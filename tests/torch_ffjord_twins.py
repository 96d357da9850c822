"""Helpers of the FFJORD twin tests (``tests/test_torch_ffjord*.py``).

flax initializes its parameters in fp32 whatever the input's dtype, so the
twins cast them to fp64 (``f64``) before both packages use them: JAX then
computes (and returns gradients) in fp64, and ``carry`` loads the same
numbers into the port through ``convert.ffjord_state_dict_from_flax``. The
port cannot draw ``jax.random``'s probes, so ``sequential_probes`` and
``chained_probes`` replay the keys the JAX flows split and hand the port
the very probes JAX drew.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pnode_tpu.ffjord.odefunc import sample_probe as j_sample_probe
from pnode_tpu_torch.convert import ffjord_state_dict_from_flax


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def carry(port, params):
    """``port`` with the fp64 flax ``params`` of its JAX twin loaded; every
    parameter must come from them (buffers such as a coupling mask keep
    their values where flax has no variable for them)."""
    got = ffjord_state_dict_from_flax(port, params)
    missing = {n for n, _ in port.named_parameters()} - set(got)
    assert not missing, sorted(missing)
    sd = port.state_dict()
    sd.update(got)
    port.load_state_dict(sd)
    return port


def probe(key, shape, kind="rademacher"):
    return torch.from_numpy(np.array(
        j_sample_probe(key, shape, jnp.float64, kind)))


def sequential_probes(key, shapes, kind="rademacher"):
    """The probes a JAX ``SequentialFlow`` draws for its layers (one key per
    layer from ``split(key, n)``); None where ``shapes[i]`` is None (a
    layer without a probe)."""
    keys = jax.random.split(key, len(shapes))
    return [None if s is None else probe(k, s, kind)
            for k, s in zip(keys, shapes)]


def chained_probes(key, shapes, kind="rademacher"):
    """The probes of JAX's ODENVP / MultiscaleParallelCNF, which split
    ``key, sub = split(key)`` before each block."""
    out = []
    for s in shapes:
        key, sub = jax.random.split(key)
        out.append(probe(sub, s, kind))
    return out


def rel(got, ref):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def assert_grads_match(port, jax_grads, rtol):
    """Every parameter's ``.grad`` against JAX's gradient tree (mapped to
    the port's names by the converter), max |diff| / max |ref|."""
    ref = ffjord_state_dict_from_flax(port, f64(jax_grads))
    names = dict(port.named_parameters())
    assert set(ref) == set(names), sorted(set(ref) ^ set(names))
    for name, p in names.items():
        err = rel(p.grad, ref[name])
        assert err <= rtol, f"{name}: {err:.3e} > {rtol:.0e}"
