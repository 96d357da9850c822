"""Helpers of the GRAND twin tests (``tests/test_torch_grand*.py``).

flax initializes its Dense kernels in fp32 whatever the input's dtype, so
the twins cast every parameter to fp64 (``f64``) before both packages use
them: JAX then computes (and returns gradients) in fp64, and ``carry``
loads the same numbers into the port through
``convert.grand_state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from pnode_tpu.models import grand as J
from pnode_tpu_torch.convert import grand_state_dict_from_flax
from pnode_tpu_torch.models import grand as P

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def carry(port, params):
    """``port`` (a GRAND model, or a dict-like holder of parts) with the
    fp64 flax ``params`` of its JAX twin loaded; every parameter must come
    from them."""
    got = grand_state_dict_from_flax(port, params)
    names = {n for n, _ in port.named_parameters()}
    assert names == set(got), sorted(names ^ set(got))
    port.load_state_dict(got)
    return port


def holder(**parts):
    """A module whose attributes are ``parts`` (one flax variable dict
    each): standalone layers go through the converter this way."""
    return nn.ModuleDict(parts).to(F64)


def rel(got, ref):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def assert_grads_match(port, jax_grads, rtol):
    """Every parameter's ``.grad`` (None read as 0: a frozen attention
    layer) against JAX's gradient tree, max |diff| / max |ref|. A gradient
    that vanishes to rounding (the key projection's bias shifts every
    score of a softmax segment alike) is held against 1e-4 of the largest
    gradient instead."""
    ref = grand_state_dict_from_flax(port, f64(jax_grads))
    names = dict(port.named_parameters())
    assert set(ref) == set(names), sorted(set(ref) ^ set(names))
    assert_named_grads_match({n: p.grad for n, p in names.items()}, ref,
                             rtol)


def assert_named_grads_match(got, ref, rtol):
    """{name: gradient or None} against {name: reference} as
    ``assert_grads_match`` holds them."""
    scale = max(float(np.max(np.abs(np.asarray(r)))) for r in ref.values())
    for name, r in ref.items():
        r = np.asarray(r)
        g = np.zeros_like(r) if got[name] is None else np.asarray(
            got[name].detach())
        err = float(np.max(np.abs(g - r))) / max(
            float(np.max(np.abs(r))), 1e-4 * scale)
        assert err <= rtol, f"{name}: {err:.3e} > {rtol:.0e}"


def sbm(n=48, seed=3, n_classes=3, feat_dim=8):
    return J.synthetic_sbm(n_nodes=n, n_classes=n_classes, feat_dim=feat_dim,
                           p_in=0.15, p_out=0.02, seed=seed)


def graphs(data, kind="rw"):
    """(JAX graph, port graph) of the same normalized adjacency."""
    n = len(data["y"])
    if kind == "gcn":
        return (J.gcn_norm_adj(data["edge_index"], n),
                P.gcn_norm_adj(data["edge_index"], n))
    return (J.get_rw_adj(data["edge_index"], n),
            P.get_rw_adj(data["edge_index"], n))


def model_pair(data, hidden=16, key=0, pos_enc=None, **kw):
    """(JAX GRANDModel, its fp64 params, the port's twin with them)."""
    kind = "gcn" if kw.get("function") == "cgnn" else "rw"
    jg, pg = graphs(data, kind)
    in_dim, n_cls = data["x"].shape[1], int(data["y"].max()) + 1
    kw = dict(dict(T=1.0, step_size=0.25, method="dopri5"), **kw)
    jm = J.GRANDModel(jg, in_dim, hidden, n_cls, **kw)
    x = jnp.asarray(data["x"], jnp.float64)
    params = f64(jm.init(jax.random.PRNGKey(key), x, pos_encoding=pos_enc))
    pm = carry(P.GRANDModel(pg, in_dim, hidden, n_cls, **kw, **CPU), params)
    return jm, params, pm


def jax_ce(jm, params, data, training=True, pos_enc=None):
    """(CE, its jax.grad) of the JAX model, dropout off."""
    x = jnp.asarray(data["x"], jnp.float64)
    y = jnp.asarray(data["y"])

    def loss(p):
        lg = jm.apply(p, x, training=training, pos_encoding=pos_enc)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(lg), y[:, None], 1))

    return jax.value_and_grad(loss)(params)


def port_ce(pm, data, training=True, pos_enc=None):
    """The port's CE, its gradient left in ``.grad``, dropout off."""
    x = torch.as_tensor(data["x"], dtype=F64)
    y = torch.as_tensor(data["y"], dtype=torch.int64)
    pe = None if pos_enc is None else torch.as_tensor(np.asarray(pos_enc))
    pm.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(
        pm(x, training=training, pos_encoding=pe), y)
    loss.backward()
    return float(loss.detach())
