"""The port's flat_adam (pnode_tpu_torch/utils/optim.py FlatAdam) against
the JAX package's (pnode_tpu/utils/optim.py): twins of tests/test_optim.py.

Both train the same two-layer tanh net (weights and inputs from numpy
seeds) for 25 steps. fp32 moments: the port against JAX's flat_adam and
against optax.adam on prescribed gradients (rtol 1e-5, atol 2e-6: the
fp32 bias corrections' pow rounds an ulp apart in the two frameworks),
and the training losses at test_optim.py's rtol 1e-4. bf16 moments: the port
against JAX's bf16 flat_adam within the same moment rounding, and against
its own fp32 run at test_optim.py's bf16 tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnode_tpu.utils import flat_adam as jflat_adam
from pnode_tpu_torch.utils import flat_adam
from pnode_tpu_torch.utils.optim import FlatAdam

torch.set_num_threads(1)


def _params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(32, 48)) * 0.2).astype(np.float32),
            "b1": (rng.normal(size=(48,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(48, 8)) * 0.2).astype(np.float32),
            "b2": (rng.normal(size=(8,)) * 0.1).astype(np.float32)}


X = np.random.default_rng(7).normal(size=(16, 32)).astype(np.float32)


def _train_jax(opt, n=25):
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    x = jnp.asarray(X)

    def loss_fn(p):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] + p["b2"]) ** 2)

    s = opt.init(p)
    losses = []
    for _ in range(n):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = opt.update(g, s)
        p = optax.apply_updates(p, u)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in p.items()}, losses


def _train_torch(make, n=25):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in _params().items()}
    x = torch.tensor(X)
    opt = make(list(p.values()))
    losses = []
    for _ in range(n):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        loss = torch.mean((h @ p["w2"] + p["b2"]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return {k: v.detach().numpy() for k, v in p.items()}, losses


def _steps_jax(opt, grads):
    """Parameters after one update per prescribed gradient."""
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    s = opt.init(p)
    for g in grads:
        u, s = opt.update({k: jnp.asarray(v) for k, v in g.items()}, s)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


def _steps_torch(make, grads):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in _params().items()}
    opt = make(list(p.values()))
    for g in grads:
        for k, v in p.items():
            v.grad = torch.tensor(g[k])
        opt.step()
    return {k: v.detach().numpy() for k, v in p.items()}


def test_f32_matches_optax_adam():
    """moment_dtype f32 is Adam: on 25 prescribed gradients (numpy, a seed)
    the port's parameters equal optax.adam's and JAX's flat_adam's within
    2e-6 (XLA's and torch's fp32 pow round b2^t an ulp apart, and 1 / (1 -
    b2^t) ~ 1000 / t turns that into ~3e-7 of lr a step at first); training
    the net, its losses follow optax.adam's within
    test_optim.py's rtol 1e-4 (the gradients come from two frameworks
    there, so parameters are compared on prescribed gradients)."""
    rng = np.random.default_rng(3)
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 0))
              .astype(np.float32) for k, v in _params().items()}
             for _ in range(25)]
    p_new = _steps_torch(lambda ps: flat_adam(ps, 1e-2, moment_dtype="f32"),
                         grads)
    for ref in (optax.adam(1e-2), jflat_adam(1e-2, moment_dtype="f32")):
        p_ref = _steps_jax(ref, grads)
        for k in p_ref:
            np.testing.assert_allclose(p_new[k], p_ref[k], rtol=1e-5,
                                       atol=2e-6)
    _, l_new = _train_torch(lambda ps: flat_adam(ps, 1e-2))
    _, l_ref = _train_jax(optax.adam(1e-2))
    np.testing.assert_allclose(l_new, l_ref, rtol=1e-4)


def test_bf16_moments_track_f32():
    """bf16 moments: within moment rounding of the fp32 run (test_optim's
    2e-2 / 2e-3), descending to the same level, and close to JAX's bf16
    flat_adam."""
    p_ref, l_ref = _train_torch(lambda ps: flat_adam(ps, 1e-2))
    p_bf, l_bf = _train_torch(lambda ps: flat_adam(ps, 1e-2,
                                                   moment_dtype="bf16"))
    for k in p_ref:
        np.testing.assert_allclose(p_bf[k], p_ref[k], rtol=2e-2, atol=2e-3)
    assert l_bf[-1] < 0.5 * l_bf[0]
    np.testing.assert_allclose(l_bf[-1], l_ref[-1], rtol=5e-2)
    p_j, l_j = _train_jax(jflat_adam(1e-2, moment_dtype="bf16"))
    for k in p_j:
        np.testing.assert_allclose(p_bf[k], p_j[k], rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(l_bf, l_j, rtol=5e-2)


def test_bf16_state_dtype():
    """The stored moments are bf16 (that is the saving); the parameters
    and their update stay fp32."""
    p = torch.zeros(5, requires_grad=True)
    opt = flat_adam([p], 1e-2, moment_dtype="bf16")
    p.grad = torch.ones(5)
    opt.step()
    st = opt.state[p]
    assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16
    assert p.dtype == torch.float32
    assert torch.allclose(p.detach(), torch.full((5,), -1e-2))


def test_schedule_callable():
    """A learning rate that is a callable of the count (optax's piecewise
    schedule, x0.1 from step 10) changes the trajectory after step 10, and
    matches JAX's flat_adam on the same schedule."""
    sched = optax.piecewise_constant_schedule(1e-2, {10: 0.1})
    p1, _ = _train_torch(lambda ps: FlatAdam(ps, lambda t: float(sched(t))))
    p2, _ = _train_torch(lambda ps: FlatAdam(ps, 1e-2))
    assert max(float(np.abs(p1[k] - p2[k]).max()) for k in p1) > 1e-5
    pj, _ = _train_jax(jflat_adam(sched))
    for k in pj:
        np.testing.assert_allclose(p1[k], pj[k], rtol=1e-4, atol=5e-7)


def test_bad_moment_dtype():
    with pytest.raises(ValueError):
        flat_adam([torch.zeros(2, requires_grad=True)], 1e-3,
                  moment_dtype="f16")
