"""Burgers-512 on the fused kernels: the port's gates, its ARKIMEX route and
its fused training loop against the JAX package.

(a) At Burgers-512 (512 -> 576 x4 -> 512, ARK3) the port's gates answer
    as the JAX package's: ``pick_weight_dtype`` gives "f32"
    (tests/test_fused_ark_adjoint.py:281), ``fused_train_loop_fits`` opens
    at chunk 16 (tests/test_fused_train_loop.py:175), and both refuse
    (4096, 2048, [4096, 4096]) and a 4096-wide Burgers-2048 stack.
(b) The port's ARKIMEX takes the fused route there: a spy sees
    ``fused_ark_step_fwd`` and ``fused_ark_step_adj`` called (their plain
    versions on the CPU), and the one-step solve and its adjoint equal the
    JAX package's ``ODESolver.solve`` and ``jax.vjp`` of it (its generic
    stage loop) at the same weights, in fp32, at the fused kernels' own
    tolerances (forward rtol 3e-5 / atol 1e-6,
    tests/test_fused_ark_adjoint.py:183; reverse rtol 2e-4 / atol 1e-6,
    :80). Under ``-pnode_fused_ark_adjoint off`` the spy sees no call.
(c) ``fused_train_loop_plain`` at the Burgers-512 widths, K 2 Adam
    iterations at lr 5e-3 on the stepper's own operands, equals the JAX
    package's ``ODESolver`` + ``optax.adam`` loop in fp64: losses rtol
    1e-10, parameters and moments atol 1e-12 (the Burgers twin of
    tests/test_fused_train_loop.py:63, which holds its kernel in fp32).

``BurgersPair`` (tests/test_torch_burgers.py) builds both problems from one
flax init at B 2-4, the weights carried across by ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu.ops.fused_ark_adjoint import (
    pick_weight_dtype as j_pick_weight_dtype,
)
from pnode_tpu.ops.fused_train_loop import (
    fused_train_loop_fits as j_fused_train_loop_fits,
)
from pnode_tpu_torch.ops import fused_ark_adjoint as adj
from pnode_tpu_torch.ops import fused_ark_forward as fwd
from pnode_tpu_torch.ops.fused_ark_adjoint import pick_weight_dtype
from pnode_tpu_torch.ops.fused_train_loop import (
    fused_train_loop_fits, fused_train_loop_plain,
)
from test_torch_burgers import DT, BurgersPair

torch.set_num_threads(1)
NX = 512
BURGERS = [576] * 4 + [NX]
LR = 5e-3


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


# -- (a) the gates --------------------------------------------------------------

@pytest.mark.parametrize("case", ["step kernels", "loop at chunk 16",
                                  "refused"])
def test_gates_agree_with_the_jax_package_at_burgers_512(case):
    pnode_tpu.clear_options()
    if case == "step kernels":
        assert j_pick_weight_dtype(NX, BURGERS) == "f32"
        assert pick_weight_dtype(NX, BURGERS, 4) == "f32"
    elif case == "loop at chunk 16":
        assert j_fused_train_loop_fits(200, NX, BURGERS, chunk=16)
        assert fused_train_loop_fits(200, NX, BURGERS, chunk=16)
    else:
        assert not j_fused_train_loop_fits(4096, 2048, [4096, 4096])
        assert not fused_train_loop_fits(4096, 2048, [4096, 4096])
        assert j_pick_weight_dtype(2048, [4096] * 4 + [2048]) is None
        assert pick_weight_dtype(2048, [4096] * 4 + [2048], 4) is None


# -- (b) the stepper's route ----------------------------------------------------

def _spy(monkeypatch):
    """Count the stepper's calls of the step kernels' wrappers (the stepper
    imports them at each call)."""
    calls = {"fwd": 0, "adj": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def spy(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)

    wrap(fwd, "fused_ark_step_fwd", "fwd")
    wrap(adj, "fused_ark_step_adj", "adj")
    return calls


@pytest.fixture(scope="module")
def pair32():
    return BurgersPair(4, NX, True, dtype=np.float32)


@pytest.mark.parametrize("route", ["auto", "off"])
def test_arkimex_takes_the_fused_route_at_burgers_512(pair32, route,
                                                      monkeypatch):
    p = pair32
    flags = ["-snes_type", "ksponly", "-ksp_rtol", "1e-6"]
    pnode_tpu.init(["p", "-pnode_fused_ark_adjoint", "off"] + flags)
    pt.init(["p", "-pnode_fused_ark_adjoint", route] + flags)
    calls = _spy(monkeypatch)
    y, _ = p.data(11)
    lam = np.random.default_rng(12).normal(size=y.shape)
    y, lam = y.astype(np.float32), lam.astype(np.float32)
    t_out = np.array([0.0, DT])

    def jstep(y0, prm):
        pred, _ = p.jode.solve(y0, t_out, params=prm)
        return pred[-1]

    y1_j, vjp = jax.vjp(jax.jit(jstep), jnp.asarray(y), p.jparams)
    gy_j, gp_j = vjp(jnp.asarray(lam))

    for prm in p.ex.parameters():
        prm.grad = None
    y0 = torch.from_numpy(y).requires_grad_(True)
    pred = p.ode.odeint_adjoint(y0, t_out)
    pred[-1].backward(torch.from_numpy(lam))
    want = (1, 1) if route == "auto" else (0, 0)
    assert (calls["fwd"], calls["adj"]) == want
    np.testing.assert_allclose(pred[-1].detach().numpy(), np.asarray(y1_j),
                               rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(gy_j), rtol=2e-4,
                               atol=1e-6)
    named = {k: v.grad for k, v in p.ex.named_parameters()}
    for a, b in zip(p.tleaves(named), p.jleaves(gp_j)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


# -- (c) the fused training loop ------------------------------------------------

def test_fused_train_loop_plain_matches_jax_adam_loop_at_burgers_512():
    p = BurgersPair(2, NX, True)
    K = 2
    ys, tgts = p.data(21, K)
    t_out = np.array([0.0, DT])
    opt = optax.adam(LR)
    jp, state = p.jparams, opt.init(p.jparams)

    @jax.jit
    def adam_step(prm, state, y, tgt):
        def loss_fn(prm):
            pred, _ = p.jode.solve(y, t_out, params=prm)
            return jnp.mean((pred[-1] - tgt) ** 2)
        lv, g = jax.value_and_grad(loss_fn)(prm)
        upd, state = opt.update(g, state)
        return optax.apply_updates(prm, upd), state, lv

    jl = []
    for k in range(K):
        jp, state, lv = adam_step(jp, state, jnp.asarray(ys[k]),
                                  jnp.asarray(tgts[k]))
        jl.append(float(lv))

    # the kernels' operands as the port's stepper hands them over
    params = ({}, dict(p.ex.named_parameters()))
    stp = p.ode._stepper.prepare(0.0, torch.zeros(2, NX, dtype=torch.float64),
                                 params, dt0=DT)
    spec, J, inv = stp._fused_reverse_args(params)
    assert J.shape == inv.shape == (NX, NX) and spec["sign"] == 1.0
    Ws = [w.detach() for w in spec["Ws"]]
    bs = [b.detach() for b in spec["bs"]]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    W1, b1, (mW, mb), (vW, vb), losses = fused_train_loop_plain(
        stp._tableau_static(), DT, torch.from_numpy(ys),
        torch.from_numpy(tgts), J, inv, Ws, bs, z, z, 0,
        activation=spec["activation"], sign=spec["sign"], lr=LR)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-10)

    def leaves(Wl, bl):
        tree = spec["rebuild"](list(Wl), list(bl))
        return p.tleaves({k: v for k, v in tree.items()})

    mu, nu = state[0].mu[1], state[0].nu[1]
    for got, want in ((leaves(W1, b1), p.jleaves(jp)),
                      (leaves(mW, mb), p.jleaves(({}, mu))),
                      (leaves(vW, vb), p.jleaves(({}, nu)))):
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
