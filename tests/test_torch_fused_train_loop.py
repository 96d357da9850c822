"""K4 (the fused training loop) and its gate: CPU twins of
tests/test_fused_train_loop.py.

Each twin runs the same numpy inputs and weights through the JAX package's
``fused_train_loop(..., interpret=True, stiff_prec="highest")`` and through
the port's wrapper on CPU tensors (its plain version, once per chunk), at
the reference test's tolerances: losses rtol 2e-5, parameters rtol 3e-5 /
atol 1e-6, moments rtol 1e-4 / atol 1e-9 (:99-120); chunkings as at
:220-232; non-uniform widths as at :329-349. An fp64 case holds the port's
plain loop to the JAX generic ODESolver + optax.adam in x64, as
tests/test_torch_solver.py's fp64 Adam test does (atol 1e-9), and a 6-stage
tableau (ARK4(3)6L) covers a stage count other than ARK3's 4. The drive of
``examples/ks_torch.py --fused_loop`` closes the file."""

import importlib.util
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import FlaxFunc, ODESolver
from pnode_tpu.models import KSFuncEX, KSFuncIM
from pnode_tpu.ops.fused_train_loop import fused_train_loop as j_loop
from pnode_tpu_torch.ops.fused_train_loop import (
    _loop_smem_bytes, fused_train_loop, fused_train_loop_cost,
    fused_train_loop_fits, fused_train_loop_plain, pick_chunk,
)

torch.set_num_threads(1)
LR = 5e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


class Ops(NamedTuple):
    """Operands of one fused loop as numpy arrays shared by both packages."""

    tbl: tuple
    J: np.ndarray
    inv: np.ndarray
    Ws: list
    bs: list
    activation: str
    sign: float


def _build(batch, nx, hidden=24, tableau="3", dt=0.2):
    """The operands as the reference test takes them: the prepared JAX
    stepper's tableau, frozen J and stage inverse, and the flax init of
    KSFuncEX's fused stack."""
    pnode_tpu.clear_options()
    pnode_tpu.init(["p", "-snes_type", "ksponly", "-ts_arkimex_type",
                    tableau, "-pnode_fused_ark_adjoint", "off",
                    "-pnode_fused_ark_precision", "highest"])
    im = KSFuncIM(nx=nx)
    ex = KSFuncEX(nx=nx, hidden=hidden, use_pallas=True)
    key = jax.random.PRNGKey(0)
    y_tmpl = jnp.zeros((batch, nx), jnp.float32)
    f32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(jnp.float32), t)
    vim, vex = f32(im.init(key, 0.0, y_tmpl)), f32(ex.init(key, 0.0, y_tmpl))
    ode = ODESolver()
    ode.setupTS(y_tmpl, FlaxFunc(im, vim), step_size=dt, method="imex",
                imex_form=True, implicit_form=True, func2=FlaxFunc(ex, vex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=batch)
    stp = ode._stepper.prepare(0.0, y_tmpl, (vim, vex),
                               dt0=jnp.float32(dt))
    spec = stp.fused_ex_spec(vex)
    gamma = [g for g in (float(x) for x in np.diag(stp._aI)) if g][0]
    tbl = (stp._aI, stp._aE, stp._bI, stp._bE)
    return Ops(tbl, np.asarray(stp.setup.frozen_J_blocks[0]),
               np.asarray(stp.setup.solver_cache[gamma]._inv[0]),
               [np.asarray(w) for w in spec["Ws"]],
               [np.asarray(b) for b in spec["bs"]], spec["activation"],
               spec["sign"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _zeros(ops):
    zW = [np.zeros_like(w) for w in ops.Ws]
    zb = [np.zeros_like(b) for b in ops.bs]
    return zW, zb


def run_jax(ops, y, tgt, Ws=None, bs=None, m=None, v=None, t0=0, **kw):
    z = _zeros(ops)
    out = j_loop(ops.tbl, 0.2, jnp.asarray(y), jnp.asarray(tgt),
                 jnp.asarray(ops.J), jnp.asarray(ops.inv),
                 [jnp.asarray(w) for w in (Ws or ops.Ws)],
                 [jnp.asarray(b) for b in (bs or ops.bs)], m or z, v or z, t0,
                 activation=ops.activation, sign=ops.sign, lr=LR,
                 interpret=True, stiff_prec="highest", **kw)
    Ws_o, bs_o, (mW, mb), (vW, vb), losses = out
    np_ = lambda ts: [np.asarray(x) for x in ts]  # noqa: E731
    return (np_(Ws_o), np_(bs_o), (np_(mW), np_(mb)), (np_(vW), np_(vb)),
            np.asarray(losses))


def run_port(ops, y, tgt, Ws=None, bs=None, m=None, v=None, t0=0, **kw):
    zW, zb = _zeros(ops)
    m = m or (zW, zb)
    v = v or (zW, zb)
    out = fused_train_loop(
        ops.tbl, float(np.float32(0.2)), _t(y), _t(tgt), _t(ops.J),
        _t(ops.inv), [_t(w) for w in (Ws or ops.Ws)],
        [_t(b) for b in (bs or ops.bs)], ([_t(a) for a in m[0]],
                                          [_t(a) for a in m[1]]),
        ([_t(a) for a in v[0]], [_t(a) for a in v[1]]), t0,
        activation=ops.activation, sign=ops.sign, lr=LR, **kw)
    Ws_o, bs_o, (mW, mb), (vW, vb), losses = out
    np_ = lambda ts: [x.numpy() for x in ts]  # noqa: E731
    return (np_(Ws_o), np_(bs_o), (np_(mW), np_(mb)), (np_(vW), np_(vb)),
            losses.numpy())


def _data(K, batch, nx, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(K, batch, nx)).astype(np.float32)
    tgt = (y + noise * rng.normal(size=y.shape)).astype(np.float32)
    return y, tgt


def _assert_states(got, want, rtol=3e-5, atol=1e-6, m_rtol=1e-4,
                   m_atol=1e-9):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for k in (2, 3):
        for a, b in zip(got[k][0] + got[k][1], want[k][0] + want[k][1]):
            np.testing.assert_allclose(a, b, rtol=m_rtol, atol=m_atol)


@pytest.mark.parametrize("tableau", ["3", "4"])
def test_fused_train_loop_matches_reference(tableau):
    """Tableau "3" is ARK3(2)4L[2]SA (4 stages), the main path's; "4" is
    ARK4(3)6L[2]SA (6 stages), a second single-gamma tableau."""
    ops = _build(8, 16, tableau=tableau)
    assert len(ops.tbl[2]) == {"3": 4, "4": 6}[tableau]
    y, tgt = _data(4, 8, 16, seed=1)
    want = run_jax(ops, y, tgt)
    got = run_port(ops, y, tgt)
    np.testing.assert_allclose(got[4], want[4], rtol=2e-5, atol=1e-8)
    _assert_states(got, want)


def test_fused_train_loop_distinct_minibatches():
    """Iteration k consumes its own (y, target): a stacked epoch equals
    running the minibatches one call at a time, threading the state."""
    batch, nx, K = 8, 16, 3
    ops = _build(batch, nx)
    y = (np.random.default_rng(7).normal(size=(K, batch, nx))
         * np.arange(1, K + 1).reshape(K, 1, 1)).astype(np.float32)
    tgt = (0.9 * y).astype(np.float32)
    all_at_once = run_port(ops, y, tgt)
    Ws, bs, m, v, t0 = ops.Ws, ops.bs, None, None, 0
    seq = []
    for k in range(K):
        Ws, bs, m, v, ls = run_port(ops, y[k:k + 1], tgt[k:k + 1], Ws, bs, m,
                                    v, t0)
        t0 += 1
        seq.append(float(ls[0]))
    np.testing.assert_allclose(all_at_once[4], seq, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(all_at_once[4], run_jax(ops, y, tgt)[4],
                               rtol=2e-5, atol=1e-8)


def test_fused_train_loop_fits_the_h100():
    """The shared-memory gate answers for the H100, not the TPU's VMEM."""
    ks = [104] * 4 + [64]
    assert _loop_smem_bytes(64, ks, 4) == 48768
    assert fused_train_loop_fits(256, 64, ks)
    assert fused_train_loop_fits(256, 64, [64, 64])
    # the JAX gate says Burgers-512 fits VMEM at chunk 16; K4's block needs
    # ~340 KB of shared memory there, against 227 KB
    assert _loop_smem_bytes(512, [576] * 4 + [512], 4) == 340096
    assert not fused_train_loop_fits(200, 512, [576] * 4 + [512], chunk=16)
    assert not fused_train_loop_fits(4096, 2048, [4096, 4096])
    # neither the batch nor the chunk binds; stages and layers do
    assert fused_train_loop_fits(1 << 20, 64, ks, chunk=1024)
    assert fused_train_loop_fits(256, 64, ks, stages=8)
    assert not fused_train_loop_fits(256, 64, ks, stages=9)
    assert not fused_train_loop_fits(256, 64, [104] * 8 + [64])
    assert not fused_train_loop_fits(256, 64, [104] * 4 + [32])
    assert pick_chunk(32, 256, 64, ks) == 32
    assert pick_chunk(24, 256, 64, ks) == 8
    assert pick_chunk(5, 256, 64, ks) == 1
    assert pick_chunk(32, 200, 512, [576] * 4 + [512]) == 1
    flops, byts = fused_train_loop_cost(([[0.0] * 4] * 4, None, [0.0] * 4,
                                         None), 256, 64, ks, 1000)
    assert flops > 0 and byts > 4 * 2 * 256 * 64


def test_fused_train_loop_chunked_grid_persistence():
    """K=32 as two launches of 16 and as 32 launches of 1: the state one
    launch leaves in the flat buffers must seed the next exactly."""
    batch, nx, K = 8, 16, 32
    ops = _build(batch, nx)
    y, tgt = _data(K, batch, nx, seed=3, noise=0.1)
    out = {c: run_port(ops, y, tgt, chunk=c) for c in (16, 1)}
    ref = run_jax(ops, y, tgt, chunk=1)
    for got in (out[16], out[1]):
        np.testing.assert_allclose(got[4], ref[4], rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(out[16][4], out[1][4], rtol=1e-5, atol=1e-10)
    # parameters and moments at each tensor's own scale: Adam's 1/sqrt(v)
    # turns rounding into ~1e-3 relative differences on noise-scale
    # elements over 32 steps (the reference's bound); a persistence or
    # indexing bug is O(scale) wrong
    flat = lambda o: o[0] + o[1] + o[2][0] + o[2][1] + o[3][0] + o[3][1]  # noqa: E731,E501
    for a, b, r in zip(flat(out[16]), flat(out[1]), flat(ref)):
        scale = max(float(np.max(np.abs(r))), 1e-12)
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=1e-3 * scale)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * scale)


def test_fused_train_loop_nonuniform_layer_widths():
    """16 -> 136 -> 24 -> 16, batch 4, nonzero biases: the reference's
    stacked-layout and phantom-row regression case. Losses against the JAX
    kernel, and the exact first-step gradient m1 / (1 - b1) against
    autodiff of the plain forward step."""
    batch, nx, K = 4, 16, 3
    ops = _build(batch, nx)
    dims = [nx, 136, 24, nx]
    rng = np.random.default_rng(5)
    Ws = [(0.05 * rng.normal(size=(a, b))).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in dims[1:]]
    ops = ops._replace(Ws=Ws, bs=bs)
    y, tgt = _data(K, batch, nx, seed=6, noise=0.1)
    got, want = run_port(ops, y, tgt), run_jax(ops, y, tgt)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-3, atol=1e-8)
    _assert_states(got, want)

    # one iteration from zero moments leaves m = (1 - b1) g
    _, _, (mW1, mb1), _, _ = run_port(ops, y[:1], tgt[:1])
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd_plain

    Wt = [_t(w).requires_grad_(True) for w in Ws]
    bt = [_t(b).requires_grad_(True) for b in bs]
    y1, _ = fused_ark_step_fwd_plain(ops.tbl, float(np.float32(0.2)),
                                     _t(y[0]), _t(ops.J), _t(ops.inv), Wt, bt,
                                     "relu", -1.0)
    loss = torch.mean((y1 - _t(tgt[0])) ** 2)
    g0 = torch.autograd.grad(loss, Wt + bt)
    for got_m, want_g in zip(mW1 + mb1, g0):
        want_g = want_g.numpy()
        scale = max(float(np.max(np.abs(want_g))), 1e-12)
        np.testing.assert_allclose(got_m / 0.1, want_g, rtol=1e-4,
                                   atol=1e-5 * scale)


def test_plain_loop_matches_jax_generic_fp64():
    """The port's plain loop in fp64, with its own prepared stepper's J and
    stage inverse, against the JAX generic stage loop + optax.adam in x64
    (4 Adam steps, perturbed weights and nonzero biases)."""
    from test_torch_solver import F64, Pair

    p = Pair(8, 16, 24, F64, flags=["-snes_type", "ksponly"])
    K = 4
    ys, tgts = p.data(7, K)
    t_out = np.array([0.0, 0.2])
    opt = optax.adam(LR)

    @jax.jit
    def step(prm, state, y, tgt):
        def loss_fn(prm):
            pred, _ = p.jode.solve(y, t_out, params=prm)
            return jnp.mean((pred[-1] - tgt) ** 2)
        lv, g = jax.value_and_grad(loss_fn)(prm)
        upd, state = opt.update(g, state)
        return optax.apply_updates(prm, upd), state, lv

    jp, state, jl = p.jparams, opt.init(p.jparams), []
    for k in range(K):
        jp, state, lv = step(jp, state, jnp.asarray(ys[k]),
                             jnp.asarray(tgts[k]))
        jl.append(float(lv))

    y0 = torch.zeros(8, 16, dtype=torch.float64)
    stp = p.ode._stepper.prepare(0.0, y0, p.tparams, dt0=0.2)
    gamma = [g for g in (float(x) for x in np.diag(stp._aI)) if g][0]
    spec = p.ex.fused_mlp_spec(p.tparams[1])
    Ws = [w.detach() for w in spec["Ws"]]
    bs = [b.detach() for b in spec["bs"]]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    Ws_o, bs_o, _, _, losses = fused_train_loop_plain(
        stp._tableau_static(), 0.2, torch.from_numpy(ys),
        torch.from_numpy(tgts), stp.setup.frozen_J_blocks[0],
        stp.setup.solver_cache[gamma]._inv[0], Ws, bs, z, z, 0, lr=LR)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=0, atol=1e-9)
    got = p.tleaves((None, spec["rebuild"](Ws_o, bs_o)))
    for a, b in zip(got, p.jleaves(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ops = _build(4, 16)
    y, tgt = _data(8, 4, 16, seed=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        run_port(ops, y, tgt, chunk=4)
    with pytest.raises(ValueError, match="divide"):
        run_port(ops, y, tgt, chunk=3)
    with pytest.raises(ValueError, match="tgt_stack"):
        run_port(ops, y, tgt[:, :2])
    with pytest.raises(ValueError, match="float32"):
        fused_train_loop(ops.tbl, 0.2, _t(y).double(), _t(tgt), _t(ops.J),
                         _t(ops.inv), [_t(w) for w in ops.Ws],
                         [_t(b) for b in ops.bs], ([], []), ([], []), 0)
    with pytest.raises(ValueError, match="m_state"):
        run_port(ops, y, tgt, m=([np.zeros(3, np.float32)] * 5, _zeros(ops)[1]))
    pt.init(["p", "-pnode_fused_ark_precision", "high"])
    with pytest.raises(ValueError, match="not ported"):
        run_port(ops, y, tgt)


def _ks_torch():
    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(REPO, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ks_torch_fused_loop_drive(tmp_path, capsys):
    """examples/ks_torch.py --fused_loop on the CPU: finite validation
    losses, and first-epoch train losses equal to the per-step path's
    within 1e-4 relative (same batches, Adam eps 1e-8: optax's formula in
    the loop against torch.optim.Adam's, both in fp32)."""
    ks = _ks_torch()
    argv = ["--device", "cpu", "--max_epochs", "2", "--data_size", "80",
            "--batch_size", "16", "--train_dir", str(tmp_path),
            # the main path, the trainer's defaults before slice 4(b)
            "--pnode_model", "imex", "--linear_solver", "hpddm",
            "--fixed_jacobian"]
    _, fused = ks.main(argv + ["--fused_loop"])
    vals = [float(ln.split("Val")[1].split("|")[0])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Epoch")]
    assert len(vals) == 2 and np.all(np.isfinite(vals)), vals
    _, per_step = ks.main(argv)
    assert len(fused[0]) == len(per_step[0]) == 3
    np.testing.assert_allclose(fused[0], per_step[0], rtol=1e-4)
    with pytest.raises(SystemExit, match="fused_loop"):
        ks.main(argv + ["--fused_loop", "--double_prec"])
    with pytest.raises(SystemExit, match="fused_loop"):
        ks.main(argv + ["--fused_loop", "--time_window_size", "2"])
