"""K5 (the fused adaptive training loop) and its gate: CPU twins of
tests/test_fused_adaptive_loop.py.

The port's wrapper on CPU tensors (its plain version,
``fused_adaptive_train_loop_plain``) against the JAX package's generic
adaptive engine (``adaptive.make_adaptive_odeint`` through ODESolver, with
optax.adam and bench.py's dt_first warm start: the reference test's own
``_reference_loop``) on the reference test's operands and inputs, at its
tolerances: decisions exact, dt_first rtol 1e-5, losses rtol 2e-3, final
parameters rtol 5e-3 of each tensor's scale (:126-142), and its tighter
bounds in the clipped regime (:177-190). Once against the JAX kernel itself
(``fused_adaptive_train_loop(interpret=True)``) at K 2. The drive of
``examples/ks_torch.py --fused_loop -ts_adapt_type basic`` closes the
file."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
import test_fused_adaptive_loop as R
from pnode_tpu.ops.fused_adaptive_loop import (
    fused_adaptive_train_loop as j_loop,
)
from pnode_tpu_torch.ops.fused_adaptive_loop import (
    _adaptive_smem_bytes, fused_adaptive_loop_fits,
    fused_adaptive_train_loop,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _stacks(seed, K, batch, nx, scale, noise):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    y = jax.random.normal(k1, (K, batch, nx), jnp.float32) * scale
    return y, y + noise * jax.random.normal(k2, (K, batch, nx), jnp.float32)


def run_port(ops, y_stack, tgt_stack, dt0, max_trials, rtol, atol,
             order=3):
    """The port's K5 on CPU tensors from zero Adam moments; parameters come
    back as the reference's flax tree."""
    spec, J, lam, Q, tbl = ops
    Ws = [_t(w) for w in spec["Ws"]]
    bs = [_t(b) for b in spec["bs"]]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    Wo, bo, (mW, mb), _, losses, stats = fused_adaptive_train_loop(
        tbl, R.GAMMA, _t(lam), _t(Q), _t(J), 0.2, dt0, _t(y_stack),
        _t(tgt_stack), Ws, bs, z, z, 0, max_trials, rtol=rtol, atol=atol,
        order=order, activation=spec["activation"], sign=spec["sign"],
        lr=R.LR)
    tree = spec["rebuild"]([w.numpy() for w in Wo], [b.numpy() for b in bo])
    grads = spec["rebuild"]([w.numpy() / 0.1 for w in mW],
                            [b.numpy() / 0.1 for b in mb])
    return tree, grads, losses.numpy(), {k: v.numpy()
                                         for k, v in stats.items()}


def _assert_decisions(stats, acc, rej):
    assert np.all(stats["completed"] == 1.0)
    np.testing.assert_array_equal(stats["accepted"].astype(np.int64), acc)
    np.testing.assert_array_equal(stats["rejected"].astype(np.int64), rej)


def _assert_params(got, want, rtol, atol_scale=None, atol=None):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        tol = atol if atol is not None else atol_scale * max(
            float(np.max(np.abs(b))), 1e-12)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=tol)


def test_plain_loop_matches_engine():
    """Twin of test_fused_adaptive_loop_matches_engine (dt0 0.08, off the
    MATCHSTEP landing boundary, as the reference chose it)."""
    batch, nx, K = 8, 16, 6
    ode, params, _ = R._build(batch, nx)
    y, tgt = _stacks(1, K, batch, nx, 0.3, 0.05)
    ref_params, ref_losses, ref_acc, ref_rej, ref_dtf = R._reference_loop(
        ode, params, y, tgt, K, 0.08)
    ops = R._kernel_operands(ode, params, batch, nx)
    tree, _, losses, stats = run_port(ops, y, tgt, 0.08, R.MAX_TRIALS,
                                      R.RTOL, R.ATOL)
    _assert_decisions(stats, ref_acc, ref_rej)
    np.testing.assert_allclose(stats["dt_first"], ref_dtf, rtol=1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3, atol=1e-8)
    _assert_params(tree, ref_params[1], rtol=5e-3, atol_scale=5e-3)


def test_plain_loop_decision_parity_clipped_regime():
    """Twin of test_fused_adaptive_loop_decision_parity_clipped_regime:
    loose tolerances clip every growth factor at dt_max_factor."""
    batch, nx, K = 8, 16, 4
    ode, params, _ = R._build(batch, nx)
    pnode_tpu.set_option("ts_rtol", "1e-1")
    pnode_tpu.set_option("ts_atol", "1e-1")
    y, tgt = _stacks(2, K, batch, nx, 0.1, 0.02)
    ref_params, ref_losses, ref_acc, ref_rej, ref_dtf = R._reference_loop(
        ode, params, y, tgt, K, 0.01)
    ops = R._kernel_operands(ode, params, batch, nx)
    tree, _, losses, stats = run_port(ops, y, tgt, 0.01, R.MAX_TRIALS,
                                      1e-1, 1e-1)
    _assert_decisions(stats, ref_acc, ref_rej)
    np.testing.assert_allclose(stats["dt_first"], ref_dtf, rtol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-5, atol=1e-8)
    _assert_params(tree, ref_params[1], rtol=1e-3, atol=1e-5)


def test_plain_loop_rejections_are_gated():
    """Twin of test_fused_adaptive_loop_rejections_are_gated: dt0 0.2 on
    scale-3 states rejects on the way down; rejected trials reverse as the
    identity, so the first iteration's gradient (m1 / (1 - b1)) equals the
    engine's, compared globally as the reference does (a relu mask near
    zero may flip one unit)."""
    batch, nx, K = 4, 16, 3
    ode, params, _ = R._build(batch, nx)
    k1, _ = jax.random.split(jax.random.PRNGKey(9))
    y = jax.random.normal(k1, (K, batch, nx), jnp.float32) * 3.0
    tgt = 0.9 * y
    _, ref_losses, ref_acc, ref_rej, _ = R._reference_loop(
        ode, params, y, tgt, K, 0.2)
    assert sum(ref_rej) > 0
    ops = R._kernel_operands(ode, params, batch, nx)
    _, _, losses, stats = run_port(ops, y, tgt, 0.2, R.MAX_TRIALS, R.RTOL,
                                   R.ATOL)
    _assert_decisions(stats, ref_acc, ref_rej)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-4, atol=1e-8)

    def loss0(p):
        pred, _ = ode.solve(y[0], np.array([0.0, 0.2]), params=p,
                            dt0=jnp.float32(0.2))
        return jnp.mean((pred[-1] - tgt[0]) ** 2)

    want = np.concatenate([np.asarray(a).ravel() for a in
                           jax.tree_util.tree_leaves(jax.grad(loss0)(params)[1])])
    _, g_tree, _, _ = run_port(ops, y[:1], tgt[:1], 0.2, R.MAX_TRIALS,
                               R.RTOL, R.ATOL)
    got = np.concatenate([np.asarray(a).ravel()
                          for a in jax.tree_util.tree_leaves(g_tree)])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3
    assert float(np.max(np.abs(got - want))) < 5e-3 * float(
        np.max(np.abs(want)))


def test_plain_loop_interior_growth_regime():
    """Twin of test_fused_adaptive_loop_interior_growth_regime: tight
    tolerances and dt0 5e-4 put ~15 growth factors inside (1, facmax),
    where the controller exponent 1/(order+1) shapes every decision; order
    5 must then take more accepted trials than ARK3's order 3."""
    batch, nx, K = 8, 16, 3
    pnode_tpu.clear_options()
    pnode_tpu.init(["p", "-snes_type", "ksponly", "-ts_arkimex_type", "3",
                    "-ts_adapt_type", "basic", "-ts_rtol", "1e-7",
                    "-ts_atol", "1e-7", "-ts_adapt_max_steps", "24",
                    "-pnode_fused_ark_adjoint", "off",
                    "-pnode_fused_ark_precision", "highest"])
    ode, params = _interior_build(batch, nx)
    y, tgt = _stacks(1, K, batch, nx, 1.0, 0.05)
    _, ref_losses, ref_acc, ref_rej, ref_dtf = R._reference_loop(
        ode, params, y, tgt, K, 0.0005)
    assert max(ref_acc) >= 10
    ops = R._kernel_operands(ode, params, batch, nx)
    _, _, losses, stats = run_port(ops, y, tgt, 0.0005, 24, 1e-7, 1e-7)
    _assert_decisions(stats, ref_acc, ref_rej)
    np.testing.assert_allclose(stats["dt_first"], ref_dtf, rtol=1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3, atol=1e-8)
    _, _, _, stats5 = run_port(ops, y, tgt, 0.0005, 24, 1e-7, 1e-7, order=5)
    assert stats5["accepted"].sum() > stats["accepted"].sum()


def _interior_build(batch, nx):
    """The reference's interior-regime solver: R._build's model under the
    caller's pnode_tpu.init (-ts_rtol 1e-7, 24 trials), not R._build's."""
    from pnode_tpu import FlaxFunc, ODESolver
    from pnode_tpu.models import KSFuncEX, KSFuncIM

    im = KSFuncIM(nx=nx)
    ex = KSFuncEX(nx=nx, hidden=24, use_pallas=True)
    key = jax.random.PRNGKey(0)
    y_tmpl = jnp.zeros((batch, nx), jnp.float32)
    vim, vex = im.init(key, 0.0, y_tmpl), ex.init(key, 0.0, y_tmpl)
    ode = ODESolver()
    ode.setupTS(y_tmpl, FlaxFunc(im, vim), step_size=0.2, method="imex",
                imex_form=True, implicit_form=True, func2=FlaxFunc(ex, vex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=batch)
    return ode, (vim, vex)


def test_plain_loop_matches_jax_kernel_interpret():
    """The plain version against the JAX kernel in interpret mode on the
    same operands, K 2: decisions equal, dt_first rtol 1e-5, losses rtol
    1e-5, parameters at the reference's engine bounds."""
    batch, nx, K = 8, 16, 2
    ode, params, _ = R._build(batch, nx)
    y, tgt = _stacks(1, K, batch, nx, 0.3, 0.05)
    ops = R._kernel_operands(ode, params, batch, nx)
    spec, J, lam, Q, tbl = ops
    zW = [jnp.zeros_like(w) for w in spec["Ws"]]
    zb = [jnp.zeros_like(b) for b in spec["bs"]]
    Wj, bj, _, _, lj, sj = j_loop(
        tbl, R.GAMMA, lam, Q, J, 0.2, 0.08, y, tgt, list(spec["Ws"]),
        list(spec["bs"]), (zW, zb), (zW, zb), 0, R.MAX_TRIALS, rtol=R.RTOL,
        atol=R.ATOL, order=3, activation=spec["activation"],
        sign=spec["sign"], lr=R.LR, interpret=True, stiff_prec="highest")
    tree, _, losses, stats = run_port(ops, y, tgt, 0.08, R.MAX_TRIALS,
                                      R.RTOL, R.ATOL)
    for name in ("accepted", "rejected", "completed"):
        np.testing.assert_array_equal(stats[name], np.asarray(sj[name]))
    np.testing.assert_allclose(stats["dt_first"], np.asarray(sj["dt_first"]),
                               rtol=1e-5)
    np.testing.assert_allclose(losses, np.asarray(lj), rtol=1e-5)
    _assert_params(tree, spec["rebuild"](Wj, bj), rtol=5e-3, atol_scale=5e-3)


def test_plain_loop_requires_order():
    with pytest.raises(TypeError, match="order is required"):
        fused_adaptive_train_loop(
            ((0.0,),) * 6, 0.4, torch.zeros(4), torch.eye(4), torch.eye(4),
            0.2, 0.01, torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
            [torch.zeros(4, 4)], [torch.zeros(4)],
            ([torch.zeros(4, 4)], [torch.zeros(4)]),
            ([torch.zeros(4, 4)], [torch.zeros(4)]), 0, 4)


def test_fits_the_h100():
    """The gate budgets one block's shared memory (227 KB), not VMEM: the
    trial records live in a device workspace, so neither the batch nor the
    trial axis binds beyond their 8 bytes each."""
    ks = [104] * 4 + [64]
    assert _adaptive_smem_bytes(64, ks, 4, 32) == 84944
    assert fused_adaptive_loop_fits(256, 64, ks, 32)
    assert fused_adaptive_loop_fits(256, 64, [64, 64], 32)
    assert fused_adaptive_loop_fits(1 << 20, 64, ks, 1024)
    assert not fused_adaptive_loop_fits(4096, 2048, [4096, 4096], 64)
    assert not fused_adaptive_loop_fits(256, 512, [576] * 4 + [512], 32)
    assert not fused_adaptive_loop_fits(256, 64, ks, 32, stages=9)
    assert not fused_adaptive_loop_fits(256, 64, [104] * 4 + [32], 32)
    assert not fused_adaptive_loop_fits(256, 64, ks, 0)


def _ks_torch():
    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(REPO, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ADAPT = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4", "-ts_atol", "1e-4"]


def test_ks_torch_fused_adaptive_loop_drive(tmp_path, capsys):
    """examples/ks_torch.py --fused_loop -ts_adapt_type basic on the CPU:
    finite validation losses; the first epoch's train losses within 1e-3
    relative of the per-step adaptive path's (same batches: K5 takes kI =
    J Y where the per-step route's K2 takes the difference quotient, so the
    landed states differ by the controller's tolerance, not by rounding);
    an epoch as one call equals two calls carrying the weights, moments and
    the dt warm start; a call whose window cannot land stops the run."""
    ks = _ks_torch()
    argv = ["--device", "cpu", "--max_epochs", "2", "--data_size", "80",
            "--batch_size", "16", "--train_dir", str(tmp_path),
            # the main path, the trainer's defaults before slice 4(b)
            "--pnode_model", "imex", "--linear_solver", "hpddm",
            "--fixed_jacobian"]
    _, fused = ks.main(argv + ["--fused_loop"] + ADAPT)
    vals = [float(ln.split("Val")[1].split("|")[0])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Epoch")]
    assert len(vals) == 2 and np.all(np.isfinite(vals)), vals
    _, per_step = ks.main(argv + ADAPT)
    assert len(fused[0]) == len(per_step[0]) == 3
    np.testing.assert_allclose(fused[0], per_step[0], rtol=1e-3)

    # FusedAdaptiveLoop's state across calls: one call of 4 == two of 2
    from pnode_tpu_torch.data import generate_ks_data
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    u, _ = generate_ks_data(nx=64, L=22.0, n_samples=80, dt_data=0.2,
                            cache_dir=str(tmp_path / "data"))
    ys, tgts = _t(u[:64].reshape(4, 16, 64)), _t(u[1:65].reshape(4, 16, 64))

    def fresh():
        pt.clear_options()
        pt.init(["p", "-snes_type", "ksponly"] + ADAPT)
        ex = KSFuncEX(nx=64, use_fused=True,
                      generator=torch.Generator().manual_seed(0))
        ode = pt.ODESolver()
        ode.setupTS(torch.zeros(16, 64), pt.TorchFunc(KSFuncIM(nx=64)),
                    step_size=0.2, method="imex", imex_form=True,
                    implicit_form=True, func2=pt.TorchFunc(ex),
                    linear_solver="hpddm", fixed_jacobian=True,
                    batch_size=16)
        return ks.FusedAdaptiveLoop(ode, ex, 16, 0.2)

    one, two = fresh(), fresh()
    l_one = one.run(ys, tgts, 5e-3)
    l_two = torch.cat([two.run(ys[:2], tgts[:2], 5e-3),
                       two.run(ys[2:], tgts[2:], 5e-3)])
    assert torch.equal(l_one, l_two)
    assert two.dt == one.dt == one.stats["dt_first"][-1]
    for a, b in zip(one.Ws + one.bs, two.Ws + two.bs):
        assert torch.equal(a, b)

    with pytest.raises(SystemExit, match="ran out"):
        ks.main(argv + ["--fused_loop", "-ts_adapt_type", "basic",
                        "-ts_rtol", "1e-9", "-ts_atol", "1e-9",
                        "-ts_adapt_max_steps", "1"])
