"""K12 (the grads-only training step) and the data-parallel fused loop:
CPU twins of tests/test_fused_dp.py and of the JAX package's
``fused_grad_step``.

- ``fused_grad_step`` (its plain version on CPU tensors) against JAX's
  ``fused_grad_step(..., interpret=True, stiff_prec="highest")`` on the same
  numpy operands (B 64, nx 16, hidden 24, fp32): loss rtol 2e-5, dW and db
  rtol 1e-4 (the reference's tolerances, tests/test_fused_dp.py:82-88),
  with the local and a global loss count.
- ``dp_fused_train_loop`` over 8, 2 and 1 gloo ranks (``run_ranks``; 1 with
  ``force_general``) against JAX's single-chip loop kernel and the port's
  K4 plain version on the full batch (:53), the local batch each rank's
  K12 sees (:91) and the uneven batch (:118); the parameters bitwise equal
  across ranks.
- ``examples/ks_torch.py --dp 2 --device cpu`` over two gloo ranks against
  the run without ``--dp``, and its refusals.
Rank bodies live in tests/torch_dp_ranks.py (torch and the port only: each
spawned rank imports it afresh). Every spawn runs under run_ranks's
deadline."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import FlaxFunc, ODESolver
from pnode_tpu.models import KSFuncEX, KSFuncIM
from pnode_tpu.ops.fused_train_loop import LoopLayout as JLayout
from pnode_tpu.ops.fused_train_loop import fused_grad_step as j_grad_step
from pnode_tpu.ops.fused_train_loop import fused_train_loop as j_loop
from pnode_tpu_torch.ops.fused_train_loop import (
    LoopLayout, fused_grad_step, fused_grad_step_cost, fused_grad_step_plain,
    fused_train_loop_cost, fused_train_loop_plain,
)
from pnode_tpu_torch.parallel import run_ranks
from torch_dp_ranks import fused_dp_rank, ks_torch_rank

torch.set_num_threads(1)
LR = 5e-3
DT32 = float(np.float32(0.2))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120.0


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _build(batch, nx, hidden=24):
    """The reference test's operands (tests/test_fused_dp.py:26-49) as
    numpy: tableau, frozen J, stage inverse, the flax init of KSFuncEX's
    fused stack, activation and sign."""
    pnode_tpu.clear_options()
    pnode_tpu.init(["p", "-snes_type", "ksponly", "-ts_arkimex_type", "3",
                    "-pnode_fused_ark_adjoint", "off",
                    "-pnode_fused_ark_precision", "highest"])
    im = KSFuncIM(nx=nx)
    ex = KSFuncEX(nx=nx, hidden=hidden, use_pallas=True)
    key = jax.random.PRNGKey(0)
    y_tmpl = jnp.zeros((batch, nx), jnp.float32)
    vim = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                 im.init(key, 0.0, y_tmpl))
    vex = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                 ex.init(key, 0.0, y_tmpl))
    ode = ODESolver()
    ode.setupTS(y_tmpl, FlaxFunc(im, vim), step_size=0.2, method="imex",
                imex_form=True, implicit_form=True, func2=FlaxFunc(ex, vex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=batch)
    stp = ode._stepper.prepare(0.0, y_tmpl, (vim, vex),
                               dt0=jnp.float32(0.2))
    spec = stp.fused_ex_spec(vex)
    gamma = [g for g in (float(x) for x in np.diag(stp._aI)) if g][0]
    tbl = tuple(np.asarray(a) for a in (stp._aI, stp._aE, stp._bI, stp._bE))
    return (tbl, np.asarray(stp.setup.frozen_J_blocks[0]),
            np.asarray(stp.setup.solver_cache[gamma]._inv[0]),
            [np.asarray(w) for w in spec["Ws"]],
            [np.asarray(b) for b in spec["bs"]], spec["activation"],
            spec["sign"])


def _data(K, batch, nx, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(K, batch, nx)).astype(np.float32)
    return y, (y + 0.05 * rng.normal(size=y.shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- K12 -------------------------------------------------------------------------

@pytest.mark.parametrize("global_count", [None, 4 * 64 * 16])
def test_fused_grad_step_matches_jax(global_count):
    """One iteration on a (64, 16) shard: loss, dW, db against the JAX
    kernel in interpret mode, with the local count and with a global one
    (the loss and the seed both scale)."""
    B, nx = 64, 16
    tbl, J, inv, Ws, bs, act, sign = _build(B, nx)
    y, tgt = _data(1, B, nx, seed=1)
    jl = JLayout(B, nx, [w.shape[1] for w in Ws])
    Wv, bv = jl.pack([jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs])
    ops = tuple(jl.pack_operator(jnp.asarray(a)) for a in (J.T, inv.T, J, inv))
    j_loss, dW, db = j_grad_step(jl, tbl, 0.2, jl.pad_batch(jnp.asarray(y[0])),
                                 jl.pad_batch(jnp.asarray(tgt[0])), *ops, Wv,
                                 bv, activation=act, sign=sign,
                                 interpret=True, stiff_prec="highest",
                                 global_count=global_count)
    j_dW, j_db = jl.unpack(dW, db)

    layout = LoopLayout(B, nx, [w.shape[1] for w in Ws])
    params = layout.pack([_t(w) for w in Ws], [_t(b) for b in bs])
    loss, grad = fused_grad_step(layout, tbl, DT32, _t(y[0]), _t(tgt[0]),
                                 _t(J), _t(inv), params, act, sign,
                                 global_count=global_count)
    t_dW, t_db = layout.unpack(grad)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-5)
    for a, b in zip(t_dW + t_db, j_dW + j_db):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def test_fused_grad_step_is_the_loop_without_adam():
    """One step of K4's plain loop from zero moments leaves m = (1 - b1) g
    and the same loss; the fp64 gradient equals autograd of the plain
    forward step's MSE."""
    B, nx = 8, 16
    tbl, J, inv, Ws, bs, act, sign = _build(B, nx)
    y, tgt = _data(1, B, nx, seed=2)
    layout = LoopLayout(B, nx, [w.shape[1] for w in Ws])
    Wt, bt = [_t(w) for w in Ws], [_t(b) for b in bs]
    loss, grad = fused_grad_step_plain(layout, tbl, DT32, _t(y[0]),
                                       _t(tgt[0]), _t(J), _t(inv),
                                       layout.pack(Wt, bt), act, sign)
    z = ([torch.zeros_like(w) for w in Wt], [torch.zeros_like(b) for b in bt])
    _, _, (mW, mb), _, losses = fused_train_loop_plain(
        tbl, DT32, _t(y), _t(tgt), _t(J), _t(inv), Wt, bt, z, z, 0, act, sign,
        lr=LR)
    assert float(loss) == float(losses[0])
    torch.testing.assert_close(grad, layout.pack(mW, mb) / 0.1, rtol=1e-6,
                               atol=0)

    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd_plain
    W64 = [w.double().requires_grad_(True) for w in Wt]
    b64 = [b.double().requires_grad_(True) for b in bt]
    y1, _ = fused_ark_step_fwd_plain(tbl, 0.2, _t(y[0]).double(),
                                     _t(J).double(), _t(inv).double(), W64,
                                     b64, act, sign)
    ref = torch.autograd.grad(torch.mean((y1 - _t(tgt[0]).double()) ** 2),
                              W64 + b64)
    _, g64 = fused_grad_step_plain(layout, tbl, 0.2, _t(y[0]).double(),
                                   _t(tgt[0]).double(), _t(J).double(),
                                   _t(inv).double(),
                                   layout.pack(W64, b64).detach(), act, sign)
    n = len(Ws)
    torch.testing.assert_close(g64, layout.pack(ref[:n], ref[n:]),
                               rtol=1e-10, atol=1e-14)


def test_loop_layout_and_cost():
    layout = LoopLayout(37, 64, [104] * 4 + [64])
    assert layout.total == 46240
    ws = [torch.randn(a, b) for a, b in zip(layout.dims, layout.dims[1:])]
    bs = [torch.randn(b) for b in layout.dims[1:]]
    flat = layout.pack(ws, bs)
    back_w, back_b = layout.unpack(flat)
    assert all(torch.equal(a, b) for a, b in zip(back_w + back_b, ws + bs))
    assert layout.pad_batch(torch.zeros(3, 37, 64)).shape == (3, 37, 64)
    with pytest.raises(ValueError, match="batch must be"):
        layout.pad_batch(torch.zeros(36, 64))
    tab = ([[0.0] * 4] * 4, None, [0.0] * 4, None)
    flops, byts = fused_grad_step_cost(tab, 256, 64, [104] * 4 + [64])
    loop_flops, _ = fused_train_loop_cost(tab, 256, 64, [104] * 4 + [64], 1)
    assert flops == loop_flops - 10 * 46240
    assert byts == 4 * (2 * 256 * 64 + 2 * 64 * 64 + 2 * 46240 + 1)


def test_fused_grad_step_rejects_what_the_kernel_does_not_take():
    tbl, J, inv, Ws, bs, act, sign = _build(8, 16)
    y, tgt = _data(1, 8, 16, seed=0)
    layout = LoopLayout(8, 16, [w.shape[1] for w in Ws])
    params = layout.pack([_t(w) for w in Ws], [_t(b) for b in bs])
    args = (tbl, DT32, _t(y[0]), _t(tgt[0]), _t(J), _t(inv))
    with pytest.raises(ValueError, match="layout"):
        fused_grad_step(LoopLayout(4, 16, layout.dims[1:]), *args, params)
    with pytest.raises(ValueError, match="tgt"):
        fused_grad_step(layout, tbl, DT32, _t(y[0]), _t(tgt[0])[:4], _t(J),
                        _t(inv), params)
    with pytest.raises(ValueError, match="float32"):
        fused_grad_step(layout, *args, params.double())


# -- the data-parallel loop over gloo ranks --------------------------------------

_RUNS = {}


def _dp_run(n_dev):
    """dp_fused_train_loop over n_dev ranks (B 64, nx 16, K 4; n_dev 1 with
    force_general), the JAX loop kernel and the port's K4 plain version on
    the full batch: computed once per n_dev for the tests below."""
    if n_dev not in _RUNS:
        B, nx, K = 64, 16, 4
        ops = _build(B, nx)
        tbl, J, inv, Ws, bs, act, sign = ops
        rng = np.random.default_rng(1)
        y = rng.normal(size=(K, B, nx)).astype(np.float32)
        tgt = (y + 0.05 * rng.normal(size=y.shape)).astype(np.float32)
        zW = [jnp.zeros_like(w) for w in Ws]
        zb = [jnp.zeros_like(b) for b in bs]
        ref = j_loop(tbl, 0.2, jnp.asarray(y), jnp.asarray(tgt),
                     jnp.asarray(J), jnp.asarray(inv),
                     [jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
                     (zW, zb), (zW, zb), 0, activation=act, sign=sign, lr=LR,
                     interpret=True, stiff_prec="highest")
        Wt, bt = [_t(w) for w in Ws], [_t(b) for b in bs]
        z = ([torch.zeros_like(w) for w in Wt],
             [torch.zeros_like(b) for b in bt])
        plain = fused_train_loop_plain(tbl, DT32, _t(y), _t(tgt), _t(J),
                                       _t(inv), Wt, bt, z, z, 0, act, sign,
                                       lr=LR)
        ranks = run_ranks(n_dev, fused_dp_rank, ops, y, tgt, n_dev == 1,
                          n_dev == 8, timeout=DEADLINE)
        _RUNS[n_dev] = (ref, plain, ranks, (ops, y, tgt))
    return _RUNS[n_dev]


@pytest.mark.parametrize("n_dev", [8, 2, 1])
def test_dp_fused_matches_single_chip_loop(n_dev):
    """Twin of tests/test_fused_dp.py:53: losses rtol 2e-5 / atol 1e-8,
    parameters and moments rtol 1e-4 / atol 1e-7 against JAX's loop kernel
    and against K4's plain version; every rank holds the same parameters,
    bit for bit."""
    ref, plain, ranks, _ = _dp_run(n_dev)
    got = ranks[0]
    want_W, want_b, (mW, mb), (vW, vb), losses = ref
    np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_allclose(got["losses"], plain[4].numpy(), rtol=2e-5,
                               atol=1e-8)
    for a, b in zip(got["Ws"] + got["bs"] + got["m"] + got["v"],
                    list(want_W) + list(want_b) + list(mW) + list(mb)
                    + list(vW) + list(vb)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-7)
    for a, b in zip(got["Ws"] + got["bs"], plain[0] + plain[1]):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-7)
    for other in ranks[1:]:
        for a, b in zip(got["Ws"] + got["bs"] + got["m"] + got["v"],
                        other["Ws"] + other["bs"] + other["m"] + other["v"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["losses"], other["losses"])


def test_dp_fused_per_device_work_scales():
    """Twin of :91: each rank's K12 sees its local shard, B/8 = 8 rows, once
    per iteration, never the global batch of 64."""
    ranks = _dp_run(8)[2]
    for r in ranks:
        assert r["shapes"] == [(8, 16)] * 4


def test_dp_fused_uneven_batch_rejected():
    """Twin of :118: a global batch of 60 over 8 ranks raises."""
    ranks = _dp_run(8)[2]
    for r in ranks:
        assert "must divide" in r["uneven"]


def test_dp_fused_one_rank_delegates_to_k4():
    """Without force_general one rank runs K4 (its plain version here):
    the result equals fused_train_loop_plain's bitwise, and K12 never
    runs; force_general ran it once per iteration (see _dp_run(1))."""
    _, plain, ranks, (ops, y, tgt) = _dp_run(1)
    assert ranks[0]["shapes"] == [(64, 16)] * 4
    out = run_ranks(1, fused_dp_rank, ops, y, tgt, False, False,
                    timeout=DEADLINE)[0]
    assert out["shapes"] == []
    for a, b in zip(out["Ws"] + out["bs"], plain[0] + plain[1]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(out["losses"], plain[4].numpy())


# -- examples/ks_torch.py --dp ---------------------------------------------------

def _ks_torch():
    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(REPO, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ks_torch_dp_drive(tmp_path, capsys):
    """--dp 2 over two gloo ranks: every rank's first-epoch train losses
    equal the run without --dp within 1e-5 relative (a mean of two local
    means against one mean, in fp32), and equal across ranks; --dp 1
    starts its own one-rank group."""
    argv = ["--device", "cpu", "--max_epochs", "1", "--data_size", "80",
            "--batch_size", "16", "--train_dir", str(tmp_path)]
    ks = _ks_torch()
    _, ref = ks.main(argv)
    _, one = ks.main(argv + ["--dp", "1"])
    assert "data-parallel: 1 device(s), 16 samples/device" in \
        capsys.readouterr().out
    np.testing.assert_allclose(one[0], ref[0], rtol=1e-6)
    ranks = run_ranks(2, ks_torch_rank, argv + ["--dp", "-1"],
                      timeout=DEADLINE)
    assert len(ranks[0][0]) == len(ref[0]) == 3
    np.testing.assert_allclose(ranks[0][0], ref[0], rtol=1e-5)
    np.testing.assert_array_equal(ranks[0][0], ranks[1][0])


def test_ks_torch_dp_refusals(tmp_path):
    """As examples/ks.py --dp: --fused_loop is refused, N must divide the
    batch, and N ranks must exist."""
    ks = _ks_torch()
    argv = ["--device", "cpu", "--max_epochs", "1", "--data_size", "80",
            "--batch_size", "16", "--train_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="fused_loop"):
        ks.main(argv + ["--dp", "2", "--fused_loop"])
    with pytest.raises(SystemExit, match="must divide"):
        ks.main(argv + ["--dp", "3"])
    with pytest.raises(SystemExit, match="2 ranks"):
        ks.main(argv + ["--dp", "2"])
