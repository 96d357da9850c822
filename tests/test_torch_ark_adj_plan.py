"""K3's and K12's launch plans and their plain versions at the KS widths.

``ark_adj_plan`` and ``grad_step_plan`` (ops/fused_ark_adjoint.py) mirror
the C plans of the fused ARK reverse step (K3) and the grads-only training
step (K12) (csrc/ark_tiles.cuh plan_rev; entry points pnode_ark_adj_plan
and pnode_grad_step_plan): rows per block, grid and shared-memory bytes.
The pinned triples are the C plans' own on an H100 (132 SMs), which
chip_smoke.py's build phase holds against these mirrors at the same
shapes. Beside them: the rule's dependence on the SM count, the refusals
(more than 8 stages or layers, a layer wider than a product takes), inv
and J read in place where their staged copies do not fit, the smaller
layer store where the whole one does not fit at one row, the fits gate's
answers (the plans at one row per block, Burgers-512 open) and the
wrappers' and the loop kernels' gates. Then
K3's and K12's plain versions against the JAX package's ``_kernel`` and
``_grad_kernel`` in interpret mode at d 64, hidden 104, B 16, ARK3, at the
tolerances of tests/test_torch_fused_ark.py (reverse rtol 2e-4 / atol
1e-6) and tests/test_torch_fused_dp.py (loss rtol 2e-5; dW, db rtol 1e-4 /
atol 1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.ops.fused_ark_adjoint import fused_ark_step_adj as j_adj
from pnode_tpu.ops.fused_ark_forward import fused_ark_step_fwd as j_fwd
from pnode_tpu.ops.fused_train_loop import LoopLayout as JLayout
from pnode_tpu.ops.fused_train_loop import fused_grad_step as j_grad_step
from pnode_tpu.tableaus import get_ark_tableau
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    MAX_SMEM_BYTES, _rev_plan_rows, ark_adj_plan, ark_fwd_plan,
    forced_rows, fused_ark_fits, fused_ark_step_adj, grad_step_plan,
    rev_plan_full,
)
from pnode_tpu_torch.ops.fused_adaptive_loop import fused_adaptive_train_loop
from pnode_tpu_torch.ops.fused_train_loop import (
    LoopLayout, fused_grad_step, fused_train_loop, fused_train_loop_fits,
    fused_train_loop_plain,
)
from pnode_tpu_torch.parallel import run_ranks
from torch_dp_ranks import fused_dp_rank

torch.set_num_threads(1)

KS = [104] * 4 + [64]
BURGERS = [576] * 4 + [512]

# (B, d, layer widths, stages) -> the C plans' (rows, grid, bytes) on 132
# SMs, K3's then K12's: chip_smoke.py's FWD_PLANS and the DP shards of
# world 2, 4 and 8 (B_local 128, 64, 32). From d 200 up (Burgers-512
# included) inv and J are read in place. At Burgers-512 K3's R 2 (100
# blocks) fits, but its ring chunks hold one row: the rule takes R 1.
C_PLANS = [
    ((256, 64, KS, 4), (2, 128, 166656), (2, 128, 168192)),
    ((37, 64, KS, 4), (1, 37, 144896), (1, 37, 145664)),
    ((1, 64, KS, 4), (1, 1, 144896), (1, 1, 145664)),
    ((3173, 64, KS, 4), (8, 397, 232448), (8, 397, 232448)),
    ((200, 512, BURGERS, 4), (1, 200, 232448), (1, 200, 232448)),
    ((200, 512, BURGERS, 8), (1, 200, 232448), (1, 200, 232448)),
    ((37, 200, [200, 200], 4), (1, 37, 232448), (1, 37, 232448)),
    ((37, 300, [300], 4), (1, 37, 232448), (1, 37, 232432)),
    ((37, 13, [100, 13], 4), (1, 37, 17328), (1, 37, 17472)),
    ((37, 100, [13, 100], 4), (1, 37, 99824), (1, 37, 101024)),
    ((37, 64, [64], 2), (1, 37, 75008), (1, 37, 75264)),
    ((37, 64, [24] * 7 + [64], 6), (1, 37, 63104), (1, 37, 64384)),
    ((16, 64, [1100, 64], 4), None, None),
    ((128, 64, KS, 4), (1, 128, 144896), (1, 128, 145664)),
    ((64, 64, KS, 4), (1, 64, 144896), (1, 64, 145664)),
    ((32, 64, KS, 4), (1, 32, 144896), (1, 32, 145664)),
]


@pytest.mark.parametrize("shape, adj, grad", C_PLANS,
                         ids=[f"B{a[0]}-d{a[1]}-s{a[3]}-{len(a[2])}l"
                              for a, _, _ in C_PLANS])
def test_mirrors_equal_the_c_plans(shape, adj, grad):
    assert ark_adj_plan(*shape) == adj
    assert grad_step_plan(*shape) == grad
    for plan in (adj, grad):
        assert plan is None or plan[2] <= MAX_SMEM_BYTES


def test_rule_halves_rows_while_a_chunk_holds_fewer_than_8_rows():
    """At Burgers-512 B 200, K3's R 2 (100 blocks) fits with one 580-float
    row of W per ring chunk (92.2 ms on the card against R 1's 10.0 ms,
    PERF.md), so the rule halves to R 1 (25 rows a chunk); forced R
    2 still takes its layout. The KS plans keep whole layers a chunk."""
    dims = [512] + BURGERS
    assert _rev_plan_rows(2, 512, dims, 4, 4, False, False) is not None
    assert _rev_plan_rows(2, 512, dims, 4, 4, False, False, 0, 8) is None
    assert _rev_plan_rows(1, 512, dims, 4, 4, False, False, 0, 8) is not None
    assert ark_adj_plan(200, 512, BURGERS, 4)[:2] == (1, 200)
    assert forced_rows(512, BURGERS, 4) == [1, 2]
    assert rev_plan_full(200, 512, tuple(BURGERS), 4, 132, 0, 2)[:2] == (
        2, 100)
    assert ark_adj_plan(256, 64, KS, 4)[:2] == (2, 128)


@pytest.mark.parametrize("sms, B, rows", [(132, 132, 1), (132, 133, 2),
                                          (132, 264, 2), (132, 265, 4),
                                          (64, 256, 4), (16, 256, 8),
                                          (8, 256, 8)])
def test_rows_are_the_fewest_whose_grid_fits_one_block_per_sm(sms, B, rows):
    for plan in (ark_adj_plan, grad_step_plan):
        assert plan(B, 64, KS, 4, sms)[:2] == (rows, -(-B // rows))


@pytest.mark.parametrize("args", [
    (16, 1100, [1100], 4),            # a state wider than 256 x 4 columns
    (16, 64, [64, 1025, 64], 4),      # a layer wider than 256 x 4 columns
    (16, 64, [1100, 64], 4),
    (16, 64, [104] * 8 + [64], 4),    # 9 layers
    (16, 64, KS, 9),                  # 9 stages
    (16, 64, KS, 0),
    (16, 64, [104] * 4 + [32], 4),    # the MLP does not map d to d
    (0, 64, KS, 4),
    (16, 64, [0, 64], 4),
])
def test_plans_refuse(args):
    assert ark_adj_plan(*args) is None
    assert grad_step_plan(*args) is None


@pytest.mark.parametrize("d, layers", [(163, [163]), (164, [164]),
                                       (200, [200, 200]), (300, [300]),
                                       (512, BURGERS)])
def test_inv_and_j_are_read_in_place_where_they_do_not_fit(d, layers):
    """Two (d, d) copies at an odd stride fit beside one row's scratch and
    every stage's store up to d 163 (one d-wide layer, 4 stages); past it
    the plans read inv and J from device memory, and a forced R takes the
    same layouts."""
    dims = [d] + layers
    for grad in (False, True):
        staged = _rev_plan_rows(1, d, dims, 4, 4, grad, True)
        in_place = _rev_plan_rows(1, d, dims, 4, 4, grad, False)
        assert in_place is not None
        if d <= 163:
            assert staged is not None and staged > in_place
        else:
            assert staged is None
        assert forced_rows(d, layers, 4, grad)[0] == 1
    assert ark_adj_plan(37, d, layers, 4) is not None
    assert grad_step_plan(37, d, layers, 4) is not None


def test_store_shrinks_at_one_row_where_the_whole_one_does_not_fit():
    """Four 1024-wide layers at 8 stages: no R holds all 8 stages' layer
    inputs and covectors, so the plan takes one row and the most stage
    slots that fit (5); the weights stream in chunks."""
    dims = [64] + [1024] * 4 + [64]
    for R in (1, 2, 4, 8):
        assert _rev_plan_rows(R, 64, dims, 8, 8, False) is None
    assert _rev_plan_rows(1, 64, dims, 8, 6, False) is None
    assert _rev_plan_rows(1, 64, dims, 8, 5, False) == MAX_SMEM_BYTES
    assert ark_adj_plan(256, 64, dims[1:], 8) == (1, 256, MAX_SMEM_BYTES)


def test_ks_store_grows_with_the_stages():
    """At KS B 256, R 2: each stage slot holds two rows of every layer's
    input and covector (2 x 960 floats)."""
    base = ark_adj_plan(256, 64, KS, 1)
    for s in (2, 4, 6):
        rows, grid, smem = ark_adj_plan(256, 64, KS, s)
        assert (rows, grid) == (2, 128)
        # per stage: one xi tile (2 x 64) and one store slot (2 x 960)
        assert smem == base[2] + 4 * (s - 1) * (2 * 64 + 2 * 960)


def test_fits_gate_answers_at_ks_and_burgers():
    """The gate is the plans at one row per block: KS and Burgers-512 fit
    both step kernels at 4 and 8 stages (K3 reads Burgers-512's inv and J
    in place), 9 stages fit neither."""
    assert fused_ark_fits(64, KS, 4)
    assert fused_ark_fits(64, KS, 8)
    assert fused_ark_fits(512, BURGERS, 4, reverse=False)
    assert fused_ark_fits(512, BURGERS, 4)
    assert fused_ark_fits(512, BURGERS, 8)
    assert not fused_ark_fits(64, KS, 9)
    assert ark_adj_plan(1, 64, KS, 4) == (1, 1, 144896)
    assert ark_adj_plan(1, 512, BURGERS, 4) == (1, 1, MAX_SMEM_BYTES)


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
def test_fits_gate_is_the_plans_and_they_take_every_batch(stages):
    """The reverse gate opens exactly where the forward plan and K3's plan
    do at one row per block, and wherever it opens, K3's plan takes every
    batch; wherever K4's gate and the step kernels' open (as
    fused_grad_step asks), K12's plan does."""
    rng = np.random.default_rng(stages)
    for _ in range(300):
        d = int(rng.integers(1, 800))
        hidden = [int(rng.integers(1, 1100))
                  for _ in range(int(rng.integers(0, 8)))]
        layers = hidden + [d]
        want = (ark_fwd_plan(1, d, layers, stages) is not None
                and ark_adj_plan(1, d, layers, stages) is not None)
        assert fused_ark_fits(d, layers, stages) == want
        for B in (1, 37, 256, 3173):
            if want:
                assert ark_adj_plan(B, d, layers, stages) is not None
            if want and fused_train_loop_fits(B, d, layers, stages=stages):
                assert grad_step_plan(B, d, layers, stages) is not None


def _tableau(name):
    t = get_ark_tableau(name)
    return ([[float(x) for x in r] for r in t.a_im],
            [[float(x) for x in r] for r in t.a_ex],
            [float(x) for x in t.b_im], [float(x) for x in t.b_ex]), t


def _operands(name, B, d, layers, seed, dt=0.2):
    tbl, t = _tableau(name)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    J = -2.0 * (A @ A.T) / d
    gamma = [g for g in np.diag(t.a_im) if g != 0.0][0]
    inv = np.linalg.inv(np.eye(d) - dt * gamma * J)
    dims = [d] + list(layers)
    Ws = [rng.normal(0, a ** -0.5, size=(a, b)) for a, b in zip(dims, dims[1:])]
    bs = [0.1 * rng.normal(size=b) for b in dims[1:]]
    y = rng.normal(size=(B, d))
    lam = rng.normal(size=(B, d))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (tbl, float(np.float32(dt)), f32(y), f32(J), f32(inv),
            [f32(w) for w in Ws], [f32(b) for b in bs], f32(lam))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_wrappers_gate_on_the_plans():
    """fused_ark_step_adj and fused_grad_step take the Burgers-512 stack,
    whose plans read inv and J in place (on CPU tensors: their plain
    versions), and refuse a layer wider than a product takes, whatever the
    device."""
    tbl, dt, y, J, inv, Ws, bs, lam = _operands("3", 2, 512, BURGERS, seed=4,
                                                dt=1e-3)
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    ys = torch.zeros(4, 2, 512)
    lp, _ = fused_ark_step_adj(tbl, dt, ys, _t(lam), _t(J), _t(inv), W, b)
    assert lp.shape == (2, 512) and bool(torch.isfinite(lp).all())
    layout = LoopLayout(2, 512, BURGERS)
    loss, grad = fused_grad_step(layout, tbl, dt, _t(y), _t(y), _t(J),
                                 _t(inv), layout.pack(W, b))
    assert grad.shape == (layout.total,) and bool(torch.isfinite(loss))
    tbl, dt, y, J, inv, Ws, bs, lam = _operands("3", 2, 64, [1100, 64],
                                                seed=5)
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    with pytest.raises(ValueError, match="shared-memory budget"):
        fused_ark_step_adj(tbl, dt, torch.zeros(4, 2, 64), _t(lam), _t(J),
                           _t(inv), W, b)
    layout = LoopLayout(2, 64, [1100, 64])
    with pytest.raises(ValueError, match="shared-memory budget"):
        fused_grad_step(layout, tbl, dt, _t(y), _t(y), _t(J), _t(inv),
                        layout.pack(W, b))


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_k3_plain_matches_jax_interpret_at_ks_widths(act):
    """K3's plain version (what chip_smoke holds the kernel to) against the
    JAX package's _kernel in interpret mode at d 64, hidden 104, B 16,
    ARK3, on the JAX forward's stage values."""
    tbl, dt, y, J, inv, Ws, bs, lam = _operands("3", 16, 64, KS, seed=7)
    jW, jb = [jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs]
    _, ys = j_fwd(tbl, dt, jnp.asarray(y), jnp.asarray(J), jnp.asarray(inv),
                  jW, jb, activation=act, interpret=True,
                  stiff_prec="highest")
    ys = np.asarray(ys)
    lp_j, (dW_j, db_j) = j_adj(tbl, dt, jnp.asarray(ys), jnp.asarray(lam),
                               jnp.asarray(J), jnp.asarray(inv), jW, jb,
                               activation=act, sign=-1.0, interpret=True,
                               stiff_prec="highest")
    lp_t, (dW_t, db_t) = fused_ark_step_adj(
        tbl, dt, _t(ys), _t(lam), _t(J), _t(inv), [_t(w) for w in Ws],
        [_t(b) for b in bs], activation=act, sign=-1.0)
    pairs = [(lp_t, lp_j)] + list(zip(dW_t, dW_j)) + list(zip(db_t, db_j))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=1e-6)


def test_k12_plain_matches_jax_interpret_at_ks_widths():
    """K12's plain version against the JAX package's _grad_kernel in
    interpret mode at d 64, hidden 104, B 16, ARK3: loss, dW and db."""
    tbl, dt, y, J, inv, Ws, bs, _ = _operands("3", 16, 64, KS, seed=8)
    tgt = (y + 0.05 * np.random.default_rng(9).normal(size=y.shape)).astype(
        np.float32)
    jl = JLayout(16, 64, KS)
    Wv, bv = jl.pack([jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs])
    ops = tuple(jl.pack_operator(jnp.asarray(a)) for a in (J.T, inv.T, J, inv))
    j_loss, dW, db = j_grad_step(jl, tbl, dt, jl.pad_batch(jnp.asarray(y)),
                                 jl.pad_batch(jnp.asarray(tgt)), *ops, Wv, bv,
                                 interpret=True, stiff_prec="highest")
    j_dW, j_db = jl.unpack(dW, db)
    layout = LoopLayout(16, 64, KS)
    params = layout.pack([_t(w) for w in Ws], [_t(b) for b in bs])
    loss, grad = fused_grad_step(layout, tbl, dt, _t(y), _t(tgt), _t(J),
                                 _t(inv), params)
    t_dW, t_db = layout.unpack(grad)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-5)
    for a, b in zip(t_dW + t_db, j_dW + j_db):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def _wide_case(B, K, d=200, seed=5):
    """A d-wide case past the staged operators' reach: ARK3, one d-wide
    hidden layer, J = -2 A A^T / d, K minibatches."""
    tbl, dt, y, J, inv, Ws, bs, lam = _operands("3", B, d, [d, d], seed)
    rng = np.random.default_rng(seed + 1)
    ys = rng.normal(size=(K, B, d)).astype(np.float32)
    tgt = (ys + 0.05 * rng.normal(size=ys.shape)).astype(np.float32)
    return tbl, dt, J, inv, Ws, bs, lam, ys, tgt


def test_step_wrappers_take_d_200():
    """K3 and K12 take d 200 (their plans read inv and J in place): on CPU
    tensors they run their plain versions."""
    tbl, dt, J, inv, Ws, bs, lam, ys, tgt = _wide_case(4, 4)
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    lp, (dW, db) = fused_ark_step_adj(tbl, dt, _t(ys), _t(lam), _t(J),
                                      _t(inv), W, b)
    assert lp.shape == (4, 200) and bool(torch.isfinite(lp).all())
    layout = LoopLayout(4, 200, [200, 200])
    loss, grad = fused_grad_step(layout, tbl, dt, _t(ys[0]), _t(tgt[0]),
                                 _t(J), _t(inv), layout.pack(W, b))
    assert grad.shape == (layout.total,) and bool(torch.isfinite(loss))


def test_loop_kernels_gate_on_their_own_budgets_at_d_200():
    """K4 and the DP loop (two gloo ranks, K12 on each shard) take d 200,
    as their own gate (fused_train_loop_fits) says, and the DP loop's
    losses and parameters match K4's plain loop; K5 refuses it by its own
    gate, not by the step kernels' reverse gate."""
    tbl, dt, J, inv, Ws, bs, _, ys, tgt = _wide_case(4, 2)
    assert fused_train_loop_fits(4, 200, [200, 200])
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    z = ([torch.zeros_like(w) for w in W], [torch.zeros_like(v) for v in b])
    args = (tbl, dt, _t(ys), _t(tgt), _t(J), _t(inv), W, b, z, z, 0)
    got = fused_train_loop(*args, lr=5e-3)  # torch_dp_ranks' rate
    plain = fused_train_loop_plain(*args, lr=5e-3)
    for a, c in zip(got[0] + got[1] + [got[4]], plain[0] + plain[1]
                    + [plain[4]]):
        assert torch.equal(a, c)
    ops = (tbl, J, inv, Ws, bs, "relu", -1.0)
    ranks = run_ranks(2, fused_dp_rank, ops, ys, tgt, False, False,
                      timeout=120.0)
    assert ranks[0]["shapes"] == [(2, 200)] * 2
    np.testing.assert_allclose(ranks[0]["losses"], plain[4].numpy(),
                               rtol=2e-5, atol=1e-8)
    for a, c in zip(ranks[0]["Ws"] + ranks[0]["bs"], plain[0] + plain[1]):
        np.testing.assert_allclose(a, c.numpy(), rtol=1e-4, atol=1e-7)
    tab6 = tuple(tbl) + (tuple(tbl[2]), tuple(tbl[3]))
    with pytest.raises(ValueError, match="adaptive loop kernel's"):
        fused_adaptive_train_loop(
            tab6, 0.4, torch.zeros(200), torch.eye(200), _t(J), 0.2, 0.01,
            _t(ys), _t(tgt), W, b, z, z, 0, 4, order=3)
