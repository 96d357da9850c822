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
wrappers' and the loop kernels' gates. The grid form (K3's, K4's, K12's
and K2's plans where the row form cannot keep inv and J resident:
Burgers-512, d 200, d 300, d 197): its tiles walked from the mirror
(``grid_phases``) for each of the four kinds, each output and each
layer's dW/db covered once at any grid, the workspace's regions disjoint
inside what the wrappers allocate; K3's and K12's launch arguments through
a stand-in for the kernel library. Then
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
from pnode_tpu_torch.ops import fused_ark_adjoint as adj
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    GRID_FWD, GRID_GRAD, GRID_KINDS, GRID_LOOP, GRID_MIN_D, GRID_SMEM,
    GRID_STEP, MAX_SMEM_BYTES, REV_GRAD, _rev_plan_rows, ark_adj_plan, ark_fwd_plan,
    forced_rows, fused_ark_fits, fused_ark_step_adj, grad_step_plan,
    grid_phases, grid_plan, grid_workspace, rev_plan_full,
)
from pnode_tpu_torch.ops.fused_mlp import grad_buffer_size
from pnode_tpu_torch.ops.fused_adaptive_loop import fused_adaptive_train_loop
from pnode_tpu_torch.ops import fused_train_loop as ftl
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
# included) the row form cannot keep inv and J resident: K3 takes the grid
# form there (rows 0, one block per SM), K12 from d 280 up (Burgers-512, d
# 300; before it K12 took the row form reading them in place: (1, 200,
# 232448) at Burgers-512, (1, 37, 232432) at d 300), keeping the row form
# at d 200, where it is faster.
GRID = (0, 132, GRID_SMEM)
C_PLANS = [
    ((256, 64, KS, 4), (2, 128, 166656), (2, 128, 168192)),
    ((37, 64, KS, 4), (1, 37, 144896), (1, 37, 145664)),
    ((1, 64, KS, 4), (1, 1, 144896), (1, 1, 145664)),
    ((3173, 64, KS, 4), (8, 397, 232448), (8, 397, 232448)),
    ((200, 512, BURGERS, 4), GRID, GRID),
    ((200, 512, BURGERS, 8), GRID, GRID),
    ((37, 200, [200, 200], 4), GRID, (1, 37, 232448)),
    ((37, 300, [300], 4), GRID, GRID),
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
    """At Burgers-512 B 200, the row form's R 2 (100 blocks) fits with one
    580-float row of W per ring chunk (92.2 ms on the card against R 1's
    10.0 ms, PERF.md), so the rule halves to R 1 (25 rows a chunk); K3 and
    K12 take the grid form there (inv and J not resident), and forced R 1
    and 2 still take their row layouts. The KS plans keep whole layers a
    chunk."""
    dims = [512] + BURGERS
    assert _rev_plan_rows(2, 512, dims, 4, 4, False, False) is not None
    assert _rev_plan_rows(2, 512, dims, 4, 4, False, False, 0, 8) is None
    assert _rev_plan_rows(1, 512, dims, 4, 4, False, False, 0, 8) is not None
    assert rev_plan_full(200, 512, tuple(BURGERS), 4, 132, 0)[:2] == (1, 200)
    assert rev_plan_full(200, 512, tuple(BURGERS), 4, 132,
                         REV_GRAD)[:2] == (1, 200)
    assert ark_adj_plan(200, 512, BURGERS, 4)[:2] == (0, 132)
    assert grad_step_plan(200, 512, BURGERS, 4)[:2] == (0, 132)
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
    assert ark_adj_plan(1, 512, BURGERS, 4) == GRID


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


def test_grid_form_at_burgers_and_row_form_at_ks():
    """K3's, K4's, K12's and K2's plans take the grid form at Burgers-512
    (B 200 and the two-rank shard B 100, 4 and 8 stages) and at d 300,
    where the row form reads inv and J in place; at d 200 and 197 K3 and
    K4 do, K12 and K2 keep the row form (faster there: their grid form
    waits for d GRID_MIN_D); the row form at every pinned KS shape (K12
    took the row form everywhere before). The form follows the row plan's
    residency (and K2's and K12's the width), so the gates do not move."""
    from pnode_tpu_torch.ops.fused_train_loop import train_loop_plan

    for s in (4, 8):
        for B in (200, 100):
            assert ark_adj_plan(B, 512, BURGERS, s) == GRID
            assert train_loop_plan(B, 512, BURGERS, s) == GRID
            assert grad_step_plan(B, 512, BURGERS, s) == GRID
            assert ark_fwd_plan(B, 512, BURGERS, s) == GRID
        for kind in GRID_KINDS:
            assert grid_plan(kind, 200, 512, BURGERS, s)[:2] == GRID[1:]
    for d, layers in ((200, [200, 200]), (300, [300]), (197, [201, 197])):
        for plan in (ark_adj_plan, train_loop_plan):
            assert plan(37, d, layers, 4) == GRID
        for plan in (grad_step_plan, ark_fwd_plan):
            assert (plan(37, d, layers, 4) == GRID) == (d >= GRID_MIN_D)
    assert ark_adj_plan(200, 512, BURGERS, 4, sms=64)[:2] == (0, 64)
    assert grad_step_plan(200, 512, BURGERS, 4, sms=64)[:2] == (0, 64)
    for shape, want, _ in C_PLANS:
        for kind, plan, min_d in ((0, ark_adj_plan, 0),
                                  (REV_GRAD, grad_step_plan, GRID_MIN_D)):
            full = rev_plan_full(shape[0], shape[1], tuple(shape[2]),
                                 shape[3], 132, kind)
            if full is not None:
                assert (plan(*shape)[0] == 0) == (not full[3]
                                                  and shape[1] >= min_d)
        if shape[1] == 64 and want is not None:
            assert ark_adj_plan(*shape)[0] > 0
            assert train_loop_plan(*shape)[0] > 0
            assert grad_step_plan(*shape)[0] > 0
            assert ark_fwd_plan(*shape)[0] > 0


# grid-form shapes: Burgers-512 at bench.py's B 200, a B no tile height
# divides (37), d 200 at B 50, an 8-stage tableau, a tableau whose stage 1
# has no explicit weight (ARK 4), one layer (ARK 4 and ARK3, whose
# explicit stage 0 has no MLP product to share its stiff product's
# phase), rows of 197 and 201 floats (not 16-byte aligned), and LATE's
# explicit stage 1 at one and two layers
GRID_CASES = [
    (200, 512, BURGERS, "3"), (37, 512, BURGERS, "3"),
    (50, 200, [200, 200], "3"), (13, 200, [200, 200], "5"),
    (9, 300, [300], "4"), (7, 300, [300, 300], "3"),
    (37, 300, [300], "3"), (37, 197, [201, 197], "3"),
    (37, 300, [300], "late"), (9, 200, [200, 200], "late"),
]
GRID_IDS = [f"B{c[0]}-d{c[1]}-{len(c[2])}l-ARK{c[3]}" for c in GRID_CASES]


def grid_tile(M, N, t):
    """Output tile t of an (M, N) product, row-major over the tile grid
    (csrc/ark_grid.cuh gemm_tile): (first row, first column, rows,
    columns)."""
    ntn = -(-N // 32)
    m0, n0 = t // ntn * 32, t % ntn * 32
    return m0, n0, min(32, M - m0), min(32, N - n0)


def grid_tiles(M, N):
    return -(-M // 32) * -(-N // 32)


def grid_reduction_order(K, G, v):
    """The reduction indices in the order a tile's chains take them
    (csrc/ark_grid.cuh red_index over group_len's positions): group 0's,
    then group 1's, ... (a chain per group, summed in group order)."""
    nb = -(-K // v)
    order = []
    for g in range(G):
        length = (nb - g + G - 1) // G * v if g < nb else 0
        order += [g + G * q if v == 1 else 4 * (g + G * (q >> 2)) + (q & 3)
                  for q in range(length)]
    return order


@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("B, d, layers, tname", GRID_CASES, ids=GRID_IDS)
def test_grid_tiles_cover_every_output_once(B, d, layers, tname, kind):
    """Walks the grid form's phases from the mirror: every product's tiles
    cover its (M, N) output exactly once, the blocks of any grid take each
    tile once, each tile's reduction takes every k once (the row form's
    groups), the outputs and operands lie inside their workspace regions,
    and the dW/db products cover each layer's [W; b] once, so the whole
    flat gradient (K2 has none). The tile groups (two a block) take tile t at group t //
    grid of block t % grid, then every 2 grid tiles. The regions are
    disjoint, 16-byte aligned and inside the workspace the plan (and so
    the wrapper) allocates."""
    tbl, _ = _tableau(tname)
    s = len(tbl[2])
    regions, total = grid_workspace(kind, B, d, layers, s)
    assert grid_plan(kind, B, d, layers, s)[2] == total
    spans = sorted((o, o + f) for o, f in regions.values())
    assert all(o % 4 == 0 for o, _ in spans) and spans[-1][1] <= total
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    dims = [d] + layers
    woff = np.cumsum([0] + [K * N + N for K, N in zip(dims, dims[1:])])
    grads = np.zeros(grad_buffer_size(dims), int)
    phases = grid_phases(kind, B, d, layers, tbl)
    for phase in phases:
        prods = phase["products"]
        ntile = sum(grid_tiles(p["M"], p["N"]) for p in prods)
        for grid in (132, 66, 5):
            walked = sorted(t for b in range(grid) for g in range(2)
                            for t in range(b + g * grid, ntile, 2 * grid))
            assert walked == list(range(ntile))
        for p in prods:
            M, N, K = p["M"], p["N"], p["K"]
            cover = np.zeros((M, N), int)
            for t in range(grid_tiles(M, N)):
                m0, n0, r, c = grid_tile(M, N, t)
                assert r > 0 and c > 0
                cover[m0:m0 + r, n0:n0 + c] += 1
            assert (cover == 1).all()
            order = grid_reduction_order(K, p["G"], p["v"])
            assert sorted(order) == list(range(K))
            for name, off, ld, kmajor in (p["a"], p["b"]):
                rows = K if kmajor else (N if (name, off, ld, kmajor) == p[
                    "b"] else M - (p["ones"] >= 0))
                if name in regions:
                    assert off + rows * ld <= regions[name][1]
            if p["epi"] in ("grad", "adam"):
                grads[woff[p["layer"]]:woff[p["layer"]] + M * N] += 1
            elif p["out"] is not None:
                name, first = p["out"]
                assert p["ldo"] == N and first + M * N <= regions[name][1]
    assert (grads == (0 if kind == GRID_FWD else 1)).all()
    # the step's phases: K3's staging and recompute or the forward (K4,
    # K12, K2: a phase per layer and stage at least), then but for K2 per
    # reached stage its backprop (and an implicit stage's solve), then dW
    n = len(layers)
    want = {GRID_STEP: s + 1 + n, GRID_FWD: s * n}.get(kind, s + 1 + s * n)
    assert len(phases) >= want


def _grid_accesses(kind, B, d, layers, tbl, phase):
    """What a phase's tiles read and write, as csrc/ark_grid.cuh's
    tile_epilogue and phase_pre do: (owner, region, first, end, mode)
    with mode "read" for a product's staged operands and the biases (any
    tile reads any of it), "pr" / "pw" for an epilogue's reads and writes
    at its own outputs' elements e < M ldo (the thread that writes an
    element is the one that reads it there: owner (product, region,
    first)). Regions: the workspace's, "W{l}", "b{l}", "J", "inv", the
    inputs "y", "tgt", "lam_in", and the outputs "lam_prev", "grads",
    Adam's "m", "v", K2's "ys", "y1" and "err"."""
    aI, s = tbl[0], len(tbl[2])
    dims, n, bd = [d] + list(layers), len(layers), B * d
    woff = np.cumsum([0] + [K * N + N for K, N in zip(dims, dims[1:])])
    um, em = adj.reach_masks(tbl)
    reached = [j for j in range(s) if (um | em) >> j & 1]
    acc = []
    if phase["pre"] == "loss":
        acc.append(("pre", "lrow", 0, B, "read"))
    elif phase["pre"] == "rows":
        acc += [("pre", "diff", 0, bd, "read"), ("pre", "lrow", 0, B, "pw")]
    for j, p in enumerate(phase["products"]):
        span = p["M"] * p["ldo"]

        def pt(mode, name, first, size=span):
            acc.append(((j, name, first), name, first, first + size, mode))

        def covectors(i, cur):
            for mm in reached:
                if mm > i and mm != cur:
                    pt("pr", "xi", mm * bd)
            pt("pw", "u", i * bd)
            if em >> i & 1:
                pt("pw", f"g{n - 1}", (s - 1 - i) * bd)
            elif aI[i][i] != 0.0 and um >> i & 1:
                pt("pw", "q", i * bd)

        def xi_done(i):
            pt("pr", "lam" if kind in (GRID_LOOP, GRID_GRAD) else "lam_in",
               0)
            pt("pw", "xi", i * bd)
            lower = [m for m in reached if m < i]
            if lower:
                covectors(lower[-1], i)
            elif kind == GRID_STEP:
                for st in reached:
                    if st != i:
                        pt("pr", "xi", st * bd)
                pt("pw", "lam_prev", 0)

        M, N, K = p["M"], p["N"], p["K"]
        for op, rows in (("a", M - (p["ones"] >= 0)), ("b", N)):
            name, off, ld, kmajor = p[op]
            acc.append((j, name, off, off + (K if kmajor else rows) * ld,
                        "read"))
        i, l, epi = p["stage"], p["layer"], p["epi"]
        hu, he, impl = um >> i & 1, em >> i & 1, aI[i][i] != 0.0
        if epi == "act":
            acc.append((j, f"b{l}", 0, N, "read"))
            pt("pw", *p["out"])
        elif epi == "backprop":
            pt("pr", *p["aux"])
            pt("pw", *p["out"])
        elif epi == "pv":
            pt("pw", "pv", 0)
        elif epi == "stage_end":
            if he and hu and not impl:
                pt("pr", "pv", 0)
            if not impl:
                xi_done(i)
            else:
                if hu:
                    pt("pr", "u", i * bd)
                pt("pw", "q", i * bd)
        elif epi == "xi":
            if hu:
                pt("pr", "u", i * bd)
            xi_done(i)
        elif epi == "grad":
            pt("pw", "grads", woff[l])
        elif epi == "adam":
            for name in ("m", "v"):
                pt("pr", name, woff[l])
                pt("pw", name, woff[l])
            pt("pw", f"W{l}", 0, dims[l] * N)
            pt("pw", f"b{l}", 0, N)
        elif epi == "fwd_stiff":
            pt("pr", *p["a"][:2])
            pt("pw", "ys", (i if kind == GRID_FWD else s - 1 - i) * bd)
            pt("pw", "kI", i * bd)
        elif epi == "fwd_ke":
            acc.append((j, f"b{n - 1}", 0, N, "read"))
            pt("pr", "y", 0)
            pt("pw", "kE", i * bd)
            for jj in range(i + 1):
                pt("pr", "kI", jj * bd)
                if jj < i:
                    pt("pr", "kE", jj * bd)
            if i + 1 < s:
                pt("pw", "G", 0)
            elif kind == GRID_FWD:
                pt("pw", "y1", 0)
                pt("pw", "err", 0)
            else:
                pt("pr", "tgt", 0)
                for name in ("diff", "lam"):
                    pt("pw", name, 0)
                if reached:
                    covectors(reached[-1], -1)
        else:
            raise AssertionError(f"no access model for {epi}")
    return acc


def _grid_hazards(acc):
    """Pairs of a phase's accesses in which one tile writes what another
    tile of the phase reads or writes: a write against a staged read, or
    against an epilogue's access by another owner."""
    return [(w, x) for w in acc if w[4] == "pw" for x in acc
            if x is not w and x[1] == w[1] and x[2] < w[3] and w[2] < x[3]
            and (x[4] == "read" or x[0] != w[0])]


@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("B, d, layers, tname", GRID_CASES, ids=GRID_IDS)
def test_grid_phases_write_nothing_another_tile_reads(B, d, layers, tname,
                                                       kind):
    """Within each of the mirror's phases (at K4's first iteration and a
    later one), no tile writes an element that another tile of the phase
    reads or writes, or that a product stages: the grid barrier between
    phases is the only ordering the kernel has."""
    tbl, _ = _tableau(tname)
    for k in (0, 1) if kind == GRID_LOOP else (0,):
        for phase in grid_phases(kind, B, d, layers, tbl, k):
            assert _grid_hazards(_grid_accesses(kind, B, d, layers, tbl,
                                                phase)) == []


def test_grid_hazard_check_sees_a_shared_one_layer_phase():
    """The check above sees the race of a one-layer stack whose explicit
    stage's layer shared the stiff product's phase: kE_i's epilogue reads
    kI_i, which the stiff product's epilogue writes, and writes G_{i+1}
    over the G_i that both products stage. Apart (the layer on Y_i's
    slot, a phase later), the two phases are clean."""
    B, d, i = 37, 300, 1
    phases = grid_phases(GRID_LOOP, B, d, [300], LATE, 1)
    stage = [ph for ph in phases[:6] if ph["products"][0]["stage"] == i]
    assert [ph["products"][0]["epi"] for ph in stage] == ["fwd_stiff",
                                                          "fwd_ke"]
    assert stage[1]["products"][0]["a"][:2] == ("ys", (3 - 1 - i) * B * d)
    for ph in stage:
        assert _grid_hazards(_grid_accesses(GRID_LOOP, B, d, [300], LATE,
                                            ph)) == []
    stiff, layer = stage[0]["products"][0], stage[1]["products"][0]
    shared = dict(pre="none", products=[stiff, dict(layer, a=stiff["a"])])
    bad = {(w[1], x[1]) for w, x in _grid_hazards(_grid_accesses(
        GRID_LOOP, B, d, [300], LATE, shared))}
    assert ("kI", "kI") in bad and ("G", "G") in bad


@pytest.mark.parametrize("kind, k", [(GRID_STEP, 0), (GRID_LOOP, 0),
                                     (GRID_LOOP, 1), (GRID_GRAD, 0),
                                     (GRID_FWD, 0)])
def test_c_grid_phases_reads_the_generator_records(monkeypatch, kind, k):
    """``c_grid_phases`` (what chip_smoke.py's build phase holds against
    the mirror) decodes pnode_ark_grid_phases' records, 20 long longs a
    product with the operands' addresses, back to regions: a stand-in
    library that writes the mirror's products at the addresses it is
    given reads back as the mirror."""
    B, d, layers = 37, 197, [201, 197]
    tbl, _ = _tableau("3")
    s, n = len(tbl[2]), len(layers)
    want = grid_phases(kind, B, d, layers, tbl, k)
    regions, _ = grid_workspace(kind, B, d, layers, s)

    class Lib:
        def pnode_ark_grid_phases(self, kind_, B_, d_, s_, n_, dims, tab, k_,
                                  ws, J, inv, y, ys, Ws, bs, rec, cap, count):
            assert (kind_, B_, d_, s_, n_, k_) == (kind, B, d, s, n, k)
            assert list(dims) == [d] + layers
            base = {"ws": ws, "J": J, "inv": inv, "y": y, "ys": ys}
            base.update({f"W{l}": Ws[l] for l in range(n)})
            base.update({f"b{l}": bs[l] for l in range(n)})

            def addr(where):
                if where is None:
                    return 0
                name, off = where[:2]
                if name in regions:
                    return ws + 4 * (regions[name][0] + off)
                return base[name] + 4 * off

            r = 0
            for ph, phase in enumerate(want):
                pre = adj.GRID_PRES.index(phase["pre"])
                for p in phase["products"] or [None]:
                    f = [ph, pre] + ([-1] + [0] * 17 if p is None else [
                        adj.GRID_EPIS.index(p["epi"]), p["stage"],
                        p["layer"], p["M"], p["N"], p["K"], p["G"], p["v"],
                        p["ones"], p["a"][3], p["b"][3], p["a"][2],
                        p["b"][2], p["ldo"], addr(p["a"]), addr(p["b"]),
                        addr(p["out"]), addr(p["aux"])])
                    rec[20 * r:20 * r + 20] = f
                    r += 1
            assert r <= cap
            count[0] = r
            return 0

    monkeypatch.setattr(adj._build, "library", lambda: Lib())
    assert adj.c_grid_phases(kind, B, d, layers, tbl, k) == want


def _Lib():
    """A stand-in kernel library recording each C call's arguments."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return 0
            return call

    lib = Lib()
    lib.calls = calls
    return lib


@pytest.mark.parametrize("B, rows, grid", [(200, 0, 0), (200, 0, 66),
                                           (200, 1, 0), (256, 0, 0)])
def test_k3_launch_arguments(B, rows, grid):
    """K3's wrapper passes the scratch of its plan's form: the grid form's
    workspace at Burgers (the plan's grid, or a smaller one asked for), the
    row form's partials at forced rows and at KS."""
    d, layers = (512, BURGERS) if B == 200 else (64, KS)
    tbl, dt, y, J, inv, Ws, bs, lam = _operands("3", B, d, layers, seed=3)
    lib = _Lib()
    adj.run_ark_adj(lib, 132, 0, tbl, dt, torch.zeros(4, B, d), _t(lam),
                    _t(J), _t(inv), [_t(w) for w in Ws], [_t(b) for b in bs],
                    "relu", -1.0, rows, grid)
    (name, a), = lib.calls
    dims = [d] + layers
    if B == 200 and rows == 0:
        want = grid_plan(GRID_STEP, B, d, layers, 4)[2]
    else:
        R = rows or ark_adj_plan(B, d, layers, 4)[0]
        want = -(-B // R) * grad_buffer_size(dims)
    assert name == "pnode_ark_adj" and a[-4:-1] == (rows, grid, want)
    assert adj.adj_scratch_floats(B, d, layers, 4, 132, rows) == want
    with pytest.raises(ValueError, match="rows"):
        adj.run_ark_adj(lib, 132, 0, tbl, dt, torch.zeros(4, B, d), _t(lam),
                        _t(J), _t(inv), [_t(w) for w in Ws],
                        [_t(b) for b in bs], "relu", -1.0, 2, 66)


@pytest.mark.parametrize("B, rows, grid, form", [
    (200, 0, 0, "plan"), (200, 0, 66, "plan"), (100, 0, 0, "plan"),
    (200, 1, 0, "plan"), (256, 0, 0, "plan"), (256, 0, 0, "grid")])
def test_k12_launch_arguments(B, rows, grid, form):
    """K12's launch passes the scratch of its form: the grid form's
    workspace at Burgers (B 200 and the two-rank shard B 100; the plan's
    grid, or a smaller one asked for) and at KS with form "grid" (a kernel
    comparison; C rows -1), the row form's partials (a slice of the
    gradient and the loss per block) at forced R 1 and at KS; the count
    the caller gives. A grid is refused in the row form."""
    d, layers = (512, BURGERS) if B != 256 else (64, KS)
    tbl, dt, y, J, inv, Ws, bs, _ = _operands("3", B, d, layers, seed=3)
    layout = LoopLayout(B, d, layers)
    params = layout.pack([_t(w) for w in Ws], [_t(b) for b in bs])
    lib = _Lib()
    loss, grad = ftl.run_grad_step(lib, 132, 0, layout, tbl, dt, _t(y),
                                   _t(y), _t(J), _t(inv), params, "relu",
                                   -1.0, 2.0 * B * d, rows, grid, form)
    (name, a), = lib.calls
    dims = [d] + layers
    if form == "grid" or (B != 256 and rows == 0):
        want = grid_plan(GRID_GRAD, B, d, layers, 4)[2]
    else:
        R = rows or grad_step_plan(B, d, layers, 4)[0]
        want = -(-B // R) * (-(-(grad_buffer_size(dims) + 1) // 4) * 4)
    assert name == "pnode_grad_step" and a[7:10] == (B, d, 4)
    assert a[-5:-1] == (2.0 * B * d, -1 if form == "grid" else rows, grid,
                        want)
    assert ftl.grad_scratch_floats(B, d, layers, 4, 132, rows, form) == want
    assert grad.shape == (layout.total,) and loss.shape == ()
    with pytest.raises(ValueError, match="grid"):
        ftl.run_grad_step(lib, 132, 0, layout, tbl, dt, _t(y), _t(y), _t(J),
                          _t(inv), params, "relu", -1.0, None, 1, 66)
    assert len(lib.calls) == 1


def test_grid_workspace_of_k12_is_k4s():
    """K12's grid-form workspace is K4's regions (the forward's kI, kE, G,
    the seed, y1 - tgt and the per-row losses beside the reverse's): 27.9
    MB at Burgers-512, B 200, ARK3, against the row form's 200 partials of
    the stack (1.27 GB); 14.0 MB at the two-rank shard B 100."""
    for B in (200, 100):
        assert grid_workspace(GRID_GRAD, B, 512, BURGERS, 4) == \
            grid_workspace(GRID_LOOP, B, 512, BURGERS, 4)
    assert 4 * grid_plan(GRID_GRAD, 200, 512, BURGERS, 4)[2] == 27_853_600
    assert 4 * grid_plan(GRID_GRAD, 100, 512, BURGERS, 4)[2] == 13_926_800
    rows = 200 * (-(-(grad_buffer_size([512] + BURGERS) + 1) // 4) * 4)
    assert 4 * rows > 1.26e9


def test_grid_workspace_at_burgers():
    """The workspace at Burgers-512, B 200, ARK3: every stage's layer
    inputs (4 x 576 wide) and covectors (4 x 576 + 512), xi, u and q, pv
    and the stage values: 23.3 MB for K3; K4 adds kI, kE, G, the seed,
    y1 - tgt and the per-row losses: 27.9 MB. Both fit the 50 MB L2."""
    s, sb = 4, 4 * 200
    k3 = grid_plan(GRID_STEP, 200, 512, BURGERS, s)[2]
    k4 = grid_plan(GRID_LOOP, 200, 512, BURGERS, s)[2]
    assert k3 == sb * (4 * 576) + sb * (4 * 576 + 512) + 4 * sb * 512 \
        + 200 * 512
    assert k4 == k3 + 2 * sb * 512 + 3 * 200 * 512 + 200
    assert 4 * k3 == 23_347_200 and 4 * k4 == 27_853_600


# a 3-stage tableau whose explicit stage is not the first (stage 1: G_1
# comes from the workspace, not the minibatch), with kI_1 in stage 2
LATE = ([[0.5, 0.0, 0.0], [0.25, 0.0, 0.0], [0.25, 0.25, 0.5]],
        [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.25, 0.5, 0.0]],
        [0.25, 0.25, 0.5], [0.25, 0.5, 0.25])


def _tableau(name):
    if name == "late":
        return LATE, None
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
