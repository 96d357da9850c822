"""K4's and K5's launch plans, their gates and their wrappers' scratch.

``train_loop_plan`` (ops/fused_train_loop.py) and ``adaptive_loop_plan``
(ops/fused_adaptive_loop.py) mirror the C plans of the fused training loop
(K4) and the fused adaptive loop (K5) (csrc/ark_tiles.cuh plan_rev, entry
points pnode_train_loop_plan and pnode_adaptive_loop_plan): rows per
block, grid (at most one block per SM, so the cooperative launch is
co-resident; the blocks stride over the row tiles past it), shared-memory
bytes and, for K5, the device workspace. chip_smoke.py's build phase holds
the mirrors against the C plans on the card. Here: the plans at the KS
main path, B 37 and B 3173; every shape the loop gates open (with the
step kernels' forward gate, as the wrappers ask) has a plan; the gates
answer as the 8-row budget they have always been, pinned at KS and
Burgers-512; the K5 workspace; the wrappers' scratch and arguments, read
through a stand-in for the kernel library (no card here).
"""

import ctypes

import numpy as np
import pytest
import torch

from pnode_tpu_torch.ops import fused_adaptive_loop as fal
from pnode_tpu_torch.ops import fused_train_loop as ftl
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    MAX_SMEM_BYTES, fused_ark_fits, grad_step_plan,
)
from pnode_tpu_torch.ops.fused_mlp import grad_buffer_size
from pnode_tpu_torch.tableaus import get_ark_tableau

torch.set_num_threads(1)

KS = [104] * 4 + [64]
BURGERS = [576] * 4 + [512]


def _budget_4(d, layers, s):
    """The loop gate's 8-row budget as the parent wrote it (K4)."""
    dims = [d] + list(layers)
    tile = 8 * d
    fwd = tile * (2 + 2 * s) + 16 * max(dims)
    rev = tile * (s + 4) + 8 * sum(dims[:-1]) + 16 * max(dims)
    return 4 * (tile * (s + 1) + max(fwd, rev) + 32)


def _budget_5(d, layers, s, trials):
    """The adaptive gate's 8-row budget as the parent wrote it (K5)."""
    dims = [d] + list(layers)
    tile = 8 * d
    fwd = tile * (2 * s + 4) + 16 * max(dims)
    rev = tile * (s + 4) + 8 * sum(dims[:-1]) + 16 * max(dims)
    return 4 * (212 + 2 * d * d + d + tile * (s + 2) + max(fwd, rev) + 32
                + 2 * trials)


@pytest.mark.parametrize("B, rows, grid", [(256, 2, 128), (37, 1, 37),
                                           (1, 1, 1), (264, 2, 132),
                                           (3173, 8, 132)])
def test_k4_rows_and_grid(B, rows, grid):
    """K12's rule (the fewest rows whose grid fits one block per SM), the
    grid capped at 132 blocks: at B 3173 397 row tiles of 8 on 132
    blocks, so blocks stride."""
    plan = ftl.train_loop_plan(B, 64, KS, 4)
    assert plan[:2] == (rows, grid)
    assert plan[2] == grad_step_plan(B, 64, KS, 4)[2] <= MAX_SMEM_BYTES
    assert -(-B // rows) > grid or B <= 132 * rows


@pytest.mark.parametrize("B, rows, grid", [(256, 2, 128), (37, 1, 37),
                                           (3173, 8, 132)])
def test_k5_rows_grid_and_workspace(B, rows, grid):
    """K4's rule on K5's layout; the workspace: the stage store (32
    trials, 4 stages) and three (B, d) buffers: 8.6 MB at B 256."""
    R, G, smem, ws = fal.adaptive_loop_plan(B, 64, KS, 4, 32)
    assert (R, G) == (rows, grid)
    assert smem <= MAX_SMEM_BYTES
    assert ws == (32 * 4 + 3) * B * 64
    if B == 256:
        assert 4 * ws == 8_585_216


def test_grids_follow_the_sm_count():
    for sms, B, rows, grid in ((64, 256, 4, 64), (16, 256, 8, 16),
                               (8, 256, 8, 8), (132, 133, 2, 67)):
        assert ftl.train_loop_plan(B, 64, KS, 4, sms)[:2] == (rows, grid)
        assert fal.adaptive_loop_plan(B, 64, KS, 4, 32, sms)[:2] == (rows,
                                                                     grid)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_forced_rows_at_ks(rows):
    """Every R takes the KS main path (chip_smoke forces each); the grid
    stays capped, K5's header comes out of the same budget."""
    p4 = ftl.train_loop_plan(256, 64, KS, 4, rows=rows)
    p5 = fal.adaptive_loop_plan(256, 64, KS, 4, 32, rows=rows)
    for plan in (p4, p5):
        assert plan[:2] == (rows, min(-(-256 // rows), 132))
        assert plan[2] <= MAX_SMEM_BYTES
    assert p5[2] >= p4[2] - 4 * 64 * 4 * rows  # K5 keeps no stage values


@pytest.mark.parametrize("bad", [3, 16, -1])
def test_plans_refuse_other_rows(bad):
    assert ftl.train_loop_plan(256, 64, KS, 4, rows=bad) is None
    assert fal.adaptive_loop_plan(256, 64, KS, 4, 32, rows=bad) is None


@pytest.mark.parametrize("args", [
    (16, 64, [104] * 8 + [64], 4),   # 9 layers
    (16, 64, KS, 9),                 # 9 stages
    (16, 64, [104] * 4 + [32], 4),   # the MLP does not map d to d
    (0, 64, KS, 4),
    (16, 64, [1100, 64], 4),         # a layer wider than a product takes
])
def test_plans_refuse(args):
    assert ftl.train_loop_plan(*args) is None
    assert fal.adaptive_loop_plan(*args[:3], args[3], 32) is None
    assert fal.adaptive_loop_plan(16, 64, KS, 4, 0) is None


def test_k5_takes_only_resident_layouts():
    """K5 forms its stage inverse beside J in shared memory: a shape whose
    two (d, d) copies do not fit has no K5 plan (the gate opens none),
    though K4 reads them in place there."""
    assert fal.adaptive_loop_plan(37, 200, [200, 200], 4, 32) is None
    assert not fal.fused_adaptive_loop_fits(37, 200, [200, 200], 32)
    assert ftl.train_loop_plan(37, 200, [200, 200], 4) is not None


def test_gates_pinned_at_ks_and_burgers():
    assert ftl._loop_smem_bytes(64, KS, 4) == 48768
    assert ftl._loop_smem_bytes(512, BURGERS, 4) == 340096
    assert fal._adaptive_smem_bytes(64, KS, 4, 32) == 84944
    assert fal._adaptive_smem_bytes(512, BURGERS, 4, 32) == 2456784
    assert ftl.fused_train_loop_fits(256, 64, KS)
    assert fal.fused_adaptive_loop_fits(256, 64, KS, 32)
    assert not ftl.fused_train_loop_fits(200, 512, BURGERS)
    assert not fal.fused_adaptive_loop_fits(200, 512, BURGERS, 32)


@pytest.mark.parametrize("stages", [1, 2, 4, 6, 8])
def test_gates_are_the_8_row_budget_and_the_plans_take_all_they_open(
        stages):
    """Swept over d, hidden widths and depths, batches and trial counts:
    each gate answers as the parent's 8-row budget does, and wherever a
    gate and the step kernels' forward gate open (the wrappers ask both),
    its kernel's plan takes the shape at every batch, K5's with its
    operators staged."""
    rng = np.random.default_rng(100 + stages)
    opened = [0, 0]
    for _ in range(250):
        d = int(rng.integers(1, 760))
        hidden = [int(rng.integers(1, 1100))
                  for _ in range(int(rng.integers(0, 8)))]
        layers = hidden + [d]
        trials = int(rng.choice([1, 4, 32, 200, 1024]))
        fits4 = ftl.fused_train_loop_fits(16, d, layers, stages=stages)
        fits5 = fal.fused_adaptive_loop_fits(16, d, layers, trials, stages)
        assert fits4 == (_budget_4(d, layers, stages) <= MAX_SMEM_BYTES)
        assert fits5 == (_budget_5(d, layers, stages, trials)
                         <= MAX_SMEM_BYTES)
        if not fused_ark_fits(d, layers, stages, reverse=False):
            continue
        opened[0] += fits4
        opened[1] += fits5
        for B in (1, 37, 256, 3173):
            if fits4:
                assert ftl.train_loop_plan(B, d, layers, stages) is not None
            if fits5:
                plan = fal.adaptive_loop_plan(B, d, layers, stages, trials)
                assert plan is not None
                assert plan[3] == (trials * stages + 3) * B * d
    assert opened[0] > 0


def test_gates_at_the_ks_widths_over_d():
    """At the KS hidden widths every d either gate opens has a plan; the
    widest are d 427 (K4) and d 134 (K5)."""
    for d in range(1, 200):
        layers = [104] * 4 + [d]
        if not fused_ark_fits(d, layers, 4, reverse=False):
            continue
        if ftl.fused_train_loop_fits(256, d, layers):
            assert ftl.train_loop_plan(256, d, layers, 4) is not None
        if fal.fused_adaptive_loop_fits(256, d, layers, 32):
            assert fal.adaptive_loop_plan(256, d, layers, 4, 32) is not None
            assert d <= 134
    assert ftl.fused_train_loop_fits(256, 427, [104] * 4 + [427])
    assert not ftl.fused_train_loop_fits(256, 428, [104] * 4 + [428])
    assert fal.fused_adaptive_loop_fits(256, 134, [104] * 4 + [134], 32)


# -- the wrappers' launches, through a stand-in library ----------------------

class _Lib:
    """Records each C call's arguments and returns 0 (success); keeps a copy
    of the Q^T operand K5's launch reads (the wrapper frees it after)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            if name == "pnode_adaptive_loop":
                d = args[16]
                self.qt = np.ctypeslib.as_array(
                    (ctypes.c_float * (d * d)).from_address(args[3])).copy()
            return 0
        return call


def _tab(with_err=False):
    t = get_ark_tableau("3")
    tab = ([[float(x) for x in r] for r in t.a_im],
           [[float(x) for x in r] for r in t.a_ex],
           [float(x) for x in t.b_im], [float(x) for x in t.b_ex])
    if with_err:
        tab += ([float(x) for x in t.b_im_err], [float(x) for x in t.b_ex_err])
    return tab, t


def _loop_operands(K, B, d, hidden, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)  # noqa: E731
    dims = [d] + hidden + [d]
    Ws = [f(a, b) for a, b in zip(dims, dims[1:])]
    bs = [f(b) for b in dims[1:]]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    return f(K, B, d), f(K, B, d), f(d, d), f(d, d), Ws, bs, z


@pytest.mark.parametrize("B, rows, chunk", [(256, 0, None), (37, 4, 8),
                                            (3173, 0, 8)])
def test_k4_launch_arguments(B, rows, chunk):
    """One launch per chunk, the scratch at the plan's grid: grid slices of
    round4(wtotal) floats (C refuses any other count), lpart grid floats."""
    K, d, hidden = 16, 64, [104] * 4
    y, tgt, J, inv, Ws, bs, z = _loop_operands(K, B, d, hidden)
    lib = _Lib()
    tab, _ = _tab()
    out = ftl.run_train_loop(lib, 132, 0, tab, 0.2, y, tgt, J, inv, Ws, bs,
                             z, z, 3, "relu", -1.0, 5e-3, 0.9, 0.999, 1e-8,
                             chunk or K, rows)
    R, grid, _ = ftl.train_loop_plan(B, d, hidden + [d], 4, 132, rows)
    total = grad_buffer_size([d] + hidden + [d])
    assert [c[0] for c in lib.calls] == ["pnode_train_loop"] * (
        K // (chunk or K))
    for i, (_, a) in enumerate(lib.calls):
        assert a[10:14] == (chunk or K, B, d, 4)
        assert a[20] == 3 + i * (chunk or K)  # t0 of the chunk
        assert a[25:27] == (rows, grid * (-(-total // 4) * 4))
    assert len(out[4]) == K


def test_k5_launch_arguments():
    """One launch; the workspace at the plan's floats; Q passed transposed
    (the kernel reads Q^T's rows)."""
    K, B, d, hidden = 4, 37, 64, [24] * 4
    y, tgt, J, _, Ws, bs, z = _loop_operands(K, B, d, hidden, seed=1)
    rng = np.random.default_rng(2)
    Q = torch.tensor(np.linalg.qr(rng.standard_normal((d, d)))[0],
                     dtype=torch.float32)
    lam = -torch.rand(d) * 50
    tab, t = _tab(True)
    lib = _Lib()
    fal.run_adaptive_loop(lib, 132, 0, tab, float(t.a_im[1][1]), lam, Q, J,
                          0.2, 0.05, y, tgt, Ws, bs, z, z, 0, 32, 1e-4, 1e-4,
                          0.9, 0.1, 10.0, t.order, "relu", -1.0, 5e-3, 0.9,
                          0.999, 1e-8, 2)
    (name, a), = lib.calls
    R, grid, _, ws = fal.adaptive_loop_plan(B, d, hidden + [d], 4, 32,
                                            rows=2)
    total = grad_buffer_size([d] + hidden + [d])
    assert name == "pnode_adaptive_loop"
    assert R == 2 and a[14:18] == (K, B, d, 4)
    assert a[-4:-1] == (2, grid * (-(-total // 4) * 4), ws)
    assert np.array_equal(lib.qt.reshape(d, d), Q.numpy().T)


def test_k5_takes_the_callers_workspace():
    """A caller's workspace (a kernel check reads the trials' stage values
    from it after the launch) is the one launched on, at the plan's floats
    and no other count."""
    K, B, d, hidden = 1, 37, 64, [24] * 4
    y, tgt, J, _, Ws, bs, z = _loop_operands(K, B, d, hidden, seed=1)
    Q = torch.eye(d)
    lam = -torch.ones(d)
    tab, t = _tab(True)
    ws_floats = fal.adaptive_loop_plan(B, d, hidden + [d], 4, 32)[3]
    assert ws_floats == (32 * 4 + 3) * B * d

    def launch(ws):
        lib = _Lib()
        fal.run_adaptive_loop(lib, 132, 0, tab, float(t.a_im[1][1]), lam, Q,
                              J, 0.2, 0.05, y, tgt, Ws, bs, z, z, 0, 32,
                              1e-4, 1e-4, 0.9, 0.1, 10.0, t.order, "relu",
                              -1.0, 5e-3, 0.9, 0.999, 1e-8, 0, workspace=ws)
        return lib.calls[0][1]

    ws = torch.empty(ws_floats)
    a = launch(ws)
    assert a[11] == ws.data_ptr() and a[-2] == ws_floats
    for bad in (torch.empty(ws_floats - 1), torch.empty(ws_floats,
                                                         dtype=torch.float64)):
        with pytest.raises(ValueError, match="workspace"):
            launch(bad)


@pytest.mark.parametrize("bad", [3, 16])
def test_wrappers_refuse_other_rows(bad):
    K, B, d, hidden = 2, 8, 16, [24]
    y, tgt, J, inv, Ws, bs, z = _loop_operands(K, B, d, hidden)
    tab, _ = _tab()
    with pytest.raises(ValueError, match="rows"):
        ftl.fused_train_loop(tab, 0.2, y, tgt, J, inv, Ws, bs, z, z, 0,
                             rows=bad)
