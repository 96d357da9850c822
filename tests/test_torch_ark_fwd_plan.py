"""K2's launch plan and its plain version at the KS widths.

``ark_fwd_plan`` (ops/fused_ark_adjoint.py) mirrors the C plan of the fused
ARK forward step (csrc/ark_tiles.cuh plan_fwd, entry point
pnode_ark_fwd_plan): rows per block, grid and shared-memory bytes. The
pinned triples are the C plan's own on an H100 (132 SMs), which
chip_smoke.py's build phase holds against this mirror at the same shapes.
Beside them: the rule's dependence on the SM count, the refusals, the fits
gate's answers (the plans at one row per block), the forward wrapper's own
gate, and the reverse-step cost counts without the MLP's last-layer
forward. The grid form (rows 0: where K3's plan takes it from d 280 up,
Burgers-512 and d 300; d 200 and 197 keep the row form, faster there):
its workspace, and the wrapper's launch arguments through a stand-in for
the kernel library. Then K2's plain version
against the JAX package's ``_kernel`` in interpret mode at the KS widths
(d 64, hidden 104, B 16) with the embedded error output, at the forward's
tolerances (rtol 3e-5 / atol 1e-6, tests/test_fused_ark_adjoint.py:183);
err, a difference that cancels, within max(1e-4, 3 e64) of max |err|, e64
the plain version's own distance from fp64 (the test says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.ops.fused_ark_forward import fused_ark_step_fwd as j_fwd
from pnode_tpu.tableaus import get_ark_tableau
from pnode_tpu_torch.ops import fused_ark_forward as fwd
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    GRID_FWD, GRID_MIN_D, GRID_SMEM, MAX_SMEM_BYTES, _ark_fwd_plan,
    ark_adj_plan, ark_fwd_plan, fused_ark_fits, fused_ark_step_adj,
    grid_plan, grid_workspace,
)
from pnode_tpu_torch.ops.fused_ark_forward import (
    fused_ark_step_fwd, fused_ark_step_fwd_plain,
)
from pnode_tpu_torch.ops.fused_train_loop import (
    fused_grad_step_cost, fused_train_loop_cost,
)

torch.set_num_threads(1)

KS = [104] * 4 + [64]
BURGERS = [576] * 4 + [512]

# (B, d, layer widths, stages) -> the C plan's (rows, grid, bytes) on 132
# SMs, as chip_smoke.py's build phase printed them; at Burgers-512 the
# grid form (rows 0, one block per SM), which K3's plan takes there (the
# row form's R 2, 100 blocks of 232,448 B, before it)
GRID = (0, 132, GRID_SMEM)
C_PLANS = [
    ((256, 64, KS, 4), (2, 128, 135296)),
    ((37, 64, KS, 4), (1, 37, 127552)),
    ((1, 64, KS, 4), (1, 1, 127552)),
    ((3173, 64, KS, 4), (8, 397, 181760)),
    ((200, 512, BURGERS, 4), GRID),
    ((200, 512, BURGERS, 8), GRID),
    ((37, 13, [100, 13], 4), (1, 37, 14496)),
    ((37, 100, [13, 100], 4), (1, 37, 97712)),
    ((37, 64, [64], 2), (1, 37, 72448)),
    ((37, 64, [24] * 7 + [64], 6), (1, 37, 51456)),
]


@pytest.mark.parametrize("shape, plan", C_PLANS,
                         ids=[f"B{a[0]}-d{a[1]}-s{a[3]}-{len(a[2])}l"
                              for a, _ in C_PLANS])
def test_mirror_equals_the_c_plan(shape, plan):
    assert ark_fwd_plan(*shape) == plan
    assert plan[2] <= MAX_SMEM_BYTES


@pytest.mark.parametrize("stages", [1, 2, 4, 6, 8])
def test_ks_rows_and_grid_at_every_stage_count(stages):
    """At B 256 the grid is 128 blocks of 2 rows whatever the tableau; the
    stage tiles (2 s R d floats) are all that grows."""
    rows, grid, smem = ark_fwd_plan(256, 64, KS, stages)
    assert (rows, grid) == (2, 128)
    assert smem == ark_fwd_plan(256, 64, KS, 1)[2] + 4 * 2 * 2 * 64 * (
        stages - 1)


@pytest.mark.parametrize("sms, B, rows", [(132, 132, 1), (132, 133, 2),
                                          (132, 264, 2), (132, 265, 4),
                                          (64, 256, 4), (16, 256, 8),
                                          (8, 256, 8)])
def test_rows_are_the_fewest_whose_grid_fits_one_block_per_sm(sms, B, rows):
    assert ark_fwd_plan(B, 64, KS, 4, sms)[:2] == (rows, -(-B // rows))


@pytest.mark.parametrize("args", [
    (16, 64, [1100, 64], 4),          # a layer wider than 256 x 4 columns
    (16, 64, [104] * 8 + [64], 4),    # 9 layers
    (16, 64, KS, 9),                  # 9 stages
    (16, 64, KS, 0),
    (16, 64, [104] * 4 + [32], 4),    # the MLP does not map d to d
    (0, 64, KS, 4),
    (16, 64, [0, 64], 4),
])
def test_plan_refuses(args):
    assert ark_fwd_plan(*args) is None


def test_fits_gate_answers():
    """The gate is the plans at one row per block: KS and Burgers-512 fit
    both step kernels (at Burgers-512 K2's and K3's plans take the grid
    form: one block per SM, 132 on an H100 SXM), a layer wider than a
    product takes fits neither."""
    assert fused_ark_fits(64, KS, 4)
    assert fused_ark_fits(512, BURGERS, 4, reverse=False)
    assert fused_ark_fits(512, BURGERS, 4)
    assert ark_fwd_plan(1, 512, BURGERS, 4) == GRID
    assert ark_adj_plan(1, 512, BURGERS, 4) == (0, 132, GRID_SMEM)
    assert ark_adj_plan(1, 64, KS, 4) == (1, 1, 144896)
    assert not fused_ark_fits(64, [1100, 64], 4, reverse=False)


# K3's grid-form shapes: Burgers-512 at 4 and 8 stages, d 300 and 280 (K2
# follows from d 280 up), d 256, 200 and d 197 with a 201-wide layer (rows
# not 16-byte aligned; K2 keeps the row form, faster there)
GRID_SHAPES = [(200, 512, BURGERS, 4), (200, 512, BURGERS, 8),
               (37, 300, [300], 4), (37, 280, [280], 4), (37, 256, [256], 4),
               (37, 200, [200, 200], 4), (37, 197, [201, 197], 4)]


@pytest.mark.parametrize("shape", GRID_SHAPES,
                         ids=[f"B{a[0]}-d{a[1]}-s{a[3]}" for a in GRID_SHAPES])
def test_grid_form_where_k3_takes_it(shape):
    """K2's plan takes the grid form where K3's does (rows 0, one block per
    SM, at any SM count) from d GRID_MIN_D (280) up, and below it keeps its
    row plan, which exists wherever K3's grid form does (the fits gate and
    a forced R read it); every pinned KS shape keeps the row form."""
    row = _ark_fwd_plan(*shape[:2], tuple(shape[2]), shape[3], 132)
    assert ark_adj_plan(*shape) == GRID and row is not None
    if shape[1] >= GRID_MIN_D:
        assert ark_fwd_plan(*shape) == GRID
        assert ark_fwd_plan(*shape, sms=64)[:2] == (0, 64)
    else:
        assert ark_fwd_plan(*shape) == row
    for ks, plan in C_PLANS:
        if ks[1] == 64 and plan is not None:
            assert ark_fwd_plan(*ks)[0] > 0 and ark_adj_plan(*ks)[0] > 0


def test_grid_workspace_at_burgers():
    """K2's workspace at Burgers-512, B 200, ARK3: every stage's layer
    inputs (4 x 576 wide), kI and kE (s, B, d) and G (B, d): 11.1 MB, no
    covector, no stage values (they go to the caller's ys)."""
    s, sb = 4, 4 * 200
    regions, total = grid_workspace(GRID_FWD, 200, 512, BURGERS, s)
    assert sorted(regions) == ["G", "h1", "h2", "h3", "h4", "kE", "kI"]
    assert total == sb * 4 * 576 + 2 * sb * 512 + 200 * 512
    assert grid_plan(GRID_FWD, 200, 512, BURGERS, s)[2] == total
    assert 4 * total == 11_059_200


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


@pytest.mark.parametrize("B, rows, grid, form, err", [
    (200, 0, 0, "plan", False), (200, 0, 66, "plan", True),
    (200, 2, 0, "plan", False), (256, 0, 0, "plan", True),
    (256, 0, 0, "grid", False), (256, 0, 66, "grid", True)])
def test_k2_launch_arguments(B, rows, grid, form, err):
    """K2's launch passes the workspace of its form: the grid form's at
    Burgers (the plan's grid, or a smaller one asked for) and at KS with
    form "grid" (a kernel comparison), none in the row form (forced R 2 at
    Burgers, the plan's R at KS); C rows -1 forces the grid form. The
    stage values and y1 (and err) are the wrapper's outputs; a grid is
    refused in the row form, a forced R with form "grid"."""
    d, layers = (512, BURGERS) if B == 200 else (64, KS)
    tbl, b_err, dt, y, J, inv, Ws, bs = _operands("3", B, d, layers, seed=3)
    lib = _Lib()
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    out = fwd.run_ark_fwd(lib, 132, 0, tbl, b_err if err else None, dt,
                          _t(y), _t(J), _t(inv), W, b, "relu", -1.0, rows,
                          grid, form)
    (name, a), = lib.calls
    grid_form = form == "grid" or (B == 200 and rows == 0)
    want = grid_plan(GRID_FWD, B, d, layers, 4)[2] if grid_form else 0
    assert name == "pnode_ark_fwd"
    assert a[7:10] == (B, d, 4)
    assert a[-4:-1] == (-1 if form == "grid" else rows, grid, want)
    assert (a[5] is not None) == err and (a[11] is not None) == err
    assert len(out) == (3 if err else 2) and out[-1].shape == (4, B, d)
    assert fwd.fwd_scratch_floats(B, d, layers, 4, 132, rows, form) == want
    for bad in (dict(rows=2, grid=66, form="plan"),
                dict(rows=2, grid=0, form="grid")):
        with pytest.raises(ValueError):
            fwd.run_ark_fwd(lib, 132, 0, tbl, None, dt, _t(y), _t(J),
                            _t(inv), W, b, "relu", -1.0, **bad)
    assert len(lib.calls) == 1


def _tableau(name):
    t = get_ark_tableau(name)
    return (([[float(x) for x in r] for r in t.a_im],
             [[float(x) for x in r] for r in t.a_ex],
             [float(x) for x in t.b_im], [float(x) for x in t.b_ex]),
            ([float(x) for x in t.b_im_err], [float(x) for x in t.b_ex_err]),
            t)


def _operands(name, B, d, layers, seed, dt=0.2):
    tbl, b_err, t = _tableau(name)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    J = -2.0 * (A @ A.T) / d
    gamma = [g for g in np.diag(t.a_im) if g != 0.0][0]
    inv = np.linalg.inv(np.eye(d) - dt * gamma * J)
    dims = [d] + list(layers)
    Ws = [rng.normal(0, a ** -0.5, size=(a, b)) for a, b in zip(dims, dims[1:])]
    bs = [0.1 * rng.normal(size=b) for b in dims[1:]]
    y = rng.normal(size=(B, d))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (tbl, b_err, float(np.float32(dt)), f32(y), f32(J), f32(inv),
            [f32(w) for w in Ws], [f32(b) for b in bs])


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_wrapper_gates_on_the_forward_alone():
    """fused_ark_step_fwd takes the Burgers-512 stack (its kernel streams the
    operators and weights), and so does the reverse step (its kernel reads
    inv and J in place); a layer wider than a product takes is refused by
    the forward wrapper's own gate."""
    tbl, _, dt, y, J, inv, Ws, bs = _operands("3", 2, 512, BURGERS, seed=4,
                                              dt=1e-3)
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    y1, ys = fused_ark_step_fwd(tbl, dt, _t(y), _t(J), _t(inv), W, b)
    assert y1.shape == (2, 512) and ys.shape == (4, 2, 512)
    assert bool(torch.isfinite(y1).all())
    lam_prev, (dW, _) = fused_ark_step_adj(tbl, dt, ys, _t(y), _t(J),
                                           _t(inv), W, b)
    assert lam_prev.shape == (2, 512) and len(dW) == 5
    assert bool(torch.isfinite(lam_prev).all())
    tbl, _, dt, y, J, inv, Ws, bs = _operands("3", 2, 64, [1100, 64], seed=5)
    with pytest.raises(ValueError, match="shared-memory budget"):
        fused_ark_step_fwd(tbl, dt, _t(y), _t(J), _t(inv),
                           [_t(w) for w in Ws], [_t(v) for v in bs])


def test_reverse_costs_leave_out_the_last_layer_forward():
    """The reverse recomputes layers 0..n-2's inputs and backprops every
    layer (dX, dW): 3x the forward MLP less the last layer's forward, as
    chip_smoke.mlp_costs counts K1's backward."""
    tbl = _tableau("3")[0]
    B, d, s = 256, 64, 4
    dims = [d] + KS
    mlp = sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
    last = 2 * B * 104 * 64
    stiff = 2 * B * d * d
    w = sum(a * b + b for a, b in zip(dims, dims[1:]))
    flops, _ = fused_train_loop_cost(tbl, B, d, KS, 8)
    assert flops == (s * (stiff + mlp) + s * (stiff + 3 * mlp - last)
                     + 10 * w + 3 * B * d)
    gflops, _ = fused_grad_step_cost(tbl, B, d, KS)
    assert gflops == flops - 10 * w


@pytest.mark.parametrize("name", ["3", "4"])
def test_k2_plain_matches_jax_interpret_at_ks_widths(name):
    """K2's plain version (what chip_smoke holds the kernel to) against the
    JAX package's _kernel in interpret mode at d 64, hidden 104, B 16, with
    the embedded error output."""
    tbl, b_err, dt, y, J, inv, Ws, bs = _operands(name, 16, 64, KS, seed=7)
    y1_j, err_j, ys_j = j_fwd(tbl, dt, jnp.asarray(y), jnp.asarray(J),
                              jnp.asarray(inv), [jnp.asarray(w) for w in Ws],
                              [jnp.asarray(b) for b in bs], b_err=b_err,
                              interpret=True, stiff_prec="highest")
    y1_t, err_t, ys_t = fused_ark_step_fwd(
        tbl, dt, _t(y), _t(J), _t(inv), [_t(w) for w in Ws],
        [_t(b) for b in bs], b_err=b_err)
    np.testing.assert_allclose(y1_t.numpy(), np.asarray(y1_j), rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=3e-5,
                               atol=1e-6)
    # err is a small difference of stage sums whose implicit kI is the
    # difference quotient (Y - G) / (dt a_ii): two fp32 evaluations part by
    # up to a few times either one's distance from fp64 (6 stages: ~3e-4
    # of max |err|), so the gate is max(1e-4, 3 e64) of max |err|, e64 the
    # plain version's own distance from its fp64 run (chip_smoke's K2 edge
    # gate)
    err_j = np.asarray(err_j)
    scale = float(np.abs(err_j).max())
    assert scale > 0.0
    err64 = fused_ark_step_fwd_plain(
        tbl, dt, _t(y).double(), _t(J).double(), _t(inv).double(),
        [_t(w).double() for w in Ws], [_t(b).double() for b in bs],
        b_err=b_err)[1].numpy()
    e64 = float(np.abs(err_t.numpy() - err64).max()) / scale
    tol = max(1e-4, 3.0 * e64) * scale
    np.testing.assert_allclose(err_t.numpy(), err_j, rtol=0, atol=tol)
    np.testing.assert_allclose(err64, err_j, rtol=0, atol=tol)
