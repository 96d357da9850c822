"""The bf16 chain on the tensor cores (K6's and K7's bf16 instances): the
plan mirrors pinned, and the products' sum order held against the JAX
package's kernels.

The bf16 chain stages its operands as bf16 and runs every product on
mma.sync.m16n8k16 (csrc/sqnxt_tiles.cuh, note 9): K = taps x Cin (forward)
or taps x Cout (g_h) padded to a multiple of 16, Cout and Cin padded to 8,
the halo staged to a multiple of 8 columns, column tiles of at least 32.
``stage_layout``, ``tc_geometry``, the tile columns and the scratch mirror
the C plans (phase 2 of chip_smoke.py holds them equal on the card); they
are pinned here at the three stage shapes of SqNxt-23 at B 128 and at
every chip_smoke SQNXT_EDGES case, and the fp32 and one-layer layouts at
their values from before the tensor-core path.

The mma sums each output in fp32 over k in chunks of 16, the chunks added
in order: ``tc_chain`` emulates that order (each chunk's exact sum rounded
to fp32, then added) for the plain bf16 chain forward and backward, dW in
K7's whole order (per backward tile, then each block's slot, then the
blocks as one warp sums them), and the emulation is held against JAX's ``_fwd_kernel`` and
``_bwd_kernel`` in interpret mode within chip_smoke's BF16_TOL (2^-6 of
max |ref| per tensor), the gate the card holds the kernels to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.models.sqnxt import ODEDynamics as JODEDynamics
from pnode_tpu.ops import fused_sqnxt as jfs
from pnode_tpu_torch.convert import sqnxt_piece_from_flax
from pnode_tpu_torch.ops import fused_sqnxt as fs

torch.set_num_threads(1)

BF16_TOL = 2.0 ** -6  # chip_smoke.py's phase 12(a) gate
CHAIN = list(range(5))

# (dim, B, H, W): the stage shapes, then chip_smoke's SQNXT_EDGES
SHAPES = {
    "stage 1": (32, 128, 32, 32),
    "stage 2": (64, 128, 16, 16),
    "stage 3": (128, 128, 8, 8),
    "ragged B3 5x7 dim 16": (16, 3, 5, 7),
    "dim 48 B4 8x8": (48, 4, 8, 8),
    "B5 1x9 dim 16": (16, 5, 1, 9),
    "B5 9x1 dim 16": (16, 5, 9, 1),
    "B1 3x3 dim 16": (16, 1, 3, 3),
    "B640 32x32 dim 16": (16, 640, 32, 32),
    "B1280 32x32 dim 16": (16, 1280, 32, 32),
}

# per layer (kf, kb, cf, cb, hr): K = taps Cin and taps Cout up to 16,
# Cout and Cin up to 8, the halo up to 8 columns
PADS = {
    "stage 1": ((32, 16, 16, 32, 0), (16, 16, 8, 16, 0), (32, 48, 16, 8, 8),
                (48, 48, 16, 16, 32), (16, 32, 32, 16, 0)),
    "stage 2": ((64, 32, 32, 64, 0), (32, 16, 16, 32, 0), (48, 96, 32, 16, 8),
                (96, 96, 32, 32, 16), (32, 64, 64, 32, 0)),
    "stage 3": ((128, 64, 64, 128, 0), (64, 32, 32, 64, 0),
                (96, 192, 64, 32, 8), (192, 192, 64, 64, 8),
                (64, 128, 128, 64, 0)),
    "ragged B3 5x7 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0),
                             (16, 32, 8, 8, 8), (32, 32, 8, 8, 8),
                             (16, 16, 16, 8, 0)),
    "dim 48 B4 8x8": ((48, 32, 24, 48, 0), (32, 16, 16, 24, 0),
                      (48, 80, 24, 16, 8), (80, 80, 24, 24, 8),
                      (32, 48, 48, 24, 0)),
    "B5 1x9 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0), (16, 32, 8, 8, 8),
                      (32, 32, 8, 8, 16), (16, 16, 16, 8, 0)),
    "B5 9x1 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0), (16, 32, 8, 8, 8),
                      (32, 32, 8, 8, 8), (16, 16, 16, 8, 0)),
    "B1 3x3 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0), (16, 32, 8, 8, 8),
                      (32, 32, 8, 8, 8), (16, 16, 16, 8, 0)),
    "B640 32x32 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0),
                          (16, 32, 8, 8, 8), (32, 32, 8, 8, 32),
                          (16, 16, 16, 8, 0)),
    "B1280 32x32 dim 16": ((16, 16, 8, 16, 0), (16, 16, 8, 8, 0),
                           (16, 32, 8, 8, 8), (32, 32, 8, 8, 32),
                           (16, 16, 16, 8, 0)),
}

# the bf16 chain: per layer (forward, backward) tile columns; (tile floats,
# weight floats) of the forward and of the backward; the scratch floats of
# K6 and K7 at a grid of 132
TC_PLANS = {
    "stage 1": (((256, 256), (512, 256), (256, 256), (256, 256), (128, 256)),
                (11008, 448), (20544, 448), (3805184, 2333696)),
    "stage 2": (((128, 128),) * 4 + ((64, 128),),
                (11264, 1664), (21120, 1664), (1970176, 1589248)),
    "stage 3": (((32, 32),) * 5, (6656, 6400), (13056, 6400),
                (1052672, 2281472)),
    "ragged B3 5x7 dim 16": (((128, 128),) * 4 + ((64, 128),), (4096, 192),
                             (6176, 192), (136638, 161352)),
    "dim 48 B4 8x8": (((32, 32), (64, 64), (32, 64), (32, 32), (32, 32)),
                      (4096, 1056), (7248, 1056), (145920, 369408)),
    "B5 1x9 dim 16": (((128, 128),) * 4 + ((64, 128),), (4096, 192),
                      (6368, 192), (135798, 160872)),
    "B5 9x1 dim 16": (((128, 128),) * 4 + ((64, 128),), (4096, 192),
                      (6176, 192), (135798, 160872)),
    "B1 3x3 dim 16": (((128, 128),) * 4 + ((64, 128),), (4096, 192),
                      (6176, 192), (135294, 160584)),
    "B640 32x32 dim 16": (((512, 256),) * 4 + ((256, 256),), (12704, 192),
                          (12704, 192), (14553088, 5403392)),
    "B1280 32x32 dim 16": (((512, 256),) * 4 + ((256, 256),), (12704, 192),
                           (12704, 192), (28971008, 10646272)),
}

# the FFMA tiles' regions, as before the tensor-core path: the fp32 chain
# (forward, backward) and each layer alone, in either dtype (forward,
# backward), (tile floats, weight floats)
FFMA_PLANS = {
    "stage 1": (((8192, 768), (12672, 768)),
                (((8192, 512), (12672, 512)), ((8192, 128), (12288, 128)),
                 ((4096, 384), (12528, 384)), ((5120, 768), (10400, 768)),
                 ((4096, 512), (12672, 512)))),
    "stage 2": (((8192, 3072), (12480, 3072)),
                (((8192, 2048), (12480, 2048)), ((4096, 512), (6528, 512)),
                 ((4096, 1536), (6240, 1536)), ((5120, 3072), (10304, 3072)),
                 ((4096, 2048), (12480, 2048)))),
    "stage 3": (((4096, 12288), (6336, 12288)),
                (((4096, 8192), (6336, 8192)), ((4096, 2048), (4096, 2048)),
                 ((4096, 6144), (4096, 6144)), ((4096, 12288), (6272, 12288)),
                 ((4096, 8192), (6336, 8192)))),
    "ragged B3 5x7 dim 16": (((4096, 192), (4096, 192)),
                             (((4096, 128), (4096, 128)),
                              ((4096, 64), (4096, 64)),
                              ((4096, 96), (4096, 192)),
                              ((4096, 192), (4096, 192)),
                              ((4096, 128), (4096, 128)))),
    "dim 48 B4 8x8": (((4096, 2304), (4096, 2304)),
                      (((4096, 1536), (4096, 1536)),
                       ((4096, 384), (4096, 384)),
                       ((4096, 1152), (4096, 1152)),
                       ((4096, 2304), (4096, 2304)),
                       ((4096, 1536), (4096, 1536)))),
    "B640 32x32 dim 16": (((8192, 192), (12288, 192)),
                          (((8192, 128), (12288, 128)),
                           ((4096, 64), (6144, 64)),
                           ((4096, 96), (6264, 192)),
                           ((4608, 192), (9552, 192)),
                           ((4096, 128), (12288, 128)))),
}


def _meta(label):
    return fs.make_meta(*SHAPES[label])


@pytest.mark.parametrize("label", list(SHAPES))
def test_tc_plan_mirrors_pinned(label):
    """The bf16 chain's plan mirrors at each stage shape and edge case: K
    and Cout padding, the staged halo, tile columns, the staged tile's and
    the weights' floats of K6 and K7, their scratch at 132 blocks."""
    meta = _meta(label)
    cols, fwd, bwd, scratch = TC_PLANS[label]
    geo = [fs.tc_geometry(meta, li, 0) for li in range(5)]
    assert tuple((g["kf"], g["kb"], g["cf"], g["cb"], g["hr"])
                 for g in geo) == PADS[label]
    for g, (taps, cin, cout) in zip(
            geo, [(len(meta.taps[li]), meta.cdims[li], meta.cdims[li + 1])
                  for li in range(5)]):
        assert g["kf"] % 16 == 0 and taps * cin <= g["kf"] < taps * cin + 16
        assert g["kb"] % 16 == 0 and taps * cout <= g["kb"] < taps * cout + 16
        assert g["cf"] % 8 == 0 and cout <= g["cf"] < cout + 8
        assert g["cb"] % 8 == 0 and cin <= g["cb"] < cin + 8
    assert tuple((fs.fwd_tile_columns(meta, li, True),
                  fs.bwd_tile_columns(meta, li, True))
                 for li in range(5)) == cols
    assert fs.stage_layout(meta, CHAIN, 2) == fwd + (True,)
    assert fs.stage_layout(meta, CHAIN, 2, True) == bwd + (True,)
    assert (fs.fwd_scratch_floats(meta, CHAIN, 132, 2),
            fs.bwd_scratch_floats(meta, CHAIN, 132, 2)) == scratch


def test_tc_store_edges():
    """The bf16 chain's store holds bf16 z tiles: at 264 blocks (two an SM,
    the largest co-resident grid of K6's bf16 instance) B640's last z fits
    it and B1280's does not, so its last layer writes its anchor (all five
    anchors in the scratch), as B640's does for the fp32 chain."""
    anchors = lambda m, n: 264 * 1024 + sum(  # noqa: E731
        fs.elem_floats(c * m.n_real, 2) for c in m.cdims[1:1 + n])
    b640, b1280 = _meta("B640 32x32 dim 16"), _meta("B1280 32x32 dim 16")
    assert fs.fwd_scratch_floats(b640, CHAIN, 264, 2) == anchors(b640, 4)
    assert fs.fwd_scratch_floats(b1280, CHAIN, 264, 2) == anchors(b1280, 5)
    assert fs.fwd_scratch_floats(b640, CHAIN, 264, 4) == 264 * 1024 + sum(
        fs.elem_floats(c * b640.n_real, 4) for c in b640.cdims[1:])


@pytest.mark.parametrize("label", list(FFMA_PLANS))
def test_ffma_layouts_unchanged(label):
    """The fp32 chain and every one-layer launch (both dtypes) keep the
    FFMA tiles' shared-memory regions and tile columns: only the bf16
    chain takes the tensor-core layout."""
    meta = _meta(label)
    chain, layers = FFMA_PLANS[label]
    assert (fs.stage_layout(meta, CHAIN, 4),
            fs.stage_layout(meta, CHAIN, 4, True)) == tuple(
                c + (False,) for c in chain)
    for li in range(5):
        for esize in (2, 4):
            got = (fs.stage_layout(meta, [li], esize),
                   fs.stage_layout(meta, [li], esize, True))
            assert got == tuple(c + (False,) for c in layers[li]), (li, esize)
        assert fs.fwd_tile_columns(meta, li) == fs.fwd_tile_columns(
            meta, li, fs.tensor_cores([li], 2))
    assert not fs.tensor_cores(CHAIN, 4) and fs.tensor_cores(CHAIN, 2)


@pytest.mark.parametrize("label", ["stage 1", "stage 2", "stage 3",
                                   "dim 48 B4 8x8", "ragged B3 5x7 dim 16"])
def test_tc_strides_fit_ldmatrix(label):
    """Every staged row starts 16-byte aligned (ldmatrix and cp.async's
    16-byte rows) and the operand strides are 16 bytes times an odd
    number (ldmatrix's eight rows on distinct banks); tiles are whole
    32-column blocks (the jobs' 16 columns, the z tile's swizzle)."""
    meta = _meta(label)
    for li in range(5):
        for tc_cols in (fs.fwd_tile_columns(meta, li, True),
                        fs.bwd_tile_columns(meta, li, True)):
            g = fs.tc_geometry(meta, li, tc_cols)
            assert g["tn"] % 32 == 0 and g["hr"] % 8 == 0
            for ld in (g["ldr"], g["ldh"], g["kf"] + 8, g["kb"] + 8):
                assert (2 * ld) % 16 == 0 and (2 * ld // 16) % 2 == 1, ld


# -- the products' sum order against the JAX kernels --------------------------

def _chunked(a, b):
    """a @ b (float32 tensors of bf16 values) with each output summed over
    k in chunks of 16, each chunk's exact sum rounded to fp32 and the
    chunks added in order in fp32: the mma's accumulation."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a64[:, k0:k0 + 16] @ b64[k0:k0 + 16]).float()
    return acc


def _k7_grid(meta):
    """K7's grid where the card holds more co-resident blocks than the
    chain has tiles (every shape of the sum-order test): the most tiles of
    any layer's forward or backward pass (fused_sqnxt.cu's bwd_grid)."""
    N = meta.n_real
    return max(-(-N // cols(meta, li, True)) for li in range(5)
               for cols in (fs.fwd_tile_columns, fs.bwd_tile_columns))


def _dw_k7_order(gz, hk, meta, li):
    """dW = gz hk^T in K7's order: each backward tile of the layer summed
    over its columns in chunks of 16 (``_chunked``), the tiles of a block
    (tile t to block t mod grid) added into its slot in order, then the
    slots summed over blocks b < min(grid, tiles) as one warp does it (lane
    k adds blocks k, k + 32, ... from 0, then the xor shuffle tree)."""
    N, tn = meta.n_real, fs.bwd_tile_columns(meta, li, True)
    ntiles, grid = -(-N // tn), _k7_grid(meta)
    slots = [None] * min(grid, ntiles)
    for t in range(ntiles):
        part = _chunked(gz[:, t * tn:(t + 1) * tn],
                        hk[:, t * tn:(t + 1) * tn].t())
        b = t % grid
        slots[b] = part if slots[b] is None else slots[b] + part
    lanes = [torch.zeros_like(slots[0]) for _ in range(32)]
    for b, slot in enumerate(slots):
        lanes[b % 32] = lanes[b % 32] + slot
    off = 16
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        off //= 2
    return lanes[0]


def _taps(h, meta, li, masks, sign=1):
    """(taps Cin, N): row t Cin + ci is h shifted by sign s_t and masked,
    the kernels' tap rows (sign -1: g_h's, masked at the source)."""
    rows = []
    for s in meta.taps[li]:
        mask = None if s == 0 else masks[(meta.axis[li], 1 if s > 0 else -1)]
        if sign > 0 or s == 0:
            rows.append(fs._tap_input(h, s, mask))
        else:
            rows.append(fs._shift(h * mask.to(h.dtype), -s))
    return torch.cat(rows)


def tc_chain(x, g, flat, meta):
    """The plain bf16 chain forward and backward (fused_sqnxt_plain and
    fused_sqnxt_bwd_plain, whose rounding points they keep) with every
    product in the tensor cores' order: (out, dx, dflat)."""
    masks = fs._tap_masks(meta, "cpu")
    f32, bf = torch.float32, torch.bfloat16

    def conv(h, w, li):
        cout = w.shape[1]
        wf = w.permute(1, 0, 2).reshape(cout, -1).to(f32)
        return _chunked(wf, _taps(h.to(f32), meta, li, masks))

    hs, h = [], x
    for li in range(5):
        hs.append(h)
        lf = fs._layer(flat, li)
        z = conv(h, lf[0], li).to(bf) + lf[1].to(bf)[:, None]
        h = fs.norm_relu(z, lf, meta, li)[0]
    out, dflat = h, [None] * len(flat)
    for li in range(4, -1, -1):
        lf = fs._layer(flat, li)
        w, b, gam, bet = lf
        z = conv(hs[li], w, li).to(bf) + b.to(bf)[:, None]
        _, zf, m, sr = fs.norm_relu(z, lf, meta, li)
        gam, bet = gam.to(f32)[:, None], bet.to(f32)[:, None]
        zh = (zf - m) / sr
        g_a = torch.where((zh * gam + bet).to(bf).to(f32) > 0, g,
                          torch.zeros_like(g)).to(f32)
        d_gam, d_bet = (g_a * zh).sum(1), g_a.sum(1)
        g_zh = g_a * gam
        inv_n = 1.0 / meta.n_real
        c1 = g_zh.sum(1, keepdim=True) * inv_n
        c2 = (g_zh * zh).sum(1, keepdim=True) * inv_n
        g_z = ((g_zh - c1 - zh * c2) / sr).to(bf).to(f32)
        taps, cout, cin = w.shape
        hk = _taps(hs[li].to(f32), meta, li, masks)
        dw = _dw_k7_order(g_z, hk, meta, li).to(bf).to(f32)
        dflat[4 * li: 4 * li + 4] = (
            dw.reshape(cout, taps, cin).permute(1, 0, 2),
            g_z.sum(1), d_gam, d_bet)
        wb = w.permute(2, 0, 1).reshape(cin, -1).to(f32)
        g = _chunked(wb, _taps(g_z, meta, li, masks, -1)).to(bf)
    return out, g, dflat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("dim, seed", [(32, 0), (48, 1), (64, 2)])
def test_tc_sum_order_within_the_gate_of_jax(dim, seed):
    """The tensor cores' sum order on the plain bf16 chain against JAX's
    _fwd_kernel and _bwd_kernel (interpret mode) on the same bf16 inputs:
    the output, dx and every parameter gradient but the conv biases within
    BF16_TOL of max |ref|; the conv biases (true gradient 0, rounding
    noise) within BF16_TOL of the layer's max |d_beta|."""
    B, H, W = 2, 8, 8
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    g = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    mod = JODEDynamics(dim, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(seed), 0.0, jnp.asarray(x))
    jmeta = jfs.make_meta(dim, B, H, W, jnp.bfloat16, interpret=True)

    def jfn(xx, p):
        return jfs.from_cn(jfs.fused_sqnxt_dyn(jfs.to_cn(xx, jmeta), p,
                                               jmeta), B, H, W)

    out, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16), params)
    gx, gp = vjp(jnp.asarray(g, jnp.bfloat16))
    meta = fs.make_meta(dim, B, H, W)
    sd = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, params))
    flat = fs.pack_params(sd, meta, torch.bfloat16)
    xc = fs.to_cn(torch.tensor(x).bfloat16(), meta)
    gc = fs.to_cn(torch.tensor(g).bfloat16(), meta)
    tout, tdx, dflat = tc_chain(xc, gc, flat, meta)
    assert _rel(fs.from_cn(tout, B, H, W).float(),
                np.asarray(out, np.float32)) <= BF16_TOL
    assert _rel(fs.from_cn(tdx, B, H, W).float(),
                np.asarray(gx, np.float32)) <= BF16_TOL
    ref = sqnxt_piece_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), gp))
    for li in range(5):
        dw, db, dgam, dbet = dflat[4 * li: 4 * li + 4]
        w = ref[f"convs.{li}.weight"]  # (Cout, Cin, kh, kw)
        want = w.permute(2, 3, 0, 1).reshape(dw.shape)
        assert _rel(dw, want) <= BF16_TOL, li
        assert _rel(dgam, ref[f"norms.{li}.scale"]) <= BF16_TOL, li
        assert _rel(dbet, ref[f"norms.{li}.bias"]) <= BF16_TOL, li
        scale = float(ref[f"norms.{li}.bias"].abs().max())
        assert float((db - ref[f"convs.{li}.bias"]).abs().max()) \
            <= BF16_TOL * scale, li


# -- K7's grid hook (comparisons of grids on the card) ------------------------

class _Lib:
    """A stand-in for the built library: records each K7 launch's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("label, esize", [("stage 3", 2), ("stage 1", 2),
                                          ("stage 2", 4)])
def test_k7_grid_hook_takes_a_smaller_grid(monkeypatch, label, esize):
    """``_launch_bwd(grid=)`` launches K7 at fewer blocks than its plan
    with the mirror's scratch at that grid, the plan's grid and scratch
    without it, and refuses a grid above the plan's or below 1 before
    launching."""
    import contextlib

    meta = _meta(label)
    plan = 264 if esize == 2 else 132
    monkeypatch.setattr(fs, "bwd_plan", lambda m, lis, dev, es: (
        plan, fs.bwd_scratch_floats(m, lis, plan, es)))
    lib = _Lib()
    monkeypatch.setattr(fs._build, "library", lambda: lib)
    monkeypatch.setattr(fs._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    dt = torch.bfloat16 if esize == 2 else torch.float32
    N, dim = meta.n_real, meta.cdims[0]
    x = torch.zeros(dim, N, dtype=dt)
    flat = [torch.zeros(1, dtype=dt)] * 20
    flats = [fs._layer(flat, li) for li in CHAIN]
    for grid in (None, 132, 1):
        fs._launch_bwd("pnode_sqnxt_bwd", x, x, flats, meta, CHAIN,
                       grid=grid)
        name, args = lib.calls[-1]
        want = plan if grid is None else grid
        assert name == "pnode_sqnxt_bwd" + ("_bf16" if esize == 2 else "")
        assert args[-3:-1] == (fs.bwd_scratch_floats(meta, CHAIN, want,
                                                     esize), want)
    for grid in (plan + 1, 0):
        with pytest.raises(ValueError, match="grid"):
            fs._launch_bwd("pnode_sqnxt_bwd", x, x, flats, meta, CHAIN,
                           grid=grid)
    assert len(lib.calls) == 3
