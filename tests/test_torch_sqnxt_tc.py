"""The bf16 instances on the tensor cores (K6's and K7's chain, K8's and
K9's one layer): the plan mirrors pinned, and the products' sum order held
against the JAX package's kernels.

The bf16 instances stage their operands as bf16 and run every product on
mma.sync.m16n8k16 (csrc/sqnxt_tiles.cuh, note 9): K = taps x Cin (forward)
or taps x Cout (g_h) padded to a multiple of 16, Cout and Cin padded to 8,
the halo staged to a multiple of 8 columns, column tiles of at least 32.
``stage_layout``, ``tc_geometry``, the tile columns and the scratch mirror
the C plans (phase 2 of chip_smoke.py holds them equal on the card); they
are pinned here at the three stage shapes of SqNxt-23 at B 128, at stage 1
at B 256 (where the bf16 model runs K8 and K9) and at every chip_smoke
SQNXT_EDGES and SQNXT_BF16_EDGES case, and the fp32 layouts at their
values from before the tensor-core path.

The mma sums each output in fp32 over k in chunks of 16, the chunks added
in order: ``tc_chain`` emulates that order (each chunk's exact sum
rounded to fp32, then added) for the plain bf16 chain and, ``layered``,
the plain bf16 layers one launch each, forward and backward, dW in the
kernel's whole order (per backward tile, then each block's slot, then the
blocks as one warp sums them; K7's grid for the chain, each K9 launch's
own for a layer), and each emulation is held against JAX's kernels in
interpret mode
(``_fwd_kernel`` and ``_bwd_kernel``; ``_fwd_layer_kernel`` and
``_bwd_layer_kernel`` through ``_core_layered``) within chip_smoke's
BF16_TOL (2^-6 of max |ref| per tensor), the gate the card holds the
kernels to."""

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

# the one-layer launches' shapes: the chain's, and stage 1 at B 256, where
# the bf16 model runs stage 1 layered (K8 and K9)
LAYER_SHAPES = dict(SHAPES, **{"stage 1 B256": (32, 256, 32, 32)})
LAYER_PADS = dict(PADS, **{"stage 1 B256": PADS["stage 1"]})

# K8's and K9's bf16 instances, each layer alone on the tensor cores: per
# layer (tile floats, weight floats) of the forward and of the backward,
# and the scratch floats of K8 and K9 at a grid of 264 (K8 keeps its one
# z in the store but for B1280's last layer, 20 tiles of 16 x 256 a block)
TC_LAYER_PLANS = {
    "stage 1": (((6272, 320), (8448, 384), 270336, 405504),
                ((6208, 96), (6208, 192), 270336, 304128),
                ((7392, 320), (16160, 320), 270336, 371712),
                ((11008, 448), (20544, 448), 270336, 473088),
                ((4096, 384), (10560, 384), 270336, 405504)),
    "stage 2": (((6400, 1152), (8704, 1280), 270336, 811008),
                ((4096, 320), (4352, 384), 270336, 405504),
                ((6528, 896), (15872, 896), 270336, 675840),
                ((11264, 1664), (21120, 1664), 270336, 1081344),
                ((4096, 1280), (10880, 1280), 270336, 811008)),
    "stage 3": (((4096, 4352), (5120, 4608), 270336, 2433024),
                ((4096, 1152), (4096, 1280), 270336, 811008),
                ((4096, 3328), (10240, 3328), 270336, 1892352),
                ((6656, 6400), (13056, 6400), 270336, 3514368),
                ((4096, 4608), (6400, 4608), 270336, 2433024)),
    "ragged B3 5x7 dim 16": (((4096, 96), (4096, 192), 270336, 304128),
                             ((4096, 96), (4096, 96), 270336, 278784),
                             ((4096, 96), (4784, 160), 270336, 295680),
                             ((4096, 160), (6176, 160), 270336, 321024),
                             ((4096, 192), (4096, 192), 270336, 304128)),
    "dim 48 B4 8x8": (((4096, 672), (4096, 960), 270336, 574464),
                      ((4096, 320), (4096, 320), 270336, 346368),
                      ((4096, 672), (7248, 704), 270336, 498432),
                      ((4096, 1056), (5216, 1056), 270336, 726528),
                      ((4096, 960), (4096, 960), 270336, 574464)),
    "B5 1x9 dim 16": (((4096, 96), (4096, 192), 270336, 304128),
                      ((4096, 96), (4096, 96), 270336, 278784),
                      ((4096, 96), (4784, 160), 270336, 295680),
                      ((4096, 160), (6368, 160), 270336, 321024),
                      ((4096, 192), (4096, 192), 270336, 304128)),
    "B640 32x32 dim 16": (((6208, 96), (6208, 192), 270336, 304128),
                          ((5184, 96), (5184, 96), 270336, 278784),
                          ((7280, 96), (9136, 160), 270336, 295680),
                          ((12704, 160), (12704, 160), 270336, 321024),
                          ((4160, 192), (6336, 192), 270336, 304128)),
}
TC_LAYER_PLANS["stage 1 B256"] = TC_LAYER_PLANS["stage 1"]
TC_LAYER_PLANS["B5 9x1 dim 16"] = TC_LAYER_PLANS["B1 3x3 dim 16"] = (
    ((4096, 96), (4096, 192), 270336, 304128),
    ((4096, 96), (4096, 96), 270336, 278784),
    ((4096, 96), (4784, 160), 270336, 295680),
    ((4096, 160), (6176, 160), 270336, 321024),
    ((4096, 192), (4096, 192), 270336, 304128))
TC_LAYER_PLANS["B1280 32x32 dim 16"] = (
    TC_LAYER_PLANS["B640 32x32 dim 16"][:4]
    + (((4160, 192), (6336, 192), 10756096, 304128),))


def _meta(label):
    return fs.make_meta(*LAYER_SHAPES[label])


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
    """The fp32 chain and every fp32 one-layer launch keep the FFMA tiles'
    shared-memory regions: only the bf16 instances take the tensor-core
    layout."""
    meta = _meta(label)
    chain, layers = FFMA_PLANS[label]
    assert (fs.stage_layout(meta, CHAIN, 4),
            fs.stage_layout(meta, CHAIN, 4, True)) == tuple(
                c + (False,) for c in chain)
    for li in range(5):
        got = (fs.stage_layout(meta, [li], 4),
               fs.stage_layout(meta, [li], 4, True))
        assert got == tuple(c + (False,) for c in layers[li]), li
    assert not fs.tensor_cores(4) and fs.tensor_cores(2)


@pytest.mark.parametrize("label", list(TC_LAYER_PLANS))
def test_tc_layer_plans_pinned(label):
    """K8's and K9's bf16 instances, each layer alone, on the tensor
    cores: the layer's geometry (K and Cout padding, the staged halo) and
    tile columns are the chain's (a layer's tile does not depend on the
    launch), the staged tile's and weights' floats of the forward and the
    backward, and K8's and K9's scratch at 264 blocks."""
    meta = _meta(label)
    chain = TC_PLANS["stage 1" if label == "stage 1 B256" else label][0]
    for li in range(5):
        g = fs.tc_geometry(meta, li, 0)
        assert (g["kf"], g["kb"], g["cf"], g["cb"], g["hr"]) == \
            LAYER_PADS[label][li], li
        assert (fs.fwd_tile_columns(meta, li, True),
                fs.bwd_tile_columns(meta, li, True)) == chain[li], li
        fwd, bwd, k8, k9 = TC_LAYER_PLANS[label][li]
        assert fs.stage_layout(meta, [li], 2) == fwd + (True,), li
        assert fs.stage_layout(meta, [li], 2, True) == bwd + (True,), li
        assert (fs.fwd_scratch_floats(meta, [li], 264, 2),
                fs.bwd_scratch_floats(meta, [li], 264, 2)) == (k8, k9), li


@pytest.mark.parametrize("label", list(LAYER_SHAPES))
def test_tc_strides_fit_ldmatrix(label):
    """Every staged row starts 16-byte aligned (ldmatrix and cp.async's
    16-byte rows) and the operand strides are 16 bytes times an odd
    number (ldmatrix's eight rows on distinct banks); tiles are whole
    32-column blocks (the jobs' 16 columns, the z tile's swizzle). The
    chain's layers and the one-layer launches (K8, K9) share each layer's
    geometry, so this covers both."""
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


def _grid(meta, lis):
    """K7's (``lis`` the chain) or K9's (one layer) grid where the card
    holds more co-resident blocks than the launch has tiles (every shape of
    the sum-order tests): the most tiles of any of its layers' forward or
    backward pass (fused_sqnxt.cu's bwd_grid)."""
    N = meta.n_real
    return max(-(-N // cols(meta, li, True)) for li in lis
               for cols in (fs.fwd_tile_columns, fs.bwd_tile_columns))


def _dw_order(gz, hk, meta, li, grid):
    """dW = gz hk^T in the backward kernels' order at ``grid`` blocks: each
    backward tile of the layer summed over its columns in chunks of 16
    (``_chunked``), the tiles of a block (tile t to block t mod grid) added
    into its slot in order, then the slots summed over blocks b <
    min(grid, tiles) as one warp does it (lane k adds blocks k, k + 32, ...
    from 0, then the xor shuffle tree)."""
    N, tn = meta.n_real, fs.bwd_tile_columns(meta, li, True)
    ntiles = -(-N // tn)
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


def _conv(h, w, meta, li, masks):
    """The layer's conv in the tensor cores' order (fp32)."""
    cout = w.shape[1]
    wf = w.permute(1, 0, 2).reshape(cout, -1).to(torch.float32)
    return _chunked(wf, _taps(h.to(torch.float32), meta, li, masks))


def tc_layer_fwd(h, lf, meta, li, masks):
    """Layer li's plain bf16 forward (``_layer_fwd``'s rounding points)
    with its conv in the tensor cores' order: the layer's output."""
    z = _conv(h, lf[0], meta, li, masks).to(torch.bfloat16) + lf[1].to(
        torch.bfloat16)[:, None]
    return fs.norm_relu(z, lf, meta, li)[0]


def tc_layer_bwd(h, g, lf, meta, li, masks, grid):
    """Layer li's plain bf16 backward (``_layer_bwd``'s rounding points)
    with every product in the tensor cores' order, dW in the order of a
    backward launch of ``grid`` blocks: (dh, (dW, db, dgam, dbet))."""
    f32, bf = torch.float32, torch.bfloat16
    w, b, gam, bet = lf
    z = _conv(h, w, meta, li, masks).to(bf) + b.to(bf)[:, None]
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
    hk = _taps(h.to(f32), meta, li, masks)
    dw = _dw_order(g_z, hk, meta, li, grid).to(bf).to(f32)
    wb = w.permute(2, 0, 1).reshape(cin, -1).to(f32)
    dh = _chunked(wb, _taps(g_z, meta, li, masks, -1)).to(bf)
    return dh, (dw.reshape(cout, taps, cin).permute(1, 0, 2), g_z.sum(1),
                d_gam, d_bet)


def tc_chain(x, g, flat, meta, layered=False):
    """The plain bf16 chain forward and backward (fused_sqnxt_plain and
    fused_sqnxt_bwd_plain, whose rounding points they keep) with every
    product in the tensor cores' order, dW summed as K7 sums it or, for
    ``layered`` (K8 and K9, one launch a layer), as each layer's K9 launch
    does at its own grid: (every layer's output, dx, dflat)."""
    masks = fs._tap_masks(meta, "cpu")
    hs = [x]
    for li in range(5):
        hs.append(tc_layer_fwd(hs[-1], fs._layer(flat, li), meta, li, masks))
    dflat = [None] * len(flat)
    for li in range(4, -1, -1):
        grid = _grid(meta, [li] if layered else CHAIN)
        g, dflat[4 * li: 4 * li + 4] = tc_layer_bwd(
            hs[li], g, fs._layer(flat, li), meta, li, masks, grid)
    return hs[1:], g, dflat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _against_jax(dim, seed, layered):
    """``tc_chain`` (``layered``: K8's and K9's order) against the JAX
    package's kernels in interpret mode on the same bf16 inputs at B 2,
    8x8: the chain (_fwd_kernel, _bwd_kernel) or, for ``layered``, the
    layer kernels through _core_layered (_fwd_layer_kernel,
    _bwd_layer_kernel), output and dx by jax.vjp. The output (layered:
    each layer's, _fwd_layer_kernel on JAX's own layer input), dx and every
    layer's parameter gradients but the conv biases within BF16_TOL of max
    |ref|; the conv biases (true gradient 0, rounding noise) within
    BF16_TOL of the layer's max |d_beta|."""
    B, H, W = 2, 8, 8
    bf = jnp.bfloat16
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    g = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    mod = JODEDynamics(dim, dtype=bf)
    params = mod.init(jax.random.PRNGKey(seed), 0.0, jnp.asarray(x))
    jmeta = jfs.make_meta(dim, B, H, W, bf, interpret=True, layered=layered)

    def jfn(xx, p):
        xc = jfs.to_cn(xx, jmeta)
        if layered:
            y = jfs._core_layered(xc, jfs.pack_params(p, jmeta, bf), jmeta)
        else:
            y = jfs.fused_sqnxt_dyn(xc, p, jmeta)
        return jfs.from_cn(y, B, H, W)

    out, vjp = jax.vjp(jfn, jnp.asarray(x, bf), params)
    gx, gp = vjp(jnp.asarray(g, bf))
    meta = fs.make_meta(dim, B, H, W)
    sd = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, params))
    flat = fs.pack_params(sd, meta, torch.bfloat16)
    xc = fs.to_cn(torch.tensor(x).bfloat16(), meta)
    gc = fs.to_cn(torch.tensor(g).bfloat16(), meta)
    touts, tdx, dflat = tc_chain(xc, gc, flat, meta, layered)
    assert _rel(fs.from_cn(touts[-1], B, H, W).float(),
                np.asarray(out, np.float32)) <= BF16_TOL
    if layered:
        jflat = jfs.pack_params(params, jmeta, bf)
        h = jfs.to_cn(jnp.asarray(x, bf), jmeta)
        for li in range(5):
            base, n_p = jfs._layer_flat_slice(jmeta, li)
            h = jfs._call_layer_fwd(h, jflat[base: base + n_p], jmeta, li)
            assert _rel(touts[li].float(), np.asarray(h, np.float32)) \
                <= BF16_TOL, li
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


@pytest.mark.parametrize("dim, seed", [(32, 0), (48, 1), (64, 2)])
def test_tc_sum_order_within_the_gate_of_jax(dim, seed):
    """The tensor cores' sum order on the plain bf16 chain (K6's and K7's
    order) against JAX's _fwd_kernel and _bwd_kernel (``_against_jax``)."""
    _against_jax(dim, seed, layered=False)


@pytest.mark.parametrize("dim, seed", [(16, 0), (16, 1), (32, 0), (32, 1)])
def test_tc_layer_sum_order_within_the_gate_of_jax(dim, seed):
    """The tensor cores' sum order one layer a launch (K8's and K9's, each
    K9 at its own grid) against JAX's _fwd_layer_kernel and
    _bwd_layer_kernel through _core_layered, for each of the five layers:
    the (1,3) and (3,1) layers are then layer 0 of their own launch
    (``_against_jax``)."""
    _against_jax(dim, seed, layered=True)


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
