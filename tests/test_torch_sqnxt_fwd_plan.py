"""K6's and K8's plain versions (ops/fused_sqnxt.py fused_sqnxt_plain,
fused_sqnxt_layer_plain) against the JAX package's forward kernels at the
real channel widths, and the forward kernels' plan: tile columns, scratch
sizes, refusals, and the layered rows' bound.

chip_smoke.py gates the CUDA kernels against exactly these plain versions
at the three ODE stage widths of SqNxt-23 (dim 32, 64, 128) and at dim 48
(cdims 48, 24, 12: no power of two). Here the plain forward, chain and one
layer at a time, is held against the JAX package's ``_fwd_kernel`` and
``_fwd_layer_kernel`` (Pallas, interpret mode) at those widths on small
images (B 2 at 8x8 and 4x4), in fp64 inputs. Both sides keep the
statistics in fp32 (the Pallas kernels' casts, kept at fp64) and sum in
different orders, so they agree to fp32 rounding: rtol 2e-5 / atol 1e-5,
test_fp64_matches_jax_kernels' forward tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.models.sqnxt import ODEDynamics as JODEDynamics
from pnode_tpu.ops import fused_sqnxt as jfs
from pnode_tpu_torch.convert import sqnxt_piece_from_flax
from pnode_tpu_torch.models.sqnxt import ODEDynamics
from pnode_tpu_torch.ops import fused_sqnxt as fs

torch.set_num_threads(1)

PART = 2 * 4 * 128  # two partial slots of 4 x 128 floats per block


def _setup(dim, B, H, W, seed):
    """Flax ODEDynamics(dim) weights from ``seed``, fp64 inputs, both
    packages' metas (JAX's in interpret mode)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, dim))
    params = JODEDynamics(dim).init(jax.random.PRNGKey(seed), 0.0,
                                    jnp.asarray(x, jnp.float32))
    sd = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tparams = {k: v.to(torch.float64) for k, v in sd.items()}
    jmeta = jfs.make_meta(dim, B, H, W, jnp.float64, interpret=True)
    return params, jnp.asarray(x, jnp.float64), tparams, \
        torch.tensor(x, dtype=torch.float64), jmeta, fs.make_meta(dim, B, H, W)


@pytest.mark.parametrize("hw", [8, 4], ids=["8x8", "4x4"])
@pytest.mark.parametrize("dim", [32, 64, 128, 48])
def test_plain_forward_matches_jax_kernels(dim, hw):
    """fused_sqnxt_plain (K6's plain version) == JAX's _fwd_kernel, and
    fused_sqnxt_layer_plain (K8's) == _fwd_layer_kernel on each of the
    five layers, fed the same layer input, at a real width."""
    B, H, W = 2, hw, hw
    params, x, tp, tx, jmeta, meta = _setup(dim, B, H, W, seed=dim + hw + 1)
    N, pad = B * H * W, jmeta.n_pad - B * H * W
    jflat = jfs.pack_params(params, jmeta, jnp.float64)
    flat = fs.pack_params(tp, meta, torch.float64)
    txc = fs.to_cn(tx, meta)
    np.testing.assert_allclose(
        fs.fused_sqnxt_plain(txc, flat, meta).numpy(),
        np.asarray(jfs._call_fwd(jfs.to_cn(x, jmeta), jflat, jmeta))[:, :N],
        rtol=2e-5, atol=1e-5)
    h = txc
    for li in range(5):
        got = fs.fused_sqnxt_layer_plain(h, fs._layer(flat, li), meta, li)
        base, n_p = jfs._layer_flat_slice(jmeta, li)
        hj = jnp.asarray(np.pad(h.numpy(), ((0, 0), (0, pad))))
        want = jfs._call_layer_fwd(hj, jflat[base: base + n_p], jmeta, li)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :N],
                                   rtol=2e-5, atol=1e-5,
                                   err_msg=f"layer {li}")
        h = got


@pytest.mark.parametrize("shape,cols", [
    ((32, 128, 32, 32), [256, 512, 256, 256, 128]),
    ((64, 128, 16, 16), [128, 128, 128, 128, 64]),
    ((128, 128, 8, 8), [32, 32, 32, 32, 32]),
    ((16, 3, 5, 7), [128, 128, 128, 128, 64])])
def test_fwd_tile_columns(shape, cols):
    """A forward tile is 4096 / RT columns (RT: Cout rounded up to 8-128),
    halved at most twice while N would give fewer than 256 tiles: stage 1
    never halves, stage 2 halves its Cout-16 layer once, stage 3 every
    layer (to 256 tiles of 32 columns), and a tiny N halves twice."""
    meta = fs.make_meta(*shape)
    assert [fs.fwd_tile_columns(meta, li) for li in range(5)] == cols


# (shape, grid, chain anchors' channels, the last layer kept on chip in
# the chain, the layer whose z the chain's store is sized by: its tiles of
# the block x Cout x tile columns)
STAGES = [
    # stage 1: every layer single pass; the last (Cout 32, 1024 tiles of
    # 128) takes 8 tiles x 32 x 128 = 32,768 floats at 132 blocks
    ((32, 128, 32, 32), 132, 16 + 8 + 16 + 16, True, 8 * 32 * 128),
    ((32, 128, 32, 32), 264, 16 + 8 + 16 + 16, True, 4 * 32 * 128),
    # stage 2: layer 1 centered (Cout 16: 2 tiles x 16 x 128), the last
    # (Cout 64, 512 tiles of 64): 4 tiles x 64 x 64 at 132 blocks
    ((64, 128, 16, 16), 132, 32 + 16 + 32 + 32, True, 4 * 64 * 64),
    # stage 3: layers 0-3 centered, all 256 tiles of 32 columns
    ((128, 128, 8, 8), 132, 64 + 32 + 64 + 64, True, 2 * 128 * 32),
    # B 512 at 32x32: the last layer's 4,096 tiles give each of 132 blocks
    # 32 tiles x 32 x 128 floats, past the store: it keeps its anchor
    ((32, 512, 32, 32), 132, 16 + 8 + 16 + 16 + 32, False, 32 * 32 * 128),
    # chip_smoke.py's B640 edge (dim 16): 2,560 tiles of 256 columns give
    # 10 a block at 264 blocks, 10 x 16 x 256 floats: the last anchor stays
    ((16, 640, 32, 32), 264, 8 + 4 + 8 + 8 + 16, False, 10 * 16 * 256),
]


@pytest.mark.parametrize("shape,grid,anchors,keep,store", STAGES)
def test_fwd_scratch_floats_at_stages(shape, grid, anchors, keep, store):
    """K6's scratch: two partial-slot buffers, then the anchors of layers
    0-3 (the next layer's halo crosses blocks) and of the last layer only
    where its z does not stay on chip (the store over STORE_FLOATS)."""
    meta = fs.make_meta(*shape)
    assert (store <= fs.STORE_FLOATS) == keep
    assert fs.fwd_scratch_floats(meta, range(5), grid) == \
        grid * PART + anchors * meta.n_real


@pytest.mark.parametrize("shape,grid", [
    ((32, 128, 32, 32), 132), ((32, 128, 32, 32), 264),
    ((32, 512, 32, 32), 132)])
def test_fwd_layer_scratch_floats(shape, grid):
    """K8 (one layer): no anchor where the layer's own store fits (stage 1
    of the model at B 128: 1,024 columns of Cout <= 32 a block), else its
    Cout x N anchor (B 512's Cout-32 layers)."""
    meta = fs.make_meta(*shape)
    N = meta.n_real
    for li in range(5):
        cout, tn = meta.cdims[li + 1], fs.fwd_tile_columns(meta, li)
        store = -(-(-(-N // tn)) // grid) * cout * tn
        want = grid * PART + (0 if store <= 32768 else cout * N)
        assert fs.fwd_scratch_floats(meta, [li], grid) == want
    assert fs.fwd_scratch_floats(meta, [4], grid) == grid * PART + (
        0 if shape[1] == 128 else 32 * N)


@pytest.mark.parametrize("edge", [
    ("ragged B3 5x7 dim 16", 16, 3, 5, 7, 1),
    ("dim 48 B4 8x8", 48, 4, 8, 8, 2),
    ("B5 1x9 dim 16", 16, 5, 1, 9, 1),
    ("B5 9x1 dim 16", 16, 5, 9, 1, 1),
    ("B1 3x3 dim 16", 16, 1, 3, 3, 1)], ids=lambda e: e[0])
def test_fwd_scratch_floats_at_edges(edge):
    """chip_smoke.py's small SQNXT_EDGES shapes (its B640 edge is in
    STAGES): a few tiles, all on chip, so the chain writes the anchors of
    layers 0-3 (c1 + c2 + c1 + c1 channels) and one layer writes none."""
    _, dim, B, H, W, grid = edge
    meta = fs.make_meta(dim, B, H, W)
    c1, c2, N = dim // 2, dim // 4, B * H * W
    assert fs.fwd_scratch_floats(meta, range(5), grid) == \
        grid * PART + (3 * c1 + c2) * N
    for li in range(5):
        assert fs.fwd_scratch_floats(meta, [li], grid) == grid * PART


@pytest.mark.parametrize("case", ["wide", "no_chain", "taps", "layers",
                                  "grid"])
def test_fwd_scratch_floats_refuses(case):
    """What the forward kernels refuse, the helper refuses: more than 128
    channels, layers that do not chain, taps that do not match their axis,
    a layer count other than 1 or 5, an empty grid."""
    meta = fs.make_meta(64, 2, 8, 8)
    lis = list(range(5))
    if case == "wide":
        meta = fs.make_meta(160, 2, 8, 8)
    elif case == "no_chain":
        lis = [0, 2, 3, 4, 1]
    elif case == "taps":
        meta = meta._replace(axis=(None, "j", "j", "i", None))
    elif case == "layers":
        lis = [0, 1]
    with pytest.raises(ValueError):
        fs.fwd_scratch_floats(meta, lis, 0 if case == "grid" else 4)


def test_fwd_takes_a_wide_dw():
    """A (3,1) layer of 128 -> 128 channels: the backward refuses its dW,
    the forward has none and takes it."""
    meta = fs.make_meta(128, 2, 8, 8)
    meta = meta._replace(cdims=(128, 128, 128, 128, 128, 128))
    assert fs.fwd_scratch_floats(meta, [3], 1) == PART
    with pytest.raises(ValueError, match="register tiles"):
        fs.bwd_scratch_floats(meta, [3], 1)


def test_cpu_tensors_never_plan():
    """CPU tensors run the plain forward, chain and one layer: no plan, no
    library, no launch counted."""
    meta = fs.make_meta(16, 1, 3, 3)
    params = dict(ODEDynamics(16).named_parameters())
    flat = [torch.randn(t.shape, dtype=torch.float64) for t in
            fs.pack_params(params, meta, torch.float64)]
    x = torch.randn(16, 9, dtype=torch.float64)
    before = (fs.fused_sqnxt_fwd.launches, fs.fused_sqnxt_layer_fwd.launches,
              len(fs._fwd_plans))
    out = fs.fused_sqnxt_fwd(x, flat, meta)
    h = fs.fused_sqnxt_layer_fwd(x, fs._layer(flat, 0), meta, 0)
    assert out.shape == (16, 9) and h.shape == (8, 9)
    assert torch.equal(out, fs.fused_sqnxt_plain(x, flat, meta))
    assert (fs.fused_sqnxt_fwd.launches, fs.fused_sqnxt_layer_fwd.launches,
            len(fs._fwd_plans)) == before


@pytest.mark.parametrize("backward,flops,byts", [
    (False, 4.5 * 32 * 32 * 131072, 4 * 176 * 131072),
    (True, 3 * 4.5 * 32 * 32 * 131072, 4 * 264 * 131072)])
def test_layered_cost_counts_each_launch(backward, flops, byts):
    """The layered rows' bound (K8, K9 at stage 1 of SqNxt-23, B 128): the
    chain's FLOPs, but each of the five launches reads its own layer's
    input (and, backward, its cotangent, and writes its dx) and writes its
    output: sum(Cin + Cout) = 176 channels forward, sum(2 Cin + Cout) =
    264 backward, plus the parameters and their gradients: 27.5 us and
    41.3 us at 3.35 TB/s, set by bytes."""
    meta = fs.make_meta(32, 128, 32, 32)
    f, b = fs.sqnxt_layered_cost(meta, backward)
    params = sum(len(meta.taps[li]) * meta.cdims[li] * meta.cdims[li + 1]
                 + 3 * meta.cdims[li + 1] for li in range(5))
    assert f == int(flops)
    assert b == byts + 4 * (2 if backward else 1) * params
    assert b / 3.35e12 > f / 67e12
    assert round(b / 3.35e12 * 1e3, 4) == (0.0413 if backward else 0.0275)
    chain = fs.sqnxt_cost(meta, range(5), backward)
    assert chain[0] == f and chain[1] < b


# -- the bf16 instances' scratch (2-byte anchors and g buffers) -----------------

@pytest.mark.parametrize("shape,grid,anchors,keep,store", STAGES)
def test_fwd_scratch_floats_bf16(shape, grid, anchors, keep, store):
    """K6's bf16 instance: the same partial slots, its anchors at 2 bytes an
    element (ceil(Cout N / 2) floats each), and a store of bf16 z tiles
    (the tensor-core path) in half the fp32 store's floats, so a last z
    past the fp32 store fits it where half of it fits STORE_FLOATS (B640
    at 264 blocks): then its last layer writes no anchor."""
    meta = fs.make_meta(*shape)
    got = fs.fwd_scratch_floats(meta, range(5), grid, 2)
    kept = keep or store // 2 <= fs.STORE_FLOATS
    assert kept == (shape == (16, 640, 32, 32) or keep)
    last = meta.cdims[5] if kept and not keep else 0
    assert got == grid * PART + (anchors - last) * meta.n_real // 2
    if not last:
        assert got - grid * PART == (fs.fwd_scratch_floats(
            meta, range(5), grid) - grid * PART) // 2


@pytest.mark.parametrize("shape,grid", [
    ((32, 128, 32, 32), 264), ((64, 128, 16, 16), 264),
    ((128, 128, 8, 8), 256), ((16, 3, 5, 7), 1), ((48, 4, 8, 8), 2)])
def test_bwd_scratch_floats_bf16(shape, grid):
    """K7's bf16 instance: the partial slots and dW slots stay fp32, its
    two g buffers of max Cin N elements take 2 bytes an element (one
    fp32 g buffer's floats for both); K9's has no g buffer, so its count
    is the fp32 one."""
    meta = fs.make_meta(*shape)
    c, N = meta.cdims, meta.n_real
    gmax = max(c[1:5]) * N
    assert fs.bwd_scratch_floats(meta, range(5), grid, 2) == \
        fs.bwd_scratch_floats(meta, range(5), grid) - gmax
    for li in range(5):
        assert fs.bwd_scratch_floats(meta, [li], grid, 2) == \
            fs.bwd_scratch_floats(meta, [li], grid)


def test_elem_floats_rounds_up():
    """csrc's elem_floats: ceil(n esize / 4), so an odd count of bf16
    elements takes the float it half fills."""
    assert [fs.elem_floats(n, 2) for n in (0, 1, 2, 7, 8)] == [0, 1, 1, 4, 4]
    assert fs.elem_floats(7, 4) == 7


def test_bf16_costs_count_two_byte_storage():
    """The bf16 rows' costs: the same FLOPs; activations, taps and b at 2
    bytes, gamma, beta and the fp32 gradients at 4 (stage 1, B 128: the
    chain's 16.8 MB forward and 25.2 MB backward, K8's five launches 46.1
    MB, K9's 69.2 MB). Their bound rates those FLOPs at the H100's bf16
    tensor-core peak, so every bf16 instance is bound by its bytes at every
    stage (stage 1: K6 5.0 us, K7 7.5, K9 20.7)."""
    from pnode_tpu_torch.utils.roofline import H100_PEAKS, peaks_for

    meta = fs.make_meta(32, 128, 32, 32)
    for bwd in (False, True):
        f2, b2 = fs.sqnxt_cost(meta, range(5), bwd, 2)
        f4, b4 = fs.sqnxt_cost(meta, range(5), bwd)
        assert f2 == f4 and b2 < b4
    assert round(fs.sqnxt_cost(meta, range(5), False, 2)[1] / 1e6, 2) == 16.78
    assert round(fs.sqnxt_cost(meta, range(5), True, 2)[1] / 1e6, 2) == 25.18
    assert round(fs.sqnxt_layered_cost(meta, False, 2)[1] / 1e6, 2) == 46.14
    assert round(fs.sqnxt_layered_cost(meta, True, 2)[1] / 1e6, 2) == 69.22
    peak, rate = peaks_for(H100_PEAKS, torch.bfloat16)
    us = []
    for dim, hw in ((32, 32), (64, 16), (128, 8)):
        m = fs.make_meta(dim, 128, hw, hw)
        for bwd in (False, True):
            for f, b in (fs.sqnxt_cost(m, range(5), bwd, 2),
                         fs.sqnxt_layered_cost(m, bwd, 2)):
                assert f / peak < b / rate
                us.append(round(1e6 * b / rate, 1))
    assert us[:4] == [5.0, 13.8, 7.5, 20.7]
