"""K7's and K9's plain versions (ops/fused_sqnxt.py fused_sqnxt_bwd_plain,
fused_sqnxt_layer_bwd_plain) against the JAX package's backward kernels at
the real channel widths, and the backward kernels' scratch sizes.

chip_smoke.py gates the CUDA kernels against exactly these plain versions,
at the three ODE stage widths of SqNxt-23 (dim 32, 64, 128) and at dim 48
(cdims 48, 24, 12: no power of two); tests/test_torch_fused_sqnxt.py twins
them at dim 16 only. Here the plain backward, chain and layered, is held
against ``jax.vjp`` of the JAX package's ``fused_sqnxt_dyn`` (its Pallas
backward kernels in interpret mode) at those widths on small images (B 2
at 8x8 and 4x4), in fp64 inputs, at test_fp64_matches_jax_kernels'
tolerances: both sides keep the statistics and the norm's backward in
fp32 (the Pallas kernels' casts, kept at fp64) and sum in different
orders, so they agree to fp32 rounding (gradients rtol 2e-4 / atol 2e-5;
a conv bias feeding a batch-stats norm has a true gradient of exactly 0,
gated absolutely at 5e-4)."""

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


def _assert_grads(got_dx, got_flat, gx0, gp0, meta):
    """The port's (dx, flat gradients) against JAX's (dx, flax gradients
    as a torch state dict)."""
    np.testing.assert_allclose(got_dx, gx0, rtol=2e-4, atol=2e-5)
    for li in range(5):
        dw, db, dgam, dbet = got_flat[4 * li: 4 * li + 4]
        w = gp0[f"convs.{li}.weight"]  # (Cout, Cin, kh, kw)
        cout, cin = w.shape[0], w.shape[1]
        want_w = w.permute(2, 3, 0, 1).reshape(-1, cout, cin).numpy()
        np.testing.assert_allclose(dw.numpy(), want_w, rtol=2e-4, atol=2e-5,
                                   err_msg=f"layer {li} dW")
        assert np.abs(db.numpy()).max() < 5e-4, f"layer {li} conv bias"
        np.testing.assert_allclose(dgam.numpy(),
                                   gp0[f"norms.{li}.scale"].numpy(),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"layer {li} dgamma")
        np.testing.assert_allclose(dbet.numpy(),
                                   gp0[f"norms.{li}.bias"].numpy(),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"layer {li} dbeta")


@pytest.mark.parametrize("hw", [8, 4], ids=["8x8", "4x4"])
@pytest.mark.parametrize("dim", [32, 64, 128, 48])
def test_plain_backward_matches_jax_kernels(dim, hw):
    """fused_sqnxt_bwd_plain (K7's plain version) and
    fused_sqnxt_layer_bwd_plain over the five layers (K9's), on the plain
    forward's layer inputs, == jax.vjp of the JAX kernels (chain and
    layered) at a real width."""
    B, H, W = 2, hw, hw
    params, x, tp, tx, jmeta, meta = _setup(dim, B, H, W, seed=dim + hw)
    xc, N = jfs.to_cn(x, jmeta), B * H * W
    g = np.random.default_rng(dim).normal(size=(dim, N))
    g_pad = np.pad(g, ((0, 0), (0, jmeta.n_pad - N)))  # JAX's 128-lane pad
    flat = fs.pack_params(tp, meta, torch.float64)
    txc, tg = fs.to_cn(tx, meta), torch.tensor(g)
    for layered in (False, True):
        jm = jmeta._replace(layered=layered)
        _, vjp = jax.vjp(lambda xx, pp: jfs.fused_sqnxt_dyn(xx, pp, jm),
                         xc, params)
        gx0, gp0 = vjp(jnp.asarray(g_pad))
        gx0 = np.asarray(gx0)[:, :N]
        gp0 = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, gp0))
        if not layered:
            dx, dflat = fs.fused_sqnxt_bwd_plain(txc, tg, flat, meta)
        else:
            hs, h = [], txc
            for li in range(5):
                hs.append(h)
                h = fs.fused_sqnxt_layer_plain(h, fs._layer(flat, li), meta,
                                               li)
            dflat, gl = [None] * 20, tg
            for li in range(4, -1, -1):
                gl, d = fs.fused_sqnxt_layer_bwd_plain(
                    hs[li], gl, fs._layer(flat, li), meta, li)
                dflat[4 * li: 4 * li + 4] = d
            dx = gl
        _assert_grads(dx.numpy(), dflat, gx0, gp0, meta)


def _params(dim):
    return dict(ODEDynamics(dim).named_parameters())


def _chain_scratch(dim, B, H, W, grid):
    meta = fs.make_meta(dim, B, H, W)
    N = meta.n_real
    c = meta.cdims
    dw = max(-(-len(meta.taps[li]) * c[li] * c[li + 1] // 4) * 4
             for li in range(5))
    return meta, 2 * grid * 4 * 128 + grid * dw + 2 * max(c[1:5]) * N


@pytest.mark.parametrize("shape,grid", [
    ((32, 128, 32, 32), 264), ((64, 128, 16, 16), 264),
    ((128, 128, 8, 8), 256), ((16, 3, 5, 7), 1), ((48, 4, 8, 8), 2)])
def test_bwd_scratch_floats(shape, grid):
    """The scratch one K7 or K9 launch takes, as csrc/sqnxt_tiles.cuh counts
    it: two partial-slot buffers of grid x 4 x 128, one dW slot per block
    (the largest taps Cin Cout, rounded up to 4) and, for the chain only,
    two g buffers of the largest Cin past the first layer x N."""
    meta, want = _chain_scratch(*shape, grid)
    assert fs.bwd_scratch_floats(meta, range(5), grid) == want
    c, N = meta.cdims, meta.n_real
    for li in range(5):
        dw = -(-len(meta.taps[li]) * c[li] * c[li + 1] // 4) * 4
        assert fs.bwd_scratch_floats(meta, [li], grid) == \
            2 * grid * 4 * 128 + grid * dw


def test_bwd_scratch_floats_at_stage_2():
    """Stage 2 of SqNxt-23 at B 128: (3,1) layer 32 -> 32 has the largest
    dW (3,072 floats); the largest Cin past layer 0 is 32, N 32,768."""
    meta = fs.make_meta(64, 128, 16, 16)
    assert fs.bwd_scratch_floats(meta, range(5), 264) == \
        264 * 1024 + 264 * 3072 + 2 * 32 * 32768


@pytest.mark.parametrize("case", ["wide", "no_chain", "taps", "layers",
                                  "grid"])
def test_bwd_scratch_floats_refuses(case):
    """What the kernels refuse, the helper refuses: more than 128 channels,
    layers that do not chain, taps that do not match their axis, a layer
    count other than 1 or 5, an empty grid."""
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
        fs.bwd_scratch_floats(meta, lis, 0 if case == "grid" else 4)


def test_bwd_scratch_floats_refuses_large_dw():
    """A (3,1) layer of 128 -> 128 channels: its dW (128 x 384) would take
    12 register tiles a thread, past the kernels' three."""
    meta = fs.make_meta(128, 2, 8, 8)
    meta = meta._replace(cdims=(128, 128, 128, 128, 128, 128))
    with pytest.raises(ValueError, match="register tiles"):
        fs.bwd_scratch_floats(meta, [3], 1)


def test_cpu_tensors_never_plan():
    """CPU tensors run the plain backward: no plan, no library."""
    meta = fs.make_meta(16, 1, 3, 3)
    flat = [torch.randn(t.shape, dtype=torch.float64) for t in
            fs.pack_params(_params(16), meta, torch.float64)]
    x = torch.randn(16, 9, dtype=torch.float64)
    g = torch.randn(16, 9, dtype=torch.float64)
    before = (fs.fused_sqnxt_bwd.launches, len(fs._bwd_plans))
    dx, _ = fs.fused_sqnxt_bwd(x, g, flat, meta)
    assert dx.shape == (16, 9)
    assert (fs.fused_sqnxt_bwd.launches, len(fs._bwd_plans)) == before
