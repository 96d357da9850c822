"""The port's fused SqueezeNext dynamics (ops/fused_sqnxt.py: the plain
versions of K6-K9 and their autograd Functions) against the JAX package:
twins of tests/test_fused_sqnxt.py.

fp32: the flax ODEDynamics and JAX's Pallas kernels in interpret mode are
the references, at that file's tolerances (forward rtol 2e-5 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5; a conv bias feeding a batch-stats norm has
a true gradient of exactly zero, so it is gated in absolute terms, 5e-4).
fp64 inputs: the JAX kernels' math (xla_reference, and the kernels in
interpret mode for the backward) keeps its statistics in fp32 even then,
so the two agree to fp32 rounding only; the exactness of the hand-written
backward is held in true fp64 (work=float64) against autograd through the
plain forward, at rtol 1e-10 / atol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.models.sqnxt import BatchStatsNorm as JBatchStatsNorm
from pnode_tpu.models.sqnxt import ODEDynamics as JODEDynamics
from pnode_tpu.models.sqnxt import _conv as jconv
from pnode_tpu.ops import fused_sqnxt as jfs
from pnode_tpu_torch.convert import sqnxt_piece_from_flax
from pnode_tpu_torch.ops import fused_sqnxt as fs

torch.set_num_threads(1)


def _setup(dim=16, B=4, H=8, W=8, seed=0, jdt=jnp.float32, tdt=torch.float32,
           module=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, dim))
    mod = module if module is not None else JODEDynamics(dim)
    params = mod.init(jax.random.PRNGKey(seed), 0.0,
                      jnp.asarray(x, jnp.float32))
    sd = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tparams = {k: v.to(tdt) for k, v in sd.items()}
    jmeta = jfs.make_meta(dim, B, H, W, jdt, interpret=True)
    meta = fs.make_meta(dim, B, H, W)
    return mod, params, jnp.asarray(x, jdt), tparams, torch.tensor(x, dtype=tdt), jmeta, meta


def _port_fwd(tparams, tx, meta):
    B, H, W = tx.shape[:3]
    return fs.from_cn(fs.fused_sqnxt_dyn(fs.to_cn(tx, meta), tparams, meta),
                      B, H, W)


def _jax_fused(params, x, jmeta):
    B, H, W = x.shape[:3]
    return jfs.from_cn(jfs.fused_sqnxt_dyn(jfs.to_cn(x, jmeta), params, jmeta),
                       B, H, W)


@pytest.mark.parametrize("layered", [False, True], ids=["chain", "layered"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 5, 5, 16),
                                   (3, 8, 4, 32), (3, 5, 7, 16)])
def test_fwd_matches_flax(shape, layered):
    """Forward == the flax module and == JAX's kernels in interpret mode
    (fp32), including ragged N and H != W, in both modes."""
    B, H, W, dim = shape
    mod, params, x, tp, tx, jmeta, meta = _setup(dim, B, H, W)
    meta = meta._replace(layered=layered)
    jmeta = jmeta._replace(layered=layered)
    out = _port_fwd(tp, tx, meta).numpy()
    np.testing.assert_allclose(out, np.asarray(mod.apply(params, 0.0, x)),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(_jax_fused(params, x, jmeta)),
                               rtol=2e-5, atol=1e-5)


def test_fwd_single_pass_branch():
    """single_pass variance (E[x^2] - E[x]^2, clamped) against a flax chain
    with the gate forced on."""
    import flax.linen as nn

    class ForcedDyn(nn.Module):
        dim: int

        @nn.compact
        def __call__(self, t, x):
            c1, c2 = self.dim // 2, self.dim // 4
            norm = lambda: JBatchStatsNorm(single_pass_min_size=1)  # noqa
            h = nn.relu(norm()(jconv(c1, 1)(x)))
            h = nn.relu(norm()(jconv(c2, 1)(h)))
            h = nn.relu(norm()(jconv(c1, (1, 3))(h)))
            h = nn.relu(norm()(jconv(c1, (3, 1))(h)))
            return nn.relu(norm()(jconv(self.dim, 1)(h)))

    mod, params, x, tp, tx, _, meta = _setup(16, 4, 8, 8, seed=3,
                                             module=ForcedDyn(16))
    meta = meta._replace(single_pass=(True,) * 5)
    np.testing.assert_allclose(_port_fwd(tp, tx, meta).numpy(),
                               np.asarray(mod.apply(params, 0.0, x)),
                               rtol=2e-5, atol=1e-5)


def _grads(shape, layered, seed, wseed):
    B, H, W, dim = shape
    mod, params, x, tp, tx, _, meta = _setup(dim, B, H, W, seed=seed)
    meta = meta._replace(layered=layered)
    w = np.random.default_rng(wseed).normal(size=(B, H, W, dim))
    jw = jnp.asarray(w, jnp.float32)
    (l0, (gp0, gx0)) = jax.value_and_grad(
        lambda p, xx: jnp.sum(mod.apply(p, 0.0, xx) * jw), argnums=(0, 1))(
            params, x)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    l1 = (_port_fwd(tp, tx, meta) * torch.tensor(w, dtype=torch.float32)).sum()
    l1.backward()
    g0 = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, gp0))
    return (float(l0), np.asarray(gx0), g0), (float(l1), tx.grad.numpy(),
                                              {k: v.grad for k, v in tp.items()})


@pytest.mark.parametrize("shape, layered, seed", [
    ((4, 8, 8, 16), False, 2), ((2, 5, 5, 16), False, 4),
    ((4, 8, 8, 16), True, 2)], ids=["chain", "ragged", "layered"])
def test_grad_matches_flax(shape, layered, seed):
    """d(loss)/d(x) and d(loss)/d(every parameter) through the autograd
    Function (K7's or K9's plain version) == autodiff through flax."""
    (l0, gx0, g0), (l1, gx1, g1) = _grads(shape, layered, seed, 9)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(gx1, gx0, rtol=2e-4, atol=2e-5)
    assert set(g0) == set(g1)
    for k, v0 in g0.items():
        v1 = g1[k].numpy()
        if k.startswith("convs") and k.endswith("bias"):
            np.testing.assert_allclose(v0.numpy(), 0, atol=5e-4)
            np.testing.assert_allclose(v1, 0, atol=5e-4)
            continue
        np.testing.assert_allclose(v1, v0.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_layered_equals_chain():
    """Layered and chain modes are the same math: outputs and gradients."""
    outs = [_grads((4, 8, 8, 16), layered, 5, 2)[1] for layered in (False, True)]
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-7)
    for k in outs[0][2]:
        np.testing.assert_allclose(outs[1][2][k], outs[0][2][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _flat_jax(params, jmeta, dtype):
    """The JAX kernels' flat arguments, regrouped per layer as the port's
    (W (taps, Cout, Cin), b, gamma, beta)."""
    flat = jfs.pack_params(params, jmeta, dtype)
    out, i = [], 0
    for li in range(5):
        nt = len(jmeta.taps[li])
        out.append(np.stack([np.asarray(w) for w in flat[i:i + nt]]))
        out += [np.asarray(flat[i + nt + k]).reshape(-1) for k in range(3)]
        i += nt + 3
    return out


@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (3, 5, 7, 16)])
def test_fp64_matches_jax_kernels(shape):
    """fp64 inputs: the plain chain == xla_reference, and the plain backward
    (chain and layered) == JAX's backward kernels in interpret mode. Both
    sides take the statistics and the norm's backward in fp32 (the Pallas
    kernels' casts, kept at fp64), summed in different orders, so they
    agree to fp32 rounding (forward atol 1e-5, gradients 2e-4 / 2e-5), not
    to fp64's."""
    B, H, W, dim = shape
    _, params, x, tp, tx, jmeta, meta = _setup(
        dim, B, H, W, seed=7, jdt=jnp.float64, tdt=torch.float64)
    xc, N = jfs.to_cn(x, jmeta), B * H * W
    np.testing.assert_allclose(
        fs.fused_sqnxt_plain(fs.to_cn(tx, meta), fs.pack_params(
            tp, meta, torch.float64), meta).numpy(),
        np.asarray(jfs.xla_reference(xc, params, jmeta))[:, :N],
        rtol=2e-5, atol=1e-5)
    g = np.random.default_rng(1).normal(size=(dim, N))
    g_pad = np.pad(g, ((0, 0), (0, jmeta.n_pad - N)))  # JAX's 128-lane pad
    for layered in (False, True):
        jm = jmeta._replace(layered=layered)
        _, vjp = jax.vjp(lambda xx, pp: jfs.fused_sqnxt_dyn(xx, pp, jm),
                         xc, params)
        gx0, gp0 = vjp(jnp.asarray(g_pad))
        gx0 = np.asarray(gx0)[:, :N]
        gp0 = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, gp0))
        tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        txc = fs.to_cn(tx, meta).requires_grad_(True)
        out = fs.fused_sqnxt_dyn(txc, tpg, meta._replace(layered=layered))
        out.backward(torch.tensor(g))
        np.testing.assert_allclose(txc.grad.numpy(), np.asarray(gx0),
                                   rtol=2e-4, atol=2e-5)
        for k, v in gp0.items():
            if k.startswith("convs") and k.endswith("bias"):
                assert np.abs(tpg[k].grad.numpy()).max() < 5e-4, k
                continue
            np.testing.assert_allclose(tpg[k].grad.numpy(), v.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("layered", [False, True], ids=["chain", "layered"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (3, 5, 7, 16)])
def test_fp64_backward_is_the_exact_transpose(shape, layered):
    """In true fp64 (work=float64: no fp32 rounding anywhere) the
    hand-written backward (K7's and K9's plain versions) == autograd through
    the plain forward, to rtol 1e-10 / atol 1e-12."""
    B, H, W, dim = shape
    _, _, _, tp, tx, _, meta = _setup(dim, B, H, W, seed=8,
                                      tdt=torch.float64)
    flat = [t.to(torch.float64).requires_grad_(True)
            for t in fs.pack_params(tp, meta, torch.float64)]
    x = fs.to_cn(tx, meta).requires_grad_(True)
    g = torch.tensor(np.random.default_rng(3).normal(size=(dim, B * H * W)))
    f64 = torch.float64
    out = fs.fused_sqnxt_plain(x, flat, meta, work=f64)
    ref = torch.autograd.grad(out, [x] + flat, g)
    if layered:
        hs, h = [], x.detach()
        for li in range(5):
            hs.append(h)
            h = fs.fused_sqnxt_layer_plain(h, fs._layer(flat, li), meta, li,
                                           work=f64).detach()
        got_flat, gg = [None] * 20, g
        for li in range(4, -1, -1):
            gg, d = fs.fused_sqnxt_layer_bwd_plain(
                hs[li], gg, [t.detach() for t in fs._layer(flat, li)], meta,
                li, work=f64)
            got_flat[4 * li: 4 * li + 4] = d
        got = [gg] + got_flat
    else:
        dx, dflat = fs.fused_sqnxt_bwd_plain(
            x.detach(), g, [t.detach() for t in flat], meta, work=f64)
        got = [dx, *dflat]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_pack_params_matches_jax():
    """pack_params lays the weights out as the JAX kernels' taps."""
    _, params, _, tp, _, jmeta, meta = _setup(16, 2, 5, 5)
    got = fs.pack_params(tp, meta, torch.float32)
    for a, b in zip(got, _flat_jax(params, jmeta, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_workspace_monotone():
    """The chain's workspace shrinks with the stage (twin of the VMEM
    estimate's monotonicity)."""
    m1 = fs.make_meta(32, 128, 32, 32)
    m2 = fs.make_meta(128, 128, 8, 8)
    assert fs.chain_workspace_bytes(m1) > fs.chain_workspace_bytes(m2)


def test_stage_gate():
    """Full width, B 128: layered at stage 1 (anchors 46 MB), chain at
    stages 2 (23 MB) and 3 (11.5 MB); every branch of the variance."""
    s1, s2, s3 = (fs.gate_meta(d, 128, hw, hw) for d, hw in
                  ((32, 32), (64, 16), (128, 8)))
    assert s1.layered and not s2.layered and not s3.layered
    assert fs.chain_workspace_bytes(s1) == 4 * 131072 * 88
    assert s1.single_pass == (True,) * 5
    assert s2.single_pass == (True, False, True, True, True)
    assert s3.single_pass == (False, False, False, False, True)
    for m in (s1, s2, s3):
        jm = jfs.make_meta(m.cdims[0], 128, m.H, m.W, jnp.float32)
        assert m.single_pass == jm.single_pass and m.cdims == jm.cdims
        assert m.taps == jm.taps and m.n_real == jm.n_real


def test_cost_counts_the_chain():
    """sqnxt_cost: 4.5 D^2 N FLOP per chain evaluation (3x backward)."""
    m = fs.make_meta(64, 128, 16, 16)
    flops, _ = fs.sqnxt_cost(m, range(5), backward=False)
    assert flops == int(4.5 * 64 * 64 * m.n_real)
    assert fs.sqnxt_cost(m, range(5), backward=True)[0] == 3 * flops
