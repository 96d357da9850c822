"""The bf16 path of the port's SqueezeNext ODE-net against the JAX package:
twins of tests/test_fused_sqnxt.py::test_bf16_path and
tests/test_models.py::test_sqnxt_bf16_mixed_precision, the bf16 model's
pieces and whole model against JAX's SqueezeNextODE(dtype="bf16"), the
bf16 gate, and chip_smoke.py's block gate against planted faults.

The plain versions of K6-K9 (ops/fused_sqnxt.py) in bf16 against the JAX
package's Pallas kernels in interpret mode on the same bf16 inputs (numpy
from a seed, flax weights carried across by convert.py): both round to
bf16 at the same points (the conv output before the bias add, the norm's
output before the ReLU, g_z, g_h, each dW) and accumulate the products in
fp32, so they agree to fp32 summation order: outputs and dx within one bf16
epsilon (2^-8) of max |ref|, the parameter gradients (fp32, each rounded
through bf16) within 2^-8 too. Measured: outputs and dx bitwise equal,
parameter gradients within 3e-7.

The bf16 model against JAX's on flax weights carried across by
sqnxt_state_dict_from_flax (width 0.25, B 4): each piece on JAX's bf16
input to it, its output, dx and parameter gradients against a random
cotangent within 2 bf16 epsilons of max |ref|, parameter gradients within
4 (measured: 1.1, 1.0 and 2.9 at most, most pieces bitwise; the same
pieces left in fp32 miss dx by 19.9 epsilons and more, their parameter
gradients by 12.6 and more). The whole model chains 17 blocks of
batch-stats norms, which amplify bf16 rounding in JAX's model itself
(tests/torch_bf16_witness.py), so its logits, loss and head gradient are
held at limits set from the readings there (see
test_bf16_model_matches_jax)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.models.sqnxt import ODEDynamics as JODEDynamics
from pnode_tpu.ops import fused_sqnxt as jfs
from pnode_tpu_torch.convert import sqnxt_piece_from_flax
from pnode_tpu_torch.models import SqueezeNextODE
from pnode_tpu_torch.ops import fused_sqnxt as fs

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_bf16_witness as witness  # noqa: E402

EPS_BF16 = 2.0 ** -8
B_MODEL = 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shape, seed", [((16, 4, 8, 8), 0),
                                         ((32, 2, 8, 8), 1),
                                         ((16, 3, 5, 7), 2)],
                         ids=["dim16", "dim32", "ragged"])
@pytest.mark.parametrize("layered", [False, True], ids=["chain", "layered"])
def test_plain_bf16_matches_jax_kernels(shape, seed, layered):
    """Forward and backward of the chain (K6/K7's plain versions) and of
    the layered mode (K8/K9's) in bf16 against JAX's _fwd_kernel /
    _bwd_kernel / _fwd_layer_kernel / _bwd_layer_kernel in interpret mode:
    dtypes, output, dx and every parameter gradient within one bf16
    epsilon of max |ref|."""
    dim, B, H, W = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    g = rng.normal(size=(B, H, W, dim)).astype(np.float32)
    mod = JODEDynamics(dim, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(seed), 0.0, jnp.asarray(x))
    jmeta = jfs.make_meta(dim, B, H, W, jnp.bfloat16, interpret=True,
                          layered=layered)
    meta = fs.make_meta(dim, B, H, W, layered=layered)

    def jfn(xx, p):
        return jfs.from_cn(jfs.fused_sqnxt_dyn(jfs.to_cn(xx, jmeta), p,
                                               jmeta), B, H, W)

    out, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16), params)
    gx, gp = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == jnp.bfloat16

    sd = sqnxt_piece_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tp = {k: v.float().requires_grad_(True) for k, v in sd.items()}
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    tout = fs.from_cn(fs.fused_sqnxt_dyn(fs.to_cn(tx, meta), tp, meta),
                      B, H, W)
    tout.backward(torch.tensor(g).bfloat16())
    assert tout.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert _rel(tout.detach().float(), np.asarray(out, np.float32)) \
        <= EPS_BF16
    assert _rel(tx.grad.float(), np.asarray(gx, np.float32)) <= EPS_BF16
    ref = sqnxt_piece_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), gp))
    for k, v in ref.items():
        assert tp[k].grad.dtype == torch.float32, k
        if k.startswith("convs.") and k.endswith(".bias"):
            # a bias feeding a batch-stats norm: true gradient 0, both
            # return the same rounding noise; gated against the scale of
            # the layer's d_beta
            scale = float(ref[k.replace("convs", "norms")].abs().max())
            assert float((tp[k].grad - v).abs().max()) <= EPS_BF16 * scale, k
        else:
            assert _rel(tp[k].grad, v) <= EPS_BF16, k


def test_plain_bf16_rounds_where_jax_does():
    """The plain bf16 layer's output is the fp32 plain layer's math
    rounded at the JAX kernels' points: the conv's fp32 sum rounded to bf16
    before the bias (z_d), the norm's fp32 output rounded to bf16 before
    the ReLU; an fp32 product never rounds per tap."""
    meta = fs.make_meta(16, 2, 4, 4)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(8, meta.n_real, generator=gen).relu().bfloat16()
    w = (torch.randn(3, 8, 8, generator=gen) * 0.3).bfloat16()
    b = torch.randn(8, generator=gen).bfloat16()
    gam, bet = torch.rand(8, generator=gen) + 0.5, torch.randn(8,
                                                              generator=gen)
    lf = (w, b, gam, bet)
    got = fs.fused_sqnxt_layer_plain(h, lf, meta, 2)
    masks = fs._tap_masks(meta, "cpu")
    z32 = fs._conv(h.float(), w.float(), meta, 2, masks, torch.float32)
    zd = z32.bfloat16() + b[:, None]
    zf = zd.float()
    inv_n = 1.0 / meta.n_real
    m = zf.sum(1, keepdim=True) * inv_n
    var = ((zf - m) * (zf - m)).sum(1, keepdim=True) * inv_n
    a = (zf - m) / torch.sqrt(var + fs.EPS) * gam[:, None] + bet[:, None]
    want = torch.relu(a.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_gate_meta_bf16_runs_the_chain_at_stage_1():
    """The bf16 anchors take 2 bytes (the JAX package's esize): at B 128 of
    the full-width model stage 1's five anchors are 23 MB, inside
    CHAIN_WORKSPACE_BYTES, so the bf16 model runs the chain (K6/K7) where
    fp32 (46 MB) runs layered (K8/K9); stages 2-3 chain in both; B 256's
    stage 1 runs layered in bf16 too."""
    bf = torch.bfloat16
    s1 = fs.make_meta(32, 128, 32, 32)
    assert fs.chain_workspace_bytes(s1, 2) * 2 == fs.chain_workspace_bytes(s1)
    assert fs.chain_workspace_bytes(s1, 2) == 88 * 131072 * 2
    assert fs.gate_meta(32, 128, 32, 32).layered
    assert not fs.gate_meta(32, 128, 32, 32, bf).layered
    assert fs.gate_meta(32, 256, 32, 32, bf).layered
    for dim, hw in ((64, 16), (128, 8)):
        for dt in (torch.float32, bf):
            assert not fs.gate_meta(dim, 128, hw, hw, dt).layered
    assert fs.esize_of(bf) == 2 and fs.esize_of(torch.float64) == 4


@pytest.fixture(scope="module")
def bf16_models():
    """SqNxt-23 at width 0.25, euler, Nt 1, from one generator: fp32 and
    bf16 on the module path, bf16 on the kernels' plain versions."""
    def build(dtype, uk):
        return SqueezeNextODE(num_classes=10, width_x=0.25, method="euler",
                              Nt=1, dtype=dtype, use_kernels=uk,
                              generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 32, 32, 3)),
                     dtype=torch.float32)
    return build(None, "off"), build("bf16", "off"), build("bf16", "on"), x


@pytest.mark.parametrize("which", ["module", "kernels"])
def test_bf16_model_mixed_precision(bf16_models, which):
    """Twin of tests/test_models.py::test_sqnxt_bf16_mixed_precision on the
    module path and on the kernel path (the plain versions here):
    parameters and gradients fp32, fp32 logits of shape (2, 10), finite
    gradients, logits within 0.25 max |logits| of the fp32 model's on the
    same weights, and the same argmax."""
    m32, m_off, m_on, x = bf16_models
    model = m_off if which == "module" else m_on
    assert model.pieces[1].convs[0].weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        logits = model(x, training=False)
        logits32 = m32(x, training=False)
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), logits32.numpy(),
                               atol=0.25 * float(logits32.abs().max()))
    assert torch.equal(logits.argmax(-1), logits32.argmax(-1))
    model.zero_grad(set_to_none=True)
    (model(x, training=True) ** 2).sum().backward()
    grads = [p.grad for p in model.parameters()]
    assert all(gr.dtype == torch.float32 for gr in grads)
    norms = [float(gr.norm()) for gr in grads]
    assert all(np.isfinite(norms)) and any(n > 0 for n in norms)


def test_bf16_state_rides_the_solver(bf16_models):
    """The ODE blocks' states are bf16 on both paths: the solvers the
    model built are keyed on bf16 templates, and the kernel path's metas
    come from the bf16 gate."""
    _, m_off, m_on, x = bf16_models
    with torch.no_grad():
        m_off(x, training=False)
        m_on(x, training=False)
    for m in (m_off, m_on):
        dts = {k[-2] if k[0] == "module" else k[2] for k in m._solvers}
        assert dts == {torch.bfloat16}, dts
    metas = [k[1] for k in m_on._solvers if k[0] == "fused"]
    assert metas and all(not mt.layered for mt in metas)


def test_model_dtype_names():
    """bf16 by any of its names; fp32 by None, "f32", "float32" or
    torch.float32; anything else raises ValueError."""
    for name in ("bf16", "bfloat16", torch.bfloat16):
        assert SqueezeNextODE(width_x=0.25, dtype=name).dtype == torch.bfloat16
    for name in (None, "f32", "float32", torch.float32):
        assert SqueezeNextODE(width_x=0.25, dtype=name).dtype is None
    for bad in ("f16", torch.float16, ["bf16"]):
        with pytest.raises(ValueError):
            SqueezeNextODE(width_x=0.25, dtype=bad)


def _nchw(a):
    return a.permute(0, 3, 1, 2) if a.dim() == 4 else a


def _nhwc(a):
    return a.permute(0, 2, 3, 1) if a.dim() == 4 else a


@pytest.fixture(scope="module")
def jax_bf16():
    """JAX's SqNxt-23 at width 0.25 (euler, Nt 1), seed-0 flax weights, on
    B_MODEL numpy images: each bf16 piece's input, output, a random
    cotangent and its vjp; the whole bf16 and fp32 models' loss, logits and
    gradients."""
    x, y = witness.inputs(B_MODEL)
    jm, jm32 = witness.jax_model(0.25, "bf16"), witness.jax_model(0.25)
    jp = jm32.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(1)
    h, pieces = jnp.asarray(x), []
    for (kind, jmod), p in zip(jm.pieces, jp):
        if kind == "ode":
            def fn(pp, hh, jmod=jmod):
                return jmod.apply(pp, 0.0, hh)
        else:
            fn = jmod.apply
        out, vjp = jax.vjp(fn, p, h)
        g = jnp.asarray(rng.normal(size=out.shape), out.dtype)
        gp, gh = vjp(g)
        f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
        pieces.append(dict(
            kind=kind, h=f32(h), h_dtype=h.dtype, out=f32(out),
            out_dtype=out.dtype, g=f32(g), gh=f32(gh), gh_dtype=gh.dtype,
            gp={k: v.double() for k, v in sqnxt_piece_from_flax(
                jax.tree_util.tree_map(f32, gp)).items()}))
        h = out
    return dict(jp=jp, x=x, y=y, pieces=pieces,
                bf16=witness.jax_run(jm, jp, x, y),
                fp32=witness.jax_run(jm32, jp, x, y))


def _bf16_piece_errors(jax_bf16, i, dtype="bf16"):
    """(output, dx, {parameter: error}) of the port's piece i on JAX's
    input, in bf16 epsilons of max |ref|; for a conv bias (true gradient
    0) the port's max |gradient| in epsilons of its norm's max |d_beta|.
    Asserts the dtypes JAX's piece has (the fp32 control skips that)."""
    ref = jax_bf16["pieces"][i]
    tm = witness.port_model(jax_bf16["jp"], 0.25, dtype)
    mod = tm.pieces[i]
    h = _nchw(torch.tensor(ref["h"]))
    if dtype == "bf16" and ref["h_dtype"] == jnp.bfloat16:
        h = h.bfloat16()
    h.requires_grad_(True)
    out = mod(0.0, h) if ref["kind"] == "ode" else mod(h)
    params = dict(mod.named_parameters())
    grads = torch.autograd.grad(out, [h] + list(params.values()),
                                _nchw(torch.tensor(ref["g"])).to(out.dtype))
    if dtype == "bf16":
        assert out.dtype == torch.bfloat16 if ref["out_dtype"] == \
            jnp.bfloat16 else torch.float32
        assert grads[0].dtype == (torch.bfloat16 if ref["gh_dtype"]
                                  == jnp.bfloat16 else torch.float32)
        assert all(gr.dtype == torch.float32 for gr in grads[1:])

    def eps(a, b):
        b = np.asarray(b, np.float64)
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / np.abs(b).max()) / EPS_BF16

    e_out = eps(_nhwc(out.detach().double()).numpy(), ref["out"])
    e_dx = eps(_nhwc(grads[0].double()).numpy(), ref["gh"])
    e_p = {}
    for k, gr in zip(params, grads[1:]):
        want = ref["gp"][k]
        if k.startswith("convs.") and k.endswith(".bias"):
            # true gradient 0: the port's own noise against max |d_beta|
            scale = float(ref["gp"][k.replace("convs", "norms")].abs().max())
            e_p[k] = float(gr.abs().max()) / scale / EPS_BF16
        else:
            e_p[k] = eps(gr.double().numpy(), want.numpy())
    return e_out, e_dx, e_p


@pytest.mark.parametrize("kind", ["stem", "entry", "ode", "head"])
def test_bf16_pieces_match_flax(jax_bf16, kind):
    """Every piece of the kind (Stem, the four BasicBlocks, the 17
    ODEDynamics on the module path, Head) of the bf16 model on JAX's bf16
    input to it: JAX's output dtype (bf16; the head's logits fp32), dx's
    dtype (bf16; the stem's fp32, its image is fp32), fp32 parameter
    gradients; output and dx within 2 bf16 epsilons of max |ref|
    (measured 1.1 at most), every parameter gradient within 4 (a sum over
    the batch and the pixels rounded to bf16 once, in other orders:
    measured 2.9, the head's dense weight). Conv biases feed a batch-stats
    norm, so their true gradient is 0: JAX's bf16 bias add returns up to
    2.6 x max |d_beta| of noise and is not compared; the port's stays
    within 16 epsilons of max |d_beta| (measured 6.6)."""
    idx = [i for i, p in enumerate(jax_bf16["pieces"]) if p["kind"] == kind]
    assert idx
    for i in idx:
        e_out, e_dx, e_p = _bf16_piece_errors(jax_bf16, i)
        assert e_out <= 2 and e_dx <= 2, (i, e_out, e_dx)
        for k, e in e_p.items():
            bias = k.startswith("convs.") and k.endswith(".bias")
            assert e <= (16 if bias else 4), (i, k, e)


def test_bf16_pieces_fp32_control_misses(jax_bf16):
    """The control that makes the piece tolerance mean something: the same
    pieces left in fp32 (what a model that silently stayed in fp32 would
    run) miss JAX's bf16 dx by far more than 2 epsilons at every piece."""
    for i in range(len(jax_bf16["pieces"])):
        _, e_dx, _ = _bf16_piece_errors(jax_bf16, i, None)
        assert e_dx > 8, (i, e_dx)


def test_bf16_model_matches_jax(jax_bf16):
    """The whole bf16 model (module path) against JAX's on the same weights
    and images: every piece's output bf16 and the logits fp32 (hooks),
    then the logits, the loss and the head's gradient at limits set from
    the readings (tests/torch_bf16_witness.py, B 4): the 17 chained
    batch-stats blocks amplify bf16 rounding, so JAX's own bf16 model sits
    0.24 max |logit| from its fp32 model, its loss 4% away and its head
    gradient at cosine 0.78; the port's bf16 model sits from JAX's at 0.21,
    7% and 0.84. Limits: logits 0.3 max |logit|, loss 10%, head cosine
    0.7."""
    tm = witness.port_model(jax_bf16["jp"], 0.25, "bf16")
    # every call's output dtype; a stage's ODE blocks run on the solver of
    # its first block (functional calls with each block's parameters), so
    # only that block's hook fires
    seen = [set() for _ in tm.pieces]
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, s=s: s.add(out.dtype))
        for m, s in zip(tm.pieces, seen)]
    loss, logits, grads = witness.port_run(tm, jax_bf16["x"], jax_bf16["y"])
    for hk in hooks:
        hk.remove()
    assert seen[-1] == {torch.float32}
    assert all(s == {torch.bfloat16} for s, kind in zip(seen, tm.kinds)
               if kind in ("stem", "entry"))
    assert all(s <= {torch.bfloat16} for s in seen[:-1])
    assert sum(bool(s) for s in seen) == 1 + 4 + 3 + 1
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    lj, logits_j, gj = jax_bf16["bf16"]
    diff = float(np.abs(logits - logits_j).max())
    assert diff <= 0.3 * float(np.abs(logits_j).max()), diff
    assert abs(loss - lj) <= 0.1 * lj, (loss, lj)
    head = [k for k in gj if k.startswith(f"pieces.{len(seen) - 1}.dense")]
    assert len(head) == 2
    assert witness.cosine(grads, gj, head) >= 0.7


def test_bf16_model_noise_is_jaxs_too(jax_bf16):
    """The second witness for phase 12(b)'s choice of gates: JAX's own bf16
    model, against its fp32 model on the same weights, keeps the head's
    gradient (cosine > 0.7) but not the deep pieces' (the whole gradient's
    cosine below 0.5), as the port's does; the port's fp32 model against
    JAX's fp32 keeps both (cosine > 0.95)."""
    r = witness.compare(jax_bf16["bf16"], jax_bf16["fp32"])
    assert r["piece_cos"][-1] > 0.7 and r["cos"] < 0.5, r
    tm32 = witness.port_model(jax_bf16["jp"], 0.25)
    r32 = witness.compare(witness.port_run(tm32, jax_bf16["x"],
                                           jax_bf16["y"]), jax_bf16["fp32"])
    assert r32["cos"] > 0.95 and r32["piece_cos"][-1] > 0.95, r32


def _reverse_taps(d):
    d[8] = d[8].flip(0)  # layer 2's dW, its three taps in reverse


def _halve_dgamma(d):
    d[14] = d[14] * 0.5  # layer 3's dgamma


def _swap_dgamma_dbeta(d):
    d[2], d[3] = d[3], d[2]  # layer 0's


@pytest.mark.parametrize("fault", [None, _reverse_taps, _halve_dgamma,
                                   _swap_dgamma_dbeta],
                         ids=["clean", "taps_reversed", "dgamma_halved",
                              "dgamma_dbeta_swapped"])
def test_block_gate_fails_planted_faults(monkeypatch, fault):
    """chip_smoke.py's phase 12(b) block gate (BF16_BLOCK_TOL) on the CPU,
    on the kernels' plain bf16 versions: one stage-1 ODE block's gradient
    (width 0.5, B 8, rk4, Nt 2) on the kernel path against the module path
    passes it as built (least cosine 0.9988, norm ratio 0.988) and fails it
    with a fault planted in the chain's backward: a 1x3 conv's dW taps
    reversed (least cosine 0.56), one layer's dgamma halved (norm ratio
    0.50), one layer's dgamma and dbeta swapped (least cosine -0.64)."""
    import chip_smoke as cs

    def build(uk, dtype):
        return SqueezeNextODE(width_x=0.5, method="rk4", Nt=2, dtype=dtype,
                              use_kernels=uk,
                              generator=torch.Generator().manual_seed(0))

    if fault is not None:
        real = fs.fused_sqnxt_bwd

        def faulty(x, g, flat, meta):
            dx, d = real(x, g, flat, meta)
            d = list(d)
            fault(d)
            return dx, d

        monkeypatch.setattr(fs, "fused_sqnxt_bwd", faulty)
    m_on, m_off = build("on", "bf16"), build("off", "bf16")
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 32, 32, 3)),
                     dtype=torch.float32)
    h, mod = cs.stage_inputs(m_off, x)[0]
    idx = next(i for i, p in enumerate(m_off.pieces) if p is mod)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(50))
    g = g.bfloat16()
    cos, ratio, ok = cs.block_gate(cs.ode_block_grads(m_on, idx, h, g),
                                   cs.ode_block_grads(m_off, idx, h, g))
    print(f"block gate, {fault.__name__ if fault else 'clean'}: least "
          f"cosine {cos:.4f}, norm ratio {ratio:.4f}")
    assert ok == (fault is None), (cos, ratio)
