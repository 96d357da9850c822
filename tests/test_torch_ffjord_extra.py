"""The port's coupling and planar flows, spectral norm, the autoencoder
divergence, ODENVP and the multiscale-parallel CNF against the JAX
package's, on the CPU in fp64.

Twins of every test of ``tests/test_ffjord_extra.py`` (its two slow tests
included, unmarked, at the JAX tests' sizes), each also held against the
JAX package on the same flax weights and inputs, plus ODENVP's and the
multiscale-parallel CNF's log_prob and gradients (through the discrete
adjoint, on JAX's Hutchinson probes) against ``jax.grad`` (rtol 1e-8).
Tolerances are max |diff| / max |ref| unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch as pt
from pnode_tpu.ffjord import odenvp as JO
from pnode_tpu.ffjord import other_flows as JF
from pnode_tpu.ffjord.cnf import CNF as JCNF
from pnode_tpu.ffjord.odefunc import (
    AutoencoderDiffEqNet as JAutoencoderDiffEqNet,
    autoencoder_divergence_fn as j_autoencoder_divergence_fn,
)
from pnode_tpu_torch import ffjord as P
from pnode_tpu_torch.ffjord import other_flows as PF
from torch_ffjord_twins import (
    assert_grads_match, carry, chained_probes, f64, probe, rel)

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture(autouse=True)
def _fresh_port_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.normal(size=a.shape), f64(params))


def _zeros(n):
    return torch.zeros(n, 1, dtype=F64)


def _logdet_row(layer, x0):
    """log|det J| of the layer's map at one row, by jacfwd."""
    J = torch.func.jacfwd(
        lambda xx: layer.apply(xx[None], _zeros(1), {})[0][0])(x0)
    return float(torch.linalg.slogdet(J)[1])


def _invertible_with_logdet(jlayer, layer, params, x):
    """Round trip, a nontrivial log-det equal to -log|det J|, and forward
    and reverse equal to JAX's (1e-12)."""
    layer = carry(layer, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, d1, _ = layer.apply(xt, _zeros(len(x)), {})
        x_back, d2, _ = layer.apply(y, d1, {}, reverse=True)
    np.testing.assert_allclose(x_back.numpy(), x, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(d2.numpy(), 0.0, atol=1e-10)
    assert float(d1.abs().max()) > 1e-3
    np.testing.assert_allclose(float(d1[0, 0]), -_logdet_row(layer, xt[0]),
                               rtol=1e-8)
    jy, jd1, _ = jlayer.apply(params, jnp.asarray(x), jnp.zeros((len(x), 1)),
                              {})
    jxb, jd2, _ = jlayer.apply(params, jy, jd1, {}, reverse=True)
    assert rel(y, jy) <= 1e-12 and rel(d1, jd1) <= 1e-12
    assert rel(x_back, jxb) <= 1e-12
    return layer, y


@pytest.mark.parametrize("mask_type,swap", [
    ("alternate", False), ("alternate", True),
    ("channel", False), ("channel", True),
])
def test_masked_coupling_invertible_with_logdet(mask_type, swap):
    jl = JF.MaskedCouplingLayer(6, hidden=(16,), mask_type=mask_type,
                                swap=swap)
    x = np.random.default_rng(0).normal(size=(8, 6))
    params = _perturbed(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    layer = PF.MaskedCouplingLayer(6, hidden=(16,), mask_type=mask_type,
                                   swap=swap, **CPU)
    layer, y = _invertible_with_logdet(jl, layer, params, x)
    mask = PF.sample_mask(6, mask_type, swap).numpy()
    np.testing.assert_array_equal(mask, np.asarray(JF.sample_mask(
        6, mask_type, swap)))
    np.testing.assert_allclose(y.numpy()[:, mask == 1.0], x[:, mask == 1.0])


def test_sample_mask_unknown_type_raises():
    with pytest.raises(ValueError):
        PF.sample_mask(4, "diagonal")


def test_autoencoder_divergence_matches_composed_jacobian():
    """e^T (J_enc J_dec) e equals the quadratic form of explicit jacfwd
    Jacobians (1e-10) and JAX's estimate (1e-12); over 512 Rademacher
    probes it approaches tr(J_enc J_dec) (within 0.35, the JAX test's
    bound); dy is decode(encode(y))."""
    jnet = JAutoencoderDiffEqNet(hidden_dims=(8, 3, 8), input_dim=5,
                                 layer_type="concat", nonlinearity="tanh")
    rng = np.random.default_rng(7)
    y = rng.normal(size=(4, 5))
    params = f64(jnet.init(jax.random.PRNGKey(1), 0.1, jnp.asarray(y)))
    net = carry(P.AutoencoderDiffEqNet((8, 3, 8), 5, "concat",
                                       "tanh").to(F64), params)
    assert net.bottleneck_dim == 3 == jnet.bottleneck_dim
    enc = lambda z: net.encode(0.1, z)  # noqa: E731
    dec = lambda h: net.decode(0.1, h)  # noqa: E731
    e = rng.normal(size=(4, 3))
    yt, et = torch.from_numpy(y), torch.from_numpy(e)
    with torch.no_grad():
        dy, div = P.autoencoder_divergence_fn(enc, dec, yt, et)
    J_enc = torch.func.jacfwd(lambda z: enc(z[None])[0])(yt[0])
    J_dec = torch.func.jacfwd(lambda h: dec(h[None])[0])(enc(yt[:1])[0])
    quad = float(et[0] @ (J_enc @ J_dec) @ et[0])
    np.testing.assert_allclose(float(div[0]), quad, rtol=1e-10)
    tr = float(torch.trace(J_enc @ J_dec))
    es = P.sample_probe((512, 3), F64,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, divs = P.autoencoder_divergence_fn(enc, dec, yt[:1].expand(512, 5),
                                              es)
    assert abs(float(divs.mean()) - tr) < 0.35
    with torch.no_grad():
        np.testing.assert_allclose(dy.numpy(), dec(enc(yt)).numpy(),
                                   rtol=1e-12)
    jenc = lambda z: jnet.apply(params, 0.1, z, method="encode")  # noqa
    jdec = lambda h: jnet.apply(params, 0.1, h, method="decode")  # noqa
    jdy, jdiv = j_autoencoder_divergence_fn(jenc, jdec, jnp.asarray(y),
                                            jnp.asarray(e))
    assert rel(div, jdiv) <= 1e-12 and rel(dy, jdy) <= 1e-12


def test_cnf_autoencode_runs_and_is_finite():
    """The autoencoder CNF: finite outputs of the right shapes, and with
    JAX's bottleneck probe its z and delta_logp equal JAX's (1e-10) and its
    gradient through the adjoint jax.grad's (1e-8)."""
    jnet = JAutoencoderDiffEqNet(hidden_dims=(8, 4, 8), input_dim=6,
                                 layer_type="concat", nonlinearity="softplus")
    kw = dict(input_dim=6, T=0.25, solver="rk4", step_size=0.25 / 4,
              autoencode=True)
    jc = JCNF(jnet, **kw)
    x = np.random.default_rng(5).normal(size=(8, 6))
    params = f64(jc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pc = carry(P.CNF(P.AutoencoderDiffEqNet((8, 4, 8), 6, "concat",
                                            "softplus"), **kw, **CPU), params)
    key = jax.random.PRNGKey(2)
    e = probe(key, (8, 4))
    with torch.no_grad():
        (z, dlp, _), _ = pc.apply(torch.from_numpy(x), probe=e,
                                  training=False)
    assert z.shape == (8, 6) and dlp.shape == (8, 1)
    assert bool(torch.isfinite(z).all() and torch.isfinite(dlp).all())
    (jz, jdlp, _), _ = jc.apply(params, jnp.asarray(x), key=key,
                                training=False)
    assert rel(z, jz) <= 1e-10 and rel(dlp, jdlp) <= 1e-10

    def jloss(p):
        (zz, dd, _), _ = jc.apply(p, jnp.asarray(x), key=key, training=True)
        return jnp.sum(zz ** 2) + jnp.sum(dd)

    (zz, dd, _), _ = pc.apply(torch.from_numpy(x), probe=e, training=True)
    (torch.sum(zz ** 2) + torch.sum(dd)).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in pc.parameters()])
    assert bool(torch.isfinite(flat).all()) and float(flat.abs().max()) > 0
    assert_grads_match(pc, jax.grad(jloss)(params), 1e-8)


def test_coupling_layer_invertible_with_logdet():
    jl = JF.CouplingLayer(6, hidden=(16,))
    x = np.random.default_rng(0).normal(size=(8, 6))
    params = _perturbed(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _invertible_with_logdet(jl, PF.CouplingLayer(6, hidden=(16,), **CPU),
                            params, x)


def test_planar_flow_logdet_matches_autodiff():
    jf = JF.PlanarFlow(3)
    x = np.random.default_rng(2).normal(size=(4, 3))
    params = f64(jf.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    flow = carry(PF.PlanarFlow(3, **CPU), params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, d1, _ = flow.apply(xt, _zeros(4), {})
    np.testing.assert_allclose(float(d1[1, 0]), -_logdet_row(flow, xt[1]),
                               rtol=1e-6)
    jy, jd1, _ = jf.apply(params, jnp.asarray(x), jnp.zeros((4, 1)), {})
    assert rel(y, jy) <= 1e-12 and rel(d1, jd1) <= 1e-12
    with pytest.raises(ValueError, match="no closed-form inverse"):
        flow.apply(xt, _zeros(4), {}, reverse=True)


def test_spectral_normalize_unit_norm():
    """50 power iterations bring the top singular value to 1 (rtol 1e-3);
    each iteration's (W / sigma, u) equals JAX's (1e-12)."""
    rng = np.random.default_rng(3)
    W = rng.normal(size=(10, 7)) * 3.0
    u0 = rng.normal(size=(7,))
    Wt, u = torch.from_numpy(W), torch.from_numpy(u0)
    ju = jnp.asarray(u0)
    Wn = Wt
    for _ in range(50):
        Wn, u = PF.spectral_normalize(Wt, u)
        jWn, ju = JF.spectral_normalize(jnp.asarray(W), ju)
    sigma = np.linalg.svd(Wn.numpy(), compute_uv=False)[0]
    np.testing.assert_allclose(sigma, 1.0, rtol=1e-3)
    assert rel(Wn, jWn) <= 1e-12 and rel(u, ju) <= 1e-12


def test_spectral_dense_applies():
    """SpectralDense's output and its updated power-iteration vector equal
    flax's (the spectral collection) on flax's weights."""
    jl = JF.SpectralDense(5)
    x = np.random.default_rng(4).normal(size=(3, 4))
    variables = f64(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jy, mutated = jl.apply(variables, jnp.asarray(x), mutable=["spectral"])
    assert "spectral" in mutated
    layer = carry(PF.SpectralDense(4, 5).to(F64), variables)
    with torch.no_grad():
        y = layer(torch.from_numpy(x))
    assert y.shape == (3, 5)
    assert rel(y, jy) <= 1e-12
    assert rel(layer.u, mutated["spectral"]["u"]) <= 1e-12


def _odenvp_pair(shape, seed=0, **kw):
    jm = JO.ODENVP(shape, **kw)
    x = np.random.default_rng(seed + 4).random((2,) + shape) * 0.9 + 0.05
    params = f64(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    pm = carry(P.ODENVP(shape, **kw, **CPU), params)
    return jm, params, pm, x


def test_odenvp_log_prob_and_grads():
    """ODENVP((8, 8, 1), 2 scales, 1 block, hidden 8) on two images: log p
    of shape (2, 1), the factored latents (2, 4, 4, 2) twice, finite
    gradients through the adjoint, not all zero (the JAX test, unmarked
    here)."""
    model = P.ODENVP((8, 8, 1), n_scales=2, n_blocks=1, hidden_dims=(8,),
                     step_size=0.25, **CPU)
    x = torch.from_numpy(np.random.default_rng(4).random((2, 8, 8, 1))
                         * 0.9 + 0.05)
    logp, zs = model.log_prob(x, generator=torch.Generator().manual_seed(1))
    assert logp.shape == (2, 1)
    assert zs[0].shape == (2, 4, 4, 2) and zs[1].shape == (2, 4, 4, 2)
    (-logp.mean()).backward()
    norms = [float(p.grad.norm()) for p in model.parameters()]
    assert all(np.isfinite(n) for n in norms) and any(n > 0 for n in norms)


def test_odenvp_log_prob_and_gradients_match_jax():
    """ODENVP((4, 4, 1)) on JAX's probes (the keys its log_prob splits):
    log p and the latents equal JAX's (1e-10), the NLL's gradient through
    the discrete adjoint jax.grad's (1e-8); with no probe (the brute-force
    divergence) too."""
    jm, params, pm, x = _odenvp_pair((4, 4, 1), n_scales=2, n_blocks=1,
                                     hidden_dims=(4,), step_size=0.25)
    key = jax.random.PRNGKey(1)
    probes = chained_probes(key, [(2, 16), (2, 8)])

    def jnll(p):
        lp, _ = jm.log_prob(p, jnp.asarray(x), key=key)
        return -jnp.mean(lp)

    jl, jg = jax.value_and_grad(jnll)(params)
    logp, zs = pm.log_prob(torch.from_numpy(x), probes=probes)
    (-logp.mean()).backward()
    nll = float(-logp.mean().detach())
    assert abs(nll - float(jl)) <= 1e-10 * abs(float(jl))
    assert_grads_match(pm, jg, 1e-8)
    jlp, jzs = jm.log_prob(params, jnp.asarray(x), key=None, training=False)
    with torch.no_grad():
        lp, zs = pm.log_prob(torch.from_numpy(x), training=False)
    assert rel(lp, jlp) <= 1e-10
    assert all(rel(a, b) <= 1e-10 for a, b in zip(zs, jzs))


def test_multiscale_parallel_cnf():
    """MultiscaleParallelCNF((8, 8, 1)): 2 scales, log p (2, 1) and z of
    x's shape, finite gradients (the JAX test, unmarked); log p and the
    gradient through the adjoint on JAX's probe equal JAX's (1e-10, 1e-8)."""
    kw = dict(n_blocks=1, intermediate_dims=(8,), step_size=0.5)
    jm = JO.MultiscaleParallelCNF((8, 8, 1), **kw)
    m = P.MultiscaleParallelCNF((8, 8, 1), **kw, **CPU)
    assert m.n_scale == 2 == jm.n_scale
    x = np.random.default_rng(0).random((2, 8, 8, 1))
    params = f64(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    m = carry(m, params)
    key = jax.random.PRNGKey(1)
    probes = chained_probes(key, [(2, 64)])
    logp, z = m.log_prob(torch.from_numpy(x), probes=probes)
    assert logp.shape == (2, 1) and z.shape == x.shape
    (-logp.mean()).backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in m.parameters())

    def jnll(p):
        lp, _ = jm.log_prob(p, jnp.asarray(x), key=key)
        return -jnp.mean(lp)

    jl, jg = jax.value_and_grad(jnll)(params)
    nll = float(-logp.mean().detach())
    assert abs(nll - float(jl)) <= 1e-10 * abs(float(jl))
    assert_grads_match(m, jg, 1e-8)
