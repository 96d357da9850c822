"""The port's FFJORD CNF stack against the JAX package's, on the CPU in fp64.

Twins of every test of ``tests/test_ffjord.py`` (the slow training test
included, at a size that runs in seconds), each also held against the JAX
package on the same flax weights (``torch_ffjord_twins.carry``), inputs
and Hutchinson probes (JAX's own, replayed). Beyond them: the data copies
bit-equal to the originals, every regularizer, the Hutchinson
delta_logp probe for probe, the tabular NLL and its gradient through the
discrete adjoint with l2int and JFrobint against ``jax.grad`` for every
parameter (rtol 1e-8, the miniboone recipe's numerics: rk4, dt 0.25, T 1),
the driver's optimizer against optax's chain, and the probe's cotangent.
Tolerances are max |diff| / max |ref| unless a test says otherwise.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import pnode_tpu_torch as pt
from pnode_tpu import ffjord as J
from pnode_tpu.ffjord import datasets as j_datasets
from pnode_tpu.ffjord import toy_data as j_toy
from pnode_tpu.ffjord.layers import DIFFEQ_LAYERS as J_DIFFEQ_LAYERS
from pnode_tpu_torch import ffjord as P
from pnode_tpu_torch.convert import ffjord_states_from_flax
from pnode_tpu_torch.ffjord import datasets as p_datasets
from pnode_tpu_torch.ffjord import toy_data as p_toy
from torch_ffjord_twins import (
    assert_grads_match, carry, f64, probe, rel, sequential_probes)

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture(autouse=True)
def _fresh_port_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


class JLinearDyn(fnn.Module):
    dim: int

    @fnn.compact
    def __call__(self, t, y):
        A = self.param("A", fnn.initializers.zeros, (self.dim, self.dim))
        return y @ A.T


class LinearDyn(nn.Module):
    """dz/dt = z A^T with learnable A: an analytically tractable flow."""

    def __init__(self, dim):
        super().__init__()
        self.A = nn.Parameter(torch.zeros(dim, dim))

    def forward(self, t, y):
        return y @ self.A.T


def test_cnf_exact_logdet_linear_flow():
    """For dz/dt = A z: z(T) = expm(AT) x and delta_logp = -T tr(A), by the
    brute-force divergence; JAX's CNF gives the same z and delta_logp to
    1e-12."""
    import scipy.linalg

    D, T = 3, 0.7
    A = np.array([[0.3, 0.2, 0.0], [-0.1, -0.4, 0.1], [0.0, 0.2, 0.1]])
    x = _x(0, (5, D))
    cnf = P.CNF(LinearDyn(D), input_dim=D, T=T, solver="dopri5",
                step_size=0.01, **CPU)
    with torch.no_grad():
        cnf.net.A.copy_(torch.from_numpy(A))
        (z, dlp, _), _ = cnf.apply(torch.from_numpy(x), exact_div=True,
                                   training=False)
    np.testing.assert_allclose(z.numpy(), x @ scipy.linalg.expm(A * T).T,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(dlp.numpy(), -T * np.trace(A) * np.ones((5, 1)),
                               rtol=1e-8)
    jc = J.CNF(JLinearDyn(dim=D), input_dim=D, T=T, solver="dopri5",
               step_size=0.01)
    (jz, jdlp, _), _ = jc.apply({"params": {"A": jnp.asarray(A)}},
                                jnp.asarray(x), exact_div=True,
                                training=False)
    assert rel(z, jz) <= 1e-12 and rel(dlp, jdlp) <= 1e-12


def _odenet_cnf(hidden, D, seed, layer_type="concatsquash", **kw):
    """(JAX CNF, its fp64 params, the port's CNF with them)."""
    jnet = J.ODEnet(hidden_dims=hidden, input_dim=D, layer_type=layer_type)
    jc = J.CNF(jnet, input_dim=D, **kw)
    params = f64(jc.init(jax.random.PRNGKey(seed), jnp.ones((2, D))))
    pc = P.CNF(P.ODEnet(hidden, D, layer_type), input_dim=D, **kw, **CPU)
    return jc, params, carry(pc, params)


def test_cnf_reverse_inverts_forward():
    """x -> z -> x within 1e-5 and delta_logp cancels (the JAX test's
    tolerances); both directions equal JAX's to 1e-10."""
    D = 2
    jc, params, pc = _odenet_cnf((16,), D, 1, T=0.5, step_size=0.02)
    x = _x(1, (4, D))
    key = jax.random.PRNGKey(2)
    e = probe(key, (4, D))
    (jz, jdlp, _), _ = jc.apply(params, jnp.asarray(x), key=key,
                                training=False)
    (jxb, jdlpb, _), _ = jc.apply(params, jz, key=key, training=False,
                                  reverse=True)
    with torch.no_grad():
        (z, dlp, _), _ = pc.apply(torch.from_numpy(x), probe=e,
                                  training=False)
        (x_back, dlp_back, _), _ = pc.apply(z, probe=e, training=False,
                                            reverse=True)
    np.testing.assert_allclose(x_back.numpy(), x, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose((dlp + dlp_back).numpy(), 0.0, atol=1e-6)
    for got, ref in ((z, jz), (dlp, jdlp), (x_back, jxb),
                     (dlp_back, jdlpb)):
        assert rel(got, ref) <= 1e-10


def test_hutchinson_vs_exact_divergence():
    """The Hutchinson estimate over 64 Rademacher probes (JAX's, keys 0-63)
    approaches the exact divergence (atol 5e-3); the first four probes'
    delta_logp equal JAX's probe for probe (1e-10), not only in the mean.
    The 64 probes run as one batch of 64 copies of x: the dynamics act row
    by row, so each row is its own solve."""
    D, B, n = 2, 6, 64
    jc, params, pc = _odenet_cnf((8,), D, 3, T=0.3, step_size=0.05,
                                 rademacher=True)
    x = _x(3, (B, D))
    es = [probe(jax.random.PRNGKey(i), (B, D)) for i in range(n)]
    with torch.no_grad():
        (_, exact, _), _ = pc.apply(torch.from_numpy(x), exact_div=True,
                                    training=False)
        (_, dlp, _), _ = pc.apply(torch.from_numpy(np.tile(x, (n, 1))),
                                  probe=torch.cat(es), training=False)
    dlp = dlp.reshape(n, B, 1)
    np.testing.assert_allclose(dlp.mean(0).numpy(), exact.numpy(), atol=5e-3)
    (_, jexact, _), _ = jc.apply(params, jnp.asarray(x), exact_div=True,
                                 training=False)
    assert rel(exact, jexact) <= 1e-10
    for i in range(4):
        (_, jdlp, _), _ = jc.apply(params, jnp.asarray(x),
                                   key=jax.random.PRNGKey(i), training=False)
        assert rel(dlp[i], jdlp) <= 1e-10, i


def test_cnf_training_step_reduces_nll():
    """One CNF block trains on 8gaussians through the adjoint: 30 Adam
    steps at 2e-2 lower the NLL by 0.2 and keep it above 0.5 (the data's
    entropy is ~1.3 nats; a log-det sign error rewards collapse). The JAX
    test's recipe (hidden 32-32, rk4 0.05 over T 0.5, B 256) at B 64."""
    D = 2
    torch.manual_seed(0)
    model = P.build_model_tabular(dim=D, num_blocks=1, hidden_dims=(32, 32),
                                  step_size=0.05, time_length=0.5,
                                  solver="rk4", **CPU)
    opt = torch.optim.Adam(model.parameters(), lr=2e-2)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(30):
        x = torch.from_numpy(p_toy.inf_train_gen("8gaussians", rng, 64))
        z, dlp, _ = model.apply(x.to(F64), generator=gen, training=True)
        loss = -torch.mean(P.standard_normal_logprob(z)[:, None] - dlp)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.2, losses[::10]
    assert losses[-1] > 0.5, losses[-5:]


def test_regularization_states_accumulate():
    """l2int and JFrobint integrate to nonnegative states, equal to JAX's
    with JAX's probe (1e-10)."""
    D = 2
    jc, params, pc = _odenet_cnf((8,), D, 5, T=0.5, step_size=0.05,
                                 regularization_fns=["l2int", "JFrobint"])
    x = _x(5, (4, D))
    key = jax.random.PRNGKey(6)
    with torch.no_grad():
        (_, _, regs), _ = pc.apply(torch.from_numpy(x),
                                   probe=probe(key, x.shape), training=False)
    assert regs.shape == (4, 2)
    assert bool(torch.all(regs >= 0))
    (_, _, jregs), _ = jc.apply(params, jnp.asarray(x), key=key,
                                training=False)
    assert rel(regs, jregs) <= 1e-10


@pytest.mark.parametrize("layer_type", sorted(J_DIFFEQ_LAYERS))
def test_diffeq_layers_forward_shapes(layer_type):
    """ODEnet(12) over every dense layer type keeps the shape, depends on t
    (but ignore) and equals flax's ODEnet on its weights (1e-12)."""
    jnet = J.ODEnet(hidden_dims=(12,), input_dim=3, layer_type=layer_type)
    x = _x(0, (4, 3))
    p = f64(jnet.init(jax.random.PRNGKey(0), 0.3, jnp.asarray(x)))
    net = P.ODEnet((12,), 3, layer_type).to(F64)
    pc = carry(net, p)
    with torch.no_grad():
        out = pc(0.3, torch.from_numpy(x))
        out2 = pc(0.9, torch.from_numpy(x))
    assert out.shape == (4, 3)
    if layer_type != "ignore":
        assert not np.allclose(out.numpy(), out2.numpy())
    assert rel(out, jnet.apply(p, 0.3, jnp.asarray(x))) <= 1e-12
    assert rel(out2, jnet.apply(p, 0.9, jnp.asarray(x))) <= 1e-12


@pytest.mark.parametrize("layer_type", ["ignore", "concat", "concat_v2",
                                        "concatcoord", "concatsquash",
                                        "squash", "blend", "hyper"])
def test_diffeq_conv_layers_forward_shapes_and_grads(layer_type):
    """Every conv layer type resolves, keeps NHWC shape, depends on t, has
    finite nonzero parameter gradients, and equals flax's (1e-12; its
    gradients 1e-10)."""
    from pnode_tpu.ffjord.layers import build_diffeq_layer as j_build

    assert layer_type in P.DIFFEQ_CONV_LAYERS
    jl = j_build(layer_type, 3, conv=True)
    x = _x(3, (2, 6, 6, 3))
    p = f64(jl.init(jax.random.PRNGKey(1), 0.3, jnp.asarray(x)))
    layer = carry(P.build_diffeq_layer(layer_type, 3, 3, conv=True).to(F64),
                  p)
    xt = torch.from_numpy(x)
    out = layer(0.3, xt)
    assert out.shape == (2, 6, 6, 3)
    if layer_type != "ignore":
        assert not np.allclose(out.detach().numpy(),
                               layer(0.9, xt).detach().numpy())
    (out ** 2).sum().backward()
    grads = [q.grad for q in layer.parameters()]
    assert grads and all(bool(torch.all(torch.isfinite(g))) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    assert rel(out, jl.apply(p, 0.3, jnp.asarray(x))) <= 1e-12
    jg = jax.grad(lambda q: jnp.sum(jl.apply(q, 0.3, jnp.asarray(x)) ** 2))(p)
    assert_grads_match(layer, jg, 1e-10)


def test_moving_batch_norm_invertible():
    """Training-mode statistics, the running state and the exact inverse
    with running stats equal to the batch's; every output equals JAX's
    (1e-12)."""
    jbn = J.MovingBatchNorm(3)
    x = _x(7, (16, 3)) * 2 + 1
    jx = jnp.asarray(x)
    jp = {"log_gamma": jnp.asarray([0.1, -0.2, 0.3]),
          "beta": jnp.asarray([0.5, 0.0, -0.4])}
    bn = carry(P.MovingBatchNorm(3, **CPU), f64(jp))
    xt = torch.from_numpy(x)
    lp = torch.zeros(16, 1, dtype=F64)
    state = bn.init_state(xt)
    with torch.no_grad():
        y, lpy, new_state = bn.apply(xt, lp, state, training=True)
    jy, jlpy, jstate = jbn.apply(jp, jx, jnp.zeros((16, 1)),
                                 jbn.init_state(jx), training=True)
    assert rel(y, jy) <= 1e-12 and rel(lpy, jlpy) <= 1e-12
    for k in ("running_mean", "running_var"):
        assert rel(new_state[k], jstate[k]) <= 1e-12
    # JAX's state carried into the port drives the same evaluation-mode
    # inverse
    carried = ffjord_states_from_flax(f64(jstate))
    with torch.no_grad():
        xr, lpr, _ = bn.apply(y, lpy, carried, training=False, reverse=True)
    jxr, jlpr, _ = jbn.apply(jp, jy, jlpy, jstate, training=False,
                             reverse=True)
    assert rel(xr, jxr) <= 1e-12 and rel(lpr, jlpr) <= 1e-12
    exact = {"running_mean": xt.mean(0), "running_var": xt.var(0,
                                                               unbiased=False)}
    with torch.no_grad():
        y2, lpy2, _ = bn.apply(xt, lp, exact, training=False)
        x2, lp2, _ = bn.apply(y2, lpy2, exact, training=False, reverse=True)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(lp2.numpy(), 0.0, atol=1e-8)


def test_tabular_datasets_synthetic_fallback():
    """miniboone without its files: the synthetic surrogate of dim 43, each
    split bit-equal to the JAX package's."""
    d = p_datasets.load_tabular("miniboone")
    assert d.dim == 43 and d.synthetic
    assert d.trn.shape[0] > d.val.shape[0]
    jd = j_datasets.load_tabular("miniboone")
    for split in ("trn", "val", "tst"):
        np.testing.assert_array_equal(getattr(d, split), getattr(jd, split))


# -- beyond the reference tests ----------------------------------------------


@pytest.mark.parametrize("name", ["8gaussians", "pinwheel", "2spirals",
                                  "checkerboard", "rings", "moons",
                                  "swissroll", "circles", "line", "cos"])
def test_toy_data_bit_equal(name):
    a = p_toy.inf_train_gen(name, np.random.default_rng(3), 301)
    b = j_toy.inf_train_gen(name, np.random.default_rng(3), 301)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(j_datasets.DATA_DIMS))
def test_synthetic_tabular_bit_equal(name):
    a, b = p_datasets._synthetic(name, seed=1), j_datasets._synthetic(name,
                                                                       seed=1)
    for split in ("trn", "val", "tst"):
        np.testing.assert_array_equal(getattr(a, split), getattr(b, split))


@pytest.mark.parametrize("name", sorted(J.REGULARIZATION_FNS))
def test_regularizer_matches_jax(name):
    """Each regularizer's integrated state, on JAX's probe (1e-10)."""
    D = 3
    jc, params, pc = _odenet_cnf((6,), D, 8, T=0.5, step_size=0.125,
                                 solver="rk4", regularization_fns=[name])
    x = _x(8, (5, D))
    key = jax.random.PRNGKey(9)
    with torch.no_grad():
        (z, dlp, regs), _ = pc.apply(torch.from_numpy(x),
                                     probe=probe(key, x.shape),
                                     training=False)
    (jz, jdlp, jregs), _ = jc.apply(params, jnp.asarray(x), key=key,
                                    training=False)
    assert rel(regs, jregs) <= 1e-10
    assert rel(dlp, jdlp) <= 1e-10 and rel(z, jz) <= 1e-12


def _tabular_pair(D, batch_norm, regs):
    kw = dict(dim=D, num_blocks=1, hidden_dims=(8, 8), time_length=1.0,
              solver="rk4", step_size=0.25, rademacher=True,
              batch_norm=batch_norm, regularization_fns=regs)
    jm = J.build_model_tabular(**kw)
    x = _x(11, (7, D))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if batch_norm:  # nonzero affine parameters
        for i in (0, 2):
            params[i] = {k: 0.1 * (i + 1) * jnp.arange(1.0, D + 1.0)
                         for k in params[i]}
    params = f64(params)
    pm = carry(P.build_model_tabular(**kw, **CPU), params)
    return jm, params, pm, x


@pytest.mark.parametrize("batch_norm", [False, True],
                         ids=["cnf", "bn-cnf-bn"])
def test_tabular_nll_gradient_through_adjoint_matches_jax(batch_norm):
    """The tabular loss NLL + 0.1 l2int + 0.05 JFrobint (the JAX driver's
    nll_and_regs) and its gradient through the port's discrete adjoint
    against jax.grad through the JAX package's, for every parameter, on
    the miniboone recipe's numerics (rk4, dt 0.25, T 1, a Rademacher
    probe): rtol 1e-8."""
    D, coeffs = 4, (0.1, 0.05)
    jm, params, pm, x = _tabular_pair(D, batch_norm, ("l2int", "JFrobint"))
    key = jax.random.PRNGKey(4)
    shapes = [(7, D) if isinstance(l, J.flows.CNFLayer) else None
              for l in jm.layers]
    probes = sequential_probes(key, shapes)

    def jloss(p):
        z, dlp, _ = jm.apply(p, jnp.asarray(x), key=key, training=True)
        nll = -jnp.mean(J.standard_normal_logprob(z)[:, None] - dlp)
        r = jnp.mean(next(l for l in jm.layers
                          if hasattr(l, "cnf")).last_regs, axis=0)
        return nll + coeffs[0] * r[0] + coeffs[1] * r[1]

    jl, jg = jax.value_and_grad(jloss)(params)
    z, dlp, _ = pm.apply(torch.from_numpy(x), probes=probes, training=True)
    nll = -torch.mean(P.standard_normal_logprob(z)[:, None] - dlp)
    r = torch.mean(next(l for l in pm.layers if hasattr(l, "cnf")).last_regs,
                   dim=0)
    loss = nll + coeffs[0] * r[0] + coeffs[1] * r[1]
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-10 * abs(float(jl))
    assert_grads_match(pm, jg, 1e-8)
    # the probe is a constant of the solve: no tensor of it took a gradient
    assert all(e is None or e.grad is None for e in probes)


def test_adjoint_gradient_equals_autograd_through_the_steps():
    """The discrete adjoint's gradient (training) equals autograd's through
    the step loop (the solve without the adjoint) to fp64 rounding."""
    _, _, pm, x = _tabular_pair(3, False, ("JFrobint",))
    e = [torch.from_numpy(np.sign(_x(2, (7, 3))))]
    grads = []
    for training in (True, False):
        pm.zero_grad()
        z, dlp, _ = pm.apply(torch.from_numpy(x), probes=e,
                             training=training)
        loss = (-torch.mean(P.standard_normal_logprob(z)[:, None] - dlp)
                + pm.layers[0].last_regs.mean())
        loss.backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in pm.parameters()]))
    assert rel(grads[0], grads[1].numpy()) <= 1e-12


def test_optimizer_and_staged_decay_match_optax():
    """examples/ffjord_tabular_torch.py's Adam with weight decay 1e-6, the
    gradient scaled by 0.1 first (the staged decay), against the JAX
    driver's add_decayed_weights -> scale_by_adam -> lr chain on the same
    gradients, over two steps (1e-10)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples", "ffjord_tabular_torch.py")
    spec = importlib.util.spec_from_file_location("_ffjord_tab", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    args, _ = drv.parse_args(["--device", "cpu"])
    lin = nn.Linear(3, 2).to(F64)
    w0 = {k: v.detach().clone() for k, v in lin.named_parameters()}
    opt = drv.make_optimizer(lin, args)
    jopt = optax.chain(optax.add_decayed_weights(args.weight_decay),
                       optax.scale_by_adam(),
                       optax.scale_by_learning_rate(args.lr))
    jp = {k: jnp.asarray(v.numpy()) for k, v in w0.items()}
    js = jopt.init(jp)
    rng = np.random.default_rng(0)
    for _ in range(2):
        g = {k: rng.normal(size=v.shape) for k, v in w0.items()}
        for k, p in lin.named_parameters():
            p.grad = torch.from_numpy(g[k]).clone()
            p.grad.mul_(0.1)
        opt.step()
        jg = {k: 0.1 * jnp.asarray(v) for k, v in g.items()}
        up, js = jopt.update(jg, js, jp)
        jp = optax.apply_updates(jp, up)
    for k, p in lin.named_parameters():
        assert rel(p, jp[k]) <= 1e-10, k


def test_sample_probe_and_sources():
    """Rademacher probes are +-1 and a CPU generator gives the same probe
    whatever the target; a CNF refuses a Hutchinson solve with neither a
    generator nor a probe; each solve counts its stages (rk4, 4 steps: 16
    dynamics evaluations)."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    e1 = P.sample_probe((5, 3), F64, generator=gen(1))
    e2 = P.sample_probe((5, 3), F64, generator=gen(1), device="cpu")
    assert set(np.unique(e1.numpy())) <= {-1.0, 1.0}
    assert torch.equal(e1, e2)
    g = P.sample_probe((4000,), F64, "gaussian", gen(2))
    assert abs(float(g.mean())) < 0.1 and abs(float(g.std()) - 1) < 0.1
    _, _, pc = _odenet_cnf((4,), 2, 0, T=1.0, solver="rk4", step_size=0.25)
    x = torch.from_numpy(_x(0, (3, 2)))
    with pytest.raises(ValueError, match="generator or a probe"):
        pc.apply(x)
    with torch.no_grad():
        pc.apply(x, generator=torch.Generator().manual_seed(0),
                 training=False)
    assert [ode.nfe_forward for ode in pc.solvers] == [16]


def test_flow_constructors_refuse_cuda_without_cuda():
    """The flow constructors default to the card; without CUDA they raise
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.CNF(P.ODEnet((4,), 2), input_dim=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.build_model_tabular(dim=2, hidden_dims=(4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.ODENVP((4, 4, 1), n_scales=1, n_blocks=1, hidden_dims=(4,))


def test_public_names_match_the_jax_package():
    """Every name of pnode_tpu.ffjord's __all__ exists in the port, as do
    ODENVP and MultiscaleParallelCNF."""
    missing = [n for n in list(J.__all__) + ["ODENVP",
                                             "MultiscaleParallelCNF"]
               if not hasattr(P, n)]
    assert not missing, missing
    assert math.isclose(float(P.standard_normal_logprob(
        torch.zeros(1, 2, dtype=F64))[0]), -math.log(2 * math.pi))
