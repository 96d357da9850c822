"""The port's GMRES (linsolve.py) and Theta stepper (steppers.py) against the
JAX package: twins of tests/test_steppers.py's theta and linear-solver cases
(:105, :168, :239, :261, :270, :278, :297, :315), plus one-to-one parity in
fp64 on the same numpy inputs: gmres's x within 1e-10 with equal ``iters``;
Theta.step within 1e-10 and step_adj (lambda and parameter gradients)
within 1e-8 at theta 1 and 1/2 with the GMRES, direct and (with a frozen
Jacobian) block stage solvers; step_embedded with a singular mass matrix."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu.linsolve import LinearSolveConfig as JLinearSolveConfig
from pnode_tpu.linsolve import gmres as jgmres
from pnode_tpu.newton import NewtonConfig as JNewtonConfig
from pnode_tpu.steppers import ImplicitSolveSetup as JImplicitSolveSetup
from pnode_tpu.steppers import Theta as JTheta
from pnode_tpu_torch.linsolve import (
    LinearSolveConfig, gmres, make_stage_solver)
from pnode_tpu_torch.newton import NewtonConfig, newton_solve
from pnode_tpu_torch.steppers import ImplicitSolveSetup, Theta

torch.set_num_threads(1)
P0 = {"a": -0.7, "b": 0.15, "c": 0.4}
Y0 = np.array([1.0, 0.5, -0.3])
LAM = np.array([0.2, -1.1, 0.7])
THETAS = pytest.mark.parametrize("theta", [1.0, 0.5], ids=["beuler", "cn"])


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def f_poly(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + math.sin(t) * p["c"]


def f_poly_j(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + jnp.sin(t) * p["c"]


def _tp():
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in P0.items()}


def _jp():
    return {k: jnp.asarray(v, jnp.float64) for k, v in P0.items()}


def _setup(kind="gmres", **kw):
    return ImplicitSolveSetup(
        lin_cfg=LinearSolveConfig(kind=kind, rtol=1e-12, **kw),
        newton_cfg=NewtonConfig(rtol=1e-12, max_it=50))


def _jsetup(kind="gmres", **kw):
    return JImplicitSolveSetup(
        lin_cfg=JLinearSolveConfig(kind=kind, rtol=1e-12, **kw),
        newton_cfg=JNewtonConfig(rtol=1e-12, max_it=50))


def _integrate(stepper, n, t_end=1.0, y0=Y0, params=None):
    params = _tp() if params is None else params
    dt = t_end / n
    y = torch.as_tensor(y0, dtype=torch.float64)
    for k in range(n):
        y, _, _ = stepper.step(k * dt, dt, y, params)
    return y


# -- twins of tests/test_steppers.py -------------------------------------------

@THETAS
def test_theta_convergence_order(theta):
    """Twin of :105: BE is first order, CN second."""
    expected = 1 if theta == 1.0 else 2
    ns = {1: (40, 80, 160), 2: (20, 40, 80)}[expected]
    sols = [_integrate(Theta(theta, f_poly, _setup()), n)
            for n in ns + (ns[-1] * 4,)]
    errs = [float((s - sols[-1]).abs().max()) for s in sols[:-1]]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)
              if errs[i + 1] > 1e-12]
    assert orders[-1] == pytest.approx(expected, abs=0.5)


@THETAS
@pytest.mark.parametrize("kind", ["gmres", "direct"])
def test_theta_step_adjoint_matches_fd(theta, kind):
    """Twin of :168: step_adj against central finite differences of
    <lam, step(y, p)>."""
    stepper = Theta(theta, f_poly, _setup(kind=kind))
    t, dt = 0.3, 0.1
    lam = torch.tensor(LAM)
    y0 = torch.tensor(Y0)
    stp = stepper.prepare(t, y0, _tp())
    _, aux, _ = stp.step(t, dt, y0, _tp())
    dly, dlp = stp.step_adj(t, dt, y0, _tp(), aux, lam)

    def scalar(y, p):
        y1, _, _ = stepper.prepare(t, y, p).step(t, dt, y, p)
        return float(torch.dot(lam, y1))

    eps = 1e-6
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = eps
        fd = (scalar(y0 + e, _tp()) - scalar(y0 - e, _tp())) / (2 * eps)
        assert fd == pytest.approx(float(dly[i]), rel=2e-5, abs=1e-8)
    for k in P0:
        pp, pm = _tp(), _tp()
        pp[k] = pp[k] + eps
        pm[k] = pm[k] - eps
        fd = (scalar(y0, pp) - scalar(y0, pm)) / (2 * eps)
        assert fd == pytest.approx(float(dlp[k]), rel=2e-5, abs=1e-8)


def test_theta_dae_mass_matrix():
    """Twin of :239: index-1 DAE y0' = -y0, 0 = y1 - y0 through a singular
    mass matrix under BE."""
    M = torch.diag(torch.tensor([1.0, 0.0], dtype=torch.float64))

    def f(t, y, p):
        return torch.stack([-p["k"] * y[0], y[1] - y[0]])

    stepper = Theta(1.0, f, _setup(), mass=M)
    y = _integrate(stepper, 100, y0=np.array([1.0, 1.0]),
                   params={"k": torch.tensor(1.0, dtype=torch.float64)})
    assert float(y[0]) == pytest.approx(np.exp(-1.0), abs=3e-3)
    assert float((y[1] - y[0]).abs()) < 1e-10


def test_gmres_solves_nonsymmetric():
    """Twin of :261."""
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((40, 40)) + 6 * np.eye(40))
    b = torch.tensor(rng.standard_normal(40))
    res = gmres(lambda v: A @ v, b, rtol=1e-12, restart=40, max_restarts=4)
    np.testing.assert_allclose((A @ res.x).numpy(), b.numpy(), rtol=0,
                               atol=1e-8)
    assert res.converged


def test_gmres_restart_path():
    """Twin of :270: restart 15 on a 60-dimensional system."""
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.standard_normal((60, 60)) + 8 * np.eye(60))
    b = torch.tensor(rng.standard_normal(60))
    res = gmres(lambda v: A @ v, b, rtol=1e-10, restart=15, max_restarts=30)
    np.testing.assert_allclose((A @ res.x).numpy(), b.numpy(), rtol=0,
                               atol=1e-6)


def _poly_flat(z):
    return f_poly(0.3, z, _tp()).reshape(-1)


def test_stage_operator_transpose_identity():
    """Twin of :278: <(sM - gJ) v, w> == <v, (sM - gJ)^T w> on the GMRES
    operator (jvp forward, the vjp built once backward)."""
    solver = make_stage_solver(_poly_flat, torch.tensor(Y0), None, sigma=1.0,
                               gamma=0.05,
                               cfg=LinearSolveConfig(kind="gmres", rtol=1e-12))
    rng = np.random.default_rng(2)
    v = torch.tensor(rng.standard_normal(3))
    w = torch.tensor(rng.standard_normal(3))
    lhs = float(torch.dot(solver._apply(v), w))
    rhs = float(torch.dot(v, solver._apply_T(w)))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_dense_vs_gmres_stage_solve_agree():
    """Twin of :297."""
    y = torch.tensor(Y0)
    rhs = torch.tensor([0.3, -0.2, 1.0], dtype=torch.float64)
    s_g = make_stage_solver(_poly_flat, y, None, 1.0, 0.05,
                            LinearSolveConfig(kind="gmres", rtol=1e-13))
    s_d = make_stage_solver(_poly_flat, y, None, 1.0, 0.05,
                            LinearSolveConfig(kind="direct"))
    np.testing.assert_allclose(s_g.solve(rhs).numpy(),
                               s_d.solve(rhs).numpy(), atol=1e-9)
    np.testing.assert_allclose(s_g.solve_transpose(rhs).numpy(),
                               s_d.solve_transpose(rhs).numpy(), atol=1e-9)


def test_newton_solves_nonlinear_system():
    """Twin of :315: Newton-Krylov on z^3 + z = (1, 2, 3)."""
    target = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)

    def residual(z):
        return z ** 3 + z - target

    def make_solver(z):
        return make_stage_solver(lambda zz: -(zz ** 3 + zz), z, None, 0.0,
                                 1.0, LinearSolveConfig(kind="gmres",
                                                        rtol=1e-14))

    z, stats = newton_solve(residual, make_solver,
                            torch.zeros(3, dtype=torch.float64),
                            NewtonConfig(rtol=1e-14))
    np.testing.assert_allclose(residual(z).numpy(), 0.0, atol=1e-10)
    assert stats.converged


# -- one-to-one parity with the JAX package --------------------------------------

@pytest.mark.parametrize("n, restart, max_restarts, rtol, shift", [
    (40, 40, 4, 1e-12, 6.0),    # one cycle
    (60, 15, 30, 1e-10, 8.0),   # restarted
    (50, 10, 3, 1e-14, 1.0),    # ends at max_restarts, unconverged
    (4, 30, 10, 1e-12, 3.0),    # m = n < restart: happy breakdown
], ids=["one-cycle", "restarted", "unconverged", "m-equals-n"])
def test_gmres_matches_jax(n, restart, max_restarts, rtol, shift):
    """The port's gmres against JAX's on one numpy matrix: the same CGS2
    Arnoldi and cycle count (``iters`` equal), x within 1e-10."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) + shift * np.eye(n)
    b = rng.standard_normal(n)
    At, Aj = torch.tensor(A), jnp.asarray(A)
    res = gmres(lambda v: At @ v, torch.tensor(b), rtol=rtol,
                restart=restart, max_restarts=max_restarts)
    ref = jgmres(lambda v: Aj @ v, jnp.asarray(b), rtol=rtol,
                 restart=restart, max_restarts=max_restarts)
    assert res.iters == int(ref.iters)
    assert res.converged == bool(ref.converged)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(res.resnorm), float(ref.resnorm),
                               rtol=1e-6, atol=1e-12)


def test_gmres_breakdown_columns_are_dropped():
    """An exact Krylov space before the m-th step (A = 2 I: one step) masks
    the rest of the cycle to zero columns; the least squares keeps the
    minimum-norm solution, as JAX's SVD does."""
    A = 2.0 * np.eye(6)
    b = np.arange(1.0, 7.0)
    res = gmres(lambda v: torch.tensor(A) @ v, torch.tensor(b), rtol=1e-12,
                restart=6, max_restarts=2)
    ref = jgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-12,
                 restart=6, max_restarts=2)
    assert res.iters == int(ref.iters) == 6
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), b / 2.0, atol=1e-12)


@THETAS
@pytest.mark.parametrize("kind", ["gmres", "direct", "block"])
def test_theta_step_and_adjoint_match_jax(theta, kind):
    """Theta.step within 1e-10 and step_adj (stored and recomputed stage)
    within 1e-8 of JAX's, on a batched (2, 3) state; "block" with a frozen
    Jacobian (prepare with dt0: the pre-inverted theta operator serves the
    step and, the Jacobian frozen, the transposed solve)."""
    fixed = kind == "block"
    lin = dict(block_size=3, fixed_jacobian=fixed)
    setup_t, setup_j = _setup(kind, **lin), _jsetup(kind, **lin)
    if fixed:
        setup_t.adjoint_exact_jacobian = False
        setup_j = JImplicitSolveSetup(setup_j.lin_cfg, setup_j.newton_cfg,
                                      adjoint_exact_jacobian=False)
    y0 = np.stack([Y0, 0.5 * Y0[::-1]])
    lam = np.stack([LAM, -LAM])
    t, dt = 0.3, 0.1
    ts = Theta(theta, f_poly, setup_t).prepare(t, torch.tensor(y0), _tp(),
                                               dt0=dt)
    js = JTheta(theta, f_poly_j, setup_j).prepare(
        jnp.asarray(t), jnp.asarray(y0), _jp(), dt0=jnp.asarray(dt))
    y1t, auxt, st_t = ts.step(t, dt, torch.tensor(y0), _tp())
    y1j, auxj, st_j = js.step(jnp.asarray(t), jnp.asarray(dt),
                              jnp.asarray(y0), _jp())
    np.testing.assert_allclose(y1t.numpy(), np.asarray(y1j), rtol=1e-10,
                               atol=1e-12)
    assert st_t.newton_iters == int(st_j.newton_iters)
    assert st_t.newton_converged == bool(st_j.newton_converged)
    dlj, dpj = js.step_adj(jnp.asarray(t), jnp.asarray(dt), jnp.asarray(y0),
                           _jp(), auxj, jnp.asarray(lam))
    for aux in (auxt, None):
        dlt, dpt = ts.step_adj(t, dt, torch.tensor(y0), _tp(), aux,
                               torch.tensor(lam))
        np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), rtol=1e-8,
                                   atol=1e-10)
        for k in P0:
            np.testing.assert_allclose(float(dpt[k]), float(dpj[k]),
                                       rtol=1e-8, atol=1e-10)


@THETAS
def test_theta_step_embedded_with_mass_matches_jax(theta):
    """step_embedded with a singular mass matrix: the step, and the error
    estimate with the algebraic row masked to zero, against JAX."""
    M = np.diag([1.0, 1.0, 0.0])

    def f_t(t, y, p):
        return torch.stack([-p["k"] * y[0] + y[1], -y[1] * y[2],
                            y[2] - y[0] ** 2])

    def f_j(t, y, p):
        return jnp.stack([-p["k"] * y[0] + y[1], -y[1] * y[2],
                          y[2] - y[0] ** 2])

    y0 = np.array([0.7, -0.4, 0.49])
    ts = Theta(theta, f_t, _setup(), mass=torch.tensor(M))
    js = JTheta(theta, f_j, _jsetup(), mass=jnp.asarray(M))
    y1t, errt, _, _ = ts.step_embedded(0.1, 0.05, torch.tensor(y0),
                                       {"k": torch.tensor(1.3,
                                                          dtype=torch.float64)})
    y1j, errj, _, _ = js.step_embedded(jnp.asarray(0.1), jnp.asarray(0.05),
                                       jnp.asarray(y0),
                                       {"k": jnp.asarray(1.3)})
    np.testing.assert_allclose(y1t.numpy(), np.asarray(y1j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(errt.numpy(), np.asarray(errj), rtol=1e-10,
                               atol=1e-14)
    assert float(errt[2]) == 0.0 and float(errt[:2].abs().max()) > 0.0
    # the algebraic row holds at the new state
    assert abs(float(y1t[2] - y1t[0] ** 2)) < 1e-10


def test_theta_step_keeps_low_precision_state_dtype():
    """A float32 state steps at float32 (Newton at promote(fp32, fp32)) and
    comes back float32, with a float64 mass matrix cast to it."""
    M = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64))
    stp = Theta(0.5, lambda t, y, p: -y, _setup(), mass=M)
    y1, aux, _ = stp.step(0.0, 0.1, torch.ones(3, dtype=torch.float32), {})
    assert y1.dtype == torch.float32 and aux is y1
    np.testing.assert_allclose(y1.numpy(), [0.95 / 1.05] * 2 + [-1.0],
                               rtol=1e-6, atol=1e-7)


def test_fixed_stencil_cast_inside_jvp_is_plain():
    """CircularConv1D keeps its fixed stencil cast to y's dtype: a first
    call inside torch.func.jvp (the GMRES matvec) must cache a plain tensor,
    not the transform's wrapper, so later calls outside it work and agree."""
    from pnode_tpu_torch.models import KSSnodeFunc

    mod = KSSnodeFunc(nx=16, hidden=4, use_fused=True,
                      generator=torch.Generator().manual_seed(0))
    y = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    v = torch.randn(3, 16, generator=torch.Generator().manual_seed(2))
    out, _ = torch.func.jvp(lambda z: mod(0.0, z), (y,), (v,))
    cast = mod.conv._cast[1]
    assert cast.dtype == torch.float32
    assert not torch._C._functorch.is_functorch_wrapped_tensor(cast)
    assert torch.equal(mod(0.0, y), out)
