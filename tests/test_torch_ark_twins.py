"""The port's ARKIMEX stepper and the ksponly check against the JAX suite's
cases: twins of tests/test_steppers.py:124-127
(``test_ark_imex_convergence_order``), :199-202
(``test_ark_step_adjoint_matches_fd``), :335
(``test_ark_step_adjoint_recompute_path_matches_stored``) and :351
(``test_time_shifted_windows_refreeze_jacobian``), and of
tests/test_observability.py:14 and :46 (``-snes_ksponly_check``). Cases "4"
and "5" are slow in the JAX suite and here. The convergence and adjoint
twins also hold the port's step and step_adj against the JAX package's on
the same inputs in fp64."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu.linsolve import LinearSolveConfig as JLinearSolveConfig
from pnode_tpu.newton import NewtonConfig as JNewtonConfig
from pnode_tpu.steppers import ARKIMEX as JARKIMEX
from pnode_tpu.steppers import ImplicitSolveSetup as JImplicitSolveSetup
from pnode_tpu.tableaus import get_ark_tableau as jget_ark_tableau
from pnode_tpu_torch.linsolve import LinearSolveConfig
from pnode_tpu_torch.newton import NewtonConfig, newton_solve
from pnode_tpu_torch.steppers import ARKIMEX, ImplicitSolveSetup
from pnode_tpu_torch.tableaus import get_ark_tableau

torch.set_num_threads(1)
Y0 = np.array([1.0, 0.5, -0.3])
LAM = np.array([0.2, -1.1, 0.7])
P_IMEX = ({"a": -2.0}, {"b": 0.2, "c": 0.5})
_NS_BY_ORDER = {1: (40, 80, 160), 2: (20, 40, 80), 3: (10, 20, 40),
                4: (5, 10, 20), 5: (8, 16, 32)}


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def f_im(t, y, p):
    return p["a"] * y


def f_ex(t, y, p):
    return p["b"] * y ** 2 + math.cos(t) * p["c"]


def f_ex_j(t, y, p):
    return p["b"] * y ** 2 + jnp.cos(t) * p["c"]


def _tp():
    return tuple({k: torch.tensor(v, dtype=torch.float64) for k, v in d.items()}
                 for d in P_IMEX)


def _jp():
    return tuple({k: jnp.asarray(v, jnp.float64) for k, v in d.items()}
                 for d in P_IMEX)


def _setup():
    return ImplicitSolveSetup(
        lin_cfg=LinearSolveConfig(kind="gmres", rtol=1e-12),
        newton_cfg=NewtonConfig(rtol=1e-12, max_it=50))


def _jsetup():
    return JImplicitSolveSetup(
        lin_cfg=JLinearSolveConfig(kind="gmres", rtol=1e-12),
        newton_cfg=JNewtonConfig(rtol=1e-12, max_it=50))


def _stepper(ark):
    return ARKIMEX(get_ark_tableau(ark), f_im, f_ex, _setup())


def _integrate(stepper, n, t_end=1.0):
    dt = t_end / n
    y = torch.tensor(Y0)
    for k in range(n):
        y, _, _ = stepper.step(k * dt, dt, y, _tp())
    return y


ARKS = ["1bee", "ars122", "l2", "3", pytest.param("4", marks=pytest.mark.slow),
        pytest.param("5", marks=pytest.mark.slow)]


@pytest.mark.parametrize("ark", ARKS)
def test_ark_imex_convergence_order(ark):
    """Twin of :124: the empirical order from successive refinements
    against a 4x finer run is the tableau's order (within 0.5); one step
    equals the JAX package's within 1e-12."""
    tab = get_ark_tableau(ark)
    ns = _NS_BY_ORDER[tab.order]
    sols = [_integrate(_stepper(ark), n) for n in ns + (ns[-1] * 4,)]
    errs = [float((s - sols[-1]).abs().max()) for s in sols[:-1]]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)
              if errs[i + 1] > 1e-12]
    assert orders, f"all errors at roundoff floor: {errs}"
    assert orders[-1] == pytest.approx(tab.order, abs=0.5)
    y1, _, _ = _stepper(ark).step(0.3, 0.1, torch.tensor(Y0), _tp())
    jy1, _, _ = JARKIMEX(jget_ark_tableau(ark), f_im, f_ex_j,
                         _jsetup()).step(jnp.asarray(0.3), jnp.asarray(0.1),
                                         jnp.asarray(Y0), _jp())
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=1e-12)


@pytest.mark.parametrize("ark", ARKS[1:])
def test_ark_step_adjoint_matches_fd(ark):
    """Twin of :199: step_adj against central finite differences of
    <lam, step(y, p)> (rel 2e-5), and against the JAX package's step_adj
    (rtol 1e-9)."""
    stepper = _stepper(ark)
    t, dt = 0.3, 0.1
    lam, y0 = torch.tensor(LAM), torch.tensor(Y0)
    _, aux, _ = stepper.step(t, dt, y0, _tp())
    dly, (g_im, g_ex) = stepper.step_adj(t, dt, y0, _tp(), aux, lam)

    def scalar(y, p):
        with torch.no_grad():
            return float(torch.dot(lam, stepper.step(t, dt, y, p)[0]))

    eps = 1e-6
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = eps
        fd = (scalar(y0 + e, _tp()) - scalar(y0 - e, _tp())) / (2 * eps)
        assert fd == pytest.approx(float(dly[i]), rel=2e-5, abs=1e-8)
    for part, grads in ((0, g_im), (1, g_ex)):
        for k in P_IMEX[part]:
            pp, pm = _tp(), _tp()
            pp[part][k] = pp[part][k] + eps
            pm[part][k] = pm[part][k] - eps
            fd = (scalar(y0, pp) - scalar(y0, pm)) / (2 * eps)
            assert fd == pytest.approx(float(grads[k]), rel=2e-5, abs=1e-8)

    jst = JARKIMEX(jget_ark_tableau(ark), f_im, f_ex_j, _jsetup())
    jt, jdt = jnp.asarray(t), jnp.asarray(dt)
    _, jaux, _ = jst.step(jt, jdt, jnp.asarray(Y0), _jp())
    jdly, (jg_im, jg_ex) = jst.step_adj(jt, jdt, jnp.asarray(Y0), _jp(), jaux,
                                       jnp.asarray(LAM))
    np.testing.assert_allclose(dly.numpy(), np.asarray(jdly), rtol=1e-9)
    for got, ref in ((g_im, jg_im), (g_ex, jg_ex)):
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-9)


def test_ark_step_adjoint_recompute_path_matches_stored():
    """Twin of :335: aux=None (solution_only trajectories and the
    checkpointed policies' REVERSE) re-solves the stages; lam and the
    gradients equal the stored-stage path's (rtol 1e-10)."""
    stepper = _stepper("3")
    t, dt = 0.2, 0.1
    lam = torch.tensor([0.4, -0.2, 0.9])
    y0 = torch.tensor(Y0)
    _, aux, _ = stepper.step(t, dt, y0, _tp())
    dly_a, g_a = stepper.step_adj(t, dt, y0, _tp(), aux, lam)
    dly_b, g_b = stepper.step_adj(t, dt, y0, _tp(), None, lam)
    np.testing.assert_allclose(dly_a.numpy(), dly_b.numpy(), rtol=1e-10)
    for part in (0, 1):
        for k in g_a[part]:
            np.testing.assert_allclose(float(g_a[part][k]),
                                       float(g_b[part][k]), rtol=1e-10)


def test_time_shifted_windows_refreeze_jacobian():
    """Twin of :351: a frozen Jacobian of a non-autonomous implicit part
    linearized at one window's t0 is not reused for a time-shifted window of
    the same geometry (the solve cache keys on t0)."""
    def f(t, y, p):
        return -(1.0 + t) * y

    pt.init(["p"])
    y0 = torch.tensor([1.0], dtype=torch.float64)
    ode = pt.ODESolver().setupTS(y0, pt.Func(f, {}), step_size=0.05,
                                 method="beuler", implicit_form=True,
                                 linear_solver="lu", fixed_jacobian=True)
    s1, _ = ode.solve(y0, np.array([0.0, 1.0]))
    s2, _ = ode.solve(y0, np.array([10.0, 11.0]))
    ref1 = float(np.exp(-1.0 - 0.5))
    ref2 = float(np.exp(-1.0 - (121.0 - 100.0) / 2.0))
    np.testing.assert_allclose(float(s1[-1][0]), ref1, rtol=5e-2)
    np.testing.assert_allclose(float(s2[-1][0]), ref2, rtol=0, atol=2e-4)
    assert np.isfinite(float(s2[-1][0])) and abs(float(s2[-1][0])) < 1.0


# -- -snes_ksponly_check (tests/test_observability.py) ---------------------------

def test_ksponly_check_flags_stale_linearization():
    """Twin of test_observability.py:14: with a stale linearization the one
    ksponly solve misses, and the check reports it; without the check
    ksponly reports converged (PETSc's semantics)."""
    def residual(z):
        return z ** 3 + z - 1.0

    class StaleSolver:
        def solve(self, r):
            return 0.05 * r

    z0 = torch.tensor([3.0], dtype=torch.float64)
    _, stats = newton_solve(residual, lambda zz: StaleSolver(), z0,
                            NewtonConfig(ksponly=True, ksponly_check=True))
    assert not stats.converged
    _, stats = newton_solve(residual, lambda zz: StaleSolver(), z0,
                            NewtonConfig(ksponly=True, ksponly_check=False))
    assert stats.converged


def test_ksponly_check_passes_on_linear_problem():
    """Twin of test_observability.py:46: on a linear residual the one solve
    is exact, the check passes through the solver's options and stats, and
    the solution is (1 / (1 + dt k))^5 y0."""
    def f(t, y, p):
        return -p["k"] * y

    P = {"k": torch.tensor(1.3, dtype=torch.float64)}
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64)
    pt.init(["p", "-snes_type", "ksponly", "-snes_ksponly_check", "1"])
    ode = pt.ODESolver().setupTS(y0, pt.Func(f, P), step_size=0.1,
                                 method="beuler", implicit_form=True,
                                 linear_solver="torch", fixed_jacobian=True)
    assert ode.newton_cfg.ksponly and ode.newton_cfg.ksponly_check
    sol, stats = ode.solve(y0, np.array([0.0, 0.5]), params=P)
    assert bool(stats.newton_converged)
    np.testing.assert_allclose(sol[-1].numpy(),
                               y0.numpy() * (1 / (1 + 0.1 * 1.3)) ** 5,
                               rtol=1e-6)
