"""The port's checkpointed trajectories (slice 5(a)) against the JAX package.

- the planners (``pnode_tpu_torch/revolve.py``, ``cams.py``, built from
  ``csrc/*.cpp`` by ``native.py``): twins of tests/test_revolve.py:29, 35,
  43 and tests/test_cams.py:87, 111, 122, 131, 135, 146, 155, 361;
- the policies in ``adjoint.py``'s engine: twins of tests/test_revolve.py:48,
  78 and tests/test_cams.py:181, 243, 272 (each policy's gradients against
  store_all's at rtol 1e-12, as the JAX suite holds them, or tighter);
- every policy (solution_only, checkpoint, revolve, cams) against store_all
  at rtol 1e-12 and against the JAX package under the same flags at rtol
  1e-10, on rk4, CN (implicit form, GMRES + Newton) and ARK IMEX 3, in fp64;
- the engine's forward re-steps against the planners' reverse-phase costs.

The JAX package's scanned executors (tests/test_revolve.py:227, 261;
tests/test_cams.py:376, 395, 434, 458) have no twin: the port's eager loop
walks the plan and has no second executor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu_torch import cams, revolve
from pnode_tpu_torch.misc import tree_leaves
from test_cams import _exhaustive_opt, _simulate_compiled, _type_peaks
from test_revolve import _dp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


# -- the revolve planner -------------------------------------------------------

@pytest.mark.parametrize("c", [1, 2, 3, 5])
def test_closed_form_cost_matches_dp(c):
    """Twin of test_revolve.py:29."""
    for n in range(1, 40):
        assert revolve.optimal_cost(n, c) == _dp(n, c), (n, c)


@pytest.mark.parametrize("n,c", [(1, 2), (7, 1), (20, 3), (64, 6), (200, 10)])
def test_plan_is_valid_and_optimal(n, c):
    """Twin of test_revolve.py:35."""
    plan = revolve.revolve_plan(n, c)
    stats = revolve.validate_plan(plan, n, c)
    assert stats["advance_cost"] == revolve.optimal_cost(n, c)
    assert stats["max_live"] <= c + 1


def test_native_library_loaded():
    """Twin of test_revolve.py:43 and test_cams.py:131: both planners are
    the libraries built from csrc/ into build/pnode_tpu_torch/, never the
    JAX package's."""
    assert revolve.using_native() and cams.using_native()
    for lib in (revolve._LIB, cams._LIB):
        assert "build/pnode_tpu_torch/lib" in lib._name, lib._name


def test_revolve_python_planner_matches_native():
    """The pure-Python planner the module keeps emits the native plan."""
    for n, c in [(1, 1), (9, 2), (40, 3), (100, 8), (257, 5)]:
        out = []
        revolve._plan_py(0, n, c, out)
        assert out == revolve.revolve_plan(n, c), (n, c)


# -- the CAMS planner ----------------------------------------------------------

def test_planner_matches_exhaustive_small_grid():
    """Twin of test_cams.py:87."""
    for n in range(1, 5):
        for m in range(0, 4):
            for w in (1, 2, 3):
                assert cams.optimal_cost(n, m, w) == _exhaustive_opt(n, m, w), (
                    n, m, w)


@pytest.mark.parametrize(
    "n,m,w",
    [(1, 0, 2), (7, 3, 2), (20, 6, 3), (64, 9, 4), (200, 12, 5), (613, 17, 5)],
)
def test_plan_is_valid_and_achieves_dp_cost(n, m, w):
    """Twin of test_cams.py:111."""
    fwd, rev = cams.cams_plan(n, m, w)
    stats = cams.validate_plan(fwd, rev, n, m, w)
    assert stats["cost"] == cams.optimal_cost(n, m, w)
    assert stats["max_units"] <= m


def test_two_level_plan_beyond_exact_cap():
    """Twin of test_cams.py:122."""
    n, m, w = 3000, 20, 4
    fwd, rev = cams.cams_plan(n, m, w)
    stats = cams.validate_plan(fwd, rev, n, m, w)
    assert stats["max_units"] <= m
    assert stats["cost"] < n * (n + 1) // 4


def test_python_fallback_matches_native():
    """Twin of test_cams.py:135."""
    for n, m, w in [(5, 2, 2), (17, 5, 3), (40, 8, 2)]:
        t_nat = cams._solve_tables(n, m, w)
        t_py = cams._solve_tables_py(n, m, w)
        assert t_nat.cost == t_py.cost, (n, m, w)
        em = cams._Emitter(t_py)
        em.emit_F(0, n, m, 0, 0, anchor=0, pending=False)
        st = cams.validate_plan(em.fwd, em.rev, n, m, w)
        assert st["cost"] == t_py.cost


def test_cams_dominates_revolve_executor_cost():
    """Twin of test_cams.py:146."""
    for n, c in [(100, 8), (500, 12)]:
        for w in (2, 5):
            assert cams.optimal_cost(n, c, w) < revolve.optimal_cost(n, c) + n


def test_saturated_budget_is_free():
    """Twin of test_cams.py:155."""
    assert cams.optimal_cost(12, 12 * 3, 3) == 0
    fwd, rev = cams.cams_plan(12, 12 * 3, 3)
    assert cams.validate_plan(fwd, rev, 12, 36, 3)["cost"] == 0


@pytest.mark.parametrize("n,m,w", [
    (1, 1, 2), (5, 2, 2), (7, 3, 2), (9, 4, 3), (16, 5, 2), (25, 6, 4),
    (40, 8, 2), (64, 7, 3),
])
def test_compile_plan_replays_consistently(n, m, w):
    """Twin of test_cams.py:361."""
    fwd, rev = cams.cams_plan(n, m, w)
    comp = cams.compile_plan(fwd, rev, n)
    _simulate_compiled(comp, n)
    ps, pg = _type_peaks(fwd, rev, n)
    assert comp["n_sol"] == ps
    assert comp["n_stage"] == pg


# -- the policies: the JAX suite's cases ----------------------------------------

def _tanh_f(t, y, p):
    return p["a"] * y + p["b"] * torch.tanh(y)


def _tanh_j(t, y, p):
    return p["a"] * y + p["b"] * jnp.tanh(y)


def _cubic_f(t, y, p):
    return -p["k"] * y ** 3


def _cubic_j(t, y, p):
    return -p["k"] * y ** 3


def _tgrad(flags, f, P, y0, t, loss_nodes, **setup):
    """The port's loss and gradients {name: grad} (dL/dy0 as "y0")."""
    pt.clear_options()
    pt.init(["p"] + flags)
    params = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for k, v in P.items()}
    y = torch.tensor(y0, dtype=torch.float64, requires_grad=True)
    ode = pt.ODESolver().setupTS(y.detach(), pt.Func(f, params), **setup)
    sol = ode.odeint_adjoint(y, t, params=params)
    loss = sum(torch.sum(sol[i] ** 2) for i in loss_nodes)
    loss.backward()
    out = {k: v.grad.numpy().copy() for k, v in params.items()}
    out["y0"] = y.grad.numpy().copy()
    return ode, float(loss.detach()), out, sol.detach().numpy()


def _jgrad(flags, f, P, y0, t, loss_nodes, **setup):
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + flags)
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in P.items()}
    ode = JODESolver()
    ode.setupTS(jnp.asarray(y0), JFunc(f, jp), **setup)

    def loss(p, y):
        sol = ode.odeint_adjoint(y, jnp.asarray(t), params=p)
        return sum(jnp.sum(sol[i] ** 2) for i in loss_nodes)

    val, (gp, gy) = jax.value_and_grad(loss, argnums=(0, 1))(jp, jnp.asarray(y0))
    out = {k: np.asarray(v) for k, v in gp.items()}
    out["y0"] = np.asarray(gy)
    return float(val), out


def _close(a, b, rtol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=0, err_msg=k)


RK4_CASE = dict(f=_tanh_f, P={"a": -0.4, "b": 0.3}, y0=[1.0, -0.7, 0.2],
                t=np.array([0.0, 0.4, 0.8]), loss_nodes=(-1, 1),
                setup=dict(step_size=0.1, method="rk4"))
CN_CASE = dict(f=_cubic_f, P={"k": 2.0}, y0=[1.0, 0.5],
               t=np.array([0.0, 1.0]), loss_nodes=(-1,),
               setup=dict(step_size=0.1, method="cn", implicit_form=True))
REVOLVE = ["-ts_trajectory_schedule", "revolve"]
CAMS = ["-ts_trajectory_schedule", "cams"]


@pytest.mark.parametrize("case, flags", [
    (RK4_CASE, ["-ts_trajectory_max_cps_ram", "3"] + REVOLVE),  # :48
    (CN_CASE, ["-ts_trajectory_max_cps_ram", "2"] + REVOLVE),   # :78
    (RK4_CASE, ["-ts_trajectory_max_cps_ram", "6"] + CAMS),     # cams :181
    (CN_CASE, ["-ts_trajectory_max_cps_ram", "2"] + CAMS),      # cams :243
], ids=["revolve_rk4", "revolve_cn", "cams_rk4", "cams_cn_tight_budget"])
def test_policy_gradients_match_store_all(case, flags):
    """Twins of test_revolve.py:48, 78 and test_cams.py:181, 243: the
    gradients under revolve and CAMS equal store_all's (rtol 1e-12; the
    JAX suite holds its CN cases at 1e-9)."""
    args = (case["f"], case["P"], case["y0"], case["t"], case["loss_nodes"])
    ode, _, g, _ = _tgrad(flags, *args, **case["setup"])
    assert ode.traj.kind == flags[-1]
    _, _, g_ref, _ = _tgrad([], *args, **case["setup"])
    _close(g, g_ref, 1e-12)


def test_cams_solve_values_match_store_all():
    """Twin of test_cams.py:272: the outputs, interior and final, equal
    store_all's."""
    def f(t, y, p):
        return p["a"] * y

    args = (f, {"a": -0.7}, [2.0, 1.0, -1.0], np.array([0.0, 0.3, 0.8, 1.2]),
            (-1,))
    setup = dict(step_size=0.05, method="bosh3")
    *_, s_ref = _tgrad([], *args, **setup)
    *_, s_cam = _tgrad(["-ts_trajectory_max_cps_ram", "4"] + CAMS, *args,
                       **setup)
    np.testing.assert_allclose(s_cam, s_ref, rtol=1e-12)


# -- every policy, three steppers, against store_all and the JAX package ---------

def _imex_case():
    def f_im(t, y, p):
        return p["k"] * y

    def f_ex(t, y, p):
        return p["c"] * torch.sin(y)

    def f_im_j(t, y, p):
        return p["k"] * y

    def f_ex_j(t, y, p):
        return p["c"] * jnp.sin(y)

    return (f_im, f_ex), (f_im_j, f_ex_j)


TIGHT = ["-ksp_rtol", "1e-13", "-snes_rtol", "1e-13", "-snes_stol", "1e-14"]
POLICIES = {
    "store_all": [],
    "solution_only": ["-ts_trajectory_solution_only", "1"],
    "checkpoint": ["-ts_trajectory_max_cps_ram", "3"],
    "revolve": ["-ts_trajectory_max_cps_ram", "3"] + REVOLVE,
    "cams": ["-ts_trajectory_max_cps_ram", "4"] + CAMS,
}


def _imex_grads(flags, jax_side):
    (f_im, f_ex), (f_im_j, f_ex_j) = _imex_case()
    y0, t = np.array([1.0, -0.5]), np.array([0.0, 0.3, 0.6])
    P = ({"k": -2.0}, {"c": 0.5})
    setup = dict(step_size=0.05, method="imex", imex_form=True,
                 implicit_form=True)
    if jax_side:
        pnode_tpu.clear_options()
        pnode_tpu.init(["p"] + flags)
        jp = tuple({k: jnp.asarray(v, jnp.float64) for k, v in d.items()}
                   for d in P)
        ode = JODESolver()
        ode.setupTS(jnp.asarray(y0), JFunc(f_im_j, jp[0]),
                    func2=JFunc(f_ex_j, jp[1]), **setup)

        def loss(p, y):
            sol = ode.odeint_adjoint(y, jnp.asarray(t), params=p)
            return jnp.sum(sol[-1] ** 2) + jnp.sum(sol[1] ** 2)

        val, (gp, gy) = jax.value_and_grad(loss, argnums=(0, 1))(
            jp, jnp.asarray(y0))
        return float(val), {"k": np.asarray(gp[0]["k"]),
                            "c": np.asarray(gp[1]["c"]), "y0": np.asarray(gy)}
    pt.clear_options()
    pt.init(["p"] + flags)
    tp = tuple({k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
                for k, v in d.items()} for d in P)
    y = torch.tensor(y0, requires_grad=True)
    ode = pt.ODESolver().setupTS(y.detach(), pt.Func(f_im, tp[0]),
                                 func2=pt.Func(f_ex, tp[1]), **setup)
    sol = ode.odeint_adjoint(y, t, params=tp)
    loss = torch.sum(sol[-1] ** 2) + torch.sum(sol[1] ** 2)
    loss.backward()
    return float(loss.detach()), {"k": tp[0]["k"].grad.numpy(),
                         "c": tp[1]["c"].grad.numpy(), "y0": y.grad.numpy()}


@pytest.mark.parametrize("policy", ["solution_only", "checkpoint", "revolve",
                                    "cams"])
@pytest.mark.parametrize("method", ["rk4", "cn", "imex3"])
def test_policy_matches_store_all_and_jax(method, policy):
    """Each policy's loss and gradients (the parameters and dL/dy0) against
    the port's store_all (rtol 1e-12) and against the JAX package under
    the same flags (rtol 1e-10), stage solves at tight tolerances."""
    if method == "imex3":
        l_pol, g_pol = _imex_grads(TIGHT + POLICIES[policy], False)
        l_ref, g_ref = _imex_grads(TIGHT, False)
        l_jax, g_jax = _imex_grads(TIGHT + POLICIES[policy], True)
    else:
        case = RK4_CASE if method == "rk4" else CN_CASE
        tf, jf = (_tanh_f, _tanh_j) if method == "rk4" else (_cubic_f,
                                                            _cubic_j)
        args = (case["P"], case["y0"], case["t"], case["loss_nodes"])
        _, l_pol, g_pol, _ = _tgrad(TIGHT + POLICIES[policy], tf, *args,
                                    **case["setup"])
        _, l_ref, g_ref, _ = _tgrad(TIGHT, tf, *args, **case["setup"])
        l_jax, g_jax = _jgrad(TIGHT + POLICIES[policy], jf, *args,
                              **case["setup"])
    assert l_pol == pytest.approx(l_ref, rel=1e-12)
    _close(g_pol, g_ref, 1e-12)
    assert l_pol == pytest.approx(l_jax, rel=1e-10)
    _close(g_pol, g_jax, 1e-10)


# -- the engine's work against the planners' costs ------------------------------

class _Counter:
    """Counts a stepper's steps: those inside step_adj (the stage
    recomputes of aux=None) apart from the rest."""

    def __init__(self, stepper):
        self.steps = self.inner = 0
        self._in_adj = False
        step, step_adj = stepper.step, stepper.step_adj

        def counted_step(*a, **k):
            if self._in_adj:
                self.inner += 1
            else:
                self.steps += 1
            return step(*a, **k)

        def counted_adj(*a, **k):
            self._in_adj = True
            try:
                return step_adj(*a, **k)
            finally:
                self._in_adj = False

        stepper.step, stepper.step_adj = counted_step, counted_adj


@pytest.mark.parametrize("policy", list(POLICIES))
def test_resteps_equal_planner_costs(policy):
    """rk4 over n = 37 steps at c = 4: the engine's forward steps after the
    original pass and the stage recomputes inside step_adj are what each
    policy's plan costs (revolve: optimal_cost(n, c) re-steps and n
    recomputes; CAMS: re-steps + recomputes = validate_plan's cost, the
    forward-step evaluations after the original pass; checkpoint: each step
    once more, with its stages kept)."""
    n, c = 37, 4
    flags = {"store_all": [], "solution_only": POLICIES["solution_only"],
             "checkpoint": ["-ts_trajectory_max_cps_ram", str(c)],
             "revolve": ["-ts_trajectory_max_cps_ram", str(c)] + REVOLVE,
             "cams": ["-ts_trajectory_max_cps_ram", str(c)] + CAMS}[policy]
    pt.init(["p"] + flags)
    params = {"a": torch.tensor(-0.4, dtype=torch.float64,
                                requires_grad=True),
              "b": torch.tensor(0.3, dtype=torch.float64,
                                requires_grad=True)}
    y0 = torch.tensor([1.0, -0.7, 0.2], dtype=torch.float64)
    ode = pt.ODESolver().setupTS(y0, pt.Func(_tanh_f, params),
                                 step_size=0.1, method="rk4")
    cnt = _Counter(ode._stepper)
    sol = ode.odeint_adjoint(y0, np.array([0.0, 1.5, n * 0.1]),
                             params=params)
    (torch.sum(sol[-1] ** 2) + torch.sum(sol[1] ** 2)).backward()
    resteps, inner = cnt.steps - n, cnt.inner
    if policy == "store_all":
        assert (resteps, inner) == (0, 0)
    elif policy == "solution_only":
        assert (resteps, inner) == (0, n)
    elif policy == "checkpoint":
        assert (resteps, inner) == (n, 0)
    elif policy == "revolve":
        assert (resteps, inner) == (revolve.optimal_cost(n, c), n)
    else:
        w = cams.stage_weight(4 * 3, 3)  # rk4 keeps 4 stages of 3 values
        fwd, rev = cams.cams_plan(n, c, w)
        assert resteps + inner == cams.validate_plan(fwd, rev, n, c, w)["cost"]
        assert inner == sum(1 for op, _ in rev if op == cams.REVERSE)
    assert all(torch.isfinite(p.grad) for p in tree_leaves(params))


def test_later_slice_policies_raise():
    """Disk and compressed storage, and the adaptive path's checkpointed
    policies, are slice 5(b)."""
    y0 = torch.zeros(2, dtype=torch.float64)
    f = pt.Func(_tanh_f, {"a": torch.tensor(-0.4), "b": torch.tensor(0.3)})
    for flags in (["-ts_trajectory_type", "disk"],
                  ["-pnode_trajectory_dtype", "bfloat16"],
                  ["-ts_adapt_type", "basic", "-ts_trajectory_max_cps_ram",
                   "4", "-ts_trajectory_schedule", "revolve"]):
        pt.clear_options()
        pt.init(["p"] + flags)
        with pytest.raises(NotImplementedError, match="slice 5"):
            pt.ODESolver().setupTS(y0, f, step_size=0.1, method="bosh3")
