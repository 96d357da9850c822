"""The adaptive controller (-ts_adapt_type basic|pi) of the PyTorch port
against the JAX package: twins of tests/test_adaptive.py on the same numpy
inputs.

- ``trial_step_core``, ``_wrms`` and both controllers on fixed cores with a
  stub stepper, in fp64: decisions and counters exact, times and step
  sizes within 1e-14 relative (numpy's pow against XLA's).
- Solves in fp64 on the generic path: outputs within rtol 1e-10, stats
  equal (accepted, rejected, newton_iters, completed), dt_first / dt_last
  within 1e-10 relative (the Newton iterates and pow round apart), gradients
  within rtol 1e-10.
- The KS fused route (K2 with its err output and K3, plain versions on the
  CPU) in fp32, at the reference test's tolerances (loss rtol 1e-5,
  gradients rtol 5e-4 / atol 1e-6).
- The explicit-RK twins (dopri5, bosh3 on ``ExplicitRK``) of
  tests/test_adaptive.py:28, 43, 56, 87, 451 and 491 in fp64: each
  reference test's own checks on the port, and the port against JAX
  (solutions and gradients rtol 1e-10, stats equal).
The controller on cn (Theta with GMRES) is twinned in
tests/test_torch_theta_trainers.py; the scalar ARK twins here run the direct
dense stage solver (``linear_solver="torch"``) on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu.adaptive as jad
import pnode_tpu_torch as pt
import pnode_tpu_torch.adaptive as tad
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu.steppers import StepStats as JStepStats
from pnode_tpu_torch.steppers import StepStats as TStepStats
from test_torch_solver import F32, F64, Pair

torch.set_num_threads(1)
Y0 = np.array([1.0, -0.5])


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


# -- trial_step_core, _wrms and the controllers ------------------------------

class JStub:
    """y1 = y + dt a y, err = dt^2 c y: a stepper whose error estimate the
    test sets through c."""

    def step_embedded(self, t, dt, y, p):
        y1 = y + dt * p["a"] * y
        err = dt ** 2 * p["c"] * y
        return y1, err, jnp.stack([y, y1]), JStepStats(
            newton_iters=jnp.array(3, jnp.int32),
            newton_converged=jnp.array(True))


class TStub:
    def step_embedded(self, t, dt, y, p):
        y1 = y + dt * p["a"] * y
        err = dt ** 2 * p["c"] * y
        return y1, err, torch.stack([y, y1]), TStepStats(3, True)


CORES = {
    # name: (t, dt, out_i, eprev, rejprev, c, controller, clip)
    "accept_grow": (0.1, 0.05, 1, 1.0, False, 1e-2, "basic", (0.1, 10.0)),
    "reject_shrink": (0.1, 0.3, 1, 1.0, False, 1e4, "basic", (0.1, 10.0)),
    "clip_low": (0.1, 0.3, 1, 1.0, False, 1e9, "basic", (0.2, 5.0)),
    "clip_high": (0.1, 0.01, 1, 1.0, False, 1e-12, "basic", (0.2, 5.0)),
    "rejprev_no_growth": (0.1, 0.01, 1, 1.0, True, 1e-6, "basic",
                          (0.1, 10.0)),
    "pi_accept": (0.1, 0.05, 1, 0.3, False, 1e-2, "pi", (0.1, 10.0)),
    "pi_reject": (0.1, 0.3, 1, 0.3, True, 1e4, "pi", (0.1, 10.0)),
    "matchstep_lands": (0.35, 0.2, 1, 1.0, False, 1e-3, "basic",
                        (0.1, 10.0)),
    "sliver_landing": (0.5 - 1e-12, 0.2, 1, 1.0, False, 1e-3, "basic",
                       (0.1, 10.0)),
    "done": (1.0, 0.2, 3, 1.0, False, 1e-3, "basic", (0.1, 10.0)),
}


@pytest.mark.parametrize("name", sorted(CORES))
def test_trial_step_core_matches_jax(name):
    t, dt, out_i, eprev, rejprev, c, controller, (lo, hi) = CORES[name]
    cfg_kw = dict(rtol=1e-4, atol=1e-6, dt_min_factor=lo, dt_max_factor=hi,
                  order=3, controller=controller)
    touts = np.array([0.0, 0.5, 1.0])
    y = np.array([1.0, -0.5])
    outs = np.stack([y, 2 * y, 3 * y])
    prm = {"a": -0.6, "c": c}
    expo = 1.0 / 4
    jcore = (jnp.asarray(t), jnp.asarray(y), jnp.asarray(dt),
             jnp.asarray(out_i), jnp.asarray(outs), jnp.asarray(2),
             jnp.asarray(1), jnp.asarray(7, jnp.int32), jnp.asarray(True),
             jnp.asarray(eprev), jnp.asarray(rejprev))
    jnew, jrec, _ = jad.trial_step_core(
        JStub(), {k: jnp.asarray(v) for k, v in prm.items()},
        jad.AdaptConfig(**cfg_kw), jnp.asarray(touts), 3, expo, jcore)
    T = np.float64
    tcore = (T(t), torch.from_numpy(y), T(dt), out_i,
             [torch.from_numpy(o) for o in outs], 2, 1, 7, True, T(eprev),
             rejprev)
    tnew, trec, _ = tad.trial_step_core(
        TStub(), {k: torch.tensor(v, dtype=torch.float64)
                  for k, v in prm.items()},
        tad.AdaptConfig(**cfg_kw), touts, 3, expo, tcore)
    # record: (t, dt_try, accept, out_slot)
    assert bool(jrec[2]) == trec[2] and int(jrec[3]) == trec[3]
    np.testing.assert_allclose([trec[0], trec[1]],
                               [float(jrec[0]), float(jrec[1])], rtol=1e-14)
    (jt, jy, jdt, joi, jouts, jacc, jrej, jnit, jconv, jep, jrp) = jnew
    (tt, ty, tdt, toi, touts_, tacc, trej, tnit, tconv, tep, trp) = tnew
    assert (int(joi), int(jacc), int(jrej), int(jnit), bool(jconv),
            bool(jrp)) == (toi, tacc, trej, tnit, tconv, trp)
    np.testing.assert_allclose([tt, tdt, tep],
                               [float(jt), float(jdt), float(jep)],
                               rtol=1e-14)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-14)
    np.testing.assert_allclose(np.stack([o.numpy() for o in touts_]),
                               np.asarray(jouts), rtol=1e-14)


@pytest.mark.parametrize("dtypes", [F64, F32], ids=["fp64", "fp32"])
def test_wrms_matches_jax(dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(0)
    err, y0, y1 = (rng.normal(size=(5, 7)).astype(np.dtype(jdt))
                   for _ in range(3))
    ref = float(jad._wrms(jnp.asarray(err), jnp.asarray(y0), jnp.asarray(y1),
                          1e-4, 1e-6))
    got = tad._wrms(torch.from_numpy(err), torch.from_numpy(y0),
                    torch.from_numpy(y1), 1e-4, 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(float(got), ref,
                               rtol=1e-14 if tdt == torch.float64 else 1e-6)


# -- solves through ODESolver, fp64 generic path -----------------------------

def _ark_pair(flags, f_ex_kind="square", a=-3.0, b=0.1, step=0.1,
              solver="torch"):
    """The scalar ARK problem f_IM = a y, f_EX = b y^2 (or b sin y) in both
    packages with the same flag tail."""
    def jf_ex(t, y, p):
        return p["b"] * (y ** 2 if f_ex_kind == "square" else jnp.sin(y))

    def tf_ex(t, y, p):
        return p["b"] * (y ** 2 if f_ex_kind == "square" else torch.sin(y))

    jp = ({"a": jnp.array(a)}, {"b": jnp.array(b)})
    tp = ({"a": torch.tensor(a, dtype=torch.float64)},
          {"b": torch.tensor(b, dtype=torch.float64)})
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + flags)
    jode = JODESolver()
    jode.setupTS(jnp.asarray(Y0), JFunc(lambda t, y, p: p["a"] * y, jp[0]),
                 step_size=step, method="imex", imex_form=True,
                 implicit_form=True, func2=JFunc(jf_ex, jp[1]),
                 linear_solver=solver)
    pt.clear_options()
    pt.init(["p"] + flags)
    tode = pt.ODESolver()
    tode.setupTS(torch.from_numpy(Y0), pt.Func(lambda t, y, p: p["a"] * y,
                                               tp[0]),
                 step_size=step, method="imex", imex_form=True,
                 implicit_form=True, func2=pt.Func(tf_ex, tp[1]),
                 linear_solver=solver)
    return jode, jp, tode, tp


def _assert_stats(st_t, st_j, dt_last_rtol=1e-10):
    assert (st_t.accepted, st_t.rejected, st_t.steps, st_t.newton_iters,
            st_t.completed, st_t.newton_converged) == (
        int(st_j.accepted), int(st_j.rejected), int(st_j.steps),
        int(st_j.newton_iters), bool(st_j.completed),
        bool(st_j.newton_converged))
    np.testing.assert_allclose(st_t.dt_first, float(st_j.dt_first),
                               rtol=1e-10)
    np.testing.assert_allclose(st_t.dt_last, float(st_j.dt_last),
                               rtol=dt_last_rtol)


@pytest.mark.parametrize("tab, tol, f_ex_kind, a, b", [
    ("3", "1e-7", "square", -3.0, 0.1),
    ("5", "1e-8", "sin", -4.0, 0.3),
], ids=["imex_ark3", "imex_ark5_embedded"])
def test_adaptive_imex_matches_jax(tab, tol, f_ex_kind, a, b):
    """Twins of test_adaptive_imex_ark3 and test_adaptive_imex_ark5_embedded
    (full Newton on the implicit stages, so newton_iters counts the
    reference's masked slots too)."""
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", tol, "-ts_atol", tol,
             "-ts_arkimex_type", tab]
    jode, jp, tode, tp = _ark_pair(flags, f_ex_kind, a, b)
    t = np.array([0.0, 1.0])
    sol_j, st_j = jode.solve(jnp.asarray(Y0), t, params=jp,
                             with_adjoint=False)
    sol_t, st_t = tode.solve(torch.from_numpy(Y0), t, params=tp,
                             with_adjoint=False)
    assert st_t.completed and st_t.rejected + st_t.accepted > 3
    _assert_stats(st_t, st_j)
    np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j), rtol=1e-10,
                               atol=1e-14)


def test_newton_iters_counts_the_masked_slots():
    """The reference adds every slot's Newton iterations, done or not: the
    port runs no slot after the landing and adds their count (ksponly: a
    constant per step; full Newton: one step from the landed state)."""
    for flags in ([], ["-snes_type", "ksponly"]):
        flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-6", "-ts_atol",
                 "1e-6", "-ts_adapt_max_steps", "40"] + flags
        jode, jp, tode, tp = _ark_pair(flags)
        t = np.array([0.0, 1.0])
        _, st_j = jode.solve(jnp.asarray(Y0), t, params=jp,
                             with_adjoint=False)
        _, st_t = tode.solve(torch.from_numpy(Y0), t, params=tp,
                             with_adjoint=False)
        assert st_t.steps < 40
        _assert_stats(st_t, st_j)


@pytest.mark.parametrize("flags", [
    ["-ts_adapt_type", "pi"],
    ["-ts_adapt_type", "basic", "-ts_adapt_clip", "0.5,1.05"],
    ["-ts_adapt_type", "pi", "-ts_adapt_clip", "0.3,2", "-ts_adapt_safety",
     "0.8"],
], ids=["pi", "basic_clip", "pi_clip_safety"])
def test_pi_controller_and_adapt_clip_match_jax(flags):
    jode, jp, tode, tp = _ark_pair(flags + ["-ts_rtol", "1e-7", "-ts_atol",
                                            "1e-9"])
    t = np.array([0.0, 1.0])
    sol_j, st_j = jode.solve(jnp.asarray(Y0), t, params=jp,
                             with_adjoint=False)
    sol_t, st_t = tode.solve(torch.from_numpy(Y0), t, params=tp,
                             with_adjoint=False)
    _assert_stats(st_t, st_j)
    np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j), rtol=1e-10)


def _grads(jode, jp, tode, tp, t, weights, flags=None):
    """d/d(params, y0) of sum_i w_i sum(sol[i]^2) in both packages."""
    def jloss(p, y0):
        sol, _ = jode.solve(y0, t, params=p)
        return sum(w * jnp.sum(sol[i] ** 2) for i, w in enumerate(weights))

    gj = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(Y0))
    if flags is not None:
        pt.clear_options()
        pt.init(["p"] + flags)
    tp_ = tuple({k: v.detach().clone().requires_grad_(True)
                 for k, v in d.items()} for d in tp)
    y0 = torch.from_numpy(Y0).requires_grad_(True)
    sol, _ = tode.solve(y0, t, params=tp_)
    sum(w * torch.sum(sol[i] ** 2) for i, w in enumerate(weights)).backward()
    gt = ((tp_[0]["a"].grad, tp_[1]["b"].grad), y0.grad)
    return ((float(gj[0][0]["a"]), float(gj[0][1]["b"])), np.asarray(gj[1])), \
        ((float(gt[0][0]), float(gt[0][1])), gt[1].numpy())


@pytest.mark.parametrize("solution_only", [False, True],
                         ids=["store_all", "solution_only"])
def test_gradients_three_outputs_match_jax(solution_only):
    """Three output times: the landing slots' cotangents are injected in
    reverse, before each landing step's transpose."""
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-7", "-ts_atol",
             "1e-7"]
    if solution_only:
        flags += ["-ts_trajectory_solution_only", "1"]
    jode, jp, tode, tp = _ark_pair(flags)
    (gpj, gyj), (gpt, gyt) = _grads(jode, jp, tode, tp,
                                    np.array([0.0, 0.3, 1.0]),
                                    (0.5, 2.0, 1.0))
    np.testing.assert_allclose(gpt, gpj, rtol=1e-10)
    np.testing.assert_allclose(gyt, gyj, rtol=1e-10)


def test_solution_only_equals_store_all():
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-6", "-ts_atol",
             "1e-6"]
    _, _, tode, tp = _ark_pair(flags)
    t = np.array([0.0, 0.4, 1.0])
    grads = []
    for solution_only in (0, 1):
        pt.set_option("ts_trajectory_solution_only", str(solution_only))
        tode.setupTS(torch.from_numpy(Y0), pt.Func(lambda t, y, p: p["a"] * y,
                                                   tp[0]),
                     step_size=0.1, method="imex", imex_form=True,
                     func2=pt.Func(lambda t, y, p: p["b"] * y ** 2, tp[1]),
                     linear_solver="torch")
        assert tode.traj.kind == ("solution_only" if solution_only
                                  else "store_all")
        y0 = torch.from_numpy(Y0).requires_grad_(True)
        prm = tuple({k: v.detach().clone().requires_grad_(True)
                     for k, v in d.items()} for d in tp)
        sol, _ = tode.solve(y0, t, params=prm)
        torch.sum(sol ** 2).backward()
        grads.append([y0.grad, prm[0]["a"].grad, prm[1]["b"].grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=0)


def test_dt_first_threaded_through_three_solves_matches_jax():
    """The training loop's warm start: each solve from the previous solve's
    dt_first (the first from an oversized dt0 that rejects)."""
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-6", "-ts_atol",
             "1e-6"]
    jode, jp, tode, tp = _ark_pair(flags, step=2.0)
    t = np.array([0.0, 1.0])
    dj = dt = None
    for k in range(3):
        sol_j, st_j = jode.solve(jnp.asarray(Y0), t, params=jp, dt0=dj)
        sol_t, st_t = tode.solve(torch.from_numpy(Y0), t, params=tp, dt0=dt)
        _assert_stats(st_t, st_j)
        assert st_t.rejected > 0 if k == 0 else st_t.rejected == 0
        np.testing.assert_allclose(sol_t.detach().numpy(), np.asarray(sol_j),
                                   rtol=1e-10)
        dj, dt = st_j.dt_first, st_t.dt_first
    assert tode.last_stats is st_t


# -- explicit RK under the controller (tests/test_adaptive.py) ---------------

P_DECAY = {"a": -0.6, "c": 0.3}


def _jf_decay(t, y, p):
    return p["a"] * y + jnp.sin(t) * p["c"]


def _tf_decay(t, y, p):
    return p["a"] * y + torch.sin(torch.as_tensor(t, dtype=y.dtype)) * p["c"]


def _decay_pair(flags, step, method, enable_adjoint=True):
    """tests/test_adaptive.py's f_decay problem in both packages, fp64."""
    jp = {k: jnp.array(v) for k, v in P_DECAY.items()}
    tp = {k: torch.tensor(v, dtype=torch.float64) for k, v in P_DECAY.items()}
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + flags)
    jode = JODESolver()
    jode.setupTS(jnp.asarray(Y0), JFunc(_jf_decay, jp), step_size=step,
                 method=method, enable_adjoint=enable_adjoint)
    pt.clear_options()
    pt.init(["p"] + flags)
    tode = pt.ODESolver()
    tode.setupTS(torch.from_numpy(Y0), pt.Func(_tf_decay, tp),
                 step_size=step, method=method, enable_adjoint=enable_adjoint)
    return jode, jp, tode, tp


def _exact(t_arr):
    """The reference's fine fixed-step dopri5 solution (JAX)."""
    pnode_tpu.clear_options()
    ode = JODESolver()
    ode.setupTS(jnp.asarray(Y0), JFunc(_jf_decay, {
        k: jnp.array(v) for k, v in P_DECAY.items()}), step_size=1e-3,
        method="dopri5", enable_adjoint=False)
    return np.asarray(ode.odeint(jnp.asarray(Y0), jnp.asarray(t_arr)))


# dt_last is the controller's proposal after the landing trial, a sliver
# whose error estimate at rtol 1e-8 and 1e-10 is within a few hundred ulps
# of fp64 rounding of the stage sums, raised to 1/(order+1): the two
# packages' proposals part by 2e-10 and 3e-9 there; nothing consumes it
DT_LAST_RTOL = 1e-7


def _tol_flags(tol):
    return ["-ts_adapt_type", "basic", "-ts_rtol", tol, "-ts_atol", tol]


def test_adaptive_forward_accuracy_and_landing_matches_jax():
    """Twin of test_adaptive_forward_accuracy_and_landing (:28)."""
    t = np.array([0.0, 0.7, 1.3, 2.0])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-8"), 0.05, "dopri5",
                                     enable_adjoint=False)
    sol_j, st_j = jode.solve(jnp.asarray(Y0), t, with_adjoint=False)
    sol, st = tode.solve(torch.from_numpy(Y0), t, with_adjoint=False)
    assert st.completed and st.accepted < 2.0 / 0.05
    np.testing.assert_allclose(sol.numpy(), _exact(t), rtol=1e-6, atol=1e-8)
    _assert_stats(st, st_j, DT_LAST_RTOL)
    np.testing.assert_allclose(sol.numpy(), np.asarray(sol_j), rtol=1e-10)


def test_adaptive_rejects_then_grows_matches_jax():
    """Twin of test_adaptive_rejects_then_grows (:43): bosh3 from dt 1.0
    rejects at least once and lands on the exact solution."""
    t = np.array([0.0, 2.0])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-10"), 1.0, "bosh3",
                                     enable_adjoint=False)
    sol_j, st_j = jode.solve(jnp.asarray(Y0), t, with_adjoint=False)
    sol, st = tode.solve(torch.from_numpy(Y0), t, with_adjoint=False)
    assert st.completed and st.rejected >= 1
    np.testing.assert_allclose(sol[-1].numpy(), _exact(t)[-1], rtol=1e-6,
                               atol=1e-7)
    _assert_stats(st, st_j, DT_LAST_RTOL)
    np.testing.assert_allclose(sol.numpy(), np.asarray(sol_j), rtol=1e-10)


def _decay_grads(tode, tp, t, y0=Y0):
    """d sum(sol[-1]^2) / d(a, c, y0) through the port's solve."""
    prm = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    y = torch.from_numpy(np.array(y0)).requires_grad_(True)
    sol = tode.solve(y, t, params=prm)[0]
    torch.sum(sol[-1] ** 2).backward()
    return np.array([float(prm["a"].grad), float(prm["c"].grad)]), \
        y.grad.numpy()


def _jax_decay_grads(jode, jp, t):
    def loss(p, y0):
        return jnp.sum(jode.solve(y0, jnp.asarray(t), params=p)[0][-1] ** 2)

    g = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(Y0))
    return np.array([float(g[0]["a"]), float(g[0]["c"])]), np.asarray(g[1])


def test_adaptive_adjoint_matches_fixed_step_gradient_and_jax():
    """Twin of test_adaptive_adjoint_matches_fixed_step_gradient (:56): the
    adaptive reverse against a fixed-step (0.005) discrete adjoint within
    1e-6, and against JAX's adaptive gradient within 1e-10."""
    t = np.array([0.0, 1.0])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-10"), 0.05, "dopri5")
    gp, gy = _decay_grads(tode, tp, t)
    jgp, jgy = _jax_decay_grads(jode, jp, t)
    np.testing.assert_allclose(gp, jgp, rtol=1e-10)
    np.testing.assert_allclose(gy, jgy, rtol=1e-10)
    pt.clear_options()
    fixed = pt.ODESolver()
    fixed.setupTS(torch.from_numpy(Y0), pt.Func(_tf_decay, tp),
                  step_size=0.005, method="dopri5")
    fp, fy = _decay_grads(fixed, tp, t)
    np.testing.assert_allclose(gp, fp, rtol=1e-6)
    np.testing.assert_allclose(gy, fy, rtol=1e-6)


def test_adaptive_adjoint_consistent_with_own_forward_fd():
    """Twin of test_adaptive_adjoint_consistent_with_own_forward_fd (:87):
    the gradient against central differences of the same adaptive solve
    (rel 1e-4, abs 1e-9), and against JAX's."""
    t = np.array([0.0, 1.0])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-9"), 0.05, "dopri5")
    gp, _ = _decay_grads(tode, tp, t)
    np.testing.assert_allclose(gp, _jax_decay_grads(jode, jp, t)[0],
                               rtol=1e-10)
    eps = 1e-6

    def loss(prm):
        sol = tode.solve(torch.from_numpy(Y0), t, params=prm,
                         with_adjoint=False)[0]
        return float(torch.sum(sol[-1] ** 2))

    for i, k in enumerate(("a", "c")):
        up = dict(tp, **{k: tp[k] + eps})
        dn = dict(tp, **{k: tp[k] - eps})
        fd = (loss(up) - loss(dn)) / (2 * eps)
        assert gp[i] == pytest.approx(fd, rel=1e-4, abs=1e-9)


def test_adaptive_dt_warm_start_matches_jax():
    """Twin of test_adaptive_dt_warm_start (:451): from an oversized dt0
    the cold solve rejects; restarting from its dt_last rejects no more and
    from its dt_first not at all, all three landing on the cold solution;
    the warm-started gradient within 1e-4 of the cold one. Each solve's
    stats and solution equal JAX's."""
    t = np.array([0.0, 1.0])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-6"), 5.0, "dopri5")
    y0t, y0j = torch.from_numpy(Y0), jnp.asarray(Y0)
    sol_c, st_c = tode.solve(y0t, t, params=tp)
    sol_w, st_w = tode.solve(y0t, t, params=tp, dt0=st_c.dt_last)
    sol_f, st_f = tode.solve(y0t, t, params=tp, dt0=st_c.dt_first)
    assert st_c.completed and st_w.completed and st_f.completed
    assert st_w.rejected <= st_c.rejected and st_f.rejected == 0
    assert st_c.dt_first > 0.0 and st_w.dt_last > 0.0
    for sol in (sol_w, sol_f):
        np.testing.assert_allclose(sol[-1].detach().numpy(),
                                   sol_c[-1].detach().numpy(), rtol=1e-5)
    sj_c, stj_c = jode.solve(y0j, t, params=jp)
    for (sol, st), dt0 in (((sol_c, st_c), None), ((sol_w, st_w), "last"),
                           ((sol_f, st_f), "first")):
        d0 = None if dt0 is None else getattr(stj_c, "dt_" + dt0)
        sj, stj = jode.solve(y0j, t, params=jp, dt0=d0)
        _assert_stats(st, stj)
        np.testing.assert_allclose(sol.detach().numpy(), np.asarray(sj),
                                   rtol=1e-10)
    prm = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    sol = tode.solve(y0t, t, params=prm, dt0=st_c.dt_last)[0]
    torch.sum(sol[-1] ** 2).backward()
    g_ref, _ = _decay_grads(tode, tp, t)
    np.testing.assert_allclose([float(prm["a"].grad), float(prm["c"].grad)],
                               g_ref, rtol=1e-4)


def test_adaptive_no_growth_after_rejection_matches_jax():
    """Twin of test_adaptive_no_growth_after_rejection (:491): bosh3 from
    dt 50 reaches the working dt in at most 6 rejections, as JAX does."""
    t = np.array([0.0, 0.5])
    jode, jp, tode, tp = _decay_pair(_tol_flags("1e-7"), 50.0, "bosh3")
    _, st = tode.solve(torch.from_numpy(Y0), t, params=tp)
    _, st_j = jode.solve(jnp.asarray(Y0), t, params=jp)
    assert st.completed and st.rejected <= 6
    _assert_stats(st, st_j)


# -- the KS fused route ------------------------------------------------------

def _ks_pair(dtypes):
    flags = ["-snes_type", "ksponly", "-ts_adapt_type", "basic", "-ts_rtol",
             "1e-4", "-ts_atol", "1e-6"]
    p = Pair(4, 16, 24, dtypes, flags=flags, fused_mode="off", w_scale=0.0)
    # JAX keeps its generic route; the port's route is chosen per solve by
    # the programmatic -pnode_fused_ark_adjoint, which a command-line value
    # would override
    pt.clear_options()
    pt.init(["p", "-ts_arkimex_type", "3"] + flags)
    return p


def _ks_value_and_grads(p, fused, t_out):
    y = (np.random.default_rng(3).normal(size=(4, 16)) * 0.1).astype(
        np.dtype(p.jdt))
    pt.set_option("pnode_fused_ark_adjoint", "auto" if fused else "off")
    for q in p.ex.parameters():
        q.grad = None
    pred, st = p.ode.solve(torch.from_numpy(y), t_out)
    loss = torch.sum(pred[-1] ** 2)
    loss.backward()
    grads = p.tleaves(({}, {k: v.grad for k, v in p.ex.named_parameters()}))

    def jl(prm):
        pred_j, st_j = p.jode.solve(jnp.asarray(y), t_out, params=prm)
        return jnp.sum(pred_j[-1] ** 2), st_j

    (lj, st_j), gj = jax.value_and_grad(jl, has_aux=True)(p.jparams)
    return (float(loss.detach()), grads, st), (float(lj), p.jleaves(gj), st_j)


def test_adaptive_fused_path_matches_generic_fp64():
    """fp64 never opens the fused gate (fp32 states only): the port's
    generic adaptive path against JAX's."""
    p = _ks_pair(F64)
    t_out = np.array([0.0, 0.4])
    (lt, gt, st), (lj, gj, st_j) = _ks_value_and_grads(p, True, t_out)
    _assert_stats(st, st_j)
    np.testing.assert_allclose(lt, lj, rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_adaptive_fused_path_matches_generic_fp32():
    """Twin of test_adaptive_fused_path_matches_generic: the port's fused
    route (K2 with err + K3, plain versions) against the port's generic
    route, and both against JAX's generic route, on value and gradients
    (the reference's loss rtol 1e-5, gradients rtol 5e-4 / atol 1e-6; the
    accept decisions equal)."""
    p = _ks_pair(F32)
    t_out = np.array([0.0, 0.4])
    stp = p.ode._stepper.prepare(0.0, torch.zeros(4, 16), p.tparams, dt0=None)
    pt.set_option("pnode_fused_ark_adjoint", "auto")
    assert stp._fused_reverse_args(p.tparams, dt=0.05) is not None
    assert stp._spectral_stage_basis(stp.setup.frozen_J_blocks[0]) is not None
    (lf, gf, stf), (lj, gj, st_j) = _ks_value_and_grads(p, True, t_out)
    (lg, gg, stg), _ = _ks_value_and_grads(p, False, t_out)
    for st in (stf, stg):
        assert (st.accepted, st.rejected, st.completed) == (
            int(st_j.accepted), int(st_j.rejected), bool(st_j.completed))
    for loss, grads in ((lf, gf), (lg, gg)):
        np.testing.assert_allclose(loss, lj, rtol=1e-5)
        for a, b in zip(grads, gj):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(lf, lg, rtol=1e-5)
    for a, b in zip(gf, gg):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_spectral_stage_inverse_matches_the_direct_inverse():
    p = _ks_pair(F64)
    stp = p.ode._stepper.prepare(0.0, torch.zeros(4, 16, dtype=torch.float64),
                                 p.tparams, dt0=None)
    J = stp.setup.frozen_J_blocks[0]
    gamma = 0.435866521508459
    inv = stp._trial_inverse(J, gamma, 0.0371)
    ref = torch.linalg.inv(torch.eye(16, dtype=J.dtype) - 0.0371 * gamma * J)
    torch.testing.assert_close(inv, ref, rtol=1e-10, atol=1e-12)
    # memoized per frozen J, across the copies prepare() makes
    basis = stp._spectral_stage_basis(J)
    stp2 = p.ode._stepper.prepare(0.0, torch.zeros(4, 16, dtype=J.dtype),
                                  p.tparams, dt0=None)
    assert stp2._spectral_stage_basis(J) is basis


# -- the policies the adaptive mode refused until slice 5(b) -----------------

@pytest.mark.parametrize("kind", ["checkpoint", "revolve", "cams", "disk"])
def test_slice5_policies_raise(kind, tmp_path):
    """These four policies raised NotImplementedError until slice 5(b);
    now each runs the adaptive dopri5 solve of the decay problem and its
    gradients equal store_all's bit for bit (the case keeps its name)."""
    from pnode_tpu_torch.steppers import ExplicitRK
    from pnode_tpu_torch.tableaus import get_rk_tableau

    pt.set_option("ts_trajectory_dirname", str(tmp_path))
    stepper = ExplicitRK(get_rk_tableau("dopri5"), _tf_decay)
    cfg = tad.AdaptConfig(rtol=1e-7, atol=1e-7, max_steps=64)
    grads = {}
    for k in ("store_all", kind):
        solve = tad.make_adaptive_odeint(
            stepper, np.array([0.0, 0.5, 1.0]), cfg, 0.05,
            traj=pt.TrajectoryConfig(kind=k, max_cps=3))
        prm = {n: torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for n, v in P_DECAY.items()}
        y = torch.from_numpy(Y0.copy()).requires_grad_(True)
        torch.sum(solve(y, prm)[0] ** 2).backward()
        grads[k] = [prm["a"].grad, prm["c"].grad, y.grad]
    for a, b in zip(grads[kind], grads["store_all"]):
        assert torch.equal(a, b)
    assert not list(tmp_path.iterdir())  # the disk rows were removed


def test_dt0_outside_adaptive_mode_raises():
    _, _, tode, tp = _ark_pair([])
    with pytest.raises(ValueError, match="adaptive-mode argument"):
        tode.solve(torch.from_numpy(Y0), np.array([0.0, 1.0]), params=tp,
                   dt0=0.1)


def test_tableau_without_embedded_pair_raises():
    _, _, tode, tp = _ark_pair(["-ts_adapt_type", "basic",
                                "-ts_arkimex_type", "ars122"])
    with pytest.raises(ValueError, match="no embedded weights"):
        tode.solve(torch.from_numpy(Y0), np.array([0.0, 1.0]), params=tp)
