"""The adaptive path's trajectory policies (checkpoint, revolve, CAMS,
disk; ``pnode_tpu_torch/adaptive.py``) against store_all and against the
JAX package: twins of tests/test_adaptive.py:279-293 (here the dopri5 half
and CN's solution_only and checkpoint; CN's revolve and CAMS are in
tests/test_torch_adaptive_plans.py), :296-330, :333-379, :409-435 and
:439-448, in fp64 on the CPU.

- Every policy's gradients equal store_all's bit for bit (the reference
  holds them at rtol 1e-10) and the JAX package's under the same flags at
  rtol 1e-10.
- What the forward keeps (``solve.forward_for_test``): scalars only for
  revolve, the reached segments' start states for checkpoint, at most (c +
  2) x state x (1 + stages) for CAMS.
- The reverse allocates no tensor of shape (max_steps,) + y0.shape (a
  ``TorchDispatchMode`` records every output shape).
- The re-steps on the trial axis are the plans' costs over the accepted
  trials: a rejected trial is walked past and computes nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu_torch import cams, revolve
from pnode_tpu_torch.adaptive import AdaptConfig, make_adaptive_odeint
from pnode_tpu_torch.steppers import ExplicitRK
from pnode_tpu_torch.tableaus import get_rk_tableau

torch.set_num_threads(1)
P = {"a": -0.6, "c": 0.3}
Y0 = np.array([1.0, -0.5])
ADAPT = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-7", "-ts_atol", "1e-7"]
POLICIES = {
    "solution_only": ["-ts_trajectory_solution_only", "1"],
    "checkpoint": ["-ts_trajectory_max_cps_ram", "4"],
    "revolve": ["-ts_trajectory_max_cps_ram", "4",
                "-ts_trajectory_schedule", "revolve"],
    "cams": ["-ts_trajectory_max_cps_ram", "4",
             "-ts_trajectory_schedule", "cams"],
}


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _tf(t, y, p):
    return p["a"] * y + torch.sin(torch.as_tensor(t, dtype=y.dtype)) * p["c"]


def _jf(t, y, p):
    return p["a"] * y + jnp.sin(t) * p["c"]


def port_grads(flags, method="cn", implicit=True, n_t=3):
    """(dL/da, dL/dc, dL/dy0) of sum(sol^2) through the port's adaptive
    solve under the flag tail (test_adaptive.py's _adaptive_grads)."""
    pt.clear_options()
    pt.init(["p"] + ADAPT + flags)
    prm = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in P.items()}
    y = torch.from_numpy(Y0.copy()).requires_grad_(True)
    ode = pt.ODESolver().setupTS(y.detach(), pt.Func(_tf, prm),
                                 step_size=0.05, method=method,
                                 implicit_form=implicit)
    sol, _ = ode.solve(y, np.linspace(0.0, 1.0, n_t), params=prm,
                       with_adjoint=True)
    (sol ** 2).sum().backward()
    return [prm["a"].grad, prm["c"].grad, y.grad]


def jax_grads(flags, method="cn", implicit=True, n_t=3):
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + ADAPT + flags)
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    ode = JODESolver()
    ode.setupTS(jnp.asarray(Y0), JFunc(_jf, jp), step_size=0.05,
                method=method, implicit_form=implicit, enable_adjoint=True)
    t = jnp.linspace(0.0, 1.0, n_t)

    def loss(p, y0):
        sol, _ = ode.solve(y0, t, params=p, with_adjoint=True)
        return jnp.sum(sol ** 2)

    gp, gy = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(Y0))
    return [np.asarray(gp["a"]), np.asarray(gp["c"]), np.asarray(gy)]


_REF = {}


def store_all_ref(method, implicit):
    """The port's store_all gradients, once per method in a worker."""
    if method not in _REF:
        _REF[method] = port_grads([], method, implicit)
    return _REF[method]


def check_policy(policy, method, implicit, flags=None):
    """The policy's gradients bit for bit store_all's, and the JAX
    package's under the same flags at rtol 1e-10 (atol 1e-12, as the
    reference holds store_all's)."""
    flags = POLICIES[policy] if flags is None else flags
    got = port_grads(flags, method, implicit)
    for a, b in zip(got, store_all_ref(method, implicit)):
        assert torch.equal(a, b), policy
    for a, b in zip(got, jax_grads(flags, method, implicit)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("policy,method,implicit", [
    ("solution_only", "dopri5", False), ("checkpoint", "dopri5", False),
    ("revolve", "dopri5", False), ("cams", "dopri5", False),
    ("solution_only", "cn", True), ("checkpoint", "cn", True),
])
def test_adaptive_policy_gradients_match_store_all(policy, method, implicit):
    """Twin of test_adaptive.py:286 (with tests/test_torch_adaptive_plans.py
    for CN's revolve and CAMS)."""
    check_policy(policy, method, implicit)


@pytest.mark.parametrize("sched", ["uniform", "revolve", "cams"])
def test_adaptive_policy_gradients_match_store_all_ark(sched):
    """Twin of test_adaptive.py:296: the same on ARK IMEX (implicit
    a*y, explicit b*y^2, the direct stage solver on both sides), the
    loss on the final state: store_all's bit for bit, JAX's at 1e-10."""
    def grads(flags, jax_side):
        t = np.array([0.0, 1.0])
        setup = dict(step_size=0.1, method="imex", imex_form=True,
                     implicit_form=True, enable_adjoint=True)
        if jax_side:
            pnode_tpu.clear_options()
            pnode_tpu.init(["p"] + ADAPT + flags)
            jp = ({"a": jnp.array(-3.0)}, {"b": jnp.array(0.1)})
            ode = JODESolver()
            ode.setupTS(jnp.asarray(Y0), JFunc(lambda t, y, p: p["a"] * y,
                                               jp[0]),
                        func2=JFunc(lambda t, y, p: p["b"] * y ** 2, jp[1]),
                        **setup)

            def loss(p, y0):
                sol, _ = ode.solve(y0, jnp.asarray(t), params=p)
                return jnp.sum(sol[-1] ** 2)

            (gi, ge), gy = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(Y0))
            return [np.asarray(gi["a"]), np.asarray(ge["b"]), np.asarray(gy)]
        pt.clear_options()
        pt.init(["p"] + ADAPT + flags)
        tp = ({"a": torch.tensor(-3.0, dtype=torch.float64,
                                 requires_grad=True)},
              {"b": torch.tensor(0.1, dtype=torch.float64,
                                 requires_grad=True)})
        y = torch.from_numpy(Y0.copy()).requires_grad_(True)
        ode = pt.ODESolver().setupTS(
            y.detach(), pt.Func(lambda t, y, p: p["a"] * y, tp[0]),
            func2=pt.Func(lambda t, y, p: p["b"] * y ** 2, tp[1]), **setup)
        sol, _ = ode.solve(y, t, params=tp)
        (sol[-1] ** 2).sum().backward()
        return [tp[0]["a"].grad, tp[1]["b"].grad, y.grad]

    flags = ["-ts_trajectory_max_cps_ram", "4"]
    if sched != "uniform":
        flags += ["-ts_trajectory_schedule", sched]
    got, ref = grads(flags, False), grads([], False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for a, b in zip(got, grads(flags, True)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12)


# -- what the forward keeps, what the reverse allocates -----------------------

def _solver(kind, max_cps=4):
    stepper = ExplicitRK(get_rk_tableau("dopri5"), lambda t, y, p: p["a"] * y)
    cfg = AdaptConfig(rtol=1e-6, atol=1e-6, max_steps=256)
    return stepper, make_adaptive_odeint(
        stepper, np.array([0.0, 1.0]), cfg, 0.05, with_adjoint=True,
        traj=pt.TrajectoryConfig(kind=kind, max_cps=max_cps))


def _elements(tree):
    if isinstance(tree, torch.Tensor):
        return int(tree.numel())
    if isinstance(tree, dict):
        return sum(_elements(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_elements(v) for v in tree)
    return 0


def test_adaptive_policy_trajectory_memory_shapes():
    """Twin of test_adaptive.py:333: the per-trial record is scalars
    (O(trials), never a tensor); states appear only where the policy keeps
    them: store_all each accepted trial's state and stage set, revolve
    nothing, checkpoint one state per reached segment (at most c), CAMS at
    most (c + 2) x state x (1 + stages) elements."""
    params = {"a": torch.tensor(-0.5, dtype=torch.float64)}
    y0 = torch.ones((8, 4), dtype=torch.float64)
    state, stages = y0.numel(), 7
    kept = {}
    for kind in ("store_all", "revolve", "checkpoint", "cams"):
        _, solve = _solver(kind)
        _, stats, trials = solve.forward_for_test(y0, params)
        n = stats.steps
        for rec in (trials.t, trials.dt, trials.acc, trials.slot):
            assert len(rec) == n
            assert not any(isinstance(x, torch.Tensor) for x in rec)
        kept[kind] = (_elements(trials.store), stats)
    n_acc = kept["store_all"][1].accepted
    assert 0 < n_acc < 256
    assert kept["store_all"][0] == n_acc * state * (1 + stages)
    assert kept["revolve"][0] == 0
    seg_len = 256 // 4
    assert kept["checkpoint"][0] == -(-kept["checkpoint"][1].steps
                                      // seg_len) * state <= 4 * state
    # (the plan's stores at slots past the last trial are never made)
    assert kept["cams"][0] <= (4 + 2) * state * (1 + stages)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.add(tuple(o.shape))
        return out


def test_adaptive_revolve_backward_never_materializes_forcing():
    """Twin of test_adaptive.py:409: the reverse gathers each trial's
    output cotangent as it goes; no tensor of shape (max_steps,) +
    y0.shape (the forcing array that would defeat the low-memory
    policies) is ever allocated, under revolve or CAMS."""
    params = {"a": torch.tensor(-0.5, dtype=torch.float64,
                                requires_grad=True)}
    for kind in ("revolve", "cams"):
        _, solve = _solver(kind)
        y0 = torch.ones((8, 4), dtype=torch.float64, requires_grad=True)
        out, _ = solve(y0, params)
        loss = (out[-1] ** 2).sum()
        with _Shapes() as rec:
            loss.backward()
        assert (256, 8, 4) not in rec.shapes, kind
        assert torch.isfinite(y0.grad).all()


def test_adaptive_policies_via_solver_flags_disk(tmp_path):
    """Twin of test_adaptive.py:439: -ts_trajectory_type disk streams the
    adaptive trial trajectory (CN) to a memmap under
    -ts_trajectory_dirname: store_all's gradients bit for bit, JAX's at
    1e-10; the memmap is removed once the reverse has read it."""
    check_policy(None, "cn", True, flags=[
        "-ts_trajectory_type", "disk", "-ts_trajectory_dirname",
        str(tmp_path)])
    assert not list(tmp_path.glob("pnode_hostdisk_*"))


# -- the work on the trial axis -----------------------------------------------

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


def gated_cams_cost(plan_rev, live):
    """(re-steps, recomputes) of CAMS's reverse plan when only the live
    slots compute: ADVANCE and CAPTURE step the live slots they pass,
    REVERSE recomputes a live slot's stages inside step_adj."""
    alive = lambda k: k < len(live) and live[k]  # noqa: E731
    resteps = inner = node = 0
    for op, k in plan_rev:
        if op == cams.RESTORE:
            node = k
        elif op == cams.ADVANCE:
            resteps += sum(1 for j in range(node, k) if alive(j))
            node = k
        elif op == cams.CAPTURE:
            resteps += alive(k)
            node = k + 1
        elif op == cams.REVERSE:
            inner += alive(k)
    return resteps, inner


@pytest.mark.parametrize("kind", ["store_all", "solution_only", "checkpoint",
                                  "revolve", "cams", "disk"])
def test_trial_axis_resteps_equal_plan_costs(kind, tmp_path):
    """dopri5 at a cold dt0 (rejections at the start) over 64 trial slots,
    c 3: after the forward's trials, the re-steps and stage recomputes are
    what each plan costs over the accepted trials (revolve plans over
    them: optimal_cost(n_acc, c)); store_all's gradients bit for bit."""
    pt.set_option("ts_trajectory_dirname", str(tmp_path))
    cfg = AdaptConfig(rtol=1e-8, atol=1e-8, max_steps=64)
    f = lambda t, y, p: p["a"] * y + p["b"] * torch.tanh(y)  # noqa: E731
    out = {}
    for k in ("store_all", kind):
        stepper = ExplicitRK(get_rk_tableau("dopri5"), f)
        cnt = _Counter(stepper)
        solve = make_adaptive_odeint(
            stepper, np.array([0.0, 0.5, 1.0]), cfg, 1.0,
            traj=pt.TrajectoryConfig(kind=k, max_cps=3))
        prm = {"a": torch.tensor(-0.7, dtype=torch.float64,
                                 requires_grad=True),
               "b": torch.tensor(0.4, dtype=torch.float64,
                                 requires_grad=True)}
        y0 = torch.tensor([1.0, -0.3, 0.5], dtype=torch.float64,
                          requires_grad=True)
        sol, stats = solve(y0, prm)
        (sol ** 2).sum().backward()
        out[k] = ([prm["a"].grad, prm["b"].grad, y0.grad],
                  cnt.steps - stats.steps, cnt.inner, stats)
    grads, resteps, inner, stats = out[kind]
    assert stats.rejected >= 1 and stats.completed
    for a, b in zip(grads, out["store_all"][0]):
        assert torch.equal(a, b)
    n = stats.accepted
    if kind == "cams":
        _, _, trials = solve.forward_for_test(
            torch.tensor([1.0, -0.3, 0.5], dtype=torch.float64),
            {"a": torch.tensor(-0.7, dtype=torch.float64),
             "b": torch.tensor(0.4, dtype=torch.float64)})
        w = cams.stage_weight(7 * 3, 3)
        _, plan_rev = cams.cams_plan(64, 3, w)
        expect = gated_cams_cost(plan_rev, trials.acc)
    else:
        expect = {"store_all": (0, 0), "solution_only": (0, n),
                  "checkpoint": (n, 0), "disk": (0, n),
                  "revolve": (revolve.optimal_cost(n, 3), n)}[kind]
    assert (resteps, inner) == expect
