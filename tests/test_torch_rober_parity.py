"""ROBER stiff-ODE parity on the port: twins of tests/test_rober_parity.py.

The ROBER problem with perturbed rate constants on the reference's
log-spaced grid, one step per output interval, against the same scipy BDF
ground truth and the reference's asserted losses, with the discrete-adjoint
gradients asserted against central finite differences of the loss
(rel 5e-5), as the JAX suite does; the CN run also against the JAX
package's loss and gradients in fp64 (1e-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu_torch.misc import tree_leaves

torch.set_num_threads(1)

endtime = 1.1e-3
t = np.concatenate([[0.0], np.logspace(-5, -3, 3)])
step_size = list(np.diff(t))


def _fun(tt, s):
    k1, k2, k3 = 0.04, 3e7, 1e4
    return np.array([-k1 * s[0] + k3 * s[1] * s[2],
                     k1 * s[0] - k3 * s[1] * s[2] - k2 * s[1] ** 2,
                     k2 * s[1] ** 2])


def _jac(tt, s):
    k1, k2, k3 = 0.04, 3e7, 1e4
    return np.array([[-k1, k3 * s[2], k3 * s[1]],
                     [k1, -2.0 * k2 * s[1] - k3 * s[2], -k3 * s[1]],
                     [0, 2.0 * k2 * s[1], 0]])


TRUE_Y = solve_ivp(fun=_fun, jac=_jac, t_span=[0, endtime],
                   y0=np.array([1.0, 0.0, 0.0]), t_eval=t, method="BDF",
                   rtol=1e-11, atol=1e-14)["y"].T
true_y = torch.tensor(TRUE_Y)
true_y0 = true_y[0]


def rober(tt, y, p):
    k1, k2, k3 = p["k"][0], p["k"][1], p["k"][2]
    f1 = -k1 * y[0] + k3 * y[1] * y[2]
    f2 = k1 * y[0] - k3 * y[1] * y[2] - k2 * y[1] ** 2
    f3 = k2 * y[1] ** 2
    return torch.stack([f1, f2, f3], -1)


def rober_j(tt, y, p):
    k1, k2, k3 = p["k"][0], p["k"][1], p["k"][2]
    f1 = -k1 * y[0] + k3 * y[1] * y[2]
    f2 = k1 * y[0] - k3 * y[1] * y[2] - k2 * y[1] ** 2
    f3 = k2 * y[1] ** 2
    return jnp.stack([f1, f2, f3], -1)


def rober_im(tt, y, p):
    k1, k3 = p["k1"][0], p["k3"][0]
    f1 = -k1 * y[0] + k3 * y[1] * y[2]
    f2 = k1 * y[0] - k3 * y[1] * y[2]
    return torch.stack([f1, f2, torch.zeros_like(f1)], -1)


def rober_ex(tt, y, p):
    f2 = -p["k2"][0] * y[1] ** 2
    return torch.stack([torch.zeros_like(f2), f2, -f2], -1)


def p_full():
    return {"k": torch.tensor([0.05, 4e7, 2e4], dtype=torch.float64)}


def p_im():
    return {"k1": torch.tensor([0.05], dtype=torch.float64),
            "k3": torch.tensor([2e4], dtype=torch.float64)}


def p_ex():
    return {"k2": torch.tensor([4e7], dtype=torch.float64)}


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def _mae(pred):
    return torch.mean(torch.abs(pred - true_y))


def _loss_and_grads(ode, params):
    """The loss and the adjoint's gradients (params, y0) of mean |pred -
    true_y|."""
    leaves = [v.requires_grad_(True) for v in tree_leaves(params)]
    y0 = true_y0.clone().requires_grad_(True)
    loss = _mae(ode.odeint_adjoint(y0, t, params=params))
    loss.backward()
    return (float(loss.detach()), [v.grad.clone() for v in leaves],
            y0.grad.clone())


def _fd_check(loss_fn, params, grads, keys, rel=5e-5):
    """Central finite differences on each scalar entry of each key."""
    for key, g in zip(keys, grads):
        base = params[key].detach().numpy()
        for idx in np.ndindex(base.shape):
            eps = max(abs(base[idx]), 1.0) * 3e-7
            pp = {k: v.detach().clone() for k, v in params.items()}
            pm = {k: v.detach().clone() for k, v in params.items()}
            pp[key][idx] += eps
            pm[key][idx] -= eps
            with torch.no_grad():
                fd = (float(loss_fn(pp)) - float(loss_fn(pm))) / (2 * eps)
            assert float(g[idx]) == pytest.approx(fd, rel=rel, abs=1e-13), \
                (key, idx)


def _cn_ode(solver="petsc"):
    return pt.ODESolver().setupTS(true_y0, pt.Func(rober, p_full()),
                                  step_size=step_size, method="cn",
                                  enable_adjoint=True, implicit_form=True,
                                  linear_solver=solver, batch_size=1)


def test_implicit_odesolver_cn():
    """Twin of :115: CN with matrix-free GMRES stage solves, the reference's
    loss 1.85e-6 +- 1e-6 and std 3.36e-6 +- 1e-6, gradients against finite
    differences and against the JAX package's in fp64."""
    ode = _cn_ode()
    params = p_full()
    loss, (gk,), _ = _loss_and_grads(ode, params)
    with torch.no_grad():
        std = torch.std(torch.abs(ode.odeint_adjoint(true_y0, t) - true_y),
                        unbiased=False)
    assert loss == pytest.approx(1.85e-6, abs=1e-6)
    assert float(std) == pytest.approx(3.36e-6, abs=1e-6)
    _fd_check(lambda p: _mae(ode.odeint_adjoint(true_y0, t, params=p)),
              params, [gk], ["k"])

    jode = JODESolver()
    jode.setupTS(jnp.asarray(TRUE_Y[0]),
                 JFunc(rober_j, {"k": jnp.array([0.05, 4e7, 2e4])}),
                 step_size=step_size, method="cn", enable_adjoint=True,
                 implicit_form=True)

    def jloss(p, y0):
        return jnp.mean(jnp.abs(jode.odeint_adjoint(y0, jnp.asarray(t),
                                                    params=p)
                                - jnp.asarray(TRUE_Y)))

    # the rate gradients only: at y0 the loss sits on |0|'s kink, where
    # jax.numpy's abs takes the derivative +1 and torch's 0
    jl, jgp = jax.value_and_grad(jloss)(
        {"k": jnp.array([0.05, 4e7, 2e4])}, jnp.asarray(TRUE_Y[0]))
    assert loss == pytest.approx(float(jl), rel=1e-8)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jgp["k"]), rtol=1e-8)


def test_imex_odesolver():
    """Twin of :139: the ARK IMEX split with GMRES stage solves, loss 3.11e-6
    +- 3e-6, both partitions' gradients against finite differences."""
    ode = pt.ODESolver().setupTS(
        true_y0, pt.Func(rober_im, p_im()), step_size=step_size,
        method="imex", enable_adjoint=True, implicit_form=True,
        imex_form=True, func2=pt.Func(rober_ex, p_ex()))
    pi, pe = p_im(), p_ex()
    loss, (g1, g3, g2), _ = _loss_and_grads(ode, (pi, pe))
    assert loss == pytest.approx(3.11e-6, abs=3e-6)
    _fd_check(lambda p: _mae(ode.odeint_adjoint(true_y0, t,
                                                params=(p, p_ex()))),
              pi, [g1, g3], ["k1", "k3"])
    _fd_check(lambda p: _mae(ode.odeint_adjoint(true_y0, t,
                                                params=(p_im(), p))),
              pe, [g2], ["k2"])


def test_explicit_odesolver_default_rk():
    """Twin of :169: "rk3" falls through to 3bs with a warning; loss
    1.85e-6 +- 1e-6, std 3.21e-6 +- 1e-6, gradients against finite
    differences."""
    ode = pt.ODESolver()
    with pytest.warns(UserWarning, match="unknown explicit method"):
        ode.setupTS(true_y0, pt.Func(rober, p_full()), step_size=step_size,
                    method="rk3", enable_adjoint=True)
    params = p_full()
    loss, (gk,), _ = _loss_and_grads(ode, params)
    with torch.no_grad():
        std = torch.std(torch.abs(ode.odeint_adjoint(true_y0, t) - true_y),
                        unbiased=False)
    assert loss == pytest.approx(1.85e-6, abs=1e-6)
    assert float(std) == pytest.approx(3.21e-6, abs=1e-6)
    _fd_check(lambda p: _mae(ode.odeint_adjoint(true_y0, t, params=p)),
              params, [gk], ["k"])


def test_adjoint_matches_autodiff_through_solver():
    """Twin of :194: the discrete adjoint equals plain autograd through the
    solve without the adjoint (rk4), which is differentiable."""
    ode = pt.ODESolver().setupTS(true_y0, pt.Func(rober, p_full()),
                                 step_size=step_size, method="rk4")
    _, (g_adj,), gy_adj = _loss_and_grads(ode, p_full())
    p = p_full()
    p["k"].requires_grad_(True)
    y0 = true_y0.clone().requires_grad_(True)
    pred, _ = ode.solve(y0, t, params=p, with_adjoint=False)
    assert pred.requires_grad
    _mae(pred).backward()
    np.testing.assert_allclose(g_adj.numpy(), p["k"].grad.numpy(), rtol=1e-8)
    np.testing.assert_allclose(gy_adj.numpy(), y0.grad.numpy(), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("solver", ["petsc", "torch", "hpddm"])
def test_linear_solver_strategies_agree(solver):
    """Twin of :217: the GMRES, direct and block stage solvers give the same
    CN solution (loss 1.85e-6 +- 1.5e-6)."""
    sol, _ = _cn_ode(solver).solve(true_y0, t, with_adjoint=False)
    assert float(_mae(sol)) == pytest.approx(1.85e-6, abs=1.5e-6)


def test_trajectory_policies_gradients_identical():
    """Twin of :236: store_all, solution_only and checkpoint(2) give the
    same CN gradients (rtol 1e-10)."""
    grads = {}
    for flags, name in [([], "store_all"),
                        (["-ts_trajectory_solution_only", "1"],
                         "solution_only"),
                        (["-ts_trajectory_max_cps_ram", "2"], "checkpoint")]:
        pt.clear_options()
        pt.init(["prog"] + flags)
        ode = pt.ODESolver().setupTS(true_y0, pt.Func(rober, p_full()),
                                     step_size=step_size, method="cn",
                                     implicit_form=True)
        assert ode.traj.kind == name
        _, (gk,), _ = _loss_and_grads(ode, p_full())
        grads[name] = gk.numpy()
    np.testing.assert_allclose(grads["store_all"], grads["solution_only"],
                               rtol=1e-10)
    np.testing.assert_allclose(grads["store_all"], grads["checkpoint"],
                               rtol=1e-10)


def test_single_time_point():
    """Twin of :263: a one-element t integrates [0, t0] and returns one
    state."""
    ode = pt.ODESolver().setupTS(true_y0, pt.Func(rober, p_full()),
                                 step_size=1e-5, method="rk4")
    sol = ode.odeint(true_y0, np.array([1e-4]))
    assert sol.shape == (1, 3)
    ode2 = pt.ODESolver().setupTS(true_y0, pt.Func(rober, p_full()),
                                  step_size=1e-5, method="rk4")
    sol2 = ode2.odeint(true_y0, np.array([0.0, 1e-4]))
    np.testing.assert_allclose(sol[0].detach().numpy(),
                               sol2[1].detach().numpy(), rtol=1e-12)
