"""The port's theta adjoint against autograd through a differentiable Newton:
twins of tests/test_implicit_autodiff_parity.py (:48, :73).

The hand-written Theta.step_adj transposes the converged stage (implicit
function theorem). Here a fixed-iteration Newton with dense solves, which
plain autograd can differentiate end to end, gives the ground truth, in
fp64, at the JAX tests' tolerances (one step rtol 1e-10 / atol 1e-12; five
CN steps 1e-9 / 1e-11)."""

import math

import numpy as np
import pytest
import torch

from pnode_tpu_torch.linsolve import LinearSolveConfig
from pnode_tpu_torch.misc import tree_add, tree_zeros_like
from pnode_tpu_torch.newton import NewtonConfig
from pnode_tpu_torch.steppers import ImplicitSolveSetup, Theta

torch.set_num_threads(1)
Y0 = [0.8, -0.3, 0.5]
P0 = {"a": -1.2, "b": 0.25}


def f(t, y, p):
    return p["a"] * y + p["b"] * torch.sin(y) + 0.1 * math.cos(t)


def _p(requires_grad=False):
    return {k: torch.tensor(v, dtype=torch.float64,
                            requires_grad=requires_grad)
            for k, v in P0.items()}


def _stepper(theta):
    setup = ImplicitSolveSetup(
        lin_cfg=LinearSolveConfig(kind="gmres", rtol=1e-14),
        newton_cfg=NewtonConfig(rtol=1e-14, stol=1e-15, max_it=60))
    return Theta(theta, f, setup)


def theta_step_autodiff(theta, t, dt, y, p, n_newton=30):
    """Theta step by a differentiable fixed-iteration Newton (dense
    solves), the JAX test's ``theta_step_autodiff``."""
    f_n = f(t, y, p)

    def residual(z):
        return z - y - dt * ((1 - theta) * f_n + theta * f(t + dt, z, p))

    z = y
    for _ in range(n_newton):
        J = torch.func.jacfwd(residual)(z)
        z = z - torch.linalg.solve(J, residual(z))
    return z


@pytest.mark.parametrize("theta", [1.0, 0.5], ids=["beuler", "cn"])
def test_theta_adjoint_vs_full_autodiff(theta):
    """Twin of :48: one step's step_adj against autograd through the
    differentiable Newton."""
    stepper = _stepper(theta)
    t, dt = 0.2, 0.15
    y0 = torch.tensor(Y0, dtype=torch.float64)
    lam = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
    _, aux, _ = stepper.step(t, dt, y0, _p())
    dly, dlp = stepper.step_adj(t, dt, y0, _p(), aux, lam)

    y_ref = y0.clone().requires_grad_(True)
    p_ref = _p(True)
    torch.dot(lam, theta_step_autodiff(theta, t, dt, y_ref, p_ref)).backward()
    np.testing.assert_allclose(dly.numpy(), y_ref.grad.numpy(), rtol=1e-10,
                               atol=1e-12)
    for k in P0:
        np.testing.assert_allclose(float(dlp[k]), float(p_ref[k].grad),
                                   rtol=1e-10, atol=1e-12)


def test_multi_step_cn_trajectory_gradient_parity():
    """Twin of :73: five CN steps, the gradient of sum(y_5^2) by the
    hand-written reverse sweep against autograd through the differentiable
    Newton."""
    stepper = _stepper(0.5)
    dt = 0.1
    y0 = torch.tensor(Y0, dtype=torch.float64)
    ys, auxs, y = [y0], [], y0
    for k in range(5):
        y, aux, _ = stepper.step(k * dt, dt, y, _p())
        ys.append(y)
        auxs.append(aux)
    lam = 2.0 * ys[-1]
    gp = tree_zeros_like(_p())
    for k in range(4, -1, -1):
        lam, gstep = stepper.step_adj(k * dt, dt, ys[k], _p(), auxs[k], lam)
        gp = tree_add(gp, gstep)

    y_ref = y0.clone().requires_grad_(True)
    p_ref = _p(True)
    y = y_ref
    for k in range(5):
        y = theta_step_autodiff(0.5, k * dt, dt, y, p_ref)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(lam.numpy(), y_ref.grad.numpy(), rtol=1e-9,
                               atol=1e-11)
    for k in P0:
        np.testing.assert_allclose(float(gp[k]), float(p_ref[k].grad),
                                   rtol=1e-9, atol=1e-11)
