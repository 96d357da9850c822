"""The port's ExplicitRK stepper (steppers.py) and its method resolution
(solver.py) against the JAX package: twins of tests/test_steppers.py's
explicit-RK cases, and ODESolver(method="rk4").odeint_adjoint gradients
against the JAX solver, all in fp64 (steps and gradients rtol 1e-12 /
atol 1e-13 for one step, 1e-10 through a solve; the two evaluate the same
stage sums in the same order)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu.steppers import ExplicitRK as JExplicitRK
from pnode_tpu.tableaus import get_rk_tableau as jget_rk_tableau
from pnode_tpu_torch.steppers import ExplicitRK
from pnode_tpu_torch.tableaus import get_rk_tableau

torch.set_num_threads(1)
METHODS = ["euler", "rk2", "bosh3", "rk4", "dopri5"]
P0 = {"a": -0.7, "b": 0.15, "c": 0.4}
Y0 = np.array([1.0, 0.5, -0.3])


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def f_poly_j(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + jnp.sin(t) * p["c"]


def f_poly_t(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + math.sin(t) * p["c"]


def _tparams():
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in P0.items()}


def _jparams():
    return {k: jnp.asarray(v, jnp.float64) for k, v in P0.items()}


@pytest.mark.parametrize("method", METHODS)
def test_step_and_adjoint_match_jax(method):
    """One step and its transpose (stored and recomputed stages) == JAX."""
    t, dt = 0.3, 0.05
    lam = np.array([0.2, -1.1, 0.7])
    js = JExplicitRK(jget_rk_tableau(method), f_poly_j)
    ts = ExplicitRK(get_rk_tableau(method), f_poly_t)
    y1j, auxj, _ = js.step(jnp.asarray(t), jnp.asarray(dt), jnp.asarray(Y0),
                           _jparams())
    y1t, auxt, _ = ts.step(t, dt, torch.tensor(Y0), _tparams())
    np.testing.assert_allclose(y1t.numpy(), np.asarray(y1j), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(auxt.numpy(), np.asarray(auxj), rtol=1e-12,
                               atol=1e-13)
    dlj, dpj = js.step_adj(jnp.asarray(t), jnp.asarray(dt), jnp.asarray(Y0),
                           _jparams(), auxj, jnp.asarray(lam))
    for aux in (auxt, None):
        dlt, dpt = ts.step_adj(t, dt, torch.tensor(Y0), _tparams(), aux,
                               torch.tensor(lam))
        np.testing.assert_allclose(dlt.numpy(), np.asarray(dlj), rtol=1e-12,
                                   atol=1e-13)
        for k in P0:
            np.testing.assert_allclose(float(dpt[k]), float(dpj[k]),
                                       rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("method", ["bosh3", "dopri5"])
def test_step_embedded_matches_jax(method):
    js = JExplicitRK(jget_rk_tableau(method), f_poly_j)
    ts = ExplicitRK(get_rk_tableau(method), f_poly_t)
    ej = js.step_embedded(jnp.asarray(0.1), jnp.asarray(0.2), jnp.asarray(Y0),
                          _jparams())[1]
    et = ts.step_embedded(0.1, 0.2, torch.tensor(Y0), _tparams())[1]
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12,
                               atol=1e-15)


_NS_BY_ORDER = {1: (40, 80, 160), 2: (20, 40, 80), 3: (10, 20, 40),
                4: (5, 10, 20), 5: (8, 16, 32)}


@pytest.mark.parametrize("method", METHODS)
def test_convergence_order(method):
    """Empirical order within 0.5 of nominal (twin of
    test_explicit_rk_convergence_order)."""
    tab = get_rk_tableau(method)
    stp = ExplicitRK(tab, f_poly_t)

    def run(n):
        y, dt = torch.tensor(Y0), 1.0 / n
        for k in range(n):
            y = stp.step(k * dt, dt, y, _tparams())[0]
        return y

    ns = _NS_BY_ORDER[tab.order]
    ref = run(ns[-1] * 4)
    errs = [float((run(n) - ref).abs().max()) for n in ns]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)
              if errs[i + 1] > 1e-12]
    assert orders, errs
    assert orders[-1] == pytest.approx(tab.order, abs=0.5)


def test_odeint_adjoint_rk4_matches_jax():
    """ODESolver(method="rk4").odeint_adjoint: solution and the gradients
    of sum(w * sol) with respect to y0 and the parameters, port against
    JAX, through a tanh-MLP dynamics over three output times."""
    rng = np.random.default_rng(0)
    W1, W2 = rng.normal(size=(4, 8)) * 0.5, rng.normal(size=(8, 4)) * 0.5
    y0 = rng.normal(size=(3, 4))
    w = rng.normal(size=(3, 3, 4))
    t = np.array([0.0, 0.3, 0.7])

    def fj(tt, y, p):
        return jnp.tanh(y @ p["W1"]) @ p["W2"]

    def ft(tt, y, p):
        return torch.tanh(y @ p["W1"]) @ p["W2"]

    pj = {"W1": jnp.asarray(W1), "W2": jnp.asarray(W2)}
    jode = JODESolver()
    jode.setupTS(jnp.zeros((3, 4)), (fj, pj), step_size=0.1, method="rk4")

    def loss_j(yy, pp):
        return jnp.sum(jode.odeint_adjoint(yy, t, params=pp) * w)

    lj, (gyj, gpj) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(y0), pj)

    pt_ = {"W1": torch.tensor(W1, requires_grad=True),
           "W2": torch.tensor(W2, requires_grad=True)}
    ode = pt.ODESolver().setupTS(torch.zeros(3, 4, dtype=torch.float64),
                                 (ft, pt_), step_size=0.1, method="rk4")
    assert type(ode._stepper).__name__ == "ExplicitRK"
    y0t = torch.tensor(y0, requires_grad=True)
    lt = (ode.odeint_adjoint(y0t, t, params=pt_) * torch.tensor(w)).sum()
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    np.testing.assert_allclose(y0t.grad.numpy(), np.asarray(gyj), rtol=1e-10,
                               atol=1e-12)
    for k in pt_:
        np.testing.assert_allclose(pt_[k].grad.numpy(), np.asarray(gpj[k]),
                                   rtol=1e-10, atol=1e-12)
    assert ode.nfe_forward == jode.nfe_forward == 7 * 4


@pytest.mark.parametrize("argv, method", [
    (["-ts_type", "rk", "-ts_rk_type", "5dp"], "5dp"),
    (["-ts_rk_type", "4"], "4"),
    (["-ts_type", "euler"], "euler"),
])
def test_method_resolution_matches_jax(argv, method):
    """-ts_type rk / -ts_rk_type / -ts_type euler pick the same tableau."""
    pt.init(["p"] + argv)
    pnode_tpu.init(["p"] + argv)
    ode = pt.ODESolver().setupTS(torch.zeros(2), lambda t, y: -y,
                                 method="dopri5")
    jode = JODESolver()
    jode.setupTS(jnp.zeros(2), lambda t, y: -y, method="dopri5")
    assert ode.method == jode.method == method
    assert ode._stepper.tab.name == jode._stepper.tab.name
