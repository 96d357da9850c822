"""bf16 in the port against the JAX package: bf16 states (twins of the 7
cases of tests/test_bf16_state.py) and bf16-compressed trajectory storage
(``-pnode_trajectory_dtype``: twins of tests/test_revolve.py:142, :201 and
tests/test_observability.py:69), on the CPU.

A bf16 state is carried and stored at bf16 with the stage math, Newton and
the linear solves at fp32; parameter gradients come back at the
parameters' dtype. Each case holds the port's bf16 run against its fp32
run and against the JAX package's bf16 run at the reference test's
tolerance (rtol 2e-2 for the explicit and theta methods, 3e-2 for IMEX,
5e-2 / atol 5e-3 for the frozen-Jacobian block solver and the adaptive
controller): bf16 rounding, not the port, sets the distance. Compressed
storage holds the gradients within bf16 distance (rtol 2e-2) of the
uncompressed ones, in both packages.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver

torch.set_num_threads(1)
Y0 = np.linspace(0.1, 1.0, 32, dtype=np.float32).reshape(4, 8)
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}
JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _f(t, y, p):
    return torch.tanh(y) * p["w"]


def _jf(t, y, p):
    return jnp.tanh(y) * p["w"]


def _port(dtype, setup, params, t_out, func2=None, f=_f):
    """(solution, {param: grad}) of sum(s[-1]) through the port."""
    ode = pt.ODESolver()
    y0 = torch.from_numpy(Y0).to(TDT[dtype])
    im = params if func2 is None else params[0]
    ode.setupTS(y0, pt.Func(f, im), func2=func2, **setup)
    prm = tuple({k: v.clone().requires_grad_(True) for k, v in d.items()}
                for d in (params if func2 is not None else (params,)))
    s, _ = ode.solve(y0, t_out, params=prm if func2 is not None else prm[0])
    s[-1].float().sum().backward()
    return s.detach(), [{k: v.grad for k, v in d.items()} for d in prm]


def _jax(dtype, setup, params, t_out, func2=None, f=_jf):
    ode = JODESolver()
    y0 = jnp.asarray(Y0).astype(JDT[dtype])
    ode.setupTS(y0, (f, params if func2 is None else params[0]),
                func2=func2, **setup)

    def loss(p, y):
        s, _ = ode.solve(y, t_out, params=p, with_adjoint=True)
        return jnp.sum(s[-1].astype(jnp.float32))

    s, _ = ode.solve(y0, t_out, params=params)
    return s, jax.grad(loss)(params, y0)


@pytest.mark.parametrize("method", ["rk4", "dopri5", "cn", "beuler"])
def test_bf16_state_dtype_and_grad(method):
    """Twin of test_bf16_state.py:46: the state stays bf16, the parameter
    gradient comes back fp32, within rtol 2e-2 of the fp32 run and of the
    JAX package's bf16 run."""
    setup = dict(step_size=0.25, method=method, enable_adjoint=True)
    t_out = np.array([1.0])
    p = {"w": torch.tensor(0.5)}
    sol, (g,) = _port("bf16", setup, p, t_out)
    assert sol.dtype == torch.bfloat16
    assert g["w"].dtype == torch.float32
    _, (g32,) = _port("f32", setup, p, t_out)
    np.testing.assert_allclose(float(g["w"]), float(g32["w"]), rtol=2e-2)
    sol_j, g_j = _jax("bf16", setup, {"w": jnp.float32(0.5)}, t_out)
    np.testing.assert_allclose(float(g["w"]), float(g_j["w"]), rtol=2e-2)
    np.testing.assert_allclose(sol.float().numpy(),
                               np.asarray(sol_j, np.float32), rtol=2e-2)


def test_bf16_state_imex():
    """Twin of :57: ARK IMEX on a bf16 state (rtol 3e-2)."""
    setup = dict(step_size=0.25, method="imex", imex_form=True,
                 implicit_form=True, enable_adjoint=True)
    t_out = np.array([1.0])

    def f_im(t, y, p):
        return -0.5 * y

    def f_ex(t, y, p):
        return torch.sin(y) * p["w"]

    def jf_ex(t, y, p):
        return jnp.sin(y) * p["w"]

    tp = ({}, {"w": torch.tensor(0.8)})
    sol_b, g_b = _port("bf16", setup, tp, t_out, func2=pt.Func(f_ex, tp[1]),
                       f=f_im)
    _, g_f = _port("f32", setup, tp, t_out, func2=pt.Func(f_ex, tp[1]),
                   f=f_im)
    assert sol_b.dtype == torch.bfloat16
    assert g_b[1]["w"].dtype == torch.float32
    np.testing.assert_allclose(float(g_b[1]["w"]), float(g_f[1]["w"]),
                               rtol=3e-2)
    jp = ({}, {"w": jnp.float32(0.8)})
    _, g_j = _jax("bf16", setup, jp, t_out, func2=(jf_ex, jp[1]),
                  f=lambda t, y, p: -0.5 * y)
    np.testing.assert_allclose(float(g_b[1]["w"]), float(g_j[1]["w"]),
                               rtol=3e-2)


def test_bf16_state_frozen_jacobian_block_solver():
    """Twin of :90: the KS/Burgers stiff configuration at bf16 (hpddm
    shared-block solver, fixed_jacobian, ksponly) with the bf16 weight
    stream: fp32 master weights cast to bf16 inside the loss, their
    gradients landing on the fp32 masters (rtol 5e-2, atol 5e-3 against
    fp32 and against the JAX package)."""
    batch, d = 4, 8
    w0 = 0.3 * np.eye(d, dtype=np.float32)
    t_out = np.array([0.5])
    setup = dict(step_size=0.25, method="imex", imex_form=True,
                 implicit_form=True, enable_adjoint=True,
                 linear_solver="hpddm", fixed_jacobian=True, batch_size=batch)

    def f_im(t, y, p):
        return 40.0 * (torch.roll(y, 1, -1) - 2 * y + torch.roll(y, -1, -1))

    def f_ex(t, y, p):
        return torch.tanh(y @ p["w"].to(y.dtype))

    def run(dtype):
        pt.init(["p", "-snes_type", "ksponly"])
        o = pt.ODESolver()
        yy = torch.from_numpy(Y0).to(TDT[dtype])
        master = torch.from_numpy(w0).requires_grad_(True)
        o.setupTS(yy, pt.Func(f_im, {}),
                  func2=pt.Func(f_ex, {"w": master.detach()}), **setup)
        s, _ = o.solve(yy, t_out, params=({}, {"w": master.to(TDT[dtype])}))
        s[-1].float().sum().backward()
        return s.detach(), master.grad

    sol_b, g_b = run("bf16")
    sol_f, g_f = run("f32")
    assert sol_b.dtype == torch.bfloat16
    assert g_b.dtype == torch.float32
    assert torch.isfinite(sol_b.float()).all()
    np.testing.assert_allclose(g_b.double().numpy(), g_f.double().numpy(),
                               rtol=5e-2, atol=5e-3)

    pnode_tpu.init(["p", "-snes_type", "ksponly"])
    jo = JODESolver()
    yj = jnp.asarray(Y0).astype(jnp.bfloat16)
    jo.setupTS(yj, (lambda t, y, p: 40.0 * (jnp.roll(y, 1, -1) - 2 * y
                                            + jnp.roll(y, -1, -1)), {}),
               func2=(lambda t, y, p: jnp.tanh(y @ p["w"].astype(y.dtype)),
                      {"w": jnp.asarray(w0)}), **setup)

    def loss(p, y):
        pp = ({}, {"w": p["w"].astype(jnp.bfloat16)})
        s, _ = jo.solve(y, t_out, params=pp, with_adjoint=True)
        return jnp.sum(s[-1].astype(jnp.float32))

    g_j = jax.grad(loss)({"w": jnp.asarray(w0)}, yj)
    np.testing.assert_allclose(g_b.double().numpy(),
                               np.asarray(g_j["w"], np.float64),
                               rtol=5e-2, atol=5e-3)


def test_bf16_state_adaptive():
    """Twin of :151: the controller over a bf16 state, its time, dt and
    error norm at fp32: the state stays bf16, lands on the output, and
    the solution (rtol/atol 3e-2) and gradient (rtol 5e-2) track the fp32
    run and the JAX package's bf16 run."""
    flags = ["p", "-ts_adapt_type", "basic", "-ts_rtol", "1e-2", "-ts_atol",
             "1e-2"]
    setup = dict(step_size=0.1, method="dopri5", enable_adjoint=True)
    t_out = np.array([0.0, 1.0])
    p = {"w": torch.tensor(0.5)}
    pt.init(flags)
    sol_b, (g_b,) = _port("bf16", setup, p, t_out)
    sol_f, (g_f,) = _port("f32", setup, p, t_out)
    assert sol_b.dtype == torch.bfloat16
    assert torch.isfinite(sol_b.float()).all()
    np.testing.assert_allclose(sol_b[-1].float().numpy(),
                               sol_f[-1].numpy(), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(float(g_b["w"]), float(g_f["w"]), rtol=5e-2)
    pnode_tpu.init(flags)
    sol_j, g_j = _jax("bf16", setup, {"w": jnp.float32(0.5)}, t_out)
    np.testing.assert_allclose(sol_b[-1].float().numpy(),
                               np.asarray(sol_j[-1], np.float32), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(float(g_b["w"]), float(g_j["w"]), rtol=5e-2)


# -- bf16-compressed storage (-pnode_trajectory_dtype) ------------------------

def _compressed_grads(flags, f, jf, P, y0, t, method, step):
    """{name: grad} of sum(sol[-1]^2) in fp32 under the flags: the port's
    and the JAX package's."""
    pt.clear_options()
    pt.init(["p"] + flags)
    prm = {k: torch.tensor(v, requires_grad=True) for k, v in P.items()}
    y = torch.tensor(y0, dtype=torch.float32)
    ode = pt.ODESolver().setupTS(y, pt.Func(f, prm), step_size=step,
                                 method=method)
    (ode.odeint_adjoint(y, t, params=prm)[-1] ** 2).sum().backward()
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + flags)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in P.items()}
    jode = JODESolver()
    jode.setupTS(jnp.asarray(y0, jnp.float32), JFunc(jf, jp), step_size=step,
                 method=method)
    g_j = jax.grad(lambda p: jnp.sum(jode.odeint_adjoint(
        jnp.asarray(y0, jnp.float32), jnp.asarray(t), params=p)[-1] ** 2))(jp)
    return ({k: float(v.grad) for k, v in prm.items()},
            {k: float(v) for k, v in g_j.items()})


BF16 = ["-pnode_trajectory_dtype", "bfloat16"]
COMPRESSED_CASES = {
    # name: (f, jf, params, y0, t, method, step, policy flags)
    "rk4_store_all": (lambda t, y, p: p["a"] * y + p["b"] * torch.tanh(y),
                      lambda t, y, p: p["a"] * y + p["b"] * jnp.tanh(y),
                      {"a": -0.5, "b": 0.3}, [1.0, -0.4], [0.0, 1.0], "rk4",
                      0.1, []),
    "bosh3_solution_only": (lambda t, y, p: p["a"] * torch.sin(y),
                            lambda t, y, p: p["a"] * jnp.sin(y),
                            {"a": -0.8}, [1.2, -0.3], [0.0, 1.0], "bosh3",
                            0.05, ["-ts_trajectory_solution_only", "1"]),
    "rk4_cams": (lambda t, y, p: p["a"] * y + p["b"] * torch.tanh(y),
                 lambda t, y, p: p["a"] * y + p["b"] * jnp.tanh(y),
                 {"a": -0.5, "b": 0.3}, [1.0, -0.4], [0.0, 1.0], "rk4", 0.1,
                 ["-ts_trajectory_max_cps_ram", "3",
                  "-ts_trajectory_schedule", "cams"]),
    "dopri5_adaptive_checkpoint": (
        lambda t, y, p: p["a"] * y + p["b"] * torch.tanh(y),
        lambda t, y, p: p["a"] * y + p["b"] * jnp.tanh(y),
        {"a": -0.5, "b": 0.3}, [1.0, -0.4], [0.0, 1.0], "dopri5", 0.1,
        ["-ts_adapt_type", "basic", "-ts_rtol", "1e-5", "-ts_atol", "1e-5",
         "-ts_adapt_max_steps", "64", "-ts_trajectory_max_cps_ram", "3"]),
}


@pytest.mark.parametrize("name", sorted(COMPRESSED_CASES))
def test_bf16_trajectory_compression(name):
    """Twins of test_revolve.py:142 (rk4, store_all) and :201 (bosh3,
    solution_only), and the same bar on CAMS and the adaptive checkpoint
    policy, which compress their checkpoints: the compressed gradients
    within rtol 2e-2 of the uncompressed ones, in the port and in JAX, and
    the port's within 2e-2 of JAX's."""
    f, jf, P, y0, t, method, step, policy = COMPRESSED_CASES[name]
    args = (f, jf, P, y0, np.asarray(t), method, step)
    g_ref, gj_ref = _compressed_grads(policy, *args)
    g_c, gj_c = _compressed_grads(policy + BF16, *args)
    for k in P:
        np.testing.assert_allclose(g_c[k], g_ref[k], rtol=2e-2)
        np.testing.assert_allclose(gj_c[k], gj_ref[k], rtol=2e-2)
        np.testing.assert_allclose(g_c[k], gj_c[k], rtol=2e-2)
        np.testing.assert_allclose(g_ref[k], gj_ref[k], rtol=1e-5)


def test_bf16_compression_warns_on_interior_outputs():
    """Twin of test_observability.py:69: compression with interior output
    times warns that they pass through the compressed store; an
    endpoint-only solve stays silent. The interior output is the
    bf16-rounded state, the final one exact."""
    P = {"a": torch.tensor(-0.5)}
    y0 = torch.tensor([1.0])

    def f(t, y, p):
        return p["a"] * y

    pt.init(["p"] + BF16)
    ode = pt.ODESolver().setupTS(y0, pt.Func(f, P), step_size=0.1,
                                 method="rk4")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sol = ode.odeint_adjoint(y0, np.array([0.0, 0.5, 1.0]), params=P)
        assert any("compressed" in str(x.message) for x in w), [
            str(x.message) for x in w]
    exact = pt.ODESolver().setupTS(y0, pt.Func(f, P), step_size=0.1,
                                   method="rk4").odeint(
        y0, np.array([0.0, 0.5, 1.0]), params=P)
    assert torch.equal(sol[1], exact[1].to(torch.bfloat16).float())
    assert torch.equal(sol[-1], exact[-1])

    pt.clear_options()
    pt.init(["p"] + BF16)
    ode2 = pt.ODESolver().setupTS(y0, pt.Func(f, P), step_size=0.1,
                                  method="rk4")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ode2.odeint_adjoint(y0, np.array([0.0, 1.0]), params=P)
        assert not any("compressed" in str(x.message) for x in w)
