"""The theta slice at the solver and trainer level, against the JAX package
in fp64 on the same numpy inputs (weights carried by ``convert.py``):

- ``-ts_type cn`` turns a dopri5 setup into the Theta stepper, and a mass
  matrix with an explicit method raises, as in JAX;
- ``odeint`` (the solve without the adjoint) is differentiable: its
  autograd gradients through dopri5 against ``jax.grad`` of JAX's
  ``solve_noadj`` (1e-10);
- one step of examples/ks_torch.py's snode / cn / petsc computation at
  hidden 16, batch 4 against examples/ks.py's: loss and gradients within
  1e-8 relative; the trainer itself for one small epoch;
- one gradient of examples/burgers_torch.py --node (f_IM + f_EX by dopri5,
  autograd) at nx 32 against burgers.py --node's;
- one step of examples/pendulum_dae_torch.py in the known-constraint and
  --unknown_alg modes against pendulum_dae.py's (loss and gradients within
  1e-8), and the trainer's checkpoints (--pretrained, --hotstart);
- the adaptive controller (-ts_adapt_type basic) driving cn against JAX:
  outputs, accept/reject counts, Newton iterations and adjoint gradients.
"""

import importlib.util
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import FlaxFunc
from pnode_tpu import Func as JFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu.models import BurgersFuncEX as JBurgersFuncEX
from pnode_tpu.models import BurgersFuncIM as JBurgersFuncIM
from pnode_tpu.models import KSSnodeFunc as JKSSnodeFunc
from pnode_tpu_torch.convert import dense_stack_from_flax, state_dict_from_flax
from pnode_tpu_torch.models import (
    BurgersFuncEX, BurgersFuncIM, IMEXSum, KSSnodeFunc)
from pnode_tpu_torch.steppers import Theta
from pnode_tpu_torch.utils import load_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P0 = {"a": -0.7, "b": 0.15, "c": 0.4}
Y0 = np.array([[1.0, 0.5, -0.3], [0.2, -0.8, 0.6]])


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def f_poly(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + math.sin(t) * p["c"]


def f_poly_j(t, y, p):
    return p["a"] * y + p["b"] * y ** 2 + jnp.sin(t) * p["c"]


def _tp(requires_grad=False):
    return {k: torch.tensor(v, dtype=torch.float64,
                            requires_grad=requires_grad)
            for k, v in P0.items()}


def _jp():
    return {k: jnp.asarray(v, jnp.float64) for k, v in P0.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- the solver --------------------------------------------------------------

def test_ts_type_cn_flips_a_dopri5_setup_to_theta():
    """The probe of the verify recipe: -ts_type cn makes a dopri5 setup the
    Theta stepper (method "cn"), as pnode_tpu.init does; -ts_type beuler
    gives theta 1."""
    for flag, theta in (("cn", 0.5), ("beuler", 1.0)):
        pt.clear_options()
        pt.init(["prog", "-ts_type", flag])
        ode = pt.ODESolver().setupTS(torch.tensor(Y0), pt.Func(f_poly, _tp()),
                                     step_size=0.1, method="dopri5")
        assert ode.method == flag
        assert isinstance(ode._stepper, Theta)
        assert ode._stepper.theta == theta


def test_mass_with_an_explicit_method_raises():
    """A mass matrix needs an implicit method, in both packages."""
    kw = dict(step_size=0.1, method="rk4", mass=np.eye(3))
    with pytest.raises(ValueError, match="implicit method"):
        pt.ODESolver().setupTS(torch.tensor(Y0), pt.Func(f_poly, _tp()), **kw)
    with pytest.raises(ValueError, match="implicit method"):
        JODESolver().setupTS(jnp.asarray(Y0), JFunc(f_poly_j, _jp()), **kw)


def test_odeint_gradients_through_dopri5_match_jax_grad():
    """solve(..., with_adjoint=False) runs under autograd: the gradients of
    a loss through dopri5's steps equal jax.grad of JAX's solve_noadj."""
    t = np.array([0.0, 0.3, 0.7])
    tgt = np.random.default_rng(3).normal(size=(3,) + Y0.shape)
    ode = pt.ODESolver().setupTS(torch.tensor(Y0), pt.Func(f_poly, _tp()),
                                 step_size=0.05, method="dopri5",
                                 enable_adjoint=False)
    p = _tp(True)
    y0 = torch.tensor(Y0, requires_grad=True)
    pred = ode.odeint(y0, t, params=p)
    loss = torch.mean((pred - torch.tensor(tgt)) ** 2)
    loss.backward()

    jode = JODESolver()
    jode.setupTS(jnp.asarray(Y0), JFunc(f_poly_j, _jp()), step_size=0.05,
                 method="dopri5", enable_adjoint=False)

    def jloss(pp, yy):
        return jnp.mean((jode.odeint(yy, jnp.asarray(t), params=pp)
                         - jnp.asarray(tgt)) ** 2)

    jl, (gp, gy) = jax.value_and_grad(jloss, argnums=(0, 1))(
        _jp(), jnp.asarray(Y0))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-12)
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(gy), rtol=1e-10,
                               atol=1e-14)
    for k in P0:
        assert float(p[k].grad) == pytest.approx(float(gp[k]), rel=1e-10)


def test_adaptive_cn_matches_jax():
    """-ts_adapt_type basic driving Theta (cn, GMRES): outputs, the accept
    and reject counts, Newton iterations and the adjoint's gradients against
    JAX's adaptive solve."""
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4", "-ts_atol",
             "1e-4", "-ts_adapt_max_steps", "200"]
    t = np.array([0.0, 0.5, 1.0])
    pt.init(["p"] + flags)
    ode = pt.ODESolver().setupTS(torch.tensor(Y0), pt.Func(f_poly, _tp()),
                                 step_size=0.1, method="cn",
                                 implicit_form=True)
    pnode_tpu.init(["p"] + flags)
    jode = JODESolver()
    jode.setupTS(jnp.asarray(Y0), JFunc(f_poly_j, _jp()), step_size=0.1,
                 method="cn", implicit_form=True)
    p = _tp(True)
    sol, st = ode.solve(torch.tensor(Y0), t, params=p)
    torch.sum(sol ** 2).backward()
    sol_j, st_j = jode.solve(jnp.asarray(Y0), t, params=_jp())
    assert st.completed and st.accepted > 5 and st.rejected > 0
    assert (st.accepted, st.rejected, st.newton_iters) == (
        int(st_j.accepted), int(st_j.rejected), int(st_j.newton_iters))
    np.testing.assert_allclose(sol.detach().numpy(), np.asarray(sol_j),
                               rtol=1e-10, atol=1e-13)
    g = jax.grad(lambda pp: jnp.sum(jode.solve(jnp.asarray(Y0), t,
                                               params=pp)[0] ** 2))(_jp())
    for k in P0:
        assert float(p[k].grad) == pytest.approx(float(g[k]), rel=1e-8)


# -- examples/ks_torch.py: snode / cn / petsc ------------------------------------

def _ks_states(B, nx=64, L=22.0, seed=0):
    """Smooth periodic states: a few Fourier modes with seeded amplitudes."""
    rng = np.random.default_rng(seed)
    x = np.arange(nx) * (L / nx)
    out = np.zeros((B, nx))
    for k in range(1, 4):
        a, b = rng.normal(size=(2, B, 1))
        out += a * np.cos(2 * np.pi * k * x / L) + b * np.sin(
            2 * np.pi * k * x / L)
    return out


def test_ks_snode_cn_petsc_step_matches_ks_py():
    """One training step of the snode model (hidden 16) under CN with
    matrix-free GMRES and Newton, batch 4: the loss and the discrete
    adjoint's gradients against ks.py's computation, within 1e-8."""
    B, H, dt = 4, 16, 0.2
    y0, tgt = _ks_states(B), _ks_states(B, seed=1)[:, None]
    t_out = np.array([0.0, dt])
    jmod = JKSSnodeFunc(nx=64, L=22.0, hidden=H)
    jparams = _np64(jmod.init(jax.random.PRNGKey(0), 0.0,
                              jnp.zeros((B, 64))))
    jode = JODESolver()
    jode.setupTS(jnp.zeros((B, 64)), FlaxFunc(jmod, jparams), step_size=dt,
                 method="cn", implicit_form=True, linear_solver="petsc",
                 fixed_jacobian=False, batch_size=B)

    def jloss(pp):
        pred = jode.odeint_adjoint(jnp.asarray(y0), jnp.asarray(t_out),
                                   params=pp)
        return jnp.mean((jnp.swapaxes(pred[1:], 0, 1) - tgt) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jparams)

    mod = KSSnodeFunc(nx=64, L=22.0, hidden=H, dtype=torch.float64,
                      use_fused=True)
    mod.load_state_dict(state_dict_from_flax(jparams))
    ode = pt.ODESolver().setupTS(
        torch.zeros(B, 64, dtype=torch.float64), pt.TorchFunc(mod),
        step_size=dt, method="cn", implicit_form=True, linear_solver="petsc",
        fixed_jacobian=False, batch_size=B)
    assert ode.lin_cfg.kind == "gmres" and isinstance(ode._stepper, Theta)
    pred = ode.odeint_adjoint(torch.tensor(y0), t_out)
    loss = torch.mean((pred[1:].transpose(0, 1) - torch.tensor(tgt)) ** 2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-8)
    ref = state_dict_from_flax(_np64(jg))
    for name, prm in mod.named_parameters():
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= 1e-8, name
    assert ode.last_stats.newton_iters >= 1 and ode.last_stats.newton_converged


def test_ks_torch_snode_cn_petsc_epoch_on_the_cpu(tmp_path):
    """examples/ks_torch.py --pnode_model snode --pnode_method cn
    --linear_solver petsc --no-fixed_jacobian for one small epoch: finite
    train and validation losses."""
    best, history = _example("ks_torch").main([
        "--device", "cpu", "--pnode_model", "snode", "--pnode_method", "cn",
        "--linear_solver", "petsc", "--no-fixed_jacobian", "--batch_size",
        "4", "--data_size", "20", "--max_epochs", "1", "--train_dir",
        str(tmp_path)])
    assert np.isfinite(best) and len(history[0]) == 3
    assert np.all(np.isfinite(history[0]))


# -- examples/burgers_torch.py --node --------------------------------------------

def test_burgers_node_gradient_matches_jax():
    """burgers --node at nx 32: f_IM + f_EX by dopri5 without the adjoint,
    the mean-abs window loss differentiated by autograd through the steps,
    against jax.grad of burgers.py --node's solve (1e-8)."""
    B, nx, step = 3, 32, 0.01
    rng = np.random.default_rng(5)
    y0 = rng.normal(size=(B, nx))
    target = rng.normal(size=(2, B, nx))
    window_t = np.array([0.0, 0.1])
    jim, jex = JBurgersFuncIM(nx=nx), JBurgersFuncEX(nx=nx)
    key = jax.random.PRNGKey(0)
    vim = _np64(jim.init(key, 0.0, jnp.zeros((B, nx))))
    vex = _np64(jex.init(key, 0.0, jnp.zeros((B, nx))))

    def combined(t, y, p):
        return jim.apply(p[0], t, y) + jex.apply(p[1], t, y)

    jode = JODESolver()
    jode.setupTS(jnp.zeros((B, nx)), (combined, (vim, vex)), step_size=step,
                 method="dopri5", enable_adjoint=False)

    def jloss(pex):
        pred, _ = jode.solve(jnp.asarray(y0), window_t, params=(vim, pex),
                             with_adjoint=False)
        return jnp.mean(jnp.abs(pred - target))

    jl, jg = jax.value_and_grad(jloss)(vex)

    im = BurgersFuncIM(nx=nx, use_fused=True, dtype=torch.float64)
    ex = BurgersFuncEX(nx=nx, dtype=torch.float64)
    ex.load_state_dict(state_dict_from_flax(vex))
    ode = pt.ODESolver().setupTS(torch.zeros(B, nx, dtype=torch.float64),
                                 pt.TorchFunc(IMEXSum(im, ex)),
                                 step_size=step, method="dopri5",
                                 enable_adjoint=False)
    pred, _ = ode.solve(torch.tensor(y0), window_t, with_adjoint=False)
    loss = torch.mean(torch.abs(pred - torch.tensor(target)))
    loss.backward()
    assert float(loss) == pytest.approx(float(jl), rel=1e-10)
    ref = state_dict_from_flax(_np64(jg))
    for name, prm in ex.named_parameters():
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= 1e-8, name


# -- examples/pendulum_dae_torch.py ------------------------------------------------

class _DiffNet(fnn.Module):
    """pendulum_dae.py's DiffNet."""

    @fnn.compact
    def __call__(self, y):
        init = fnn.initializers.normal(stddev=0.01)
        h = fnn.gelu(fnn.Dense(10, use_bias=False, kernel_init=init)(y))
        h = fnn.gelu(fnn.Dense(10, use_bias=False, kernel_init=init)(h))
        return fnn.Dense(5, use_bias=False, kernel_init=init)(h)


class _AlgNet(fnn.Module):
    """pendulum_dae.py's AlgNet at a wider init, so the learned constraint
    row is far from 0."""

    @fnn.compact
    def __call__(self, y):
        init = fnn.initializers.normal(stddev=0.3)
        h = fnn.gelu(fnn.Dense(10, use_bias=False, kernel_init=init)(y))
        h = fnn.gelu(fnn.Dense(10, use_bias=False, kernel_init=init)(h))
        return fnn.Dense(1, use_bias=False, kernel_init=init)(h)


def _jax_pendulum_step(unknown_alg, data_size):
    """pendulum_dae.py's data and one loss + gradient, in fp64."""
    G = 9.81
    M = np.eye(5)
    M[-1, -1] = 0.0
    t_obs = np.linspace(0.0, 0.5, data_size + 1)
    step = float(t_obs[1] - t_obs[0])

    def pendulum_true(tt, y, p):
        return jnp.stack([y[2], y[3], -y[0] * y[4], -y[1] * y[4] - G,
                          y[4] * (y[0] ** 2 + y[1] ** 2) + G * y[1]
                          - (y[2] ** 2 + y[3] ** 2)])

    th0 = 0.5
    y0 = jnp.asarray([np.sin(th0), -np.cos(th0), 0.0, 0.0,
                      G * np.cos(th0)])
    ode0 = JODESolver()
    ode0.setupTS(y0, JFunc(pendulum_true, {}), step_size=step, method="cn",
                 implicit_form=True, mass=M, enable_adjoint=False)
    true_y = ode0.odeint(y0, t_obs)
    diff_net, alg_net = _DiffNet(), _AlgNet()
    key = jax.random.PRNGKey(0)
    params = {"diff": _np64(diff_net.init(key, y0)),
              "alg": _np64(alg_net.init(jax.random.PRNGKey(1), y0))}

    def learned_dae(tt, y, p):
        f_diff = diff_net.apply(p["diff"], y)
        if unknown_alg:
            f_alg = alg_net.apply(p["alg"], y)[0]
        else:
            f_alg = (y[4] * (y[0] ** 2 + y[1] ** 2) + G * y[1]
                     - (y[2] ** 2 + y[3] ** 2))
        return jnp.concatenate([f_diff[:4], jnp.asarray([f_alg])])

    ode = JODESolver()
    ode.setupTS(y0, JFunc(learned_dae, params), step_size=step,
                method="cn", implicit_form=True, mass=M, enable_adjoint=True)

    def loss_fn(pp):
        return jnp.mean(jnp.abs(ode.odeint_adjoint(y0, t_obs, params=pp)
                                - true_y))

    loss, g = jax.value_and_grad(loss_fn)(params)
    return np.asarray(true_y), params, float(loss), g


@pytest.mark.parametrize("unknown_alg", [False, True],
                         ids=["known", "unknown_alg"])
def test_pendulum_dae_step_matches_jax(unknown_alg):
    """One training step of pendulum_dae_torch (M = diag(1,1,1,1,0), CN,
    GMRES through the mass matrix) against pendulum_dae.py's: the data, the
    loss and the gradients of both nets, within 1e-8 relative."""
    pend = _example("pendulum_dae_torch")
    true_y_j, params, jl, jg = _jax_pendulum_step(unknown_alg, 20)
    t_obs, step = pend.observation_times(20, 1)
    y0 = pend.initial_state(torch.float64, "cpu")
    true_y = pend.true_trajectory(y0, t_obs, step)
    np.testing.assert_allclose(true_y.numpy(), true_y_j, rtol=1e-10,
                               atol=1e-12)
    model = pend.LearnedDAE(unknown_alg, dtype=torch.float64)
    model.load_state_dict({**dense_stack_from_flax(params["diff"], "diff."),
                           **dense_stack_from_flax(params["alg"], "alg.")})
    ode = pend.make_solver(model, y0, "cn", step)
    loss = torch.mean(torch.abs(ode.odeint_adjoint(y0, t_obs) - true_y))
    loss.backward()
    assert float(loss) == pytest.approx(jl, rel=1e-8)
    ref = {**dense_stack_from_flax(_np64(jg["diff"]), "diff."),
           **dense_stack_from_flax(_np64(jg["alg"]), "alg.")}
    for name, prm in model.named_parameters():
        if not unknown_alg and name.startswith("alg."):
            assert prm.grad is None or float(prm.grad.abs().max()) == 0.0
            continue
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= 1e-8, name


def test_pendulum_dae_torch_checkpoints(tmp_path):
    """The trainer on the CPU: known-constraint training saves its pickle
    checkpoint, --unknown_alg --pretrained warm-starts the differential net
    from it and keeps it frozen, --hotstart resumes after the saved
    iteration; every loss and constraint report finite."""
    pend = _example("pendulum_dae_torch")
    common = ["--device", "cpu", "--double_prec", "--data_size", "10",
              "--test_freq", "1", "--train_dir", str(tmp_path)]
    out = pend.main(common + ["--niters", "2"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert [i for i, _ in out["cv"]] == [0, 1]
    ck = load_checkpoint(str(tmp_path / "best_pendulum_dae.ckpt"))
    diff_saved = {k: v for k, v in ck["params"].items()
                  if k.startswith("diff.")}
    out = pend.main(common + ["--niters", "1", "--unknown_alg",
                              "--pretrained"])
    assert np.isfinite(out["losses"][0])
    ck2 = load_checkpoint(str(tmp_path / "best_pendulum_dae_unknown_alg.ckpt"))
    for k, v in diff_saved.items():
        assert np.array_equal(ck2["params"][k], v), k
    out = pend.main(common + ["--niters", "3", "--hotstart"])
    assert len(out["losses"]) == 3 - (ck["iter"] + 1)
