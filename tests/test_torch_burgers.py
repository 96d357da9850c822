"""The Burgers slice and the rest of the SINODE model zoo against the JAX
package: the stencil twins of tests/test_models.py, every model's forward
and VJP against flax (weights carried by ``convert.state_dict_from_flax``),
a Burgers IMEX ``odeint_adjoint`` step and Adam steps against JAX's
``ODESolver`` + ``optax.adam``, and the trainers on the CPU.

Everything runs in fp64 (``use_fused`` on the CPU runs K1's and K10/K11's
plain versions): models and one-step solves rtol 1e-12 (the same products
summed in another association), gradients through the solver rtol 1e-10
and Adam's parameters atol 1e-12, as tests/test_torch_solver.py's."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import FlaxFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu.models import BurgersFuncEX as JBurgersFuncEX
from pnode_tpu.models import BurgersFuncIM as JBurgersFuncIM
from pnode_tpu.models import KSFuncIM as JKSFuncIM
from pnode_tpu.models import KSMLPFunc as JKSMLPFunc
from pnode_tpu.models import KSSnodeFunc as JKSSnodeFunc
from pnode_tpu_torch.convert import state_dict_from_flax
from pnode_tpu_torch.models import (
    BurgersFuncEX, BurgersFuncIM, KSFuncIM, KSMLPFunc, KSSnodeFunc,
    burgers_fixed_kernel, circular_stencil_apply, ks_fixed_kernel)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1e-3


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _np64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


# -- fp64 twins of tests/test_models.py's stencil checks ----------------------

def test_circular_stencil_matches_dense_circulant():
    nx = 16
    kern = torch.from_numpy(ks_fixed_kernel(22.0 / nx))
    y = np.random.default_rng(0).normal(size=(3, nx))
    out = circular_stencil_apply(torch.from_numpy(y), kern).numpy()
    C = np.zeros((nx, nx))
    k = len(kern)
    for i in range(nx):
        for j in range(k):
            C[i, (i + j - k // 2) % nx] += float(kern[j])
    np.testing.assert_allclose(out, y @ C.T, rtol=1e-12)


def test_ks_stencil_is_ks_linear_operator():
    nx, L = 64, 22.0
    dx = L / nx
    x = np.arange(nx) * dx
    kwave = 2 * np.pi * 3 / L
    u = torch.from_numpy(np.cos(kwave * x))[None]
    out = KSFuncIM(nx=nx, L=L, dtype=torch.float64, use_fused=True)(0.0, u)
    expected = (kwave**2 - kwave**4) * np.cos(kwave * x)
    np.testing.assert_allclose(out[0].numpy(), expected, rtol=0,
                               atol=0.05 * np.abs(expected).max())


def test_burgers_stencil_is_scaled_laplacian():
    nx = 32
    x = np.arange(nx) / nx
    kwave = 2 * np.pi * 2
    u = torch.from_numpy(np.sin(kwave * x))[None]
    out = BurgersFuncIM(nx=nx, alpha=8e-4, use_fused=True,
                        dtype=torch.float64)(0.0, u)
    expected = -8e-4 * kwave**2 * np.sin(kwave * x)
    np.testing.assert_allclose(out[0].numpy(), expected, rtol=0,
                               atol=0.05 * np.abs(expected).max())
    np.testing.assert_array_equal(
        BurgersFuncIM(nx=nx).conv.fixed.numpy(),
        burgers_fixed_kernel(1.0 / nx, 8e-4))


# -- models against flax: forward and VJP ---------------------------------------

MODELS = {
    "burgers_im": (lambda f: JBurgersFuncIM(nx=24, use_pallas=f),
                   lambda f: BurgersFuncIM(nx=24, use_fused=f)),
    "burgers_ex": (lambda f: JBurgersFuncEX(nx=24, use_pallas=f),
                   lambda f: BurgersFuncEX(nx=24, use_fused=f)),
    "ks_im": (lambda f: JKSFuncIM(nx=16, fixed_linear=False, use_pallas=f),
              lambda f: KSFuncIM(nx=16, fixed_linear=False, use_fused=f)),
    "snode": (lambda f: JKSSnodeFunc(nx=16, hidden=12, fixed_linear=f),
              lambda f: KSSnodeFunc(nx=16, hidden=12, fixed_linear=f)),
    "mlp": (lambda f: JKSMLPFunc(nx=16, hidden=12),
            lambda f: KSMLPFunc(nx=16, hidden=12)),
}


@pytest.mark.parametrize("name, flag", [
    ("burgers_im", False), ("burgers_im", True), ("burgers_ex", False),
    ("burgers_ex", True), ("ks_im", True), ("snode", True), ("snode", False),
    ("mlp", False)])
def test_model_forward_and_vjp_match_flax(name, flag):
    make_j, make_t = MODELS[name]
    jm, tm = make_j(flag), make_t(flag).to(torch.float64)
    nx = tm.nx
    rng = np.random.default_rng(len(name) + flag)
    y, g = rng.normal(size=(5, nx)), rng.normal(size=(5, nx))
    v = jm.init(jax.random.PRNGKey(2), 0.0, jnp.zeros((5, nx)))
    # perturbed weights and nonzero biases (zero-init biases and the
    # N(0, 0.01) KS init would leave parts of the VJP untested)
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * np.cos(
            np.arange(a.size).reshape(a.shape))), v)
    ref, vjp = jax.vjp(lambda vv, yy: jm.apply(vv, 0.0, yy), v,
                       jnp.asarray(y))
    gv, gy = vjp(jnp.asarray(g))
    tm.load_state_dict(state_dict_from_flax(_np64(v)), strict=True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = tm(0.0, yt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=1e-12,
                               atol=1e-12)
    grads = state_dict_from_flax(_np64(gv))
    assert sorted(grads) == sorted(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=n)
    if name == "burgers_im":
        assert tm.linear_in_y and not list(tm.parameters())
    if name == "burgers_ex":
        spec = tm.fused_mlp_spec(dict(tm.named_parameters()))
        assert (spec is None) != flag
        assert spec is None or spec["sign"] == 1.0


def test_convert_raises_on_an_unmapped_module():
    with pytest.raises(KeyError, match="Dense_0"):
        state_dict_from_flax({"params": {"Dense_0": {"kernel": np.ones(2)}}})


# -- the Burgers IMEX solve against JAX's ODESolver -----------------------------

class BurgersPair:
    """One Burgers IMEX problem built in both packages from a flax init:
    ARK3, hpddm, frozen Jacobian, ksponly, -ksp_rtol 1e-6 (bench.py's
    burgers recipe) at a small grid, fp64."""

    def __init__(self, B, nx, fused):
        self.B, self.nx = B, nx
        flags = ["-snes_type", "ksponly", "-ksp_rtol", "1e-6"]
        pnode_tpu.clear_options()
        pnode_tpu.init(["p", "-pnode_fused_ark_adjoint", "off"] + flags)
        jim = JBurgersFuncIM(nx=nx, use_pallas=fused)
        jex = JBurgersFuncEX(nx=nx, use_pallas=fused)
        tmpl = jnp.zeros((B, nx), jnp.float64)
        vim = _np64(jim.init(jax.random.PRNGKey(0), 0.0, tmpl))
        vex = _np64(jex.init(jax.random.PRNGKey(1), 0.0, tmpl))
        vex = jax.tree_util.tree_map(
            lambda a: a + 0.01 * np.sin(np.arange(a.size).reshape(a.shape)),
            vex)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, (vim, vex))
        self.jode = JODESolver()
        self.jode.setupTS(tmpl, FlaxFunc(jim, self.jparams[0]), step_size=DT,
                          method="imex", imex_form=True, implicit_form=True,
                          func2=FlaxFunc(jex, self.jparams[1]),
                          linear_solver="hpddm", fixed_jacobian=True,
                          batch_size=B)
        pt.clear_options()
        pt.init(["p"] + flags)
        self.im = BurgersFuncIM(nx=nx, use_fused=fused, dtype=torch.float64)
        self.ex = BurgersFuncEX(nx=nx, use_fused=fused, dtype=torch.float64)
        self.ex.load_state_dict(state_dict_from_flax(vex))
        self.ode = pt.ODESolver()
        self.ode.setupTS(torch.zeros(B, nx, dtype=torch.float64),
                         pt.TorchFunc(self.im), step_size=DT, method="imex",
                         imex_form=True, implicit_form=True,
                         func2=pt.TorchFunc(self.ex), linear_solver="hpddm",
                         fixed_jacobian=True, batch_size=B)

    def data(self, seed, K=None):
        rng = np.random.default_rng(seed)
        shape = (self.B, self.nx) if K is None else (K, self.B, self.nx)
        y = rng.normal(size=shape)
        return y, y + 0.05 * rng.normal(size=shape)

    def jleaves(self, tree):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree[1])]

    def tleaves(self, named):
        # flax leaves are sorted by name (Dense_i/bias before Dense_i/kernel,
        # bias_i before kernel_i); the converted names sort the same way
        return [named[k].detach().numpy().T if k.endswith(".weight")
                else named[k].detach().numpy() for k in sorted(named)]


def _window_loss_j(pred, tgt):
    return jnp.mean(jnp.abs(pred - tgt))


@pytest.mark.parametrize("fused", [False, True])
def test_burgers_odeint_adjoint_matches_jax(fused):
    """Loss, dy0 and the explicit part's gradients of a two-step window
    (the Burgers trainer's mean-abs loss plus a squared term)."""
    p = BurgersPair(4, 32, fused)
    y, tgt = p.data(3)
    t_out = np.array([0.0, DT, 2 * DT])

    def jloss(y0, prm):
        pred, _ = p.jode.solve(y0, t_out, params=prm)
        return _window_loss_j(pred[1:], jnp.asarray(tgt)) + jnp.sum(
            pred[-1] ** 2)

    lj, (gyj, gpj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(y), p.jparams)
    y0 = torch.from_numpy(y).requires_grad_(True)
    pred = p.ode.odeint_adjoint(y0, t_out)
    lt = torch.mean(torch.abs(pred[1:] - torch.from_numpy(tgt))) + torch.sum(
        pred[-1] ** 2)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-12)
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(gyj), rtol=1e-10,
                               atol=1e-12)
    named = {k: v.grad for k, v in p.ex.named_parameters()}
    for a, b in zip(p.tleaves(named), p.jleaves(gpj)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-13)
    assert p.ode.last_stats.newton_iters == 6  # ksponly: 3 implicit stages


def test_burgers_adam_steps_match_optax():
    p = BurgersPair(4, 32, True)
    K, lr = 3, 1e-3
    ys, tgts = p.data(7, K)
    t_out = np.array([0.0, DT])
    opt = optax.adam(lr)
    jp, state = p.jparams, opt.init(p.jparams)

    @jax.jit
    def adam_step(prm, state, y, tgt):
        def loss_fn(prm):
            pred, _ = p.jode.solve(y, t_out, params=prm)
            return _window_loss_j(pred, tgt)
        lv, g = jax.value_and_grad(loss_fn)(prm)
        upd, state = opt.update(g, state)
        return optax.apply_updates(prm, upd), state, lv

    jl = []
    for k in range(K):
        jp, state, lv = adam_step(jp, state, jnp.asarray(ys[k]),
                                  jnp.asarray(tgts[k]))
        jl.append(float(lv))
    topt = torch.optim.Adam(p.ex.parameters(), lr=lr)
    tl = []
    for k in range(K):
        pred = p.ode.odeint_adjoint(torch.from_numpy(ys[k]), t_out)
        loss = torch.mean(torch.abs(pred - torch.from_numpy(tgts[k])))
        topt.zero_grad()
        loss.backward()
        topt.step()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    for a, b in zip(p.tleaves(dict(p.ex.named_parameters())),
                    p.jleaves(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_frozen_jacobian_through_the_stencil_op_is_the_roll_chains():
    """The memoized frozen J of a Burgers solve at fp32 (the J that a card
    assembles through K10) equals the roll chain's bitwise, and the fused
    ARK step gate stays closed at nx 512 (K3 needs more shared memory than
    a block has)."""
    Js = []
    for fused in (False, True):
        pt.clear_options()
        pt.init(["p", "-snes_type", "ksponly"])
        im = BurgersFuncIM(nx=24, use_fused=fused)
        ex = BurgersFuncEX(nx=24, use_fused=True)
        ode = pt.ODESolver().setupTS(
            torch.zeros(3, 24), pt.TorchFunc(im), step_size=DT,
            method="imex", imex_form=True, func2=pt.TorchFunc(ex),
            linear_solver="hpddm", fixed_jacobian=True, batch_size=3)
        stp = ode._stepper.prepare(0.0, torch.zeros(3, 24),
                                   ({}, dict(ex.named_parameters())),
                                   dt0=DT)
        Js.append(stp.setup.frozen_J_blocks)
    assert Js[0].dtype == torch.float32 and torch.equal(Js[0], Js[1])
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_fits

    assert fused_ark_fits(24, [27] * 4 + [24], 4)
    assert not fused_ark_fits(512, [576] * 4 + [512], 4)


# -- the trainers on the CPU ----------------------------------------------------

def _run(script, *flags, timeout=300):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *flags],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_burgers_trainer_runs_on_cpu(tmp_path):
    out = _run("burgers_torch.py", "--device", "cpu", "--nx", "32",
               "--batch_size", "4", "--batch_time", "2", "--step_size",
               "0.05", "--epochs", "2", "--iters_per_epoch", "2",
               "--train_dir", str(tmp_path),
               # the trainer's defaults before slice 4(b)
               "--linear_solver", "hpddm", "--fixed_jacobian")
    final = float(out.strip().splitlines()[-1].split()[-1])
    test = float([ln for ln in out.splitlines()
                  if ln.startswith("Epoch")][-1].split("Test")[1].split()[0])
    assert np.isfinite(final) and np.isfinite(test), out


@pytest.mark.parametrize("model", ["snode", "mlp"])
def test_ks_trainer_single_function_models(model, tmp_path):
    out = _run("ks_torch.py", "--device", "cpu", "--max_epochs", "1",
               "--data_size", "80", "--batch_size", "16", "--pnode_model",
               model, "--pnode_method", "rk4", "--train_dir", str(tmp_path),
               # the trainer's defaults before slice 4(b)
               "--linear_solver", "hpddm", "--fixed_jacobian")
    line = [ln for ln in out.splitlines() if ln.startswith("Epoch")][-1]
    assert np.isfinite(float(line.split("Val")[1].split("|")[0])), out
