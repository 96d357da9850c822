"""The port's solver stack against the JAX package: dense stage solves,
Newton, the ARK-IMEX step and its adjoint, odeint_adjoint gradients, and
the slice-1 done criterion -- 4 Adam steps of KS training, port (torch.optim
.Adam) against JAX + optax.adam (the twin of tests/test_fused_train_loop.py::
test_fused_train_loop_matches_reference).

fp64 on the generic path: rtol 1e-10 (steps, gradients), atol 1e-9 (losses
and parameters after Adam). fp32 on the fused path (the port's plain
versions of K2/K3 against JAX's Pallas kernels in interpret mode): the
reference's tolerances (gradients rtol 2e-4 / atol 1e-6; losses rtol 2e-5,
parameters rtol 3e-5 / atol 1e-6 after Adam)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pnode_tpu
import pnode_tpu.linsolve as jlin
import pnode_tpu_torch as pt
import pnode_tpu_torch.linsolve as tlin
from pnode_tpu import FlaxFunc
from pnode_tpu import ODESolver as JODESolver
from pnode_tpu.models import KSFuncEX as JKSFuncEX
from pnode_tpu.models import KSFuncIM as JKSFuncIM
from pnode_tpu_torch.convert import state_dict_from_flax
from pnode_tpu_torch.misc import tree_leaves
from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

torch.set_num_threads(1)
F64 = (jnp.float64, torch.float64)
F32 = (jnp.float32, torch.float32)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


class Pair:
    """The same KS IMEX problem built in both packages from one flax init."""

    def __init__(self, B, nx, hidden, dtypes, flags=(), fused=True,
                 tableau="3", fused_mode="off", linear_solver="hpddm",
                 fixed_jacobian=True, w_scale=0.02):
        jdt, tdt = dtypes
        self.B, self.nx, self.jdt, self.tdt = B, nx, jdt, tdt
        pnode_tpu.clear_options()
        pnode_tpu.init(["p", "-ts_arkimex_type", tableau,
                        "-pnode_fused_ark_precision", "highest",
                        "-pnode_fused_ark_adjoint", fused_mode]
                       + list(flags))
        jim = JKSFuncIM(nx=nx)
        jex = JKSFuncEX(nx=nx, hidden=hidden, use_pallas=fused)
        tmpl = jnp.zeros((B, nx), jdt)
        vim = jim.init(jax.random.PRNGKey(0), 0.0, tmpl)
        vex = jex.init(jax.random.PRNGKey(1), 0.0, tmpl)
        # nonzero biases, and weights large enough that the gradients sit
        # well above Adam's eps (where its update is insensitive to rounding)
        # (in numpy: each eager jnp op would compile once per leaf shape)
        vex = jax.tree_util.tree_map(
            lambda a: jnp.asarray((np.asarray(a) + w_scale * np.cos(
                np.arange(a.size).reshape(a.shape))).astype(jdt)), vex)
        vim = jax.tree_util.tree_map(lambda a: a.astype(jdt), vim)
        self.jparams = (vim, vex)
        self.jode = JODESolver()
        self.jode.setupTS(tmpl, FlaxFunc(jim, vim), step_size=0.2,
                          method="imex", imex_form=True, implicit_form=True,
                          func2=FlaxFunc(jex, vex),
                          linear_solver=linear_solver,
                          fixed_jacobian=fixed_jacobian, batch_size=B)

        pt.clear_options()
        pt.init(["p", "-ts_arkimex_type", tableau] + list(flags)
                + (["-pnode_fused_ark_adjoint", "off"]
                   if fused_mode == "off" else []))
        self.im = KSFuncIM(nx=nx).to(tdt)
        self.ex = KSFuncEX(nx=nx, hidden=hidden, use_fused=fused).to(tdt)
        self.ex.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, vex)))
        self.ode = pt.ODESolver()
        self.ode.setupTS(torch.zeros(B, nx, dtype=tdt), pt.TorchFunc(self.im),
                         step_size=0.2, method="imex", imex_form=True,
                         implicit_form=True, func2=pt.TorchFunc(self.ex),
                         linear_solver=linear_solver,
                         fixed_jacobian=fixed_jacobian, batch_size=B)

    @property
    def tparams(self):
        return ({}, dict(self.ex.named_parameters()))

    def data(self, seed, K=None):
        rng = np.random.default_rng(seed)
        shape = (self.B, self.nx) if K is None else (K, self.B, self.nx)
        y = rng.normal(size=shape)
        tgt = y + 0.05 * rng.normal(size=shape)
        return y.astype(np.dtype(self.jdt)), tgt.astype(np.dtype(self.jdt))

    def jleaves(self, tree):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree[1])]

    def tleaves(self, tree):
        # flax leaves are sorted by name (Dense_i/bias before Dense_i/kernel,
        # a kernel being nn.Linear's weight transposed); match that order
        return [tree[1][k].detach().numpy().T if k.endswith(".weight")
                else tree[1][k].detach().numpy() for k in sorted(tree[1])]


# -- dense stage solves ---------------------------------------------------------

@pytest.mark.parametrize("use_inverse", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_dense_stage_solver_matches_jax(use_inverse, shared):
    rng = np.random.default_rng(0)
    d, batch = 6, 3
    Jb = rng.normal(size=(1 if shared else batch, d, d))
    rhs = rng.normal(size=batch * d)
    js = jlin.DenseStageSolver(jnp.asarray(Jb), None, 1.0, 0.3, batch * d,
                               use_inverse=use_inverse)
    ts = tlin.DenseStageSolver(torch.from_numpy(Jb), None, 1.0, 0.3,
                               batch * d, use_inverse=use_inverse)
    for name in ("solve", "solve_transpose"):
        ref = np.asarray(getattr(js, name)(jnp.asarray(rhs)))
        got = getattr(ts, name)(torch.from_numpy(rhs)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shared", [True, False])
def test_assemble_block_jacobian_matches_jax(shared):
    from pnode_tpu.models.sinode import circular_stencil_apply as jst
    from pnode_tpu_torch.models.sinode import circular_stencil_apply as tst

    rng = np.random.default_rng(1)
    k, y = rng.normal(size=5), rng.normal(size=(3, 8))

    def jf(z):
        zz = z.reshape(3, 8)
        return (jst(zz, jnp.asarray(k)) + 0.1 * zz ** 2).reshape(-1)

    def tf(z):
        zz = z.reshape(3, 8)
        return (tst(zz, torch.from_numpy(k)) + 0.1 * zz ** 2).reshape(-1)

    cfg_j = jlin.LinearSolveConfig(kind="block", block_size=8)
    cfg_t = tlin.LinearSolveConfig(kind="block", block_size=8)
    ref = jlin.assemble_block_jacobian(jf, jnp.asarray(y).reshape(-1), cfg_j,
                                       shared)
    got = tlin.assemble_block_jacobian(tf, torch.from_numpy(y).reshape(-1),
                                       cfg_t, shared)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


# -- one step and its adjoint, fp64 generic path -----------------------------

STEP_CASES = [
    dict(flags=["-snes_type", "ksponly"]),
    dict(flags=[]),  # full Newton loop
    dict(flags=["-snes_type", "ksponly"], fused=False, tableau="ars122"),
    dict(flags=[], linear_solver="torch", fixed_jacobian=False),
]


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_and_step_adj_match_jax_fp64(case):
    p = Pair(6, 16, 24, F64, **case)
    y, _ = p.data(0)
    lam = np.random.default_rng(1).normal(size=y.shape)
    dt = 0.2
    jstp = p.jode._stepper.prepare(0.0, jnp.asarray(y), p.jparams, dt0=dt)
    tstp = p.ode._stepper.prepare(0.0, torch.from_numpy(y), p.tparams, dt0=dt)
    y1_j, aux_j, st_j = jstp._step_generic(0.0, dt, jnp.asarray(y), p.jparams)
    with torch.no_grad():
        y1_t, aux_t, st_t = tstp._step_generic(0.0, dt, torch.from_numpy(y),
                                               p.tparams)
    np.testing.assert_allclose(y1_t.numpy(), np.asarray(y1_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-10,
                               atol=1e-12)
    assert st_t.newton_iters == int(st_j.newton_iters)
    assert st_t.newton_converged == bool(st_j.newton_converged)
    lp_j, (_, g_j) = jstp.step_adj(0.0, dt, jnp.asarray(y), p.jparams, aux_j,
                                   jnp.asarray(lam))
    with torch.no_grad():
        lp_t, (_, g_t) = tstp.step_adj(0.0, dt, torch.from_numpy(y),
                                       p.tparams, aux_t,
                                       torch.from_numpy(lam))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10,
                               atol=1e-12)
    for a, b in zip(p.tleaves((None, g_t)), p.jleaves((None, g_j))):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


# -- odeint_adjoint gradients ------------------------------------------------

def _grads_both(p, t_out, weights=(0.0, 1.0, 1.0)):
    """Loss sum_i w_i sum(pred[i]^2) + sum|pred[-1]| through both solvers;
    returns ((loss, dy0, dparams) JAX, (...) port)."""
    y, _ = p.data(2)

    def jloss(y0, prm):
        pred, _ = p.jode.solve(y0, t_out, params=prm)
        return (sum(w * jnp.sum(pred[i] ** 2) for i, w in enumerate(weights))
                + jnp.sum(jnp.abs(pred[-1])))

    lj, (gy_j, gp_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(y), p.jparams)
    y0 = torch.from_numpy(y).requires_grad_(True)
    pred = p.ode.odeint_adjoint(y0, t_out)
    lt = (sum(w * torch.sum(pred[i] ** 2) for i, w in enumerate(weights))
          + torch.sum(torch.abs(pred[-1])))
    lt.backward()
    gp_t = ({}, {k: v.grad for k, v in p.ex.named_parameters()})
    return (float(lj), np.asarray(gy_j), p.jleaves(gp_j)), \
        (float(lt.detach()), y0.grad.numpy(), p.tleaves(gp_t))


@pytest.mark.parametrize("flags", [["-snes_type", "ksponly"],
                                   ["-snes_type", "ksponly",
                                    "-ts_trajectory_solution_only", "1"]])
def test_odeint_adjoint_gradients_fp64_interior_outputs(flags):
    p = Pair(5, 16, 24, F64, flags=flags)
    (lj, gyj, gpj), (lt, gyt, gpt) = _grads_both(p, np.array([0.0, 0.4, 0.8]))
    np.testing.assert_allclose(lt, lj, rtol=1e-12)
    np.testing.assert_allclose(gyt, gyj, rtol=1e-10, atol=1e-12)
    for a, b in zip(gpt, gpj):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_odeint_adjoint_gradients_fp32_fused_path():
    """The port's fused path (plain K2/K3 on the CPU) against JAX's fused
    Pallas kernels in interpret mode."""
    p = Pair(8, 16, 24, F32, flags=["-snes_type", "ksponly"],
             fused_mode="interpret")
    y = torch.zeros(8, 16)
    stp = p.ode._stepper.prepare(0.0, y, p.tparams, dt0=0.2)
    assert stp._fused_reverse_args(p.tparams) is not None
    (lj, gyj, gpj), (lt, gyt, gpt) = _grads_both(p, np.array([0.0, 0.6]),
                                                 weights=(0.0, 1.0))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(gyt, gyj, rtol=2e-4, atol=1e-6)
    for a, b in zip(gpt, gpj):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


def test_live_module_and_params_override_agree():
    p = Pair(4, 16, 24, F64, flags=["-snes_type", "ksponly"])
    y, tgt = p.data(3)
    t_out = np.array([0.0, 0.2])
    pred = p.ode.odeint_adjoint(torch.from_numpy(y), t_out)
    torch.sum((pred[-1] - torch.from_numpy(tgt)) ** 2).backward()
    live = {k: v.grad.clone() for k, v in p.ex.named_parameters()}
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.ex.named_parameters()}
    pred2 = p.ode.odeint_adjoint(torch.from_numpy(y), t_out,
                                 params=({}, params))
    torch.sum((pred2[-1] - torch.from_numpy(tgt)) ** 2).backward()
    for k in live:
        torch.testing.assert_close(params[k].grad, live[k], rtol=0, atol=0)
    stats = p.ode.last_stats
    assert stats.newton_iters == 3 and stats.newton_converged
    with torch.no_grad():
        assert not p.ode.odeint(torch.from_numpy(y), t_out).requires_grad


# -- the slice: 4 Adam steps of KS training ------------------------------------

def _adam_both(p, K, lr=5e-3, eps=1e-8):
    ys, tgts = p.data(7, K)
    t_out = np.array([0.0, 0.2])
    opt = optax.adam(lr, eps=eps)
    jp = p.jparams
    state = opt.init(jp)
    jl, jg = [], []

    @jax.jit  # one compile, where eager optax compiles each op per shape
    def adam_step(prm, state, y, tgt):
        def loss_fn(prm):
            pred, _ = p.jode.solve(y, t_out, params=prm)
            return jnp.mean((pred[-1] - tgt) ** 2)
        lv, g = jax.value_and_grad(loss_fn)(prm)
        upd, state = opt.update(g, state)
        return optax.apply_updates(prm, upd), state, lv, g

    for k in range(K):
        jp, state, lv, g = adam_step(jp, state, jnp.asarray(ys[k]),
                                     jnp.asarray(tgts[k]))
        jl.append(float(lv))
        jg.append(p.jleaves(g))
    topt = torch.optim.Adam(p.ex.parameters(), lr=lr, eps=eps)
    tl, tg = [], []
    for k in range(K):
        pred = p.ode.odeint_adjoint(torch.from_numpy(ys[k]), t_out)
        loss = torch.mean((pred[-1] - torch.from_numpy(tgts[k])) ** 2)
        topt.zero_grad()
        loss.backward()
        tg.append(p.tleaves(({}, {n: q.grad for n, q in
                                  p.ex.named_parameters()})))
        topt.step()
        tl.append(float(loss.detach()))
    return (jl, jg, p.jleaves(jp)), (tl, tg, p.tleaves(p.tparams))


def test_slice_adam_steps_match_jax_fp64_generic():
    p = Pair(8, 16, 104, F64, flags=["-snes_type", "ksponly"])
    (jl, jg, jp), (tl, tg, tp) = _adam_both(p, 4)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-9)
    for a_k, b_k in zip(tg, jg):
        for a, b in zip(a_k, b_k):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-15)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_slice_adam_steps_match_jax_fp32_fused():
    """The reference test's own setting: the flax init as it is, Adam at
    its default eps."""
    p = Pair(8, 16, 104, F32, flags=["-snes_type", "ksponly"],
             fused_mode="interpret", w_scale=0.0)
    (jl, _, jp), (tl, _, tp) = _adam_both(p, 4)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=1e-6)


def test_slice_adam_steps_match_jax_fp32_fused_biased_weights():
    """Perturbed weights and nonzero biases. Adam moves a parameter by
    lr*g/(|g| + eps), which passes a gradient's rounding on amplified by up
    to lr/eps where |g| is below eps. Here, at the default eps 1e-8, the two
    fp32 evaluations end 3.3e-5 apart in some parameter after 4 steps, over
    the reference's atol 1e-6 + rtol 3e-5. Both sides use eps 1e-6, so the
    comparison measures the solver, not Adam's conditioning."""
    p = Pair(8, 16, 104, F32, flags=["-snes_type", "ksponly"],
             fused_mode="interpret", w_scale=0.1)
    (jl, _, jp), (tl, _, tp) = _adam_both(p, 4, eps=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=1e-6)


# -- what this slice does not run ----------------------------------------------

@pytest.mark.parametrize("kwargs, flags, match", [
    # the theta methods are ported; ARKIMEX still refuses a mass matrix, as
    # the JAX package's does (the case keeps its id)
    pytest.param(dict(mass=np.eye(8)), [], "ARKIMEX refuses",
                 id="kwargs0-flags0-slice 4"),
    # checkpointed trajectories run since slice 5(a); compressed storage
    # is slice 5(b) (the case keeps its id)
    pytest.param(dict(), ["-pnode_trajectory_dtype", "bfloat16"], "slice 5",
                 id="kwargs1-flags1-slice 5"),
    (dict(), ["-ts_trajectory_type", "disk"], "slice 5"),
    # the adaptive mode (slice 3) under a checkpointed policy (slice 5(b))
    pytest.param(dict(), ["-ts_adapt_type", "basic",
                          "-ts_trajectory_max_cps_ram", "4"], "slice 5",
                 id="kwargs3-flags3-slice 3"),
])
def test_later_slices_raise(kwargs, flags, match):
    pt.init(["p"] + flags)
    im, ex = KSFuncIM(nx=8), KSFuncEX(nx=8, hidden=4)
    setup = dict(step_size=0.2, method="imex", imex_form=True,
                 func2=pt.TorchFunc(ex), linear_solver="hpddm",
                 fixed_jacobian=True, batch_size=2)
    setup.update(kwargs)
    with pytest.raises(NotImplementedError, match=match):
        pt.ODESolver().setupTS(torch.zeros(2, 8), pt.TorchFunc(im), **setup)


def test_gmres_stage_solver_raises():
    """The matrix-free GMRES stage solver (the default linear_solver,
    petsc) raised until the theta slice; it now runs the IMEX step, and
    agrees with the direct dense solve (the test keeps its name)."""
    im = KSFuncIM(nx=8, dtype=torch.float64)
    ex = KSFuncEX(nx=8, hidden=4, dtype=torch.float64,
                  generator=torch.Generator().manual_seed(0))
    pt.init(["p", "-ksp_rtol", "1e-12"])
    sols = {}
    for solver in ("petsc", "torch"):
        ode = pt.ODESolver().setupTS(
            torch.zeros(2, 8, dtype=torch.float64), pt.TorchFunc(im),
            step_size=0.2, method="imex", imex_form=True,
            func2=pt.TorchFunc(ex), linear_solver=solver, batch_size=2)
        assert ode.lin_cfg.kind == {"petsc": "gmres",
                                    "torch": "direct"}[solver]
        with torch.no_grad():
            sols[solver] = ode.odeint(
                torch.linspace(-1, 1, 16, dtype=torch.float64).reshape(2, 8),
                np.array([0.0, 0.2]))
    np.testing.assert_allclose(sols["petsc"].numpy(), sols["torch"].numpy(),
                               rtol=1e-9, atol=1e-10)
    assert tree_leaves(({}, dict(ex.named_parameters())))

