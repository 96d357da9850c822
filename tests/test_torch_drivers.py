"""The port's drivers against the JAX package's, in fp64 on the CPU.

- examples/spiral_torch.py, spiral_unstable_torch.py and rober_torch.py
  against examples/spiral.py, spiral_unstable.py and rober.py (each JAX
  driver imported as a module, its flags in ``sys.argv``): the data
  (spiral's ``true_y``, spiral_unstable's CN data, rober's normalized
  ``solve_ivp`` data), the windows drawn by the same numpy generator, and
  from the same weights (flax's, carried by ``convert.py``) the first loss,
  the first gradient and the first optimizer update (optax's rmsprop or
  adam against the port's), all at rtol 1e-10; each trainer on the CPU, and
  rober's ``--hotstart`` with its normalization guard.
- examples/ks_torch.py and burgers_torch.py default to examples/ks.py's and
  burgers.py's configuration (snode, cn, petsc, an unfrozen Jacobian;
  ARK3 IMEX with Newton on GMRES), and one adjoint gradient at those
  defaults at a tiny size equals the JAX computation's (loss 1e-10,
  gradients 1e-8).
"""

import importlib.util
import os
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
from pnode_tpu.models import KSSnodeFunc as JKSSnodeFunc
from pnode_tpu_torch.convert import dense_stack_from_flax, state_dict_from_flax
from pnode_tpu_torch.models import BurgersFuncEX, BurgersFuncIM, KSSnodeFunc
from pnode_tpu_torch.utils import load_checkpoint
from pnode_tpu_torch.utils.optim import RMSprop

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def _load(name, argv=None):
    """examples/<name>.py as a module; a JAX driver parses ``argv`` at
    import, so it goes into sys.argv for the import."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.argv
    sys.argv = [f"{name}.py"] + list(argv or [])
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    pnode_tpu.clear_options()
    return mod


def _np64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _close_params(module, jax_params, prefix=""):
    """module's parameters (and .grad with grads=True) against a flax Dense
    stack's, all at RTOL."""
    ref = dense_stack_from_flax(_np64(jax_params), prefix)
    got = dict(module.named_parameters())
    assert got.keys() == ref.keys()
    for name, prm in got.items():
        assert _rel(prm.detach().numpy(), ref[name].numpy()) <= RTOL, name


def _close_grads(module, jax_grads):
    ref = dense_stack_from_flax(_np64(jax_grads))
    for name, prm in module.named_parameters():
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= RTOL, name


# -- spiral ---------------------------------------------------------------------

SPIRAL_ARGS = ["--data_size", "100", "--batch_time", "5", "--batch_size", "4"]


def test_spiral_first_step_matches_spiral_py():
    """spiral_torch.py's data, first window, loss, gradient and RMSprop
    update against spiral.py's (dopri5 with the discrete adjoint,
    optax.rmsprop), rtol 1e-10."""
    js = _load("spiral", ["--cpu", "--double_prec"] + SPIRAL_ARGS)
    sp = _load("spiral_torch")
    args, _ = sp.parse_args(["--device", "cpu", "--double_prec"]
                            + SPIRAL_ARGS)
    t = np.linspace(0.0, sp.T_END, args.data_size)
    np.testing.assert_array_equal(t, js.t)
    true_y = sp.ground_truth(t, torch.float64, "cpu")
    np.testing.assert_allclose(true_y.numpy(), np.asarray(js.true_y),
                               rtol=RTOL, atol=1e-13)

    # the JAX example: one draw sizes the solver, the loop draws the next
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    jy0_s, jbt, _ = js.get_batch(rng_j)
    jy0, _, jy = js.get_batch(rng_j)
    y0_s, window_t, _ = sp.get_batch(rng_t, true_y, t, args.data_size,
                                     args.batch_time, args.batch_size)
    y0, _, by = sp.get_batch(rng_t, true_y, t, args.data_size,
                             args.batch_time, args.batch_size)
    np.testing.assert_array_equal(window_t, jbt)
    np.testing.assert_allclose(by.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=1e-13)

    func = js.ODEFunc()
    params = _np64(func.init(jax.random.PRNGKey(0), 0.0, js.true_y0[None]))
    jode = JODESolver()
    jode.setupTS(jy0_s, FlaxFunc(func, params), step_size=args.step_size,
                 method="dopri5", enable_adjoint=True)

    def jloss(p):
        pred = jode.odeint_adjoint(jy0, jbt, params=p)
        return jnp.mean(jnp.abs(pred - jy))

    jl, jg = jax.value_and_grad(jloss)(params)
    opt = optax.rmsprop(args.lr)
    upd, _ = opt.update(jg, opt.init(params))
    jnew = optax.apply_updates(params, upd)

    mod = sp.ODEFunc(dtype=torch.float64)
    mod.load_state_dict(dense_stack_from_flax(params))
    ode, _ = sp.make_solvers(mod, y0_s, true_y[0], args)
    opt_t = RMSprop(mod.parameters(), lr=args.lr)
    loss = sp.train_step(ode, opt_t, y0, window_t, by)
    assert float(loss) == pytest.approx(float(jl), rel=RTOL)
    _close_grads(mod, jg)
    _close_params(mod, jnew)


def test_spiral_torch_trains_on_the_cpu(tmp_path):
    sp = _load("spiral_torch")
    out = sp.main(["--device", "cpu", "--double_prec", "--niters", "4",
                   "--test_freq", "2", "--train_dir", str(tmp_path)]
                  + SPIRAL_ARGS)
    assert len(out["losses"]) == 4 and [i for i, _ in out["test"]] == [2, 4]
    assert np.all(np.isfinite(out["losses"])) and np.isfinite(out["final"])


# -- spiral_unstable --------------------------------------------------------------

UNSTABLE_ARGS = ["--data_size", "40", "--batch_time", "4", "--batch_size",
                 "3"]


def test_spiral_unstable_first_step_matches_jax():
    """spiral_unstable_torch.py against spiral_unstable.py: the CN data, and
    from the seed-42 weights the first loss, gradient norm, gradient and
    update of both paths (CN with the discrete adjoint; autograd through
    dopri5), rtol 1e-10."""
    js = _load("spiral_unstable", ["--cpu", "--double_prec"] + UNSTABLE_ARGS)
    su = _load("spiral_unstable_torch")
    args, _ = su.parse_args(["--device", "cpu", "--double_prec"]
                            + UNSTABLE_ARGS)
    assert args.seed == js.args.seed == 42 and args.method == "cn"
    t = np.linspace(0.0, su.T_END, args.data_size)
    np.testing.assert_array_equal(t, js.t)
    data_ode = JODESolver()
    data_ode.setupTS(js.true_y0, lambda tt, y: (y ** 3) @ js.true_A,
                     step_size=args.step_size / 4, method="cn",
                     implicit_form=True, enable_adjoint=False)
    jtrue = data_ode.odeint(js.true_y0, t)
    true_y = su.ground_truth(t, args.step_size, torch.float64, "cpu")
    np.testing.assert_allclose(true_y.numpy(), np.asarray(jtrue), rtol=RTOL,
                               atol=1e-13)

    s = np.random.default_rng(42).choice(args.data_size - args.batch_time,
                                         size=args.batch_size, replace=False)
    jy0 = jtrue[s]
    jyt = jnp.stack([jtrue[s + i] for i in range(args.batch_time)])
    y0, yt = su.get_batch(np.random.default_rng(42), true_y, args.data_size,
                          args.batch_time, args.batch_size)
    window_t = t[:args.batch_time] - t[0]
    func = js.ODEFunc()
    params = _np64(func.init(jax.random.PRNGKey(42), 0.0, js.true_y0[None]))
    opt = optax.rmsprop(args.lr)

    for adjoint, method in ((True, "cn"), (False, "dopri5")):
        jode = JODESolver()
        jode.setupTS(jnp.zeros((args.batch_size, 2)), FlaxFunc(func, params),
                     step_size=args.step_size, method=method,
                     implicit_form=adjoint, enable_adjoint=adjoint)

        def jloss(p):
            if adjoint:
                pred = jode.odeint_adjoint(jy0, window_t, params=p)
            else:
                pred, _ = jode.solve(jy0, window_t, params=p,
                                     with_adjoint=False)
            return jnp.mean(jnp.abs(pred - jyt))

        jl, jg = jax.value_and_grad(jloss)(params)
        upd, _ = opt.update(jg, opt.init(params))
        jnew = optax.apply_updates(params, upd)

        mod = su.ODEFunc(dtype=torch.float64)
        mod.load_state_dict(dense_stack_from_flax(params))
        ode = su.make_solvers(mod, args, torch.float64, "cpu")[
            0 if adjoint else 1]
        opt_t = RMSprop(mod.parameters(), lr=args.lr)
        loss, gnorm = su.train_step(ode, adjoint, opt_t,
                                    list(mod.parameters()), y0, window_t, yt)
        assert loss == pytest.approx(float(jl), rel=RTOL), method
        assert gnorm == pytest.approx(float(optax.global_norm(jg)), rel=RTOL)
        _close_grads(mod, jg)
        _close_params(mod, jnew)


def test_spiral_unstable_torch_trains_on_the_cpu():
    su = _load("spiral_unstable_torch")
    out = su.main(["--device", "cpu", "--double_prec", "--niters", "2",
                   "--test_freq", "1"] + UNSTABLE_ARGS)
    assert len(out["pnode"]) == len(out["ref"]) == 2
    assert np.all(np.isfinite(out["pnode"] + out["ref"]))


# -- rober -------------------------------------------------------------------------

ROBER_ARGS = ["--data_size", "6"]


@pytest.mark.parametrize("normalize", ["minmax", "mean"])
def test_rober_first_step_matches_rober_py(normalize):
    """rober_torch.py against rober.py: the grids, the normalized BDF data,
    and from the same weights the first loss, gradient norm, gradient and
    Adam update (CN, implicit form, GMRES), rtol 1e-10."""
    flags = ROBER_ARGS + ["--normalize", normalize]
    jr = _load("rober", ["--cpu", "--double_prec"] + flags)
    ro = _load("rober_torch")
    args, _ = ro.parse_args(["--device", "cpu", "--double_prec"] + flags)
    t_obs, step_size = ro.time_grids(args.data_size, args.steps_per_data_point)
    np.testing.assert_array_equal(t_obs, jr.t_obs)
    np.testing.assert_array_equal(step_size, jr.step_size)

    # rober.py main()'s data
    from scipy.integrate import solve_ivp

    path = solve_ivp(jr.rober_rhs, [0, jr.endtime * 1.1],
                     np.array([1.0, 0.0, 0.0]), t_eval=jr.t_obs,
                     jac=jr.rober_jac, method="BDF", rtol=1e-11, atol=1e-14)
    jdata = path["y"].T
    if normalize == "minmax":
        shift = jdata.min(0, keepdims=True)
        jdata = (jdata - shift) / (jdata.max(0, keepdims=True) - shift)
    else:
        jdata = ((jdata - jdata.mean(0, keepdims=True))
                 / jdata.std(0, keepdims=True))
    data, _, _ = ro.rober_data(t_obs, normalize)
    np.testing.assert_allclose(data, jdata, rtol=RTOL, atol=1e-14)

    true_y = jnp.asarray(jdata)
    func = jr.ODEFunc()
    params = _np64(func.init(jax.random.PRNGKey(0), 0.0, true_y[0]))
    jode = JODESolver()
    jode.setupTS(true_y[0], FlaxFunc(func, params), step_size=jr.step_size,
                 method="cn", implicit_form=True, linear_solver="petsc",
                 enable_adjoint=True)

    def jloss(p):
        pred = jode.odeint_adjoint(true_y[0], t_obs, params=p)
        return jnp.mean(jnp.abs(pred - true_y))

    jl, jg = jax.value_and_grad(jloss)(params)
    opt = optax.adam(args.lr)
    upd, _ = opt.update(jg, opt.init(params))
    jnew = optax.apply_updates(params, upd)

    mod = ro.ODEFunc(dtype=torch.float64)
    mod.load_state_dict(dense_stack_from_flax(params))
    ty = torch.tensor(data)
    ode = ro.make_solver(mod, ty[0], step_size, args)
    opt_t = torch.optim.Adam(mod.parameters(), lr=args.lr)
    loss, gnorm = ro.train_step(ode, mod, opt_t, ty[0], t_obs, ty)
    assert loss == pytest.approx(float(jl), rel=RTOL)
    assert gnorm == pytest.approx(float(optax.global_norm(jg)), rel=RTOL)
    _close_grads(mod, jg)
    _close_params(mod, jnew)


def test_rober_gelu_is_flax_gelu():
    """flax's nn.gelu is the tanh form; the port's net uses it too."""
    x = np.linspace(-4.0, 4.0, 41)
    got = torch.nn.functional.gelu(torch.tensor(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-10, atol=1e-15)


def test_rober_torch_checkpoints_and_hotstart(tmp_path):
    """The trainer on the CPU: Iter lines and metrics.jsonl every
    --test_freq, the best checkpoint, --hotstart resuming after its
    iteration, and a checkpoint of another normalization refused."""
    ro = _load("rober_torch")
    common = ["--device", "cpu", "--double_prec", "--test_freq", "2",
              "--train_dir", str(tmp_path)] + ROBER_ARGS
    out = ro.main(common + ["--niters", "3"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    ck = load_checkpoint(str(tmp_path / "best.ckpt"))
    assert ck["normalize"] == "minmax" and ck["iter"] in (0, 2)
    tags = [ln for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(tags) == 4  # Train/Loss and Train/Gradient at iters 0 and 2
    out = ro.main(common + ["--niters", "5", "--hotstart"])
    assert out["start"] == ck["iter"] + 1
    assert len(out["losses"]) == 5 - out["start"]
    with pytest.raises(RuntimeError, match="normalization mismatch"):
        ro.main(common + ["--niters", "6", "--hotstart", "--normalize",
                          "mean"])


# -- the trainers at their new defaults ----------------------------------------

def test_ks_torch_defaults_are_ks_py_defaults():
    """ks_torch.py parses to ks.py's configuration (snode, cn, petsc, no
    frozen Jacobian), and one adjoint gradient of that configuration (snode
    at hidden 16, batch 4) equals ks.py's (loss 1e-10, gradients 1e-8)."""
    jk = _load("ks", ["--cpu"])
    args, _ = _load("ks_torch").parse_args([])
    for key in ("pnode_model", "pnode_method", "linear_solver",
                "fixed_jacobian", "step_size", "batch_size", "lr",
                "time_window_size", "seed"):
        assert getattr(args, key) == getattr(jk.args, key), key
    assert args.device == "cuda" and args.use_fused
    B, H = 4, 16
    rng = np.random.default_rng(3)
    y0 = rng.normal(size=(B, 64))
    tgt = rng.normal(size=(B, 1, 64))
    t_out = np.array([0.0, args.step_size])
    jmod = JKSSnodeFunc(nx=64, L=22.0, hidden=H)
    jparams = _np64(jmod.init(jax.random.PRNGKey(0), 0.0, jnp.zeros((B, 64))))
    setup = dict(step_size=args.step_size, method=args.pnode_method,
                 implicit_form=True, linear_solver=args.linear_solver,
                 fixed_jacobian=args.fixed_jacobian, batch_size=B)
    jode = JODESolver()
    jode.setupTS(jnp.zeros((B, 64)), FlaxFunc(jmod, jparams), **setup)

    def jloss(pp):
        pred = jode.odeint_adjoint(jnp.asarray(y0), jnp.asarray(t_out),
                                   params=pp)
        return jnp.mean((jnp.swapaxes(pred[1:], 0, 1) - tgt) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    mod = KSSnodeFunc(nx=64, L=22.0, hidden=H, dtype=torch.float64,
                      use_fused=args.use_fused)
    mod.load_state_dict(state_dict_from_flax(jparams))
    ode = pt.ODESolver().setupTS(torch.zeros(B, 64, dtype=torch.float64),
                                 pt.TorchFunc(mod), **setup)
    pred = ode.odeint_adjoint(torch.tensor(y0), t_out)
    loss = torch.mean((pred[1:].transpose(0, 1) - torch.tensor(tgt)) ** 2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-10)
    ref = state_dict_from_flax(_np64(jg))
    for name, prm in mod.named_parameters():
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= 1e-8, name


def test_burgers_torch_defaults_are_burgers_py_defaults():
    """burgers_torch.py parses to burgers.py's configuration (ARK3 IMEX,
    petsc, no frozen Jacobian, Newton: no ksponly), and one adjoint
    gradient of that configuration at nx 32, batch 3, a two-output window
    equals burgers.py's (loss 1e-10, gradients 1e-8)."""
    jb = _load("burgers", ["--cpu"])
    bt = _load("burgers_torch")
    args, _ = bt.parse_args([])
    for key in ("method", "imex", "linear_solver", "fixed_jacobian",
                "step_size", "batch_size", "batch_time", "lr", "seed"):
        assert getattr(args, key) == getattr(jb.args, key), key
    B, nx, step = 3, 32, 0.05
    rng = np.random.default_rng(5)
    y0 = rng.normal(size=(B, nx))
    target = rng.normal(size=(2, B, nx))
    window_t = np.arange(2) * bt.DT_DATA
    jim, jex = JBurgersFuncIM(nx=nx), JBurgersFuncEX(nx=nx)
    key = jax.random.PRNGKey(0)
    vim = _np64(jim.init(key, 0.0, jnp.zeros((B, nx))))
    vex = _np64(jex.init(key, 0.0, jnp.zeros((B, nx))))
    setup = dict(step_size=step, method=args.method, imex_form=True,
                 implicit_form=True, linear_solver=args.linear_solver,
                 fixed_jacobian=args.fixed_jacobian, batch_size=B)
    jode = JODESolver()
    jode.setupTS(jnp.zeros((B, nx)), FlaxFunc(jim, vim),
                 func2=FlaxFunc(jex, vex), **setup)

    def jloss(pex):
        pred = jode.odeint_adjoint(jnp.asarray(y0), window_t,
                                   params=(vim, pex))
        return jnp.mean(jnp.abs(pred - target))

    jl, jg = jax.value_and_grad(jloss)(vex)
    im = BurgersFuncIM(nx=nx, use_fused=args.use_fused, dtype=torch.float64)
    # f_EX in the layout of flax's StackedMLP (the fused module keeps the
    # FusedStackedMLP one); the stencil as the trainer runs it
    ex = BurgersFuncEX(nx=nx, dtype=torch.float64)
    ex.load_state_dict(state_dict_from_flax(vex))
    ode = pt.ODESolver().setupTS(torch.zeros(B, nx, dtype=torch.float64),
                                 pt.TorchFunc(im), func2=pt.TorchFunc(ex),
                                 **setup)
    assert not ode.newton_cfg.ksponly and ode.lin_cfg.kind == "gmres"
    pred = ode.odeint_adjoint(torch.tensor(y0), window_t)
    loss = torch.mean(torch.abs(pred - torch.tensor(target)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-10)
    ref = state_dict_from_flax(_np64(jg))
    for name, prm in ex.named_parameters():
        assert _rel(prm.grad.numpy(), ref[name].numpy()) <= 1e-8, name


def test_burgers_torch_trains_at_its_defaults_on_the_cpu(tmp_path):
    """burgers_torch.py at its defaults but the sizes, on the CPU: finite
    losses through Newton on GMRES."""
    bt = _load("burgers_torch")
    final = bt.main(["--device", "cpu", "--nx", "32", "--batch_size", "4",
                     "--batch_time", "2", "--step_size", "0.05", "--epochs",
                     "1", "--iters_per_epoch", "2", "--n_ic", "3",
                     "--train_dir", str(tmp_path)])
    assert np.isfinite(final)
