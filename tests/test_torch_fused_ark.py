"""K2 and K3 (the fused ARK forward and reverse steps) and their gate.

The plain PyTorch versions (what the CUDA kernels are held to on the card)
against the JAX package's Pallas kernels in interpret mode, in fp32, for
tableaus "3" and "ars122", with ragged batches and nonzero biases, at the
reference's own tolerances (forward rtol 3e-5 / atol 1e-6,
tests/test_fused_ark_adjoint.py:183; reverse rtol 2e-4 / atol 1e-6, :80).
The gate tests twin tests/test_fused_ark_adjoint.py:110-161."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch as pt
from pnode_tpu.ops.fused_ark_adjoint import fused_ark_step_adj as j_adj
from pnode_tpu.ops.fused_ark_forward import fused_ark_step_fwd as j_fwd
from pnode_tpu.tableaus import get_ark_tableau
from pnode_tpu_torch.models import KSFuncEX, KSFuncIM
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    fused_ark_fits, fused_ark_step_adj, pick_weight_dtype,
)
from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _operands(tab_name, B, d=16, hidden=24, seed=0, dt=0.2):
    """Tableau, dt, state, J, inv and an MLP stack with nonzero biases, as
    fp32 numpy arrays shared by both packages."""
    tab = get_ark_tableau(tab_name)
    tbl = ([[float(x) for x in r] for r in tab.a_im],
           [[float(x) for x in r] for r in tab.a_ex],
           [float(x) for x in tab.b_im], [float(x) for x in tab.b_ex])
    gamma = [g for g in np.diag(tab.a_im) if g != 0.0][0]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    J = -(A @ A.T) * 2.0  # stiff, symmetric negative definite
    inv = np.linalg.inv(np.eye(d) - dt * gamma * J)
    dims = [d, hidden, hidden, hidden, d]
    Ws = [rng.normal(0, 0.3, size=(a, b)) for a, b in zip(dims, dims[1:])]
    bs = [0.1 * rng.normal(size=b) for b in dims[1:]]
    y = rng.normal(size=(B, d))
    lam = rng.normal(size=(B, d))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (tbl, float(np.float32(dt)), f32(y), f32(J), f32(inv),
            [f32(w) for w in Ws], [f32(b) for b in bs], f32(lam))


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [("3", 13), ("3", 5), ("ars122", 11)]


@pytest.mark.parametrize("tab_name, B", CASES)
def test_k2_plain_matches_jax_interpret(tab_name, B):
    tbl, dt, y, J, inv, Ws, bs, _ = _operands(tab_name, B)
    y1_j, ys_j = j_fwd(tbl, dt, jnp.asarray(y), jnp.asarray(J),
                       jnp.asarray(inv), [jnp.asarray(w) for w in Ws],
                       [jnp.asarray(b) for b in bs], activation="relu",
                       sign=-1.0, interpret=True, stiff_prec="highest")
    y1_t, ys_t = fused_ark_step_fwd(tbl, dt, _t(y), _t(J), _t(inv),
                                    [_t(w) for w in Ws], [_t(b) for b in bs],
                                    activation="relu", sign=-1.0)
    np.testing.assert_allclose(y1_t.numpy(), np.asarray(y1_j), rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=3e-5,
                               atol=1e-6)


@pytest.mark.parametrize("tab_name, B, dt", [("3", 13, 0.2), ("3", 5, 0.05),
                                             ("4", 11, 0.1)])
def test_k2_err_plain_matches_jax_interpret(tab_name, B, dt):
    """K2's embedded-error output (the adaptive trial step) against the JAX
    kernel's b_err output: y1 and Ys at the forward's tolerances, err
    within 1e-4 of max |err| (a small difference of stage sums whose
    implicit kI is the difference quotient (Y - G) / (dt a_ii))."""
    tbl, dt, y, J, inv, Ws, bs, _ = _operands(tab_name, B, seed=2, dt=dt)
    tab = get_ark_tableau(tab_name)
    b_err = ([float(x) for x in tab.b_im_err], [float(x) for x in tab.b_ex_err])
    y1_j, err_j, ys_j = j_fwd(tbl, dt, jnp.asarray(y), jnp.asarray(J),
                              jnp.asarray(inv), [jnp.asarray(w) for w in Ws],
                              [jnp.asarray(b) for b in bs], b_err=b_err,
                              interpret=True, stiff_prec="highest")
    y1_t, err_t, ys_t = fused_ark_step_fwd(
        tbl, dt, _t(y), _t(J), _t(inv), [_t(w) for w in Ws],
        [_t(b) for b in bs], b_err=b_err)
    np.testing.assert_allclose(y1_t.numpy(), np.asarray(y1_j), rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=3e-5,
                               atol=1e-6)
    err_j = np.asarray(err_j)
    assert float(np.abs(err_j).max()) > 0.0
    np.testing.assert_allclose(err_t.numpy(), err_j, rtol=0,
                               atol=1e-4 * float(np.abs(err_j).max()))


@pytest.mark.parametrize("tab_name, B", CASES)
def test_k3_plain_matches_jax_interpret(tab_name, B):
    tbl, dt, y, J, inv, Ws, bs, lam = _operands(tab_name, B, seed=1)
    _, ys = j_fwd(tbl, dt, jnp.asarray(y), jnp.asarray(J), jnp.asarray(inv),
                  [jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
                  interpret=True, stiff_prec="highest")
    ys = np.asarray(ys)
    lp_j, (dW_j, db_j) = j_adj(tbl, dt, jnp.asarray(ys), jnp.asarray(lam),
                               jnp.asarray(J), jnp.asarray(inv),
                               [jnp.asarray(w) for w in Ws],
                               [jnp.asarray(b) for b in bs],
                               activation="tanh", sign=-1.0, interpret=True,
                               stiff_prec="highest")
    lp_t, (dW_t, db_t) = fused_ark_step_adj(
        tbl, dt, _t(ys), _t(lam), _t(J), _t(inv), [_t(w) for w in Ws],
        [_t(b) for b in bs], activation="tanh", sign=-1.0)
    pairs = [(lp_t, lp_j)] + list(zip(dW_t, dW_j)) + list(zip(db_t, db_j))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=1e-6)


def test_k2_k3_plain_dt_zero_is_identity():
    tbl, _, y, J, inv, Ws, bs, lam = _operands("3", 6)
    y1, ys = fused_ark_step_fwd(tbl, 0.0, _t(y), _t(J), _t(inv),
                                [_t(w) for w in Ws], [_t(b) for b in bs])
    assert torch.equal(y1, _t(y))
    lp, (dWs, _) = fused_ark_step_adj(tbl, 0.0, ys, _t(lam), _t(J), _t(inv),
                                      [_t(w) for w in Ws],
                                      [_t(b) for b in bs])
    assert torch.equal(lp, _t(lam))
    assert all(float(dW.abs().max()) == 0.0 for dW in dWs)


def test_step_wrappers_reject_what_the_kernels_do_not_take():
    tbl, dt, y, J, inv, Ws, bs, _ = _operands("3", 4)
    W, b = [_t(w) for w in Ws], [_t(v) for v in bs]
    with pytest.raises(ValueError, match="embedded weights"):
        fused_ark_step_fwd(tbl, dt, _t(y), _t(J), _t(inv), W, b,
                           b_err=(tbl[2][:2], tbl[3]))
    with pytest.raises(ValueError, match="float32"):
        fused_ark_step_fwd(tbl, dt, _t(y).double(), _t(J), _t(inv), W, b)
    with pytest.raises(ValueError, match="J_dense"):
        fused_ark_step_fwd(tbl, dt, _t(y), _t(J)[:8], _t(inv), W, b)
    with pytest.raises(ValueError, match="Ys"):
        fused_ark_step_adj(tbl, dt, _t(y)[None], _t(y), _t(J), _t(inv), W, b)


def test_fits_from_the_kernels_shared_memory_budget():
    assert fused_ark_fits(64, [104] * 4 + [64], 4)      # KS: 29 / 42 KB
    assert fused_ark_fits(512, [576] * 4 + [512], 4, reverse=False)
    assert not fused_ark_fits(512, [576] * 4 + [512], 4)  # ~290 KB reverse
    assert not fused_ark_fits(64, [104] * 9 + [64], 4)  # > 8 layers
    assert not fused_ark_fits(64, [104] * 4 + [64], 9)  # > 8 stages
    assert pick_weight_dtype(64, [104] * 4 + [64], 4) == "f32"
    assert pick_weight_dtype(512, [576] * 4 + [512], 4) is None
    pt.init(["p", "-pnode_fused_ark_weights", "bf16"])
    with pytest.raises(ValueError, match="not ported"):
        pick_weight_dtype(64, [104] * 4 + [64], 4)


# -- the gate (twins of tests/test_fused_ark_adjoint.py:110-161) -------------

def _ode(flags, B=4, nx=16, hidden=8, fused=True, fixed=True):
    pt.clear_options()
    pt.init(["p"] + list(flags))
    im = KSFuncIM(nx=nx, fixed_linear=fixed,
                  generator=torch.Generator().manual_seed(0))
    ex = KSFuncEX(nx=nx, hidden=hidden, use_fused=fused,
                  generator=torch.Generator().manual_seed(1))
    ode = pt.ODESolver()
    y = torch.zeros(B, nx)
    ode.setupTS(y, pt.TorchFunc(im), step_size=0.2, method="imex",
                imex_form=True, implicit_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=B)
    params = (dict(im.named_parameters()), dict(ex.named_parameters()))
    stp = ode._stepper.prepare(0.0, y, params, dt0=0.2)
    return ode, stp, params


def test_gate_opens_on_the_production_config():
    _, stp, params = _ode(["-snes_type", "ksponly"])
    spec, J, inv = stp._fused_reverse_args(params)
    assert J.shape == inv.shape == (16, 16) and J.is_contiguous()
    assert len(spec["Ws"]) == 5 and spec["sign"] == -1.0
    rebuilt = spec["rebuild"](spec["Ws"], spec["bs"])
    assert list(rebuilt) == list(params[1])


def test_gate_stays_off_without_spec():
    ode, stp, params = _ode(["-snes_type", "ksponly"], fused=False)
    assert stp._fused_reverse_args(params) is None
    y0 = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
    pred = ode.odeint(y0, np.array([0.0, 0.4]))
    assert torch.isfinite(pred).all()


def test_gate_requires_linear_implicit_part():
    ode, _, _ = _ode(["-snes_type", "ksponly"], fixed=False)
    assert ode._fused_ex_spec is None


def test_gate_stays_closed_without_ksponly():
    _, stp, params = _ode([])
    assert stp._fused_reverse_args(params) is None
    _, stp, params = _ode(["-snes_type", "ksponly", "-snes_ksponly_check",
                           "1"])
    assert stp._fused_reverse_args(params) is None


def test_gate_options():
    _, stp, params = _ode(["-snes_type", "ksponly",
                           "-pnode_fused_ark_adjoint", "off"])
    assert stp._fused_reverse_args(params) is None
    _, stp, params = _ode(["-snes_type", "ksponly",
                           "-pnode_fused_ark_adjoint", "interpret"])
    with pytest.raises(ValueError, match="interpret"):
        stp._fused_reverse_args(params)
    for tier in ("auto", "highest"):
        _, stp, params = _ode(["-snes_type", "ksponly",
                               "-pnode_fused_ark_precision", tier])
        assert stp._fused_reverse_args(params) is not None
    for tier in ("high", "default"):
        _, stp, params = _ode(["-snes_type", "ksponly",
                               "-pnode_fused_ark_precision", tier])
        with pytest.raises(ValueError, match="not ported"):
            stp._fused_reverse_args(params)


def test_frozen_operators_memoized_per_problem():
    _, stp, params = _ode(["-snes_type", "ksponly"])
    stp2 = stp.prepare(0.0, torch.zeros(4, 16), params, dt0=0.2)
    assert stp2.setup.frozen_J_blocks is stp.setup.frozen_J_blocks
    stp3 = stp.prepare(0.0, torch.zeros(4, 16), params, dt0=0.1)
    assert stp3.setup.frozen_J_blocks is not stp.setup.frozen_J_blocks


def test_fused_step_matches_generic_step():
    """The port's fused forward step (plain version on the CPU) against its
    own generic stage loop, as the JAX package's test does (rtol 3e-5)."""
    _, stp, params = _ode(["-snes_type", "ksponly"], B=8, hidden=24)
    y0 = torch.randn(8, 16, generator=torch.Generator().manual_seed(3))
    dt = float(np.float32(0.2))
    y1_f, aux_f, st_f = stp.step(0.0, dt, y0, params)
    y1_g, aux_g, _ = stp._step_generic(0.0, dt, y0, params)
    torch.testing.assert_close(y1_f, y1_g, rtol=3e-5, atol=1e-6)
    torch.testing.assert_close(aux_f, aux_g, rtol=3e-5, atol=1e-6)
    assert st_f.newton_converged and st_f.newton_iters == 3
    lam = torch.randn(8, 16, generator=torch.Generator().manual_seed(4))
    lp_f, (_, g_f) = stp.step_adj(0.0, dt, y0, params, aux_f, lam)
    pt.set_option("pnode_fused_ark_adjoint", "off")
    lp_g, (_, g_g) = stp.step_adj(0.0, dt, y0, params, aux_g, lam)
    torch.testing.assert_close(lp_f, lp_g, rtol=5e-4, atol=1e-6)
    for k in g_f:
        torch.testing.assert_close(g_f[k], g_g[k], rtol=5e-4, atol=1e-6)
