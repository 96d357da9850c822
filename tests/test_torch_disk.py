"""Disk trajectories of the port (``pnode_tpu_torch/disk_host.py`` and the
``disk`` policy of ``adjoint.py`` / ``adaptive.py``) against the JAX
package: twins of every test in tests/test_disk_host.py and of
tests/test_revolve.py:107 and :170, in fp64 on the CPU.

- The explicit drivers (``ODESolver.disk_trajectory_solver``): loss and
  gradients against the port's in-memory store_all (rtol 1e-10; bit for
  bit where noted) and against JAX's in-memory solve under ``jax.grad``
  (the reference test's tolerances: rtol 1e-10, or 1e-9 for its Newton
  case).
- "Two compiles regardless of length" has no meaning for an eager loop;
  its twin checks the chunk geometry instead: a ragged last chunk, and at
  most ``chunk`` states on the device at once in either direction.
- bf16 storage writes the memmap as raw 16-bit words (numpy has no bf16)
  that decode to the bf16-rounded states.
"""

import math
import os

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

P = {"a": -1.3, "b": 0.7}
Y0 = np.linspace(0.3, 1.1, 5)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def f_lin(t, y, p):
    return p["a"] * y + p["b"] * math.sin(t)


def f_stiff(t, y, p):
    return p["a"] * y ** 3 - 4.0 * y


def jf_lin(t, y, p):
    return p["a"] * y + p["b"] * jnp.sin(t)


def jf_stiff(t, y, p):
    return p["a"] * y ** 3 - 4.0 * y


JF = {f_lin: jf_lin, f_stiff: jf_stiff}


def _loss(outputs):
    return (outputs ** 2).sum() + (outputs[-1] * 0.5).sum()


def _tparams(dtype=torch.float64):
    return {k: torch.tensor(v, dtype=dtype) for k, v in P.items()}


def _setup(method, implicit, f=f_lin, step=0.05, flags=(), dtype=None,
           **kw):
    pt.clear_options()
    pt.init(["p"] + list(flags))
    y0 = torch.from_numpy(Y0) if dtype is None else torch.from_numpy(Y0).to(
        dtype)
    ode = pt.ODESolver()
    ode.setupTS(y0, pt.Func(f, _tparams(y0.dtype)), step_size=step,
                method=method, implicit_form=implicit, **kw)
    return ode


def _mem_grads(ode, t, loss=_loss):
    """The port's in-memory loss and gradients (store_all)."""
    prm = {k: v.clone().requires_grad_(True) for k, v in _tparams().items()}
    y = torch.from_numpy(Y0.copy()).requires_grad_(True)
    sol, _ = ode.solve(y, t, params=prm, with_adjoint=True)
    val = loss(sol)
    val.backward()
    return float(val.detach()), {k: v.grad for k, v in prm.items()}, y.grad


def _jax_grads(method, implicit, t, f=f_lin, step=0.05, flags=(), loss=_loss,
               **kw):
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + list(flags))
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    ode = JODESolver()
    ode.setupTS(jnp.asarray(Y0), (JF[f], jp), step_size=step, method=method,
                implicit_form=implicit, enable_adjoint=True, **kw)

    def fn(p, y0):
        sol, _ = ode.solve(y0, jnp.asarray(t), params=p, with_adjoint=True)
        return loss(sol)

    val, (gp, gy) = jax.value_and_grad(fn, argnums=(0, 1))(jp,
                                                           jnp.asarray(Y0))
    return float(val), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gy)


def _close(got, ref, rtol, atol):
    lv, gp, gy = got
    lr, gpr, gyr = ref
    np.testing.assert_allclose(lv, lr, rtol=max(rtol, 1e-12))
    np.testing.assert_allclose(np.asarray(gy), np.asarray(gyr), rtol=rtol,
                               atol=atol)
    for k in gpr:
        np.testing.assert_allclose(np.asarray(gp[k]), np.asarray(gpr[k]),
                                   rtol=rtol, atol=atol)


def _disk_value_and_grad(dsk, loss=_loss):
    val, (gy, gp) = dsk.value_and_grad(loss, torch.from_numpy(Y0),
                                       _tparams())
    return float(val), gp, gy


def test_host_disk_trajectory_is_exported():
    """The explicit driver is part of the package's API, as
    ``pnode_tpu.HostDiskTrajectory`` is the JAX package's."""
    from pnode_tpu_torch import disk_host

    assert pt.HostDiskTrajectory is disk_host.HostDiskTrajectory
    assert "HostDiskTrajectory" in pt.__all__
    assert pnode_tpu.HostDiskTrajectory.__name__ == "HostDiskTrajectory"


@pytest.mark.parametrize("method,implicit", [
    ("rk4", False), ("dopri5", False), ("cn", True), ("beuler", True),
])
def test_disk_host_grads_match_inmemory(method, implicit, tmp_path):
    """Twin of :43: value_and_grad through the disk driver (chunk 3, a
    ragged last chunk) against the in-memory solve, interior outputs
    forced: bit for bit against the port's store_all, rtol 1e-10 against
    JAX."""
    t = np.linspace(0.0, 1.0, 4)
    ode = _setup(method, implicit)
    ref = _mem_grads(ode, t)
    dsk = _setup(method, implicit, flags=["-ts_trajectory_dirname",
                                          str(tmp_path)]
                 ).disk_trajectory_solver(t, chunk=3)
    got = _disk_value_and_grad(dsk)
    assert got[0] == ref[0] and torch.equal(got[2], ref[2])
    assert all(torch.equal(got[1][k], ref[1][k]) for k in P)
    _close(got, _jax_grads(method, implicit, t), 1e-10, 1e-13)
    assert os.path.dirname(dsk._path) == str(tmp_path)
    dsk.close()
    assert not os.path.exists(dsk._path)


def test_disk_host_outputs_match_and_memmap_on_disk(tmp_path):
    """Twin of :68: the outputs equal the in-memory solve's; the memmap
    holds every node (n_steps + 1 rows), y0 first and the final state
    last; close() removes it."""
    t = np.linspace(0.0, 0.8, 3)
    ode = _setup("cn", True)
    sol_ref, _ = ode.solve(torch.from_numpy(Y0), t, params=_tparams(),
                           with_adjoint=False)
    dsk = ode.disk_trajectory_solver(t, chunk=4)
    dsk.dirname = str(tmp_path)
    dsk._path = os.path.join(str(tmp_path), "traj.npy")
    sol, stats = dsk.solve(torch.from_numpy(Y0), _tparams())
    np.testing.assert_allclose(sol.numpy(), sol_ref.detach().numpy(),
                               rtol=1e-12, atol=1e-14)
    jode = JODESolver()
    jode.setupTS(jnp.asarray(Y0), (jf_lin, {k: jnp.asarray(v)
                                            for k, v in P.items()}),
                 step_size=0.05, method="cn", implicit_form=True)
    sol_j, _ = jode.solve(jnp.asarray(Y0), jnp.asarray(t),
                          with_adjoint=False)
    np.testing.assert_allclose(sol.numpy(), np.asarray(sol_j), rtol=1e-10)
    mm = np.load(dsk._path, mmap_mode="r")
    assert mm.shape == (int(dsk.grid.n_steps) + 1,) + Y0.shape
    np.testing.assert_allclose(mm[0], Y0)
    np.testing.assert_allclose(mm[-1], sol[-1].numpy(), rtol=1e-12)
    dsk.close()
    assert not os.path.exists(dsk._path)


def test_disk_host_two_compiles_regardless_of_length(tmp_path):
    """Twin of :88. The JAX driver compiles at most two chunk kernels per
    direction; the eager port compiles nothing, so the twin checks what
    the chunking is for: 40 steps in chunks of 7 (the last one ragged) and
    at most 7 states on the device at once, forward or reverse."""
    t = np.linspace(0.0, 2.0, 2)  # 40 steps at 0.05
    ode = _setup("rk4", False)
    dsk = ode.disk_trajectory_solver(t, chunk=7)
    dsk.dirname = str(tmp_path)
    dsk._path = os.path.join(str(tmp_path), "traj.npy")
    dsk.solve(torch.from_numpy(Y0), _tparams())
    store = dsk._disk
    assert store.chunks(41) == [(a, min(a + 7, 41)) for a in range(0, 41, 7)]
    assert store.chunks(41)[-1] == (35, 41)
    assert store.max_device_rows == 7
    lam, gp = dsk.adjoint_solve(torch.ones((2,) + Y0.shape,
                                           dtype=torch.float64), _tparams())
    assert store.max_device_rows == 7
    assert lam.shape == Y0.shape and set(gp) == set(P)
    dsk.close()


def test_disk_host_stiff_newton_and_single_output(tmp_path):
    """Twin of :101: nonlinear implicit dynamics (Newton in both sweeps)
    and the single-output-time selection (integrate [0, 0.6], return the
    endpoint): rtol 1e-9 against the in-memory solve, as the reference."""
    t = np.array([0.6])

    def loss(o):
        return (o ** 2).sum()

    ode = _setup("cn", True, f=f_stiff, step=0.02)
    ref = _mem_grads(ode, t, loss)
    dsk = _setup("cn", True, f=f_stiff, step=0.02, flags=[
        "-ts_trajectory_dirname", str(tmp_path)]).disk_trajectory_solver(
            t, chunk=8)
    got = _disk_value_and_grad(dsk, loss)
    _close(got, ref, 1e-9, 1e-12)
    _close(got, _jax_grads("cn", True, t, f=f_stiff, step=0.02, loss=loss),
           1e-9, 1e-12)
    dsk.close()


def test_disk_host_fixed_jacobian_nonlinear_linearization_point(tmp_path):
    """Twin of :129: with fixed_jacobian the frozen J is assembled at the
    solve's y0 in both directions, so the outputs equal the in-memory
    solve's bit for bit and the gradients at rtol 1e-10 (chunk 7: chunk
    boundaries inside the solve)."""
    t = np.linspace(0.0, 0.6, 4)
    kw = dict(fixed_jacobian=True, linear_solver="torch")
    ode = _setup("cn", True, f=f_stiff, step=0.02, **kw)
    sol_ref, _ = ode.solve(torch.from_numpy(Y0), t, params=_tparams())
    ref = _mem_grads(ode, t)
    dsk = _setup("cn", True, f=f_stiff, step=0.02, flags=[
        "-ts_trajectory_dirname", str(tmp_path)], **kw
    ).disk_trajectory_solver(t, chunk=7)
    sol, _ = dsk.solve(torch.from_numpy(Y0), _tparams())
    assert torch.equal(sol, sol_ref.detach())
    got = _disk_value_and_grad(dsk)
    _close(got, ref, 1e-10, 1e-13)
    _close(got, _jax_grads("cn", True, t, f=f_stiff, step=0.02, **kw),
           1e-10, 1e-13)
    dsk.close()


def test_disk_host_dtype_cast_matches_solver(tmp_path):
    """Twin of :168: the driver casts y0 to the solver's dtype, as
    ODESolver.solve does: an fp64 y0 into an fp32 solver runs and stores
    fp32."""
    ode = _setup("rk4", False, flags=["-ts_trajectory_dirname",
                                      str(tmp_path)], dtype=torch.float32)
    dsk = ode.disk_trajectory_solver(np.linspace(0.0, 0.5, 2), chunk=4)
    sol, _ = dsk.solve(torch.from_numpy(Y0), _tparams(torch.float32))
    assert sol.dtype == torch.float32
    assert dsk._mm.dtype == np.float32
    dsk.close()


def test_disk_host_zero_steps_value_and_grad():
    """Twin of :185: a 0-step grid (outputs [0, 0], both y0): the gradient
    is the sum of the two output cotangents, 2 * 2 * y0, and zero for the
    parameters; no memmap is written."""
    from pnode_tpu_torch.disk_host import HostDiskTrajectory
    from pnode_tpu_torch.grid import TimeGrid

    ode = _setup("rk4", False)
    grid = TimeGrid(ts=np.zeros((0,)), dts=np.zeros((0,)),
                    out_idx=np.asarray([0, 0]), n_steps=0)
    dsk = HostDiskTrajectory(ode._stepper, grid)
    loss, (gy, gp) = dsk.value_and_grad(lambda o: (o ** 2).sum(),
                                        torch.from_numpy(Y0), _tparams())
    np.testing.assert_allclose(gy.numpy(), 2.0 * 2.0 * Y0, rtol=1e-12)
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), 0.0, atol=1e-15)
    assert dsk._mm is None and not os.path.exists(dsk._path)


def test_disk_host_bf16_compression(tmp_path):
    """Twin of :204: -pnode_trajectory_dtype bf16 writes 2-byte rows (the
    raw bf16 words) and the gradients stay within the reference's bf16
    bar (rtol 2e-2, atol 1e-4) of the uncompressed driver's, and of the
    JAX package's compressed driver."""
    t = np.linspace(0.0, 1.0, 2)
    y0f = torch.from_numpy(Y0).float()
    pf = _tparams(torch.float32)

    def run(flags):
        ode = _setup("rk4", False, dtype=torch.float32, flags=[
            "-ts_trajectory_dirname", str(tmp_path)] + flags)
        dsk = ode.disk_trajectory_solver(t, chunk=6)
        _, (gy, gp) = dsk.value_and_grad(lambda o: (o ** 2).sum(), y0f, pf)
        return dsk, gy, gp

    dsk, gy, gp = run(["-pnode_trajectory_dtype", "bf16"])
    mm = np.load(dsk._path, mmap_mode="r")
    assert mm.dtype.itemsize == 2 and dsk._mm.dtype == np.int16
    row0 = torch.from_numpy(np.array(mm[0])).view(torch.bfloat16)
    assert torch.equal(row0, y0f.to(torch.bfloat16))
    dsk2, gy_ref, gp_ref = run([])
    np.testing.assert_allclose(gy.numpy(), gy_ref.numpy(), rtol=2e-2,
                               atol=1e-4)
    for k in gp_ref:
        np.testing.assert_allclose(gp[k].numpy(), gp_ref[k].numpy(),
                                   rtol=2e-2, atol=1e-4)

    pnode_tpu.clear_options()
    pnode_tpu.init(["p", "-ts_trajectory_dirname", str(tmp_path),
                    "-pnode_trajectory_dtype", "bf16"])
    jode = JODESolver()
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in P.items()}
    jode.setupTS(jnp.asarray(Y0, jnp.float32), (jf_lin, jp), step_size=0.05,
                 method="rk4", enable_adjoint=True)
    jdsk = jode.disk_trajectory_solver(jnp.asarray(t), chunk=6)
    _, (gy_j, gp_j) = jdsk.value_and_grad(lambda o: jnp.sum(o ** 2),
                                          jnp.asarray(Y0, jnp.float32), jp)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), rtol=2e-2,
                               atol=1e-4)
    for k in gp_j:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(gp_j[k]),
                                   rtol=2e-2, atol=1e-4)
    for d in (dsk, dsk2, jdsk):
        d.close()


def _adaptive_flags(max_steps=512, tmp=None):
    flags = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4", "-ts_atol",
             "1e-6", "-ts_adapt_max_steps", str(max_steps)]
    return flags + (["-ts_trajectory_dirname", str(tmp)] if tmp else [])


@pytest.mark.parametrize("method,implicit", [("cn", True), ("dopri5", False)])
def test_adaptive_disk_host_bit_parity(method, implicit, tmp_path):
    """Twin of :252: the adaptive disk driver (chunk 7: ragged trial
    chunks) against the in-memory adaptive solve: the same outputs and
    counts bit for bit, the gradients bit for bit (the reference: rtol
    1e-10) and at rtol 1e-10 against JAX; the memmap holds max_steps rows,
    chunks without an accepted trial are not read."""
    t = np.linspace(0.0, 1.0, 3)
    ode = _setup(method, implicit, flags=_adaptive_flags())
    sol_ref, st_ref = ode.solve(torch.from_numpy(Y0), t, params=_tparams())
    ref = _mem_grads(ode, t)
    dsk = _setup(method, implicit, flags=_adaptive_flags(tmp=tmp_path)
                 ).disk_trajectory_solver(t, chunk=7)
    sol, st = dsk.solve(torch.from_numpy(Y0), _tparams())
    assert torch.equal(sol, sol_ref.detach())
    assert (st.accepted, st.rejected, st.completed) == (
        st_ref.accepted, st_ref.rejected, True)
    got = _disk_value_and_grad(dsk)
    assert got[0] == ref[0] and torch.equal(got[2], ref[2])
    assert all(torch.equal(got[1][k], ref[1][k]) for k in P)
    _close(got, _jax_grads(method, implicit, t, flags=_adaptive_flags()),
           1e-10, 1e-13)
    mm = np.load(dsk._path, mmap_mode="r")
    assert mm.shape == (512,) + Y0.shape
    assert dsk._disk.max_device_rows <= 7
    dsk.close()
    assert not os.path.exists(dsk._path)


# -- the disk policy through the solver's flags (tests/test_revolve.py) -------

def _flag_grads(flags, f, jf, P_, y0, t, loss_nodes, **setup):
    """(loss, {name: grad}) through odeint_adjoint in the port and in JAX
    under the same flags."""
    pt.clear_options()
    pt.init(["p"] + flags)
    prm = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in P_.items()}
    y = torch.tensor(y0, dtype=torch.float64)
    ode = pt.ODESolver().setupTS(y, pt.Func(f, prm), **setup)
    sol = ode.odeint_adjoint(y, t, params=prm)
    val = sum((sol[i] ** 2).sum() for i in loss_nodes)
    val.backward()
    got = (float(val), {k: v.grad.numpy() for k, v in prm.items()})
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + flags)
    jp = {k: jnp.asarray(v) for k, v in P_.items()}
    jode = JODESolver()
    jode.setupTS(jnp.asarray(y0), JFunc(jf, jp), **setup)

    def loss(p):
        s = jode.odeint_adjoint(jnp.asarray(y0), jnp.asarray(t), params=p)
        return sum(jnp.sum(s[i] ** 2) for i in loss_nodes)

    val_j, g_j = jax.value_and_grad(loss)(jp)
    return got, (float(val_j), {k: np.asarray(v) for k, v in g_j.items()})


@pytest.mark.parametrize("case", ["rk4_interior", "cn"])
def test_disk_trajectory_policy_gradients_match(case, tmp_path):
    """Twins of test_revolve.py:107 (rk4, interior and final outputs in
    the loss: rtol 1e-10, loss 1e-12) and :170 (CN, Newton in the reverse:
    rtol 1e-9): -ts_trajectory_type disk against the in-memory policy, in
    the port and in JAX; the memmap is removed after the reverse."""
    if case == "cn":
        args = (lambda t, y, p: -p["k"] * y ** 3,
                lambda t, y, p: -p["k"] * y ** 3, {"k": 1.5}, [1.0, 0.6],
                np.array([0.0, 0.6]), (-1,))
        setup, rtol = dict(step_size=0.1, method="cn",
                           implicit_form=True), 1e-9
    else:
        args = (lambda t, y, p: p["a"] * y + p["b"] * torch.sin(y),
                lambda t, y, p: p["a"] * y + p["b"] * jnp.sin(y),
                {"a": -0.5, "b": 0.3}, [1.0, -0.4], np.array([0.0, 0.5, 1.0]),
                (-1, 1))
        setup, rtol = dict(step_size=0.1, method="rk4"), 1e-10
    disk = ["-ts_trajectory_type", "disk", "-ts_trajectory_dirname",
            str(tmp_path), "-pnode_disk_chunk", "3"]
    (l_ref, g_ref), (lj_ref, gj_ref) = _flag_grads([], *args, **setup)
    (l_dsk, g_dsk), (lj_dsk, gj_dsk) = _flag_grads(disk, *args, **setup)
    assert l_dsk == pytest.approx(l_ref, rel=1e-12)
    assert lj_dsk == pytest.approx(lj_ref, rel=1e-12)
    for k in g_ref:
        np.testing.assert_array_equal(g_dsk[k], g_ref[k])
        np.testing.assert_allclose(g_dsk[k], gj_dsk[k], rtol=rtol)
        np.testing.assert_allclose(gj_dsk[k], gj_ref[k], rtol=rtol)
    assert not list(tmp_path.glob("pnode_hostdisk_*"))
