"""Rank bodies of the data-parallel twins (tests/test_torch_fused_dp.py and
tests/test_torch_parallel.py), run by ``pnode_tpu_torch.parallel.run_ranks``
in spawned processes. Every rank imports this module afresh, so it imports
only numpy, torch and the port: never JAX. Inputs arrive as numpy arrays;
results go back as numpy arrays and floats."""

import importlib.util
import os

import numpy as np
import torch

import pnode_tpu_torch as pt
from pnode_tpu_torch.parallel import (
    dp_fused_train_loop, dp_value_and_grad, make_mesh, replicate, shard_batch,
)
from pnode_tpu_torch.parallel import fused_dp

LR = 5e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(ts):
    return [t.detach().cpu().numpy() for t in ts]


def fused_dp_rank(device, ops, y, tgt, force_general, uneven):
    """dp_fused_train_loop over every rank on a flat mesh, from zero Adam
    moments. ``ops``: (tableau, J, inv, Ws, bs, activation, sign) as numpy.
    Returns the parameters, moments and losses, the batch shapes K12 saw,
    and, when ``uneven``, the error a batch of B - 4 rows raises."""
    tbl, J, inv, Ws, bs, activation, sign = ops
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    Ws, bs = [t(w) for w in Ws], [t(b) for b in bs]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    mesh = make_mesh()
    shapes = []
    kernel = fused_dp.fused_grad_step

    def spy(layout, tab, dt, yk, *args, **kw):
        shapes.append(tuple(yk.shape))
        return kernel(layout, tab, dt, yk, *args, **kw)

    fused_dp.fused_grad_step = spy
    try:
        args = (mesh, tbl, float(np.float32(0.2)))
        rest = (t(J), t(inv), Ws, bs, z, z, 0)
        kw = dict(activation=activation, sign=sign, lr=LR,
                  force_general=force_general)
        Wo, bo, (mW, mb), (vW, vb), losses = dp_fused_train_loop(
            *args, t(y), t(tgt), *rest, **kw)
        err = None
        if uneven:
            try:
                dp_fused_train_loop(*args, t(y[:, :-4]), t(tgt[:, :-4]),
                                    *rest, **kw)
            except ValueError as e:
                err = str(e)
    finally:
        fused_dp.fused_grad_step = kernel
    return {"Ws": _np(Wo), "bs": _np(bo), "m": _np(mW) + _np(mb),
            "v": _np(vW) + _np(vb), "losses": losses.cpu().numpy(),
            "shapes": shapes, "uneven": err}


def _tanh(t, y, p):
    return torch.tanh(y @ p["w"])


def tanh_case_rank(device, cases):
    """The test_parallel.py problems: d/dw of the MSE of an ODE solve of
    y' = tanh(y w) (plus mean(pred[1]^2) where t_out has three times),
    batch-sharded over the case's mesh, in fp64. Each case: (flags,
    method, step, mesh_shape, axis, w, y0, tgt, t_out). Returns per case
    (loss, dL/dw, the local shard, the solver's trajectory policy)."""
    out = {}
    for name, (flags, method, step, mesh_shape, axis, w, y0, tgt,
               t_out) in cases.items():
        pt.clear_options()
        pt.init(["p"] + list(flags))
        mesh = (make_mesh() if mesh_shape is None else
                make_mesh(mesh_shape=mesh_shape, axis_names=("dcn", "dp")))
        f64 = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        local = shard_batch((f64(y0), f64(tgt)), mesh, axis=axis)
        P = {"w": replicate(f64(w), mesh).requires_grad_(True)}
        ode = pt.ODESolver()
        ode.setupTS(torch.zeros_like(local[0]), pt.Func(_tanh, P),
                    step_size=step, method=method)

        def loss_fn(p, batch):
            pred, _ = ode.solve(batch[0], np.asarray(t_out), params=p)
            interior = torch.mean(pred[1] ** 2) if len(t_out) > 2 else 0.0
            return torch.mean((pred[-1] - batch[1]) ** 2) + interior

        loss, g = dp_value_and_grad(loss_fn, mesh, axis=axis)(P, local)
        out[name] = (float(loss), g["w"].numpy(), local[0].numpy(),
                     ode.traj.kind)
    return out


def ks_case_rank(device, cases):
    """dryrun_multichip's train step on the port: the KS IMEX model
    (KSFuncEX from a flax state dict) batch-sharded over the case's mesh,
    the loss and gradients meaned over its axes by dp_value_and_grad, one
    torch.optim.Adam step at lr 1e-3. Each case: (flags, nx, hidden, dtype,
    mesh_shape, axis, state, y0, tgt). Returns the loss, the gradients and
    the updated parameters (sorted by name)."""
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    out = {}
    for name, (flags, nx, hidden, dtype, mesh_shape, axis, state, y0,
               tgt) in cases.items():
        dt = getattr(torch, dtype)
        pt.clear_options()
        pt.init(["p", "-snes_type", "ksponly", "-ksp_rtol", "1e-6"]
                + list(flags))
        mesh = (make_mesh() if mesh_shape is None else
                make_mesh(mesh_shape=mesh_shape, axis_names=("dcn", "dp")))
        local = shard_batch((torch.tensor(y0, dtype=dt),
                             torch.tensor(tgt, dtype=dt)), mesh, axis=axis)
        im = KSFuncIM(nx=nx).to(dt)
        ex = KSFuncEX(nx=nx, hidden=hidden, use_fused=False).to(dt)
        ex.load_state_dict({k: torch.tensor(v, dtype=dt)
                            for k, v in state.items()})
        with torch.no_grad():
            for p, r in zip(ex.parameters(),
                            replicate(list(ex.parameters()), mesh)):
                p.copy_(r)
        ode = pt.ODESolver()
        ode.setupTS(torch.zeros_like(local[0]), pt.TorchFunc(im),
                    step_size=0.2, method="imex", imex_form=True,
                    implicit_form=True, func2=pt.TorchFunc(ex),
                    linear_solver="hpddm", fixed_jacobian=True,
                    batch_size=local[0].shape[0])

        def loss_fn(params, batch):
            pred, _ = ode.solve(batch[0], np.array([0.0, 0.2]))
            return torch.mean((pred[-1] - batch[1]) ** 2)

        names = sorted(n for n, _ in ex.named_parameters())
        prm = dict(ex.named_parameters())
        params = [prm[n] for n in names]
        loss, grads = dp_value_and_grad(loss_fn, mesh, axis=axis)(params,
                                                                  local)
        opt = torch.optim.Adam(params, lr=1e-3)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        out[name] = (float(loss), _np(grads), _np(params))
    return out


def ks_torch_rank(device, argv):
    """examples/ks_torch.py's main(argv) on this rank: its per-epoch train
    losses."""
    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(REPO, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pt.clear_options()
    return mod.main(list(argv))[1]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def suite_rank(device, tanh_cases, ks_cases, fused):
    """tests/test_torch_parallel.py's work in one group of ranks: the mesh
    validation errors, tanh_case_rank's and ks_case_rank's cases, and
    fused_dp_rank on ``fused`` (ops, y, tgt)."""
    errors = {
        "overallocation": _error(lambda: make_mesh(10_000)),
        "axis_names": _error(lambda: make_mesh(mesh_shape=(2, 4),
                                               axis_names=("dp",))),
        "needs": _error(lambda: make_mesh(mesh_shape=(100, 100),
                                          axis_names=("a", "b"))),
    }
    return {"errors": errors, "tanh": tanh_case_rank(device, tanh_cases),
            "ks": ks_case_rank(device, ks_cases),
            "fused": fused_dp_rank(device, *fused, False, False)}
