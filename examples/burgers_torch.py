"""Burgers SINODE training on the PyTorch/CUDA port.

Twin of ``examples/burgers.py``: viscous Burgers trajectories (100 ICs,
T = 5, saved every 0.1, from the port's ETDRK4 generator), an IMEX split
with the fixed circular Laplacian as f_IM (``BurgersFuncIM``) and a learned
ReLU stack N -> 9N/8 x4 -> N as f_EX (``BurgersFuncEX``), random (IC,
window) minibatches, the mean-abs window loss, Adam, trained through
``ODESolver.odeint_adjoint`` and its hand-written discrete adjoint::

    python examples/burgers_torch.py                  # the H100 (default)
    python examples/burgers_torch.py --device cpu --nx 32 --batch_size 4 \\
        --batch_time 2 --step_size 0.05 --epochs 1 --iters_per_epoch 2
    python examples/burgers_torch.py --linear_solver hpddm --fixed_jacobian

    python examples/burgers_torch.py --node           # autodiff baseline
    python examples/burgers_torch.py --no-imex        # cn on f_IM

The defaults are ``examples/burgers.py``'s: nx 512, batch 200, dt 1e-3,
ARK3 IMEX with Newton (PETSc's newtonls) on matrix-free GMRES stage solves
(``--linear_solver petsc``) against an unfrozen Jacobian. ``bench.py
--workload burgers``'s numerics are ``--linear_solver hpddm
--fixed_jacobian``: the frozen, pre-inverted stage operator with
``-snes_type ksponly`` (a programmatic default under ``--fixed_jacobian``
that a command-line flag overrides). ``--use_fused`` (on by default) puts
f_EX on K1 and f_IM on K10/K11; the fused ARK step kernels stay off at nx
512 (their gate's 8-row budget needs more shared memory than the H100's
227 KB), so the step runs the generic stage loop. ``--node`` (the
reference's torchdiffeq baseline) integrates f_IM + f_EX by dopri5 at
``--step_size`` without the adjoint, the gradients by autograd through the
steps (K1 and K10/K11 under autograd); it keeps every step's activations,
so its memory grows with ``--batch_time``. ``--no-imex`` integrates f_IM
alone by Crank-Nicolson, as ``examples/burgers.py --no-imex`` does (f_EX
then takes no part, and its parameters get no gradient). PETSc-style flags after the script's own
options go to the port's options database (``-ts_arkimex_type l2``, ...).
``--device cuda`` raises when CUDA is absent: the CPU is an explicit
choice, never a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT_DATA = 0.1


def parse_args(argv=None):
    p = argparse.ArgumentParser("Burgers (PyTorch port)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--imex", action="store_true", default=True)
    p.add_argument("--no-imex", dest="imex", action="store_false")
    p.add_argument("--method", type=str, default="imex")
    p.add_argument("--batch_time", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--step_size", type=float, default=1e-3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--test_freq", type=int, default=10)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str,
                   default="./train_results_burgers_torch")
    p.add_argument("--linear_solver", choices=["petsc", "hpddm", "torch"],
                   default="petsc")
    p.add_argument("--fixed_jacobian", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--node", action="store_true",
                   help="autodiff through the solver: f_IM + f_EX by dopri5, "
                   "enable_adjoint=False")
    p.add_argument("--iters_per_epoch", type=int, default=0,
                   help="override the data-derived iteration count")
    p.add_argument("--n_ic", type=int, default=100,
                   help="initial conditions of the generated data")
    p.add_argument("--use_fused", action=argparse.BooleanOptionalAction,
                   default=True, help="f_EX on K1 and f_IM on K10/K11")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def get_batch(u, rng, batch_size, batch_time):
    """Random (IC, start) windows: y0 (B, nx), targets (T, B, nx), as
    numpy arrays (uniform dt, so the window offsets are shared)."""
    n_ic, n_t, _ = u.shape
    ics = rng.integers(0, n_ic, size=batch_size)
    starts = rng.integers(0, n_t - batch_time, size=batch_size)
    y0 = u[ics, starts]
    y = np.stack([u[ics, starts + j] for j in range(batch_time)], axis=0)
    return y0, y


def main(argv=None, history=None):
    """Train; returns the running mean of the train loss. ``history``, a
    list, receives each iteration's loss."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.data import generate_burgers_data
    from pnode_tpu_torch.models import (
        BurgersFuncEX, BurgersFuncIM, IMEXSum)
    from pnode_tpu_torch.utils import RunningAverageMeter

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    if args.fixed_jacobian:
        pt.set_option("snes_type", "ksponly")
    pt.init([sys.argv[0]] + unknown)

    rng = np.random.default_rng(args.seed)
    u, _ = generate_burgers_data(nx=args.nx, n_ic=args.n_ic,
                                 cache_dir=os.path.join(args.train_dir,
                                                        "data"))
    n_train_ic = int(0.8 * u.shape[0])
    u_train, u_test = u[:n_train_ic], u[n_train_ic:]
    print(f"Burgers data: {u.shape}, dt {DT_DATA}")
    window_t = np.arange(args.batch_time) * DT_DATA

    gen = torch.Generator(device=device).manual_seed(args.seed)
    im = BurgersFuncIM(nx=args.nx, use_fused=args.use_fused, dtype=dtype,
                       device=device)
    ex = BurgersFuncEX(nx=args.nx, use_fused=args.use_fused, generator=gen,
                       dtype=dtype, device=device)
    ode = pt.ODESolver()
    y_tmpl = torch.zeros(args.batch_size, args.nx, dtype=dtype, device=device)
    if args.node:
        # integrate the combined right-hand side explicitly and
        # differentiate straight through the steps
        ode.setupTS(y_tmpl, pt.TorchFunc(IMEXSum(im, ex)),
                    step_size=args.step_size, method="dopri5",
                    enable_adjoint=False)
    else:
        ode.setupTS(
            y_tmpl, pt.TorchFunc(im), step_size=args.step_size,
            method=args.method if args.imex else "cn", imex_form=args.imex,
            implicit_form=True, func2=pt.TorchFunc(ex) if args.imex else None,
            linear_solver=args.linear_solver,
            fixed_jacobian=args.fixed_jacobian, batch_size=args.batch_size)
    opt = torch.optim.Adam(ex.parameters(), lr=args.lr)

    def predict(y0):
        if args.node:
            return ode.solve(y0, window_t, with_adjoint=False)[0]
        return ode.odeint_adjoint(y0, window_t)

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def window_loss(pred, target):
        return torch.mean(torch.abs(pred - target))

    iters_per_epoch = args.iters_per_epoch or max(
        1, u_train.shape[0] * (u.shape[1] - args.batch_time)
        // args.batch_size)
    loss_meter = RunningAverageMeter(0.97)
    rng_test = np.random.default_rng(12345)
    for epoch in range(args.epochs):
        t0 = time.time()
        for _ in range(iters_per_epoch):
            y0, target = get_batch(u_train, rng, args.batch_size,
                                   args.batch_time)
            loss = window_loss(predict(as_t(y0)), as_t(target))
            opt.zero_grad(set_to_none=True)
            if loss.requires_grad:  # not under --no-imex: f_EX takes no part
                loss.backward()
                opt.step()
            loss_meter.update(float(loss.detach()))
            if history is not None:
                history.append(loss_meter.val)
            if np.isnan(loss_meter.val):
                print("NaN loss - stopping")
                return float("nan")
        ty0, ttgt = get_batch(u_test, rng_test, args.batch_size,
                              args.batch_time)
        with torch.no_grad():
            tl = float(window_loss(ode.odeint(as_t(ty0), window_t),
                                   as_t(ttgt)))
        print(f"Epoch {epoch:03d} | {time.time() - t0:.2f}s | "
              f"Train {loss_meter.avg:.6e} | Test {tl:.6e} | "
              f"NFE-F {ode.nfe_forward}")
    return loss_meter.avg


if __name__ == "__main__":
    final = main()
    print(f"final train loss {final:.6e}")
