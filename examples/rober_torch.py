"""ROBER stiff-kinetics training on the PyTorch/CUDA port.

Twin of ``examples/rober.py``: the stiff ROBER kinetics fit by a small GELU
MLP (3 -> 5 x6 -> 3, no bias, N(0, 0.5) weights, the tanh form of GELU as
flax's ``nn.gelu``) over t in [0, 100] on a log-spaced observation grid
(``logspace(-5, 2, --data_size)``), integrated on a finer log grid whose
per-step dt list lands on every observation (a non-uniform grid), by
Crank-Nicolson in implicit form with matrix-free GMRES stage solves
(``--linear_solver petsc``), trained through ``odeint_adjoint`` with Adam.
The data is scipy's BDF solution, minmax- or mean-normalized. Every
``--test_freq`` iterations it prints ``Iter | Time | Loss | Grad | NFE-F |
NFE-B``, logs Train/Loss and Train/Gradient through ``MetricsWriter``
(``metrics.jsonl``, and TensorBoard where it imports) and saves the best
weights (``best.ckpt`` in ``--train_dir``, the JAX package's pickle of
numpy arrays through ``pnode_tpu_torch.utils.save_checkpoint``, as
``examples/rober.py`` writes it), which ``--hotstart`` resumes from; a
checkpoint of another normalization is refused::

    python examples/rober_torch.py                    # the H100
    python examples/rober_torch.py --device cpu --double_prec --niters 200

The weights are drawn in fp64 from a CPU generator seeded by ``--seed`` and
then cast and moved. PETSc-style flags after the script's own options go
to the port's options database. ``--device cuda`` raises when CUDA is
absent: the CPU is an explicit choice, never a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENDTIME = 100.0
K1, K2, K3 = 0.04, 3e7, 1e4


def parse_args(argv=None):
    p = argparse.ArgumentParser("ROBER (PyTorch port)")
    p.add_argument("--method", type=str, default="cn")
    p.add_argument("--data_size", type=int, default=20)
    p.add_argument("--steps_per_data_point", type=int, default=2)
    p.add_argument("--niters", type=int, default=500)
    p.add_argument("--test_freq", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--normalize", choices=["minmax", "mean"], default="minmax")
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--implicit_form", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str,
                   default="./train_results_rober_torch")
    p.add_argument("--hotstart", action="store_true")
    p.add_argument("--linear_solver", choices=["petsc", "hpddm", "torch"],
                   default="petsc")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def time_grids(data_size, steps_per_data_point):
    """(observation times, the per-step dt list of the finer log grid)."""
    t_obs = np.concatenate([[0.0], np.logspace(-5, 2, data_size)])
    t_traj = np.concatenate([[0.0], np.logspace(
        -5, 2, data_size + (data_size - 1) * (steps_per_data_point - 1))])
    return t_obs, list(np.diff(t_traj))


def rober_rhs(tt, s):
    return np.array([-K1 * s[0] + K3 * s[1] * s[2],
                     K1 * s[0] - K3 * s[1] * s[2] - K2 * s[1] ** 2,
                     K2 * s[1] ** 2])


def rober_jac(tt, s):
    return np.array([[-K1, K3 * s[2], K3 * s[1]],
                     [K1, -2 * K2 * s[1] - K3 * s[2], -K3 * s[1]],
                     [0.0, 2 * K2 * s[1], 0.0]])


def rober_data(t_obs, normalize):
    """scipy's BDF solution at t_obs (rtol 1e-11, atol 1e-14), normalized:
    (data (n, 3), shift, scale) as numpy arrays."""
    from scipy.integrate import solve_ivp

    path = solve_ivp(rober_rhs, [0, ENDTIME * 1.1], np.array([1.0, 0.0, 0.0]),
                     t_eval=t_obs, jac=rober_jac, method="BDF", rtol=1e-11,
                     atol=1e-14)
    data = path["y"].T
    shift, scale = 0.0, 1.0
    if normalize == "minmax":
        shift = data.min(0, keepdims=True)
        scale = data.max(0, keepdims=True) - shift
    elif normalize == "mean":
        shift = data.mean(0, keepdims=True)
        scale = data.std(0, keepdims=True)
    return (data - shift) / scale, shift, scale


class ODEFunc(nn.Module):
    """3 -> 5 x6 -> 3 without biases, the tanh form of GELU after each
    hidden layer; N(0, 0.5) weights drawn in fp64 from ``generator`` (a
    CPU one) and cast."""

    def __init__(self, generator=None, dtype=None, device=None):
        super().__init__()
        dims = [3] + [5] * 6 + [3]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=False, dtype=dtype, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lin in self.layers:
                w = torch.empty(lin.weight.shape, dtype=torch.float64)
                lin.weight.copy_(w.normal_(0.0, 0.5, generator=generator))

    def forward(self, t, y):
        h = y
        for lin in self.layers[:-1]:
            h = F.gelu(lin(h), approximate="tanh")
        return self.layers[-1](h)


def make_solver(func, y0, step_size, args):
    import pnode_tpu_torch as pt

    return pt.ODESolver().setupTS(
        y0, pt.TorchFunc(func), step_size=step_size, method=args.method,
        implicit_form=args.implicit_form, linear_solver=args.linear_solver,
        enable_adjoint=True)


def train_step(ode, func, opt, true_y0, t_obs, true_y):
    """One Adam step; returns (loss, global gradient norm) as floats."""
    loss = torch.mean(torch.abs(ode.odeint_adjoint(true_y0, t_obs) - true_y))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    gnorm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in func.parameters()))
    opt.step()
    return float(loss.detach()), float(gnorm)


def main(argv=None):
    """Train; returns {"losses": per-iteration losses, "start": the first
    iteration, "final": the running mean, "seconds": the loop's time}."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.utils import (
        MetricsWriter, RunningAverageMeter, load_checkpoint, makedirs,
        save_checkpoint)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.init([sys.argv[0]] + unknown)

    t_obs, step_size = time_grids(args.data_size, args.steps_per_data_point)
    data, _, _ = rober_data(t_obs, args.normalize)
    true_y = torch.as_tensor(data, dtype=dtype, device=device)
    true_y0 = true_y[0]
    gen = torch.Generator().manual_seed(args.seed)
    func = ODEFunc(gen, dtype, device)
    ode = make_solver(func, true_y0, step_size, args)
    opt = torch.optim.Adam(func.parameters(), lr=args.lr)

    makedirs(args.train_dir)
    ckpt = os.path.join(args.train_dir, "best.ckpt")
    start_iter, best_loss = 0, float("inf")
    if args.hotstart and os.path.exists(ckpt):
        ck = load_checkpoint(ckpt)
        if ck.get("normalize") != args.normalize:
            raise RuntimeError("hotstart normalization mismatch: the "
                               f"checkpoint is {ck.get('normalize')!r}, the "
                               f"run {args.normalize!r}")
        func.load_state_dict({k: torch.as_tensor(v)
                              for k, v in ck["params"].items()})
        start_iter, best_loss = int(ck["iter"]) + 1, float(ck["best_loss"])
        print(f"hotstart at iter {start_iter}, best {best_loss:.3e}")

    writer = MetricsWriter(args.train_dir)
    time_meter = RunningAverageMeter(0.97)
    loss_meter = RunningAverageMeter(0.97)
    losses = []
    t0 = end = time.time()
    for itr in range(start_iter, args.niters):
        loss, gnorm = train_step(ode, func, opt, true_y0, t_obs, true_y)
        losses.append(loss)
        time_meter.update(time.time() - end)
        loss_meter.update(loss)
        nfe_b = ode.nfe_forward  # the adjoint replays the same trajectory
        if itr % args.test_freq == 0:
            print(f"Iter {itr:04d} | Time {time_meter.avg:.4f}s | "
                  f"Loss {loss_meter.avg:.6e} | Grad {gnorm:.3e} | "
                  f"NFE-F {ode.nfe_forward} | NFE-B {nfe_b}")
            writer.add_scalar("Train/Loss", loss, itr)
            writer.add_scalar("Train/Gradient", gnorm, itr)
            if loss < best_loss:
                best_loss = loss
                save_checkpoint(ckpt, {"iter": itr,
                                       "params": func.state_dict(),
                                       "best_loss": best_loss,
                                       "normalize": args.normalize})
        end = time.time()
    writer.close()
    return {"losses": losses, "start": start_iter, "final": loss_meter.avg,
            "seconds": time.time() - t0}


if __name__ == "__main__":
    out = main()
    print(f"final loss {out['final']:.6e}")
