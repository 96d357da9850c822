"""Pendulum index-1 DAE training on the PyTorch/CUDA port.

Twin of ``examples/pendulum_dae.py``: the Cartesian pendulum as a 5-state
DAE (x, y, vx, vy, lambda) with the singular mass matrix M =
diag(1, 1, 1, 1, 0), integrated by Crank-Nicolson (``method="cn"``, Newton
with matrix-free GMRES stage solves through the mass matrix), trained
through ``ODESolver.odeint_adjoint`` and its hand-written discrete adjoint
with AdamW. Two modes: the known algebraic constraint (a net learns the
differential part only), and ``--unknown_alg`` (a second net learns the
constraint; ``--pretrained`` warm-starts and freezes the differential net
from a known-constraint checkpoint). Every ``--test_freq`` iterations it
reports the constraint violation sum((x^2 + y^2 - 1)^2) over the
trajectory::

    python examples/pendulum_dae_torch.py                   # the H100
    python examples/pendulum_dae_torch.py --device cpu --double_prec \\
        --niters 200
    python examples/pendulum_dae_torch.py --unknown_alg --pretrained

Checkpoints are the JAX package's pickles of numpy arrays
(``pnode_tpu_torch.utils.save_checkpoint``, as ``examples/pendulum_dae.py``
writes them) in ``--train_dir`` (``best_pendulum_dae.ckpt``,
``best_pendulum_dae_unknown_alg.ckpt``), read by ``--pretrained`` and
``--hotstart``. As in the JAX example, the nets use
the tanh form of GELU (flax's ``nn.gelu`` default) and AdamW decays weights
by 1e-4 (optax's ``adamw`` default; torch's is 1e-2). PETSc-style flags
after the script's own options go to the port's options database.
``--device cuda`` raises when CUDA is absent: the CPU is an explicit
choice, never a fallback.
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
G = 9.81
ENDTIME = 0.5
# mass matrix: the last (algebraic) row is zero
MASS = np.diag([1.0, 1.0, 1.0, 1.0, 0.0])


def parse_args(argv=None):
    p = argparse.ArgumentParser("pendulum_DAE (PyTorch port)")
    p.add_argument("--method", type=str, default="cn")
    p.add_argument("--data_size", type=int, default=100)
    p.add_argument("--steps_per_data_point", type=int, default=1)
    p.add_argument("--niters", type=int, default=500)
    p.add_argument("--test_freq", type=int, default=10)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--unknown_alg", action="store_true")
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--hotstart", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str,
                   default="./train_results_pendulum_torch")
    p.add_argument("--init_std", type=float, default=0.01)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def pendulum_true(t, y, p):
    """The true DAE right-hand side: the index-1 form, lambda's equation in
    the algebraic row."""
    return torch.stack([y[2], y[3], -y[0] * y[4], -y[1] * y[4] - G,
                        y[4] * (y[0] ** 2 + y[1] ** 2) + G * y[1]
                        - (y[2] ** 2 + y[3] ** 2)])


class DenseNet(nn.Module):
    """5 -> 10 -> 10 -> d_out, no bias, the tanh form of GELU between the
    layers. The N(0, std) weights are drawn in fp64 from ``generator`` (a
    CPU one) and cast, so a seed gives the same net in every dtype and on
    every device."""

    def __init__(self, d_out, std, generator=None, dtype=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=False, dtype=dtype, device=device)
            for a, b in ((5, 10), (10, 10), (10, d_out)))
        with torch.no_grad():
            for lin in self.layers:
                w = torch.empty(lin.weight.shape, dtype=torch.float64)
                lin.weight.copy_(w.normal_(0.0, std, generator=generator))

    def forward(self, y):
        h = y
        for i, lin in enumerate(self.layers):
            h = lin(h)
            if i < len(self.layers) - 1:
                h = F.gelu(h, approximate="tanh")
        return h


class LearnedDAE(nn.Module):
    """f = (diff(y)[:4], g(y)): g the known constraint's row, or the
    learned ``alg`` net's output (``unknown_alg``)."""

    def __init__(self, unknown_alg, init_std=0.01, generator=None,
                 dtype=None, device=None):
        super().__init__()
        self.unknown_alg = unknown_alg
        self.diff = DenseNet(5, 0.01, generator, dtype, device)
        self.alg = DenseNet(1, init_std, generator, dtype, device)

    def forward(self, t, y):
        f_diff = self.diff(y)
        if self.unknown_alg:
            f_alg = self.alg(y)[0]
        else:
            f_alg = (y[4] * (y[0] ** 2 + y[1] ** 2) + G * y[1]
                     - (y[2] ** 2 + y[3] ** 2))
        return torch.cat([f_diff[:4], f_alg[None]])


def initial_state(dtype, device):
    """The consistent initial condition: theta0 0.5, at rest, lambda from
    the constraint."""
    th0 = 0.5
    x0, y0 = np.sin(th0), -np.cos(th0)
    return torch.tensor([x0, y0, 0.0, 0.0, -G * y0], dtype=dtype,
                        device=device)


def observation_times(data_size, steps_per_data_point):
    t_obs = np.linspace(0.0, ENDTIME, data_size + 1)
    return t_obs, float(t_obs[1] - t_obs[0]) / steps_per_data_point


def true_trajectory(y0, t_obs, step_size):
    """The data: the true DAE by CN through the mass matrix."""
    import pnode_tpu_torch as pt

    ode0 = pt.ODESolver().setupTS(
        y0, pt.Func(pendulum_true, {}), step_size=step_size, method="cn",
        implicit_form=True, mass=MASS, enable_adjoint=False)
    with torch.no_grad():
        return ode0.odeint(y0, t_obs)


def make_solver(model, y0, method, step_size):
    import pnode_tpu_torch as pt

    return pt.ODESolver().setupTS(
        y0, pt.TorchFunc(model), step_size=step_size, method=method,
        implicit_form=True, mass=MASS, enable_adjoint=True)


def constraint_violation(ode, y0, t_obs):
    """sum over the trajectory of (x^2 + y^2 - 1)^2."""
    with torch.no_grad():
        pred, _ = ode.solve(y0, t_obs, with_adjoint=False)
        return float(torch.sum((pred[:, 0] ** 2 + pred[:, 1] ** 2 - 1.0)
                               ** 2))


def main(argv=None, state=None):
    """Train; returns {"losses": per-iteration losses, "cv": [(iter,
    constraint violation)], "final": the running mean}. ``state`` (a
    state_dict of the learned DAE) replaces the seeded weights."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.utils import (
        RunningAverageMeter, load_checkpoint, makedirs, save_checkpoint)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.init([sys.argv[0]] + unknown)

    t_obs, step_size = observation_times(args.data_size,
                                         args.steps_per_data_point)
    true_y0 = initial_state(dtype, device)
    true_y = true_trajectory(true_y0, t_obs, step_size)
    print("data: constraint violation",
          float((true_y[:, 0] ** 2 + true_y[:, 1] ** 2 - 1.0).abs().max()))

    gen = torch.Generator().manual_seed(args.seed)
    model = LearnedDAE(args.unknown_alg, args.init_std, gen, dtype, device)
    if state is not None:
        model.load_state_dict(state)
    makedirs(args.train_dir)
    ckpt_known = os.path.join(args.train_dir, "best_pendulum_dae.ckpt")
    ckpt_path = os.path.join(
        args.train_dir, "best_pendulum_dae_unknown_alg.ckpt"
        if args.unknown_alg else "best_pendulum_dae.ckpt")
    if args.pretrained and os.path.exists(ckpt_known):
        ck = load_checkpoint(ckpt_known)
        model.diff.load_state_dict(
            {k[len("diff."):]: torch.as_tensor(v)
             for k, v in ck["params"].items() if k.startswith("diff.")})
        print("warm-started differential net from pretrained checkpoint")
    ode = make_solver(model, true_y0, args.method, step_size)

    # the pretrained mode freezes the differential net: the optimizer gets
    # the algebraic net's parameters only
    frozen_diff = args.pretrained and args.unknown_alg
    trained = model.alg.parameters() if frozen_diff else model.parameters()
    opt = torch.optim.AdamW(trained, lr=args.lr, weight_decay=1e-4)

    start_iter, best_loss = 0, float("inf")
    if args.hotstart and os.path.exists(ckpt_path):
        ck = load_checkpoint(ckpt_path)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in ck["params"].items()})
        start_iter, best_loss = int(ck["iter"]) + 1, float(ck["best_loss"])
        print(f"hotstart at iter {start_iter}")

    time_meter = RunningAverageMeter(0.97)
    loss_meter = RunningAverageMeter(0.97)
    losses, cvs = [], []
    end = time.time()
    for itr in range(start_iter, args.niters):
        opt.zero_grad(set_to_none=True)
        pred = ode.odeint_adjoint(true_y0, t_obs)
        loss = torch.mean(torch.abs(pred - true_y))
        loss.backward()
        opt.step()
        lv = float(loss.detach())
        losses.append(lv)
        time_meter.update(time.time() - end)
        loss_meter.update(lv)
        if itr % args.test_freq == 0:
            cv = constraint_violation(ode, true_y0, t_obs)
            cvs.append((itr, cv))
            print(f"Iter {itr:04d} | Time {time_meter.avg:.4f}s | "
                  f"Loss {loss_meter.avg:.6e} | Constraint dev {cv:.3e} | "
                  f"NFE-F {ode.nfe_forward}")
            if lv < best_loss:
                best_loss = lv
                save_checkpoint(ckpt_path, {"iter": itr,
                                            "params": model.state_dict(),
                                            "best_loss": best_loss})
        end = time.time()
    return {"losses": losses, "cv": cvs, "final": loss_meter.avg}


if __name__ == "__main__":
    out = main()
    print(f"final loss {out['final']:.6e}")
