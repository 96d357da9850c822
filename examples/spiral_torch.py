"""Spiral neural-ODE fit on the PyTorch/CUDA port.

Twin of ``examples/spiral.py``: the ground truth du/dt = (u^3) A from a
second solver without the adjoint (dopri5 at half the data spacing),
random time-window minibatches drawn by ``np.random.default_rng(seed)``
(the same windows as the JAX example), a tanh MLP on y^3, RMSprop in
optax's form (``pnode_tpu_torch.utils.optim.RMSprop``: decay 0.9, eps
inside the square root), EMA meters and the test loss on the full
trajectory every ``--test_freq`` iterations::

    python examples/spiral_torch.py                   # the H100
    python examples/spiral_torch.py --device cpu --double_prec --niters 60
    python examples/spiral_torch.py --niters 500 -ts_type cn -snes_type ksponly

The weights are drawn in fp64 from a CPU generator seeded by ``--seed`` and
then cast and moved, so a seed gives the same net on every device and in
every dtype. PETSc-style flags after the script's own options go to the
port's options database (``-ts_trajectory_max_cps_ram 16``, ...).
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
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUE_Y0 = (2.0, 0.0)
TRUE_A = ((-0.1, 2.0), (-2.0, -0.1))
T_END = 25.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("spiral (PyTorch port)")
    p.add_argument("--method", type=str, default="dopri5")
    p.add_argument("--data_size", type=int, default=1000)
    p.add_argument("--batch_time", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--test_freq", type=int, default=20)
    p.add_argument("--step_size", type=float, default=0.025)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--implicit_form", action="store_true")
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--train_dir", type=str,
                   default="./train_results_spiral_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


class ODEFunc(nn.Module):
    """y -> Linear(2, 50) on y^3, tanh, Linear(50, 2); N(0, 0.1) weights,
    zero biases (flax's Dense defaults), drawn in fp64 from ``generator``
    (a CPU one) and cast."""

    def __init__(self, generator=None, dtype=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype, device=device)
            for a, b in ((2, 50), (50, 2)))
        with torch.no_grad():
            for lin in self.layers:
                w = torch.empty(lin.weight.shape, dtype=torch.float64)
                lin.weight.copy_(w.normal_(0.0, 0.1, generator=generator))
                lin.bias.zero_()

    def forward(self, t, y):
        return self.layers[1](torch.tanh(self.layers[0](y ** 3)))


def ground_truth(t, dtype, device):
    """The data: (u^3) A by dopri5 at half the data spacing, no adjoint."""
    import pnode_tpu_torch as pt

    y0 = torch.tensor(TRUE_Y0, dtype=dtype, device=device)
    A = torch.tensor(TRUE_A, dtype=dtype, device=device)
    ode = pt.ODESolver().setupTS(
        y0, lambda tt, y: (y ** 3) @ A, step_size=float(t[1] - t[0]) / 2,
        method="dopri5", enable_adjoint=False)
    with torch.no_grad():
        return ode.odeint(y0, t)


def get_batch(rng, true_y, t, data_size, batch_time, batch_size):
    """(y0 (B, 2), window offsets (T,), targets (T, B, 2)): the JAX
    example's draw from the same numpy generator."""
    s = rng.choice(data_size - batch_time, size=batch_size, replace=False)
    s_t = torch.as_tensor(s, device=true_y.device)
    batch_y = torch.stack([true_y[s_t + i] for i in range(batch_time)])
    return true_y[s_t], t[:batch_time] - t[0], batch_y


def make_solvers(func, y_tmpl, y0, args):
    """(training solver with the adjoint, test solver without)."""
    import pnode_tpu_torch as pt

    kw = dict(step_size=args.step_size, method=args.method,
              implicit_form=args.implicit_form)
    ode = pt.ODESolver().setupTS(y_tmpl, pt.TorchFunc(func),
                                 enable_adjoint=True, **kw)
    ode_test = pt.ODESolver().setupTS(y0, pt.TorchFunc(func),
                                      enable_adjoint=False, **kw)
    return ode, ode_test


def window_loss(ode, y0, window_t, batch_y):
    """mean |pred - batch_y| through the discrete adjoint."""
    return torch.mean(torch.abs(ode.odeint_adjoint(y0, window_t) - batch_y))


def train_step(ode, opt, y0, window_t, batch_y):
    """One RMSprop step; returns the loss (a tensor)."""
    loss = window_loss(ode, y0, window_t, batch_y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    """Train; returns {"losses": per-iteration losses, "test": [(iter,
    test loss)], "final": the final test loss, "seconds": the training
    loop's wall time}."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.utils import RunningAverageMeter, makedirs
    from pnode_tpu_torch.utils.optim import RMSprop

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.init([sys.argv[0]] + unknown)
    makedirs(args.train_dir)

    t = np.linspace(0.0, T_END, args.data_size)
    true_y = ground_truth(t, dtype, device)
    true_y0 = true_y[0]
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    func = ODEFunc(gen, dtype, device)
    # the JAX example draws one batch to size its solver's template
    by0, window_t, _ = get_batch(rng, true_y, t, args.data_size,
                                 args.batch_time, args.batch_size)
    ode, ode_test = make_solvers(func, by0, true_y0, args)
    opt = RMSprop(func.parameters(), lr=args.lr)

    def test_loss():
        with torch.no_grad():
            return float(torch.mean(torch.abs(ode_test.odeint(true_y0, t)
                                              - true_y)))

    time_meter = RunningAverageMeter(0.97)
    loss_meter = RunningAverageMeter(0.97)
    losses, tests = [], []
    t0 = end = time.time()
    for itr in range(1, args.niters + 1):
        by0, _, by = get_batch(rng, true_y, t, args.data_size,
                               args.batch_time, args.batch_size)
        lv = float(train_step(ode, opt, by0, window_t, by))
        losses.append(lv)
        time_meter.update(time.time() - end)
        loss_meter.update(lv)
        if itr % args.test_freq == 0:
            tl = test_loss()
            tests.append((itr, tl))
            print(f"Iter {itr:04d} | Time {time_meter.avg:.4f}s | "
                  f"Train Loss {loss_meter.avg:.6f} | Test Loss {tl:.6f} | "
                  f"NFE-F {ode.nfe_forward}")
        end = time.time()
    seconds = time.time() - t0
    return {"losses": losses, "test": tests, "final": test_loss(),
            "seconds": seconds}


if __name__ == "__main__":
    out = main()
    print(f"final test loss {out['final']:.6f}")
