"""Unstable-spiral fit on the PyTorch/CUDA port: the discrete-adjoint CN
path beside autodiff through dopri5.

Twin of ``examples/spiral_unstable.py``: an unstable linear-cubed spiral
(positive real part, data by CN at a quarter of the step without the
adjoint) trained side by side with (a) the implicit CN path and its
discrete adjoint (``odeint_adjoint``) and (b) plain autograd through the
steps of an explicit dopri5 solve (``solve(..., with_adjoint=False)``),
from the same weights on the same minibatches, each with its own RMSprop
in optax's form. Every ``--test_freq`` iterations it prints both running
losses and the gradients' global norms::

    python examples/spiral_unstable_torch.py              # the H100
    python examples/spiral_unstable_torch.py --device cpu --double_prec \\
        --niters 100

The seed (default 42) draws the minibatch windows (numpy, as the JAX
example) and the weights (fp64 from a CPU generator, then cast and moved).
PETSc-style flags after the script's own options go to the port's options
database. ``--device cuda`` raises when CUDA is absent: the CPU is an
explicit choice, never a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from spiral_torch import ODEFunc  # noqa: E402

TRUE_Y0 = (0.5, 0.0)
TRUE_A = ((0.1, 2.0), (-2.0, 0.1))
T_END = 5.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("spiral_unstable (PyTorch port)")
    p.add_argument("--method", type=str, default="cn")
    p.add_argument("--data_size", type=int, default=200)
    p.add_argument("--batch_time", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--niters", type=int, default=500)
    p.add_argument("--test_freq", type=int, default=20)
    p.add_argument("--step_size", type=float, default=0.025)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def ground_truth(t, step_size, dtype, device):
    """The data: (u^3) A by CN (implicit form) at step_size / 4."""
    import pnode_tpu_torch as pt

    y0 = torch.tensor(TRUE_Y0, dtype=dtype, device=device)
    A = torch.tensor(TRUE_A, dtype=dtype, device=device)
    ode = pt.ODESolver().setupTS(
        y0, lambda tt, y: (y ** 3) @ A, step_size=step_size / 4, method="cn",
        implicit_form=True, enable_adjoint=False)
    with torch.no_grad():
        return ode.odeint(y0, t)


def get_batch(rng, true_y, data_size, batch_time, batch_size):
    """(y0 (B, 2), targets (T, B, 2)), drawn as the JAX example draws."""
    s = rng.choice(data_size - batch_time, size=batch_size, replace=False)
    s_t = torch.as_tensor(s, device=true_y.device)
    return true_y[s_t], torch.stack([true_y[s_t + i]
                                     for i in range(batch_time)])


def make_solvers(func, args, dtype, device):
    """(the CN solver with the discrete adjoint, the dopri5 solver that
    autograd differentiates)."""
    import pnode_tpu_torch as pt

    tmpl = torch.zeros(args.batch_size, 2, dtype=dtype, device=device)
    ode_pnode = pt.ODESolver().setupTS(
        tmpl, pt.TorchFunc(func), step_size=args.step_size,
        method=args.method, implicit_form=True, enable_adjoint=True)
    ode_ref = pt.ODESolver().setupTS(
        tmpl, pt.TorchFunc(func), step_size=args.step_size, method="dopri5",
        enable_adjoint=False)
    return ode_pnode, ode_ref


def train_step(ode, adjoint, opt, params, y0, window_t, yt):
    """One RMSprop step; returns (loss, global gradient norm) as floats."""
    if adjoint:
        pred = ode.odeint_adjoint(y0, window_t)
    else:
        pred = ode.solve(y0, window_t, with_adjoint=False)[0]
    loss = torch.mean(torch.abs(pred - yt))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    gnorm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in params))
    opt.step()
    return float(loss.detach()), float(gnorm)


def main(argv=None):
    """Train both paths; returns {"pnode": losses, "ref": losses, "final":
    (the two running means), "seconds": the training loop's wall time}."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.utils import RunningAverageMeter
    from pnode_tpu_torch.utils.optim import RMSprop

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.init([sys.argv[0]] + unknown)

    t = np.linspace(0.0, T_END, args.data_size)
    true_y = ground_truth(t, args.step_size, dtype, device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    func_a = ODEFunc(gen, dtype, device)
    func_b = ODEFunc(dtype=dtype, device=device)
    func_b.load_state_dict(func_a.state_dict())
    window_t = t[:args.batch_time] - t[0]
    ode_pnode, _ = make_solvers(func_a, args, dtype, device)
    _, ode_ref = make_solvers(func_b, args, dtype, device)
    opt_a = RMSprop(func_a.parameters(), lr=args.lr)
    opt_b = RMSprop(func_b.parameters(), lr=args.lr)

    meter_a, meter_b = RunningAverageMeter(0.97), RunningAverageMeter(0.97)
    out = {"pnode": [], "ref": []}
    t0 = time.time()
    for itr in range(1, args.niters + 1):
        y0, yt = get_batch(rng, true_y, args.data_size, args.batch_time,
                           args.batch_size)
        la, ga = train_step(ode_pnode, True, opt_a, list(func_a.parameters()),
                            y0, window_t, yt)
        lb, gb = train_step(ode_ref, False, opt_b, list(func_b.parameters()),
                            y0, window_t, yt)
        out["pnode"].append(la)
        out["ref"].append(lb)
        meter_a.update(la)
        meter_b.update(lb)
        if itr % args.test_freq == 0:
            print(f"Iter {itr:04d} | PNODE(CN) loss {meter_a.avg:.6f} "
                  f"(|g| {ga:.3e}) | dopri5-AD loss {meter_b.avg:.6f} "
                  f"(|g| {gb:.3e})")
    out["final"] = (meter_a.avg, meter_b.avg)
    out["seconds"] = time.time() - t0
    return out


if __name__ == "__main__":
    res = main()
    la, lb = res["final"]
    print(f"final: PNODE {la:.6f} | AD reference {lb:.6f}")
