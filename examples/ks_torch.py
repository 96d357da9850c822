"""KS (Kuramoto-Sivashinsky) SINODE training on the PyTorch/CUDA port.

Twin of the IMEX branch of ``examples/ks.py`` (without ``--fused_loop``):
learned chaotic-PDE dynamics on a 64-point L=22 grid, f_IM the fixed
5-point stencil, f_EX = -MLP 64 -> 104 x4 -> 64, one-step windows trained
with Adam through ``ODESolver.odeint_adjoint`` and its hand-written
discrete adjoint, a plateau LR decay on the validation loss::

    python examples/ks_torch.py                       # the H100 (default)
    python examples/ks_torch.py --device cpu --max_epochs 1 --data_size 80 \
        --batch_size 16

The defaults are the main-path recipe: ARK3 IMEX, ``linear_solver hpddm``
with a frozen Jacobian, ``-snes_type ksponly`` (a programmatic default that
a command-line flag overrides), and the fused MLP, which on CUDA runs the
fused ARK step kernels. PETSc-style flags after the script's own options go
to the port's options database (``-ts_arkimex_type ars122``,
``-pnode_fused_ark_adjoint off``, ...). ``--device cuda`` raises when CUDA
is absent: the CPU is an explicit choice, never a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, L = 64, 22.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("KS (PyTorch port)")
    p.add_argument("--normalize", choices=["minmax", "mean"], default=None)
    p.add_argument("--step_size", type=float, default=0.2)
    p.add_argument("--data_size", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--time_window_size", type=int, default=1)
    p.add_argument("--time_window_endpoint", action="store_true")
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--validate_freq", type=int, default=1)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str, default="./train_results_ks_torch")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--linear_solver", choices=["hpddm", "torch"],
                   default="hpddm")
    p.add_argument("--fixed_jacobian", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--use_fused", action=argparse.BooleanOptionalAction,
                   default=True, help="fused MLP (K1) and, on the fused "
                   "gate, the ARK step kernels (K2, K3)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def make_batches(u, rng, W, batch_size, endpoint):
    """Windowed minibatches: y0 = u[i], targets u[i+1..i+W] (or endpoint)."""
    starts = np.arange(len(u) - W)
    rng.shuffle(starts)
    for b in range(len(starts) // batch_size):
        s = starts[b * batch_size:(b + 1) * batch_size]
        tgt = (u[s + W][:, None] if endpoint
               else np.stack([u[s + 1 + j] for j in range(W)], axis=1))
        yield u[s], tgt


def main(argv=None):
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.data import generate_ks_data
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.set_option("snes_type", "ksponly")
    pt.init([sys.argv[0]] + unknown)

    u_all, dt_data = generate_ks_data(
        nx=NX, L=L, n_samples=args.data_size, dt_data=args.step_size,
        cache_dir=os.path.join(args.train_dir, "data"))
    if args.normalize == "minmax":
        lo, hi = u_all.min(), u_all.max()
        u_all = 2 * (u_all - lo) / (hi - lo) - 1
    elif args.normalize == "mean":
        u_all = (u_all - u_all.mean()) / u_all.std()
    n_train = int(0.8 * len(u_all))
    u_train, u_val = u_all[:n_train], u_all[n_train:]
    print(f"KS data: train {u_train.shape}, val {u_val.shape}, dt {dt_data}")

    W = args.time_window_size
    t_out = (np.asarray([0.0, W * dt_data]) if args.time_window_endpoint
             else np.arange(W + 1) * dt_data)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    im = KSFuncIM(nx=NX, L=L, dtype=dtype, device=device)
    ex = KSFuncEX(nx=NX, use_fused=args.use_fused, generator=gen,
                  dtype=dtype, device=device)
    ode = pt.ODESolver()
    ode.setupTS(
        torch.zeros(args.batch_size, NX, dtype=dtype, device=device),
        pt.TorchFunc(im), step_size=args.step_size, method="imex",
        imex_form=True, implicit_form=True, func2=pt.TorchFunc(ex),
        linear_solver=args.linear_solver,
        fixed_jacobian=args.fixed_jacobian, batch_size=args.batch_size)
    opt = torch.optim.Adam(ex.parameters(), lr=args.lr)

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def data_loss(pred, tgt):
        # pred[0] is y0 itself; targets align with pred[1:]
        return torch.mean((pred[1:].transpose(0, 1) - tgt) ** 2)

    # plateau LR decay on the per-epoch validation loss (halve after 10
    # non-improving validations), as examples/ks.py does
    lr_now, lr_best, lr_bad = args.lr, float("inf"), 0
    best_val = float("inf")
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.max_epochs):
        t0 = time.time()
        losses = []
        for y0, tgt in make_batches(u_train, rng, W, args.batch_size,
                                    args.time_window_endpoint):
            pred = ode.odeint_adjoint(as_t(y0), t_out)
            loss = data_loss(pred, as_t(tgt))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        train_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        if epoch % args.validate_freq:
            continue
        # one full validation batch, like the reference's loader
        with torch.no_grad():
            vb = list(make_batches(u_val, np.random.default_rng(0), W,
                                   len(u_val) - W, args.time_window_endpoint))
            vl = float(np.mean([
                float(data_loss(ode.odeint(as_t(y0), t_out), as_t(tgt)))
                for y0, tgt in vb])) if vb else float("nan")
        if vl < lr_best * (1.0 - 1e-4):
            lr_best, lr_bad = vl, 0
        else:
            lr_bad += 1
            if lr_bad > 10:
                lr_now, lr_bad = lr_now * 0.5, 0
                for group in opt.param_groups:
                    group["lr"] = lr_now
                print(f"plateau: lr -> {lr_now:.2e}")
        best_val = min(best_val, vl)
        print(f"Epoch {epoch:04d} | Time {time.time() - t0:.2f}s | "
              f"Train {train_loss:.6e} | Val {vl:.6e} | "
              f"NFE-F {ode.nfe_forward}")
    return best_val


if __name__ == "__main__":
    bv = main()
    print(f"best val loss {bv:.6e}")
