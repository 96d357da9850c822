"""KS (Kuramoto-Sivashinsky) SINODE training on the PyTorch/CUDA port.

Twin of the IMEX branch of ``examples/ks.py`` (without ``--fused_loop``):
learned chaotic-PDE dynamics on a 64-point L=22 grid, f_IM the fixed
5-point stencil, f_EX = -MLP 64 -> 104 x4 -> 64, one-step windows trained
with Adam through ``ODESolver.odeint_adjoint`` and its hand-written
discrete adjoint, a plateau LR decay on the validation loss::

    python examples/ks_torch.py                       # the H100 (default)
    python examples/ks_torch.py --fused_loop          # one launch per epoch
    python examples/ks_torch.py --device cpu --max_epochs 1 --data_size 80 \
        --batch_size 16

The defaults are the main-path recipe: ARK3 IMEX, ``linear_solver hpddm``
with a frozen Jacobian, ``-snes_type ksponly`` (a programmatic default that
a command-line flag overrides), and the fused MLP, which on CUDA runs the
fused ARK step kernels. PETSc-style flags after the script's own options go
to the port's options database (``-ts_arkimex_type ars122``,
``-pnode_fused_ark_adjoint off``, ...). ``--device cuda`` raises when CUDA
is absent: the CPU is an explicit choice, never a fallback.

``--fused_loop`` (twin of ``examples/ks.py --fused_loop``) runs each epoch's
minibatches, stacked into (K, B, 64), as K iterations of the fused training
loop (K4: forward step, MSE, stage-exact reverse, Adam in optax's form) in
one call, carrying the weights and Adam moments across epochs; the plateau
LR goes in as its ``lr``. At the end of each epoch the loop's weights are
copied into the model, so validation runs through ``ode.odeint`` as before.
It needs the fused-kernel gate (``--use_fused``, ksponly, frozen Jacobian),
``--time_window_size 1`` and fp32; the CPU runs the loop's plain version.
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
    p.add_argument("--fused_loop", action="store_true",
                   help="each epoch as K iterations of the fused training "
                   "loop (K4) in one call")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


class FusedLoop:
    """The ``--fused_loop`` path: K4's operands from the fused step gate
    (``stepper.prepare`` + ``_fused_reverse_args``), and the explicit
    part's weights and Adam moments carried from call to call."""

    def __init__(self, ode, ex, batch_size, step_size):
        import torch

        from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop_fits

        p = next(ex.parameters())
        y_tmpl = torch.zeros(batch_size, ex.nx, dtype=p.dtype, device=p.device)
        params = ({}, dict(ex.named_parameters()))
        stp = ode._stepper.prepare(0.0, y_tmpl, params, dt0=step_size)
        gate = stp._fused_reverse_args(params, dt=step_size)
        if gate is None:
            raise SystemExit(
                "--fused_loop requires the fused-kernel gate: --use_fused, "
                "--fixed_jacobian, --linear_solver hpddm, -snes_type ksponly "
                "(frozen linear implicit part)")
        spec, self.J, self.inv = gate
        self.tab = stp._tableau_static()
        dims = [int(w.shape[1]) for w in spec["Ws"]]
        if not fused_train_loop_fits(batch_size, ex.nx, dims,
                                     stages=len(self.tab[2])):
            raise SystemExit("--fused_loop: the configuration exceeds the "
                             "loop kernel's shared-memory budget")
        # the step size as the fp32 solve carries it
        self.dt = float(torch.tensor(step_size, dtype=p.dtype))
        self.spec = spec
        self.Ws = [w.detach().clone() for w in spec["Ws"]]
        self.bs = [b.detach().clone() for b in spec["bs"]]
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]  # noqa: E731
        self.m = (zeros(self.Ws), zeros(self.bs))
        self.v = (zeros(self.Ws), zeros(self.bs))
        self.t = 0

    def run(self, y_stack, tgt_stack, lr, eps=1e-8):
        """K = len(y_stack) Adam iterations; returns the K losses."""
        from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

        self.Ws, self.bs, self.m, self.v, losses = fused_train_loop(
            self.tab, self.dt, y_stack, tgt_stack, self.J, self.inv, self.Ws,
            self.bs, self.m, self.v, self.t,
            activation=self.spec["activation"], sign=self.spec["sign"],
            lr=lr, eps=eps)
        self.t += int(y_stack.shape[0])
        return losses

    def copy_to(self, ex):
        """Write the loop's weights into the model's parameters."""
        import torch

        new = self.spec["rebuild"](self.Ws, self.bs)
        with torch.no_grad():
            for name, prm in ex.named_parameters():
                prm.copy_(new[name])


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
    fused = None
    if args.fused_loop:
        if W != 1 or dtype != torch.float32:
            raise SystemExit("--fused_loop requires --time_window_size 1 "
                             "and fp32 (no --double_prec)")
        fused = FusedLoop(ode, ex, args.batch_size, args.step_size)

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
    history = []  # per epoch, the per-iteration train losses
    for epoch in range(args.max_epochs):
        t0 = time.time()
        batches = list(make_batches(u_train, rng, W, args.batch_size,
                                    args.time_window_endpoint))
        if fused is not None and batches:
            # the whole epoch as one call; targets (B, 1, d) -> (B, d)
            losses = fused.run(as_t(np.stack([b[0] for b in batches])),
                               as_t(np.stack([b[1][:, 0] for b in batches])),
                               lr_now)
            fused.copy_to(ex)
        else:
            losses = []
            for y0, tgt in batches:
                pred = ode.odeint_adjoint(as_t(y0), t_out)
                loss = data_loss(pred, as_t(tgt))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            losses = torch.stack(losses) if losses else torch.zeros(0)
        history.append(losses.cpu().tolist())
        train_loss = (float(np.mean(history[-1])) if history[-1]
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
    return best_val, history


if __name__ == "__main__":
    bv, _ = main()
    print(f"best val loss {bv:.6e}")
