"""FFJORD on 2-D toy densities on the PyTorch/CUDA port, with flow plots.

Twin of ``examples/ffjord_toy.py``: one CNF block (concatsquash, tanh,
64-64-64, dopri5 at 0.05 over T 0.5, a Rademacher probe) trained by Adam on
batches of 512 from a toy distribution (``ffjord.toy_data``, the JAX
package's sampler on the same ``np.random.default_rng(seed)`` draws);
``--viz`` saves a figure every ``--viz_freq`` iterations (data, flow
samples through the reverse flow, the learned density by the brute-force
divergence). The final weights go to ``<save>/checkpt.ckpt`` (the JAX
driver writes none)::

    python examples/ffjord_toy_torch.py --data 8gaussians --niters 500 --viz
    python examples/ffjord_toy_torch.py --device cpu --niters 20

The weights come from torch's generator seeded by ``--seed`` on the CPU and
each iteration's probe from a CPU generator seeded by ``--seed``.
PETSc-style flags after the script's own options go to the port's options
database. ``--device cuda`` raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("ffjord-toy (PyTorch port)")
    p.add_argument("--data", type=str, default="8gaussians")
    p.add_argument("--dims", type=str, default="64-64-64")
    p.add_argument("--layer_type", type=str, default="concatsquash")
    p.add_argument("--nonlinearity", type=str, default="tanh")
    p.add_argument("--time_length", type=float, default=0.5)
    p.add_argument("--solver", type=str, default="dopri5")
    p.add_argument("--step_size", type=float, default=0.05)
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--viz_freq", type=int, default=200)
    p.add_argument("--save", type=str,
                   default="./train_results_ffjord_toy_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def build_model(args, device, dtype):
    from pnode_tpu_torch.ffjord import build_model_tabular

    torch.manual_seed(args.seed)
    return build_model_tabular(
        dim=2, num_blocks=1,
        hidden_dims=tuple(int(d) for d in args.dims.split("-")),
        layer_type=args.layer_type, nonlinearity=args.nonlinearity,
        time_length=args.time_length, solver=args.solver,
        step_size=args.step_size, rademacher=True, device=device,
        dtype=dtype)


def nll(model, x, generator=None, probes=None):
    from pnode_tpu_torch.ffjord import standard_normal_logprob

    z, dlp, _ = model.apply(x, training=True, generator=generator,
                            probes=probes)
    return -torch.mean(standard_normal_logprob(z)[:, None] - dlp)


def train_step(model, opt, x, generator=None, probes=None):
    loss = nll(model, x, generator, probes)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def visualize(model, args, itr, device, dtype):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pnode_tpu_torch.ffjord import standard_normal_logprob
    from pnode_tpu_torch.ffjord.toy_data import inf_train_gen

    os.makedirs(os.path.join(args.save, "png"), exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    data = inf_train_gen(args.data, np.random.default_rng(0), 2000)
    axes[0].scatter(data[:, 0], data[:, 1], s=2, alpha=0.5)
    axes[0].set_title("data")
    z = np.random.default_rng(1).normal(size=(2000, 2))
    with torch.no_grad():
        x_gen, _, _ = model.apply(
            torch.as_tensor(z, dtype=dtype, device=device), training=False,
            reverse=True, generator=torch.Generator().manual_seed(0))
        x_gen = x_gen.cpu().numpy()
        axes[1].scatter(x_gen[:, 0], x_gen[:, 1], s=2, alpha=0.5)
        axes[1].set_title("flow samples")
        g = np.linspace(-4, 4, 80)
        xx, yy = np.meshgrid(g, g)
        pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], 1),
                              dtype=dtype, device=device)
        zz, dlp, _ = model.apply(pts, training=False, exact_div=True)
        logp = (standard_normal_logprob(zz)[:, None] - dlp).cpu().numpy()
    axes[2].imshow(np.exp(logp).reshape(80, 80), extent=[-4, 4, -4, 4],
                   origin="lower")
    axes[2].set_title("learned density")
    for ax in axes:
        ax.set_xlim(-4, 4)
        ax.set_ylim(-4, 4)
    fig.tight_layout()
    path = os.path.join(args.save, "png", f"{itr:06d}.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def main(argv=None):
    """Train; returns {"losses", "final" (the EMA NLL), "seconds"}."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.ffjord.toy_data import inf_train_gen
    from pnode_tpu_torch.utils import RunningAverageMeter, save_checkpoint

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    dtype = torch.float64 if args.double_prec else torch.float32
    pt.init([sys.argv[0]] + unknown)
    model = build_model(args, device, dtype)
    rng = np.random.default_rng(args.seed)
    # the JAX driver draws one batch to initialize its parameters
    inf_train_gen(args.data, rng, args.batch_size)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator().manual_seed(args.seed)
    loss_meter = RunningAverageMeter(0.97)
    losses = []
    t0 = end = time.time()
    for itr in range(1, args.niters + 1):
        x = torch.as_tensor(inf_train_gen(args.data, rng, args.batch_size),
                            dtype=dtype, device=device)
        lv = float(train_step(model, opt, x, generator=gen))
        losses.append(lv)
        loss_meter.update(lv)
        if itr % 100 == 0:
            print(f"Iter {itr:05d} | Time {time.time() - end:.2f}s | "
                  f"NLL {loss_meter.avg:.4f}")
            end = time.time()
        if args.viz and itr % args.viz_freq == 0:
            print("saved", visualize(model, args, itr, device, dtype))
    seconds = time.time() - t0
    save_checkpoint(os.path.join(args.save, "checkpt.ckpt"),
                    {"params": model.state_dict(), "itr": args.niters})
    return {"losses": losses, "final": loss_meter.avg, "seconds": seconds}


if __name__ == "__main__":
    out = main()
    print(f"final NLL {out['final']:.4f}")
