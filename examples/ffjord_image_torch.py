"""Image CNF training on the PyTorch/CUDA port: ODENVP or the
multiscale-parallel CNF on MNIST / CIFAR-10.

Twin of ``examples/ffjord_image.py``: uniform dequantization ``(255 x +
u) / 256``, the bits/dim objective, Adam, per-epoch bits/dim, the best
checkpoint and ``--hotstart``, and a sample grid per epoch through the
multiscale inverse. The defaults are the JAX driver's: mnist, odenvp, 2
scales, one block a scale, hidden 32,32, concat layers, rk4 at 0.25 over T
0.5, batch 64. Images are NHWC, as in the JAX package::

    python examples/ffjord_image_torch.py --epochs 2            # the H100
    python examples/ffjord_image_torch.py --device cpu --epochs 1 \\
        --iters_per_epoch 2 --batch_size 4 --hidden_dims 8

The images come from ``--data_dir`` (MNIST's IDX files or ``mnist.pkl``,
CIFAR-10's python batches) when they are there, else from the JAX driver's
synthetic surrogate (4,096 smooth blobs, the same numpy draws). The weights
come from torch's generator seeded by ``--seed`` on the CPU; the
dequantization noise and the probes from a CPU generator seeded by
``--seed``. ``--device cuda`` raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}


def parse_args(argv=None):
    p = argparse.ArgumentParser("ffjord-image (PyTorch port)")
    p.add_argument("--data", choices=["mnist", "cifar10"], default="mnist")
    p.add_argument("--model", choices=["odenvp", "multiscale-parallel"],
                   default="odenvp")
    p.add_argument("--n_scales", type=int, default=2)
    p.add_argument("--n_blocks", type=int, default=1)
    p.add_argument("--hidden_dims", type=str, default="32,32")
    p.add_argument("--layer_type", type=str, default="concat")
    p.add_argument("--solver", type=str, default="rk4")
    p.add_argument("--step_size", type=float, default=0.25)
    p.add_argument("--time_length", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--iters_per_epoch", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--train_dir", type=str,
                   default="./train_results_ffjord_img_torch")
    p.add_argument("--n_sample", type=int, default=16)
    p.add_argument("--hotstart", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def load_mnist_idx(data_dir):
    """MNIST's IDX file (train-images-idx3-ubyte[.gz])."""
    import gzip
    import struct

    for fname in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
        for opener, suff in ((gzip.open, ".gz"), (open, "")):
            path = os.path.join(data_dir, fname + suff)
            if not os.path.exists(path):
                continue
            with opener(path, "rb") as f:
                magic, n, h, w = struct.unpack(">IIII", f.read(16))
                if magic != 0x803:
                    raise ValueError(f"bad IDX magic {magic:#x} in {path}")
                x = np.frombuffer(f.read(n * h * w), np.uint8)
            return x.reshape(n, h, w, 1)
    raise FileNotFoundError("no MNIST IDX file")


def load_images(name, data_dir):
    """(uint8 NHWC images, synthetic?): the files where they are, else the
    JAX driver's surrogate of smooth blobs."""
    try:
        if name == "cifar10":
            xs = []
            for i in range(1, 6):
                with open(os.path.join(data_dir, "cifar-10-batches-py",
                                       f"data_batch_{i}"), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(d[b"data"]))
            x = np.concatenate(xs).reshape(-1, 3, 32, 32)
            return x.transpose(0, 2, 3, 1).astype(np.uint8), False
        try:
            return load_mnist_idx(data_dir), False
        except FileNotFoundError:
            pass
        with open(os.path.join(data_dir, "mnist.pkl"), "rb") as f:
            x = pickle.load(f)["train_x"]
        return x.reshape(-1, 28, 28, 1).astype(np.uint8), False
    except (FileNotFoundError, OSError):
        h, w, c = SHAPES[name]
        rng = np.random.default_rng(0)
        n = 4096
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        cx = rng.random((n, 1, 1, 1))
        cy = rng.random((n, 1, 1, 1))
        r = 0.08 + 0.12 * rng.random((n, 1, 1, 1))
        d2 = ((xx[None, :, :, None] - cx) ** 2
              + (yy[None, :, :, None] - cy) ** 2)
        x = np.exp(-d2 / (2 * r ** 2)).astype(np.float32)
        x = np.broadcast_to(x, (n, h, w, c))
        return (255 * x).astype(np.uint8), True


def build_model(args, shape, device, dtype):
    from pnode_tpu_torch.ffjord import MultiscaleParallelCNF, ODENVP

    hidden = tuple(int(s) for s in args.hidden_dims.split(","))
    torch.manual_seed(args.seed)
    if args.model == "odenvp":
        return ODENVP(shape, n_scales=args.n_scales, n_blocks=args.n_blocks,
                      hidden_dims=hidden, layer_type=args.layer_type,
                      solver=args.solver, step_size=args.step_size,
                      time_length=args.time_length, device=device,
                      dtype=dtype)
    return MultiscaleParallelCNF(
        shape, n_blocks=args.n_blocks, intermediate_dims=hidden,
        solver=args.solver, step_size=args.step_size,
        time_length=args.time_length, alpha=0.05, device=device, dtype=dtype)


def bits_per_dim(model, x, generator=None, probes=None):
    """-log2 p(x) per dimension, +8 bits for the 1/256 scaling."""
    logpx, _ = model.log_prob(x, generator=generator, probes=probes,
                              training=True)
    return -torch.mean(logpx) / (x[0].numel() * math.log(2)) + 8.0


def dequantize(batch_u8, generator, dtype, device):
    """(x + u) / 256 with u ~ U[0, 1) from ``generator`` (on the CPU)."""
    u = torch.rand(batch_u8.shape, generator=generator, dtype=dtype)
    x = (torch.as_tensor(batch_u8, dtype=dtype) + u) / 256.0
    return x.to(device)


def train_step(model, opt, x, generator=None, probes=None):
    bpd = bits_per_dim(model, x, generator, probes)
    opt.zero_grad(set_to_none=True)
    bpd.backward()
    opt.step()
    return bpd.detach()


def main(argv=None):
    """Train; returns {"bpd" (per iteration), "best", "seconds", "iters",
    "images_per_s"}."""
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
    makedirs(args.train_dir)
    x_all, synthetic = load_images(args.data, args.data_dir)
    if synthetic:
        print("image files not found; using the synthetic surrogate")
    shape = SHAPES[args.data]
    model = build_model(args, shape, device, dtype)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.model} on {args.data}{shape}: {n_params / 1e6:.3f}M params")
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator().manual_seed(args.seed)

    iters = args.iters_per_epoch or max(1, len(x_all) // args.batch_size)
    writer = MetricsWriter(args.train_dir)
    meter = RunningAverageMeter(0.95)
    best = float("inf")
    ckpt_path = os.path.join(args.train_dir, "ckpt.pkl")
    if args.hotstart and os.path.exists(ckpt_path):
        saved = load_checkpoint(ckpt_path)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in saved["params"].items()})
        opt.load_state_dict(torch.load(
            os.path.join(args.train_dir, "opt.pt"), map_location=device))
        best = float(saved["best"])
        print(f"hotstart: resumed (best {best:.4f})")

    rng = np.random.default_rng(args.seed)
    out = {"bpd": [], "best": best, "seconds": 0.0, "iters": 0}
    for epoch in range(args.epochs):
        t0 = time.time()
        perm = rng.permutation(len(x_all))
        bpds = []
        for it in range(iters):
            idx = perm[it * args.batch_size:(it + 1) * args.batch_size]
            if len(idx) < args.batch_size:
                break
            x = dequantize(x_all[idx], gen, dtype, device)
            bpds.append(train_step(model, opt, x, generator=gen))
        bpds = torch.stack(bpds).cpu().numpy()
        epoch_s = time.time() - t0
        out["seconds"] += epoch_s
        out["iters"] += len(bpds)
        out["bpd"] += [float(b) for b in bpds]
        for b in bpds:
            meter.update(float(b))
        writer.add_scalar("Train/bits_per_dim", float(bpds.mean()), epoch)
        print(f"Epoch {epoch:03d} | {epoch_s:.1f}s | "
              f"bits/dim {bpds.mean():.4f} (ema {meter.avg:.4f}) | "
              f"{len(bpds) * args.batch_size / epoch_s:.1f} images/s")
        if float(bpds.mean()) < best:
            best = float(bpds.mean())
            save_checkpoint(ckpt_path, {"params": model.state_dict(),
                                        "best": best, "args": vars(args)})
            torch.save(opt.state_dict(),
                       os.path.join(args.train_dir, "opt.pt"))
        # a sample grid through the inverse path
        with torch.no_grad():
            samples = model.sample(args.n_sample, generator=gen)
        np.save(os.path.join(args.train_dir, f"samples_ep{epoch:03d}.npy"),
                samples.cpu().numpy())
    writer.close()
    out["best"] = best
    out["images_per_s"] = (out["iters"] * args.batch_size
                           / max(out["seconds"], 1e-9))
    return out


if __name__ == "__main__":
    main()
