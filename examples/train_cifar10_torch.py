"""CIFAR-10 ODE-net training on the PyTorch/CUDA port + the memstat record.

Twin of ``examples/train_cifar10.py``: SqueezeNext with ODE blocks
(SqNxt-23, ``pnode_tpu_torch.models.SqueezeNextODE``), the ODE blocks
trained through the discrete adjoint, SGD with momentum and weight decay on
the piecewise schedule (x0.1 at 30, 60 and 80 epochs of iterations), the
per-epoch train and test accuracy, and the ``memstat.txt`` record
``Nt mem_gb epoch_time method source precision`` (peak device memory from
``torch.cuda.max_memory_allocated``)::

    python examples/train_cifar10_torch.py --Nt 2 --method rk4 --epochs 2
    python examples/train_cifar10_torch.py --precision bf16 --epochs 2
    python examples/train_cifar10_torch.py --device cpu --epochs 1 \
        --iters_per_epoch 2 --batch_size 4 --width_x 0.25 --method euler --Nt 1

The same flags as the JAX trainer, with ``--device`` (default ``cuda``; it
raises when CUDA is absent: the CPU is an explicit choice, never a fallback)
and ``--use_kernels auto|on|off`` (the fused ODE-dynamics kernels K6-K9, or
the module path) in place of ``--cpu`` and ``--use_pallas``. ``--precision
bf16`` trains the JAX trainer's mixed precision (fp32 parameters, bf16
activations and ODE states, fp32 norm statistics and logits), with the bf16
instances of K6-K9 under ``--use_kernels auto|on`` and bf16 ``F.conv2d``
under ``off``. PETSc-style flags after the script's own options go to the
port's options database.

The CIFAR-10 pickles are read from ``--data_dir`` when present (then the
random crop and flip run on the device from a ``torch.Generator``);
otherwise the JAX trainer's synthetic surrogate, bit for bit (5,000 train and
1,000 test images from ``default_rng(0)``, class-tinted channel means, no
augmentation).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("cifar10-odenet (PyTorch port)")
    p.add_argument("--method", type=str, default="rk4")
    p.add_argument("--Nt", type=int, default=2)
    p.add_argument("--t1", type=float, default=1.0)
    p.add_argument("--width_x", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--data_dir", type=str,
                   default="./data/cifar-10-batches-py")
    p.add_argument("--train_dir", type=str, default="./train_results_cifar")
    p.add_argument("--iters_per_epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16"])
    p.add_argument("--use_kernels", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def load_cifar10(data_dir):
    """Standard cifar-10-batches-py pickles; the synthetic surrogate if
    absent. Returns (x_tr, y_tr, x_te, y_te, synthetic), NHWC float32."""
    try:
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(data_dir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        with open(os.path.join(data_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x_tr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_tr = np.concatenate(ys).astype(np.int32)
        x_te = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_te = np.array(d[b"labels"], np.int32)
        mean = np.array([0.4914, 0.4822, 0.4465]) * 255
        std = np.array([0.2023, 0.1994, 0.2010]) * 255
        norm = lambda x: ((x - mean) / std).astype(np.float32)  # noqa: E731
        return norm(x_tr), y_tr, norm(x_te), y_te, False
    except (FileNotFoundError, OSError):
        rng = np.random.default_rng(0)
        n_tr, n_te = 5000, 1000
        x_tr = rng.normal(size=(n_tr, 32, 32, 3)).astype(np.float32)
        y_tr = rng.integers(0, 10, n_tr).astype(np.int32)
        x_te = rng.normal(size=(n_te, 32, 32, 3)).astype(np.float32)
        y_te = rng.integers(0, 10, n_te).astype(np.int32)
        # make labels learnable: tint each class's channel means
        for x, y in ((x_tr, y_tr), (x_te, y_te)):
            x[..., 0] += 0.3 * (y[:, None, None] % 3)
            x[..., 1] += 0.3 * (y[:, None, None] // 3)
        return x_tr, y_tr, x_te, y_te, True


def augment(x, ox, oy, flip):
    """Crop 32x32 at row offsets ``ox`` and column offsets ``oy`` (0..8) out
    of the reflect-padded (pad 4) NHWC batch, then mirror the columns where
    ``flip``: the JAX trainer's augment_device with its offsets given."""
    import torch
    import torch.nn.functional as F

    n = x.shape[0]
    pad = F.pad(x.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="reflect")
    pad = pad.permute(0, 2, 3, 1)
    ar = torch.arange(32, device=x.device)
    rows = ox[:, None] + ar
    cols = oy[:, None] + torch.where(flip[:, None], 31 - ar, ar)
    b = torch.arange(n, device=x.device)[:, None, None]
    return pad[b, rows[:, :, None], cols[:, None, :]]


def random_augment(x, generator):
    """Random crop (pad 4) + horizontal flip, drawn on x's device."""
    import torch

    n, dev = x.shape[0], x.device
    ox = torch.randint(0, 9, (n,), generator=generator, device=dev)
    oy = torch.randint(0, 9, (n,), generator=generator, device=dev)
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    return augment(x, ox, oy, flip)


def main(argv=None):
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import SqueezeNextODE
    from pnode_tpu_torch.utils import RunningAverageMeter, makedirs

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    pt.init([sys.argv[0]] + unknown)
    makedirs(args.train_dir)
    x_tr, y_tr, x_te, y_te, synthetic = load_cifar10(args.data_dir)
    if synthetic:
        print("CIFAR-10 files not found; using the synthetic surrogate")
    print(f"train {x_tr.shape}, test {x_te.shape}")

    model = SqueezeNextODE(
        num_classes=10, width_x=args.width_x, method=args.method, Nt=args.Nt,
        t1=args.t1, dtype=args.precision, use_kernels=args.use_kernels,
        generator=torch.Generator().manual_seed(args.seed)).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M | NFE per forward: "
          f"{model.nfe_per_forward}")

    iters_per_epoch = args.iters_per_epoch or max(
        1, len(x_tr) // args.batch_size)
    # optax.chain(add_decayed_weights(wd), sgd(piecewise lr, momentum)):
    # torch's SGD adds wd * p to the gradient before the momentum trace, and
    # the schedule steps once per iteration
    opt = torch.optim.SGD(model.parameters(), lr=args.lr,
                          momentum=args.momentum,
                          weight_decay=args.weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, [30 * iters_per_epoch, 60 * iters_per_epoch,
              80 * iters_per_epoch], gamma=0.1)

    x_tr_d = torch.as_tensor(x_tr, device=device)
    y_tr_d = torch.as_tensor(y_tr, device=device).long()
    x_te_d = torch.as_tensor(x_te, device=device)
    y_te_d = torch.as_tensor(y_te, device=device).long()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    loss_meter = RunningAverageMeter(0.97)
    te_accs = []
    for epoch in range(args.epochs):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        # enough shuffled indices for iters_per_epoch even when the data
        # set is smaller than iters * batch (the surrogate is 5k images)
        need = iters_per_epoch * args.batch_size
        perm = np.concatenate([rng.permutation(len(x_tr))
                               for _ in range(-(-need // len(x_tr)))])[:need]
        losses, accs = [], []
        for it in range(iters_per_epoch):
            idx = torch.as_tensor(
                perm[it * args.batch_size:(it + 1) * args.batch_size],
                device=device)
            x, y = x_tr_d[idx], y_tr_d[idx]
            if not synthetic:
                x = random_augment(x, gen)
            logits = model(x, training=True)
            loss = F.cross_entropy(logits, y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
            accs.append((logits.detach().argmax(-1) == y).float().mean())
        for lv in torch.stack(losses).cpu().numpy():
            loss_meter.update(float(lv))
        train_acc = float(torch.stack(accs).mean())
        if cuda:
            torch.cuda.synchronize(device)
        epoch_time = time.time() - t0

        with torch.no_grad():
            te_accs = [
                float((model(x_te_d[i:i + args.batch_size], training=False)
                       .argmax(-1) == y_te_d[i:i + args.batch_size])
                      .float().mean())
                for i in range(0, len(x_te) - args.batch_size + 1,
                               args.batch_size)]
        # the reference's torch.cuda.max_memory_allocated record
        if cuda:
            mem_gb, mem_src = torch.cuda.max_memory_allocated(device) / 1e9, \
                "peak"
        else:
            mem_gb, mem_src = 0.0, "none"
        print(f"Epoch {epoch:03d} | {epoch_time:.1f}s | "
              f"Loss {loss_meter.avg:.4f} | Train acc {train_acc:.4f} | "
              f"Test acc {np.mean(te_accs) if te_accs else 0.0:.4f} | "
              f"Mem {mem_gb:.2f}GB ({mem_src})")
        with open(os.path.join(args.train_dir, "memstat.txt"), "a") as f:
            f.write(f"{args.Nt} {mem_gb:.3f} {epoch_time:.2f} {args.method} "
                    f"{mem_src} {args.precision}\n")
    return float(np.mean(te_accs)) if te_accs else 0.0


if __name__ == "__main__":
    acc = main()
    print(f"final test accuracy {acc:.4f}")
