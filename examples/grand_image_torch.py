"""GRAND image classification on the PyTorch/CUDA port: pixel-grid graph
diffusion.

Twin of ``examples/grand_image.py`` (the reference's ``GNN_image.py`` and
``run_image.py``): raw pixel intensities diffuse on the 4- or 8-neighbor
grid graph, then one Linear over the flattened diffused image decodes the
class logits; Adam, the per-epoch training loss and test accuracy. It
trains on MNIST when the raw IDX files are in ``--data_dir``
(train-images-idx3-ubyte etc., optionally .gz), else on the JAX driver's
quadrant-blob surrogate (the same numpy draws)::

    python examples/grand_image_torch.py --epochs 5 --batch_size 256
    python examples/grand_image_torch.py --device cpu --epochs 1 \\
        --train_size 512

The weights come from torch's generator seeded by ``--seed`` on the CPU,
dropout (off by default) from a generator on ``--device`` seeded by
``--seed + 7``. ``--device cuda`` raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser("grand-image (PyTorch port)")
    p.add_argument("--data_dir", type=str, default="./data/mnist")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--train_size", type=int, default=8192,
                   help="cap on training images (the reference trains "
                   "image GNNs on subsets)")
    p.add_argument("--time", type=float, default=1.0)
    p.add_argument("--step_size", type=float, default=0.25)
    p.add_argument("--method", type=str, default="rk4")
    p.add_argument("--diags", action="store_true",
                   help="8-neighbor grid (reference --diags)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--input_dropout", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def _read_idx(path):
    """IDX format: \\x00\\x00 <dtype> <ndim>, then ndim big-endian uint32
    dims, then the uint8 payload."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        raw = f.read()
    ndim = raw[3]
    dims = [int.from_bytes(raw[4 + 4 * i: 8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(raw, np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


def load_mnist(data_dir):
    def find(stem):
        for suf in ("", ".gz"):
            p = os.path.join(data_dir, stem + suf)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(stem)

    xtr = _read_idx(find("train-images-idx3-ubyte")).astype(np.float32)
    ytr = _read_idx(find("train-labels-idx1-ubyte")).astype(np.int32)
    xte = _read_idx(find("t10k-images-idx3-ubyte")).astype(np.float32)
    yte = _read_idx(find("t10k-labels-idx1-ubyte")).astype(np.int32)
    return (xtr[..., None] / 255.0, ytr, xte[..., None] / 255.0, yte,
            False)


def synthetic(n, H, W, n_cls, seed):
    """Quadrant blobs: class c lights quadrant c, plus N(0, 0.2) noise."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_cls, size=n)
    xs = np.zeros((n, H, W, 1), np.float32)
    qh, qw = H // 2, W // 2
    for i, c in enumerate(ys):
        oy, ox = (c // 2) * qh, (c % 2) * qw
        xs[i, oy + 2: oy + qh - 2, ox + 2: ox + qw - 2, 0] = 1.0
    xs += rng.normal(scale=0.2, size=xs.shape).astype(np.float32)
    return xs, ys.astype(np.int32)


def load_data(args):
    """(x_tr, y_tr, x_te, y_te, n_classes, synthetic): MNIST's files, else
    the 16 x 16 surrogate; the training set capped at --train_size."""
    try:
        x_tr, y_tr, x_te, y_te, syn = load_mnist(args.data_dir)
        n_cls = 10
    except FileNotFoundError:
        print("MNIST files not found; using the quadrant-blob surrogate")
        n_cls = 4
        x_tr, y_tr = synthetic(4096, 16, 16, n_cls, args.seed)
        x_te, y_te = synthetic(1024, 16, 16, n_cls, args.seed + 1)
        syn = True
    return (x_tr[: args.train_size], y_tr[: args.train_size], x_te, y_te,
            n_cls, syn)


def build_model(args, H, W, n_cls, device, dtype):
    """The GRANDImage of the flags, weights from torch's generator seeded
    by ``--seed`` on the CPU."""
    from pnode_tpu_torch.models.grand_image import GRANDImage

    torch.manual_seed(args.seed)
    return GRANDImage(H, W, n_cls, T=args.time, step_size=args.step_size,
                      method=args.method, diags=args.diags,
                      input_dropout=args.input_dropout,
                      dropout=args.dropout, device=device, dtype=dtype)


def train_step(model, opt, x, y, generator=None):
    """One Adam step on the discrete adjoint's gradient of the mean CE;
    returns the loss (on the device)."""
    loss = torch.nn.functional.cross_entropy(
        model(x, training=True, generator=generator), y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def eval_acc(model, x, y):
    with torch.no_grad():
        return float(torch.mean(
            (model(x, training=False).argmax(-1) == y).float()))


def main(argv=None):
    """Train; returns {"losses" (per epoch), "test_acc" (per epoch),
    "seconds", "iters", "images_per_s"}."""
    args, _ = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    sys.path.insert(0, ROOT)
    device, dtype = torch.device(args.device), torch.float32
    x_tr, y_tr, x_te, y_te, n_cls, syn = load_data(args)
    H, W = x_tr.shape[1], x_tr.shape[2]
    print(f"train {x_tr.shape} test {x_te.shape} "
          f"({'synthetic' if syn else 'MNIST'})")
    model = build_model(args, H, W, n_cls, device, dtype)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)

    def dev(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    B = args.batch_size
    n = (len(x_tr) // B) * B
    out = {"losses": [], "test_acc": [], "seconds": 0.0, "iters": 0}
    for epoch in range(args.epochs):
        t0 = time.time()
        perm = np.random.default_rng(epoch).permutation(len(x_tr))[:n]
        losses = []
        for i in range(0, n, B):
            idx = perm[i: i + B]
            losses.append(train_step(model, opt, dev(x_tr[idx], dtype),
                                     dev(y_tr[idx], torch.int64), gen))
        tot = float(torch.stack(losses).sum())
        accs = [eval_acc(model, dev(x_te[i: i + B], dtype),
                         dev(y_te[i: i + B], torch.int64))
                for i in range(0, min(len(x_te), 4 * B), B)]
        secs = time.time() - t0
        out["seconds"] += secs
        out["iters"] += n // B
        out["losses"].append(tot / (n // B))
        out["test_acc"].append(float(np.mean(accs)))
        print(f"epoch {epoch:03d} | loss {tot / (n // B):.4f} | "
              f"test acc {np.mean(accs):.4f} | {secs:.1f}s")
    out["images_per_s"] = out["iters"] * B / max(out["seconds"], 1e-12)
    return out


if __name__ == "__main__":
    main()
