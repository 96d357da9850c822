"""GRAND node classification on the PyTorch/CUDA port.

Twin of ``examples/grand_node.py`` (the reference's ``grand.py`` wired
for ``--block pnode``): encoder -> GRAND diffusion ODE -> decoder on a
node-classification task, full batch, AdamW in optax's form (decoupled
weight decay, eps 1e-8), early stopping on validation accuracy, the CSV
Recorder for sweeps, and the IMEX, hard-attention, rewiring, heavy-ball,
CGNN, kNN-rewiring and beltrami options of the JAX driver::

    python examples/grand_node_torch.py --function transformer --block imex
    python examples/grand_node_torch.py --device cpu --epochs 2

Planetoid and Geom-GCN files are read from ``--data_dir`` when they are
there; otherwise (and for ``--dataset synthetic``, the default) it trains
on the stochastic-block-model surrogate. The weights come from torch's
generator seeded by ``--seed`` on the CPU, and dropout draws from a
generator on ``--device`` seeded by ``--seed``. PETSc-style flags after the
script's own options go to the port's options database. ``--device cuda``
raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HETEROPHILIC = ("cornell", "texas", "wisconsin", "chameleon", "squirrel",
                "film", "actor")


def parse_args(argv=None):
    p = argparse.ArgumentParser("grand (PyTorch port)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--data_dir", type=str, default="./data/planetoid")
    p.add_argument("--function", type=str, default="laplacian",
                   choices=["laplacian", "transformer", "gat", "hbnode",
                            "cgnn"])
    p.add_argument("--cgnn_alpha", type=float, default=1.0,
                   help="cgnn: per-node alpha_train init")
    p.add_argument("--block", type=str, default="pnode",
                   choices=["pnode", "imex", "hard_att", "heavyball",
                            "rewire_att"])
    p.add_argument("--rw_addD", type=float, default=0.2,
                   help="block=rewire_att: keep ~(1+rw_addD)x the base "
                   "edge count from the candidate set each forward")
    p.add_argument("--rewire_candidates", type=str, default="two_hop",
                   choices=["two_hop", "random"],
                   help="block=rewire_att: static candidate edge pool")
    p.add_argument("--rewire_knn", type=int, default=0,
                   help="every N epochs, rebuild the graph as the "
                   "feature-kNN graph (0 = off)")
    p.add_argument("--knn_k", type=int, default=16,
                   help="kNN degree for --rewire_knn")
    p.add_argument("--knn_t", type=str, default="T0",
                   choices=["raw", "T0", "TN"],
                   help="features the kNN graph is built on: raw inputs, "
                   "encoder output, or post-diffusion state")
    p.add_argument("--att_samp_pct", type=float, default=1.0,
                   help="hard_att block: fraction of edges kept per "
                   "training solve")
    p.add_argument("--use_flux", action="store_true",
                   help="hard_att block: weight the sampling score by "
                   "||h_src - h_dst||")
    p.add_argument("--attention_norm_idx", type=int, default=0,
                   choices=[0, 1])
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--time", type=float, default=3.0)
    p.add_argument("--step_size", type=float, default=0.5)
    p.add_argument("--method", type=str, default="dopri5")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--decay", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--input_dropout", type=float, default=0.5)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--early_stop_int", action="store_true",
                   help="evaluate at intermediate integration times and "
                   "report the best")
    p.add_argument("--rewiring", type=str, default="none",
                   choices=["none", "two_hop", "gdc"],
                   help="graph rewiring")
    p.add_argument("--gdc_alpha", type=float, default=0.05)
    p.add_argument("--gdc_k", type=int, default=64)
    p.add_argument("--beltrami", action="store_true",
                   help="positional-encoding (beltrami) mode")
    p.add_argument("--pos_enc_dim", type=int, default=16)
    p.add_argument("--pos_enc_hidden", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", type=int, default=0,
                   help="heterophilic datasets: which of the 10 public "
                   "Geom-GCN splits to use")
    p.add_argument("--train_dir", type=str,
                   default="./train_results_grand")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def load_data(args):
    """The dataset of ``--dataset``: its files, else the SBM surrogate."""
    from pnode_tpu_torch.models.grand import (
        load_heterophilic, load_planetoid, synthetic_sbm)

    if args.dataset == "synthetic":
        return synthetic_sbm(seed=args.seed)
    try:
        if args.dataset in HETEROPHILIC:
            data = load_heterophilic(args.data_dir, args.dataset,
                                     split=args.split)
            print(f"loaded heterophilic {args.dataset!r}: "
                  f"{data['x'].shape[0]} nodes")
        else:
            data = load_planetoid(args.data_dir, args.dataset)
            print(f"loaded planetoid {args.dataset!r}: "
                  f"{data['x'].shape[0]} nodes")
    except (FileNotFoundError, OSError):
        print(f"dataset {args.dataset!r} files not found in "
              f"{args.data_dir}; using the SBM surrogate")
        data = synthetic_sbm(seed=args.seed)
    return data


def build_graph(args, data):
    """(graph, positional encodings or None) of the flags' rewiring,
    normalization and beltrami mode."""
    from pnode_tpu_torch.models.grand import (
        Graph, gcn_norm_adj, gdc_rewiring, get_rw_adj,
        laplacian_positional_encoding, two_hop)

    n = len(data["y"])
    edge_index = data["edge_index"]
    if args.rewiring == "two_hop":
        edge_index = two_hop(edge_index, n)
        print(f"two-hop rewiring: {data['edge_index'].shape[1]} -> "
              f"{edge_index.shape[1]} edges")
    if args.rewiring == "gdc":
        edge_index, ew = gdc_rewiring(edge_index, n, alpha=args.gdc_alpha,
                                      k=args.gdc_k)
        print(f"gdc rewiring: {data['edge_index'].shape[1]} -> "
              f"{edge_index.shape[1]} edges")
        graph = Graph(torch.as_tensor(edge_index, dtype=torch.int64),
                      torch.as_tensor(ew, dtype=torch.float64), n)
    elif args.function == "cgnn":
        # the CGNN baseline diffuses on the sym-normalized adjacency
        graph = gcn_norm_adj(edge_index, n, self_loop_weight=1.0)
    else:
        graph = get_rw_adj(edge_index, n, self_loop_weight=1.0)
    pos_enc = None
    if args.beltrami:
        pos_enc = laplacian_positional_encoding(data["edge_index"], n,
                                                args.pos_enc_dim)
    return graph, pos_enc


def build_model(args, graph, in_dim, n_classes, device, dtype):
    """The GRANDModel of the flags, weights from torch's generator seeded
    by ``--seed`` on the CPU."""
    from pnode_tpu_torch.models.grand import GRANDModel

    torch.manual_seed(args.seed)
    return GRANDModel(
        graph, in_dim, args.hidden_dim, n_classes,
        function=args.function, block=args.block, T=args.time,
        step_size=args.step_size, method=args.method, heads=args.heads,
        input_dropout=args.input_dropout, dropout=args.dropout,
        pos_dim=args.pos_enc_dim if args.beltrami else 0,
        pos_hidden=args.pos_enc_hidden,
        att_samp_pct=args.att_samp_pct, use_flux=args.use_flux,
        attention_norm_idx=args.attention_norm_idx,
        cgnn_alpha=args.cgnn_alpha,
        rw_addD=args.rw_addD, rewire_candidates=args.rewire_candidates,
        rewire_seed=args.seed, device=device, dtype=dtype)


def make_optimizer(model, args):
    """``optax.adamw(lr, weight_decay=decay)``: torch's AdamW decays the
    weights by lr * decay before the Adam step, which is optax's update
    p - lr (adam + decay p) to rounding, with the same eps 1e-8."""
    return torch.optim.AdamW(model.parameters(), lr=args.lr,
                             weight_decay=args.decay, eps=1e-8)


def masked_ce(logits, y, mask):
    """Cross-entropy summed over the mask's nodes over their count."""
    ce = torch.nn.functional.cross_entropy(logits, y, reduction="none")
    return torch.sum(ce * mask) / torch.sum(mask)


def train_step(model, opt, x, y, train_mask, generator=None, pos_enc=None):
    """One full-batch AdamW step on the discrete adjoint's gradient;
    returns the loss (on the device)."""
    loss = masked_ce(model(x, training=True, generator=generator,
                           pos_encoding=pos_enc), y, train_mask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    # optax updates every parameter, zero gradients included: the frozen
    # attention of the hard_att / rewire_att blocks still decays
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return loss.detach()


def accuracy(model, x, y, masks, pos_enc=None):
    """{mask name: accuracy} of the evaluation-mode logits."""
    with torch.no_grad():
        pred = model(x, training=False, pos_encoding=pos_enc).argmax(-1)
        hit = (pred == y).to(x.dtype)
        return {k: float(torch.sum(hit * m) / torch.sum(m))
                for k, m in masks.items()}


def accuracy_multi(model, x, y, masks, eval_times, pos_enc=None):
    """(val acc, test acc, time) at the interior time with the best
    validation accuracy (the early-stop evaluation)."""
    with torch.no_grad():
        pred = model.apply_multi(x, eval_times, pos_encoding=pos_enc).argmax(
            -1)
        hit = (pred == y).to(x.dtype)
        val = torch.sum(hit * masks["val_mask"], -1) / torch.sum(
            masks["val_mask"])
        test = torch.sum(hit * masks["test_mask"], -1) / torch.sum(
            masks["test_mask"])
        i = int(torch.argmax(val))
        return float(val[i]), float(test[i]), float(eval_times[i])


def knn_features(args, model, data, x, pos_enc=None):
    """The features the kNN graph is built on (``--knn_t``)."""
    if args.knn_t == "raw":
        return data["x"]
    with torch.no_grad():
        if args.knn_t == "T0":
            return model.forward_encoder(x, pos_encoding=pos_enc)
        return model.forward_ode(x, pos_encoding=pos_enc)


def to_device(data, pos_enc, device, dtype):
    """(x, y, masks, pos_enc) as tensors on ``device``."""
    x = torch.as_tensor(data["x"], dtype=dtype, device=device)
    y = torch.as_tensor(data["y"], dtype=torch.int64, device=device)
    masks = {k: torch.as_tensor(data[k], dtype=dtype, device=device)
             for k in ("train_mask", "val_mask", "test_mask")}
    if pos_enc is not None:
        pos_enc = torch.as_tensor(pos_enc, dtype=dtype, device=device)
    return x, y, masks, pos_enc


def main(argv=None):
    """Train; returns {"losses", "best_val", "best_test", "epochs",
    "seconds"}."""
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models.grand import get_rw_adj, knn_graph
    from pnode_tpu_torch.utils import Recorder, makedirs

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    pt.init([sys.argv[0]] + unknown)
    device, dtype = torch.device(args.device), torch.float32
    data = load_data(args)
    graph, pos_np = build_graph(args, data)
    n = len(data["y"])
    n_classes = int(data["y"].max()) + 1
    print(f"graph: {n} nodes, {graph.edge_index.shape[1]} edges, "
          f"{n_classes} classes")
    model = build_model(args, graph, data["x"].shape[1], n_classes, device,
                        dtype)
    if args.block == "rewire_att":
        print(f"rewire_att: {model.diffusion_graph.edge_index.shape[1]} "
              f"candidate edges ({args.rewire_candidates}), top-"
              f"{model.rewire_K} kept per forward")
    x, y, masks, pos_enc = to_device(data, pos_np, device, dtype)
    opt = make_optimizer(model, args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    eval_times = np.linspace(0.0, args.time, 5)[1:]

    rec = Recorder()
    out = {"losses": [], "best_val": 0.0, "best_test": 0.0, "epochs": 0,
           "seconds": 0.0}
    best_val, best_test, patience = 0.0, 0.0, 0
    t_start = time.time()
    for epoch in range(args.epochs):
        t0 = time.time()
        if args.rewire_knn and epoch % args.rewire_knn == 0 and epoch != 0:
            ei = knn_graph(knn_features(args, model, data, x, pos_enc),
                           args.knn_k)
            model.rewire(get_rw_adj(ei, n, self_loop_weight=1.0))
            print(f"Epoch {epoch:03d} | kNN rewiring ({args.knn_t}, "
                  f"k={args.knn_k}): {ei.shape[1]} edges")
        loss = float(train_step(model, opt, x, y, masks["train_mask"], gen,
                                pos_enc))
        out["losses"].append(loss)
        if args.early_stop_int:
            va, ta, _ = accuracy_multi(model, x, y, masks, eval_times,
                                       pos_enc)
            accs = {"train_mask": float("nan"), "val_mask": va,
                    "test_mask": ta}
        else:
            accs = accuracy(model, x, y, masks, pos_enc)
        out["epochs"] = epoch + 1
        if accs["val_mask"] > best_val:
            best_val, best_test, patience = (accs["val_mask"],
                                             accs["test_mask"], 0)
        else:
            patience += 1
        if epoch % 10 == 0:
            print(f"Epoch {epoch:03d} | {time.time() - t0:.2f}s | "
                  f"Loss {loss:.4f} | train {accs['train_mask']:.3f} | "
                  f"val {accs['val_mask']:.3f} | test "
                  f"{accs['test_mask']:.3f}")
        if patience > args.patience:
            print("early stopping")
            break
    out["seconds"] = time.time() - t_start
    out["best_val"], out["best_test"] = best_val, best_test
    rec.record(dataset=args.dataset, function=args.function,
               block=args.block, hidden=args.hidden_dim, T=args.time,
               best_val=best_val, best_test=best_test)
    makedirs(args.train_dir)
    rec.save(os.path.join(args.train_dir, "results.csv"))
    print(f"best val {best_val:.4f} | test at best val {best_test:.4f}")
    return out


if __name__ == "__main__":
    main()
