"""GRAND hyperparameter sweep on the PyTorch/CUDA port.

Twin of ``examples/grand_sweep.py`` (the offline form of the reference's
ray-tune search): one ``examples/grand_node_torch.py`` process per trial
on ``--device``, every trial appended to the same Recorder CSV.

- ``--scheduler random``: plain random search, every trial at the full
  epoch budget;
- ``--scheduler asha`` (default): successive halving with reduction
  factor ``--eta``: every sampled configuration runs at the first rung
  (``--min_epochs``), the top 1/eta by validation accuracy go on to an
  eta-times larger budget, up to ``--epochs``.

::

    python examples/grand_sweep_torch.py --trials 8 --epochs 40
    python examples/grand_sweep_torch.py --device cpu --scheduler random \\
        --trials 1 --epochs 2

Flags the sweep does not know go to every trial.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = {
    "function": ["laplacian", "transformer"],
    "time": [1.0, 2.0, 3.0],
    "hidden_dim": [32, 64],
    "lr": [0.01, 0.005],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser("grand-sweep (PyTorch port)")
    p.add_argument("--trials", type=int, default=6)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--scheduler", type=str, default="asha",
                   choices=["random", "asha"])
    p.add_argument("--eta", type=int, default=2,
                   help="ASHA reduction factor (promote top 1/eta per rung)")
    p.add_argument("--min_epochs", type=int, default=0,
                   help="first-rung budget (default: epochs // eta^rungs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str,
                   default="./train_results_grand")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def sample_config(rng):
    return {k: v[rng.integers(0, len(v))] for k, v in SPACE.items()}


def run_trial(args, unknown, cfg, epochs, tag):
    """One grand_node_torch.py process: (best val, its last line)."""
    cmd = [
        sys.executable, os.path.join(ROOT, "examples", "grand_node_torch.py"),
        "--function", str(cfg["function"]),
        "--time", str(cfg["time"]),
        "--hidden_dim", str(cfg["hidden_dim"]),
        "--lr", str(cfg["lr"]),
        "--epochs", str(epochs),
        "--train_dir", args.train_dir,
        "--device", args.device,
    ] + unknown
    t0 = time.time()
    out = subprocess.run(cmd, capture_output=True, text=True)
    best_val, line = -1.0, None
    for ln in out.stdout.splitlines():
        if ln.startswith("best val"):
            line = ln
            try:
                best_val = float(ln.split("|")[0].split()[-1])
            except ValueError:
                pass
    if line is None and out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
    print(f"{tag}: {cfg} @ {epochs}ep -> {line} ({time.time()-t0:.1f}s)")
    return best_val, line


def main(argv=None):
    """Run the sweep; returns {"trials": [(config, epochs, best val)],
    "best": (val, config) or None for --scheduler random}."""
    args, unknown = parse_args(argv)
    if args.trials < 1:
        raise SystemExit("--trials must be >= 1")
    rng = np.random.default_rng(args.seed)
    res = {"trials": [], "best": None}

    def trial(cfg, epochs, tag):
        val, _ = run_trial(args, unknown, cfg, epochs, tag)
        res["trials"].append((cfg, epochs, val))
        return val

    if args.scheduler == "random":
        for t in range(args.trials):
            trial(sample_config(rng), args.epochs, f"trial {t}")
        print(f"\nsweep CSV: {os.path.join(args.train_dir, 'results.csv')}")
        return res

    # -- ASHA / successive halving -------------------------------------------
    eta = max(2, args.eta)
    n_rungs = max(1, int(math.floor(math.log(args.trials, eta))) + 1)
    min_ep = args.min_epochs or max(1, args.epochs // eta ** (n_rungs - 1))
    rungs = [min(args.epochs, min_ep * eta ** k) for k in range(n_rungs)]
    rungs = sorted(set(rungs))  # saturated rungs (a tiny --epochs) merge
    print(f"ASHA rungs (epochs): {rungs}, eta={eta}")

    population = [sample_config(rng) for _ in range(args.trials)]
    for k, budget in enumerate(rungs):
        scored = [(trial(cfg, budget, f"rung {k} trial {i}"), i, cfg)
                  for i, cfg in enumerate(population)]
        if all(v < 0 for v, _, _ in scored):
            raise SystemExit(
                f"rung {k}: every trial failed to report a validation "
                "accuracy; aborting instead of promoting failed configs")
        if k == len(rungs) - 1:
            break
        scored.sort(key=lambda s: (s[0], s[1]), reverse=True)
        keep = max(1, math.ceil(len(scored) / eta))
        population = [cfg for _, _, cfg in scored[:keep]]
        print(f"rung {k}: promoted {keep}/{len(scored)} configs")
    best = max(scored, key=lambda s: (s[0], s[1]))
    res["best"] = (best[0], best[2])
    print(f"\nbest config: {best[2]} (val {best[0]:.4f})")
    print(f"sweep CSV: {os.path.join(args.train_dir, 'results.csv')}")
    return res


if __name__ == "__main__":
    main()
