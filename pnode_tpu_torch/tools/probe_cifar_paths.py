"""How far the CIFAR kernel path and module path stand from an fp64 truth
along their own SGD trajectories.

Run on a machine with the card, from the repository root::

    python -m pnode_tpu_torch.tools.probe_cifar_paths

SqNxt-23 ODE (width 1.0, rk4, Nt 2, seed-0 weights) at B 128 on the
synthetic CIFAR surrogate and chip_smoke.py phase 6(c)'s batches, on
cuDNN's deterministic algorithms, TF32 off. Three evaluators of one
step's loss and gradient: the kernel path (K6-K9) and the module path in
fp32, and the module path in fp64 with the model's fp32 pins lifted (the
truth), all on the card. Each of the three takes 3 SGD steps (lr 0.1,
momentum 0.9, wd 5e-4, phase 6(c)'s optimizer) on its own gradients; at
every point a trajectory visits, all three evaluators give the loss and
the gradient on that step's batch. The lines print, at each point, the
three losses and each fp32 evaluator's gradient cosine and norm ratio
against the truth's, whole and without the conv biases (their exact
gradient is 0: each conv feeds a norm on batch statistics), the worst
tensors, and how far the trajectories have parted. The last line printed
is a JSON object of the readings.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, WIDTH, LR, MOMENTUM, WD, STEPS = 128, 1.0, 0.1, 0.9, 5e-4, 3
DEVICE = "cuda"
BIAS = re.compile(r"convs\.\d+\.bias$")


@contextlib.contextmanager
def fp64_pins(on):
    """Lift the model's fp32 pins (norm statistics, logits, the plain
    versions' work dtype) while ``on``."""
    import torch

    from ..models import sqnxt as tsq
    from ..ops import fused_sqnxt as tfs

    old = tsq.FP32, tfs.WORK
    if on:
        tsq.FP32 = tfs.WORK = torch.float64
    try:
        yield
    finally:
        tsq.FP32, tfs.WORK = old


class Evaluator:
    """One model (kernel or module path, fp32 or fp64) that gives the loss
    and the gradient at any weights."""

    def __init__(self, name, mode, dtype, state):
        import torch

        from ..models import SqueezeNextODE

        self.name, self.dtype = name, dtype
        self.truth = dtype == torch.float64
        self.model = SqueezeNextODE(
            width_x=WIDTH, method="rk4", Nt=2, use_kernels=mode,
            generator=torch.Generator().manual_seed(0)).to(DEVICE, dtype)
        self.load(state)

    def load(self, weights):
        import torch

        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(weights[k])

    def weights(self):
        return {k: p.detach().double().clone()
                for k, p in self.model.named_parameters()}

    def loss_grad(self, x, y):
        import torch

        self.model.zero_grad(set_to_none=True)
        with fp64_pins(self.truth):
            logits = self.model(x.to(self.dtype), training=True)
            loss = torch.nn.functional.cross_entropy(logits, y)
            loss.backward()
        g = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().double()
             for k, p in self.model.named_parameters()}
        return float(loss.detach()), g


def flat(d):
    import torch

    return torch.cat([v.reshape(-1) for v in d.values()])


def cosine(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def live(d):
    """``d`` without the conv biases: every conv feeds a norm on batch
    statistics, which cancels its bias, so their exact gradient is 0 and
    what a path computes for them is rounding noise that moves no loss."""
    return {k: v for k, v in d.items() if not BIAS.search(k)}


def compare(g, ref):
    """Cosine and norm ratio against ``ref``, of the whole gradient and of
    its live part, and the three live tensors of lowest cosine."""
    per = sorted((cosine(g[k].reshape(-1), ref[k].reshape(-1)), k)
                 for k in live(ref))
    a, b = flat(g), flat(ref)
    la, lb = flat(live(g)), flat(live(ref))
    return {"cos": cosine(a, b), "ratio": float(a.norm() / b.norm()),
            "cos_live": cosine(la, lb),
            "ratio_live": float(la.norm() / lb.norm()),
            "worst": [(k, c) for c, k in per[:3]]}


def main():
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    spec = importlib.util.spec_from_file_location(
        "train_cifar10_torch",
        os.path.join(ROOT, "examples", "train_cifar10_torch.py"))
    cif = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cif)
    x_np, y_np, _, _, synthetic = cif.load_cifar10(
        os.path.join(ROOT, "data", "cifar-10-batches-py"))
    rng = np.random.default_rng(0)  # chip_smoke.py phase 6(c)'s batches
    idx = [rng.choice(len(x_np), B, replace=False)
           for _ in range(STEPS + 1)]
    batches = [(torch.as_tensor(x_np[i], device=DEVICE),
                torch.as_tensor(y_np[i], device=DEVICE).long()) for i in idx]

    from ..models import SqueezeNextODE

    state0 = {k: p.detach().double().clone() for k, p in SqueezeNextODE(
        width_x=WIDTH, method="rk4", Nt=2, use_kernels="off",
        generator=torch.Generator().manual_seed(0)).to(DEVICE).named_parameters()}
    evals = {"kernel": Evaluator("kernel", "on", torch.float32, state0),
             "module": Evaluator("module", "off", torch.float32, state0),
             "truth": Evaluator("truth", "off", torch.float64, state0)}
    print(f"{torch.cuda.get_device_name(0)}; data "
          f"{'synthetic surrogate' if synthetic else 'CIFAR-10'}; SqNxt-23 "
          f"ODE width {WIDTH}, rk4, Nt 2, B {B}; SGD lr {LR} momentum "
          f"{MOMENTUM} wd {WD}; {STEPS} steps a trajectory")

    # each evaluator's own trajectory: weights at every point it visits
    paths = {}
    for name, ev in evals.items():
        ev.load(state0)
        opt = torch.optim.SGD(ev.model.parameters(), lr=LR,
                              momentum=MOMENTUM, weight_decay=WD)
        pts, losses = [], []
        for t in range(STEPS + 1):
            pts.append(ev.weights())
            loss, _ = ev.loss_grad(*batches[t])
            losses.append(loss)
            if t < STEPS:
                opt.step()
        paths[name] = pts
        print(f"{name} trajectory: losses "
              + ", ".join(f"{v:.6f}" for v in losses))

    report = {"device": torch.cuda.get_device_name(0), "points": []}
    for name in ("kernel", "module", "truth"):
        for t, w in enumerate(paths[name]):
            row = {"path": name, "t": t, "loss": {}, "grad": {}}
            res = {}
            for ev_name, ev in evals.items():
                ev.load(w)
                res[ev_name] = ev.loss_grad(*batches[t])
                row["loss"][ev_name] = res[ev_name][0]
            ref = res["truth"][1]
            for ev_name in ("kernel", "module"):
                row["grad"][ev_name] = compare(res[ev_name][1], ref)
            row["grad"]["kernel_vs_module"] = compare(res["kernel"][1],
                                                      res["module"][1])
            moved = {o: float((flat(w) - flat(paths[o][t])).norm()
                              / max(float((flat(paths[o][t])
                                           - flat(state0)).norm()), 1e-30))
                     for o in paths if o != name and t > 0}
            row["apart"] = moved
            report["points"].append(row)
            print(f"{name} t={t}: loss kernel {row['loss']['kernel']:.6f} "
                  f"module {row['loss']['module']:.6f} truth "
                  f"{row['loss']['truth']:.6f}; against the truth's gradient: "
                  + "; ".join(
                      f"{e} cos {row['grad'][e]['cos']:.6f} ratio "
                      f"{row['grad'][e]['ratio']:.6f}, without the conv "
                      f"biases cos {row['grad'][e]['cos_live']:.8f} ratio "
                      f"{row['grad'][e]['ratio_live']:.6f}, worst "
                      + ", ".join(f"{k} {c:.4f}"
                                  for k, c in row['grad'][e]['worst'])
                      for e in ("kernel", "module"))
                  + f"; kernel against module cos "
                  f"{row['grad']['kernel_vs_module']['cos']:.6f} (without "
                  f"the conv biases "
                  f"{row['grad']['kernel_vs_module']['cos_live']:.8f})"
                  + ("" if not moved else "; |w - w_other| / |w_other - w0| "
                     + ", ".join(f"{o} {v:.4f}" for o, v in moved.items())))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
