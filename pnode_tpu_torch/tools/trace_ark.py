"""Where K3's, K4's, K12's and K2's time goes: block 0's phases of one
launch.

Run on a machine with the card, from the repository root::

    python -m pnode_tpu_torch.tools.trace_ark

It builds the kernels a second time with ``-DARK_TRACE`` (into its own
library beside the usual one), under which thread 0 of block 0 of a K3,
K4, K12 or K2 (grid form) launch logs ``clock64()`` and a tag at each
phase boundary. In
the row form (``ark::reverse_step``, csrc/ark_tiles.cuh): the staging,
each stage's covectors, its stiff product, each wait for a weight chunk,
each MLP recompute and backprop product, the dW/db flush, the implicit
line and, for K12, after its forward step and its seed. In the grid form
(csrc/ark_grid.cuh): each phase's start by kind (recompute, forward,
backprop, stiff, dW/db), each of block 0's tiles' start, the end of its
FMA loop and of its epilogue, and block 0's arrival at the grid barrier.
At the KS main path (B 256, 64 -> 104 x4 -> 64, ARK3, dt 0.2;
``compare_kernels``' inputs) it runs K3 at the plan's rows per block and
at R 1, 4 and 8, and K12 at B_local 256; at Burgers-512 (bench.py's
recipe: B 200, 512 -> 576 x4 -> 512, ARK3, dt 1e-3, chip_smoke.py's
operators) K3, K4 (2 iterations), K12 (B 200 and the two-rank shard B
100) and K2 in the grid form, and K3 in the row form at R 1 (its first
stages: the marks log holds 2048); each after a
warm-up call. It prints the time between consecutive marks summed by the
pair of marks that bound it, largest first, and for the grid form block
0's time per phase kind split into FMA loops, epilogues, the per-block
work before the tiles and the wait at the barrier. Cycles become
microseconds at the rate of the launch's own globaltimer. The last line
printed is a JSON object of the readings.
"""

from __future__ import annotations

import ctypes
import json

TAGS = ("start", "staged", "covectors", "u J", "acquire", "chunk in",
        "recompute", "backprop", "pv", "dW/db", "xi", "forward step",
        "seed", "end", "issued", "tile", "grid recompute", "grid forward",
        "grid backprop", "grid stiff", "grid dW/db", "grid barrier",
        "grid tile", "grid epilogue", "grid tile done")
# csrc/ark_tiles.cuh MarkTag
GRID_KINDS = ("grid recompute", "grid forward", "grid backprop",
              "grid stiff", "grid dW/db")
N_MARKS = 2048  # kMarks
# (mark before, mark after) -> what the time between them is
SPANS = {
    ("start", "staged"): "staging: lam, inv and J, the first chunk",
    ("start", "forward step"): "forward step (K2's body)",
    ("forward step", "seed"): "squared error and seed",
    ("seed", "staged"): "staging: the first chunk",
    ("staged", "covectors"): "covectors and Y_i",
    ("xi", "covectors"): "covectors and Y_i",
    ("covectors", "u J"): "stiff product u J",
    ("acquire", "chunk in"): "wait for a weight chunk",
    ("chunk in", "issued"): "issue of the next chunk's copies",
    ("chunk in", "tile"): "a product's FMAs (no copy issued)",
    ("issued", "tile"): "a product's FMAs",
    ("tile", "acquire"): "between a chunk's FMAs and the next acquire",
    ("tile", "recompute"): "recompute epilogue (split-k sum, bias, act)",
    ("tile", "backprop"): "backprop epilogue (split-k sum, act')",
    ("recompute", "acquire"): "between products",
    ("backprop", "acquire"): "between products",
    ("covectors", "acquire"): "between products",
    ("u J", "acquire"): "between products",
    ("backprop", "pv"): "pv += dyE",
    ("pv", "dW/db"): "dW/db formed and written",
    ("dW/db", "xi"): "implicit line (q inv - c)",
    ("backprop", "xi"): "pv += dyE and the implicit line",
    ("u J", "xi"): "the implicit line",
    ("covectors", "xi"): "the implicit line",
    ("xi", "end"): "lam_prev out",
    ("dW/db", "end"): "lam_prev out",
}


def read_marks(fn):
    """[(tag, cycles)] of the last launch, and the cycles per ns."""
    from ..ops import _build

    t = (ctypes.c_longlong * N_MARKS)()
    tags = (ctypes.c_int * N_MARKS)()
    n = (ctypes.c_int * 1)()
    ns = (ctypes.c_ulonglong * 2)()
    _build.check(fn(t, tags, n, ns), "phase marks")
    marks = [(TAGS[tags[i]], t[i]) for i in range(min(n[0], N_MARKS))]
    rate = (marks[-1][1] - marks[0][1]) / max(1, ns[1] - ns[0])
    return marks, rate


def phases(marks, rate):
    """{span: [us, count]} of consecutive marks, and the launch's us."""
    out = {}
    for (a, ta), (b, tb) in zip(marks, marks[1:]):
        name = SPANS.get((a, b), f"{a} -> {b}")
        row = out.setdefault(name, [0.0, 0])
        row[0] += (tb - ta) / rate / 1e3
        row[1] += 1
    return out, (marks[-1][1] - marks[0][1]) / rate / 1e3


def grid_breakdown(marks, rate):
    """Block 0's us per grid phase kind: "pre" (the phase's start to its
    first tile, or to the barrier), "fma" (a tile's start to the end of
    its FMA loop), "epilogue", "barrier" (arrival at the grid barrier to
    the next phase's start, or to the launch's end), with the phase and
    tile counts."""
    out = {}
    kind = None
    for (a, ta), (b, tb) in zip(marks, marks[1:]):
        if a in GRID_KINDS:
            kind = a
            out.setdefault(kind, dict(pre=0.0, fma=0.0, epilogue=0.0,
                                      barrier=0.0, phases=0, tiles=0))
            out[kind]["phases"] += 1
        if kind is None:
            continue
        us = (tb - ta) / rate / 1e3
        row = out[kind]
        if a in GRID_KINDS:
            row["pre"] += us
        elif (a, b) == ("grid tile", "grid epilogue"):
            row["fma"] += us
            row["tiles"] += 1
        elif (a, b) == ("grid epilogue", "grid tile done"):
            row["epilogue"] += us
        elif a == "grid barrier":
            row["barrier"] += us
    return out


def timeline(marks, rate, n=60):
    """The first ``n`` spans of the launch in order: (before, after, us)."""
    return [(a, b, (tb - ta) / rate / 1e3)
            for (a, ta), (b, tb) in list(zip(marks, marks[1:]))[:n]]


def main(argv=None):
    import torch

    from ..ops import _build
    from ..ops import fused_ark_adjoint as adj
    from ..ops import fused_train_loop as ftl
    from ..ops.fused_ark_forward import fused_ark_step_fwd_plain
    from .compare_kernels import ks_case

    if not torch.cuda.is_available():
        raise SystemExit("trace_ark needs a CUDA card")
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DARK_TRACE",)
    lib = _build.library()
    for name in ("pnode_ark_adj_marks", "pnode_grad_step_marks",
                 "pnode_train_loop_marks", "pnode_ark_fwd_marks"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4
    tab, dt, J, inv, Ws, bs, y, tgt, lam = ks_case(256, 0)
    Ys = fused_ark_step_fwd_plain(tab, dt, y, J, inv, Ws, bs)[1]
    layout = ftl.LoopLayout(256, 64, [int(w.shape[1]) for w in Ws])
    params = layout.pack(Ws, bs)
    runs = [(f"K3 KS B256 R {r or 'plan'}",
             lambda r=r: adj.fused_ark_step_adj(tab, dt, Ys, lam, J, inv, Ws,
                                                bs, rows=r),
             lib.pnode_ark_adj_marks) for r in (0, 1, 4, 8)]
    runs.append(("K12 KS B_local 256 R plan",
                 lambda: ftl.fused_grad_step(layout, tab, dt, y, tgt, J, inv,
                                             params),
                 lib.pnode_grad_step_marks))
    runs += burgers_runs(lib)
    result = {}
    for label, fn, read in runs:
        fn()
        fn()
        torch.cuda.synchronize()
        marks, rate = read_marks(read)
        ph, total = phases(marks, rate)
        result[label] = dict(launch_us=total, phases=ph)
        print(f"[trace] {label}: block 0 {total:.1f} us from start to end")
        for name, (us, k) in sorted(ph.items(), key=lambda kv: -kv[1][0]):
            print(f"[trace]   {name:44s} {us:8.1f} us over {k} spans")
        if label.endswith("R plan"):  # the first stage in order
            for a, b, us in timeline(marks, rate):
                print(f"[trace]     {a:>12s} -> {b:12s} {us:7.2f} us")
        if "grid" in label:
            grid = grid_breakdown(marks, rate)
            result[label]["grid"] = grid
            for kind, row in grid.items():
                print(f"[trace]   {kind:15s} {row['phases']:3d} phases, "
                      f"{row['tiles']:4d} tiles: FMA loops "
                      f"{row['fma']:8.1f} us, epilogues "
                      f"{row['epilogue']:8.1f}, before the tiles "
                      f"{row['pre']:7.1f}, at the barrier "
                      f"{row['barrier']:8.1f}")
    print(json.dumps(result))
    return result


def burgers_runs(lib):
    """K3, K4 (2 iterations), K12 (B 200 and 100) and K2 in the grid form,
    and K3 in the row form at R 1, at bench.py's Burgers-512 recipe, on
    chip_smoke.py's operators and minibatches."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ..ops import fused_ark_adjoint as adj
    from ..ops import fused_train_loop as ftl
    from ..ops.fused_ark_forward import (fused_ark_step_fwd,
                                         fused_ark_step_fwd_plain)

    dev = torch.device("cuda", 0)
    J, inv, tab, Ws, bs = cs.burgers_operators(dev)
    dt = float(np.float32(cs.BDT))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    pairs = cs.burgers_batches(3, seed=5)
    ys, tgts = (f32(np.stack([p[i] for p in pairs[:2]])) for i in (0, 1))
    y = f32(pairs[2][0])
    lam = f32(np.random.default_rng(6).normal(size=tuple(y.shape)))
    Ys = fused_ark_step_fwd_plain(tab, dt, y, J, inv, Ws, bs, "relu",
                                  1.0)[1]
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    tgt = f32(pairs[2][1])
    grad_runs = []
    for B in (200, 100):
        layout = ftl.LoopLayout(B, 512, [int(w.shape[1]) for w in Ws])
        grad_runs.append((
            f"K12 Burgers-512 B{B} grid",
            lambda B=B, lo=layout: ftl.fused_grad_step(
                lo, tab, dt, y[:B], tgt[:B], J, inv, lo.pack(Ws, bs), "relu",
                1.0),
            lib.pnode_grad_step_marks))
    return grad_runs + [
        ("K2 Burgers-512 B200 grid",
         lambda: fused_ark_step_fwd(tab, dt, y, J, inv, Ws, bs, "relu", 1.0),
         lib.pnode_ark_fwd_marks),
        ("K3 Burgers-512 B200 grid",
         lambda: adj.fused_ark_step_adj(tab, dt, Ys, lam, J, inv, Ws, bs,
                                        "relu", 1.0),
         lib.pnode_ark_adj_marks),
        # the row form the plan took before the grid form; its marks fill
        # the log within the first stages
        ("K3 Burgers-512 B200 row form R 1",
         lambda: adj.fused_ark_step_adj(tab, dt, Ys, lam, J, inv, Ws, bs,
                                        "relu", 1.0, rows=1),
         lib.pnode_ark_adj_marks),
        ("K4 Burgers-512 B200 grid, 2 iterations",
         lambda: ftl.fused_train_loop(tab, dt, ys, tgts, J, inv, Ws, bs, z, z,
                                      0, sign=1.0, lr=5e-3),
         lib.pnode_train_loop_marks)]


if __name__ == "__main__":
    main()
