"""Where K6's-K9's time goes: per-phase microseconds of a launch.

Run on a machine with the card, from the repository root::

    python -m pnode_tpu_torch.tools.trace_sqnxt [--dtype bf16]

It builds the kernels a second time with ``-DSQNXT_TRACE`` (into its own
library beside the usual one), under which thread 0 of block 0 of a K6-K9
launch stores ``clock64()`` at each phase boundary (csrc/sqnxt_tiles.cuh).
At the three ODE stage shapes of SqNxt-23 at B 128 (the inputs of
``compare_kernels``), it runs K6 and K7 at each stage and K8 and K9 on
each layer of stage 1 (K8 and K9 on the plain forward's layer inputs),
after a warm-up call, and prints block 0's view of each phase: a pass's
own tiles (and inside its first tile, the staging, the products and the
row sums), then the grid barrier with the partial sums after it (which
includes waiting for the slowest block), and K6's and K8's normalize-out
pass. Cycles become microseconds at the rate of the launch's own
globaltimer. ``--dtype bf16`` runs the bf16 instances on the same values
rounded to bf16 (x, g, the taps and b; gamma and beta stay fp32, as
``pack_params`` packs them). The last line printed is a JSON object of the
phases.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np

N_MARKS = 4 * 5 + 6 * 5 + 6 * 5 + 2  # csrc/sqnxt_tiles.cuh kMarks
SUB = 50                              # kMarkSub: inside a pass's first tile


def marks_us(read, nl, backward=True):
    """{phase: us} of the last launch (nl layers) whose marks ``read``
    (pnode_sqnxt_bwd_marks or pnode_sqnxt_fwd_marks) returns."""
    from ..ops import _build

    n = N_MARKS
    m = (ctypes.c_longlong * n)()
    ns = (ctypes.c_ulonglong * 2)()
    _build.check(read(m, ns), "phase marks")
    rate = (m[n - 1] - m[n - 2]) / max(1, ns[1] - ns[0])  # cycles per ns
    us = lambda a, b: (b - a) / rate / 1e3  # noqa: E731
    out = {"launch": us(m[n - 2], m[n - 1])}
    prev = m[n - 2]
    for l in range(nl):
        f = m[4 * l: 4 * l + 4]
        t = m[SUB + 3 * l: SUB + 3 * l + 3]
        out[f"fwd {l} tiles"] = us(prev, f[1])
        out[f"fwd {l}   1st tile: weights + staging"] = us(prev, t[0])
        out[f"fwd {l}   1st tile: product"] = us(t[0], t[1])
        out[f"fwd {l}   1st tile: row sums"] = us(t[1], t[2])
        out[f"fwd {l} barrier + stats"] = us(f[1], f[2])
        out[f"fwd {l} centered variance"] = us(f[2], f[3])
        prev = f[3]
    if not backward:
        out["normalize out"] = us(prev, m[20])
        return out
    for l in range(nl - 1, -1, -1):
        b = m[20 + 6 * l: 26 + 6 * l]
        t = m[SUB + 15 + 3 * l: SUB + 18 + 3 * l]
        out[f"bwd {l} pass A"] = us(prev, b[1])
        out[f"bwd {l} barrier + sums"] = us(b[1], b[2])
        out[f"bwd {l} pass B"] = us(b[2], b[3])
        out[f"bwd {l}   1st tile: staging, g_z"] = us(b[2], t[0])
        out[f"bwd {l}   1st tile: g_h"] = us(t[0], t[1])
        out[f"bwd {l}   1st tile: dW"] = us(t[1], t[2])
        out[f"bwd {l} barrier"] = us(b[3], b[4])
        out[f"bwd {l} dW sum"] = us(b[4], b[5])
        prev = b[5]
    return out


def to_dtype(x, g, flat, dtype):
    """x, g and the packed parameters in the kernels' storage type: the
    activations, taps and b in ``dtype``, gamma and beta fp32."""
    return (x.to(dtype), g.to(dtype),
            [t.to(dtype) if k % 4 < 2 else t for k, t in enumerate(flat)])


def main(argv=None):
    import torch

    from ..ops import _build
    from ..ops import fused_sqnxt as fs
    from .compare_kernels import SQNXT_STAGES, sqnxt_inputs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("trace_sqnxt needs a CUDA card")
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DSQNXT_TRACE",)
    lib = _build.library()
    for name in ("pnode_sqnxt_bwd_marks", "pnode_sqnxt_fwd_marks"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    result = {}
    for label, dim, H in SQNXT_STAGES:
        x, g, flat, meta = sqnxt_inputs(dim, H, rng)
        x, g, flat = to_dtype(x, g, flat, dtype)
        runs = [("K6", lambda: fs.fused_sqnxt_fwd(x, flat, meta), 5, False),
                ("K7", lambda: fs.fused_sqnxt_bwd(x, g, flat, meta), 5, True)]
        if label == "stage 1":
            hs, h = [], x
            for li in range(5):
                hs.append(h)
                h = fs.fused_sqnxt_layer_plain(h, fs._layer(flat, li), meta,
                                               li)
            for li in range(5):
                runs.append((f"K8 layer {li}", lambda li=li:
                             fs.fused_sqnxt_layer_fwd(hs[li],
                                                      fs._layer(flat, li),
                                                      meta, li), 1, False))
            for li in range(5):
                gl = g[:meta.cdims[li + 1]].contiguous()
                runs.append((f"K9 layer {li}", lambda li=li, gl=gl:
                             fs.fused_sqnxt_layer_bwd(hs[li], gl,
                                                      fs._layer(flat, li),
                                                      meta, li), 1, True))
        for name, fn, nl, backward in runs:
            fn()
            fn()
            torch.cuda.synchronize()
            read = (lib.pnode_sqnxt_bwd_marks if backward
                    else lib.pnode_sqnxt_fwd_marks)
            ph = marks_us(read, nl, backward)
            result[f"{args.dtype} {label} {name}"] = ph
            print(f"[trace] {args.dtype} {label} {name}: launch "
                  f"{ph['launch']:.1f} us")
            for k, v in ph.items():
                if k != "launch":
                    print(f"[trace]   {k:32s} {v:9.1f} us")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
