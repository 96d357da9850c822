"""K1 of this checkout against K1 of another checkout, timed in turns.

Run on a machine with the card, from the repository root::

    git archive <commit> | tar -x -C build/other   # any other checkout
    python -m pnode_tpu_torch.tools.compare_k1 build/other

The other checkout's ``pnode_tpu_torch`` is loaded as a second package
(its kernels build into that checkout's ``build/``; both builds run at
once). At the KS stack (B 256, 64 -> 104 x4 -> 64) and the Burgers stack
(B 200, 512 -> 576 x4 -> 512), with N(0, 1 / fan_in) weights, N(0, 0.1)
biases and N(0, 1) inputs and cotangents from seed 0, it checks that the
two forwards agree (max |diff| / max |ref| <= 1e-5) and the two dx
norm-wise (5e-3: a ReLU unit within fp32 rounding of 0 may flip between
two correct evaluations), then times each K1 forward and backward in
turns (other, this, this, other): the median of 30 samples of 10
back-to-back calls by CUDA events, and the device time per call, every
kernel of the call summed over a profiler trace of 20 calls (the timing
helpers are ``chip_smoke.py``'s, so it runs from the repository root).
The last line printed is a JSON object of the readings.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np

STACKS = (("KS", 256, [64] + [104] * 4 + [64]),
          ("Burgers", 200, [512] + [576] * 4 + [512]))


def load_other(root: str):
    """The other checkout's ``ops.fused_mlp``, under another package name."""
    pkg = Path(root).resolve() / "pnode_tpu_torch"
    name = "other_pnode_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(name + ".ops.fused_mlp")


def device_us(fn, n=20):
    """(device us per call, kernel launches per call) over a trace of ``n``
    calls: every device kernel the calls launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels, _ = device_kernels(prof.events())
    return (sum(e.time_range.elapsed_us() for e in kernels) / n,
            len(kernels) / n)


def main(argv=None):
    import torch

    from chip_smoke import cuda_times_ms, summary

    from ..ops import fused_mlp as this

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_k1 needs a CUDA card")
    other = load_other(args.other)
    builds = [threading.Thread(target=m._build.library)
              for m in (this, other)]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    result = {}
    for label, B, dims in STACKS:
        Ws = [f32(rng.normal(0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0, 0.1, size=b)) for b in dims[1:]]
        x = f32(rng.normal(size=(B, dims[0])))
        g = f32(rng.normal(size=(B, dims[-1])))
        out, ref = (m.fused_mlp_fwd(x, Ws, bs) for m in (this, other))
        dx, dx_ref = (m.fused_mlp_bwd(x, g, Ws, bs)[0] for m in (this, other))
        d_out = float((out - ref).abs().max() / ref.abs().max())
        d_dx = float((dx - dx_ref).norm() / dx_ref.norm())
        print(f"[compare] {label}: this vs other, forward {d_out:.3e} (max), "
              f"dx {d_dx:.3e} (norm-wise)")
        if not (d_out <= 1e-5 and d_dx <= 5e-3):
            raise SystemExit(f"{label}: the two K1 disagree")
        for what in ("fused_mlp_fwd", "fused_mlp_bwd"):
            calls = {}
            for side, mod in (("other", other), ("this", this)):
                fn = getattr(mod, what)
                call_args = (x, Ws, bs) if what == "fused_mlp_fwd" else (
                    x, g, Ws, bs)
                calls[side] = lambda fn=fn, a=call_args: fn(*a)
            ms = {side: [] for side in calls}
            for side in ("other", "this", "this", "other"):
                ms[side].append(summary(cuda_times_ms(calls[side]))[0])
            row = {}
            for side, fn in calls.items():
                us, launches = device_us(fn)
                row[side] = dict(ms=ms[side], device_us=us,
                                 launches_per_call=launches)
                print(f"[compare] {label} {what} {side}: CUDA events "
                      f"{ms[side][0]:.4f} / {ms[side][1]:.4f} ms, device "
                      f"{us:.1f} us per call over {launches:.0f} launches")
            result[f"{label} {what}"] = row
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
