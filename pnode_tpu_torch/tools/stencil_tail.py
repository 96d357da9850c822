"""K11's dw tail and K10/K11's host route, measured on the card.

Run from the repository root on a machine with the card::

    python -m pnode_tpu_torch.tools.stencil_tail

(1) Variants of ``csrc/circular_stencil.cu``, each the committed source or
one text substitution of it, built beside the library (one nvcc each, all
at once, into ``build/stencil_tail/``):

- as committed: 8 warps a block with dw, thread 0's ticket one
  acquire-release add;
- the ticket as ``__threadfence`` and a relaxed ``atomicAdd`` (the last
  block fencing again);
- 4 warps a block with dw;
- the warps of the plan without dw (one a block at Burgers: 200 blocks);
- no ticket and no last block's sum (dw is not written: timing only).

At the Burgers (200, 512) k 3 and KS (256, 64) k 5 stage shapes, with N(0,
1) operands and U(-1, 1) taps from seed 0, each variant's dy must equal the
plain fp32 version's bitwise and its dw (where written) lie within 1e-5 of
max |ref|; then each is timed with dw by its device time per call over a
profiler trace of 50 calls, in turns (in order, then reversed), beside the
launch floor (a one-element ``torch.add``'s device time).

(2) The host route of one call at the Burgers shape, part by part: host
microseconds per call over 3,000 calls (a synchronise every 500), and the
wrappers' CUDA events per back-to-back call. The timing helpers are
``chip_smoke.py``'s, so it runs from the repository root.

The last line printed is a JSON object of the readings.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import numpy as np

SHAPES = (("Burgers", 200, 512, 3), ("KS", 256, 64, 5))
TICKET = """  unsigned before;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(before) : "l"(ticket) : "memory");
  return before == gridDim.x - 1;"""
FENCED = """  __threadfence();
  const bool last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  if (last) __threadfence();
  return last;"""
WARPS = "    int w = kMaxTileWarps;\n"
NO_DW_RULE = "!need_dw && "
TAKE = "      is_last = take_ticket(a.ticket);"


def variants(src: str) -> dict:
    """name -> source: the committed one and its substitutions."""
    for part in (TICKET, WARPS, NO_DW_RULE, TAKE):
        if src.count(part) != 1:
            raise SystemExit(f"csrc/circular_stencil.cu changed: {part!r}")
    return {
        "as committed": src,
        "fence + relaxed atomicAdd": src.replace(TICKET, FENCED),
        "4 warps with dw": src.replace(
            WARPS, "    int w = need_dw ? 4 : kMaxTileWarps;\n"),
        "the plan's warps without dw": src.replace(NO_DW_RULE, ""),
        "no ticket, no sum (timing only)": src.replace(
            TAKE, "      is_last = false;"),
    }


def build(srcs: dict) -> dict:
    """name -> ctypes library of each variant."""
    from ..ops import _build

    out = _build.BUILD_DIR.parent / "stencil_tail"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        (out / f"v{i}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-shared", "-o", str(out / f"v{i}.so"), str(out / f"v{i}.cu")]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (i, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        fn = lib.pnode_stencil_bwd
        fn.restype, fn.argtypes = _build._SIGNATURES["pnode_stencil_bwd"]
        libs[name] = lib
    return libs


def time_tails(libs: dict, result: dict) -> None:
    import torch

    from chip_smoke import device_us_per_call

    from ..ops import _build
    from ..ops import circular_stencil as cs

    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    one = torch.ones(1, device=dev)
    result["launch floor us"] = device_us_per_call(
        lambda: torch.add(one, one), [""])[0]
    print(f"[tail] launch floor {result['launch floor us']:.2f} us")
    for label, rows, n, k in SHAPES:
        y, g = f32(rng.normal(size=(rows, n))), f32(rng.normal(size=(rows, n)))
        w = f32(rng.uniform(-1.0, 1.0, size=k))
        dy, dw = torch.empty_like(y), torch.empty(k, device=dev)
        scratch = torch.zeros(4 + k * rows, dtype=torch.int32, device=dev)
        stream = _build.stream_of(y)
        ref_dy, ref_dw = cs.circular_stencil_bwd_plain(y, g, w)

        def call(lib):
            rc = lib.pnode_stencil_bwd(
                y.data_ptr(), g.data_ptr(), w.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), scratch.data_ptr(), scratch.numel(), rows, n,
                k, 1, stream)
            _build.check(rc, "a K11 variant")

        for name, lib in libs.items():
            dw.fill_(float("nan"))
            call(lib)
            torch.cuda.synchronize()
            d_dw = float((dw - ref_dw).abs().max() / ref_dw.abs().max())
            ok = torch.equal(dy, ref_dy) and (
                d_dw <= 1e-5 or name.endswith("(timing only)"))
            print(f"[tail] {label} {name}: dy bitwise {torch.equal(dy, ref_dy)}"
                  f", dw {d_dw:.2e}")
            if not ok:
                raise SystemExit(f"{label}: {name} disagrees with the plain "
                                 "version")
        got = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            got[name].append(device_us_per_call(lambda: call(libs[name]),
                                                ["stencil_bwd"], n=50)[0])
        for name, us in got.items():
            print(f"[tail] {label} K11 with dw, {name}: device {us[0]:.2f} / "
                  f"{us[1]:.2f} us per call")
        result[label] = got


def time_host(result: dict) -> None:
    import torch

    from chip_smoke import cuda_times_ms, summary

    from ..ops import _build
    from ..ops import circular_stencil as cs

    dev = torch.device("cuda", 0)
    y, g = torch.randn(200, 512, device=dev), torch.randn(200, 512,
                                                          device=dev)
    w, one = torch.randn(3, device=dev), torch.ones(1, device=dev)
    out = torch.empty_like(y)
    lib = _build.library()
    args = (y.data_ptr(), w.data_ptr(), out.data_ptr(), 200, 512, 3,
            _build.stream_of(y))
    parts = {
        "K10's wrapper": lambda: cs.circular_stencil_fwd(y, w),
        "K11's wrapper without dw": lambda: cs.circular_stencil_bwd(
            y, g, w, need_dw=False),
        "K11's wrapper with dw": lambda: cs.circular_stencil_bwd(y, g, w),
        "_check": lambda: cs._check(y, w, "K10"),
        "torch.empty_like": lambda: torch.empty_like(y),
        "_build.stream_of (the raw getter)": lambda: _build.stream_of(y),
        "torch.cuda.current_stream(...).cuda_stream": lambda:
            torch.cuda.current_stream(y.device).cuda_stream,
        "the current device (the raw getter)": torch._C._cuda_getDevice,
        "three data_ptr": lambda: (y.data_ptr(), w.data_ptr(),
                                   out.data_ptr()),
        "_build.library()": _build.library,
        "the ctypes launch of K10": lambda: lib.pnode_stencil_fwd(*args),
        "torch.add(one, one)": lambda: torch.add(one, one),
    }
    host = {}
    for name, fn in parts.items():
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3000):
            fn()
            if i % 500 == 499:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t0) / 3000 * 1e6
        print(f"[tail] host {name}: {host[name]:.2f} us per call")
    events = {}
    for name in list(parts)[:3]:
        events[name] = summary(cuda_times_ms(parts[name]))[0] * 1e3
        print(f"[tail] CUDA events, {name}: {events[name]:.2f} us per "
              "back-to-back call")
    result["host us"], result["CUDA events us"] = host, events


def main():
    import torch

    from ..ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("stencil_tail needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[tail] {gpu}")
    _build.library()
    libs = build(variants((_build.CSRC / "circular_stencil.cu").read_text()))
    result = {"gpu": gpu}
    time_tails(libs, result)
    time_host(result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
