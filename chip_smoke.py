#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pnode_tpu_torch) on one NVIDIA H100.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

It imports no JAX. Phases, each of which raises on failure (so the script
exits non-zero without printing the final line):

1. Device: CUDA present, compute capability 9.0; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles pnode_tpu_torch/csrc/*.cu for sm_90a with nvcc (timed).
3. Kernels: K1 forward, K1 backward, K2 (ARK forward step) and K3 (ARK
   reverse step) against their plain PyTorch versions on the card, at the
   main path's shapes (B 256, 64 -> 104 x4 -> 64, ARK3, dt 0.2, J and the
   stage inverse from the port's own KSFuncIM) and at a ragged size (B 37,
   hidden 24, nonzero biases), on KS states from the port's generator (the
   inputs the main path gives the kernels): max relative error (max |diff|
   / max |ref|) against the fp32 plain version (<= 1e-5 forward outputs,
   <= 1e-4 gradients and lam_prev) and against the plain version in
   float64 (<= 1e-4); median per-call times of kernel and plain version
   over CUDA events (30 samples of 10 back-to-back calls each). Then K4,
   the fused training loop, against fused_train_loop_plain on K = 8
   distinct KS minibatches (Adam lr 5e-3) at the main path's shapes, at
   the ragged size (chunk=8) and at a batch whose row tiles outnumber the
   co-resident blocks, and K = 16 as two chunks of 8 against one launch
   (check_loop says how it gates); per-iteration times in turns. K2 with
   its embedded error output (the adaptive trial step) at both sizes
   (check_embedded). K5, the fused adaptive loop, against
   fused_adaptive_train_loop_plain on K = 8 KS minibatches (rtol = atol =
   1e-4, 32 trials): the main path from a dt0 warmed by a probe call, the
   ragged case, a cold dt0 = 0.2 that must reject, and a batch whose row
   tiles outnumber the co-resident blocks (check_adaptive says how it
   gates); per-iteration times in turns.
4. The slice: KS SINODE training through ODESolver.odeint_adjoint at full
   width, batch 256, torch.optim.Adam at lr 5e-3, on KS data from the
   port's generator. (a) 4 Adam iterations on the kernel path against the
   generic stage loop through K1 (-pnode_fused_ark_adjoint off), from the
   same weights and batches: per-step loss and gradients, free-running
   loss trajectories and final parameters, all gated at 5e-4
   (phase_paths_agree says how). (b) 200 iterations on the kernel path:
   finite losses, mean of the last 20 below the mean of the first 20;
   steps/s of the kernel path and of the plain path (the nn.Linear model
   on the generic loop, no kernels). Every kernel's launch count over
   (a) + (b) must be above 0. (c) The fused-loop path of
   examples/ks_torch.py --fused_loop (K4) from the same weights and
   batches: its first 4 iterations against (a)'s per-step kernel path in
   (a)'s form; a traced call of 20 iterations (the device's busy share);
   then 200 iterations as a warm launch of 20 and a timed
   launch of 180: finite losses, the last 20 below the first 20 and
   within 10% of (b)'s, steps/s beside (b)'s; K4's launch count over the
   200 iterations must be above 0.
5. The adaptive slice (-ts_adapt_type basic, rtol = atol = 1e-4, the
   dt_first warm start), same width and batch: (a) 4 Adam iterations on
   the per-step adaptive kernel path (K2 with err, K3) against the generic
   adaptive path (phase_adaptive_paths_agree says how); (b) 50 iterations
   on the kernel path: finite losses, the last 10 below the first 10,
   steps/s and trials per iteration; (c) examples/ks_torch.py --fused_loop
   -ts_adapt_type basic (K5): its first 4 iterations against (a)'s generic
   path, a traced call of 20 iterations, then a warm launch of 20 and a
   timed launch of 180. The launch counts of K2's err output, K3 and K5
   over the phase must be above 0.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NX, HIDDEN, BATCH, DT, LR = 64, 104, 256, 0.2, 5e-3
GAMMA = 1767732205903 / 4055673282236  # ARK3(2)4L[2]SA's ESDIRK diagonal
KERNELS = {
    # name: (route, source, replaces)
    "fused_mlp_fwd": ("cuda", "pnode_tpu_torch/csrc/fused_mlp.cu",
                      "pnode_tpu/ops/fused_mlp.py:75"),
    "fused_mlp_bwd": ("cuda", "pnode_tpu_torch/csrc/fused_mlp.cu",
                      "pnode_tpu/ops/fused_mlp.py:89"),
    "fused_ark_step_fwd": ("cuda", "pnode_tpu_torch/csrc/fused_ark_forward.cu",
                           "pnode_tpu/ops/fused_ark_forward.py:53"),
    "fused_ark_step_adj": ("cuda", "pnode_tpu_torch/csrc/fused_ark_adjoint.cu",
                           "pnode_tpu/ops/fused_ark_adjoint.py:304"),
    "fused_train_loop": ("cuda", "pnode_tpu_torch/csrc/fused_train_loop.cu",
                         "pnode_tpu/ops/fused_train_loop.py:284"),
    "fused_ark_step_fwd_embedded": (
        "cuda", "pnode_tpu_torch/csrc/fused_ark_forward.cu",
        "pnode_tpu/ops/fused_ark_forward.py:53"),
    "fused_adaptive_train_loop": (
        "cuda", "pnode_tpu_torch/csrc/fused_adaptive_loop.cu",
        "pnode_tpu/ops/fused_adaptive_loop.py:262"),
}
# the adaptive slice's controller: bench.py's tolerances for KS, basic
ADAPT_FLAGS = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4", "-ts_atol",
               "1e-4", "-ts_adapt_max_steps", "32"]
MAX_TRIALS = 32


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    """max |a - b| / max |b| over the whole tensor (b is the reference)."""
    import torch

    a = a.detach().to(torch.float64)
    b = b.detach().to(torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b):
    import torch

    return float((a.detach().to(torch.float64)
                  - b.detach().to(torch.float64)).abs().max())


def cuda_times_ms(fn, reps=30, warmup=5, inner=10):
    """Sorted per-call times over CUDA events, after warm-up. Each sample
    times ``inner`` back-to-back calls, so a kernel's time is its device
    time once the host enqueues faster than the card runs, not the host's
    launch latency of one call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)


def summary(times):
    """(median, p66) of sorted samples: p66 is the highest percentile with
    a third of the samples beyond it (10 of 30)."""
    return statistics.median(times), times[len(times) - 1 - len(times) // 3]


# -- phase 1 and 2 ------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"compute capability {cap}; the kernels are built "
                           "for sm_90a (Hopper)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase_build():
    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_adaptive_loop import _adaptive_smem_bytes
    from pnode_tpu_torch.ops.fused_ark_adjoint import _smem_bytes
    from pnode_tpu_torch.ops.fused_train_loop import _loop_smem_bytes

    t0 = time.perf_counter()
    lib = _build.library()
    secs = time.perf_counter() - t0
    info = _build.build_info
    log(f"[build] {info['path']} in {secs:.1f} s "
        f"({'cached' if info.get('cached') else 'nvcc'})")
    for line in info.get("log", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"[build]   {line.strip()}")
    # the fits gate mirrors the kernels' shared-memory layout in Python
    for d, layers, s in ((NX, [HIDDEN] * 4 + [NX], 4), (512, [576] * 4 + [512], 8)):
        dims = [d] + layers
        fwd = lib.pnode_ark_fwd_smem(d, s, max(dims))
        adj = lib.pnode_ark_adj_smem(d, s, max(dims), 8 * sum(dims[:-1]))
        loop = lib.pnode_train_loop_smem(d, s, max(dims), 8 * sum(dims[:-1]))
        adapt = lib.pnode_adaptive_loop_smem(d, s, max(dims),
                                             8 * sum(dims[:-1]), MAX_TRIALS)
        if (fwd, adj, loop, adapt) != (
                _smem_bytes(d, layers, s, False),
                _smem_bytes(d, layers, s, True),
                _loop_smem_bytes(d, layers, s),
                _adaptive_smem_bytes(d, layers, s, MAX_TRIALS)):
            raise AssertionError(f"the fits gates disagree with the kernels' "
                                 f"shared memory ({fwd}, {adj}, {loop}, "
                                 f"{adapt}) at d={d}")
        log(f"[build] kernels' shared memory at d={d}, s={s}: forward step "
            f"{fwd} B, reverse step {adj} B, training loop {loop} B, "
            f"adaptive loop ({MAX_TRIALS} trials) {adapt} B")
    # K4's and K5's grids: min(ceil(B / 8), co-resident blocks of a launch)
    for name, cap in (("training loop", loop_capacity(HIDDEN)),
                      ("adaptive loop", loop_capacity(HIDDEN, adaptive=True))):
        log(f"[build] {name} at the main path: {cap} co-resident blocks "
            f"(grid {min(-(-BATCH // 8), cap)} at B {BATCH})")


def loop_capacity(hidden, stages=4, adaptive=False):
    """Co-resident K4 (or K5, at MAX_TRIALS) blocks for 64 -> hidden x4 ->
    64: the occupancy query the wrapper sizes its grid with."""
    from pnode_tpu_torch.ops import _build

    lib = _build.library()
    dims = [NX] + [hidden] * 4 + [NX]
    h = 8 * sum(dims[:-1])
    cap = _build.int_array([0])
    if adaptive:
        smem = lib.pnode_adaptive_loop_smem(NX, stages, max(dims), h,
                                            MAX_TRIALS)
        rc = lib.pnode_adaptive_loop_capacity(smem, cap)
    else:
        smem = lib.pnode_train_loop_smem(NX, stages, max(dims), h)
        rc = lib.pnode_train_loop_capacity(smem, cap)
    _build.check(rc, "loop kernel occupancy query")
    return cap[0]


# -- phase 3 ------------------------------------------------------------------

def ks_operators(device, B=BATCH, nx=NX):
    """Frozen J, the ARK3 stage inverse at DT and the tableau from the
    port's own KSFuncIM, and the prepared stepper (its embedded weights,
    the spectral basis of J, the per-trial stage inverses)."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly"])
    im = KSFuncIM(nx=nx, device=device)
    ex = KSFuncEX(nx=nx, hidden=8, use_fused=True,
                  generator=torch.Generator(device=device).manual_seed(0),
                  device=device)
    ode = pt.ODESolver()
    y = torch.zeros(B, nx, device=device)
    ode.setupTS(y, pt.TorchFunc(im), step_size=DT, method="imex",
                imex_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=B)
    stp = ode._stepper.prepare(0.0, y, ({}, {}), dt0=DT)
    J = stp.setup.frozen_J_blocks[0]
    inv = stp.setup.solver_cache[GAMMA]._inv[0]
    return J, inv, ode._stepper._tableau_static(), stp


def make_stack(device, rng, hidden, nonzero_bias):
    """MLP stack 64 -> hidden x4 -> 64: N(0, 0.01) weights and zero biases
    (the KS init), or N(0, 0.2) weights and N(0, 0.1) biases."""
    import torch

    dims = [NX] + [hidden] * 4 + [NX]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    Ws = [f32(rng.normal(0.0, 0.01 if not nonzero_bias else 0.2,
                         size=(a, b))) for a, b in zip(dims, dims[1:])]
    bs = [f32(rng.normal(0.0, 0.1, size=(b,)) if nonzero_bias
              else np.zeros(b)) for b in dims[1:]]
    return Ws, bs


def make_case(device, u, B, hidden, nonzero_bias, seed):
    """MLP stack, states x (B rows of the KS data u), and random covectors
    g (K1 backward) and lam (K3)."""
    import torch

    rng = np.random.default_rng(seed)
    Ws, bs = make_stack(device, rng, hidden, nonzero_bias)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    x = f32(u[rng.choice(len(u), B, replace=False)])
    g = f32(rng.normal(size=(B, NX)))
    lam = f32(rng.normal(size=(B, NX)))
    return Ws, bs, x, g, lam


def check_kernel(name, got, plain, ref64, tol32, report, tol64=1e-4):
    """got/plain/ref64: lists of tensors; records and asserts the errors:
    within ``tol32`` of the plain fp32 version and within ``tol64`` of the
    plain version in float64. The plain fp32 version's own error against
    float64 is printed beside them."""
    e32 = max(rel_err(a, b) for a, b in zip(got, plain))
    e64 = max(rel_err(a, b) for a, b in zip(got, ref64))
    e_plain = max(rel_err(a, b) for a, b in zip(plain, ref64))
    ea = max(abs_err(a, b) for a, b in zip(got, plain))
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    ok = e32 <= tol32 and e64 <= tol64
    log(f"[kernels]   {name}: rel err vs plain fp32 {e32:.3e} (tol "
        f"{tol32:.0e}), vs plain fp64 {e64:.3e} (tol {tol64:.0e}; plain fp32 "
        f"vs fp64 {e_plain:.3e}), max abs {ea:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")


def phase_kernels(device, u):
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        fused_ark_step_adj, fused_ark_step_adj_plain)
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_embedded,
        fused_ark_step_fwd_plain)
    from pnode_tpu_torch.ops.fused_mlp import (
        fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fwd, fused_mlp_plain)

    J, inv, tab, stp = ks_operators(device)
    berr = (stp._bIe, stp._bEe)
    dt = float(np.float32(DT))  # the step size as the fp32 solve carries it
    f64 = lambda ts: [t.to(torch.float64) for t in ts]  # noqa: E731
    reports = {k: {} for k in KERNELS}
    cases = [("main path B256 h104", BATCH, HIDDEN, False, 1),
             ("ragged B37 h24 biased", 37, 24, True, 2)]
    for label, B, hidden, biased, seed in cases:
        log(f"[kernels] {label}")
        Ws, bs, x, g, lam = make_case(device, u, B, hidden, biased, seed)
        main = B == BATCH
        # K1 forward
        out = fused_mlp_fwd(x, Ws, bs)
        torch.cuda.synchronize()
        check_kernel("fused_mlp_fwd", [out], [fused_mlp_plain(x, Ws, bs)],
                     [fused_mlp_plain(x.double(), f64(Ws), f64(bs))], 1e-5,
                     reports["fused_mlp_fwd"] if main else {})
        # K1 backward
        got = fused_mlp_bwd(x, g, Ws, bs)
        torch.cuda.synchronize()
        pl = fused_mlp_bwd_plain(x, g, Ws, bs)
        r64 = fused_mlp_bwd_plain(x.double(), g.double(), f64(Ws), f64(bs))
        flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
        check_kernel("fused_mlp_bwd", flat(got), flat(pl), flat(r64), 1e-4,
                     reports["fused_mlp_bwd"] if main else {})
        # K2
        args = (tab, dt, x, J, inv, Ws, bs)
        args64 = (tab, dt, x.double(), J.double(), inv.double(), f64(Ws),
                  f64(bs))
        y1, Ys = fused_ark_step_fwd(*args)
        torch.cuda.synchronize()
        y1p, Ysp = fused_ark_step_fwd_plain(*args)
        y1d, Ysd = fused_ark_step_fwd_plain(*args64)
        check_kernel("fused_ark_step_fwd", [y1, Ys], [y1p, Ysp], [y1d, Ysd],
                     1e-5, reports["fused_ark_step_fwd"] if main else {})
        # K2 with its embedded error output (the adaptive trial step)
        check_embedded(tab, berr, dt, x, J, inv, Ws, bs, args64,
                       reports["fused_ark_step_fwd_embedded"] if main else {})
        # the same at a trial's dt and spectral stage inverse (reading only:
        # err is ~50x smaller at dt 0.05 than at 0.2, the rounding is not)
        dtt = float(np.float32(0.05))
        invt = stp._trial_inverse(J, GAMMA, dtt)
        e_k = fused_ark_step_fwd_embedded(tab, berr, dtt, x, J, invt, Ws,
                                          bs)[1]
        e_p = fused_ark_step_fwd_plain(tab, dtt, x, J, invt, Ws, bs,
                                       b_err=berr)[1]
        e_d = fused_ark_step_fwd_plain(tab, dtt, x.double(), J.double(),
                                       invt.double(), f64(Ws), f64(bs),
                                       b_err=berr)[1]
        log(f"[kernels]   fused_ark_step_fwd_embedded at dt {dtt}: err rel "
            f"(to max |err| {float(e_p.abs().max()):.3e}) vs plain fp32 "
            f"{rel_err(e_k, e_p):.3e}, vs plain fp64 {rel_err(e_k, e_d):.3e} "
            f"(plain fp32 vs fp64 {rel_err(e_p, e_d):.3e}); not gated")
        # K3, on the plain forward's stage values
        aargs = (tab, dt, Ysp, lam, J, inv, Ws, bs)
        aargs64 = (tab, dt, Ysp.double(), lam.double(), J.double(),
                   inv.double(), f64(Ws), f64(bs))
        flat3 = lambda r: [r[0], *r[1][0], *r[1][1]]  # noqa: E731
        got = fused_ark_step_adj(*aargs)
        torch.cuda.synchronize()
        check_kernel("fused_ark_step_adj", flat3(got),
                     flat3(fused_ark_step_adj_plain(*aargs)),
                     flat3(fused_ark_step_adj_plain(*aargs64)), 1e-4,
                     reports["fused_ark_step_adj"] if main else {})
        if main:
            timings = {
                "fused_mlp_fwd": (lambda: fused_mlp_fwd(x, Ws, bs),
                                  lambda: fused_mlp_plain(x, Ws, bs)),
                "fused_mlp_bwd": (lambda: fused_mlp_bwd(x, g, Ws, bs),
                                  lambda: fused_mlp_bwd_plain(x, g, Ws, bs)),
                "fused_ark_step_fwd": (
                    lambda: fused_ark_step_fwd(*args),
                    lambda: fused_ark_step_fwd_plain(*args)),
                "fused_ark_step_fwd_embedded": (
                    lambda: fused_ark_step_fwd_embedded(tab, berr, *args[1:]),
                    lambda: fused_ark_step_fwd_plain(*args, b_err=berr)),
                "fused_ark_step_adj": (
                    lambda: fused_ark_step_adj(*aargs),
                    lambda: fused_ark_step_adj_plain(*aargs)),
            }
            for name, (kern, plain) in timings.items():
                # plain, kernel, kernel, plain: compare within one call
                p1 = summary(cuda_times_ms(plain))
                k1 = summary(cuda_times_ms(kern))
                k2 = summary(cuda_times_ms(kern))
                p2 = summary(cuda_times_ms(plain))
                reports[name]["ms"] = min(k1[0], k2[0])
                reports[name]["plain_ms"] = min(p1[0], p2[0])
                log(f"[kernels]   {name}: kernel median {k1[0]:.4f} / "
                    f"{k2[0]:.4f} ms (p66 {k1[1]:.4f} / {k2[1]:.4f}), plain "
                    f"median {p1[0]:.4f} / {p2[0]:.4f} ms (p66 {p1[1]:.4f} / "
                    f"{p2[1]:.4f}); 30 samples of 10 back-to-back calls")
    reports["fused_train_loop"] = phase_loop_kernel(device, u, J, inv, tab,
                                                    dt)
    reports["fused_adaptive_train_loop"] = phase_adaptive_kernel(device, u,
                                                                 stp)
    return reports


def check_embedded(tab, berr, dt, x, J, inv, Ws, bs, args64, report):
    """K2's err output against the plain version: y1 and Ys as K2's (1e-5
    of their max; 1e-4 against float64); err within 1e-4 of max |err| of
    the plain version in fp32, and no farther from the plain version in
    float64 than max(1e-4, twice the plain fp32 version's own distance).
    err is a small difference of stage sums whose implicit kI is the
    difference quotient (Y - G) / (dt a_ii): at the main path's KS states
    and dt 0.2 the plain version in fp32 is itself ~1e-4 of max |err| from
    float64, so 1e-4 against float64 is out of reach of any fp32
    evaluation."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd_embedded, fused_ark_step_fwd_plain)

    y1, err, Ys = fused_ark_step_fwd_embedded(tab, berr, dt, x, J, inv, Ws,
                                              bs)
    torch.cuda.synchronize()
    p = fused_ark_step_fwd_plain(tab, dt, x, J, inv, Ws, bs, b_err=berr)
    d = fused_ark_step_fwd_plain(*args64, b_err=berr)
    check_kernel("fused_ark_step_fwd_embedded (y1, Ys)", [y1, Ys],
                 [p[0], p[2]], [d[0], d[2]], 1e-5, report)
    check_kernel(f"fused_ark_step_fwd_embedded (err, max |err| "
                 f"{float(p[1].abs().max()):.3e})", [err], [p[1]], [d[1]],
                 1e-4, report, tol64=max(1e-4, 2.0 * rel_err(p[1], d[1])))


def loop_case(device, u, B, hidden, biased, seed, K):
    """K4 operands: make_case's MLP stack and K distinct KS minibatches of
    one-step windows as (K, B, 64) tensors, in shuffled epochs as phase 4
    draws them, or drawn with replacement when B exceeds the data."""
    import torch

    rng = np.random.default_rng(seed)
    Ws, bs = make_stack(device, rng, hidden, biased)
    if B < len(u):
        pairs = ks_batches(u, K, B, seed)
        y, tgt = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    else:
        idx = rng.integers(0, len(u) - 1, size=(K, B))
        y, tgt = u[idx], u[idx + 1]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    return Ws, bs, f32(y), f32(tgt)


def loop_runner(tab, dt, J, inv, Ws, bs, y, tgt):
    """run(fn, K, eps, dtype, **kw): fn (the kernel's wrapper or its plain
    version) over the first K minibatches from zero Adam moments."""
    import torch

    def run(fn, K, eps, dtype=torch.float32, **kw):
        cast = lambda ts: [t.to(dtype) for t in ts]  # noqa: E731
        z = ([torch.zeros_like(w, dtype=dtype) for w in Ws],
             [torch.zeros_like(b, dtype=dtype) for b in bs])
        return fn(tab, dt, y[:K].to(dtype), tgt[:K].to(dtype), J.to(dtype),
                  inv.to(dtype), cast(Ws), cast(bs), z, z, 0, lr=LR, eps=eps,
                  **kw)

    return run


def norm_rel(got, ref):
    """max over tensor pairs of ||got - ref|| / ||ref|| (norm-wise)."""
    import torch

    return max(float((a.detach().double() - b.detach().double()).norm()
                     / b.detach().double().norm().clamp_min(1e-300))
               for a, b in zip(got, ref))


def check_loop(label, run, K, chunk, report, tol=5e-4):
    """K4 against fused_train_loop_plain on the same operands.

    - The first iteration's gradient, read as m1 / (1 - b1) after one
      iteration from zero moments (the exact check of
      tests/test_fused_train_loop.py:332-349): within 1e-4 norm-wise per
      tensor of the plain version in fp32 and in fp64.
    - K iterations at Adam eps 1e-8 and 1e-6: per-iteration losses within
      1e-4 relative; the final parameters within ``tol`` in max abs at eps
      1e-8 and norm-wise relative at eps 1e-6 (phase 4(a)'s form: below
      eps, Adam passes a gradient's rounding on amplified by up to lr/eps).
    """
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, fused_train_loop_plain)

    grad = lambda out: [m / 0.1 for m in out[2][0] + out[2][1]]  # noqa: E731
    g_k = grad(run(fused_train_loop, 1, 1e-8))
    torch.cuda.synchronize()
    g_p = grad(run(fused_train_loop_plain, 1, 1e-8))
    g_d = grad(run(fused_train_loop_plain, 1, 1e-8, torch.float64))
    e32, e64, e_plain = norm_rel(g_k, g_p), norm_rel(g_k, g_d), \
        norm_rel(g_p, g_d)
    ea = max(abs_err(a, b) for a, b in zip(g_k, g_p))
    ok = e32 <= 1e-4 and e64 <= 1e-4
    log(f"[kernels]   fused_train_loop {label}: first-iteration gradient "
        f"(m1 / (1 - b1)) rel err vs plain fp32 {e32:.3e}, vs plain fp64 "
        f"{e64:.3e} (norm-wise, tol 1e-4; plain fp32 vs fp64 "
        f"{e_plain:.3e})")
    for eps in (1e-8, 1e-6):
        kk = run(fused_train_loop, K, eps, chunk=chunk)
        torch.cuda.synchronize()
        pp = run(fused_train_loop_plain, K, eps)
        lk, lp = kk[4].double().cpu(), pp[4].double().cpu()
        lrel = float(((lk - lp).abs() / lp.abs()).max())
        pk, pq = kk[0] + kk[1], pp[0] + pp[1]
        pabs = max(abs_err(a, b) for a, b in zip(pk, pq))
        prel = norm_rel(pk, pq)
        ea = max(ea, pabs, float((lk - lp).abs().max()))
        ok = ok and lrel <= 1e-4 and (pabs <= tol if eps == 1e-8
                                      else prel <= tol)
        log(f"[kernels]   fused_train_loop {label}: K {K}, chunk {chunk}, "
            f"Adam eps {eps:.0e}: losses max rel err {lrel:.3e} (tol 1e-4); "
            f"params max abs {pabs:.3e}, rel (norm-wise) {prel:.3e}; gated "
            f"{'max abs' if eps == 1e-8 else 'rel'} at {tol:.0e}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    if not ok:
        raise AssertionError(f"fused_train_loop ({label}) disagrees with its "
                             "plain version")


def phase_loop_kernel(device, u, J, inv, tab, dt, K=8, tol=5e-4):
    """Phase 3 for K4: the main path (B 256, 64 -> 104 x4 -> 64), the
    ragged case (B 37, hidden 24, nonzero biases, chunk=8) and a batch
    with more row tiles than co-resident blocks, against the plain loop;
    K = 16 as two launches of 8 against one launch; time per iteration,
    kernel and plain version in turns."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, fused_train_loop_plain)

    report = {}
    log(f"[kernels] fused_train_loop: K {K} distinct KS minibatches, Adam "
        f"lr {LR}")
    main = loop_case(device, u, BATCH, HIDDEN, False, 1, 2 * K)
    run = loop_runner(tab, dt, J, inv, *main)
    check_loop(f"B{BATCH} h{HIDDEN}", run, K, None, report, tol)
    rag = loop_runner(tab, dt, J, inv,
                      *loop_case(device, u, 37, 24, True, 2, K))
    check_loop("B37 h24 biased", rag, K, 8, report, tol)
    # more row tiles than co-resident blocks: blocks stride over tiles,
    # summing their partials and loss over more than one tile
    wide = 8 * loop_capacity(24, len(tab[2])) + 5
    strided = loop_runner(tab, dt, J, inv,
                          *loop_case(device, u, wide, 24, True, 3, K))
    check_loop(f"B{wide} h24 biased (blocks stride)", strided, K, None,
               report, tol)

    # persistence across launches: the state one launch leaves in device
    # memory seeds the next
    one = run(fused_train_loop, 2 * K, 1e-8)
    two = run(fused_train_loop, 2 * K, 1e-8, chunk=K)
    torch.cuda.synchronize()
    lrel = float(((two[4] - one[4]).abs() / one[4].abs()).max())
    pabs = max(abs_err(a, b) for a, b in zip(two[0] + two[1],
                                             one[0] + one[1]))
    same = all(torch.equal(a, b) for a, b in zip(
        two[0] + two[1] + [two[4]], one[0] + one[1] + [one[4]]))
    log(f"[kernels]   fused_train_loop K {2 * K}: chunk {K} vs one launch: "
        f"losses max rel {lrel:.3e}, params max abs {pabs:.3e} (bitwise "
        f"equal: {same}; tol 1e-4, {tol:.0e})")
    if not (lrel <= 1e-4 and pabs <= tol):
        raise AssertionError("fused_train_loop loses its state across "
                             "launches")

    # per iteration: plain, kernel, kernel, plain
    kern = lambda: run(fused_train_loop, K, 1e-8)  # noqa: E731
    plain = lambda: run(fused_train_loop_plain, K, 1e-8)  # noqa: E731
    p1 = summary(cuda_times_ms(plain, reps=10, warmup=1, inner=1))
    k1 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    k2 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    p2 = summary(cuda_times_ms(plain, reps=10, warmup=1, inner=1))
    report["ms"] = min(k1[0], k2[0]) / K
    report["plain_ms"] = min(p1[0], p2[0]) / K
    log(f"[kernels]   fused_train_loop per iteration: kernel median "
        f"{k1[0] / K:.4f} / {k2[0] / K:.4f} ms (p66 {k1[1] / K:.4f} / "
        f"{k2[1] / K:.4f}), plain median {p1[0] / K:.4f} / {p2[0] / K:.4f} ms "
        f"(p66 {p1[1] / K:.4f} / {p2[1] / K:.4f}); 10 samples of 3 (kernel) "
        f"or 1 (plain) back-to-back calls of K {K}")
    return report


def adaptive_runner(stp, Ws, bs, y, tgt, dt0):
    """run(fn, K, eps, dtype, k0, state): fn (K5's wrapper or its plain
    version) over minibatches k0 .. k0 + K - 1 with the main path's
    controller (rtol = atol = 1e-4, MAX_TRIALS trials, window [0, DT]),
    from ``state`` = (weights, biases, m, v, t0, dt0), by default
    ``run.state0``: the case's weights, zero Adam moments, t0 0 and dt0."""
    import torch

    J = stp.setup.frozen_J_blocks[0]
    lam, Q = stp._spectral_stage_basis(J)
    tab = stp._tableau_static() + (stp._bIe, stp._bEe)

    def run(fn, K, eps, dtype=torch.float32, k0=0, state=None):
        cast = lambda ts: [t.to(dtype) for t in ts]  # noqa: E731
        W, b, m, v, t0, d0 = run.state0 if state is None else state
        return fn(tab, GAMMA, lam.to(dtype), Q.to(dtype), J.to(dtype), DT,
                  d0, y[k0:k0 + K].to(dtype), tgt[k0:k0 + K].to(dtype),
                  cast(W), cast(b), (cast(m[0]), cast(m[1])),
                  (cast(v[0]), cast(v[1])), t0, MAX_TRIALS, rtol=1e-4,
                  atol=1e-4, order=stp.tab.order, lr=LR, eps=eps)

    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    run.state0 = (Ws, bs, z, z, 0, dt0)
    return run


def stats_rows(out):
    """Per-iteration (accepted, rejected, completed) of a K5 result."""
    st = out[5]
    return [tuple(int(st[n][i]) for n in ("accepted", "rejected",
                                          "completed"))
            for i in range(len(out[4]))]


def rel_max(a, b):
    """max |a - b| / |b| elementwise (b the reference)."""
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def check_adaptive(label, run, K, report, tol=5e-4, min_rejected=0,
                   drift=False):
    """K5 against fused_adaptive_train_loop_plain on the same operands.

    - On one trajectory (phase 4(a)'s per-step form): K iterations, one
      launch each, from the kernel run's parameters, Adam moments and
      warm-start dt; at each, kernel and plain version run one probe
      iteration from those parameters and zero moments, whose m1 / (1 -
      b1) is the iteration's gradient. Per iteration: accepted, rejected
      and completed equal; dt_first within 1e-5 relative; dt_last within
      5e-2 (the controller's proposal after the landing trial, a MATCHSTEP
      sliver whose error estimate is a few times 1e-3 of the tolerance and
      carries fp32 rounding of the same size, moved by the 1/(order+1)
      power: two correct fp32 evaluations put it up to 1e-2 apart on the
      card, and nothing consumes it; a wrong controller branch, the clip
      or no growth after a rejection, moves it by 10% or more); loss
      within 1e-4 relative; gradient within ``tol`` norm-wise per tensor.
    - Free-running, K iterations in one launch at Adam eps 1e-8 and 1e-6:
      decisions equal, losses within 1e-4 relative, at least
      ``min_rejected`` rejections; at eps 1e-6 the final parameters within
      ``tol`` norm-wise (phase 4(a)'s form). dt_first, dt_last and the
      final parameters at eps 1e-8 (max abs, phase 4(a)'s form there) are
      printed and not gated: with kI = Y J^T the rounding of a stage
      product reaches the gradient multiplied by |J|, and Adam below eps
      multiplies a gradient's rounding by up to lr/eps = 5e5, so two
      free-running fp32 trajectories part (after 8 iterations the plain
      version in fp32 is itself 3.2e-3, max abs, from the plain version
      in fp64 at the main path), and with them the error estimates that
      set a rejected first trial's dt. ``drift`` runs the fp64 plain
      version and prints that distance beside the kernel's.
    """
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop as kern,
        fused_adaptive_train_loop_plain as plain)

    grad = lambda out: [m / 0.1 for m in out[2][0] + out[2][1]]  # noqa: E731
    W, b, m, v, t0, dt = run.state0
    z = run.state0[2]
    same, ea = True, 0.0
    worst = {"grad": 0.0, "loss": 0.0, "dt_first": 0.0, "dt_last": 0.0}
    rows = []
    for k in range(K):
        probe = (W, b, z, z, 0, dt)
        pk = run(kern, 1, 1e-8, k0=k, state=probe)
        torch.cuda.synchronize()
        pp = run(plain, 1, 1e-8, k0=k, state=probe)
        if k == 0:
            pd = run(plain, 1, 1e-8, torch.float64, state=probe)
            log(f"[kernels]   fused_adaptive_train_loop {label}: first-"
                f"iteration gradient vs plain fp32 "
                f"{norm_rel(grad(pk), grad(pp)):.3e}, vs plain fp64 "
                f"{norm_rel(grad(pk), grad(pd)):.3e} (plain fp32 vs fp64 "
                f"{norm_rel(grad(pp), grad(pd)):.3e}; fp64 trials "
                f"{stats_rows(pd)})")
        rows += stats_rows(pk)
        same = same and stats_rows(pk) == stats_rows(pp)
        for name in ("dt_first", "dt_last"):
            worst[name] = max(worst[name], rel_max(pk[5][name], pp[5][name]))
        worst["loss"] = max(worst["loss"], rel_max(pk[4], pp[4]))
        worst["grad"] = max(worst["grad"], norm_rel(grad(pk), grad(pp)))
        ea = max([ea, abs_err(pk[4], pp[4])]
                 + [abs_err(x, y) for x, y in zip(grad(pk), grad(pp))])
        adv = run(kern, 1, 1e-8, k0=k, state=(W, b, m, v, t0, dt))
        W, b, m, v = adv[0], adv[1], adv[2], adv[3]
        t0, dt = t0 + 1, float(adv[5]["dt_first"][0])
    ok = (same and worst["dt_first"] <= 1e-5 and worst["dt_last"] <= 5e-2
          and worst["loss"] <= 1e-4 and worst["grad"] <= tol)
    log(f"[kernels]   fused_adaptive_train_loop {label}: {K} iterations on "
        f"one trajectory, (accepted, rejected, completed) {rows} (plain "
        f"{'equal' if same else 'DIFFERENT'}); max rel err dt_first "
        f"{worst['dt_first']:.3e} (tol 1e-5), dt_last {worst['dt_last']:.3e} "
        f"(tol 5e-2), loss {worst['loss']:.3e} (tol 1e-4), gradient "
        f"{worst['grad']:.3e} (norm-wise, tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    for eps in (1e-8, 1e-6):
        kk = run(kern, K, eps)
        torch.cuda.synchronize()
        pp = run(plain, K, eps)
        rows_k, rows_p = stats_rows(kk), stats_rows(pp)
        dtf = rel_max(kk[5]["dt_first"], pp[5]["dt_first"])
        dtl = rel_max(kk[5]["dt_last"], pp[5]["dt_last"])
        lrel = rel_max(kk[4], pp[4])
        pk, pq = kk[0] + kk[1], pp[0] + pp[1]
        n_rej = sum(r[1] for r in rows_k)
        prel = norm_rel(pk, pq)
        ea = max(ea, abs_err(kk[4], pp[4]))
        good = (rows_k == rows_p and lrel <= 1e-4 and n_rej >= min_rejected
                and (eps == 1e-8 or prel <= tol))
        ok = ok and good
        log(f"[kernels]   fused_adaptive_train_loop {label}: K {K} in one "
            f"launch, Adam eps {eps:.0e}: (accepted, rejected, completed) "
            f"{rows_k} (plain {'equal' if rows_k == rows_p else rows_p}); "
            f"losses max rel err {lrel:.3e} (tol 1e-4)"
            + ("" if eps == 1e-8 else f"; final parameters rel (norm-wise) "
               f"{prel:.3e} (tol {tol:.0e})")
            + (f"; rejections {n_rej} (at least {min_rejected})"
               if min_rejected else "") + f" {'ok' if good else 'FAIL'}")
        line = (f"[kernels]     not gated: max rel err dt_first {dtf:.3e}, "
                f"dt_last {dtl:.3e}; final parameters kernel vs plain fp32 "
                f"max abs {max(abs_err(x, y) for x, y in zip(pk, pq)):.3e}, "
                f"rel (norm-wise) {prel:.3e}")
        if drift and eps == 1e-8:
            dd = run(plain, K, eps, torch.float64)
            pd = dd[0] + dd[1]
            line += (f"; plain fp32 vs plain fp64 max abs "
                     f"{max(abs_err(x, y) for x, y in zip(pq, pd)):.3e}, rel "
                     f"{norm_rel(pq, pd):.3e}; kernel vs plain fp64 max abs "
                     f"{max(abs_err(x, y) for x, y in zip(pk, pd)):.3e} (fp64 "
                     f"decisions {'equal' if stats_rows(dd) == rows_k else stats_rows(dd)})")
        log(line)
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    if not ok:
        raise AssertionError(f"fused_adaptive_train_loop ({label}) disagrees "
                             "with its plain version")


def phase_adaptive_kernel(device, u, stp, K=8):
    """Phase 3 for K5, against its plain version on K KS minibatches: the
    main path (B 256, hidden 104, dt0 warm from a probe call), the ragged
    case (B 37, hidden 24, nonzero biases), a cold dt0 = DT that must
    reject, and a batch whose row tiles outnumber the co-resident blocks;
    then time per iteration, kernel and plain version in turns."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop, fused_adaptive_train_loop_plain)

    report = {}
    log(f"[kernels] fused_adaptive_train_loop: K {K} distinct KS "
        f"minibatches, rtol = atol = 1e-4, {MAX_TRIALS} trials, Adam lr {LR}")
    main = loop_case(device, u, BATCH, HIDDEN, False, 1, K)
    probe = adaptive_runner(stp, *main, DT)(fused_adaptive_train_loop, 1,
                                            1e-8)
    dt_warm = float(probe[5]["dt_first"][0])
    log(f"[kernels]   probe call from dt0 {DT}: dt_first {dt_warm:.6g}")
    run = adaptive_runner(stp, *main, dt_warm)
    check_adaptive(f"B{BATCH} h{HIDDEN} warm", run, K, report, drift=True)
    rag = adaptive_runner(stp, *loop_case(device, u, 37, 24, True, 2, K),
                          dt_warm)
    check_adaptive("B37 h24 biased", rag, K, report)
    cold = adaptive_runner(stp, *main, DT)
    check_adaptive(f"B{BATCH} h{HIDDEN} cold dt0 {DT}", cold, K, report,
                   min_rejected=1)
    wide = 8 * loop_capacity(24, adaptive=True) + 5
    strided = adaptive_runner(stp, *loop_case(device, u, wide, 24, True, 3,
                                              K), dt_warm)
    check_adaptive(f"B{wide} h24 biased (blocks stride)", strided, K, report)

    kern = lambda: run(fused_adaptive_train_loop, K, 1e-8)  # noqa: E731
    plain = lambda: run(fused_adaptive_train_loop_plain, K, 1e-8)  # noqa
    p1 = summary(cuda_times_ms(plain, reps=5, warmup=1, inner=1))
    k1 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    k2 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    p2 = summary(cuda_times_ms(plain, reps=5, warmup=1, inner=1))
    report["ms"] = min(k1[0], k2[0]) / K
    report["plain_ms"] = min(p1[0], p2[0]) / K
    log(f"[kernels]   fused_adaptive_train_loop per iteration: kernel median "
        f"{k1[0] / K:.4f} / {k2[0] / K:.4f} ms (p66 {k1[1] / K:.4f} / "
        f"{k2[1] / K:.4f}), plain median {p1[0] / K:.4f} / {p2[0] / K:.4f} ms "
        f"(p66 {p1[1] / K:.4f} / {p2[1] / K:.4f}); 10 samples of 3 (kernel) "
        f"or 5 samples of 1 (plain) back-to-back calls of K {K}; trials per "
        f"iteration {stats_rows(run(fused_adaptive_train_loop, K, 1e-8))}")
    return report


# -- phase 4 ------------------------------------------------------------------

def ks_batches(u, n_iters, batch, seed):
    """One-step windows (y0 = u[i], target u[i+1]) in shuffled minibatches,
    epoch after epoch, as (y0, target) numpy pairs."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_iters:
        starts = np.arange(len(u) - 1)
        rng.shuffle(starts)
        for b in range(len(starts) // batch):
            s = starts[b * batch:(b + 1) * batch]
            out.append((u[s], u[s + 1]))
    return out[:n_iters]


def build_trainer(device, state, fused, flags=(), eps=1e-8):
    """(ode, ex module, optimizer) of the KS IMEX model from ``state``;
    Adam at lr 5e-3 and epsilon ``eps`` (torch's and optax's default)."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly"] + list(flags))
    im = KSFuncIM(nx=NX, device=device)
    ex = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=fused, device=device)
    ex.load_state_dict(state)
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(BATCH, NX, device=device), pt.TorchFunc(im),
                step_size=DT, method="imex", imex_form=True,
                func2=pt.TorchFunc(ex), linear_solver="hpddm",
                fixed_jacobian=True, batch_size=BATCH)
    return ode, ex, torch.optim.Adam(ex.parameters(), lr=LR, eps=eps)


def train(ode, ex, opt, batches, device):
    """One Adam iteration per batch; returns the losses as a tensor."""
    import torch

    t_out = np.array([0.0, DT])
    losses = []
    for y0, tgt in batches:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
        tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
        pred = ode.odeint_adjoint(y0, t_out)
        loss = torch.mean((pred[-1] - tgt) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def loss_and_grads(ode, ex, y0, tgt, device):
    """(loss, gradient tensors) of one step's MSE; leaves them in .grad."""
    import torch

    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    for p in ex.parameters():
        p.grad = None
    pred = ode.odeint_adjoint(y0, np.array([0.0, DT]))
    loss = torch.mean((pred[-1] - tgt) ** 2)
    loss.backward()
    return float(loss.detach()), [p.grad.detach().clone()
                                  for p in ex.parameters()]


def device_kernels(events):
    """(kernel events, busy us) of a trace's raw events: kernels are device
    events that are neither user annotations (a span's device-side copy)
    nor the CPU ops that launched them, so no device interval is counted
    twice; busy is the union of their intervals."""
    from torch.autograd import DeviceType

    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in cpu_names]
    busy_us, end_us = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo = max(e.time_range.start, end_us)
        busy_us += max(0.0, e.time_range.end - lo)
        end_us = max(end_us, e.time_range.end)
    return kernels, busy_us


def profile_steps(label, ode, ex, opt, batches, device):
    """A traced run of kernel-path training steps: host time per layer
    (spans around the solve, the loss, the adjoint and Adam), device time
    per kernel, and the device's busy share of the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    t_out = np.array([0.0, DT])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for y0, tgt in batches:
            y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
            tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
            with record_function("span:solve"):
                pred = ode.odeint_adjoint(y0, t_out)
            with record_function("span:loss"):
                loss = torch.mean((pred[-1] - tgt) ** 2)
            opt.zero_grad(set_to_none=True)
            with record_function("span:adjoint"):
                loss.backward()
            with record_function("span:adam"):
                opt.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels, busy_us = device_kernels(events)
    n = len(batches)
    spans, per_kernel = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("span:"):
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
    for e in kernels:
        us, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    log(f"[profile] {label}: {n} traced steps, {1e3 * wall / n:.3f} ms/step; "
        f"device busy {busy_us * 1e-6 / wall:.3f} of the wall time")
    log("[profile] host us/step: " + ", ".join(
        f"{k[5:]} {v / n:.1f}" for k, v in sorted(spans.items())))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:8]:
        log(f"[profile]   {us / n:9.1f} us/step x{count // n:<3d} {name[:90]}")
    if not kernels:
        log("[profile] the profiler recorded no device time")


def to_linear_state(fused_state):
    """nn.Linear state_dict of the same weights (weight is (out, in))."""
    out = {}
    i = 0
    while f"net.kernel_{i}" in fused_state:
        out[f"net.layers.{i}.weight"] = fused_state[f"net.kernel_{i}"].t().contiguous()
        out[f"net.layers.{i}.bias"] = fused_state[f"net.bias_{i}"].clone()
        i += 1
    return out


def ks_data(n_samples=600):
    from pnode_tpu_torch.data import generate_ks_data

    u, _ = generate_ks_data(nx=NX, L=22.0, n_samples=n_samples, dt_data=DT,
                            cache_dir=os.path.join(ROOT, "build", "data"))
    return u


def phase_paths_agree(device, state0, batches, tol=5e-4):
    """Phase 4(a): the kernel path against the generic stage loop through
    K1 (-pnode_fused_ark_adjoint off), from the same weights and batches.

    - At each Adam step, both paths evaluate the loss and the gradients from
      the kernel path's parameters: within ``tol`` relative (gradients
      norm-wise per tensor).
    - Run free, the two loss trajectories agree within ``tol`` relative.
    - Run free at Adam's default eps, the final parameters agree within
      ``tol`` in max abs: the form of the reference's own chip gate
      (tools/hardware_smoke.py gate 7). The KS init's weight gradients are
      ~1e-9, below eps, where Adam's step lr*g/(|g| + eps) passes a
      gradient's rounding on to the parameter amplified by lr/eps, so a
      relative gate on parameters does not hold between two correct fp32
      evaluations there.
    - Run free at Adam eps 1e-6, above those gradients, the final
      parameters agree within ``tol`` relative (norm-wise per tensor).

    Returns the kernel path's free-running runs, {eps: (losses, params)}.
    """
    import torch

    import pnode_tpu_torch as pt

    off = ["-pnode_fused_ark_adjoint", "off"]
    ode, ex, opt = build_trainer(device, state0, fused=True)
    step_l = step_g = 0.0
    losses = []
    for y0, tgt in batches:
        pt.set_option("pnode_fused_ark_adjoint", "off")
        l_g, g_g = loss_and_grads(ode, ex, y0, tgt, device)
        pt.set_option("pnode_fused_ark_adjoint", "auto")
        l_k, g_k = loss_and_grads(ode, ex, y0, tgt, device)
        step_l = max(step_l, abs(l_k - l_g) / abs(l_g))
        step_g = max(step_g, max(float((a - b).norm() / b.norm())
                                 for a, b in zip(g_k, g_g)))
        opt.step()
        losses.append(l_k)
    log(f"[slice] (a) {len(batches)} Adam steps, kernel path vs generic "
        f"loop through K1 from the same parameters: max rel err loss "
        f"{step_l:.3e}, gradients {step_g:.3e} (norm-wise; tol {tol:.0e})")
    # the loop above is the kernel path's free-running trajectory
    kernel_runs = {1e-8: (torch.tensor(losses), list(ex.parameters()))}
    ode, ex, opt = build_trainer(device, state0, True, eps=1e-6)
    kernel_runs[1e-6] = (train(ode, ex, opt, batches, device),
                         list(ex.parameters()))
    ok = step_l <= tol and step_g <= tol
    for eps, (lk, pk) in kernel_runs.items():
        ode, ex, opt = build_trainer(device, state0, True, off, eps=eps)
        lg, pg = train(ode, ex, opt, batches, device), list(ex.parameters())
        ok = runs_agree("generic loop through K1", eps, (lk, pk), (lg, pg),
                        tol) and ok
    if not ok:
        raise AssertionError("kernel path and generic path disagree")
    return kernel_runs


def runs_agree(label, eps, got, ref, tol):
    """Phase 4(a)'s form for two free-running runs (losses, params): the
    losses within ``tol`` relative; the params within ``tol`` in max abs at
    Adam eps 1e-8 and norm-wise relative at eps 1e-6. Logs, returns ok."""
    (lk, pk), (lg, pg) = got, ref
    lk, lg = lk.double().cpu(), lg.double().cpu()
    lrel = float(((lk - lg).abs() / lg.abs()).max())
    pabs = max(abs_err(a, b) for a, b in zip(pk, pg))
    prel = norm_rel(pk, pg)
    log(f"[slice]     free-running vs {label}, Adam eps {eps:.0e}: losses "
        f"max rel err {lrel:.3e}; params max abs diff {pabs:.3e}, max rel "
        f"(norm-wise per tensor) {prel:.3e}; gated: losses rel and params "
        f"{'max abs' if eps == 1e-8 else 'rel'}, tol {tol:.0e}")
    return lrel <= tol and (pabs <= tol if eps == 1e-8 else prel <= tol)


def phase_slice(device, u, n_long=200, n_plain=50):
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    log(f"[slice] KS data {u.shape}, batch {BATCH}, dt {DT}, lr {LR}")
    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    batches = ks_batches(u, n_long, BATCH, seed=0)
    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_adj": fused_ark_step_adj}
    for w in wrappers.values():
        w.launches = 0

    kernel_runs = phase_paths_agree(device, state0, batches[:4])

    # (b) 200 iterations on the kernel path, timed after a warm-up
    ode_k, ex_k, opt_k = build_trainer(device, state0, fused=True)
    warm = 20
    loss_warm = train(ode_k, ex_k, opt_k, batches[:warm], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = train(ode_k, ex_k, opt_k, batches[warm:], device)
    torch.cuda.synchronize()
    kern_sps = (n_long - warm) / (time.perf_counter() - t0)
    counts = {k: w.launches for k, w in wrappers.items()}
    profile_steps("kernel path", ode_k, ex_k, opt_k, batches[:10], device)
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[slice] (b) {n_long} Adam steps on the kernel path: mean loss "
        f"first 20 {first:.6e}, last 20 {last:.6e}; "
        f"{kern_sps:.1f} steps/s (steps {warm}..{n_long})")
    if not last < first:
        raise AssertionError("training did not reduce the loss")

    # the plain path: nn.Linear model on the generic loop, no kernels
    ode_p, ex_p, opt_p = build_trainer(device, to_linear_state(state0),
                                       fused=False)
    train(ode_p, ex_p, opt_p, batches[:5], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(ode_p, ex_p, opt_p, batches[5:5 + n_plain], device)
    torch.cuda.synchronize()
    plain_sps = n_plain / (time.perf_counter() - t0)
    profile_steps("plain path", ode_p, ex_p, opt_p, batches[:10], device)
    log(f"[slice] plain path (nn.Linear, generic stage loop): "
        f"{plain_sps:.1f} steps/s over {n_plain} steps")
    log(f"[slice] launches over phase 4 (a) + (b): {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    counts["fused_train_loop"] = phase_fused_loop(
        device, state0, batches, kernel_runs, last, kern_sps)
    return counts, kern_sps, plain_sps


def profile_loop(make_loop, ys, tgts, kernel="train_loop_kernel",
                 attempts=2):
    """A traced call of a fresh fused loop (``make_loop()``): its wall time
    per iteration, the device's busy share of it, and the loop kernel's
    device time per iteration. A trace that holds no time for the loop
    kernel (seen once in a process that had run many traced and untraced
    phases before) is taken again; after ``attempts`` such traces the
    kernel's time per iteration comes from CUDA events around an untraced
    call, and the busy share is not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(ys)
    for _ in range(attempts):
        loop = make_loop()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop.run(ys, tgts, LR)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, busy_us = device_kernels(prof.events())
        k_us = sum(e.time_range.elapsed_us() for e in kernels
                   if kernel in e.name)
        if k_us > 0:
            log(f"[profile] fused loop: {n} traced iterations in one call, "
                f"{1e3 * wall / n:.3f} ms/iteration; device busy "
                f"{busy_us * 1e-6 / wall:.3f} of the wall time; {kernel} "
                f"{k_us / n:.1f} us/iteration")
            return
        log(f"[profile] fused loop: the trace holds no time for {kernel} "
            f"({len(kernels)} device events)")
    loop = make_loop()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    loop.run(ys, tgts, LR)
    end.record()
    end.synchronize()
    log(f"[profile] fused loop: CUDA events over an untraced call of {n} "
        f"iterations (its launch preparation included): "
        f"{start.elapsed_time(end) / n:.3f} ms/iteration; busy share not "
        f"measured")


def load_ks_torch():
    """examples/ks_torch.py as a module (its FusedLoop is the gate and the
    state of ``--fused_loop``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(ROOT, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fused_loop(device, state0, batches, kernel_runs, per_step_last,
                     per_step_sps, warm=20, tol=5e-4):
    """Phase 4(c): the fused-loop path (K4 through ks_torch's FusedLoop,
    the gate and state of ``examples/ks_torch.py --fused_loop``) from
    state0 on the same batches. Returns K4's launch count over its 200
    iterations."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

    ks = load_ks_torch()
    as_t = lambda i: torch.tensor(  # noqa: E731
        np.stack([b[i] for b in batches]), dtype=torch.float32,
        device=device)
    ys, tgts = as_t(0), as_t(1)
    n = len(batches)

    def fresh_loop():
        ode, ex, _ = build_trainer(device, state0, fused=True)
        return ex, ks.FusedLoop(ode, ex, BATCH, DT)

    ok = True
    for eps, ref in kernel_runs.items():
        ex, loop = fresh_loop()
        losses = loop.run(ys[:4], tgts[:4], LR, eps=eps)
        loop.copy_to(ex)
        ok = runs_agree("per-step kernel path", eps,
                        (losses, list(ex.parameters())), ref, tol) and ok
    if not ok:
        raise AssertionError("fused loop and per-step kernel path disagree")
    profile_loop(lambda: fresh_loop()[1], ys[:warm], tgts[:warm])

    ex, loop = fresh_loop()
    fused_train_loop.launches = 0
    loss_warm = loop.run(ys[:warm], tgts[:warm], LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = loop.run(ys[warm:], tgts[warm:], LR)
    torch.cuda.synchronize()
    sps = (n - warm) / (time.perf_counter() - t0)
    count = fused_train_loop.launches
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite fused-loop loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    gap = abs(last - per_step_last) / per_step_last
    log(f"[slice] (c) {n} Adam steps on the fused loop: mean loss first 20 "
        f"{first:.6e}, last 20 {last:.6e} ({gap:.3f} from (b)'s "
        f"{per_step_last:.6e}, tol 0.1); {count} launches")
    log(f"[slice] fused loop {sps:.1f} steps/s (steps {warm}..{n}, one "
        f"launch) beside the per-step kernel path's {per_step_sps:.1f} "
        f"steps/s (b), same call")
    if not (last < first and gap <= 0.1):
        raise AssertionError("the fused loop did not train as the per-step "
                             "kernel path does")
    if count <= 0:
        raise AssertionError("fused_train_loop was never launched on the "
                             "fused-loop path")
    return count


# -- phase 5 ------------------------------------------------------------------

def adaptive_step(ode, ex, y0, tgt, device, dt0):
    """(loss, gradient tensors, stats) of one adaptive solve's MSE from
    dt0; leaves the gradients in .grad."""
    import torch

    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    for p in ex.parameters():
        p.grad = None
    pred, st = ode.solve(y0, np.array([0.0, DT]), dt0=dt0)
    loss = torch.mean((pred[-1] - tgt) ** 2)
    loss.backward()
    return loss.detach(), [p.grad.detach().clone()
                           for p in ex.parameters()], st


def train_adaptive(ode, ex, opt, batches, device, dt0=DT):
    """One Adam iteration per batch through the adaptive solver, each solve
    warm-started from the previous one's dt_first (bench.py's protocol),
    the first from dt0; returns (losses, per-iteration stats)."""
    import torch

    losses, stats, dtc = [], [], dt0
    for y0, tgt in batches:
        loss, _, st = adaptive_step(ode, ex, y0, tgt, device, dtc)
        opt.step()
        losses.append(loss)
        stats.append(st)
        dtc = st.dt_first
    return torch.stack(losses), stats


def decisions(stats):
    return [(s.accepted, s.rejected, int(s.completed)) for s in stats]


def phase_adaptive_paths_agree(device, state0, batches, tol=5e-4):
    """Phase 5(a): the per-step adaptive kernel path (K2 with its err
    output, K3) against the generic adaptive path (-pnode_fused_ark_adjoint
    off: the stage loop through K1, kI = J Y), each solve warm-started from
    its own path's previous dt_first.

    - At each Adam step both paths solve from the kernel path's parameters:
      equal (accepted, rejected, completed); dt_first within 1e-4 relative
      (K2's implicit kI is the difference quotient (Y - G)/(dt a_ii), whose
      rounding moves the error estimate by ~1e-5, the generic path's is J Y);
      loss and gradients within ``tol`` relative (gradients norm-wise).
    - Run free at Adam eps 1e-8 and 1e-6: phase 4(a)'s form.

    Returns the generic path's free-running runs {eps: (losses, params,
    stats)}, phase 5(c)'s reference."""
    import torch

    import pnode_tpu_torch as pt

    off = ADAPT_FLAGS + ["-pnode_fused_ark_adjoint", "off"]
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS)
    step_l = step_g = dtf = 0.0
    same = True
    losses, stats_k = [], []
    dt_k = dt_g = DT
    for y0, tgt in batches:
        pt.set_option("pnode_fused_ark_adjoint", "off")
        l_g, g_g, st_g = adaptive_step(ode, ex, y0, tgt, device, dt_g)
        pt.set_option("pnode_fused_ark_adjoint", "auto")
        l_k, g_k, st_k = adaptive_step(ode, ex, y0, tgt, device, dt_k)
        same = same and decisions([st_k]) == decisions([st_g])
        dtf = max(dtf, abs(st_k.dt_first - st_g.dt_first) / st_g.dt_first)
        step_l = max(step_l, float(abs(l_k - l_g) / abs(l_g)))
        step_g = max(step_g, max(float((a - b).norm() / b.norm())
                                 for a, b in zip(g_k, g_g)))
        opt.step()
        losses.append(l_k)
        stats_k.append(st_k)
        dt_k, dt_g = st_k.dt_first, st_g.dt_first
    log(f"[slice] (a) {len(batches)} adaptive Adam steps, per-step kernel "
        f"path vs the generic adaptive path from the same parameters: "
        f"(accepted, rejected, completed) {decisions(stats_k)} "
        f"{'equal' if same else 'DIFFER'}; dt_first max rel {dtf:.3e} (tol "
        f"1e-4); loss max rel {step_l:.3e}, gradients {step_g:.3e} (norm-"
        f"wise; tol {tol:.0e})")
    ok = same and dtf <= 1e-4 and step_l <= tol and step_g <= tol
    kernel_runs = {1e-8: (torch.stack(losses), list(ex.parameters()),
                          stats_k)}
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS, eps=1e-6)
    lk, sk = train_adaptive(ode, ex, opt, batches, device)
    kernel_runs[1e-6] = (lk, list(ex.parameters()), sk)
    generic_runs = {}
    for eps, (lk, pk, sk) in kernel_runs.items():
        ode, ex, opt = build_trainer(device, state0, True, off, eps=eps)
        lg, sg = train_adaptive(ode, ex, opt, batches, device)
        generic_runs[eps] = (lg, list(ex.parameters()), sg)
        ok = runs_agree("generic adaptive path", eps, (lk, pk),
                        generic_runs[eps][:2], tol) and ok
        ok = ok and decisions(sk) == decisions(sg)
    if not ok:
        raise AssertionError("the per-step adaptive kernel path and the "
                             "generic adaptive path disagree")
    return generic_runs


def phase_adaptive_slice(device, u, n_steps=50, warm=5):
    """Phase 5: the adaptive slice at full width (ADAPT_FLAGS): (a) the
    per-step kernel path against the generic path; (b) n_steps iterations
    on the per-step kernel path; (c) the fused adaptive loop (K5). Returns
    the launch counts of K2's err output, K3 and K5 over the phase."""
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd_embedded)

    log(f"[slice] adaptive: {' '.join(ADAPT_FLAGS)}, window [0, {DT}], "
        f"batch {BATCH}, lr {LR}, dt_first warm start")
    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    batches = ks_batches(u, 200, BATCH, seed=1)
    wrappers = {"fused_ark_step_fwd_embedded": fused_ark_step_fwd_embedded,
                "fused_ark_step_adj": fused_ark_step_adj}
    for w in wrappers.values():
        w.launches = 0
    generic_runs = phase_adaptive_paths_agree(device, state0, batches[:4])

    # (b) the per-step adaptive kernel path
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS)
    l_warm, s_warm = train_adaptive(ode, ex, opt, batches[:warm], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_rest, s_rest = train_adaptive(ode, ex, opt, batches[warm:n_steps],
                                    device, s_warm[-1].dt_first)
    torch.cuda.synchronize()
    sps = (n_steps - warm) / (time.perf_counter() - t0)
    counts = {k: w.launches for k, w in wrappers.items()}
    losses = torch.cat([l_warm, l_rest]).cpu().numpy()
    trials = [s.steps for s in s_warm + s_rest]
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    log(f"[slice] (b) {n_steps} adaptive Adam steps on the per-step kernel "
        f"path: mean loss first 10 {first:.6e}, last 10 {last:.6e}; "
        f"{sps:.1f} steps/s (steps {warm}..{n_steps}); trials per iteration "
        f"mean {np.mean(trials):.2f} (min {min(trials)}, max {max(trials)}), "
        f"rejected {sum(s.rejected for s in s_warm + s_rest)}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError("adaptive training did not reduce the loss")
    log(f"[slice] launches over phase 5 (a) + (b): {counts}")
    counts["fused_adaptive_train_loop"] = phase_fused_adaptive_loop(
        device, state0, batches, generic_runs, sps)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the adaptive "
                                 "path")
    return counts


def phase_fused_adaptive_loop(device, state0, batches, generic_runs,
                              per_step_sps, warm=20, tol=5e-4):
    """Phase 5(c): K5 through ks_torch's FusedAdaptiveLoop (the gate and
    state of ``examples/ks_torch.py --fused_loop -ts_adapt_type basic``)
    from state0 on the same batches, against the generic adaptive path of
    (a), which takes kI = J Y as K5 does:

    - per step (phase 4(a)'s per-step form): for 4 iterations, one call of
      one iteration each, the generic path solves from the loop's
      parameters and warm-start dt: equal (accepted, rejected, completed),
      loss within ``tol`` relative, and the gradient (the loop's read from
      its Adam moments, (m' - b1 m) / (1 - b1)) within ``tol`` in relative
      L2 over all parameters, the reference's form for this comparison
      (tests/test_fused_adaptive_loop.py:251-264): per tensor (printed)
      the first layer's gradient, a sum that cancels to ~1e-7 at the KS
      init, moves by ~1e-3 when one preactivation sits at zero and the two
      paths' fp32 stage values put it on either side (measured on the CPU:
      one hidden unit carries 98% of the difference);
    - run free for 4 iterations at Adam eps 1e-8 and 1e-6 against (a)'s
      generic runs: equal decisions, losses within ``tol`` relative; the
      parameters printed in phase 4(a)'s form, not gated (check_adaptive
      says why).

    Then a traced call of 20 iterations; a warm launch of 20 and a timed
    launch of the rest. Returns K5's launch count over those two
    launches."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop)

    ks = load_ks_torch()
    as_t = lambda i: torch.tensor(  # noqa: E731
        np.stack([b[i] for b in batches]), dtype=torch.float32,
        device=device)
    ys, tgts = as_t(0), as_t(1)
    n = len(batches)
    b1 = 0.9

    def fresh_loop():
        ode, ex, _ = build_trainer(device, state0, True, ADAPT_FLAGS)
        return ex, ks.FusedAdaptiveLoop(ode, ex, BATCH, DT)

    def row(st, i):
        return tuple(int(st[k][i]) for k in ("accepted", "rejected",
                                             "completed"))

    # per step: the generic path from the loop's parameters and dt
    _, loop = fresh_loop()
    ode_g, ex_g, _ = build_trainer(device, state0, True,
                                   ADAPT_FLAGS + ["-pnode_fused_ark_adjoint",
                                                  "off"])
    names = [name for name, _ in ex_g.named_parameters()]
    step_l = step_g = 0.0
    step_t = [0.0] * len(names)
    same = True
    for k in range(4):
        loop.copy_to(ex_g)
        l_g, g_g, st_g = adaptive_step(ode_g, ex_g, ys[k], tgts[k], device,
                                       float(loop.dt))
        m_prev = [t.clone() for t in loop.m[0] + loop.m[1]]
        l_k = loop.run(ys[k:k + 1], tgts[k:k + 1], LR)[0]
        g_flat = [(mn - b1 * mp) / (1.0 - b1)
                  for mn, mp in zip(loop.m[0] + loop.m[1], m_prev)]
        nW = len(loop.Ws)
        g_named = loop.spec["rebuild"](g_flat[:nW], g_flat[nW:])
        g_k = [g_named[name] for name in names]
        same = same and row(loop.stats, 0) == decisions([st_g])[0]
        step_l = max(step_l, float(abs(l_k - l_g) / abs(l_g)))
        flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa
        step_g = max(step_g, float((flat(g_k) - flat(g_g)).norm()
                                   / flat(g_g).norm()))
        step_t = [max(e, float((a - b).norm() / b.norm()))
                  for e, a, b in zip(step_t, g_k, g_g)]
    log(f"[slice] (c) fused adaptive loop, 4 iterations one call each, the "
        f"generic adaptive path from the loop's parameters and dt: "
        f"decisions {'equal' if same else 'DIFFERENT'}; max rel err loss "
        f"{step_l:.3e}, gradient {step_g:.3e} (L2 over all parameters; tol "
        f"{tol:.0e}); per tensor, not gated: " + ", ".join(
            f"{n.split('.')[-1]} {e:.1e}" for n, e in zip(names, step_t)))
    ok = same and step_l <= tol and step_g <= tol

    # free-running against (a)'s generic runs
    for eps, (lg, pg, sg) in generic_runs.items():
        ex, loop = fresh_loop()
        losses = loop.run(ys[:4], tgts[:4], LR, eps=eps)
        loop.copy_to(ex)
        rows = [row(loop.stats, i) for i in range(4)]
        lrel = rel_max(losses.cpu(), lg.cpu())
        pk = list(ex.parameters())
        good = rows == decisions(sg) and lrel <= tol
        log(f"[slice] (c) fused adaptive loop, first 4 iterations in one "
            f"call, Adam eps {eps:.0e}: (accepted, rejected, completed) "
            f"{rows} {'equal to' if rows == decisions(sg) else 'DIFFERENT from'}"
            f" the generic path's; losses max rel err {lrel:.3e} (tol "
            f"{tol:.0e}); parameters, not gated: max abs "
            f"{max(abs_err(a, b) for a, b in zip(pk, pg)):.3e}, rel "
            f"(norm-wise) {norm_rel(pk, pg):.3e} {'ok' if good else 'FAIL'}")
        ok = ok and good
    if not ok:
        raise AssertionError("the fused adaptive loop and the generic "
                             "adaptive path disagree")
    profile_loop(lambda: fresh_loop()[1], ys[:warm], tgts[:warm],
                 kernel="adaptive_loop_kernel")

    ex, loop = fresh_loop()
    fused_adaptive_train_loop.launches = 0
    loss_warm = loop.run(ys[:warm], tgts[:warm], LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = loop.run(ys[warm:], tgts[warm:], LR)
    torch.cuda.synchronize()
    sps = (n - warm) / (time.perf_counter() - t0)
    count = fused_adaptive_train_loop.launches
    st = loop.stats
    trials = (st["accepted"] + st["rejected"]).cpu().numpy()
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[slice] (c) {n} adaptive Adam steps on the fused adaptive loop: "
        f"mean loss first 20 {first:.6e}, last 20 {last:.6e}; {count} "
        f"launches; trials per iteration in the timed launch mean "
        f"{trials.mean():.2f} (max {int(trials.max())} of {MAX_TRIALS})")
    log(f"[slice] fused adaptive loop {sps:.1f} steps/s (steps {warm}..{n}, "
        f"one launch) beside the per-step adaptive kernel path's "
        f"{per_step_sps:.1f} steps/s (b), same call")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError("the fused adaptive loop did not train")
    return count


def main():
    import torch

    phase_device()
    phase_build()
    u = ks_data()
    reports = phase_kernels("cuda", u)
    counts, _, _ = phase_slice("cuda", u)
    adaptive_counts = phase_adaptive_slice("cuda", u)
    # K3 runs on both slices' paths: its count is the fixed-step path's
    counts["fused_ark_step_fwd_embedded"] = adaptive_counts[
        "fused_ark_step_fwd_embedded"]
    counts["fused_adaptive_train_loop"] = adaptive_counts[
        "fused_adaptive_train_loop"]
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = reports[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
