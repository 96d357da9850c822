"""A kernel of this checkout against the same kernel of another checkout,
timed in turns.

Run on a machine with the card, from the repository root::

    git archive <commit> | tar -x -C build/other   # any other checkout
    python -m pnode_tpu_torch.tools.compare_kernels build/other --kernel k6 k8

The other checkout's ``pnode_tpu_torch`` is loaded as a second package
(its kernels build into that checkout's ``build/``; both builds run at
once).

``--kernel k1`` (the fused MLP, forward and backward): at the KS stack (B 256, 64 -> 104 x4 -> 64) and the Burgers stack
(B 200, 512 -> 576 x4 -> 512), with N(0, 1 / fan_in) weights, N(0, 0.1)
biases and N(0, 1) inputs and cotangents from seed 0, it checks that the
two forwards agree (max |diff| / max |ref| <= 1e-5) and the two dx
norm-wise (5e-3: a ReLU unit within fp32 rounding of 0 may flip between
two correct evaluations), then times each K1 forward and backward in
turns (other, this, this, other): the median of 30 samples of 10
back-to-back calls by CUDA events, and the device time per call, every
kernel of the call summed over a profiler trace of 20 calls (the timing
helpers are ``chip_smoke.py``'s, so it runs from the repository root).

``--kernel k6`` (the SqueezeNext chain forward, ``fused_sqnxt_fwd``),
``--kernel k8`` (its one-layer forward, ``fused_sqnxt_layer_fwd``),
``--kernel k7`` (the chain backward, ``fused_sqnxt_bwd``) and ``--kernel
k9`` (the one-layer backward, ``fused_sqnxt_layer_bwd``; K8 and K9 run all
five layers per evaluation, each on the plain forward's layer input): at
the three ODE stage shapes of SqNxt-23 at B 128 (dim 32 at 32x32, 64 at
16x16, 128 at 8x8), with lecun-normal weights (``ODEDynamics``' own
init), N(1, 0.1) norm scales, N(0, 0.1) norm shifts, ReLU(N(0, 1)) inputs
and N(0, 1) cotangents from seed 0, it checks the two forwards' outputs
(max |diff| / max |ref| <= 1e-5, ``chip_smoke``'s forward tolerance) and
every output of the two backwards norm-wise (5e-3,
``chip_smoke.check_grads``' tolerance: a ReLU pre-activation within fp32
rounding of 0 may flip between two correct evaluations), then times one
evaluation of each in turns as for K1.

``--kernel k2`` (the fused ARK forward step, ``fused_ark_step_fwd``):
at the KS main path (B 256, 64 -> 104 x4 -> 64, ARK3, dt 0.2, J and the
stage inverse of the port's KSFuncIM, KS states), at a ragged B 37 of the
same, and at the Burgers forward (B 200, 512 -> 576 x4 -> 512, J = -2 A
A^T / d, N(0, 1) states), each without and with the embedded error
output, N(0, 1 / fan_in) weights and N(0, 0.1) biases from seed 0. Both
sides are called through their C entry points (the other checkout's
wrapper may refuse the Burgers forward). It checks y1 and Ys (max |diff|
/ max |ref| <= 1e-5) and err (1e-4 of max |err|), times each in turns as
for K1, and then times this checkout's K2 at forced rows per block (1, 2,
4, 8 where they fit) in turns at the KS and Burgers shapes: the readings
that chose the plan's rule (every R must give the same bits).

``--kernel k3`` (the fused ARK reverse step, ``fused_ark_step_adj``): at
the KS main path (B 256, 64 -> 104 x4 -> 64, ARK3, dt 0.2, J and the stage
inverse of the port's KSFuncIM, KS states and the plain forward's stage
values, a covector lam ~ N(0, 1)) and at B 37 of the same, N(0, 1 /
fan_in) weights and N(0, 0.1) biases from seed 0, both sides through their
wrappers. It checks lam_prev (max |diff| / max |ref| <= 1e-4) and dW/db
norm-wise (5e-3: a ReLU unit within fp32 rounding of 0 may flip between two
correct evaluations), times each in turns as for K1 (device time: its step
kernel and its block-order sum of partials), then times this checkout's K3
at forced rows per block (1, 2, 4, 8) in turns at KS B 256, each with the
bytes of its partials (lam_prev must have the same bits at every R).

``--kernel k12`` (the grads-only training step, ``fused_grad_step``): at
the KS shards B_local 256 and 128 (one-step targets from the KS data), as
for k3: loss and gradient (max |diff| / max |ref| <= 1e-4 on the loss,
5e-3 norm-wise on the gradient), times in turns, then this checkout's K12
at forced rows per block at B_local 256 and 128.

``--kernel k4`` (the fused training loop, ``fused_train_loop``): K = 8
iterations from the same N(0, 1 / fan_in) weights (zero biases at KS B
256, N(0, 0.1) at B 37), zero Adam moments, KS minibatches and their
one-step targets, Adam lr 5e-3, eps 1e-6, at KS B 256 and B 37. It holds
this checkout's losses (max relative 1e-4) and final parameters (5e-4
norm-wise, ``chip_smoke.check_loop``'s gate) against the plain version
and prints the other's beside them, times one call of K iterations in
turns as for K1, with the device time of the loop kernel alone per
iteration, then this checkout's K4 at forced rows per block (1, 2, 4, 8)
at B 256.

``--kernel k5`` (the fused adaptive loop, ``fused_adaptive_train_loop``):
at KS B 256 (weights as for k4, rtol = atol = 1e-4, 32 trials, dt0 warmed
by one call of this checkout's kernel from 0.2), K = 8. It holds this
checkout's (accepted, rejected, completed) at every iteration, its
losses (max relative 1e-4) and its final parameters (5e-4 norm-wise, with
``chip_smoke.adaptive_params_gap``'s reference where the plain fp32
version misses) against the plain version, prints the other's beside
them, then times as for k4.

``--kernel k13`` (the shared-memory probe, ``probe_smem``): at the card's
opt-in size, on the probe's own input (one tile per SM), both sides
bitwise 3x, timed in turns, with ``torch.mul(x, 3)``'s device time beside
them.

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


SQNXT_STAGES = (("stage 1", 32, 32), ("stage 2", 64, 16), ("stage 3", 128, 8))
SQNXT_B = 128


def load_other(root: str, module: str):
    """The other checkout's ``<module>`` (e.g. ``ops.fused_mlp``), under
    another package name."""
    pkg = Path(root).resolve() / "pnode_tpu_torch"
    name = "other_pnode_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(name + "." + module)


def device_us(fn, n=20, per_call=None):
    """(device us per call, kernel launches per call) over a trace of ``n``
    calls: every device kernel the calls launched, or, given ``per_call``
    (the launches one call makes), the mean traced launch times that (a
    trace may miss launches)."""
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
    total = sum(e.time_range.elapsed_us() for e in kernels)
    if per_call:
        return (per_call * total / len(kernels) if kernels else float("nan"),
                len(kernels) / n)
    return total / n, len(kernels) / n


def device_by_kernel(fn, n=20):
    """{kernel name: mean device us per launch} over a trace of ``n``
    calls (which launch of a call takes the time)."""
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
    by = {}
    for e in kernels:
        by.setdefault(e.name.split("(")[0][:60], []).append(
            e.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in by.items()}


def time_in_turns(label, calls, result, per_call=None):
    """CUDA events in turns (other, this, this, other) and the device time
    per call of each side (``device_us``)."""
    from chip_smoke import cuda_times_ms, summary

    ms = {side: [] for side in calls}
    for side in ("other", "this", "this", "other"):
        ms[side].append(summary(cuda_times_ms(calls[side]))[0])
    row = {}
    for side, fn in calls.items():
        us, launches = device_us(fn, per_call=per_call)
        row[side] = dict(ms=ms[side], device_us=us,
                         launches_per_call=launches)
        print(f"[compare] {label} {side}: CUDA events {ms[side][0]:.4f} / "
              f"{ms[side][1]:.4f} ms, device {us:.1f} us per call over "
              f"{launches:.2f} launches traced per call")
    result[label] = row


def compare_k1(this, other, result):
    import torch

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
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
            call_args = (x, Ws, bs) if what == "fused_mlp_fwd" else (
                x, g, Ws, bs)
            calls = {side: (lambda fn=getattr(mod, what), a=call_args:
                            fn(*a))
                     for side, mod in (("other", other), ("this", this))}
            time_in_turns(f"{label} {what}", calls, result)


def sqnxt_inputs(dim, H, rng):
    """(x, g, flat, meta) of one stage shape on the card, from ``rng``."""
    import torch

    from ..models.sqnxt import ODEDynamics, _lecun_normal_
    from ..ops import fused_sqnxt as fs

    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    mod = ODEDynamics(dim)
    for conv in mod.convs:
        w = conv.weight
        _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
    meta = fs.make_meta(dim, SQNXT_B, H, H)
    params = {k: v.detach() for k, v in mod.named_parameters()}
    for li in range(5):
        c = params[f"norms.{li}.scale"].shape[0]
        params[f"norms.{li}.scale"] = torch.tensor(
            rng.normal(1.0, 0.1, c), dtype=torch.float32)
        params[f"norms.{li}.bias"] = torch.tensor(
            rng.normal(0.0, 0.1, c), dtype=torch.float32)
    flat = [t.cuda() for t in fs.pack_params(params, meta, torch.float32)]
    N = meta.n_real
    x = torch.tensor(np.maximum(rng.normal(size=(dim, N)), 0.0),
                     dtype=torch.float32, device="cuda")
    g = torch.tensor(rng.normal(size=(dim, N)), dtype=torch.float32,
                     device="cuda")
    return x, g, flat, meta


SQNXT_NAMES = {"k6": "fused_sqnxt_fwd", "k7": "fused_sqnxt_bwd",
               "k8": "fused_sqnxt_layer_fwd", "k9": "fused_sqnxt_layer_bwd"}


def compare_sqnxt(this, other, kernel, result):
    """K6 (``fused_sqnxt_fwd``), K7 (``fused_sqnxt_bwd``), K8
    (``fused_sqnxt_layer_fwd`` over the five layers) or K9
    (``fused_sqnxt_layer_bwd`` over the five layers) of both checkouts at
    the three stage shapes."""
    import torch

    rng = np.random.default_rng(0)
    name = SQNXT_NAMES[kernel]
    sides = (("other", other), ("this", this))
    for label, dim, H in SQNXT_STAGES:
        x, g, flat, meta = sqnxt_inputs(dim, H, rng)
        layer = this._layer
        hs, h = [], x
        for li in range(5):
            hs.append(h)
            h = this.fused_sqnxt_layer_plain(h, layer(flat, li), meta, li)
        gls = [g[:meta.cdims[li + 1]].contiguous() for li in range(5)]
        if kernel == "k6":
            calls = {side: (lambda m=mod: m.fused_sqnxt_fwd(x, flat, meta))
                     for side, mod in sides}
        elif kernel == "k7":
            calls = {side: (lambda m=mod: m.fused_sqnxt_bwd(x, g, flat, meta))
                     for side, mod in sides}
        elif kernel == "k8":
            calls = {side: (lambda m=mod: [
                m.fused_sqnxt_layer_fwd(hs[li], layer(flat, li), meta, li)
                for li in range(5)]) for side, mod in sides}
        else:
            calls = {side: (lambda m=mod: [
                m.fused_sqnxt_layer_bwd(hs[li], gls[li], layer(flat, li),
                                        meta, li) for li in range(5)])
                for side, mod in sides}
        outs = {}
        for side, fn in calls.items():
            r = fn()
            if kernel in ("k6", "k8"):
                outs[side] = r if kernel == "k8" else [r]
                continue
            r = r if kernel == "k9" else [r]
            # (output, is a conv bias); a conv bias feeding a batch-stats
            # norm has a true gradient of 0, so both sides return noise
            outs[side] = [(t, k % 4 == 1) for dh, d in r
                          for t, k in [(dh, 0)] + [(t, k) for k, t in
                                                   enumerate(d)]]
        torch.cuda.synchronize()
        if kernel in ("k6", "k8"):
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(outs["this"], outs["other"]))
            print(f"[compare] {label} {name}: this vs other, max |diff| / "
                  f"max |other| {err:.3e} over {len(outs['this'])} outputs")
            if not err <= 1e-5:
                raise SystemExit(f"{label}: the two {name} disagree")
        else:
            errs = []
            for (a, bias), (b, _) in zip(outs["this"], outs["other"]):
                if bias:
                    continue
                errs.append(float((a - b).double().norm()
                                  / b.double().norm().clamp_min(1e-30)))
            print(f"[compare] {label} {name}: this vs other, worst "
                  f"norm-wise {max(errs):.3e} over {len(errs)} outputs")
            if not max(errs) <= 5e-3:
                raise SystemExit(f"{label}: the two {name} disagree")
        time_in_turns(f"{label} {name}", calls, result)


def k2_call(mod, tab, b_err, dt, y, J, inv, Ws, bs, rows=0):
    """One K2 launch of ``mod`` (a checkout's ops.fused_ark_forward) through
    its C entry point: (y1, Ys) or (y1, err, Ys). ``rows`` forces the rows
    per block where the entry point takes them."""
    import torch

    b = mod._build
    fn = b.library().pnode_ark_fwd
    s, (B, d) = len(tab[2]), y.shape
    dims = [d] + [int(w.shape[1]) for w in Ws]
    y1 = torch.empty_like(y)
    Ys = torch.empty((s, B, d), device=y.device)
    err = None if b_err is None else torch.empty_like(y)
    args = [y.data_ptr(), J.data_ptr(), inv.data_ptr(), y1.data_ptr(),
            Ys.data_ptr(), None if err is None else err.data_ptr(), B, d, s,
            mod.tableau_array(tab),
            None if b_err is None else b.double_array(b_err[0] + b_err[1]),
            dt, -1.0, len(Ws), b.int_array(dims), b.ptr_array(Ws),
            b.ptr_array(bs), 1]
    if len(fn.argtypes) == 20:
        args.append(rows)
    elif rows:
        raise SystemExit("the other checkout's K2 takes no rows per block")
    rc = fn(*args, b.stream_of(y))
    b.check(rc, "K2")
    return (y1, Ys) if err is None else (y1, err, Ys)


def k2_cases():
    """(label, tableau, embedded weights, dt, y, J, inv, Ws, bs) of the K2
    comparisons on the card."""
    import torch

    from chip_smoke import GAMMA, ks_data, ks_operators

    from ..tableaus import get_ark_tableau

    t = get_ark_tableau("3")
    b_err = ([float(x) for x in t.b_im_err], [float(x) for x in t.b_ex_err])
    dt = float(np.float32(0.2))
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    J, inv, tab, _ = ks_operators("cuda")
    u = ks_data()
    cases = []
    for label, B, dims in (("KS B256", 256, STACKS[0][2]),
                           ("KS B37", 37, STACKS[0][2]),
                           ("Burgers B200", 200, STACKS[1][2])):
        d = dims[0]
        Ws = [f32(rng.normal(0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0, 0.1, size=b)) for b in dims[1:]]
        if d == 64:
            y, Jc, invc = f32(u[rng.choice(len(u), B, replace=False)]), J, inv
        else:
            A = rng.normal(size=(d, d))
            J64 = -2.0 * (A @ A.T) / d
            y, Jc = f32(rng.normal(size=(B, d))), f32(J64)
            invc = f32(np.linalg.inv(np.eye(d) - dt * GAMMA * J64))
        for be in (None, b_err):
            cases.append((label + (" err" if be else ""), tab, be, dt, y, Jc,
                          invc, Ws, bs))
    return cases


def compare_k2(this, other, result):
    import torch

    for label, tab, be, dt, y, J, inv, Ws, bs in k2_cases():
        outs = {side: k2_call(mod, tab, be, dt, y, J, inv, Ws, bs)
                for side, mod in (("this", this), ("other", other))}
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(outs["this"], outs["other"])]
        tols = [1e-4 if be and i == 1 else 1e-5 for i in range(len(errs))]
        print(f"[compare] {label} fused_ark_step_fwd: this vs other, max "
              f"|diff| / max |other| {', '.join(f'{e:.3e}' for e in errs)}")
        if any(e > t for e, t in zip(errs, tols)):
            raise SystemExit(f"{label}: the two K2 disagree")
        calls = {side: (lambda m=mod, a=(tab, be, dt, y, J, inv, Ws, bs):
                        k2_call(m, *a))
                 for side, mod in (("other", other), ("this", this))}
        time_in_turns(f"{label} fused_ark_step_fwd", calls, result,
                      per_call=1)
    # this checkout's K2 at forced rows per block, in turns
    from chip_smoke import cuda_times_ms, summary

    for label, tab, be, dt, y, J, inv, Ws, bs in k2_cases():
        if be is not None or label == "KS B37":
            continue
        args = (tab, be, dt, y, J, inv, Ws, bs)
        rows = [r for r in (1, 2, 4, 8) if _fits_rows(this, r, args)]
        ref = k2_call(this, *args, rows=rows[0])
        ms = {r: [] for r in rows}
        for r in rows + rows[::-1]:
            ms[r].append(summary(cuda_times_ms(
                lambda r=r: k2_call(this, *args, rows=r)))[0])
        row = {}
        for r in rows:
            got = k2_call(this, *args, rows=r)
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            us, launches = device_us(
                lambda r=r: k2_call(this, *args, rows=r), per_call=1)
            row[r] = dict(ms=ms[r], device_us=us, bitwise_equal=same)
            print(f"[compare] {label} K2 at {r} rows per block (grid "
                  f"{-(-y.shape[0] // r)}): CUDA events {ms[r][0]:.4f} / "
                  f"{ms[r][1]:.4f} ms, device {us:.1f} us; same bits as "
                  f"{rows[0]} rows: {same}")
            if not same:
                raise SystemExit(f"{label}: K2 at {r} rows gives other bits")
        result[f"{label} rows"] = row


def _fits_rows(mod, rows, args):
    """True when the C entry point takes ``rows`` rows per block here."""
    try:
        k2_call(mod, *args, rows=rows)
    except RuntimeError:
        return False
    return True


def ks_case(B, seed):
    """(tab, dt, J, inv, Ws, bs, y, tgt, lam) at the KS main path's widths:
    KS states y and their one-step targets, N(0, 1 / fan_in) weights, N(0,
    0.1) biases and a covector lam ~ N(0, 1) from ``seed``, on the card."""
    import torch

    from chip_smoke import DT, ks_data, ks_operators

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    J, inv, tab, _ = ks_operators("cuda")
    u = ks_data()
    dims = STACKS[0][2]
    Ws = [f32(rng.normal(0, a ** -0.5, size=(a, b)))
          for a, b in zip(dims, dims[1:])]
    bs = [f32(rng.normal(0, 0.1, size=b)) for b in dims[1:]]
    idx = rng.choice(len(u) - 1, B, replace=False)
    return (tab, float(np.float32(DT)), J, inv, Ws, bs, f32(u[idx]),
            f32(u[idx + 1]), f32(rng.normal(size=(B, dims[0]))))


def _rel(a, b, norm=False):
    a, b = a.double(), b.double()
    if norm:
        return float((a - b).norm() / b.norm().clamp_min(1e-300))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def forced_rows(label, result, calls, pick, bitwise, partial_floats):
    """This checkout's kernel at forced rows per block, in turns: ``calls``
    maps R to a call; ``pick(out)`` is the output compared across R,
    bitwise where ``bitwise`` (K3's lam_prev), else norm-wise (K12's
    gradient, whose sums R regroups; 5e-3 as between checkouts)."""
    import torch

    from chip_smoke import cuda_times_ms, summary

    rows = sorted(calls)
    ref = pick(calls[rows[0]]())
    ms = {r: [] for r in rows}
    for r in rows + rows[::-1]:
        ms[r].append(summary(cuda_times_ms(calls[r]))[0])
    row = {}
    for r in rows:
        out = pick(calls[r]())
        ok = torch.equal(out, ref) if bitwise else _rel(out, ref, True) <= 5e-3
        us, _ = device_us(calls[r], per_call=2)
        row[r] = dict(ms=ms[r], device_us=us, agrees=ok,
                      partial_bytes=4 * partial_floats[r])
        print(f"[compare] {label} at {r} rows per block: CUDA events "
              f"{ms[r][0]:.4f} / {ms[r][1]:.4f} ms, device {us:.1f} us; "
              f"partials {4 * partial_floats[r]} B, written once and read "
              f"back once; {'same bits as' if bitwise else 'agrees with'} "
              f"{rows[0]} rows: {ok}")
        if not ok:
            raise SystemExit(f"{label}: {r} rows disagree with {rows[0]}")
    result[f"{label} rows"] = row


def compare_k3(this, other, result):
    import torch

    from ..ops.fused_ark_forward import fused_ark_step_fwd_plain
    from ..ops.fused_mlp import grad_buffer_size

    for B in (256, 37):
        tab, dt, J, inv, Ws, bs, y, _, lam = ks_case(B, 0)
        Ys = fused_ark_step_fwd_plain(tab, dt, y, J, inv, Ws, bs)[1]
        args = (tab, dt, Ys, lam, J, inv, Ws, bs)
        outs = {side: mod.fused_ark_step_adj(*args)
                for side, mod in (("this", this), ("other", other))}
        torch.cuda.synchronize()
        flat = {k: [v[0], *v[1][0], *v[1][1]] for k, v in outs.items()}
        e_lp = _rel(flat["this"][0], flat["other"][0])
        e_g = max(_rel(a, b, norm=True)
                  for a, b in zip(flat["this"][1:], flat["other"][1:]))
        label = f"KS B{B} fused_ark_step_adj"
        print(f"[compare] {label}: this vs other, lam_prev {e_lp:.3e} (max), "
              f"dW/db {e_g:.3e} (norm-wise)")
        if not (e_lp <= 1e-4 and e_g <= 5e-3):
            raise SystemExit(f"{label}: the two K3 disagree")
        calls = {side: (lambda m=mod: m.fused_ark_step_adj(*args))
                 for side, mod in (("other", other), ("this", this))}
        time_in_turns(label, calls, result, per_call=2)
        for side, fn in calls.items():
            by = device_by_kernel(fn)
            result[label][side]["by_kernel_us"] = by
            print(f"[compare] {label} {side} by kernel: "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in by.items()))
        if B == 256:
            total = grad_buffer_size([64] + [int(w.shape[1]) for w in Ws])
            forced_rows(
                f"KS B{B} K3", result,
                {r: (lambda r=r: this.fused_ark_step_adj(*args, rows=r))
                 for r in (1, 2, 4, 8)},
                lambda out: out[0], True,
                {r: -(-B // r) * total for r in (1, 2, 4, 8)})


def compare_k12(this, other, result):
    import torch

    for B in (256, 128):
        tab, dt, J, inv, Ws, bs, y, tgt, _ = ks_case(B, 1)
        args = {}
        for side, mod in (("this", this), ("other", other)):
            layout = mod.LoopLayout(B, 64, [int(w.shape[1]) for w in Ws])
            args[side] = (layout, tab, dt, y, tgt, J, inv,
                          layout.pack(Ws, bs))
        outs = {side: mod.fused_grad_step(*args[side])
                for side, mod in (("this", this), ("other", other))}
        torch.cuda.synchronize()
        e_l = _rel(outs["this"][0], outs["other"][0])
        e_g = _rel(outs["this"][1], outs["other"][1], norm=True)
        label = f"KS B_local {B} fused_grad_step"
        print(f"[compare] {label}: this vs other, loss {e_l:.3e}, gradient "
              f"{e_g:.3e} (norm-wise)")
        if not (e_l <= 1e-4 and e_g <= 5e-3):
            raise SystemExit(f"{label}: the two K12 disagree")
        calls = {side: (lambda m=mod, a=args[side]: m.fused_grad_step(*a))
                 for side, mod in (("other", other), ("this", this))}
        time_in_turns(label, calls, result, per_call=2)
        for side, fn in calls.items():
            by = device_by_kernel(fn)
            result[label][side]["by_kernel_us"] = by
            print(f"[compare] {label} {side} by kernel: "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in by.items()))
        total = -(-(args["this"][0].total + 1) // 4) * 4  # a block's slice
        forced_rows(
            f"KS B_local {B} K12", result,
            {r: (lambda r=r: this.fused_grad_step(*args["this"], rows=r))
             for r in (1, 2, 4, 8)},
            lambda out: out[1], False,
            {r: -(-B // r) * total for r in (1, 2, 4, 8)})


def compare_k13(this, other, result):
    import torch

    from chip_smoke import device_us_per_call

    lib = this._build.library()
    optin = this._build.int_array([0])
    this._build.check(lib.pnode_smem_optin(optin), "opt-in query")
    n = optin[0]
    x = this.probe_input(n, "cuda")
    for side, mod in (("this", this), ("other", other)):
        if not torch.equal(mod.probe_smem(x, n), 3.0 * x):
            raise SystemExit(f"{side}'s K13 is not 3x at {n} B")
    print(f"[compare] K13 at {n} B x {x.numel()} floats: both bitwise 3x")
    calls = {side: (lambda m=mod: m.probe_smem(x, n))
             for side, mod in (("other", other), ("this", this))}
    time_in_turns(f"K13 at {n} B", calls, result, per_call=1)
    us, _ = device_us_per_call(lambda: torch.mul(x, 3), [""])
    result[f"K13 at {n} B"]["torch.mul"] = dict(device_us=us)
    print(f"[compare] K13 at {n} B torch.mul(x, 3): device {us:.1f} us")


def loop_operands(B, seed, K=8):
    """(tab, dt, J, inv, Ws, bs, y, tgt) at KS widths, y and tgt (K, B,
    64): K minibatches of KS states and their one-step targets."""
    import torch

    from chip_smoke import DT, ks_data, ks_operators

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    J, inv, tab, stp = ks_operators("cuda")
    u = ks_data()
    dims = STACKS[0][2]
    Ws = [f32(rng.normal(0, a ** -0.5, size=(a, b)))
          for a, b in zip(dims, dims[1:])]
    bs = [f32(rng.normal(0, 0.1, size=b) if B != 256 else np.zeros(b))
          for b in dims[1:]]
    idx = rng.integers(0, len(u) - 1, size=(K, B))
    return (tab, float(np.float32(DT)), J, inv, Ws, bs, f32(u[idx]),
            f32(u[idx + 1]), stp)


def loop_turns(label, calls, kernel, K, result):
    """CUDA events in turns (other, this, this, other) per call of K
    iterations, and the device time of ``kernel`` alone per iteration."""
    from chip_smoke import cuda_times_ms, summary

    ms = {side: [] for side in calls}
    for side in ("other", "this", "this", "other"):
        ms[side].append(summary(cuda_times_ms(calls[side], reps=10, warmup=2,
                                              inner=3))[0] / K)
    row = {}
    for side, fn in calls.items():
        by = device_by_kernel(fn, n=5)
        us = sum(v for k, v in by.items() if kernel in k) / K
        row[side] = dict(ms_per_iteration=ms[side],
                         device_us_per_iteration=us, by_kernel_us=by)
        print(f"[compare] {label} {side}: CUDA events {ms[side][0]:.4f} / "
              f"{ms[side][1]:.4f} ms per iteration, device {us:.1f} us per "
              f"iteration ({kernel})")
    gain = (row["other"]["device_us_per_iteration"]
            / row["this"]["device_us_per_iteration"])
    print(f"[compare] {label}: this is {gain:.2f}x faster than the other by "
          "device time")
    result[label] = row


def compare_k4(this, other, result, K=8):
    import torch

    for B in (256, 37):
        tab, dt, J, inv, Ws, bs, y, tgt, _ = loop_operands(B, 0, K)
        z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b)
                                                  for b in bs])

        def call(mod, **kw):
            return mod.fused_train_loop(tab, dt, y, tgt, J, inv, Ws, bs, z, z,
                                        0, lr=5e-3, eps=1e-6, **kw)

        outs = {side: call(mod) for side, mod in (("this", this),
                                                  ("other", other))}
        torch.cuda.synchronize()
        plain = this.fused_train_loop_plain(tab, dt, y, tgt, J, inv, Ws, bs,
                                            z, z, 0, lr=5e-3, eps=1e-6)
        label = f"KS B{B} fused_train_loop K {K}"
        errs = {}
        for side, out in outs.items():
            errs[side] = (_rel(out[4], plain[4]), max(
                _rel(a, b, norm=True) for a, b in zip(out[0] + out[1],
                                                      plain[0] + plain[1])))
            print(f"[compare] {label}: {side} vs the plain version, losses "
                  f"{errs[side][0]:.3e}, final parameters {errs[side][1]:.3e}"
                  " (norm-wise)")
        if not (errs["this"][0] <= 1e-4 and errs["this"][1] <= 5e-4):
            raise SystemExit(f"{label}: this K4 disagrees with its plain "
                             "version")
        loop_turns(label, {side: (lambda m=mod: call(m))
                           for side, mod in (("other", other),
                                             ("this", this))},
                   "train_loop_kernel", K, result)
        if B == 256:
            ref = outs["this"]
            row = {}
            for r in (1, 2, 4, 8):
                if this.train_loop_plan(B, 64, STACKS[0][2][1:], 4,
                                        rows=r) is None:
                    continue
                out = call(this, rows=r)
                e = _rel(out[4], ref[4])
                by = device_by_kernel(lambda r=r: call(this, rows=r), n=5)
                us = sum(v for k, v in by.items()
                         if "train_loop_kernel" in k) / K
                row[r] = dict(device_us_per_iteration=us, losses_rel=e)
                print(f"[compare] {label} at {r} rows per block: device "
                      f"{us:.1f} us per iteration, losses vs the plan's "
                      f"{e:.3e}")
                if e > 1e-4:
                    raise SystemExit(f"{label}: {r} rows disagree")
            result[f"{label} rows"] = row


def compare_k5(this, other, result, K=8):
    import torch

    from chip_smoke import DT, adaptive_params_gap, adaptive_runner

    B = 256
    _, _, _, _, Ws, bs, y, tgt, stp = loop_operands(B, 0, K)
    dt0 = float(adaptive_runner(stp, Ws, bs, y, tgt, DT)(
        this.fused_adaptive_train_loop, 1, 1e-6)[5]["dt_first"][0])
    run = adaptive_runner(stp, Ws, bs, y, tgt, dt0)
    outs = {side: run(mod.fused_adaptive_train_loop, K, 1e-6)
            for side, mod in (("this", this), ("other", other))}
    torch.cuda.synchronize()
    outs["plain"] = run(this.fused_adaptive_train_loop_plain, K, 1e-6)
    rows = {side: [tuple(int(o[5][n][i]) for n in ("accepted", "rejected",
                                                   "completed"))
                   for i in range(K)] for side, o in outs.items()}
    label = f"KS B{B} fused_adaptive_train_loop K {K}"
    print(f"[compare] {label} from dt0 {dt0:.6g}: trials this {rows['this']}"
          f", other {rows['other']}, plain {rows['plain']}")
    for side in ("this", "other"):
        e_l = _rel(outs[side][4], outs["plain"][4])
        gap, line = ((None, "") if side == "other" else adaptive_params_gap(
            run, K, 1e-6, outs[side], outs["plain"], 0, 5e-4))
        print(f"[compare] {label}: {side} vs the plain version, losses "
              f"{e_l:.3e}{line}")
        if side == "this" and (rows["this"] != rows["plain"] or e_l > 1e-4
                               or gap > 5e-4):
            raise SystemExit(f"{label}: this K5 disagrees with its plain "
                             "version")
    loop_turns(label, {side: (lambda m=mod: run(m.fused_adaptive_train_loop,
                                                K, 1e-6))
                       for side, mod in (("other", other), ("this", this))},
               "adaptive_loop_kernel", K, result)


MODULES = {"k1": "ops.fused_mlp", "k2": "ops.fused_ark_forward",
           "k3": "ops.fused_ark_adjoint", "k12": "ops.fused_train_loop",
           "k4": "ops.fused_train_loop", "k5": "ops.fused_adaptive_loop",
           "k13": "tools.probe_smem_limit"}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--kernel", nargs="+", default=["k1"],
                    choices=("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8",
                             "k9", "k12", "k13"),
                    help="one or more kernels, compared in this order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs a CUDA card")
    result = {}
    for kernel in args.kernel:
        module = MODULES.get(kernel, "ops.fused_sqnxt")
        this = importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.{module}")
        other = load_other(args.other, module)
        builds = [threading.Thread(target=m._build.library)
                  for m in (this, other)]
        for t in builds:
            t.start()
        for t in builds:
            t.join()
        if kernel == "k1":
            compare_k1(this, other, result)
        elif kernel == "k2":
            compare_k2(this, other, result)
        elif kernel == "k3":
            compare_k3(this, other, result)
        elif kernel == "k12":
            compare_k12(this, other, result)
        elif kernel == "k4":
            compare_k4(this, other, result)
        elif kernel == "k5":
            compare_k5(this, other, result)
        elif kernel == "k13":
            compare_k13(this, other, result)
        else:
            compare_sqnxt(this, other, kernel, result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
