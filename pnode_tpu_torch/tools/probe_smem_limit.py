"""Probe the card's largest dynamic shared memory per block (K13).

Counterpart of ``tools/probe_vmem_limit.py``, which searched the largest
single-kernel resident set that the TPU's VMEM takes. On Hopper the
resident set that can fail is one block's dynamic shared memory, and every
gate of the port's loop and step kernels assumes its limit:
``MAX_SMEM_BYTES`` (``ops/fused_ark_adjoint.py``; ``kMaxSmemBytes`` in
``csrc/pnode_kernels.cuh``). This probe finds it by launching K13
(``csrc/probe_smem.cu``: out = 3 x through ``bytes`` of dynamic shared
memory per block) up an ascending ladder of sizes until one fails, then
bisecting to 4 bytes. It also prints the card's opt-in attribute and the
co-resident capacities the loop kernels' grids assume::

    python -m pnode_tpu_torch.tools.probe_smem_limit
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build

LADDER = tuple(kb * 1024 for kb in (48, 64, 96, 128, 160, 192, 224, 256))


def probe_smem_plain(x):
    """Plain PyTorch version of K13: 3 x (bitwise what 2x + x gives)."""
    return 3.0 * x


def probe_smem(x, smem_bytes):
    """out = 3 x through ``smem_bytes`` (a multiple of 4) of dynamic shared
    memory per block. CUDA tensors launch K13 or raise (a size over the
    card's limit raises); CPU tensors run ``probe_smem_plain``."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe_smem: x must be contiguous float32")
    if smem_bytes < 4 or smem_bytes % 4:
        raise ValueError(f"probe_smem: {smem_bytes} B is not a positive "
                         "multiple of 4")
    if x.device.type == "cpu":
        return probe_smem_plain(x)
    lib = _build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.pnode_probe_smem(x.data_ptr(), out.data_ptr(), x.numel(),
                                  int(smem_bytes), _build.stream_of(x))
    _build.check(rc, f"probe_smem at {smem_bytes} B")
    probe_smem.launches += 1
    return out


probe_smem.launches = 0


def probe_input(smem_bytes, device):
    """x for a probe of ``smem_bytes``: one tile per SM on a card (2 on the
    CPU) of N(0, 1) floats from seed 0, as (rows, 128)."""
    device = torch.device(device)
    blocks = (torch.cuda.get_device_properties(device).multi_processor_count
              if device.type == "cuda" else 2)
    rows = -(-blocks * (smem_bytes // 4) // 128)
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(rows, 128, generator=gen, device=device)


def try_size(smem_bytes, device="cuda", launch=probe_smem):
    """One probe: prints OK, WRONG RESULT or FAIL as the JAX package's probe
    does, and returns True for OK."""
    x = probe_input(smem_bytes, device)
    try:
        out = launch(x, smem_bytes)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    except RuntimeError as e:
        msg = str(e).split("\n")[0][:140]
        print(f"  dynamic smem {smem_bytes:7d} B: FAIL ({msg})")
        return False
    ok = bool(torch.equal(out, probe_smem_plain(x)))
    print(f"  dynamic smem {smem_bytes:7d} B: "
          f"{'OK' if ok else 'WRONG RESULT'}")
    return ok


def search(try_fn):
    """(largest size that works, smallest that fails or None): up LADDER
    until a size fails, then bisect between the last that worked and it, to
    4 bytes."""
    lo, hi = 0, None
    for size in LADDER:
        if try_fn(size):
            lo = size
        else:
            hi = size
            break
    if hi is None:
        return lo, None
    while hi - lo > 4:
        mid = (lo + hi) // 8 * 4
        if try_fn(mid):
            lo = mid
        else:
            hi = mid
    return lo, hi


def capacities():
    """Co-resident blocks per launch that the loop kernels' grids assume at
    the KS main path (64 -> 104 x4 -> 64, ARK3's 4 stages; K5 at 32
    trials) and the SqueezeNext kernels' (K6-K9)."""
    from ..ops.fused_adaptive_loop import _adaptive_smem_bytes
    from ..ops.fused_train_loop import _loop_smem_bytes

    lib = _build.library()
    ks = [104] * 4 + [64]
    cap = _build.int_array([0])
    out = {}
    for name, fn, smem in (
            ("train_loop (K4)", lib.pnode_train_loop_capacity,
             _loop_smem_bytes(64, ks, 4)),
            ("adaptive_loop (K5)", lib.pnode_adaptive_loop_capacity,
             _adaptive_smem_bytes(64, ks, 4, 32))):
        _build.check(fn(smem, cap), f"{name} occupancy query")
        out[name] = (cap[0], smem)
    # K6-K9 size their shared memory per launch: their plans' grids at the
    # full-width CIFAR shapes (stage 2's chain, stage 1's (3,1) layer)
    from ..ops import fused_sqnxt as fs
    stage2, stage1 = fs.make_meta(64, 128, 16, 16), fs.make_meta(32, 128, 32,
                                                                  32)
    for name, plan, meta, lis in (
            ("sqnxt_fwd (K6), stage 2", fs.fwd_plan, stage2, range(5)),
            ("sqnxt_layer_fwd (K8), stage 1 layer 3", fs.fwd_plan, stage1,
             [3]),
            ("sqnxt_bwd (K7), stage 2", fs.bwd_plan, stage2, range(5)),
            ("sqnxt_layer_bwd (K9), stage 1 layer 3", fs.bwd_plan, stage1,
             [3])):
        out[name] = (plan(meta, lis, torch.device("cuda"))[0], None)
    return out


def main(argv=None):
    """Run the probe on the current card; returns {"largest", "fails_at",
    "optin", "capacities"}. ``argv`` takes no options but --help."""
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_smem_limit needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    lib = _build.library()
    optin = _build.int_array([0])
    with torch.cuda.device(device):
        _build.check(lib.pnode_smem_optin(optin), "opt-in attribute query")
        print(f"device: {torch.cuda.get_device_name(device)}; "
              f"cudaDevAttrMaxSharedMemoryPerBlockOptin {optin[0]} B")
        lo, hi = search(lambda n: try_size(n, device))
        print(f"largest working dynamic shared memory: {lo} B"
              + (f" (fails at {hi} B)" if hi else " (never failed)"))
        caps = capacities()
    for name, (blocks, smem) in caps.items():
        print(f"co-resident blocks, {name}: {blocks}"
              + (f" at {smem} B per block" if smem else ""))
    return {"largest": lo, "fails_at": hi, "optin": optin[0],
            "capacities": caps}


if __name__ == "__main__":
    main()
