"""Roofline accounting on the H100 (the port's counterpart of
``pnode_tpu/utils/roofline.py``).

PyTorch has no counterpart of XLA's cost analysis of a compiled program, so
``roofline`` takes the flops and bytes a unit of work needs, counted from
its shapes (the kernel modules' ``*_cost`` functions), and returns the
fractions of the card's peaks that a measured rate of units reaches.
"""

from __future__ import annotations

from typing import Optional

import torch

# ({operand dtype: peak FLOP/s}, device-memory bytes/s) of the H100 SXM at
# 700 W, dense rates without sparsity (NVIDIA's data sheet): fp32 outside
# the tensor cores, bf16 on them (fp32 accumulation), HBM3. The bf16 rate
# is the least time a bf16 x bf16 product could take on the card, whatever
# units a kernel uses for it.
H100_PEAKS = ({torch.float32: 67e12, torch.bfloat16: 989e12}, 3.35e12)
_PEAKS = {"h100": H100_PEAKS}


def peaks_for(table, dtype=torch.float32) -> tuple:
    """(peak_flops at ``dtype``'s operands, peak_bytes_per_s) from one
    entry of the peaks table."""
    flops, byts = table
    if dtype not in flops:
        raise ValueError(f"no peak for {dtype}: {sorted(map(str, flops))}")
    return flops[dtype], byts


def device_peaks(device=None, dtype=torch.float32) -> Optional[tuple]:
    """(peak_flops at ``dtype``, peak_bytes_per_s) of ``device`` (default:
    card 0) from ``torch.cuda.get_device_name``, or None for an unknown
    device or no card."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, table in _PEAKS.items():
        if key in kind:
            return peaks_for(table, dtype)
    return None


def roofline(flops_per_unit: float, bytes_per_unit: float,
             rate_per_s: float, device=None, dtype=torch.float32) -> dict:
    """{flops_per_unit, hbm_bytes_per_unit, mfu, hbm_frac} for units of
    work done at ``rate_per_s`` on operands of ``dtype``; the fractions are
    None where the peaks are unknown or the flops are zero."""
    out = {"flops_per_unit": float(flops_per_unit),
           "hbm_bytes_per_unit": float(bytes_per_unit),
           "mfu": None, "hbm_frac": None}
    peaks = device_peaks(device, dtype)
    if peaks is not None and flops_per_unit > 0:
        out["mfu"] = flops_per_unit * rate_per_s / peaks[0]
        out["hbm_frac"] = bytes_per_unit * rate_per_s / peaks[1]
    return out
