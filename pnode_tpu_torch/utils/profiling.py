"""Profiling hooks: trace capture and device-memory telemetry (the port's
counterpart of ``pnode_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where a
  card is present, CUDA activity around the block, written as a Chrome
  trace to ``<logdir>/trace.json``; ``-pnode_profile <logdir>`` sets the
  directory, and without one the block runs untraced.
- ``annotate(name)``: a named region of the trace
  (``torch.profiler.record_function``).
- ``device_memory_gb()``: peak and live device memory from
  ``torch.cuda.max_memory_allocated`` / ``memory_allocated``; zeros where
  there is no card, as the JAX package reports for the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from ..options import Options


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a profiler trace if a logdir is given or -pnode_profile is
    set; yields the profiler (None when untraced)."""
    if logdir is None:
        logdir = Options().get_string("pnode_profile")
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_gb(device=None) -> dict:
    """{'peak_gb': ..., 'live_gb': ...} of ``device`` (default: the current
    card); 0.0 for both on the CPU."""
    if device is not None and torch.device(device).type != "cuda" or \
            not torch.cuda.is_available():
        return {"peak_gb": 0.0, "live_gb": 0.0}
    return {"peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "live_gb": torch.cuda.memory_allocated(device) / 1e9}


def annotate(name: str):
    """Named profiler region (shows up in the trace timeline)."""
    return torch.profiler.record_function(name)
