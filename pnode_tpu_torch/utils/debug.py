"""Failure detection and debug dumps (the port's copy of
``pnode_tpu/utils/debug.py``).

``assert_converged`` reads a solve's ``SolveStats`` on the host and raises
``SolverDivergedError`` where Newton did not converge, dumping the named
tensors to an ``.npz`` first when ``-pnode_dump_on_failure <prefix>`` is
set; ``nan_guard`` is the training loop's NaN/Inf break.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np

from ..options import Options


class SolverDivergedError(RuntimeError):
    pass


def _host(v):
    """A tensor (any device) or array as a numpy array on the host."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if v.dtype.is_floating_point and v.element_size() < 4:
            v = v.float()  # numpy has no bf16
        return v.numpy()
    return np.asarray(v)


def dump_state(path_prefix: str, **arrays) -> str:
    """Save named arrays to ``<prefix>_<unix time>.npz``; returns the
    path."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    path = f"{path_prefix}_{int(time.time())}.npz"
    np.savez_compressed(path, **{k: _host(v) for k, v in arrays.items()})
    return path


def assert_converged(stats, context: str = "",
                     dump: Optional[dict] = None) -> None:
    """Raise (after the optional dump) where ``stats.newton_converged`` is
    false. Reads the flag on the host, a sync on the card."""
    if bool(_host(stats.newton_converged)):
        return
    prefix = Options().get_string("pnode_dump_on_failure")
    msg = f"nonlinear solver failed to converge ({context})"
    if prefix and dump:
        path = dump_state(prefix, **dump)
        msg += f"; state dumped to {path}"
    raise SolverDivergedError(msg)


def nan_guard(value, context: str = "loss") -> float:
    """float(value); raises FloatingPointError on NaN or Inf."""
    v = float(_host(value))
    if math.isnan(v) or math.isinf(v):
        raise FloatingPointError(f"{context} is {v}")
    return v
