"""Trainer helpers, the port's counterparts of ``pnode_tpu/utils``: the
meter, ``Tee`` / ``get_logger`` / ``makedirs`` (``logging.py``), the locking
CSV ``Recorder``, ``MetricsWriter``, the failure checks (``debug.py``),
profiling and device memory (``profiling.py``), pickle checkpoints
(``checkpoint.py``) and ``flat_adam`` (``optim.py``). ``roofline.py`` is
imported as a module."""

from __future__ import annotations

from .checkpoint import load_checkpoint, save_checkpoint
from .debug import SolverDivergedError, assert_converged, dump_state, nan_guard
from .logging import Tee, get_logger, makedirs
from .metrics import MetricsWriter
from .optim import FlatAdam as flat_adam
from .profiling import annotate, device_memory_gb, trace
from .recorder import Recorder


class RunningAverageMeter:
    """Tracks an exponential moving average of a scalar."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = float(val)
        else:
            self.avg = self.avg * self.momentum + float(val) * (1 - self.momentum)
        self.val = float(val)


__all__ = [
    "RunningAverageMeter",
    "Tee",
    "get_logger",
    "makedirs",
    "Recorder",
    "MetricsWriter",
    "SolverDivergedError",
    "assert_converged",
    "dump_state",
    "nan_guard",
    "annotate",
    "device_memory_gb",
    "trace",
    "save_checkpoint",
    "load_checkpoint",
    "flat_adam",
]
