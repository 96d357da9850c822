"""Static time-grid construction: fixed steps that land on requested outputs.

Rebuilds the reference's TimeSpan semantics natively: PETSc TS with
``ExactFinalTime.MATCHSTEP`` + ``setTimeSpan`` truncates steps to land exactly
on each requested output time, while ``tspanPostStep``
(reference pnode/petsc_adjoint.py:518-532) applies per-step step-size
lists and counts the steps between outputs for the adjoint replay
(``cur_sol_steps``). Because all of this is data-independent, the whole
schedule is precomputed here on the host as static numpy arrays — the XLA-
friendly formulation (static scan lengths, no host round-trips inside jit).

Landing tolerance is relative to the current step size (PETSc's TimeSpan
matching is ``reltol*h``-based), so log-spaced grids with steps of 1e-5 work;
a requested output the schedule cannot land on raises, mirroring
"TSSolve fails to step on all the specified points"
(reference pnode/petsc_adjoint.py:867-868).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class TimeGrid:
    ts: np.ndarray        # (n_steps,) step start times
    dts: np.ndarray       # (n_steps,) step sizes
    out_idx: np.ndarray   # (n_out,) node index (0..n_steps) of each output
    n_steps: int


def _tol(dt: float) -> float:
    return max(1e-6 * abs(dt), 1e-14)


def build_time_grid(
    t_out: np.ndarray,
    step_size: Union[float, Sequence[float]],
    dtype=np.float64,
    max_steps: int = 1_000_000,
) -> TimeGrid:
    """Build the full fixed-step schedule covering all requested outputs.

    t_out: ascending 1-D array of output times; t_out[0] is the initial time
    (its "output" is y0 itself, as with PETSc TimeSpan).
    step_size: scalar (steps truncate to land on outputs, then resume the
    nominal h — MATCHSTEP semantics) or a per-step list (entry k is used for
    step k; past the end the last entry repeats, matching tspanPostStep).
    """
    t_out = np.asarray(t_out, dtype=np.float64)
    if t_out.ndim != 1 or t_out.size < 1:
        raise ValueError("t must be a 1-D array with at least one element")
    if np.any(np.diff(t_out) <= 0):
        raise ValueError("t must be strictly increasing")

    ts: List[float] = []
    dts: List[float] = []
    out_idx: List[int] = [0]

    is_list = isinstance(step_size, (list, tuple, np.ndarray))
    if is_list:
        sizes = [float(s) for s in np.asarray(step_size).ravel()]
        if not sizes:
            raise ValueError("step_size list must be non-empty")
        if any(s <= 0 for s in sizes):
            raise ValueError("step sizes must be positive")
    else:
        h = float(step_size)
        if h <= 0:
            raise ValueError("step_size must be positive")

    t = float(t_out[0])
    k = 0  # global step counter
    for target in t_out[1:]:
        target = float(target)
        while True:
            dt = (sizes[k] if k < len(sizes) else sizes[-1]) if is_list else h
            if t >= target - _tol(dt):
                break
            if k >= max_steps:
                raise RuntimeError(
                    f"exceeded max_steps={max_steps} building the time grid "
                    "(-ts_max_steps to raise the cap)"
                )
            if is_list:
                if t + dt > target + _tol(dt):
                    raise RuntimeError(
                        "per-step step_size list fails to land on requested "
                        f"output time {target} (reached {t}, next dt {dt}); "
                        "the reference raises 'TSSolve fails to step on all "
                        "the specified points' in this case"
                    )
            else:
                if t + dt > target - _tol(dt):
                    dt = target - t  # truncate to land (MATCHSTEP)
            ts.append(t)
            dts.append(dt)
            t = t + dt
            k += 1
        # snap exactly onto the output node to avoid float drift
        t = target
        out_idx.append(k)

    return TimeGrid(
        ts=np.asarray(ts, dtype=np.float64),
        dts=np.asarray(dts, dtype=np.float64),
        out_idx=np.asarray(out_idx, dtype=np.int64),
        n_steps=len(ts),
    )
