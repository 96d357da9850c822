"""Revolve (optimal binomial) checkpoint schedules: ctypes binding + fallback.

The port's copy of ``pnode_tpu/revolve.py``. The native planner
(``csrc/revolve.cpp``, shared source) generates the action sequence
realizing PETSc TSTrajectory's optimal revolve schedules under a
``-ts_trajectory_max_cps_ram`` budget; ``native.py`` builds it with g++
into ``build/pnode_tpu_torch/`` at first use. The pure-Python planner, with
identical output, is kept as the JAX package keeps it; a failed build warns
and falls back to it, and ``using_native()`` says which one is in use.
Schedules depend only on (n, c).

Action encoding (op, arg):
  0 RESTORE k | 1 ADVANCE k | 2 STORE k | 3 REVERSE k | 4 DROP k
"""

from __future__ import annotations

import ctypes
import warnings
from functools import lru_cache
from math import comb
from typing import List, Tuple

from . import native

RESTORE, ADVANCE, STORE, REVERSE, DROP = range(5)

_LIB = None
_LIB_TRIED = False


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = native.load("revolve")
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native revolve planner unavailable ({e}); using the "
                      "pure-Python planner")
        return None
    lib.revolve_plan.restype = ctypes.c_int64
    lib.revolve_plan.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.revolve_cost.restype = ctypes.c_int64
    lib.revolve_cost.argtypes = [ctypes.c_int64, ctypes.c_int64]
    _LIB = lib
    return _LIB


def _rep(n: int, s: int) -> int:
    r = 0
    while comb(s + r, s) < n:
        r += 1
    return r


@lru_cache(maxsize=None)
def optimal_cost(n: int, c: int) -> int:
    """Minimal forward re-steps T(n, c) (verified vs DP in tests)."""
    if n <= 1:
        return 0
    if c <= 0:
        return n * (n - 1) // 2
    s = c + 1
    r = _rep(n, s)
    return r * n - comb(s + r, s + 1)


def _best_split(n: int, c: int) -> int:
    best_m, best = 1, None
    for m in range(1, n):
        cost = m + optimal_cost(m, c) + optimal_cost(n - m, c - 1)
        if best is None or cost < best:
            best, best_m = cost, m
    return best_m


def _plan_py(b: int, e: int, c: int, out: List[Tuple[int, int]]):
    n = e - b
    if n <= 0:
        return
    if n == 1:
        out.append((RESTORE, b))
        out.append((REVERSE, b))
        return
    if c <= 0:
        for k in range(e - 1, b - 1, -1):
            out.append((RESTORE, b))
            if k > b:
                out.append((ADVANCE, k))
            out.append((REVERSE, k))
        return
    m = _best_split(n, c)
    out.append((RESTORE, b))
    out.append((ADVANCE, b + m))
    out.append((STORE, b + m))
    _plan_py(b + m, e, c - 1, out)
    out.append((DROP, b + m))
    _plan_py(b, b + m, c, out)


def revolve_plan(n: int, c: int) -> List[Tuple[int, int]]:
    """Action list reversing n steps with c spare checkpoint slots."""
    if n <= 0:
        return []
    lib = _load_lib()
    if lib is not None:
        cap = 8 * (optimal_cost(n, c) + 4 * n + 16)
        ops = (ctypes.c_int64 * cap)()
        args = (ctypes.c_int64 * cap)()
        m = lib.revolve_plan(n, c, ops, args, cap)
        if m >= 0:
            return [(int(ops[i]), int(args[i])) for i in range(m)]
    out: List[Tuple[int, int]] = []
    _plan_py(0, n, c, out)
    return out


def compile_actions(n: int, c: int):
    """Compile the (n, c) revolve plan to a unit-action table for the
    scanned executor: rows (op, slot, k) with op 0=restore-slot,
    1=advance-one-step-k, 2=store-to-slot, 3=reverse-step-k, over a
    fixed (c+2)-slot checkpoint buffer (slot 0 pins the initial state).
    The JAX package's scanned executors read it; the port's eager
    executor walks ``revolve_plan`` itself."""
    import numpy as np

    plan = revolve_plan(n, max(1, c))
    actions = []
    slot_of = {0: 0}
    free = list(range(1, max(1, c) + 2))
    cursor_node = 0
    for op, k in plan:
        if op == RESTORE:
            actions.append((0, slot_of[k], 0))
            cursor_node = k
        elif op == ADVANCE:
            for j in range(cursor_node, k):
                actions.append((1, 0, j))
            cursor_node = k
        elif op == STORE:
            s = free.pop(0)
            slot_of[k] = s
            actions.append((2, s, 0))
        elif op == REVERSE:
            actions.append((3, 0, k))
        elif op == DROP:
            free.insert(0, slot_of.pop(k))
    return np.asarray(actions, np.int32).reshape(-1, 3)


def validate_plan(plan, n: int, c: int) -> dict:
    """Simulate the plan; raise on inconsistency. Returns cost/slot stats."""
    stored = {0}
    cursor = None
    reversed_next = n - 1
    advance_cost = 0
    max_live = 1
    for op, k in plan:
        if op == RESTORE:
            assert k in stored, f"RESTORE of unstored node {k}"
            cursor = k
        elif op == ADVANCE:
            assert cursor is not None and k > cursor
            advance_cost += k - cursor
            cursor = k
        elif op == STORE:
            assert cursor == k
            stored.add(k)
            max_live = max(max_live, len(stored))
        elif op == REVERSE:
            assert cursor == k, f"REVERSE at {k} but cursor at {cursor}"
            assert k == reversed_next, (
                f"steps must be reversed in descending order: got {k}, "
                f"expected {reversed_next}"
            )
            reversed_next -= 1
        elif op == DROP:
            stored.discard(k)
        else:
            raise AssertionError(f"unknown op {op}")
    assert reversed_next == -1, "not all steps reversed"
    assert max_live <= c + 1, f"used {max_live} slots > budget {c + 1}"
    return {"advance_cost": advance_cost, "max_live": max_live}


def using_native() -> bool:
    return _load_lib() is not None
