"""CAMS multistage checkpoint schedules: ctypes binding + Python fallback.

The port's copy of ``pnode_tpu/cams.py``. The native planner
(``csrc/cams.cpp``, shared source; ``native.py`` builds it with g++ into
``build/pnode_tpu_torch/`` at first use) computes OPTIMAL checkpoint
schedules for multistage steppers, where besides solution checkpoints (1
unit) the schedule may store a step's full stage set ((y_k, aux_k), w
units) so its adjoint needs no stage recomputation. csrc/cams.cpp's header
documents the cost model and the (n, m, d, g) dynamic program. A failed
build warns and falls back to the pure-Python DP; ``using_native()`` says
which one is in use.

Schedule powers the DP exploits:
  - the ORIGINAL forward pass stores checkpoints for free;
  - stage sets can be captured EN PASSANT during any advance (the advance
    computes them anyway) and their y_k doubles as a restore point;
  - a solution checkpoint is dropped at its final restore, freeing its unit
    to fund captures on that last pass.

The C++ library computes cost + decision tables; plan emission lives here
(shared with the pure-Python fallback DP).

Action encoding (op, arg) -- extends revolve.py's:
  0 RESTORE k | 1 ADVANCE k | 2 STORE k | 3 REVERSE k | 4 DROP k
  5 CAPTURE k (execute step k storing (y_k, aux_k); cursor -> k+1)
  6 REVERSE_STAGE k (adjoint from the stage checkpoint; drops it)
A plan is a pair (fwd_stores, reverse_actions): fwd_stores (STORE/CAPTURE,
nondecreasing positions) execute during the original forward solve.
``compile_plan`` turns a plan into the fixed-slot tables of the JAX
package's scanned executor; the port's eager executor walks the plan
itself, and the tables stay for their tests.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from functools import lru_cache
from typing import List, Optional, Tuple

from . import native
from .revolve import ADVANCE, DROP, RESTORE, REVERSE, STORE

CAPTURE = 5
REVERSE_STAGE = 6

_LIB = None
_LIB_TRIED = False

# exact-DP size cap: the O(n^2 m) table solve stays fast up to here; longer
# trajectories get a two-level scheme (uniform top-level solution
# checkpoints, exact CAMS within each segment).
EXACT_N_CAP = 1024

# decision kinds (shared P/F encoding, kind * 2^24 + a)
_PLAIN, _PROMOTE, _SOLSPLIT, _CAPSPLIT, _FINAL = range(5)


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = native.load("cams")
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native CAMS planner unavailable ({e}); using the "
                      "pure-Python DP")
        return None
    lib.cams_solve.restype = ctypes.c_int64
    lib.cams_solve.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def using_native() -> bool:
    return _load_lib() is not None


# ---------------------------------------------------------------------------
# Decision tables: native (preferred) or pure-Python reference DP
# ---------------------------------------------------------------------------


class _Tables:
    """Decision lookups Pdec/Fdec indexed by (n, m, d, g)."""

    def __init__(self, n, m, w, pdec, fdec, cost):
        self.n, self.m, self.w = n, m, w
        self._pdec, self._fdec = pdec, fdec
        self.cost = cost

    def _i(self, n, m, d, g):
        return ((n * (self.m + 1) + m) * 2 + d) * 2 + g

    def P(self, n, m, d, g) -> Tuple[int, int]:
        v = self._pdec[self._i(n, m, d, g)]
        return v >> 24, v & 0xFFFFFF

    def F(self, n, m, d, g) -> Tuple[int, int]:
        v = self._fdec[self._i(n, m, d, g)]
        return v >> 24, v & 0xFFFFFF


@lru_cache(maxsize=32)
def _solve_tables(n: int, m: int, w: int) -> _Tables:
    lib = _load_lib()
    size = (n + 1) * (m + 1) * 4
    if lib is not None:
        pdec = (ctypes.c_int32 * size)()
        fdec = (ctypes.c_int32 * size)()
        cost = int(lib.cams_solve(n, m, w, pdec, fdec))
        return _Tables(n, m, w, pdec, fdec, cost)
    return _solve_tables_py(n, m, w)


def _solve_tables_py(n: int, m: int, w: int) -> _Tables:
    """Reference DP (mirrors csrc/cams.cpp exactly)."""
    size = (n + 1) * (m + 1) * 4
    P = [0] * size
    F = [0] * size
    pdec = [0] * size
    fdec = [0] * size

    def idx(nn, mm, d, g):
        return ((nn * (m + 1) + mm) * 2 + d) * 2 + g

    for nn in range(1, n + 1):
        for mm in range(m + 1):
            for d in (0, 1):
                for g in (0, 1):
                    i = idx(nn, mm, d, g)
                    if nn == 1:
                        best, dec = 1, 0
                    else:
                        best, dec = nn + d + P[idx(nn - 1, mm, d, g)], 0
                    if d == 1 and mm >= 1:
                        c = P[idx(nn, mm - 1, 0, 1)]
                        if c < best:
                            best, dec = c, _PROMOTE << 24
                    if mm >= 1:
                        for a in range(1, nn):
                            c = (a + P[idx(nn - a, mm - 1, 0, 1)]
                                 + d + P[idx(a, mm, d, g)])
                            if c < best:
                                best, dec = c, (_SOLSPLIT << 24) | a
                    if mm >= w:
                        for a in range(nn):
                            # same-pass continuation: P, no restore offset
                            rc = (P[idx(nn - a - 1, mm - w, 1, 0)]
                                  if nn - a - 1 > 0 else 0)
                            lc = d + P[idx(a, mm, d, g)] if a > 0 else 0
                            c = (a + 1) + rc + lc
                            if c < best:
                                best, dec = c, (_CAPSPLIT << 24) | a
                    if g == 1 and (nn - 1) * w <= mm + 1 and nn < best:
                        best, dec = nn, _FINAL << 24
                    P[i], pdec[i] = best, dec

                    fbest, fd = d + P[i], 0
                    if d == 1 and mm >= 1:
                        c = F[idx(nn, mm - 1, 0, 1)]
                        if c < fbest:
                            fbest, fd = c, _PROMOTE << 24
                    if mm >= 1:
                        for a in range(1, nn):
                            c = (F[idx(nn - a, mm - 1, 0, 1)]
                                 + d + P[idx(a, mm, d, g)])
                            if c < fbest:
                                fbest, fd = c, (_SOLSPLIT << 24) | a
                    if mm >= w:
                        for a in range(nn):
                            rc = (F[idx(nn - a - 1, mm - w, 1, 0)]
                                  if nn - a - 1 > 0 else 0)
                            lc = d + P[idx(a, mm, d, g)] if a > 0 else 0
                            c = rc + lc
                            if c < fbest:
                                fbest, fd = c, (_CAPSPLIT << 24) | a
                    if nn * w <= mm + g and fbest > 0:
                        fbest, fd = 0, _FINAL << 24
                    F[i], fdec[i] = fbest, fd
    return _Tables(n, m, w, pdec, fdec, F[idx(n, m, 0, 0)])


def stage_weight(aux_sz: int, state_sz: int) -> int:
    """Memory weight of a stage checkpoint in state units: 1 (the solution)
    + ceil(aux units / state units), floored at 1 aux unit.

    This is THE convention both executors budget -ts_trajectory_max_cps_ram
    against (the fixed grid's executor in adjoint.py, and the adaptive
    path's trial axis) — keep it single-source so the two planners can
    never drift apart on how much memory a stage set costs."""
    return 1 + max(1, math.ceil(aux_sz / max(1, state_sz)))


def optimal_cost(n: int, m: int, w: int) -> int:
    """Minimal recompute cost (forward-step evals after the original pass)."""
    if n <= 0:
        return 0
    m, w = max(0, int(m)), max(1, int(w))
    if min(m, n * w) != m:
        m = n * w  # saturated budget: full capture
    if n > EXACT_N_CAP:
        fwd, rev = cams_plan(n, m, w)
        return validate_plan(fwd, rev, n, m, w)["cost"]
    return _solve_tables(n, m, w).cost


# ---------------------------------------------------------------------------
# Plan emission from decision tables
# ---------------------------------------------------------------------------


class _Emitter:
    def __init__(self, tabs: _Tables, base: int = 0):
        self.T = tabs
        self.base = base  # global node offset (two-level segments)
        self.fwd: List[Tuple[int, int]] = []
        self.rev: List[Tuple[int, int]] = []

    # -- paid pass ----------------------------------------------------------

    def emit_R(self, b, e, m, d, g, anchor) -> bool:
        """Launch a paid pass: RESTORE anchor, advance to b, run P.
        Returns True if the anchor was consumed (dropped) by a descendant."""
        if e - b <= 0:
            return False
        self.rev.append((RESTORE, anchor))
        if b > anchor:
            self.rev.append((ADVANCE, b))
        return self.emit_P(b, e, m, d, g, anchor)

    def emit_P(self, b, e, m, d, g, anchor) -> bool:
        """Pass in flight, cursor at b."""
        n = e - b
        if n <= 0:
            return False
        kind, a = self.T.P(n, m, d, g)
        if kind == _PLAIN:
            if n == 1:
                self.rev.append((REVERSE, b))
                return False
            if e - 1 > b:
                self.rev.append((ADVANCE, e - 1))
            self.rev.append((REVERSE, e - 1))
            return self.emit_R(b, e - 1, m, d, g, anchor)
        if kind == _PROMOTE:
            self.rev.append((STORE, b))
            consumed = self.emit_P(b, e, m - 1, 0, 1, b)
            if not consumed:
                self.rev.append((DROP, b))
            return False
        if kind == _SOLSPLIT:
            self.rev.append((ADVANCE, b + a))
            self.rev.append((STORE, b + a))
            consumed = self.emit_P(b + a, e, m - 1, 0, 1, b + a)
            if not consumed:
                self.rev.append((DROP, b + a))
            return self.emit_R(b, b + a, m, d, g, anchor)
        if kind == _CAPSPLIT:
            if a > 0:
                self.rev.append((ADVANCE, b + a))
            self.rev.append((CAPTURE, b + a))
            self.emit_P(b + a + 1, e, m - self.T.w, 1, 0, b + a)
            self.rev.append((REVERSE_STAGE, b + a))
            return self.emit_R(b, b + a, m, d, g, anchor)
        if kind == _FINAL:
            # drop the (solution) anchor at its final restore; capture-chain
            # the whole range, recompute only the last step
            self.rev.append((DROP, anchor))
            for k in range(b, e - 1):
                self.rev.append((CAPTURE, k))
            self.rev.append((REVERSE, e - 1))
            for k in range(e - 2, b - 1, -1):
                self.rev.append((REVERSE_STAGE, k))
            return True
        raise AssertionError(f"bad P decision {kind}")

    # -- free (original) pass -----------------------------------------------

    def emit_F(self, b, e, m, d, g, anchor, pending: bool) -> bool:
        """Free pass in flight. ``pending``: this range's anchor is a
        solution checkpoint whose STORE has not been appended yet; this
        emitter materializes it unless it chooses full-capture (eliding the
        store is how the g-bonus unit is realized on the free pass)."""
        n = e - b
        if n <= 0:
            if pending:
                self.fwd.append((STORE, anchor))
            return False
        kind, a = self.T.F(n, m, d, g)
        if kind == _FINAL:
            # capture the whole range during the free pass
            for k in range(b, e):
                self.fwd.append((CAPTURE, k))
            for k in range(e - 1, b - 1, -1):
                self.rev.append((REVERSE_STAGE, k))
            return pending  # anchor store elided = consumed
        if pending:
            self.fwd.append((STORE, anchor))
        if kind == _PLAIN:  # use-R: the free pass stores nothing further here
            return self.emit_R(b, e, m, d, g, anchor)
        if kind == _PROMOTE:
            consumed = self.emit_F(b, e, m - 1, 0, 1, b, pending=True)
            if not consumed:
                self.rev.append((DROP, b))
            return False
        if kind == _SOLSPLIT:
            consumed = self.emit_F(b + a, e, m - 1, 0, 1, b + a, pending=True)
            if not consumed:
                self.rev.append((DROP, b + a))
            return self.emit_R(b, b + a, m, d, g, anchor)
        if kind == _CAPSPLIT:
            self.fwd.append((CAPTURE, b + a))
            self.emit_F(b + a + 1, e, m - self.T.w, 1, 0, b + a, pending=False)
            self.rev.append((REVERSE_STAGE, b + a))
            return self.emit_R(b, b + a, m, d, g, anchor)
        raise AssertionError(f"bad F decision {kind}")


def cams_plan(n: int, m: int, w: int):
    """(fwd_stores, reverse_actions) for n steps, m spare units, stage
    weight w."""
    if n <= 0:
        return [], []
    m, w = max(0, int(m)), max(1, int(w))
    if m > n * w:
        m = n * w
    if n > EXACT_N_CAP:
        return _plan_two_level(n, m, w)
    tabs = _solve_tables(n, m, w)
    em = _Emitter(tabs)
    em.emit_F(0, n, m, 0, 0, anchor=0, pending=False)
    return em.fwd, em.rev


def _plan_two_level(n: int, m: int, w: int):
    """Trajectories beyond the exact-DP cap: uniform top-level solution
    checkpoints split [0, n) into segments of <= EXACT_N_CAP steps; exact
    CAMS within each segment (droppable anchors, budget freed as segments
    complete)."""
    n_seg = math.ceil(n / EXACT_N_CAP)
    if m < n_seg - 1:
        raise RuntimeError(
            f"CAMS schedule for n={n} steps needs at least {n_seg - 1} "
            f"checkpoint slots (got max_cps={m}): segments must fit the "
            f"exact-DP cap of {EXACT_N_CAP} steps"
        )
    seg_len = math.ceil(n / n_seg)
    bounds = [min(i * seg_len, n) for i in range(n_seg + 1)]
    fwd: List[Tuple[int, int]] = []
    rev: List[Tuple[int, int]] = []
    # top-level stores; the rightmost segment's free-pass plan follows them
    for b in bounds[1:-1]:
        fwd.append((STORE, b))
    for i in range(n_seg - 1, -1, -1):
        b, e = bounds[i], bounds[i + 1]
        held = i  # solution cps b_1..b_i still stored (b_i = this start)
        spare = m - held
        tabs = _solve_tables(e - b, spare, w)
        em = _Emitter(tabs)
        if i == n_seg - 1:
            # tail of the original pass: free-pass emission; the top-level
            # store at b was already appended (not pending), so g=0
            em.emit_F(b, e, spare, 0, 0, anchor=b, pending=False)
            if i > 0:
                em.rev.append((DROP, b))
        else:
            g = 1 if i > 0 else 0  # interior anchors are droppable sols
            consumed = em.emit_R(b, e, spare, 0, g, anchor=b)
            if i > 0 and not consumed:
                em.rev.append((DROP, b))
        # remap local (n, m) table coordinates: emitters already use global
        # node ids (b, e are global), so just concatenate
        fwd.extend(em.fwd)
        rev.extend(em.rev)
    return fwd, rev


# ---------------------------------------------------------------------------
# Scanned-executor compilation: plan -> slot-addressed unit action table
# ---------------------------------------------------------------------------

# unit-action opcodes of the JAX package's scanned executor
A_RESTORE_SOL = 0    # cursor <- solbuf[slot]
A_RESTORE_STAGE = 1  # cursor <- stagebuf_y[slot]
A_ADVANCE = 2        # cursor <- step(k, cursor)
A_STORE = 3          # solbuf[slot] <- cursor
A_REVERSE = 4        # lam <- step_adj(k, cursor, aux=None, lam) + force[k]
A_CAPTURE = 5        # stagebuf[slot] <- (cursor, aux of step k); cursor <- y1
A_REVERSE_STAGE = 6  # lam <- step_adj(k, stagebuf[slot], lam) + force[k]


def compile_plan(fwd, rev, n: int):
    """Compile a (fwd_stores, reverse_actions) plan into fixed-slot arrays
    for a scanned executor that holds each stepper body once (the JAX
    package's ``adjoint._cams_bwd_scan``; the port's eager executor walks
    the plan and does not use the tables).

    Returns a dict:
      fwd_sol[k]   -- solution slot to write BEFORE step k (dummy = n_sol)
      fwd_stage[k] -- stage slot to write AT step k       (dummy = n_stage)
      actions[L,3] -- (op, slot, k) unit actions for the reverse phase
      n_sol / n_stage -- peak live slot counts (buffers sized +1 for dummy)

    DROP is compile-time only (frees a slot for reuse); ADVANCE is expanded
    to unit steps so every action touches at most one stepper invocation.
    """
    import numpy as _np

    sol_slot = {0: 0}       # node 0 = y0, pre-seeded in slot 0
    stage_slot = {}
    sol_free: List[int] = []
    stage_free: List[int] = []
    sol_next, stage_next = 1, 0

    def alloc(free, nxt):
        if free:
            return free.pop(), nxt
        return nxt, nxt + 1

    fwd_sol = _np.full(max(n, 1), -1, _np.int32)
    fwd_stage = _np.full(max(n, 1), -1, _np.int32)
    for op, k in fwd:
        if op == STORE:
            if k not in sol_slot:
                s, sol_next = alloc(sol_free, sol_next)
                sol_slot[k] = s
            if k < n:
                fwd_sol[k] = sol_slot[k]
        elif op == CAPTURE:
            s, stage_next = alloc(stage_free, stage_next)
            stage_slot[k] = s
            fwd_stage[k] = s
        else:  # pragma: no cover - planner emits only STORE/CAPTURE forward
            raise AssertionError(f"bad forward op {op}")

    actions: List[Tuple[int, int, int]] = []
    cursor = 0
    for op, k in rev:
        if op == RESTORE:
            if k in sol_slot:
                actions.append((A_RESTORE_SOL, sol_slot[k], 0))
            else:
                actions.append((A_RESTORE_STAGE, stage_slot[k], 0))
            cursor = k
        elif op == ADVANCE:
            for j in range(cursor, k):
                actions.append((A_ADVANCE, 0, j))
            cursor = k
        elif op == STORE:
            s, sol_next = alloc(sol_free, sol_next)
            sol_slot[k] = s
            actions.append((A_STORE, s, 0))
        elif op == REVERSE:
            actions.append((A_REVERSE, 0, k))
        elif op == CAPTURE:
            s, stage_next = alloc(stage_free, stage_next)
            stage_slot[k] = s
            actions.append((A_CAPTURE, s, k))
            cursor = k + 1
        elif op == REVERSE_STAGE:
            s = stage_slot.pop(k)
            actions.append((A_REVERSE_STAGE, s, k))
            stage_free.append(s)
        elif op == DROP:
            sol_free.append(sol_slot.pop(k))
        else:  # pragma: no cover
            raise AssertionError(f"unknown op {op}")

    acts = (
        _np.asarray(actions, _np.int32)
        if actions
        else _np.zeros((0, 3), _np.int32)
    )
    # dummy slots absorb the "no store at this step" lanes of the fwd scan
    fwd_sol[fwd_sol < 0] = sol_next
    fwd_stage[fwd_stage < 0] = stage_next
    return {
        "fwd_sol": fwd_sol,
        "fwd_stage": fwd_stage,
        "actions": acts,
        "n_sol": sol_next,
        "n_stage": stage_next,
    }


def validate_plan(fwd, rev, n: int, m: int, w: int) -> dict:
    """Simulate both phases; raise on inconsistency or budget violation.

    Returns {"cost": reverse-phase forward-step evals, "max_units": peak
    memory units}. The original pass's own steps are not counted in cost.
    """
    sols = {0}
    stages = {}
    units = 0
    max_units = 0
    pos = 0
    for op, k in fwd:
        assert k >= pos, f"forward store at {k} behind cursor {pos}"
        if op == STORE:
            assert k not in sols, f"double STORE at {k}"
            sols.add(k)
            units += 1
        elif op == CAPTURE:
            assert k not in stages, f"double CAPTURE at {k}"
            stages[k] = True
            units += w
            pos = k + 1
        else:
            raise AssertionError(f"bad forward op {op}")
        max_units = max(max_units, units)

    cursor = None
    reversed_next = n - 1
    cost = 0
    for op, k in rev:
        if op == RESTORE:
            assert k in sols or k in stages, f"RESTORE of unstored node {k}"
            cursor = k
        elif op == ADVANCE:
            assert cursor is not None and k > cursor, (k, cursor)
            cost += k - cursor
            cursor = k
        elif op == STORE:
            assert cursor == k and k not in sols
            sols.add(k)
            units += 1
            max_units = max(max_units, units)
        elif op == REVERSE:
            assert cursor == k, f"REVERSE at {k}, cursor {cursor}"
            assert k == reversed_next, (k, reversed_next)
            cost += 1  # stage recompute inside step_adj
            reversed_next -= 1
        elif op == CAPTURE:
            assert cursor == k and k not in stages
            stages[k] = True
            units += w
            max_units = max(max_units, units)
            cursor = k + 1
            cost += 1
        elif op == REVERSE_STAGE:
            assert k in stages, f"no stage checkpoint for step {k}"
            assert k == reversed_next, (k, reversed_next)
            del stages[k]
            units -= w
            reversed_next -= 1
        elif op == DROP:
            assert k in sols, f"DROP of unstored node {k}"
            sols.discard(k)
            units -= 1
        else:
            raise AssertionError(f"unknown op {op}")
    assert reversed_next == -1, f"reversal stopped at step {reversed_next}"
    assert max_units <= m, f"peak {max_units} units > budget {m}"
    return {"cost": cost, "max_units": max_units}
