"""Discrete-adjoint driver: forward step loop + hand-written reverse sweep.

Counterpart of ``pnode_tpu/adjoint.py`` on the fixed grid, with the
trajectory policies of PETSc's TSTrajectory (``-ts_trajectory_*``):

- ``store_all``     keep the step-start states AND the stage values: the
                    reverse sweep replays with no recomputation.
- ``solution_only`` keep the states only: the reverse sweep recomputes
                    each step's stage values inside ``step_adj``.
- ``checkpoint``    (``-ts_trajectory_max_cps_ram c``) keep the start state
                    of each of c uniform segments of ``ceil(n / c)`` steps;
                    the reverse recomputes a segment forward, keeping its
                    states and stage values, then sweeps it. Memory O(c +
                    n / c) states; the last segment is simply shorter.
- ``revolve``       (``... -ts_trajectory_schedule revolve``) the forward
                    keeps nothing; the reverse executes the optimal
                    binomial schedule ``revolve.revolve_plan(n, c)`` (at most
                    c + 1 states live), reversing each step with its stages
                    recomputed (``aux=None``).
- ``cams``          (``... -ts_trajectory_schedule cams``) the optimal
                    multistage schedule ``cams.cams_plan(n, c, w)``: the
                    forward keeps solution and stage-set checkpoints (a
                    stage set costs w = ``cams.stage_weight`` state units),
                    and the reverse reverses a step from its stored stages
                    where the plan kept them, with ``aux=None`` elsewhere.

The solve is one ``torch.autograd.Function``. Its forward runs the step loop
under ``torch.no_grad()`` and keeps what the policy dictates; its backward
runs the stepper's stage-exact ``step_adj`` from the last step to the
first, adding the output cotangents at interior output nodes (the
reference's ``adj_u += grad_output[i-1]`` forcing). Every policy reverses
the steps in the same order with the same inputs, so all of them give the
same gradients, bit for bit where the step is deterministic. Autograd never
records a graph through the solver.

The JAX package also has scanned executors for revolve and CAMS, and the
``-pnode_revolve_executor`` / ``-pnode_cams_executor`` switches between
them; they exist to keep its compiled program flat. The port's eager loop
walks the plan directly, so it has neither (the options are accepted and
ignored).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import cams as cm
from . import revolve as rv
from .misc import tree_add, tree_leaves, tree_map, tree_zeros_like

KINDS = ("store_all", "solution_only", "checkpoint", "revolve", "cams")


@dataclass(frozen=True)
class TrajectoryConfig:
    """Static trajectory policy (from -ts_trajectory_* flags)."""

    kind: str = "store_all"  # one of KINDS
    max_cps: int = 0         # checkpoint slots of checkpoint/revolve/cams


class SolveStats(NamedTuple):
    newton_iters: int
    newton_converged: bool


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class _Engine:
    """Forward and reverse sweeps of one (stepper, grid, policy)."""

    def __init__(self, stepper, grid, traj: TrajectoryConfig, dtype):
        self.stepper = stepper
        self.kind = traj.kind
        self.max_cps = max(1, int(traj.max_cps))
        self.n_steps = int(grid.n_steps)
        self.out_idx = [int(i) for i in grid.out_idx]
        # step times at the state dtype (the JAX package carries them as
        # arrays of that dtype), as Python floats: no device scalars
        npdt = _numpy_dtype(dtype)
        self.ts = [float(x) for x in np.asarray(grid.ts, npdt)]
        self.dts = [float(x) for x in np.asarray(grid.dts, npdt)]
        uniform = self.n_steps > 0 and bool(
            np.allclose(grid.dts, grid.dts[0], rtol=1e-12, atol=0.0))
        # t0/dt0 from the static grid: the frozen-Jacobian linearization
        # time and the pre-inverted operator's step size
        self.t0 = float(grid.ts[0]) if self.n_steps > 0 else 0.0
        self.dt0 = float(grid.dts[0]) if uniform else None
        # uniform segments of the checkpoint policy
        self.seg_len = (math.ceil(self.n_steps / self.max_cps)
                        if self.n_steps > 0 else 0)
        # CAMS stage weight per input shape (cams.stage_weight)
        self._cams_w: dict = {}
        self.last_stats = None

    def prepare(self, y0, params):
        return self.stepper.prepare(self.t0, y0, params, dt0=self.dt0)

    # -- forward -----------------------------------------------------------

    def forward(self, y0, params, store: bool):
        """Step loop; returns (outputs, stats, stored): what ``backward``
        needs under the policy (nothing unless ``store``)."""
        outputs = {0: y0}
        kind = self.kind if store else None
        y_hist, aux_hist = [], []
        cams_plan, sols, stages, pos = None, {}, {}, 0
        iters, conv = 0, True
        y = y0
        if self.n_steps > 0:
            stp = self.prepare(y0, params)
            want = set(self.out_idx)
            for k in range(self.n_steps):
                y1, aux, st = stp.step(self.ts[k], self.dts[k], y, params)
                if kind in ("store_all", "solution_only"):
                    y_hist.append(y)
                    if kind == "store_all":
                        aux_hist.append(aux)
                elif kind == "checkpoint" and k % self.seg_len == 0:
                    y_hist.append(y)
                elif kind == "cams":
                    if cams_plan is None:  # w needs one step's stage values
                        cams_plan = self._cams_plan(y0, params, aux)
                    pos = _cams_stores(cams_plan[0], pos, k, y, aux, sols,
                                       stages)
                iters += st.newton_iters
                conv = conv and bool(st.newton_converged)
                y = y1
                if k + 1 in want:
                    outputs[k + 1] = y
            if kind == "cams":
                _cams_stores(cams_plan[0], pos, self.n_steps, y, None, sols,
                             stages)
        out = torch.stack([outputs[i] for i in self.out_idx])
        stored = ((sols, stages, cams_plan and cams_plan[1]) if kind == "cams"
                  else (y_hist, aux_hist))
        return out, SolveStats(iters, conv), stored

    def _cams_plan(self, y0, params, aux):
        """(plan_fwd, plan_rev) of ``cams.cams_plan(n, c, w)``, the stage
        weight w from one step's stage values, memoized per input shape."""
        key = (tuple(y0.shape), y0.dtype,
               tuple((tuple(p.shape), p.dtype) for p in tree_leaves(params)))
        w = self._cams_w.get(key)
        if w is None:
            aux_sz = sum(int(a.numel()) for a in tree_leaves(aux)
                         if isinstance(a, torch.Tensor))
            w = self._cams_w[key] = cm.stage_weight(aux_sz, int(y0.numel()))
        return cm.cams_plan(self.n_steps, self.max_cps, w)

    # -- reverse -----------------------------------------------------------

    def backward(self, y0, params, stored, g_out):
        """Reverse sweep; returns (dL/dy0, dL/dparams)."""
        force = {}
        for j, node in enumerate(self.out_idx):
            force[node] = g_out[j].contiguous()
        if self.n_steps == 0:
            return force.get(0, torch.zeros_like(y0)), tree_zeros_like(params)
        lam = force.get(self.n_steps)
        if lam is None:
            lam = torch.zeros_like(y0)
        stp = self.prepare(y0, params)
        sweep = _Sweep(self, stp, params, force, lam)
        if self.kind in ("store_all", "solution_only"):
            y_hist, aux_hist = stored
            for k in range(self.n_steps - 1, -1, -1):
                sweep.reverse(k, y_hist[k], aux_hist[k] if aux_hist else None)
        elif self.kind == "checkpoint":
            self._checkpoint_reverse(sweep, stored[0])
        elif self.kind == "revolve":
            self._revolve_reverse(sweep, y0)
        else:
            self._cams_reverse(sweep, y0, stored)
        return sweep.lam, sweep.gp

    def _checkpoint_reverse(self, sweep, cps):
        """Each segment, last first: recompute it from its start state,
        keeping states and stage values, then sweep it."""
        for s in range(len(cps) - 1, -1, -1):
            b = s * self.seg_len
            e = min(b + self.seg_len, self.n_steps)
            ys, auxs, y = [], [], cps[s]
            for k in range(b, e):
                ys.append(y)
                y, aux = sweep.advance(k, y, keep_aux=True)
                auxs.append(aux)
            for k in range(e - 1, b - 1, -1):
                sweep.reverse(k, ys[k - b], auxs[k - b])

    def _revolve_reverse(self, sweep, y0):
        """Execute ``revolve_plan(n, c)`` action by action."""
        store = {0: y0}
        node, cursor = 0, y0
        for op, k in rv.revolve_plan(self.n_steps, self.max_cps):
            if op == rv.RESTORE:
                node, cursor = k, store[k]
            elif op == rv.ADVANCE:
                for j in range(node, k):
                    cursor = sweep.advance(j, cursor)
                node = k
            elif op == rv.STORE:
                store[k] = cursor
            elif op == rv.REVERSE:
                sweep.reverse(k, cursor, None)
            elif op == rv.DROP:
                store.pop(k, None)

    def _cams_reverse(self, sweep, y0, stored):
        """Execute the CAMS plan's reverse actions."""
        sols, stages, plan_rev = dict(stored[0]), dict(stored[1]), stored[2]
        sols.setdefault(0, y0)
        node, cursor = 0, y0
        for op, k in plan_rev:
            if op == cm.RESTORE:
                node, cursor = k, sols[k] if k in sols else stages[k][0]
            elif op == cm.ADVANCE:
                for j in range(node, k):
                    cursor = sweep.advance(j, cursor)
                node = k
            elif op == cm.STORE:
                sols[k] = cursor
            elif op == cm.REVERSE:
                sweep.reverse(k, cursor, None)
            elif op == cm.CAPTURE:
                y1, aux = sweep.advance(k, cursor, keep_aux=True)
                stages[k] = (cursor, aux)
                node, cursor = k + 1, y1
            elif op == cm.REVERSE_STAGE:
                y_k, aux_k = stages.pop(k)
                sweep.reverse(k, y_k, aux_k)
            elif op == cm.DROP:
                sols.pop(k, None)


def _cams_stores(plan_fwd, pos, k, y, aux, sols, stages):
    """The forward plan's actions at node k (STORE: the state; CAPTURE: the
    state and step k's stage values); returns the next action's index."""
    while pos < len(plan_fwd) and plan_fwd[pos][1] == k:
        if plan_fwd[pos][0] == cm.STORE:
            sols[k] = y
        else:  # cm.CAPTURE
            stages[k] = (y, aux)
        pos += 1
    return pos


class _Sweep:
    """The reverse sweep's state: lam and the parameter gradient."""

    def __init__(self, engine, stp, params, force, lam):
        self.engine, self.stp, self.params = engine, stp, params
        self.force, self.lam, self.gp = force, lam, None

    def advance(self, k, y, keep_aux=False):
        """Step k from y, outside the original pass."""
        e = self.engine
        y1, aux, _ = self.stp.step(e.ts[k], e.dts[k], y, self.params)
        return (y1, aux) if keep_aux else y1

    def reverse(self, k, y_k, aux_k):
        """lam <- step k's adjoint (+ the output cotangent at node k)."""
        e = self.engine
        lam, gstep = self.stp.step_adj(e.ts[k], e.dts[k], y_k, self.params,
                                       aux_k, self.lam)
        if k in self.force:
            lam = lam + self.force[k]
        self.lam = lam
        # 0 + g == g exactly: start from the last step's gradient
        self.gp = gstep if self.gp is None else tree_add(self.gp, gstep)


class _OdeintFunction(torch.autograd.Function):
    """outputs = solve(y0, params); backward = the hand-written adjoint."""

    @staticmethod
    def forward(ctx, engine, template, y0, *leaves):
        params = _unflatten(template, leaves)
        with torch.no_grad():
            outputs, stats, stored = engine.forward(y0, params, store=True)
        engine.last_stats = stats
        ctx.engine, ctx.template, ctx.stored = engine, template, stored
        ctx.save_for_backward(y0, *leaves)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        y0, *leaves = ctx.saved_tensors
        params = _unflatten(ctx.template, leaves)
        with torch.no_grad():
            lam, gp = ctx.engine.backward(y0, params, ctx.stored, g_out)
        ctx.stored = None
        return (None, None, lam, *tree_leaves(gp))


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def make_odeint(stepper, grid, traj: TrajectoryConfig,
                with_adjoint: bool = True, dtype=torch.float32):
    """Build ``solve(y0, params) -> (outputs, stats)``.

    ``grid`` is a TimeGrid; ``outputs`` stacks the state at each requested
    output time. With ``with_adjoint`` the outputs are differentiable with
    respect to ``y0`` and every tensor in ``params`` through the
    hand-written discrete adjoint; without it, through autograd of the
    step loop (the explicit steppers: reverse mode through a Newton solve
    has no reference, as ``jax.grad`` cannot differentiate the JAX
    package's ``lax.while_loop``).
    """
    if traj.kind not in KINDS:
        raise ValueError(f"trajectory policy {traj.kind!r}: one of {KINDS}")
    engine = _Engine(stepper, grid, traj, dtype)

    def solve(y0, params):
        if with_adjoint:
            template = tree_map(lambda _: None, params)
            out = _OdeintFunction.apply(engine, template, y0,
                                        *tree_leaves(params))
            return out, engine.last_stats
        # no adjoint: the step loop runs under autograd, so the outputs are
        # differentiable through the steps themselves, as jax.grad of the
        # JAX package's solve_noadj is
        out, stats, _ = engine.forward(y0, params, store=False)
        return out, stats

    return solve
