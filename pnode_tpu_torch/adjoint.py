"""Discrete-adjoint driver: forward step loop + hand-written reverse sweep.

Counterpart of ``pnode_tpu/adjoint.py:54-235, 726-905`` for the
``store_all`` and ``solution_only`` trajectory policies (the checkpointed,
revolve, CAMS and disk policies are ROADMAP queue A slice 5):

- ``store_all``     keep the step-start states AND the stage values: the
                    reverse sweep replays with no recomputation.
- ``solution_only`` keep the states only: the reverse sweep recomputes
                    each step's stage values.

The solve is one ``torch.autograd.Function``. Its forward runs the step loop
under ``torch.no_grad()`` and keeps what the policy dictates; its backward
runs the stepper's stage-exact ``step_adj`` from the last step to the
first, adding the output cotangents at interior output nodes (the
reference's ``adj_u += grad_output[i-1]`` forcing). Autograd never records
a graph through the solver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .misc import tree_add, tree_leaves, tree_map, tree_zeros_like

_SLICE5 = "ROADMAP queue A slice 5 (trajectory policies)"


@dataclass(frozen=True)
class TrajectoryConfig:
    """Static trajectory policy (from -ts_trajectory_* flags)."""

    kind: str = "store_all"  # store_all|solution_only (others: slice 5)


class SolveStats(NamedTuple):
    newton_iters: int
    newton_converged: bool


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class _Engine:
    """Forward and reverse sweeps of one (stepper, grid, policy)."""

    def __init__(self, stepper, grid, traj: TrajectoryConfig, dtype):
        self.stepper = stepper
        self.n_steps = int(grid.n_steps)
        self.out_idx = [int(i) for i in grid.out_idx]
        self.store_aux = traj.kind == "store_all"
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
        self.last_stats = None

    def prepare(self, y0, params):
        return self.stepper.prepare(self.t0, y0, params, dt0=self.dt0)

    def forward(self, y0, params, store: bool):
        """Step loop; returns (outputs, stats, (y_hist, aux_hist))."""
        outputs = {0: y0}
        y_hist, aux_hist = [], []
        iters, conv = 0, True
        y = y0
        if self.n_steps > 0:
            stp = self.prepare(y0, params)
            want = set(self.out_idx)
            for k in range(self.n_steps):
                y1, aux, st = stp.step(self.ts[k], self.dts[k], y, params)
                if store:
                    y_hist.append(y)
                    if self.store_aux:
                        aux_hist.append(aux)
                iters += st.newton_iters
                conv = conv and bool(st.newton_converged)
                y = y1
                if k + 1 in want:
                    outputs[k + 1] = y
        out = torch.stack([outputs[i] for i in self.out_idx])
        return out, SolveStats(iters, conv), (y_hist, aux_hist)

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
        y_hist, aux_hist = stored
        gp = None
        for k in range(self.n_steps - 1, -1, -1):
            aux_k = aux_hist[k] if self.store_aux else None
            lam, gstep = stp.step_adj(self.ts[k], self.dts[k], y_hist[k],
                                      params, aux_k, lam)
            if k in force:
                lam = lam + force[k]
            # 0 + g == g exactly: start from the first step's gradient
            gp = gstep if gp is None else tree_add(gp, gstep)
        return lam, gp


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
    if traj.kind not in ("store_all", "solution_only"):
        raise NotImplementedError(
            f"trajectory policy {traj.kind!r} is {_SLICE5}; the port runs "
            "store_all and solution_only")
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
