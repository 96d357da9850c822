"""Adaptive step-size control (``-ts_adapt_type basic|pi``) with the
discrete adjoint.

Counterpart of ``pnode_tpu/adaptive.py:64-215, 476-505, 711-772`` for the
``store_all`` and ``solution_only`` trajectory policies (the checkpoint,
revolve, CAMS and disk policies are ROADMAP queue A slice 5): PETSc's
TSAdapt basic controller, i.e. embedded-error step-size adaptation with a
safety factor and clipping, the WRMS error norm against ``-ts_rtol`` /
``-ts_atol``, and MATCHSTEP truncation onto the requested output times.

The JAX package runs the controller as a bounded scan over ``max_steps``
trial steps, with masked no-ops once every output is reached. The port
runs an eager trial loop: the accept decision is read on the host once per
trial, and the loop stops when the last output has landed. Outputs and
stats are the reference's, since a masked slot changes nothing; only
``newton_iters``, which the reference adds on every slot, done or not, gets
the skipped slots' count added without running them.

The solve is one ``torch.autograd.Function`` (the pattern of
``adjoint.py``). Its forward records, per ACCEPTED trial, ``(t, dt_try,
out_slot)`` and the pre-step state (plus the stage set under
``store_all``): a rejected trial reverses as the identity and injects no
cotangent, so walking the accepted trials alone equals the reference's
gated reverse scan over every slot. Its backward walks them last to first
and adds ``g_out[slot]`` to the covector before each step's transpose.
Accepted step sizes are data: no gradient flows to ``dt0``.

Time arithmetic: t, dt and the controller's scalars ride at
``promote_types(y.dtype, float32)``, as numpy scalars of that dtype (the
reference's traced scalars). In fp32, ``t + (t_end - t)`` can miss t_end by
one ulp, which costs an extra sliver trial and changes ``accepted``; Python
doubles would give different counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .adjoint import TrajectoryConfig, _numpy_dtype, _unflatten
from .misc import tree_add, tree_leaves, tree_map, tree_zeros_like

_SLICE5 = "ROADMAP queue A slice 5(b) (the adaptive path's trajectory policies)"


@dataclass(frozen=True)
class AdaptConfig:
    rtol: float = 1e-4
    atol: float = 1e-4
    safety: float = 0.9
    dt_min_factor: float = 0.1   # max shrink per step (-ts_adapt_clip low)
    dt_max_factor: float = 10.0  # max growth per step (-ts_adapt_clip high)
    max_steps: int = 4096        # trial-step bound
    order: int = 5               # the controller exponent is 1/(order+1)
    # "basic": PETSc's elementary controller; "pi": the two-error-history
    # PI controller (Hairer-Wanner II.4)
    controller: str = "basic"
    pi_kI: float = 0.7
    pi_kP: float = 0.4


class AdaptiveStats(NamedTuple):
    steps: int
    accepted: int
    rejected: int
    newton_iters: int
    newton_converged: bool
    completed: bool  # every output reached within max_steps
    # the controller's dt after the last trial: a warm start for the next
    # solve (solve(..., dt0=stats.dt_last))
    dt_last: float
    # dt of the FIRST accepted trial: the warm start for repeated solves of
    # the same window (a training loop), which needs the start-of-window dt
    dt_first: float


def _wrms(err, y0, y1, rtol, atol):
    """sqrt(mean((err / (atol + rtol max(|y0|, |y1|)))^2)), at >= fp32."""
    wdt = torch.promote_types(err.dtype, torch.float32)
    err, y0, y1 = err.to(wdt), y0.to(wdt), y1.to(wdt)
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return torch.sqrt(torch.mean((err / scale) ** 2))


def _gated_adj(stp, params, t_k, dt_k, y_k, aux_k, slot_k, g_out, lam, gp):
    """One reverse step of an accepted trial: inject the slot's output
    cotangent, then transpose the step (rejected trials are not recorded:
    they reverse as the identity). ``gp`` None stands for zero
    gradients."""
    if slot_k >= 0:
        lam = lam + g_out[slot_k].to(lam.dtype)
    lam, gstep = stp.step_adj(float(t_k), float(dt_k), y_k, params, aux_k,
                              lam)
    # 0 + g == g exactly: start from the first reversed step's gradient
    return lam, (gstep if gp is None else tree_add(gp, gstep))


def trial_step_core(stp, params, cfg, touts, n_out, expo, core):
    """One adaptive trial step: MATCHSTEP truncation onto the next output,
    embedded step, WRMS accept test, dt controller, output landing.

    The single source of the controller semantics (the reference's
    ``trial_step_core``). ``touts`` is a numpy array of the time dtype;
    ``core`` = (t, y, dt, out_i, outputs, n_acc, n_rej, nit, conv, eprev,
    rejprev) with t, dt and eprev numpy scalars of that dtype and
    ``outputs`` a list of n_out states (updated in place). Returns
    ``(new_core, (t, dt_try, accept, out_slot), aux)`` with t the pre-step
    time and ``aux`` the step's stage set.
    """
    (t, y, dt, out_i, outputs, n_acc, n_rej, nit, conv, eprev,
     rejprev) = core
    T = touts.dtype.type
    t_end = touts[-1]
    done = out_i >= n_out
    target = touts[min(out_i, n_out - 1)]
    # MATCHSTEP: truncate onto the next requested output
    dt_try = np.maximum(np.minimum(dt, target - t), T(0.0))

    y1, err, aux, st = stp.step_embedded(float(t), float(dt_try), y, params)
    enorm = T(float(_wrms(err, y, y1, cfg.rtol, cfg.atol)))
    accept = (bool(enorm <= 1.0) or bool(dt_try <= T(1e-14) * t_end)) \
        and not done

    e_cur = np.maximum(enorm, T(1e-10))
    if cfg.controller == "pi":
        fac = (T(cfg.safety) * np.power(e_cur, T(-cfg.pi_kI * expo))
               * np.power(eprev, T(cfg.pi_kP * expo)))
    else:
        fac = T(cfg.safety) * np.power(e_cur, T(-expo))
    fac = np.clip(fac, T(cfg.dt_min_factor), T(cfg.dt_max_factor))
    # no growth on the trial right after a rejection (Hairer's DOPRI5 rule,
    # PETSc TSAdapt's post-reject behaviour)
    if rejprev:
        fac = np.minimum(fac, T(1.0))
    dt_next = dt if done else dt * fac
    eprev_new = e_cur if accept else eprev
    rejprev_new = rejprev if done else not accept

    t_new = t + dt_try if accept else t
    y_new = y1 if accept else y
    tol = T(1e-10) * np.maximum(np.abs(target), T(1.0))
    landed = accept and bool(t_new >= target - tol)
    out_slot = out_i if landed else -1
    if landed:
        outputs[out_slot] = y_new
        out_i += 1
    n_acc += int(accept)
    n_rej += int(not accept and not done)
    nit += int(st.newton_iters)
    conv = conv and bool(st.newton_converged)
    new_core = (t_new, y_new, dt_next, out_i, outputs, n_acc, n_rej, nit,
                conv, eprev_new, rejprev_new)
    return new_core, (t, dt_try, accept, out_slot), aux


class _AdaptiveEngine:
    """Forward trial loop and gated reverse sweep of one (stepper, output
    times, controller, policy)."""

    def __init__(self, stepper, t_out, cfg: AdaptConfig, dt0, kind):
        self.stepper = stepper
        self.t_out = np.asarray(t_out, dtype=np.float64)
        self.n_out = len(self.t_out)
        self.cfg = cfg
        self.dt0 = dt0
        self.expo = 1.0 / (cfg.order + 1)
        self.store_aux = kind == "store_all"
        self.last_stats = None

    def _prepared(self, y0, params):
        # the frozen Jacobian of the solve, linearized at t_out[0]; dt0=None
        # because dt varies under the controller: the stage inverses are
        # formed per trial (steppers._fused_reverse_args(dt=...))
        prep = getattr(self.stepper, "prepare", None)
        if prep is None:
            return self.stepper
        return prep(float(self._touts(y0)[0]), y0, params, dt0=None)

    def _touts(self, y0):
        tdtype = _numpy_dtype(torch.promote_types(y0.dtype, torch.float32))
        return np.asarray(self.t_out, tdtype)

    def forward(self, y0, params, dt0, store: bool):
        """The trial loop; returns (outputs, stats, records of the accepted
        trials (t, dt_try, out_slot, y_pre, aux))."""
        stp = self._prepared(y0, params)
        touts = self._touts(y0)
        T = touts.dtype.type
        n_out, max_steps = self.n_out, int(self.cfg.max_steps)
        core = (touts[0], y0, T(float(dt0)), 1, [y0] * n_out, 0, 0, 0, True,
                T(1.0), False)
        recs = []
        dt_first = None
        k = 0
        while k < max_steps and core[3] < n_out:
            y_pre = core[1]
            core, (t_k, dt_k, acc_k, slot_k), aux = trial_step_core(
                stp, params, self.cfg, touts, n_out, self.expo, core)
            k += 1
            if acc_k:
                if dt_first is None:
                    dt_first = dt_k
                if store:
                    recs.append((t_k, dt_k, slot_k, y_pre,
                                 aux if self.store_aux else None))
        (t, y, dt_end, out_i, outputs, n_acc, n_rej, nit, conv, _,
         _) = core
        if k < max_steps:
            # every output landed: the reference runs the remaining slots
            # as masked steps from the landed state, whose Newton stats
            # still count; they are identical, so one evaluation serves all
            per = getattr(stp, "static_newton_iters", lambda: None)()
            if per is None:
                dt_try = np.maximum(np.minimum(dt_end, touts[-1] - t), T(0.0))
                with torch.no_grad():
                    _, _, _, st = stp.step_embedded(float(t), float(dt_try), y,
                                                    params)
                per = int(st.newton_iters)
                conv = conv and bool(st.newton_converged)
            nit += (max_steps - k) * per
        stats = AdaptiveStats(
            steps=n_acc + n_rej, accepted=n_acc, rejected=n_rej,
            newton_iters=nit, newton_converged=conv, completed=out_i >= n_out,
            dt_last=float(dt_end),
            dt_first=float(dt_end if dt_first is None else dt_first))
        return torch.stack(outputs), stats, recs

    def backward(self, y0, params, recs, g_out):
        """Reverse sweep over the accepted trials; returns (dL/dy0,
        dL/dparams)."""
        stp = self._prepared(y0, params)
        lam = torch.zeros_like(y0)
        gp = None
        for t_k, dt_k, slot_k, y_k, aux_k in reversed(recs):
            lam, gp = _gated_adj(stp, params, t_k, dt_k, y_k, aux_k, slot_k,
                                 g_out, lam, gp)
        # the t_out[0] output is y0 itself
        lam = lam + g_out[0].to(lam.dtype)
        return lam, (tree_zeros_like(params) if gp is None else gp)


class _AdaptiveFunction(torch.autograd.Function):
    """outputs = adaptive solve(y0, params); backward = the gated adjoint.
    dt0 is a Python float: the recorded schedule is replayed, not
    re-adapted, so it gets no gradient."""

    @staticmethod
    def forward(ctx, engine, template, dt0, y0, *leaves):
        params = _unflatten(template, leaves)
        with torch.no_grad():
            outputs, stats, recs = engine.forward(y0, params, dt0, store=True)
        engine.last_stats = stats
        ctx.engine, ctx.template, ctx.recs = engine, template, recs
        ctx.save_for_backward(y0, *leaves)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        y0, *leaves = ctx.saved_tensors
        params = _unflatten(ctx.template, leaves)
        with torch.no_grad():
            lam, gp = ctx.engine.backward(y0, params, ctx.recs, g_out)
        ctx.recs = None
        return (None, None, None, lam, *tree_leaves(gp))


def make_adaptive_odeint(stepper, t_out, cfg: AdaptConfig, dt0,
                         with_adjoint: bool = True, traj=None):
    """Build ``solve(y0, params, dt0=None) -> (outputs, stats)`` with
    adaptive stepping.

    ``stepper`` provides ``step_embedded(t, dt, y, params) -> (y1, err,
    aux, stats)``; ``t_out`` is the ascending output-time array (t_out[0]
    the initial time, reported as y0); ``traj`` a TrajectoryConfig (None:
    store_all). ``dt0`` is the controller's initial step, which a call may
    override (a warm start from the previous solve's ``stats.dt_first``).
    """
    if traj is None:
        traj = TrajectoryConfig()
    kind = traj.kind if with_adjoint else "solution_only"
    if kind in ("checkpoint", "revolve", "cams", "disk"):
        raise NotImplementedError(
            f"adaptive trajectory policy {kind!r} is {_SLICE5}; the port's "
            "adaptive path runs store_all and solution_only (the fixed grid "
            "runs every policy)")
    if kind not in ("store_all", "solution_only"):
        raise ValueError(f"unknown trajectory kind {kind!r}")
    engine = _AdaptiveEngine(stepper, t_out, cfg, dt0, kind)

    def solve(y0, params, dt0_arg=None):
        d = float(engine.dt0 if dt0_arg is None else dt0_arg)
        if with_adjoint:
            template = tree_map(lambda _: None, params)
            out = _AdaptiveFunction.apply(engine, template, d, y0,
                                          *tree_leaves(params))
            return out, engine.last_stats
        with torch.no_grad():
            out, stats, _ = engine.forward(y0, params, d, store=False)
        return out, stats

    return solve
