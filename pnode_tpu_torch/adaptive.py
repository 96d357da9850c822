"""Adaptive step-size control (``-ts_adapt_type basic|pi``) with the
discrete adjoint, under every trajectory policy.

Counterpart of ``pnode_tpu/adaptive.py``: PETSc's TSAdapt basic
controller, i.e. embedded-error step-size adaptation with a safety factor
and clipping, the WRMS error norm against ``-ts_rtol`` / ``-ts_atol``, and
MATCHSTEP truncation onto the requested output times.

The JAX package runs the controller as a bounded scan over ``max_steps``
trial slots, with masked no-ops once every output is reached. The port
runs an eager trial loop: the accept decision is read on the host once per
trial, and the loop stops when the last output has landed. Outputs and
stats are the reference's, since a masked slot changes nothing; only
``newton_iters``, which the reference adds on every slot, done or not, gets
the skipped slots' count added without running them.

The solve is one ``torch.autograd.Function`` (the pattern of
``adjoint.py``). Its forward records, per trial k, the scalars ``(t,
dt_try, accepted, out_slot)``, O(trials) and never O(trials x state), and
stores what the trajectory policy keeps, keyed by the trial's index; its
backward runs ``adjoint.py``'s reverse machinery over the trial axis, where
a rejected trial (and a slot past the last one) is the identity: it is
walked past and computes nothing, and the output cotangent ``g_out[slot]``
of an accepted trial that landed is added to the covector before the
trial's transpose. The policies (``TrajectoryConfig``):

- ``store_all`` / ``solution_only``: each accepted trial's pre-step state
  (and stage set under store_all).
- ``checkpoint``: the pre-step state of each segment of ``ceil(max_steps /
  c)`` trial slots the loop reaches; the reverse recomputes a segment,
  keeping states and stage sets, then sweeps it.
- ``revolve``: nothing; the reverse runs ``revolve_plan(n_acc, c)`` over
  the ACCEPTED trials (a fixed grid once the forward has run), where the
  JAX package plans over the ``max_steps`` slots: the same gradients with
  fewer re-steps (``optimal_cost(n_acc, c)``).
- ``cams``: ``cams_plan(max_steps, c, w)`` over the trial slots, fixed
  before the trial count is known (w from the first trial's stage set; c
  defaults to 16 as in the JAX package); a CAPTURE at a rejected slot keeps
  the state only.
- ``disk``: every trial's pre-step state to a memmap of ``max_steps`` rows
  (``disk_host.DiskStore``); the reverse reads chunks last first and skips
  a chunk without an accepted trial.

``-pnode_trajectory_dtype`` compresses what store_all, solution_only,
checkpoint, CAMS and disk keep (revolve keeps nothing), as the JAX package
does. Accepted step sizes are data: no gradient flows to ``dt0``.

Time arithmetic: t, dt and the controller's scalars ride at
``promote_types(y.dtype, float32)``, as numpy scalars of that dtype (the
reference's traced scalars). In fp32, ``t + (t_end - t)`` can miss t_end by
one ulp, which costs an extra sliver trial and changes ``accepted``; Python
doubles would give different counts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import cams as cm
from .adjoint import (
    KINDS, Codec, TrajectoryConfig, _numpy_dtype, _Sweep, _unflatten,
    cams_reverse, cams_stores, cams_weight, checkpoint_reverse,
    disk_reverse, new_disk_store, release, revolve_reverse)
from .misc import tree_leaves, tree_map


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




class Trials(NamedTuple):
    """The forward's record: per trial k the scalars t, dt_try, accepted
    and out_slot (-1 unless the trial landed on an output), and ``store``,
    what the trajectory policy kept, keyed by trial index."""

    t: list
    dt: list
    acc: list
    slot: list
    store: object


class _AdaptiveEngine:
    """Forward trial loop and gated reverse sweep of one (stepper, output
    times, controller, policy)."""

    def __init__(self, stepper, t_out, cfg: AdaptConfig, dt0,
                 traj: TrajectoryConfig, disk_store=None):
        self.stepper = stepper
        self.t_out = np.asarray(t_out, dtype=np.float64)
        self.n_out = len(self.t_out)
        self.cfg = cfg
        self.dt0 = dt0
        self.expo = 1.0 / (cfg.order + 1)
        self.kind = traj.kind
        self.codec = Codec(traj.store_dtype)
        self.max_steps = int(cfg.max_steps)
        self.max_cps = max(1, int(traj.max_cps))
        # checkpoint: uniform segments of the max_steps trial slots; CAMS:
        # its c defaults to 16, as the JAX package's adaptive CAMS does
        self.seg_len = max(1, math.ceil(self.max_steps / self.max_cps))
        self.cams_c = max(1, int(traj.max_cps) or 16)
        self.disk_store = disk_store or new_disk_store(traj.kind)
        self._cams_w: dict = {}
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

    def cams_plan(self, y0, params, aux):
        """``cams.cams_plan(max_steps, c, w)`` over the trial slots, w from
        one trial's stage set (memoized per input shape)."""
        key = (tuple(y0.shape), y0.dtype,
               tuple((tuple(p.shape), p.dtype) for p in tree_leaves(params)))
        w = self._cams_w.get(key)
        if w is None:
            w = self._cams_w[key] = cams_weight(y0, aux)
        return cm.cams_plan(self.max_steps, self.cams_c, w)

    def forward(self, y0, params, dt0, store: bool):
        """The trial loop; returns (outputs, stats, Trials)."""
        stp = self._prepared(y0, params)
        touts = self._touts(y0)
        T = touts.dtype.type
        n_out, max_steps = self.n_out, self.max_steps
        kind = self.kind if store else None
        put = self.codec.put
        core = (touts[0], y0, T(float(dt0)), 1, [y0] * n_out, 0, 0, 0, True,
                T(1.0), False)
        t_r, dt_r, acc_r, slot_r = [], [], [], []
        kept: dict = {}  # store_all / solution_only: k -> (y, aux)
        cps: list = []   # checkpoint: the reached segments' start states
        plan, sols, stages, pos = None, {}, {}, 0  # cams
        disk = (self.disk_store().open(max_steps, put(y0))
                if kind == "disk" else None)
        dt_first = None
        k = 0
        while k < max_steps and core[3] < n_out:
            y_pre = core[1]
            core, (t_k, dt_k, acc_k, slot_k), aux = trial_step_core(
                stp, params, self.cfg, touts, n_out, self.expo, core)
            t_r.append(t_k)
            dt_r.append(dt_k)
            acc_r.append(acc_k)
            slot_r.append(slot_k)
            if acc_k and dt_first is None:
                dt_first = dt_k
            if kind in ("store_all", "solution_only"):
                if acc_k:
                    kept[k] = (put(y_pre),
                               put(aux) if kind == "store_all" else None)
            elif kind == "checkpoint":
                if k % self.seg_len == 0:
                    cps.append(put(y_pre))
            elif kind == "cams":
                if plan is None:  # w needs one trial's stage set
                    plan = self.cams_plan(y0, params, aux)
                pos = cams_stores(plan[0], pos, k, y_pre,
                                  aux if acc_k else None, sols, stages, put)
            elif kind == "disk":
                disk.put(k, put(y_pre))
            k += 1
        if disk is not None:
            disk.finish()
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
        kept_by_kind = {"checkpoint": cps, "disk": disk,
                        "cams": (sols, stages, plan and plan[1])}
        trials = Trials(t_r, dt_r, acc_r, slot_r,
                        kept_by_kind.get(kind, kept))
        return torch.stack(outputs), stats, trials

    def backward(self, y0, params, trials, g_out):
        """Reverse sweep over the trial axis; returns (dL/dy0, dL/dparams).
        The output cotangent of the trial landing on output i sits at the
        node after that trial; the t_out[0] output is y0 itself (node 0)."""
        n = len(trials.t)
        force = {0: g_out[0].to(y0.dtype)}
        for k, s in enumerate(trials.slot):
            if s >= 0:
                force[k + 1] = g_out[s].to(y0.dtype)
        stp = self._prepared(y0, params)
        ts = [float(t) for t in trials.t]
        dts = [float(dt) for dt in trials.dt]
        get = lambda x: self.codec.get(x, y0.dtype)  # noqa: E731
        if self.kind == "revolve":
            # the accepted trials as a fixed grid: node j + 1 follows the
            # j-th accepted trial (cotangents sit at accepted landings only)
            acc = [k for k in range(n) if trials.acc[k]]
            node = {0: 0, **{k + 1: j + 1 for j, k in enumerate(acc)}}
            force = {node[m]: g for m, g in force.items()}
            sweep = _Sweep([ts[k] for k in acc], [dts[k] for k in acc], stp,
                           params, force, _init_lam(force, len(acc), y0))
            if acc:
                revolve_reverse(sweep, y0, len(acc), self.max_cps)
            return sweep.lam, sweep.gradient()
        sweep = _Sweep(ts, dts, stp, params, force, _init_lam(force, n, y0),
                       live=trials.acc)
        kept = trials.store
        if self.kind in ("store_all", "solution_only"):
            for k in range(n - 1, -1, -1):
                y_k, aux_k = kept.get(k, (None, None))
                sweep.reverse(k, get(y_k), get(aux_k))
        elif self.kind == "checkpoint":
            checkpoint_reverse(sweep, kept, self.seg_len, n, get)
        elif self.kind == "cams":
            cams_reverse(sweep, y0, kept, self.codec)
        else:
            disk_reverse(sweep, kept, n, get)
        return sweep.lam, sweep.gradient()


def _init_lam(force, n, y0):
    """The covector entering the last step: the cotangent at node n, taken
    out of ``force`` (CAMS's plan walks the slots past n too)."""
    lam = force.pop(n, None)
    return torch.zeros_like(y0) if lam is None else lam


class _AdaptiveFunction(torch.autograd.Function):
    """outputs = adaptive solve(y0, params); backward = the gated adjoint.
    dt0 is a Python float: the recorded schedule is replayed, not
    re-adapted, so it gets no gradient."""

    @staticmethod
    def forward(ctx, engine, template, dt0, y0, *leaves):
        params = _unflatten(template, leaves)
        with torch.no_grad():
            outputs, stats, trials = engine.forward(y0, params, dt0,
                                                    store=True)
        engine.last_stats = stats
        ctx.engine, ctx.template, ctx.trials = engine, template, trials
        ctx.save_for_backward(y0, *leaves)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        y0, *leaves = ctx.saved_tensors
        params = _unflatten(ctx.template, leaves)
        try:
            with torch.no_grad():
                lam, gp = ctx.engine.backward(y0, params, ctx.trials, g_out)
        finally:
            release(ctx.trials.store)
            ctx.trials = None
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
    ``solve.forward_for_test(y0, params)`` runs the forward alone and
    returns ``(outputs, stats, Trials)``: what the policy keeps.
    """
    if traj is None:
        traj = TrajectoryConfig()
    kind = traj.kind if with_adjoint else "solution_only"
    if kind not in KINDS:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    engine = _AdaptiveEngine(stepper, t_out, cfg, dt0,
                             traj if with_adjoint else TrajectoryConfig(kind))

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

    solve.forward_for_test = lambda y0, params: engine.forward(
        y0, params, float(engine.dt0), store=True)
    return solve
