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
- ``disk``          (``-ts_trajectory_type disk``, PETSc's default) every
                    step-start state goes to a numpy memmap under
                    ``-ts_trajectory_dirname`` (``disk_host.DiskStore``: in
                    chunks of ``-pnode_disk_chunk`` states, no per-step
                    synchronization); the reverse reads them back, a chunk
                    at a time and last first, with ``aux=None``.

``-pnode_trajectory_dtype bfloat16`` (``TrajectoryConfig.store_dtype``)
compresses what a policy stores across the forward and the reverse, as the
JAX package does for each policy: store_all's and solution_only's states
and stage values (interior outputs then pass through the compressed store,
with a warning; the first and the final output stay exact), CAMS's
checkpoints and the disk rows; a stored state is expanded to the state's
dtype before a stage transpose or a re-step. The fixed grid's checkpoint
and revolve policies keep their states at the state's dtype, as the JAX
package's do.

The solve is one ``torch.autograd.Function``. Its forward runs the step loop
under ``torch.no_grad()`` and keeps what the policy dictates; its backward
runs the stepper's stage-exact ``step_adj`` from the last step to the
first, adding the output cotangents at interior output nodes (the
reference's ``adj_u += grad_output[i-1]`` forcing). Every policy reverses
the steps in the same order with the same inputs, so all of them give the
same gradients, bit for bit where the step is deterministic and nothing is
compressed. Autograd never records a graph through the solver. The
adaptive path (``adaptive.py``) runs the same reverse machinery over its
trial axis, where a rejected trial is the identity (``_Sweep``'s ``live``).

The JAX package also has scanned executors for revolve and CAMS, and the
``-pnode_revolve_executor`` / ``-pnode_cams_executor`` switches between
them; they exist to keep its compiled program flat. The port's eager loop
walks the plan directly, so it has neither (the options are accepted and
ignored).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import cams as cm
from . import revolve as rv
from .misc import tree_add, tree_leaves, tree_map, tree_zeros_like

KINDS = ("store_all", "solution_only", "checkpoint", "revolve", "cams",
         "disk")


@dataclass(frozen=True)
class TrajectoryConfig:
    """Static trajectory policy (from -ts_trajectory_* flags)."""

    kind: str = "store_all"  # one of KINDS
    max_cps: int = 0         # checkpoint slots of checkpoint/revolve/cams
    # storage dtype of what the policy stores ("" = the state's; "bfloat16"
    # or "bf16" halves an fp32 trajectory: -pnode_trajectory_dtype)
    store_dtype: str = ""


class SolveStats(NamedTuple):
    newton_iters: int
    newton_converged: bool


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _round_to(x, dtype: torch.dtype) -> list:
    """fp64 values rounded to ``dtype``, as Python floats (through torch:
    numpy has no bf16)."""
    x = torch.as_tensor(np.asarray(x, np.float64))
    return x.to(dtype).double().tolist()


def storage_dtype(name: str):
    """The torch dtype of ``-pnode_trajectory_dtype`` (None for "")."""
    if not name:
        return None
    dt = getattr(torch, "bfloat16" if name == "bf16" else name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"-pnode_trajectory_dtype {name!r}: a floating "
                         "dtype name (bf16/bfloat16, float16, float32)")
    return dt


class Codec:
    """What a policy stores, compressed to the storage dtype on the way in
    (``put``) and expanded to the state's dtype on the way out (``get``);
    the identity without a storage dtype. None passes through."""

    def __init__(self, store_dtype: str):
        self.dtype = storage_dtype(store_dtype)

    def put(self, x):
        if self.dtype is None or x is None:
            return x
        return tree_map(lambda a: a.to(self.dtype), x)

    def get(self, x, dtype):
        if self.dtype is None or x is None:
            return x
        return tree_map(lambda a: a.to(dtype), x)


def new_disk_store(kind):
    """The disk policy's DiskStore factory: a fresh memmap under
    -ts_trajectory_dirname per forward, in -pnode_disk_chunk rows (None
    for the other policies)."""
    if kind != "disk":
        return None
    from .disk_host import DiskStore, disk_options, new_path

    dirname, chunk = disk_options()
    return lambda: DiskStore(new_path(dirname, "solve"), chunk)


class _Engine:
    """Forward and reverse sweeps of one (stepper, grid, policy)."""

    def __init__(self, stepper, grid, traj: TrajectoryConfig, dtype,
                 disk_store=None):
        self.stepper = stepper
        self.kind = traj.kind
        self.max_cps = max(1, int(traj.max_cps))
        self.codec = Codec(traj.store_dtype)
        self.disk_store = disk_store or new_disk_store(traj.kind)
        self.n_steps = int(grid.n_steps)
        self.out_idx = [int(i) for i in grid.out_idx]
        # step times at the state dtype (the JAX package carries them as
        # arrays of that dtype), as Python floats: no device scalars
        self.ts = _round_to(grid.ts, dtype)
        self.dts = _round_to(grid.dts, dtype)
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
        put = self.codec.put
        y_hist, aux_hist = [], []
        cams_plan, sols, stages, pos = None, {}, {}, 0
        disk = None
        iters, conv = 0, True
        y = y0
        if self.n_steps > 0:
            stp = self.prepare(y0, params)
            want = set(self.out_idx)
            if kind == "disk":  # every step's state and the final one
                disk = self.disk_store().open(self.n_steps + 1, put(y0))
            for k in range(self.n_steps):
                y1, aux, st = stp.step(self.ts[k], self.dts[k], y, params)
                if kind in ("store_all", "solution_only"):
                    y_hist.append(put(y))
                    if kind == "store_all":
                        aux_hist.append(put(aux))
                elif kind == "checkpoint" and k % self.seg_len == 0:
                    y_hist.append(y)
                elif kind == "cams":
                    if cams_plan is None:  # w needs one step's stage values
                        cams_plan = self._cams_plan(y0, params, aux)
                    pos = cams_stores(cams_plan[0], pos, k, y, aux, sols,
                                      stages, put)
                elif kind == "disk":
                    disk.put(k, put(y))
                iters += st.newton_iters
                conv = conv and bool(st.newton_converged)
                y = y1
                if k + 1 in want:
                    outputs[k + 1] = y
            if kind == "cams":
                cams_stores(cams_plan[0], pos, self.n_steps, y, None, sols,
                            stages, put)
            elif kind == "disk":
                disk.put(self.n_steps, put(y))
                disk.finish()
            if (self.codec.dtype is not None
                    and kind in ("store_all", "solution_only")):
                # interior outputs pass through the compressed store, as
                # the JAX package gathers them from it
                for i in outputs:
                    if 0 < i < self.n_steps:
                        outputs[i] = self.codec.get(put(outputs[i]), y.dtype)
        out = torch.stack([outputs[i] for i in self.out_idx])
        if kind == "cams":
            stored = (sols, stages, cams_plan and cams_plan[1])
        elif kind == "disk":
            stored = disk
        else:
            stored = (y_hist, aux_hist)
        return out, SolveStats(iters, conv), stored

    def _cams_plan(self, y0, params, aux):
        """(plan_fwd, plan_rev) of ``cams.cams_plan(n, c, w)``, the stage
        weight w from one step's stage values, memoized per input shape."""
        key = (tuple(y0.shape), y0.dtype,
               tuple((tuple(p.shape), p.dtype) for p in tree_leaves(params)))
        w = self._cams_w.get(key)
        if w is None:
            w = self._cams_w[key] = cams_weight(y0, aux)
        return cm.cams_plan(self.n_steps, self.max_cps, w)

    # -- reverse -----------------------------------------------------------

    def backward(self, y0, params, stored, g_out):
        """Reverse sweep; returns (dL/dy0, dL/dparams)."""
        force = {}
        for j, node in enumerate(self.out_idx):
            g = g_out[j].contiguous()
            force[node] = g if node not in force else force[node] + g
        if self.n_steps == 0:
            return force.get(0, torch.zeros_like(y0)), tree_zeros_like(params)
        lam = force.get(self.n_steps)
        if lam is None:
            lam = torch.zeros_like(y0)
        stp = self.prepare(y0, params)
        sweep = _Sweep(self.ts, self.dts, stp, params, force, lam)
        get = lambda x: self.codec.get(x, y0.dtype)  # noqa: E731
        if self.kind in ("store_all", "solution_only"):
            y_hist, aux_hist = stored
            for k in range(self.n_steps - 1, -1, -1):
                sweep.reverse(k, get(y_hist[k]),
                              get(aux_hist[k]) if aux_hist else None)
        elif self.kind == "checkpoint":
            checkpoint_reverse(sweep, stored[0], self.seg_len, self.n_steps)
        elif self.kind == "revolve":
            revolve_reverse(sweep, y0, self.n_steps, self.max_cps)
        elif self.kind == "cams":
            cams_reverse(sweep, y0, stored, self.codec)
        else:
            disk_reverse(sweep, stored, self.n_steps, get)
        return sweep.lam, sweep.gradient()


def cams_weight(y0, aux):
    """CAMS's stage-set weight in state units, from one step's stage
    values (``cams.stage_weight``)."""
    aux_sz = sum(int(a.numel()) for a in tree_leaves(aux)
                 if isinstance(a, torch.Tensor))
    return cm.stage_weight(aux_sz, int(y0.numel()))


def cams_stores(plan_fwd, pos, k, y, aux, sols, stages, put):
    """The forward plan's actions at node k (STORE: the state; CAPTURE: the
    state and step k's stage values, None where step k is the identity),
    compressed by ``put``; returns the next action's index."""
    while pos < len(plan_fwd) and plan_fwd[pos][1] == k:
        if plan_fwd[pos][0] == cm.STORE:
            sols[k] = put(y)
        else:  # cm.CAPTURE
            stages[k] = (put(y), put(aux))
        pos += 1
    return pos


def checkpoint_reverse(sweep, cps, seg_len, n, get=lambda y: y):
    """Each segment of ``seg_len`` steps, last first: recompute it from its
    start state ``get(cps[s])``, keeping states and stage values, then
    sweep it."""
    for s in range(len(cps) - 1, -1, -1):
        b = s * seg_len
        e = min(b + seg_len, n)
        ys, auxs, y = [], [], get(cps[s])
        for k in range(b, e):
            ys.append(y)
            y, aux = sweep.advance(k, y, keep_aux=True)
            auxs.append(aux)
        for k in range(e - 1, b - 1, -1):
            sweep.reverse(k, ys[k - b], auxs[k - b])


def revolve_reverse(sweep, y0, n, c):
    """Execute ``revolve_plan(n, c)`` action by action."""
    store = {0: y0}
    node, cursor = 0, y0
    for op, k in rv.revolve_plan(n, c):
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


def cams_reverse(sweep, y0, stored, codec):
    """Execute the CAMS plan's reverse actions, compressing what they store
    as the forward did. A checkpoint the forward never reached (the
    adaptive trial axis past its last trial) restores as None: every step
    after it is the identity."""
    sols, stages, plan_rev = dict(stored[0]), dict(stored[1]), stored[2]
    put = codec.put
    get = lambda x: codec.get(x, y0.dtype)  # noqa: E731
    sols.setdefault(0, put(y0))
    node, cursor = 0, y0
    for op, k in plan_rev:
        if op == cm.RESTORE:
            raw = sols[k] if k in sols else stages.get(k, (None,))[0]
            node, cursor = k, get(raw)
        elif op == cm.ADVANCE:
            for j in range(node, k):
                cursor = sweep.advance(j, cursor)
            node = k
        elif op == cm.STORE:
            sols[k] = put(cursor)
        elif op == cm.REVERSE:
            sweep.reverse(k, cursor, None)
        elif op == cm.CAPTURE:
            y1, aux = sweep.advance(k, cursor, keep_aux=True)
            stages[k] = (put(cursor), put(aux))
            node, cursor = k + 1, y1
        elif op == cm.REVERSE_STAGE:
            y_k, aux_k = stages.pop(k)
            sweep.reverse(k, get(y_k), get(aux_k))
        elif op == cm.DROP:
            sols.pop(k, None)


def disk_reverse(sweep, disk, n, get):
    """Read the disk rows back a chunk at a time, last first, and reverse
    each step with ``aux=None``. A chunk without a live step is not read:
    its steps are identities, so only their output cotangents are added."""
    for a, b in reversed(disk.chunks(n)):
        ys = None
        if sweep.live is None or any(sweep.live[a:b]):
            ys = disk.read(a, b)
        for k in range(b - 1, a - 1, -1):
            sweep.reverse(k, None if ys is None else get(ys[k - a]), None)


class _Sweep:
    """The reverse sweep's state: lam and the parameter gradient, over a
    schedule of step times ``ts`` / ``dts``. Where ``live`` is given, step
    k with ``live[k]`` false or past its end (a rejected or unreached
    adaptive trial) is
    the identity: ``advance`` returns its input and ``reverse`` adds the
    output cotangent only."""

    def __init__(self, ts, dts, stp, params, force, lam, live=None):
        self.ts, self.dts, self.live = ts, dts, live
        self.stp, self.params = stp, params
        self.force, self.lam, self.gp = force, lam, None

    def is_live(self, k):
        live = self.live
        return live is None or (k < len(live) and live[k])

    def advance(self, k, y, keep_aux=False):
        """Step k from y, outside the original pass."""
        if not self.is_live(k):
            return (y, None) if keep_aux else y
        y1, aux, _ = self.stp.step(self.ts[k], self.dts[k], y, self.params)
        return (y1, aux) if keep_aux else y1

    def reverse(self, k, y_k, aux_k):
        """lam <- step k's adjoint (+ the output cotangent at node k)."""
        if self.is_live(k):
            lam, gstep = self.stp.step_adj(self.ts[k], self.dts[k], y_k,
                                           self.params, aux_k, self.lam)
            self.lam = lam
            # 0 + g == g exactly: start from the last step's gradient
            self.gp = gstep if self.gp is None else tree_add(self.gp, gstep)
        if k in self.force:
            self.lam = self.lam + self.force[k]

    def gradient(self):
        """The parameter gradient (zeros where no step was reversed)."""
        return tree_zeros_like(self.params) if self.gp is None else self.gp


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
        try:
            with torch.no_grad():
                lam, gp = ctx.engine.backward(y0, params, ctx.stored, g_out)
        finally:
            release(ctx.stored)
            ctx.stored = None
        return (None, None, lam, *tree_leaves(gp))


def release(stored):
    """Remove a disk policy's memmap once its reverse has read it (a disk
    store also removes it when it is garbage-collected unread)."""
    close = getattr(stored, "close", None)
    if close is not None:
        close()


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
    out_idx = np.asarray(grid.out_idx)
    if (engine.codec.dtype is not None
            and traj.kind in ("store_all", "solution_only")
            and np.any((out_idx > 0) & (out_idx < int(grid.n_steps)))):
        warnings.warn(
            "-pnode_trajectory_dtype compression is active while interior "
            "output times are requested: interior outputs pass through the "
            f"compressed ({traj.store_dtype}) trajectory store and lose "
            "precision (the final state stays exact). Drop the compression "
            "flag or request only the endpoint if interior outputs feed a "
            "precision-sensitive loss.", stacklevel=3)

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
