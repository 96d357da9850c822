"""Explicit RK, theta and ARK-IMEX time steppers with stage-exact
hand-written discrete adjoints.

Counterpart of ``pnode_tpu/steppers.py``. ``ExplicitRK`` is the classical
transposed-RK recursion, one vector-Jacobian product per stage. ``Theta``
is backward Euler (theta 1) and Crank-Nicolson (theta 1/2) with an
optional, possibly singular, mass matrix (index-1 DAEs): the one-stage
residual ``R(z) = M(z - y) - h[(1-theta) f(t,y) + theta f(t+h,z)]``, its
transpose one transposed stage solve at the converged state. The ARK
stepper provides:

- ``step(t, dt, y, params) -> (y1, aux, stats)``: one step; ``aux`` stacks
  the stage values Y_i (the trajectory payload of ``store_all``).
- ``step_embedded(t, dt, y, params) -> (y1, err, aux, stats)``: the step
  plus the embedded error estimate of a tableau with ``b_err`` weights, the
  adaptive controller's trial step (``adaptive.py``).
- ``step_adj(t, dt, y, params, aux, lam) -> (lam_prev, gparams)``: the exact
  transpose of the discrete step map. With stages
  ``Y_i = y + h sum_{j<i}(aI_ij kI_j + aE_ij kE_j) + h aI_ii fI(Y_i)`` the
  reverse recursion for ``xi_i = dL/dG_i`` is::

    u_i  = h (bI_i lam + sum_{m>i} aI_mi xi_m)      # covector into kI_i
    uh_i = h (bE_i lam + sum_{m>i} aE_mi xi_m)      # covector into kE_i
    p_i  = JI_i^T u_i + JE_i^T uh_i
    xi_i = (I - h aI_ii JI_i)^{-T} p_i              # transposed stage solve
    grad_thI += fI_th^T (u_i + h aI_ii xi_i);  grad_thE += fE_th^T uh_i
    lam_prev = lam + sum_i xi_i

On the production stiff-PDE configuration (ksponly, a frozen shared
Jacobian of a certified-linear parameter-free implicit part, a single
ESDIRK gamma, f_EX = sign * MLP, fp32 2-D state) ``step`` and ``step_adj``
run the fused step kernels K2 (with its err output under the adaptive
controller) and K3 (``ops/``); everything else runs the generic stage
loop, whose f_EX evaluations go through K1 when the model uses
``FusedStackedMLP``. Vector-Jacobian products use
``torch.autograd.grad`` on a graph built for that one evaluation: nothing
outside a single stage ever records a graph.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .linsolve import (
    DenseStageSolver, LinearSolveConfig, assemble_block_jacobian,
    make_stage_solver,
)
from .misc import tree_add, tree_leaves, tree_zeros_like
from .newton import NewtonConfig, newton_solve
from .tableaus import ARKTableau, RKTableau


class StepStats(NamedTuple):
    """Per-step solver telemetry (the adjoint engine sums it over the
    trajectory)."""

    newton_iters: int
    newton_converged: bool


@dataclass
class ImplicitSolveSetup:
    """Static solver configuration of the implicit stages."""

    lin_cfg: LinearSolveConfig
    newton_cfg: NewtonConfig
    # frozen per-solve Jacobian blocks for dense/block solvers (fixed_jacobian)
    frozen_J_blocks: Optional[torch.Tensor] = None
    # True: the adjoint's transposed solves re-linearize at the converged
    # stage; False: they reuse frozen_J_blocks (the reference's dense path)
    adjoint_exact_jacobian: bool = True
    # pre-inverted stage solvers keyed by the ESDIRK diagonal a_ii, built
    # once per solve when the Jacobian is frozen and dt is uniform
    solver_cache: Optional[dict] = None
    # the model certified d f_im/dy independent of y (linear_in_y)
    im_linear_in_y: bool = False


def _frozen_setup(owner, setup, params, t0, dt0, y0, f_flat, build_cache):
    """Assemble the frozen Jacobian and build the pre-inverted stage-solver
    cache. For a certified-linear, parameter-free implicit part both are
    constants of the problem: they are computed once, at a constant state,
    and memoized on ``owner`` keyed by (t0, dt0, shape, dtype, device), so
    a training loop does not rebuild them per step (the JAX package bakes
    them into the compiled program; rebuilding per step cost 95% of the
    Burgers step there)."""
    const = setup.im_linear_in_y and not tree_leaves(params)
    key = None
    if const:
        key = (float(t0), None if dt0 is None else float(dt0),
               tuple(y0.shape), str(y0.dtype), str(y0.device))
        memo = getattr(owner, "_const_freeze_memo", None)
        if memo is not None and memo[0] == key:
            return memo[1]
    with torch.no_grad():
        y_lin = torch.zeros_like(y0) if const else y0.detach()
        J = assemble_block_jacobian(f_flat, y_lin.reshape(-1),
                                    setup.lin_cfg,
                                    shared=setup.lin_cfg.kind == "block")
        cache = build_cache(J)
    if const:
        owner._const_freeze_memo = (key, (J, cache))
    return J, cache


def _vjp(fn, y, params):
    """(out, vjp) of ``fn(y, params)``; ``vjp(ct)`` returns the cotangents
    (d<ct, out>/dy, {name: d<ct, out>/dparam}). The graph is local to this
    one evaluation and may be pulled back more than once."""
    with torch.enable_grad():
        y_ = y.detach().requires_grad_(True)
        p_ = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out = fn(y_, p_)
    leaves = [y_] + list(p_.values())

    def vjp(ct):
        gs = torch.autograd.grad(out, leaves, grad_outputs=ct.to(out.dtype),
                                 retain_graph=True, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for g, x in zip(gs, leaves)]
        return gs[0], dict(zip(p_, gs[1:]))

    return out, vjp


class ExplicitRK:
    """Tableau-driven explicit RK over arbitrary state shapes (counterpart
    of ``pnode_tpu/steppers.py:84-185``). ``aux`` stacks the stage
    derivatives k_i; ``step_adj`` is the transposed-RK recursion with one
    ``_vjp`` per stage whose covector can be nonzero."""

    def __init__(self, tableau: RKTableau, f: Callable):
        self.tab = tableau
        self.f = f  # f(t, y, params) -> dy
        # Python-float coefficients: they keep the state's dtype
        self._a = [[float(x) for x in row] for row in tableau.a]
        self._b = [float(x) for x in tableau.b]
        self._c = [float(x) for x in tableau.c]
        self._berr = (None if tableau.b_err is None
                      else [float(x) for x in tableau.b_err])
        # stages whose adjoint covector is identically zero are skipped in
        # the reverse sweep (dopri5's FSAL stage has b_i = 0 = a_mi)
        s = tableau.stages
        self._adj_active = [
            bool(tableau.b[i] != 0.0 or np.any(tableau.a[i + 1:, i] != 0.0))
            for i in range(s)]
        self.nfe_per_step = s

    def prepare(self, t0, y0, params, dt0=None):
        """Per-solve setup hook (nothing to do for explicit methods)."""
        return self

    def static_newton_iters(self):
        """Newton iterations of one step: none, whatever the data."""
        return 0

    def step(self, t, dt, y, params):
        a, b, c = self._a, self._b, self._c
        # stage math at promote_types(y, fp32): a bf16 state's increments
        # are summed at fp32, and f sees its stage values at bf16
        work = torch.promote_types(y.dtype, torch.float32)
        low = y.dtype != work
        yw = y.to(work)
        ks = []
        for i in range(self.tab.stages):
            Yi = yw
            for j in range(i):
                if a[i][j] != 0.0:
                    Yi = Yi + (dt * a[i][j]) * ks[j]
            ks.append(_at_least(self.f(t + c[i] * dt,
                                       Yi.to(y.dtype) if low else Yi,
                                       params), work))
        y1 = yw
        for i, k in enumerate(ks):
            if b[i] != 0.0:
                y1 = y1 + (dt * b[i]) * k
        # the carried state and the stored stages stay at the state dtype
        return y1.to(y.dtype), torch.stack(ks).to(y.dtype), StepStats(0, True)

    def step_embedded(self, t, dt, y, params):
        """Step plus the embedded error estimate: (y1, err, aux, stats),
        err at promote_types(y, fp32)."""
        if self._berr is None:
            raise ValueError(f"RK tableau {self.tab.name!r} has no embedded "
                             "weights; -ts_adapt_type basic needs bosh3 or "
                             "dopri5")
        y1, aux, stats = self.step(t, dt, y, params)
        work = torch.promote_types(y.dtype, torch.float32)
        err = torch.zeros_like(y, dtype=work)
        for i in range(self.tab.stages):
            d = self._b[i] - self._berr[i]
            if d != 0.0:
                err = err + (dt * d) * aux[i]
        return y1, err, aux, stats

    def _stage_values(self, dt, y, ks):
        a = self._a
        Ys = []
        for i in range(self.tab.stages):
            Yi = y
            for j in range(i):
                if a[i][j] != 0.0:
                    Yi = Yi + (dt * a[i][j]) * ks[j]
            Ys.append(Yi)
        return Ys

    def step_adj(self, t, dt, y, params, aux, lam):
        """The transposed-RK recursion at promote_types(y, fp32); each vjp
        at the stage value in the state's dtype, its seed cast to f's
        output dtype (``_vjp``); parameter gradients at their own dtype."""
        a, b, c = self._a, self._b, self._c
        s = self.tab.stages
        if aux is None:
            _, aux, _ = self.step(t, dt, y, params)
        work = torch.promote_types(y.dtype, torch.float32)
        low = y.dtype != work
        Ys = self._stage_values(dt, y.to(work),
                                [aux[i].to(work) for i in range(s)])
        lamw = lam.to(work)
        xis: list = [None] * s
        gp = tree_zeros_like(params)
        lam_prev = lamw
        for i in range(s - 1, -1, -1):
            if not self._adj_active[i]:
                continue
            u = (dt * b[i]) * lamw
            for m in range(i + 1, s):
                if a[m][i] != 0.0 and xis[m] is not None:
                    u = u + (dt * a[m][i]) * xis[m]
            ti = t + c[i] * dt
            _, vjp = _vjp(lambda yy, pp, ti=ti: self.f(ti, yy, pp),
                          Ys[i].to(y.dtype) if low else Ys[i], params)
            dly, dlp = vjp(u)
            dly = _at_least(dly, work)
            xis[i] = dly
            gp = tree_add(gp, dlp)
            lam_prev = lam_prev + dly
        return lam_prev.to(lam.dtype), gp


def _at_least(x, dtype):
    """x at promote_types(x.dtype, dtype): never a downcast."""
    return x.to(torch.promote_types(x.dtype, dtype))


def _mass_apply(mass, v):
    """M v over the last axis (v (..., d), M (d, d)); the identity for
    None. A plain fp32 product on the card: TF32 is off (package import)."""
    if mass is None:
        return v
    return torch.einsum("ij,...j->...i", mass.to(v.dtype), v)


def _mass_apply_T(mass, v):
    if mass is None:
        return v
    return torch.einsum("ji,...j->...i", mass.to(v.dtype), v)


class Theta:
    """Theta method: backward Euler (theta 1, TSBE) / Crank-Nicolson (theta
    1/2, TSCN), with an optional mass matrix for DAEs (``F = M udot -
    f(t, u)``; the pendulum DAE uses M = diag(1,1,1,1,0)). Counterpart of
    ``pnode_tpu/steppers.py:275-468``; ``aux`` is the converged stage, the
    new state."""

    def __init__(self, theta: float, f: Callable, setup: ImplicitSolveSetup,
                 mass: Optional[torch.Tensor] = None):
        self.theta = float(theta)
        self.f = f
        self.setup = setup
        self.mass = mass
        self.nfe_per_step = 2 if self.theta < 1.0 else 1

    def prepare(self, t0, y0, params, dt0=None):
        """Freeze the dense/block Jacobian at (t0, y0) for this solve (only
        with ``fixed_jacobian``; GMRES is matrix-free) and, for a uniform
        step dt0 without a mass matrix, pre-invert the stage operator,
        keyed by theta. Shares ARKIMEX's freeze-and-memo path."""
        if (self.setup.lin_cfg.kind == "gmres"
                or not self.setup.lin_cfg.fixed_jacobian):
            return self

        def f_flat(zf):
            return self.f(t0, zf.reshape(y0.shape), params).reshape(-1)

        def build_cache(J):
            if dt0 is None or self.mass is not None or self.theta <= 0.0:
                return None
            return {self.theta: DenseStageSolver(
                J, None, 1.0, dt0 * self.theta, int(y0.numel()),
                use_inverse=True)}

        J, cache = _frozen_setup(self, self.setup, params, t0, dt0, y0,
                                 f_flat, build_cache)
        new = copy.copy(self)
        new.setup = dataclasses.replace(self.setup, frozen_J_blocks=J,
                                        solver_cache=cache)
        return new

    def _solver(self, t1, params, gamma, z_flat, shape, frozen):
        def f_flat(zf):
            return self.f(t1, zf.reshape(shape), params).reshape(-1)

        return make_stage_solver(f_flat, z_flat, self.mass, sigma=1.0,
                                 gamma=gamma, cfg=self.setup.lin_cfg,
                                 cached_J_blocks=frozen)

    def step(self, t, dt, y, params):
        th = self.theta
        t1 = t + dt
        shape = y.shape
        f_n = self.f(t, y, params) if th < 1.0 else None

        def residual_flat(z_flat):
            z = z_flat.reshape(shape)
            rhs = th * self.f(t1, z, params)
            if f_n is not None:
                rhs = rhs + (1.0 - th) * f_n
            return (_mass_apply(self.mass, z - y) - dt * rhs).reshape(-1)

        cache = self.setup.solver_cache
        if cache is not None and th in cache:
            cached = cache[th]
            make = lambda zf: cached  # noqa: E731
        else:
            make = lambda zf: self._solver(  # noqa: E731
                t1, params, dt * th, zf, shape, self.setup.frozen_J_blocks)
        # Newton (and GMRES) at promote_types(y, fp32); the result is cast
        # back to the state's dtype
        work = torch.promote_types(y.dtype, torch.float32)
        z_flat, nstats = newton_solve(residual_flat, make,
                                      y.reshape(-1).to(work),
                                      self.setup.newton_cfg)
        y1 = z_flat.reshape(shape).to(y.dtype)
        return y1, y1, StepStats(newton_iters=nstats.iters,
                                 newton_converged=nstats.converged)

    def step_embedded(self, t, dt, y, params):
        """Step plus the adaptive controller's error estimate, the
        trapezoid-vs-implicit-Euler difference at the same converged
        stage: err = dt/2 (f(t, y) - f(t+dt, y1)), O(dt^2) for both BE and
        CN. With a mass matrix the algebraic rows (diag(M) == 0) carry no
        truncation error and are masked out."""
        y1, aux, stats = self.step(t, dt, y, params)
        err = (0.5 * dt) * (self.f(t, y, params) - self.f(t + dt, y1, params))
        if self.mass is not None:
            diff_rows = torch.diagonal(self.mass) != 0.0
            err = torch.where(diff_rows.expand(err.shape), err,
                              torch.zeros_like(err))
        return y1, err, aux, stats

    def step_adj(self, t, dt, y, params, aux, lam):
        """(M - dt theta J1)^T w = lam at the converged state, then
        lam_prev = M^T w + dt (1-theta) J0^T w and the parameter gradients
        from the vjps at t+dt and (theta < 1) at t."""
        th = self.theta
        t1 = t + dt
        shape = y.shape
        y1 = self.step(t, dt, y, params)[0] if aux is None else aux
        setup = self.setup
        work = torch.promote_types(y.dtype, torch.float32)
        cache = setup.solver_cache
        if (cache is not None and th in cache
                and not setup.adjoint_exact_jacobian):
            solver = cache[th]
        else:
            frozen = (None if setup.adjoint_exact_jacobian
                      else setup.frozen_J_blocks)
            solver = self._solver(t1, params, dt * th,
                                  y1.reshape(-1).to(work), shape, frozen)
        w = solver.solve_transpose(lam.reshape(-1).to(work)).reshape(shape)
        _, vjp1 = _vjp(lambda yy, pp: self.f(t1, yy, pp), y1, params)
        _, gp = vjp1((dt * th) * w)
        lam_prev = _mass_apply_T(self.mass, w)
        if th < 1.0:
            _, vjp0 = _vjp(lambda yy, pp: self.f(t, yy, pp), y, params)
            dly0, gp0 = vjp0((dt * (1.0 - th)) * w)
            lam_prev = lam_prev + dly0
            gp = tree_add(gp, gp0)
        return lam_prev.to(lam.dtype), gp


class ARKIMEX:
    """Additive IMEX Runge-Kutta: f_IM treated implicitly (ESDIRK part),
    f_EX explicitly -- the SINODE semi-implicit capability.

    params is a 2-tuple (params_im, params_ex) of parameter dicts; the
    adjoint keeps the two partitions separate.
    """

    def __init__(self, tableau: ARKTableau, f_im: Callable, f_ex: Callable,
                 setup: ImplicitSolveSetup, mass=None,
                 fused_ex_spec: Optional[Callable] = None):
        if mass is not None:
            raise NotImplementedError(
                "mass matrices are supported for the theta methods (DAEs: "
                "method beuler or cn); ARKIMEX refuses them, as the JAX "
                "package's does")
        self.tab = tableau
        self.f_im = f_im
        self.f_ex = f_ex
        self.setup = setup
        # model-provided (Ws, bs, activation, sign, rebuild) spec enabling
        # the fused step kernels; None -> generic stage loop
        self.fused_ex_spec = fused_ex_spec
        self.nfe_per_step = 2 * tableau.stages
        self._aI = [[float(x) for x in row] for row in tableau.a_im]
        self._aE = [[float(x) for x in row] for row in tableau.a_ex]
        self._bI = [float(x) for x in tableau.b_im]
        self._bE = [float(x) for x in tableau.b_ex]
        self._cI = [float(x) for x in tableau.c_im]
        self._cE = [float(x) for x in tableau.c_ex]
        self._bIe = (None if tableau.b_im_err is None
                     else [float(x) for x in tableau.b_im_err])
        self._bEe = (None if tableau.b_ex_err is None
                     else [float(x) for x in tableau.b_ex_err])
        # {id(J): (J, basis)} of _spectral_stage_basis, shared by the copies
        # prepare() makes (the frozen J outlives them)
        self._spectral_memo = {}

    def _tableau_static(self):
        return (self._aI, self._aE, self._bI, self._bE)

    def prepare(self, t0, y0, params, dt0=None):
        """Freeze the dense/block Jacobian of f_IM at (t0, y0) and
        pre-invert the stage operators for a uniform step dt0."""
        if (self.setup.lin_cfg.kind == "gmres"
                or not self.setup.lin_cfg.fixed_jacobian):
            return self
        params_im, _ = params

        def f_flat(zf):
            return self.f_im(t0, zf.reshape(y0.shape), params_im).reshape(-1)

        def build_cache(J):
            if dt0 is None:
                return None
            gammas = sorted({g for g in (float(x) for x in np.diag(self.tab.a_im))
                             if g != 0.0})
            return {g: DenseStageSolver(J, None, 1.0, dt0 * g, int(y0.numel()),
                                        use_inverse=True)
                    for g in gammas}

        J, cache = _frozen_setup(self, self.setup, params_im, t0, dt0, y0,
                                 f_flat, build_cache)
        new = copy.copy(self)
        new.setup = dataclasses.replace(self.setup, frozen_J_blocks=J,
                                        solver_cache=cache)
        return new

    def _stage_solver(self, ti, params_im, gamma, z_flat, shape):
        def f_flat(zf):
            return self.f_im(ti, zf.reshape(shape), params_im).reshape(-1)

        return make_stage_solver(f_flat, z_flat, None, sigma=1.0, gamma=gamma,
                                 cfg=self.setup.lin_cfg,
                                 cached_J_blocks=self.setup.frozen_J_blocks)

    def step(self, t, dt, y, params):
        if self._fused_fwd_ok(y):
            fused = self._fused_reverse_args(params, dt=dt)
            if fused is not None:
                from .ops.fused_ark_forward import fused_ark_step_fwd

                spec, J, inv_op = fused
                y1, aux = fused_ark_step_fwd(
                    self._tableau_static(), dt, y, J, inv_op, spec["Ws"],
                    spec["bs"], activation=spec["activation"],
                    sign=spec["sign"])
                return y1, aux, self._fused_stats()
        return self._step_generic(t, dt, y, params)

    def _fused_fwd_ok(self, y):
        """State and solver conditions of the fused step kernels: batched
        2-D fp32 state and a ksponly (single linearized solve)
        configuration without the opt-in residual check."""
        return (
            y.dim() == 2
            and y.dtype == torch.float32
            and self.setup.newton_cfg.ksponly
            and not self.setup.newton_cfg.ksponly_check
        )

    def _fused_stats(self):
        n_impl = sum(1 for i in range(self.tab.stages) if self._aI[i][i] != 0.0)
        return StepStats(newton_iters=n_impl, newton_converged=True)

    def static_newton_iters(self):
        """Newton iterations of one step when they do not depend on the data
        (ksponly without its residual check: one linearized solve per
        implicit stage, fused or generic), else None."""
        cfg = self.setup.newton_cfg
        if cfg.ksponly and not cfg.ksponly_check:
            return self._fused_stats().newton_iters
        return None

    def _step_generic(self, t, dt, y, params):
        y1, aux, stats, _ = self._stage_loop(t, dt, y, params)
        return y1, aux, stats

    def step_embedded(self, t, dt, y, params):
        """Step plus the embedded error estimate: (y1, err, aux, stats),
        with err = dt sum_i ((bI - bI_err)_i kI_i + (bE - bE_err)_i kE_i).
        On the fused gate it is one K2 launch with the err output, the
        stage inverse formed for this trial's dt (_fused_reverse_args)."""
        tab = self.tab
        if tab.b_im_err is None:
            raise ValueError(
                f"ARK tableau {tab.name!r} has no embedded weights; "
                "-ts_adapt_type basic requires one of 1bee/3/4")
        if self._fused_fwd_ok(y):
            fused = self._fused_reverse_args(params, dt=dt)
            if fused is not None:
                from .ops.fused_ark_forward import fused_ark_step_fwd

                spec, J, inv_op = fused
                y1, err, aux = fused_ark_step_fwd(
                    self._tableau_static(), dt, y, J, inv_op, spec["Ws"],
                    spec["bs"], activation=spec["activation"],
                    sign=spec["sign"], b_err=(self._bIe, self._bEe))
                return y1, err, aux, self._fused_stats()
        y1, aux, stats, (kI, kE) = self._stage_loop(t, dt, y, params)
        err = torch.zeros_like(y)
        for i in range(tab.stages):
            dI = self._bI[i] - self._bIe[i]
            dE = self._bE[i] - self._bEe[i]
            if dI != 0.0:
                err = err + (dt * dI) * kI[i]
            if dE != 0.0:
                err = err + (dt * dE) * kE[i]
        return y1, err, aux, stats

    def _stage_loop(self, t, dt, y, params):
        """The generic stage loop: (y1, aux, stats, (kI, kE))."""
        params_im, params_ex = params
        aI, aE, bI, bE = self._aI, self._aE, self._bI, self._bE
        s = self.tab.stages
        shape = y.shape
        work = torch.promote_types(y.dtype, torch.float32)
        kI, kE, Ys = [], [], []
        total_newton = 0
        all_conv = True
        for i in range(s):
            G = y
            for j in range(i):
                if aI[i][j] != 0.0:
                    G = G + (dt * aI[i][j]) * kI[j]
                if aE[i][j] != 0.0:
                    G = G + (dt * aE[i][j]) * kE[j]
            tiI = t + self._cI[i] * dt
            tiE = t + self._cE[i] * dt
            gii = aI[i][i]
            if gii != 0.0:
                def residual_flat(z_flat, G=G, tiI=tiI, gii=gii):
                    z = z_flat.reshape(shape)
                    r = (z - G) - (dt * gii) * self.f_im(tiI, z, params_im)
                    return r.reshape(-1)

                cache = self.setup.solver_cache
                if cache is not None and gii in cache:
                    cached = cache[gii]
                    make = lambda zf, cached=cached: cached  # noqa: E731
                else:
                    make = lambda zf, tiI=tiI, gii=gii: self._stage_solver(  # noqa: E731
                        tiI, params_im, dt * gii, zf, shape)
                z_flat, nstats = newton_solve(
                    residual_flat, make, G.reshape(-1).to(work),
                    self.setup.newton_cfg)
                Yi = z_flat.reshape(shape).to(y.dtype)
                total_newton += nstats.iters
                all_conv = all_conv and nstats.converged
            else:
                Yi = G
            Ys.append(Yi)
            kI.append(self.f_im(tiI, Yi, params_im))
            kE.append(self.f_ex(tiE, Yi, params_ex))
        y1 = y
        for i in range(s):
            if bI[i] != 0.0:
                y1 = y1 + (dt * bI[i]) * kI[i]
            if bE[i] != 0.0:
                y1 = y1 + (dt * bE[i]) * kE[i]
        aux = torch.stack(Ys)
        stats = StepStats(newton_iters=total_newton, newton_converged=all_conv)
        return y1.to(y.dtype), aux.to(y.dtype), stats, (kI, kE)

    def _spectral_stage_basis(self, J0):
        """Eigenbasis ``(lam, Q)`` of the frozen J for per-trial stage
        inverses, or None (then ``torch.linalg.inv``).

        The adaptive controller needs ``(I - dt gamma J)^{-1}`` at a dt that
        changes every trial. When J is symmetric (the KS and Burgers
        periodic stencils), one fp64 ``numpy.linalg.eigh`` at first use
        rewrites every trial inverse as ``Q diag(1/(1 - dt gamma lam)) Q^T``,
        two (d, d) products. Exact in exact arithmetic; the basis is checked
        by reconstruction before use. Memoized per frozen J."""
        hit = self._spectral_memo.get(id(J0))
        if hit is not None and hit[0] is J0:
            return hit[1]
        Jh = J0.detach().to("cpu", torch.float64).numpy()
        scale = float(np.max(np.abs(Jh))) or 1.0
        basis = None
        if float(np.max(np.abs(Jh - Jh.T))) <= 1e-6 * scale:
            lam, Q = np.linalg.eigh(Jh)
            rec = float(np.max(np.abs((Q * lam) @ Q.T - Jh)))
            if rec <= 1e-10 * scale:
                basis = tuple(torch.tensor(a, dtype=J0.dtype, device=J0.device)
                              for a in (lam, Q))
        self._spectral_memo.clear()
        self._spectral_memo[id(J0)] = (J0, basis)
        return basis

    def _trial_inverse(self, J0, gamma, dt):
        """(I - dt gamma J)^{-1} where no pre-inverted operator serves dt
        (the adaptive controller's trials, non-uniform grids): Q diag(w)
        Q^T, w = 1/(1 - (dt gamma) lam), with dt gamma rounded to J's dtype
        as the reference's traced dt rounds it; without a spectral basis,
        torch.linalg.inv. Plain products outside any kernel, as the
        reference forms it (TF32 is off)."""
        basis = self._spectral_stage_basis(J0)
        if basis is None:
            eye = torch.eye(J0.shape[-1], dtype=J0.dtype, device=J0.device)
            return torch.linalg.inv(eye - (float(dt) * gamma) * J0).contiguous()
        lam_e, Q = basis
        dtg = float(torch.tensor(float(dt), dtype=J0.dtype) * gamma)
        w = 1.0 / (1.0 - dtg * lam_e)
        return ((Q * w) @ Q.T).contiguous()

    def _fused_reverse_args(self, params, dt=None):
        """The single gate of the fused step kernels; (spec, J, inv_op) or
        None.

        Open when the model provides the MLP spec, the implicit part is
        certified linear (setupTS only passes a spec then) and
        parameter-free, ksponly is set, the Jacobian is frozen and shared,
        the tableau has a single ESDIRK gamma, and the kernels' shared-
        memory budget takes the widths. Device-independent: on CPU tensors
        the wrappers run their plain versions. ``-pnode_fused_ark_adjoint
        off`` forces the generic stage loop. The pre-inverted operator
        comes from the per-solve cache (uniform dt); without it and with
        ``dt`` given, (I - dt gamma J)^{-1} is formed here
        (``_trial_inverse``).
        """
        if self.fused_ex_spec is None:
            return None
        from .options import Options
        from .ops.fused_ark_adjoint import (
            check_stiff_dot_precision, pick_weight_dtype)

        mode = Options().get_string("pnode_fused_ark_adjoint", "auto")
        if mode == "off":
            return None
        if mode != "auto":
            raise ValueError(
                f"-pnode_fused_ark_adjoint {mode!r}: use auto|off (interpret "
                "mode is a Pallas notion; on CPU tensors the wrappers run "
                "their plain PyTorch versions)")
        check_stiff_dot_precision()
        setup = self.setup
        if not setup.newton_cfg.ksponly or setup.newton_cfg.ksponly_check:
            return None
        if setup.adjoint_exact_jacobian or setup.frozen_J_blocks is None:
            return None
        if setup.frozen_J_blocks.shape[0] != 1:
            return None
        gammas = {g for g in (float(x) for x in np.diag(self.tab.a_im))
                  if g != 0.0}
        if len(gammas) != 1:
            return None
        gamma = next(iter(gammas))
        params_im, params_ex = params
        if tree_leaves(params_im):
            return None
        spec = self.fused_ex_spec(params_ex)
        if spec is None:
            return None
        J0 = setup.frozen_J_blocks[0]
        d = int(J0.shape[-1])
        if pick_weight_dtype(d, [int(w.shape[1]) for w in spec["Ws"]],
                             self.tab.stages) is None:
            return None
        inv_op = None
        cache = setup.solver_cache
        if cache is not None:
            solver = cache.get(gamma)
            if (solver is not None and solver._inv is not None
                    and solver._shared):
                inv_op = solver._inv[0]
        if inv_op is None:
            if dt is None:
                return None
            inv_op = self._trial_inverse(J0, gamma, dt)
        return spec, J0, inv_op

    def step_adj(self, t, dt, y, params, aux, lam):
        params_im, params_ex = params
        aI, aE, bI, bE = self._aI, self._aE, self._bI, self._bE
        s = self.tab.stages
        shape = y.shape
        if aux is None:
            _, aux, _ = self.step(t, dt, y, params)

        fused = (self._fused_reverse_args(params, dt=dt)
                 if self._fused_fwd_ok(y) else None)
        if fused is not None:
            from .ops.fused_ark_adjoint import fused_ark_step_adj

            spec, J, inv_op = fused
            lam_prev, (dWs, dbs) = fused_ark_step_adj(
                self._tableau_static(), dt, aux, lam, J, inv_op, spec["Ws"],
                spec["bs"], activation=spec["activation"], sign=spec["sign"])
            return lam_prev, (tree_zeros_like(params_im),
                              spec["rebuild"](dWs, dbs))

        Ys = [aux[i] for i in range(s)]
        setup = self.setup
        work = torch.promote_types(y.dtype, torch.float32)
        frozen = None if setup.adjoint_exact_jacobian else setup.frozen_J_blocks
        xis: list = [None] * s
        g_im = tree_zeros_like(params_im)
        g_ex = tree_zeros_like(params_ex)
        lam_prev = lam
        for i in range(s - 1, -1, -1):
            u = (dt * bI[i]) * lam
            uh = (dt * bE[i]) * lam
            for m in range(i + 1, s):
                if xis[m] is None:
                    continue
                if aI[m][i] != 0.0:
                    u = u + (dt * aI[m][i]) * xis[m]
                if aE[m][i] != 0.0:
                    uh = uh + (dt * aE[m][i]) * xis[m]
            tiI = t + self._cI[i] * dt
            tiE = t + self._cE[i] * dt
            _, vjpI = _vjp(lambda yy, pp, tiI=tiI: self.f_im(tiI, yy, pp),
                           Ys[i], params_im)
            _, vjpE = _vjp(lambda yy, pp, tiE=tiE: self.f_ex(tiE, yy, pp),
                           Ys[i], params_ex)
            dyI, gI = vjpI(u)
            dyE, gE = vjpE(uh)
            p = dyI + dyE
            gii = aI[i][i]
            if gii != 0.0:
                cache = setup.solver_cache
                if (cache is not None and gii in cache
                        and not setup.adjoint_exact_jacobian):
                    solver = cache[gii]
                else:
                    def f_flat(zf, tiI=tiI):
                        return self.f_im(tiI, zf.reshape(shape),
                                         params_im).reshape(-1)

                    solver = make_stage_solver(
                        f_flat, Ys[i].reshape(-1).to(work), None, sigma=1.0,
                        gamma=dt * gii, cfg=setup.lin_cfg,
                        cached_J_blocks=frozen)
                xi = solver.solve_transpose(
                    p.reshape(-1).to(work)).reshape(shape)
                _, gI2 = vjpI((dt * gii) * xi)
                gI = tree_add(gI, gI2)
            else:
                xi = p
            xis[i] = xi
            g_im = tree_add(g_im, gI)
            g_ex = tree_add(g_ex, gE)
            lam_prev = lam_prev + xi
        return lam_prev.to(lam.dtype), (g_im, g_ex)
