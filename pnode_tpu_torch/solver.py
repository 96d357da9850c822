"""Solver facade: the three-call user API (setupTS / odeint / odeint_adjoint).

Counterpart of ``pnode_tpu/solver.py:49-508``::

    ode = ODESolver()
    ode.setupTS(u_template, TorchFunc(f_im), step_size=0.2, method="imex",
                imex_form=True, func2=TorchFunc(f_ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=B)
    sol = ode.odeint_adjoint(y0, t)        # trains the live modules
    sol = ode.odeint_adjoint(y0, t, params=(p_im, p_ex))

``sol`` is differentiable: ``loss.backward()`` runs the hand-written
discrete adjoint and fills the parameters' ``.grad``.

Runtime options override programmatic choices (setFromOptions-last):
``-ts_type``, ``-ts_rk_type``, ``-ts_arkimex_type``, ``-ts_max_steps``,
``-ts_trajectory_solution_only``, ``-ts_trajectory_max_cps_ram`` with
``-ts_trajectory_schedule uniform|revolve|cams`` (``adjoint.py``),
``-snes_type``, ``-snes_rtol``,
``-snes_atol``, ``-snes_stol``, ``-snes_max_it``, ``-snes_ksponly_check``,
``-pnode_linear_solver``, and the adaptive controller's ``-ts_adapt_type
basic|pi``, ``-ts_rtol``, ``-ts_atol``, ``-ts_adapt_safety``,
``-ts_adapt_clip low,high`` and ``-ts_adapt_max_steps`` (``adaptive.py``;
``solve(..., dt0=)`` warm-starts it), and the stage solver's
``-ksp_rtol``, ``-ksp_atol``, ``-ksp_max_it`` and ``-ksp_gmres_restart``
(also under the ``-pnode_inner_`` prefix). The port runs the explicit RK
methods (euler, rk2, bosh3, rk4, dopri5, ...), the theta methods
(``beuler``/``be``, ``cn``/``theta``; ``mass=`` makes them DAE solvers) and
the IMEX method, on fixed steps with every in-memory trajectory policy
(store_all, solution_only, checkpoint, revolve, CAMS) or under the
controller with store_all and solution_only; disk and compressed
trajectories, and the controller's checkpointed policies, raise
``NotImplementedError`` naming their ROADMAP slice. ``solve(...,
with_adjoint=False)`` (and ``odeint``) runs the step loop under autograd,
so its outputs are differentiable by plain autograd through the steps.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .adjoint import TrajectoryConfig, make_odeint
from .grid import build_time_grid
from .linsolve import LinearSolveConfig, normalize_linear_solver_name
from .modules import as_dynamics
from .newton import NewtonConfig
from .options import Options
from .steppers import ARKIMEX, ExplicitRK, ImplicitSolveSetup, Theta
from .tableaus import THETA_METHODS, get_ark_tableau, get_rk_tableau

_THETA_TS_TYPES = {"beuler": 1.0, "be": 1.0, "cn": 0.5, "theta": 0.5}


class ODESolver:
    """One configured time integrator (the reference's per-ODEPetsc state)."""

    def __init__(self, prefix: str = ""):
        self.opts = Options(prefix)
        self._configured = False
        self._cache = {}
        self.last_stats = None
        self.nfe_forward = 0

    # ------------------------------------------------------------------
    def setupTS(
        self,
        u_tensor,
        func,
        step_size=0.01,
        enable_adjoint: bool = True,
        implicit_form: bool = False,
        use_dlpack: bool = True,  # accepted for API parity
        method: str = "dopri5",
        mass=None,
        imex_form: bool = False,
        func2=None,
        batch_size: int = 1,
        linear_solver: str = "petsc",
        fixed_jacobian: bool = False,
        matrixfree_jacobian: bool = True,
        params=None,
        params2=None,
    ):
        """Configure the integrator (kwarg surface of the reference's
        setupTS). ``u_tensor`` fixes the state's shape, dtype and device;
        ``params``/``params2`` override the parameters carried by
        ``func``/``func2``."""
        if imex_form and func2 is None:
            raise ValueError("func2 must be provided to enable imex_form=True")
        del use_dlpack, implicit_form

        self.template = torch.as_tensor(u_tensor)
        self.dtype = self.template.dtype
        self.device = self.template.device
        self.state_shape = tuple(self.template.shape)
        # the mass matrix, per block (d, d), in the state's dtype and on its
        # device
        self.mass = (None if mass is None else torch.as_tensor(
            mass, dtype=self.dtype, device=self.device))
        self.imex = bool(imex_form)
        self.enable_adjoint = bool(enable_adjoint)
        self.step_size = step_size

        f_im, get_im = as_dynamics(func, params)
        # models opt into the fused step kernels by exposing
        # fused_mlp_spec(params); the implicit part must also CERTIFY
        # linearity in y (the kernels apply the frozen Jacobian)
        self._fused_ex_spec = None
        mod_im = getattr(func, "module", None)
        self._im_linear = bool(getattr(mod_im, "linear_in_y", False))
        if imex_form:
            f_ex, get_ex = as_dynamics(func2, params2)
            self.f = (f_im, f_ex)
            self._get_params = lambda: (get_im(), get_ex())
            mod = getattr(func2, "module", None)
            if (mod is not None and hasattr(mod, "fused_mlp_spec")
                    and self._im_linear):
                self._fused_ex_spec = mod.fused_mlp_spec
        else:
            self.f = f_im
            self._get_params = get_im

        # --- option coupling rules (reference petsc_adjoint.py:590-594) ---
        linear_solver = self.opts.get_string("pnode_linear_solver",
                                             linear_solver)
        if linear_solver in ("petsc", "gmres"):
            matrixfree_jacobian = True
        if fixed_jacobian or linear_solver in ("torch", "direct", "lu"):
            matrixfree_jacobian = False
        canonical = normalize_linear_solver_name(linear_solver)
        if canonical == "block" and not matrixfree_jacobian:
            kind = "block"
        elif canonical == "block" or matrixfree_jacobian:
            kind = "gmres"
        else:
            kind = canonical  # "direct"

        n_tmpl = int(self.template.numel())
        if n_tmpl % int(batch_size) != 0:
            raise ValueError(
                f"batch_size {batch_size} does not divide state size {n_tmpl}")
        inner = Options(self.opts.prefix + "pnode_inner_")

        def _ksp(name, default, get="get_real"):
            outer_val = getattr(self.opts, get)(name, default)
            return getattr(inner, get)(name, outer_val)

        self.lin_cfg = LinearSolveConfig(
            kind=kind,
            rtol=_ksp("ksp_rtol", 1e-5),
            atol=_ksp("ksp_atol", 0.0),
            restart=_ksp("ksp_gmres_restart", 30, "get_int"),
            max_restarts=max(1, _ksp("ksp_max_it", 300, "get_int") // 30),
            block_size=n_tmpl // int(batch_size),
            fixed_jacobian=bool(fixed_jacobian),
        )
        # dtype-aware Newton tolerance defaults (PETSc's 1e-8 presumes fp64)
        eps = float(torch.finfo(self.dtype).eps)
        tol_default = max(50.0 * eps, 1e-8)
        self.newton_cfg = NewtonConfig(
            rtol=self.opts.get_real("snes_rtol", tol_default),
            atol=self.opts.get_real("snes_atol", 1e-50),
            stol=self.opts.get_real("snes_stol", tol_default),
            max_it=self.opts.get_int("snes_max_it", 50),
            ksponly=self.opts.get_string("snes_type", "newtonls") == "ksponly",
            ksponly_check=bool(self.opts.get_int("snes_ksponly_check", 0)),
        )

        # --- method resolution (setFromOptions-last) -----------------------
        meth = method
        ts_type = self.opts.get_string("ts_type")
        if ts_type is not None:
            if ts_type == "rk":
                meth = self.opts.get_string("ts_rk_type", "3bs")
            elif ts_type in _THETA_TS_TYPES or ts_type == "euler":
                meth = ts_type
            elif ts_type == "arkimex":
                meth = "imex"
            else:
                warnings.warn(
                    f"-ts_type {ts_type} not supported; keeping {meth!r}")
        elif self.opts.has("ts_rk_type"):
            meth = self.opts.get_string("ts_rk_type")
        self.method = meth

        # --- trajectory policy ---------------------------------------------
        traj_kind = "store_all"
        if self.opts.get_int("ts_trajectory_solution_only", 0):
            traj_kind = "solution_only"
        max_cps = self.opts.get_int("ts_trajectory_max_cps_ram", 0)
        if max_cps and max_cps > 0:
            # uniform segments by default; "revolve" selects the optimal
            # binomial schedule (csrc/revolve.cpp), "cams" the optimal
            # multistage mixed solution/stage-set schedule (csrc/cams.cpp)
            sched = self.opts.get_string("ts_trajectory_schedule", "uniform")
            traj_kind = sched if sched in ("revolve", "cams") else "checkpoint"
        # the JAX package's executor switches (its scanned executors keep
        # its compiled program flat); the port's eager loop has one executor
        for name in ("pnode_revolve_executor", "pnode_cams_executor"):
            self.opts.get_string(name, "auto")
        tt = self.opts.get_string("ts_trajectory_type", "memory")
        if tt == "disk" or self.opts.get_string("pnode_trajectory_dtype", ""):
            raise NotImplementedError(
                "disk and compressed (-pnode_trajectory_dtype) trajectories "
                "are ROADMAP queue A slice 5(b); the port runs store_all, "
                "solution_only and -ts_trajectory_max_cps_ram c with "
                "-ts_trajectory_schedule uniform|revolve|cams")
        if tt != "memory":
            warnings.warn(f"-ts_trajectory_type {tt!r} unknown; using memory")
        self.traj = TrajectoryConfig(kind=traj_kind, max_cps=max_cps or 0)

        self.adapt_type = self.opts.get_string("ts_adapt_type", "none")
        if (self.adapt_type not in (None, "none")
                and traj_kind in ("checkpoint", "revolve", "cams")):
            raise NotImplementedError(
                "the adaptive path's checkpoint, revolve and CAMS policies "
                "are ROADMAP queue A slice 5(b); under -ts_adapt_type the "
                "port runs store_all and solution_only")
        self.max_steps = self.opts.get_int("ts_max_steps", 1_000_000)

        self._cache.clear()
        self._configured = True
        self._stepper = self._build_stepper()
        return self

    # ------------------------------------------------------------------
    def _build_stepper(self):
        meth = self.method
        # with a frozen Jacobian the adjoint reuses it too (the reference's
        # dense-path semantics; the cached inverse serves the transposes)
        exact_adj = not self.lin_cfg.fixed_jacobian
        setup = ImplicitSolveSetup(self.lin_cfg, self.newton_cfg,
                                   adjoint_exact_jacobian=exact_adj,
                                   im_linear_in_y=self._im_linear)
        if self.imex or meth == "imex":
            if not self.imex:
                raise ValueError("method='imex' needs imex_form=True and "
                                 "func2")
            tab = get_ark_tableau(self.opts.get_string("ts_arkimex_type"))
            f_im, f_ex = self.f
            return ARKIMEX(tab, f_im, f_ex, setup, mass=self.mass,
                           fused_ex_spec=self._fused_ex_spec)
        if meth in THETA_METHODS or meth in _THETA_TS_TYPES:
            theta = THETA_METHODS.get(meth, _THETA_TS_TYPES.get(meth))
            return Theta(theta, self.f, setup, mass=self.mass)
        tab = get_rk_tableau(meth)
        if self.mass is not None:
            raise ValueError(
                "mass matrices require an implicit method (beuler/cn) — the "
                "reference has the same constraint (IFunction-based DAEs)")
        return ExplicitRK(tab, self.f)

    def _get_solve_fn(self, grid, with_adjoint: bool):
        # t0/dt0 are part of the key: prepare() linearizes at t0 and
        # pre-inverts the stage operator for dt0
        n0 = int(grid.n_steps)
        uniform = n0 > 0 and bool(
            np.allclose(grid.dts, grid.dts[0], rtol=1e-12, atol=0.0))
        key = (
            n0,
            tuple(int(i) for i in grid.out_idx),
            with_adjoint,
            float(grid.ts[0]) if n0 > 0 else 0.0,
            float(grid.dts[0]) if uniform else None,
        )
        fn = self._cache.get(key)
        if fn is None:
            fn = make_odeint(self._stepper, grid, self.traj,
                             with_adjoint=with_adjoint, dtype=self.dtype)
            self._cache[key] = fn
        return fn

    def _prep_times(self, t):
        # `t` is host-side schedule data: memoize the host copy by identity
        # (training loops reuse one `t`), so a device `t` is read once
        memo = getattr(self, "_t_memo", None)
        if memo is not None and memo[0] is t:
            t_np = memo[1]
        else:
            if isinstance(t, torch.Tensor):
                t_np = t.detach().cpu().numpy().astype(np.float64).reshape(-1)
            else:
                t_np = np.asarray(t, dtype=np.float64).reshape(-1)
            self._t_memo = (t, t_np)
        if t_np.shape[0] == 1:
            # single output time: integrate [0, t0], return the endpoint
            return np.array([0.0, float(t_np[0])]), slice(1, 2)
        return t_np, slice(None)

    def _build_adapt_cfg(self):
        """(AdaptConfig, dt0) from the options database."""
        from .adaptive import AdaptConfig

        if not hasattr(self._stepper, "step_embedded"):
            raise ValueError(
                "-ts_adapt_type basic needs an embedded error estimate; "
                f"method {self.method!r} has none (use an embedded RK "
                "(bosh3/dopri5) or an ARK pair with b_err, or "
                "-ts_adapt_type none)")
        tab = getattr(self._stepper, "tab", None)
        order = getattr(tab, "order", 5) if tab is not None else 2
        # -ts_adapt_clip low,high (PETSc TSAdaptSetClip)
        clip = self.opts.get_string("ts_adapt_clip", "")
        lo, hi = 0.1, 10.0
        if clip:
            parts = [p for p in clip.replace(",", " ").split() if p]
            if len(parts) == 2:
                lo, hi = float(parts[0]), float(parts[1])
            else:
                warnings.warn(
                    f"-ts_adapt_clip expects 'low,high'; got {clip!r}")
        cfg = AdaptConfig(
            rtol=self.opts.get_real("ts_rtol", 1e-4),
            atol=self.opts.get_real("ts_atol", 1e-4),
            safety=self.opts.get_real("ts_adapt_safety", 0.9),
            dt_min_factor=lo,
            dt_max_factor=hi,
            max_steps=min(self.max_steps,
                          self.opts.get_int("ts_adapt_max_steps", 4096)),
            order=order,
            controller="pi" if self.adapt_type == "pi" else "basic",
        )
        dt0 = (float(self.step_size[0])
               if isinstance(self.step_size, (list, tuple))
               else float(self.step_size))
        return cfg, dt0

    def _get_adaptive_fn(self, t_full, with_adjoint: bool):
        from .adaptive import make_adaptive_odeint

        key = ("adaptive", tuple(float(x) for x in t_full), with_adjoint,
               self.traj)
        fn = self._cache.get(key)
        if fn is None:
            cfg, dt0 = self._build_adapt_cfg()
            fn = make_adaptive_odeint(self._stepper, t_full, cfg, dt0,
                                      with_adjoint=with_adjoint,
                                      traj=self.traj)
            self._cache[key] = fn
        return fn

    def solve(self, u0, t, params=None, with_adjoint: Optional[bool] = None,
              dt0=None):
        """Functional solve: returns (solution, stats); differentiable when
        ``with_adjoint`` (the default follows ``enable_adjoint``).

        ``dt0`` (adaptive mode only) overrides the controller's initial
        step for this solve: ``stats.dt_first`` of the previous solve of the
        same window warm-starts it (a training loop), where the end-of-
        window ``stats.dt_last`` would re-pay the initial rejection descent
        each time. PETSc resets dt every TSSolve; the warm start goes beyond
        the reference's operating mode.
        """
        if not self._configured:
            raise RuntimeError("call setupTS before odeint")
        if with_adjoint is None:
            with_adjoint = self.enable_adjoint
        t_full, sel = self._prep_times(t)
        if self.adapt_type not in (None, "none"):
            fn = self._get_adaptive_fn(t_full, with_adjoint)
            y0 = torch.as_tensor(u0, dtype=self.dtype, device=self.device)
            p = self._get_params() if params is None else params
            outputs, stats = fn(y0, p) if dt0 is None else fn(y0, p, dt0)
            self.last_stats = stats
            return outputs[sel], stats
        if dt0 is not None:
            raise ValueError("dt0 is an adaptive-mode argument "
                             "(-ts_adapt_type basic/pi)")
        grid = build_time_grid(t_full, self.step_size,
                               max_steps=self.max_steps)
        fn = self._get_solve_fn(grid, with_adjoint)
        y0 = torch.as_tensor(u0, dtype=self.dtype, device=self.device)
        p = self._get_params() if params is None else params
        outputs, stats = fn(y0, p)
        self.nfe_forward += grid.n_steps * self._stepper.nfe_per_step
        self.last_stats = stats
        return outputs[sel], stats

    # -- reference-parity entry points ----------------------------------

    def odeint(self, u0, t, params=None):
        """Forward solve without adjoint bookkeeping: differentiable by
        autograd through the steps (the JAX package's ``solve_noadj``)."""
        sol, _ = self.solve(u0, t, params=params, with_adjoint=False)
        return sol

    def odeint_adjoint(self, u0, t, params=None):
        """Forward solve whose gradients run the discrete adjoint."""
        if not self.enable_adjoint:
            warnings.warn("odeint_adjoint called with enable_adjoint=False; "
                          "enabling")
            self.enable_adjoint = True
        sol, _ = self.solve(u0, t, params=params, with_adjoint=True)
        return sol


# Reference-compatible alias
ODEPnode = ODESolver
