"""Linear solves for implicit stages: matrix-free GMRES, dense LU, block LU.

Counterpart of ``pnode_tpu/linsolve.py``:

- ``"gmres"`` (reference "petsc"): restarted GMRES (``gmres``) on the
  matrix-free stage operator. J v is ``torch.func.jvp`` of the vector
  field at the linearization point; J^T v is the function
  ``torch.func.vjp`` returns, built once per solver, for the adjoint's
  transposed solves.
- ``"direct"`` (reference "torch", cached dense LU): per-block dense
  Jacobians, factored once per solve or once per odeint when the Jacobian
  is frozen.
- ``"block"`` (reference "hpddm"): one shared (d, d) block assembled from
  the first batch row and applied to every row.

Jacobians are assembled with ``torch.func.jacfwd`` at >= fp32 and the
stage operators are factored or inverted at >= fp32: the operators are
stiff, and a reduced-precision stage operator corrupts every solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class GMRESResult(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor
    iters: int
    converged: bool


def _safe_normalize(v, eps):
    nrm = torch.linalg.norm(v)
    ok = nrm > eps
    return torch.where(ok, v / torch.where(ok, nrm, torch.ones_like(nrm)),
                       torch.zeros_like(v))


def _lstsq_hessenberg(H, rhs, rcond):
    """argmin_y ||H y - rhs|| for the Arnoldi matrix H (m+1, m), on H's
    device and without a host read.

    The JAX package solves it with ``jnp.linalg.lstsq`` (an SVD, the
    minimum-norm solution with singular values below ``rcond * s_max``
    dropped). ``torch.linalg.lstsq`` on CUDA solves only full-rank
    problems (``gels``), and ``torch.linalg.svd`` / ``pinv`` read an error
    flag back to the host. So: Householder QR, with the columns whose
    |R_jj| falls below ``rcond * max |R_jj|`` dropped (their y_j = 0).
    After a breakdown the masked Arnoldi steps leave H's trailing columns
    exactly zero; dropping them is the minimum-norm solution, as the SVD's
    is."""
    Q, R = torch.linalg.qr(H)
    d = R.diagonal().abs()
    keep = (d > 0) & (d >= rcond * d.max())
    kf = keep.to(H.dtype)
    R = R * kf[:, None] * kf[None, :] + torch.diag(1.0 - kf)
    c = (Q.T @ rhs) * kf
    return torch.linalg.solve_triangular(R, c[:, None], upper=True)[:, 0]


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    rtol: float = 1e-5,
    atol: float = 0.0,
    restart: int = 30,
    max_restarts: int = 10,
) -> GMRESResult:
    """Restarted GMRES, the algorithm of ``pnode_tpu.linsolve.gmres``.

    Each cycle runs m = min(restart, n) Arnoldi steps, orthogonalized by
    classical Gram-Schmidt twice over the whole basis with the rows past
    the step masked (CGS2); a breakdown lane is masked to a zero vector,
    not exited; then the (m+1, m) least-squares problem
    (``_lstsq_hessenberg``). Convergence is tested only between cycles,
    and ``iters = cycles * m``. The host reads the residual norm once
    before the first cycle and once after each: nothing inside a cycle
    waits for the device. The residual each test reads starts the next
    cycle, and with no ``x0`` the first residual is ``b`` itself (A 0 =
    0): the JAX loop's iterates with one matvec fewer per cycle.
    """
    n = b.shape[0]
    dtype = b.dtype
    m = int(min(restart, n))
    eps = torch.finfo(dtype).tiny * 1e3
    rcond = torch.finfo(dtype).eps * (m + 1)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    target = torch.clamp(rtol * torch.linalg.norm(b), min=atol)
    rows = torch.arange(m + 1, device=b.device)

    def cycle(x, r0):
        beta = torch.linalg.norm(r0)
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
        V[0] = _safe_normalize(r0, eps)
        for j in range(m):
            w = matvec(V[j])
            mask = (rows <= j).to(dtype)
            h1 = (V @ w) * mask
            w = w - V.T @ h1
            h2 = (V @ w) * mask
            w = w - V.T @ h2
            hcol = h1 + h2
            hcol[j + 1] = torch.linalg.norm(w)
            V[j + 1] = _safe_normalize(w, eps)
            H[:, j] = hcol
        e1 = torch.zeros(m + 1, dtype=dtype, device=b.device)
        e1[0] = beta
        return x + V[:m].T @ _lstsq_hessenberg(H, e1, rcond)

    rnorm = torch.linalg.norm(r)
    r_h, t_h = torch.stack([rnorm, target.to(rnorm.dtype)]).tolist()
    cycles = 0
    while r_h > t_h and cycles < max_restarts:
        x = cycle(x, r)
        r = b - matvec(x)
        rnorm = torch.linalg.norm(r)
        r_h = float(rnorm)
        cycles += 1
    return GMRESResult(x=x, resnorm=rnorm, iters=cycles * m,
                       converged=r_h <= max(t_h, eps))


@dataclass(frozen=True)
class LinearSolveConfig:
    """Static configuration resolved from ``setupTS`` kwargs + runtime options.

    kind: "gmres" | "direct" | "block" (reference petsc/torch/hpddm).
    """

    kind: str = "gmres"
    rtol: float = 1e-5
    atol: float = 0.0
    restart: int = 30
    max_restarts: int = 10
    # block size d of the block-diagonal batch structure (state elements per
    # batch sample); 0 means "whole system is one block"
    block_size: int = 0
    fixed_jacobian: bool = False

    def blocks_of(self, n: int) -> tuple:
        d = self.block_size if self.block_size > 0 else n
        if n % d != 0:
            raise ValueError(f"state size {n} not divisible by block size {d}")
        return n // d, d


def normalize_linear_solver_name(name: str) -> str:
    aliases = {
        "petsc": "gmres",
        "gmres": "gmres",
        "torch": "direct",
        "direct": "direct",
        "lu": "direct",
        "hpddm": "block",
        "block": "block",
    }
    if name not in aliases:
        raise ValueError(
            f"unknown linear_solver {name!r}; expected one of {sorted(aliases)}"
        )
    return aliases[name]


def _promoted(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def assemble_block_jacobian(f_flat, y_flat, cfg: LinearSolveConfig,
                            shared: bool) -> torch.Tensor:
    """Dense Jacobian(s) of the flat vector field, exploiting batch structure.

    f_flat: flat -> flat vector field (t already bound). Returns (batch, d, d)
    per-sample Jacobians, or (1, d, d) when ``shared`` (the Jacobian of the
    first batch row, applied to every row).
    """
    y_flat = _promoted(y_flat).detach()
    n = y_flat.shape[0]
    batch_size, d = cfg.blocks_of(n)
    if batch_size <= 1:
        return torch.func.jacfwd(f_flat)(y_flat)[None].contiguous()
    rows = y_flat.reshape(batch_size, d)

    def f_row(row, idx):
        full = torch.cat([rows[:idx], row[None], rows[idx + 1:]])
        return f_flat(full.reshape(-1)).reshape(batch_size, d)[idx]

    if shared:
        return torch.func.jacfwd(lambda r: f_row(r, 0))(rows[0])[None].contiguous()
    return torch.stack([
        torch.func.jacfwd(lambda r, i=i: f_row(r, i))(rows[i])
        for i in range(batch_size)
    ])


class GMRESStageSolver:
    """Matrix-free solve of (sigma*M - gamma*J) v = rhs by restarted GMRES
    (counterpart of ``pnode_tpu/linsolve.py:295-345``).

    J v is ``torch.func.jvp`` of ``f_flat`` at ``y_flat`` (forward mode,
    so a stencil on K10 runs its ``jvp`` rule: K10 on the tangent); J^T v
    is the pullback ``torch.func.vjp`` returns (K11 for that stencil),
    built once per solver, as the JAX solver builds its ``vjp_fun`` once:
    at the first transposed apply, so a forward Newton iteration, which
    never transposes, does not pay a forward pass for it.
    ``last`` holds the ``GMRESResult`` of the latest solve."""

    def __init__(self, f_flat, y_flat, mass_matvec, mass_rmatvec, sigma,
                 gamma, cfg: LinearSolveConfig):
        self._cfg = cfg
        self._sigma = sigma
        self._gamma = gamma
        self._y = y_flat
        self._f = f_flat
        self._mass_mv = mass_matvec
        self._mass_rmv = mass_rmatvec
        self._vjp_fun = None
        self.last = None

    def _apply(self, v):
        _, jv = torch.func.jvp(self._f, (self._y,), (v,))
        mv = self._mass_mv(v) if self._mass_mv is not None else v
        # in v's dtype: forward mode through a 0-d tensor op with a Python
        # float (pendulum_dae's y[1] * y[4] - G) returns an fp64 tangent
        return self._sigma * mv - self._gamma * jv.to(v.dtype)

    def _apply_T(self, v):
        if self._vjp_fun is None:
            _, self._vjp_fun = torch.func.vjp(self._f, self._y)
        (jtv,) = self._vjp_fun(v)
        mv = self._mass_rmv(v) if self._mass_rmv is not None else v
        return self._sigma * mv - self._gamma * jtv.to(v.dtype)

    def _gmres(self, matvec, rhs_flat):
        cfg = self._cfg
        self.last = gmres(matvec, rhs_flat, rtol=cfg.rtol, atol=cfg.atol,
                          restart=cfg.restart, max_restarts=cfg.max_restarts)
        return self.last.x

    def solve(self, rhs_flat):
        return self._gmres(self._apply, rhs_flat)

    def solve_transpose(self, rhs_flat):
        return self._gmres(self._apply_T, rhs_flat)


class DenseStageSolver:
    """Dense solve of (sigma*M - gamma*J) per batch block.

    - LU factorization computed once per construction and reused across
      Newton iterations and (transposed) adjoint solves.
    - ``use_inverse=True``: invert the operator once so every solve is a
      single (batch, d) @ (d, d) product: the right trade whenever the
      operator is reused many times (frozen Jacobian + uniform dt), the
      reference's production stiff-PDE configuration, and the operand the
      fused step kernels take.
    """

    def __init__(self, J_blocks, mass_blocks, sigma, gamma, n,
                 use_inverse: bool = False):
        J_blocks = _promoted(J_blocks)
        d = J_blocks.shape[-1]
        eye = torch.eye(d, dtype=J_blocks.dtype, device=J_blocks.device)
        M = eye[None] if mass_blocks is None else mass_blocks.to(J_blocks.dtype)
        op = sigma * M - gamma * J_blocks
        self._shared = op.shape[0] == 1
        self._batch = n // d
        self._d = d
        self._inv = None
        if use_inverse:
            self._inv = torch.linalg.inv(op).contiguous()
        else:
            self._lu, self._piv = torch.linalg.lu_factor(op)

    def _solve(self, rhs_flat, trans: bool):
        r = rhs_flat.reshape(self._batch, self._d)
        if self._inv is not None:
            if self._shared:
                A = self._inv[0]
                x = r @ (A if trans else A.T)
            else:
                x = torch.einsum("bji,bj->bi" if trans else "bij,bj->bi",
                                 self._inv, r)
        elif self._shared:
            x = torch.linalg.lu_solve(self._lu[0], self._piv[0], r.T,
                                      adjoint=trans).T
        else:
            x = torch.linalg.lu_solve(self._lu, self._piv, r[..., None],
                                      adjoint=trans)[..., 0]
        return x.reshape(rhs_flat.shape)

    def solve(self, rhs_flat):
        return self._solve(rhs_flat, trans=False)

    def solve_transpose(self, rhs_flat):
        return self._solve(rhs_flat, trans=True)


def make_stage_solver(
    f_flat,
    y_flat,
    mass_flat: Optional[torch.Tensor],
    sigma,
    gamma,
    cfg: LinearSolveConfig,
    cached_J_blocks: Optional[torch.Tensor] = None,
):
    """Build the (sigma*M - gamma*J) solver at linearization point ``y_flat``.

    ``mass_flat``: the per-block mass matrix (d, d), applied to every
    batch block (None: the identity)."""
    if cfg.kind == "gmres":
        mass_mv = mass_rmv = None
        if mass_flat is not None:
            batch, d = cfg.blocks_of(int(y_flat.shape[0]))
            mass = mass_flat.to(y_flat.dtype)

            def mass_mv(v):
                return (v.reshape(batch, d) @ mass.T).reshape(-1)

            def mass_rmv(v):
                return (v.reshape(batch, d) @ mass).reshape(-1)

        return GMRESStageSolver(f_flat, y_flat, mass_mv, mass_rmv, sigma,
                                gamma, cfg)
    J_blocks = (cached_J_blocks if cached_J_blocks is not None
                else assemble_block_jacobian(f_flat, y_flat, cfg,
                                             cfg.kind == "block"))
    mass_blocks = None if mass_flat is None else mass_flat[None]
    return DenseStageSolver(J_blocks, mass_blocks, sigma, gamma,
                            int(y_flat.shape[0]))
