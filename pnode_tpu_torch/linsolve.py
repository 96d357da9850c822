"""Dense linear solves for implicit stages (the reference's "torch"/"hpddm").

Counterpart of ``pnode_tpu/linsolve.py:142-391``:

- ``"direct"`` (reference "torch", cached dense LU): per-block dense
  Jacobians, factored once per solve or once per odeint when the Jacobian
  is frozen.
- ``"block"`` (reference "hpddm"): one shared (d, d) block assembled from
  the first batch row and applied to every row.
- ``"gmres"`` (reference "petsc", matrix-free GMRES) is ROADMAP queue A
  slice 4 and raises here.

Jacobians are assembled with ``torch.func.jacfwd`` at >= fp32 and the
stage operators are factored or inverted at >= fp32: the operators are
stiff, and a reduced-precision stage operator corrupts every solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


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
    """Build the (sigma*M - gamma*J) solver at linearization point ``y_flat``."""
    if cfg.kind == "gmres":
        raise NotImplementedError(
            "the matrix-free GMRES stage solver (linear_solver petsc/gmres) "
            "is ROADMAP queue A slice 4; use linear_solver hpddm or torch")
    J_blocks = (cached_J_blocks if cached_J_blocks is not None
                else assemble_block_jacobian(f_flat, y_flat, cfg,
                                             cfg.kind == "block"))
    mass_blocks = None if mass_flat is None else mass_flat[None]
    return DenseStageSolver(J_blocks, mass_blocks, sigma, gamma,
                            int(y_flat.shape[0]))
