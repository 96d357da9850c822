"""Newton solves for implicit stages (PETSc SNES equivalent).

Counterpart of ``pnode_tpu/newton.py:26-122`` as a plain Python loop. With
``-snes_type ksponly`` one linearized solve is taken and convergence is
declared without evaluating the residual again (PETSc's behaviour), so the
ksponly path reads nothing back from the device. The loop is never
differentiated: the discrete adjoint transposes the converged
linearization instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class NewtonConfig:
    rtol: float = 1e-8
    atol: float = 1e-50
    stol: float = 1e-8
    max_it: int = 50
    ksponly: bool = False  # -snes_type ksponly: one linearized solve
    # -snes_ksponly_check: evaluate the residual after the ksponly solve
    ksponly_check: bool = False


class NewtonStats(NamedTuple):
    iters: int
    resnorm: Optional[float]
    converged: bool


def newton_solve(
    residual: Callable[[torch.Tensor], torch.Tensor],
    make_solver: Callable[[torch.Tensor], object],
    z0: torch.Tensor,
    cfg: NewtonConfig,
):
    """Solve residual(z) = 0 starting from z0.

    make_solver(z) returns an object whose ``.solve(r)`` applies the inverse
    of the stage operator (sigma*M - gamma*J) evaluated at ``z``.
    Returns (z, NewtonStats). ``resnorm`` is None on the plain ksponly path,
    which evaluates no norm.
    """
    r0 = residual(z0)
    eps = torch.finfo(z0.dtype).eps

    if cfg.ksponly:
        z = z0 - make_solver(z0).solve(r0)
        if not cfg.ksponly_check:
            return z, NewtonStats(iters=1, resnorm=None, converged=True)
        r0norm = float(torch.linalg.norm(r0))
        rnorm = float(torch.linalg.norm(residual(z)))
        target = max(cfg.rtol * r0norm, cfg.atol, 100 * eps * (1.0 + r0norm))
        return z, NewtonStats(iters=1, resnorm=rnorm,
                              converged=rnorm <= target)

    r0norm = float(torch.linalg.norm(r0))
    target = max(cfg.rtol * r0norm, cfg.atol)
    # the residual at z carries over to the next iteration's solve, and the
    # three norms the tests read come back in one host read
    z, r, rnorm, dznorm, znorm, it = z0, r0, r0norm, float("inf"), 0.0, 0
    while (rnorm > target and dznorm > cfg.stol * (1.0 + znorm)
           and it < cfg.max_it):
        delta = make_solver(z).solve(r)
        z = z - delta
        r = residual(z)
        rnorm, dznorm, znorm = torch.stack([
            torch.linalg.norm(r), torch.linalg.norm(delta),
            torch.linalg.norm(z)]).tolist()
        it += 1
    # success = residual criterion OR step-size criterion (a stol exit is
    # PETSc's CONVERGED_SNORM_RELATIVE, a success code)
    res_ok = rnorm <= max(target, 10 * eps * (1 + r0norm))
    step_ok = (dznorm <= cfg.stol * (1.0 + znorm)
               and rnorm == rnorm and abs(rnorm) != float("inf"))
    return z, NewtonStats(iters=it, resnorm=rnorm,
                          converged=res_ok or step_ok)
