"""Model builders and the base density for FFJORD training.

Counterpart of ``pnode_tpu/ffjord/model_builders.py`` (the reference's
``train_misc.py``): ``build_model_tabular``, a chain of CNF blocks with
optional MovingBatchNorm between them, and the standard-normal
log-density.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .cnf import CNF
from .flows import CNFLayer, MovingBatchNorm, SequentialFlow
from .odefunc import ODEnet


def standard_normal_logprob(z: torch.Tensor) -> torch.Tensor:
    """Per-sample log N(0, I) density, summed over the feature dims."""
    logz = -0.5 * math.log(2 * math.pi)
    return torch.sum(logz - 0.5 * z ** 2, dim=tuple(range(1, z.ndim)))


def build_model_tabular(
    dim: int,
    num_blocks: int = 1,
    hidden_dims: Sequence[int] = (64, 64),
    layer_type: str = "concatsquash",
    nonlinearity: str = "softplus",
    time_length: float = 0.5,
    solver: str = "dopri5",
    step_size: float = 0.05,
    batch_norm: bool = False,
    bn_lag: float = 0.0,
    rademacher: bool = False,
    regularization_fns: Sequence[str] = (),
    solver_options: Optional[dict] = None,
    device="cuda",
    dtype=None,
) -> SequentialFlow:
    """A chain of CNF blocks (with MovingBatchNorm before and after each
    where ``batch_norm``), the reference's ``build_model_tabular``. The
    weights are drawn from torch's default generator on the CPU, then
    moved to ``device``."""

    def make_cnf():
        net = ODEnet(hidden_dims=tuple(hidden_dims), input_dim=dim,
                     layer_type=layer_type, nonlinearity=nonlinearity)
        return CNFLayer(CNF(
            net, input_dim=dim, T=time_length, solver=solver,
            step_size=step_size, rademacher=rademacher,
            regularization_fns=regularization_fns,
            solver_options=solver_options, device=device, dtype=dtype))

    layers = [make_cnf() for _ in range(num_blocks)]
    if batch_norm:
        def bn():
            return MovingBatchNorm(dim, bn_lag=bn_lag, device=device,
                                   dtype=dtype)

        chained = [bn()]
        for cnf in layers:
            chained += [cnf, bn()]
        layers = chained
    return SequentialFlow(layers)
