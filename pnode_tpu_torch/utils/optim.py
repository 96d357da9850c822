"""Optimizers in the JAX package's (optax's) form, where torch's differs.

``RMSprop`` is ``optax.rmsprop(lr)`` at its defaults, which the spiral
trainers use: decay 0.9, the second moment from 0, and eps 1e-8 inside
the square root::

    nu <- decay nu + (1 - decay) g^2
    p  <- p - lr g / sqrt(nu + eps)

``torch.optim.RMSprop`` puts eps outside the root and decays at 0.99, so
its first steps, with nu ~ 0.1 g^2, move the weights differently.
"""

from __future__ import annotations

import torch


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, initial_scale)`` (no momentum, not
    centered, no bias correction)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                nu = state["nu"]
                nu.mul_(decay).add_((1.0 - decay) * (p.grad * p.grad))
                p.sub_(lr * (p.grad * torch.rsqrt(nu + eps)))
        return loss
