"""Optimizers in the JAX package's (optax's) form, where torch's differs.

``RMSprop`` is ``optax.rmsprop(lr)`` at its defaults, which the spiral
trainers use: decay 0.9, the second moment from 0, and eps 1e-8 inside
the square root::

    nu <- decay nu + (1 - decay) g^2
    p  <- p - lr g / sqrt(nu + eps)

``torch.optim.RMSprop`` puts eps outside the root and decays at 0.99, so
its first steps, with nu ~ 0.1 g^2, move the weights differently.

``FlatAdam`` (exported as ``utils.flat_adam``) is
``pnode_tpu/utils/optim.py``'s Adam whose moments are stored in
``moment_dtype``: fp32 (exactly optax's Adam: the same update expression,
the bias corrections ``1 - b ** count`` in fp32 from the integer count) or
bf16 (half the optimizer state's bytes; the moments are upcast for fp32
update math and rounded back to bf16 on store, ~0.4% relative rounding).
The parameters stay in their own dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

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


_MOMENT_DTYPES = {None: torch.float32, "f32": torch.float32,
                  "float32": torch.float32, "bf16": torch.bfloat16,
                  "bfloat16": torch.bfloat16}


class FlatAdam(torch.optim.Optimizer):
    """Adam with moments stored in ``moment_dtype`` (None / "f32" or
    "bf16"); ``lr`` a float or a callable of the step count (1, 2, ...),
    as an optax schedule. Per parameter, with the count t::

        m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2      (fp32)
        p <- p - lr(t) (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    then m and v are rounded to the moment dtype."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: Optional[str] = None):
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype {moment_dtype!r}: use f32|bf16")
        self.moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self.count = 0
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        self.count += 1
        t, f32 = self.count, torch.float32
        for group in self.param_groups:
            lr = group["lr"](t) if callable(group["lr"]) else group["lr"]
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            b1c = 1.0 - torch.tensor(b1, dtype=f32) ** t
            b2c = 1.0 - torch.tensor(b2, dtype=f32) ** t
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                g = p.grad.to(f32)
                m = b1 * state["mu"].to(f32) + (1.0 - b1) * g
                v = b2 * state["nu"].to(f32) + (1.0 - b2) * (g * g)
                upd = -lr * (m / b1c.to(g.device)) / (
                    torch.sqrt(v / b2c.to(g.device)) + eps)
                p.add_(upd.to(p.dtype))
                state["mu"] = m.to(self.moment_dtype)
                state["nu"] = v.to(self.moment_dtype)
        return loss
