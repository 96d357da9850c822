"""Flow containers and the non-ODE flow layers.

Counterpart of ``pnode_tpu/ffjord/flows.py``: ``SequentialFlow`` (the
reference's ``container.py``), ``MovingBatchNorm`` (``normalization.py``),
the elementwise ZeroMean / Logit / Sigmoid transforms (``elemwise.py``)
and ``SqueezeLayer`` (``squeeze.py``), with ``CNFLayer`` embedding a CNF.

Every layer follows one protocol, the JAX package's with the parameters in
the module::

    layer.init_state(x) -> state (a dict; {} if stateless)
    layer.apply(x, delta, state, training=True, reverse=False, **kw)
        -> (y, delta', new_state)

``delta`` accumulates the log-density change with the reference's
convention ``log p_x(x) = log p_z(z) - delta``; ``state`` carries running
statistics (MovingBatchNorm) and is threaded by the caller, so the flow
state stays explicit as in the JAX package. The CNF layers also take
``generator=`` or ``probe=`` (the Hutchinson probe); the others ignore
them. ``apply`` shadows ``nn.Module.apply`` (the recursive ``fn`` map) on
these classes, as the JAX package's name for a layer's evaluation;
calling a layer runs it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .layers import on_device


class FlowLayer(nn.Module):
    def init_state(self, x):
        return {}

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        raise NotImplementedError

    def forward(self, *args, **kw):
        return self.apply(*args, **kw)


class CNFLayer(FlowLayer):
    """A CNF block in a flow chain."""

    def __init__(self, cnf):
        super().__init__()
        self.cnf = cnf
        self.last_regs = None
        self.last_stats = None

    def apply(self, x, delta, state, training=True, reverse=False,
              exact_div=False, generator=None, probe=None, **kw):
        (z, dlp, regs), stats = self.cnf.apply(
            x, training=training, reverse=reverse, exact_div=exact_div,
            generator=generator, probe=probe)
        self.last_regs = regs
        self.last_stats = stats
        # each direction measures its own -int div; accumulating it makes a
        # forward and reverse round trip cancel
        return z, delta + dlp, state


class MovingBatchNorm(FlowLayer):
    """Affine normalization with running statistics and the exact log-det.
    ``log_gamma`` and ``beta`` are parameters; the running mean and
    variance live in the flow state (``init_state``)."""

    def __init__(self, dim: int, bn_lag: float = 0.0, decay: float = 0.1,
                 affine: bool = True, eps: float = 1e-4, device="cuda",
                 dtype=None):
        super().__init__()
        self.dim = dim
        self.decay = decay
        self.bn_lag = bn_lag
        self.affine = affine
        self.eps = eps
        if affine:
            self.log_gamma = nn.Parameter(torch.zeros(dim))
            self.beta = nn.Parameter(torch.zeros(dim))
        on_device(self, device, dtype)

    def init_state(self, x):
        kw = dict(dtype=x.dtype, device=x.device)
        return {"running_mean": torch.zeros(self.dim, **kw),
                "running_var": torch.ones(self.dim, **kw)}

    def apply(self, x, logpx, state, training=True, reverse=False, **kw):
        if reverse:
            return self._reverse(x, logpx, state)
        if training:
            mean = torch.mean(x, dim=0)
            var = torch.var(x, dim=0, unbiased=False)
            new_state = {
                "running_mean": (1 - self.decay) * state["running_mean"]
                + self.decay * mean,
                "running_var": (1 - self.decay) * state["running_var"]
                + self.decay * var,
            }
            use_mean, use_var = mean, var
        else:
            new_state = state
            use_mean, use_var = state["running_mean"], state["running_var"]
        y = (x - use_mean) / torch.sqrt(use_var + self.eps)
        ldj = -0.5 * torch.log(use_var + self.eps)
        if self.affine:
            y = y * torch.exp(self.log_gamma) + self.beta
            ldj = ldj + self.log_gamma
        # log p_x = log p_y + sum(ldj)  =>  delta -= sum(ldj)
        return y, logpx - torch.sum(ldj) * torch.ones_like(logpx), new_state

    def _reverse(self, y, delta, state):
        use_mean, use_var = state["running_mean"], state["running_var"]
        ldj = -0.5 * torch.log(use_var + self.eps)
        if self.affine:
            y = (y - self.beta) * torch.exp(-self.log_gamma)
            ldj = ldj + self.log_gamma
        x = y * torch.sqrt(use_var + self.eps) + use_mean
        return x, delta + torch.sum(ldj) * torch.ones_like(delta), state


class ZeroMeanTransform(FlowLayer):
    """x -> x - 0.5 (image preprocessing; zero log-det)."""

    def apply(self, x, logpx, state, training=True, reverse=False, **kw):
        return (x + 0.5 if reverse else x - 0.5), logpx, state


class LogitTransform(FlowLayer):
    """x -> logit(alpha + (1 - 2 alpha) x) with the exact log-det (the
    image pipelines' dequantization transform)."""

    def __init__(self, alpha: float = 0.05):
        super().__init__()
        self.alpha = alpha

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        a = self.alpha
        log_scale = math.log(1 - 2 * a)

        def acc(delta, ldj):
            d = torch.sum(ldj, dim=tuple(range(1, ldj.ndim)))
            return delta - d.reshape(delta.shape[0], *([1] * (delta.ndim - 1)))

        if reverse:
            s = torch.sigmoid(x)
            y = (s - a) / (1 - 2 * a)
            ldj = torch.log(s) + torch.log1p(-s) - log_scale
            return y, acc(delta, ldj), state
        s = a + (1 - 2 * a) * x
        y = torch.log(s) - torch.log1p(-s)
        ldj = log_scale - torch.log(s) - torch.log1p(-s)
        return y, acc(delta, ldj), state


class SigmoidTransform(FlowLayer):
    """The inverse of LogitTransform(alpha=0)."""

    def apply(self, x, logpx, state, training=True, reverse=False, **kw):
        return LogitTransform(0.0).apply(x, logpx, state,
                                         reverse=not reverse)


class SqueezeLayer(FlowLayer):
    """Space to channel, NHWC: (B, H, W, C) -> (B, H/2, W/2, 4C), channels
    in the JAX package's order; volume preserving."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def apply(self, x, logpx, state, training=True, reverse=False, **kw):
        f = self.factor
        b, h, w, c = x.shape
        if reverse:
            c2 = c // (f * f)
            y = x.reshape(b, h, w, f, f, c2).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, h * f, w * f, c2)
        else:
            y = x.reshape(b, h // f, f, w // f, f, c)
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f,
                                                    f * f * c)
        return y, logpx, state


class SequentialFlow(nn.Module):
    """A chain of FlowLayers threading (x, logpx, state); reverse runs the
    chain backwards. ``generator`` is passed to every layer (each CNF draws
    its probe from it when it runs); ``probes[i]``, where given, is layer
    i's probe."""

    def __init__(self, layers: Sequence[FlowLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def init_state(self, x):
        return [layer.init_state(x) for layer in self.layers]

    def forward(self, *args, **kw):
        return self.apply(*args, **kw)

    def apply(self, x, logpx=None, states=None, training=True, reverse=False,
              generator: Optional[torch.Generator] = None, probes=None,
              **kw):
        if logpx is None:
            logpx = torch.zeros((x.shape[0], 1), dtype=x.dtype,
                                device=x.device)
        if states is None:
            states = self.init_state(x)
        n = len(self.layers)
        idx = range(n - 1, -1, -1) if reverse else range(n)
        new_states = list(states)
        for i in idx:
            x, logpx, new_states[i] = self.layers[i].apply(
                x, logpx, states[i], training=training, reverse=reverse,
                generator=generator,
                probe=None if probes is None else probes[i], **kw)
        return x, logpx, new_states
