"""Non-ODE flow layers: affine coupling, planar flow, spectral norm.

Counterpart of ``pnode_tpu/ffjord/other_flows.py`` (the reference's
``coupling.py``, ``planar.py``, ``glow.py`` and ``spectral_norm.py``): the
discrete flow baselines the FFJORD paper compares against and
power-iteration spectral normalization. They follow the FlowLayer protocol
of ``flows.py`` (``log p_x(x) = log p_z(z) - delta``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .flows import FlowLayer
from .layers import dense, lecun_normal_, on_device


class _CouplingNet(nn.Module):
    """ReLU MLP whose last layer starts at zero (identity coupling)."""

    def __init__(self, d_in: int, hidden: Sequence[int], out_dim: int):
        super().__init__()
        dims = (d_in,) + tuple(hidden)
        self.layers = nn.ModuleList(dense(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.layers.append(dense(dims[-1], 2 * out_dim))
        with torch.no_grad():
            self.layers[-1].weight.zero_()

    def forward(self, x):
        h = x
        for lin in self.layers[:-1]:
            h = F.relu(lin(h))
        return self.layers[-1](h)


class CouplingLayer(FlowLayer):
    """Affine coupling (RealNVP): one half conditions the scale and shift
    of the other; exact log-det."""

    def __init__(self, dim: int, hidden: Sequence[int] = (64, 64),
                 swap: bool = False, device="cuda", dtype=None):
        super().__init__()
        self.dim = dim
        self.d = dim // 2
        self.swap = swap
        # the net's output sized dim - dim // 2 in either order, as in the
        # JAX layer
        self.net = _CouplingNet(dim - self.d if swap else self.d, hidden,
                                dim - self.d)
        on_device(self, device, dtype)

    def _split(self, x):
        if self.swap:
            return x[:, self.d:], x[:, : self.d]
        return x[:, : self.d], x[:, self.d:]

    def _merge(self, a, b):
        return torch.cat([b, a] if self.swap else [a, b], dim=1)

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        a, b = self._split(x)
        sb = self.net(a)
        shift, log_scale = sb[:, : b.shape[1]], sb[:, b.shape[1]:]
        log_scale = torch.tanh(log_scale)  # bounded scales, stable training
        if reverse:
            b_new = (b - shift) * torch.exp(-log_scale)
            delta = delta + torch.sum(log_scale, dim=1, keepdim=True)
        else:
            b_new = b * torch.exp(log_scale) + shift
            delta = delta - torch.sum(log_scale, dim=1, keepdim=True)
        return self._merge(a, b_new), delta, state


def sample_mask(dim: int, mask_type: str = "alternate", swap: bool = False):
    """Binary conditioning mask: 'alternate' = MAF index masking (even
    indices 1), 'channel' = the RealNVP half split."""
    mask = torch.zeros(dim)
    if mask_type == "alternate":
        mask[::2] = 1.0
    elif mask_type == "channel":
        mask[: dim // 2] = 1.0
    else:
        raise ValueError(f"Unknown mask_type {mask_type!r}")
    return 1.0 - mask if swap else mask


class _MaskedNet(nn.Module):
    def __init__(self, d_in: int, hidden: Sequence[int], out_dim: int,
                 activation: str):
        super().__init__()
        self.act = F.relu if activation == "relu" else torch.tanh
        dims = (d_in,) + tuple(hidden) + (out_dim,)
        self.layers = nn.ModuleList(dense(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        h = x
        for lin in self.layers[:-1]:
            h = self.act(lin(h))
        return self.layers[-1](h)


class MaskedCouplingLayer(FlowLayer):
    """Masked affine coupling (the tabular experiments): the masked input
    conditions an elementwise exp-scale (tanh net) and shift (ReLU net);
    masked positions pass through, so log|det| sums the unmasked
    log-scales."""

    def __init__(self, dim: int, hidden: Sequence[int] = (64, 64),
                 mask_type: str = "alternate", swap: bool = False,
                 device="cuda", dtype=None):
        super().__init__()
        self.dim = dim
        self.register_buffer("mask", sample_mask(dim, mask_type, swap)[None])
        self.net_scale = _MaskedNet(dim, hidden, dim, "tanh")
        self.net_shift = _MaskedNet(dim, hidden, dim, "relu")
        on_device(self, device, dtype)

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        mask = self.mask.to(x.dtype)
        xm = x * mask
        masked_log_s = self.net_scale(xm) * (1.0 - mask)
        masked_shift = self.net_shift(xm) * (1.0 - mask)
        logdet = torch.sum(masked_log_s, dim=1, keepdim=True)
        if reverse:
            y = (x - masked_shift) * torch.exp(-masked_log_s)
            delta = delta + logdet
        else:
            y = x * torch.exp(masked_log_s) + masked_shift
            delta = delta - logdet
        return y, delta, state


class PlanarFlow(FlowLayer):
    """Planar flow x + u tanh(w.x + b); invertibility by the u-hat
    reparameterization. Forward only: the inverse has no closed form (the
    reference has the same restriction)."""

    def __init__(self, dim: int, device="cuda", dtype=None):
        super().__init__()
        self.dim = dim
        self.u = nn.Parameter(0.1 * torch.randn(dim))
        self.w = nn.Parameter(0.1 * torch.randn(dim))
        self.b = nn.Parameter(torch.zeros(()))
        on_device(self, device, dtype)

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        if reverse:
            raise ValueError("planar flows have no closed-form inverse")
        u, w, b = self.u, self.w, self.b
        # u-hat: w.u >= -1 for invertibility
        wu = torch.dot(w, u)
        m = -1.0 + F.softplus(wu)
        u_hat = u + (m - wu) * w / torch.clamp(torch.dot(w, w), min=1e-12)
        lin = x @ w + b
        y = x + u_hat[None, :] * torch.tanh(lin)[:, None]
        psi = (1 - torch.tanh(lin) ** 2)[:, None] * w[None, :]
        det = 1.0 + psi @ u_hat
        delta = delta - torch.log(torch.abs(det) + 1e-12)[:, None]
        return y, delta, state


def spectral_normalize(kernel: torch.Tensor, u, n_iters: int = 1,
                       eps: float = 1e-12):
    """Power iteration on the (in, out) kernel; returns (W / sigma, new_u).
    The estimate vector u is explicit state threaded by the caller."""
    W = kernel.reshape(-1, kernel.shape[-1])  # (in, out)
    for _ in range(n_iters):
        v = W @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = W.T @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = v @ (W @ u)
    return kernel / torch.clamp(sigma, min=eps), u


class SpectralDense(nn.Module):
    """Dense layer with spectral normalization: the kernel in flax's
    (in, out) layout, the power iteration's vector in the buffer ``u``,
    updated (without gradient) by every call, as the JAX layer updates its
    ``spectral`` collection."""

    def __init__(self, in_features: int, features: int,
                 n_power_iterations: int = 1):
        super().__init__()
        self.n_power_iterations = n_power_iterations
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        lecun_normal_(self.kernel, in_features)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.randn(features))

    def forward(self, x):
        W_sn, new_u = spectral_normalize(self.kernel, self.u.to(x.dtype),
                                         self.n_power_iterations)
        with torch.no_grad():
            self.u.copy_(new_u)
        return x @ W_sn + self.bias


class BruteForceLayer(FlowLayer):
    """Invertible dense linear flow with the exact log|det| (glow's 1x1
    without the LU parameterization): y = x W^T, delta -= log|det W|; the
    weight starts at the identity, the reverse materializes the inverse."""

    def __init__(self, dim: int, device="cuda", dtype=None):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.eye(dim))
        on_device(self, device, dtype)

    def apply(self, x, delta, state, training=True, reverse=False, **kw):
        W = self.weight
        _, logdet = torch.linalg.slogdet(W)
        ld = logdet * torch.ones_like(delta)
        if reverse:
            return x @ torch.linalg.inv(W).T, delta + ld, state
        return x @ W.T, delta - ld, state
