"""SINODE KS model (PyTorch): learned stiff-PDE dynamics for the KS equation.

Counterpart of ``pnode_tpu/models/sinode.py:30-238``:

- ``KSFuncIM``: fixed (or learnable) 5-point circular stencil of
  -d^4/dx^4 - d^2/dx^2, the implicit part. Applied as rolls (the exact path:
  no conv1d, so cuDNN's TF32 default never touches the stiff operator).
- ``KSFuncEX``: -MLP(y), 64 -> 104 x4 -> 64 with ReLU, N(0, 0.01) weights and
  zero biases, the explicit part. ``use_fused=True`` evaluates the stack
  through K1 (``FusedStackedMLP``, parameters ``kernel_i`` (in, out) and
  ``bias_i`` as in JAX) and opts into the fused ARK step kernels through
  ``fused_mlp_spec``; ``use_fused=False`` uses ``nn.Linear`` layers.

Every module takes ``forward(t, y)`` and an explicit ``torch.Generator`` for
its random init, so weights are reproducible from a seed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.fused_mlp import fused_mlp, fused_mlp_plain


def ks_fixed_kernel(dx: float) -> np.ndarray:
    """5-point stencil of -(d^4/dx^4) - (d^2/dx^2) (KS linear operator)."""
    return np.array(
        [
            -1.0 / dx**4,
            4.0 / dx**4 - 1.0 / dx**2,
            -6.0 / dx**4 + 2.0 / dx**2,
            4.0 / dx**4 - 1.0 / dx**2,
            -1.0 / dx**4,
        ]
    )


def circular_stencil_apply(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Periodic cross-correlation along the last axis:
    out[i] = sum_j kernel[j] * y[(i + j - k//2) mod N], as k rolls."""
    k = kernel.shape[0]
    half = k // 2
    out = kernel[0] * torch.roll(y, half, dims=-1)
    for j in range(1, k):
        out = out + kernel[j] * torch.roll(y, half - j, dims=-1)
    return out


class CircularConv1D(nn.Module):
    """Single-channel circular conv (no bias); optionally a fixed stencil.

    fixed_kernel given -> a buffer, not a parameter; otherwise a parameter
    initialized U(-sqrt(1/k), sqrt(1/k)) like torch's Conv1d default.
    """

    def __init__(self, kernel_size: int = 5,
                 fixed_kernel: Optional[Sequence[float]] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        if fixed_kernel is not None:
            # not persistent: a fixed stencil is configuration, not state
            self.register_buffer(
                "fixed", torch.tensor(np.asarray(fixed_kernel),
                                      dtype=torch.float64, device=device),
                persistent=False)
            self.kernel = None
        else:
            bound = math.sqrt(1.0 / kernel_size)
            w = torch.empty(kernel_size, dtype=dtype, device=device)
            w.uniform_(-bound, bound, generator=generator)
            self.kernel = nn.Parameter(w)

    def forward(self, y):
        kernel = self.fixed if self.kernel is None else self.kernel
        return circular_stencil_apply(y, kernel.to(y.dtype))


def _normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class StackedMLP(nn.Module):
    """Dense stack (``nn.Linear``) with N(0, w_std) weights and zero bias."""

    def __init__(self, d_in: int, features: Sequence[int],
                 activation: str = "relu", w_std: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        dims = [d_in] + list(features)
        self.activation = activation
        self.layers = nn.ModuleList()
        for a, b in zip(dims, dims[1:]):
            lin = nn.Linear(a, b, dtype=dtype, device=device)
            _normal_(lin.weight, w_std, generator)
            with torch.no_grad():
                lin.bias.zero_()
            self.layers.append(lin)

    def forward(self, y):
        act = torch.relu if self.activation == "relu" else torch.tanh
        h = y
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            h = lin(h)
            if i < n - 1:
                h = act(h)
        return h


class FusedStackedMLP(nn.Module):
    """StackedMLP evaluated by K1 (one kernel for the whole stack).

    Parameters ``kernel_i`` (d_i, d_{i+1}) and ``bias_i`` keep the JAX
    package's layout. Inputs go through ``ops.fused_mlp`` (the kernel on
    CUDA, its plain version on the CPU), which takes fp32 only and raises on
    any other dtype off the CPU. CPU inputs of other dtypes (the fp64 parity
    runs) take the plain version directly, with autograd through it.
    """

    def __init__(self, d_in: int, features: Sequence[int],
                 activation_name: str = "relu", w_std: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        dims = [d_in] + list(features)
        self.activation_name = activation_name
        self.n_layers = len(features)
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            w = torch.empty(a, b, dtype=dtype, device=device)
            _normal_(w, w_std, generator)
            self.register_parameter(f"kernel_{i}", nn.Parameter(w))
            self.register_parameter(
                f"bias_{i}",
                nn.Parameter(torch.zeros(b, dtype=dtype, device=device)))

    def stack(self):
        Ws = [getattr(self, f"kernel_{i}") for i in range(self.n_layers)]
        bs = [getattr(self, f"bias_{i}") for i in range(self.n_layers)]
        return Ws, bs

    def forward(self, y):
        Ws, bs = self.stack()
        batch_shape = y.shape[:-1]
        y2 = y.reshape(-1, y.shape[-1])
        if y.dtype != torch.float32 and y.device.type == "cpu":
            out = fused_mlp_plain(y2, Ws, bs, self.activation_name)
        else:
            out = fused_mlp(y2.contiguous(), Ws, bs, self.activation_name)
        return out.reshape(batch_shape + (out.shape[-1],))


class KSFuncIM(nn.Module):
    """KS implicit part: 5-point circular stencil (fixed or learnable)."""

    def __init__(self, nx: int = 64, L: float = 22.0,
                 fixed_linear: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.nx, self.L, self.fixed_linear = nx, L, fixed_linear
        dx = L / nx
        fixed = tuple(ks_fixed_kernel(dx)) if fixed_linear else None
        self.conv = CircularConv1D(5, fixed, generator, dtype, device)

    @property
    def linear_in_y(self):
        """True when f(t, y) is exactly linear in y with no affine part --
        the certification the fused ARK kernels need (their J applies use
        the frozen Jacobian, exact only for linear dynamics)."""
        return self.fixed_linear

    def forward(self, t, y):
        return self.conv(y)


def _fused_stack_spec(params, activation, sign):
    """(Ws, bs, rebuild) from a parameter dict holding exactly one
    FusedStackedMLP (keys ``<prefix>kernel_i`` / ``<prefix>bias_i``), for
    the fused step kernels; None for any other layout."""
    names = list(params)
    kernels = [k for k in names if k.rsplit(".", 1)[-1].startswith("kernel_")]
    n = len(kernels)
    if n == 0 or len(names) != 2 * n:
        return None
    prefix = kernels[0][: len(kernels[0]) - len(kernels[0].rsplit(".", 1)[-1])]
    keys_W = [f"{prefix}kernel_{i}" for i in range(n)]
    keys_b = [f"{prefix}bias_{i}" for i in range(n)]
    if set(keys_W + keys_b) != set(names):
        return None

    def rebuild(dWs, dbs):
        out = {}
        for i in range(n):
            out[keys_W[i]] = dWs[i]
            out[keys_b[i]] = dbs[i]
        return {k: out[k] for k in names}

    return {"Ws": [params[k] for k in keys_W],
            "bs": [params[k] for k in keys_b],
            "activation": activation, "sign": sign, "rebuild": rebuild}


class KSFuncEX(nn.Module):
    """KS explicit part: -MLP(y), hidden 104, ReLU.

    use_fused selects K1 and opts into the fused ARK step kernels.
    """

    def __init__(self, nx: int = 64, hidden: int = 104,
                 use_fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.nx, self.hidden, self.use_fused = nx, hidden, use_fused
        feats = (hidden,) * 4 + (nx,)
        if use_fused:
            self.net = FusedStackedMLP(nx, feats, "relu", 0.01, generator,
                                       dtype, device)
        else:
            self.net = StackedMLP(nx, feats, "relu", 0.01, generator, dtype,
                                  device)

    def forward(self, t, y):
        return -self.net(y)

    def fused_mlp_spec(self, params):
        """Opt-in for the fused ARK step kernels: f_ex = -MLP."""
        if not self.use_fused:
            return None
        return _fused_stack_spec(params, "relu", -1.0)
