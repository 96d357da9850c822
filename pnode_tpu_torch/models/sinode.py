"""SINODE model zoo (PyTorch): learned stiff-PDE dynamics for KS and Burgers.

Counterpart of ``pnode_tpu/models/sinode.py``:

- ``KSFuncIM``: fixed (or learnable) 5-point circular stencil of
  -d^4/dx^4 - d^2/dx^2, the KS implicit part.
- ``KSFuncEX``: -MLP(y), 64 -> 104 x4 -> 64 with ReLU, N(0, 0.01) weights and
  zero biases, the KS explicit part.
- ``KSSnodeFunc``: conv(y) - MLP(y) (64 -> 200 x4 -> 64, ReLU), the KS
  "snode" single function; ``KSMLPFunc``: a sigmoid MLP (64 -> 104 x4 ->
  64), the KS "mlp" single function.
- ``BurgersFuncIM``: the fixed 3-point circular Laplacian alpha d^2/dx^2,
  the Burgers implicit part; ``BurgersFuncEX``: +MLP(y), N -> 9N/8 x4 -> N
  with ReLU and N(0, 0.1) weights, the Burgers explicit part.

``IMEXSum(im, ex)``: f_IM + f_EX as one function, the trainers' ``--node``
baseline.

``use_fused=True`` (the JAX package's ``use_pallas``) puts a stack on K1
(``FusedStackedMLP``, parameters ``kernel_i`` (in, out) and ``bias_i`` as in
JAX; the explicit parts then opt into the fused ARK step kernels through
``fused_mlp_spec``) and a stencil on K10/K11 (``ops.circular_stencil``);
``use_fused=False`` uses ``nn.Linear`` layers and the roll chain. Stencils
are never a conv1d, so cuDNN's TF32 default never touches a stiff operator.
``KSSnodeFunc``'s ``use_fused`` routes its stencil alone (see the class).

Every module takes ``forward(t, y)`` and an explicit ``torch.Generator``,
dtype and device, so weights are reproducible from a seed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.circular_stencil import circular_stencil, circular_stencil_plain
from ..ops.fused_mlp import fused_mlp, fused_mlp_plain

_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


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


def burgers_fixed_kernel(dx: float, alpha: float = 8e-4) -> np.ndarray:
    """3-point stencil of alpha d^2/dx^2 (the Burgers viscous term)."""
    return np.array([alpha / dx**2, -2.0 * alpha / dx**2, alpha / dx**2])


# the JAX package's name for the roll chain: out[i] = sum_j kernel[j] *
# y[(i + j - k//2) mod N], k rolls summed in order
circular_stencil_apply = circular_stencil_plain


class CircularConv1D(nn.Module):
    """Single-channel circular conv (no bias); optionally a fixed stencil.

    fixed_kernel given -> a buffer, not a parameter; otherwise a parameter
    initialized U(-sqrt(1/k), sqrt(1/k)) like torch's Conv1d default.
    use_fused: apply it through K10/K11 (``ops.circular_stencil``; on CPU
    tensors, their plain versions).
    """

    def __init__(self, kernel_size: int = 5,
                 fixed_kernel: Optional[Sequence[float]] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None, use_fused: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.use_fused = use_fused
        if fixed_kernel is not None:
            # not persistent: a fixed stencil is configuration, not state
            self.register_buffer(
                "fixed", torch.tensor(np.asarray(fixed_kernel),
                                      dtype=torch.float64, device=device),
                persistent=False)
            self.kernel = None
            self._cast = (None, None)  # (the buffer, it in y's dtype/device)
        else:
            bound = math.sqrt(1.0 / kernel_size)
            w = torch.empty(kernel_size, dtype=dtype, device=device)
            w.uniform_(-bound, bound, generator=generator)
            self.kernel = nn.Parameter(w)

    def fixed_as(self, y):
        """The fixed stencil in y's dtype on y's device, cast once and kept
        while the buffer, the dtype and the device stay: a call then makes
        no copy (on the card, no cast kernel beside K10/K11). The cast runs
        outside any torch.func transform: inside jvp, a cast of the plain
        buffer comes back wrapped for that transform's level, and caching
        it would hand a dead wrapper to every later call."""
        src, cast = self._cast
        if (src is not self.fixed or cast.dtype != y.dtype
                or cast.device != y.device):
            with torch._C._DisableFuncTorch():
                cast = self.fixed.to(device=y.device, dtype=y.dtype)
            self._cast = (self.fixed, cast)
        return cast

    def forward(self, y):
        kernel = self.fixed_as(y) if self.kernel is None else self.kernel
        if self.use_fused:
            return circular_stencil(y, kernel)
        return circular_stencil_apply(y, kernel.to(y.dtype))


def _normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class StackedMLP(nn.Module):
    """Dense stack (``nn.Linear``) with N(0, w_std) weights and zero bias;
    activation relu, tanh or sigmoid between the layers."""

    def __init__(self, d_in: int, features: Sequence[int],
                 activation: str = "relu", w_std: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"StackedMLP: unsupported activation "
                             f"{activation!r}")
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
        act = _ACTIVATIONS[self.activation]
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
    """KS implicit part: 5-point circular stencil (fixed or learnable);
    use_fused applies it through K10/K11."""

    def __init__(self, nx: int = 64, L: float = 22.0,
                 fixed_linear: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None, use_fused: bool = False):
        super().__init__()
        self.nx, self.L, self.fixed_linear = nx, L, fixed_linear
        dx = L / nx
        fixed = tuple(ks_fixed_kernel(dx)) if fixed_linear else None
        self.conv = CircularConv1D(5, fixed, generator, dtype, device,
                                   use_fused=use_fused)

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


class KSSnodeFunc(nn.Module):
    """KS "snode" single function: conv(y) - MLP(y), hidden 200, ReLU.

    use_fused puts the stencil on K10/K11: under CN with GMRES, J v runs
    K10's ``jvp`` rule (K10 on the tangent) and J^T v K11. The MLP stays
    on ``nn.Linear``: the GMRES matvec is ``torch.func.jvp``, and K1's
    autograd Function has no forward-mode rule (nor has the JAX
    ``fused_mlp``, a ``custom_vjp``).
    """

    def __init__(self, nx: int = 64, L: float = 22.0, hidden: int = 200,
                 fixed_linear: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None, use_fused: bool = False):
        super().__init__()
        self.nx, self.L, self.hidden = nx, L, hidden
        fixed = tuple(ks_fixed_kernel(L / nx)) if fixed_linear else None
        self.conv = CircularConv1D(5, fixed, generator, dtype, device,
                                   use_fused=use_fused)
        self.net = StackedMLP(nx, (hidden,) * 4 + (nx,), "relu", 0.01,
                              generator, dtype, device)

    def forward(self, t, y):
        return self.conv(y) - self.net(y)


class KSMLPFunc(nn.Module):
    """KS "mlp" single function: sigmoid MLP, hidden 104."""

    def __init__(self, nx: int = 64, hidden: int = 104,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.nx, self.hidden = nx, hidden
        self.net = StackedMLP(nx, (hidden,) * 4 + (nx,), "sigmoid", 0.01,
                              generator, dtype, device)

    def forward(self, t, y):
        return self.net(y)


class BurgersFuncIM(nn.Module):
    """Burgers implicit part: the fixed circular Laplacian alpha d2/dx2 on
    [0, 1); use_fused applies it through K10/K11."""

    def __init__(self, nx: int = 512, alpha: float = 8e-4,
                 use_fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.nx, self.alpha = nx, alpha
        fixed = tuple(burgers_fixed_kernel(1.0 / nx, alpha))
        self.conv = CircularConv1D(3, fixed, generator, dtype, device,
                                   use_fused=use_fused)

    @property
    def linear_in_y(self):
        return True  # fixed stencil, no bias

    def forward(self, t, y):
        return self.conv(y)


class BurgersFuncEX(nn.Module):
    """Burgers explicit part: +MLP(y), ReLU stack N -> 9N/8 x4 -> N with
    N(0, 0.1) weights. use_fused selects K1 and opts into the fused ARK
    step kernels (K2/K3 per step, K4 and K12 in the fused loops), whose
    plans take N 512."""

    def __init__(self, nx: int = 512, use_fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=None, device=None):
        super().__init__()
        self.nx, self.use_fused = nx, use_fused
        w = nx * 9 // 8
        feats = (w, w, w, w, nx)
        if use_fused:
            self.net = FusedStackedMLP(nx, feats, "relu", 0.1, generator,
                                       dtype, device)
        else:
            self.net = StackedMLP(nx, feats, "relu", 0.1, generator, dtype,
                                  device)

    def forward(self, t, y):
        return self.net(y)

    def fused_mlp_spec(self, params):
        """Opt-in for the fused ARK step kernels: f_ex = +MLP."""
        if not self.use_fused:
            return None
        return _fused_stack_spec(params, "relu", 1.0)


class IMEXSum(nn.Module):
    """f_IM + f_EX of an IMEX split as one function, ``forward(t, y) =
    im(t, y) + ex(t, y)``, with the two modules' own parameters (``im.*``,
    ``ex.*``): the right-hand side the trainers' ``--node`` baseline
    integrates explicitly and differentiates by autograd."""

    def __init__(self, im: nn.Module, ex: nn.Module):
        super().__init__()
        self.im, self.ex = im, ex

    def forward(self, t, y):
        return self.im(t, y) + self.ex(t, y)
