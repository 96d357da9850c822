"""Time-dependent diffeq layer zoo (PyTorch).

Counterpart of ``pnode_tpu/ffjord/layers.py`` (the reference's
``diffeq_layers/basic.py``): the Ignore / Concat / Squash / ConcatSquash /
Hyper / Blend / ConcatCoord families, dense (tabular) and 2-D conv (image).
Each layer maps ``(t, y) -> y'`` with t a scalar; how t enters tells the
families apart:

- ignore:        f(y)
- concat:        f([t, y])
- concat_v2:     f(y) + a t
- squash:        f(y) * sigmoid(gate(t))
- concatsquash:  f(y) * sigmoid(gate(t)) + bias(t)
- hyper:         weights generated from t by a small hypernetwork
- blend:         f0(y) + t (f1(y) - f0(y))
- concatcoord:   the conv variant also concatenates coordinate grids

Layouts follow the JAX package, so flat states compare element for element
with it: dense inputs are ``(..., dim_in)``, images are NHWC. Convolutions
permute to NCHW only around ``F.conv2d`` / ``F.conv_transpose2d`` (an NHWC
tensor permuted is a channels-last NCHW view, so no copy is made). flax's
``padding="SAME"`` pads ``(lo, hi) = (p // 2, p - p // 2)``, asymmetric at
stride 2, so ``conv2d_same`` pads by hand where the two sides differ; and
flax's ``ConvTranspose`` (``lax.conv_transpose`` with ``transpose_kernel``
false) correlates the stride-dilated input with the kernel as stored,
where ``F.conv_transpose2d`` flips it: ``ConvTranspose`` keeps its weight
in torch's ``(in, out, kh, kw)`` layout, flipped against flax's kernel
(``convert.py`` flips it), and crops or pads the full transposed output to
lax's SAME/VALID window.

Children are registered in the order flax creates its submodules
(``Dense_0, Dense_1, ...`` counted per kind), which is how
``convert.ffjord_state_dict_from_flax`` pairs them. Weights are drawn as
flax draws them: LeCun-normal kernels (a normal truncated at two standard
deviations), zero biases, N(0, 0.01) for the hypernetworks' outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: N(0, 1 / fan_in) truncated at 2 std."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def dense(d_in: int, d_out: int, bias: bool = True,
          std: float = None) -> nn.Linear:
    """An ``nn.Linear`` drawn as flax's ``Dense``: LeCun-normal kernel (or
    N(0, std^2) where ``std`` is given), zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        if std is None:
            lecun_normal_(lin.weight, d_in)
        else:
            lin.weight.normal_(0.0, std)
        if bias:
            lin.bias.zero_()
    return lin


def t_col(t, y: torch.Tensor, shape) -> torch.Tensor:
    """A tensor of ``shape`` filled with the scalar t, in y's dtype and on
    y's device (t is rounded to y's dtype, as the JAX layers cast it)."""
    return torch.full(tuple(shape), float(t), dtype=y.dtype, device=y.device)


# -- convolutions in NHWC with lax's padding ---------------------------------


def _same_pads(n: int, k: int, s: int):
    """lax's SAME padding of one spatial dim: out = ceil(n / s)."""
    out = -(-n // s)
    p = max((out - 1) * s + k - n, 0)
    return p // 2, p - p // 2


def conv2d_same(x, w, b=None, stride: int = 1, padding: str = "SAME",
                groups: int = 1):
    """flax ``Conv``: x NHWC, w OIHW, lax's SAME or VALID padding."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if padding == "SAME":
        (hl, hh), (wl, wh) = (_same_pads(xc.shape[2], w.shape[2], stride),
                              _same_pads(xc.shape[3], w.shape[3], stride))
        if hl == hh and wl == wh:
            pad = (hl, wl)
        else:
            xc = F.pad(xc, (wl, wh, hl, hh))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    out = F.conv2d(xc, w, b, stride=stride, padding=pad, groups=groups)
    return out.permute(0, 2, 3, 1)


def _transpose_pads(k: int, s: int, padding: str):
    """lax's ``_conv_transpose_padding``: (lo, hi) pads of the dilated
    input."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    return lo, pad_len - lo


def conv_transpose2d_same(x, w, b=None, stride: int = 1,
                          padding: str = "SAME"):
    """flax ``ConvTranspose`` (``transpose_kernel=False``): x NHWC, w in
    torch's (in, out, kh, kw) layout, i.e. flax's HWIO kernel flipped in
    both spatial dims. ``F.conv_transpose2d`` pads the dilated input by k - 1
    on both sides; the result is cropped (or zero-padded: windows wholly
    in the padding give 0) to lax's pads."""
    kh, kw = w.shape[2], w.shape[3]
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride)
    (hl, hh), (wl, wh) = (_transpose_pads(kh, stride, padding),
                          _transpose_pads(kw, stride, padding))
    out = F.pad(out, (wl - (kw - 1), wh - (kw - 1),
                      hl - (kh - 1), hh - (kh - 1)))
    out = out.permute(0, 2, 3, 1)
    return out if b is None else out + b


class Conv(nn.Module):
    """flax ``nn.Conv`` in NHWC: weight OIHW, LeCun-normal, zero bias."""

    def __init__(self, c_in: int, c_out: int, ksize: int = 3,
                 stride: int = 1, padding: str = "SAME", groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in // groups, ksize, ksize))
        lecun_normal_(self.weight, c_in // groups * ksize * ksize)
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x):
        return conv2d_same(x, self.weight, self.bias, self.stride,
                           self.padding, self.groups)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` in NHWC: weight (in, out, kh, kw), the
    flax kernel flipped; LeCun-normal over in * kh * kw, zero bias."""

    def __init__(self, c_in: int, c_out: int, ksize: int = 3,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(c_in, c_out, ksize, ksize))
        lecun_normal_(self.weight, c_in * ksize * ksize)
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return conv_transpose2d_same(x, self.weight, self.bias, self.stride,
                                     self.padding)


# -- dense (tabular) layers --------------------------------------------------


class IgnoreLinear(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.lin = dense(dim_in, dim_out)

    def forward(self, t, y):
        return self.lin(y)


class ConcatLinear(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.lin = dense(dim_in + 1, dim_out)

    def forward(self, t, y):
        tt = t_col(t, y, y.shape[:-1] + (1,))
        return self.lin(torch.cat([tt, y], -1))


class ConcatLinearV2(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.lin = dense(dim_in, dim_out)
        self.hyper_bias = dense(1, dim_out, bias=False)

    def forward(self, t, y):
        return self.lin(y) + self.hyper_bias(t_col(t, y, y.shape[:-1] + (1,)))


class SquashLinear(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.hyper_gate = dense(1, dim_out)
        self.lin = dense(dim_in, dim_out)

    def forward(self, t, y):
        gate = self.hyper_gate(t_col(t, y, y.shape[:-1] + (1,)))
        return self.lin(y) * torch.sigmoid(gate)


class ConcatSquashLinear(nn.Module):
    """The FFJORD default: f(y) * sigmoid(gate(t)) + bias(t)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.hyper_gate = dense(1, dim_out)
        self.hyper_bias = dense(1, dim_out, bias=False)
        self.lin = dense(dim_in, dim_out)

    def forward(self, t, y):
        tf = t_col(t, y, y.shape[:-1] + (1,))
        return (self.lin(y) * torch.sigmoid(self.hyper_gate(tf))
                + self.hyper_bias(tf))


class HyperLinear(nn.Module):
    """Weights and bias generated from t by a hypernetwork."""

    def __init__(self, dim_in: int, dim_out: int, hypernet_dim: int = 8):
        super().__init__()
        self.dim_in, self.dim_out = dim_in, dim_out
        self.hyper = dense(1, hypernet_dim)
        self.weights = dense(hypernet_dim, dim_out * dim_in + dim_out,
                             std=0.01)

    def forward(self, t, y):
        h = torch.tanh(self.hyper(t_col(t, y, (1,))))
        wb = self.weights(h)
        b = wb[: self.dim_out]
        W = wb[self.dim_out:].reshape(self.dim_out, self.dim_in)
        return y @ W.T + b


class BlendLinear(nn.Module):
    """W(t) = W0 + t (W1 - W0)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.lin0 = dense(dim_in, dim_out)
        self.lin1 = dense(dim_in, dim_out)

    def forward(self, t, y):
        f0 = self.lin0(y)
        return f0 + float(t) * (self.lin1(y) - f0)


# -- conv (image) layers -----------------------------------------------------


def _conv(c_in, c_out, ksize, stride, transpose):
    if transpose:
        return ConvTranspose(c_in, c_out, ksize, stride)
    return Conv(c_in, c_out, ksize, stride)


class IgnoreConv2d(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.conv = _conv(dim_in, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        return self.conv(y)


class ConcatConv2d(nn.Module):
    """A constant-t channel in front of y's channels."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.conv = _conv(dim_in + 1, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        tt = t_col(t, y, y.shape[:-1] + (1,))
        return self.conv(torch.cat([tt, y], -1))


class ConcatCoordConv2d(nn.Module):
    """t and the normalized coordinate grids in front of y's channels."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.conv = _conv(dim_in + 3, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        b, h, w, _ = y.shape
        hh = torch.linspace(-1.0, 1.0, h, dtype=y.dtype, device=y.device)
        ww = torch.linspace(-1.0, 1.0, w, dtype=y.dtype, device=y.device)
        gy, gx = torch.meshgrid(hh, ww, indexing="ij")
        coords = torch.stack([gy, gx], -1)[None].expand(b, h, w, 2)
        tt = t_col(t, y, (b, h, w, 1))
        return self.conv(torch.cat([tt, coords, y], -1))


class SquashConv2d(nn.Module):
    """conv(y) * sigmoid(gate(t))."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.hyper_gate = dense(1, dim_out)
        self.conv = _conv(dim_in, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        gate = self.hyper_gate(t_col(t, y, (1,)))
        return self.conv(y) * torch.sigmoid(gate)


class ConcatConv2dV2(nn.Module):
    """conv(y) + bias(t), broadcast over H and W."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.hyper_bias = dense(1, dim_out, bias=False)
        self.conv = _conv(dim_in, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        return self.conv(y) + self.hyper_bias(t_col(t, y, (1,)))


class BlendConv2d(nn.Module):
    """conv0(y) + t (conv1(y) - conv0(y))."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.conv0 = _conv(dim_in, dim_out, ksize, stride, transpose)
        self.conv1 = _conv(dim_in, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        f0 = self.conv0(y)
        return f0 + float(t) * (self.conv1(y) - f0)


class HyperConv2d(nn.Module):
    """Conv kernel and bias generated from t by a hypernetwork. The kernel
    is generated in flax's HWIO layout and applied as lax applies it (a
    transposed conv: unflipped, so flipped here for
    ``F.conv_transpose2d``)."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.dim_in, self.dim_out, self.ksize = dim_in, dim_out, ksize
        self.stride, self.transpose = stride, transpose
        self.n_w = dim_in * dim_out * ksize * ksize
        self.weights = dense(1, self.n_w + dim_out, std=0.01)

    def forward(self, t, y):
        k = self.ksize
        wb = self.weights(t_col(t, y, (1,)))
        kernel = wb[: self.n_w].reshape(k, k, self.dim_in, self.dim_out)
        bias = wb[self.n_w:]
        if self.transpose:
            w = kernel.flip(0, 1).permute(2, 3, 0, 1)
            return conv_transpose2d_same(y, w, bias, self.stride)
        return conv2d_same(y, kernel.permute(3, 2, 0, 1), bias, self.stride)


class ConcatSquashConv2d(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, transpose: bool = False):
        super().__init__()
        self.hyper_gate = dense(1, dim_out)
        self.hyper_bias = dense(1, dim_out, bias=False)
        self.conv = _conv(dim_in, dim_out, ksize, stride, transpose)

    def forward(self, t, y):
        tf = t_col(t, y, (1,))
        return (self.conv(y) * torch.sigmoid(self.hyper_gate(tf))
                + self.hyper_bias(tf))


# -- gated units (not time-dependent) -----------------------------------------


class GatedLinear(nn.Module):
    """f(x) * sigmoid(g(x))."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.f = dense(dim_in, dim_out)
        self.g = dense(dim_in, dim_out)

    def forward(self, x):
        return self.f(x) * torch.sigmoid(self.g(x))


class GatedConv(nn.Module):
    """Gated 2-D convolution, NHWC."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, padding: str = "SAME", groups: int = 1):
        super().__init__()
        self.f = Conv(dim_in, dim_out, ksize, stride, padding, groups)
        self.g = Conv(dim_in, dim_out, ksize, stride, padding, groups)

    def forward(self, x):
        return self.f(x) * torch.sigmoid(self.g(x))


class GatedConvTranspose(nn.Module):
    """Gated transposed 2-D convolution, NHWC."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.f = ConvTranspose(dim_in, dim_out, ksize, stride, padding)
        self.g = ConvTranspose(dim_in, dim_out, ksize, stride, padding)

    def forward(self, x):
        return self.f(x) * torch.sigmoid(self.g(x))


DIFFEQ_LAYERS = {
    "ignore": IgnoreLinear,
    "concat": ConcatLinear,
    "concat_v2": ConcatLinearV2,
    "squash": SquashLinear,
    "concatsquash": ConcatSquashLinear,
    "hyper": HyperLinear,
    "blend": BlendLinear,
    # coordinates exist only for images: the dense path maps concatcoord
    # to ConcatLinear, as the reference and the JAX package do
    "concatcoord": ConcatLinear,
}

DIFFEQ_CONV_LAYERS = {
    "ignore": IgnoreConv2d,
    "concat": ConcatConv2d,
    "concat_v2": ConcatConv2dV2,
    "concatcoord": ConcatCoordConv2d,
    "concatsquash": ConcatSquashConv2d,
    "squash": SquashConv2d,
    "blend": BlendConv2d,
    "hyper": HyperConv2d,
}


def build_diffeq_layer(layer_type: str, dim_in: int, dim_out: int,
                       conv: bool = False, **kw):
    """The layer of ``layer_type`` from ``dim_in`` to ``dim_out`` features
    (channels where ``conv``). flax infers the input width at init; a torch
    module is built with it, hence ``dim_in``."""
    table = DIFFEQ_CONV_LAYERS if conv else DIFFEQ_LAYERS
    if layer_type not in table:
        raise ValueError(
            f"unknown layer_type {layer_type!r}; options: {sorted(table)}")
    return table[layer_type](dim_in, dim_out, **kw)


def on_device(module: nn.Module, device, dtype=None) -> nn.Module:
    """``module`` moved to ``device`` (and cast to ``dtype`` where given):
    the flow constructors' placement. The weights are drawn on the CPU
    first, so a seed gives the same flow on every device. A CUDA device
    without CUDA raises: the CPU is the caller's explicit choice, never a
    fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: CUDA is not available (pass "
                           "device='cpu' to run on the CPU)")
    return module.to(device=dev, dtype=dtype)
