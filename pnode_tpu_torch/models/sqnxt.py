"""SqueezeNext ODE-net for CIFAR-10 (counterpart of
``pnode_tpu/models/sqnxt.py``).

SqNxt-23 (blocks (6, 6, 8, 1), stage channels (32, 64, 128, 256) x
``width_x``) where each stage's residual blocks after the first are ODE
blocks integrating the BasicBlock2 dynamics (``ODEDynamics``) over [0, t1].
``BatchStatsNorm`` normalizes by the current batch's statistics (no running
averages), so the dynamics are a pure function of (t, y, params) and couple
the whole batch: a solve never splits it.

``dtype="bf16"`` is the JAX package's mixed precision: parameters and their
gradients stay fp32, every conv (and the head's dense layer) casts its
weights and its input to bf16 as flax's ``nn.Conv(dtype=...)`` does,
``BatchStatsNorm`` computes its statistics in fp32 and returns the
activation dtype, the stem casts the image to bf16, and the head returns
fp32 logits. The ODE state and its trajectory are bf16 (the solvers sum
the RK stages in fp32); on the kernel path the dynamics run the bf16
instances of K6-K9.

Layouts: the public input is NHWC ``(B, 32, 32, 3)``, as in the JAX package.
The non-ODE pieces run NCHW through ``F.conv2d``. With ``use_kernels="on"``
the ODE state rides the (C, N) layout of the fused dynamics kernels
(``ops/fused_sqnxt.py``: K6/K7 for the chain, K8/K9 layered), converted
once per run of consecutive ODE blocks, not once per block.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..modules import Func, TorchFunc
from ..ops import fused_sqnxt as fs
from ..solver import ODESolver
from ..tableaus import get_rk_tableau

# the dtype the JAX package pins at fp32 whatever the activation dtype: the
# norm statistics and the logits (a test of true fp64 sets it to float64)
FP32 = torch.float32
DTYPES = {None: None, "f32": None, "float32": None, torch.float32: None,
          "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          torch.bfloat16: torch.bfloat16}


def _cast(x, dtype):
    return x if dtype is None else x.to(dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(ch, ksize, strides, padding="SAME", use_bias=True,
    dtype=dtype)`` on NCHW: weight (Cout, Cin, kh, kw), bias (Cout,), both
    fp32; with a ``dtype`` the weight, the bias and the input are cast to it
    before the conv. For the model's kernels (odd sizes at stride 1, 1x1 at
    stride 2 on even sizes) SAME pads (k - 1) / 2 on each side."""

    def __init__(self, cin, cout, ksize, stride=1, dtype=None):
        super().__init__()
        kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        kh, kw = self.weight.shape[2:]
        dt = self.dtype
        return F.conv2d(_cast(x, dt), _cast(self.weight, dt),
                        _cast(self.bias, dt), self.stride,
                        ((kh - 1) // 2, (kw - 1) // 2))


class BatchStatsNorm(nn.Module):
    """Normalize over (batch, H, W) per channel with a learnable affine.

    Statistics in fp32 whatever the input dtype (the JAX package's), eps
    1e-5; at or above ``single_pass_min_size`` elements the variance is
    E[x^2] - E[x]^2 clamped at 0, below it the centered E[(x - E[x])^2]."""

    def __init__(self, c, eps=1e-5, single_pass_min_size=1 << 20):
        super().__init__()
        self.eps = eps
        self.single_pass_min_size = single_pass_min_size
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        axes = (0, 2, 3)
        x32 = x.to(FP32)
        mean = x32.mean(axes, keepdim=True)
        if x.numel() >= self.single_pass_min_size:
            m2 = (x32 * x32).mean(axes, keepdim=True)
            var = torch.clamp_min(m2 - mean * mean, 0.0)
        else:
            xc = x32 - mean
            var = (xc * xc).mean(axes, keepdim=True)
        scale = self.scale.to(FP32)[:, None, None]
        bias = self.bias.to(FP32)[:, None, None]
        out = (x32 - mean) / torch.sqrt(var + self.eps) * scale + bias
        return out.to(x.dtype)


def _chain(convs, norms, x):
    h = x
    for conv, norm in zip(convs, norms):
        h = torch.relu(norm(conv(h)))
    return h


class BasicBlock(nn.Module):
    """SqueezeNext residual block; the stride applies to the first 1x1 conv
    and to the shortcut only."""

    def __init__(self, in_channels, out_channels, stride=1, dtype=None):
        super().__init__()
        red = 0.5
        if stride == 2:
            red = 1.0
        elif in_channels > out_channels:
            red = 0.25
        c1 = int(in_channels * red)
        c2 = int(in_channels * red * 0.5)
        dt = dtype
        convs = [Conv(in_channels, c1, 1, stride, dt), Conv(c1, c2, 1, 1, dt),
                 Conv(c2, c1, (1, 3), 1, dt), Conv(c1, c1, (3, 1), 1, dt),
                 Conv(c1, out_channels, 1, 1, dt)]
        chans = [c1, c2, c1, c1, out_channels]
        self.shortcut = stride == 2 or in_channels != out_channels
        if self.shortcut:
            convs.append(Conv(in_channels, out_channels, 1, stride, dt))
            chans.append(out_channels)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchStatsNorm(c) for c in chans)

    def forward(self, x):
        h = _chain(self.convs[:5], self.norms[:5], x)
        if self.shortcut:
            sc = torch.relu(self.norms[5](self.convs[5](x)))
        else:
            sc = torch.relu(x)
        return torch.relu(h + sc)


class ODEDynamics(nn.Module):
    """BasicBlock2, the conv stack without residual, as f(t, y) on NCHW."""

    def __init__(self, dim, dtype=None):
        super().__init__()
        self.dim = dim
        c1, c2 = int(dim * 0.5), int(dim * 0.25)
        dt = dtype
        self.convs = nn.ModuleList([
            Conv(dim, c1, 1, 1, dt), Conv(c1, c2, 1, 1, dt),
            Conv(c2, c1, (1, 3), 1, dt), Conv(c1, c1, (3, 1), 1, dt),
            Conv(c1, dim, 1, 1, dt)])
        self.norms = nn.ModuleList(BatchStatsNorm(c)
                                   for c in (c1, c2, c1, c1, dim))

    def forward(self, t, x):
        return _chain(self.convs, self.norms, x)


class Stem(nn.Module):
    """The image cast to ``dtype`` (where given), then conv + norm +
    ReLU."""

    def __init__(self, width_x=1.0, dtype=None):
        super().__init__()
        ch = int(width_x * 64)
        self.dtype = dtype
        self.convs = nn.ModuleList([Conv(3, ch, 3, 1, dtype)])
        self.norms = nn.ModuleList([BatchStatsNorm(ch)])

    def forward(self, x):
        return _chain(self.convs, self.norms, _cast(x, self.dtype))


class Head(nn.Module):
    """1x1 conv + norm + ReLU, 4x4 average pool, Dense (in ``dtype`` where
    given, as flax's ``nn.Dense(dtype=...)``); fp32 logits. The pooled map
    is flattened in NHWC order, as flax does (32x32 inputs)."""

    def __init__(self, width_x=1.0, in_channels=256, num_classes=10,
                 dtype=None):
        super().__init__()
        ch = int(width_x * 128)
        self.dtype = dtype
        self.convs = nn.ModuleList([Conv(in_channels, ch, 1, 1, dtype)])
        self.norms = nn.ModuleList([BatchStatsNorm(ch)])
        self.dense = nn.Linear(ch, num_classes)

    def forward(self, x):
        h = F.avg_pool2d(_chain(self.convs, self.norms, x), 4, 4)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        dt = self.dtype
        return F.linear(_cast(h, dt), _cast(self.dense.weight, dt),
                        _cast(self.dense.bias, dt)).to(FP32)


def _lecun_normal_(w, fan_in, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance
    1 / fan_in, drawn on the CPU from ``generator``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    v = torch.erfinv(u * (hi - lo) + lo) * (math.sqrt(2.0) * std)
    with torch.no_grad():
        w.copy_(v.to(w.dtype))


class SqueezeNextODE(nn.Module):
    """SqNxt-23 with ODE stages.

        model = SqueezeNextODE(num_classes=10, method="rk4", Nt=2)
        logits = model(x)          # x: (B, 32, 32, 3); logits (B, classes)
        loss.backward()            # ODE blocks through the discrete adjoint

    ``dtype``: None / "f32" (fp32 throughout) or "bf16" (the JAX package's
    mixed precision: see the module's note). Anything else raises
    ``ValueError``.

    ``use_kernels``: "on" runs the ODE dynamics on the fused kernels (the
    plain versions on CPU tensors; on the card their fp32 or bf16
    instances), "off" on the module path (``F.conv2d`` plus
    ``BatchStatsNorm`` per layer). "auto" resolves to "on": the JAX
    package's auto -> XLA was a TPU measurement (-23% end to end on the v5e
    for the layered kernels) and does not carry over to this card. On the
    card the kernels take up to 128 channels, the widest ODE stage at
    ``width_x`` 1.0.
    """

    BLOCKS = (6, 6, 8, 1)
    STAGE_CH = (32, 64, 128, 256)
    STAGE_STRIDE = (1, 2, 2, 2)

    def __init__(self, num_classes: int = 10, width_x: float = 1.0,
                 method: str = "rk4", Nt: int = 2, t1: float = 1.0,
                 enable_adjoint: bool = True, dtype=None,
                 use_kernels: str = "auto", generator=None):
        super().__init__()
        try:
            self.dtype = dt = DTYPES[dtype]
        except (KeyError, TypeError):
            raise ValueError(f"dtype {dtype!r}: f32 or bf16") from None
        if use_kernels not in ("auto", "on", "off"):
            raise ValueError(f"use_kernels={use_kernels!r}: auto|on|off")
        self.use_kernels = use_kernels != "off"
        self.width_x = width_x
        self.method = method
        self.t1 = t1
        self.step_size = t1 / float(Nt)
        self.enable_adjoint = enable_adjoint
        kinds, pieces = ["stem"], [Stem(width_x, dt)]
        in_ch = 64
        for nblocks, ch, stride in zip(self.BLOCKS, self.STAGE_CH,
                                       self.STAGE_STRIDE):
            kinds.append("entry")
            pieces.append(BasicBlock(int(width_x * in_ch), int(width_x * ch),
                                     stride, dt))
            for _ in range(nblocks - 1):
                kinds.append("ode")
                pieces.append(ODEDynamics(int(width_x * ch), dt))
            in_ch = ch
        kinds.append("head")
        pieces.append(Head(width_x, int(width_x * in_ch), num_classes, dt))
        self.kinds = kinds
        self.pieces = nn.ModuleList(pieces)
        self._solvers = {}
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """flax's initializers: lecun-normal kernels, zero biases, unit norm
        scales and zero norm biases."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, Conv):
                cout, cin, kh, kw = m.weight.shape
                _lecun_normal_(m.weight, cin * kh * kw, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.weight.shape[1], generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchStatsNorm):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)

    # one solver per (dim, shape, mode): all ODE blocks of a stage share it,
    # each solve passes its own block's parameters
    def _module_solver(self, mod, h):
        key = ("module", mod.dim, tuple(h.shape), h.dtype, h.device)
        ode = self._solvers.get(key)
        if ode is None:
            ode = ODESolver().setupTS(torch.zeros_like(h), TorchFunc(mod),
                                      step_size=self.step_size,
                                      method=self.method,
                                      enable_adjoint=self.enable_adjoint)
            self._solvers[key] = ode
        return ode

    def _fused_solver(self, meta, h):
        key = ("fused", meta, h.dtype, h.device)
        ode = self._solvers.get(key)
        if ode is None:
            ode = ODESolver().setupTS(
                torch.zeros_like(h),
                Func(lambda t, y, p, m=meta: fs.fused_sqnxt_dyn(y, p, m)),
                step_size=self.step_size, method=self.method,
                enable_adjoint=self.enable_adjoint)
            self._solvers[key] = ode
        return ode

    def forward(self, x, training: bool = True):
        """Logits of an NHWC batch. ``training`` runs the ODE blocks through
        the discrete adjoint (gradients flow); otherwise they run without
        recording anything."""
        h = x.permute(0, 3, 1, 2)
        t_out = np.array([self.t1])  # single output time
        bhw = None  # (B, H, W) while h rides the (C, N) layout
        for kind, mod in zip(self.kinds, self.pieces):
            if kind == "ode":
                if self.use_kernels:
                    if bhw is None:
                        B, C, H, W = h.shape
                        bhw = (B, H, W)
                        h = h.permute(1, 0, 2, 3).reshape(C, -1).contiguous()
                    meta = fs.gate_meta(mod.dim, *bhw, dtype=h.dtype)
                    ode = self._fused_solver(meta, h)
                else:
                    ode = self._module_solver(mod, h)
                sol, _ = ode.solve(
                    h, t_out, params=dict(mod.named_parameters()),
                    with_adjoint=training and self.enable_adjoint)
                h = sol[-1]
            else:
                if bhw is not None:
                    B, H, W = bhw
                    h = h.reshape(-1, B, H, W).permute(1, 0, 2, 3)
                    bhw = None
                h = mod(h)
        return h

    @property
    def nfe_per_forward(self):
        n_ode = sum(1 for kind in self.kinds if kind == "ode")
        steps = int(round(self.t1 / self.step_size))
        return n_ode * get_rk_tableau(self.method).stages * steps
