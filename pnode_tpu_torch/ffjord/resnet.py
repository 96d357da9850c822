"""ResNet feature blocks from the reference's flow layer zoo.

Counterpart of ``pnode_tpu/ffjord/resnet.py`` (the reference's
``resnet.py``): ``BasicBlock`` (3x3 conv - GroupNorm(2) - ReLU - 3x3 conv -
GroupNorm(2) + identity skip, final ReLU) and ``ResNeXtBottleneck`` (1x1
reduce - grouped 3x3 - 1x1 expand with batch norms, type-C ResNeXt). NHWC,
plain feature extractors without log-density bookkeeping. ``GroupNorm``
and ``BatchNorm`` are flax's, in NHWC: flax's BatchNorm keeps a running
average of the biased batch variance at momentum 0.99, where
``nn.BatchNorm2d`` keeps the unbiased one at 0.9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` over NHWC input (flax's ``GroupNorm``)."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over NHWC input: batch statistics while
    training (the running averages updated at ``momentum``), the running
    ones otherwise."""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, training: bool = True):
        if training:
            red = tuple(range(x.ndim - 1))
            mean = torch.mean(x, dim=red)
            var = torch.var(x, dim=red, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class BasicBlock(nn.Module):
    """conv3x3 -> GN(2) -> ReLU -> conv3x3 -> GN(2) -> +x -> ReLU."""

    def __init__(self, dim: int, expansion: int = 1):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, bias=False)
        self.norm1 = GroupNorm(2, dim, eps=1e-4)
        self.conv2 = Conv(dim, dim, 3, bias=False)
        self.norm2 = GroupNorm(2, dim, eps=1e-4)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        return F.relu(h + x)


class ResNeXtBottleneck(nn.Module):
    """ResNeXt type-C bottleneck: 1x1 reduce to cardinality * base_depth
    channels, grouped 3x3, 1x1 expand back to dim, identity skip."""

    def __init__(self, dim: int, cardinality: int = 4, base_depth: int = 32):
        super().__init__()
        D = cardinality * base_depth
        self.conv1 = Conv(dim, D, 1, bias=False)
        self.bn1 = BatchNorm(D)
        self.conv2 = Conv(D, D, 3, groups=cardinality, bias=False)
        self.bn2 = BatchNorm(D)
        self.conv3 = Conv(D, dim, 1, bias=False)
        self.bn3 = BatchNorm(dim)

    def forward(self, x, training: bool = True):
        h = F.relu(self.bn1(self.conv1(x), training))
        h = F.relu(self.bn2(self.conv2(h), training))
        h = self.bn3(self.conv3(h), training)
        return F.relu(h + x)
