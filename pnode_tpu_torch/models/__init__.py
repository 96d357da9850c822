from .sinode import (
    CircularConv1D,
    FusedStackedMLP,
    KSFuncEX,
    KSFuncIM,
    StackedMLP,
    circular_stencil_apply,
    ks_fixed_kernel,
)
from .sqnxt import (
    BasicBlock,
    BatchStatsNorm,
    Head,
    ODEDynamics,
    SqueezeNextODE,
    Stem,
)

__all__ = [
    "BasicBlock",
    "BatchStatsNorm",
    "Head",
    "ODEDynamics",
    "SqueezeNextODE",
    "Stem",
    "CircularConv1D",
    "FusedStackedMLP",
    "KSFuncEX",
    "KSFuncIM",
    "StackedMLP",
    "circular_stencil_apply",
    "ks_fixed_kernel",
]
