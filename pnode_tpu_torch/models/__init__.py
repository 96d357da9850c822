from .sinode import (
    CircularConv1D,
    FusedStackedMLP,
    KSFuncEX,
    KSFuncIM,
    StackedMLP,
    circular_stencil_apply,
    ks_fixed_kernel,
)

__all__ = [
    "CircularConv1D",
    "FusedStackedMLP",
    "KSFuncEX",
    "KSFuncIM",
    "StackedMLP",
    "circular_stencil_apply",
    "ks_fixed_kernel",
]
