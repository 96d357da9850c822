"""Carry weights from the JAX package's flax variables into the port.

``state_dict_from_flax(variables)`` takes a flax variable tree (nested dicts
of numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, variables)``)
of one of the KS models and returns the matching PyTorch ``state_dict``:

- ``StackedMLP_0/Dense_i/{kernel, bias}`` -> ``net.layers.i.{weight, bias}``;
  a flax Dense kernel is (in, out) and ``nn.Linear.weight`` is (out, in),
  so the kernel is transposed.
- ``FusedStackedMLP_0/{kernel_i, bias_i}`` -> ``net.{kernel_i, bias_i}``,
  copied as they are (the fused module keeps the (in, out) layout).
- ``CircularConv1D_0/kernel`` -> ``conv.kernel`` (learnable stencil).

Nothing here imports JAX: the caller converts the arrays to numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_MODULE_NAMES = {
    "StackedMLP_0": "net",
    "FusedStackedMLP_0": "net",
    "CircularConv1D_0": "conv",
}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a KS model's flax variables."""
    params = variables.get("params", {}) if hasattr(variables, "get") else {}
    out: Dict[str, torch.Tensor] = {}
    for mod_name, sub in params.items():
        if mod_name not in _MODULE_NAMES:
            raise KeyError(f"no port counterpart for flax module {mod_name!r}")
        prefix = _MODULE_NAMES[mod_name]
        for name, leaf in sub.items():
            if name.startswith("Dense_"):
                i = int(name.split("_", 1)[1])
                out[f"{prefix}.layers.{i}.weight"] = _tensor(
                    np.asarray(leaf["kernel"]).T)
                out[f"{prefix}.layers.{i}.bias"] = _tensor(leaf["bias"])
            else:
                out[f"{prefix}.{name}"] = _tensor(leaf)
    return out
