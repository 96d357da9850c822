"""Carry weights from the JAX package's flax variables into the port.

``state_dict_from_flax(variables)`` takes a flax variable tree (nested dicts
of numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, variables)``)
of one of the SINODE models (``KSFuncIM``, ``KSFuncEX``, ``KSSnodeFunc``,
``KSMLPFunc``, ``BurgersFuncIM``, ``BurgersFuncEX``) and returns the
matching PyTorch ``state_dict``:

- ``StackedMLP_0/Dense_i/{kernel, bias}`` -> ``net.layers.i.{weight, bias}``;
  a flax Dense kernel is (in, out) and ``nn.Linear.weight`` is (out, in),
  so the kernel is transposed.
- ``FusedStackedMLP_0/{kernel_i, bias_i}`` -> ``net.{kernel_i, bias_i}``,
  copied as they are (the fused module keeps the (in, out) layout).
- ``CircularConv1D_0/kernel`` -> ``conv.kernel`` (learnable stencil; a
  fixed stencil has no flax variable and no state_dict entry).

Any other flax module raises ``KeyError``.

``dense_stack_from_flax(variables, prefix)`` maps a flax module built of
``Dense`` layers alone (the pendulum DAE's nets, ``Dense(use_bias=False)``)
onto a ``layers`` ModuleList of ``nn.Linear``: ``Dense_i/kernel`` ->
``{prefix}layers.i.weight`` (transposed), and the bias where there is one.

``sqnxt_state_dict_from_flax(param_list)`` does the same for the
SqueezeNext ODE-net (``models.SqueezeNextODE``) from the list of per-piece
flax variables its JAX counterpart's ``init`` returns.

Nothing here imports JAX: the caller converts the arrays to numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_MODULE_NAMES = {
    "StackedMLP_0": "net",
    "FusedStackedMLP_0": "net",
    "CircularConv1D_0": "conv",
}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def dense_stack_from_flax(variables: Mapping,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict entries of a ``layers`` ModuleList of ``nn.Linear``
    from a flax module of ``Dense_i`` layers (kernel (in, out) -> weight
    (out, in); a layer with ``use_bias=False`` has no bias entry)."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        kind, i = name.rsplit("_", 1)
        if kind != "Dense":
            raise KeyError(f"no port counterpart for flax module {name!r}")
        out[f"{prefix}layers.{i}.weight"] = _tensor(
            np.asarray(leaf["kernel"]).T)
        if "bias" in leaf:
            out[f"{prefix}layers.{i}.bias"] = _tensor(leaf["bias"])
    return out


def sqnxt_piece_from_flax(variables: Mapping,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict of one SqueezeNext piece (Stem, BasicBlock,
    ODEDynamics or Head) from its flax variables:
    ``Conv_i/{kernel, bias}`` -> ``convs.i.{weight, bias}`` with the kernel
    (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw); ``BatchStatsNorm_i/{scale,
    bias}`` -> ``norms.i.{scale, bias}``; ``Dense_0/{kernel, bias}`` ->
    ``dense.{weight, bias}`` with the kernel (in, out) -> (out, in)."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        kind, i = name.rsplit("_", 1)
        if kind == "Conv":
            out[f"{prefix}convs.{i}.weight"] = _tensor(
                np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))
            out[f"{prefix}convs.{i}.bias"] = _tensor(leaf["bias"])
        elif kind == "BatchStatsNorm":
            out[f"{prefix}norms.{i}.scale"] = _tensor(leaf["scale"])
            out[f"{prefix}norms.{i}.bias"] = _tensor(leaf["bias"])
        elif kind == "Dense":
            out[f"{prefix}dense.weight"] = _tensor(np.asarray(leaf["kernel"]).T)
            out[f"{prefix}dense.bias"] = _tensor(leaf["bias"])
        else:
            raise KeyError(f"no port counterpart for flax module {name!r}")
    return out


def sqnxt_state_dict_from_flax(
        param_list: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """The state_dict of ``models.SqueezeNextODE`` from the list of flax
    variables that the JAX package's ``SqueezeNextODE.init`` returns (one
    entry per piece, in order)."""
    out: Dict[str, torch.Tensor] = {}
    for p, variables in enumerate(param_list):
        out.update(sqnxt_piece_from_flax(variables, f"pieces.{p}."))
    return out


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a SINODE model's flax variables."""
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
