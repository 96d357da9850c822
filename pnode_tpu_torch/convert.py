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

``ffjord_state_dict_from_flax(flow, params)`` does the same for an FFJORD
flow of ``pnode_tpu_torch.ffjord`` from what its JAX counterpart's
``init`` returns (lists of per-layer, per-block or per-scale flax
variables, MovingBatchNorm's and the other flow layers' plain dicts):
``Dense`` kernels transposed, ``Conv`` kernels HWIO -> OIHW,
``ConvTranspose`` kernels flipped in both spatial dims and laid out (in,
out, kh, kw) for ``F.conv_transpose2d``, GroupNorm's and BatchNorm's
scale -> weight, BatchNorm's ``batch_stats`` -> its running buffers,
SpectralDense's ``spectral`` vector -> its buffer ``u``; flax's
submodule names (``<Kind>_<i>`` counted per kind, ``<list>_<i>``) are
paired with the port's children in registration order.
``ffjord_states_from_flax`` carries MovingBatchNorm's running statistics
(the flow state).

``grand_state_dict_from_flax(model, params)`` does the same for a GRAND
model (``models.grand.GRANDModel`` or ``models.grand_image.GRANDImage``)
from the dict of per-part flax variables its JAX counterpart's ``init``
returns.

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


# -- FFJORD -------------------------------------------------------------------

# flax leaf module kind -> {flax leaf name: (port name, transform)}
_FLAX_LEAVES = {
    # Dense kernel (in, out) -> nn.Linear weight (out, in)
    "Dense": {"kernel": ("weight", lambda k: k.T), "bias": ("bias", None)},
    # Conv kernel HWIO (I = in / groups) -> OIHW
    "Conv": {"kernel": ("weight", lambda k: k.transpose(3, 2, 0, 1)),
             "bias": ("bias", None)},
    # ConvTranspose kernel HWIO, correlated unflipped by lax ->
    # F.conv_transpose2d's (in, out, kh, kw), which it flips
    "ConvTranspose": {
        "kernel": ("weight",
                   lambda k: np.flip(k, (0, 1)).transpose(2, 3, 0, 1)),
        "bias": ("bias", None)},
    "GroupNorm": {"scale": ("weight", None), "bias": ("bias", None)},
    "BatchNorm": {"scale": ("weight", None), "bias": ("bias", None),
                  "mean": ("running_mean", None),
                  "var": ("running_var", None)},
}


def _flax_kind(module) -> str:
    return "Dense" if isinstance(module, torch.nn.Linear) else \
        type(module).__name__


def _flax_children(module, tree: Mapping):
    """(flax name, port path, child) of a port module's children: flax
    names a compact module's submodules ``<Kind>_<i>`` counted per kind in
    creation order (the port registers its children in that order, a
    ModuleList's members in turn), a setup module's list members
    ``<attr>_<i>``, and a submodule given ``name=`` by that name (the port
    registers it under the same attribute; it takes no count)."""
    counts: Dict[str, int] = {}

    def counted(child):
        kind = _flax_kind(child)
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        return f"{kind}_{i}"

    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            for i, c in enumerate(child):
                key = f"{name}_{i}"
                yield (key if key in tree else counted(c)), f"{name}.{i}", c
        elif name in tree:  # a submodule flax names explicitly (name=...)
            yield name, name, child
        else:
            yield counted(child), name, child


def _flax_walk(module, tree: Mapping, prefix: str, out: Dict):
    leaf = _FLAX_LEAVES.get(_flax_kind(module))
    if leaf is not None:
        for name, arr in tree.items():
            port, fn = leaf[name]
            a = np.asarray(arr)
            out[prefix + port] = _tensor(fn(a) if fn else a)
        return
    own = dict(module.named_parameters(recurse=False))
    own.update(module.named_buffers(recurse=False))
    seen = set()
    for name in tree:
        if name in own:  # a raw variable (self.param / self.variable)
            out[prefix + name] = _tensor(tree[name])
            seen.add(name)
    for key, path, child in _flax_children(module, tree):
        if key in tree:
            _flax_walk(child, tree[key], f"{prefix}{path}.", out)
            seen.add(key)
    missing = set(tree) - seen
    if missing:
        raise KeyError(f"no port counterpart for flax entries "
                       f"{sorted(missing)} under {prefix or 'the root'!r}")


def _flax_state_dict(module, variables: Mapping,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """The state_dict entries of a port ``nn.Module`` that mirrors a flax
    module from its flax variables (every collection: ``params``,
    ``batch_stats``, ``spectral``)."""
    out: Dict[str, torch.Tensor] = {}
    colls = variables if "params" in variables else {"params": variables}
    for tree in colls.values():
        _flax_walk(module, tree, prefix, out)
    return out


def ffjord_state_dict_from_flax(flow, params,
                                prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX FFJORD flow's parameters: ``flow``
    is the port's counterpart (a ``SequentialFlow``, ``CNFLayer``,
    ``CNF``, ``ODENVP``, ``MultiscaleParallelCNF``, a flow layer or a
    flax-mirroring module) and ``params`` what the JAX object's ``init``
    returned, as numpy arrays. MovingBatchNorm's running statistics are
    flow state, not parameters: ``ffjord_states_from_flax`` carries
    them."""
    from .ffjord import cnf, flows, odenvp, other_flows

    out: Dict[str, torch.Tensor] = {}
    if isinstance(flow, flows.SequentialFlow):
        for i, (layer, p) in enumerate(zip(flow.layers, params)):
            out.update(ffjord_state_dict_from_flax(
                layer, p, f"{prefix}layers.{i}."))
    elif isinstance(flow, flows.CNFLayer):
        out.update(ffjord_state_dict_from_flax(flow.cnf, params,
                                               prefix + "cnf."))
    elif isinstance(flow, cnf.CNF):
        out.update(_flax_state_dict(flow.net, params, prefix + "net."))
    elif isinstance(flow, odenvp.ODENVP):
        for s, (blocks, ps) in enumerate(zip(flow.scales, params)):
            for b, (blk, p) in enumerate(zip(blocks, ps)):
                out.update(ffjord_state_dict_from_flax(
                    blk, p, f"{prefix}scales.{s}.{b}."))
    elif isinstance(flow, odenvp.MultiscaleParallelCNF):
        for b, (blk, p) in enumerate(zip(flow.blocks, params)):
            out.update(ffjord_state_dict_from_flax(
                blk, p, f"{prefix}blocks.{b}."))
    elif isinstance(flow, other_flows.MaskedCouplingLayer):
        out.update(_flax_state_dict(flow.net_scale, params["scale"],
                                          prefix + "net_scale."))
        out.update(_flax_state_dict(flow.net_shift, params["shift"],
                                          prefix + "net_shift."))
    elif isinstance(flow, other_flows.CouplingLayer):
        out.update(_flax_state_dict(flow.net, params, prefix + "net."))
    else:  # a plain dict of a flow layer's own tensors, or flax variables
        out.update(_flax_state_dict(flow, params, prefix))
    return out


def ffjord_states_from_flax(states):
    """A JAX flow's state (MovingBatchNorm's running statistics: a list of
    dicts of arrays) as the port's flow state, on the CPU; move it with
    the flow's inputs."""
    if isinstance(states, Mapping):
        return {k: ffjord_states_from_flax(v) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return [ffjord_states_from_flax(v) for v in states]
    return _tensor(states)


# -- GRAND --------------------------------------------------------------------


def grand_state_dict_from_flax(model, params) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ``GRANDModel`` or ``GRANDImage``:
    ``model`` is the port's counterpart and ``params`` what the JAX
    object's ``init`` returned (``{"enc", "func", "dec"}`` and, where the
    model has them, ``"enc_pos"`` and ``"hard_att"``; ``{"func", "dec"}``
    for GRANDImage), as numpy arrays. Each entry maps onto the port
    module of its name: Dense kernels transposed; the dynamics' own
    variables (``alpha_train``, ``beta_train``, ``gamma``, ``a_src``,
    ``a_dst``) copied; flax's ``W`` and ``Wout`` by name."""
    out: Dict[str, torch.Tensor] = {}
    for name, variables in params.items():
        out.update(_flax_state_dict(getattr(model, name), variables,
                                    name + "."))
    return out
