"""Checkpoints as the JAX package writes them: a pickle of numpy trees.

``save_checkpoint(path, payload)`` turns every tensor in ``payload`` (dicts,
lists and tuples of tensors, arrays and scalars) into a numpy array and
pickles the result, as ``pnode_tpu/utils/checkpoint.py``'s pickle backend
does, so a file written by either package reads in the other; a bf16
tensor is stored as fp32 (numpy has no bf16). ``load_checkpoint`` returns
the numpy tree. ``format`` (or ``-pnode_checkpoint_format``) must be
"pickle": the port writes no orbax directory.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch


def _to_numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    return tree


def _resolve_format(fmt):
    if fmt is None:
        from ..options import Options

        fmt = Options().get_string("pnode_checkpoint_format", "pickle")
    if fmt != "pickle":
        raise ValueError(f"checkpoint format {fmt!r}: the port writes pickle "
                         "only (no orbax)")
    return fmt


def save_checkpoint(path: str, payload: Dict[str, Any],
                    format: str | None = None) -> None:
    """Write ``payload`` (a dict of tensor trees and metadata) to ``path``."""
    _resolve_format(format)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy_tree(payload), f)


def load_checkpoint(path: str, format: str | None = None):
    """Read a checkpoint written by save_checkpoint (either package's)."""
    _resolve_format(format)
    with open(path, "rb") as f:
        return pickle.load(f)
