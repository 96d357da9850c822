"""Tree helpers over the port's parameter containers.

``pnode_tpu/misc.py`` maps over JAX pytrees; the port's parameters are
dicts of tensors (``named_parameters()``), grouped in tuples for the
(implicit, explicit) split of an IMEX model. These helpers recurse over
exactly those containers.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Apply ``fn`` leafwise over matching dicts / tuples / lists of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Tree) -> list:
    """Leaves in the same order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)
