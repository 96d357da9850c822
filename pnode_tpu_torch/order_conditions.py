"""Order conditions for additive (IMEX) Runge-Kutta pairs via colored trees.

An additive RK method (A_im, A_ex with shared weights b and abscissae c) has
combined order p iff for every 2-colored rooted tree t with |t| <= p

    b . phi(t) = 1 / gamma(t)

where phi is built recursively with the child's root color selecting which A
lifts that subtree (Araujo, Murua & Sanz-Serna 1997; Kennedy & Carpenter
2003). Because b is shared, the root's own color does not change the
algebraic condition, so trees are enumerated modulo root color.

Used by the tests to assert the hand-entered Kennedy-Carpenter ARK3/ARK4
tableaus satisfy EVERY coupling condition (not just the per-method ones).
The port's copy of ``pnode_tpu/order_conditions.py`` (numpy only).
"""

from __future__ import annotations

import itertools
from fractions import Fraction
from functools import lru_cache
from typing import List, Tuple

import numpy as np

# A colored tree is represented canonically as a sorted tuple of
# (color, subtree) pairs, where color in {0, 1} is the COLOR OF THE CHILD'S
# ROOT (0 = implicit, 1 = explicit). The overall root carries no color.
ColoredTree = Tuple  # recursive tuple type


@lru_cache(maxsize=None)
def _colored_trees(order: int) -> Tuple[ColoredTree, ...]:
    """All colored trees with `order` nodes (root color factored out)."""
    if order == 1:
        return ((),)  # the single leaf: no children
    results = set()
    # partition order-1 remaining nodes into child subtrees
    for parts in _partitions(order - 1):
        # parts: multiset of child subtree sizes
        child_choices = []
        for sz in parts:
            subs = _colored_trees(sz)
            child_choices.append(
                [(color, sub) for color in (0, 1) for sub in subs]
            )
        for combo in itertools.product(*child_choices):
            results.add(tuple(sorted(combo)))
    return tuple(sorted(results))


@lru_cache(maxsize=None)
def _partitions(n: int) -> Tuple[Tuple[int, ...], ...]:
    """Integer partitions of n as non-increasing tuples."""
    if n == 0:
        return ((),)
    out = set()
    for first in range(n, 0, -1):
        for rest in _partitions(n - first):
            if not rest or first >= rest[0]:
                out.add((first,) + rest)
    return tuple(sorted(out))


def tree_order(t: ColoredTree) -> int:
    return 1 + sum(tree_order(sub) for _, sub in t)


def tree_density(t: ColoredTree) -> Fraction:
    """gamma(t): |t| * prod gamma(subtrees)."""
    g = Fraction(tree_order(t))
    for _, sub in t:
        g *= tree_density(sub)
    return g


def all_conditions(max_order: int) -> List[ColoredTree]:
    trees: List[ColoredTree] = []
    for p in range(1, max_order + 1):
        trees.extend(_colored_trees(p))
    return trees


def phi(t: ColoredTree, a_im: np.ndarray, a_ex: np.ndarray) -> np.ndarray:
    """Elementary weight vector phi(t) in R^s."""
    s = a_im.shape[0]
    v = np.ones(s)
    for color, sub in t:
        A = a_im if color == 0 else a_ex
        v = v * (A @ phi(sub, a_im, a_ex))
    return v


def residuals(a_im, a_ex, b, max_order: int) -> np.ndarray:
    """b.phi(t) - 1/gamma(t) for every colored tree up to max_order."""
    a_im = np.asarray(a_im, dtype=np.float64)
    a_ex = np.asarray(a_ex, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = []
    for t in all_conditions(max_order):
        out.append(float(b @ phi(t, a_im, a_ex)) - float(1 / tree_density(t)))
    return np.asarray(out)


def n_conditions(max_order: int) -> int:
    return len(all_conditions(max_order))
