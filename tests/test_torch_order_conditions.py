"""Twins of tests/test_order_conditions.py on the port's copies: the
colored-tree order conditions (``pnode_tpu_torch/order_conditions.py``)
on the port's tableaus (``pnode_tpu_torch/tableaus.py``); the copy itself
is pinned to the original in tests/test_torch_scaffold.py."""

import numpy as np
import pytest

from pnode_tpu_torch.order_conditions import (
    all_conditions,
    n_conditions,
    residuals,
    tree_order,
)
from pnode_tpu_torch.tableaus import get_ark_tableau, get_rk_tableau


def test_tree_counts():
    """Twin of :16: 1 and 2 trees at orders 1 and 2, strictly growing."""
    counts = [len([t for t in all_conditions(5) if tree_order(t) == p])
              for p in range(1, 6)]
    assert counts[0] == 1
    assert counts[1] == 2
    assert counts[2] > counts[1] and counts[3] > counts[2]
    assert n_conditions(5) == sum(counts)


def test_single_method_reduction_matches_rk():
    """Twin of :27: with A_im == A_ex the conditions are plain RK's: rk4
    meets order 4 and not 5, dopri5 meets order 5."""
    tab = get_rk_tableau("rk4")
    np.testing.assert_allclose(residuals(tab.a, tab.a, tab.b, 4), 0.0,
                               atol=1e-14)
    assert np.max(np.abs(residuals(tab.a, tab.a, tab.b, 5))) > 1e-3
    d5 = get_rk_tableau("dopri5")
    np.testing.assert_allclose(residuals(d5.a, d5.a, d5.b, 5), 0.0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["1bee", "ars122", "l2", "3", "4", "5", "5a"])
def test_ark_pairs_satisfy_all_coupling_conditions(name):
    """Twin of :40: every coupling condition up to the pair's order."""
    tab = get_ark_tableau(name)
    r = residuals(tab.a_im, tab.a_ex, tab.b_im, tab.order)
    np.testing.assert_allclose(r, 0.0, atol=5e-11, err_msg=name)


def _stab_R(z, A, b):
    s = len(b)
    return 1.0 + z * (b @ np.linalg.solve(np.eye(s) - z * A, np.ones(s)))


def test_ark5_L_stable_with_embedded_order4():
    """Twin of :54: the "5" slot is L-stable with an order-4 embedded
    estimator and a stiffly accurate ESDIRK part."""
    tab = get_ark_tableau("5")
    gamma = float(tab.a_im[1, 1])
    S = tab.stages
    alpha = np.zeros(S)
    alpha[0] = 1.0
    for i in range(1, S):
        alpha[i] = -np.dot(tab.a_im[i, :i], alpha[:i]) / gamma
    w = np.zeros(S)
    for i in range(1, S):
        w[i] = (alpha[i] - 1.0 - np.dot(tab.a_im[i, 1:i], w[1:i])) / gamma
    rinf = 1.0 + np.dot(tab.b_im, w)
    assert abs(rinf) < 1e-12, f"not L-stable: R(inf) = {rinf}"
    for z in (-0.5, -3.0, -40.0, -1e3, complex(-1, 4), complex(-20, 60)):
        assert abs(_stab_R(z, tab.a_im, tab.b_im)) <= 1.0 + 1e-9, z
    assert tab.b_im_err is not None and tab.embedded_order == 4
    r4 = residuals(tab.a_im, tab.a_ex, tab.b_im_err, 4)
    np.testing.assert_allclose(r4, 0.0, atol=5e-11)
    r5 = residuals(tab.a_im, tab.a_ex, tab.b_im_err, 5)
    assert np.max(np.abs(r5)) > 1e-4, "embedded weights accidentally order 5"
    np.testing.assert_allclose(tab.a_im[-1], tab.b_im, atol=1e-14)
    assert tab.a_im[0, 0] == 0.0
