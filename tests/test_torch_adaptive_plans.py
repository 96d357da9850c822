"""CN's revolve and CAMS cases of the adaptive trajectory-policy twin
(tests/test_adaptive.py:279-293; the other six cases are in
tests/test_torch_adaptive_policies.py, which holds the helpers), in their
own file: on CN (Newton with matrix-free GMRES, ~1100 accepted trials at
rtol 1e-7) the port replays revolve's 7,140 re-steps and CAMS's plan over
4,096 trial slots on the host, the longest twins of the slice.

Each policy's gradients equal store_all's bit for bit (the reference:
rtol 1e-10) and the JAX package's under the same flags at rtol 1e-10.
"""

import pytest
import torch

import pnode_tpu_torch as pt
from test_torch_adaptive_policies import check_policy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


@pytest.mark.parametrize("policy", ["revolve", "cams"])
def test_adaptive_policy_gradients_match_store_all_cn(policy):
    """Twin of test_adaptive.py:286's CN revolve and CAMS cases."""
    check_policy(policy, "cn", True)
