"""Every FFJORD diffeq layer of the port against flax's, forward and VJP,
on the CPU in fp64.

Each entry of ``DIFFEQ_LAYERS`` (on (5, 4) inputs) and of
``DIFFEQ_CONV_LAYERS`` (on NHWC (2, 5, 6, 3) inputs, odd and even sizes, at
stride 1 and 2, plain and transposed), and the gated units: the flax
layer's fp64 weights carried into the port (``convert.py``: Dense kernels
transposed, Conv kernels HWIO -> OIHW, ConvTranspose kernels flipped for
``F.conv_transpose2d``), the output and the VJP of a random cotangent with
respect to the input and every parameter within 1e-12 of max |ref| (fp64
products summed in another order). The stride-2 cases hold lax's
asymmetric SAME padding and the transposed ones lax's unflipped kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.ffjord import layers as JL
from pnode_tpu_torch.convert import ffjord_state_dict_from_flax
from pnode_tpu_torch.ffjord import layers as PL
from torch_ffjord_twins import assert_grads_match, carry, f64, rel

torch.set_num_threads(1)
TOL = 1e-12


def _vjp_matches(jlayer, layer, x, args=(0.37,)):
    """Forward and VJP (input and parameters) of ``layer`` against
    ``jlayer``'s at ``x`` (args are the leading call arguments, t)."""
    rng = np.random.default_rng(5)
    p = f64(jlayer.init(jax.random.PRNGKey(2), *args, jnp.asarray(x)))
    p = jax.tree_util.tree_map(  # weights off their init (zero biases)
        lambda a: a + 0.1 * rng.normal(size=a.shape), p)
    layer = carry(layer.to(torch.float64), p)
    jout, vjp = jax.vjp(lambda q, xx: jlayer.apply(q, *args, xx), p,
                        jnp.asarray(x))
    g = rng.normal(size=jout.shape)
    jgp, jgx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(*args, xt)
    assert tuple(out.shape) == tuple(jout.shape)
    assert rel(out, jout) <= TOL
    out.backward(torch.from_numpy(g))
    assert rel(xt.grad, jgx) <= TOL
    assert_grads_match(layer, jgp, TOL)


@pytest.mark.parametrize("layer_type", sorted(JL.DIFFEQ_LAYERS))
def test_dense_layer_forward_and_vjp(layer_type):
    x = np.random.default_rng(1).normal(size=(5, 4))
    _vjp_matches(JL.build_diffeq_layer(layer_type, 3),
                 PL.build_diffeq_layer(layer_type, 4, 3), x)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transpose"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("layer_type", sorted(JL.DIFFEQ_CONV_LAYERS))
def test_conv_layer_forward_and_vjp(layer_type, stride, transpose):
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 3))
    kw = dict(stride=stride, transpose=transpose)
    _vjp_matches(JL.build_diffeq_layer(layer_type, 4, conv=True, **kw),
                 PL.build_diffeq_layer(layer_type, 3, 4, conv=True, **kw), x)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["GatedConv", "GatedConvTranspose"])
def test_gated_conv_forward_and_vjp(kind, stride):
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 3))
    _vjp_matches(getattr(JL, kind)(dim_out=4, stride=stride),
                 getattr(PL, kind)(3, 4, stride=stride), x, args=())


def test_gated_linear_and_valid_grouped_conv():
    """GatedLinear, and a VALID grouped GatedConv (groups 3 on 6 channels:
    the kernel's (kh, kw, in / groups, out) layout)."""
    rng = np.random.default_rng(4)
    _vjp_matches(JL.GatedLinear(dim_out=5), PL.GatedLinear(7, 5),
                 rng.normal(size=(4, 7)), args=())
    _vjp_matches(JL.GatedConv(dim_out=6, padding="VALID", groups=3),
                 PL.GatedConv(6, 6, padding="VALID", groups=3),
                 rng.normal(size=(2, 7, 6, 6)), args=())


def test_build_diffeq_layer_refuses_unknown_types_and_converter_strays():
    with pytest.raises(ValueError, match="unknown layer_type"):
        PL.build_diffeq_layer("nope", 2, 2)
    with pytest.raises(ValueError, match="unknown layer_type"):
        PL.build_diffeq_layer("nope", 2, 2, conv=True)
    layer = PL.build_diffeq_layer("concat", 2, 3)
    with pytest.raises(KeyError, match="no port counterpart"):
        ffjord_state_dict_from_flax(layer, {"params": {"Dense_0": {
            "kernel": np.zeros((3, 3)), "bias": np.zeros(3)},
            "Dense_7": {"kernel": np.zeros((3, 3))}}})
