"""The port's KS models and K1 (fused MLP) against the JAX package.

Weights are made by flax ``init`` and carried across with
``convert.state_dict_from_flax``; inputs are made with numpy from a seed.
Models are compared in fp64 (rtol 1e-12); K1's plain version in fp32
against JAX's ``fused_mlp`` in interpret mode (forward rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6: fp32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch
from pnode_tpu.models import KSFuncEX as JKSFuncEX
from pnode_tpu.models import KSFuncIM as JKSFuncIM
from pnode_tpu.models.sinode import circular_stencil_apply as j_stencil
from pnode_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from pnode_tpu_torch.convert import state_dict_from_flax
from pnode_tpu_torch.models import KSFuncEX, KSFuncIM
from pnode_tpu_torch.models.sinode import circular_stencil_apply
from pnode_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_bwd, fused_mlp_fwd, fused_mlp_plain,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, variables, dtype):
    module = module.to(dtype)
    module.load_state_dict(state_dict_from_flax(_np(variables)), strict=True)
    return module


def _stack(seed, dims, bias_scale):
    rng = np.random.default_rng(seed)
    Ws = [rng.normal(0, 0.3, size=(a, b)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(bias_scale * rng.normal(size=b)).astype(np.float32)
          for b in dims[1:]]
    return Ws, bs


@pytest.mark.parametrize("fixed", [True, False])
def test_ks_func_im_fp64(fixed):
    B, nx = 5, 16
    y = np.random.default_rng(0).normal(size=(B, nx))
    jm = JKSFuncIM(nx=nx, fixed_linear=fixed)
    v = jm.init(jax.random.PRNGKey(3), 0.0, jnp.zeros((B, nx)))
    ref = np.asarray(jm.apply(v, 0.0, jnp.asarray(y)))
    tm = _port(KSFuncIM(nx=nx, fixed_linear=fixed), v, torch.float64)
    got = tm(0.0, torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert tm.linear_in_y == fixed
    assert (len(list(tm.parameters())) == 0) == fixed


@pytest.mark.parametrize("fused", [False, True])
def test_ks_func_ex_fp64(fused):
    B, nx, hidden = 6, 16, 24
    y = np.random.default_rng(1).normal(size=(B, nx))
    jm = JKSFuncEX(nx=nx, hidden=hidden, use_pallas=fused)
    v = jm.init(jax.random.PRNGKey(4), 0.0, jnp.zeros((B, nx)))
    v = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(a.shape)), v)
    ref = np.asarray(jm.apply(v, 0.0, jnp.asarray(y)))
    tm = _port(KSFuncEX(nx=nx, hidden=hidden, use_fused=fused), v,
               torch.float64)
    got = tm(0.0, torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)
    assert (tm.fused_mlp_spec(dict(tm.named_parameters())) is None) != fused


def test_convert_transposes_dense_kernels():
    jm = JKSFuncEX(nx=16, hidden=8)
    v = _np(jm.init(jax.random.PRNGKey(0), 0.0, jnp.zeros((2, 16))))
    sd = state_dict_from_flax(v)
    k0 = v["params"]["StackedMLP_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(sd["net.layers.0.weight"].numpy(), k0.T)
    jf = JKSFuncEX(nx=16, hidden=8, use_pallas=True)
    vf = _np(jf.init(jax.random.PRNGKey(0), 0.0, jnp.zeros((2, 16))))
    sdf = state_dict_from_flax(vf)
    np.testing.assert_array_equal(
        sdf["net.kernel_1"].numpy(), vf["params"]["FusedStackedMLP_0"]["kernel_1"])


def test_circular_stencil_matches_jax():
    rng = np.random.default_rng(2)
    y, k = rng.normal(size=(3, 11)), rng.normal(size=5)
    ref = np.asarray(j_stencil(jnp.asarray(y), jnp.asarray(k)))
    got = circular_stencil_apply(torch.from_numpy(y), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_k1_plain_forward_matches_jax_interpret(activation):
    dims = [16, 24, 24, 16]
    Ws, bs = _stack(5, dims, 0.1)
    x = np.random.default_rng(6).normal(size=(13, 16)).astype(np.float32)
    ref = np.asarray(j_fused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in Ws],
                                 [jnp.asarray(b) for b in bs], activation,
                                 interpret=True))
    got = fused_mlp_fwd(torch.from_numpy(x), [torch.from_numpy(w) for w in Ws],
                        [torch.from_numpy(b) for b in bs], activation)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_k1_plain_gradients_match_jax_interpret(activation):
    dims = [16, 24, 24, 24, 16]
    Ws, bs = _stack(7, dims, 0.1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(11, 16)).astype(np.float32)
    g = rng.normal(size=(11, 16)).astype(np.float32)

    def jloss(x, Ws, bs):
        return jnp.sum(j_fused_mlp(x, Ws, bs, activation, interpret=True)
                       * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), [jnp.asarray(w) for w in Ws],
        [jnp.asarray(b) for b in bs])
    xt = torch.from_numpy(x).requires_grad_(True)
    Wt = [torch.from_numpy(w).requires_grad_(True) for w in Ws]
    bt = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    (fused_mlp(xt, Wt, bt, activation) * torch.from_numpy(g)).sum().backward()
    pairs = [(xt.grad, jgrads[0])]
    pairs += list(zip([w.grad for w in Wt], jgrads[1]))
    pairs += list(zip([b.grad for b in bt], jgrads[2]))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)


def test_k1_backward_matches_autograd_of_plain():
    dims = [8, 12, 8]
    Ws, bs = _stack(9, dims, 0.5)
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(7, 8)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(11).normal(
        size=(7, 8)).astype(np.float32))
    Wt = [torch.from_numpy(w).requires_grad_(True) for w in Ws]
    bt = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    xt = x.clone().requires_grad_(True)
    (fused_mlp_plain(xt, Wt, bt, "tanh") * g).sum().backward()
    dx, dWs, dbs = fused_mlp_bwd(x, g, [w.detach() for w in Wt],
                                 [b.detach() for b in bt], "tanh")
    torch.testing.assert_close(dx, xt.grad, rtol=1e-5, atol=1e-6)
    for a, w in zip(dWs, Wt):
        torch.testing.assert_close(a, w.grad, rtol=1e-5, atol=1e-6)
    for a, b in zip(dbs, bt):
        torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-6)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    Ws, bs = _stack(12, [4, 6, 4], 0.0)
    W = [torch.from_numpy(w) for w in Ws]
    b = [torch.from_numpy(v) for v in bs]
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp_fwd(x.double(), W, b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp_fwd(torch.zeros(4, 3).T, W, b)
    with pytest.raises(ValueError, match="chain"):
        fused_mlp_fwd(x, W[::-1], b)
    with pytest.raises(ValueError, match="activation"):
        fused_mlp_fwd(x, W, b, "sigmoid")
    with pytest.raises(ValueError, match="layers"):
        fused_mlp_fwd(x, W * 5, b * 5)
    assert fused_mlp_fwd.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("dtype, match", [(torch.float64, "float32"),
                                          (torch.float32, "device")])
def test_fused_stacked_mlp_off_cpu_always_reaches_k1(dtype, match):
    """Only CPU tensors of another dtype take the plain stack; off the CPU
    (here the meta device, as no card is present) every input goes to the K1
    wrapper, which raises on what the kernel does not take."""
    from pnode_tpu_torch.models.sinode import FusedStackedMLP

    net = FusedStackedMLP(4, (6, 4), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        net(torch.zeros(3, 4, dtype=dtype, device="meta"))
    cpu = FusedStackedMLP(4, (6, 4), dtype=torch.float64)
    assert cpu(torch.ones(3, 4, dtype=torch.float64)).dtype == torch.float64
