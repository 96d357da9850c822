"""K1's scratch sizes, and its plain versions against JAX at the Burgers
widths and at the edges of the kernels' tiling.

The kernels (``csrc/fused_mlp.cu``) own their grids and run only on the
card (``chip_smoke.py`` phases 3 and 7); ``mlp_scratch`` gives the scratch
each call allocates, which the C entry points check. Here: the scratch
holds what each launch writes, at the KS widths, the Burgers widths, ragged
widths and 1-8 layers, and stacks the kernels do not take are refused,
as is a bad cotangent; and the plain forward and backward against JAX's
``fused_mlp`` in interpret mode at 512 -> 576 x4 -> 512, B 8, and at
chip_smoke's KS stack and K1 edge shapes (B 1 and 37, widths 13 and 100,
1 and 8 layers, tanh), seeded numpy inputs, fp32 (max |diff| within 1e-5
of max |ref| forward, 1e-4 backward: fp32 products summed in another
order); and the input VJP at tests/test_ops.py's divergence-path dims
[16, 24, 16] at that test's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnode_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from pnode_tpu_torch.ops.fused_mlp import (
    MAX_LAYERS, fused_mlp, fused_mlp_bwd, fused_mlp_fwd, grad_buffer_size,
    mlp_scratch, split_grads,
)

torch.set_num_threads(1)

KS = (64, 104, 104, 104, 104, 64)
BURGERS = (512, 576, 576, 576, 576, 512)
STACKS = [
    (KS, 256), (BURGERS, 200), (KS, 1), (KS, 37),
    ((13, 100, 13, 100, 13), 37), ((100, 13), 37), ((3, 2), 5),
    ((64,) + (24,) * 7 + (64,), 37), ((31, 33, 32, 1), 65),
] + [((20,) * (n + 1), 33) for n in range(1, MAX_LAYERS + 1)]
# chip_smoke.py's K1_EDGES, at the same batches and activations, and
# phase 3's main case
EDGES = [
    ("KS-main", KS, 256, "relu"),
    ("B1", KS, 1, "relu"), ("B37", KS, 37, "relu"),
    ("widths-13-100", (13, 100, 13, 100, 13), 37, "relu"),
    ("1-layer", (100, 13), 37, "relu"),
    ("8-layers", (64,) + (24,) * 7 + (64,), 37, "relu"),
    ("tanh", KS, 256, "tanh"),
]


@pytest.mark.parametrize(
    "dims, B", STACKS,
    ids=[f"B{B}-{'x'.join(map(str, d))}" for d, B in STACKS])
def test_scratch_holds_what_each_launch_writes(dims, B):
    """The forward writes the output of hidden layer l into buffer l % 2 of
    fwd / 2 floats (one buffer of fwd floats for 2 layers); the backward
    holds the inputs of layers 1..n-1 back to back, then writes the
    cotangent of layer l's input (l = n-1..1) into buffer (n - 1 - l) % 2
    of the rest, as ``pnode_mlp_fwd`` / ``pnode_mlp_bwd`` lay them out."""
    fwd, bwd = mlp_scratch(dims, B)
    n = len(dims) - 1
    buf = fwd // 2 if n > 2 else fwd
    for l in range(n - 1):
        assert (l % 2) * buf + B * dims[l + 1] <= fwd
    h = B * sum(dims[1:-1])
    assert bwd == h + fwd
    for l in range(n - 1, 0, -1):
        assert h + ((n - 1 - l) % 2) * buf + B * dims[l] <= bwd
    assert (fwd == 0) == (n == 1)


def test_scratch_at_the_main_shapes():
    """Burgers: 0.92 MB of forward scratch, 2.76 MB in the backward (1.84
    MB of recomputed inputs); no ceil(B / 8) x weights partial buffer."""
    assert mlp_scratch(BURGERS, 200) == (2 * 200 * 576,
                                         200 * 576 * 4 + 2 * 200 * 576)
    assert mlp_scratch(KS, 256) == (2 * 256 * 104, 256 * 104 * 6)
    assert mlp_scratch((100, 13), 37) == (0, 0)


@pytest.mark.parametrize("dims, B", [
    (KS, 0), ((8,) * (MAX_LAYERS + 2), 4), ((8, 0, 8), 4), ((8,), 4)],
    ids=["B0", "9-layers", "width-0", "no-layer"])
def test_scratch_refuses_what_the_kernels_do_not_take(dims, B):
    with pytest.raises(ValueError, match="K1 takes"):
        mlp_scratch(dims, B)


@pytest.mark.parametrize("make_g, match", [
    (lambda g: g[:, :-1], "g must be"),
    (lambda g: g.double(), "float32"),
    (lambda g: g.T.contiguous().T, "contiguous"),
    (lambda g: g[0], "2-D"),
    (lambda g: g.numpy(), "tensor"),
], ids=["shape", "dtype", "strided", "1-D", "not-a-tensor"])
def test_backward_refuses_a_bad_cotangent(make_g, match):
    """fused_mlp_bwd checks g before it dispatches (CPU or card)."""
    x, g, Ws, bs = _stack(5, (6, 7, 5), 4)
    T = torch.from_numpy
    with pytest.raises((ValueError, TypeError), match=match):
        fused_mlp_bwd(T(x), make_g(T(g)), [T(w) for w in Ws],
                      [T(b) for b in bs])


def _stack(seed, dims, B):
    rng = np.random.default_rng(seed)
    Ws = [rng.normal(0, a ** -0.5, size=(a, b)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [rng.normal(0, 0.1, size=b).astype(np.float32) for b in dims[1:]]
    x = rng.normal(size=(B, dims[0])).astype(np.float32)
    g = rng.normal(size=(B, dims[-1])).astype(np.float32)
    return x, g, Ws, bs


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max |diff| / max |ref| = {err:.3e} > {tol:.0e}"


def _forward_matches_jax(seed, dims, B, activation):
    x, _, Ws, bs = _stack(seed, dims, B)
    ref = j_fused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in Ws],
                      [jnp.asarray(b) for b in bs], activation,
                      interpret=True)
    T = torch.from_numpy
    got = fused_mlp_fwd(T(x), [T(w) for w in Ws], [T(b) for b in bs],
                        activation)
    assert got.shape == (B, dims[-1]) and got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)
    assert fused_mlp_fwd.launches == 0  # CPU tensors run the plain version


def _backward_matches_jax(seed, dims, B, activation):
    x, g, Ws, bs = _stack(seed, dims, B)
    _, vjp = jax.vjp(lambda x, Ws, bs: j_fused_mlp(x, Ws, bs, activation,
                                                   interpret=True),
                     jnp.asarray(x), [jnp.asarray(w) for w in Ws],
                     [jnp.asarray(b) for b in bs])
    jdx, jdWs, jdbs = vjp(jnp.asarray(g))
    T = torch.from_numpy
    dx, dWs, dbs = fused_mlp_bwd(T(x), T(g), [T(w) for w in Ws],
                                 [T(b) for b in bs], activation)
    for got, ref in zip([dx, *dWs, *dbs], [jdx, *jdWs, *jdbs]):
        assert tuple(got.shape) == tuple(ref.shape)
        _close(got.numpy(), ref, 1e-4)
    # the autograd Function's gradient is the same backward
    xt = T(x).requires_grad_(True)
    Wt = [T(w).requires_grad_(True) for w in Ws]
    bt = [T(b).requires_grad_(True) for b in bs]
    (fused_mlp(xt, Wt, bt, activation) * T(g)).sum().backward()
    for got, ref in zip([xt.grad, *[w.grad for w in Wt],
                         *[b.grad for b in bt]], [dx, *dWs, *dbs]):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert fused_mlp_bwd.launches == 0


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_burgers_widths_forward_matches_jax_interpret(activation):
    _forward_matches_jax(21, BURGERS, 8, activation)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_burgers_widths_backward_matches_jax_interpret(activation):
    _backward_matches_jax(22, BURGERS, 8, activation)


@pytest.mark.parametrize("label, dims, B, activation", EDGES,
                         ids=[e[0] for e in EDGES])
def test_edge_shapes_forward_matches_jax_interpret(label, dims, B,
                                                   activation):
    _forward_matches_jax(31, dims, B, activation)


@pytest.mark.parametrize("label, dims, B, activation", EDGES,
                         ids=[e[0] for e in EDGES])
def test_edge_shapes_backward_matches_jax_interpret(label, dims, B,
                                                    activation):
    _backward_matches_jax(32, dims, B, activation)


def test_grad_buffer_layout_puts_each_bias_after_its_weight():
    """The backward writes [dW; db] of layer l as one (K + 1, N) block of
    the flat buffer: split_grads must read db as row K of it."""
    dims = (3, 5, 2)
    flat = torch.arange(float(grad_buffer_size(dims)))
    dWs, dbs = split_grads(flat, dims)
    off = 0
    for (K, N), dW, db in zip(zip(dims, dims[1:]), dWs, dbs):
        block = flat[off:off + (K + 1) * N].view(K + 1, N)
        assert torch.equal(block[:K], dW) and torch.equal(block[K], db)
        off += (K + 1) * N


def test_vjp_for_the_divergence_path_matches_jax_interpret():
    """The twin of tests/test_ops.py::test_fused_mlp_jvp_for_divergence_path
    at its dims [16, 24, 16], B 4, relu, on its draws (numpy seed 2, weights
    and biases N(0, 1) x 0.1 in fp32): the input VJP of K1's plain version,
    directly and through its autograd Function, against the VJP of JAX's
    fused_mlp in interpret mode, within the JAX test's tolerances (rtol
    2e-4, atol 1e-5)."""
    rng = np.random.default_rng(2)
    dims = [16, 24, 16]
    Ws = [rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
          * np.float32(0.1) for i in range(len(dims) - 1)]
    bs = [rng.normal(size=(dims[i + 1],)).astype(np.float32)
          * np.float32(0.1) for i in range(len(dims) - 1)]
    x = rng.normal(size=(4, 16)).astype(np.float32)
    v = rng.normal(size=(4, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: j_fused_mlp(
        xx, [jnp.asarray(w) for w in Ws], [jnp.asarray(b) for b in bs],
        "relu", interpret=True), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(v))[0])
    T = torch.from_numpy
    dx, _, _ = fused_mlp_bwd(T(x), T(v), [T(w) for w in Ws],
                             [T(b) for b in bs], "relu")
    np.testing.assert_allclose(dx.numpy(), ref, rtol=2e-4, atol=1e-5)
    xt = T(x).requires_grad_(True)
    (g,) = torch.autograd.grad(
        fused_mlp(xt, [T(w) for w in Ws], [T(b) for b in bs], "relu"), xt,
        grad_outputs=T(v))
    np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=1e-5)
    assert fused_mlp_bwd.launches == 0
