"""K1: the dense stack (Dense -> act -> ... -> Dense), one tiled layer per
launch.

Replaces ``pnode_tpu/ops/fused_mlp.py`` ``_fwd_kernel`` (:75) and
``_bwd_kernel`` (:89). The CUDA source is ``csrc/fused_mlp.cu``; its note
says what bounds it on the H100 and what the design does about that.
The C entry points own the grids; ``mlp_scratch`` gives the scratch each
call needs, which they check.

- ``fused_mlp(x, Ws, bs, activation)`` is differentiable: a
  ``torch.autograd.Function`` whose forward is ``fused_mlp_fwd`` and whose
  backward is ``fused_mlp_bwd`` (recompute the layer inputs, then backprop).
- ``fused_mlp_fwd`` / ``fused_mlp_bwd`` check their inputs and, for CUDA
  tensors, launch the kernel (and count the launch) or raise. For CPU
  tensors they run the plain PyTorch versions ``fused_mlp_plain`` /
  ``fused_mlp_bwd_plain``, which compute the same function and are what
  the kernel is compared with on the card.

Shapes are the true widths (no 128-lane padding: that was a TPU tiling
artifact). ``x`` is (B, d_in) fp32; ``Ws[i]`` is (d_i, d_{i+1}) and
``bs[i]`` is (d_{i+1},), the JAX package's layout.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from . import _build

MAX_LAYERS = 8
ROWS_PER_BLOCK = 8  # csrc/pnode_kernels.cuh kRows: K2-K5 and K12's row tile
_ACT_CODES = {"relu": 1, "tanh": 2}


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(h) if activation == "relu" else torch.tanh(h)


def check_stack(x: torch.Tensor, weights, biases, activation: str,
                what: str) -> List[int]:
    """Validate an fp32 MLP stack against a (B, d_in) input; return dims.
    Each weight and bias takes one combined test; one that fails it is
    checked item by item for the message."""
    if activation not in _ACT_CODES:
        raise ValueError(f"{what}: unsupported activation {activation!r}")
    n = len(weights)
    if n < 1 or n > MAX_LAYERS or len(biases) != n:
        raise ValueError(f"{what}: needs 1..{MAX_LAYERS} layers with one "
                         f"bias each, got {n} weights, {len(biases)} biases")
    device = x.device if isinstance(x, torch.Tensor) else None
    _check_tensor(x, 2, what, "x", device)
    dims = [x.shape[1]]
    f32, Tensor = torch.float32, torch.Tensor
    for i in range(n):
        w, b = weights[i], biases[i]
        if not (isinstance(w, Tensor) and w.dtype == f32 and w.dim() == 2
                and w.device == device and w.is_contiguous()):
            _check_tensor(w, 2, what, f"weights[{i}]", device)
        if not (isinstance(b, Tensor) and b.dtype == f32 and b.dim() == 1
                and b.device == device and b.is_contiguous()):
            _check_tensor(b, 1, what, f"biases[{i}]", device)
        k, m = w.shape
        if k != dims[-1] or b.shape[0] != m:
            raise ValueError(
                f"{what}: layer {i} shapes {tuple(w.shape)}, {tuple(b.shape)} "
                f"do not chain from width {dims[-1]}")
        dims.append(m)
    return dims


def _check_tensor(t, ndim, what, name, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: {name} must be a tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")


def split_grads(flat: torch.Tensor, dims: Sequence[int]):
    """Views (dWs, dbs) into a flat [W0, b0, W1, b1, ...] gradient buffer."""
    sizes = []
    for k, n in zip(dims, dims[1:]):
        sizes += [k * n, n]
    pieces = flat.split_with_sizes(sizes)
    dWs = tuple(p.view(k, n) for p, k, n in zip(pieces[0::2], dims, dims[1:]))
    return dWs, pieces[1::2]


def grad_buffer_size(dims: Sequence[int]) -> int:
    return sum(k * n + n for k, n in zip(dims, dims[1:]))


@functools.lru_cache(maxsize=64)
def mlp_scratch(dims: Tuple[int, ...], B: int) -> Tuple[int, int]:
    """Scratch floats of one K1 forward and one backward call at widths
    ``dims`` (d_in, hidden..., d_out) and batch ``B``, which
    ``csrc/fused_mlp.cu``'s ``scratch_floats`` computes again and checks.

    The forward's hidden outputs alternate between two buffers of B x the
    widest hidden width (one buffer for a 2-layer stack, none for 1). The
    backward holds the recomputed inputs of layers 1..n-1 back to back,
    then buffers as the forward's for the hidden cotangents. Raises
    ValueError on a stack the kernels do not take."""
    n = len(dims) - 1
    if B < 1 or not 1 <= n <= MAX_LAYERS or min(dims) < 1:
        raise ValueError(f"K1 takes B >= 1 and 1..{MAX_LAYERS} layers of "
                         f"width >= 1, got B {B}, dims {list(dims)}")
    hidden = dims[1:-1]
    fwd = min(2, n - 1) * B * max(hidden, default=0)
    return fwd, B * sum(hidden) + fwd


@functools.lru_cache(maxsize=64)
def _c_dims(dims: Tuple[int, ...]):
    return _build.int_array(dims)


# -- plain PyTorch versions -------------------------------------------------

def fused_mlp_plain(x, weights, biases, activation="relu"):
    """Plain PyTorch forward of the stack (what the kernel computes)."""
    h = x
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < n - 1:
            h = _act(h, activation)
    return h


def fused_mlp_bwd_plain(x, g, weights, biases, activation="relu"):
    """Plain PyTorch backward: recompute the layer inputs, then backprop.
    Returns (dx, dWs, dbs) of <g, MLP(x)>."""
    n = len(weights)
    hs = [x]
    h = x
    for i in range(n - 1):
        h = _act(h @ weights[i] + biases[i], activation)
        hs.append(h)
    dWs: list = [None] * n
    dbs: list = [None] * n
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            if activation == "relu":
                g = g * (hs[i + 1] > 0).to(g.dtype)
            else:
                g = g * (1.0 - hs[i + 1] * hs[i + 1])
        dWs[i] = hs[i].T @ g
        dbs[i] = g.sum(dim=0)
        g = g @ weights[i].T
    return g, tuple(dWs), tuple(dbs)


# -- kernel wrappers --------------------------------------------------------

def _on_device(x, launch):
    """launch() with x's card current, switching cards (host work on
    every call) only when another card is current."""
    index = x.get_device()
    if torch.cuda.current_device() == index:
        return launch()
    with torch.cuda.device(index):
        return launch()


def fused_mlp_fwd(x, weights, biases, activation="relu"):
    """MLP(x) through K1's forward kernel (CUDA: one launch per layer) or
    its plain version (CPU)."""
    dims = check_stack(x, weights, biases, activation, "fused_mlp_fwd")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, biases, activation)
    lib = _build.library()
    B = x.shape[0]
    dims = tuple(dims)
    size = mlp_scratch(dims, B)[0]
    out = torch.empty((B, dims[-1]), dtype=x.dtype, device=x.device)
    scratch = torch.empty(size, dtype=x.dtype, device=x.device)
    launch = functools.partial(
        lib.pnode_mlp_fwd, x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        size, B, len(weights), _c_dims(dims), _build.ptr_array(weights),
        _build.ptr_array(biases), _ACT_CODES[activation],
        _build.stream_of(x))
    _build.check(_on_device(x, launch), "fused_mlp_fwd kernel")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(x, g, weights, biases, activation="relu"):
    """(dx, dWs, dbs) of <g, MLP(x)> through K1's backward kernel (CUDA:
    recompute the hidden layers, then one launch per layer for dX and
    [dW; db]) or its plain version (CPU)."""
    dims = check_stack(x, weights, biases, activation, "fused_mlp_bwd")
    _check_tensor(g, 2, "fused_mlp_bwd", "g", x.device)
    B = int(x.shape[0])
    if tuple(g.shape) != (B, dims[-1]):
        raise ValueError(f"fused_mlp_bwd: g must be {(B, dims[-1])}, got "
                         f"{tuple(g.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, g, weights, biases, activation)
    lib = _build.library()
    dims = tuple(dims)
    size = mlp_scratch(dims, B)[1]
    # one allocation: dx, the flat gradients, then the scratch
    dx, grads, scratch = torch.empty(
        B * dims[0] + grad_buffer_size(dims) + size, dtype=x.dtype,
        device=x.device).split_with_sizes(
            [B * dims[0], grad_buffer_size(dims), size])
    dx = dx.view(B, dims[0])
    launch = functools.partial(
        lib.pnode_mlp_bwd, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
        grads.data_ptr(), scratch.data_ptr(), size, B, len(weights),
        _c_dims(dims), _build.ptr_array(weights), _build.ptr_array(biases),
        _ACT_CODES[activation], _build.stream_of(x))
    _build.check(_on_device(x, launch), "fused_mlp_bwd kernel")
    fused_mlp_bwd.launches += 1
    dWs, dbs = split_grads(grads, dims)
    return dx, dWs, dbs


fused_mlp_bwd.launches = 0


class _FusedMLP(torch.autograd.Function):
    """K1 forward, with K1 backward as its gradient."""

    @staticmethod
    def forward(ctx, activation, n_layers, x, *flat):
        Ws, bs = list(flat[0::2]), list(flat[1::2])
        ctx.activation = activation
        ctx.save_for_backward(x, *flat)
        return fused_mlp_fwd(x, Ws, bs, activation)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        Ws, bs = flat[0::2], flat[1::2]
        dx, dWs, dbs = fused_mlp_bwd(x, g.contiguous(), Ws, bs,
                                     ctx.activation)
        grads: list = []
        for dW, db in zip(dWs, dbs):
            grads += [dW, db]
        return (None, None, dx, *grads)


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor],
              activation: str = "relu") -> torch.Tensor:
    """Differentiable MLP(x) through K1 (forward and backward kernels).

    x: (B, d_in) fp32; weights[i]: (d_i, d_{i+1}); biases[i]: (d_{i+1},).
    """
    flat: list = []
    for w, b in zip(weights, biases):
        flat += [w, b]
    return _FusedMLP.apply(activation, len(weights), x, *flat)
