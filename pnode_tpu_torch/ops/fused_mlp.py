"""K1: the whole dense stack (Dense -> act -> ... -> Dense) in one kernel.

Replaces ``pnode_tpu/ops/fused_mlp.py`` ``_fwd_kernel`` (:75) and
``_bwd_kernel`` (:89). The CUDA source is ``csrc/fused_mlp.cu``; its note
says what bounds it on the H100 and what the design does about that.

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

from typing import List, Sequence

import torch

from . import _build

MAX_LAYERS = 8
ROWS_PER_BLOCK = 8  # csrc/pnode_kernels.cuh kRows
_ACT_CODES = {"relu": 1, "tanh": 2}


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(h) if activation == "relu" else torch.tanh(h)


def check_stack(x: torch.Tensor, weights, biases, activation: str,
                what: str) -> List[int]:
    """Validate an fp32 MLP stack against a (B, d_in) input; return dims."""
    if activation not in _ACT_CODES:
        raise ValueError(f"{what}: unsupported activation {activation!r}")
    n = len(weights)
    if n < 1 or n > MAX_LAYERS or len(biases) != n:
        raise ValueError(f"{what}: needs 1..{MAX_LAYERS} layers with one "
                         f"bias each, got {n} weights, {len(biases)} biases")
    _check_tensor(x, 2, what, "x", x.device)
    dims = [int(x.shape[1])]
    for i, (w, b) in enumerate(zip(weights, biases)):
        _check_tensor(w, 2, what, f"weights[{i}]", x.device)
        _check_tensor(b, 1, what, f"biases[{i}]", x.device)
        if int(w.shape[0]) != dims[-1] or int(b.shape[0]) != int(w.shape[1]):
            raise ValueError(
                f"{what}: layer {i} shapes {tuple(w.shape)}, {tuple(b.shape)} "
                f"do not chain from width {dims[-1]}")
        dims.append(int(w.shape[1]))
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
    dWs, dbs = [], []
    off = 0
    for k, n in zip(dims, dims[1:]):
        dWs.append(flat[off:off + k * n].view(k, n))
        off += k * n
        dbs.append(flat[off:off + n])
        off += n
    return tuple(dWs), tuple(dbs)


def grad_buffer_size(dims: Sequence[int]) -> int:
    return sum(k * n + n for k, n in zip(dims, dims[1:]))


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

def fused_mlp_fwd(x, weights, biases, activation="relu"):
    """MLP(x) through K1's forward kernel (CUDA) or its plain version (CPU)."""
    dims = check_stack(x, weights, biases, activation, "fused_mlp_fwd")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, biases, activation)
    lib = _build.library()
    B = int(x.shape[0])
    out = torch.empty((B, dims[-1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.pnode_mlp_fwd(
            x.data_ptr(), out.data_ptr(), B, len(weights),
            _build.int_array(dims), _build.ptr_array(weights),
            _build.ptr_array(biases), _ACT_CODES[activation],
            _build.stream_of(x))
    _build.check(rc, "fused_mlp_fwd kernel")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(x, g, weights, biases, activation="relu"):
    """(dx, dWs, dbs) of <g, MLP(x)> through K1's backward kernel (CUDA) or
    its plain version (CPU)."""
    dims = check_stack(x, weights, biases, activation, "fused_mlp_bwd")
    _check_tensor(g, 2, "fused_mlp_bwd", "g", x.device)
    B = int(x.shape[0])
    if tuple(g.shape) != (B, dims[-1]):
        raise ValueError(f"fused_mlp_bwd: g must be {(B, dims[-1])}, got "
                         f"{tuple(g.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, g, weights, biases, activation)
    lib = _build.library()
    nblk = -(-B // ROWS_PER_BLOCK)
    total = grad_buffer_size(dims)
    dx = torch.empty_like(x)
    partial = torch.empty(nblk * total, dtype=x.dtype, device=x.device)
    grads = torch.empty(total, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.pnode_mlp_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), B, len(weights), _build.int_array(dims),
            _build.ptr_array(weights), _build.ptr_array(biases),
            _ACT_CODES[activation], _build.stream_of(x))
    _build.check(rc, "fused_mlp_bwd kernel")
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
