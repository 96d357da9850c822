"""K4: K complete training iterations per launch.

Replaces ``pnode_tpu/ops/fused_train_loop.py`` ``_kernel`` (:284), launched
by ``fused_train_loop`` (:512): the production path of ``examples/ks.py
--fused_loop``. The CUDA source is ``csrc/fused_train_loop.cu``; its note
says what bounds it on the H100 and what the design does about that (one
persistent cooperative launch per call, or per chunk, with a grid-wide
barrier between each iteration's per-block forward and reverse steps and
its Adam update).

Scope: the fused step kernels' (K2, K3), plus the one-step MSE and Adam.
Math per iteration k, which ``fused_train_loop_plain`` writes out::

    y1, Ys = forward ARK step of y_stack[k]          (K2's math)
    L_k    = sum((y1 - tgt_stack[k])^2) / (B d)
    lam    = 2 (y1 - tgt_stack[k]) / (B d)
    dW, db = stage-exact reverse step from (Ys, lam)  (K3's math)
    t      = t0 + k + 1;  c1 = 1 - exp(t ln b1);  c2 = 1 - exp(t ln b2)
    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p - lr (m / c1) / (sqrt(v / c2) + eps)       (optax.adam)

Only fp32 runs on the card; the plain version takes any float dtype.
``LoopLayout`` and ``fused_grad_step`` (the data-parallel grads-only kernel)
belong to the DP slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import _build
from .fused_ark_adjoint import (
    MAX_SMEM_BYTES, MAX_STAGES, check_step_args, check_stiff_dot_precision,
    fused_ark_step_adj_plain, tableau_array,
)
from .fused_ark_forward import fused_ark_step_fwd_plain
from .fused_mlp import (
    MAX_LAYERS, ROWS_PER_BLOCK, _ACT_CODES, _check_tensor, grad_buffer_size,
    split_grads,
)

_REDUCE_FLOATS = 32  # csrc/fused_train_loop.cu kReduceFloats


def _loop_smem_bytes(d: int, layer_dims: Sequence[int], stages: int) -> int:
    """Shared memory of one K4 block (csrc/fused_train_loop.cu LoopSmem):
    the s stage values and the seed tile, then the forward's or the
    reverse's scratch, whichever is larger, then the loss reduction."""
    dims = [d] + list(layer_dims)
    R = ROWS_PER_BLOCK
    tile = R * d
    pingpong = 2 * R * max(dims)
    fwd = tile * (2 + 2 * stages) + pingpong
    rev = tile * (stages + 4) + R * sum(dims[:-1]) + pingpong
    return 4 * (tile * (stages + 1) + max(fwd, rev) + _REDUCE_FLOATS)


def fused_train_loop_fits(B: int, d: int, layer_dims: Sequence[int],
                          chunk: int = 8, stages: int = 4) -> bool:
    """True when K4 takes this configuration on the H100.

    One block keeps an 8-row tile's s stage values, its loss seed and the
    larger of the forward's and the reverse's scratch in shared memory, at
    most 227 KB (the KS recipe, 64 -> 104 x4 -> 64 at ARK3's 4 stages,
    needs 48,768 B). That budget is also what co-residency needs: the
    wrapper sizes the grid from the occupancy query, min(ceil(B/8),
    co-resident blocks), so the grid is co-resident whenever one block fits
    on an SM, and 256 threads of at most 255 registers always do. Neither B
    nor ``chunk`` binds: blocks stride over row tiles, and the minibatches
    stream from device memory whatever the chunk. ``stages`` is the
    tableau's stage count (ARK3's 4 by default).

    Burgers-512 (512 -> 576 x4 -> 512) does not fit: ~340 KB per block at
    4 stages, as K3 alone needs ~291 KB. The JAX gate says it fits the
    TPU's VMEM at chunk 16 (tests/test_fused_train_loop.py:175); the two
    budgets are different memories.
    """
    if B < 1 or chunk < 1 or not 1 <= stages <= MAX_STAGES:
        return False
    if not 1 <= len(layer_dims) <= MAX_LAYERS or layer_dims[-1] != d:
        return False
    return _loop_smem_bytes(d, layer_dims, stages) <= MAX_SMEM_BYTES


def pick_chunk(K: int, B: int, d: int, layer_dims: Sequence[int]) -> int:
    """Largest chunk in (32, 16, 8) that divides K and fits; 1 otherwise
    (the chunks ``fused_train_loop`` takes: 1 or a multiple of 8)."""
    for c in (32, 16, 8):
        if K % c == 0 and fused_train_loop_fits(B, d, layer_dims, chunk=c):
            return c
    return 1


def fused_train_loop_cost(tableau_static, B, d, layer_dims, K):
    """Analytic (flops, device-memory bytes) PER TRAINING ITERATION at the
    logical sizes, the JAX package's convention with K4's choices.

    Per iteration: forward = s stiff products + s MLPs; reverse = one stiff
    product per stage + an MLP recompute and its backprop (~3x the forward
    MLP: K4 recomputes the layer inputs, as K3 does); Adam ~10 elementwise
    ops per parameter. Device memory: (y, target) in and the loss out; each
    of the ceil(B/8) blocks writes its dW/db partial and phase B reads them
    all; Adam reads and writes W, m and v. The operators and the packing of
    the state into flat buffers are paid once per call, so 1/K each.
    """
    s = len(tableau_static[2])
    dims = [d] + list(layer_dims)
    mlp = sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
    w_elems = grad_buffer_size(dims)
    nblk = -(-B // ROWS_PER_BLOCK)
    flops = s * (2 * B * d * d + mlp)        # forward
    flops += s * (2 * B * d * d + 3 * mlp)   # reverse
    flops += 10 * w_elems + 3 * B * d        # adam + loss
    byts = 4 * (2 * B * d + 1)
    byts += 4 * (2 * nblk * w_elems + 6 * w_elems)
    byts += 4 * (2 * d * d + 6 * w_elems) / max(1, K)
    return flops, byts


# -- plain PyTorch version --------------------------------------------------

@torch.no_grad()
def fused_train_loop_plain(tableau_static, dt, y_stack, tgt_stack, J_dense,
                           inv_op, weights, biases, m_state, v_state, t0,
                           activation="relu", sign=-1.0, lr=1e-3, b1=0.9,
                           b2=0.999, eps=1e-8):
    """Plain PyTorch version of K4 (same signature and return structure,
    without ``chunk``): the math of the JAX package's _fwd_bwd_iteration
    plus its Adam update, on the plain forward and reverse steps."""
    K, B, d = (int(x) for x in y_stack.shape)
    inv_count = 1.0 / (B * d)
    params = [list(weights), list(biases)]
    m = [list(m_state[0]), list(m_state[1])]
    v = [list(v_state[0]), list(v_state[1])]
    losses = []
    for k in range(K):
        Ws, bs = params
        y1, Ys = fused_ark_step_fwd_plain(tableau_static, dt, y_stack[k],
                                          J_dense, inv_op, Ws, bs,
                                          activation, sign)
        diff = y1 - tgt_stack[k]
        losses.append((diff * diff).sum() * inv_count)
        lam = (2.0 * inv_count) * diff
        _, grads = fused_ark_step_adj_plain(tableau_static, dt, Ys, lam,
                                            J_dense, inv_op, Ws, bs,
                                            activation, sign)
        adam_step_plain(params, m, v, grads, t0 + k + 1, lr, b1, b2, eps)
    return (params[0], params[1], (m[0], m[1]), (v[0], v[1]),
            torch.stack(losses))


def adam_step_plain(params, m, v, grads, t, lr, b1, b2, eps):
    """optax's Adam update number ``t`` (counting from 1) in the loop
    kernels' form: the bias corrections 1 - exp(t ln b) in the parameters'
    dtype. params, m, v and grads are [weights, biases] pairs of lists;
    params, m and v are updated in place (their list entries replaced)."""
    ref = params[0][0]
    tt = torch.tensor(float(t), dtype=ref.dtype, device=ref.device)
    c1 = 1.0 - torch.exp(tt * math.log(b1))
    c2 = 1.0 - torch.exp(tt * math.log(b2))
    for part in range(2):  # weights, then biases
        for l, g in enumerate(grads[part]):
            mi = b1 * m[part][l] + (1.0 - b1) * g
            vi = b2 * v[part][l] + (1.0 - b2) * (g * g)
            m[part][l], v[part][l] = mi, vi
            params[part][l] = params[part][l] - lr * (mi / c1) / (
                torch.sqrt(vi / c2) + eps)


# -- kernel wrapper ---------------------------------------------------------

def check_loop_operands(what, tableau_static, y_stack, tgt_stack, J_dense,
                        inv_op, weights, biases, m_state, v_state,
                        activation):
    """Validate the operands shared by the loop kernels (K4, K5); returns
    (K, B, d, s, dims)."""
    dev = y_stack.device if isinstance(y_stack, torch.Tensor) else None
    _check_tensor(y_stack, 3, what, "y_stack", dev)
    _check_tensor(tgt_stack, 3, what, "tgt_stack", dev)
    if tuple(tgt_stack.shape) != tuple(y_stack.shape):
        raise ValueError(f"{what}: tgt_stack must be {tuple(y_stack.shape)}, "
                         f"got {tuple(tgt_stack.shape)}")
    K = int(y_stack.shape[0])
    if K < 1 or y_stack.shape[1] < 1:
        raise ValueError(f"{what}: empty y_stack {tuple(y_stack.shape)}")
    s, B, d, dims = check_step_args(tableau_static, y_stack[0], J_dense,
                                    inv_op, weights, biases, activation, what)
    for name, state in (("m_state", m_state), ("v_state", v_state)):
        if len(state) != 2:
            raise ValueError(f"{what}: {name} must be (weights, biases)")
        for ref, got in zip((weights, biases), state):
            if len(got) != len(ref):
                raise ValueError(f"{what}: {name} has {len(got)} tensors, "
                                 f"expected {len(ref)}")
            for i, (r, g) in enumerate(zip(ref, got)):
                _check_tensor(g, r.dim(), what, f"{name}[{i}]", dev)
                if g.shape != r.shape:
                    raise ValueError(f"{what}: {name}[{i}] must be "
                                     f"{tuple(r.shape)}, got {tuple(g.shape)}")
    return K, B, d, s, dims


def _check_loop_args(tableau_static, y_stack, tgt_stack, J_dense, inv_op,
                     weights, biases, m_state, v_state, activation, chunk):
    """Validate the operands; returns (K, B, d, s, dims, chunk)."""
    what = "fused_train_loop"
    K, B, d, s, dims = check_loop_operands(
        what, tableau_static, y_stack, tgt_stack, J_dense, inv_op, weights,
        biases, m_state, v_state, activation)
    C = K if chunk is None else int(chunk)
    if chunk is not None:
        if C < 1 or K % C != 0:
            raise ValueError(f"chunk {C} must divide K={K}")
        if C != 1 and C % 8 != 0:
            raise ValueError(f"chunk must be 1 or a multiple of 8, got {C}")
    if not fused_train_loop_fits(B, d, dims[1:], chunk=C, stages=s):
        raise ValueError(f"{what}: configuration exceeds the loop kernel's "
                         "shared-memory budget (gate with "
                         "fused_train_loop_fits)")
    return K, B, d, s, dims, C


def _flat(ws, bs):
    return torch.cat([t for w, b in zip(ws, bs) for t in (w.reshape(-1), b)])


def fused_train_loop(tableau_static, dt, y_stack, tgt_stack, J_dense, inv_op,
                     weights, biases, m_state, v_state, t0,
                     activation="relu", sign=-1.0, lr=1e-3, b1=0.9, b2=0.999,
                     eps=1e-8, chunk=None):
    """Run K complete training iterations; ``chunk=None`` runs all K in one
    launch, an explicit ``chunk`` C (1 or a multiple of 8 dividing K) runs
    K/C launches of C iterations with the state carried in device memory.

    y_stack, tgt_stack: (K, B, d); iteration k trains on (y_stack[k],
    tgt_stack[k]). J_dense, inv_op: (d, d); weights[i] (d_i, d_{i+1}),
    biases[i] (d_{i+1},); m_state and v_state: (Ws, bs) lists of the same
    shapes; t0: Adam updates already applied. Returns (weights', biases',
    (mW', mb'), (vW', vb'), losses (K,)); the inputs are not modified.
    CUDA tensors launch the kernel; CPU tensors run
    ``fused_train_loop_plain`` once per chunk.
    """
    check_stiff_dot_precision()
    K, B, d, s, dims, C = _check_loop_args(
        tableau_static, y_stack, tgt_stack, J_dense, inv_op, weights, biases,
        m_state, v_state, activation, chunk)
    if y_stack.device.type == "cpu":
        Ws, bs, m, v = weights, biases, m_state, v_state
        losses = []
        for c in range(0, K, C):
            Ws, bs, m, v, ls = fused_train_loop_plain(
                tableau_static, dt, y_stack[c:c + C], tgt_stack[c:c + C],
                J_dense, inv_op, Ws, bs, m, v, t0 + c, activation, sign, lr,
                b1, b2, eps)
            losses.append(ls)
        return Ws, bs, m, v, torch.cat(losses)
    lib = _build.library()
    params = _flat(weights, biases)
    m_flat = _flat(*m_state)
    v_flat = _flat(*v_state)
    total = grad_buffer_size(dims)
    losses = torch.empty(K, dtype=y_stack.dtype, device=y_stack.device)
    with torch.cuda.device(y_stack.device):
        smem = lib.pnode_train_loop_smem(d, s, max(dims),
                                         ROWS_PER_BLOCK * sum(dims[:-1]))
        cap = _build.int_array([0])
        _build.check(lib.pnode_train_loop_capacity(smem, cap),
                     "fused_train_loop occupancy query (cooperative launch)")
        grid = min(-(-B // ROWS_PER_BLOCK), cap[0])
        partial = torch.empty(grid * total, dtype=y_stack.dtype,
                              device=y_stack.device)
        lpart = torch.empty(grid, dtype=y_stack.dtype, device=y_stack.device)
        stream = _build.stream_of(y_stack)
        for c in range(0, K, C):
            rc = lib.pnode_train_loop(
                y_stack[c].data_ptr(), tgt_stack[c].data_ptr(),
                J_dense.data_ptr(), inv_op.data_ptr(), params.data_ptr(),
                m_flat.data_ptr(), v_flat.data_ptr(), partial.data_ptr(),
                lpart.data_ptr(), losses[c].data_ptr(), C, B, d, s,
                tableau_array(tableau_static), float(dt), float(sign),
                len(weights), _build.int_array(dims), _ACT_CODES[activation],
                int(t0) + c, float(lr), float(b1), float(b2), float(eps),
                grid, stream)
            _build.check(rc, "fused_train_loop kernel")
            fused_train_loop.launches += 1
    Ws, bs = split_grads(params, dims)
    mW, mb = split_grads(m_flat, dims)
    vW, vb = split_grads(v_flat, dims)
    return list(Ws), list(bs), (list(mW), list(mb)), (list(vW), list(vb)), \
        losses


fused_train_loop.launches = 0
