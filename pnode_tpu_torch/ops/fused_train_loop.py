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

K12, ``fused_grad_step``, is one iteration's forward step, MSE and reverse
step without Adam (replaces ``_grad_kernel`` (:613), launched by
``fused_grad_step`` (:688)): the per-rank kernel of
``parallel.fused_dp.dp_fused_train_loop``, which all-reduces its loss and
gradient and runs Adam outside it. Its source is ``csrc/fused_grad_step.cu``.
Both run K2's and K3's bodies (``csrc/ark_tiles.cuh``) on K12's plan, which
``fused_ark_adjoint.grad_step_plan`` mirrors; K4's caps the grid at one
block per SM (``train_loop_plan``). ``LoopLayout``
describes the operands of both kernels: the flat ``[W0, b0, W1, b1, ...]``
buffer that holds the parameters, the Adam moments and the gradient (no
TPU lane padding).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import _build
from .fused_ark_adjoint import (
    MAX_SMEM_BYTES, MAX_STAGES, REV_GRAD, _round4, check_step_args,
    check_stiff_dot_precision, fused_ark_step_adj_plain, grad_step_plan,
    rev_plan_full, sm_count, tableau_array,
)
from .fused_ark_forward import fused_ark_step_fwd_plain
from .fused_mlp import (
    MAX_LAYERS, _ACT_CODES, _check_tensor, grad_buffer_size, split_grads,
)

_REDUCE_FLOATS = 32  # the 8-row tile's loss reduction
GATE_ROWS = 8  # rows of the tile the loop gates budget (see _loop_smem_bytes)


def _loop_smem_bytes(d: int, layer_dims: Sequence[int], stages: int) -> int:
    """The routing budget of K4 (and K5, fused_adaptive_loop): the shared
    memory of the port's first K4 block, an 8-row tile's s stage values and
    seed, then the forward's or the reverse's scratch, whichever is larger,
    then the loss reduction. No kernel lays memory out so now (K4 runs on
    ``train_loop_plan``); the gate keeps the budget so that every
    configuration routes as before."""
    dims = [d] + list(layer_dims)
    R = GATE_ROWS
    tile = R * d
    pingpong = 2 * R * max(dims)
    fwd = tile * (2 + 2 * stages) + pingpong
    rev = tile * (stages + 4) + R * sum(dims[:-1]) + pingpong
    return 4 * (tile * (stages + 1) + max(fwd, rev) + _REDUCE_FLOATS)


def fused_train_loop_fits(B: int, d: int, layer_dims: Sequence[int],
                          chunk: int = 8, stages: int = 4) -> bool:
    """True when K4 takes this configuration on the H100.

    The gate is the 8-row budget (``_loop_smem_bytes``, at most 227 KB;
    the KS recipe, 64 -> 104 x4 -> 64 at ARK3's 4 stages, needs 48,768 B),
    and wherever it opens with the step kernels' forward gate (which the
    wrapper asks too), K4's plan (``train_loop_plan``) takes every batch:
    its grid is at most one block per SM, so it is co-resident whenever one
    block fits on an SM, and 256 threads of at most 255 registers always
    do. Neither B nor ``chunk`` binds: blocks stride over row tiles, and
    the minibatches stream from device memory whatever the chunk.
    ``stages`` is the tableau's stage count (ARK3's 4 by default).

    Burgers-512 (512 -> 576 x4 -> 512) does not fit: ~340 KB per block at
    4 stages. The JAX gate says it fits the
    TPU's VMEM at chunk 16 (tests/test_fused_train_loop.py:175); the two
    budgets are different memories.
    """
    if B < 1 or chunk < 1 or not 1 <= stages <= MAX_STAGES:
        return False
    if not 1 <= len(layer_dims) <= MAX_LAYERS or layer_dims[-1] != d:
        return False
    return _loop_smem_bytes(d, layer_dims, stages) <= MAX_SMEM_BYTES


def train_loop_plan(B: int, d: int, layer_dims: Sequence[int], stages: int,
                    sms: int = 132, rows: int = 0):
    """K4's launch (C entry point pnode_train_loop_plan): (rows per block,
    grid, shared-memory bytes), or None. K12's plan (``grad_step_plan``:
    the fewest rows in {1, 2, 4, 8} whose grid fits one block per SM, the
    stage values, the seed and both steps' scratch in shared memory) with
    the grid capped at ``sms`` blocks, which stride over the row tiles
    past it (R 2, 128 blocks at KS B 256; R 8, 132 blocks at B 3173).
    ``rows`` 1, 2, 4 or 8 forces R."""
    plan = rev_plan_full(int(B), int(d), tuple(int(n) for n in layer_dims),
                         int(stages), int(sms), REV_GRAD, int(rows))
    if plan is None:
        return None
    R, grid, smem, _ = plan
    return R, min(grid, int(sms)), smem


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
    product per stage + an MLP recompute of the layer inputs (every layer
    but the last, whose output the backprop does not need, as K3 does) and
    its backprop (dX and dW per layer: 2x the forward MLP); Adam ~10
    elementwise ops per parameter. Device memory, each input read once and
    each output written once (the roofline's, not the kernel's partial-sum
    traffic): (y, target) in and the loss out; Adam reads and writes W, m
    and v. The operators and the packing of the state into flat buffers are
    paid once per call, so 1/K each.
    """
    s = len(tableau_static[2])
    dims = [d] + list(layer_dims)
    mlp = sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
    w_elems = grad_buffer_size(dims)
    last = 2 * B * dims[-2] * dims[-1]
    flops = s * (2 * B * d * d + mlp)               # forward
    flops += s * (2 * B * d * d + 3 * mlp - last)   # reverse
    flops += 10 * w_elems + 3 * B * d        # adam + loss
    byts = 4 * (2 * B * d + 1)
    byts += 4 * (6 * w_elems)
    byts += 4 * (2 * d * d + 6 * w_elems) / max(1, K)
    return flops, byts


def fused_grad_step_cost(tableau_static, B, d, layer_dims):
    """Analytic (flops, device-memory bytes) of one ``fused_grad_step``
    call: ``fused_train_loop_cost``'s forward, reverse and loss without
    Adam; bytes are the roofline's (y and the target, the operators and the
    parameters read once, the gradient and the loss written once), not the
    kernel's partial-sum traffic."""
    s = len(tableau_static[2])
    dims = [d] + list(layer_dims)
    mlp = sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
    w_elems = grad_buffer_size(dims)
    last = 2 * B * dims[-2] * dims[-1]
    flops = s * (2 * B * d * d + mlp) + s * (2 * B * d * d + 3 * mlp - last)
    flops += 3 * B * d
    byts = 4 * (2 * B * d + 2 * d * d + 2 * w_elems + 1)
    return flops, byts


class LoopLayout:
    """Operands of the loop kernels (K4, K12) for a (B, d) local batch and
    the stack d -> layer_dims: parameters, Adam moments and gradients in
    one flat ``[W0, b0, W1, b1, ...]`` buffer each, of ``total`` floats.
    ``B`` is the LOCAL (per-rank) batch."""

    def __init__(self, B, d, layer_dims):
        self.dims = [int(d)] + [int(x) for x in layer_dims]
        self.B = int(B)
        self.total = grad_buffer_size(self.dims)

    def pad_batch(self, a):
        """(..., B, d) -> the contiguous kernel operand. Nothing is padded:
        the kernels mask the rows past B of their last row tile."""
        if tuple(a.shape[-2:]) != (self.B, self.dims[0]):
            raise ValueError(f"batch must be (..., {self.B}, {self.dims[0]}), "
                             f"got {tuple(a.shape)}")
        return a.contiguous()

    def pack(self, ws, bs):
        return _flat(ws, bs)

    def unpack(self, flat):
        """(weights, biases) as views into the flat buffer."""
        ws, bs = split_grads(flat, self.dims)
        return list(ws), list(bs)


# -- plain PyTorch versions -------------------------------------------------

@torch.no_grad()
def fused_grad_step_plain(layout, tableau_static, dt, y, tgt, J_dense, inv_op,
                          params, activation="relu", sign=-1.0,
                          global_count=None):
    """Plain PyTorch version of K12: ``fused_train_loop_plain``'s iteration
    without Adam. Returns (loss, flat gradient)."""
    count = float(global_count if global_count is not None
                  else layout.B * layout.dims[0])
    inv_count = 1.0 / count
    Ws, bs = layout.unpack(params)
    y1, Ys = fused_ark_step_fwd_plain(tableau_static, dt, y, J_dense, inv_op,
                                      Ws, bs, activation, sign)
    diff = y1 - tgt
    loss = (diff * diff).sum() * inv_count
    _, (dWs, dbs) = fused_ark_step_adj_plain(
        tableau_static, dt, Ys, (2.0 * inv_count) * diff, J_dense, inv_op,
        Ws, bs, activation, sign)
    return loss, _flat(dWs, dbs)


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
    """Validate the operands shared by the loop kernels (K4, K5 and the DP
    loop); returns (K, B, d, s, dims). Each caller gates on its own
    kernel's budget (``fused_train_loop_fits``, ``fused_adaptive_loop_fits``),
    not on the step kernels' reverse gate."""
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
                                    inv_op, weights, biases, activation, what,
                                    reverse=False)
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


def fused_grad_step(layout, tableau_static, dt, y, tgt, J_dense, inv_op,
                    params, activation="relu", sign=-1.0, global_count=None,
                    rows=0):
    """(loss, flat gradient) of ONE training iteration on the local batch:
    the forward ARK step of y (B, d), the MSE against tgt and the
    stage-exact reverse step, without Adam. ``params`` is the flat buffer
    (``layout.pack``). The loss and its seed 2 (y1 - tgt) / count use the
    local count B d unless ``global_count`` is given: the data-parallel
    caller keeps it local and means the result over the ranks, which is the
    global mean. CUDA tensors launch K12 (at its plan's rows per block, or
    ``rows`` 1, 2, 4 or 8 forced, for kernel comparisons); CPU tensors run
    ``fused_grad_step_plain``."""
    what = "fused_grad_step"
    check_stiff_dot_precision()
    Ws, bs = layout.unpack(params)
    s, B, d, dims = check_step_args(tableau_static, y, J_dense, inv_op, Ws, bs,
                                    activation, what)
    _check_tensor(tgt, 2, what, "tgt", y.device)
    _check_tensor(params, 1, what, "params", y.device)
    if (B, dims) != (layout.B, layout.dims) or params.numel() != layout.total:
        raise ValueError(f"{what}: operands do not match the layout "
                         f"(B {layout.B}, dims {layout.dims})")
    if tuple(tgt.shape) != (B, d):
        raise ValueError(f"{what}: tgt must be {(B, d)}, got "
                         f"{tuple(tgt.shape)}")
    # K4's gate: the DP loop delegates one rank to K4, so K12 takes what
    # K4 takes (its plan does wherever that gate opens)
    if (not fused_train_loop_fits(B, d, dims[1:], stages=s)
            or grad_step_plan(B, d, dims[1:], s) is None):
        raise ValueError(f"{what}: configuration exceeds the loop kernels' "
                         "shared-memory budget (gate with "
                         "fused_train_loop_fits)")
    if y.device.type == "cpu":
        return fused_grad_step_plain(layout, tableau_static, dt, y, tgt,
                                     J_dense, inv_op, params, activation,
                                     sign, global_count)
    lib = _build.library()
    count = float(global_count if global_count is not None else B * d)
    grid = (grad_step_plan(B, d, dims[1:], s, sm_count(y.device))[1]
            if rows == 0 else -(-B // rows))
    out = torch.empty(layout.total + 1, dtype=y.dtype, device=y.device)
    # one 16-byte-aligned slice per block: the gradient, then the loss
    partial = torch.empty(grid * (-(-(layout.total + 1) // 4) * 4),
                          dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.pnode_grad_step(
            y.data_ptr(), tgt.data_ptr(), J_dense.data_ptr(),
            inv_op.data_ptr(), params.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, d, s, tableau_array(tableau_static), float(dt),
            float(sign), len(Ws), _build.int_array(dims),
            _ACT_CODES[activation], count, int(rows), partial.numel(),
            _build.stream_of(y))
    _build.check(rc, "fused_grad_step kernel")
    fused_grad_step.launches += 1
    return out[-1], out[:-1]


fused_grad_step.launches = 0


def fused_train_loop(tableau_static, dt, y_stack, tgt_stack, J_dense, inv_op,
                     weights, biases, m_state, v_state, t0,
                     activation="relu", sign=-1.0, lr=1e-3, b1=0.9, b2=0.999,
                     eps=1e-8, chunk=None, rows=0):
    """Run K complete training iterations; ``chunk=None`` runs all K in one
    launch, an explicit ``chunk`` C (1 or a multiple of 8 dividing K) runs
    K/C launches of C iterations with the state carried in device memory.

    y_stack, tgt_stack: (K, B, d); iteration k trains on (y_stack[k],
    tgt_stack[k]). J_dense, inv_op: (d, d); weights[i] (d_i, d_{i+1}),
    biases[i] (d_{i+1},); m_state and v_state: (Ws, bs) lists of the same
    shapes; t0: Adam updates already applied. Returns (weights', biases',
    (mW', mb'), (vW', vb'), losses (K,)); the inputs are not modified.
    CUDA tensors launch the kernel (at its plan's rows per block, or
    ``rows`` 1, 2, 4 or 8 forced, for kernel comparisons); CPU tensors run
    ``fused_train_loop_plain`` once per chunk.
    """
    check_stiff_dot_precision()
    K, B, d, s, dims, C = _check_loop_args(
        tableau_static, y_stack, tgt_stack, J_dense, inv_op, weights, biases,
        m_state, v_state, activation, chunk)
    if rows not in (0, 1, 2, 4, 8):
        raise ValueError(f"fused_train_loop: rows must be 0, 1, 2, 4 or 8, "
                         f"got {rows}")
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
    with torch.cuda.device(y_stack.device):
        return run_train_loop(
            _build.library(), sm_count(y_stack.device),
            _build.stream_of(y_stack), tableau_static, dt, y_stack,
            tgt_stack, J_dense, inv_op, weights, biases, m_state, v_state, t0,
            activation, sign, lr, b1, b2, eps, C, rows)


def run_train_loop(lib, sms, stream, tableau_static, dt, y_stack, tgt_stack,
                   J_dense, inv_op, weights, biases, m_state, v_state, t0,
                   activation, sign, lr, b1, b2, eps, chunk, rows):
    """``fused_train_loop``'s launches through ``lib`` (the kernel library)
    on a card of ``sms`` SMs, operands validated: the scratch at K4's plan,
    then one launch per chunk on ``stream``."""
    K, B, d = (int(x) for x in y_stack.shape)
    s = len(tableau_static[2])
    dims = [d] + [int(w.shape[1]) for w in weights]
    plan = train_loop_plan(B, d, dims[1:], s, sms, rows)
    if plan is None:
        raise ValueError(f"fused_train_loop: no plan at rows {rows} for B {B}"
                         f", {dims}, {s} stages")
    grid = plan[1]
    params = _flat(weights, biases)
    m_flat = _flat(*m_state)
    v_flat = _flat(*v_state)
    total = grad_buffer_size(dims)
    f32 = dict(dtype=y_stack.dtype, device=y_stack.device)
    losses = torch.empty(K, **f32)
    partial = torch.empty(grid * _round4(total), **f32)
    lpart = torch.empty(grid, **f32)
    for c in range(0, K, chunk):
        rc = lib.pnode_train_loop(
            y_stack[c].data_ptr(), tgt_stack[c].data_ptr(),
            J_dense.data_ptr(), inv_op.data_ptr(), params.data_ptr(),
            m_flat.data_ptr(), v_flat.data_ptr(), partial.data_ptr(),
            lpart.data_ptr(), losses[c].data_ptr(), chunk, B, d, s,
            tableau_array(tableau_static), float(dt), float(sign),
            len(weights), _build.int_array(dims), _ACT_CODES[activation],
            int(t0) + c, float(lr), float(b1), float(b2), float(eps),
            int(rows), partial.numel(), stream)
        _build.check(rc, "fused_train_loop kernel")
        fused_train_loop.launches += 1
    Ws, bs = split_grads(params, dims)
    mW, mb = split_grads(m_flat, dims)
    vW, vb = split_grads(v_flat, dims)
    return list(Ws), list(bs), (list(mW), list(mb)), (list(vW), list(vb)), \
        losses


fused_train_loop.launches = 0


def plan(B, d, layer_dims, stages, device, rows=0):
    """The C plan's (rows per block, grid, shared-memory bytes) of K4 on
    ``device``'s card: what ``train_loop_plan`` mirrors."""
    import ctypes

    lib = _build.library()
    dims = [d] + list(layer_dims)
    out = (_build.int_array([0]), _build.int_array([0]),
           (ctypes.c_longlong * 1)(0))
    with torch.cuda.device(device):
        rc = lib.pnode_train_loop_plan(B, d, stages, len(layer_dims),
                                       _build.int_array(dims), rows, *out)
    return None if rc else tuple(o[0] for o in out)
