"""Data-parallel composition of the fused training loop.

Counterpart of ``pnode_tpu/parallel/fused_dp.py``. The single-card fused
loop (K4, ``ops/fused_train_loop.py``) keeps K complete training iterations
inside one launch. Exact synchronous data parallelism needs a gradient
reduction across ranks BEFORE each Adam update, so when the batch is
sharded the iteration boundary comes back out of the kernel. Per iteration,
on every rank:

1. ``fused_grad_step`` (K12): the forward step, the MSE and the reverse
   step on the local shard, emitting the loss and the flat gradient in the
   layout K4 keeps its parameters in;
2. one ``all_reduce`` of the bucket [gradient, loss], SUM then a division
   by the number of ranks: the local means become the global batch mean;
3. Adam on the flat buffers in the loop kernels' form (``adam_step_plain``:
   b^t as exp(t ln b)), a handful of tensor ops, as the reference left it
   to XLA outside Pallas.

Parameters stay identical on every rank by construction: every rank applies
the same update to the same state. The reference's semantics: one rank per
shard, the solver COMM_SELF-local, only gradients reduced
(``pnode_tpu/parallel/fused_dp.py:39-41``; SURVEY.md section 5.8).
"""

from __future__ import annotations

import torch

from ..ops.fused_train_loop import (
    LoopLayout, adam_step_plain, check_loop_operands, fused_grad_step,
    fused_train_loop,
)
from .data_parallel import all_reduce_mean, shard_index


@torch.no_grad()
def dp_fused_train_loop(mesh, tableau_static, dt, y_stack, tgt_stack,
                        J_dense, inv_op, weights, biases, m_state, v_state,
                        t0, activation="relu", sign=-1.0, lr=1e-3, b1=0.9,
                        b2=0.999, eps=1e-8, axis="dp", force_general=False):
    """K data-parallel training iterations: ``fused_train_loop``'s contract
    and return value plus the mesh. ``y_stack`` and ``tgt_stack`` are the
    GLOBAL (K, B, d) minibatches, the same on every rank; each rank trains
    on its shard of the batch axis over ``axis``. Weights and moments are
    replicated.

    One rank needs no reduction, so it delegates to K4 (the same math:
    per-iteration Adam on the unreduced gradient is K4's update);
    ``force_general=True`` runs the per-iteration path anyway (the DP
    architecture's one-rank cost). CUDA tensors launch K12 (or K4), CPU
    tensors run their plain versions."""
    what = "dp_fused_train_loop"
    K, B, d, _, dims = check_loop_operands(
        what, tableau_static, y_stack, tgt_stack, J_dense, inv_op, weights,
        biases, m_state, v_state, activation)
    index, count = shard_index(mesh, axis)
    if B % count:
        raise ValueError(f"global batch {B} must divide over {count} "
                         f"devices on mesh axis {axis!r}")
    if count == 1 and not force_general:
        return fused_train_loop(tableau_static, dt, y_stack, tgt_stack,
                                J_dense, inv_op, weights, biases, m_state,
                                v_state, t0, activation=activation, sign=sign,
                                lr=lr, b1=b1, b2=b2, eps=eps)
    B_local = B // count
    layout = LoopLayout(B_local, d, dims[1:])
    rows = slice(index * B_local, (index + 1) * B_local)
    y_loc = layout.pad_batch(y_stack[:, rows])
    tgt_loc = layout.pad_batch(tgt_stack[:, rows])
    params = [[layout.pack(weights, biases)], []]
    m = [[layout.pack(*m_state)], []]
    v = [[layout.pack(*v_state)], []]
    losses = []
    for k in range(K):
        loss, grad = fused_grad_step(layout, tableau_static, dt, y_loc[k],
                                     tgt_loc[k], J_dense, inv_op,
                                     params[0][0], activation, sign)
        # the only collective: local means -> global batch mean
        bucket = all_reduce_mean(torch.cat([grad, loss.reshape(1)]), mesh,
                                 axis)
        adam_step_plain(params, m, v, [[bucket[:-1]], []], t0 + k + 1, lr, b1,
                        b2, eps)
        losses.append(bucket[-1])
    Ws, bs = layout.unpack(params[0][0])
    mW, mb = layout.unpack(m[0][0])
    vW, vb = layout.unpack(v[0][0])
    return Ws, bs, (mW, mb), (vW, vb), torch.stack(losses)
