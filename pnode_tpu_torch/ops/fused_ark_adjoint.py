"""K3: one whole stage-exact ARK-IMEX reverse step in one kernel.

Replaces ``pnode_tpu/ops/fused_ark_adjoint.py`` ``_kernel`` (:304), launched
by ``fused_ark_step_adj`` (:458). The CUDA source is
``csrc/fused_ark_adjoint.cu``; its note says what bounds it on the H100 and
what the design does about that.

Scope (the reference's production stiff-PDE configuration): a frozen
shared (d, d) Jacobian J of a certified-linear, parameter-free implicit
part, the pre-inverted stage operator inv = (I - dt gamma J)^{-1} for a
single ESDIRK gamma, and f_EX = sign * MLP (relu/tanh). Math, identical to
the generic ``ARKIMEX.step_adj``::

    for i = s-1 .. 0:
        u_i  = dt (bI_i lam + sum_{m>i} aI_mi xi_m)
        uh_i = dt (bE_i lam + sum_{m>i} aE_mi xi_m)
        p_i  = u_i J (explicit stage) + MLP_vjp_x(Y_i, sign * uh_i)
        xi_i = (u_i/(dt a_ii) + p_i) inv - u_i/(dt a_ii)   (implicit stage)
        dW  += MLP_vjp_W(Y_i, sign * uh_i)
    lam_prev = lam + sum_i xi_i

Row-vector convention: J^T u (columns) is ``u @ J`` (rows) and the
transposed solve is ``p @ inv``, so the reverse takes J and inv as they
are (the forward takes their transposes).

Only fp32 is ported: the TPU's bf16x3 stiff-dot tier and bf16 weight
storage were MXU workarounds; every product here is a true fp32 FMA.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _build
from .fused_mlp import (
    MAX_LAYERS, ROWS_PER_BLOCK, _ACT_CODES, _check_tensor, check_stack,
    fused_mlp_bwd_plain, grad_buffer_size, split_grads,
)

MAX_STAGES = 8
MAX_SMEM_BYTES = 232448  # 227 KB: one block's opt-in shared memory on sm_90


def check_stiff_dot_precision() -> None:
    """Validate ``-pnode_fused_ark_precision``: "auto" and "highest" both
    mean true fp32 for the stiff operator products, the only tier the
    kernels run. "high" and "default" name the TPU's bf16x3 and single-pass
    bf16 tiers, which are not ported."""
    from ..options import Options

    name = Options().get_string("pnode_fused_ark_precision", "auto")
    if name in ("auto", "highest"):
        return
    if name in ("high", "default"):
        raise ValueError(
            f"-pnode_fused_ark_precision {name}: the bf16 stiff-dot tiers "
            "were a TPU MXU workaround and are not ported; the CUDA kernels "
            "run the stiff products in fp32 (use auto or highest)")
    raise ValueError(f"-pnode_fused_ark_precision {name!r}: use auto|highest")


def _smem_bytes(d: int, layer_dims: Sequence[int], stages: int,
                reverse: bool) -> int:
    """Shared memory of one block of the step kernels (csrc/*.cu
    pnode_ark_{fwd,adj}_smem)."""
    dims = [d] + list(layer_dims)
    R = ROWS_PER_BLOCK
    pingpong = 2 * R * max(dims)
    if reverse:
        return 4 * (R * d * (6 + stages) + R * sum(dims[:-1]) + pingpong)
    return 4 * (R * d * (3 + 2 * stages) + pingpong)


def fused_ark_fits(d: int, layer_dims: Sequence[int], stages: int,
                   reverse: bool = True) -> bool:
    """True when the step kernels take this configuration on the H100.

    The kernels keep one 8-row tile's stage values, covectors and layer
    activations in shared memory, so that is the budget that binds: at most
    227 KB per block (the KS config needs 29 KB forward, 42 KB reverse;
    Burgers-512 needs ~290 KB reverse and does not fit). Registers do not
    bind: each thread carries a fixed 4-row accumulator whatever the
    widths. Weight gradients go to a per-block scratch slice in device
    memory, not to shared memory. ``reverse=False`` checks the forward
    kernel alone."""
    if not 1 <= len(layer_dims) <= MAX_LAYERS or not 1 <= stages <= MAX_STAGES:
        return False
    if layer_dims[-1] != d:
        return False
    need = _smem_bytes(d, layer_dims, stages, reverse=False)
    if reverse:
        need = max(need, _smem_bytes(d, layer_dims, stages, reverse=True))
    return need <= MAX_SMEM_BYTES


def pick_weight_dtype(d: int, layer_dims: Sequence[int], stages: int):
    """Weight-storage dtype of the fused kernels: "f32", or None when the
    configuration does not fit (``-pnode_fused_ark_weights {auto,f32}``;
    bf16 storage was a TPU VMEM workaround and is not ported)."""
    from ..options import Options

    mode = Options().get_string("pnode_fused_ark_weights", "auto")
    if mode not in ("auto", "f32"):
        raise ValueError(f"-pnode_fused_ark_weights {mode!r}: use auto|f32 "
                         "(bf16 weight storage is not ported)")
    return "f32" if fused_ark_fits(d, layer_dims, stages) else None


def check_step_args(tableau_static, y, J_dense, inv_op, weights, biases,
                    activation, what):
    """Validate the operands shared by the forward and reverse step
    kernels; returns (s, B, d, dims)."""
    aI, aE, bI, bE = tableau_static
    s = len(bI)
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"{what}: {s} stages; the kernels take 1..8")
    if (len(aI) != s or len(aE) != s or len(bE) != s
            or any(len(r) != s for r in list(aI) + list(aE))):
        raise ValueError(f"{what}: tableau rows do not match {s} stages")
    dims = check_stack(y, weights, biases, activation, what)
    B, d = int(y.shape[0]), int(y.shape[1])
    if dims[-1] != d:
        raise ValueError(f"{what}: explicit MLP must map the state to itself")
    for name, op in (("J_dense", J_dense), ("inv_op", inv_op)):
        _check_tensor(op, 2, what, name, y.device)
        if tuple(op.shape) != (d, d):
            raise ValueError(f"{what}: {name} must be {(d, d)}, got "
                             f"{tuple(op.shape)}")
    if not fused_ark_fits(d, dims[1:], s):
        raise ValueError(f"{what}: configuration exceeds the kernels' "
                         "shared-memory budget (gate with fused_ark_fits)")
    return s, B, d, dims


def tableau_array(tableau_static):
    """The raw tableau as the C entry points take it: aI, aE, bI, bE."""
    aI, aE, bI, bE = tableau_static
    flat = [float(x) for row in aI for x in row]
    flat += [float(x) for row in aE for x in row]
    flat += [float(x) for x in bI] + [float(x) for x in bE]
    return _build.double_array(flat)


# -- plain PyTorch version --------------------------------------------------

def fused_ark_step_adj_plain(tableau_static, dt, Ys, lam, J_dense, inv_op,
                             weights, biases, activation="relu", sign=-1.0):
    """Plain PyTorch version of the fused reverse step (same signature and
    algebraic collapse as the kernel). Returns (lam_prev, (dWs, dbs)).
    ``dt`` is a Python float, or a 0-d tensor whose dtype then rounds every
    coefficient dt * a (K5's plain version)."""
    aI, aE, bI, bE = tableau_static
    s = len(bI)
    n = len(weights)
    if not isinstance(dt, torch.Tensor):
        dt = float(dt)
    dWs: list = [None] * n
    dbs: list = [None] * n
    xis: list = [None] * s
    lam_prev = lam
    for i in range(s - 1, -1, -1):
        u = uh = None
        if bI[i] != 0.0:
            u = (dt * bI[i]) * lam
        if bE[i] != 0.0:
            uh = (dt * bE[i]) * lam
        for m in range(i + 1, s):
            if xis[m] is None:
                continue
            if aI[m][i] != 0.0:
                t_ = (dt * aI[m][i]) * xis[m]
                u = t_ if u is None else u + t_
            if aE[m][i] != 0.0:
                t_ = (dt * aE[m][i]) * xis[m]
                uh = t_ if uh is None else uh + t_
        if u is None and uh is None:
            continue
        implicit = aI[i][i] != 0.0
        p = None
        if u is not None and not implicit:
            p = u @ J_dense
        if uh is not None:
            dyE, dW, db = fused_mlp_bwd_plain(Ys[i], sign * uh, weights,
                                              biases, activation)
            for l in range(n):
                dWs[l] = dW[l] if dWs[l] is None else dWs[l] + dW[l]
                dbs[l] = db[l] if dbs[l] is None else dbs[l] + db[l]
            p = dyE if p is None else p + dyE
        if implicit:
            if u is not None:
                inv_dtg = 0.0 if dt == 0.0 else 1.0 / (dt * aI[i][i])
                c = u * inv_dtg
                q = c if p is None else c + p
                xi = q @ inv_op - c
            else:
                xi = p @ inv_op
        else:
            xi = p
        xis[i] = xi
        lam_prev = lam_prev + xi
    for l in range(n):
        if dWs[l] is None:
            dWs[l] = torch.zeros_like(weights[l])
            dbs[l] = torch.zeros_like(biases[l])
    return lam_prev, (tuple(dWs), tuple(dbs))


# -- kernel wrapper ---------------------------------------------------------

def fused_ark_step_adj(tableau_static, dt, Ys, lam, J_dense, inv_op,
                       weights, biases, activation="relu", sign=-1.0):
    """One fused reverse ARK step. Returns (lam_prev, (dWs, dbs)).

    tableau_static: (a_im, a_ex, b_im, b_ex) as nested Python floats; dt a
    Python float; Ys (s, B, d) the stored stage values; lam (B, d); J_dense
    and inv_op (d, d). CUDA tensors launch the kernel; CPU tensors run
    ``fused_ark_step_adj_plain``.
    """
    s, B, d, dims = check_step_args(tableau_static, lam, J_dense, inv_op,
                                    weights, biases, activation,
                                    "fused_ark_step_adj")
    _check_tensor(Ys, 3, "fused_ark_step_adj", "Ys", lam.device)
    if tuple(Ys.shape) != (s, B, d):
        raise ValueError(f"fused_ark_step_adj: Ys must be {(s, B, d)}, got "
                         f"{tuple(Ys.shape)}")
    if lam.device.type == "cpu":
        return fused_ark_step_adj_plain(tableau_static, dt, Ys, lam, J_dense,
                                        inv_op, weights, biases, activation,
                                        sign)
    lib = _build.library()
    nblk = -(-B // ROWS_PER_BLOCK)
    total = grad_buffer_size(dims)
    lam_prev = torch.empty_like(lam)
    partial = torch.empty(nblk * total, dtype=lam.dtype, device=lam.device)
    grads = torch.empty(total, dtype=lam.dtype, device=lam.device)
    with torch.cuda.device(lam.device):
        rc = lib.pnode_ark_adj(
            Ys.data_ptr(), lam.data_ptr(), J_dense.data_ptr(),
            inv_op.data_ptr(), lam_prev.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), B, d, s, tableau_array(tableau_static),
            float(dt), float(sign), len(weights), _build.int_array(dims),
            _build.ptr_array(weights), _build.ptr_array(biases),
            _ACT_CODES[activation], _build.stream_of(lam))
    _build.check(rc, "fused_ark_step_adj kernel")
    fused_ark_step_adj.launches += 1
    return lam_prev, split_grads(grads, dims)


fused_ark_step_adj.launches = 0
