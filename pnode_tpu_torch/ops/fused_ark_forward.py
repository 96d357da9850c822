"""K2: one whole ARK-IMEX forward step in one kernel.

Replaces ``pnode_tpu/ops/fused_ark_forward.py`` ``_kernel`` (:53), launched
by ``fused_ark_step_fwd`` (:157). The CUDA source is
``csrc/fused_ark_forward.cu``; its note says what bounds it on the H100 and
what the design does about that.

Scope: the fused reverse step's (``fused_ark_adjoint.py``) plus
``-snes_type ksponly``. For a linear f_IM the single linearized solve is
exact Newton, and with the pre-inverted operator the stage loop collapses
to products::

    for i = 0 .. s-1:
        G_i = y + dt sum_{j<i} (aI_ij kI_j + aE_ij kE_j)
        implicit: Y_i = G_i inv^T,  kI_i = (Y_i - G_i) / (dt aI_ii)
        explicit: Y_i = G_i,        kI_i = Y_i J^T
        kE_i = sign * MLP(Y_i)
    y1 = y + dt sum_i (bI_i kI_i + bE_i kE_i)

The ``dt == 0`` guard keeps kI finite on identity steps. Outputs y1 and the
stacked stage values (the trajectory payload the reverse step reads).
"""

from __future__ import annotations

import torch

from . import _build
from .fused_ark_adjoint import check_step_args, tableau_array
from .fused_mlp import _ACT_CODES, fused_mlp_plain


def fused_ark_step_fwd_plain(tableau_static, dt, y, J_dense, inv_op,
                             weights, biases, activation="relu", sign=-1.0):
    """Plain PyTorch version of the fused forward step (same signature and
    algebraic collapse as the kernel). Returns (y1, Ys (s, B, d))."""
    aI, aE, bI, bE = tableau_static
    s = len(bI)
    dt = float(dt)
    kI: list = [None] * s
    kE: list = [None] * s
    Ys = []
    y1 = y
    for i in range(s):
        G = y
        for j in range(i):
            if aI[i][j] != 0.0:
                G = G + (dt * aI[i][j]) * kI[j]
            if aE[i][j] != 0.0:
                G = G + (dt * aE[i][j]) * kE[j]
        if aI[i][i] != 0.0:
            Yi = G @ inv_op.T
            inv_dt = 0.0 if dt == 0.0 else 1.0 / (dt * aI[i][i])
            kI[i] = (Yi - G) * inv_dt
        else:
            Yi = G
            kI[i] = Yi @ J_dense.T
        Ys.append(Yi)
        kE[i] = sign * fused_mlp_plain(Yi, weights, biases, activation)
        if bI[i] != 0.0:
            y1 = y1 + (dt * bI[i]) * kI[i]
        if bE[i] != 0.0:
            y1 = y1 + (dt * bE[i]) * kE[i]
    return y1, torch.stack(Ys)


def fused_ark_step_fwd(tableau_static, dt, y, J_dense, inv_op, weights,
                       biases, activation="relu", sign=-1.0, b_err=None):
    """One fused forward ARK step. Returns (y1, Ys stacked (s, B, d)).

    tableau_static: (a_im, a_ex, b_im, b_ex) as nested Python floats; dt a
    Python float; y (B, d); J_dense and inv_op (d, d), passed as they are
    (the kernel applies their transposes). CUDA tensors launch the kernel;
    CPU tensors run ``fused_ark_step_fwd_plain``. The embedded error output
    (``b_err``) of the adaptive mode is not ported yet.
    """
    if b_err is not None:
        raise NotImplementedError(
            "fused_ark_step_fwd: the embedded-error output (b_err) belongs "
            "to the adaptive mode, ROADMAP queue A slice 3")
    s, B, d, dims = check_step_args(tableau_static, y, J_dense, inv_op,
                                    weights, biases, activation,
                                    "fused_ark_step_fwd")
    if y.device.type == "cpu":
        return fused_ark_step_fwd_plain(tableau_static, dt, y, J_dense,
                                        inv_op, weights, biases, activation,
                                        sign)
    lib = _build.library()
    y1 = torch.empty_like(y)
    Ys = torch.empty((s, B, d), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.pnode_ark_fwd(
            y.data_ptr(), J_dense.data_ptr(), inv_op.data_ptr(),
            y1.data_ptr(), Ys.data_ptr(), B, d, s,
            tableau_array(tableau_static), float(dt), float(sign),
            len(weights), _build.int_array(dims), _build.ptr_array(weights),
            _build.ptr_array(biases), _ACT_CODES[activation],
            _build.stream_of(y))
    _build.check(rc, "fused_ark_step_fwd kernel")
    fused_ark_step_fwd.launches += 1
    return y1, Ys


fused_ark_step_fwd.launches = 0
