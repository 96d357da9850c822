"""K2: one whole ARK-IMEX forward step in one kernel.

Replaces ``pnode_tpu/ops/fused_ark_forward.py`` ``_kernel`` (:53), launched
by ``fused_ark_step_fwd`` (:157). The CUDA source is
``csrc/fused_ark_forward.cu`` with its body in ``csrc/ark_tiles.cuh`` (the
row form) or ``csrc/ark_grid.cuh`` (the grid form, where K3's plan takes
it from d 280 up: Burgers-512, d 300); their notes say what bounds it on
the H100 and what the design does about that. The launch's form, rows
per block, grid and shared memory come from the C plan, which
``fused_ark_adjoint.ark_fwd_plan`` mirrors (the fits gate reads the
mirror).

Scope: the fused reverse step's (``fused_ark_adjoint.py``) plus
``-snes_type ksponly``. For a linear f_IM the single linearized solve is
exact Newton, and with the pre-inverted operator the stage loop collapses
to products::

    for i = 0 .. s-1:
        G_i = y + dt sum_{j<i} (aI_ij kI_j + aE_ij kE_j)
        implicit: Y_i = G_i inv^T,  kI_i = (Y_i - G_i) / (dt aI_ii)
        explicit: Y_i = G_i,        kI_i = Y_i J^T
        kE_i = sign * MLP(Y_i)
    y1  = y + dt sum_i (bI_i kI_i + bE_i kE_i)
    err = dt sum_i ((bI - bI_err)_i kI_i + (bE - bE_err)_i kE_i)

The ``dt == 0`` guard keeps kI finite on identity steps. Outputs y1 and the
stacked stage values (the trajectory payload the reverse step reads), and,
given the embedded weights ``b_err``, the error estimate err that drives
the adaptive controller (``-ts_adapt_type basic``): the same kernel, whose
launches count on ``fused_ark_step_fwd_embedded``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_ark_adjoint import (
    GRID_FWD, ark_fwd_plan, check_step_args, grid_plan, sm_count,
    tableau_array,
)
from .fused_mlp import _ACT_CODES, fused_mlp_plain


def fused_ark_step_fwd_plain(tableau_static, dt, y, J_dense, inv_op,
                             weights, biases, activation="relu", sign=-1.0,
                             b_err=None, stage_jy=False):
    """Plain PyTorch version of the fused forward step (same signature and
    algebraic collapse as the kernel). Returns (y1, Ys (s, B, d)), or (y1,
    err, Ys) given ``b_err``.

    ``dt`` is a Python float, or a 0-d tensor whose dtype then rounds every
    coefficient dt * a (K5's plain version: the JAX package's arithmetic
    for a traced dt). ``stage_jy`` takes kI = Y J^T on implicit stages, as
    K5 does, instead of the difference quotient."""
    aI, aE, bI, bE = tableau_static
    s = len(bI)
    if not isinstance(dt, torch.Tensor):
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
            if stage_jy:
                kI[i] = Yi @ J_dense.T
            else:
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
    if b_err is None:
        return y1, torch.stack(Ys)
    err = torch.zeros_like(y)
    for i, (dI, dE) in enumerate(_err_weights(tableau_static, b_err)):
        if dI != 0.0:
            err = err + (dt * dI) * kI[i]
        if dE != 0.0:
            err = err + (dt * dE) * kE[i]
    return y1, err, torch.stack(Ys)


def _err_weights(tableau_static, b_err):
    """The embedded pair's weight differences (bI - bI_err, bE - bE_err)
    per stage, in double as the reference forms them."""
    _, _, bI, bE = tableau_static
    bIe, bEe = b_err
    s = len(bI)
    if len(bIe) != s or len(bEe) != s:
        raise ValueError(f"b_err must hold two rows of {s} embedded weights")
    return [(float(bI[i]) - float(bIe[i]), float(bE[i]) - float(bEe[i]))
            for i in range(s)]


def fused_ark_step_fwd(tableau_static, dt, y, J_dense, inv_op, weights,
                       biases, activation="relu", sign=-1.0, b_err=None):
    """One fused forward ARK step. Returns (y1, Ys stacked (s, B, d)), or
    (y1, err, Ys) when ``b_err = (b_im_err, b_ex_err)`` is given (the
    embedded pair driving ``-ts_adapt_type basic``, as the reference's
    wrapper returns them; those launches count on
    ``fused_ark_step_fwd_embedded``).

    tableau_static: (a_im, a_ex, b_im, b_ex) as nested Python floats; dt a
    Python float; y (B, d); J_dense and inv_op (d, d), passed as they are
    (the kernel applies their transposes). CUDA tensors launch the kernel
    in its plan's form (``ark_fwd_plan``); CPU tensors run
    ``fused_ark_step_fwd_plain``.
    """
    if b_err is not None:
        return fused_ark_step_fwd_embedded(tableau_static, b_err, dt, y,
                                           J_dense, inv_op, weights, biases,
                                           activation, sign)
    return _fwd(fused_ark_step_fwd, tableau_static, None, dt, y, J_dense,
                inv_op, weights, biases, activation, sign)


def fused_ark_step_fwd_embedded(tableau_static, b_err, dt, y, J_dense,
                                inv_op, weights, biases, activation="relu",
                                sign=-1.0):
    """``fused_ark_step_fwd`` with the embedded error output: (y1, err,
    Ys). Its own launch count, so a run shows that the adaptive path went
    through the err output."""
    return _fwd(fused_ark_step_fwd_embedded, tableau_static, b_err, dt, y,
                J_dense, inv_op, weights, biases, activation, sign)


def _fwd(counter, tableau_static, b_err, dt, y, J_dense, inv_op, weights,
         biases, activation, sign):
    check_step_args(tableau_static, y, J_dense, inv_op, weights, biases,
                    activation, "fused_ark_step_fwd", reverse=False)
    if b_err is not None:
        _err_weights(tableau_static, b_err)
    if y.device.type == "cpu":
        return fused_ark_step_fwd_plain(tableau_static, dt, y, J_dense,
                                        inv_op, weights, biases, activation,
                                        sign, b_err)
    with torch.cuda.device(y.device):
        return run_ark_fwd(_build.library(), sm_count(y.device),
                           _build.stream_of(y), tableau_static, b_err, dt, y,
                           J_dense, inv_op, weights, biases, activation, sign)


def fwd_scratch_floats(B, d, layer_dims, stages, sms=132, rows=0,
                       form="plan"):
    """Floats of K2's workspace: the grid form's (``grid_plan``, GRID_FWD:
    layer inputs, kI, kE and G) where the plan takes it at ``rows`` 0, or
    with ``form`` "grid"; 0 in the row form."""
    grid_form = form == "grid" or (
        rows == 0 and ark_fwd_plan(B, d, layer_dims, stages, sms)[0] == 0)
    return grid_plan(GRID_FWD, B, d, layer_dims, stages, sms)[2] \
        if grid_form else 0


def run_ark_fwd(lib, sms, stream, tableau_static, b_err, dt, y, J_dense,
                inv_op, weights, biases, activation="relu", sign=-1.0,
                rows=0, grid=0, form="plan"):
    """``fused_ark_step_fwd``'s launch (with the err output given
    ``b_err``) through ``lib`` (the kernel library) on a card of ``sms``
    SMs, operands validated: the outputs and the workspace of the plan's
    form, one C call on ``stream``. For kernel comparisons only: ``rows``
    1, 2, 4 or 8 forces the row form; ``form`` "grid" the grid form
    whatever the plan's (the KS shapes'); ``grid`` the grid form on that
    many co-resident blocks, not the plan's (the outputs' bits do not
    depend on it)."""
    B, d = (int(x) for x in y.shape)
    s = len(tableau_static[2])
    dims = [d] + [int(w.shape[1]) for w in weights]
    if (rows not in (0, 1, 2, 4, 8) or grid < 0
            or form not in ("plan", "grid") or (rows and form == "grid")):
        raise ValueError("fused_ark_step_fwd: rows must be 0, 1, 2, 4 or 8 "
                         "(the row form), form plan or grid, grid 0 or "
                         "positive")
    ws_floats = fwd_scratch_floats(B, d, dims[1:], s, sms, rows, form)
    if grid and not ws_floats:
        raise ValueError(f"fused_ark_step_fwd: grid {grid} is for the grid "
                         "form only")
    y1 = torch.empty_like(y)
    Ys = torch.empty((s, B, d), dtype=y.dtype, device=y.device)
    ws = torch.empty(ws_floats, dtype=y.dtype, device=y.device)
    err = None if b_err is None else torch.empty_like(y)
    err_tab = None if b_err is None else _build.double_array(
        [float(x) for x in b_err[0]] + [float(x) for x in b_err[1]])
    rc = lib.pnode_ark_fwd(
        y.data_ptr(), J_dense.data_ptr(), inv_op.data_ptr(), y1.data_ptr(),
        Ys.data_ptr(), None if err is None else err.data_ptr(),
        ws.data_ptr(), B, d, s, tableau_array(tableau_static), err_tab,
        float(dt), float(sign), len(weights), _build.int_array(dims),
        _build.ptr_array(weights), _build.ptr_array(biases),
        _ACT_CODES[activation], -1 if form == "grid" else int(rows),
        int(grid), ws_floats, stream)
    _build.check(rc, "fused_ark_step_fwd kernel")
    if b_err is None:
        fused_ark_step_fwd.launches += 1
        return y1, Ys
    fused_ark_step_fwd_embedded.launches += 1
    return y1, err, Ys


def plan(B, d, layer_dims, stages, device):
    """The C plan's (rows per block, grid, shared-memory bytes) on
    ``device``'s card: what ``ark_fwd_plan`` mirrors."""
    lib = _build.library()
    dims = [d] + list(layer_dims)
    rows, grid, smem = (_build.int_array([0]), _build.int_array([0]),
                        (ctypes.c_longlong * 1)(0))
    with torch.cuda.device(device):
        rc = lib.pnode_ark_fwd_plan(B, d, stages, len(layer_dims),
                                    _build.int_array(dims), rows, grid, smem)
    return None if rc else (rows[0], grid[0], smem[0])


fused_ark_step_fwd.launches = 0
fused_ark_step_fwd_embedded.launches = 0
