"""K5: K complete ADAPTIVE training iterations per launch.

Replaces ``pnode_tpu/ops/fused_adaptive_loop.py`` ``_kernel`` (:262), with
``_ark_trial`` (:123) and ``_ark_adjoint`` (:173), launched by
``fused_adaptive_train_loop`` (:607): the adaptive mode's fused training
loop, behind ``examples/ks_torch.py --fused_loop -ts_adapt_type basic``
(the JAX package reaches its kernel only through ``bench.py --workload
adaptive``). The CUDA source is ``csrc/fused_adaptive_loop.cu``, on K2's
and K3's bodies (``csrc/ark_tiles.cuh``) and K4's plan with a trial header
(``adaptive_loop_plan``); its note says what bounds it on the H100 and what
the design does about that.

Scope: K4's (ksponly, a frozen parameter-free linear f_IM, f_EX = sign *
MLP) with a symmetric J given by its eigenbasis (``spec_lam``, ``spec_Q``),
the basic controller and one output window [0, t_end] (the SINODE one-step
training shape). Per iteration k, which ``fused_adaptive_train_loop_plain``
writes out (the controller is ``adaptive.trial_step_core``'s)::

    y = y_stack[k], t = 0, dt = the previous iteration's first accepted dt
    trials, at most max_trials, until the window lands:
        dt_try = max(min(dt, t_end - t), 0)
        M = Q diag(1 / (1 - (dt_try gamma) lam)) Q^T
        y1, err = ARK step with the stage inverse M and kI = Y J^T
        accept: WRMS(err) <= 1 (or dt_try <= 1e-14 t_end)
        dt *= clip(safety WRMS^(-1/(order+1)), lo, hi), <= 1 after a reject
    L_k = mean((y_landed - tgt_stack[k])^2)
    the accepted trials reversed from their pre-step states; Adam (K4's)

Stats per iteration: accepted, rejected, completed (0 when max_trials ran
out before the landing: the loss is then against y0 and the gradient is
zero, as in the reference), dt_first, dt_last. Only fp32 runs on the card;
the plain version takes any float dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _build
from .fused_ark_adjoint import (
    MAX_SMEM_BYTES, MAX_STAGES, REV_ADAPT, _round4,
    check_stiff_dot_precision, fused_ark_step_adj_plain, rev_plan_full,
    sm_count, tableau_array,
)
from .fused_ark_forward import fused_ark_step_fwd_plain
from .fused_mlp import (
    MAX_LAYERS, _ACT_CODES, _check_tensor, grad_buffer_size, split_grads,
)
from .fused_train_loop import (
    GATE_ROWS, _flat, adam_step_plain, check_loop_operands,
)

_REDUCE_FLOATS = 32  # csrc/fused_adaptive_loop.cu kAdaptReduce
# sizeof(Tableau) in csrc/pnode_kernels.cuh: int s, 2 s*s + 5 s floats and
# 2 s*s + 4 s bytes of zero flags, at kMaxStages
_TABLEAU_BYTES = 4 + 4 * (2 * MAX_STAGES ** 2 + 5 * MAX_STAGES) \
    + 2 * MAX_STAGES ** 2 + 4 * MAX_STAGES
STAT_NAMES = ("accepted", "rejected", "completed", "dt_first", "dt_last")


def _adaptive_smem_bytes(d: int, layer_dims: Sequence[int], stages: int,
                         max_trials: int) -> int:
    """K5's routing budget: the shared memory of the port's first K5 block
    (the trial's tableau, Q^T, the trial's stage inverse and its weights,
    an 8-row tile's s stage values, lam and lam_prev, the larger of the
    forward's and the reverse's scratch, the reduction scratch and two
    words per trial record). No kernel lays memory out so now (K5 runs on
    ``adaptive_loop_plan``); the gate keeps the budget so that every
    configuration routes as before."""
    dims = [d] + list(layer_dims)
    R = GATE_ROWS
    tile = R * d
    pingpong = 2 * R * max(dims)
    fwd = tile * (2 * stages + 4) + pingpong
    rev = tile * (stages + 4) + R * sum(dims[:-1]) + pingpong
    tab = (_TABLEAU_BYTES + 15) // 16 * 4
    return 4 * (tab + 2 * d * d + d + tile * (stages + 2) + max(fwd, rev)
                + _REDUCE_FLOATS + 2 * max_trials)


def fused_adaptive_loop_fits(B: int, d: int, layer_dims: Sequence[int],
                             max_trials: int, stages: int = 4) -> bool:
    """True when K5 takes this configuration on the H100.

    The gate is the 8-row budget (``_adaptive_smem_bytes``, at most 227
    KB; the KS recipe, 64 -> 104 x4 -> 64 at ARK3's 4 stages and 32
    trials, needs 84,944 B), and wherever it opens with the step kernels'
    forward gate (which the wrapper asks too), K5's plan
    (``adaptive_loop_plan``) takes every batch. The trials' stage values
    live in a (max_trials, s, B, d) device workspace, so neither B nor
    max_trials binds beyond the records' 8 bytes each; the grid is at most
    one block per SM, as K4's. (The JAX gate budgets the TPU's VMEM, where
    the trial records are the dominant term.)"""
    if B < 1 or max_trials < 1 or not 1 <= stages <= MAX_STAGES:
        return False
    if not 1 <= len(layer_dims) <= MAX_LAYERS or layer_dims[-1] != d:
        return False
    return (_adaptive_smem_bytes(d, layer_dims, stages, max_trials)
            <= MAX_SMEM_BYTES)


def adaptive_head_floats(d: int, max_trials: int) -> int:
    """Floats of K5's trial header ahead of the plan's regions
    (csrc/fused_adaptive_loop.cu adapt_head): the trial's tableau, the
    weights w, the warp sums, dt_try and the decision per trial."""
    return ((_TABLEAU_BYTES + 15) // 16 * 4 + _round4(d) + _REDUCE_FLOATS
            + _round4(2 * max_trials))


def adaptive_loop_plan(B: int, d: int, layer_dims: Sequence[int],
                       stages: int, max_trials: int, sms: int = 132,
                       rows: int = 0):
    """K5's launch (C entry point pnode_adaptive_loop_plan): (rows per
    block, grid, shared-memory bytes, device-workspace floats), or None.
    K4's rule (``train_loop_plan``) on K5's layout: the trial header, lam
    and lam_prev, then the forward's and the reverse's scratch overlaid,
    the trial's stage inverse and J staged (the plan takes no other layout;
    wherever the gate opens, one fits). The workspace holds the stage store
    (max_trials, s, B, d), two state buffers and lam (B, d each). ``rows``
    1, 2, 4 or 8 forces R."""
    B, d, max_trials = int(B), int(d), int(max_trials)
    if max_trials < 1:
        return None
    plan = rev_plan_full(B, d, tuple(int(n) for n in layer_dims),
                         int(stages), int(sms), REV_ADAPT, int(rows),
                         adaptive_head_floats(d, max_trials))
    if plan is None or not plan[3]:
        return None
    R, grid, smem, _ = plan
    return R, min(grid, int(sms)), smem, (max_trials * int(stages) + 3) * B * d


def _require_order(order):
    if order is None:
        # the controller exponent 1/(order+1) must be the tableau's order:
        # a wrong one is tolerance-valid but does systematically more or
        # fewer trials (the reference measured 27 against 23 accepted steps
        # per KS window with order 5 against ARK3's 3)
        raise TypeError("order is required: pass the tableau's order "
                        "(stepper.tab.order)")


def _trial_inverse(Q, lamv, dtg):
    """Q diag(1 / (1 - dtg lam)) Q^T, the reference's form (Q * w) @ Q^T."""
    w = 1.0 / (1.0 - dtg * lamv)
    return (Q * w) @ Q.T


# -- plain PyTorch version --------------------------------------------------

@torch.no_grad()
def fused_adaptive_train_loop_plain(
        tableau_static, gamma, spec_lam, spec_Q, J_dense, t_end, dt0, y_stack,
        tgt_stack, weights, biases, m_state, v_state, t0, max_trials,
        rtol=1e-4, atol=1e-4, safety=0.9, dt_min_factor=0.1,
        dt_max_factor=10.0, order=None, activation="relu", sign=-1.0,
        lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, relu_masks=None):
    """Plain PyTorch version of K5 (same signature and return structure): a
    transcription of the reference kernel's trial loop, gated reverse and
    Adam on tensors. The controller's scalars are numpy scalars of the
    state's dtype, the per-trial coefficients dt_try * a are rounded to it
    (a 0-d tensor dt), as the reference computes them for its traced dt.
    ``relu_masks``: (k, n) -> the per-stage ReLU decisions
    (``fused_ark_step_adj_plain``'s ``masks``) of iteration k's trial n,
    counting every trial, that its reverse takes in place of its own."""
    _require_order(order)
    aI, aE, bI, bE, bIe, bEe = tableau_static
    tab4, b_err = (aI, aE, bI, bE), (bIe, bEe)
    K, B, d = (int(x) for x in y_stack.shape)
    dtype, dev = y_stack.dtype, y_stack.device
    T = torch.empty((), dtype=dtype).numpy().dtype.type
    t_end = float(t_end)
    t_endT, gammaT = T(t_end), T(gamma)
    tiny = T(1e-14 * t_end)
    land = T(t_end - 1e-10 * max(abs(t_end), 1.0))
    neg_expo = T(-1.0 / (order + 1))
    inv_count = 1.0 / float(B * d)
    Q, lamv = spec_Q.to(dtype), spec_lam.to(dtype)
    params = [list(weights), list(biases)]
    m = [list(m_state[0]), list(m_state[1])]
    v = [list(v_state[0]), list(v_state[1])]
    losses, rows = [], []
    dt_carry = T(float(dt0))

    def trial(dt_try, y, **kw):
        M = _trial_inverse(Q, lamv, float(dt_try * gammaT))
        dt_t = torch.tensor(float(dt_try), dtype=dtype, device=dev)
        Ws, bs = params
        return M, dt_t, fused_ark_step_fwd_plain(
            tab4, dt_t, y, J_dense, M.T, Ws, bs, activation, sign,
            stage_jy=True, **kw)

    for k in range(K):
        y0, tgt = y_stack[k], tgt_stack[k]
        t, dt, y = T(0.0), dt_carry, y0
        rejprev = done = False
        n_acc = n_rej = 0
        dt_first = None
        recs = []  # accepted trials: (dt_try, pre-step state)
        for n in range(max_trials):
            if done:
                break
            dt_try = np.maximum(np.minimum(dt, t_endT - t), T(0.0))
            _, _, (y1, err, _) = trial(dt_try, y, b_err=b_err)
            scale = atol + rtol * torch.maximum(y.abs(), y1.abs())
            enorm = T(float(torch.sqrt(torch.sum((err / scale) ** 2)
                                       * inv_count)))
            accept = bool(enorm <= 1.0) or bool(dt_try <= tiny)
            e_cur = np.maximum(enorm, T(1e-10))
            fac = T(safety) * np.exp(neg_expo * np.log(e_cur))
            fac = np.clip(fac, T(dt_min_factor), T(dt_max_factor))
            if rejprev:
                fac = np.minimum(fac, T(1.0))
            dt = dt * fac
            rejprev = not accept
            if accept:
                recs.append((dt_try, y, n))
                t, y = t + dt_try, y1
                n_acc += 1
                if dt_first is None:
                    dt_first = dt_try
                done = bool(t >= land)
            else:
                n_rej += 1
        dt_last = dt
        if dt_first is None:
            dt_first = dt_last
        diff = (y if done else y0) - tgt
        losses.append(torch.sum(diff * diff) * inv_count)
        grads = None
        if done:
            lam = (2.0 * inv_count) * diff
            for dt_try, y_pre, n in reversed(recs):
                M, dt_t, (_, Ys) = trial(dt_try, y_pre)
                lam, g = fused_ark_step_adj_plain(
                    tab4, dt_t, Ys, lam, J_dense, M, params[0], params[1],
                    activation, sign,
                    None if relu_masks is None else relu_masks(k, n))
                grads = g if grads is None else tuple(
                    [a + b for a, b in zip(ga, gb)]
                    for ga, gb in zip(grads, g))
        if grads is None:
            grads = ([torch.zeros_like(w) for w in params[0]],
                     [torch.zeros_like(b) for b in params[1]])
        adam_step_plain(params, m, v, [list(grads[0]), list(grads[1])],
                        t0 + k + 1, lr, b1, b2, eps)
        rows.append([n_acc, n_rej, float(done), float(dt_first),
                     float(dt_last)])
        dt_carry = dt_first
    st = torch.tensor(rows, dtype=dtype, device=dev)
    stats = {name: st[:, i] for i, name in enumerate(STAT_NAMES)}
    return (params[0], params[1], (m[0], m[1]), (v[0], v[1]),
            torch.stack(losses), stats)


# -- kernel wrapper ---------------------------------------------------------

def fused_adaptive_train_loop(
        tableau_static, gamma, spec_lam, spec_Q, J_dense, t_end, dt0, y_stack,
        tgt_stack, weights, biases, m_state, v_state, t0, max_trials,
        rtol=1e-4, atol=1e-4, safety=0.9, dt_min_factor=0.1,
        dt_max_factor=10.0, order=None, activation="relu", sign=-1.0,
        lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, rows=0, workspace=None):
    """Run K complete adaptive training iterations in one launch.

    tableau_static: (aI, aE, bI, bE, bI_err, bE_err) as Python floats;
    gamma the ESDIRK diagonal; spec_lam (d,) and spec_Q (d, d) the
    eigenbasis of the frozen symmetric J_dense (d, d); the window is [0,
    t_end]; dt0 the first iteration's controller dt (a float or a 0-d
    tensor); y_stack, tgt_stack (K, B, d); weights, biases, m_state,
    v_state as ``fused_train_loop`` takes them; t0 the Adam updates
    already applied; ``order`` the tableau's order (required). Iteration k
    trains on (y_stack[k], tgt_stack[k]) and starts its controller from
    the previous iteration's dt_first. Returns (weights', biases', (mW',
    mb'), (vW', vb'), losses (K,), stats) with stats a dict of (K,) tensors
    accepted, rejected, completed, dt_first, dt_last; the inputs are not
    modified. CUDA tensors launch the kernel (at its plan's rows per
    block, or ``rows`` 1, 2, 4 or 8 forced, for kernel comparisons); CPU
    tensors run ``fused_adaptive_train_loop_plain``. ``workspace``: an fp32
    tensor of the plan's workspace floats on the card for the launch's
    device workspace, which it leaves holding the last iteration's trial
    stage values, (max_trials, s, B, d) first (a kernel check reads them);
    by default the wrapper allocates its own.
    """
    _require_order(order)
    check_stiff_dot_precision()
    what = "fused_adaptive_train_loop"
    tab4 = tuple(tableau_static[:4])
    K, B, d, s, dims = check_loop_operands(
        what, tab4, y_stack, tgt_stack, J_dense, spec_Q, weights, biases,
        m_state, v_state, activation)
    _check_tensor(spec_lam, 1, what, "spec_lam", y_stack.device)
    if tuple(spec_lam.shape) != (d,):
        raise ValueError(f"{what}: spec_lam must be ({d},), got "
                         f"{tuple(spec_lam.shape)}")
    bIe, bEe = tableau_static[4:]
    if len(bIe) != s or len(bEe) != s:
        raise ValueError(f"{what}: the tableau needs {s} embedded weights "
                         "per part")
    if not fused_adaptive_loop_fits(B, d, dims[1:], int(max_trials), s):
        raise ValueError(f"{what}: configuration exceeds the adaptive loop "
                         "kernel's shared-memory budget (gate with "
                         "fused_adaptive_loop_fits)")
    if rows not in (0, 1, 2, 4, 8):
        raise ValueError(f"{what}: rows must be 0, 1, 2, 4 or 8, got {rows}")
    if y_stack.device.type == "cpu":
        if workspace is not None:
            raise ValueError(f"{what}: the plain version has no workspace")
        return fused_adaptive_train_loop_plain(
            tableau_static, gamma, spec_lam, spec_Q, J_dense, t_end, dt0,
            y_stack, tgt_stack, weights, biases, m_state, v_state, t0,
            max_trials, rtol, atol, safety, dt_min_factor, dt_max_factor,
            order, activation, sign, lr, b1, b2, eps)
    with torch.cuda.device(y_stack.device):
        return run_adaptive_loop(
            _build.library(), sm_count(y_stack.device),
            _build.stream_of(y_stack), tableau_static, gamma, spec_lam,
            spec_Q, J_dense, t_end, dt0, y_stack, tgt_stack, weights,
            biases, m_state, v_state, t0, max_trials, rtol, atol, safety,
            dt_min_factor, dt_max_factor, order, activation, sign, lr, b1,
            b2, eps, rows, workspace)


def run_adaptive_loop(lib, sms, stream, tableau_static, gamma, spec_lam,
                      spec_Q, J_dense, t_end, dt0, y_stack, tgt_stack,
                      weights, biases, m_state, v_state, t0, max_trials,
                      rtol, atol, safety, dt_min_factor, dt_max_factor,
                      order, activation, sign, lr, b1, b2, eps, rows,
                      workspace=None):
    """``fused_adaptive_train_loop``'s launch through ``lib`` (the kernel
    library) on a card of ``sms`` SMs, operands validated: the scratch at
    K5's plan (the device workspace ``workspace`` where given), then one
    launch on ``stream``."""
    what = "fused_adaptive_train_loop"
    tab4 = tuple(tableau_static[:4])
    bIe, bEe = tableau_static[4:]
    K, B, d = (int(x) for x in y_stack.shape)
    s = len(tab4[2])
    dims = [d] + [int(w.shape[1]) for w in weights]
    plan = adaptive_loop_plan(B, d, dims[1:], s, max_trials, sms, rows)
    if plan is None:
        raise ValueError(f"{what}: no plan at rows {rows} for B {B}, {dims}, "
                         f"{s} stages, {max_trials} trials")
    grid, ws_floats = plan[1], plan[3]
    dev = y_stack.device
    params = _flat(weights, biases)
    m_flat = _flat(*m_state)
    v_flat = _flat(*v_state)
    total = grad_buffer_size(dims)
    f32 = dict(dtype=torch.float32, device=dev)
    if isinstance(dt0, torch.Tensor):
        dt_io = dt0.detach().reshape(1).to(**f32).clone()
    else:
        dt_io = torch.tensor([float(dt0)], **f32)
    stats = torch.empty(K, 6, **f32)
    partial = torch.empty(grid * _round4(total), **f32)
    lpart = torch.empty(grid, **f32)
    eslot = torch.empty(2 * grid, **f32)
    if workspace is None:
        ws = torch.empty(ws_floats, **f32)
    elif (workspace.dtype != torch.float32 or workspace.device != dev
          or workspace.numel() != ws_floats
          or not workspace.is_contiguous()):
        raise ValueError(f"{what}: workspace must be {ws_floats} contiguous "
                         f"fp32 floats on {dev}")
    else:
        ws = workspace
    qt = spec_Q.t().contiguous()  # the kernel reads Q^T's rows
    err_tab = _build.double_array([float(x) for x in bIe]
                                  + [float(x) for x in bEe])
    rc = lib.pnode_adaptive_loop(
        y_stack.data_ptr(), tgt_stack.data_ptr(), J_dense.data_ptr(),
        qt.data_ptr(), spec_lam.data_ptr(), params.data_ptr(),
        m_flat.data_ptr(), v_flat.data_ptr(), partial.data_ptr(),
        lpart.data_ptr(), eslot.data_ptr(), ws.data_ptr(), stats.data_ptr(),
        dt_io.data_ptr(), K, B, d, s, tableau_array(tab4), err_tab,
        float(gamma), float(sign), len(weights), _build.int_array(dims),
        _ACT_CODES[activation], int(t0), float(lr), float(b1), float(b2),
        float(eps), int(max_trials), float(rtol), float(atol), float(safety),
        float(dt_min_factor), float(dt_max_factor), 1.0 / (int(order) + 1),
        float(t_end), int(rows), partial.numel(), ws.numel(), stream)
    _build.check(rc, f"{what} kernel")
    fused_adaptive_train_loop.launches += 1
    Ws, bs = split_grads(params, dims)
    mW, mb = split_grads(m_flat, dims)
    vW, vb = split_grads(v_flat, dims)
    out = {name: stats[:, i + 1] for i, name in enumerate(STAT_NAMES)}
    return (list(Ws), list(bs), (list(mW), list(mb)), (list(vW), list(vb)),
            stats[:, 0], out)


fused_adaptive_train_loop.launches = 0


def plan(B, d, layer_dims, stages, max_trials, device, rows=0):
    """The C plan's (rows per block, grid, shared-memory bytes, workspace
    floats) of K5 on ``device``'s card: what ``adaptive_loop_plan``
    mirrors."""
    import ctypes

    lib = _build.library()
    dims = [d] + list(layer_dims)
    out = (_build.int_array([0]), _build.int_array([0]),
           (ctypes.c_longlong * 1)(0), (ctypes.c_longlong * 1)(0))
    with torch.cuda.device(device):
        rc = lib.pnode_adaptive_loop_plan(B, d, stages, len(layer_dims),
                                          _build.int_array(dims), max_trials,
                                          rows, *out)
    return None if rc else tuple(o[0] for o in out)
