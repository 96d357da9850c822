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

import functools
from typing import Sequence

import torch

from . import _build
from .fused_mlp import (
    MAX_LAYERS, _ACT_CODES, _check_tensor, check_stack, fused_mlp_bwd_plain,
    grad_buffer_size, split_grads,
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


# K2's register tile (csrc/ark_tiles.cuh kThreads, kCols): a product takes
# layers up to kThreads * kCols wide
FWD_THREADS, FWD_COLS = 256, 4


def _split_k(K: int, N: int) -> int:
    nct = -(-N // FWD_COLS)
    return max(1, min(FWD_THREADS // nct, max(1, K // 4)))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _fwd_scratch(R: int, d: int, dims: Sequence[int], stages: int) -> int:
    """Floats of forward_step's regions at R rows per block (y, kI, kE, G,
    Y, two layer buffers, the split-k partials; csrc/ark_tiles.cuh
    layout_fwd): K2's plan and K12's both lay them out."""
    red = 0  # the MLP layers' split-k partials (the stiff products: none)
    for K, N in zip(dims, dims[1:]):
        g = _split_k(K, N)
        if g > 1:
            red = max(red, g * N)
    return (3 * _round4(R * d) + 2 * _round4(stages * R * d)
            + 2 * _round4(R * max(dims)) + _round4(R * red))


def _fwd_plan_rows(R: int, d: int, dims: Sequence[int], stages: int):
    """Shared-memory bytes of K2 at R rows per block (csrc/ark_tiles.cuh
    plan_rows), or None when it does not fit."""
    maxd = max(dims)
    if maxd > FWD_THREADS * FWD_COLS:
        return None
    fixed = _fwd_scratch(R, d, dims, stages)
    budget = MAX_SMEM_BYTES // 4
    op = _round4(d * (d | 1))
    whole = _round4(max(K * N for K, N in zip(dims, dims[1:])))
    if fixed + 2 * op + 2 * whole <= budget:
        return 4 * (fixed + 2 * op + 2 * whole)
    slot = min((budget - fixed) // 2 & ~3, max(whole, op))
    if slot < _round4(maxd):
        return None
    return 4 * (fixed + 2 * slot)


def ark_fwd_plan(B: int, d: int, layer_dims: Sequence[int], stages: int,
                 sms: int = 132):
    """K2's launch (csrc/fused_ark_forward.cu fwd_plan, C entry point
    pnode_ark_fwd_plan): (rows per block, grid, shared-memory bytes), or
    None when the configuration does not fit. Where K3's plan takes the
    grid form (``ark_adj_plan``) and d >= GRID_MIN_D (Burgers-512, d 300),
    K2's does too (0, grid, bytes). Else the row form
    (csrc/ark_tiles.cuh plan_fwd): rows the fewest in {1, 2, 4, 8} whose
    grid ceil(B / rows) fits one block per SM (``sms``, 132 on an H100
    SXM), else 8; halved while the block's shared memory (stage values,
    operators, the weight ring) passes MAX_SMEM_BYTES. Memoized: every
    step wrapper's gate asks it."""
    plan = _ark_fwd_plan(int(B), int(d), tuple(int(n) for n in layer_dims),
                         int(stages), int(sms))
    adj = ark_adj_plan(B, d, layer_dims, stages, sms)
    if (plan is not None and adj is not None and adj[0] == 0
            and d >= GRID_MIN_D):
        return (0,) + grid_plan(GRID_FWD, B, d, layer_dims, stages, sms)[:2]
    return plan


@functools.lru_cache(maxsize=1024)
def _ark_fwd_plan(B: int, d: int, layer_dims: tuple, stages: int, sms: int):
    dims = [d] + list(layer_dims)
    if (B < 1 or not 1 <= stages <= MAX_STAGES
            or not 1 <= len(layer_dims) <= MAX_LAYERS or dims[-1] != d
            or min(dims) < 1):
        return None
    R = 1
    while R < 8 and -(-B // R) > sms:
        R *= 2
    while R >= 1:
        smem = _fwd_plan_rows(R, d, dims, stages)
        if smem is not None:
            return R, -(-B // R), smem
        R //= 2
    return None


def _row_stride(N: int) -> int:
    """Row stride of a streamed weight chunk (csrc/ark_tiles.cuh
    row_stride)."""
    return N | 1 if N % 4 else (N if N // 4 % 2 else N + 4)


# the reverse's layouts (csrc/ark_tiles.cuh RevKind): K3's; K4's and
# K12's (the stage values kept, the forward overlaid); K5's (lam and
# lam_prev, the forward overlaid, after the kernel's own header)
REV_STEP, REV_GRAD, REV_ADAPT = 0, 1, 2
# fewest rows of each W_l a ring chunk of the rule's R > 1 holds
# (csrc/ark_tiles.cuh kMinChunkRows)
MIN_CHUNK_ROWS = 8


def _rev_plan_rows(R: int, d: int, dims: Sequence[int], stages: int,
                   nst: int, grad, resident: bool = True, head: int = 0,
                   min_rows: int = 0):
    """Shared-memory bytes of K3 (``grad`` False or REV_STEP), K4 and K12
    (True or REV_GRAD) or K5 (REV_ADAPT, after ``head`` floats) at R rows
    per block with ``nst`` stage slots in the layer store, inv and J
    staged whole (``resident``) or read in place from device memory
    (csrc/ark_tiles.cuh plan_rev_rows), or None when it does not fit, or
    when a ring chunk holds fewer than ``min_rows`` rows of some W_l (all
    of it where it has fewer; plan_rev's chunks_fill)."""
    kind = int(grad)
    pairs = list(zip(dims, dims[1:]))
    if max(dims) > FWD_THREADS * FWD_COLS:
        return None
    redw = max(max(_split_k(K, N) * N, _split_k(N, K) * K) for K, N in pairs)
    whole = max(K * _row_stride(N) for K, N in pairs)
    minslot = max(_row_stride(N) for _, N in pairs)
    sst = sum(_round4(R * K) + _round4(R * N) for K, N in pairs)
    tile, stiles = _round4(R * d), _round4(stages * R * d)
    # (Ys, seed) or (lam, lam_prev)
    off = head + (stiles + tile if kind == REV_GRAD else 2 * tile)
    scratch = off
    off += stiles + 3 * tile + nst * sst + _round4(R * redw)
    if kind != REV_STEP:  # forward_step's regions overlay the reverse's
        off = max(off, scratch + _fwd_scratch(R, d, dims, stages))
    if resident:
        off += 2 * _round4(d * (d | 1))  # inv and J
    slot = _round4(whole)
    avail = MAX_SMEM_BYTES // 4 - off
    if 2 * slot > avail:
        slot = (avail // 2) & ~3
    if slot < _round4(minslot):
        return None
    if any(slot // _row_stride(N) < min(min_rows, K) for K, N in pairs):
        return None
    return 4 * (off + 2 * slot)


# The grid form (csrc/ark_grid.cuh): every product of K3's step, of K4's
# iteration, of K12's gradient step or of K2's forward step, tiled over
# one cooperative grid of one block per SM, two tile groups of
# GRID_THREADS threads a block, in GRID_TILE x GRID_TILE output tiles over
# GRID_CHUNK-deep staged chunks. K3's and K4's plans take it where the row
# form's cannot keep inv and J in shared memory (Burgers-512, d 200, d 300
# and d 197 among the pinned shapes), K2's and K12's there from d
# GRID_MIN_D up; the KS shapes keep the row form. The
# launches that run it (csrc/ark_grid.cuh GridKind): K3's step
# (GRID_STEP), K4's loop (GRID_LOOP), K12's gradient step (GRID_GRAD), K2's
# forward step (GRID_FWD).
GRID_THREADS, GRID_GROUPS, GRID_TILE, GRID_CHUNK = 128, 2, 32, 64
GRID_SMEM = 4 * (GRID_GROUPS * 4 * GRID_CHUNK * (GRID_TILE + 4) + 32)
GRID_STEP, GRID_LOOP, GRID_GRAD, GRID_FWD = 0, 1, 2, 3
GRID_KINDS = (GRID_STEP, GRID_LOOP, GRID_GRAD, GRID_FWD)
# K2 and K12 take the grid form only from this state width up (csrc/
# ark_grid.cuh kGridMinD): below it their row form, which streams inv or
# J through every block's ring, is faster (d 200, 197 and 256; PERF.md)
GRID_MIN_D = 280


def grid_workspace(kind: int, B: int, d: int, layer_dims: Sequence[int],
                   stages: int):
    """The grid form's device workspace (csrc/ark_grid.cuh plan_grid):
    ({region: (offset, floats)}, total floats), each region at a multiple
    of 4 floats. Every stage's layer inputs h_l (l >= 1); for the reverse
    (all but K2) every stage's covectors g_l (g_{n-1}: the seeds sign
    uh_i), xi, u and q (s, B, d), pv (B, d), the stage values h_0 ("ys",
    (s, B, d)); for the forward (K4, K12, K2) kI, kE (s, B, d) and G (B,
    d); for the MSE (K4, K12) the seed lam and y1 - tgt (B, d) and the
    per-row losses (B). h_l, g_l and the stage values hold stage i in slot
    s - 1 - i; K2's h_l in slot i, its stage values the caller's ys."""
    dims = [int(d)] + [int(n) for n in layer_dims]
    n, sb, bd = len(layer_dims), stages * B, B * d
    regions, off = {}, 0

    def take(name, floats):
        nonlocal off
        regions[name] = (off, floats)
        off += _round4(floats)

    for l in range(1, n):
        take(f"h{l}", sb * dims[l])
    if kind != GRID_FWD:
        for l in range(n):
            take(f"g{l}", sb * dims[l + 1])
        for name in ("xi", "u", "q"):
            take(name, sb * d)
        take("pv", bd)
        take("ys", sb * d)
    if kind != GRID_STEP:
        for name in ("kI", "kE"):
            take(name, sb * d)
        take("G", bd)
    if kind in (GRID_LOOP, GRID_GRAD):
        for name in ("lam", "diff"):
            take(name, bd)
        take("lrow", B)
    return regions, off


def grid_plan(kind: int, B: int, d: int, layer_dims: Sequence[int],
              stages: int, sms: int = 132):
    """The grid form's launch (C entry point pnode_ark_grid_plan): (grid,
    shared-memory bytes, workspace floats); the grid is one block per
    SM."""
    return (int(sms), GRID_SMEM,
            grid_workspace(kind, int(B), int(d), layer_dims, int(stages))[1])


def reach_masks(tableau_static):
    """The stages a covector into kI (umask) or kE (emask) reaches, as bit
    masks (csrc/ark_tiles.cuh reach_masks)."""
    aI, aE, bI, bE = tableau_static
    s = len(bI)
    um = em = 0
    for i in range(s - 1, -1, -1):
        hu, he = bI[i] != 0.0, bE[i] != 0.0
        for m in range(i + 1, s):
            if (um | em) >> m & 1:
                hu = hu or aI[m][i] != 0.0
                he = he or aE[m][i] != 0.0
        um |= int(hu) << i
        em |= int(he) << i
    return um, em


# the grid form's epilogues and per-block work, in csrc/ark_grid.cuh's
# order (GridEpi, GridPre)
GRID_EPIS = ("act", "backprop", "pv", "stage_end", "xi", "grad", "adam",
             "fwd_stiff", "fwd_ke")
GRID_PRES = ("none", "stage", "loss", "rows")


def grid_phases(kind: int, B: int, d: int, layer_dims: Sequence[int],
                tableau_static, k: int = 1):
    """The grid form's phases of ``kind`` in order, at iteration ``k`` of
    K4's loop (csrc/ark_grid.cuh next_phase; C entry point
    pnode_ark_grid_phases): the forward (K4, K12, K2), or K3's staging of
    the stage values and its recompute; then, but for K2, the reverse's
    stages and the dW/db products (K4's with Adam, K12's and K3's the
    flat gradient; K4's and K12's after the loss rows). Each phase is a
    dict of its
    per-block work ``pre`` (GRID_PRES) and its ``products``, each a dict
    of its epilogue ``epi`` (GRID_EPIS), ``stage``, ``layer``, the (M, N)
    output over K reduction positions in G groups of blocks of v
    positions dealt round-robin, ``ones`` (A's row that reads 1, dW's db
    row, or -1), ``ldo``, the operands ``a`` and ``b`` as (region, first
    float, row stride, k-major), ``out`` as (region, first float) or None
    where the epilogue writes by element, and ``aux`` (kEpiBackprop's
    h_l) likewise. Regions: the workspace's (``grid_workspace``; "ys"
    holds h_0, K2's the caller's), "W{l}", "J", "inv" and the minibatch
    "y". Stage i's layer inputs and covectors sit in slot s - 1 - i (K2's
    in slot i)."""
    aI, bI = tableau_static[0], tableau_static[2]
    s = len(bI)
    dims = [int(d)] + [int(n) for n in layer_dims]
    n, bd = len(layer_dims), B * d
    um, em = reach_masks(tableau_static)
    reached = um | em
    phases = []

    def h(l, i=None):  # h_l, whole or at stage i's slot
        slot = i if kind == GRID_FWD else s - 1 - (i or 0)
        return ("ys" if l == 0 else f"h{l}",
                0 if i is None else slot * B * dims[l])

    def gemm(epi, stage, layer, M, N, K, G, v, a, b, out, ldo, aux=None,
             ones=-1):
        return dict(epi=epi, stage=stage, layer=layer, M=M, N=N, K=K, G=G,
                    v=v, ones=ones, ldo=ldo, a=a, b=b, out=out, aux=aux)

    def mlp(l, a, M, out, epi, stage):
        K, N = dims[l], dims[l + 1]
        return gemm(epi, stage, l, M, N, K, _split_k(K, N), 1, a + (K, 0),
                    (f"W{l}", 0, N, 1), out, N)

    def stiff(a, op, transposed, epi, i):
        return gemm(epi, i, 0, B, d, d, 1, 1, a + (d, 0),
                    (op, 0, d, int(not transposed)), None, d)

    def phase(products, pre="none"):
        phases.append(dict(pre=pre, products=products))

    if kind != GRID_STEP:
        for i in range(s):
            impl = aI[i][i] != 0.0
            G = ("y", 0) if i == 0 else ("G", 0)
            prods = [stiff(G, "inv" if impl else "J", True, "fwd_stiff", i)]
            beside = not impl and n > 1
            if beside:
                prods.append(mlp(0, G, B, h(1, i), "act", i))
            phase(prods, "loss" if i == 0 and k > 0 and kind == GRID_LOOP
                  else "none")
            for l in range(1 if beside else 0, n):
                last = l == n - 1
                phase([mlp(l, h(l, i), B,
                           ("kE", i * bd) if last else h(l + 1, i),
                           "fwd_ke" if last else "act", i)])
        if kind == GRID_FWD:
            return phases
    else:
        phase([], "stage")
        for l in range(n - 1):
            phase([mlp(l, h(l), s * B, h(l + 1), "act", 0)])
    i = max((j for j in range(s) if reached >> j & 1), default=-1)
    while i >= 0:
        hu, he, impl = um >> i & 1, em >> i & 1, aI[i][i] != 0.0
        pv = hu and not impl
        u = ("u", i * bd)
        if he and pv and n == 1:
            phase([stiff(u, "J", False, "pv", i)])
        for l in range(n - 1, -1, -1) if he else ():
            K, N = dims[l], dims[l + 1]
            g = ("g%d" % l, (s - 1 - i) * B * N, N, 0)
            prods = [gemm("backprop" if l else "stage_end", i, l, B, K, N,
                          _split_k(N, K), 4 if N % 4 == 0 else 1, g,
                          (f"W{l}", 0, N, 0),
                          ("g%d" % (l - 1), (s - 1 - i) * B * K) if l
                          else None, K, h(l, i) if l else None)]
            if pv and n > 1 and l == n - 1:
                prods.append(stiff(u, "J", False, "pv", i))
            phase(prods)
        if not he and pv:
            phase([stiff(u, "J", False, "stage_end", i)])
        if impl:
            phase([stiff(("q", i * bd), "inv", False, "xi", i)])
        i = max((j for j in range(i) if reached >> j & 1), default=-1)
    phase([gemm("adam" if kind == GRID_LOOP else "grad", 0, l, dims[l] + 1,
                dims[l + 1], s * B, 1, 1, h(l) + (dims[l], 1),
                (f"g{l}", 0, dims[l + 1], 1), None, dims[l + 1],
                ones=dims[l]) for l in range(n)],
          "none" if kind == GRID_STEP else "rows")
    return phases


def _rev_plan(B, d, layer_dims, stages, sms, kind, min_d=0):
    """``rev_plan_full``'s (rows, grid, bytes) at the rule's rows, or the
    grid form's (0, grid, bytes) where the rule's plan cannot keep inv and
    J resident and d >= ``min_d``."""
    plan = rev_plan_full(int(B), int(d), tuple(int(n) for n in layer_dims),
                         int(stages), int(sms), kind)
    if plan is None:
        return None
    if not plan[3] and d >= min_d:
        return (0,) + grid_plan(GRID_STEP, B, d, layer_dims, stages, sms)[:2]
    return plan[:3]


@functools.lru_cache(maxsize=1024)
def rev_plan_full(B: int, d: int, layer_dims: tuple, stages: int, sms: int,
                  kind: int, rows: int = 0, head: int = 0):
    """csrc/ark_tiles.cuh plan_rev for the layout ``kind`` after ``head``
    floats: (rows per block, grid ceil(B / rows), shared-memory bytes,
    inv and J resident), or None. ``rows`` 1, 2, 4 or 8 forces R with the
    whole store; 0 takes the rule."""
    dims = [d] + list(layer_dims)
    if (B < 1 or not 1 <= stages <= MAX_STAGES
            or not 1 <= len(layer_dims) <= MAX_LAYERS or dims[-1] != d
            or min(dims) < 1):
        return None
    for resident in (True, False):
        if rows:
            smem = (_rev_plan_rows(rows, d, dims, stages, stages, kind,
                                   resident, head)
                    if rows in (1, 2, 4, 8) else None)
            if smem is not None:
                return rows, -(-B // rows), smem, resident
            continue
        R = 1
        while R < 8 and -(-B // R) > sms:
            R *= 2
        while R >= 1:
            smem = _rev_plan_rows(R, d, dims, stages, stages, kind, resident,
                                  head, MIN_CHUNK_ROWS if R > 1 else 0)
            if smem is not None:
                return R, -(-B // R), smem, resident
            R //= 2
        for nst in range(stages - 1, 0, -1):
            smem = _rev_plan_rows(1, d, dims, stages, nst, kind, resident,
                                  head)
            if smem is not None:
                return 1, B, smem, resident
    return None


def ark_adj_plan(B: int, d: int, layer_dims: Sequence[int], stages: int,
                 sms: int = 132):
    """K3's launch (csrc/ark_tiles.cuh plan_rev, C entry point
    pnode_ark_adj_plan): (rows per block, grid, shared-memory bytes), or
    None when the configuration does not fit. Where the row form below
    cannot keep inv and J resident (past d ~160 at KS-like stacks:
    Burgers-512, d 200, d 300), the grid form's (0, grid, bytes)
    (``grid_plan``: one block per SM, 132 on an H100 SXM). Rows: the
    fewest in {1, 2,
    4, 8} whose grid ceil(B / rows) fits one block per SM (``sms``, 132 on
    an H100 SXM), else 8; halved while the block's shared memory (lam,
    lam_prev, the stage covectors, the store of every stage's layer inputs
    and covectors, inv and J staged whole, the two-slot weight ring) passes
    MAX_SMEM_BYTES or, above one row, a ring chunk holds fewer than
    MIN_CHUNK_ROWS rows of a layer (Burgers-512 at R 2: one row, so R 1);
    at one row the store then holds fewer stages. All of
    that first with inv and J staged, then (where their two copies do not
    fit, past d ~160 at KS-like stacks) with the reverse reading them from
    device memory. None only for what no kernel takes: a layer wider than
    1024, more than 8 stages or layers. Memoized: every reverse wrapper's
    gate asks it."""
    return _rev_plan(B, d, layer_dims, stages, sms, REV_STEP)


def grad_step_plan(B: int, d: int, layer_dims: Sequence[int], stages: int,
                   sms: int = 132):
    """K12's launch (plan_rev with the forward's regions, C entry point
    pnode_grad_step_plan): (rows per block, grid, shared-memory bytes) for a
    (B, d) shard, or None. ``ark_adj_plan``'s rule on K4's layout (each
    block keeps its stage values and seed beside the larger of the
    forward's and the reverse's scratch), and like K4's the grid form (0,
    grid, bytes) where that layout cannot keep inv and J resident, from d
    GRID_MIN_D up (Burgers-512, d 300; d 200 keeps the row form, which
    reads them in place)."""
    return _rev_plan(B, d, layer_dims, stages, sms, REV_GRAD, GRID_MIN_D)


def forced_rows(d: int, layer_dims: Sequence[int], stages: int,
                grad: bool = False) -> list:
    """The rows per block that a forced launch of K3 (or K12, ``grad``;
    the wrappers' ``rows=``) takes: each R in (1, 2, 4, 8) whose layout
    holds every stage's store, with inv and J staged or in place."""
    dims = [d] + list(layer_dims)
    return [R for R in (1, 2, 4, 8)
            if any(_rev_plan_rows(R, d, dims, stages, stages, grad, res)
                   is not None for res in (True, False))]


@functools.lru_cache(maxsize=16)
def sm_count(device) -> int:
    """SMs of ``device``'s card: what the C plans take their rule from."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_ark_fits(d: int, layer_dims: Sequence[int], stages: int,
                   reverse: bool = True) -> bool:
    """True when the step kernels take this configuration on the H100:
    the forward kernel (K2) when its plan does at one row per block
    (``ark_fwd_plan``), and with ``reverse`` the reverse kernel (K3) too
    when its plan does (``ark_adj_plan``). A plan that takes one row takes
    every batch, so the gate is the plans' own answer: they refuse only a
    layer wider than 1024, more than 8 stages or layers, or a stack that
    does not map the state to itself. The KS config needs 125 KB for K2
    and 142 KB for K3 at one row; at Burgers-512 (512 -> 576 x4 -> 512)
    K2's row plan fills the 227 KB, streaming the operators and weights
    through its ring, and K2 and K3 take the grid form (K3's row plan
    would read inv and J in place). Registers do not bind: each thread
    carries a fixed accumulator tile whatever the widths.
    ``reverse=False`` checks the forward kernel alone."""
    if not 1 <= len(layer_dims) <= MAX_LAYERS or not 1 <= stages <= MAX_STAGES:
        return False
    if layer_dims[-1] != d:
        return False
    if ark_fwd_plan(1, d, layer_dims, stages) is None:
        return False
    return not reverse or ark_adj_plan(1, d, layer_dims, stages) is not None


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
                    activation, what, reverse=True):
    """Validate the operands shared by the forward and reverse step
    kernels; returns (s, B, d, dims). ``reverse=False`` (the forward step)
    asks only that the forward kernel take the configuration."""
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
    if not fused_ark_fits(d, dims[1:], s, reverse):
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
                             weights, biases, activation="relu", sign=-1.0,
                             masks=None):
    """Plain PyTorch version of the fused reverse step (same signature and
    algebraic collapse as the kernel). Returns (lam_prev, (dWs, dbs)).
    ``dt`` is a Python float, or a 0-d tensor whose dtype then rounds every
    coefficient dt * a (K5's plain version). ``masks``: per stage, the
    ReLU decisions ``fused_mlp_bwd_plain`` takes at that stage."""
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
            dyE, dW, db = fused_mlp_bwd_plain(
                Ys[i], sign * uh, weights, biases, activation,
                None if masks is None else masks[i])
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


def reverse_relu_masks(ys, weights, biases):
    """The ReLU decisions z > 0 that ``ark::reverse_step``'s recompute
    (csrc/ark_tiles.cuh ``rev_forward``) takes on fp32 stage values ``ys``
    (..., d), one bool tensor (..., N) per hidden layer: z summed as the
    kernel sums it, k split over ``_split_k(K, N)`` groups (group g one FMA
    chain over k = g, g + G, ... ascending, from 0), the groups' sums added
    in group order, then the bias, and the next layer's input relu(z) in
    fp32. Each FMA is formed in fp64 and rounded to fp32: the product is
    exact there, and the sum's two roundings differ from the FMA's one
    about once in 2^29. A kernel check hands these to the plain version
    (``masks``) where two correct fp32 evaluations part on a unit within
    rounding of 0."""
    lead = tuple(ys.shape[:-1])
    h = ys.reshape(-1, ys.shape[-1]).float()
    out = []
    for W, b in zip(weights[:-1], biases[:-1]):
        K, N = (int(n) for n in W.shape)
        G = _split_k(K, N)
        h64, W64 = h.double(), W.float().double()
        z = None
        for g in range(G):
            acc = torch.zeros(h.shape[0], N, dtype=torch.float32,
                              device=h.device)
            for k in range(g, K, G):
                acc = (h64[:, k:k + 1] * W64[k] + acc.double()).float()
            z = acc if z is None else z + acc
        z = z + b.float()
        mask = z > 0
        out.append(mask.reshape(lead + (N,)))
        h = torch.where(mask, z, torch.zeros_like(z))
    return out


# -- kernel wrapper ---------------------------------------------------------

def fused_ark_step_adj(tableau_static, dt, Ys, lam, J_dense, inv_op,
                       weights, biases, activation="relu", sign=-1.0,
                       rows=0):
    """One fused reverse ARK step. Returns (lam_prev, (dWs, dbs)).

    tableau_static: (a_im, a_ex, b_im, b_ex) as nested Python floats; dt a
    Python float; Ys (s, B, d) the stored stage values; lam (B, d); J_dense
    and inv_op (d, d). CUDA tensors launch the kernel in its plan's form
    (``ark_adj_plan``), or for kernel comparisons the row form at ``rows``
    1, 2, 4 or 8 forced; CPU tensors run ``fused_ark_step_adj_plain``.
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
    with torch.cuda.device(lam.device):
        return run_ark_adj(_build.library(), sm_count(lam.device),
                           _build.stream_of(lam), tableau_static, dt, Ys,
                           lam, J_dense, inv_op, weights, biases, activation,
                           sign, rows)


def adj_scratch_floats(B, d, layer_dims, stages, sms=132, rows=0):
    """Floats of K3's scratch: the row form's dW/db partials (its grid
    times the stack's parameters), or the grid form's workspace."""
    dims = [d] + list(layer_dims)
    plan = (ark_adj_plan(B, d, layer_dims, stages, sms) if rows == 0
            else (rows, -(-B // rows)))
    if plan[0] == 0:
        return grid_plan(GRID_STEP, B, d, layer_dims, stages, sms)[2]
    return plan[1] * grad_buffer_size(dims)


def run_ark_adj(lib, sms, stream, tableau_static, dt, Ys, lam, J_dense,
                inv_op, weights, biases, activation, sign, rows, grid=0):
    """``fused_ark_step_adj``'s launch through ``lib`` (the kernel library)
    on a card of ``sms`` SMs, operands validated: the scratch of the
    plan's form, one C call on ``stream``. ``grid`` (kernel comparisons
    only): the grid form on that many co-resident blocks, not the plan's
    (the outputs' bits do not depend on it)."""
    B, d = (int(x) for x in lam.shape)
    s = len(tableau_static[2])
    dims = [d] + [int(w.shape[1]) for w in weights]
    if rows not in (0, 1, 2, 4, 8) or grid < 0 or (rows and grid):
        raise ValueError("fused_ark_step_adj: rows must be 0, 1, 2, 4 or 8 "
                         "and grid 0 or positive (the grid form's), not both")
    total = grad_buffer_size(dims)
    lam_prev = torch.empty_like(lam)
    scratch = torch.empty(adj_scratch_floats(B, d, dims[1:], s, sms, rows),
                          dtype=lam.dtype, device=lam.device)
    grads = torch.empty(total, dtype=lam.dtype, device=lam.device)
    rc = lib.pnode_ark_adj(
        Ys.data_ptr(), lam.data_ptr(), J_dense.data_ptr(),
        inv_op.data_ptr(), lam_prev.data_ptr(), scratch.data_ptr(),
        grads.data_ptr(), B, d, s, tableau_array(tableau_static),
        float(dt), float(sign), len(weights), _build.int_array(dims),
        _build.ptr_array(weights), _build.ptr_array(biases),
        _ACT_CODES[activation], int(rows), int(grid), scratch.numel(),
        stream)
    _build.check(rc, "fused_ark_step_adj kernel")
    fused_ark_step_adj.launches += 1
    return lam_prev, split_grads(grads, dims)


def c_grid_plan(kind, B, d, layer_dims, stages, device):
    """The C grid plan's (grid, shared-memory bytes, workspace floats) of
    ``kind`` (GRID_KINDS) on ``device``'s card: what
    ``grid_plan`` mirrors."""
    import ctypes

    lib = _build.library()
    dims = [d] + list(layer_dims)
    grid = _build.int_array([0])
    smem, ws = (ctypes.c_longlong * 1)(0), (ctypes.c_longlong * 1)(0)
    with torch.cuda.device(device):
        rc = lib.pnode_ark_grid_plan(kind, B, d, stages, len(layer_dims),
                                     _build.int_array(dims), grid, smem, ws)
    return None if rc else (grid[0], smem[0], ws[0])


def c_grid_phases(kind, B, d, layer_dims, tableau_static, k=1):
    """The C generator's phases (pnode_ark_grid_phases, run on the host:
    no launch), decoded into ``grid_phases``' form for comparison with the
    mirror. The workspace and operands are named by addresses that are
    never read."""
    import ctypes

    lib = _build.library()
    s, n = len(tableau_static[2]), len(layer_dims)
    dims = [d] + list(layer_dims)
    regions, total = grid_workspace(kind, B, d, layer_dims, s)
    names = ["ws", "J", "inv", "y", "ys"] + [f"W{l}" for l in range(n)] + [
        f"b{l}" for l in range(n)]
    base = {name: (j + 1) << 36 for j, name in enumerate(names)}
    ptrs = lambda pre: (ctypes.c_void_p * n)(  # noqa: E731
        *[base[f"{pre}{l}"] for l in range(n)])
    cap, width = 64 * (n + 2) * (s + 2), 20
    rec = (ctypes.c_longlong * (cap * width))()
    count = _build.int_array([0])
    rc = lib.pnode_ark_grid_phases(
        kind, B, d, s, n, _build.int_array(dims),
        tableau_array(tableau_static), k, base["ws"], base["J"],
        base["inv"], base["y"], base["ys"], ptrs("W"), ptrs("b"), rec, cap,
        count)
    _build.check(rc, "pnode_ark_grid_phases")

    def where(addr):
        if addr == 0:
            return None
        name = max((nm for nm in base if base[nm] <= addr),
                   key=lambda nm: base[nm])
        off = (addr - base[name]) // 4
        if name != "ws":
            return (name, off)
        for region, (o, floats) in regions.items():
            if o <= off < o + floats:
                return (region, off - o)
        raise AssertionError(f"address {addr} outside the workspace")

    phases = []
    for r in range(count[0]):
        (ph, pre, epi, stage, layer, M, N, K, G, v, ones, akm, bkm, lda, ldb,
         ldo, a, b, out, aux) = rec[r * width:(r + 1) * width]
        if ph == len(phases):
            phases.append(dict(pre=GRID_PRES[pre], products=[]))
        if epi < 0:
            continue
        phases[ph]["products"].append(dict(
            epi=GRID_EPIS[epi], stage=stage, layer=layer, M=M, N=N, K=K,
            G=G, v=v, ones=ones, ldo=ldo, a=where(a) + (lda, akm),
            b=where(b) + (ldb, bkm), out=where(out), aux=where(aux)))
    return phases


def plan(B, d, layer_dims, stages, device, grad=False):
    """The C plan's (rows per block, grid, shared-memory bytes) of K3 (or
    of K12, ``grad``) on ``device``'s card: what ``ark_adj_plan`` (or
    ``grad_step_plan``) mirrors."""
    import ctypes

    lib = _build.library()
    dims = [d] + list(layer_dims)
    rows, grid, smem = (_build.int_array([0]), _build.int_array([0]),
                        (ctypes.c_longlong * 1)(0))
    fn = lib.pnode_grad_step_plan if grad else lib.pnode_ark_adj_plan
    with torch.cuda.device(device):
        rc = fn(B, d, stages, len(layer_dims), _build.int_array(dims), rows,
                grid, smem)
    return None if rc else (rows[0], grid[0], smem[0])


fused_ark_step_adj.launches = 0
