"""K10 and K11: the periodic k-point stencil along the last axis.

Replaces ``pnode_tpu/ops/circular_stencil.py`` ``_fwd_kernel`` (:32) and
``_bwd_kernel`` (:41). The CUDA source is ``csrc/circular_stencil.cu``; its
note says what bounds it on the H100 and what the design does about that.

- ``circular_stencil(y, kernel)`` computes
  ``out[..., i] = sum_j kernel[j] * y[..., (i + j - k//2) mod N]`` with the
  leading dimensions flattened to rows. It is differentiable: a
  ``torch.autograd.Function`` whose forward is K10 and whose backward is
  K11 (dy, the flipped stencil, and dw, k shifted inner products, skipped
  when the stencil needs no gradient). The op is linear, so its forward-mode
  rule (``jvp``) is the same op on the tangent, and its ``vmap`` rule folds
  the vmapped dimension into rows and launches once: ``torch.func.jacfwd``
  (the dense Jacobian of ``linsolve.assemble_block_jacobian``) runs through
  the kernel. The JAX op is a ``custom_vjp`` without forward mode, so there
  the frozen Jacobian always comes from the roll chain; the computed
  function and its VJP are the same.
- ``circular_stencil_fwd`` / ``circular_stencil_bwd`` check their inputs
  and, for CUDA float32 tensors, launch the kernel (and count the launch)
  or raise: one launch per call in every mode, K11's dw summed inside it.
  CPU tensors of any floating dtype run the plain versions
  ``circular_stencil_plain`` (the roll chain) and
  ``circular_stencil_bwd_plain``, which are what the kernels are compared
  with on the card. Any other dtype or device raises: there is no fallback.
- ``stencil_plan`` mirrors the C plan (``plan`` asks the C one): the body
  (the register tile or the staged rows), rows per warp, rows per block and
  grid.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

TILE_MAX_CHUNKS = 4   # float4s of a row one lane holds: 16 floats
TILE_MAX_TAPS = 9     # k/2 and k-1-k/2 within one neighbouring float4
TILE_MAX_WARPS = 8
STAGE_ELEMS = 1024    # elements of a staged block's rows
MAX_STAGE_ROWS = 64


def tile_lanes(n: int) -> int:
    """Lanes per row of the register tile at row length ``n``: the largest
    power of two <= 32 dividing N/4, where that leaves each lane 1, 2 or 4
    float4s; 0 where the tile does not take N."""
    if n % 4:
        return 0
    v4 = n // 4
    lanes = 32
    while v4 % lanes:
        lanes //= 2
    chunks = v4 // lanes
    return lanes if chunks <= TILE_MAX_CHUNKS and chunks & (chunks - 1) == 0 \
        else 0


def stencil_plan(rows: int, n: int, k: int, sms: int, aligned: bool = True,
                 need_dw: bool = False):
    """The C plan (csrc/circular_stencil.cu ``make_plan``) of K10 and K11
    at (rows, N), k taps, on a card of ``sms`` SMs, the operands 16-byte
    aligned or not, with or without K11's dw: (body, rows per warp, rows
    per block, grid). Body 1 is the register tile, a row on
    ``tile_lanes(N)`` lanes, with 8, 4, 2 or 1 warps a block, the most that
    keep a block per SM, and 8 with dw (fewer blocks take the last block's
    ticket); body 0 the staged rows (rows per warp 0), ~1024 elements a
    block."""
    lanes = tile_lanes(n) if aligned and k <= TILE_MAX_TAPS else 0
    if lanes:
        per_warp = 32 // lanes
        warps = -(-rows // per_warp)
        w = TILE_MAX_WARPS
        while not need_dw and w > 1 and -(-warps // w) < sms:
            w //= 2
        return 1, per_warp, w * per_warp, -(-warps // w)
    rpb = max(1, min(MAX_STAGE_ROWS, STAGE_ELEMS // n))
    return 0, 0, rpb, -(-rows // rpb)


def plan(rows: int, n: int, k: int, device, aligned: bool = True,
         need_dw: bool = False):
    """The C plan on ``device``'s card: what ``stencil_plan`` mirrors."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _build.library().pnode_stencil_plan(rows, n, k, int(aligned),
                                                 int(need_dw), out)
    _build.check(rc, "circular_stencil plan")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _dw_words(device_index, rows, n, k, aligned):
    """4-byte words of K11's dw scratch at this shape: the counter's 4, then
    k partials per block of the C plan's grid."""
    return 4 + k * plan(rows, n, k, device_index, aligned, True)[3]


# (device index, stream handle) -> int32 zeros: K11's dw counter (word 0,
# which every dw launch leaves at 0) and its partials (from word 4).
# Launches on one stream run one after another, so no two in flight share
# a counter.
_dw_scratch: dict = {}


def dw_scratch(device, stream: int, words: int) -> torch.Tensor:
    """K11's dw scratch for ``stream`` on ``device``, at least ``words``
    long: allocated once, zeroed on that stream (the current one), grown
    when a larger grid needs more, never cleared again."""
    key = (device.index, stream)
    buf = _dw_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        _dw_scratch[key] = buf
    return buf


# -- plain PyTorch versions -------------------------------------------------

def circular_stencil_plain(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The roll chain: out[..., i] = sum_j w[j] y[..., (i + j - k//2) mod N],
    summed over j in order (what K10 computes, in the same order)."""
    k = int(w.shape[0])
    half = k // 2
    out = w[0] * torch.roll(y, half, dims=-1)
    for j in range(1, k):
        out = out + w[j] * torch.roll(y, half - j, dims=-1)
    return out


def circular_stencil_bwd_plain(y, g, w, need_dw: bool = True):
    """(dy, dw) of <g, stencil(y, w)>, as the JAX kernel writes them:
    dy[..., i] = sum_j w[j] g[..., (i - j + k//2) mod N] (the flipped
    stencil, summed over j in order) and dw[j] = sum(g * roll(y, k//2 - j));
    dw is None when ``need_dw`` is False."""
    k = int(w.shape[0])
    half = k // 2
    dy = w[0] * torch.roll(g, -half, dims=-1)
    for j in range(1, k):
        dy = dy + w[j] * torch.roll(g, j - half, dims=-1)
    dw = None
    if need_dw:
        dw = torch.stack([torch.sum(g * torch.roll(y, half - j, dims=-1))
                          for j in range(k)])
    return dy, dw


# -- kernel wrappers --------------------------------------------------------

def _check(y, w, what, g=None):
    """Validate (rows, N) operands (y and, given, g) and a (k,) stencil;
    return (rows, n, k, on the card)."""
    ops = (("y", y, 2), ("w", w, 1)) if g is None else (
        ("y", y, 2), ("w", w, 1), ("g", g, 2))
    for name, t, ndim in ops:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.dim() != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    dev, dtype = y.device, y.dtype
    for name, t, _ in ops[1:]:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
    kind = dev.type
    if kind == "cuda":
        if dtype != torch.float32:
            raise ValueError(f"{what}: the kernel takes float32 CUDA tensors, "
                             f"got {dtype}")
    elif kind != "cpu":
        raise ValueError(f"{what}: unsupported device {dev}")
    elif not y.is_floating_point():
        raise ValueError(f"{what}: y must be floating point, got {dtype}")
    rows, n = y.shape
    k = w.shape[0]
    if n < 1 or k < 1:
        raise ValueError(f"{what}: needs N >= 1 and k >= 1, got N {n}, k {k}")
    if rows * n >= 2**31:
        raise ValueError(f"{what}: {rows} x {n} elements exceed the kernel's "
                         "32-bit indexing")
    return rows, n, k, kind == "cuda"


def _on_device(device, fn, *args):
    """fn(*args) with ``device`` current, entered only when it is not (the
    operands are on the card, so CUDA is initialised: the raw getter)."""
    if device.index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def circular_stencil_fwd(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """stencil(y (rows, N), w (k,)) through K10 (CUDA) or the plain version
    (CPU)."""
    rows, n, k, cuda = _check(y, w, "circular_stencil_fwd")
    if not cuda:
        return circular_stencil_plain(y, w)
    out = torch.empty_like(y)
    if rows == 0:
        return out
    rc = _on_device(y.device, _build.library().pnode_stencil_fwd,
                    y.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k,
                    _build.stream_of(y))
    _build.check(rc, "circular_stencil_fwd kernel")
    circular_stencil_fwd.launches += 1
    return out


circular_stencil_fwd.launches = 0


def circular_stencil_bwd(y: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                         need_dw: bool = True):
    """(dy, dw) of <g, stencil(y, w)> through K11 (CUDA) or the plain
    version (CPU); dw is None when ``need_dw`` is False (a fixed stencil:
    the kernel then skips its dw pass). One launch either way: with dw,
    the blocks' partials are summed by the last block to finish, in
    ``dw_scratch``."""
    rows, n, k, cuda = _check(y, w, "circular_stencil_bwd", g)
    if g.shape != y.shape:
        raise ValueError(f"circular_stencil_bwd: g must be {tuple(y.shape)}, "
                         f"got {tuple(g.shape)}")
    if not cuda:
        return circular_stencil_bwd_plain(y, g, w, need_dw)
    dy = torch.empty_like(y)
    if rows == 0:
        return dy, (torch.zeros_like(w) if need_dw else None)
    lib = _build.library()
    stream = _build.stream_of(y)
    dw, scratch, words = None, None, 0
    ptrs = (y.data_ptr(), g.data_ptr(), dy.data_ptr())
    if need_dw:
        dw = torch.empty_like(w)
        aligned = (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0
        words = _dw_words(y.device.index, rows, n, k, aligned)
        scratch = dw_scratch(y.device, stream, words).data_ptr()
    rc = _on_device(y.device, lib.pnode_stencil_bwd, ptrs[0], ptrs[1],
                    w.data_ptr(), ptrs[2], dw.data_ptr() if need_dw else None,
                    scratch, words, rows, n, k, int(need_dw), stream)
    _build.check(rc, "circular_stencil_bwd kernel")
    circular_stencil_bwd.launches += 1
    return dy, dw


circular_stencil_bwd.launches = 0


class _CircularStencil(torch.autograd.Function):
    """K10 forward, K11 backward, and the rules torch.func needs: the op is
    linear in each argument, so a tangent goes through the op itself; under
    vmap the vmapped dimension joins the rows (one launch)."""

    @staticmethod
    def forward(y2, w):
        return circular_stencil_fwd(y2, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y2, w = inputs
        ctx.save_for_backward(y2, w)
        ctx.save_for_forward(y2, w)

    @staticmethod
    def backward(ctx, g):
        y2, w = ctx.saved_tensors
        need_dw = ctx.needs_input_grad[1]
        g = g.contiguous()
        if _wrapped(y2, g, w):
            # inside torch.func.vjp / grad the backward sees the transform's
            # wrapped tensors, which have no storage for K11: the op below
            # reaches the kernel with plain ones
            out = _CircularStencilBwd.apply(y2, g, w, need_dw)
            return out if need_dw else (out, None)
        return circular_stencil_bwd(y2, g, w, need_dw=need_dw)

    @staticmethod
    def jvp(ctx, y_t, w_t):
        y2, w = ctx.saved_tensors
        out = None
        if y_t is not None:
            out = _CircularStencil.apply(y_t.contiguous(), w)
        if w_t is not None:
            term = _CircularStencil.apply(y2, w_t.contiguous())
            out = term if out is None else out + term
        return out

    @staticmethod
    def vmap(info, in_dims, y2, w):
        y_dim, w_dim = in_dims
        if w_dim is None:
            yb = y2.movedim(y_dim, 0)
            out = _CircularStencil.apply(
                yb.reshape(-1, yb.shape[-1]).contiguous(), w)
            return out.reshape(yb.shape), 0
        # a batch of stencils (rare: torch.func over the taps): one launch
        # per stencil
        ws = w.movedim(w_dim, 0)
        ys = y2.movedim(y_dim, 0) if y_dim is not None else None
        outs = [_CircularStencil.apply(
            (y2 if ys is None else ys[b]).contiguous(), ws[b].contiguous())
            for b in range(info.batch_size)]
        return torch.stack(outs), 0


def _wrapped(*ts):
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts)


class _CircularStencilBwd(torch.autograd.Function):
    """K11 as an op of its own: (dy, dw) of <g, stencil(y2, w)>, or dy
    alone without ``need_dw``. torch.func hands an autograd.Function's
    forward plain tensors, so _CircularStencil's backward goes through this
    op where it runs inside a transform (the adjoint's transposed GMRES
    applies J^T v through torch.func.vjp). Under vmap a batch folds into
    the rows for dy alone and loops otherwise (dw sums over the rows).
    Its own backward is not ported: the port differentiates the stencil
    once in reverse mode."""

    @staticmethod
    def forward(y2, g, w, need_dw):
        dy, dw = circular_stencil_bwd(y2, g, w, need_dw=need_dw)
        return (dy, dw) if need_dw else dy

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the circular stencil's second derivative in reverse mode is not "
            "ported")

    @staticmethod
    def vmap(info, in_dims, y2, g, w, need_dw):
        y_dim, g_dim, w_dim = in_dims[:3]
        n = g.shape[-1]
        B = info.batch_size

        def take(t, d, b):
            return (t if d is None else t.movedim(d, 0)[b]).contiguous()

        if not need_dw and w_dim is None:
            # dy = S^T g needs no y: the folded g stands in for it
            gb = (g.movedim(g_dim, 0) if g_dim is not None
                  else g.expand(B, *g.shape))
            flat = gb.reshape(-1, n).contiguous()
            dy = _CircularStencilBwd.apply(flat, flat, w, False)
            return dy.reshape(gb.shape), 0
        outs = [_CircularStencilBwd.apply(take(y2, y_dim, b),
                                          take(g, g_dim, b),
                                          take(w, w_dim, b), need_dw)
                for b in range(B)]
        if need_dw:
            return ((torch.stack([o[0] for o in outs]),
                     torch.stack([o[1] for o in outs])), (0, 0))
        return torch.stack(outs), 0


def circular_stencil(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable periodic cross-correlation along the last axis through
    K10/K11: y (..., N), kernel (k,) (cast to y's dtype, as the JAX op
    does; a stencil already in y's dtype is used as it is, with no copy)."""
    n = y.shape[-1]
    k = int(kernel.shape[0])
    y2 = y.reshape(-1, n).contiguous()
    w = kernel.reshape(k).to(y.dtype).contiguous()
    return _CircularStencil.apply(y2, w).reshape(y.shape)
