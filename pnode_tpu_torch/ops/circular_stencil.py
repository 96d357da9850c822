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
  or raise. CPU tensors of any floating dtype run the plain versions
  ``circular_stencil_plain`` (the roll chain) and
  ``circular_stencil_bwd_plain``, which are what the kernels are compared
  with on the card. Any other dtype or device raises: there is no fallback.
"""

from __future__ import annotations

import torch

from . import _build

# elements of one block's row tile (csrc/circular_stencil.cu): ~4 per thread
TILE_ELEMS = 1024
MAX_ROWS_PER_BLOCK = 64


def rows_per_block(n: int) -> int:
    """Rows of one block's tile at row length ``n``."""
    return max(1, min(MAX_ROWS_PER_BLOCK, TILE_ELEMS // n))


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

def _check(y, w, what, others=()):
    """Validate (rows, N) operands and a (k,) stencil; return (rows, n, k)."""
    for name, t, ndim in (("y", y, 2), ("w", w, 1)) + tuple(others):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.dim() != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {y.dtype} on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if y.device.type == "cpu":
        if not y.is_floating_point():
            raise ValueError(f"{what}: y must be floating point, got "
                             f"{y.dtype}")
    elif y.device.type == "cuda":
        if y.dtype != torch.float32:
            raise ValueError(f"{what}: the kernel takes float32 CUDA tensors, "
                             f"got {y.dtype}")
    else:
        raise ValueError(f"{what}: unsupported device {y.device}")
    rows, n, k = int(y.shape[0]), int(y.shape[1]), int(w.shape[0])
    if n < 1 or k < 1:
        raise ValueError(f"{what}: needs N >= 1 and k >= 1, got N {n}, k {k}")
    if rows * n >= 2**31:
        raise ValueError(f"{what}: {rows} x {n} elements exceed the kernel's "
                         "32-bit indexing")
    return rows, n, k


def circular_stencil_fwd(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """stencil(y (rows, N), w (k,)) through K10 (CUDA) or the plain version
    (CPU)."""
    rows, n, k = _check(y, w, "circular_stencil_fwd")
    if y.device.type == "cpu":
        return circular_stencil_plain(y, w)
    out = torch.empty_like(y)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(y.device):
        rc = lib.pnode_stencil_fwd(y.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   rows, n, k, rows_per_block(n),
                                   _build.stream_of(y))
    _build.check(rc, "circular_stencil_fwd kernel")
    circular_stencil_fwd.launches += 1
    return out


circular_stencil_fwd.launches = 0


def circular_stencil_bwd(y: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                         need_dw: bool = True):
    """(dy, dw) of <g, stencil(y, w)> through K11 (CUDA) or the plain
    version (CPU); dw is None when ``need_dw`` is False (a fixed stencil:
    the kernel then skips its dw pass)."""
    rows, n, k = _check(y, w, "circular_stencil_bwd", (("g", g, 2),))
    if tuple(g.shape) != tuple(y.shape):
        raise ValueError(f"circular_stencil_bwd: g must be {tuple(y.shape)}, "
                         f"got {tuple(g.shape)}")
    if y.device.type == "cpu":
        return circular_stencil_bwd_plain(y, g, w, need_dw)
    dy = torch.empty_like(y)
    dw = torch.zeros_like(w) if need_dw else None
    if rows == 0:
        return dy, dw
    lib = _build.library()
    rpb = rows_per_block(n)
    nblk = -(-rows // rpb)
    partial = (torch.empty(nblk * k, dtype=y.dtype, device=y.device)
               if need_dw else dy)  # unread without the dw pass
    with torch.cuda.device(y.device):
        rc = lib.pnode_stencil_bwd(
            y.data_ptr(), g.data_ptr(), w.data_ptr(), dy.data_ptr(),
            partial.data_ptr(), dw.data_ptr() if need_dw else None, rows, n,
            k, rpb, int(need_dw), _build.stream_of(y))
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
        return circular_stencil_bwd(y2, g.contiguous(), w,
                                    need_dw=ctx.needs_input_grad[1])

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


def circular_stencil(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable periodic cross-correlation along the last axis through
    K10/K11: y (..., N), kernel (k,) (cast to y's dtype, as the JAX op
    does)."""
    n = y.shape[-1]
    k = int(kernel.shape[0])
    y2 = y.reshape(-1, n).contiguous()
    w = kernel.reshape(k).to(y.dtype).contiguous()
    return _CircularStencil.apply(y2, w).reshape(y.shape)
