"""The port's circular stencil (K10/K11's plain versions inside their
autograd Function) against the JAX package's stencil kernel in interpret
mode and the roll chain.

Taps are random and asymmetric: both fixed stencils (KS, Burgers) are
symmetric, so a reversed tap order or a roll in the wrong direction would
pass on them unseen. Tolerances: fp64 rtol 1e-12 of max |ref| (the same
sums in another association at most); fp32 forward and dy 2e-6 of max |ref|
(tests/test_ops.py's), dw 1e-5 of max |ref| (k sums over rows x N elements,
taken in another order). Jacobians through the op equal the dense
circulant exactly: every coefficient is one tap times one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch.ops.circular_stencil as cs
from pnode_tpu.models.sinode import circular_stencil_apply as j_roll_chain
from pnode_tpu.ops.circular_stencil import circular_stencil as j_stencil
from pnode_tpu_torch.ops import _build
from pnode_tpu_torch.ops.circular_stencil import (
    circular_stencil, circular_stencil_bwd, circular_stencil_bwd_plain,
    circular_stencil_fwd, circular_stencil_plain)

torch.set_num_threads(1)
DTYPES = {"fp32": (np.float32, torch.float32, 2e-6, 1e-5),
          "fp64": (np.float64, torch.float64, 1e-12, 1e-12)}


def _case(seed, rows, n, k, np_dtype):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(rows, n)).astype(np_dtype)
    g = rng.normal(size=(rows, n)).astype(np_dtype)
    w = rng.uniform(-1.0, 1.0, size=k).astype(np_dtype)
    return y, g, w


def _circulant(w, n):
    """C with (y @ C.T)[i] = sum_j w[j] y[(i + j - k//2) mod n]."""
    C = np.zeros((n, n))
    k = len(w)
    for i in range(n):
        for j in range(k):
            C[i, (i + j - k // 2) % n] += w[j]
    return C


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [64, 512, 100])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_forward_dy_dw_match_jax_kernel(k, n, dtype):
    np_dt, t_dt, tol, tol_dw = DTYPES[dtype]
    y, g, w = _case(k * 1000 + n, 6, n, k, np_dt)
    jy, jw, jg = jnp.asarray(y), jnp.asarray(w), jnp.asarray(g)
    ref, vjp = jax.vjp(lambda a, b: j_stencil(a, b, interpret=True), jy, jw)
    ref_dy, ref_dw = vjp(jg)
    yt = torch.from_numpy(y).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = circular_stencil(yt, wt)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), ref, tol)
    _close(yt.grad, ref_dy, tol)
    _close(wt.grad, ref_dw, tol_dw)
    # the plain versions are the roll chain, summed in the same order
    _close(circular_stencil_plain(yt.detach(), wt.detach()),
           j_roll_chain(jy, jw), tol)
    dy, dw = circular_stencil_bwd_plain(yt.detach(), torch.from_numpy(g),
                                        wt.detach())
    assert torch.equal(dy, yt.grad) and torch.equal(dw, wt.grad)


@pytest.mark.parametrize("n, k", [(64, 5), (9, 7), (4, 11)])
def test_jacfwd_through_the_op_is_the_dense_circulant(n, k):
    """torch.func.jacfwd (the port's Jacobian assembly) through the op's
    jvp and vmap rules equals the dense circulant and JAX's jacfwd of the
    roll chain exactly, also when k > N wraps the taps more than once."""
    y, _, w = _case(n + k, 3, n, k, np.float64)
    wt = torch.from_numpy(w)
    J = torch.func.jacfwd(lambda r: circular_stencil(r, wt))(
        torch.from_numpy(y[0]))
    Jj = jax.jacfwd(lambda r: j_roll_chain(r, jnp.asarray(w)))(
        jnp.asarray(y[0]))
    np.testing.assert_array_equal(J.numpy(), _circulant(w, n))
    np.testing.assert_array_equal(J.numpy(), np.asarray(Jj))


def test_jacfwd_of_the_block_solver_matches_the_roll_chain():
    """assemble_block_jacobian's shared block (the frozen J of the IMEX
    step) through the op equals the one through the roll chain bitwise."""
    from pnode_tpu_torch.linsolve import (
        LinearSolveConfig, assemble_block_jacobian)

    B, n = 4, 16
    _, _, w = _case(3, B, n, 3, np.float32)
    wt = torch.from_numpy(w)
    cfg = LinearSolveConfig(kind="block", block_size=n, fixed_jacobian=True)
    y = torch.zeros(B * n)
    J_op = assemble_block_jacobian(
        lambda z: circular_stencil(z.reshape(B, n), wt).reshape(-1), y, cfg,
        shared=True)
    J_roll = assemble_block_jacobian(
        lambda z: circular_stencil_plain(z.reshape(B, n), wt).reshape(-1), y,
        cfg, shared=True)
    assert J_op.dtype == torch.float32
    assert torch.equal(J_op, J_roll)


@pytest.mark.parametrize("in_dim", [0, 1, 2])
def test_vmap_folds_the_batch_into_rows(in_dim, monkeypatch):
    """Under torch.func.vmap the op runs once, on the vmapped dimension
    folded into rows, wherever that dimension sits."""
    calls = []
    real = cs.circular_stencil_fwd

    def spy(y2, w):
        calls.append(tuple(y2.shape))
        return real(y2, w)

    monkeypatch.setattr(cs, "circular_stencil_fwd", spy)
    y, _, w = _case(in_dim, 5 * 3, 12, 5, np.float64)
    batch = torch.from_numpy(y).reshape(5, 3, 12).movedim(0, in_dim)
    wt = torch.from_numpy(w)
    out = torch.func.vmap(lambda r: circular_stencil(r, wt),
                          in_dims=in_dim)(batch)
    assert calls == [(15, 12)]
    ref = circular_stencil_plain(batch.movedim(in_dim, 0), wt)
    assert torch.equal(out, ref)


def test_vmap_over_stencils():
    y, _, _ = _case(5, 2, 10, 3, np.float64)
    ws = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 3)))
    yt = torch.from_numpy(y)
    out = torch.func.vmap(lambda w: circular_stencil(yt, w))(ws)
    for b in range(4):
        assert torch.equal(out[b], circular_stencil_plain(yt, ws[b]))


def test_fixed_stencil_skips_the_dw_pass(monkeypatch):
    seen = []
    real = cs.circular_stencil_bwd

    def spy(y2, g, w, need_dw=True):
        seen.append(need_dw)
        return real(y2, g, w, need_dw)

    monkeypatch.setattr(cs, "circular_stencil_bwd", spy)
    y, g, w = _case(7, 4, 20, 5, np.float64)
    yt = torch.from_numpy(y).requires_grad_(True)
    (circular_stencil(yt, torch.from_numpy(w)) * torch.from_numpy(g)).sum(
    ).backward()
    assert seen == [False]
    dy, dw = real(torch.from_numpy(y), torch.from_numpy(g),
                  torch.from_numpy(w), need_dw=False)
    assert dw is None and torch.equal(dy, yt.grad)


class _CudaStyle(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrappers see for a
    tensor on the card (none is present here)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_style(a):
    return torch.Tensor._make_subclass(_CudaStyle, torch.from_numpy(a))


def test_wrappers_raise_on_what_the_kernels_do_not_take(monkeypatch):
    y, g, w = _case(8, 3, 8, 3, np.float64)
    with pytest.raises(ValueError, match="float32 CUDA"):
        circular_stencil_fwd(_cuda_style(y), _cuda_style(w))
    with pytest.raises(ValueError, match="float32 CUDA"):
        circular_stencil_bwd(_cuda_style(y), _cuda_style(g), _cuda_style(w))
    meta = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        circular_stencil_fwd(meta, torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        circular_stencil_fwd(torch.zeros(8, 3).T, torch.zeros(3))
    with pytest.raises(ValueError, match="float64"):
        circular_stencil_fwd(torch.zeros(3, 8), torch.zeros(3).double())
    with pytest.raises(ValueError, match="must be"):
        circular_stencil_bwd(torch.zeros(3, 8), torch.zeros(3, 7),
                             torch.zeros(3))
    # fp32 on the card goes to the kernel: no plain fallback
    monkeypatch.setattr(_build, "library", lambda: (_ for _ in ()).throw(
        RuntimeError("no kernel library here")))
    y32, g32, w32 = (_cuda_style(a.astype(np.float32)) for a in (y, g, w))
    for call in (lambda: circular_stencil_fwd(y32, w32),
                 lambda: circular_stencil_bwd(y32, g32, w32)):
        with pytest.raises(RuntimeError, match="no kernel library"):
            call()
    assert circular_stencil_fwd.launches == 0
    assert circular_stencil_bwd.launches == 0


@pytest.mark.parametrize("k", [3, 5, 7])
def test_library_conv1d_computes_the_same_function(k):
    """nn.Conv1d with circular padding k//2 (the library call chip_smoke
    times beside K10/K11; the port never calls it) is the same
    cross-correlation, taps in the same direction."""
    y, g, w = _case(9 + k, 5, 33, k, np.float64)
    conv = torch.nn.Conv1d(1, 1, k, padding=k // 2, padding_mode="circular",
                           bias=False, dtype=torch.float64)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).reshape(1, 1, k))
    yt = torch.from_numpy(y).requires_grad_(True)
    out = conv(yt[:, None])[:, 0]
    out.backward(torch.from_numpy(g))
    ref = circular_stencil_plain(torch.from_numpy(y), torch.from_numpy(w))
    dy, dw = circular_stencil_bwd_plain(torch.from_numpy(y),
                                        torch.from_numpy(g),
                                        torch.from_numpy(w))
    _close(out.detach(), ref, 1e-12)
    _close(yt.grad, dy, 1e-12)
    _close(conv.weight.grad.reshape(k), dw, 1e-12)


@pytest.mark.parametrize("mode", ["vjp", "vjp with dw", "jacrev",
                                  "vmap of vjp with dw", "autograd"])
def test_k11_gets_plain_tensors_under_torch_func(mode, monkeypatch):
    """K11 takes raw pointers, so inside torch.func (the transposed GMRES's
    vjp, jacrev) the backward must reach circular_stencil_bwd with plain
    tensors, not the transform's wrappers, and give the roll chain's
    adjoint (dy bitwise equal to the plain K11, dw to 1e-12)."""
    y, g, w = (torch.from_numpy(a) for a in _case(41, 4, 16, 5,
                                                  np.float64))
    orig = cs.circular_stencil_bwd
    seen = []

    def spy(yy, gg, ww, need_dw=True):
        seen.append(any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                        for t in (yy, gg, ww)))
        return orig(yy, gg, ww, need_dw)

    monkeypatch.setattr(cs, "circular_stencil_bwd", spy)
    dy_ref, dw_ref = circular_stencil_bwd_plain(y, g, w)
    if mode == "vjp":
        (dy,) = torch.func.vjp(lambda yy: cs.circular_stencil(yy, w), y)[1](g)
        assert torch.equal(dy, dy_ref)
    elif mode == "vjp with dw":
        dy, dw = torch.func.vjp(cs.circular_stencil, y, w)[1](g)
        assert torch.equal(dy, dy_ref)
        _close(dw, dw_ref, 1e-12)
    elif mode == "jacrev":
        J = torch.func.jacrev(lambda r: cs.circular_stencil(r, w))(y[0])
        _close(J, torch.func.jacfwd(
            lambda r: circular_stencil_plain(r, w))(y[0]), 1e-12)
    elif mode == "vmap of vjp with dw":
        gs = torch.stack([g, 2.0 * g])
        dys, dws = torch.func.vmap(
            lambda gg: torch.func.vjp(cs.circular_stencil, y, w)[1](gg))(gs)
        assert torch.equal(dys[0], dy_ref)
        _close(dws[1], 2.0 * dw_ref, 1e-12)
    else:
        yr, wr = y.clone().requires_grad_(), w.clone().requires_grad_()
        cs.circular_stencil(yr, wr).backward(g)
        assert torch.equal(yr.grad, dy_ref)
        _close(wr.grad, dw_ref, 1e-12)
    assert seen and not any(seen)
