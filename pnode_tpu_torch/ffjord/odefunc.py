"""CNF dynamics nets and divergence estimators.

Counterpart of ``pnode_tpu/ffjord/odefunc.py`` (the reference's
``odefunc.py``): the ODEnet stack of time-dependent layers, the autoencoder
split of it, the exact (brute-force) divergence, the Hutchinson estimator
and its probe.

The Hutchinson term ``e . (J e)`` is one forward-mode product, as in the
JAX package (``jax.jvp``): here ``torch.autograd.forward_ad`` dual tensors,
which compose with the reverse mode that the port's adjoint takes of the
whole dynamics (``steppers._vjp``), so the adjoint differentiates through
the jvp (reverse over forward). The brute-force divergence is
``torch.func.vmap`` over samples of ``torch.func.jacfwd`` of a one-row
call, the JAX package's ``vmap(jacfwd)``: a layer sees the batch of one
that it sees there.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch import nn

from .layers import build_diffeq_layer

NONLINEARITIES = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "softplus": F.softplus,
    "elu": F.elu,
    "swish": F.silu,
    "square": lambda x: x ** 2,
    "identity": lambda x: x,
}


class ODEnet(nn.Module):
    """Stack of time-dependent layers: the hidden widths, then a map back
    to ``input_dim``; the nonlinearity between layers, not after the
    last."""

    def __init__(self, hidden_dims: Sequence[int], input_dim: int,
                 layer_type: str = "concatsquash",
                 nonlinearity: str = "softplus"):
        super().__init__()
        self.act = NONLINEARITIES[nonlinearity]
        dims = (input_dim,) + tuple(hidden_dims) + (input_dim,)
        self.layers = nn.ModuleList(
            build_diffeq_layer(layer_type, a, b)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, t, y):
        h = y
        for layer in self.layers[:-1]:
            h = self.act(layer(t, h))
        return self.layers[-1](t, h)


class AutoencoderDiffEqNet(nn.Module):
    """Encoder/decoder split of the dynamics net for a divergence estimate
    through the bottleneck: the first ``len(hidden_dims)//2 + 1`` layers
    encode (nonlinearity after every one), the rest decode (nonlinearity
    between, not after the last). ``forward`` returns ``(h, dy)``."""

    def __init__(self, hidden_dims: Sequence[int], input_dim: int,
                 layer_type: str = "concat", nonlinearity: str = "softplus"):
        super().__init__()
        if layer_type not in ("ignore", "hyper", "concat", "concatcoord",
                              "blend"):
            raise ValueError(
                f"layer_type {layer_type!r} unsupported for the autoencoder "
                "net (reference odefunc.py:362)")
        self.act = NONLINEARITIES[nonlinearity]
        dims = tuple(hidden_dims) + (input_dim,)
        n_enc = len(hidden_dims) // 2 + 1
        ins = (input_dim,) + dims[:-1]
        self.encoder_layers = nn.ModuleList(
            build_diffeq_layer(layer_type, a, b)
            for a, b in zip(ins[:n_enc], dims[:n_enc]))
        self.decoder_layers = nn.ModuleList(
            build_diffeq_layer(layer_type, a, b)
            for a, b in zip(ins[n_enc:], dims[n_enc:]))
        self.bottleneck_dim = dims[n_enc - 1]

    def encode(self, t, y):
        h = y
        for layer in self.encoder_layers:
            h = self.act(layer(t, h))
        return h

    def decode(self, t, h):
        dy = h
        for i, layer in enumerate(self.decoder_layers):
            dy = layer(t, dy)
            if i < len(self.decoder_layers) - 1:
                dy = self.act(dy)
        return dy

    def forward(self, t, y):
        h = self.encode(t, y)
        return h, self.decode(t, h)


def jvp(fn, x, v, params=None):
    """(fn(x), J_fn(x) v) by forward-mode dual tensors; differentiable by
    reverse mode in everything ``fn`` closes over and in ``x``. With
    ``params`` (a dict of tensors), ``fn(x, params)`` gets them as duals
    with explicit zero tangents: an op between a dual tensor and a plain
    one gives the plain one a ZeroTensor tangent, which PyTorch runs
    through Python reference kernels (~0.2-0.5 ms of host an op against
    ~10 us for two duals), so the net's parameters enter as duals.

    Forward grads are switched on explicitly: the adjoint runs the forward
    solve inside an ``autograd.Function``'s forward, where PyTorch switches
    them off (the tangent would come back None, read as zero). A dual's
    primal must not overlap itself in memory (an expanded x), hence the
    ``contiguous``."""
    with fwAD._set_fwd_grad_enabled(True), fwAD.dual_level():
        xd = fwAD.make_dual(x.contiguous(), v)
        if params is None:
            out = fn(xd)
        else:
            out = fn(xd, {k: fwAD.make_dual(p, torch.zeros_like(p))
                          for k, p in params.items()})
        out = fwAD.unpack_dual(out)
    tangent = out.tangent
    return out.primal, (torch.zeros_like(out.primal) if tangent is None
                        else tangent)


def autoencoder_divergence_fn(encode_closed, decode_closed, y, e,
                              params=None):
    """(dy, the Hutchinson divergence through the bottleneck): with
    J_enc = dh/dy and J_dec = d(dy)/dh the estimate is e^T J_enc J_dec e,
    whose expectation is tr(J_dec J_enc), the divergence of
    decode(encode(y)), with the probe in the bottleneck. Two jvps, as in
    the JAX package. y (B, D), e (B, H). With ``params`` the closures take
    them as a second argument (``jvp``'s zero-tangent duals)."""
    h = encode_closed(y) if params is None else encode_closed(y, params)
    dy, w = jvp(decode_closed, h, e, params)       # w  = J_dec e   (B, D)
    _, Jw = jvp(encode_closed, y, w, params)       # Jw = J_enc w   (B, H)
    return dy, torch.sum(e * Jw, dim=-1)


def divergence_approx_fn(f_closed, z, e, params=None):
    """Hutchinson estimator: (dz, e . (J e)) per sample, by one jvp."""
    dz, Je = jvp(f_closed, z, e, params)
    return dz, torch.sum(e * Je, dim=-1)


def divergence_bf_fn(f_closed, z):
    """Exact divergence: the trace of each sample's Jacobian, by jacfwd of
    a one-row call, vmapped over the samples."""
    def per_sample(zi):
        J = torch.func.jacfwd(lambda x: f_closed(x[None])[0])(zi)
        return torch.diagonal(J).sum()

    return f_closed(z), torch.func.vmap(per_sample)(z)


def sample_probe(shape, dtype, kind: str = "rademacher", generator=None,
                 device=None):
    """Hutchinson probe, fixed per solve: +-1 (rademacher) or N(0, 1),
    drawn from ``generator`` on the generator's own device (the default
    generator when None) and moved to ``device``: a CPU generator gives
    the same probe on every device. The JAX package draws from
    ``jax.random``, which the port cannot reproduce: tests pass JAX's probe
    in explicitly."""
    src = generator.device if generator is not None else device
    if kind == "gaussian":
        e = torch.randn(shape, dtype=dtype, device=src, generator=generator)
    else:
        bits = torch.randint(0, 2, shape, device=src, generator=generator)
        e = bits.to(dtype) * 2.0 - 1.0
    return e.to(device)
