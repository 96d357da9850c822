"""ODENVP: the multiscale image CNF (real-NVP-style factor-out), and the
multiscale-parallel CNF.

Counterpart of ``pnode_tpu/ffjord/odenvp.py`` (the reference's
``odenvp.py`` and ``multiscale_parallel.py``): dequantized images pass a
logit transform, then per scale a stack of conv-ODEnet CNF blocks at that
resolution, a squeeze (space to channel) and a factor-out of half the
channels to the standard-normal prior; the last scale sends everything to
the prior. log p(x) is the sum of the prior terms minus the accumulated
delta_logp. Images are NHWC, as in the JAX package, so the latents compare
element for element with it.

Probes: ``generator=`` draws one per CNF block as it runs, ``probes=`` gives
them in the order the blocks run (``inverse`` runs them backwards); with
neither, every block takes the brute-force divergence, as the JAX package
does when it is given no key.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .cnf import CNF
from .flows import LogitTransform, SqueezeLayer, ZeroMeanTransform
from .layers import DIFFEQ_CONV_LAYERS, on_device
from .model_builders import standard_normal_logprob

_ACTS = {"softplus": nn.functional.softplus, "tanh": torch.tanh,
         "relu": nn.functional.relu}


class ConvODEnet(nn.Module):
    """Conv stack of time-dependent layers for image CNFs (ODEnet with
    conv layers): the hidden channel counts, then ``out_channels``."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int],
                 out_channels: int, layer_type: str = "concat",
                 nonlinearity: str = "softplus"):
        super().__init__()
        self.act = _ACTS[nonlinearity]
        Layer = DIFFEQ_CONV_LAYERS[layer_type]
        dims = (in_channels,) + tuple(hidden_dims) + (out_channels,)
        self.layers = nn.ModuleList(Layer(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, t, y):
        h = y
        for layer in self.layers[:-1]:
            h = self.act(layer(t, h))
        return self.layers[-1](t, h)


def _block_kw(generator, probes, i):
    """The i-th block's probe source; exact divergence with neither."""
    if probes is not None:
        return dict(probe=probes[i])
    if generator is not None:
        return dict(generator=generator)
    return dict(exact_div=True)


class ODENVP(nn.Module):
    """Multiscale CNF::

        model = ODENVP((H, W, C), n_scales=2, n_blocks=2, device="cuda")
        logpx, zs = model.log_prob(x, generator=gen, training=True)
    """

    def __init__(
        self,
        input_shape: Tuple[int, int, int],
        n_scales: int = 2,
        n_blocks: int = 2,
        hidden_dims: Sequence[int] = (32, 32),
        layer_type: str = "concat",
        nonlinearity: str = "softplus",
        alpha: float = 0.05,
        time_length: float = 0.5,
        solver: str = "rk4",
        step_size: float = 0.25,
        device="cuda",
        dtype=None,
    ):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.alpha = alpha
        self.logit = LogitTransform(alpha)
        self.squeeze = SqueezeLayer(2)
        h, w, c = input_shape
        shapes = []
        scales = []
        for s in range(n_scales):
            scales.append(nn.ModuleList(
                CNF(ConvODEnet(c, hidden_dims, c, layer_type, nonlinearity),
                    event_shape=(h, w, c), T=time_length, solver=solver,
                    step_size=step_size, device="cpu")
                for _ in range(n_blocks)))
            shapes.append((h, w, c))
            if s < n_scales - 1:
                # squeeze, then factor out half the channels
                h, w, c = h // 2, w // 2, 2 * c
        self.scales = nn.ModuleList(scales)
        self.scale_shapes = shapes
        on_device(self, device, dtype)

    def forward(self, x, generator=None, probes=None, training=True):
        """x -> (z_list, delta); log p(x) = sum priors(z) - delta."""
        delta = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        h, delta, _ = self.logit.apply(x, delta, {})
        zs = []
        i = 0
        for s, blocks in enumerate(self.scales):
            for blk in blocks:
                (h, dlp, _), _ = blk.apply(h, training=training,
                                           **_block_kw(generator, probes, i))
                delta = delta + dlp
                i += 1
            if s < len(self.scales) - 1:
                h, delta, _ = self.squeeze.apply(h, delta, {})
                c = h.shape[-1]
                zs.append(h[..., c // 2:])
                h = h[..., : c // 2]
        zs.append(h)
        return zs, delta

    def log_prob(self, x, generator=None, probes=None, training=True):
        zs, delta = self.forward(x, generator, probes, training)
        logpz = sum(standard_normal_logprob(z) for z in zs)
        return logpz[:, None] - delta, zs

    @property
    def z_shapes(self):
        """Shapes of the factored-out latents, as forward() returns them."""
        shapes = []
        for s, (h, w, c) in enumerate(self.scale_shapes):
            if s < len(self.scale_shapes) - 1:
                shapes.append((h // 2, w // 2, 2 * c))
            else:
                shapes.append((h, w, c))
        return shapes

    def inverse(self, zs, generator=None, probes=None):
        """Latents -> image, the exact inverse of forward(). Returns
        (x, delta_rev) with delta_rev = -delta_fwd, so log p(x) =
        sum priors(zs) + delta_rev."""
        n_scales = len(self.scales)
        delta = torch.zeros((zs[-1].shape[0], 1), dtype=zs[-1].dtype,
                            device=zs[-1].device)
        h = zs[-1]
        i = 0
        for s in range(n_scales - 1, -1, -1):
            if s < n_scales - 1:
                # undo the factor-out (h is the kept first half), unsqueeze
                h = torch.cat([h, zs[s]], dim=-1)
                h, delta, _ = self.squeeze.apply(h, delta, {}, reverse=True)
            for blk in reversed(self.scales[s]):
                (h, dlp, _), _ = blk.apply(h, training=False, reverse=True,
                                           **_block_kw(generator, probes, i))
                delta = delta + dlp
                i += 1
        x, delta, _ = self.logit.apply(h, delta, {}, reverse=True)
        return x, delta

    def sample(self, n: int, generator=None, temp: float = 1.0, dtype=None,
               device=None):
        """Prior samples (temp * N(0, I) per factored scale, drawn from
        ``generator`` on its device) pushed back through the exact
        inverse."""
        p = next(self.parameters())
        dtype = dtype or p.dtype
        device = device or p.device
        src = generator.device if generator is not None else device
        zs = [temp * torch.randn((n,) + shape, dtype=dtype, device=src,
                                 generator=generator).to(device)
              for shape in self.z_shapes]
        x, _ = self.inverse(zs, generator=generator)
        return x


def _squeeze(x, f=2):
    b, h, w, c = x.shape
    y = x.reshape(b, h // f, f, w // f, f, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def _unsqueeze(x, f=2):
    b, h, w, c = x.shape
    c2 = c // (f * f)
    y = x.reshape(b, h, w, f, f, c2).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * f, w * f, c2)


class ParallelScaleDyn(nn.Module):
    """Sum of conv nets at several squeezed scales: scale k squeezes k
    times, runs its own ConvODEnet and unsqueezes back (the reference's
    ParallelSumModules)."""

    def __init__(self, n_scale: int, channels: int,
                 hidden_dims: Sequence[int] = (32,),
                 layer_type: str = "concat"):
        super().__init__()
        self.n_scale = n_scale
        self.nets = nn.ModuleList(
            ConvODEnet(channels * 4 ** k, hidden_dims, channels * 4 ** k,
                       layer_type)
            for k in range(n_scale))

    def forward(self, t, y):
        out = torch.zeros_like(y)
        for k, net in enumerate(self.nets):
            z = y
            for _ in range(k):
                z = _squeeze(z)
            dz = net(t, z)
            for _ in range(k):
                dz = _unsqueeze(dz)
            out = out + dz
        return out


class MultiscaleParallelCNF(nn.Module):
    """One full-resolution CNF per block whose dynamics sums per-scale conv
    nets; downsamples while both spatial dims stay at least 4 (n_scale 0
    takes them all)."""

    def __init__(
        self,
        input_shape: Tuple[int, int, int],
        n_scale: int = 0,
        n_blocks: int = 1,
        intermediate_dims: Sequence[int] = (32,),
        alpha: float = -1.0,
        time_length: float = 1.0,
        solver: str = "rk4",
        step_size: float = 0.25,
        device="cuda",
        dtype=None,
    ):
        super().__init__()
        h, w, c = input_shape
        max_scale = 0
        hh, ww = h, w
        while hh >= 4 and ww >= 4:
            max_scale += 1
            hh //= 2
            ww //= 2
        self.n_scale = min(n_scale or max_scale, max_scale)
        self.input_shape = tuple(input_shape)
        self.pre = LogitTransform(alpha) if alpha > 0 else ZeroMeanTransform()
        self.blocks = nn.ModuleList(
            CNF(ParallelScaleDyn(self.n_scale, c, intermediate_dims),
                event_shape=input_shape, T=time_length, solver=solver,
                step_size=step_size, device="cpu")
            for _ in range(n_blocks))
        on_device(self, device, dtype)

    def forward(self, *args, **kw):
        return self.log_prob(*args, **kw)

    def log_prob(self, x, generator=None, probes=None, training=True):
        delta = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        h, delta, _ = self.pre.apply(x, delta, {})
        for i, blk in enumerate(self.blocks):
            (h, dlp, _), _ = blk.apply(h, training=training,
                                       **_block_kw(generator, probes, i))
            delta = delta + dlp
        return standard_normal_logprob(h)[:, None] - delta, h

    def inverse(self, z, generator=None, probes=None):
        """Latent -> image (one full-resolution latent)."""
        delta = torch.zeros((z.shape[0], 1), dtype=z.dtype, device=z.device)
        h = z
        for i, blk in enumerate(reversed(self.blocks)):
            (h, dlp, _), _ = blk.apply(h, training=False, reverse=True,
                                       **_block_kw(generator, probes, i))
            delta = delta + dlp
        x, delta, _ = self.pre.apply(h, delta, {}, reverse=True)
        return x, delta

    def sample(self, n: int, generator=None, temp: float = 1.0, dtype=None,
               device=None):
        p = next(self.parameters())
        dtype = dtype or p.dtype
        device = device or p.device
        src = generator.device if generator is not None else device
        z = temp * torch.randn((n,) + self.input_shape, dtype=dtype,
                               device=src, generator=generator).to(device)
        x, _ = self.inverse(z, generator=generator)
        return x
