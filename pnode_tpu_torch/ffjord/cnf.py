"""The CNF layer: a continuous normalizing flow through the port's solver.

Counterpart of ``pnode_tpu/ffjord/cnf.py`` (the reference's
``layers/cnf.py``). The flow state ``(z, delta_logp, reg accumulators)``
is flattened into one ``(B, D + 1 + R)`` tensor integrated over [0, T];
training runs the discrete adjoint (``ODESolver.solve(...,
with_adjoint=True)``), evaluation the step loop under autograd (no
trajectory kept by the adjoint); the reverse (sampling) direction runs the
time-flipped dynamics ``t -> T - t`` with the signs flipped.

The solver's dynamics take one flat parameter dict: the net's parameters
under their module names (``net.<name>``, evaluated through
``torch.func.functional_call``) and the Hutchinson probe under ``probe``.
The probe is detached inside the dynamics, the JAX package's
``stop_gradient``: the adjoint's cotangent for it is zero and reaches no
optimizer (the probe tensor itself never requires grad).

Convention (the reference driver's): the layer returns
``(z, delta_logp, regs)`` with ``log p_x(x) = log p_z(z) - delta_logp``.
The end time T is a static hyperparameter, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..modules import Func
from ..solver import ODESolver
from .layers import on_device
from .odefunc import (
    autoencoder_divergence_fn, divergence_bf_fn, jvp, sample_probe)
from .regularization import REGULARIZATION_FNS


class _Call(nn.Module):
    """``net.<method>``: ``functional_call`` on it swaps the net's
    parameters, named ``net.<name>`` as in the CNF's parameter dict."""

    def __init__(self, net: nn.Module, method: str):
        super().__init__()
        self.net, self.method = net, method

    def forward(self, *args):
        return getattr(self.net, self.method)(*args)


class CNF(nn.Module):
    """One CNF block::

        cnf = CNF(odenet, input_dim=D, T=0.5, regularization_fns=["l2int"],
                  device="cuda")
        (z, delta_logp, regs), stats = cnf.apply(x, generator=gen)
        x_back = cnf.apply(z, probe=e, reverse=True)[0][0]

    ``odenet`` is an ``nn.Module`` with ``forward(t, y)`` (y in the event
    shape, batch first); its parameters are the CNF's. ``event_shape`` is
    the non-batch shape of x for image CNFs (e.g. (H, W, C)): the solver's
    state is the flattened ``(B, prod(event_shape) + 1 + R)`` tensor while
    the net sees the unflattened view.
    """

    def __init__(
        self,
        odenet: nn.Module,
        input_dim: int = None,
        T: float = 0.5,
        solver: str = "dopri5",
        step_size: float = 0.05,
        divergence: str = "approx",
        rademacher: bool = True,
        regularization_fns: Sequence[str] = (),
        solver_options: Optional[dict] = None,
        event_shape: Optional[Tuple[int, ...]] = None,
        autoencode: bool = False,
        device="cuda",
        dtype=None,
    ):
        super().__init__()
        self.net = odenet
        if event_shape is not None:
            self.event_shape = tuple(event_shape)
            input_dim = int(np.prod(self.event_shape))
        else:
            if input_dim is None:
                raise ValueError("provide input_dim or event_shape")
            self.event_shape = (int(input_dim),)
        self.D = int(input_dim)
        self.T = float(T)
        self.solver = solver
        self.step_size = float(step_size)
        self.divergence = divergence
        self.rademacher = rademacher
        self.reg_names: List[str] = list(regularization_fns)
        for r in self.reg_names:
            if r not in REGULARIZATION_FNS:
                raise ValueError(f"unknown regularization {r!r}")
        self.R = len(self.reg_names)
        self.solver_options = solver_options or {}
        self._solvers: Dict = {}
        # the autoencoder divergence through the bottleneck: approximate
        # only and no regularization state, as in the reference
        self.autoencode = bool(autoencode)
        if self.autoencode:
            if self.R:
                raise ValueError(
                    "autoencode does not support regularization functionals "
                    "(reference AutoencoderODEfunc takes only (y, logp))")
            if divergence == "brute_force":
                raise ValueError(
                    "autoencode supports only the approximate divergence "
                    "(reference odefunc.py:395-397)")
        # plain dict: not submodules (the net is registered once, above)
        self._calls = {m: _Call(odenet, m) for m in (
            ("encode", "decode") if self.autoencode else ("forward",))}
        on_device(self, device, dtype)

    # -- dynamics --------------------------------------------------------

    def _dynamics(self, reverse: bool, exact_div: bool):
        D, T, ev, calls = self.D, self.T, self.event_shape, self._calls
        sign = -1.0 if reverse else 1.0

        def dyn(t, flat, p):
            net_p = {k: v for k, v in p.items() if k != "probe"}
            z = flat[..., :D]
            t_eff = T - t if reverse else t

            def call(method, zz, params, unflatten=True):
                arg = zz.reshape((zz.shape[0],) + ev) if unflatten else zz
                out = torch.func.functional_call(calls[method], params,
                                                 (t_eff, arg))
                return out.reshape(zz.shape[0], -1)

            if self.autoencode:
                e = p["probe"].detach()
                dz, div = autoencoder_divergence_fn(
                    lambda zz, q: call("encode", zz, q),
                    lambda hh, q: call("decode", hh, q, False), z, e, net_p)
                Je = torch.zeros_like(z)
            elif exact_div:
                dz, div = divergence_bf_fn(
                    lambda zz: call("forward", zz, net_p), z)
                e = Je = torch.zeros_like(z)
            else:
                e = p["probe"].detach()
                dz, Je = jvp(lambda zz, q: call("forward", zz, q), z, e,
                             net_p)
                div = torch.sum(e * Je, dim=-1)
            parts = [sign * dz, (-sign * div)[..., None]]
            for name in self.reg_names:
                parts.append(REGULARIZATION_FNS[name](z, dz, div, e, Je)[
                    ..., None])  # reg densities accumulate forward
            return torch.cat(parts, dim=-1)

        return dyn

    def _get_solver(self, shape, dtype, device, training, reverse, exact_div):
        key = (shape, dtype, str(device), training, reverse, exact_div)
        ode = self._solvers.get(key)
        if ode is None:
            ode = ODESolver()
            ode.setupTS(
                torch.zeros(shape, dtype=dtype, device=device),
                Func(self._dynamics(reverse, exact_div)),
                step_size=self.step_size,
                method=self.solver,
                enable_adjoint=training,
                **self.solver_options,
            )
            self._solvers[key] = ode
        return ode

    @property
    def solvers(self):
        """The solvers built so far (one per state shape, dtype, device and
        mode); their ``nfe_forward`` counts the dynamics evaluations."""
        return list(self._solvers.values())

    # -- forward ---------------------------------------------------------

    def forward(self, *args, **kw):
        return self.apply(*args, **kw)

    def apply(self, x, logpx=None, training: bool = True,
              reverse: bool = False, exact_div: bool = False,
              generator: Optional[torch.Generator] = None,
              probe: Optional[torch.Tensor] = None):
        """Returns ``((z, delta_logp, regs), stats)``.

        delta_logp accumulates -int div f; log p_x(x) = log p_z(z) -
        delta_logp. In reverse mode x is a base sample and z the data-space
        point. The Hutchinson probe is ``probe`` where given, else drawn
        from ``generator`` (``odefunc.sample_probe``); the brute-force
        divergence (``exact_div``) takes neither.
        """
        B = x.shape[0]
        dtype, device = x.dtype, x.device
        x_flat = x.reshape(B, -1)
        if exact_div:
            if self.autoencode:
                raise ValueError("autoencode has no brute-force divergence")
            probe = torch.zeros_like(x_flat)
        elif probe is not None:
            probe = torch.as_tensor(probe, dtype=dtype, device=device)
        elif generator is not None:
            shape = ((B, self.net.bottleneck_dim) if self.autoencode
                     else tuple(x_flat.shape))
            probe = sample_probe(
                shape, dtype, "rademacher" if self.rademacher else "gaussian",
                generator, device)
        else:
            raise ValueError("a generator or a probe is required for the "
                             "Hutchinson estimator")
        if logpx is None:
            logpx = torch.zeros((B, 1), dtype=dtype, device=device)
        flat0 = torch.cat(
            [x_flat, logpx, torch.zeros((B, self.R), dtype=dtype,
                                        device=device)], dim=-1)
        ode = self._get_solver(tuple(flat0.shape), dtype, device, training,
                               reverse, exact_div)
        p = {"net." + k: v for k, v in self.net.named_parameters()}
        p["probe"] = probe
        sol, stats = ode.solve(flat0, np.array([0.0, self.T]), params=p,
                               with_adjoint=training)
        out = sol[-1]
        z = out[..., : self.D].reshape((B,) + self.event_shape)
        delta_logp = out[..., self.D: self.D + 1]
        regs = out[..., self.D + 1:]
        return (z, delta_logp, regs), stats
