"""GRAND on pixel-grid graphs: image classification by graph diffusion.

Counterpart of ``pnode_tpu/models/grand_image.py``: each image is a graph
whose nodes are pixels joined to their 4 neighbors (8 with ``diags``); raw
pixel intensities diffuse under du/dt = alpha (A u - u) + beta u0 with no
encoder, then one Linear over the flattened diffused image gives the
class logits. The grid adjacency is the same for every image, so the batch
diffuses in one spmm per evaluation: (batch, chan) folds into the feature
axis of a single (n_pixels, batch * chan) state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ffjord.layers import dense, on_device
from ..solver import ODESolver
from .grand import LaplacianFunc, dropout, get_rw_adj


def grid_edge_index(H: int, W: int, diags: bool = False) -> np.ndarray:
    """(2, E) directed edge list of the H x W pixel grid (both directions
    present): E = 2 (2HW - H - W) without diagonals, + 4 (H-1)(W-1)
    with."""
    idx = np.arange(H * W).reshape(H, W)
    pairs = []
    pairs.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()]))
    pairs.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()]))
    if diags:
        pairs.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()]))
        pairs.append(np.stack([idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()]))
    fwd = np.concatenate(pairs, axis=1)
    return np.concatenate([fwd, fwd[::-1]], axis=1)


class GRANDImage(nn.Module):
    """Pixel-diffusion classifier::

        model = GRANDImage(28, 28, n_classes=10, device="cuda")
        logits = model(x, training=True, generator=gen)   # x (B, H, W, C)

    The solve returns the state at the single output time T. The source
    term x0 is the (dropped-out) input and is not detached, as in the JAX
    package. A CUDA device without CUDA raises.
    """

    def __init__(self, H: int, W: int, n_classes: int, chan: int = 1,
                 T: float = 1.0, step_size: float = 0.25,
                 method: str = "dopri5", diags: bool = False,
                 input_dropout: float = 0.5, dropout: float = 0.5,
                 self_loop_weight: float = 1.0,
                 enable_adjoint: bool = True, device="cuda", dtype=None):
        super().__init__()
        self.H, self.W, self.chan = H, W, chan
        self.n_pix = H * W
        self.func = LaplacianFunc(hidden_dim=chan)
        self.dec = dense(self.n_pix * chan, n_classes)
        self.input_dropout = input_dropout
        self.dropout = dropout
        self.T = T
        self.method = method
        self.step_size = step_size
        self.enable_adjoint = enable_adjoint
        self._solvers = {}
        on_device(self, device, dtype)
        self.device = torch.device(device)
        self.graph = get_rw_adj(grid_edge_index(H, W, diags), self.n_pix,
                                self_loop_weight).to(self.device)

    def _state(self, x):
        """(B, H, W, C) or (B, N, C) -> (N, B*C) diffusion state."""
        B = x.shape[0]
        u = x.reshape(B, self.n_pix, self.chan)
        return u.permute(1, 0, 2).reshape(self.n_pix, B * self.chan)

    def _solver(self, shape, dtype):
        key = (shape, dtype)
        ode = self._solvers.get(key)
        if ode is None:
            func = self.func

            def f(t, y, p):
                fp = {k: v for k, v in p.items() if k != "x0"}
                return torch.func.functional_call(
                    func, fp, (t, y, self.graph, p["x0"]))

            ode = ODESolver()
            ode.setupTS(torch.zeros(shape, dtype=dtype, device=self.device),
                        (f, {}), step_size=self.step_size,
                        method=self.method,
                        enable_adjoint=self.enable_adjoint)
            self._solvers[key] = ode
        return ode

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        u0 = self._state(x)
        if training:
            u0 = dropout(u0, self.input_dropout, generator)
        ode = self._solver(tuple(u0.shape), u0.dtype)
        p = dict(self.func.named_parameters())
        p["x0"] = u0
        sol, _ = ode.solve(u0, np.array([self.T]), params=p,
                           with_adjoint=training and self.enable_adjoint)
        z = F.relu(sol[-1])
        if training:
            z = dropout(z, self.dropout, generator)
        # (N, B*C) -> (B, N*C): the flattened image of each sample
        z = z.reshape(self.n_pix, B, self.chan).permute(1, 0, 2).reshape(
            B, self.n_pix * self.chan)
        return self.dec(z)
