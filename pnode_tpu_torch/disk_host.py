"""Disk trajectories (``-ts_trajectory_type disk``, PETSc's default
TSTrajectory) and the explicit disk drivers ``HostDiskTrajectory`` /
``AdaptiveHostDiskTrajectory``.

Counterpart of ``pnode_tpu/disk_host.py``. The JAX package needs two disk
engines: an ``io_callback`` inside its compiled scan, and these host-driven
classes for backends without host callbacks. The port's solves are eager
loops on the host already, so one engine serves both: the ``disk`` policy
of ``adjoint.py`` (fixed grid) and ``adaptive.py`` (the trial axis), whose
forward hands every step-start state to a ``DiskStore`` and whose reverse
reads the states back, last first, with ``aux=None`` (solution-only
storage, PETSc's disk default). The classes here drive those engines
outside autograd, as the reference's explicit TSSolve / TSAdjointSolve
loop does.

``DiskStore`` keeps device memory at O(chunk x state): the forward gathers
``chunk`` states on the device, copies them in one transfer to a pinned
host buffer (two buffers in turn, so a copy overlaps the next chunk's
steps) and writes the memmap rows from there; it never synchronizes per
step. The reverse uploads one chunk at a time, last first. A bf16 state
goes to disk as its raw 16 bits (``view(torch.int16)`` on the device) and
is viewed back on the way up: numpy has no bf16.
"""

from __future__ import annotations

import itertools
import os
import weakref
from typing import Callable, Optional

import numpy as np
import torch

_COUNTER = itertools.count(1)


def new_path(dirname: str, tag: str) -> str:
    """A fresh memmap path under ``dirname`` (process id and a counter)."""
    return os.path.join(
        dirname, f"pnode_hostdisk_{tag}_{os.getpid()}_{next(_COUNTER)}.npy")


def _raw_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype whose bits go to disk: int16 for bf16, else the dtype."""
    return torch.int16 if dtype == torch.bfloat16 else dtype


def _remove(path: str):
    if os.path.exists(path):
        os.remove(path)


class DiskStore:
    """Rows of states in a numpy memmap at ``path``, written in order in
    chunks of ``chunk`` rows and read back a chunk at a time.

    ``open(n_rows, like)`` creates the memmap for states like ``like``
    (shape, dtype, device); ``put(row, y)`` takes the next row; ``finish()``
    writes what is pending; ``read(a, b)`` returns rows a..b-1 on the
    device; ``close()`` removes the file (also done when the store is
    garbage-collected). ``max_device_rows`` is the most states the store
    held on the device at once (pending rows or one uploaded chunk)."""

    def __init__(self, path: str, chunk: int = 64):
        self.path = path
        self.chunk = max(1, int(chunk))
        self.mm = None
        self.max_device_rows = 0
        self._pending, self._row0 = [], 0
        self._host, self._turn = [], 0
        self._finalizer = None

    def open(self, n_rows: int, like: torch.Tensor):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.shape, self.dtype = tuple(like.shape), like.dtype
        self.device = like.device
        raw = _raw_dtype(like.dtype)
        self.mm = np.lib.format.open_memmap(
            self.path, mode="w+",
            dtype=torch.empty((), dtype=raw).numpy().dtype,
            shape=(int(n_rows),) + self.shape)
        self._finalizer = weakref.finalize(self, _remove, self.path)
        self._pending, self._row0, self._inflight = [], 0, []
        return self

    def chunks(self, n: int):
        """[(a, b), ...]: rows 0..n-1 in chunks of ``chunk``, the last one
        ragged."""
        return [(a, min(a + self.chunk, n)) for a in range(0, n, self.chunk)]

    # -- forward: device -> pinned host buffer -> memmap -------------------

    def _buffers(self):
        """Two pinned host buffers of one chunk each (CUDA stores only)."""
        if not self._host:
            raw = _raw_dtype(self.dtype)
            self._host = [
                (torch.empty((self.chunk,) + self.shape, dtype=raw,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(2)]
        return self._host

    def put(self, row: int, y: torch.Tensor):
        if not self._pending:
            self._row0 = int(row)
        self._pending.append(y)
        self.max_device_rows = max(self.max_device_rows, len(self._pending))
        if len(self._pending) == self.chunk:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        a, n = self._row0, len(self._pending)
        block = torch.stack(self._pending).view(_raw_dtype(self.dtype))
        self._pending = []
        if block.device.type != "cuda":
            self.mm[a:a + n] = block.numpy()
            return
        if len(self._inflight) == 2:  # the buffer this copy reuses
            self._drain_one()
        host, event = self._buffers()[self._turn]
        self._turn ^= 1
        host[:n].copy_(block, non_blocking=True)
        event.record()
        self._inflight.append((a, n, host, event))

    def _drain_one(self):
        a, n, host, event = self._inflight.pop(0)
        event.synchronize()
        self.mm[a:a + n] = host[:n].numpy()

    def finish(self):
        """Write every pending row; the memmap then holds the trajectory."""
        self._flush()
        while self._inflight:
            self._drain_one()
        self.mm.flush()
        return self

    # -- reverse: memmap -> pinned host buffer -> device -------------------

    def read(self, a: int, b: int) -> torch.Tensor:
        """Rows a..b-1 as one device tensor (b - a, *shape) of the stored
        dtype; ``b - a`` is at most ``chunk``."""
        n = b - a
        self.max_device_rows = max(self.max_device_rows, n)
        rows = self.mm[a:b]
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(rows)).view(self.dtype)
        host, event = self._buffers()[self._turn]
        self._turn ^= 1
        event.synchronize()  # its previous upload has left the buffer
        host[:n].numpy()[...] = rows
        out = host[:n].to(self.device, non_blocking=True)
        event.record()
        return out.view(self.dtype)

    def close(self):
        self.mm = None
        if self._finalizer is not None:
            self._finalizer()


def disk_options(opts=None):
    """(dirname, chunk) from ``-ts_trajectory_dirname`` (default
    ./ts_trajectory) and ``-pnode_disk_chunk`` (default 64)."""
    from .options import Options

    opts = Options() if opts is None else opts
    return (opts.get_string("ts_trajectory_dirname", "./ts_trajectory"),
            opts.get_int("pnode_disk_chunk", 64))


class _HostDiskBase:
    """What both drivers share: the output selection, the memmap's path and
    lifecycle, ``value_and_grad`` and ``close``."""

    def _init_common(self, dirname, chunk, store_dtype, sel, n_outputs, tag,
                     dtype):
        self.dirname = dirname
        self.chunk = max(1, int(chunk))
        self.store_dtype = "bfloat16" if store_dtype == "bf16" else (
            store_dtype or "")
        self.dtype = dtype
        if sel is None or (isinstance(sel, slice) and sel == slice(None)):
            self.sel = None
        else:
            self.sel = np.arange(n_outputs)[sel]
        self._n_outputs = n_outputs
        self._path = new_path(dirname, tag)
        self._disk: Optional[DiskStore] = None
        self._stored = None
        self._y0 = None

    @property
    def _mm(self):
        return None if self._disk is None else self._disk.mm

    def _cast_y0(self, y0):
        y0 = torch.as_tensor(y0)
        return y0 if self.dtype is None else y0.to(self.dtype)

    def _engine_store(self) -> Callable[[], DiskStore]:
        """The engines' DiskStore factory: this driver's path and chunk."""
        def make():
            if self._disk is not None:  # a second solve reuses the path
                self._disk.close()
            self._disk = DiskStore(self._path, self.chunk)
            return self._disk

        return make

    def _select(self, outputs):
        return outputs if self.sel is None else outputs[torch.as_tensor(
            self.sel, device=outputs.device)]

    def _full_cotangent(self, g_outputs):
        """Cotangents per returned output -> per grid output (scatter-add
        over the selection)."""
        g = torch.stack(list(g_outputs)) if not isinstance(
            g_outputs, torch.Tensor) else g_outputs
        if self.sel is None:
            return g
        full = torch.zeros((self._n_outputs,) + tuple(g.shape[1:]),
                           dtype=g.dtype, device=g.device)
        full.index_add_(0, torch.as_tensor(self.sel, device=g.device), g)
        return full

    def value_and_grad(self, loss_fn: Callable, y0, params):
        """``loss_fn(outputs) -> scalar``; returns ``(loss, (grad_y0,
        grad_params))``. The loss and its output cotangents come from
        autograd on the n_out outputs; the trajectory stays on disk."""
        outputs, _ = self.solve(y0, params)
        out = outputs.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(out)
            (g,) = torch.autograd.grad(loss, out)
        return loss.detach(), self.adjoint_solve(g, params)

    def close(self):
        if self._disk is not None:
            self._disk.close()
            self._disk = None
        self._stored = None
        _remove(self._path)


class HostDiskTrajectory(_HostDiskBase):
    """Disk-backed trajectory and explicit adjoint of one (stepper, grid).

    ``solve(y0, params) -> (outputs, stats)`` streams every step's state
    (and the final one: ``n_steps + 1`` rows) to the memmap;
    ``adjoint_solve(g_outputs, params) -> (grad_y0, grad_params)`` reads
    them back last first; ``value_and_grad(loss_fn, y0, params)`` does
    both around ``loss_fn(outputs)``. ``chunk`` (``-pnode_disk_chunk``)
    bounds the states on the device; ``store_dtype`` ("bf16", ...)
    compresses the memmap, and interior outputs then come back through it
    (the first and the final output stay exact); ``sel`` selects among the
    grid's outputs; ``dtype`` is the solver's state dtype. The stepper is
    prepared once per solve and once per adjoint, at the solve's y0: the
    frozen-Jacobian semantics of the in-memory policies."""

    def __init__(self, stepper, grid, dirname: str = "./ts_trajectory",
                 chunk: int = 64, store_dtype: str = "", sel=None,
                 dtype=None):
        self.stepper = stepper
        self.grid = grid
        self._init_common(dirname, chunk, store_dtype, sel,
                          len(np.asarray(grid.out_idx)), "grid", dtype)
        self._engines = {}

    def _engine(self, dtype):
        from .adjoint import TrajectoryConfig, _Engine

        eng = self._engines.get(dtype)
        if eng is None:
            eng = self._engines[dtype] = _Engine(
                self.stepper, self.grid,
                TrajectoryConfig(kind="disk", store_dtype=self.store_dtype),
                dtype, disk_store=self._engine_store())
        return eng

    def solve(self, y0, params):
        y0 = self._cast_y0(y0)
        eng = self._engine(y0.dtype)
        with torch.no_grad():
            outputs, stats, stored = eng.forward(y0, params, store=True)
        self._y0, self._stored = y0, stored
        return self._select(outputs), stats

    def adjoint_solve(self, g_outputs, params):
        """The discrete adjoint from the cotangents of the returned
        outputs: ``(grad_y0, grad_params)``, what autograd through the
        in-memory policies gives for the same loss."""
        g = self._full_cotangent(g_outputs)
        if int(self.grid.n_steps) > 0 and self._stored is None:
            raise RuntimeError("run solve() before adjoint_solve()")
        y0 = self._y0 if self._y0 is not None else torch.zeros(
            g.shape[1:], dtype=g.dtype, device=g.device)
        eng = self._engine(y0.dtype)
        with torch.no_grad():
            return eng.backward(y0, params, self._stored, g.to(y0.dtype))


class AdaptiveHostDiskTrajectory(_HostDiskBase):
    """The disk driver of the adaptive path (``-ts_adapt_type`` with the
    disk trajectory, PETSc's default configuration): the controller's
    trial loop writes every trial's pre-step state to a memmap of
    ``max_steps`` rows (its trial axis) and stops once every output has
    landed; the adjoint reads the rows back, last first, skipping chunks
    that hold no accepted trial (exact identities). Same API as
    ``HostDiskTrajectory``."""

    def __init__(self, stepper, t_out, cfg, dt0: float,
                 dirname: str = "./ts_trajectory", chunk: int = 64,
                 store_dtype: str = "", sel=None, dtype=None):
        from .adaptive import _AdaptiveEngine
        from .adjoint import TrajectoryConfig

        self.stepper = stepper
        self.t_out = np.asarray(t_out, np.float64)
        self.cfg = cfg
        self.dt0 = float(dt0)
        self._init_common(dirname, chunk, store_dtype, sel, len(self.t_out),
                          "adapt", dtype)
        self._eng = _AdaptiveEngine(
            stepper, self.t_out, cfg, self.dt0,
            TrajectoryConfig(kind="disk", store_dtype=self.store_dtype),
            disk_store=self._engine_store())

    def solve(self, y0, params):
        y0 = self._cast_y0(y0)
        with torch.no_grad():
            outputs, stats, stored = self._eng.forward(y0, params, self.dt0,
                                                       store=True)
        self._y0, self._stored = y0, stored
        return self._select(outputs), stats

    def adjoint_solve(self, g_outputs, params):
        if self._stored is None:
            raise RuntimeError("run solve() before adjoint_solve()")
        g = self._full_cotangent(g_outputs)
        with torch.no_grad():
            return self._eng.backward(self._y0, params, self._stored,
                                      g.to(self._y0.dtype))
