"""Windowed minibatches of a trajectory, in the JAX package's order (the
port's counterpart of ``pnode_tpu/data/loader.py``).

``WindowedLoader`` runs the shared ``csrc/windowed_loader.cpp`` (built by
``native.py`` into ``build/pnode_tpu_torch/``, never the JAX package's
library): a producer thread assembles shuffled (y0, targets) batches into a
ring of staging buffers, shuffling the window starts with ``std::shuffle``
on ``mt19937_64`` seeded by ``seed``. With the same array, seed, window,
batch and ``endpoint_only`` it yields the JAX loader's native batches bit
for bit, epoch after epoch. ``use_native=False`` gives the JAX loader's
numpy order instead (``default_rng(seed).permutation`` per epoch). The
native path is the default (``use_native=None``) and a failed build
raises: falling back quietly would change the batch order.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import native

_FP = ctypes.POINTER(ctypes.c_float)
_lib = None


def _load():
    """The loader library with its signatures (built on first call)."""
    global _lib
    if _lib is None:
        lib = native.load("windowed_loader")
        lib.wl_create.restype = ctypes.c_void_p
        lib.wl_create.argtypes = [_FP, ctypes.c_long, ctypes.c_long,
                                  ctypes.c_long, ctypes.c_long,
                                  ctypes.c_ulong, ctypes.c_int]
        lib.wl_batches_per_epoch.restype = ctypes.c_long
        lib.wl_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.wl_next.restype = ctypes.c_long
        lib.wl_next.argtypes = [ctypes.c_void_p, _FP, _FP]
        lib.wl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class WindowedLoader:
    """Iterate shuffled windowed minibatches of a trajectory array.

    u: (N, dim) array, cast to contiguous float32; yields (y0 (B, dim),
    targets (B, n_tgt, dim)) float32 arrays with n_tgt = 1 (endpoint_only:
    u[i + window]) or window (u[i + 1 .. i + window]). One iteration is one
    epoch of (N - window) // B batches; the next iteration continues with
    the next epoch's order.
    """

    def __init__(self, u: np.ndarray, window: int, batch: int,
                 seed: int = 0, endpoint_only: bool = False,
                 use_native: Optional[bool] = None):
        self.u = np.ascontiguousarray(u, dtype=np.float32)
        self.window = int(window)
        self.batch = int(batch)
        self.seed = int(seed)
        self.endpoint_only = bool(endpoint_only)
        self.n_tgt = 1 if endpoint_only else self.window
        n = self.u.shape[0]
        self.batches_per_epoch = max(0, (n - self.window) // self.batch)
        self._h = None
        self._lib = None
        if use_native is not False and self.batches_per_epoch > 0:
            lib = _load()
            h = lib.wl_create(self.u.ctypes.data_as(_FP), n,
                              self.u.shape[1], self.window, self.batch,
                              self.seed, int(self.endpoint_only))
            if not h:
                raise RuntimeError("wl_create failed")
            self._h, self._lib = h, lib
        self._rng = np.random.default_rng(self.seed)

    @property
    def native(self) -> bool:
        return self._h is not None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        dim = self.u.shape[1]
        if self._h is not None:
            y0 = np.empty((self.batch, dim), np.float32)
            tgt = np.empty((self.batch, self.n_tgt, dim), np.float32)
            for _ in range(self.batches_per_epoch):
                self._lib.wl_next(self._h, y0.ctypes.data_as(_FP),
                                  tgt.ctypes.data_as(_FP))
                yield y0.copy(), tgt.copy()
            return
        starts = self._rng.permutation(self.u.shape[0] - self.window)
        for b in range(self.batches_per_epoch):
            s = starts[b * self.batch:(b + 1) * self.batch]
            y0 = self.u[s]
            if self.endpoint_only:
                tgt = self.u[s + self.window][:, None]
            else:
                tgt = np.stack([self.u[s + 1 + j]
                                for j in range(self.window)], axis=1)
            yield y0, tgt

    def close(self):
        """Stop the producer thread and free the ring (also on deletion)."""
        if self._h is not None:
            self._lib.wl_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()
