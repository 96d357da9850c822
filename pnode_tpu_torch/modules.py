"""Dynamics-function wrappers: ``func(t, y, params) -> dy`` plus ``func.params``.

Counterpart of ``pnode_tpu/modules.py``. The solver calls every dynamics
function with an explicit parameter dict so the hand-written adjoint can
return one gradient per entry:

- ``Func(fn, params)``: wrap any function ``fn(t, y, params)``.
- ``TorchFunc(module)``: wrap an ``nn.Module`` whose ``forward(t, y)`` is the
  dynamics (the model-zoo path, counterpart of ``FlaxFunc``). Its parameters
  are the module's own ``named_parameters()``, evaluated through
  ``torch.func.functional_call``, so a solve without ``params=`` uses (and
  its adjoint trains) the live module, while ``params=`` overrides them.
- Subclass ``DynamicsModule`` and implement ``__call__``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


class DynamicsModule:
    """Base class: dynamics with an explicit parameter dict."""

    @property
    def params(self) -> Params:
        return {}

    def __call__(self, t, y, params=None):
        raise NotImplementedError

    def bind(self):
        """Return (apply_fn, params) with apply_fn(t, y, params)."""
        return (lambda t, y, p: self(t, y, p)), self.params


class Func(DynamicsModule):
    """Wrap a function fn(t, y, params)."""

    def __init__(self, fn: Callable, params: Optional[Params] = None):
        self.fn = fn
        self._params = {} if params is None else params

    @property
    def params(self) -> Params:
        return self._params

    def __call__(self, t, y, params=None):
        return self.fn(t, y, self._params if params is None else params)


class TorchFunc(DynamicsModule):
    """Wrap an ``nn.Module`` with ``forward(t, y)``."""

    def __init__(self, module: nn.Module):
        self.module = module

    @property
    def params(self) -> Params:
        # read afresh on every access: the live Parameters, so an optimizer
        # stepping the module is seen by the next solve
        return dict(self.module.named_parameters())

    def __call__(self, t, y, params=None):
        if params is None:
            return self.module(t, y)
        return torch.func.functional_call(self.module, params, (t, y))


def as_dynamics(func, params: Optional[Params] = None):
    """Coerce user input into (apply_fn, params_getter).

    Accepts a DynamicsModule, a (fn, params) tuple, or a bare callable
    f(t, y) (parameterless dynamics). The second element is a zero-argument
    callable returning the current parameters (the ``params`` argument when
    given), so solves that pass no ``params=`` see the module's live ones.
    """
    if isinstance(func, DynamicsModule):
        fn, _ = func.bind()
        return fn, ((lambda: params) if params is not None
                    else (lambda: func.params))
    if isinstance(func, tuple) and len(func) == 2:
        fn, p = func
        p = params if params is not None else p
        return (lambda t, y, pp: fn(t, y, pp)), (lambda: p)
    if callable(func):
        p = params if params is not None else {}
        return (lambda t, y, pp: func(t, y)), (lambda: p)
    raise TypeError(
        "func must be a DynamicsModule, (fn, params) tuple, or callable f(t, y)"
    )
