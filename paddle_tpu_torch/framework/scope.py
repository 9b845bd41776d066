"""Scope: name -> torch tensor map with parent chaining (counterpart of
``paddle_tpu/framework/scope.py``; reference: framework/scope.h:46).

A slot holds a torch tensor on the executor's device (or any Python
value).  The executor updates parameters, optimizer state and BatchNorm
statistics in place, so a tensor taken from the scope keeps tracking
its variable across steps; copy it to keep a snapshot.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .place import resolve_device

__all__ = ["Scope", "global_scope", "scope_guard", "load_numpy_state",
           "numpy_state"]


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def var(self, name: str) -> "_ScopeSlot":
        if name not in self._vars:
            self._vars[name] = None
        return _ScopeSlot(self, name)

    def find_var(self, name: str) -> Optional["_ScopeSlot"]:
        s = self
        while s is not None:
            if name in s._vars:
                return _ScopeSlot(s, name)
            s = s._parent
        return None

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def local_var_names(self) -> List[str]:
        return list(self._vars.keys())

    def get(self, name: str, default=None):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return default

    def has(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s._parent
        return False

    def set(self, name: str, value):
        """Bind ``name`` where it already lives (parent chain), else
        locally."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s._parent
        self._vars[name] = value

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)

    def items(self) -> Iterator:
        return iter(self._vars.items())


class _ScopeSlot:
    """Handle mirroring the reference's Variable* returned by Scope::Var."""

    def __init__(self, scope: Scope, name: str):
        self._scope = scope
        self._name = name

    def get(self):
        return self._scope.get(self._name)

    def set(self, value):
        self._scope.set(self._name, value)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev


def load_numpy_state(scope: Scope, arrays: Dict[str, np.ndarray],
                     device="cuda") -> None:
    """Bind every ``{name: numpy array}`` entry in ``scope`` as a tensor
    of its own (a copy, never a view of the array) on ``device``: how a
    startup scope made elsewhere (for example by the JAX package) is
    carried into the port, since the two packages' random streams
    differ."""
    dev = resolve_device(device)
    for name, arr in arrays.items():
        scope.set(name, torch.tensor(np.asarray(arr), device=dev))


def numpy_state(scope: Scope, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """``{name: numpy copy}`` of the scope's tensors named ``names``."""
    return {n: scope.get(n).detach().cpu().numpy().copy() for n in names}
