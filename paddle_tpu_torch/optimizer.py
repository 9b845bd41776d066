"""Dygraph optimizers (counterpart of ``paddle_tpu/optimizer.py``).

Ported: :class:`AdamOptimizer` (``optimizer.py:514-643``) with the
``adam`` op's update (``ops/optimizer_ops.py:126-165``).  It is Paddle's
Adam, not ``torch.optim.Adam``: the beta-power accumulators start at 1.0
and are multiplied after each update, and epsilon is added to the
*uncorrected* ``sqrt(v)``:

    lr_t = lr * sqrt(1 - b2p * beta2) / (1 - b1p * beta1)
    m    = beta1 * m + (1 - beta1) * g
    v    = beta2 * v + (1 - beta2) * g * g
    p   -= lr_t * m / (sqrt(v) + epsilon)
    b1p *= beta1;  b2p *= beta2

Each parameter keeps its own accumulators and is updated only on a step
that gave it a gradient, as in JAX.  Parameters whose beta powers agree
are updated together by ``torch._foreach_*`` ops, in place (this takes
the place of the JAX package's flattened multi-tensor update, a speed
detail).  LAMB, AdamW and the other optimizers, regularization and
gradient clipping are not ported.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

__all__ = ["Optimizer", "AdamOptimizer", "LambOptimizer",
           "AdamWOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization and grad_clip are not ported (ROADMAP.md)")
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameter_list)
                                if parameter_list is not None else None)

    def minimize(self, loss, parameter_list=None):
        """Apply one update from each parameter's ``.grad`` (the caller
        has run ``loss.backward()``); parameters without a gradient are
        left alone.  Returns ``(None, [(param, grad), ...])``."""
        params = parameter_list or self._parameter_list or []
        params_grads = [(p, p.grad) for p in params if p.grad is not None]
        with torch.no_grad():
            self._apply(params_grads)
        return None, params_grads

    def _apply(self, params_grads):
        raise NotImplementedError


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        if lazy_mode:
            raise NotImplementedError("Adam lazy_mode (sparse rows) is not "
                                      "ported")
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # per parameter: moment1, moment2 (tensors) and the beta powers
        # (float32 scalars, as the JAX op's (1,) f32 accumulators)
        self._state: Dict[int, dict] = {}

    def _param_state(self, p) -> dict:
        st = self._state.get(id(p))
        if st is None:
            st = {"m1": torch.zeros_like(p), "m2": torch.zeros_like(p),
                  "b1p": np.float32(1.0), "b2p": np.float32(1.0)}
            self._state[id(p)] = st
        return st

    def _apply(self, params_grads):
        lr = np.float32(self._learning_rate)
        b1, b2 = np.float32(self._beta1), np.float32(self._beta2)
        one = np.float32(1.0)
        groups: Dict[tuple, List] = defaultdict(list)
        for p, g in params_grads:
            st = self._param_state(p)
            groups[(float(st["b1p"]), float(st["b2p"]))].append((p, g, st))
        for (b1p, b2p), items in groups.items():
            b1p, b2p = np.float32(b1p), np.float32(b2p)
            lr_t = lr * np.sqrt(one - b2p * b2) / (one - b1p * b1)
            ps = [p for p, _, _ in items]
            gs = [g for _, g, _ in items]
            m1 = [st["m1"] for _, _, st in items]
            m2 = [st["m2"] for _, _, st in items]
            # the moment coefficients as the JAX op forms them: Python
            # floats applied to f32 tensors
            torch._foreach_mul_(m1, self._beta1)
            torch._foreach_add_(m1, gs, alpha=1.0 - self._beta1)
            torch._foreach_mul_(m2, self._beta2)
            torch._foreach_addcmul_(m2, gs, gs, value=1.0 - self._beta2)
            denom = torch._foreach_sqrt(m2)
            torch._foreach_add_(denom, float(self._epsilon))
            torch._foreach_addcdiv_(ps, m1, denom, value=-float(lr_t))
            for _, _, st in items:
                st["b1p"] = b1p * b1
                st["b2p"] = b2p * b2


def _unported(name):
    def init(self, *a, **k):
        raise NotImplementedError(f"{name} is not ported (ROADMAP.md)")
    return type(name, (Optimizer,), {"__init__": init})


LambOptimizer = _unported("LambOptimizer")
AdamWOptimizer = _unported("AdamWOptimizer")
