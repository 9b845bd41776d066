"""The dygraph train step (counterpart of ``paddle_tpu/dygraph/jit.py``
``_cast_params_resident`` and ``jit_train_step`` :29-128).

PyTorch runs eagerly, so the step is not compiled: it runs the forward
(under :func:`~paddle_tpu_torch.dygraph.amp_guard` with ``amp``),
``backward()``, ``optimizer.minimize`` and clears the gradients.  The
parameters and the optimizer's state are updated **in place**; this takes
the place of the JAX package's buffer donation.  ``TracedLayer`` and
``compiled_forward`` are not ported.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .base import AMP_DTYPES, amp_guard, check_amp_dtype

__all__ = ["jit_train_step", "to_tensor"]


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _cast_params_resident(model, dtype):
    """Store every float32 parameter in ``dtype`` in place (AMP O2).  The
    JAX package keeps BatchNorm's parameters f32; the port has no dygraph
    BatchNorm, so every parameter goes.  The f32 master weights live in
    the optimizer's state (``AdamOptimizer``), not on the model."""
    want = AMP_DTYPES[dtype]
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(want)


def jit_train_step(model, optimizer, loss_fn: Callable, amp=False,
                   amp_dtype="bfloat16", amp_level="O1"):
    """``step(*inputs) -> loss`` for ``loss_fn(model, *tensor_inputs)``.

    Inputs may be numpy arrays or tensors; they are moved to the model's
    device.  Each call runs the forward, ``loss.backward()``,
    ``optimizer.minimize(loss)`` and ``model.clear_gradients()``, updating
    parameters and optimizer state in place, and returns the loss,
    detached.

    ``amp=True`` runs the forward under ``amp_guard(dtype=amp_dtype,
    level=amp_level)``: white-list ops in ``amp_dtype`` (``"bfloat16"`` or
    ``"float16"``; their casts are autograd ops, so the backward
    matches), parameters and optimizer state f32.  ``amp_level="O2"``
    first makes the parameters resident in ``amp_dtype``
    (:func:`_cast_params_resident`); the optimizer then keeps an f32
    master of each.  fp16 runs without a loss scale, as the JAX
    package's dygraph step does."""
    if amp:
        check_amp_dtype(amp_dtype)
        if amp_level == "O2":
            _cast_params_resident(model, amp_dtype)
    device = next(iter(model.parameters())).device

    def step(*inputs):
        with amp_guard(enable=amp, dtype=amp_dtype, level=amp_level):
            loss = loss_fn(model, *(to_tensor(x, device) for x in inputs))
        loss.backward()
        optimizer.minimize(loss)
        model.clear_gradients()
        return loss.detach()

    return step


class TracedLayer:
    def __init__(self, *a, **k):
        raise NotImplementedError("TracedLayer is not ported (ROADMAP.md)")


def compiled_forward(model_or_fn):
    raise NotImplementedError("compiled_forward is not ported (ROADMAP.md)")
