"""The dygraph train step (counterpart of ``paddle_tpu/dygraph/jit.py``
``jit_train_step`` :51-128).

PyTorch runs eagerly, so the step is not compiled: it runs the forward,
``backward()``, ``optimizer.minimize`` and clears the gradients.  The
parameters and the optimizer's state are updated **in place**; this takes
the place of the JAX package's buffer donation.  ``TracedLayer`` and
``compiled_forward`` are not ported.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["jit_train_step", "to_tensor"]


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def jit_train_step(model, optimizer, loss_fn: Callable, amp=False):
    """``step(*inputs) -> loss`` for ``loss_fn(model, *tensor_inputs)``.

    Inputs may be numpy arrays or tensors; they are moved to the model's
    device.  Each call runs the forward, ``loss.backward()``,
    ``optimizer.minimize(loss)`` and ``model.clear_gradients()``, updating
    parameters and optimizer state in place, and returns the loss,
    detached."""
    if amp:
        raise NotImplementedError(
            "jit_train_step(amp=True): AMP O1/O2 and bf16 attention are not "
            "ported (ROADMAP.md Queue 1, the bf16 flash variants with AMP)")
    device = next(iter(model.parameters())).device

    def step(*inputs):
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
