"""The plain op lowerings the BERT/ERNIE dygraph layers use, in PyTorch.

Counterparts of the JAX package's lowerings, with its semantics:

* ``lookup_table_v2`` (``ops/nn_ops.py:690-707``): ids clipped into the
  table, rows of ``padding_idx`` (when >= 0) zeroed;
* ``softmax_with_cross_entropy`` (``ops/nn_ops.py:470-505``): an f32
  log-sum-exp, hard labels, ``ignore_index`` honoured only when >= 0, and
  the closed-form gradient ``(softmax - onehot(label)) * dLoss`` of
  ``_softmax_ce_grad``, from the softmax saved by the forward;
* ``dropout`` (``ops/nn_ops.py:784-810``): ``upscale_in_train`` or
  ``downgrade_in_infer``, identity (or the downgrade) when ``is_test``;
  the keep mask is drawn from the caller's ``torch.Generator``;
* the activations ``gelu`` (exact erf) and ``tanh`` (``math_ops.py:76,
  109``) by name, and ``unsqueeze2`` (``tensor_ops.py:284``).

``layer_norm`` and ``matmul`` (with ``alpha`` / ``transpose_Y``) are the
decoder forms' (:mod:`.decoder_ops`); ``mean`` and ``einsum`` are
``torch.mean`` and ``torch.einsum``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["lookup_table_v2", "activation", "unsqueeze2", "dropout",
           "softmax_with_cross_entropy"]


def lookup_table_v2(table: torch.Tensor, ids: torch.Tensor,
                    padding_idx: int = -1) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (clipped to the table); the rows of
    ``padding_idx`` are zeros when it is >= 0."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    out = F.embedding(ids, table)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


# exact-erf GELU (the JAX lowering's approximate=False) and tanh
_ACTS = {"gelu": F.gelu, "tanh": torch.tanh}


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` by its Paddle name, or ``x`` when None."""
    if act is None:
        return x
    if act not in _ACTS:
        raise NotImplementedError(f"activation {act!r} is not ported")
    return _ACTS[act](x)


def unsqueeze2(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """``x`` with a unit axis inserted at each of ``axes``, in sorted
    order."""
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


def dropout(x: torch.Tensor, p: float, is_test: bool = False,
            implementation: str = "downgrade_in_infer",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Paddle dropout.  ``upscale_in_train``: ``x / (1 - p)`` where kept
    in training, ``x`` at test; ``downgrade_in_infer``: ``x`` where kept in
    training, ``x * (1 - p)`` at test.  Each element is kept with
    probability ``1 - p``, drawn from ``generator``."""
    if implementation not in ("upscale_in_train", "downgrade_in_infer"):
        raise ValueError(f"unknown dropout_implementation "
                         f"{implementation!r}")
    if is_test:
        return x if implementation == "upscale_in_train" else x * (1.0 - p)
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    if implementation == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


class _SoftmaxCE(torch.autograd.Function):
    """Hard-label softmax cross entropy over the last axis; the backward
    is the closed form from the saved softmax (JAX ``_softmax_ce_grad``),
    so the f32 log-softmax is never stored."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index):
        x32 = logits.float()
        lse = torch.logsumexp(x32, dim=-1, keepdim=True)
        picked = torch.gather(x32, -1, label)
        loss = lse - picked
        if ignore_index >= 0:
            loss = torch.where(label != ignore_index, loss,
                               torch.zeros_like(loss))
        softmax = torch.exp(x32 - lse).to(logits.dtype)
        ctx.save_for_backward(softmax, label)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, dloss):
        softmax, label = ctx.saved_tensors
        grad = softmax.to(torch.float32, copy=True)
        grad.scatter_add_(-1, label, torch.full_like(label, -1,
                                                     dtype=grad.dtype))
        grad.mul_(dloss.float())
        if ctx.ignore_index >= 0:
            grad = grad * (label != ctx.ignore_index).to(grad.dtype)
        return grad.to(softmax.dtype), None, None


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               ignore_index: int = -100) -> torch.Tensor:
    """Per-row loss ``logsumexp(logits) - logits[label]`` (f32), shape
    logits' with the last axis 1.  ``label`` holds int class ids, with or
    without the trailing unit axis."""
    if label.dim() == logits.dim() - 1:
        label = label.unsqueeze(-1)
    return _SoftmaxCE.apply(logits, label.long(), int(ignore_index))
