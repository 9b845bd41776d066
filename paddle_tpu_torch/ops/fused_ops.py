"""``fused_multihead_attention``: counterpart of the JAX package's op
(``paddle_tpu/ops/fused_ops.py:26-135``).

q, k, v are ``(batch, heads, seq, head_dim)``.  A padding bias
(``(b, kv)``, ``(b, 1, kv)``, ``(b, 1, 1, kv)``) or no bias takes
:func:`~.flash_attention.flash_attention`: the hand-written kernels on the
card, their plain versions on the CPU, the padding bias a constant.  A
full-matrix bias (``(b, 1, q, kv)`` / ``(b, h, q, kv)``) takes the dense
:func:`~.flash_attention.attention_reference` under autograd, outside
any kernel, as in JAX (:30-35).

With ``dropout_rate > 0`` a per-call seed is drawn from the caller's
``torch.Generator`` (in ``[0, 2**23)``, as JAX draws it, :60-69) and is
saved by the autograd function, so the backward regenerates the mask.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.random import default_generator
from .flash_attention import (attention_reference, flash_attention,
                              is_padding_bias)

__all__ = ["fused_multihead_attention"]


def _draw_seed(generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """One int64 dropout seed in ``[0, 2**23)`` from ``generator``, as a
    one-element tensor on ``device`` (no host sync on the card)."""
    seed = torch.randint(0, 1 << 23, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    return seed.to(device)


def fused_multihead_attention(q, k, v, bias_qk=None, scale=0.0,
                              causal=False, dropout_rate=0.0,
                              generator: Optional[torch.Generator] = None):
    """softmax(q k^T * scale + bias_qk [, causal]) [dropped] @ v.
    ``scale`` 0 means ``1 / sqrt(head_dim)``; the dropout seed comes from
    ``generator`` (default: q's device's default generator)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    seed = None
    if dropout_rate > 0.0:
        seed = _draw_seed(generator if generator is not None
                          else default_generator(q.device), q.device)
    if bias_qk is not None and not is_padding_bias(bias_qk):
        return attention_reference(q, k, v, bias_qk, causal, scale,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=seed)
    return flash_attention(q, k, v, bias=bias_qk, causal=causal, scale=scale,
                           dropout_rate=dropout_rate, dropout_seed=seed)
