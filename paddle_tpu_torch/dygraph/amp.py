"""The AMP cast rule at op boundaries (counterpart of
``paddle_tpu/dygraph/tracer.py:70-146``, ``_amp_lists`` and
``_amp_cast_inputs``).

Each dygraph op front that the JAX tracer would trace under a Paddle op
type calls :func:`amp_cast` with that type and its floating inputs:
``matmul`` (``ops/decoder_ops.py``), ``fused_multihead_attention``
(``ops/fused_ops.py``, q, k, v and the padding bias), ``lookup_table_v2``
(``dygraph/nn.py`` ``Embedding``), ``softmax_with_cross_entropy``,
``mean`` and ``softmax`` (``ops/nn_ops.py``).  Outside an enabled
:func:`~paddle_tpu_torch.dygraph.amp_guard` it returns its inputs.

The cast cache.  Inside a guard each tensor is cast at most once per
dtype: a tensor read by two white-list ops gets one cast, and both
consumers read its output.  The consumers' gradients therefore meet at
the cast's output, are summed there in bf16 by autograd, and only then
does the cast's backward take the sum to f32, which is the JAX tape's
order.  An entry is valid while the tensor is the same object at the same
version (an in-place update, such as the optimizer's, invalidates it);
the outermost guard drops the cache, so ``jit_train_step`` casts once per
step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import AMP_DTYPES, amp_state

__all__ = ["amp_cast"]


def _cast(t: torch.Tensor, want: torch.dtype, cache: Optional[dict]):
    if cache is not None:
        hit = cache.get((id(t), want))
        if hit is not None and hit[0] is t and hit[1] == t._version:
            return hit[2]
    out = t.to(want)
    if cache is not None:
        cache[(id(t), want)] = (t, t._version, out)
    return out


def amp_cast(op_type: str, *tensors) -> Tuple:
    """``tensors``, each cast as op ``op_type`` takes it under the current
    AMP state: a white-list op gets its f32 tensors in the AMP dtype, a
    black-list op its bf16 / fp16 tensors in f32
    (``softmax_with_cross_entropy`` under bf16 excepted), any other op
    the tensors as they are.  None and integer tensors pass through.
    Returns a tuple of the same length."""
    st = amp_state()
    if not st.enabled:
        return tensors
    white, black = st.lists()
    if op_type in white:
        want, src = AMP_DTYPES[st.dtype], (torch.float32,)
    elif op_type in black:
        # the lowering upcasts inside (f32 logsumexp, the Softmax saved in
        # the logits' dtype); bf16 needs no overflow guard, so no cast
        if st.dtype == "bfloat16" and op_type == "softmax_with_cross_entropy":
            return tensors
        want, src = torch.float32, (torch.bfloat16, torch.float16)
    else:
        return tensors
    return tuple(_cast(t, want, st.cache)
                 if t is not None and t.dtype in src else t
                 for t in tensors)
