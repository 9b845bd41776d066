"""The plain op lowerings the decoder forms use, in PyTorch.

Counterparts of the JAX package's lowerings:

* ``lookup_table_v2`` (``paddle_tpu/ops/nn_ops.py``): embedding rows;
* ``layer_norm`` (``ops/nn_ops.py``): statistics over the axes from
  ``begin_norm_axis`` on, population variance, ``eps`` inside the square
  root, then scale and bias;
* ``matmul`` (``ops/math_ops.py:394``): ``alpha`` multiplies the product,
  after it, as the JAX lowering does; under AMP it is a white-list op
  (its f32 operands are cast to bf16 first,
  :func:`~paddle_tpu_torch.dygraph.amp.amp_cast`);
* ``attention_reference`` (``ops/pallas_kernels.py``): the dense
  composition ``fused_multihead_attention`` (``ops/fused_ops.py``) runs
  when its bias is a whole ``(b, 1, q, kv)`` matrix rather than a
  per-key padding vector.  The serving prefill and reference forms
  always feed such a causal matrix, so on the TPU too their attention
  runs outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["lookup_table_v2", "layer_norm", "matmul", "attention_reference"]


def lookup_table_v2(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at integer ``ids``; the output has ids' shape
    plus the row width."""
    return F.embedding(ids.long(), table)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = -1, epsilon: float = 1e-5
               ) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * scale + bias`` over the axes
    ``begin_norm_axis..`` (population variance)."""
    norm_shape = tuple(x.shape[begin_norm_axis % x.dim():])
    return F.layer_norm(x, norm_shape, scale.reshape(norm_shape),
                        bias.reshape(norm_shape), epsilon)


def matmul(x: torch.Tensor, y: torch.Tensor, transpose_Y: bool = False,
           alpha: float = 1.0) -> torch.Tensor:
    # imported here: the dygraph package imports this module
    from ..dygraph.amp import amp_cast
    x, y = amp_cast("matmul", x, y)
    if transpose_Y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax(q @ k^T * scale + bias) @ v`` on ``(b, h, s, d)`` q/k/v;
    ``bias`` broadcasts to ``(b, h, q, kv)``."""
    s = matmul(q, k, transpose_Y=True, alpha=scale) + bias
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
