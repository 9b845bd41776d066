"""The dygraph layers the BERT/ERNIE slice uses (counterpart of
``paddle_tpu/dygraph/nn.py:78-283``): ``Linear``, ``Embedding``,
``LayerNorm`` and ``Dropout``, as ``nn.Module``s with Paddle's attribute
names and layouts (``Linear.weight`` is ``[in, out]``).

Beyond Paddle's arguments, each takes ``device`` (default "cuda", which
raises without a card) and ``generator``, the ``torch.Generator`` its
initializers and dropout draw from (default: the device's
:func:`~paddle_tpu_torch.framework.random.default_generator`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.place import resolve_device
from ..framework.random import default_generator
from ..initializer import ConstantInitializer
from ..ops import nn_ops
from ..ops.decoder_ops import matmul
from .amp import amp_cast
from .layers import Layer, create_parameter

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout"]


class Linear(Layer):
    """``act(x @ weight + bias)``, weight ``[input_dim, output_dim]``."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", device="cuda",
                 generator=None):
        super().__init__()
        self._act = act
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = create_parameter(param_attr, [input_dim, output_dim],
                                       **kw)
        self.bias = create_parameter(bias_attr, [output_dim], is_bias=True,
                                     **kw)

    def forward(self, input):
        out = matmul(input, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return nn_ops.activation(out, self._act)


class Embedding(Layer):
    """Rows of ``weight`` (``size`` = [vocab, width]) at integer ids."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32",
                 device="cuda", generator=None):
        super().__init__()
        if is_sparse or is_distributed:
            raise NotImplementedError(
                "Embedding(is_sparse/is_distributed) is not ported to "
                "dygraph (ROADMAP.md item 2); the static "
                "layers.embedding(is_sparse=True) is")
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = create_parameter(param_attr, list(size), dtype=dtype,
                                       device=device, generator=generator)

    def forward(self, input):
        (w,) = amp_cast("lookup_table_v2", self.weight)   # white under O2
        return nn_ops.lookup_table_v2(w, input, self._padding_idx)


class LayerNorm(Layer):
    """Normalises over the trailing ``normalized_shape`` axes (population
    variance, ``epsilon`` inside the root), then scale and shift."""

    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", device="cuda", generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._shape = [int(s) for s in normalized_shape]
        self._epsilon = epsilon
        n = int(np.prod(self._shape))
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = (create_parameter(
            param_attr, [n], default_initializer=ConstantInitializer(1.0),
            **kw) if scale else None)
        self.bias = (create_parameter(bias_attr, [n], is_bias=True, **kw)
                     if shift else None)

    def forward(self, input):
        # a bf16 or fp16 input takes JAX's rounding points (bf16: the
        # normalized value, * Scale, + Bias, each in x's dtype; fp16: the
        # normalized value, then * Scale + Bias rounded once, see
        # nn_ops.layer_norm_lowp); f32 is one F.layer_norm
        if (input.dtype in (torch.bfloat16, torch.float16)
                and self.weight is not None and self.bias is not None):
            return nn_ops.layer_norm_lowp(input, self.weight, self.bias,
                                          self._shape, self._epsilon)
        w, b = (None if t is None
                else t.reshape(self._shape).to(input.dtype)
                for t in (self.weight, self.bias))
        return F.layer_norm(input, self._shape, w, b, self._epsilon)


class Dropout(Layer):
    """Paddle dropout; ``seed`` fixes the mask (the same every call, as
    the JAX lowering's ``fix_seed``)."""

    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer", device="cuda",
                 generator=None):
        super().__init__()
        resolve_device(device)   # raises for a device this process lacks
        self._p = p
        self._impl = dropout_implementation
        self._seed = seed
        self._generator = generator

    def forward(self, input):
        gen = self._generator
        if self._seed is not None:
            gen = torch.Generator(device=input.device)
            gen.manual_seed(int(self._seed))
        elif gen is None:
            gen = default_generator(input.device)
        return nn_ops.dropout(input, self._p, is_test=not self.training,
                              implementation=self._impl, generator=gen)
