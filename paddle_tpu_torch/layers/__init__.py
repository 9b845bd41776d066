"""fluid.layers for the static path (counterpart of
``paddle_tpu/layers/``): the layers the ResNet, LeNet and word2vec
training programs use.
Each builds vars and ops through ``LayerHelper``; the ops lower to
PyTorch in ``ops/``."""
from __future__ import annotations

from ..framework.core import default_main_program
from ..framework.dtype import VarType, convert_dtype
from . import nn, tensor
from .nn import (accuracy, batch_norm, cast, concat, conv2d,  # noqa: F401
                 elementwise_add, embedding, fc, mean, pool2d, relu,
                 reshape, sigmoid, softmax, softmax_with_cross_entropy, topk)
from .tensor import (create_global_var, create_parameter,  # noqa: F401
                     fill_constant)


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """A feed variable (reference: layers/io.py data).  With
    ``append_batch_size`` a leading -1 batch dim is prepended."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    if block.has_var(name):
        return block.var(name)
    return block.create_var(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        lod_level=lod_level, is_data=True, stop_gradient=stop_gradient,
        need_check_feed=True)
