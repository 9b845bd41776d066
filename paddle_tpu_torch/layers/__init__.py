"""fluid.layers for the static path (counterpart of
``paddle_tpu/layers/``): the layers the ResNet, MobileNetV3, LeNet,
word2vec, static BERT encoder, PSPNet and book text models' training
programs use and the other layers of the activation, norm, pad,
interpolation and loss ops, the RNN cells, ``rnn`` and the recurrent,
sequence and beam-search layers (:mod:`.rnn`, :mod:`.sequence_lod`), the
learning-rate schedules (:mod:`.learning_rate_scheduler`) and the
Python operators on
``Variable`` (:mod:`.math_op_patch`).
Each builds vars and ops through ``LayerHelper``; the ops lower to
PyTorch in ``ops/``."""
from __future__ import annotations

from ..framework.core import default_main_program
from ..framework.dtype import VarType, convert_dtype
from . import nn, tensor
from .math_op_patch import monkey_patch_variable
from .nn import (abs, accuracy, adaptive_pool2d, argmax,  # noqa: F401
                 argmin, argsort, batch_norm, cast, ceil, clip,
                 clip_by_norm, concat, conv2d, conv2d_transpose, cos,
                 cos_sim, cross_entropy, dropout, elementwise_add,
                 elementwise_div, elementwise_floordiv, elementwise_max,
                 elementwise_min, elementwise_mod, elementwise_mul,
                 elementwise_pow, elementwise_sub, embedding, erf, exp,
                 expand, fc, flatten, floor, fused_multihead_attention,
                 gather, gelu, hard_sigmoid, hard_swish, huber_loss,
                 increment, kldiv_loss, l2_normalize, label_smooth,
                 layer_norm, leaky_relu, log, log_loss, log_softmax, mean_iou,
                 logsigmoid, matmul, mean, mse_loss, mul, one_hot, pad,
                 pad2d, pool2d, prelu, reciprocal, reduce_all, reduce_any,
                 reduce_max, reduce_mean, reduce_min, reduce_prod,
                 reduce_sum, relu, relu6, reshape, resize_bilinear,
                 resize_nearest, round, rsqrt, scale, shape, sigmoid,
                 sigmoid_cross_entropy_with_logits, sign, sin, slice,
                 smooth_l1, softmax, softmax_with_cross_entropy, softplus,
                 softsign, split, sqrt, square, square_error_cost, squeeze,
                 stack, swish, tanh, topk, transpose, unsqueeze, unstack,
                 where)
from .tensor import (assign, create_global_var,  # noqa: F401
                     create_parameter, fill_constant,
                     fill_constant_batch_size_like, range, zeros_like)
from . import sequence_lod
from .sequence_lod import (sequence_conv, sequence_first_step,  # noqa: F401
                           sequence_last_step, sequence_mask, sequence_pool,
                           sequence_reverse, sequence_softmax)
from . import rnn as rnn_module
from .rnn import (GRUCell, LSTMCell, RNNCell, StaticRNN,  # noqa: F401
                  beam_search, beam_search_decode, birnn, dynamic_gru,
                  dynamic_lstm, gru, lstm)
from .rnn import rnn  # noqa: F401  (the function, as in JAX)

monkey_patch_variable()

from . import learning_rate_scheduler  # noqa: E402
from .learning_rate_scheduler import (  # noqa: E402,F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)


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
