"""``paddle.nn.functional`` (counterpart of
``paddle_tpu/nn/functional.py``): functional names over the static
layers, each defined as JAX's defines it, mostly as an alias of the
layer.  ``hardsigmoid`` has slope 0.1667 by default here, as in JAX,
where ``layers.hard_sigmoid`` has 0.2; ``l1_loss`` and ``nll_loss``
emit the ops of JAX's ``paddle.tensor`` calls (``abs``,
``elementwise_sub``, ``index_sample``, ``scale``, the ``reduce_*`` ops
over every axis)."""
from __future__ import annotations

from .. import layers as _L
from ..framework.dtype import VarType
from ..layer_helper import LayerHelper

# activations
relu = _L.relu
relu6 = _L.relu6
sigmoid = _L.sigmoid
tanh = _L.tanh
softmax = _L.softmax
log_softmax = _L.log_softmax
leaky_relu = _L.leaky_relu
gelu = _L.gelu
swish = _L.swish
hardswish = _L.hard_swish
prelu = _L.prelu
softplus = _L.softplus
softsign = _L.softsign


def _op(op_type, inputs, attrs=None):
    """One op on its first input's dtype, as JAX's ``paddle.tensor``
    helpers append it."""
    helper = LayerHelper(op_type)
    ref = next(v[0] for v in inputs.values() if v)
    out = helper.create_variable_for_type_inference(
        ref.dtype if ref is not None else VarType.FP32)
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def elu(x, alpha=1.0, name=None):
    return _op("elu", {"X": [x]}, {"alpha": float(alpha)})


def silu(x, name=None):
    return _op("silu", {"X": [x]})


def hardsigmoid(x, slope=0.1667, offset=0.5, name=None):
    return _op("hard_sigmoid", {"X": [x]},
               {"slope": float(slope), "offset": float(offset)})


# nn building blocks
linear = _L.fc
conv2d = _L.conv2d
conv2d_transpose = _L.conv2d_transpose
embedding = _L.embedding
dropout = _L.dropout
batch_norm = _L.batch_norm
layer_norm = _L.layer_norm
one_hot = _L.one_hot
pad = _L.pad
interpolate = _L.resize_bilinear
upsample = _L.resize_bilinear


def avg_pool2d(x, kernel_size, stride=None, padding=0, name=None):
    return _L.pool2d(x, pool_size=kernel_size, pool_type="avg",
                     pool_stride=stride or kernel_size,
                     pool_padding=padding)


def max_pool2d(x, kernel_size, stride=None, padding=0, name=None):
    return _L.pool2d(x, pool_size=kernel_size, pool_type="max",
                     pool_stride=stride or kernel_size,
                     pool_padding=padding)


def adaptive_avg_pool2d(x, output_size, name=None):
    return _L.adaptive_pool2d(x, output_size, pool_type="avg")


def adaptive_max_pool2d(x, output_size, name=None):
    return _L.adaptive_pool2d(x, output_size, pool_type="max")


# losses
cross_entropy = _L.softmax_with_cross_entropy
square_error_cost = _L.square_error_cost
mse_loss = _L.mse_loss
kl_div = _L.kldiv_loss
log_loss = _L.log_loss
smooth_l1_loss = _L.smooth_l1
binary_cross_entropy_with_logits = _L.sigmoid_cross_entropy_with_logits
label_smooth = _L.label_smooth


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _L.l2_normalize(x, axis, epsilon)


def _reduce_all(op_type, x):
    return _op(op_type, {"X": [x]},
               {"dim": [], "keep_dim": False, "reduce_all": True})


def _reduction(loss, reduction):
    if reduction == "mean":
        return _reduce_all("reduce_mean", loss)
    if reduction == "sum":
        return _reduce_all("reduce_sum", loss)
    return loss


def l1_loss(input, label, reduction="mean", name=None):
    diff = _op("abs", {"X": [_op("elementwise_sub",
                                 {"X": [input], "Y": [label]})]})
    return _reduction(diff, reduction)


def nll_loss(input, label, weight=None, reduction="mean", name=None):
    """input: log-probabilities [N, C]; label: [N] or [N, 1]."""
    if len(label.shape) == 1:
        label = _L.unsqueeze(label, [1])
    picked = _op("index_sample", {"X": [input], "Index": [label]})
    return _reduction(_L.scale(picked, -1.0), reduction)
