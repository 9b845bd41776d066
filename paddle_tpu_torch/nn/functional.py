"""``paddle.nn.functional`` (counterpart of
``paddle_tpu/nn/functional.py``): functional names over the static
layers.  Ported: ``hardswish`` and ``hardsigmoid`` (JAX :22, :44; slope
0.1667 by default here, as in JAX, where ``layers.hard_sigmoid`` has
0.2), and the aliases of layers the port has (``relu``, ``sigmoid``,
``softmax``, ``linear``, ``conv2d``, ``embedding``, ``dropout``,
``batch_norm``).  The other names of the JAX module raise
``NotImplementedError``."""
from __future__ import annotations

from .. import layers as _L
from ..layer_helper import LayerHelper

relu = _L.relu
sigmoid = _L.sigmoid
softmax = _L.softmax
hardswish = _L.hard_swish
linear = _L.fc
conv2d = _L.conv2d
embedding = _L.embedding
dropout = _L.dropout
batch_norm = _L.batch_norm


def hardsigmoid(x, slope=0.1667, offset=0.5, name=None):
    helper = LayerHelper("hard_sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("hard_sigmoid", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"slope": float(slope), "offset": float(offset)})
    return out


def _unported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"nn.functional.{name} is not ported "
                                  f"(ROADMAP.md)")

    fn.__name__ = name
    return fn


for _name in ("relu6", "tanh", "log_softmax", "leaky_relu", "gelu", "swish",
              "prelu", "softplus", "softsign", "elu", "silu",
              "conv2d_transpose", "layer_norm", "one_hot", "pad",
              "interpolate", "upsample", "avg_pool2d", "max_pool2d",
              "adaptive_avg_pool2d", "adaptive_max_pool2d", "cross_entropy",
              "square_error_cost", "mse_loss", "kl_div", "log_loss",
              "smooth_l1_loss", "binary_cross_entropy_with_logits",
              "label_smooth", "normalize", "l1_loss", "nll_loss"):
    globals()[_name] = _unported(_name)
del _name
