"""fluid.layers NN graph builders (counterpart of
``paddle_tpu/layers/nn.py``: ``fc`` :22, ``embedding`` :60, ``conv2d``
:93 (a ``depthwise_conv2d`` where groups equal the channels, :125-129),
``pool2d`` :201, ``batch_norm`` :257, ``softmax`` :382, ``relu`` and
``sigmoid`` :409-410, ``exp``, ``ceil``, ``floor`` and ``cos`` :414-421,
``hard_swish`` :463, the ``elementwise_*`` family :522-530,
``layer_norm`` :318, ``dropout`` :356, ``log_softmax`` :390, the unary
``tanh``, ``square``, ``rsqrt`` and ``erf`` :411-427, ``gelu`` :447,
``mul`` :489, ``matmul`` :499, the ``reduce_*`` layers :533-555,
``mean`` :558, ``scale`` :565, ``clip`` and ``clip_by_norm`` :574-590,
``cross_entropy`` :603, ``softmax_with_cross_entropy`` :614,
``reshape`` :718, ``squeeze`` :728, ``unsqueeze`` :738, ``flatten``
:748, ``transpose`` :758, ``stack`` :768, ``unstack`` :777, ``split``
:787, ``expand`` :802, ``gather`` :810, ``slice`` :835, ``one_hot``
:862, ``topk`` :870, ``where`` :908, ``shape`` :948, ``cast`` :955,
``concat`` :964, ``accuracy`` :980, ``fused_multihead_attention``
:1105; ``hard_sigmoid``: ``paddle_tpu/layers/nn_tail.py:59``; and the
layers of the activation, norm, pad, interpolation and loss ops:
``conv2d_transpose`` :155, ``adaptive_pool2d`` :239, the unary
``sqrt``, ``abs``, ``log``, ``round``, ``sin``, ``softplus``,
``softsign``, ``reciprocal``, ``logsigmoid`` and ``sign`` :412-428,
``relu6`` :431, ``leaky_relu`` :439, ``swish`` :455, ``prelu`` :471,
``l2_normalize`` :590, ``sigmoid_cross_entropy_with_logits`` :638,
``square_error_cost`` :651, ``smooth_l1`` :661, ``huber_loss`` :676,
``log_loss`` :686, ``mse_loss`` :694, ``kldiv_loss`` :698,
``label_smooth`` :706, ``pad`` :844, ``pad2d`` :852, ``argmax`` /
``argmin`` / ``argsort`` :882-905, ``resize_bilinear`` :920,
``resize_nearest`` :934, ``increment`` :1034, ``cos_sim`` :1042;
``mean_iou``: ``paddle_tpu/layers/nn_tail.py:708``).  Each
builds vars and ops through ``LayerHelper`` with the JAX package's op
types, slots and attrs, so both packages build the same program."""
from __future__ import annotations

import numpy as np

from ..framework.dtype import VarType, convert_dtype
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "softmax",
           "relu", "sigmoid", "exp", "ceil", "floor", "cos", "hard_swish",
           "hard_sigmoid", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "elementwise_mod",
           "elementwise_floordiv", "where", "mean", "scale", "clip",
           "clip_by_norm", "softmax_with_cross_entropy", "reshape", "topk",
           "cast", "concat", "accuracy", "dropout", "layer_norm",
           "log_softmax", "tanh", "square", "rsqrt", "erf", "gelu", "mul",
           "matmul", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "reduce_all", "reduce_any", "cross_entropy",
           "squeeze", "unsqueeze", "flatten", "transpose", "stack",
           "unstack", "split", "expand", "gather", "slice", "one_hot",
           "shape", "fused_multihead_attention", "conv2d_transpose",
           "adaptive_pool2d", "sqrt", "abs", "log", "round", "sin",
           "softplus", "softsign", "reciprocal", "logsigmoid", "sign",
           "relu6", "leaky_relu", "swish", "prelu", "l2_normalize",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "smooth_l1", "huber_loss", "log_loss", "mse_loss", "kldiv_loss",
           "label_smooth", "pad", "pad2d", "argmax", "argmin", "argsort",
           "resize_bilinear", "resize_nearest", "increment", "cos_sim",
           "mean_iou"]


def _single(x, n=2):
    return [x] * n if isinstance(x, int) else list(x)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """mul (+ sum over several inputs) + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = inputs[0].dtype
    mul_results = []
    for inp in inputs:
        flat = int(np.prod([s if s >= 0 else -s
                            for s in inp.shape[num_flatten_dims:]]))
        w = helper.create_parameter(param_attr, shape=[flat, size],
                                    dtype=dtype)
        out = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            "mul", inputs={"X": [inp], "Y": [w]}, outputs={"Out": [out]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference: layers/nn.py embedding (lookup_table op)."""
    if is_distributed:
        raise NotImplementedError("embedding(is_distributed=True): the "
                                  "parameter-server path is not ported")
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=size, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None
                   else padding_idx if padding_idx >= 0
                   else size[0] + padding_idx)
    helper.append_op(
        "lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse,
               "is_distributed": is_distributed})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    channel_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[channel_axis]
    fsize = _single(filter_size)
    stride = _single(stride)
    dilation = _single(dilation)
    padding_algorithm = "EXPLICIT"
    if isinstance(padding, str):
        padding_algorithm = padding.upper()
        padding = [0, 0]
    else:
        padding = _single(padding)
    op_type = ("depthwise_conv2d" if groups == num_channels
               and num_filters % num_channels == 0 and groups != 1
               else "conv2d")
    filter_shape = [num_filters, num_channels // groups] + fsize
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    default_init = NormalInitializer(0.0, (2.0 / fan_in) ** 0.5)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype,
                                default_initializer=default_init)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "data_format": data_format,
               "padding_algorithm": padding_algorithm})
    pre_act = helper.append_bias_op(out, dim_start=channel_axis,
                                    dim_end=channel_axis + 1,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, data_format="NCHW", name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    padding_algorithm = "EXPLICIT"
    if isinstance(pool_padding, str):
        padding_algorithm = pool_padding.upper()
        pool_padding = [0, 0]
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _single(pool_size),
               "strides": _single(pool_stride),
               "paddings": _single(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format,
               "padding_algorithm": padding_algorithm})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    """A ``conv2d_transpose`` op with a (C_in, num_filters / groups, *k)
    filter, + bias + act; ``filter_size`` is required, as in JAX
    (``output_size`` alone raises ``ValueError``)."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    if filter_size is None:
        raise ValueError("filter_size required (output_size-only not "
                         "supported yet)")
    w = helper.create_parameter(
        param_attr, shape=[input.shape[1], num_filters // groups]
        + _single(filter_size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _single(stride), "paddings": _single(padding),
               "dilations": _single(dilation), "groups": groups,
               "data_format": data_format})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    """A ``pool2d`` op with ``adaptive``: ``pool_size`` is the output
    size, which must divide the input's (as in JAX)."""
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _single(pool_size),
               "adaptive": True, "strides": [1, 1], "paddings": [0, 0]})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    helper = LayerHelper("batch_norm", name=name, act=act)
    dtype = input.dtype
    channel_axis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    c = input.shape[channel_axis]
    scale = helper.create_parameter(
        ParamAttr._to_attr(param_attr), shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(ParamAttr._to_attr(bias_attr), shape=[c],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype=dtype, default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=[c],
        dtype=dtype, default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True

    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        "dropout", inputs={"X": [x]}, outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "fix_seed": seed is not None, "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def _simple_unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    fn.__name__ = op_type
    return fn


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """LayerNorm over the axes from ``begin_norm_axis``, with a Scale
    (ones) and a Bias (zeros) of their flattened size."""
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, shape=norm_shape, dtype=dtype, is_bias=True)]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(y, act)


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


relu = _simple_unary("relu")
sigmoid = _simple_unary("sigmoid")
exp = _simple_unary("exp")
ceil = _simple_unary("ceil")
floor = _simple_unary("floor")
cos = _simple_unary("cos")
tanh = _simple_unary("tanh")
square = _simple_unary("square")
rsqrt = _simple_unary("rsqrt")
erf = _simple_unary("erf")
sqrt = _simple_unary("sqrt")
abs = _simple_unary("abs")
log = _simple_unary("log")
round = _simple_unary("round")
sin = _simple_unary("sin")
softplus = _simple_unary("softplus")
softsign = _simple_unary("softsign")
reciprocal = _simple_unary("reciprocal")
logsigmoid = _simple_unary("logsigmoid")
sign = _simple_unary("sign")


def _unary_with(op_type, x, attrs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def relu6(x, threshold=6.0, name=None):
    return _unary_with("relu6", x, {"threshold": threshold}, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_with("leaky_relu", x, {"alpha": alpha}, name)


def swish(x, beta=1.0, name=None):
    return _unary_with("swish", x, {"beta": beta}, name)


def prelu(x, mode, param_attr=None, name=None):
    """``where(x > 0, x, alpha * x)`` with a learnt alpha (0.25 at
    start): one scalar, one per channel or one per element."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def gelu(x, approximate=False):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def _reduce_layer(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"reduce_all": False, "dim": list(dims),
                     "keep_dim": keep_dim}
        helper.append_op(op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    fn.__name__ = op_type
    return fn


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    helper = LayerHelper("hard_swish", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("hard_swish", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"threshold": threshold, "scale": scale,
                            "offset": offset})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    helper = LayerHelper("hard_sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("hard_sigmoid", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"slope": slope, "offset": offset})
    return out


def _elementwise(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)

    fn.__name__ = op_type
    return fn


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")
elementwise_mod = _elementwise("elementwise_mod")
elementwise_floordiv = _elementwise("elementwise_floordiv")


def where(condition, x, y=None, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", inputs={"Condition": [condition], "X": [x],
                                      "Y": [y]},
                     outputs={"Out": [out]})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "numeric_stable_mode": numeric_stable_mode, "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def _with_xshape(op_type, x, attrs, name=None):
    """An op of ``op_type`` on ``x`` with an Out and an XShape."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _with_xshape("squeeze2", input, {"axes": list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _with_xshape("unsqueeze2", input, {"axes": list(axes)}, name)


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", x, {"axis": axis}, name)


def transpose(x, perm, name=None):
    return _with_xshape("transpose2", x, {"axis": list(perm)}, name)


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("stack", inputs={"X": xs}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "decrease_axis": []})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(VarType.FP32)
    helper.append_op("one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(VarType.INT32,
                                                    stop_gradient=True)
    helper.append_op("shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def fused_multihead_attention(q, k, v, bias_qk=None, scale=0.0, causal=False,
                              dropout_rate=0.0, name=None):
    """Scaled dot-product attention over (b, heads, seq, head_dim) q, k, v
    (``ops/fused_ops.py``: kernels 1-5 for no bias or a padding bias).
    ``dropout_rate > 0`` drops attention probabilities inside the kernels
    from a per-step seed, the ``Seed`` output; ``Lse`` saves the
    forward's log-sum-exp for the grad."""
    helper = LayerHelper("fused_multihead_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias_qk is not None:
        inputs["BiasQK"] = [bias_qk]
    outputs = {"Out": [out]}
    if dropout_rate > 0.0:
        outputs["Seed"] = [
            helper.create_variable_for_type_inference("float32")]
    outputs["Lse"] = [helper.create_variable_for_type_inference("float32")]
    helper.append_op("fused_multihead_attention", inputs=inputs,
                     outputs=outputs,
                     attrs={"scale": float(scale), "causal": bool(causal),
                            "dropout_rate": float(dropout_rate)})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": int(x.dtype), "out_dtype": int(dtype)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    xs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("concat", inputs={"X": xs}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(VarType.INT64)
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": int(k)})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """reference: layers/metric_op.py accuracy (top_k + accuracy ops)."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(VarType.FP32)
    correct = correct or helper.create_variable_for_type_inference(
        VarType.INT32)
    total = total or helper.create_variable_for_type_inference(VarType.INT64)
    helper.append_op(
        "accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    acc_out.stop_gradient = True
    return acc_out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x / sqrt(reduce_sum(x * x, axis))`` as JAX builds it (its
    ``epsilon`` is not read)."""
    s = reduce_sum(square(x), dim=axis, keep_dim=True)
    helper = LayerHelper("l2_normalize", name=name)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sqrt", inputs={"X": [s]}, outputs={"Out": [norm]})
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_div", inputs={"X": [x], "Y": [norm]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def cos_sim(X, Y):
    xn = l2_normalize(X, axis=-1)
    yn = l2_normalize(Y, axis=-1)
    helper = LayerHelper("cos_sim")
    prod = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("elementwise_mul", inputs={"X": [xn], "Y": [yn]},
                     outputs={"Out": [prod]}, attrs={"axis": -1})
    return reduce_sum(prod, dim=-1, keep_dim=True)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


# -- losses ------------------------------------------------------------------
def _loss(op_type, inputs, out_slot, attrs, dtype, extra_outs=(),
          name=None):
    """One loss op: its ``out_slot`` var, and a var for each of
    ``extra_outs`` (the residual-like outputs JAX's layers also bind)."""
    helper = LayerHelper(op_type, name=name)
    outs = {slot: [helper.create_variable_for_type_inference(dtype)]
            for slot in tuple(extra_outs) + (out_slot,)}
    helper.append_op(op_type, inputs=inputs, outputs=outs, attrs=attrs)
    return outs[out_slot][0]


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    return _loss("sigmoid_cross_entropy_with_logits",
                 {"X": [x], "Label": [label]}, "Out",
                 {"ignore_index": ignore_index, "normalize": normalize},
                 x.dtype, name=name)


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("elementwise_sub", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [diff]}, attrs={"axis": -1})
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square", inputs={"X": [diff]}, outputs={"Out": [out]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    return _loss("smooth_l1_loss", inputs, "Out", {"sigma": sigma or 1.0},
                 x.dtype, extra_outs=("Diff",))


def huber_loss(input, label, delta):
    return _loss("huber_loss", {"X": [input], "Y": [label]}, "Out",
                 {"delta": delta}, input.dtype, extra_outs=("Residual",))


def log_loss(input, label, epsilon=1e-4, name=None):
    return _loss("log_loss", {"Predicted": [input], "Labels": [label]},
                 "Loss", {"epsilon": epsilon}, input.dtype, name=name)


def mse_loss(input, label):
    return mean(square_error_cost(input, label))


def kldiv_loss(x, target, reduction="mean", name=None):
    return _loss("kldiv_loss", {"X": [x], "Target": [target]}, "Loss",
                 {"reduction": reduction}, x.dtype, name=name)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    return _loss("label_smooth", inputs, "Out", {"epsilon": float(epsilon)},
                 dtype, name=name)


# -- pads, arg ops and resizes ------------------------------------------------
def pad(x, paddings, pad_value=0.0, name=None):
    return _unary_with("pad", x, {"paddings": list(paddings),
                                  "pad_value": float(pad_value)}, name)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _unary_with("pad2d", input, {
        "paddings": list(paddings), "mode": mode,
        "pad_value": float(pad_value), "data_format": data_format}, name)


def _arg(op_type, x, axis, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(VarType.INT64,
                                                    stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmax(x, axis=0, name=None):
    return _arg("arg_max", x, axis, name)


def argmin(x, axis=0, name=None):
    return _arg("arg_min", x, axis, name)


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ids = helper.create_variable_for_type_inference(VarType.INT64,
                                                    stop_gradient=True)
    helper.append_op("argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def _resize(op_type, input, out_shape, scale, name, attrs):
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    return _unary_with(op_type, input, attrs, name)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1, data_format="NCHW"):
    """A ``bilinear_interp`` op; its lowering resizes as JAX's does
    (half-pixel centres whatever ``align_corners``)."""
    return _resize("bilinear_interp", input, out_shape, scale, name,
                   {"align_corners": align_corners,
                    "align_mode": align_mode})


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True, data_format="NCHW"):
    return _resize("nearest_interp", input, out_shape, scale, name,
                   {"align_corners": align_corners})


def mean_iou(input, label, num_classes):
    """(mean IoU f32, wrong and correct counts per class) of the
    predicted class ids ``input`` against ``label``."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference(VarType.FP32)
    wrong = helper.create_variable_for_type_inference(VarType.INT32)
    correct = helper.create_variable_for_type_inference(VarType.INT32)
    helper.append_op("mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct
