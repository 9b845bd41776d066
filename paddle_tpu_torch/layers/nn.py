"""fluid.layers NN graph builders (counterpart of
``paddle_tpu/layers/nn.py``: ``fc`` :22, ``embedding`` :60, ``conv2d``
:93, ``pool2d`` :201, ``batch_norm`` :257, ``softmax`` :382, ``relu`` and
``sigmoid`` :409-410, ``elementwise_add`` :522, ``mean`` :558,
``softmax_with_cross_entropy`` :614, ``reshape`` :718, ``topk`` :870,
``cast`` :955, ``concat`` :964, ``accuracy`` :980).  Each builds vars and ops through
``LayerHelper`` with the JAX package's op types, slots and attrs, so both
packages build the same program."""
from __future__ import annotations

import numpy as np

from ..framework.dtype import VarType, convert_dtype
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "softmax",
           "relu", "sigmoid", "elementwise_add", "mean",
           "softmax_with_cross_entropy", "reshape", "topk", "cast", "concat",
           "accuracy"]


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
    if groups == num_channels and num_filters % num_channels == 0 \
            and groups != 1:
        raise NotImplementedError("depthwise_conv2d is not ported")
    filter_shape = [num_filters, num_channels // groups] + fsize
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    default_init = NormalInitializer(0.0, (2.0 / fan_in) ** 0.5)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=dtype,
                                default_initializer=default_init)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d", inputs={"Input": [input], "Filter": [w]},
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


relu = _simple_unary("relu")
sigmoid = _simple_unary("sigmoid")


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
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
