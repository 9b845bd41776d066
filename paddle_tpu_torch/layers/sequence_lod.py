"""fluid.layers' sequence functions for the static path (counterpart of
``paddle_tpu/layers/sequence_lod.py``): ``sequence_pool`` :29,
``sequence_first_step`` :41, ``sequence_last_step`` :45,
``sequence_softmax`` :49, ``sequence_conv`` :57, ``sequence_reverse``
:78 and ``sequence_mask`` :170.

A ragged batch is a padded ``[N, T, ...]`` tensor with an explicit
``length`` variable (``[N]`` ints); ``length=None`` means every row is
full length.  The module's other names (``sequence_expand``,
``sequence_pad``, ``row_conv`` and the rest) wait for their op types
(ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

from ..framework.core import Variable
from ..layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_conv", "sequence_reverse",
           "sequence_mask"]


def _maybe_len(inputs, length, slot="Length"):
    if length is not None:
        inputs[slot] = [length]
    return inputs


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0,
                  length=None):
    helper = LayerHelper("sequence_pool", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op("sequence_pool",
                     inputs=_maybe_len({"X": [input]}, length),
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper(),
                            "pad_value": pad_value})
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length=length)


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    helper = LayerHelper("sequence_softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_softmax",
                     inputs=_maybe_len({"X": [input]}, length),
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, length=None):
    """A context-window convolution along time (window ``filter_size``
    from ``padding_start``), then the bias and ``act``."""
    helper = LayerHelper("sequence_conv", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        param_attr, shape=[filter_size * input.shape[-1], num_filters],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    if padding_start is None:
        padding_start = -((filter_size - 1) // 2)
    helper.append_op("sequence_conv",
                     inputs=_maybe_len({"X": [input], "Filter": [w]},
                                       length),
                     outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": padding_start,
                            "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, dim_start=2, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def sequence_reverse(x, name=None, length=None):
    helper = LayerHelper("sequence_reverse", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_reverse",
                     inputs=_maybe_len({"X": [x]}, length),
                     outputs={"Y": [out]}, attrs={})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    inputs = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if isinstance(maxlen, Variable):
        inputs["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = -1 if maxlen is None else int(maxlen)
    helper.append_op("sequence_mask", inputs=inputs, outputs={"Y": [out]},
                     attrs=attrs)
    return out

