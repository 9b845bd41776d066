"""Tensor-creation layers (counterpart of ``paddle_tpu/layers/tensor.py``:
``create_parameter`` :18, ``create_global_var`` :30, ``fill_constant``
:49, ``cast`` :130, ``concat`` :136)."""
from __future__ import annotations

from ..framework.dtype import convert_dtype
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "fill_constant",
           "cast", "concat"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, convert_dtype(dtype),
                                   is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=convert_dtype(dtype), shape=tuple(shape),
        persistable=persistable, name=name or helper.name,
        stop_gradient=True)
    startup = helper.startup_program.global_block()
    startup.create_var(name=var.name, shape=tuple(shape),
                       dtype=convert_dtype(dtype), persistable=persistable)
    startup.append_op(
        "fill_constant", outputs={"Out": [var.name]},
        attrs={"shape": list(shape), "value": float(value),
               "dtype": int(var.dtype)})
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    helper.append_op(
        "fill_constant", outputs={"Out": [out]},
        attrs={"shape": list(shape), "value": float(value),
               "dtype": int(dtype)})
    return out


def cast(x, dtype):
    from . import nn

    return nn.cast(x, dtype)


def concat(input, axis=0, name=None):
    from . import nn

    return nn.concat(input, axis, name)
