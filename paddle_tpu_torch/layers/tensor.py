"""Tensor-creation layers (counterpart of ``paddle_tpu/layers/tensor.py``:
``create_parameter`` :18, ``create_global_var`` :30, ``fill_constant``
:49, ``fill_constant_batch_size_like`` :61, ``zeros_like`` :83,
``assign`` :100, ``cast`` :130, ``concat`` :136, ``range`` :162)."""
from __future__ import annotations

from ..framework.core import Variable
from ..framework.dtype import convert_dtype
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "fill_constant",
           "fill_constant_batch_size_like", "zeros_like", "assign", "cast",
           "concat", "range"]


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        "fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "value": float(value),
               "dtype": int(dtype), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        stop_gradient=True)
    helper.append_op("fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def range(start, end, step, dtype="float32"):
    """``arange(start, end, step)``; each bound a Variable or a number
    (a ``[1]`` ``fill_constant`` of ``dtype``)."""
    helper = LayerHelper("range")
    s, e, st = (v if isinstance(v, Variable) else fill_constant([1], dtype, v)
                for v in (start, end, step))
    out = helper.create_variable_for_type_inference(convert_dtype(dtype),
                                                    stop_gradient=True)
    helper.append_op("range", inputs={"Start": [s], "End": [e],
                                      "Step": [st]},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """``output`` (a new var by default) := ``input``, a Variable (the
    ``assign`` op).  A numpy ``input`` (the ``assign_value`` op) is not
    ported."""
    if not isinstance(input, Variable):
        raise NotImplementedError("assign of a numpy array (the "
                                  "assign_value op) is not ported")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def cast(x, dtype):
    from . import nn

    return nn.cast(x, dtype)


def concat(input, axis=0, name=None):
    from . import nn

    return nn.concat(input, axis, name)
