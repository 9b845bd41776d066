"""LayerHelper: shared machinery of the static layers functions
(counterpart of ``paddle_tpu/layer_helper.py``; reference:
python/paddle/fluid/layer_helper.py).

Creates parameters (with their init ops in the startup program), temp
output vars, and appends ops to the current main program.  The port's
dygraph layers are ``nn.Module``s (``dygraph/``) and do not come here.
"""
from __future__ import annotations

from typing import Optional

from .framework import unique_name
from .framework.core import (Variable, default_main_program,
                             default_startup_program)
from .framework.dtype import VarType, convert_dtype
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        if name is None:
            name = unique_name.generate(layer_type)
        self.name = name

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # ------------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=convert_dtype(dtype) if dtype is not None else None,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    # ------------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype=VarType.FP32,
                         is_bias: bool = False, default_initializer=None,
                         stop_gradient: bool = False
                         ) -> Optional[Variable]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer
        if init is None:
            init = default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            return main_block.var(attr.name)
        param = main_block.create_parameter(
            name=attr.name, shape=shape, dtype=convert_dtype(dtype),
            trainable=attr.trainable, regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate})
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(attr.name):
            startup_block.create_var(name=attr.name, shape=tuple(shape),
                                     dtype=convert_dtype(dtype),
                                     persistable=True)
            init(startup_block.var(attr.name), startup_block)
        return param

    # ------------------------------------------------------------------
    def append_activation(self, input_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"name": act}
        act = dict(act)
        act_type = act.pop("name")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out

    def append_bias_op(self, input_var, dim_start=1, dim_end=None,
                       bias_attr=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = (bias_attr if bias_attr is not None
                     else self.kwargs.get("bias_attr"))
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out
