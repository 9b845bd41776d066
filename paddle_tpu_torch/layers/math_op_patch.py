"""Python operators on static ``Variable``s (counterpart of
``paddle_tpu/layers/math_op_patch.py:12-50, 208-240``; reference:
``fluid/layers/math_op_patch.py:58 monkey_patch_variable``).

``+ - * / ** % //`` append the ``elementwise_*`` ops; a Python scalar
operand of ``+ - * /`` becomes a ``scale`` op (``x * scale + bias``),
any other scalar a ``[1]`` ``fill_constant`` of the variable's dtype, as
in JAX.  The comparisons append ``equal`` ... ``greater_equal``, whose
outputs are bool.  So ``__eq__`` builds an op, and a ``Variable`` hashes
by identity.  Indexing (``__getitem__``, JAX :56-205) is not ported.
"""
from __future__ import annotations

from ..framework.core import Variable
from ..layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]


def _create_op(op_type, x, y, axis=-1, reverse=False):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    a, b = (y, x) if reverse else (x, y)
    helper.append_op(op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def _scalar_op(x, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _to_var(x, ref: Variable):
    """A Python scalar as a ``[1]`` filled constant of ``ref``'s dtype."""
    from . import tensor as tensor_layers

    return tensor_layers.fill_constant([1], ref.dtype, float(x))


def _binary(op_type, reverse=False, scalar_fn=None):
    def impl(self, other):
        if isinstance(other, (int, float)):
            if scalar_fn is not None:
                return scalar_fn(self, other)
            other = _to_var(other, self)
        elif not isinstance(other, Variable):
            return NotImplemented
        return _create_op(op_type, self, other, reverse=reverse)

    return impl


def _getitem(self, item):
    raise NotImplementedError("indexing a static Variable (slice, "
                              "strided_slice, gather) is not ported "
                              "(ROADMAP.md)")


def monkey_patch_variable():
    Variable.__getitem__ = _getitem
    Variable.__add__ = _binary("elementwise_add",
                               scalar_fn=lambda x, s: _scalar_op(x, 1.0, s))
    Variable.__radd__ = Variable.__add__
    Variable.__sub__ = _binary("elementwise_sub",
                               scalar_fn=lambda x, s: _scalar_op(x, 1.0, -s))
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True,
                                scalar_fn=lambda x, s: _scalar_op(x, -1.0, s))
    Variable.__mul__ = _binary("elementwise_mul",
                               scalar_fn=lambda x, s: _scalar_op(x, s, 0.0))
    Variable.__rmul__ = Variable.__mul__
    Variable.__truediv__ = _binary(
        "elementwise_div",
        scalar_fn=lambda x, s: _scalar_op(x, 1.0 / s, 0.0))
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__rpow__ = _binary("elementwise_pow", reverse=True)
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
    for name, op_type in (("__eq__", "equal"), ("__ne__", "not_equal"),
                          ("__lt__", "less_than"), ("__le__", "less_equal"),
                          ("__gt__", "greater_than"),
                          ("__ge__", "greater_equal")):
        setattr(Variable, name, _binary(op_type))
    Variable.__hash__ = lambda self: id(self)
