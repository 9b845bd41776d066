"""Math op lowerings of the static path (counterpart of
``paddle_tpu/ops/math_ops.py``: ``elementwise_add`` and
``elementwise_mul`` :50-52, ``relu`` :72, ``sigmoid`` :74, ``reciprocal``
:99, ``scale`` :154, ``sum`` (gradient accumulation), ``mean`` :222,
``top_k`` :318 and ``mul`` :423).

``mul`` has an explicit grad lowering (two matrix products); the others
take the registry's generic vjp replay, whose forward is one cheap pass.
"""
from __future__ import annotations

import math

import torch

from ..framework.core import GRAD_SUFFIX
from .registry import op

__all__ = ["align"]


def align(x, y, axis):
    """Paddle's elementwise broadcast: ``y`` aligned to ``x`` starting at
    ``axis`` (reference: operators/elementwise/elementwise_op_function.h)."""
    xd, yd = x.dim(), y.dim()
    if yd > xd:  # symmetric case: align x to y
        y2, x2 = align(y, x, axis)
        return x2, y2
    if axis is None or axis == -1:
        axis = xd - yd
    if yd < xd:
        y = y.reshape((1,) * axis + tuple(y.shape) + (1,) * (xd - axis - yd))
    return x, y


@op("elementwise_add")
def _elementwise_add(ctx):
    x, y = align(ctx.in_("X"), ctx.in_("Y"), ctx.attr("axis", -1))
    ctx.set_out("Out", x + y)


@op("elementwise_mul")
def _elementwise_mul(ctx):
    x, y = align(ctx.in_("X"), ctx.in_("Y"), ctx.attr("axis", -1))
    ctx.set_out("Out", x * y)


@op("reciprocal")
def _reciprocal(ctx):
    ctx.set_out("Out", torch.reciprocal(ctx.in_("X")))


def _in_dtype(v: float, x: torch.Tensor) -> float:
    """The python scalar ``v`` as JAX's weak typing hands it to an op on
    ``x``: rounded to x's floating dtype (float16 and bfloat16 products
    then see the rounded factor, as in JAX)."""
    return float(torch.tensor(v, dtype=x.dtype))


@op("scale")
def _scale(ctx):
    """``x * scale + bias`` (or ``(x + bias) * scale``) in x's dtype: an
    integer x stays integer for integer-valued scale and bias, as in the
    reference's scale_op.  A zero bias adds nothing (XLA drops the add of
    zero from the JAX lowering, which would turn -0 into +0)."""
    x = ctx.in_("X")
    s = (ctx.in_("ScaleTensor") if ctx.has_input("ScaleTensor")
         else float(ctx.attr("scale", 1.0)))
    b = float(ctx.attr("bias", 0.0))
    if x.is_floating_point():
        b = _in_dtype(b, x)
        if not isinstance(s, torch.Tensor):
            s = _in_dtype(s, x)
    elif (not isinstance(s, torch.Tensor) and s.is_integer()
          and b.is_integer()):
        s, b = int(s), int(b)
    if ctx.attr("bias_after_scale", True):
        out = x * s + b if b else x * s
    else:
        out = (x + b) * s if b else x * s
    ctx.set_out("Out", out)


@op("relu")
def _relu(ctx):
    ctx.set_out("Out", torch.relu(ctx.in_("X")))


@op("sigmoid")
def _sigmoid(ctx):
    ctx.set_out("Out", torch.sigmoid(ctx.in_("X")))


@op("sum")
def _sum(ctx):
    xs = [v for v in ctx.ins("X") if v is not None]
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    ctx.set_out("Out", out)


@op("mean")
def _mean(ctx):
    ctx.set_out("Out", torch.mean(ctx.in_("X")))


@op("top_k", no_grad=True)
def _top_k(ctx):
    x = ctx.in_("X")
    if ctx.has_input("K"):
        raise NotImplementedError("top_k with a K input is not ported")
    vals, idxs = torch.topk(x, int(ctx.attr("k", 1)), dim=-1)
    ctx.set_out("Out", vals)
    ctx.set_out("Indices", idxs)


def _mul_2d(x, y, xnc, ync):
    xm = x.reshape(math.prod(x.shape[:xnc]), -1)
    ym = y.reshape(math.prod(y.shape[:ync]), -1)
    return xm, ym


@op("mul")
def _mul(ctx):
    """Flattening matmul (reference: mul_op.cc — x_num_col_dims)."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    xnc, ync = ctx.attr("x_num_col_dims", 1), ctx.attr("y_num_col_dims", 1)
    xm, ym = _mul_2d(x, y, xnc, ync)
    out = torch.matmul(xm, ym)
    ctx.set_out("Out", out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


@op("mul_grad", no_grad=True)
def _mul_grad(ctx):
    """dX = dOut @ Y^T and dY = X^T @ dOut, on the flattened 2-D views."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    dout = ctx.in_("Out" + GRAD_SUFFIX)
    xnc, ync = ctx.attr("x_num_col_dims", 1), ctx.attr("y_num_col_dims", 1)
    xm, ym = _mul_2d(x, y, xnc, ync)
    dm = dout.reshape(xm.shape[0], ym.shape[1])
    if ctx.has_output("X" + GRAD_SUFFIX):
        ctx.set_out("X" + GRAD_SUFFIX, (dm @ ym.t()).reshape(x.shape))
    if ctx.has_output("Y" + GRAD_SUFFIX):
        ctx.set_out("Y" + GRAD_SUFFIX, (xm.t() @ dm).reshape(y.shape))
