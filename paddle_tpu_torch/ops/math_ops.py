"""Math op lowerings of the static path (counterpart of
``paddle_tpu/ops/math_ops.py``: ``elementwise_add`` :50, ``relu`` :72,
``sum`` (gradient accumulation), ``mean`` :222, ``top_k`` :318 and
``mul`` :423).

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


@op("relu")
def _relu(ctx):
    ctx.set_out("Out", torch.relu(ctx.in_("X")))


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
