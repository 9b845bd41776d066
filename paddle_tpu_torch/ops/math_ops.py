"""Math op lowerings of the static path (counterpart of
``paddle_tpu/ops/math_ops.py``: the ``elementwise_*`` family :49-59,
``relu`` :72, ``sigmoid`` :74, ``sqrt`` :78, ``ceil`` / ``floor`` /
``cos`` / ``exp`` :81-92, ``reciprocal`` :99, ``sign`` :102,
``hard_sigmoid`` and ``hard_swish`` :114-125, ``scale`` :154, ``clip``
and ``clip_by_norm`` :185-205 (dense), ``sum`` (gradient accumulation),
``mean`` :222, ``top_k`` :318, the comparisons :351-356,
``mul`` :423 and ``increment`` :494).

``mul``, ``hard_swish`` and ``hard_sigmoid`` have explicit grad
lowerings; the others take the registry's generic vjp replay, whose
forward is one cheap pass.  The comparisons have no grad, as in JAX.
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


def _elementwise(fn):
    def lower(ctx):
        x, y = align(ctx.in_("X"), ctx.in_("Y"), ctx.attr("axis", -1))
        ctx.set_out("Out", fn(x, y))

    return lower


# jnp.mod and jnp.floor_divide round toward -inf, as torch.remainder and
# torch.floor_divide do; jnp.maximum / minimum and torch's split a tied
# gradient in halves
for _name, _fn in (("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_mod", torch.remainder),
                   ("elementwise_floordiv", torch.floor_divide)):
    op(_name)(_elementwise(_fn))

for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt),
                   ("greater_equal", torch.ge)):
    op(_name, no_grad=True)(_elementwise(_fn))


def _unary(fn):
    def lower(ctx):
        ctx.set_out("Out", fn(ctx.in_("X")))

    return lower


for _name, _fn in (("relu", torch.relu), ("sigmoid", torch.sigmoid),
                   ("reciprocal", torch.reciprocal), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("exp", torch.exp), ("sign", torch.sign),
                   ("sqrt", torch.sqrt)):
    op(_name)(_unary(_fn))


@op("clip")
def _clip(ctx):
    """``X`` clamped into [min, max] (the attrs, or the ``Min`` /
    ``Max`` tensors)."""
    lo = ctx.in_("Min") if ctx.has_input("Min") else ctx.attr("min", 0.0)
    hi = ctx.in_("Max") if ctx.has_input("Max") else ctx.attr("max", 0.0)
    ctx.set_out("Out", torch.clamp(ctx.in_("X"), lo, hi))


@op("clip_by_norm")
def _clip_by_norm(ctx):
    """``X * (max_norm / |X|)`` where the whole tensor's L2 norm exceeds
    ``max_norm``, else ``X`` (a ``torch.where``: no host read)."""
    x = ctx.in_("X")
    max_norm = ctx.attr("max_norm", 1.0)
    norm = torch.sqrt((x * x).sum())
    ctx.set_out("Out", torch.where(norm > max_norm, x * (max_norm / norm),
                                   x))


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


def _reciprocal_of(v: float, x: torch.Tensor) -> float:
    """``1 / v`` as XLA's CPU compiles JAX's ``/ v``: a product with the
    reciprocal, which is float32's in an f32 or bf16 computation (XLA
    computes bf16 in f32 and rounds each op) and float16's in fp16."""
    r = 1.0 / v
    if x.dtype == torch.float16:
        return _in_dtype(r, x)
    return float(torch.tensor(r, dtype=torch.float32))


def _fma(a, b, c):
    """``a * b + c`` rounded once to a's dtype where XLA's CPU contracts
    the product and the sum into one fused multiply-add (f32, computed
    here in float64, and fp16, in float32, where its products are
    exact), and rounded after each op in bf16, which XLA computes in f32
    and rounds op by op."""
    if a.dtype == torch.bfloat16:
        return a * b + c
    wide = torch.float32 if a.dtype == torch.float16 else torch.float64
    b = b.to(wide) if isinstance(b, torch.Tensor) else b
    c = c.to(wide) if isinstance(c, torch.Tensor) else c
    return (a.to(wide) * b + c).to(a.dtype)


def _clip_factor(u, lo, hi):
    """d clip(u, lo, hi) / du as JAX's vjp of ``jnp.clip`` (a maximum,
    then a minimum) gives it: 1 inside, 0 outside, and half at each tie,
    where the max and the min split the gradient between their operands
    (``F.hardswish``'s grad has no such halves)."""
    m = torch.clamp(u, min=lo)
    a = (u > lo).to(u.dtype) + 0.5 * (u == lo).to(u.dtype)
    b = (m < hi).to(u.dtype) + 0.5 * (m == hi).to(u.dtype)
    return a * b


def _hard_swish_parts(ctx):
    x = ctx.in_("X")
    t = _in_dtype(float(ctx.attr("threshold", 6.0)), x)
    u = x + _in_dtype(float(ctx.attr("offset", 3.0)), x)
    return x, u, t, _reciprocal_of(float(ctx.attr("scale", 6.0)), x)


@op("hard_swish")
def _hard_swish(ctx):
    """``x * clip(x + offset, 0, threshold) / scale`` (JAX
    ``math_ops.py:120``), in x's dtype, each op rounded as XLA's CPU
    rounds it."""
    x, u, t, r = _hard_swish_parts(ctx)
    ctx.set_out("Out", x * torch.clamp(u, 0.0, t) * r)


@op("hard_swish_grad", no_grad=True)
def _hard_swish_grad(ctx):
    """JAX's vjp: ``g/scale * c + g/scale * x * dc/du`` with ``c`` the
    clip and JAX's half gradient at each edge of the clip."""
    x, u, t, r = _hard_swish_parts(ctx)
    gs = ctx.in_("Out" + GRAD_SUFFIX).to(x.dtype) * r
    ctx.set_out("X" + GRAD_SUFFIX, _fma(torch.clamp(u, 0.0, t), gs,
                                         x * gs * _clip_factor(u, 0.0, t)))


def _hard_sigmoid_parts(ctx):
    x = ctx.in_("X")
    slope = _in_dtype(float(ctx.attr("slope", 0.2)), x)
    return x, _fma(x, slope, _in_dtype(float(ctx.attr("offset", 0.5)),
                                       x)), slope


@op("hard_sigmoid")
def _hard_sigmoid(ctx):
    """``clip(slope * x + offset, 0, 1)`` (JAX ``math_ops.py:114``)."""
    _, u, _ = _hard_sigmoid_parts(ctx)
    ctx.set_out("Out", torch.clamp(u, 0.0, 1.0))


@op("hard_sigmoid_grad", no_grad=True)
def _hard_sigmoid_grad(ctx):
    x, u, slope = _hard_sigmoid_parts(ctx)
    g = ctx.in_("Out" + GRAD_SUFFIX).to(x.dtype)
    ctx.set_out("X" + GRAD_SUFFIX, g * _clip_factor(u, 0.0, 1.0) * slope)


@op("increment")
def _increment(ctx):
    """``x + step`` in x's dtype: a new tensor, which the executor copies
    into the scope's own (``@LR_DECAY_COUNTER@`` advances in place, so a
    captured step's replays advance it too)."""
    x, step = ctx.in_("X"), float(ctx.attr("step", 1.0))
    ctx.set_out("Out", x + (_in_dtype(step, x) if x.is_floating_point()
                            else int(step)))


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
