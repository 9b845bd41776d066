"""Creation, random and shape op lowerings of the static path
(counterpart of ``paddle_tpu/ops/tensor_ops.py``: ``fill_constant`` :36,
``gaussian_random`` :70, ``uniform_random`` :81, ``cast`` :192,
``reshape2`` :214 with its shape inference :228, ``transpose2`` :254,
``concat`` :332).  The shape ops' and ``cast``'s grads are the registry's
generic vjp replay, as in JAX: a cast's cotangent is cast back to the
input's dtype, so an f32 parameter read through a bf16 cast gets an f32
gradient.

Random ops draw from the executor's ``torch.Generator`` (seeded from the
program's ``random_seed``), or from a generator of their own when the op
carries a nonzero ``seed`` attr, as the JAX lowerings key their draw.
The numbers are not JAX's: the two streams differ, so parity tests carry
the startup scope across instead.  Under shape inference (``meta``
device, no generator) they allocate nothing.
"""
from __future__ import annotations

import math

import torch

from ..framework.dtype import VarType, convert_dtype, to_torch_dtype
from ..framework.random import default_generator
from .registry import infer_for, op

__all__ = []


def _attr_dtype(ctx, default=VarType.FP32) -> torch.dtype:
    d = ctx.attr("dtype", int(default))
    if isinstance(d, str):
        return to_torch_dtype(convert_dtype(d))
    return to_torch_dtype(VarType(int(d)))


def _shape_attr(ctx):
    if ctx.has_input("ShapeTensor"):
        raise NotImplementedError("fill ops with a ShapeTensor input are "
                                  "not ported")
    return [int(s) for s in ctx.attr("shape", [])]


def _device(ctx) -> torch.device:
    return ctx.device if ctx.device is not None else torch.device("cpu")


@op("fill_constant", no_grad=True)
def _fill_constant(ctx):
    if ctx.has_input("ValueTensor"):
        raise NotImplementedError("fill_constant with a ValueTensor input "
                                  "is not ported")
    ctx.set_out("Out", torch.full(_shape_attr(ctx), ctx.attr("value", 0.0),
                                  dtype=_attr_dtype(ctx),
                                  device=_device(ctx)))


def _random_f32(ctx, draw) -> torch.Tensor:
    """An f32 tensor of the op's shape filled in place by ``draw(t, gen)``
    from the op's generator; empty on the meta device."""
    dev = _device(ctx)
    out = torch.empty(_shape_attr(ctx), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out
    seed = ctx.attr("seed", 0)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = ctx.rng() or default_generator(dev)
    draw(out, gen)
    return out


@op("gaussian_random", no_grad=True)
def _gaussian_random(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    out = _random_f32(ctx, lambda t, g: t.normal_(0.0, 1.0, generator=g))
    ctx.set_out("Out", (mean + std * out).to(_attr_dtype(ctx)))


@op("uniform_random", no_grad=True)
def _uniform_random(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = _random_f32(ctx, lambda t, g: t.uniform_(lo, hi, generator=g))
    ctx.set_out("Out", out.to(_attr_dtype(ctx)))


@op("cast")
def _cast(ctx):
    """``X`` converted to ``out_dtype`` (``in_dtype`` is informational:
    the value's own dtype is what is converted, as in JAX)."""
    dt = to_torch_dtype(VarType(int(ctx.attr("out_dtype",
                                             int(VarType.FP32)))))
    ctx.set_out("Out", ctx.in_("X").to(dt))


@op("transpose2")
def _transpose2(ctx):
    """The permuted tensor, materialized (contiguous), as XLA's transpose
    is: the layout pass's NHWC values are physically channels-last."""
    x = ctx.in_("X")
    ctx.set_out("Out", x.permute(*ctx.attr("axis")).contiguous())
    if ctx.has_output("XShape"):
        ctx.set_out("XShape", torch.zeros((0,), dtype=x.dtype,
                                          device=x.device))


def _resolve_shape(target, in_shape):
    """Paddle reshape semantics: 0 copies the input dim, one -1 is
    inferred."""
    target = list(target)
    for i, s in enumerate(target):
        if s == 0:
            target[i] = in_shape[i]
    if -1 in target:
        known = math.prod(s for s in target if s != -1)
        total = math.prod(in_shape)
        target[target.index(-1)] = total // known if known else -1
    return target


@op("reshape2")
def _reshape2(ctx):
    x = ctx.in_("X")
    if ctx.has_input("Shape"):
        raise NotImplementedError("reshape2 with a Shape tensor input is "
                                  "not ported")
    ctx.set_out("Out", x.reshape(_resolve_shape(ctx.attr("shape", []),
                                                tuple(x.shape))))
    if ctx.has_output("XShape"):
        ctx.set_out("XShape", torch.zeros((0,), dtype=x.dtype,
                                          device=x.device))


@infer_for("reshape2")
def _reshape2_infer(op_, block):
    """Out's shape from the attr alone, a -1 batch dim kept; XShape keeps
    its declared shape (JAX :228)."""
    x = block._find_var_recursive(op_.input("X")[0])
    out_shape = []
    for i, s in enumerate(op_.attrs.get("shape", [])):
        if s == 0:
            out_shape.append(x.shape[i] if i < len(x.shape) else -1)
        else:
            out_shape.append(s)
    if -1 in out_shape and -1 not in x.shape:
        known = math.prod(s for s in out_shape if s != -1)
        total = math.prod(x.shape) if x.shape else 0
        if known > 0 and total > 0:
            out_shape[out_shape.index(-1)] = total // known
    out = block._find_var_recursive(op_.output("Out")[0])
    out.shape = tuple(out_shape)
    out.dtype = x.dtype


@op("concat")
def _concat(ctx):
    if ctx.has_input("AxisTensor"):
        raise NotImplementedError("concat with an AxisTensor input is not "
                                  "ported")
    xs = [v for v in ctx.ins("X") if v is not None]
    ctx.set_out("Out", torch.cat(xs, dim=ctx.attr("axis", 0)))
