"""Creation and random op lowerings of the static path (counterpart of
``paddle_tpu/ops/tensor_ops.py``: ``fill_constant`` :36,
``gaussian_random`` :70, ``uniform_random`` :81).

Random ops draw from the executor's ``torch.Generator`` (seeded from the
program's ``random_seed``), or from a generator of their own when the op
carries a nonzero ``seed`` attr, as the JAX lowerings key their draw.
The numbers are not JAX's: the two streams differ, so parity tests carry
the startup scope across instead.  Under shape inference (``meta``
device, no generator) they allocate nothing.
"""
from __future__ import annotations

import torch

from ..framework.dtype import VarType, convert_dtype, to_torch_dtype
from ..framework.random import default_generator
from .registry import op

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
