"""Creation, random and shape op lowerings of the static path
(counterpart of ``paddle_tpu/ops/tensor_ops.py``: ``fill_constant`` :36,
``fill_any_like`` :46, ``fill_zeros_like`` :54,
``fill_constant_batch_size_like`` :60, ``gaussian_random`` :70,
``uniform_random`` :81, ``range`` :139, ``assign`` :164, ``shape`` :181,
``cast`` :192, ``reshape2`` :214 with its shape inference :228,
``transpose2`` :254, ``squeeze2`` / ``squeeze`` :272, ``unsqueeze2`` /
``unsqueeze`` :284, ``flatten2`` / ``flatten`` :298, ``concat`` :332,
``split`` :341, ``stack`` :378, ``unstack`` :384, ``slice`` :393,
``strided_slice`` :412, ``gather`` :425, ``index_sample`` :467,
``expand`` :473, ``expand_v2`` :489, ``where`` :525).  The shape ops'
and ``cast``'s grads are the registry's generic vjp replay, as in JAX: a
cast's cotangent is cast back to the input's dtype, so an f32 parameter
read through a bf16 cast gets an f32 gradient.  ``range``'s bounds, ``shape``'s result and a
``gather`` ``Axis`` tensor cross to the host (their shapes or values
decide the result's shape), so a step holding them cannot be captured.

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
from ..framework.random import default_generator, seeded_generator
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


@op("fill_any_like", no_grad=True)
def _fill_any_like(ctx):
    """X's shape filled with ``value``, in ``dtype`` (-1: X's)."""
    x = ctx.in_("X")
    d = ctx.attr("dtype", -1)
    dt = x.dtype if d in (-1, None) else to_torch_dtype(VarType(int(d)))
    ctx.set_out("Out", torch.full(tuple(x.shape), ctx.attr("value", 0.0),
                                  dtype=dt, device=x.device))


@op("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ctx):
    ctx.set_out("Out", torch.zeros_like(ctx.in_("X")))


@op("fill_constant_batch_size_like", no_grad=True)
def _fill_cbsl(ctx):
    """``shape`` with its ``output_dim_idx`` entry taken from Input's
    ``input_dim_idx`` dim, filled with ``value``."""
    x = ctx.in_("Input")
    shape = [int(s) for s in ctx.attr("shape", [])]
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[ctx.attr("input_dim_idx",
                                                            0)]
    ctx.set_out("Out", torch.full(shape, ctx.attr("value", 0.0),
                                  dtype=_attr_dtype(ctx), device=x.device))


def _host_float(v) -> float:
    return float(v.reshape(-1)[0]) if isinstance(v, torch.Tensor) else v


@op("range", no_grad=True)
def _range(ctx):
    """``arange(Start, End, Step)`` of the three one-element inputs,
    read as floats on the host: float32, as JAX's ``jnp.arange`` of
    floats gives."""
    start, end, step = (_host_float(ctx.in_(s))
                        for s in ("Start", "End", "Step"))
    dev = ctx.in_("Start").device
    if dev.type == "meta":
        raise ValueError("range: the length depends on the input values")
    ctx.set_out("Out", torch.arange(start, end, step, dtype=torch.float32,
                                    device=dev))


@op("shape", no_grad=True)
def _shape(ctx):
    x = ctx.in_("Input")
    ctx.set_out("Out", torch.tensor(list(x.shape), dtype=torch.int32,
                                    device=x.device))


def _random_f32(ctx, draw) -> torch.Tensor:
    """An f32 tensor of the op's shape filled in place by ``draw(t, gen)``
    from the op's generator; empty on the meta device."""
    dev = _device(ctx)
    out = torch.empty(_shape_attr(ctx), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out
    seed = ctx.attr("seed", 0)
    gen = (seeded_generator(dev, seed) if seed else
           ctx.rng() or default_generator(dev))
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
    _xshape(ctx, x)


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


def _xshape(ctx, x):
    if ctx.has_output("XShape"):
        ctx.set_out("XShape", torch.zeros((0,), dtype=x.dtype,
                                          device=x.device))


def _squeeze2(ctx):
    """X without the unit axes of ``axes`` (all unit axes when empty; an
    axis whose size is not 1 stays)."""
    x = ctx.in_("X")
    axes = ctx.attr("axes", [])
    axes = ([a % x.dim() for a in axes] if axes else
            [i for i, s in enumerate(x.shape) if s == 1])
    ctx.set_out("Out", x.reshape([s for i, s in enumerate(x.shape)
                                  if not (i in axes and s == 1)]))
    _xshape(ctx, x)


def _unsqueeze2(ctx):
    x = ctx.in_("X")
    out = x
    for a in sorted(ctx.attr("axes", [])):
        out = out.unsqueeze(a)
    ctx.set_out("Out", out)
    _xshape(ctx, x)


def _flatten2(ctx):
    """X as (prod(shape[:axis]), rest): (1, numel) at axis 0."""
    x = ctx.in_("X")
    axis = ctx.attr("axis", 1)
    ctx.set_out("Out", x.reshape(math.prod(x.shape[:axis]) if axis else 1,
                                 -1))
    _xshape(ctx, x)


for _name, _fn in (("squeeze2", _squeeze2), ("squeeze", _squeeze2),
                   ("unsqueeze2", _unsqueeze2), ("unsqueeze", _unsqueeze2),
                   ("flatten2", _flatten2), ("flatten", _flatten2)):
    op(_name)(_fn)


@op("split")
def _split(ctx):
    """X cut along ``axis`` into ``sections`` (sizes) or ``num`` equal
    parts."""
    x = ctx.in_("X")
    axis = ctx.attr("axis", 0)
    sections = list(ctx.attr("sections", []))
    if not sections:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} does not divide "
                             f"into {num} equal parts")
        sections = [x.shape[axis] // num] * num
    ctx.set_out("Out", list(torch.split(x, sections, dim=axis)))


@op("stack")
def _stack(ctx):
    xs = [v for v in ctx.ins("X") if v is not None]
    ctx.set_out("Y", torch.stack(xs, dim=ctx.attr("axis", 0)))


@op("unstack")
def _unstack(ctx):
    x = ctx.in_("X")
    axis = ctx.attr("axis", 0)
    n = int(ctx.attr("num", 0) or x.shape[axis])
    if n != x.shape[axis]:
        raise ValueError(f"unstack: num {n} is not dim {x.shape[axis]}")
    ctx.set_out("Y", list(torch.unbind(x, dim=axis)))


@op("slice")
def _slice(ctx):
    """``Input[starts:ends]`` on ``axes`` (negative bounds from the end,
    both clamped into the dim), then ``decrease_axis`` squeezed."""
    x = ctx.in_("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes", []), ctx.attr("starts", []),
                       ctx.attr("ends", [])):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, max(e, s))
    out = x[tuple(idx)]
    decrease = ctx.attr("decrease_axis", [])
    if decrease:
        out = out.reshape([d for i, d in enumerate(out.shape)
                           if i not in {a % x.dim() for a in decrease}])
    ctx.set_out("Out", out)


@op("strided_slice")
def _strided_slice(ctx):
    """``Input[start:end:stride]`` on ``axes``, Python's slice rules (a
    negative stride walks backwards)."""
    x = ctx.in_("Input")
    out = x
    for a, s, e, st in zip(ctx.attr("axes", []), ctx.attr("starts", []),
                           ctx.attr("ends", []), ctx.attr("strides", [])):
        rows = range(x.shape[a])[slice(s, e, st)]
        if st > 0:
            out = out[(slice(None),) * a + (slice(rows.start, rows.stop,
                                                  st),)]
        else:
            out = out.index_select(a, torch.tensor(list(rows),
                                                   dtype=torch.long,
                                                   device=x.device))
    ctx.set_out("Out", out)


@op("index_sample")
def _index_sample(ctx):
    """``take_along_axis(X, Index, axis=1)``: each row's own picks."""
    ctx.set_out("Out", torch.take_along_dim(
        ctx.in_("X"), ctx.in_("Index").long(), dim=1))


@op("gather")
def _gather(ctx):
    """``take(X, Index, axis)``: Index's shape in place of X's axis."""
    x, index = ctx.in_("X"), ctx.in_("Index")
    axis = ctx.attr("axis", 0)
    if ctx.has_input("Axis"):
        axis = int(_host_float(ctx.in_("Axis")))
    axis %= x.dim()
    out = x.index_select(axis, index.reshape(-1).long())
    ctx.set_out("Out", out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                   + tuple(x.shape[axis + 1:])))


@op("expand")
def _expand(ctx):
    """``tile(X, expand_times)`` (a shorter list tiles the trailing
    axes, as np.tile)."""
    x = ctx.in_("X")
    times = [int(t) for t in ctx.attr("expand_times", [])]
    times = [1] * (x.dim() - len(times)) + times
    ctx.set_out("Out", x.repeat(*times))


@op("expand_v2")
def _expand_v2(ctx):
    """X broadcast to ``shape`` (-1 keeps X's dim, or 1 for a new
    leading one)."""
    x = ctx.in_("X")
    shape = list(ctx.attr("shape", []))
    off = len(shape) - x.dim()
    final = [(x.shape[i - off] if i >= off else 1) if s == -1 else s
             for i, s in enumerate(shape)]
    ctx.set_out("Out", x.expand(final).contiguous())


@op("concat")
def _concat(ctx):
    if ctx.has_input("AxisTensor"):
        raise NotImplementedError("concat with an AxisTensor input is not "
                                  "ported")
    xs = [v for v in ctx.ins("X") if v is not None]
    ctx.set_out("Out", torch.cat(xs, dim=ctx.attr("axis", 0)))


@op("assign")
def _assign(ctx):
    """A copy of ``X``: the output may be state of its own (an
    ``@EMA`` or ``@SLOW`` var seeded from a parameter), which must not
    share the parameter's memory."""
    ctx.set_out("Out", ctx.in_("X").clone())


@op("where")
def _where(ctx):
    ctx.set_out("Out", torch.where(ctx.in_("Condition"), ctx.in_("X"),
                                   ctx.in_("Y")))
