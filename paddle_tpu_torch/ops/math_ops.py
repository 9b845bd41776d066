"""Math op lowerings of the static path (counterpart of
``paddle_tpu/ops/math_ops.py``: the ``elementwise_*`` family :49-59,
``relu`` :72, ``sigmoid`` :74, ``sqrt`` :78, ``ceil`` / ``floor`` /
``cos`` / ``exp`` :81-92, ``reciprocal`` :99, ``sign`` :102,
``tanh`` :76, ``rsqrt`` :79, ``square`` :98, ``erf`` :103, ``gelu``
:109-110 (exact or ``approximate``), ``hard_sigmoid`` and ``hard_swish``
:114-125, ``scale`` :154, ``clip`` and ``clip_by_norm`` :185-205
(dense), ``sum`` (gradient accumulation), ``mean`` :222, the
``reduce_*`` family :231-250 (``dim`` / ``keep_dim`` / ``reduce_all``),
``top_k`` :318, the comparisons :351-356, ``matmul`` :394 (``transpose_X``
/ ``transpose_Y``, ``alpha``, 1-D operands), ``matmul_v2`` :413, ``mul``
:423, ``bmm`` :438, ``fc`` :443 and ``increment`` :494).

``mul``, ``gelu``, ``hard_swish`` and ``hard_sigmoid`` have explicit grad
lowerings; the others take the registry's generic vjp replay, whose
forward is one cheap pass (the products of ``matmul``, ``matmul_v2``,
``bmm`` and ``fc`` are ``torch.matmul``, outside any kernel: no Pallas
kernel computes them in JAX either).  A bf16 or fp16 exact ``gelu`` is
:func:`.gelu.gelu_lowp`'s: the kernels of ``csrc/gelu_lowp.cu`` on the
card, their plain versions on the CPU, as dygraph's gelu.  The
comparisons have no grad, as in JAX.

The rest of JAX's ``math_ops`` follows below: the activations and unary
math :66-135 (``abs`` ... ``stanh``), ``pow`` :138, ``frobenius_norm``
:255, ``p_norm`` :265, ``logsumexp`` :274, ``arg_max`` / ``arg_min`` /
``argsort`` :288-317, ``top_k_v2`` :337, the logical ops and the ``is*``
predicates :351-395, ``dot``, ``addmm``, ``cumsum``, ``maximum``,
``minimum``, ``kron``, ``trace`` and ``matmul_with_flatten`` :462-543.
Their grads are the registry's vjp replay of forwards written as JAX
writes them, so the gradient at an edge is JAX's, not torch's: ``abs``
is ``where(x >= 0, x, -x)`` (gradient 1 at 0), the clips are a maximum
then a minimum (half the gradient at each edge), ``leaky_relu`` and
``elu`` take JAX's branch at 0, and ``p_norm``'s 2-norm is
``sqrt(sum(x * x))`` (NaN gradient at the zero vector, as in JAX).
"""
from __future__ import annotations

import math

import torch

from ..framework.core import GRAD_SUFFIX
from ..framework.selected_rows import SelectedRows
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
                   ("sqrt", torch.sqrt), ("tanh", torch.tanh),
                   ("rsqrt", torch.rsqrt), ("square", torch.square),
                   ("erf", torch.erf)):
    op(_name)(_unary(_fn))


def _exact_gelu_lowp(ctx, x) -> bool:
    return (not ctx.attr("approximate", False)
            and x.dtype in (torch.bfloat16, torch.float16))


@op("gelu")
def _gelu(ctx):
    """``jax.nn.gelu(x, approximate)`` in x's dtype: exact erf (bf16 /
    fp16 through :func:`.gelu.gelu_lowp`) or the tanh form."""
    x = ctx.in_("X")
    if _exact_gelu_lowp(ctx, x):
        from .gelu import gelu_lowp
        ctx.set_out("Out", gelu_lowp(x))
        return
    ctx.set_out("Out", torch.nn.functional.gelu(
        x, approximate="tanh" if ctx.attr("approximate", False) else "none"))


@op("gelu_grad", no_grad=True)
def _gelu_grad(ctx):
    """``gelu'(x) * dOut`` (the bf16 / fp16 exact form through
    :func:`.gelu.gelu_lowp_grad`, which rounds where JAX's vjp does)."""
    x = ctx.in_("X")
    dy = ctx.in_("Out" + GRAD_SUFFIX).to(x.dtype)
    if _exact_gelu_lowp(ctx, x):
        from .gelu import gelu_lowp_grad
        ctx.set_out("X" + GRAD_SUFFIX, gelu_lowp_grad(x, dy))
        return
    ctx.set_out("X" + GRAD_SUFFIX, torch.ops.aten.gelu_backward(
        dy, x, approximate="tanh" if ctx.attr("approximate", False)
        else "none"))


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
    if isinstance(x, SelectedRows):
        # duplicates summed before the norm, as the reference's
        # SelectedRows kernel does (JAX math_ops.py:198-207)
        x = x.merge_rows()
        norm = torch.sqrt((x.values * x.values).sum())
        scaled = torch.where(norm > max_norm, max_norm / norm,
                             torch.ones_like(norm))
        ctx.set_out("Out", SelectedRows(x.rows, x.values * scaled,
                                        x.height))
        return
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
    if isinstance(x, SelectedRows):
        # a sparse scale touches the values only; a bias densifies
        # (JAX math_ops.py:161-167)
        if b == 0.0:
            if not isinstance(s, torch.Tensor):
                s = _in_dtype(s, x.values)
            ctx.set_out("Out", SelectedRows(x.rows, x.values * s,
                                            x.height))
            return
        x = x.to_dense()
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
    """The inputs added in order.  SelectedRows + SelectedRows
    concatenates their rows; a SelectedRows and a dense value give the
    dense sum (``framework/selected_rows.py``)."""
    xs = [v for v in ctx.ins("X") if v is not None]
    out = xs[0]
    for v in xs[1:]:
        out = v.__radd__(out) if isinstance(v, SelectedRows) else out + v
    ctx.set_out("Out", out)


@op("mean")
def _mean(ctx):
    ctx.set_out("Out", torch.mean(ctx.in_("X")))


def _reduce(fn, bool_out=False):
    """A ``reduce_*`` lowering: over ``dim`` (each taken modulo x's rank)
    or every axis under ``reduce_all``, keeping the reduced axes as 1
    under ``keep_dim``; an integer sum or product keeps x's dtype and a
    boolean one gives int32, as jnp does."""
    def lower(ctx):
        x = ctx.in_("X")
        if ctx.attr("reduce_all", False):
            dims = tuple(range(x.dim()))
        else:
            dim = ctx.attr("dim", [0])
            dims = tuple(d % max(x.dim(), 1) for d in (
                dim if isinstance(dim, (list, tuple)) else [dim]))
        keep = bool(ctx.attr("keep_dim", False))
        if bool_out:
            x = x.bool()
        elif x.dtype == torch.bool:
            x = x.to(torch.int32)
        ctx.set_out("Out", fn(x, dims, keep))

    return lower


def _prod(x, dims, keep):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    return x if keep else x.reshape([s for i, s in enumerate(x.shape)
                                     if i not in dims])


def _mean(x, dims, keep):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=dims, keepdim=keep)


for _name, _fn, _bool in (
        ("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k,
                                                 dtype=x.dtype), False),
        ("reduce_mean", _mean, False),
        ("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
         False),
        ("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
         False),
        ("reduce_prod", _prod, False),
        ("reduce_any", lambda x, d, k: torch.any(x, dim=d, keepdim=k), True),
        ("reduce_all", lambda x, d, k: torch.all(x, dim=d, keepdim=k),
         True)):
    op(_name, no_grad=_bool)(_reduce(_fn, _bool))


_SORT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
              torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _sort_key(x):
    """A key whose integer order is XLA's total order of ``x``'s floats
    (``lax.sort``, ``lax.top_k``): -0 below +0, NaN above every number;
    an integer ``x`` is its own key."""
    if not x.is_floating_point():
        return x
    bits = x.contiguous().view(_SORT_BITS[x.dtype])
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def xla_top_k(x, k, axis=-1, largest=True):
    """The ``k`` largest (or smallest) of ``x`` along ``axis`` in XLA's
    total order, ties in index order, as ``lax.top_k``: a stable sort of
    the keys, then the first ``k``.  (values, int64 indices)."""
    key = _sort_key(x) if largest else _sort_key(-x)
    idxs = torch.sort(key, dim=axis, stable=True, descending=True)[1]
    idxs = idxs.narrow(axis, 0, k)
    return torch.take_along_dim(x, idxs, dim=axis), idxs


def _topk(ctx):
    """:func:`xla_top_k`.  A ``K`` tensor is read on the host (as JAX
    reads it at trace time), so a step with one cannot be captured."""
    x = ctx.in_("X")
    k = int(ctx.in_("K")) if ctx.has_input("K") else int(ctx.attr("k", 1))
    out, idxs = xla_top_k(x, k, ctx.attr("axis", -1),
                          bool(ctx.attr("largest", True)))
    ctx.set_out("Out", out)
    ctx.set_out("Indices", idxs)


op("top_k", no_grad=True)(_topk)
op("top_k_v2", no_grad=True)(_topk)


def _times(out, alpha):
    """``out * alpha`` with the python scalar in out's dtype (skipped at
    1), as JAX's weakly typed product computes it."""
    if alpha == 1.0:
        return out
    return out * (_in_dtype(alpha, out) if out.is_floating_point()
                  else alpha)


@op("matmul")
def _matmul(ctx):
    """``alpha * X' @ Y'`` with X' and Y' transposed on their last two
    axes when asked; a 1-D X is a row (a column when transposed) and a
    1-D Y a column (a row), and the unit axis stays in the result, as in
    JAX."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    tx, ty = ctx.attr("transpose_X", False), ctx.attr("transpose_Y", False)
    if x.dim() == 1:
        x = x[:, None] if tx else x[None, :]
    if y.dim() == 1:
        y = y[None, :] if ty else y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    ctx.set_out("Out", _times(torch.matmul(x, y),
                              float(ctx.attr("alpha", 1.0))))


@op("matmul_v2")
def _matmul_v2(ctx):
    x, y = ctx.in_("X"), ctx.in_("Y")
    if ctx.attr("trans_x", False):
        x = x.transpose(-1, -2)
    if ctx.attr("trans_y", False):
        y = y.transpose(-1, -2)
    ctx.set_out("Out", torch.matmul(x, y))


@op("bmm")
def _bmm(ctx):
    ctx.set_out("Out", torch.matmul(ctx.in_("X"), ctx.in_("Y")))


@op("fc")
def _fc(ctx):
    """The fused fully-connected op of the inference passes: ``Input``
    flattened at ``in_num_col_dims``, ``@ W``, ``+ Bias`` and a ``relu``
    when ``activation_type`` names it."""
    x, w = ctx.in_("Input"), ctx.in_("W")
    ncd = ctx.attr("in_num_col_dims", 1)
    out = torch.matmul(x.reshape(math.prod(x.shape[:ncd]), -1), w)
    if ctx.has_input("Bias"):
        out = out + ctx.in_("Bias").reshape(1, -1)
    if ctx.attr("activation_type", "") == "relu":
        out = torch.relu(out)
    ctx.set_out("Out", out.reshape(tuple(x.shape[:ncd]) + (w.shape[1],)))


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


@op("matmul_with_flatten")
def _matmul_with_flatten(ctx):
    _mul(ctx)


op("matmul_with_flatten_grad", no_grad=True)(_mul_grad)


# -- the activations and unary math (JAX math_ops.py:66-135) ---------------
def _const(v, x):
    """The python scalar ``v`` as a 0-d tensor of x's dtype and device
    (the operand of a maximum / minimum, whose tie halves the gradient)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def jax_abs(x):
    """``|x|`` with JAX's gradient, 1 at 0 (+0 at -0, as ``jnp.abs``)."""
    return torch.where(x >= 0, x + 0.0, -x)


def jax_clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: a maximum, then a minimum, so each edge
    takes half the gradient, as in JAX."""
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def _elu(x, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def _softplus(x):
    """``jnn.softplus``: ``logaddexp(x, 0)`` (torch's ``softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


_UNARY_ATTR = {
    "relu6": lambda x, c: jax_clip(x, 0.0, c.attr("threshold", 6.0)),
    "logsigmoid": lambda x, c: -_softplus(-x),
    "tanh_shrink": lambda x, c: x - torch.tanh(x),
    "abs": lambda x, c: jax_abs(x),
    "round": lambda x, c: torch.round(x),
    "sin": lambda x, c: torch.sin(x),
    "tan": lambda x, c: torch.tan(x),
    "acos": lambda x, c: torch.acos(x),
    "asin": lambda x, c: torch.asin(x),
    "atan": lambda x, c: torch.atan(x),
    "cosh": lambda x, c: torch.cosh(x),
    "sinh": lambda x, c: torch.sinh(x),
    "log": lambda x, c: torch.log(x),
    "log2": lambda x, c: torch.log2(x),
    "log10": lambda x, c: torch.log10(x),
    "log1p": lambda x, c: torch.log1p(x),
    "expm1": lambda x, c: torch.expm1(x),
    "softplus": lambda x, c: _softplus(x),
    "softsign": lambda x, c: x / (1.0 + jax_abs(x)),
    "leaky_relu": lambda x, c: torch.where(x >= 0, x,
                                           c.attr("alpha", 0.02) * x),
    "elu": lambda x, c: _elu(x, c.attr("alpha", 1.0)),
    "swish": lambda x, c: x * torch.sigmoid(c.attr("beta", 1.0) * x),
    "silu": lambda x, c: x * torch.sigmoid(x),
    "hard_shrink": lambda x, c: torch.where(
        jax_abs(x) > c.attr("threshold", 0.5), x, torch.zeros_like(x)),
    "soft_relu": lambda x, c: torch.log1p(torch.exp(jax_clip(
        x, -c.attr("threshold", 40.0), c.attr("threshold", 40.0)))),
    "thresholded_relu": lambda x, c: torch.where(
        x > c.attr("threshold", 1.0), x, torch.zeros_like(x)),
    "brelu": lambda x, c: jax_clip(x, c.attr("t_min", 0.0),
                                   c.attr("t_max", 24.0)),
    "stanh": lambda x, c: c.attr("scale_b", 1.7159) * torch.tanh(
        c.attr("scale_a", 0.67) * x),
}


def _unary_attr(fn):
    def lower(ctx):
        ctx.set_out("Out", fn(ctx.in_("X"), ctx))

    return lower


for _name, _fn in _UNARY_ATTR.items():
    op(_name)(_unary_attr(_fn))

@op("pow")
def _pow(ctx):
    """``x ** factor`` (the attr, or the ``FactorTensor``), in x's
    dtype."""
    f = (ctx.in_("FactorTensor") if ctx.has_input("FactorTensor")
         else float(ctx.attr("factor", 1.0)))
    ctx.set_out("Out", torch.pow(ctx.in_("X"), f))


# -- norms and the log-sum-exp (JAX math_ops.py:255-285) --------------------
def _dims(ctx, x, name, default):
    """The reduced axes of a ``dim`` / ``axis`` attr, all of x's under
    ``reduce_all``."""
    if ctx.attr("reduce_all", False):
        return tuple(range(x.dim()))
    d = ctx.attr(name, default)
    return tuple(d) if isinstance(d, (list, tuple)) else (d,)


@op("frobenius_norm")
def _frobenius_norm(ctx):
    x = ctx.in_("X")
    ctx.set_out("Out", torch.sqrt(torch.sum(
        torch.square(x), dim=_dims(ctx, x, "dim", [0]),
        keepdim=bool(ctx.attr("keep_dim", False)))))


@op("p_norm")
def _p_norm(ctx):
    """``jnp.linalg.norm(x, ord=porder, axis=axis)``, a vector norm, in
    its terms: the 2-norm ``sqrt(sum(x * x))``, the infinities
    ``max`` / ``min`` of ``|x|``, 0 the count of nonzeros, else
    ``sum(|x| ** p) ** (1 / p)``."""
    x = ctx.in_("X")
    p = float(ctx.attr("porder", 2.0))
    axis = ctx.attr("axis", -1)
    keep = bool(ctx.attr("keepdim", False))
    if p == 2.0:
        out = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=keep))
    elif p == math.inf:
        out = torch.amax(jax_abs(x), dim=axis, keepdim=keep)
    elif p == -math.inf:
        out = torch.amin(jax_abs(x), dim=axis, keepdim=keep)
    elif p == 0.0:
        out = torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keep)
    elif p == 1.0:
        out = torch.sum(jax_abs(x), dim=axis, keepdim=keep)
    else:
        out = torch.pow(torch.sum(torch.pow(jax_abs(x), p), dim=axis,
                                  keepdim=keep), 1.0 / p)
    ctx.set_out("Out", out)


@op("logsumexp")
def _logsumexp(ctx):
    x = ctx.in_("X")
    ctx.set_out("Out", torch.logsumexp(
        x, dim=_dims(ctx, x, "axis", [0]),
        keepdim=bool(ctx.attr("keepdim", False))))


# -- arg_max / arg_min / argsort (JAX math_ops.py:288-317; no grads) --------
def _arg(fn):
    def lower(ctx):
        x = ctx.in_("X")
        ax = ctx.attr("axis", -1)
        if ctx.attr("flatten", False):
            out = fn(x.reshape(-1), dim=0)
        else:
            out = fn(x, dim=ax)
        if ctx.attr("keepdims", False):
            out = out.unsqueeze(ax)
        ctx.set_out("Out", out.to(torch.int64))

    return lower


op("arg_max", no_grad=True)(_arg(torch.argmax))
op("arg_min", no_grad=True)(_arg(torch.argmin))


@op("argsort", no_grad=True)
def _argsort(ctx):
    """A stable sort of ``x`` (of ``-x`` when ``descending``), as
    ``jnp.argsort``: -0 equal to +0, NaN last (``top_k``'s total order
    is not this one)."""
    x = ctx.in_("X")
    ax = ctx.attr("axis", -1)
    idx = torch.argsort(-x if ctx.attr("descending", False) else x, dim=ax,
                        stable=True)
    ctx.set_out("Indices", idx)
    ctx.set_out("Out", torch.take_along_dim(x, idx, dim=ax))


# -- logical ops and predicates (JAX math_ops.py:351-395; no grads) ---------
for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    op(_name, no_grad=True)(_elementwise(_fn))

for _name, _fn in (
        ("logical_not", torch.logical_not),
        ("isfinite", lambda x: torch.all(torch.isfinite(x))),
        ("isfinite_v2", torch.isfinite), ("isnan_v2", torch.isnan),
        ("isinf_v2", torch.isinf),
        ("isinf", lambda x: torch.any(torch.isinf(x))),
        ("isnan", lambda x: torch.any(torch.isnan(x)))):
    op(_name, no_grad=True)(_unary(_fn))


# -- dot, addmm, cumsum, maximum, minimum, kron, trace (JAX :462-534) -------
@op("dot")
def _dot(ctx):
    ctx.set_out("Out", torch.sum(ctx.in_("X") * ctx.in_("Y"), dim=-1))


@op("addmm")
def _addmm(ctx):
    i, x, y = ctx.in_("Input"), ctx.in_("X"), ctx.in_("Y")
    ctx.set_out("Out", ctx.attr("Beta", 1.0) * i
                + ctx.attr("Alpha", 1.0) * torch.matmul(x, y))


@op("cumsum")
def _cumsum(ctx):
    """JAX's lowering term for term: ``reverse`` sums from the end, and
    ``exclusive`` then shifts the sums one place toward the end along
    the axis, a zero first."""
    x = ctx.in_("X")
    ax = ctx.attr("axis", -1)
    if ctx.attr("flatten", False):
        x, ax = x.reshape(-1), 0
    if ctx.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (ax,)), dim=ax), (ax,))
    else:
        out = torch.cumsum(x, dim=ax)
    if ctx.attr("exclusive", False):
        n = out.shape[ax]
        out = torch.cat([torch.zeros_like(out.narrow(ax, 0, 1)),
                         out.narrow(ax, 0, n - 1)], dim=ax)
    ctx.set_out("Out", out)


op("maximum")(lambda ctx: ctx.set_out("Out", torch.maximum(ctx.in_("X"),
                                                           ctx.in_("Y"))))
op("minimum")(lambda ctx: ctx.set_out("Out", torch.minimum(ctx.in_("X"),
                                                           ctx.in_("Y"))))
op("kron")(lambda ctx: ctx.set_out("Out", torch.kron(ctx.in_("X"),
                                                     ctx.in_("Y"))))


@op("trace")
def _trace(ctx):
    ctx.set_out("Out", torch.diagonal(
        ctx.in_("Input"), offset=ctx.attr("offset", 0),
        dim1=ctx.attr("axis1", 0), dim2=ctx.attr("axis2", 1)).sum(-1))
