"""The plain op lowerings the BERT/ERNIE dygraph layers use, in PyTorch.

Counterparts of the JAX package's lowerings, with its semantics:

* ``lookup_table_v2`` (``ops/nn_ops.py:690-707``): ids clipped into the
  table, rows of ``padding_idx`` (when >= 0) zeroed;
* ``softmax_with_cross_entropy`` (``ops/nn_ops.py:470-505``): an f32
  log-sum-exp, hard labels, ``ignore_index`` honoured only when >= 0, and
  the closed-form gradient ``(softmax - onehot(label)) * dLoss`` of
  ``_softmax_ce_grad``, from the softmax saved by the forward;
* ``dropout`` (``ops/nn_ops.py:784-810``): ``upscale_in_train`` or
  ``downgrade_in_infer``, identity (or the downgrade) when ``is_test``;
  the keep mask is drawn from the caller's ``torch.Generator``;
* the activations ``gelu`` (exact erf) and ``tanh`` (``math_ops.py:76,
  109``) by name, and ``unsqueeze2`` (``tensor_ops.py:284``);
* the dygraph fronts ``mean`` and ``softmax`` (black-list ops under AMP).

Under AMP (``paddle_tpu_torch.dygraph.amp_guard``) the fronts cast their
inputs by the op lists (:func:`amp_cast`); every lowering here keeps its
input's dtype as the JAX one does: ``dropout`` upscales by the factor
rounded to x's dtype, ``gelu`` and ``tanh`` run in x's dtype,
``softmax_with_cross_entropy`` takes an f32 log-sum-exp of bf16 logits,
stores the Softmax in their dtype and returns the f32 loss, and its
closed-form gradient comes back in the logits' dtype.

``layer_norm`` and ``matmul`` (with ``alpha`` / ``transpose_Y``) are the
decoder forms' (:mod:`.decoder_ops`); ``einsum`` is ``torch.einsum`` of
operands promoted as jnp promotes them (``models/bert.py``).

The static path's op lowerings (registered in :mod:`.registry`) follow
below: ``conv2d`` (``conv_forward`` :45, ``_conv_lower`` :81), ``pool2d``
(:161), ``batch_norm`` (``bn_shapes`` :296, ``bn_train_stats`` :310,
:341, its grad maker :374), ``softmax_with_cross_entropy`` (:471, its
closed-form grad :509), ``accuracy`` (:858), ``softmax`` (:460) and
``lookup_table`` (:692-708: ids with a trailing unit axis squeezed, the
dense gradient of the default grad maker; ``is_sparse`` raises, its
SelectedRows gradient is not ported).  conv2d, pool2d and
batch_norm carry explicit grad lowerings: the convolution's through
``aten.convolution_backward``, max pooling's through the indices of a
recomputed ``max_pool2d_with_indices``, batch_norm's in closed form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX
from .registry import default_grad_maker, grad_maker, op

__all__ = ["lookup_table_v2", "activation", "layer_norm_lowp", "unsqueeze2",
           "dropout",
           "softmax_with_cross_entropy", "mean", "softmax", "amp_cast",
           "conv_forward", "conv_backward", "bn_shapes", "bn_train_stats"]


def amp_cast(op_type: str, *tensors):
    """:func:`paddle_tpu_torch.dygraph.amp.amp_cast` (imported at the call:
    the dygraph package imports this module)."""
    from ..dygraph.amp import amp_cast as cast
    return cast(op_type, *tensors)


def lookup_table_v2(table: torch.Tensor, ids: torch.Tensor,
                    padding_idx: int = -1) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (clipped to the table); the rows of
    ``padding_idx`` are zeros when it is >= 0."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    out = F.embedding(ids, table)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


# exact-erf GELU (the JAX lowering's approximate=False) and tanh
_ACTS = {"gelu": F.gelu, "tanh": torch.tanh}


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` by its Paddle name, or ``x`` when None.  A bf16 gelu
    rounds where JAX's compiled gelu rounds (:func:`.gelu.gelu_lowp`)."""
    if act is None:
        return x
    if act not in _ACTS:
        raise NotImplementedError(f"activation {act!r} is not ported")
    if act == "gelu" and x.dtype == torch.bfloat16:
        from .gelu import gelu_lowp
        return gelu_lowp(x)
    return _ACTS[act](x)


class _LayerNormLowp(torch.autograd.Function):
    """JAX's ``layer_norm`` lowering (``nn_ops.py:388-412``) on a bf16 x,
    rounding where its compiled form rounds: the normalized value
    (statistics in f32) rounded to x's dtype, then ``* Scale`` and
    ``+ Bias`` as two ops in x's dtype.  The backward is the compiled
    ``jax.vjp``'s: ``g = dy * Scale`` in f32, unrounded, through the f32
    normalization backward, dX rounded once; dScale and dBias are sums
    in f32 rounded once (XLA's CPU reduction rounds every partial sum to
    bf16, so those two differ from it in the last bits).

    On the card the backward is ATen's one-pass layer-norm backward with
    the forward's f32 statistics, which does exactly that f32 math (dScale
    from the unrounded normalized value).  ATen's CPU kernel takes bf16
    statistics only, so the CPU spells the same math out in f32, with
    JAX's dScale terms (the rounded normalized value times dy)."""

    @staticmethod
    def forward(ctx, x, scale, bias, shape, eps):
        s = scale.reshape(shape).to(x.dtype)
        b = bias.reshape(shape).to(x.dtype)
        if x.is_cuda:
            y_hat, mean, rstd = torch.ops.aten.native_layer_norm(
                x, list(shape), None, None, eps)
            ctx.save_for_backward(x, s, mean, rstd)
        else:
            y_hat = F.layer_norm(x, shape, None, None, eps)
            ctx.save_for_backward(x, s, y_hat)
        ctx.shape, ctx.eps = shape, eps
        ctx.dtypes = (scale.dtype, bias.dtype, scale.shape)
        return y_hat * s + b

    @staticmethod
    def backward(ctx, dy):
        sdt, bdt, pshape = ctx.dtypes
        rows = tuple(range(dy.dim() - len(ctx.shape)))
        if dy.is_cuda:
            x, s, mean, rstd = ctx.saved_tensors
            dx, dscale, dbias = torch.ops.aten.native_layer_norm_backward(
                dy.contiguous(), x, list(ctx.shape), mean, rstd, s,
                torch.zeros_like(s), [True, True, True])
        else:
            x, s, y_hat = ctx.saved_tensors
            axes = tuple(range(x.dim() - len(ctx.shape), x.dim()))
            x32 = x.float()
            var, mean = torch.var_mean(x32, dim=axes, unbiased=False,
                                       keepdim=True)
            rstd = torch.rsqrt(var + ctx.eps)
            dx = torch.ops.aten.native_layer_norm_backward(
                dy.float() * s.float(), x32, list(ctx.shape), mean, rstd,
                None, None, [True, False, False])[0].to(x.dtype)
            dscale = (y_hat * dy).float().sum(dim=rows).to(x.dtype)
            dbias = dy.float().sum(dim=rows).to(x.dtype)
        return (dx, dscale.to(sdt).reshape(pshape),
                dbias.to(bdt).reshape(pshape), None, None)


def layer_norm_lowp(x, scale, bias, shape, eps=1e-5):
    """LayerNorm over the trailing ``shape`` axes of a bf16 ``x`` with
    JAX's rounding points (:class:`_LayerNormLowp`); output in x's
    dtype."""
    return _LayerNormLowp.apply(x, scale, bias, tuple(shape), eps)


def unsqueeze2(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """``x`` with a unit axis inserted at each of ``axes``, in sorted
    order."""
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


def dropout(x: torch.Tensor, p: float, is_test: bool = False,
            implementation: str = "downgrade_in_infer",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Paddle dropout.  ``upscale_in_train``: ``x / (1 - p)`` where kept
    in training, ``x`` at test; ``downgrade_in_infer``: ``x`` where kept in
    training, ``x * (1 - p)`` at test.  Each element is kept with
    probability ``1 - p``, drawn from ``generator``."""
    if implementation not in ("upscale_in_train", "downgrade_in_infer"):
        raise ValueError(f"unknown dropout_implementation "
                         f"{implementation!r}")
    if is_test:
        return x if implementation == "upscale_in_train" else x * (1.0 - p)
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    if implementation == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        if x.dtype != torch.float32:
            # the factor in x's dtype, as JAX's jnp.asarray(scale, x.dtype)
            scale = torch.full((), scale, dtype=x.dtype, device=x.device)
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


class _SoftmaxCE(torch.autograd.Function):
    """Hard-label softmax cross entropy over the last axis; the backward
    is the closed form from the saved softmax (JAX ``_softmax_ce_grad``),
    so the f32 log-softmax is never stored."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index):
        x32 = logits.float()
        lse = torch.logsumexp(x32, dim=-1, keepdim=True)
        picked = torch.gather(x32, -1, label)
        loss = lse - picked
        if ignore_index >= 0:
            loss = torch.where(label != ignore_index, loss,
                               torch.zeros_like(loss))
        softmax = torch.exp(x32 - lse).to(logits.dtype)
        ctx.save_for_backward(softmax, label)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, dloss):
        softmax, label = ctx.saved_tensors
        grad = softmax.to(torch.float32, copy=True)
        grad.scatter_add_(-1, label, torch.full_like(label, -1,
                                                     dtype=grad.dtype))
        grad.mul_(dloss.float())
        if ctx.ignore_index >= 0:
            grad = grad * (label != ctx.ignore_index).to(grad.dtype)
        return grad.to(softmax.dtype), None, None


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               ignore_index: int = -100) -> torch.Tensor:
    """Per-row loss ``logsumexp(logits) - logits[label]`` (f32), shape
    logits' with the last axis 1.  ``label`` holds int class ids, with or
    without the trailing unit axis."""
    if label.dim() == logits.dim() - 1:
        label = label.unsqueeze(-1)
    (logits,) = amp_cast("softmax_with_cross_entropy", logits)
    return _SoftmaxCE.apply(logits, label.long(), int(ignore_index))


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element (the ``mean`` op; black-list under
    AMP)."""
    (x,) = amp_cast("mean", x)
    return torch.mean(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax over ``axis`` (the ``softmax`` op; black-list under AMP)."""
    (x,) = amp_cast("softmax", x)
    return torch.softmax(x, dim=axis)


# ==========================================================================
# The static path's op lowerings
# ==========================================================================
def _conv_padding(paddings, algo, in_shape, k_shape, strides, dilations):
    """Paddle padding attrs -> [(lo, hi)] per spatial dim (JAX
    ``_conv_padding`` :26)."""
    nd = len(in_shape)
    if algo == "VALID":
        return [(0, 0)] * nd
    if algo == "SAME":
        pads = []
        for i in range(nd):
            eff_k = (k_shape[i] - 1) * dilations[i] + 1
            out = -(-in_shape[i] // strides[i])
            total = max(0, (out - 1) * strides[i] + eff_k - in_shape[i])
            pads.append((total // 2, total - total // 2))
        return pads
    if len(paddings) == nd:
        return [(p, p) for p in paddings]
    if len(paddings) == 2 * nd:
        return [(paddings[2 * i], paddings[2 * i + 1]) for i in range(nd)]
    return [(0, 0)] * nd


def _nchw(x, data_format):
    """``x`` as an NCHW view (an NHWC tensor is permuted, not copied)."""
    if data_format in ("NCHW", "AnyLayout"):
        return x
    return x.permute(0, 3, 1, 2)


def _from_nchw(x, data_format):
    if data_format in ("NCHW", "AnyLayout"):
        return x
    return x.permute(0, 2, 3, 1)


def _split_pads(pads):
    """(symmetric padding for the conv call, explicit F.pad widths or
    None)."""
    if all(lo == hi for lo, hi in pads):
        return [lo for lo, _ in pads], None
    return [0] * len(pads), (pads[1][0], pads[1][1], pads[0][0], pads[0][1])


def _conv_geometry(x_nchw, w, strides, paddings, dilations, groups,
                   padding_algorithm, depthwise):
    if x_nchw.dim() != 4:
        raise NotImplementedError("only 2-D convolutions are ported")
    pads = _conv_padding(list(paddings), padding_algorithm,
                         list(x_nchw.shape[2:]), list(w.shape[2:]),
                         list(strides), list(dilations))
    if depthwise:
        groups = x_nchw.shape[1]
    return pads, groups or 1


def conv_forward(x, w, *, strides, paddings, dilations, groups=1,
                 data_format="NCHW", padding_algorithm="EXPLICIT",
                 depthwise=False):
    """The conv2d forward as a pure function — the exact computation the
    ``conv2d`` lowering runs, shared with ``fused_conv_bn_act``
    (``fused_ops.py``) so fusing the epilogue never changes the conv.
    Filters are OIHW in both layouts."""
    xc = _nchw(x, data_format)
    pads, groups = _conv_geometry(xc, w, strides, paddings, dilations,
                                  groups, padding_algorithm, depthwise)
    sym, explicit = _split_pads(pads)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    out = F.conv2d(xc, w, None, list(strides), sym, list(dilations), groups)
    return _from_nchw(out, data_format)


def conv_backward(x, w, dout, *, strides, paddings, dilations, groups=1,
                  data_format="NCHW", padding_algorithm="EXPLICIT",
                  depthwise=False, need_input=True, need_filter=True):
    """(dInput, dFilter) of :func:`conv_forward` for the cotangent
    ``dout`` (either may be None when not asked for)."""
    xc = _nchw(x, data_format)
    h, wd = xc.shape[2:]
    pads, groups = _conv_geometry(xc, w, strides, paddings, dilations,
                                  groups, padding_algorithm, depthwise)
    sym, explicit = _split_pads(pads)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        _nchw(dout, data_format), xc, w, None, list(strides), sym,
        list(dilations), False, [0, 0], groups,
        [need_input, need_filter, False])
    if dx is not None and explicit is not None:
        (h_lo, _), (w_lo, _) = pads
        dx = dx[:, :, h_lo:h_lo + h, w_lo:w_lo + wd]
    if dx is not None:
        dx = _from_nchw(dx, data_format)
    return dx, dw


def conv_attrs(ctx) -> dict:
    """The conv attrs a conv2d (or fused conv) op carries."""
    return dict(
        strides=list(ctx.attr("strides", [1, 1])),
        paddings=list(ctx.attr("paddings", [0, 0])),
        dilations=list(ctx.attr("dilations", [1, 1])),
        groups=ctx.attr("groups", 1) or 1,
        data_format=ctx.attr("data_format", "NCHW"),
        padding_algorithm=ctx.attr("padding_algorithm", "EXPLICIT"),
        depthwise=bool(ctx.attr("depthwise", False)),
    )


@op("conv2d")
def _conv2d(ctx):
    ctx.set_out("Output", conv_forward(ctx.in_("Input"), ctx.in_("Filter"),
                                       **conv_attrs(ctx)))


@op("conv2d_grad", no_grad=True)
def _conv2d_grad(ctx):
    need_x = ctx.has_output("Input" + GRAD_SUFFIX)
    need_w = ctx.has_output("Filter" + GRAD_SUFFIX)
    dx, dw = conv_backward(ctx.in_("Input"), ctx.in_("Filter"),
                           ctx.in_("Output" + GRAD_SUFFIX),
                           need_input=need_x, need_filter=need_w,
                           **conv_attrs(ctx))
    if need_x:
        ctx.set_out("Input" + GRAD_SUFFIX, dx)
    if need_w:
        ctx.set_out("Filter" + GRAD_SUFFIX, dw)


# -- pool2d (reference: pool_op.cc) -----------------------------------------
def _pool_setup(ctx, x):
    """(kind, NCHW view, args): kind is "global", or "window" with
    (ksize, strides, symmetric padding, explicit F.pad widths or None)."""
    ptype = ctx.attr("pooling_type", "max")
    ksize = list(ctx.attr("ksize", [2, 2]))
    strides = list(ctx.attr("strides", [2, 2]))
    paddings = list(ctx.attr("paddings", [0, 0]))
    fmt = ctx.attr("data_format", "NCHW")
    xc = _nchw(x, fmt)
    if ctx.attr("global_pooling", False) or (ctx.attr("adaptive", False)
                                             and ksize == [1, 1]):
        return "global", xc, None
    if ctx.attr("adaptive", False):
        raise NotImplementedError("adaptive pool2d is not ported")
    in_sp = list(xc.shape[2:])
    algo = ctx.attr("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        pads = []
        for i in range(2):
            out = -(-in_sp[i] // strides[i])
            total = max(0, (out - 1) * strides[i] + ksize[i] - in_sp[i])
            pads.append((total // 2, total - total // 2))
    elif algo == "VALID":
        pads = [(0, 0), (0, 0)]
    elif len(paddings) == 4:
        pads = [(paddings[0], paddings[1]), (paddings[2], paddings[3])]
    else:
        pads = [(p, p) for p in paddings]
    if ctx.attr("ceil_mode", False):
        pads = [(lo, hi + strides[i] - 1) for i, (lo, hi) in enumerate(pads)]
    sym, explicit = _split_pads(pads)
    if explicit is None and any(2 * p > k for p, k in zip(sym, ksize)):
        sym, explicit = [0, 0], (pads[1][0], pads[1][1], pads[0][0],
                                 pads[0][1])
    if ptype != "max" and explicit is not None:
        raise NotImplementedError("average pool2d with asymmetric or "
                                  "ceil-mode padding is not ported")
    return "window", xc, (ksize, strides, sym, explicit)


@op("pool2d")
def _pool2d(ctx):
    x = ctx.in_("X")
    fmt = ctx.attr("data_format", "NCHW")
    is_max = ctx.attr("pooling_type", "max") == "max"
    kind, xc, args = _pool_setup(ctx, x)
    if kind == "global":
        out = (xc.amax(dim=(2, 3), keepdim=True) if is_max
               else xc.mean(dim=(2, 3), keepdim=True))
    else:
        ksize, strides, sym, explicit = args
        if is_max:
            if explicit is not None:
                xc = F.pad(xc, explicit, value=float("-inf"))
            out = F.max_pool2d(xc, ksize, strides, sym)
        else:
            out = F.avg_pool2d(xc, ksize, strides, sym,
                               count_include_pad=not ctx.attr("exclusive",
                                                              True))
    ctx.set_out("Out", _from_nchw(out, fmt))


@op("pool2d_grad", no_grad=True)
def _pool2d_grad(ctx):
    """Global max: the cotangent split evenly over the tied maxima (JAX's
    reduce-max rule); window max: to the first maximum of each window in
    row-major order (JAX's select_and_scatter with ``ge``), through the
    indices of a recomputed ``max_pool2d_with_indices``; average: spread
    over the window (``avg_pool2d_backward``)."""
    if not ctx.has_output("X" + GRAD_SUFFIX):
        return
    x = ctx.in_("X")
    fmt = ctx.attr("data_format", "NCHW")
    is_max = ctx.attr("pooling_type", "max") == "max"
    dout = _nchw(ctx.in_("Out" + GRAD_SUFFIX), fmt)
    kind, xc, args = _pool_setup(ctx, x)
    if kind == "global":
        if is_max:
            hit = (xc == xc.amax(dim=(2, 3), keepdim=True)).to(dout.dtype)
            dx = dout * hit / hit.sum(dim=(2, 3), keepdim=True)
        else:
            dx = (dout / (xc.shape[2] * xc.shape[3])).expand(xc.shape)
    else:
        ksize, strides, sym, explicit = args
        if is_max:
            xp = (F.pad(xc, explicit, value=float("-inf"))
                  if explicit is not None else xc)
            _, idx = F.max_pool2d(xp, ksize, strides, sym,
                                  return_indices=True)
            dx = torch.ops.aten.max_pool2d_with_indices_backward(
                dout.contiguous(), xp, ksize, strides, sym, [1, 1], False,
                idx)
            if explicit is not None:
                w_lo, _, h_lo, _ = explicit
                dx = dx[:, :, h_lo:h_lo + xc.shape[2],
                        w_lo:w_lo + xc.shape[3]]
        else:
            dx = torch.ops.aten.avg_pool2d_backward(
                dout.contiguous(), xc, ksize, strides, sym, False,
                not ctx.attr("exclusive", True), None)
    ctx.set_out("X" + GRAD_SUFFIX, _from_nchw(dx, fmt).contiguous())


# -- batch_norm (reference: batch_norm_op.cc) --------------------------------
def bn_shapes(x, layout):
    """(c_axis, reduction axes, broadcast shape, element count) for a BN
    over ``layout`` — shared by batch_norm and the fused BN ops."""
    nd = x.dim()
    c_axis = 1 if layout in ("NCHW", "AnyLayout") and nd > 1 else nd - 1
    red_axes = tuple(i for i in range(nd) if i != c_axis)
    bshape = [1] * nd
    bshape[c_axis] = x.shape[c_axis]
    n = 1
    for i in red_axes:
        n *= x.shape[i]
    return c_axis, red_axes, bshape, n


def bn_train_stats(x, red_axes, bshape, n, c_axis):
    """Batch mean and biased variance in f32, the JAX recipe term for
    term (``nn_ops.py:310``): moments of ``x - shift``, where the shift
    is the mean of the first 1/8 of the batch when the batch is larger
    than 8 (the whole batch otherwise), then ``mean = shift + s1/n`` and
    ``var = max(s2/n - (s1/n)^2, 0)``."""
    if x.dim() > 1 and c_axis != 0 and x.shape[0] > 8:
        shift = x[: x.shape[0] // 8].float().mean(dim=red_axes)
    else:
        shift = x.float().mean(dim=red_axes)
    xs = x.float() - shift.reshape(bshape)
    s1 = xs.sum(dim=red_axes)
    s2 = torch.square(xs).sum(dim=red_axes)
    mean = shift + s1 / n
    var = torch.clamp_min(s2 / n - torch.square(s1 / n), 0.0)
    return mean, var


def bn_is_test(ctx) -> bool:
    return bool(ctx.attr("is_test", False)
                or ctx.attr("use_global_stats", False))


def bn_forward_stats(ctx, x, layout):
    """(mean, inv-std, bshape, c_axis) of a BN over ``x``, binding
    MeanOut / VarianceOut (running averages, or the running stats
    themselves at test time) and SavedMean / SavedVariance (inv-std)."""
    mean_rt, var_rt = ctx.in_("Mean"), ctx.in_("Variance")
    momentum = ctx.attr("momentum", 0.9)
    c_axis, red_axes, bshape, n = bn_shapes(x, layout)
    if bn_is_test(ctx):
        mean, var = mean_rt, var_rt
        ctx.set_out("MeanOut", mean_rt)
        ctx.set_out("VarianceOut", var_rt)
    else:
        mean, var = bn_train_stats(x, red_axes, bshape, n, c_axis)
        ctx.set_out("MeanOut", momentum * mean_rt + (1.0 - momentum) * mean)
        ctx.set_out("VarianceOut",
                    momentum * var_rt + (1.0 - momentum) * var)
    inv = torch.rsqrt(var + ctx.attr("epsilon", 1e-5))
    ctx.set_out("SavedMean", mean)
    ctx.set_out("SavedVariance", inv)  # the reference saves inv-std here
    return mean, inv, bshape, c_axis


def bn_fold(x, scale, bias, mean, inv):
    """The per-channel (a, b) of ``y = x * a + b``, cast once to x's
    dtype, as the JAX lowering folds them."""
    a = (inv * scale).to(x.dtype)
    b = (bias - mean * inv * scale).to(x.dtype)
    return a, b


def bn_backward(x, g, scale, mean, inv, layout, is_test):
    """(dX, dScale, dBias) of a BN for the cotangent ``g`` of its
    (pre-activation) output, in closed form: the reductions in f32, and
    ``dX = g*cg + (x - mean)*cx + c0`` with the batch-statistic terms
    folded into per-channel vectors (JAX ``_fused_bn_act_bwd``)."""
    _, red_axes, bshape, n = bn_shapes(x, layout)
    xs = x.float() - mean.reshape(bshape)
    gf = g.float()
    sg = gf.sum(dim=red_axes)
    sgx = (gf * xs).sum(dim=red_axes) * inv
    a = scale * inv
    cg = a.to(g.dtype)
    if is_test:
        dx = g * cg.reshape(bshape)
    else:
        cx = (-a * inv * sgx / n).to(x.dtype)
        c0 = (-a * sg / n).float()
        dx = (g * cg.reshape(bshape)
              + (x - mean.to(x.dtype).reshape(bshape)) * cx.reshape(bshape)
              + c0.reshape(bshape).to(g.dtype))
    return dx.to(x.dtype), sgx.to(scale.dtype), sg.to(scale.dtype)


@op("batch_norm")
def _batch_norm(ctx):
    x = ctx.in_("X")
    mean, inv, bshape, _ = bn_forward_stats(
        ctx, x, ctx.attr("data_layout", "NCHW"))
    a, b = bn_fold(x, ctx.in_("Scale"), ctx.in_("Bias"), mean, inv)
    ctx.set_out("Y", x * a.reshape(bshape) + b.reshape(bshape))


@op("batch_norm_grad", no_grad=True)
def _batch_norm_grad(ctx):
    """The JAX package replays the forward under ``jax.vjp`` here; the
    closed form below is that vjp written out (the running-stat inputs
    get no gradient)."""
    x = ctx.in_("X")
    dys = ctx.ins("Y" + GRAD_SUFFIX, missing_ok=True)
    dy = dys[0] if dys and dys[0] is not None else torch.zeros_like(x)
    dx, dscale, dbias = bn_backward(
        x, dy, ctx.in_("Scale"), ctx.in_("SavedMean"),
        ctx.in_("SavedVariance"), ctx.attr("data_layout", "NCHW"),
        bn_is_test(ctx))
    if ctx.has_output("X" + GRAD_SUFFIX):
        ctx.set_out("X" + GRAD_SUFFIX, dx)
    if ctx.has_output("Scale" + GRAD_SUFFIX):
        ctx.set_out("Scale" + GRAD_SUFFIX, dscale)
    if ctx.has_output("Bias" + GRAD_SUFFIX):
        ctx.set_out("Bias" + GRAD_SUFFIX, dbias)


@grad_maker("batch_norm")
def _bn_grad_maker(op_, no_grad_names=frozenset()):
    # default maker, but never produce grads for the running-stat inputs
    descs = default_grad_maker(op_, no_grad_names)
    for d in descs:
        for slot in ("Mean" + GRAD_SUFFIX, "Variance" + GRAD_SUFFIX):
            if slot in d["outputs"]:
                d["outputs"][slot] = [EMPTY_VAR_NAME] * len(d["outputs"][slot])
    return descs


# -- softmax_with_cross_entropy (reference: softmax_with_cross_entropy_op) --
@op("softmax_with_cross_entropy")
def _softmax_ce_lower(ctx):
    """Log-softmax in f32 as (max, logsumexp); the Softmax output in the
    logits' dtype; hard or soft labels; ``ignore_index`` honoured when
    >= 0 (JAX :471)."""
    logits, label = ctx.in_("Logits"), ctx.in_("Label")
    axis = ctx.attr("axis", -1)
    ignore_index = ctx.attr("ignore_index", -100)
    x32 = logits.float()
    m = x32.amax(dim=axis, keepdim=True)
    lse = m + torch.log(torch.exp(x32 - m).sum(dim=axis, keepdim=True))
    ctx.set_out("Softmax", torch.exp(x32 - lse).to(logits.dtype))
    if ctx.attr("soft_label", False):
        loss = (label.float() * (lse - x32)).sum(dim=axis, keepdim=True)
    else:
        lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
        lbl = lbl.long().unsqueeze(axis)
        loss = lse - torch.take_along_dim(x32, lbl, dim=axis)
        if ignore_index >= 0:
            loss = torch.where(lbl != ignore_index, loss,
                               torch.zeros((), device=loss.device))
    ctx.set_out("Loss", loss)


@op("softmax_with_cross_entropy_grad", no_grad=True)
def _softmax_ce_grad_lower(ctx):
    """Closed-form dLogits = (Softmax - onehot(Label)) * dLoss from the
    saved Softmax (JAX :509), plus the softmax jacobian term when the
    Softmax output has a cotangent of its own."""
    softmax, label = ctx.in_("Softmax"), ctx.in_("Label")
    dl = ctx.in_("Loss" + GRAD_SUFFIX).float()
    axis = ctx.attr("axis", -1)
    ignore_index = ctx.attr("ignore_index", -100)
    p = softmax.float()
    if ctx.attr("soft_label", False):
        y = label.float()
        dx = (p * y.sum(dim=axis, keepdim=True) - y) * dl
    else:
        lbl = label.squeeze(axis) if label.dim() == softmax.dim() else label
        lbl = lbl.long().unsqueeze(axis)
        ax = axis % softmax.dim()
        iota_shape = [1] * softmax.dim()
        iota_shape[ax] = softmax.shape[ax]
        iota = torch.arange(softmax.shape[ax],
                            device=softmax.device).reshape(iota_shape)
        dx = (p - (iota == lbl).float()) * dl
        if ignore_index >= 0:
            dx = torch.where(lbl == ignore_index,
                             torch.zeros((), device=dx.device), dx)
    if ctx.has_input("Softmax" + GRAD_SUFFIX):
        ds = ctx.in_("Softmax" + GRAD_SUFFIX).float()
        dx = dx + p * (ds - (ds * p).sum(dim=axis, keepdim=True))
    ctx.set_out("Logits" + GRAD_SUFFIX, dx.to(softmax.dtype))


# -- accuracy (reference: operators/metrics/accuracy_op.cc) ------------------
@op("accuracy", no_grad=True)
def _accuracy(ctx):
    indices, label = ctx.in_("Indices"), ctx.in_("Label")
    if label.dim() == 1:
        label = label[:, None]
    correct = (indices == label.to(indices.dtype)).any(dim=-1)
    num_correct = correct.float().sum()
    total = torch.tensor(float(indices.shape[0]), device=indices.device)
    ctx.set_out("Accuracy", (num_correct / total).float())
    ctx.set_out("Correct", num_correct.int())
    ctx.set_out("Total", total.long())


# -- softmax and the embedding lookup -----------------------------------------
@op("softmax")
def _softmax(ctx):
    ctx.set_out("Out", torch.softmax(ctx.in_("X"), dim=ctx.attr("axis", -1)))


@op("lookup_table")
def _lookup_table(ctx):
    ids = ctx.in_("Ids")
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ctx.set_out("Out", lookup_table_v2(ctx.in_("W"), ids,
                                       ctx.attr("padding_idx", -1)))


@grad_maker("lookup_table")
def _lookup_table_grad_maker(op_, no_grad_names=frozenset()):
    if op_.attrs.get("is_sparse", False):
        raise NotImplementedError("lookup_table with is_sparse=True: the "
                                  "SelectedRows gradient is not ported "
                                  "(ROADMAP.md)")
    return default_grad_maker(op_, no_grad_names)
