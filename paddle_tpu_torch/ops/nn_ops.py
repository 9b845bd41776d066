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
``softmax_with_cross_entropy`` takes an f32 log-sum-exp of bf16 logits
(fp16 logits reach it as their f32 cast: it is black-listed under fp16),
stores the Softmax in their dtype and returns the f32 loss, and its
closed-form gradient comes back in the logits' dtype.

``layer_norm`` and ``matmul`` (with ``alpha`` / ``transpose_Y``) are the
decoder forms' (:mod:`.decoder_ops`); ``einsum`` is ``torch.einsum`` of
operands promoted as jnp promotes them (``models/bert.py``).

The static path's op lowerings (registered in :mod:`.registry`) follow
below: ``conv2d`` and ``depthwise_conv2d`` (``conv_forward`` :45,
``_conv_lower`` :81, :150-151), ``pool2d``
(:161), ``batch_norm`` (``bn_shapes`` :296, ``bn_train_stats`` :310,
:341, its grad maker :374), ``softmax_with_cross_entropy`` (:471, its
closed-form grad :509), ``accuracy`` (:858), ``dropout`` (:784, its
mask-reading grad :813-850), ``softmax`` (:460), ``squared_l2_norm``
(:597, the global-norm clip's) and
``lookup_table`` (:692-708: ids with a trailing unit axis squeezed, the
dense gradient of the default grad maker; ``is_sparse`` raises, its
SelectedRows gradient is not ported), ``lookup_table_v2`` and its alias
``embedding`` (:706-707, ids as given), ``layer_norm`` (:388: statistics
in f32, y in x's dtype; a bf16 or fp16 x with Scale and Bias rounds where
:func:`layer_norm_lowp` does), ``log_softmax`` (:465), ``cross_entropy``
and ``cross_entropy2`` (:544, :567: probabilities in, the label's picked
probability clipped at 1e-20, ignored labels 0), ``one_hot`` and
``one_hot_v2`` (:764, :773: f32 rows, an id outside [0, depth) a row of
zeros).  conv2d, pool2d, layer_norm and
batch_norm carry explicit grad lowerings: the convolution's through
``aten.convolution_backward``, max pooling's through the indices of a
recomputed ``max_pool2d_with_indices``, batch_norm's in closed form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX
from ..framework.random import default_generator, seeded_generator
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
    """``act`` by its Paddle name, or ``x`` when None.  A bf16 or fp16
    gelu rounds where JAX's compiled gelu rounds (:func:`.gelu.gelu_lowp`)."""
    if act is None:
        return x
    if act not in _ACTS:
        raise NotImplementedError(f"activation {act!r} is not ported")
    if act == "gelu" and x.dtype in (torch.bfloat16, torch.float16):
        from .gelu import gelu_lowp
        return gelu_lowp(x)
    return _ACTS[act](x)


class _LayerNormLowp(torch.autograd.Function):
    """JAX's ``layer_norm`` lowering (``nn_ops.py:388-412``) on a bf16 or
    fp16 x, rounding where its compiled form rounds (measured against
    ``jax.jit`` on XLA's CPU, ``tests/test_torch_amp.py``).  bf16: the
    normalized value (statistics in f32) rounded to x's dtype, then
    ``* Scale`` and ``+ Bias`` as two ops in x's dtype.  fp16: XLA
    computes the fused ``* Scale + Bias`` in f32 and rounds once, so only
    the normalized value and the output round.  The backward is the
    compiled ``jax.vjp``'s: ``g = dy * Scale`` (in f32, unrounded, for
    bf16; rounded to fp16 for fp16) through the f32 normalization
    backward, dX rounded once; dScale and dBias are sums in f32 rounded
    once (XLA's CPU reduction rounds partial sums to x's dtype, so those
    two differ from it in the last bits).  In fp16 the products and sums
    take fp16 operands straight into f32 arithmetic (``torch.mul`` of an
    fp16 and an f32 tensor computes in f32), so no f32 copy of an
    activation is made; ATen's layer-norm kernels on the card take fp16
    in and out with f32 math, the CPU's run on f32 copies.

    On the card the backward is ATen's one-pass layer-norm backward with
    the forward's f32 statistics, which does exactly that f32 math (dScale
    from the unrounded normalized value).  ATen's CPU kernel takes bf16
    statistics only, so the CPU spells the same math out in f32, with
    JAX's dScale terms (the rounded normalized value times dy)."""

    @staticmethod
    def forward(ctx, x, scale, bias, shape, eps):
        s = scale.reshape(shape).to(x.dtype)
        b = bias.reshape(shape).to(x.dtype)
        ctx.shape, ctx.eps = shape, eps
        ctx.dtypes = (scale.dtype, bias.dtype, scale.shape)
        ctx.fp16 = x.dtype == torch.float16
        if ctx.fp16:
            y_hat, mean, rstd = torch.ops.aten.native_layer_norm(
                x if x.is_cuda else x.float(), list(shape), None, None, eps)
            y_hat = y_hat.to(x.dtype)
            ctx.save_for_backward(x, s, y_hat, mean, rstd)
            # the f32 product, then the f32 sum, rounded once
            return torch.mul(y_hat, s.float()).add_(b.float()).to(x.dtype)
        if x.is_cuda:
            y_hat, mean, rstd = torch.ops.aten.native_layer_norm(
                x, list(shape), None, None, eps)
            ctx.save_for_backward(x, s, mean, rstd)
        else:
            y_hat = F.layer_norm(x, shape, None, None, eps)
            ctx.save_for_backward(x, s, y_hat)
        return y_hat * s + b

    @staticmethod
    def backward(ctx, dy):
        sdt, bdt, pshape = ctx.dtypes
        rows = tuple(range(dy.dim() - len(ctx.shape)))
        if ctx.fp16:
            x, s, y_hat, mean, rstd = ctx.saved_tensors
            g = torch.mul(dy, s.float()).to(x.dtype)
            if dy.is_cuda:
                dx = torch.ops.aten.native_layer_norm_backward(
                    g.contiguous(), x, list(ctx.shape), mean, rstd, None,
                    None, [True, False, False])[0]
            else:
                dx = torch.ops.aten.native_layer_norm_backward(
                    g.float(), x.float(), list(ctx.shape), mean, rstd, None,
                    None, [True, False, False])[0].to(x.dtype)
            # fp16 x fp16 is exact in f32
            dscale = torch.mul(y_hat, dy.float()).sum(dim=rows).to(x.dtype)
            dbias = dy.sum(dim=rows, dtype=torch.float32).to(x.dtype)
        elif dy.is_cuda:
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
    """LayerNorm over the trailing ``shape`` axes of a bf16 or fp16 ``x`` with
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
    return _dropout_apply(x, keep, p, implementation)


def _dropout_apply(x: torch.Tensor, keep: torch.Tensor, p: float,
                   implementation: str) -> torch.Tensor:
    """Training dropout of ``x`` under the boolean ``keep`` mask."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if implementation == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        if x.dtype != torch.float32:
            # the factor in x's dtype, as JAX's jnp.asarray(scale, x.dtype)
            scale = torch.full((), scale, dtype=x.dtype, device=x.device)
        return torch.where(keep, x * scale, zero)
    return torch.where(keep, x, zero)


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


def conv_attrs(ctx, depthwise=False) -> dict:
    """The conv attrs a conv2d (or fused conv) op carries;
    ``depthwise``: a ``depthwise_conv2d`` op, one group per input
    channel."""
    return dict(
        strides=list(ctx.attr("strides", [1, 1])),
        paddings=list(ctx.attr("paddings", [0, 0])),
        dilations=list(ctx.attr("dilations", [1, 1])),
        groups=ctx.attr("groups", 1) or 1,
        data_format=ctx.attr("data_format", "NCHW"),
        padding_algorithm=ctx.attr("padding_algorithm", "EXPLICIT"),
        depthwise=depthwise or bool(ctx.attr("depthwise", False)),
    )


def _conv_lower(ctx, depthwise=False):
    ctx.set_out("Output", conv_forward(ctx.in_("Input"), ctx.in_("Filter"),
                                       **conv_attrs(ctx, depthwise)))


def _conv_grad_lower(ctx, depthwise=False):
    need_x = ctx.has_output("Input" + GRAD_SUFFIX)
    need_w = ctx.has_output("Filter" + GRAD_SUFFIX)
    dx, dw = conv_backward(ctx.in_("Input"), ctx.in_("Filter"),
                           ctx.in_("Output" + GRAD_SUFFIX),
                           need_input=need_x, need_filter=need_w,
                           **conv_attrs(ctx, depthwise))
    if need_x:
        ctx.set_out("Input" + GRAD_SUFFIX, dx)
    if need_w:
        ctx.set_out("Filter" + GRAD_SUFFIX, dw)


# depthwise_conv2d (JAX nn_ops.py:151): the conv2d lowering with one group
# per input channel, cuDNN's grouped convolution in both directions
op("conv2d")(_conv_lower)
op("conv2d_grad", no_grad=True)(_conv_grad_lower)
op("depthwise_conv2d")(lambda ctx: _conv_lower(ctx, depthwise=True))
op("depthwise_conv2d_grad", no_grad=True)(
    lambda ctx: _conv_grad_lower(ctx, depthwise=True))


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
        # p - onehot(label) without a one-hot tensor: -1 added at each
        # row's label (-0.0, which changes nothing, where the label lies
        # outside the classes and the one-hot row would be zeros), so a
        # vocabulary-wide loss holds one copy of p, not three
        n = softmax.shape[axis]
        inside = (lbl >= 0) & (lbl < n)
        dx = p.clone().scatter_add_(
            axis, torch.where(inside, lbl, torch.zeros_like(lbl)),
            -inside.float())
        dx.mul_(dl)
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
    # a fill, not a host tensor copied over: capturable in a CUDA graph
    total = torch.full((), float(indices.shape[0]), device=indices.device)
    ctx.set_out("Accuracy", (num_correct / total).float())
    ctx.set_out("Correct", num_correct.int())
    ctx.set_out("Total", total.long())


# -- dropout (reference: dropout_op.cc; JAX ops/nn_ops.py:784-850) ------------
@op("dropout")
def _dropout_op(ctx):
    """The static ``dropout``: ``Out`` as :func:`dropout`, and ``Mask``
    the uint8 keep mask (ones in x's dtype when ``is_test``), which
    ``dropout_grad`` reads; the mask is drawn from the executor's
    generator, or from one seeded with ``seed`` when ``fix_seed``."""
    x = ctx.in_("X")
    p = float(ctx.attr("dropout_prob", 0.5))
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        ctx.set_out("Out", dropout(x, p, True, impl))
        if ctx.has_output("Mask"):
            ctx.set_out("Mask", torch.ones_like(x))
        return
    if x.device.type == "meta":
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        gen = (seeded_generator(x.device, ctx.attr("seed", 0))
               if ctx.attr("fix_seed", False) else
               ctx.rng() or default_generator(x.device))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    ctx.set_out("Out", _dropout_apply(x, keep, p, impl))
    ctx.set_out("Mask", keep.to(torch.uint8))


@grad_maker("dropout")
def _dropout_grad_maker(op_, no_grad_names=frozenset()):
    return [dict(
        type="dropout_grad",
        inputs={"Mask": op_.output("Mask"),
                "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                      for n in op_.output("Out")]},
        outputs={"X" + GRAD_SUFFIX: [
            (n + GRAD_SUFFIX) if n not in no_grad_names else EMPTY_VAR_NAME
            for n in op_.input("X")]},
        attrs=dict(op_.attrs))]


@op("dropout_grad", no_grad=True)
def _dropout_grad(ctx):
    """``dOut`` under the forward's mask (and its upscale); at test the
    forward's identity or ``* (1 - p)``."""
    dout = ctx.in_("Out" + GRAD_SUFFIX)
    p = float(ctx.attr("dropout_prob", 0.5))
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        ctx.set_out("X" + GRAD_SUFFIX, dropout(dout, p, True, impl))
        return
    keep = ctx.in_("Mask") > 0
    ctx.set_out("X" + GRAD_SUFFIX, _dropout_apply(dout, keep, p, impl))


# -- the squared L2 norm of gradient clipping (JAX nn_ops.py:597) ------------
@op("squared_l2_norm")
def _squared_l2_norm(ctx):
    """``sum(x^2)`` over the whole tensor, as a ``[1]`` tensor."""
    x = ctx.in_("X")
    ctx.set_out("Out", (x * x).sum().reshape(1))


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


def _lookup_grad(ctx, squeeze_last):
    """The dense W gradient of an embedding lookup: each row of dOut added
    into its id's row (ids clipped as the forward clips them, the
    ``padding_idx`` rows' cotangents dropped), by ``index_put_`` with
    ``accumulate``, which on the card sorts the ids and sums each id's
    rows in one order, so every run gives the same bits (a captured step
    equals an eager one); ATen's embedding backward does not on the card
    once an id repeats across thousands of rows."""
    if not ctx.has_output("W" + GRAD_SUFFIX):
        return
    w, ids = ctx.in_("W"), ctx.in_("Ids")
    if squeeze_last and ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long().clamp(0, w.shape[0] - 1).reshape(-1)
    g = ctx.in_("Out" + GRAD_SUFFIX).reshape(-1, w.shape[-1]).to(w.dtype)
    pad = ctx.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        g = g * (ids != pad).unsqueeze(-1).to(g.dtype)
    ctx.set_out("W" + GRAD_SUFFIX, torch.zeros_like(w).index_put_(
        (ids,), g, accumulate=True))


op("lookup_table_grad", no_grad=True)(
    lambda ctx: _lookup_grad(ctx, squeeze_last=True))



@grad_maker("lookup_table_v2")
def _lookup_table_v2_grad_maker(op_, no_grad_names=frozenset()):
    return _lookup_table_grad_maker(op_, no_grad_names)


def _lookup_v2(ctx):
    ctx.set_out("Out", lookup_table_v2(ctx.in_("W"), ctx.in_("Ids"),
                                       ctx.attr("padding_idx", -1)))


op("lookup_table_v2")(_lookup_v2)
op("embedding")(_lookup_v2)
grad_maker("embedding")(_lookup_table_v2_grad_maker)
for _t in ("lookup_table_v2_grad", "embedding_grad"):
    op(_t, no_grad=True)(lambda ctx: _lookup_grad(ctx, squeeze_last=False))


# -- layer_norm (reference: layer_norm_op.cc; JAX nn_ops.py:388) ------------
def _ln_parts(ctx):
    """(x, Scale, Bias, the normalized shape, eps)."""
    x = ctx.in_("X")
    begin = ctx.attr("begin_norm_axis", 1)
    scale = ctx.in_("Scale") if ctx.has_input("Scale") else None
    bias = ctx.in_("Bias") if ctx.has_input("Bias") else None
    return x, scale, bias, tuple(x.shape[begin:]), ctx.attr("epsilon", 1e-5)


def _ln_lowp(x, scale, bias) -> bool:
    return (x.dtype in (torch.bfloat16, torch.float16) and scale is not None
            and bias is not None)


def _ln_y(x, scale, bias, shape, eps):
    """Y as JAX computes it: the normalized value in f32 rounded to x's
    dtype, then ``* Scale`` and ``+ Bias`` in x's dtype (bf16 and fp16
    with both: :func:`layer_norm_lowp`'s rounding points)."""
    if _ln_lowp(x, scale, bias):
        return layer_norm_lowp(x, scale, bias, shape, eps)
    if x.dtype == torch.float32:
        return F.layer_norm(x, shape, None if scale is None else
                            scale.reshape(shape),
                            None if bias is None else bias.reshape(shape),
                            eps)
    y = F.layer_norm(x.float(), shape, None, None, eps).to(x.dtype)
    if scale is not None:
        y = y * scale.reshape(shape).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(shape).to(x.dtype)
    return y


@op("layer_norm")
def _layer_norm(ctx):
    """Y over the trailing axes from ``begin_norm_axis``, and Mean and
    Variance (biased) over them in f32, shaped as the leading axes."""
    x, scale, bias, shape, eps = _ln_parts(ctx)
    axes = tuple(range(x.dim() - len(shape), x.dim()))
    var, mean = torch.var_mean(x.float(), dim=axes, unbiased=False)
    ctx.set_out("Y", _ln_y(x, scale, bias, shape, eps))
    ctx.set_out("Mean", mean)
    ctx.set_out("Variance", var)


@op("layer_norm_grad", no_grad=True)
def _layer_norm_grad(ctx):
    """f32: ATen's one-pass layer-norm backward from the forward's Mean
    and ``rsqrt(Variance + eps)``; bf16 / fp16: autograd through the
    forward's rounding points (:func:`layer_norm_lowp`'s backward)."""
    x, scale, bias, shape, eps = _ln_parts(ctx)
    dys = ctx.ins("Y" + GRAD_SUFFIX, missing_ok=True)
    dy = dys[0] if dys and dys[0] is not None else torch.zeros_like(x)
    need = [ctx.has_output(s + GRAD_SUFFIX) and (s == "X" or v is not None)
            for s, v in (("X", x), ("Scale", scale), ("Bias", bias))]
    if x.dtype == torch.float32:
        stat = tuple(x.shape[:x.dim() - len(shape)]) + (1,) * len(shape)
        mean = ctx.in_("Mean").reshape(stat)
        rstd = torch.rsqrt(ctx.in_("Variance").reshape(stat) + eps)
        grads = torch.ops.aten.native_layer_norm_backward(
            dy.to(x.dtype).contiguous(), x.contiguous(), list(shape), mean,
            rstd, None if scale is None else scale.reshape(shape),
            None if bias is None else bias.reshape(shape), need)
    else:
        leaves = [t.detach().requires_grad_(True) if t is not None else None
                  for t in (x, scale, bias)]
        with torch.enable_grad():
            y = _ln_y(*leaves, shape, eps)
            want = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(y, want, dy.to(y.dtype)))
        grads = [next(got) if n else None for n in need]
    for (slot, src), g, n in zip((("X", x), ("Scale", scale),
                                  ("Bias", bias)), grads, need):
        if n:
            ctx.set_out(slot + GRAD_SUFFIX, g.reshape(src.shape).to(
                src.dtype))


# -- log_softmax and the cross entropies (JAX nn_ops.py:465, :544, :567) -----
@op("log_softmax")
def _log_softmax(ctx):
    ctx.set_out("Out", torch.log_softmax(ctx.in_("X"),
                                         dim=ctx.attr("axis", -1)))


def _picked(x, label, ignore_index):
    """(-log(clip(p[label], 1e-20)) with ignored labels 0, the picked
    probability): the hard-label terms of both cross entropies."""
    lbl = label.long()
    if lbl.dim() == x.dim():
        lbl = lbl.squeeze(-1)
    mask = (lbl != ignore_index).unsqueeze(-1)
    safe = torch.where(mask.squeeze(-1), lbl, torch.zeros_like(lbl))
    picked = torch.take_along_dim(x, safe.unsqueeze(-1), dim=-1)
    loss = -torch.log(torch.clamp(picked, min=1e-20))
    return torch.where(mask, loss, torch.zeros((), dtype=loss.dtype,
                                               device=loss.device)), picked


@op("cross_entropy")
def _cross_entropy(ctx):
    """``-sum(label * log(clip(X, 1e-20)))`` over the last axis for soft
    labels, else ``-log(clip(X[label], 1e-20))``, kept dims."""
    x, label = ctx.in_("X"), ctx.in_("Label")
    if ctx.attr("soft_label", False):
        ctx.set_out("Y", -(label * torch.log(torch.clamp(x, min=1e-20))).sum(
            dim=-1, keepdim=True))
        return
    ctx.set_out("Y", _picked(x, label, ctx.attr("ignore_index", -100))[0])


@op("cross_entropy2")
def _cross_entropy2(ctx):
    x = ctx.in_("X")
    y, picked = _picked(x, ctx.in_("Label"), ctx.attr("ignore_index", -100))
    ctx.set_out("Y", y)
    ctx.set_out("XShape", torch.zeros((0,), dtype=x.dtype, device=x.device))
    ctx.set_out("MatchX", picked)


# -- one_hot (JAX nn_ops.py:764, :773) ---------------------------------------
def _one_hot(x, depth):
    """f32 rows with a 1 at each id; an id outside [0, depth) gives a row
    of zeros, as ``jax.nn.one_hot``."""
    cols = torch.arange(depth, device=x.device)
    return (x.long().unsqueeze(-1) == cols).to(torch.float32)


@op("one_hot", no_grad=True)
def _one_hot_op(ctx):
    """Ids with a trailing unit axis squeezed first."""
    x = ctx.in_("X")
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    ctx.set_out("Out", _one_hot(x, ctx.attr("depth", 1)))


@op("one_hot_v2", no_grad=True)
def _one_hot_v2(ctx):
    ctx.set_out("Out", _one_hot(ctx.in_("X"), ctx.attr("depth", 1)))
