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
* the activations by name (:func:`activation`: the lowering of the op
  an ``act=`` appends), and ``unsqueeze2`` (``tensor_ops.py:284``);
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
dense gradient of the default grad maker; under ``is_sparse`` the
SelectedRows gradient of ``lookup_table_sparse_grad``, :711-761),
``lookup_table_v2`` and its alias ``embedding`` (:706-707, ids as
given), ``layer_norm`` (:388: statistics
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
from ..framework.selected_rows import SelectedRows
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


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` by its Paddle name, or ``x`` when None: the op an ``act=``
    appends (any unary activation op, at its default attrs) run through
    its lowering, so a bf16 or fp16 gelu rounds where JAX's compiled
    gelu rounds (:func:`.gelu.gelu_lowp`)."""
    if act is None:
        return x
    from .registry import eager_call
    return eager_call(act, {"X": [x]}, out_arity={"Out": 1})["Out"][0]


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


_CHANNELS_FIRST = ("NCHW", "NCDHW", "AnyLayout")


def _nchw(x, data_format):
    """``x`` as a channels-first view (an NHWC or NDHWC tensor is
    permuted, not copied)."""
    if data_format in _CHANNELS_FIRST:
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _from_nchw(x, data_format):
    if data_format in _CHANNELS_FIRST:
        return x
    return x.permute(0, *range(2, x.dim()), 1)


def _pad_widths(pads):
    """[(lo, hi)] per spatial dim -> F.pad's widths (last dim first)."""
    return tuple(v for lo, hi in reversed(pads) for v in (lo, hi))


def _split_pads(pads):
    """(symmetric padding for the conv call, explicit F.pad widths or
    None)."""
    if all(lo == hi for lo, hi in pads):
        return [lo for lo, _ in pads], None
    return [0] * len(pads), _pad_widths(pads)


def _conv_geometry(x_nchw, w, strides, paddings, dilations, groups,
                   padding_algorithm, depthwise):
    pads = _conv_padding(list(paddings), padding_algorithm,
                         list(x_nchw.shape[2:]), list(w.shape[2:]),
                         list(strides), list(dilations))
    if depthwise:
        groups = x_nchw.shape[1]
    return pads, groups or 1


def conv_forward(x, w, *, strides, paddings, dilations, groups=1,
                 data_format="NCHW", padding_algorithm="EXPLICIT",
                 depthwise=False):
    """The conv2d / conv3d forward as a pure function — the exact
    computation the ``conv2d`` lowering runs, shared with
    ``fused_conv_bn_act`` (``fused_ops.py``) so fusing the epilogue never
    changes the conv.  Filters are OIHW (OIDHW) in both layouts."""
    xc = _nchw(x, data_format)
    pads, groups = _conv_geometry(xc, w, strides, paddings, dilations,
                                  groups, padding_algorithm, depthwise)
    sym, explicit = _split_pads(pads)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    conv = F.conv3d if xc.dim() == 5 else F.conv2d
    out = conv(xc, w, None, list(strides), sym, list(dilations), groups)
    return _from_nchw(out, data_format)


def conv_backward(x, w, dout, *, strides, paddings, dilations, groups=1,
                  data_format="NCHW", padding_algorithm="EXPLICIT",
                  depthwise=False, need_input=True, need_filter=True):
    """(dInput, dFilter) of :func:`conv_forward` for the cotangent
    ``dout`` (either may be None when not asked for)."""
    xc = _nchw(x, data_format)
    spatial = xc.shape[2:]
    pads, groups = _conv_geometry(xc, w, strides, paddings, dilations,
                                  groups, padding_algorithm, depthwise)
    sym, explicit = _split_pads(pads)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        _nchw(dout, data_format), xc, w, None, list(strides), sym,
        list(dilations), False, [0] * len(spatial), groups,
        [need_input, need_filter, False])
    if dx is not None and explicit is not None:
        dx = dx[(slice(None), slice(None)) + tuple(
            slice(lo, lo + n) for (lo, _), n in zip(pads, spatial))]
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
# per input channel, cuDNN's grouped convolution in both directions;
# conv3d (:152) the same over NCDHW / NDHWC
op("conv2d")(_conv_lower)
op("conv2d_grad", no_grad=True)(_conv_grad_lower)
op("depthwise_conv2d")(lambda ctx: _conv_lower(ctx, depthwise=True))
op("depthwise_conv2d_grad", no_grad=True)(
    lambda ctx: _conv_grad_lower(ctx, depthwise=True))
op("conv3d")(_conv_lower)
op("conv3d_grad", no_grad=True)(_conv_grad_lower)


def conv_transpose_forward(x, w, *, strides, paddings, dilations, groups=1,
                           data_format="NCHW", padding_algorithm="EXPLICIT",
                           output_padding=()):
    """The transposed convolution as JAX lowers it (``_conv_lower``
    :118-146: a conv over the input dilated by ``strides``, with the
    flipped, transposed filter, padded ``eff_k - 1 - pad`` on each side
    and ``output_padding`` more at the end), which is cuDNN's transposed
    convolution at padding 0 cropped by (lo, hi - output_padding) on each
    spatial dim (a negative crop pads zeros).  The pads come from
    ``paddings`` / ``padding_algorithm`` over the *input* size, as in JAX;
    its ``output_size`` attr is not read, as in JAX.  Filters are
    (C_in, C_out / groups, *k)."""
    xc = _nchw(x, data_format)
    nd = xc.dim() - 2
    strides, dilations = list(strides), list(dilations)
    pads = _conv_padding(list(paddings), padding_algorithm,
                         list(xc.shape[2:]), list(w.shape[2:]), strides,
                         dilations)
    op_ = list(output_padding) or [0] * nd
    conv = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
    full = conv(xc, w, None, strides, 0, 0, groups or 1, dilations)
    crop = _pad_widths([(-lo, op_[i] - hi) for i, (lo, hi) in
                        enumerate(pads)])
    if any(crop):
        full = F.pad(full, crop)
    return _from_nchw(full, data_format)


def _conv_transpose_lower(ctx):
    ctx.set_out("Output", conv_transpose_forward(
        ctx.in_("Input"), ctx.in_("Filter"),
        strides=ctx.attr("strides", [1, 1]),
        paddings=ctx.attr("paddings", [0, 0]),
        dilations=ctx.attr("dilations", [1, 1]),
        groups=ctx.attr("groups", 1) or 1,
        data_format=ctx.attr("data_format", "NCHW"),
        padding_algorithm=ctx.attr("padding_algorithm", "EXPLICIT"),
        output_padding=ctx.attr("output_padding", []) or ()))


# conv2d_transpose, depthwise_conv2d_transpose (its ``groups`` as given,
# as JAX reads it) and conv3d_transpose (JAX nn_ops.py:153-155); their
# grads replay the forward under the registry's vjp
for _t in ("conv2d_transpose", "depthwise_conv2d_transpose",
           "conv3d_transpose"):
    op(_t)(_conv_transpose_lower)


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
        (oh, ow), (h, w) = ksize, xc.shape[2:]
        if h % oh or w % ow:
            raise NotImplementedError(
                f"adaptive pool2d to {ksize} from ({h}, {w}): only "
                f"divisible sizes, as in the JAX package (ROADMAP.md)")
        return "adaptive", xc, (oh, ow)
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
        sym, explicit = [0, 0], _pad_widths(pads)
    return "window", xc, (ksize, strides, sym, explicit)


def _pool_forward(ctx, kind, xc, args, is_max):
    """The pooled NCHW tensor.  Adaptive (divisible): each output cell
    the max or mean of its (h / oh, w / ow) block, as JAX's reshape
    (ties of a max share its gradient).  Average pooling over explicit
    (asymmetric or ceil-mode) pads: window sums over the zero-padded
    input divided by the window size, or with ``exclusive`` by the
    count of real elements in the window, as JAX's ``reduce_window``
    sums."""
    if kind == "global":
        return (xc.amax(dim=(2, 3), keepdim=True) if is_max
                else xc.mean(dim=(2, 3), keepdim=True))
    if kind == "adaptive":
        (oh, ow), (n, c, h, w) = args, xc.shape
        r = xc.reshape(n, c, oh, h // oh, ow, w // ow)
        return r.amax(dim=(3, 5)) if is_max else r.mean(dim=(3, 5))
    ksize, strides, sym, explicit = args
    if is_max:
        if explicit is not None:
            xc = F.pad(xc, explicit, value=float("-inf"))
        return F.max_pool2d(xc, ksize, strides, sym)
    exclusive = ctx.attr("exclusive", True)
    if explicit is None:
        return F.avg_pool2d(xc, ksize, strides, sym,
                            count_include_pad=not exclusive)
    total = F.avg_pool2d(F.pad(xc, explicit), ksize, strides, 0,
                         divisor_override=1)
    if not exclusive:
        return total / (ksize[0] * ksize[1])
    ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                      device=xc.device)
    return total / F.avg_pool2d(F.pad(ones, explicit), ksize, strides, 0,
                                divisor_override=1)


@op("pool2d")
def _pool2d(ctx):
    x = ctx.in_("X")
    fmt = ctx.attr("data_format", "NCHW")
    is_max = ctx.attr("pooling_type", "max") == "max"
    kind, xc, args = _pool_setup(ctx, x)
    ctx.set_out("Out", _from_nchw(_pool_forward(ctx, kind, xc, args,
                                                is_max), fmt))


@op("pool2d_grad", no_grad=True)
def _pool2d_grad(ctx):
    """Global max: the cotangent split evenly over the tied maxima (JAX's
    reduce-max rule); window max: to the first maximum of each window in
    row-major order (JAX's select_and_scatter with ``ge``), through the
    indices of a recomputed ``max_pool2d_with_indices``; average: spread
    over the window (``avg_pool2d_backward``); adaptive, and average
    over explicit pads: the vjp of :func:`_pool_forward`."""
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
    elif kind == "adaptive" or (not is_max and args[3] is not None):
        _, pull = torch.func.vjp(
            lambda t: _pool_forward(ctx, kind, t, args, is_max), xc)
        (dx,) = pull(dout.to(xc.dtype))
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
        # JAX's take_along_axis: a negative label counts from the end, one
        # still outside the classes (an ignore label such as 255) picks
        # NaN; the gather itself never leaves the row
        n = logits.shape[axis]
        at = torch.where(lbl < 0, lbl + n, lbl)
        inside = (at >= 0) & (at < n)
        picked = torch.take_along_dim(
            x32, torch.where(inside, at, torch.zeros_like(at)), dim=axis)
        loss = lse - torch.where(inside, picked, torch.full_like(
            picked, float("nan")))
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


def _lookup_sparse_grad_maker(fwd_type, squeeze_last):
    """An ``is_sparse`` lookup's W gradient is a SelectedRows made in
    O(batch) by ``lookup_table_sparse_grad`` (JAX ``nn_ops.py:711-737``;
    reference: lookup_table_op.cc's SelectedRows grad kernel); a dense
    one takes the default grad maker.  Ids get no gradient."""

    @grad_maker(fwd_type)
    def maker(op_, no_grad_names=frozenset()):
        if not op_.attrs.get("is_sparse", False):
            return default_grad_maker(op_, no_grad_names)
        w = op_.input("W")[0]
        out = op_.output("Out")[0]
        w_grad = (EMPTY_VAR_NAME if w in no_grad_names
                  else w + GRAD_SUFFIX)
        return [dict(
            type="lookup_table_sparse_grad",
            inputs={"W": list(op_.input("W")),
                    "Ids": list(op_.input("Ids")),
                    "Out" + GRAD_SUFFIX: [out + GRAD_SUFFIX]},
            outputs={"W" + GRAD_SUFFIX: [w_grad]},
            attrs={**dict(op_.attrs), "__squeeze_last__": squeeze_last})]
    return maker


_lookup_sparse_grad_maker("lookup_table", True)
_lookup_sparse_grad_maker("lookup_table_v2", False)
_lookup_sparse_grad_maker("embedding", False)


@op("lookup_table_sparse_grad", no_grad=True)
def _lookup_table_sparse_grad(ctx):
    """The SelectedRows W gradient: rows are the ids as the forward
    clips them (duplicates kept), values dOut's rows, a ``padding_idx``
    row's value zeroed (JAX ``nn_ops.py:740-761``)."""
    w, ids = ctx.in_("W"), ctx.in_("Ids")
    if (ctx.attr("__squeeze_last__", False) and ids.dim() > 1
            and ids.shape[-1] == 1):
        ids = ids.squeeze(-1)
    rows = ids.long().reshape(-1)
    g = ctx.in_("Out" + GRAD_SUFFIX).reshape(rows.shape[0], w.shape[-1])
    pad = ctx.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        g = torch.where((rows != pad).unsqueeze(-1), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
    ctx.set_out("W" + GRAD_SUFFIX, SelectedRows(
        rows.clamp(0, w.shape[0] - 1), g, w.shape[0]))


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



def _lookup_v2(ctx):
    ctx.set_out("Out", lookup_table_v2(ctx.in_("W"), ctx.in_("Ids"),
                                       ctx.attr("padding_idx", -1)))


op("lookup_table_v2")(_lookup_v2)
op("embedding")(_lookup_v2)
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


# ==========================================================================
# The rest of JAX's nn_ops: norms, prelu, pads, interpolation, sampling,
# metrics and the simple losses.  Their grads are the registry's vjp
# replay of forwards written as JAX writes them (``cvm`` has JAX's grad
# maker and closed-form grad).
# ==========================================================================
def _channel_shape(x, c):
    return (1, c) + (1,) * (x.dim() - 2)


@op("instance_norm")
def _instance_norm(ctx):
    """Per sample and channel over the spatial axes, in x's dtype (JAX
    :415); SavedMean and SavedVariance (inv-std) shaped (N, C)."""
    x = ctx.in_("X")
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + ctx.attr("epsilon", 1e-5))
    y = (x - mean) * inv
    if ctx.has_input("Scale"):
        y = y * ctx.in_("Scale").reshape(_channel_shape(x, -1))
    if ctx.has_input("Bias"):
        y = y + ctx.in_("Bias").reshape(_channel_shape(x, -1))
    ctx.set_out("Y", y)
    ctx.set_out("SavedMean", mean.reshape(x.shape[:2]))
    ctx.set_out("SavedVariance", inv.reshape(x.shape[:2]))


@op("group_norm")
def _group_norm(ctx):
    """Over each sample's ``groups`` channel groups, in x's dtype, x
    channels-first as JAX reads it (:435); Mean and Variance (N, G)."""
    x = ctx.in_("X")
    g = ctx.attr("groups", 1)
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    var, mean = torch.var_mean(xg, dim=tuple(range(2, xg.dim())),
                               unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + ctx.attr("epsilon", 1e-5))
         ).reshape(x.shape)
    if ctx.has_input("Scale"):
        y = y * ctx.in_("Scale").reshape(_channel_shape(x, c))
    if ctx.has_input("Bias"):
        y = y + ctx.in_("Bias").reshape(_channel_shape(x, c))
    ctx.set_out("Y", y)
    ctx.set_out("Mean", mean.reshape(n, g))
    ctx.set_out("Variance", var.reshape(n, g))


@op("prelu")
def _prelu(ctx):
    """``where(x > 0, x, alpha * x)``, alpha one scalar (``all``), one a
    channel or one an element (JAX :1021)."""
    x, alpha = ctx.in_("X"), ctx.in_("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape(_channel_shape(x, -1))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.set_out("Out", torch.where(x > 0, x, a * x))


# -- pads (JAX nn_ops.py:891-935) --------------------------------------------
def _pad_modes(x, pads, mode, value):
    """``jnp.pad`` of ``x`` by [(lo, hi)] per axis: constant, reflect, or
    edge (any other mode, as JAX's lowering reads it); reflect and edge
    gather each padded axis's source indices."""
    if mode == "constant":
        return F.pad(x, _pad_widths(pads), value=value)
    for ax, (lo, hi) in enumerate(pads):
        if lo or hi:
            n = x.shape[ax]
            i = torch.arange(-lo, n + hi, device=x.device)
            if mode == "reflect":
                i = torch.where(i < 0, -i, torch.where(i >= n,
                                                       2 * (n - 1) - i, i))
            x = x.index_select(ax, i.clamp(0, n - 1))
    return x


@op("pad")
def _pad(ctx):
    x = ctx.in_("X")
    p = ctx.attr("paddings", [])
    ctx.set_out("Out", _pad_modes(
        x, [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())], "constant",
        float(ctx.attr("pad_value", 0.0))))


@op("pad2d")
def _pad2d(ctx):
    x = ctx.in_("X")
    p = ctx.attr("paddings", [0, 0, 0, 0])
    if ctx.attr("data_format", "NCHW") == "NCHW":
        pads = [(0, 0), (0, 0), (p[0], p[1]), (p[2], p[3])]
    else:
        pads = [(0, 0), (p[0], p[1]), (p[2], p[3]), (0, 0)]
    ctx.set_out("Out", _pad_modes(x, pads, ctx.attr("mode", "constant"),
                                  float(ctx.attr("pad_value", 0.0))))


@op("pad3d")
def _pad3d(ctx):
    x = ctx.in_("X")
    p = ctx.attr("paddings", [0] * 6)
    if ctx.attr("data_format", "NCDHW") == "NCDHW":
        pads = [(0, 0), (0, 0), (p[4], p[5]), (p[2], p[3]), (p[0], p[1])]
    else:
        pads = [(0, 0), (p[4], p[5]), (p[2], p[3]), (p[0], p[1]), (0, 0)]
    ctx.set_out("Out", _pad_modes(x, pads, ctx.attr("mode", "constant"),
                                  float(ctx.attr("value", 0.0))))


# -- interpolation (JAX nn_ops.py:938-956) -----------------------------------
def _triangle(d):
    return torch.clamp_min(1 - d, 0)


def _keys_cubic(d):
    """Keys' cubic kernel with a = -0.5, as ``jax.image``'s."""
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(out), out)


def resize_weights(m: int, n: int, method: str, dtype, device):
    """The (m, n) matrix that resizes an axis of m samples to n as
    ``jax.image.resize`` does (``compute_weight_mat``, in f32, cast to
    the input's dtype): half-pixel centres, the kernel widened by the
    down-scale factor (antialiasing), each column normalized; nearest
    picks ``floor((j + 0.5) * m / n)``."""
    j = torch.arange(n, dtype=torch.float32, device=device)
    if method == "nearest":
        src = torch.floor((j + 0.5) * m / n).long()
        w = (torch.arange(m, device=device)[:, None] == src).float()
        return w.to(dtype)
    inv = 1.0 / (n / m)
    sample = (j + 0.5) * inv - 0.5
    d = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    d = d / max(inv, 1.0)
    w = _triangle(d) if method == "bilinear" else _keys_cubic(d)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def resize(x, out_h: int, out_w: int, method: str):
    """``jax.image.resize`` of an NCHW ``x`` over its last two axes: one
    product with each axis's :func:`resize_weights` in x's dtype (an axis
    that keeps its size is left alone, as in JAX), so the forward and the
    backward are GEMMs, the same bits on every run."""
    h, w = x.shape[2:]
    if out_h != h:
        x = torch.matmul(resize_weights(h, out_h, method, x.dtype,
                                        x.device).t(), x)
    if out_w != w:
        x = torch.matmul(x, resize_weights(w, out_w, method, x.dtype,
                                           x.device))
    return x


def _interp(ctx, method):
    """:func:`resize` of an NCHW ``X`` to (``out_h``, ``out_w``), or by
    ``scale`` when it is positive.  ``align_corners`` and ``align_mode``
    are not read, as in the JAX lowering (a known divergence from
    Paddle, ROADMAP.md); an ``OutSize`` input raises, as in JAX."""
    x = ctx.in_("X")
    if ctx.has_input("OutSize"):
        raise NotImplementedError("an OutSize input is not supported, as "
                                  "in the JAX package (ROADMAP.md)")
    out_h, out_w = ctx.attr("out_h", -1), ctx.attr("out_w", -1)
    scale = ctx.attr("scale", 0.0)
    if scale and scale > 0:
        out_h, out_w = int(x.shape[2] * scale), int(x.shape[3] * scale)
    ctx.set_out("Out", resize(x, out_h, out_w, method))


for _m in ("bilinear", "nearest", "bicubic"):
    op(_m + "_interp")(lambda ctx, m=_m: _interp(ctx, m))


@op("grid_sampler")
def _grid_sampler(ctx):
    """Bilinear or nearest sampling of an NCHW ``X`` at ``Grid``'s
    (N, Ho, Wo, 2) points in [-1, 1] (JAX :959), by ``F.grid_sample``:
    the same zeros / border / reflection padding and ``align_corners``
    mapping."""
    ctx.set_out("Output", F.grid_sample(
        ctx.in_("X"), ctx.in_("Grid"), mode=ctx.attr("mode", "bilinear"),
        padding_mode=ctx.attr("padding_mode", "zeros"),
        align_corners=bool(ctx.attr("align_corners", True))))


@op("temporal_shift")
def _temporal_shift(ctx):
    """A quarter (``shift_ratio``) of the channels from the next segment,
    the next quarter from the previous, zeros at the ends (JAX :1046)."""
    x = ctx.in_("X")
    seg = ctx.attr("seg_num", 1)
    ratio = ctx.attr("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    pre = F.pad(xr[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    post = F.pad(xr[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    ctx.set_out("Out", torch.cat([pre, post, xr[:, :, c2:]], dim=2)
                .reshape(nt, c, h, w))


@op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx):
    """Max pooling with the flat argmax of each window in the unpadded
    plane (JAX :239): the windows padded with the dtype's lowest finite
    value and stacked, the max over them (ties share the gradient, as
    JAX's reduce-max) and the first argmax in row-major window order."""
    x = ctx.in_("X")
    ksize = list(ctx.attr("ksize", [2, 2]))
    strides = list(ctx.attr("strides", ksize))
    pads = list(ctx.attr("paddings", [0, 0]))
    n, c, h, w = x.shape
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = [h, w], [h, w], [0, 0]
    elif ctx.attr("adaptive", False):
        oh_t, ow_t = ksize
        if (oh_t, ow_t) == (1, 1):
            ksize, strides, pads = [h, w], [h, w], [0, 0]
        elif h % oh_t == 0 and w % ow_t == 0:
            ksize = [h // oh_t, w // ow_t]
            strides, pads = list(ksize), [0, 0]
        else:
            raise NotImplementedError(
                f"max_pool2d_with_index adaptive output {ksize} does not "
                f"divide input plane ({h}, {w}), as in the JAX package "
                f"(ROADMAP.md)")
    xp = F.pad(x, (pads[1], pads[1], pads[0], pads[0]),
               value=torch.finfo(x.dtype).min)
    win = xp.unfold(2, ksize[0], strides[0]).unfold(3, ksize[1], strides[1])
    oh, ow = win.shape[2:4]
    win = win.reshape(n, c, oh, ow, ksize[0] * ksize[1])
    ctx.set_out("Out", win.amax(dim=-1))
    if ctx.has_output("Mask"):
        k_arg = win.argmax(dim=-1)
        hi = (torch.arange(oh, device=x.device)[:, None] * strides[0]
              + k_arg // ksize[1] - pads[0])
        wi = (torch.arange(ow, device=x.device)[None, :] * strides[1]
              + k_arg % ksize[1] - pads[1])
        ctx.set_out("Mask", (hi * w + wi).to(torch.int32))


# -- metrics (JAX nn_ops.py:873) ---------------------------------------------
@op("mean_iou", no_grad=True)
def _mean_iou(ctx):
    """The confusion matrix of (label, prediction) pairs as JAX's
    ``.at[label, pred].add(1.0)`` builds it: a negative index counts from
    the end, and a pair still outside [0, n) (an ignore label such as
    255) is dropped, here by sending it to a spare bin, so no index ever
    leaves the matrix on the card.  Then the per-class IoU over the
    classes that occur, in f32."""
    n = ctx.attr("num_classes", 2)
    pred = ctx.in_("Predictions").reshape(-1).long()
    label = ctx.in_("Labels").reshape(-1).long()
    pred = torch.where(pred < 0, pred + n, pred)
    label = torch.where(label < 0, label + n, label)
    inside = (pred >= 0) & (pred < n) & (label >= 0) & (label < n)
    cell = torch.where(inside, label * n + pred, torch.full_like(pred, n * n))
    cm = torch.zeros(n * n + 1, dtype=torch.float32, device=pred.device
                     ).index_add_(0, cell, torch.ones_like(
                         cell, dtype=torch.float32))[:n * n].reshape(n, n)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-9),
                      torch.zeros_like(union))
    valid = (union > 0).float().sum()
    ctx.set_out("OutMeanIou", iou.sum() / torch.clamp_min(valid, 1.0))
    ctx.set_out("OutWrong", cm.sum(1) - inter)
    ctx.set_out("OutCorrect", inter)


@op("cvm")
def _cvm(ctx):
    """Show / click columns log-transformed (``use_cvm``) or dropped (JAX
    :1062)."""
    x = ctx.in_("X")
    if ctx.attr("use_cvm", True):
        c0 = torch.log(x[:, :1] + 1.0)
        c1 = torch.log(x[:, 1:2] + 1.0) - c0
        ctx.set_out("Y", torch.cat([c0, c1, x[:, 2:]], dim=1))
    else:
        ctx.set_out("Y", x[:, 2:])


@grad_maker("cvm")
def _cvm_grad_maker(op_, no_grad_names=frozenset()):
    return [dict(type="cvm_grad",
                 inputs={"X": list(op_.inputs["X"]),
                         "Y" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                             for n in op_.outputs["Y"]]},
                 outputs={"X" + GRAD_SUFFIX: [
                     n + GRAD_SUFFIX if n not in no_grad_names
                     else EMPTY_VAR_NAME for n in op_.inputs["X"]]},
                 attrs=dict(op_.attrs))]


@op("cvm_grad", no_grad=True)
def _cvm_grad(ctx):
    """dY straight through, zero for the dropped columns (JAX :1089)."""
    x, dy = ctx.in_("X"), ctx.in_("Y" + GRAD_SUFFIX)
    if ctx.attr("use_cvm", True):
        ctx.set_out("X" + GRAD_SUFFIX, dy)
    else:
        ctx.set_out("X" + GRAD_SUFFIX, torch.cat(
            [torch.zeros((x.shape[0], 2), dtype=x.dtype, device=x.device),
             dy], dim=1))


# -- the simple losses (JAX nn_ops.py:584-686, :1035) -------------------------
@op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx):
    from .math_ops import jax_abs
    x, label = ctx.in_("X"), ctx.in_("Label")
    loss = (torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
            - x * label + torch.logaddexp(-jax_abs(x), torch.zeros_like(x)))
    mask = label != ctx.attr("ignore_index", -100)
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if ctx.attr("normalize", False):
        loss = loss / torch.clamp_min(mask.to(loss.dtype).sum(), 1.0)
    ctx.set_out("Out", loss)


@op("squared_l2_distance")
def _squared_l2_distance(ctx):
    d = ctx.in_("X") - ctx.in_("Y")
    ctx.set_out("sub_result", d)
    ctx.set_out("Out", torch.sum(torch.square(d), dim=-1, keepdim=True))


@op("smooth_l1_loss")
def _smooth_l1(ctx):
    from .math_ops import jax_abs
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = ctx.in_("X") - ctx.in_("Y")
    if ctx.has_input("InsideWeight"):
        d = d * ctx.in_("InsideWeight")
    ad = jax_abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * ctx.in_("OutsideWeight")
    ctx.set_out("Diff", d)
    ctx.set_out("Out", torch.sum(loss, dim=tuple(range(1, loss.dim())))
                .reshape(-1, 1))


@op("huber_loss")
def _huber(ctx):
    from .math_ops import jax_abs
    delta = ctx.attr("delta", 1.0)
    r = ctx.in_("Y") - ctx.in_("X")
    ar = jax_abs(r)
    ctx.set_out("Residual", r)
    ctx.set_out("Out", torch.where(ar <= delta, 0.5 * r * r,
                                   delta * (ar - 0.5 * delta)))


@op("mse_loss")
def _mse(ctx):
    ctx.set_out("Out", torch.square(ctx.in_("X") - ctx.in_("Y")))


@op("kldiv_loss")
def _kldiv(ctx):
    x, t = ctx.in_("X"), ctx.in_("Target")
    loss = t * (torch.log(torch.clamp_min(t, 1e-20)) - x)
    loss = torch.where(t > 0, loss, torch.zeros_like(loss))
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    ctx.set_out("Loss", loss)


@op("bce_loss")
def _bce(ctx):
    x, label = ctx.in_("X"), ctx.in_("Label")
    ctx.set_out("Out", -(label * torch.log(torch.clamp_min(x, 1e-12))
                         + (1 - label) * torch.log(torch.clamp_min(1 - x,
                                                                   1e-12))))


@op("rank_loss")
def _rank_loss(ctx):
    d = ctx.in_("Left") - ctx.in_("Right")
    ctx.set_out("Out", torch.logaddexp(d, torch.zeros_like(d))
                - ctx.in_("Label") * d)


@op("log_loss")
def _log_loss(ctx):
    p, label = ctx.in_("Predicted"), ctx.in_("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_out("Loss", -label * torch.log(p + eps)
                - (1 - label) * torch.log(1 - p + eps))


@op("hinge_loss")
def _hinge_loss(ctx):
    logits, labels = ctx.in_("Logits"), ctx.in_("Labels")
    ctx.set_out("Loss", torch.relu(1.0 - (2.0 * labels - 1.0) * logits))


@op("label_smooth")
def _label_smooth(ctx):
    x = ctx.in_("X")
    eps = ctx.attr("epsilon", 0.0)
    if ctx.has_input("PriorDist"):
        ctx.set_out("Out", (1 - eps) * x + eps * ctx.in_("PriorDist"))
    else:
        ctx.set_out("Out", (1 - eps) * x + eps / x.shape[-1])
