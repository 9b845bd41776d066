"""``fused_multihead_attention``: counterpart of the JAX package's op
(``paddle_tpu/ops/fused_ops.py:26-135``).

q, k, v are ``(batch, heads, seq, head_dim)``.  A padding bias
(``(b, kv)``, ``(b, 1, kv)``, ``(b, 1, 1, kv)``) or no bias takes
:func:`~.flash_attention.flash_attention`: the hand-written kernels on the
card, their plain versions on the CPU, the padding bias a constant.  A
full-matrix bias (``(b, 1, q, kv)`` / ``(b, h, q, kv)``) takes the dense
:func:`~.flash_attention.attention_reference` under autograd, outside
any kernel, as in JAX (:30-35).

With ``dropout_rate > 0`` a per-call seed is drawn from the caller's
``torch.Generator`` (in ``[0, 2**23)``, as JAX draws it, :60-69) and is
saved by the autograd function, so the backward regenerates the mask.

The static path's fused BN ops follow (``fused_ops.py:152-254`` and
:442-567): ``fused_batch_norm_act`` and ``fused_bn_add_activation`` with
their closed-form grads (plain PyTorch, as the JAX package leaves them
to XLA), and ``fused_conv_bn_act`` with its grad, the ops that
``fuse_epilogue_pass`` (``framework/ir.py``) builds from conv -> BN
(-> add) -> relu chains.  Their epilogues run in the hand-written
kernels of :mod:`.bn_act` on the card: ``bn_act_apply`` forward,
``bn_act_bwd_apply`` backward.  The convolution itself is the
``conv2d`` op's (``nn_ops.conv_forward`` / ``conv_backward``), so fusion
changes where the epilogue runs, not the conv.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX
from ..framework.random import default_generator
from . import bn_act
from .flash_attention import (attention_reference, flash_attention,
                              is_padding_bias)
from .nn_ops import (bn_backward, bn_fold, bn_forward_stats, bn_is_test,
                     bn_shapes, conv_attrs, conv_backward, conv_forward)
from .registry import grad_maker, op

__all__ = ["fused_multihead_attention"]


def _draw_seed(generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """One int64 dropout seed in ``[0, 2**23)`` from ``generator``, as a
    one-element tensor on ``device`` (no host sync on the card)."""
    seed = torch.randint(0, 1 << 23, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    return seed.to(device)


def fused_multihead_attention(q, k, v, bias_qk=None, scale=0.0,
                              causal=False, dropout_rate=0.0,
                              generator: Optional[torch.Generator] = None):
    """softmax(q k^T * scale + bias_qk [, causal]) [dropped] @ v.
    ``scale`` 0 means ``1 / sqrt(head_dim)``; the dropout seed comes from
    ``generator`` (default: q's device's default generator)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    seed = None
    if dropout_rate > 0.0:
        seed = _draw_seed(generator if generator is not None
                          else default_generator(q.device), q.device)
    if bias_qk is not None and not is_padding_bias(bias_qk):
        return attention_reference(q, k, v, bias_qk, causal, scale,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=seed)
    return flash_attention(q, k, v, bias=bias_qk, causal=causal, scale=scale,
                           dropout_rate=dropout_rate, dropout_seed=seed)


# ==========================================================================
# fused BN (+ add) + activation, and fused conv + BN (+ add) + activation
# ==========================================================================
def _fused_bn_act_fwd(ctx, with_add):
    x = ctx.in_("X")
    z = ctx.in_("Z") if (with_add and ctx.has_input("Z")) else None
    act = ctx.attr("act_type", "relu")
    if act not in ("relu", ""):
        raise NotImplementedError(f"fused bn act_type={act!r}")
    mean, inv, bshape, _ = bn_forward_stats(
        ctx, x, ctx.attr("data_layout", "NCHW"))
    a, b = bn_fold(x, ctx.in_("Scale"), ctx.in_("Bias"), mean, inv)
    y = x * a.reshape(bshape) + b.reshape(bshape)
    if z is not None:
        y = y + z
    ctx.set_out("Y", bn_act.apply_act(y, act))


@op("fused_batch_norm_act")
def _fused_bn_act(ctx):
    _fused_bn_act_fwd(ctx, with_add=False)


@op("fused_bn_add_activation")
def _fused_bn_add_act(ctx):
    _fused_bn_act_fwd(ctx, with_add=True)


def _fused_bn_act_bwd(ctx, with_add):
    x, y = ctx.in_("X"), ctx.in_("Y")
    g = bn_act.act_mask_grad(y, ctx.in_("Y" + GRAD_SUFFIX),
                             ctx.attr("act_type", "relu"))
    if with_add:
        ctx.set_out("Z" + GRAD_SUFFIX, g)
    dx, dscale, dbias = bn_backward(
        x, g, ctx.in_("Scale"), ctx.in_("SavedMean"),
        ctx.in_("SavedVariance"), ctx.attr("data_layout", "NCHW"),
        bn_is_test(ctx))
    ctx.set_out("Scale" + GRAD_SUFFIX, dscale)
    ctx.set_out("Bias" + GRAD_SUFFIX, dbias)
    if ctx.has_output("X" + GRAD_SUFFIX):
        ctx.set_out("X" + GRAD_SUFFIX, dx)


@op("fused_batch_norm_act_grad", no_grad=True)
def _fused_bn_act_grad(ctx):
    _fused_bn_act_bwd(ctx, with_add=False)


@op("fused_bn_add_activation_grad", no_grad=True)
def _fused_bn_add_act_grad(ctx):
    _fused_bn_act_bwd(ctx, with_add=True)


def _grad_names(names, no_grad_names):
    return [(n + GRAD_SUFFIX) if n not in no_grad_names else EMPTY_VAR_NAME
            for n in names]


def _make_fused_bn_grad_desc(op_, no_grad_names, with_add):
    inputs = {
        "X": op_.input("X"),
        "Y": op_.output("Y"),
        "Scale": op_.input("Scale"),
        "SavedMean": op_.output("SavedMean"),
        "SavedVariance": op_.output("SavedVariance"),
        "Y" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in op_.output("Y")],
    }
    outputs = {
        "X" + GRAD_SUFFIX: _grad_names(op_.input("X"), no_grad_names),
        "Scale" + GRAD_SUFFIX: _grad_names(op_.input("Scale"), no_grad_names),
        "Bias" + GRAD_SUFFIX: _grad_names(op_.input("Bias"), no_grad_names),
    }
    if with_add and op_.input("Z"):
        outputs["Z" + GRAD_SUFFIX] = _grad_names(op_.input("Z"),
                                                 no_grad_names)
    return [dict(type=op_.type + "_grad", inputs=inputs, outputs=outputs,
                 attrs=dict(op_.attrs))]


@grad_maker("fused_batch_norm_act")
def _fused_bn_act_maker(op_, no_grad_names=frozenset()):
    return _make_fused_bn_grad_desc(op_, no_grad_names, with_add=False)


@grad_maker("fused_bn_add_activation")
def _fused_bn_add_act_maker(op_, no_grad_names=frozenset()):
    return _make_fused_bn_grad_desc(op_, no_grad_names, with_add=True)


@grad_maker("fused_conv_bn_act")
def _fused_conv_bn_act_maker(op_, no_grad_names=frozenset()):
    inputs = {
        "Input": op_.input("Input"),
        "Filter": op_.input("Filter"),
        "Scale": op_.input("Scale"),
        "ConvOut": op_.output("ConvOut"),
        "Output": op_.output("Output"),
        "SavedMean": op_.output("SavedMean"),
        "SavedVariance": op_.output("SavedVariance"),
        "Output" + GRAD_SUFFIX: [n + GRAD_SUFFIX
                                 for n in op_.output("Output")],
    }
    outputs = {
        "Input" + GRAD_SUFFIX: _grad_names(op_.input("Input"), no_grad_names),
        "Filter" + GRAD_SUFFIX: _grad_names(op_.input("Filter"),
                                            no_grad_names),
        "Scale" + GRAD_SUFFIX: _grad_names(op_.input("Scale"), no_grad_names),
        "Bias" + GRAD_SUFFIX: _grad_names(op_.input("Bias"), no_grad_names),
    }
    if op_.input("Z"):
        outputs["Z" + GRAD_SUFFIX] = _grad_names(op_.input("Z"),
                                                 no_grad_names)
    return [dict(type="fused_conv_bn_act_grad", inputs=inputs,
                 outputs=outputs, attrs=dict(op_.attrs))]


@op("fused_conv_bn_act")
def _fused_conv_bn_act(ctx):
    """Inputs: Input/Filter (the conv), Scale/Bias/Mean/Variance (the
    BN), optional Z (residual add between BN and act).  Outputs: Output
    (post-activation), ConvOut (the BN's X, kept for the backward),
    MeanOut/VarianceOut/SavedMean/SavedVariance exactly as batch_norm.
    ``data_format`` governs conv and BN alike.  The epilogue is kernel 7
    (:func:`.bn_act.bn_act_apply`)."""
    cattrs = conv_attrs(ctx)
    conv_out = conv_forward(ctx.in_("Input"), ctx.in_("Filter"), **cattrs)
    ctx.set_out("ConvOut", conv_out)
    mean, inv, _, c_axis = bn_forward_stats(ctx, conv_out,
                                            cattrs["data_format"])
    a, b = bn_fold(conv_out, ctx.in_("Scale"), ctx.in_("Bias"), mean, inv)
    z = ctx.in_("Z") if ctx.has_input("Z") else None
    ctx.set_out("Output", bn_act.bn_act_apply(
        conv_out, a, b, z=z, act=ctx.attr("act_type", "relu"),
        c_axis=c_axis))


@op("fused_conv_bn_act_grad", no_grad=True)
def _fused_conv_bn_act_grad(ctx):
    """act' -> BN backward -> conv backward.  The BN reductions are plain
    f32 sums; the activation mask and the dX affine run as one pass in
    kernel 8 (:func:`.bn_act.bn_act_bwd_apply`), which also writes the
    residual's gradient when the chain has a Z; dInput/dFilter come from
    the same convolution backward as ``conv2d_grad``."""
    cattrs = conv_attrs(ctx)
    conv_out, y = ctx.in_("ConvOut"), ctx.in_("Output")
    dy = ctx.in_("Output" + GRAD_SUFFIX)
    scale = ctx.in_("Scale")
    mean, inv = ctx.in_("SavedMean"), ctx.in_("SavedVariance")
    act = ctx.attr("act_type", "relu")
    c_axis, red_axes, bshape, n = bn_shapes(conv_out, cattrs["data_format"])
    want_g = ctx.has_output("Z" + GRAD_SUFFIX)

    g = bn_act.act_mask_grad(y, dy, act)
    xs = conv_out.float() - mean.reshape(bshape)
    gf = g.float()
    sg = gf.sum(dim=red_axes)
    sgx = (gf * xs).sum(dim=red_axes) * inv
    del xs, gf
    ctx.set_out("Scale" + GRAD_SUFFIX, sgx.to(scale.dtype))
    ctx.set_out("Bias" + GRAD_SUFFIX, sg.to(scale.dtype))
    a = scale * inv
    cg = a.to(g.dtype)
    if bn_is_test(ctx):
        # frozen BN: the batch-statistic terms vanish
        dconv = g * cg.reshape(bshape)
        if want_g:
            ctx.set_out("Z" + GRAD_SUFFIX, g)
    else:
        del g
        cx = (-a * inv * sgx / n).to(conv_out.dtype)
        c0 = (-a * sg / n).float()
        dconv, g_k = bn_act.bn_act_bwd_apply(
            y, dy, conv_out, cg, mean.to(conv_out.dtype), cx, c0, act=act,
            c_axis=c_axis, want_g=want_g)
        if want_g:
            ctx.set_out("Z" + GRAD_SUFFIX, g_k)
    need_x = ctx.has_output("Input" + GRAD_SUFFIX)
    need_w = ctx.has_output("Filter" + GRAD_SUFFIX)
    if need_x or need_w:
        dxi, dwf = conv_backward(ctx.in_("Input"), ctx.in_("Filter"),
                                 dconv.to(conv_out.dtype),
                                 need_input=need_x, need_filter=need_w,
                                 **cattrs)
        if need_x:
            ctx.set_out("Input" + GRAD_SUFFIX, dxi)
        if need_w:
            ctx.set_out("Filter" + GRAD_SUFFIX, dwf)
