"""``fused_multihead_attention``: counterpart of the JAX package's op
(``paddle_tpu/ops/fused_ops.py:26-135``, its grad maker :379-409), as a
function of tensors (dygraph BERT) and as the static op with its grad.

q, k, v are ``(batch, heads, seq, head_dim)``.  A padding bias
(``(b, kv)``, ``(b, 1, kv)``, ``(b, 1, 1, kv)``) or no bias takes the
flash path (``ops/flash_attention.py``): the hand-written kernels 1-5 on
the card, their plain versions on the CPU, the padding bias a constant
(zero gradient).  A full-matrix bias (``(b, 1, q, kv)`` /
``(b, h, q, kv)``) takes the dense
:func:`~.flash_attention.attention_reference` under autograd, outside
any kernel, with a bias gradient, as JAX's ``attention_reference``
branch does (:30-35).

With ``dropout_rate > 0`` a per-call seed is drawn from the caller's
``torch.Generator`` (in ``[0, 2**23)``, as JAX draws it, :60-69).  The
dygraph function's autograd saves it; the static op stores it as its
``Seed`` output, a float32 ``(1,)`` tensor holding the integer as JAX's
does, which the grad op reads and converts to the kernels' int64 on the
device (no host sync, so a captured step stays capturable), so the
backward regenerates the forward's mask.

The static op saves ``Lse``, the flash forward's (b, h, sq) float32
log-sum-exp, and its grad runs the backward kernels from it with no
forward replay.  JAX's ``Lse`` is the TPU kernel's lane-broadcast (b, h,
sq, 128) layout, or a ``(1,)`` zero sentinel where its kernel does not
engage (every CPU run); the port's rule: an ``Lse`` input of three dims
is a saved lse, anything else (the dense path's ``(1,)`` sentinel, or no
``Lse`` at all, as on the op ``fuse_multihead_attention_pass`` builds)
makes the grad run the forward (kernel 1-2 on the card) for lse, then
the backward kernel.

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

Last, the fc epilogue (``fused_ops.py:356-376`` and :577-651):
``fused_matmul_bias_act`` and its grad, the ops ``fuse_epilogue_pass``
builds from mul / matmul -> bias add -> act chains.  The forward with a
1-D bias on the trailing axis runs kernel 9
(:func:`.matmul_epilogue.matmul_bias_act`) on the flattened 2-D
operands; any other bias takes the plain composition of the unfused ops
(``_matmul_bias_act_jnp``), as in JAX.  The grad replays the
pre-activation ``x @ w + b`` (kernel 9 with no act on the card, so the
act's derivative sees the bits the forward's epilogue saw), then applies
the unfused act grad (``threshold_backward``, ``sigmoid_backward``, ...,
the derivatives autograd's replay of the act op takes), and leaves dX,
dW and dBias to plain products and a sum, as JAX leaves them to XLA.
On the CPU every term is the unfused chain's, so fusion changes no bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX
from ..framework.random import default_generator
from . import bn_act
from .matmul_epilogue import matmul_bias_act
from .flash_attention import (attention_backward, attention_forward,
                              attention_reference, flash_attention,
                              is_padding_bias, normalize_bias)
from .nn_ops import (amp_cast, bn_backward, bn_fold, bn_forward_stats,
                     bn_is_test, bn_shapes, conv_attrs, conv_backward,
                     conv_forward)
from .math_ops import align
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
    ``generator`` (default: q's device's default generator).  Under AMP
    it is a white-list op: q, k, v and the bias are cast to bf16."""
    q, k, v, bias_qk = amp_cast("fused_multihead_attention", q, k, v,
                                bias_qk)
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
# the static fused_multihead_attention op and its grad
# ==========================================================================
def _mha_attrs(ctx, q):
    """(bias or None, scale, causal, dropout_rate) of the op on ``q``."""
    bias = ctx.in_("BiasQK") if ctx.has_input("BiasQK") else None
    scale = float(ctx.attr("scale", 0.0) or 0.0) or 1.0 / math.sqrt(
        q.shape[-1])
    return (bias, scale, bool(ctx.attr("causal", False)),
            float(ctx.attr("dropout_rate", 0.0) or 0.0))


def _flash_bias(bias):
    """A padding bias as the flash path takes it: (b, kv) f32,
    contiguous."""
    if bias is None:
        return None
    return normalize_bias(bias).float().contiguous()


def _mha_out_lse(q, k, v, bias, scale, causal, rate, seed):
    """The flash forward ``(out, lse)``: kernels 1-2 on the card, the
    plain version on the CPU, empty tensors of the right shapes under
    shape inference."""
    if q.device.type == "meta":
        return (torch.empty_like(q),
                torch.empty(tuple(q.shape[:3]), dtype=torch.float32,
                            device=q.device))
    return attention_forward(q, k, v, _flash_bias(bias), scale, causal, rate,
                             seed)


@op("fused_multihead_attention")
def _fused_mha_op(ctx):
    """Out (and Lse, Seed) of the static op; see the module docstring."""
    q, k, v = ctx.in_("Q"), ctx.in_("K"), ctx.in_("V")
    bias, scale, causal, rate = _mha_attrs(ctx, q)
    seed = None
    if rate > 0.0:
        gen = ctx.rng()
        seed = (torch.zeros((1,), dtype=torch.int64, device=q.device)
                if q.device.type == "meta" else
                _draw_seed(gen if gen is not None
                           else default_generator(q.device), q.device))
        ctx.set_out("Seed", seed.to(torch.float32))
    if bias is not None and not is_padding_bias(bias):
        if ctx.has_output("Lse"):
            ctx.set_out("Lse", torch.zeros((1,), dtype=torch.float32,
                                           device=q.device))
        ctx.set_out("Out", attention_reference(
            q, k, v, bias, causal, scale, dropout_rate=rate,
            dropout_seed=seed))
        return
    out, lse = _mha_out_lse(q, k, v, bias, scale, causal, rate, seed)
    ctx.set_out("Out", out)
    if ctx.has_output("Lse"):
        ctx.set_out("Lse", lse)


@op("fused_multihead_attention_grad", no_grad=True)
def _fused_mha_grad_op(ctx):
    """dQ, dK, dV (and dBiasQK): from the saved lse when ``Lse`` has
    three dims, else after a forward for lse (kernels 3 or 4-5 on the
    card, the padding bias's gradient zeros); a full-matrix bias's
    gradients by autograd through the dense path."""
    q, k, v = ctx.in_("Q"), ctx.in_("K"), ctx.in_("V")
    bias, scale, causal, rate = _mha_attrs(ctx, q)
    seed = (ctx.in_("Seed").to(torch.int64) if ctx.has_input("Seed")
            else None)
    dout = ctx.in_("Out" + GRAD_SUFFIX).to(q.dtype)
    slots = ("Q", "K", "V")
    if bias is not None and not is_padding_bias(bias):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
        with torch.enable_grad():
            out = attention_reference(*leaves, causal, scale,
                                      dropout_rate=rate, dropout_seed=seed)
            grads = torch.autograd.grad(out, leaves, dout.to(out.dtype))
        for slot, g in zip(slots + ("BiasQK",), grads):
            ctx.set_out(slot + GRAD_SUFFIX, g)
        return
    lse = ctx.in_("Lse") if ctx.has_input("Lse") else None
    out = ctx.in_("Out") if ctx.has_input("Out") else None
    if lse is None or lse.dim() != 3 or out is None:
        out, lse = _mha_out_lse(q, k, v, bias, scale, causal, rate, seed)
    grads = attention_backward(q, k, v, _flash_bias(bias), out, lse, dout,
                               scale, causal, rate, seed)
    for slot, g in zip(slots, grads):
        ctx.set_out(slot + GRAD_SUFFIX, g)
    if bias is not None and ctx.has_output("BiasQK" + GRAD_SUFFIX):
        ctx.set_out("BiasQK" + GRAD_SUFFIX, torch.zeros_like(bias))


@grad_maker("fused_multihead_attention")
def _fused_mha_grad_maker(op_, no_grad_names=frozenset()):
    """JAX's grad desc (:379-409): the forward's Seed, and Lse with Out
    when saved, feed the grad op."""
    inputs = {
        "Q": op_.input("Q"), "K": op_.input("K"), "V": op_.input("V"),
        "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in op_.output("Out")],
    }
    if op_.input("BiasQK"):
        inputs["BiasQK"] = op_.input("BiasQK")
    if op_.output("Seed"):
        inputs["Seed"] = op_.output("Seed")
    if op_.output("Lse"):
        inputs["Lse"] = op_.output("Lse")
        inputs["Out"] = op_.output("Out")
    outputs = {s + GRAD_SUFFIX: _grad_names(op_.input(s), no_grad_names)
               for s in ("Q", "K", "V")}
    if op_.input("BiasQK"):
        outputs["BiasQK" + GRAD_SUFFIX] = _grad_names(op_.input("BiasQK"),
                                                      no_grad_names)
    return [dict(type="fused_multihead_attention_grad", inputs=inputs,
                 outputs=outputs, attrs=dict(op_.attrs))]


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


# ==========================================================================
# fused matmul + bias + activation (the fc epilogue)
# ==========================================================================
@grad_maker("fused_matmul_bias_act")
def _fused_matmul_bias_act_maker(op_, no_grad_names=frozenset()):
    inputs = {
        "X": op_.input("X"),
        "Y": op_.input("Y"),
        "Bias": op_.input("Bias"),
        "Out" + GRAD_SUFFIX: [n + GRAD_SUFFIX for n in op_.output("Out")],
    }
    outputs = {
        "X" + GRAD_SUFFIX: _grad_names(op_.input("X"), no_grad_names),
        "Y" + GRAD_SUFFIX: _grad_names(op_.input("Y"), no_grad_names),
        "Bias" + GRAD_SUFFIX: _grad_names(op_.input("Bias"), no_grad_names),
    }
    return [dict(type="fused_matmul_bias_act_grad", inputs=inputs,
                 outputs=outputs, attrs=dict(op_.attrs))]


def _mm_attrs(ctx):
    """(act, x_num_col_dims, axis, trailing): ``trailing`` when the bias
    is 1-D on the product's last axis, the layout of kernel 9's
    epilogue."""
    xnc, axis = ctx.attr("x_num_col_dims", 1), ctx.attr("axis", -1)
    trailing = ((axis is None or axis < 0 or axis == xnc)
                and ctx.in_("Bias").dim() == 1)
    return ctx.attr("act_type", ""), xnc, axis, trailing


def _pre_act(x, w, bias, xnc, axis, trailing, act=""):
    """(x2, act(x @ w + bias)): the flattened X and the product with its
    bias (and ``act``), as the unfused mul, elementwise_add and act ops
    compute it.  ``trailing``: kernel 9 on the card, 2-D result; else the
    paddle-axis broadcast, shape ``x.shape[:xnc] + (N,)``."""
    x2 = x.reshape(math.prod(x.shape[:xnc]), -1)
    if trailing:
        return x2, matmul_bias_act(x2.contiguous(), w.contiguous(), bias,
                                   act)
    out = torch.matmul(x2, w).reshape(tuple(x.shape[:xnc]) + (w.shape[-1],))
    out, b = align(out, bias, axis)
    return x2, bn_act.apply_act(out + b, act)


@op("fused_matmul_bias_act")
def _fused_matmul_bias_act(ctx):
    """``act(X @ Y + Bias)`` with X flattened to ``(prod(shape[:xnc]),
    -1)``; the epilogue is kernel 9 for a trailing 1-D bias."""
    x, w = ctx.in_("X"), ctx.in_("Y")
    act, xnc, axis, trailing = _mm_attrs(ctx)
    _, out = _pre_act(x, w, ctx.in_("Bias"), xnc, axis, trailing, act)
    ctx.set_out("Out", out.reshape(tuple(x.shape[:xnc]) + (w.shape[-1],)))


def _act_backward(pre, dy, act):
    """``act'(pre) * dy`` as autograd's replay of the unfused act op
    computes it (derivatives of relu, sigmoid, tanh and exact gelu)."""
    aten = torch.ops.aten
    if not act:
        return dy
    if act == "relu":
        return aten.threshold_backward(dy, pre, 0)
    if act == "sigmoid":
        return aten.sigmoid_backward(dy, torch.sigmoid(pre))
    if act == "tanh":
        return aten.tanh_backward(dy, torch.tanh(pre))
    if act == "gelu":
        return aten.gelu_backward(dy, pre)
    raise NotImplementedError(f"fused matmul epilogue act {act!r}")


@op("fused_matmul_bias_act_grad", no_grad=True)
def _fused_matmul_bias_act_grad(ctx):
    """Replay of the pre-activation, the act's derivative, then dX = g
    W^T and dW = X^T g on the flattened views (g in the product's dtype)
    and dBias = the sum of g over every axis but the bias's (in g's)."""
    x, w, bias = ctx.in_("X"), ctx.in_("Y"), ctx.in_("Bias")
    act, xnc, axis, trailing = _mm_attrs(ctx)
    x2, pre = _pre_act(x, w, bias, xnc, axis, trailing)
    dy = ctx.in_("Out" + GRAD_SUFFIX).to(pre.dtype).reshape(pre.shape)
    g = _act_backward(pre, dy, act)
    if ctx.has_output("Bias" + GRAD_SUFFIX):
        ax = pre.dim() - 1 if trailing or axis is None or axis < 0 else axis
        red = [d for d in range(pre.dim()) if d != ax]
        ctx.set_out("Bias" + GRAD_SUFFIX,
                    g.sum(dim=red, keepdim=True).reshape(bias.shape))
    # the product's cotangent in the product's dtype: under AMP the f32
    # g of the bias add comes back to the bf16 ``mul`` output, as the
    # unfused elementwise_add_grad hands it to mul_grad
    g2 = g.reshape(x2.shape[0], w.shape[1]).to(
        torch.promote_types(x2.dtype, w.dtype))
    if ctx.has_output("X" + GRAD_SUFFIX):
        ctx.set_out("X" + GRAD_SUFFIX, (g2 @ w.t()).reshape(x.shape))
    if ctx.has_output("Y" + GRAD_SUFFIX):
        ctx.set_out("Y" + GRAD_SUFFIX, x2.t() @ g2)
