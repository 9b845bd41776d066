"""The recurrent and sequence op lowerings of the static path
(counterpart of ``paddle_tpu/ops/sequence_ops.py``), on the padded
representation: a ragged batch is a dense ``[N, T, ...]`` tensor and an
int ``Length`` ``[N]`` (a missing ``Length`` means full length,
``_get_len`` :32-46).

* ``sequence_mask`` :48, ``sequence_pool`` :76 (``SUM``, ``AVERAGE``,
  ``SQRT``, ``MAX``, ``LAST``, ``FIRST``), ``sequence_softmax`` :122,
  ``sequence_reverse`` :141 (each row's valid prefix reversed, the
  padding kept in place) and ``sequence_conv`` :159 (a context window
  along time over the masked batch, then one product);
* the recurrences ``lstm`` :432, ``gru`` :475, ``dynamic_lstm`` :507 and
  ``dynamic_gru`` :558, and the single steps ``lstm_unit`` :578 and
  ``gru_unit`` :595.  A recurrence is a Python loop over T with one
  ``addmm`` a step (JAX's ``lax.scan``, which is no Pallas kernel), with
  JAX's masking: a row's state freezes past its length and its padded
  outputs are 0.  Gate order ``i, f, g, o``; ``dynamic_lstm``'s
  peepholes are ignored, as in JAX (:511).  A reversed recurrence
  reindexes each row by its own length (:524-529), not by T;
* beam search: ``beam_search`` :618 (one step of expansion over the flat
  ``[N*B, V]`` log-probs: the top ``B`` of each source's ``B*V``
  continuations in XLA's ``top_k`` order, a finished beam going on with
  ``end_id`` at an unchanged score and every other token at
  ``finfo.min``), ``beam_search_decode`` :649 (the backtrack, on the
  host), ``gather_tree`` :803 and ``beam_gather_states`` :906.

Grads: the generic vjp replay of the registry, except ``dynamic_lstm``,
``gru_unit`` and ``sequence_conv``, which have explicit grad lowerings:
the replay would run ``dynamic_lstm``'s T-step loop a second time before
its backward, and the other two a forward's products again.  The
explicit ones take the forward's saved outputs (``Hidden`` / ``Cell``,
``Gate`` / ``ResetHiddenPrev``) and compute in closed form.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX
from ..framework.dtype import convert_dtype, to_torch_dtype
from .math_ops import xla_top_k
from .registry import op

__all__ = []


def _length_mask(length, T, dtype=torch.float32):
    """``[N]`` lengths -> ``[N, T]`` mask."""
    t = torch.arange(T, device=length.device)
    return (t[None, :] < length.reshape(-1)[:, None]).to(dtype)


def _get_len(ctx, x, slot="Length"):
    """The ``Length`` input (flattened), or every row at full length."""
    if ctx.has_input(slot):
        return ctx.in_(slot).reshape(-1)
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def _rev_index(length, T):
    """``[N, T]`` time index that reverses each row's valid prefix and
    keeps its padding in place (its own inverse)."""
    t = torch.arange(T, device=length.device)[None, :]
    L = length.reshape(-1)[:, None].to(torch.int64)
    return torch.where(t < L, L - 1 - t, t)


def _take_time(x, idx):
    """``x[n, idx[n, t]]`` over the time axis 1."""
    return torch.take_along_dim(
        x, idx.reshape(idx.shape + (1,) * (x.dim() - 2)), dim=1)


def _bshape(v, x):
    """``v`` ``[N]`` reshaped to broadcast over ``x``'s trailing axes."""
    return v.reshape((x.shape[0],) + (1,) * (x.dim() - 2))


def _neg(dtype):
    return torch.finfo(dtype).min


# --------------------------------------------------------------------------
# sequence_mask, sequence_pool, sequence_softmax, sequence_reverse
# --------------------------------------------------------------------------
@op("sequence_mask", no_grad=True)
def _sequence_mask(ctx):
    """``Y[n, t] = t < X[n]`` over ``maxlen`` columns (the attr, a
    ``MaxLenTensor`` or, when neither, ``max(X)``: both read on the
    host, as JAX reads them at trace time)."""
    x = ctx.in_("X").reshape(-1)
    maxlen = ctx.attr("maxlen", -1)
    if ctx.has_input("MaxLenTensor"):
        maxlen = int(ctx.in_("MaxLenTensor").reshape(-1)[0])
    if maxlen is None or maxlen < 0:
        maxlen = int(x.max())
    dt = ctx.attr("out_dtype", "int64") or "int64"
    try:
        out_dt = to_torch_dtype(convert_dtype(dt))
    except (ValueError, TypeError, KeyError):
        out_dt = torch.int64
    t = torch.arange(maxlen, device=x.device)
    ctx.set_out("Y", (t[None, :] < x[:, None]).to(out_dt))


@op("sequence_pool")
def _sequence_pool(ctx):
    """A masked reduction over time; an empty row gives ``pad_value``."""
    x = ctx.in_("X")
    length = _get_len(ctx, x)
    ptype = (ctx.attr("pooltype", "SUM") or "SUM").upper()
    pad_value = ctx.attr("pad_value", 0.0) or 0.0
    N, T = x.shape[0], x.shape[1]
    m = _length_mask(length, T, x.dtype).reshape(
        (N, T) + (1,) * (x.dim() - 2))
    empty = _bshape(length == 0, x)
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype in ("AVERAGE", "SQRT"):
        denom = torch.clamp(length.to(x.dtype), min=1)
        if ptype == "SQRT":
            denom = torch.sqrt(denom)
        out = (x * m).sum(1) / _bshape(denom, x)
    elif ptype == "MAX":
        xm = torch.where(m > 0, x, torch.full((), _neg(x.dtype),
                                              dtype=x.dtype,
                                              device=x.device))
        out = torch.amax(xm, 1)
        if ctx.has_output("MaxIndex"):
            ctx.set_out("MaxIndex", torch.argmax(xm, 1).to(torch.int32))
    elif ptype == "LAST":
        idx = torch.clamp(length.to(torch.int64) - 1, min=0)
        out = _take_time(x, idx[:, None]).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    out = torch.where(empty, torch.full((), float(pad_value), dtype=x.dtype,
                                        device=x.device), out)
    ctx.set_out("Out", out)


@op("sequence_softmax")
def _sequence_softmax(ctx):
    """A softmax within each row's valid prefix, padding 0."""
    x = ctx.in_("X")
    length = _get_len(ctx, x)
    mask = _length_mask(length, x.shape[1], torch.bool)
    xm = torch.where(mask, x, torch.full((), _neg(x.dtype), dtype=x.dtype,
                                         device=x.device))
    e = torch.exp(xm - torch.amax(xm, 1, keepdim=True))
    e = torch.where(mask, e, torch.zeros((), dtype=e.dtype, device=e.device))
    ctx.set_out("Out", e / torch.clamp(e.sum(1, keepdim=True), min=1e-30))


@op("sequence_reverse")
def _sequence_reverse(ctx):
    x = ctx.in_("X")
    ctx.set_out("Y", _take_time(x, _rev_index(_get_len(ctx, x),
                                               x.shape[1])))


# --------------------------------------------------------------------------
# sequence_conv
# --------------------------------------------------------------------------
def _seq_conv_parts(ctx):
    x, w = ctx.in_("X"), ctx.in_("Filter")
    length = _get_len(ctx, x)
    c_len = int(ctx.attr("contextLength", 3))
    c_start = int(ctx.attr("contextStart", -((c_len - 1) // 2)))
    mask = _length_mask(length, x.shape[1], x.dtype)[:, :, None]
    return x, w, mask, c_len, c_start


def _window_valid(T, off, device):
    t = torch.arange(T, device=device)
    return (((t + off) >= 0) & ((t + off) < T))[None, :, None]


def _seq_conv_im(xm, c_len, c_start):
    """The context windows ``[N, T, c_len * D]``: column block k holds
    ``xm[n, t + c_start + k]``, 0 outside the row."""
    T = xm.shape[1]
    zero = torch.zeros((), dtype=xm.dtype, device=xm.device)
    cols = []
    for k in range(c_len):
        off = c_start + k
        cols.append(torch.where(_window_valid(T, off, xm.device),
                                torch.roll(xm, -off, 1), zero))
    return torch.cat(cols, -1)


@op("sequence_conv")
def _sequence_conv(ctx):
    x, w, mask, c_len, c_start = _seq_conv_parts(ctx)
    im = _seq_conv_im(x * mask, c_len, c_start)
    ctx.set_out("Out", torch.matmul(im, w) * mask)


@op("sequence_conv_grad", no_grad=True)
def _sequence_conv_grad(ctx):
    """``dIm = (dOut * mask) @ W^T``, ``dW = Im^T @ (dOut * mask)``, and
    each column block of dIm rolled back onto dX under the mask."""
    x, w, mask, c_len, c_start = _seq_conv_parts(ctx)
    N, T, D = x.shape
    dout = ctx.in_("Out" + GRAD_SUFFIX)
    if dout is None:
        dout = torch.zeros(N, T, w.shape[1], dtype=x.dtype, device=x.device)
    dom = (dout * mask).reshape(N * T, -1)
    if _wants(ctx, "Filter"):
        im = _seq_conv_im(x * mask, c_len, c_start)
        _set_grad(ctx, "Filter", im.reshape(N * T, -1).t() @ dom)
    if _wants(ctx, "X"):
        dim = (dom @ w.t()).reshape(N, T, c_len, D)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        dxm = torch.zeros_like(x)
        for k in range(c_len):
            off = c_start + k
            dxm = dxm + torch.roll(torch.where(
                _window_valid(T, off, x.device), dim[:, :, k], zero), off, 1)
        _set_grad(ctx, "X", dxm * mask)


def _wants(ctx, slot):
    names = ctx.out_names(slot + GRAD_SUFFIX)
    return bool(names) and names[0] != EMPTY_VAR_NAME


def _set_grad(ctx, slot, value):
    if _wants(ctx, slot):
        ctx.set_out(slot + GRAD_SUFFIX, value)


def _cot(ctx, slot, like):
    """The cotangent of output ``slot`` (zeros when nobody made one)."""
    names = ctx.op.inputs.get(slot + GRAD_SUFFIX, [])
    g = (ctx.in_(slot + GRAD_SUFFIX) if names and names[0] != EMPTY_VAR_NAME
         and names[0] in ctx.env else None)
    return torch.zeros_like(like) if g is None else g.to(like.dtype)


# --------------------------------------------------------------------------
# recurrences
# --------------------------------------------------------------------------
def _lstm_cell_step(carry, xt, wi, wh, b):
    h, c = carry
    gates = (xt if wi is None else xt @ wi) + h @ wh + b
    i, f, g, o = torch.chunk(gates, 4, -1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    h = o * torch.tanh(c)
    return (h, c), h


def _gru_cell_step(carry, xt, wi, wh, b):
    """The fused ``gru`` op's step: ``(1 - z) * n + z * h`` (JAX
    :386-397; ``gru_unit``'s update is the other way round)."""
    (h,) = carry
    D = wh.shape[0]
    gi = (xt if wi is None else xt @ wi) + b
    gh_rz = h @ wh[:, :2 * D]
    r = torch.sigmoid(gi[..., :D] + gh_rz[..., :D])
    z = torch.sigmoid(gi[..., D:2 * D] + gh_rz[..., D:2 * D])
    n = torch.tanh(gi[..., 2 * D:] + (r * h) @ wh[:, 2 * D:])
    h = (1 - z) * n + z * h
    return (h,), h


def _run_rnn(x, length, h0, c0, wi, wh, b, cell, reverse=False):
    """One direction of one layer: x ``[N, T, D]`` -> (out ``[N, T, H]``,
    the final carry)."""
    T = x.shape[1]
    mask = _length_mask(length, T, x.dtype)[:, :, None]
    idx = _rev_index(length, T) if reverse else None
    xin = _take_time(x, idx) if reverse else x
    carry = (h0, c0) if c0 is not None else (h0,)
    outs = []
    for t in range(T):
        mt = mask[:, t]
        new, out = cell(carry, xin[:, t], wi, wh, b)
        carry = tuple(mt * n + (1 - mt) * o for n, o in zip(new, carry))
        outs.append(out * mt)
    out = torch.stack(outs, 1)
    if reverse:
        out = _take_time(out, idx)
    return out, carry


def _fused_rnn(ctx, cell, gates, with_c):
    x = ctx.in_("Input")
    length = _get_len(ctx, x, "SequenceLength")
    wis, whs = ctx.ins("WeightIh"), ctx.ins("WeightHh")
    bs = ctx.ins("Bias") if ctx.has_input("Bias") else [None] * len(wis)
    dirs = 2 if ctx.attr("is_bidirec", False) else 1
    H, N = whs[0].shape[0], x.shape[0]
    h0 = ctx.in_("InitH") if ctx.has_input("InitH") else None
    c0 = ctx.in_("InitC") if with_c and ctx.has_input("InitC") else None
    last_h, last_c, inp = [], [], x
    for layer in range(len(wis) // dirs):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            b = bs[k] if bs[k] is not None else x.new_zeros(gates * H)
            ih = h0[k] if h0 is not None else x.new_zeros(N, H)
            ic = (c0[k] if c0 is not None else x.new_zeros(N, H)) \
                if with_c else None
            out, carry = _run_rnn(inp, length, ih, ic, wis[k], whs[k], b,
                                  cell, reverse=(d == 1))
            outs.append(out)
            last_h.append(carry[0])
            if with_c:
                last_c.append(carry[1])
        inp = torch.cat(outs, -1) if dirs == 2 else outs[0]
    ctx.set_out("Out", inp)
    ctx.set_out("LastH", torch.stack(last_h, 0))
    if with_c:
        ctx.set_out("LastC", torch.stack(last_c, 0))


@op("lstm")
def _lstm(ctx):
    """Multi-layer (bi)LSTM over the padded batch (``WeightIh`` /
    ``WeightHh`` / ``Bias`` one per layer and direction)."""
    _fused_rnn(ctx, _lstm_cell_step, 4, True)


@op("gru")
def _gru(ctx):
    """Multi-layer (bi)GRU, as ``lstm``."""
    _fused_rnn(ctx, _gru_cell_step, 3, False)


def _dlstm_parts(ctx):
    """(x, w, the 4H bias, length, h0, c0, reverse index or None)."""
    x, w = ctx.in_("Input"), ctx.in_("Weight")
    H, N, T = w.shape[0], x.shape[0], x.shape[1]
    b = ctx.in_("Bias") if ctx.has_input("Bias") else None
    bb = b.reshape(-1)[:4 * H] if b is not None else x.new_zeros(4 * H)
    length = _get_len(ctx, x, "SequenceLength")
    h0 = ctx.in_("H0") if ctx.has_input("H0") else x.new_zeros(N, H)
    c0 = ctx.in_("C0") if ctx.has_input("C0") else x.new_zeros(N, H)
    ridx = (_rev_index(length, T) if ctx.attr("is_reverse", False)
            else None)
    return x, w, bb, length, h0, c0, ridx


@op("dynamic_lstm")
def _dynamic_lstm(ctx):
    """``Input`` is the precomputed x-projection ``[N, T, 4H]``,
    ``Weight`` ``[H, 4H]`` the recurrent matrix, ``Bias`` ``[1, 4H]``.
    A step: ``gates = x_t + h @ W + b`` (one ``addmm``), then the cell;
    the state freezes past a row's length; ``Hidden`` / ``Cell`` are 0
    there."""
    x, w, bb, length, h0, c0, ridx = _dlstm_parts(ctx)
    H, T = w.shape[0], x.shape[1]
    mask = _length_mask(length, T, torch.bool)[:, :, None]
    xin = _take_time(x, ridx) if ridx is not None else x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h, c = h0, c0
    hs, cs = [], []
    for t in range(T):
        gates = torch.addmm(xin[:, t], h, w) + bb
        s = torch.sigmoid(gates)
        cn = s[:, H:2 * H] * c + s[:, :H] * torch.tanh(gates[:, 2 * H:3 * H])
        hn = s[:, 3 * H:] * torch.tanh(cn)
        mt = mask[:, t]
        h, c = torch.where(mt, hn, h), torch.where(mt, cn, c)
        hs.append(torch.where(mt, hn, zero))
        cs.append(torch.where(mt, cn, zero))
    hidden, cell = torch.stack(hs, 1), torch.stack(cs, 1)
    if ridx is not None:
        hidden, cell = _take_time(hidden, ridx), _take_time(cell, ridx)
    ctx.set_out("Hidden", hidden)
    ctx.set_out("Cell", cell)
    ctx.set_out("LastH", h)
    ctx.set_out("LastC", c)


@op("dynamic_lstm_grad", no_grad=True)
def _dynamic_lstm_grad(ctx):
    """Backpropagation through time from the forward's ``Hidden`` and
    ``Cell``: the carries before each step are ``H0`` / ``C0`` then the
    saved outputs (a row's valid steps are a prefix, and its padded
    steps carry no gradient), so every step's gates come from one
    product, and the reverse loop does one ``addmm`` a step
    (``dh_prev = dGates @ W^T``).  dW and dBias are one product and one
    sum over all steps."""
    x, w, bb, length, h0, c0, ridx = _dlstm_parts(ctx)
    H, N, T = w.shape[0], x.shape[0], x.shape[1]
    hidden, cell = ctx.in_("Hidden"), ctx.in_("Cell")
    d_hid, d_cell = _cot(ctx, "Hidden", hidden), _cot(ctx, "Cell", cell)
    dh, dc = _cot(ctx, "LastH", h0), _cot(ctx, "LastC", c0)
    if ridx is not None:
        x, hidden, cell = (_take_time(v, ridx) for v in (x, hidden, cell))
        d_hid, d_cell = _take_time(d_hid, ridx), _take_time(d_cell, ridx)
    # time-major, so a step's slices are contiguous
    m = _length_mask(length, T, x.dtype).t()[:, :, None]       # [T, N, 1]
    hprev = torch.cat([h0[None], hidden.transpose(0, 1)[:-1]], 0)
    cprev = torch.cat([c0[None], cell.transpose(0, 1)[:-1]], 0)
    gates = torch.addmm(bb, hprev.reshape(T * N, H), w).reshape(T, N, 4 * H)
    gates = gates + x.transpose(0, 1)
    s = torch.sigmoid(gates)
    i, f, o = s[..., :H], s[..., H:2 * H], s[..., 3 * H:]
    g = torch.tanh(gates[..., 2 * H:3 * H])
    tc = torch.tanh(f * cprev + i * g)
    # d gates_i / f / g per unit of dCn, d gates_o per unit of dHn
    p_ifg = torch.cat([g * i * (1 - i), cprev * f * (1 - f),
                       i * (1 - g * g)], -1).reshape(T, N, 3, H)
    p_o = tc * o * (1 - o)
    a = o * (1 - tc * tc)
    d_hid = d_hid.transpose(0, 1) * m
    d_cell = d_cell.transpose(0, 1) * m
    keep = 1 - m
    dgates = torch.empty(T, N, 4 * H, dtype=x.dtype, device=x.device)
    wt = w.t()
    for t in range(T - 1, -1, -1):
        dhn = dh * m[t] + d_hid[t]
        dcn = dc * m[t] + d_cell[t] + dhn * a[t]
        dgates[t, :, :3 * H] = (dcn[:, None, :] * p_ifg[t]).reshape(N, -1)
        dgates[t, :, 3 * H:] = dhn * p_o[t]
        dc = dc * keep[t] + dcn * f[t]
        dh = torch.addmm(dh * keep[t], dgates[t], wt)
    flat = dgates.reshape(T * N, 4 * H)
    if _wants(ctx, "Weight"):
        _set_grad(ctx, "Weight", hprev.reshape(T * N, H).t() @ flat)
    if _wants(ctx, "Bias"):
        b = ctx.in_("Bias")
        db = torch.zeros(b.numel(), dtype=b.dtype, device=b.device)
        db[:4 * H] = flat.sum(0)
        _set_grad(ctx, "Bias", db.reshape(b.shape))
    dx = dgates.transpose(0, 1)
    if ridx is not None:
        dx = _take_time(dx, ridx)
    _set_grad(ctx, "Input", dx.contiguous())
    _set_grad(ctx, "H0", dh)
    _set_grad(ctx, "C0", dc)


@op("dynamic_gru")
def _dynamic_gru(ctx):
    """``Input`` the x-projection ``[N, T, 3H]``, ``Weight`` ``[H, 3H]``
    recurrent; the fused ``gru`` op's step."""
    x, w = ctx.in_("Input"), ctx.in_("Weight")
    H, N = w.shape[0], x.shape[0]
    b = ctx.in_("Bias") if ctx.has_input("Bias") else None
    bb = b.reshape(-1)[:3 * H] if b is not None else x.new_zeros(3 * H)
    h0 = ctx.in_("H0") if ctx.has_input("H0") else x.new_zeros(N, H)
    out, (hT,) = _run_rnn(x, _get_len(ctx, x, "SequenceLength"), h0, None,
                          None, w, bb, _gru_cell_step,
                          reverse=bool(ctx.attr("is_reverse", False)))
    ctx.set_out("Hidden", out)
    ctx.set_out("LastH", hT)


@op("lstm_unit")
def _lstm_unit(ctx):
    """One cell step on precomputed gates ``X`` ``[N, 4H]``."""
    i, f, g, o = torch.chunk(ctx.in_("X"), 4, -1)
    fb = ctx.attr("forget_bias", 0.0) or 0.0
    c = (torch.sigmoid(f + fb) * ctx.in_("C_prev")
         + torch.sigmoid(i) * torch.tanh(g))
    ctx.set_out("C", c)
    ctx.set_out("H", torch.sigmoid(o) * torch.tanh(c))


def _gru_unit_parts(ctx):
    x, hp, w = ctx.in_("Input"), ctx.in_("HiddenPrev"), ctx.in_("Weight")
    if ctx.has_input("Bias"):
        x = x + ctx.in_("Bias").reshape(1, -1)
    return x, hp, w, hp.shape[-1]


@op("gru_unit")
def _gru_unit(ctx):
    """One GRU step: ``r, z = sigmoid(x_rz + h @ W_rz)``,
    ``n = tanh(x_n + (r * h) @ W_n)``, ``h' = (1 - z) * h + z * n``."""
    x, hp, w, H = _gru_unit_parts(ctx)
    hw = hp @ w[:, :2 * H]
    r = torch.sigmoid(x[..., :H] + hw[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hw[..., H:2 * H])
    rh = r * hp
    n = torch.tanh(x[..., 2 * H:] + rh @ w[:, 2 * H:])
    ctx.set_out("Gate", torch.cat([r, z, n], -1))
    ctx.set_out("ResetHiddenPrev", rh)
    ctx.set_out("Hidden", (1 - z) * hp + z * n)


@op("gru_unit_grad", no_grad=True)
def _gru_unit_grad(ctx):
    """The step's gradient in closed form from the saved ``Gate`` (r, z,
    n) and ``ResetHiddenPrev``: four products, none of the forward's
    again."""
    x, hp, w, H = _gru_unit_parts(ctx)
    gate, rh = ctx.in_("Gate"), ctx.in_("ResetHiddenPrev")
    r, z, n = gate[..., :H], gate[..., H:2 * H], gate[..., 2 * H:]
    dh = _cot(ctx, "Hidden", hp)
    dgate = _cot(ctx, "Gate", gate)
    dz = dh * (n - hp) + dgate[..., H:2 * H]
    dn = dh * z + dgate[..., 2 * H:]
    dhp = dh * (1 - z)
    dn_pre = dn * (1 - n * n)
    drh = dn_pre @ w[:, 2 * H:].t() + _cot(ctx, "ResetHiddenPrev", rh)
    dr = drh * hp + dgate[..., :H]
    dhp = dhp + drh * r
    drz = torch.cat([dr * r * (1 - r), dz * z * (1 - z)], -1)
    dhp = dhp + drz @ w[:, :2 * H].t()
    dx = torch.cat([drz, dn_pre], -1)
    if _wants(ctx, "Weight"):
        _set_grad(ctx, "Weight", torch.cat([hp.t() @ drz, rh.t() @ dn_pre],
                                           -1))
    if _wants(ctx, "Bias"):
        b = ctx.in_("Bias")
        _set_grad(ctx, "Bias", dx.sum(0).reshape(b.shape))
    _set_grad(ctx, "Input", dx)
    _set_grad(ctx, "HiddenPrev", dhp)


# --------------------------------------------------------------------------
# beam search
# --------------------------------------------------------------------------
@op("beam_search", no_grad=True)
def _beam_search(ctx):
    """One step of beam expansion over the flat layout: ``Scores``
    ``[N*B, V]`` log-probs, ``PreIds`` / ``PreScores`` ``[N*B, 1]``; the
    top ``B`` continuations of each source's ``B*V`` by accumulated
    score.  ``SelectedIds`` / ``SelectedScores`` ``[N*B, 1]``,
    ``ParentIdx`` ``[N*B]`` (the row each continues)."""
    scores, pre_scores = ctx.in_("Scores"), ctx.in_("PreScores")
    beam = int(ctx.attr("beam_size", 4))
    end_id = int(ctx.attr("end_id", 0))
    NB, V = scores.shape
    N = NB // beam
    finished = (ctx.in_("PreIds").reshape(-1) == end_id)[:, None]
    ps = pre_scores.reshape(-1, 1).to(scores.dtype)
    cont = ps + scores
    is_end = (torch.arange(V, device=scores.device) == end_id)[None, :]
    keep = torch.zeros_like(scores) + torch.where(
        is_end, ps, torch.full((), _neg(scores.dtype), dtype=scores.dtype,
                               device=scores.device))
    total = torch.where(finished, keep, cont)
    top_scores, top_idx = xla_top_k(total.reshape(N, beam * V), beam)
    parent = top_idx // V
    parent_flat = (parent + torch.arange(N, device=scores.device)[:, None]
                   * beam).reshape(-1)
    ctx.set_out("SelectedIds", (top_idx % V).reshape(-1, 1))
    ctx.set_out("SelectedScores", top_scores.reshape(-1, 1))
    ctx.set_out("ParentIdx", parent_flat.to(torch.int32))


@op("beam_search_decode", no_grad=True, host=True)
def _beam_search_decode(ctx):
    """The backtrack through each step's parents into whole hypotheses,
    on the host (the reference's ragged result); a hypothesis ends at its
    first ``end_id``.  ``SentenceIds`` ``[N*B, T]`` int64 (0 past its
    length), ``SentenceScores`` the last step's scores,
    ``SentenceLength``."""
    def host(slot):
        return [v.detach().cpu().numpy().reshape(-1) for v in ctx.ins(slot)]

    ids_steps, score_steps = host("Ids"), host("Scores")
    parent_steps = host("ParentIdx")
    end_id = int(ctx.attr("end_id", 0))
    T, NB = len(ids_steps), ids_steps[0].shape[0]
    seqs = np.zeros((NB, T), np.int64)
    lens = np.zeros((NB,), np.int64)
    for b in range(NB):
        toks, cur = [], b
        for t in range(T - 1, -1, -1):
            toks.append(int(ids_steps[t][cur]))
            cur = int(parent_steps[t][cur]) if t > 0 else cur
        toks.reverse()
        if end_id in toks:
            toks = toks[: toks.index(end_id) + 1]
        seqs[b, :len(toks)] = toks
        lens[b] = len(toks)
    dev = ctx.ins("Ids")[0].device
    final = (torch.as_tensor(score_steps[-1]) if score_steps
             else torch.zeros(NB))
    ctx.set_out("SentenceIds", torch.from_numpy(seqs).to(dev))
    ctx.set_out("SentenceScores", final.to(dev))
    ctx.set_out("SentenceLength", torch.from_numpy(lens).to(dev))


@op("gather_tree", no_grad=True)
def _gather_tree(ctx):
    """Backtrack beam parents into whole sequences: ``Ids`` / ``Parents``
    ``[T, B, W]`` -> ``[T, B, W]``."""
    ids, parents = ctx.in_("Ids"), ctx.in_("Parents").to(torch.int64)
    T, B, W = ids.shape
    beam = torch.arange(W, device=ids.device)[None, :].expand(B, W)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = torch.take_along_dim(ids[t], beam, dim=1)
        beam = torch.take_along_dim(parents[t], beam, dim=1)
    ctx.set_out("Out", torch.stack(outs, 0))


@op("beam_gather_states")
def _beam_gather_states(ctx):
    """``out[b, j] = X[b, Ids[b, j]]`` (a beam decoder's parent-state
    reorder)."""
    x, ids = ctx.in_("X"), ctx.in_("Ids").to(torch.int64)
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    ctx.set_out("Out", x[b, ids])
