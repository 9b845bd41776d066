"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd front.

Counterpart of ``paddle_tpu/ops/pallas_kernels.py`` ``attention_reference``,
``is_padding_bias``, ``_normalize_bias`` (:80-129), the flash kernels
(:150-621) and their fronts ``flash_attention``,
``flash_attention_fwd_res``, ``flash_attention_bwd_res`` and
``_flash_prologue`` (:658-758).  Layouts are the JAX package's: q, k, v
``(batch, heads, seq, head_dim)``; the padding bias is additive, one value
per key, ``(b, kv)`` / ``(b, 1, kv)`` / ``(b, 1, 1, kv)``.

One :class:`torch.autograd.Function` replaces the custom_vjp and the
residual API: its forward saves ``(q, k, v, bias, out, lse, seed)`` and
its backward runs the backward from ``lse`` with no forward replay.  The
padding bias gets a zero gradient (``pallas_kernels.py:646-650``).

Dtypes: q, k, v (and dO) are float32, bfloat16 or float16, all of one
dtype, as the TPU kernels take them; the output and the gradients are in
that dtype, lse and delta are float32, and the padding bias reaches the
kernels as float32 (under AMP it is the exact upcast of the bf16 or fp16
bias the white-list cast made).  In bf16 and fp16 every product
accumulates in float32 and the operands the TPU kernels cast are rounded
at the same points: p before the PV product (``pd.astype(v.dtype)``,
:190/:229), pd before dV (:436/:470), dS before dQ and dK
(:405/:440/:467/:473); fp16 keeps subnormals there, as XLA's cast does.

Head dims: any multiple of 8 up to 128 (the TPU kernels engage for any
multiple of 8, :702; above 128 the kernels' backward does not fit a
block's shared memory, so a CUDA tensor with a wider head raises).

Dispatch: a CPU tensor takes the plain versions
(:func:`flash_fwd_reference`, :func:`flash_bwd_reference`); a CUDA tensor
launches the kernels of ``csrc/flash_attention.cu`` for its dtype
(:func:`flash_fwd`, :func:`flash_bwd`: ``flash_fwd_f32``,
``flash_fwd_bf16`` or ``flash_fwd_fp16``, and so on) or raises when they
do not take its dtype or shape.  There is no other path.  The backward
takes the fused kernel when ``sq <= 512`` and ``sk <= 512`` (one TPU
block, ``pallas_kernels.py:532``) and the split dQ and dK/dV pair above
that.  In bf16 and fp16 the forward and both backwards run on the tensor
cores (``wgmma``) and read their inputs through TMA tensor maps, so a
view off a 16-byte boundary is copied first; the f32 kernels are SIMT
f32 arithmetic (no TF32).

Dropout (attention probabilities, upscale in train) is keyed by a seed:
an int64 tensor of one element, drawn by the caller.  On the card the
kernels draw each element's keep decision from Philox keyed by (seed,
b, h, i, j), the same in the forward and in either backward, and
:func:`flash_dropout_mask` writes that mask out.  On the CPU the plain
versions draw the mask from a ``torch.Generator`` seeded with the seed,
the same in the forward and the backward.  The two masks differ; only
the distribution is contractual, as in the JAX package (:86-87).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..kernel_build import CudaKernel, KernelFunction
from .paged_attention import DEFAULT_MASK_VALUE

__all__ = [
    "DEFAULT_MASK_VALUE", "MAX_HEAD_DIM", "FUSED_BWD_MAX_SEQ", "FLASH",
    "FLASH_FWD", "FLASH_BWD_FUSED", "FLASH_BWD_DQ", "FLASH_BWD_DKV",
    "FLASH_FWD_BF16", "FLASH_BWD_FUSED_BF16", "FLASH_BWD_DQ_BF16",
    "FLASH_BWD_DKV_BF16", "FLASH_FWD_FP16", "FLASH_BWD_FUSED_FP16",
    "FLASH_BWD_DQ_FP16", "FLASH_BWD_DKV_FP16", "FLASH_DROPOUT_MASK",
    "is_padding_bias", "normalize_bias", "seeded_keep", "attention_reference",
    "flash_fwd_reference", "flash_bwd_reference", "attention_dtype",
    "flash_fwd", "flash_bwd", "bwd_fused", "bwd_dq", "bwd_dkv",
    "flash_dropout_mask", "attention_forward", "attention_backward",
    "flash_attention",
]

#: the kernels take every head dim that is a multiple of 8 up to this one;
#: they run at the next of the tile widths 32, 64, 128
MAX_HEAD_DIM = 128
#: the backward takes the fused kernel up to this many queries and keys
FUSED_BWD_MAX_SEQ = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_ATTN = [_I, _I, _I, _I, _I, _F, _I, _P, _U, _F, _U, _P]
#: the hand-written Hopper kernels (csrc/flash_attention.cu)
FLASH = CudaKernel("flash_attention.cu", {
    "paddle_flash_fwd_f32": [_P] * 6 + _ATTN,
    "paddle_flash_bwd_dq_f32": [_P] * 8 + _ATTN,
    "paddle_flash_bwd_dkv_f32": [_P] * 9 + _ATTN,
    # the f32 fused backward takes a float32 scratch for dQ's shares
    # (None where it takes none: _fused_f32_parts)
    "paddle_flash_bwd_fused_f32": [_P] * 11 + _ATTN,
    "paddle_flash_fwd_bf16": [_P] * 6 + _ATTN,
    "paddle_flash_bwd_dq_bf16": [_P] * 8 + _ATTN,
    "paddle_flash_bwd_dkv_bf16": [_P] * 9 + _ATTN,
    # the bf16 and fp16 fused backwards also take their float32 dQ scratch
    "paddle_flash_bwd_fused_bf16": [_P] * 11 + _ATTN,
    "paddle_flash_fwd_fp16": [_P] * 6 + _ATTN,
    "paddle_flash_bwd_dq_fp16": [_P] * 8 + _ATTN,
    "paddle_flash_bwd_dkv_fp16": [_P] * 9 + _ATTN,
    "paddle_flash_bwd_fused_fp16": [_P] * 11 + _ATTN,
    "paddle_flash_dropout_mask": [_P, _I, _I, _I, _I, _P, _U, _U, _P],
    # not launches: the bf16 / fp16 fused kernel's CTAs per SM, for
    # reports, and the size of the f32 fused kernel's scratch
    "paddle_flash_fused_occupancy": [_I, _I, _P],
    "paddle_flash_fused_f32_parts": [_I] * 5 + [_P],
})
FLASH_FWD = KernelFunction(FLASH, "paddle_flash_fwd_f32", "flash_fwd_f32")
FLASH_BWD_FUSED = KernelFunction(FLASH, "paddle_flash_bwd_fused_f32",
                                 "flash_bwd_fused_f32")
FLASH_BWD_DQ = KernelFunction(FLASH, "paddle_flash_bwd_dq_f32",
                              "flash_bwd_dq_f32")
FLASH_BWD_DKV = KernelFunction(FLASH, "paddle_flash_bwd_dkv_f32",
                               "flash_bwd_dkv_f32")
FLASH_FWD_BF16 = KernelFunction(FLASH, "paddle_flash_fwd_bf16",
                                "flash_fwd_bf16")
FLASH_BWD_FUSED_BF16 = KernelFunction(FLASH, "paddle_flash_bwd_fused_bf16",
                                      "flash_bwd_fused_bf16")
FLASH_BWD_DQ_BF16 = KernelFunction(FLASH, "paddle_flash_bwd_dq_bf16",
                                   "flash_bwd_dq_bf16")
FLASH_BWD_DKV_BF16 = KernelFunction(FLASH, "paddle_flash_bwd_dkv_bf16",
                                    "flash_bwd_dkv_bf16")
FLASH_FWD_FP16 = KernelFunction(FLASH, "paddle_flash_fwd_fp16",
                                "flash_fwd_fp16")
FLASH_BWD_FUSED_FP16 = KernelFunction(FLASH, "paddle_flash_bwd_fused_fp16",
                                      "flash_bwd_fused_fp16")
FLASH_BWD_DQ_FP16 = KernelFunction(FLASH, "paddle_flash_bwd_dq_fp16",
                                   "flash_bwd_dq_fp16")
FLASH_BWD_DKV_FP16 = KernelFunction(FLASH, "paddle_flash_bwd_dkv_fp16",
                                    "flash_bwd_dkv_fp16")
#: the kernel each wrapper launches, by the dtype of q
_KERNELS = {
    torch.float32: {"fwd": FLASH_FWD, "fused": FLASH_BWD_FUSED,
                    "dq": FLASH_BWD_DQ, "dkv": FLASH_BWD_DKV},
    torch.bfloat16: {"fwd": FLASH_FWD_BF16, "fused": FLASH_BWD_FUSED_BF16,
                     "dq": FLASH_BWD_DQ_BF16, "dkv": FLASH_BWD_DKV_BF16},
    torch.float16: {"fwd": FLASH_FWD_FP16, "fused": FLASH_BWD_FUSED_FP16,
                    "dq": FLASH_BWD_DQ_FP16, "dkv": FLASH_BWD_DKV_FP16},
}
FLASH_DROPOUT_MASK = KernelFunction(FLASH, "paddle_flash_dropout_mask",
                                    "flash_dropout_mask")


# ==========================================================================
# bias shapes
# ==========================================================================
def is_padding_bias(bias: torch.Tensor) -> bool:
    """True for the per-key padding shapes the flash path handles."""
    if bias.dim() == 2:
        return True
    if bias.dim() == 3 and bias.shape[1] == 1:
        return True
    return bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1


def normalize_bias(bias: torch.Tensor) -> torch.Tensor:
    """Accept (b, kv), (b, 1, 1, kv) or (b, 1, kv); return (b, kv)."""
    if bias.dim() == 2:
        return bias
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
        return bias[:, 0, 0, :]
    if bias.dim() == 3 and bias.shape[1] == 1:
        return bias[:, 0, :]
    raise ValueError(f"unsupported attention bias shape {tuple(bias.shape)}")


# ==========================================================================
# plain versions
# ==========================================================================
def _drop_threshold(rate: float) -> int:
    """keep iff 32 random bits >= this (the TPU kernel's rule, :146)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def seeded_keep(shape, rate: float, seed, device) -> torch.Tensor:
    """A boolean keep mask (keep probability ``1 - rate``) drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (an int or a
    one-element tensor): the same seed gives the same mask."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) >= rate


def _scores(q, k, bias, scale, causal):
    """f32 ``q k^T * scale + bias``, then DEFAULT_MASK_VALUE above the
    diagonal when causal: the order of ``attention_reference`` (:88-99)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        if is_padding_bias(bias):
            s = s + normalize_bias(bias)[:, None, None, :].float()
        else:
            s = s + bias.float()           # (b, 1, q, kv) / (b, h, q, kv)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        tril = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(tril, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    return s


def _dropped(x, keep, rate):
    return torch.where(keep.bool(), x, torch.zeros_like(x)) * (
        1.0 / (1.0 - rate))


def _rounded(x, dtype):
    """f32 ``x`` cast to ``dtype`` and back: where the TPU kernels cast an
    f32 operand to the inputs' dtype before a product (a no-op in f32)."""
    return x.to(dtype).float()


def attention_reference(q, k, v, bias=None, causal=False, scale=1.0,
                        dropout_rate=0.0, dropout_seed=None, keep=None):
    """Dense attention, differentiable by autograd: the flash kernels'
    oracle and the path of a full-matrix bias.  ``bias``: a padding shape
    or a matrix broadcastable to (b, h, q, kv).  With ``dropout_rate`` the
    probabilities are dropped (upscale in train) by ``keep`` (a 0/1
    tensor of shape (b, h, q, kv)) when given, else by
    :func:`seeded_keep` of ``dropout_seed``.  Output in v's dtype."""
    p = torch.softmax(_scores(q, k, bias, scale, causal), dim=-1)
    if dropout_rate > 0.0:
        if keep is None:
            if dropout_seed is None:
                raise ValueError("attention dropout requires a seed or a "
                                 "keep mask")
            keep = seeded_keep(p.shape, dropout_rate, dropout_seed, p.device)
        p = _dropped(p, keep, dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_fwd_reference(q, k, v, bias, scale, causal, dropout_rate=0.0,
                        keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(out, lse)`` with ``out`` in
    q's dtype and ``lse`` (b, h, sq) f32.  The softmax normalises the
    undropped p; only the PV product sees ``keep``, and takes p rounded to
    v's dtype; a row whose sum is 0 gives zeros."""
    s = _scores(q, k, bias, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = _dropped(p, keep, dropout_rate)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", _rounded(p, v.dtype),
                       v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_bwd_reference(q, k, v, bias, out, lse, do, scale, causal,
                        dropout_rate=0.0, keep=None):
    """Plain version of the backward kernels (``_bwd_softmax_terms``
    :353 and its three contractions): ``(dq, dk, dv)`` from the saved
    ``lse``, with ``delta = rowsum(dO * O)`` and
    ``dS = P * (keep(dP) / (1 - rate) - delta) * scale``, all in f32;
    dS and the dropped P are rounded to the inputs' dtype before the
    products that take them, and the gradients come out in it."""
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, bias, scale, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    pd = p
    if dropout_rate > 0.0:
        pd = _dropped(p, keep, dropout_rate)
        dp = _dropped(dp, keep, dropout_rate)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", _rounded(ds, k.dtype), k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(pd, do.dtype), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ==========================================================================
# the CUDA kernels' wrappers
# ==========================================================================
#: the tensors in the attention dtype; bias, lse and delta are f32
_DATA = ("q", "k", "v", "do")


def attention_dtype(fn, q) -> torch.dtype:
    """q's dtype if the kernels take it (f32, bf16, fp16), else raise
    ``ValueError``."""
    if q.dtype not in _KERNELS:
        raise ValueError(f"{fn}: q is {q.dtype}; the kernels take float32, "
                         f"bfloat16 or float16")
    return q.dtype


def _check_cuda(fn, **tensors):
    """Raise unless q, k, v, do share q's dtype (f32, bf16, fp16), bias, lse
    and delta are f32 and ``seed`` int64, and every tensor is contiguous
    and on the CUDA device of the first."""
    dev = None
    dt = attention_dtype(fn, tensors["q"]) if "q" in tensors else None
    for name, t in tensors.items():
        if t is None:
            continue
        if dev is None:
            dev = t.device
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {dev}")
        want = (torch.int64 if name == "seed"
                else dt if name in _DATA else torch.float32)
        if t.dtype != want:
            raise ValueError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                             f"{want}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    return dev


def _shapes(fn, q, k, v, bias):
    """(b, h, sq, sk, d), validated against what the kernels take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q, k, v must be (batch, heads, seq, "
                         f"head_dim)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{fn}: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head_dim {d} is not a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if sq < 1 or sk < 1 or b < 1 or h < 1:
        raise ValueError(f"{fn}: empty input q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if bias is not None and tuple(bias.shape) != (b, sk):
        raise ValueError(f"{fn}: bias must be (batch, kv_seq) = "
                         f"{(b, sk)}, got {tuple(bias.shape)}")
    return b, h, sq, sk, d


def _attn_args(h, sq, sk, d, scale, causal, dropout_rate, seed, stream):
    """The trailing ``Attn`` arguments every entry point takes."""
    if dropout_rate > 0.0:
        if seed is None:
            raise ValueError("flash attention dropout requires a seed")
        if not 0.0 < dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in (0, 1)")
        return [h, sq, sk, d, float(scale), int(bool(causal)),
                seed.data_ptr(), _drop_threshold(dropout_rate),
                1.0 / (1.0 - dropout_rate), 0, stream]
    return [h, sq, sk, d, float(scale), int(bool(causal)), None, 0, 1.0, 0,
            stream]


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, bias, scale, causal, dropout_rate=0.0, seed=None):
    """Launch ``flash_fwd_f32`` (f32 q, k, v), ``flash_fwd_bf16`` (bf16) or
    ``flash_fwd_fp16`` (fp16) on the current stream: ``(out, lse)``, out
    (b, h, sq, d) in q's dtype and lse (b, h, sq) f32.  ``bias`` is None
    or (b, sk) f32; ``seed`` an int64 tensor of one element (dropout
    only).  Raises on anything the kernels do not take."""
    dev = _check_cuda("flash_fwd", q=q, k=k, v=v, bias=bias, seed=seed)
    b, h, sq, sk, d = _shapes("flash_fwd", q, k, v, bias)
    q, k, v = _tma_ready(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[q.dtype]["fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            out.data_ptr(), lse.data_ptr(), b,
            *_attn_args(h, sq, sk, d, scale, causal, dropout_rate, seed,
                        stream))
    return out, lse


def _bwd_inputs(fn, q, k, v, bias, do, lse, delta, seed):
    dev = _check_cuda(fn, q=q, k=k, v=v, bias=bias, do=do, lse=lse,
                      delta=delta, seed=seed)
    b, h, sq, sk, d = _shapes(fn, q, k, v, bias)
    if do.shape != q.shape or tuple(lse.shape) != (b, h, sq) \
            or lse.shape != delta.shape:
        raise ValueError(f"{fn}: do{tuple(do.shape)} lse{tuple(lse.shape)} "
                         f"delta{tuple(delta.shape)} do not fit "
                         f"q{tuple(q.shape)}")
    return dev, (b, h, sq, sk, d)


def _fused_scratch(b, h, sq, d, dev):
    """The bf16 / fp16 fused kernel's float32 scratch: dQ's sums (b h sq d
    floats), then its order flags, zeroed: a CTA counter and one flag per
    (b h, q tile of 32 or 64 rows)."""
    n = b * h * sq * d
    buf = torch.empty(n + b * h * -(-sq // 32) + 1, dtype=torch.float32,
                      device=dev)
    buf[n:].zero_()
    return buf


def _fused_f32_parts(b: int, h: int, sq: int, sk: int, d: int) -> int:
    """The (b, h, sq, d) float32 slices that ``flash_bwd_fused_f32``'s
    scratch holds, as ``launch_fused_f32`` in ``csrc/flash_attention.cu``
    runs the kernel: one for each kv-tile CTA of a (b, h) (128 keys up to
    head dim 64, 64 above), as many as 256 MiB holds but at least 4, the
    CTAs running that many to a launch; 0 where one CTA takes every key
    and stores dQ itself."""
    n = ctypes.c_int(0)
    err = FLASH.load().paddle_flash_fused_f32_parts(b, h, sq, sk, d,
                                                    ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"flash_bwd_fused_f32: no scratch size for b {b} "
                           f"h {h} sq {sq} sk {sk} d {d} (cudaError_t {err})")
    return n.value


def bwd_fused(q, k, v, bias, do, lse, delta, scale, causal,
              dropout_rate=0.0, seed=None):
    """Launch ``flash_bwd_fused_f32``, ``_bf16`` or ``_fp16``: ``(dq, dk,
    dv)`` in one kernel.  Every kernel sums dQ across its kv-tile CTAs in
    float32 in kv order, in a scratch allocated here: the bf16 and fp16
    kernels their sums (b h sq d floats, rounded once); the f32 kernel
    each kv-tile CTA's share, which a second launch sums: up to 256 MiB,
    or 4 x dQ where that is larger (277 MB at b 44, h 12, s 512, d 64),
    the CTAs running as many shares to a launch
    (:func:`_fused_f32_parts`)."""
    dev, (b, h, sq, sk, d) = _bwd_inputs("bwd_fused", q, k, v, bias, do, lse,
                                         delta, seed)
    q, k, v, do, lse, delta = _tma_ready(q, k, v, do, lse, delta)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.dtype != torch.float32:
        buf = _fused_scratch(b, h, sq, d, dev)
    else:
        n = _fused_f32_parts(b, h, sq, sk, d)
        buf = torch.empty(n * b * h * sq * d, dtype=torch.float32,
                          device=dev) if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[q.dtype]["fused"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(buf),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            *_attn_args(h, sq, sk, d, scale, causal, dropout_rate, seed,
                        stream))
    return dq, dk, dv


def _tma_ready(*tensors):
    """The tensors, each copied if its address is not 16-byte aligned: the
    bf16 and fp16 kernels read them through TMA tensor maps, and the f32
    kernels by 16-byte ``cp.async`` copies, which need 16-byte-aligned
    rows."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def bwd_dq(q, k, v, bias, do, lse, delta, scale, causal, dropout_rate=0.0,
           seed=None):
    """Launch ``flash_bwd_dq_f32``, ``_bf16`` or ``_fp16``: ``dq``."""
    dev, (b, h, sq, sk, d) = _bwd_inputs("bwd_dq", q, k, v, bias, do, lse,
                                         delta, seed)
    q, k, v, do = _tma_ready(q, k, v, do)
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[q.dtype]["dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, *_attn_args(h, sq, sk, d, scale, causal, dropout_rate, seed,
                           stream))
    return dq


def bwd_dkv(q, k, v, bias, do, lse, delta, scale, causal, dropout_rate=0.0,
            seed=None):
    """Launch ``flash_bwd_dkv_f32``, ``_bf16`` or ``_fp16``: ``(dk,
    dv)``."""
    dev, (b, h, sq, sk, d) = _bwd_inputs("bwd_dkv", q, k, v, bias, do, lse,
                                         delta, seed)
    q, k, v, do, lse, delta = _tma_ready(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[q.dtype]["dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b,
            *_attn_args(h, sq, sk, d, scale, causal, dropout_rate, seed,
                        stream))
    return dk, dv


def flash_bwd(q, k, v, bias, out, lse, do, scale, causal, dropout_rate=0.0,
              seed=None):
    """The backward on the card: ``delta = rowsum(dO * O)`` in f32 (a torch
    reduction, as in JAX :528), then the fused kernel when both lengths
    are at most :data:`FUSED_BWD_MAX_SEQ`, else the split dQ and dK/dV
    kernels.  Returns ``(dq, dk, dv)``."""
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, bias, do, lse, delta, scale, causal, dropout_rate, seed)
    if max(q.shape[2], k.shape[2]) <= FUSED_BWD_MAX_SEQ:
        return bwd_fused(*args)
    return (bwd_dq(*args), *bwd_dkv(*args))


def flash_dropout_mask(b, h, sq, sk, dropout_rate, seed) -> torch.Tensor:
    """The kernels' keep mask, (b, h, sq, sk) uint8 on seed's CUDA device,
    written through the kernels' own Philox function."""
    dev = _check_cuda("flash_dropout_mask", seed=seed)
    keep = torch.empty((b, h, sq, sk), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        FLASH_DROPOUT_MASK(keep.data_ptr(), b, h, sq, sk, seed.data_ptr(),
                           _drop_threshold(dropout_rate), 0, stream)
    return keep


# ==========================================================================
# the autograd front
# ==========================================================================
def attention_forward(q, k, v, bias, scale, causal, dropout_rate, seed):
    """``(out, lse)``: the plain forward for CPU tensors (its dropout mask
    :func:`seeded_keep` of ``seed``), :func:`flash_fwd` for CUDA ones.
    ``bias`` is None or (b, kv) f32."""
    if q.device.type == "cpu":
        keep = (seeded_keep((*q.shape[:3], k.shape[2]), dropout_rate, seed,
                            q.device) if dropout_rate > 0.0 else None)
        return flash_fwd_reference(q, k, v, bias, scale, causal,
                                   dropout_rate, keep)
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, bias, scale, causal, dropout_rate, seed)
    raise ValueError(f"flash_attention: no path for device {q.device}")


def attention_backward(q, k, v, bias, out, lse, do, scale, causal,
                       dropout_rate, seed):
    """``(dq, dk, dv)`` from the saved ``lse``: the plain backward for CPU
    tensors (the forward's mask), :func:`flash_bwd` for CUDA ones."""
    if q.device.type == "cpu":
        keep = (seeded_keep((*q.shape[:3], k.shape[2]), dropout_rate, seed,
                            q.device) if dropout_rate > 0.0 else None)
        return flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, dropout_rate, keep)
    return flash_bwd(q, k, v, bias, out, lse, do.contiguous(), scale, causal,
                     dropout_rate, seed)


class _FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v); the backward runs from the
    saved lse (no forward replay) and gives the padding bias zeros."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, causal, dropout_rate):
        out, lse = attention_forward(q, k, v, bias, scale, causal,
                                     dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.attrs = (scale, causal, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        scale, causal, dropout_rate = ctx.attrs
        dq, dk, dv = attention_backward(q, k, v, bias, out, lse, do, scale,
                                        causal, dropout_rate, seed)
        dbias = (torch.zeros_like(bias)
                 if bias is not None and ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    dropout_rate=0.0, dropout_seed=None):
    """Fused scaled-dot-product attention on (b, h, s, d) tensors.

    ``bias``: additive padding mask (b, kv) / (b, 1, kv) / (b, 1, 1, kv)
    or None; it is a constant (zero gradient).  ``dropout_rate > 0``
    drops attention probabilities inside the kernels; ``dropout_seed``
    (an int64 tensor of one element on q's device) keys the mask, which
    the backward regenerates.  CPU tensors take the plain versions, CUDA
    tensors the kernels (which raise on what they do not take).  q, k, v
    are float32, bfloat16 or float16 (one dtype); a bf16 or fp16 bias is
    taken as its exact f32 upcast."""
    attention_dtype("flash_attention", q)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        bias = normalize_bias(bias).float()
        if q.device.type == "cuda":
            bias = bias.contiguous()
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("flash_attention dropout requires dropout_seed")
    seed = dropout_seed if dropout_rate > 0.0 else None
    return _FlashAttention.apply(q, k, v, bias, seed, float(scale),
                                 bool(causal), float(dropout_rate))
