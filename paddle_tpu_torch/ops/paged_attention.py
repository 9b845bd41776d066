"""Ragged paged decode attention: the CUDA kernels' wrapper and their plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas_kernels.py`` ``_gqa_group``,
``paged_attention_reference``, ``_paged_decode_call`` and the
``paged_attention`` front, over f32, bf16 and int8 pools.  Layouts are
the JAX package's:

* q ``(num_seqs, q_heads, head_dim)`` f32 — one decode token per sequence;
* k_pages / v_pages ``(kv_heads, num_pages, page_size, head_dim)`` pools
  in the storage dtype (float32, bfloat16 or int8);
* k_scale / v_scale ``(kv_heads, num_pages)`` f32 per-page scales, int8
  pools only: a page dequantizes as ``code * (scale / 127)``;
* block_tables ``(num_seqs, pages_per_seq)`` int32 page ids in sequence
  order (entries past a sequence's last page hold any valid page id —
  the scheduler pads with 0 — and are masked out);
* context_lens ``(num_seqs,)`` int32 true lengths, current token included.

Query head ``h`` reads kv head ``h // (q_heads // kv_heads)`` (GQA).

Dequantization order: the Pallas kernel computes ``k * (s / 127)``
(:872-885), JAX's reference and CPU fallback ``(k * s) / 127``
(:828-829); the two differ by up to two f32 ulps per element (on a
third of all code and scale pairs).  The port
takes the kernel's order in both its CUDA kernel and its plain version,
so those two differ only in the order of their sums.

Dispatch (:func:`paged_attention`): a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel of its pool dtype
(``paged_decode_f32``, ``paged_decode_bf16``, ``paged_decode_int8``),
or raises when no kernel takes its dtype, scales or shape.  A quantized
pool is never widened to reach the f32 kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["DEFAULT_MASK_VALUE", "INT8_QMAX", "gqa_group",
           "paged_attention_reference", "paged_decode", "paged_decode_bf16",
           "paged_decode_int8", "paged_attention", "PAGED_ATTENTION",
           "PAGED_DECODE", "PAGED_DECODE_BF16", "PAGED_DECODE_INT8"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: an int8 code's largest magnitude (JAX ``paged_ops.INT8_QMAX``)
INT8_QMAX = 127.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE = [_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
#: the hand-written Hopper kernels' library (csrc/paged_attention.cu)
PAGED_ATTENTION = CudaKernel("paged_attention.cu", {
    "paddle_paged_decode_f32": [_P] * 6 + _SHAPE,
    "paddle_paged_decode_bf16": [_P] * 6 + _SHAPE,
    "paddle_paged_decode_int8": [_P] * 8 + _SHAPE,
})
#: its kernels, one per pool dtype; each ``launches`` counts every launch
#: made by :func:`paged_decode`, :func:`paged_decode_bf16` and
#: :func:`paged_decode_int8`
PAGED_DECODE = KernelFunction(PAGED_ATTENTION, "paddle_paged_decode_f32",
                              "paged_decode_f32")
PAGED_DECODE_BF16 = KernelFunction(PAGED_ATTENTION,
                                   "paddle_paged_decode_bf16",
                                   "paged_decode_bf16")
PAGED_DECODE_INT8 = KernelFunction(PAGED_ATTENTION,
                                   "paddle_paged_decode_int8",
                                   "paged_decode_int8")
#: the kernels take any head dim that is a multiple of 8 up to this (JAX's
#: kernel engages for any multiple of 8, ``pallas_kernels.py:1257``); they
#: run at the next of 32, 64, 128, 256 with the real dim as the row stride
_MAX_HEAD_DIM = 256
_MAX_GROUP = 8
#: the quantized kernels keep a sequence's page ids (and scales) in
#: shared memory: the table widths they take
_MAX_WIDTH = 8192


def gqa_group(n_heads: int, n_kv: int) -> int:
    """Query-per-KV-head group size, validated (a floor division here
    would read the wrong KV head for every query past the first group)."""
    if n_kv <= 0 or n_heads % n_kv:
        raise ValueError(
            f"paged_attention: q_heads={n_heads} is not a positive "
            f"multiple of kv_heads={n_kv} (GQA grouping)")
    return n_heads // n_kv


def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens, scale=None, k_scale=None,
                              v_scale=None):
    """Plain version: gather every table page, widen it to f32 (bf16: a
    cast; int8: ``code * (scale / 127)`` with the page's scale), mask
    positions at or past ``context_lens`` with ``DEFAULT_MASK_VALUE``,
    softmax, weight V.  Output in q's dtype."""
    n_seqs, n_heads, d = q.shape
    n_kv = k_pages.shape[0]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = gqa_group(n_heads, n_kv)
    flat = block_tables.reshape(-1).long()
    k = k_pages.index_select(1, flat)
    v = v_pages.index_select(1, flat)
    if k_scale is not None:
        ks = (k_scale.index_select(1, flat) / INT8_QMAX)[..., None, None]
        vs = (v_scale.index_select(1, flat) / INT8_QMAX)[..., None, None]
        k = k.float() * ks
        v = v.float() * vs
    elif k.dtype != torch.float32:
        k = k.float()
        v = v.float()
    k = k.reshape(n_kv, n_seqs, -1, d)
    v = v.reshape(n_kv, n_seqs, -1, d)
    k = k.repeat_interleave(group, dim=0).transpose(0, 1)   # (B, H, C, d)
    v = v.repeat_interleave(group, dim=0).transpose(0, 1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(s.shape[-1], device=s.device)[None, None, :]
    s = torch.where(pos < context_lens.to(s.device)[:, None, None], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p.to(v.dtype), v).to(q.dtype)


def _check(name, q, k_pages, v_pages, block_tables, context_lens,
           pool_dtype, scales=()):
    """The kernels' contract, checked before a launch: contiguous tensors
    on q's CUDA device, f32 q, pools of ``pool_dtype``, f32 scales of
    shape ``(kv_heads, num_pages)``, int32 tables and lengths, 16-byte
    aligned q and pools, consistent shapes, a head dim and GQA group the
    kernels are built for, and for bf16 and int8 pools a table at most
    ``_MAX_WIDTH`` pages wide."""
    n_seqs, n_heads, d = q.shape
    n_kv, n_pages, page_size, dk = k_pages.shape
    group = gqa_group(n_heads, n_kv)
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "context_lens": context_lens,
               **dict(zip(("k_scale", "v_scale"), scales))}
    dev = q.device
    for nm, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {nm} is on {t.device}, "
                             f"expected the CUDA device of q ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if q.dtype != torch.float32:
        raise ValueError(f"{name}: q is {q.dtype}; the kernels take "
                         f"float32 queries")
    for nm in ("k_pages", "v_pages"):
        if tensors[nm].dtype != pool_dtype:
            raise ValueError(f"{name}: {nm} is {tensors[nm].dtype}, "
                             f"expected {pool_dtype}")
    for nm in ("q", "k_pages", "v_pages"):
        if tensors[nm].data_ptr() % 16:
            raise ValueError(f"{name}: {nm} is not 16-byte aligned")
    for nm, t in zip(("k_scale", "v_scale"), scales):
        if t.dtype != torch.float32 or t.shape != (n_kv, n_pages):
            raise ValueError(f"{name}: {nm} must be float32 of shape "
                             f"{(n_kv, n_pages)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for nm in ("block_tables", "context_lens"):
        if tensors[nm].dtype != torch.int32:
            raise ValueError(f"{name}: {nm} must be int32")
    if (v_pages.shape != k_pages.shape or dk != d
            or block_tables.dim() != 2 or block_tables.shape[0] != n_seqs
            or context_lens.shape != (n_seqs,)):
        raise ValueError(
            f"{name}: inconsistent shapes q{tuple(q.shape)} "
            f"k{tuple(k_pages.shape)} v{tuple(v_pages.shape)} "
            f"tables{tuple(block_tables.shape)} "
            f"lens{tuple(context_lens.shape)}")
    if d % 8 or not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} is not a multiple of 8 in "
                         f"[8, {_MAX_HEAD_DIM}]")
    if group > _MAX_GROUP:
        raise ValueError(f"{name}: GQA group {group} > {_MAX_GROUP}")
    width = block_tables.shape[1]
    if n_seqs == 0 or width == 0:
        raise ValueError(f"{name}: no sequences or an empty block table")
    if pool_dtype != torch.float32 and width > _MAX_WIDTH:
        raise ValueError(f"{name}: table width {width} > {_MAX_WIDTH}")


def _launch(kernel, q, k_pages, v_pages, scales, block_tables, context_lens,
            scale):
    n_seqs, n_heads, d = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               *(t.data_ptr() for t in scales), block_tables.data_ptr(),
               context_lens.data_ptr(), out.data_ptr(), n_seqs, n_heads,
               n_kv, n_pages, page_size, block_tables.shape[1], d,
               float(scale), stream)
    return out


def paged_decode(q, k_pages, v_pages, block_tables, context_lens, scale):
    """Launch the f32 kernel on ``torch.cuda.current_stream()`` and
    return its output ``(num_seqs, q_heads, head_dim)`` f32.

    Takes f32 q and pools, int32 tables and lengths, all contiguous on one
    CUDA device; head_dim a multiple of 8 up to 256; q_heads / kv_heads
    at most 8.  Raises on anything else.  A row with context length 0
    yields zeros; a length past the table's reach is clamped to it."""
    _check("paged_decode", q, k_pages, v_pages, block_tables, context_lens,
           torch.float32)
    return _launch(PAGED_DECODE, q, k_pages, v_pages, (), block_tables,
                   context_lens, scale)


def paged_decode_bf16(q, k_pages, v_pages, block_tables, context_lens,
                      scale):
    """The bf16-page kernel: as :func:`paged_decode`, with bf16 pools
    (widened to f32 exactly in the kernel), and a table at most
    8,192 pages wide."""
    _check("paged_decode_bf16", q, k_pages, v_pages, block_tables,
           context_lens, torch.bfloat16)
    return _launch(PAGED_DECODE_BF16, q, k_pages, v_pages, (), block_tables,
                   context_lens, scale)


def paged_decode_int8(q, k_pages, v_pages, block_tables, context_lens,
                      scale, k_scale, v_scale):
    """The int8-page kernel: as :func:`paged_decode_bf16`, with int8
    pools and their f32 ``(kv_heads, num_pages)`` scale pools (a page
    dequantizes as ``code * (scale / 127)`` in the kernel)."""
    _check("paged_decode_int8", q, k_pages, v_pages, block_tables,
           context_lens, torch.int8, (k_scale, v_scale))
    return _launch(PAGED_DECODE_INT8, q, k_pages, v_pages,
                   (k_scale, v_scale), block_tables, context_lens, scale)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, k_scale=None, v_scale=None):
    """Ragged paged attention for decode (one query token per sequence).
    CPU tensors take :func:`paged_attention_reference`; CUDA tensors
    launch the kernel of the pool's dtype or raise.  ``k_scale`` /
    ``v_scale`` go with int8 pools and with no other."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: k_scale and v_scale go "
                         "together")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         context_lens, scale, k_scale,
                                         v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no path for device {q.device}")
    dt = k_pages.dtype
    if dt == torch.int8:
        if k_scale is None:
            raise ValueError("paged_attention: an int8 pool needs its "
                             "k_scale / v_scale pools")
        return paged_decode_int8(q, k_pages, v_pages, block_tables,
                                 context_lens, scale, k_scale, v_scale)
    if k_scale is not None:
        raise ValueError(f"paged_attention: scales go with int8 pools, "
                         f"not {dt}")
    if dt == torch.bfloat16:
        return paged_decode_bf16(q, k_pages, v_pages, block_tables,
                                 context_lens, scale)
    if dt == torch.float32:
        return paged_decode(q, k_pages, v_pages, block_tables, context_lens,
                            scale)
    raise ValueError(f"paged_attention: k_pages is {dt}; the kernels take "
                     f"float32, bfloat16 and int8 pools")
