"""Ragged paged decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas_kernels.py`` ``_gqa_group``,
``paged_attention_reference``, ``_paged_decode_call`` and the
``paged_attention`` front (f32 pools).  Layouts are the JAX package's:

* q ``(num_seqs, q_heads, head_dim)`` — one decode token per sequence;
* k_pages / v_pages ``(kv_heads, num_pages, page_size, head_dim)`` pools;
* block_tables ``(num_seqs, pages_per_seq)`` int32 page ids in sequence
  order (entries past a sequence's last page hold any valid page id —
  the scheduler pads with 0 — and are masked out);
* context_lens ``(num_seqs,)`` int32 true lengths, current token included.

Query head ``h`` reads kv head ``h // (q_heads // kv_heads)`` (GQA).

Dispatch (:func:`paged_attention`): a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel, or raises when the kernel
does not take its dtype or shape.  There is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["DEFAULT_MASK_VALUE", "gqa_group", "paged_attention_reference",
           "paged_decode", "paged_attention", "PAGED_ATTENTION",
           "PAGED_DECODE"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the hand-written Hopper kernel's library (csrc/paged_attention.cu)
PAGED_ATTENTION = CudaKernel("paged_attention.cu", {
    "paddle_paged_decode_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, ctypes.c_float, _P],
})
#: its kernel; ``launches`` counts every launch made by :func:`paged_decode`
PAGED_DECODE = KernelFunction(PAGED_ATTENTION, "paddle_paged_decode_f32",
                              "paged_decode_f32")
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP = 8


def gqa_group(n_heads: int, n_kv: int) -> int:
    """Query-per-KV-head group size, validated (a floor division here
    would read the wrong KV head for every query past the first group)."""
    if n_kv <= 0 or n_heads % n_kv:
        raise ValueError(
            f"paged_attention: q_heads={n_heads} is not a positive "
            f"multiple of kv_heads={n_kv} (GQA grouping)")
    return n_heads // n_kv


def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens, scale=None):
    """Plain version: gather every table page, mask positions at or past
    ``context_lens`` with ``DEFAULT_MASK_VALUE``, softmax, weight V.
    Output in q's dtype."""
    n_seqs, n_heads, d = q.shape
    n_kv = k_pages.shape[0]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = gqa_group(n_heads, n_kv)
    flat = block_tables.reshape(-1).long()
    k = k_pages.index_select(1, flat).reshape(n_kv, n_seqs, -1, d)
    v = v_pages.index_select(1, flat).reshape(n_kv, n_seqs, -1, d)
    k = k.repeat_interleave(group, dim=0).transpose(0, 1)   # (B, H, C, d)
    v = v.repeat_interleave(group, dim=0).transpose(0, 1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(s.shape[-1], device=s.device)[None, None, :]
    s = torch.where(pos < context_lens.to(s.device)[:, None, None], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p.to(v.dtype), v).to(q.dtype)


def paged_decode(q, k_pages, v_pages, block_tables, context_lens, scale):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()`` and
    return its output ``(num_seqs, q_heads, head_dim)`` f32.

    Takes f32 q and pools, int32 tables and lengths, all contiguous on one
    CUDA device; head_dim in {32, 64, 128, 256}; q_heads / kv_heads at
    most 8.  Raises on anything else.  A row with context length 0
    yields zeros; a length past the table's reach is clamped to it."""
    n_seqs, n_heads, d = q.shape
    n_kv, n_pages, page_size, dk = k_pages.shape
    group = gqa_group(n_heads, n_kv)
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "context_lens": context_lens}
    dev = q.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"paged_decode: {name} is on {t.device}, "
                             f"expected the CUDA device of q ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"paged_decode: {name} is "
                             f"{tensors[name].dtype}; the kernel takes "
                             f"float32 (bf16/int8 pools are not ported)")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} is not 16-byte aligned")
    for name in ("block_tables", "context_lens"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"paged_decode: {name} must be int32")
    if (v_pages.shape != k_pages.shape or dk != d
            or block_tables.dim() != 2 or block_tables.shape[0] != n_seqs
            or context_lens.shape != (n_seqs,)):
        raise ValueError(
            f"paged_decode: inconsistent shapes q{tuple(q.shape)} "
            f"k{tuple(k_pages.shape)} v{tuple(v_pages.shape)} "
            f"tables{tuple(block_tables.shape)} "
            f"lens{tuple(context_lens.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {d} not in {_HEAD_DIMS}")
    if group > _MAX_GROUP:
        raise ValueError(f"paged_decode: GQA group {group} > {_MAX_GROUP}")
    if n_seqs == 0 or block_tables.shape[1] == 0:
        raise ValueError("paged_decode: no sequences or an empty block "
                         "table")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        PAGED_DECODE(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_tables.data_ptr(), context_lens.data_ptr(),
                     out.data_ptr(), n_seqs, n_heads, n_kv, n_pages,
                     page_size, block_tables.shape[1], d, float(scale),
                     stream)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Ragged paged attention for decode (one query token per sequence).
    CPU tensors take :func:`paged_attention_reference`; CUDA tensors
    launch the kernel (:func:`paged_decode`) or raise."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         context_lens, scale)
    if q.device.type == "cuda":
        return paged_decode(q, k_pages, v_pages, block_tables, context_lens,
                            scale)
    raise ValueError(f"paged_attention: no path for device {q.device}")
