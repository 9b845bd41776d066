"""Ragged paged decode attention: the CUDA kernel's wrappers and its plain
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
version; a CUDA tensor launches the kernel (``csrc/paged_attention.cu``)
for its pool dtype, or raises when the kernel does not take its dtype,
scales or shape.  One kernel serves the three page dtypes, each through
its own entry point and launch count (``paged_decode_f32``,
``paged_decode_bf16``, ``paged_decode_int8``), at any table width: it
walks each (sequence, kv head) pair's table row in spans of pages that
:func:`decode_splits` plans from shapes alone, and the last span of a
pair to finish merges the spans' states in a fixed order, in the same
launch.  A quantized pool is never widened to f32.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["DEFAULT_MASK_VALUE", "INT8_QMAX", "gqa_group", "decode_splits",
           "decode_scratch_numel", "split_plan",
           "paged_attention_reference", "paged_decode", "paged_decode_bf16",
           "paged_decode_int8", "paged_attention", "PAGED_ATTENTION",
           "PAGED_DECODE", "PAGED_DECODE_BF16", "PAGED_DECODE_INT8"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: an int8 code's largest magnitude (JAX ``paged_ops.INT8_QMAX``)
INT8_QMAX = 127.0

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the entry points' shape arguments, the split plan and the stream
_SHAPE = [_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]
#: the hand-written Hopper kernel's library (csrc/paged_attention.cu)
PAGED_ATTENTION = CudaKernel("paged_attention.cu", {
    "paddle_paged_decode_f32": [_P] * 8 + _SHAPE,
    "paddle_paged_decode_bf16": [_P] * 8 + _SHAPE,
    "paddle_paged_decode_int8": [_P] * 10 + _SHAPE,
})
#: its entry points, one per pool dtype; each ``launches`` counts every launch
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
#: the kernel takes any head dim that is a multiple of 8 up to this (JAX's
#: kernel engages for any multiple of 8, ``pallas_kernels.py:1257``); it
#: runs at the next of 32, 64, 128, 256 with the real dim as the row stride
_MAX_HEAD_DIM = 256
_MAX_GROUP = 8


#: the kernel's split of the page walk: a split takes at least this many
#: tokens, two rounds of its CTA's loads (4 warps x 16 rows) ...
_SPLIT_TOKENS = 128
#: ... and spans double until the grid is at most this many CTAs (12 an
#: SM; both chosen by timing spans of 1 to 64 pages at page 16 on the H100)
_SMS = 132   # the H100's streaming multiprocessors
_MAX_CTAS = 12 * _SMS
#: a span's page ids (and int8's two scale rows) sit in shared memory: at
#: most this many pages a span (96 KB at int8); a wider table takes more
#: splits
_MAX_SPAN = 8192
#: the grid's third dimension
_MAX_SPLITS = 65535


def decode_splits(n_seqs: int, n_kv_heads: int, width: int,
                  page_size: int) -> tuple:
    """``(n_splits, span)``: the kernel walks each (sequence, kv head)
    pair's block-table row in ``n_splits`` spans of ``span`` pages, one
    CTA each.  A span holds at least ``_SPLIT_TOKENS`` tokens, and
    doubles while the grid ``n_seqs * n_kv_heads * n_splits`` is larger
    than ``_MAX_CTAS``, up to ``_MAX_SPAN`` pages: a wider table takes
    more splits.  It depends on shapes the host holds, never on the
    context lengths, which live on the card: the launch needs no host
    sync and can be captured in a CUDA graph.  Splits that start past a
    sequence's context return at once."""
    cap = min(width, _MAX_SPAN)
    span = min(cap, -(-_SPLIT_TOKENS // page_size))
    while span < cap and n_seqs * n_kv_heads * -(-width // span) \
            > _MAX_CTAS:
        span = min(2 * span, cap)
    n_splits = -(-width // span)
    if n_splits > _MAX_SPLITS:
        raise ValueError(f"paged_decode: a table of {width} pages needs "
                         f"{n_splits} spans of {span}; the grid takes "
                         f"{_MAX_SPLITS}")
    return n_splits, span


def decode_scratch_numel(n_seqs: int, n_kv_heads: int, group: int,
                         head_dim: int, n_splits: int) -> int:
    """f32 words of the split partials a launch needs: per split of each
    (sequence, kv head) pair, ``group`` rows of ``head_dim`` accumulators
    and a max and a sum each; none for an unsplit walk."""
    if n_splits == 1:
        return 0
    return n_seqs * n_kv_heads * n_splits * group * (head_dim + 2)


def split_plan(q, k_pages, block_tables) -> tuple:
    """:func:`decode_splits` for one call, from its tensors' shapes alone
    (no tensor is read)."""
    return decode_splits(q.shape[0], k_pages.shape[0], block_tables.shape[1],
                         k_pages.shape[2])


#: {(device index, stream): int32 tickets}, zeroed once; each launch
#: leaves its tickets zero again
_TICKETS = {}
#: buffers a longer one replaced: kept, since a CUDA graph captured
#: earlier may still launch with them
_RETIRED = []


def _tickets(dev, stream: int, count: int):
    """The split walk's ticket buffer for ``stream`` on ``dev``, at least
    ``count`` long: one per stream, so that two streams never share a
    ticket.  It is made (zeroed, on that stream) outside a CUDA graph
    capture: run the decode once on the capture stream before capturing."""
    key = (dev.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode: no ticket buffer for this stream yet; run the "
                "decode once on the capture stream before capturing it in "
                "a CUDA graph")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=dev)
        _TICKETS[key] = buf
    return buf


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
    """The kernel's contract, checked before a launch: contiguous tensors
    on q's CUDA device, f32 q, pools of ``pool_dtype``, f32 scales of
    shape ``(kv_heads, num_pages)``, int32 tables and lengths, 16-byte
    aligned q and pools, consistent shapes, and a head dim and GQA group
    the kernel is built for."""
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
        raise ValueError(f"{name}: q is {q.dtype}; the kernel takes "
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


def _launch_split(kernel, q, k_pages, v_pages, scales, block_tables,
                  context_lens, scale):
    """Launch the kernel over its split walk (:func:`split_plan`), with
    its partials' scratch and its stream's tickets."""
    n_seqs, n_heads, d = q.shape
    n_kv, n_pages, page_size, _ = k_pages.shape
    n_splits, span = split_plan(q, k_pages, block_tables)
    out = torch.empty_like(q)
    numel = decode_scratch_numel(n_seqs, n_kv, n_heads // n_kv, d, n_splits)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = tickets = None
        if numel:
            part = torch.empty(numel, dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device, stream, n_seqs * n_kv)
        kernel(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               *(t.data_ptr() for t in scales), block_tables.data_ptr(),
               context_lens.data_ptr(), out.data_ptr(),
               part.data_ptr() if numel else None,
               tickets.data_ptr() if numel else None, n_seqs, n_heads,
               n_kv, n_pages, page_size, block_tables.shape[1], d,
               float(scale), n_splits, span, stream)
    return out


def paged_decode(q, k_pages, v_pages, block_tables, context_lens, scale):
    """Launch the kernel over f32 pages on ``torch.cuda.current_stream()``
    and return its output ``(num_seqs, q_heads, head_dim)`` f32.

    Takes f32 q and pools, int32 tables and lengths, all contiguous on one
    CUDA device; head_dim a multiple of 8 up to 256; q_heads / kv_heads
    at most 8; a table of any width.  Raises on anything else.  A row
    with context length 0 yields zeros; a length past the table's reach
    is clamped to it."""
    _check("paged_decode", q, k_pages, v_pages, block_tables, context_lens,
           torch.float32)
    return _launch_split(PAGED_DECODE, q, k_pages, v_pages, (),
                         block_tables, context_lens, scale)


def paged_decode_bf16(q, k_pages, v_pages, block_tables, context_lens,
                      scale):
    """The kernel over bf16 pages: as :func:`paged_decode`, with bf16
    pools (widened to f32 exactly in the kernel)."""
    _check("paged_decode_bf16", q, k_pages, v_pages, block_tables,
           context_lens, torch.bfloat16)
    return _launch_split(PAGED_DECODE_BF16, q, k_pages, v_pages, (),
                         block_tables, context_lens, scale)


def paged_decode_int8(q, k_pages, v_pages, block_tables, context_lens,
                      scale, k_scale, v_scale):
    """The kernel over int8 pages: as :func:`paged_decode_bf16`, with int8
    pools and their f32 ``(kv_heads, num_pages)`` scale pools (a page
    dequantizes as ``code * (scale / 127)`` in the kernel)."""
    _check("paged_decode_int8", q, k_pages, v_pages, block_tables,
           context_lens, torch.int8, (k_scale, v_scale))
    return _launch_split(PAGED_DECODE_INT8, q, k_pages, v_pages,
                         (k_scale, v_scale), block_tables, context_lens,
                         scale)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, k_scale=None, v_scale=None):
    """Ragged paged attention for decode (one query token per sequence).
    CPU tensors take :func:`paged_attention_reference`; CUDA tensors
    launch the kernel over the pool's dtype or raise.  ``k_scale`` /
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
    raise ValueError(f"paged_attention: k_pages is {dt}; the kernel takes "
                     f"float32, bfloat16 and int8 pools")
