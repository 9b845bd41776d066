"""Paged-KV serving ops: the KV write and read paths of the serving
runtime, over f32, bf16 and int8 pools.  Counterpart of
``paddle_tpu/ops/paged_ops.py``.

* :func:`kv_cache_append` scatters new K/V rows into the pools at
  allocator-assigned flat slots.  It updates the pools (and, for int8,
  their scale pools) **in place**: this replaces the JAX package's
  buffer donation, and the pool is never copied.
* :func:`paged_attention` is the op front over
  :mod:`paddle_tpu_torch.ops.paged_attention` (plain version on the CPU,
  the CUDA kernels on the card).
* :func:`kv_dequant` widens gathered pages back to f32 for the dense
  attention of the chunk form.

A bf16 pool needs no extra state: a write casts to bf16 (round to
nearest even, as JAX's ``astype``), a read casts back.  An int8 pool
carries a per-(kv_head, page) absmax scale pool, and a write follows
JAX's ``_quant_scatter`` (:52-100) exactly:

* reset-on-open: a write at page offset 0 recycles the page (the
  allocator starts every page there), so its old scale counts as 0 and
  its stale codes are requantized by ratio 0 (zeroed);
* monotone scale: ``new_scale = max(old_scale, absmax(this write's
  values in the page))``;
* a touched page's existing codes are requantized once by
  ``round(q * old / new)`` (exact when the scale did not grow);
* quantize: ``clip(round(x / scale * 127), -127, 127)``; dequantize:
  ``q * scale / 127`` (:func:`kv_dequant`; the decode kernels and their
  plain version use the Pallas kernel's ``q * (scale / 127)``).

``torch.round`` and ``jnp.round`` both round half to even, so on the same
f32 inputs the codes and scales equal JAX's bit for bit.  These are not
Pallas kernels in the JAX package (XLA fuses its jnp ops), so they are
torch ops on both devices here.  Pad-sentinel slots (``num_pages *
page_size``) are dropped before any of it, as JAX's ``mode="drop"``
drops them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .paged_attention import INT8_QMAX, paged_attention

__all__ = ["kv_cache_append", "kv_dequant", "live_slots", "scatter_rows",
           "quant_plan", "quant_scatter_", "paged_attention", "INT8_QMAX"]


def live_slots(slot_mapping: torch.Tensor, pad_slot: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, slots)``: the positions of ``slot_mapping`` that hold a
    real pool slot, and those slots (int64).  The pad sentinel
    (``num_pages * page_size``, :attr:`KVCacheConfig.pad_slot`) marks a
    bucket-padded position whose write is dropped — the JAX scatter drops
    it with ``mode="drop"``, while torch indexing would fault on it, so
    it is filtered here first."""
    rows = torch.nonzero(slot_mapping < pad_slot).squeeze(1)
    return rows, slot_mapping[rows].long()


class QuantPlan(NamedTuple):
    """What an int8 write needs of its slots, the same for every layer
    of one step: the touched pages (sorted), each live slot's index
    among them, and per touched page 0.0 where the write opens it
    (offset 0: its old scale is dropped) and 1.0 elsewhere."""
    touched: torch.Tensor
    inverse: torch.Tensor
    keep: torch.Tensor


def quant_plan(slots: torch.Tensor, page_size: int) -> QuantPlan:
    """The :class:`QuantPlan` of live ``slots`` (int64, no sentinel)."""
    pages = slots // page_size
    touched, inverse = torch.unique(pages, sorted=True, return_inverse=True)
    keep = torch.ones(touched.shape, dtype=torch.float32, device=slots.device)
    keep.index_fill_(0, inverse[slots % page_size == 0], 0.0)
    return QuantPlan(touched, inverse, keep)


def quant_scatter_(pool: torch.Tensor, scales: torch.Tensor,
                   new: torch.Tensor, slots: torch.Tensor,
                   plan: Optional[QuantPlan] = None) -> None:
    """Write ``new`` ``(kv_heads, tokens, d)`` f32 into the int8 ``pool``
    at live flat ``slots`` (int64, no sentinel), with the per-(kv_head,
    page) ``scales``, both in place: JAX ``_quant_scatter`` with its
    untouched pages left as they are."""
    if slots.numel() == 0:
        return
    n_kv, n_pages, page_size, d = pool.shape
    if plan is None:
        plan = quant_plan(slots, page_size)
    touched, inverse, keep = plan
    old_eff = scales[:, touched] * keep
    new_abs = new.abs().amax(dim=2)                       # (n_kv, tokens)
    page_max = torch.zeros_like(old_eff).scatter_reduce_(
        1, inverse[None, :].expand(n_kv, -1), new_abs, reduce="amax")
    new_scales = torch.maximum(old_eff, page_max)
    pos = new_scales > 0
    ratio = torch.where(pos, old_eff / torch.where(pos, new_scales, 1.0),
                        1.0)
    # requant the touched pages' codes under their new scale (ratio 1:
    # unchanged; ratio 0 on reset: zeroed)
    old_pages = pool[:, touched].float()
    pool[:, touched] = torch.round(
        old_pages * ratio[..., None, None]).to(pool.dtype)
    scales[:, touched] = new_scales
    slot_scale = new_scales[:, inverse]                  # (n_kv, tokens)
    denom = torch.where(slot_scale > 0, slot_scale, 1.0)
    q = torch.clamp(torch.round(new / denom[..., None] * INT8_QMAX),
                    -INT8_QMAX, INT8_QMAX).to(pool.dtype)
    pool.view(n_kv, n_pages * page_size, d).index_copy_(1, slots, q)


def scatter_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 live: Tuple[torch.Tensor, torch.Tensor],
                 scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 plan: Optional[QuantPlan] = None) -> None:
    """Write rows ``live[0]`` of k/v ``(tokens, kv_heads, head_dim)``
    into the pools ``(kv_heads, num_pages, page_size, head_dim)`` at flat
    slots ``live[1]``, in place: cast to the pool's dtype, or quantized
    with the int8 ``scales`` pair (``plan``: their
    :func:`quant_plan`, computed once a step)."""
    rows, slots = live
    n_kv, n_pages, page_size, d = k_pool.shape
    if scales is not None:
        for pool, sc, new in ((k_pool, scales[0], k), (v_pool, scales[1], v)):
            quant_scatter_(pool, sc, new[rows].float().transpose(0, 1),
                           slots, plan)
        return
    for pool, new in ((k_pool, k), (v_pool, v)):
        flat = pool.view(n_kv, n_pages * page_size, d)
        flat.index_copy_(1, slots, new[rows].to(pool.dtype).transpose(0, 1))


def kv_cache_append(k: torch.Tensor, v: torch.Tensor,
                    slot_mapping: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> None:
    """K/V ``(num_tokens, kv_heads, head_dim)`` enter the pools at flat
    slots ``slot_mapping`` (``page_id * page_size + offset``); a slot
    equal to ``num_pages * page_size`` (the pad sentinel) is dropped.
    With ``k_scale`` / ``v_scale`` (int8 pools) the write quantizes.
    The pools and scales are updated in place; nothing is returned."""
    n_kv, n_pages, page_size, _ = k_pool.shape
    live = live_slots(slot_mapping, n_pages * page_size)
    scales = None if k_scale is None else (k_scale, v_scale)
    scatter_rows(k_pool, v_pool, k, v, live, scales)


def kv_dequant(x: torch.Tensor, scale: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Gathered pages back to f32 (JAX ``kv_dequant``): ``x * scale /
    127`` with the same gather of the scale pool (its shape a
    leading-axes prefix of x's), or a plain cast without one."""
    x = x.float()
    if scale is None:
        return x
    s = scale.float()
    s = s.reshape(tuple(s.shape) + (1,) * (x.dim() - s.dim()))
    return x * s / INT8_QMAX
