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
torch ops on both devices here.

Every write has static shapes (:func:`write_plan`), as JAX's scatters
with ``mode="drop"`` do, so one code runs eagerly and inside a CUDA
graph: nothing is read back to the host.  A pad-sentinel row
(``num_pages * page_size``, :attr:`KVCacheConfig.pad_slot`) does not
drop out of the index list; it writes again what the first live row
writes, at the same slot, so its write is that row's and cannot race
with it.  A step whose every row is a pad writes the last slot's own
content back to it.  For int8, the page opens and the per-page maxima
scatter into vectors one page longer than the pool, whose last entry is
a sink, so the scales of untouched pages keep their bits; the opens are
made once a step, with the rest of the plan.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .paged_attention import INT8_QMAX, paged_attention

__all__ = ["kv_cache_append", "kv_dequant", "write_plan", "WritePlan",
           "scatter_rows", "quant_scatter_", "paged_attention", "INT8_QMAX"]


class WritePlan(NamedTuple):
    """The static-shape index plan of one step's KV write, the same for
    every layer and pool (:func:`write_plan`): per row, the row whose
    value it writes (``src``: itself if live, else the first live row),
    the flat slot it writes (``slot``: always inside the pool) and
    whether that is a live value (``live``: False for every row of an
    all-pad step, whose rows write back what ``slot`` holds; None when a
    live row is known, so every row is).  For int8 pools also, per row:
    the page of its slot (``page``), the page whose scale it raises
    (``scale_page``: the sink page ``num_pages`` in an all-pad step), and
    0.0 where this step opens that page (a write at page offset 0 drops
    its old scale) and 1.0 elsewhere (``keep``).  Where the caller gave
    the touched pages (``touched``: every page of a live row, repeats and
    untouched pages allowed), the write requantizes each of them once,
    with its own ``touched_keep``, instead of once per row."""
    src: torch.Tensor
    slot: torch.Tensor
    live: Optional[torch.Tensor]
    page: Optional[torch.Tensor] = None
    scale_page: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    touched: Optional[torch.Tensor] = None
    touched_keep: Optional[torch.Tensor] = None


def write_plan(slot_mapping: torch.Tensor, pad_slot: int, page_size: int,
               quantized: bool = False, live_row: Optional[int] = None,
               touched: Optional[torch.Tensor] = None) -> WritePlan:
    """The :class:`WritePlan` of ``slot_mapping`` (flat slots, the pad
    sentinel ``pad_slot`` marking a dropped row), by device ops only;
    ``quantized``: with the int8 pools' page fields.  ``live_row``: a row
    the caller knows to be live (the serving forms' row 0), which the pad
    rows then repeat, so no all-pad step is possible and the write reads
    nothing back.  ``touched``: for int8, a list of pages that holds every
    live row's page (built on the host, as prefill's slot map is; its
    length is the caller's), so that a write of many rows per page
    requantizes each page once.  A page listed twice, or listed and not
    written, is requantized by ratio 1 and keeps its bits."""
    slots = slot_mapping.long()
    live = slots < pad_slot
    rows = torch.arange(slots.numel(), device=slots.device)
    if live_row is not None:
        src = torch.where(live, rows, live_row)
        slot = slots[src]
        live_src = None
    else:
        first = live.to(torch.uint8).argmax()   # 0 when no row is live
        src = torch.where(live, rows, first)
        live_src = live[src]
        slot = torch.clamp(slots[src], max=pad_slot - 1)
    if not quantized:
        return WritePlan(src, slot, live_src)
    n_pages = pad_slot // page_size
    page = slot // page_size
    opens = (slot % page_size == 0).to(torch.float32)
    scale_page = page
    if live_src is not None:
        scale_page = torch.where(live_src, page, n_pages)
        opens = opens * live_src
    opened = torch.zeros(n_pages + 1, dtype=torch.float32,
                         device=slots.device).scatter_reduce_(
        0, scale_page, opens, reduce="amax")
    if touched is not None:
        touched = touched.long()
        return WritePlan(src, slot, live_src, page, scale_page,
                         1.0 - opened[scale_page], touched,
                         1.0 - opened[touched])
    return WritePlan(src, slot, live_src, page, scale_page,
                     1.0 - opened[scale_page])


def _values(flat: torch.Tensor, plan: WritePlan, q: torch.Tensor
            ) -> torch.Tensor:
    """``q`` ``(kv_heads, tokens, d)`` where the plan's rows are live, and
    ``flat``'s own rows at their slots where none is."""
    if plan.live is None:
        return q
    return torch.where(plan.live[None, :, None], q, flat[:, plan.slot])


def quant_scatter_(pool: torch.Tensor, scales: torch.Tensor,
                   new: torch.Tensor, slots: torch.Tensor,
                   plan: Optional[WritePlan] = None) -> None:
    """Write ``new`` ``(kv_heads, tokens, d)`` f32 into the int8 ``pool``
    at flat ``slots`` (the pad sentinel ``num_pages * page_size`` among
    them is dropped), with the per-(kv_head, page) ``scales``, both in
    place: JAX ``_quant_scatter``.  ``plan``: the slots' quantized
    :func:`write_plan`, when it is already made."""
    if slots.numel() == 0:
        return
    n_kv, n_pages, page_size, d = pool.shape
    if plan is None:
        plan = write_plan(slots, n_pages * page_size, page_size, True)
    new = new[:, plan.src]
    # reset-on-open and the monotone scale, per unit: a row's page, or
    # each page of the caller's touched list.  The page's maximum of
    # this step's values scatters into a row one page longer than the
    # pool (its last entry the sink of an all-pad step, whose rows read
    # back their real page's 0), and each unit reads its page's back, so
    # every unit of one page computes the same new scale; untouched
    # pages are not read
    page, scale_page = plan.page, plan.scale_page
    per_row = plan.touched is None
    unit, keep = ((page, plan.keep) if per_row else
                  (plan.touched, plan.touched_keep))
    old_eff = scales[:, unit] * keep                      # (n_kv, units)
    page_max = torch.zeros(n_kv, n_pages + 1, dtype=torch.float32,
                           device=pool.device).scatter_reduce_(
        1, scale_page[None, :].expand(n_kv, -1), new.abs().amax(dim=2),
        reduce="amax")[:, unit]
    new_scale = torch.maximum(old_eff, page_max)
    pos = new_scale > 0
    ratio = torch.where(pos, old_eff / torch.where(pos, new_scale, 1.0),
                        1.0)
    # requant the written pages' codes under their new scale (ratio 1:
    # unchanged; ratio 0 on reset: zeroed); units of one page read the
    # same codes and write the same requant and scale
    pool[:, unit] = torch.round(
        pool[:, unit].float() * ratio[..., None, None]).to(pool.dtype)
    scales[:, unit] = new_scale
    if not per_row:     # each row's page's new scale
        new_scale = scales[:, page]
    denom = torch.where(new_scale > 0, new_scale, 1.0)
    q = torch.clamp(torch.round(new / denom[..., None] * INT8_QMAX),
                    -INT8_QMAX, INT8_QMAX).to(pool.dtype)
    flat = pool.view(n_kv, n_pages * page_size, d)
    flat.index_copy_(1, plan.slot, _values(flat, plan, q))


def scatter_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, plan: WritePlan,
                 scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> None:
    """Write k/v ``(tokens, kv_heads, head_dim)`` into the pools
    ``(kv_heads, num_pages, page_size, head_dim)`` by ``plan`` (the
    step's :func:`write_plan`, quantized for int8 pools), in place: cast
    to the pool's dtype, or quantized with the int8 ``scales`` pair."""
    n_kv, n_pages, page_size, d = k_pool.shape
    if scales is not None:
        for pool, sc, new in ((k_pool, scales[0], k), (v_pool, scales[1], v)):
            quant_scatter_(pool, sc, new.float().transpose(0, 1),
                           plan.slot, plan)
        return
    for pool, new in ((k_pool, k), (v_pool, v)):
        flat = pool.view(n_kv, n_pages * page_size, d)
        q = new[plan.src].to(pool.dtype).transpose(0, 1)
        flat.index_copy_(1, plan.slot, _values(flat, plan, q))


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
    if slot_mapping.numel() == 0:
        return
    plan = write_plan(slot_mapping, n_pages * page_size, page_size,
                      k_scale is not None)
    scales = None if k_scale is None else (k_scale, v_scale)
    scatter_rows(k_pool, v_pool, k, v, plan, scales)


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
