"""Paged-KV serving ops (f32 pools): the decode path of the serving
runtime.  Counterpart of ``paddle_tpu/ops/paged_ops.py``.

* :func:`kv_cache_append` scatters this step's new K/V rows into the
  pools at allocator-assigned flat slots.  It updates the pools **in
  place** (this replaces the JAX package's buffer donation: the pool is
  never copied).
* :func:`paged_attention` is the op front over
  :mod:`paddle_tpu_torch.ops.paged_attention` (plain version on the CPU,
  the CUDA kernel on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .paged_attention import paged_attention

__all__ = ["kv_cache_append", "live_slots", "scatter_rows", "paged_attention"]


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


def scatter_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 live: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """Write rows ``live[0]`` of k/v ``(tokens, kv_heads, head_dim)``
    into the pools ``(kv_heads, num_pages, page_size, head_dim)`` at flat
    slots ``live[1]``, in place."""
    rows, slots = live
    n_kv, n_pages, page_size, d = k_pool.shape
    for pool, new in ((k_pool, k), (v_pool, v)):
        flat = pool.view(n_kv, n_pages * page_size, d)
        flat.index_copy_(1, slots, new[rows].to(pool.dtype).transpose(0, 1))


def kv_cache_append(k: torch.Tensor, v: torch.Tensor,
                    slot_mapping: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor) -> None:
    """K/V ``(num_tokens, kv_heads, head_dim)`` enter the pools at flat
    slots ``slot_mapping`` (``page_id * page_size + offset``); a slot
    equal to ``num_pages * page_size`` (the pad sentinel) is dropped.
    The pools are updated in place; nothing is returned."""
    n_kv, n_pages, page_size, _ = k_pool.shape
    scatter_rows(k_pool, v_pool, k, v,
                 live_slots(slot_mapping, n_pages * page_size))
