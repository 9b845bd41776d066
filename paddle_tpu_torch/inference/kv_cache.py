"""Paged KV-cache allocator for the serving runtime (host bookkeeping).

Counterpart of ``paddle_tpu/inference/kv_cache.py`` without the
prefix-cache / copy-on-write parts and without telemetry gauges.  The
device pools are laid out ``(kv_heads, num_pages, page_size, head_dim)``
per layer (the layout the paged-decode kernel reads).  Sequences own
PAGES, not a contiguous max-seq strip: appending a token allocates a page
only when the sequence's last page is full, and finishing a sequence
returns its pages at once.

Every decision is deterministic: pages are handed out FIFO (fresh ids
ascending, freed pages reused in free order), so a seeded request trace
gives the same allocation sequence as the JAX package's allocator.
Exhaustion is backpressure, not an error: :meth:`append_tokens` returns
``None``, changing nothing, when the pool cannot cover the request.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["KVCacheConfig", "PagedKVCache"]


@dataclass(frozen=True)
class KVCacheConfig:
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    num_layers: int = 1
    dtype: str = "float32"

    @property
    def pad_slot(self) -> int:
        """Flat slot id past the pool end: ``kv_cache_append`` drops
        writes to it, so bucket-padded positions are no-ops."""
        return self.num_pages * self.page_size

    def pool_shape(self):
        return (self.num_kv_heads, self.num_pages, self.page_size,
                self.head_dim)

    def scale_bytes(self) -> int:
        """Scale-pool bytes for one side of one layer: always 0, since
        only unquantized (float32) pools are ported."""
        return 0


@dataclass
class _Seq:
    pages: List[int] = field(default_factory=list)
    length: int = 0  # tokens written


class PagedKVCache:
    """Page allocator + per-sequence block tables (host side)."""

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self._free: deque = deque(range(config.num_pages))
        self._seqs: Dict[object, _Seq] = {}
        self.alloc_count = 0
        self.free_count = 0
        self.peak_pages = 0

    # -- capacity ----------------------------------------------------------
    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.config.num_pages - self.num_free_pages

    def utilization(self) -> float:
        """Fraction of pool pages currently owned by live sequences."""
        return self.pages_in_use / self.config.num_pages

    def fragmentation(self) -> float:
        """Fraction of owned slots holding no token (tail-of-page waste);
        0.0 when nothing is allocated."""
        used_pages = self.pages_in_use
        if used_pages == 0:
            return 0.0
        tokens = sum(s.length for s in self._seqs.values())
        return 1.0 - tokens / (used_pages * self.config.page_size)

    def pages_needed(self, seq_id, n_tokens: int) -> int:
        """Fresh pages required to append n_tokens to seq_id (which may
        be new)."""
        s = self._seqs.get(seq_id)
        have = len(s.pages) if s else 0
        length = s.length if s else 0
        need = -(-(length + n_tokens) // self.config.page_size)  # ceil
        return max(0, need - have)

    def can_append(self, seq_id, n_tokens: int) -> bool:
        return self.pages_needed(seq_id, n_tokens) <= self.num_free_pages

    # -- lifecycle ---------------------------------------------------------
    def append_tokens(self, seq_id, n_tokens: int) -> Optional[np.ndarray]:
        """Reserve slots for n_tokens appended to seq_id (creating it on
        first touch) and return their flat slot ids ``(n_tokens,)`` int32.
        Returns None, with no state change, when the pool can't cover
        it (admission backpressure)."""
        need = self.pages_needed(seq_id, n_tokens)
        if need > self.num_free_pages:
            return None
        s = self._seqs.setdefault(seq_id, _Seq())
        ps = self.config.page_size
        for _ in range(need):
            s.pages.append(self._free.popleft())
            self.alloc_count += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        pos = s.length + np.arange(n_tokens)
        pages = np.asarray(s.pages, np.int64)
        slots = (pages[pos // ps] * ps + pos % ps).astype(np.int32) \
            if n_tokens else np.empty(0, np.int32)
        s.length += n_tokens
        return slots

    def free_sequence(self, seq_id):
        """Return the sequence's pages to the free list (in page order)."""
        s = self._seqs.pop(seq_id, None)
        if s is None:
            return
        self._free.extend(s.pages)
        self.free_count += len(s.pages)

    # -- views for the decode step ----------------------------------------
    def context_len(self, seq_id) -> int:
        return self._seqs[seq_id].length

    def num_pages_of(self, seq_id) -> int:
        return len(self._seqs[seq_id].pages)

    def block_table(self, seq_id, width: int) -> np.ndarray:
        """The sequence's page ids padded to ``width`` with page 0 (a
        valid page; padded entries are masked by the context length)."""
        pages = self._seqs[seq_id].pages
        if len(pages) > width:
            raise ValueError(
                f"block table width {width} < {len(pages)} pages of "
                f"sequence {seq_id!r}")
        out = np.zeros(width, np.int32)
        out[: len(pages)] = pages
        return out

    def live_sequences(self) -> List:
        return list(self._seqs)

    def stats(self) -> dict:
        """The JAX allocator's keys; the prefix-cache section is all
        zeros, as there with the feature off."""
        return {
            "dtype": self.config.dtype,
            "scale_bytes": self.config.scale_bytes(),
            "effective_capacity_tokens":
                self.config.num_pages * self.config.page_size,
            "pages_total": self.config.num_pages,
            "pages_in_use": self.pages_in_use,
            "peak_pages": self.peak_pages,
            "utilization": self.utilization(),
            "fragmentation": self.fragmentation(),
            "alloc_count": self.alloc_count,
            "free_count": self.free_count,
            "prefix_cache": {
                "enabled": False, "hit_tokens": 0, "forked_pages": 0,
                "evicted_pages": 0, "shared_acquires": 0,
                "cached_pages": 0, "shared_pages": 0,
            },
        }
