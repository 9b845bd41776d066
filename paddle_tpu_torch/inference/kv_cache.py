"""Paged KV-cache allocator for the serving runtime (host bookkeeping).

Counterpart of ``paddle_tpu/inference/kv_cache.py``, whole: the prefix
cache, quantized pool sizes, speculative decoding's rollback
(:meth:`PagedKVCache.truncate_tokens`) and the telemetry gauges and
counters (``utils/telemetry.py``; every mutation republishes the pool
gauges, as the JAX allocator does).  The device pools are laid out ``(kv_heads,
num_pages, page_size, head_dim)`` per layer (the layout the paged-decode
kernels read), in the storage dtype of :attr:`KVCacheConfig.dtype`;
int8 pools carry ``(kv_heads, num_pages)`` f32 scale pools beside them.
Sequences own PAGES, not a contiguous max-seq strip: appending a token
allocates a page only when the sequence's last page is full, and
finishing a sequence returns its pages at once.

Every decision is deterministic: pages are handed out FIFO (fresh ids
ascending, freed pages reused in free order), so a seeded request trace
gives the same allocation sequence as the JAX package's allocator.
Exhaustion is backpressure, not an error: :meth:`append_tokens` returns
``None``, changing nothing, when the pool cannot cover the request.

Copy-on-write prefix caching (``FLAGS_kv_prefix_cache`` or the
``prefix_cache=`` argument; off by default, and then the allocator
behaves exactly as without it):

* every page carries a refcount; a page is owned while a live sequence
  maps it, cached when its refcount reaches zero but its content is
  still indexed, free otherwise;
* full pages are immutable and indexed under a chained sha1 digest of
  their token ids (chained through every preceding page); the partial
  tail page of a sequence is indexed too, under ``(chain digest,
  tail tokens)``;
* :meth:`match_prefix` walks a prompt through the index and
  :meth:`acquire_prefix` maps the cached pages into a new sequence at
  refcount + 1;
* the first write into a shared partial page forks it: the writer gets
  a private copy page and the fork is queued (:meth:`take_forks`) for
  the engine to copy on the device before the step that writes;
* refcount-0 cached pages are evicted only when the free list is dry,
  oldest free first, ``crc32(seed:page)`` breaking ties.
"""
from __future__ import annotations

import hashlib
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import telemetry as tm

__all__ = ["KVCacheConfig", "PagedKVCache", "KV_DTYPES"]

#: the storage dtypes a pool may have (``FLAGS_kv_cache_dtype``)
KV_DTYPES = ("float32", "bfloat16", "int8")
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


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

    @property
    def quantized(self) -> bool:
        """True when the pool needs a scale pool beside it (int8: pages
        store ``round(x / scale * 127)`` per (kv_head, page))."""
        return self.dtype == "int8"

    @property
    def itemsize(self) -> int:
        """Bytes of one stored element."""
        return _ITEMSIZE[self.dtype]

    def pool_shape(self):
        return (self.num_kv_heads, self.num_pages, self.page_size,
                self.head_dim)

    def scale_shape(self):
        """Per-(kv_head, page) absmax scale pool (int8 only)."""
        return (self.num_kv_heads, self.num_pages)

    def scale_bytes(self) -> int:
        """Scale-pool bytes for one side (K or V) of one layer; 0 for
        unquantized dtypes (no scale pool exists)."""
        if not self.quantized:
            return 0
        return int(np.prod(self.scale_shape())) * 4


@dataclass
class _Seq:
    pages: List[int] = field(default_factory=list)
    length: int = 0  # tokens written
    # prefix-cache chain state (unused when the feature is off)
    digest: bytes = b""           # chain digest after the last full page
    tail: List[int] = field(default_factory=list)  # tokens in the tail page
    tokens: List[int] = field(default_factory=list)
    opaque: bool = False          # tokens unknown: pages never indexed
    # acquired but not yet committed hit accounting (commit_prefix_hit)
    pending_hit: int = 0
    pending_shared: int = 0


def _chain(digest: bytes, tokens) -> bytes:
    """Chained page-content digest (hashlib, so the same in every
    process)."""
    h = hashlib.sha1(digest)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PagedKVCache:
    """Page allocator + per-sequence block tables (host side)."""

    def __init__(self, config: KVCacheConfig,
                 prefix_cache: Optional[bool] = None, seed: int = 0):
        self.config = config
        if prefix_cache is None:
            from ..utils.flags import flag_bool

            prefix_cache = flag_bool("FLAGS_kv_prefix_cache")
        self.prefix_cache = bool(prefix_cache)
        self.seed = int(seed)
        self._free: deque = deque(range(config.num_pages))
        self._seqs: Dict[object, _Seq] = {}
        # CoW / prefix-index state (empty and untouched when the prefix
        # cache is off)
        self._refs: Dict[int, int] = {}            # page -> refcount
        self._used: Dict[int, int] = {}            # page -> valid slots
        self._full_key: Dict[int, bytes] = {}      # page -> full digest
        self._index: Dict[bytes, int] = {}         # full digest -> page
        self._partials: Dict[bytes, Dict[int, tuple]] = {}
        self._page_partial: Dict[int, Tuple[bytes, tuple]] = {}
        self._cached_free: Dict[int, int] = {}     # page -> free generation
        self._free_gen = 0
        self._pending_forks: List[Tuple[int, int, int]] = []
        self.alloc_count = 0
        self.free_count = 0
        self.peak_pages = 0
        self.hit_tokens = 0
        self.forked_pages = 0
        self.evicted_pages = 0
        self.shared_acquires = 0

    # -- capacity ----------------------------------------------------------
    @property
    def num_free_pages(self) -> int:
        """Reclaimable pages: free plus refcount-0 cached pages."""
        return len(self._free) + len(self._cached_free)

    @property
    def pages_in_use(self) -> int:
        """Distinct pages owned by live sequences (a page shared by N
        sequences counts once)."""
        return self.config.num_pages - self.num_free_pages

    def utilization(self) -> float:
        """Fraction of pool pages currently owned by live sequences."""
        return self.pages_in_use / self.config.num_pages

    def fragmentation(self) -> float:
        """Fraction of owned slots holding no token (tail-of-page waste);
        0.0 when nothing is allocated.  Shared pages count once."""
        used_pages = self.pages_in_use
        if used_pages == 0:
            return 0.0
        if self.prefix_cache:
            tokens = sum(self._used.get(p, 0) for p in self._refs)
        else:
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

    def cow_fork_need(self, seq_id, n_tokens: int) -> int:
        """1 when appending ``n_tokens`` now would write into a shared
        partial tail page (the write forks it), else 0; always 0 with
        the prefix cache off."""
        if not self.prefix_cache or n_tokens <= 0:
            return 0
        s = self._seqs.get(seq_id)
        if s is None or not s.pages or s.length % self.config.page_size == 0:
            return 0
        return 1 if self._refs.get(s.pages[-1], 0) > 1 else 0

    def can_append(self, seq_id, n_tokens: int) -> bool:
        return (self.pages_needed(seq_id, n_tokens)
                + self.cow_fork_need(seq_id, n_tokens)
                <= self.num_free_pages)

    def _publish_gauges(self):
        """Pool state into the telemetry registry, at every allocator
        mutation, so a mid-run snapshot is never stale."""
        tm.gauge("kv_pool_pages_in_use",
                 "KV pages currently owned by live sequences").set(
                     self.pages_in_use)
        tm.gauge("kv_pool_utilization",
                 "fraction of KV pool pages in use").set(self.utilization())
        tm.gauge("kv_pool_fragmentation",
                 "fraction of owned KV slots holding no token "
                 "(tail-of-page waste)").set(self.fragmentation())
        if self.prefix_cache:
            tm.gauge("kv_prefix_cached_pages",
                     "refcount-0 pages kept as evictable prefix-cache "
                     "entries").set(len(self._cached_free))
            tm.gauge("kv_prefix_shared_pages",
                     "pages currently mapped by more than one live "
                     "sequence").set(
                         sum(1 for r in self._refs.values() if r > 1))
        if self.config.dtype != "float32":
            # published only for a quantized pool
            tm.gauge("kv_quant_scale_bytes",
                     "per-side per-layer scale-pool bytes backing the "
                     "quantized KV pool").set(self.config.scale_bytes())
            tm.gauge("kv_quant_capacity_tokens",
                     "token slots the quantized pool holds at its fixed "
                     "byte budget").set(
                         self.config.num_pages * self.config.page_size)

    # -- page pool internals ----------------------------------------------
    def _evict_key(self, page: int):
        """Seeded eviction order of refcount-0 cached pages: oldest free
        generation first, ``crc32(seed:page)`` breaking ties."""
        return (self._cached_free[page],
                zlib.crc32(f"{self.seed}:{page}".encode()))

    def _take_page(self) -> int:
        """One free page, evicting the oldest cached page when the free
        list is dry.  The caller checked capacity."""
        if self._free:
            return self._free.popleft()
        page = min(self._cached_free, key=self._evict_key)
        del self._cached_free[page]
        self._drop_index(page)
        self._used.pop(page, None)
        self.evicted_pages += 1
        tm.counter("kv_prefix_evicted_total",
                   "cached prefix pages evicted to satisfy fresh "
                   "allocations").inc()
        return page

    def _drop_index(self, page: int):
        d = self._full_key.pop(page, None)
        if d is not None and self._index.get(d) == page:
            del self._index[d]
        self._unregister_partial(page)

    def _unregister_partial(self, page: int):
        pp = self._page_partial.pop(page, None)
        if pp is not None:
            digest, _ = pp
            m = self._partials.get(digest)
            if m is not None:
                m.pop(page, None)
                if not m:
                    del self._partials[digest]

    def _register_chain(self, s: _Seq, tokens):
        """Advance the sequence's chain by ``tokens`` (just appended):
        register newly full pages and the new partial tail."""
        buf = s.tail + [int(t) for t in tokens]
        ps = self.config.page_size
        page_i = (s.length - len(buf)) // ps
        while len(buf) >= ps:
            chunk, buf = buf[:ps], buf[ps:]
            d = _chain(s.digest, chunk)
            page = s.pages[page_i]
            self._unregister_partial(page)
            if page not in self._full_key and d not in self._index:
                self._full_key[page] = d
                self._index[d] = page
            s.digest = d
            page_i += 1
        s.tail = buf
        if buf:
            page = s.pages[page_i]
            # the tail page is exclusively owned here (a write into a
            # shared page forked first), so its entry can be refreshed
            self._unregister_partial(page)
            tup = tuple(buf)
            self._partials.setdefault(s.digest, {})[page] = tup
            self._page_partial[page] = (s.digest, tup)

    # -- lifecycle ---------------------------------------------------------
    def append_tokens(self, seq_id, n_tokens: int,
                      tokens=None) -> Optional[np.ndarray]:
        """Reserve slots for n_tokens appended to seq_id (creating it on
        first touch) and return their flat slot ids ``(n_tokens,)``
        int32.  Returns None, with no state change, when the pool can't
        cover it (admission backpressure).

        ``tokens`` (prefix cache only) are the token ids appended: they
        feed the content index.  ``tokens=None`` marks the sequence
        opaque: its pages are never indexed."""
        if tokens is not None:
            tokens = list(tokens)
            if len(tokens) != n_tokens:
                raise ValueError(
                    f"append_tokens: {len(tokens)} token ids for "
                    f"{n_tokens} slots")
        need = self.pages_needed(seq_id, n_tokens)
        fork = self.cow_fork_need(seq_id, n_tokens)
        if need + fork > self.num_free_pages:
            return None
        s = self._seqs.setdefault(seq_id, _Seq())
        ps = self.config.page_size
        if self.prefix_cache:
            if tokens is None and n_tokens and not s.opaque:
                s.opaque = True
                if s.pages and s.length % ps:
                    # stale partial entry: its content will change
                    self._unregister_partial(s.pages[-1])
            if fork:
                src = s.pages[-1]
                dst = self._take_page()
                self._refs[src] -= 1
                self._refs[dst] = 1
                keep = s.length % ps
                self._used[dst] = keep
                s.pages[-1] = dst
                self._pending_forks.append((src, dst, keep))
                self.forked_pages += 1
                self.alloc_count += 1
                tm.counter("kv_prefix_forked_total",
                           "shared partial pages forked on first write "
                           "(copy-on-write)").inc()
            elif (n_tokens and s.pages and s.length % ps
                    and not s.opaque):
                # exclusive tail about to change: retire the stale entry
                self._unregister_partial(s.pages[-1])
        for _ in range(need):
            page = self._take_page()
            s.pages.append(page)
            self._refs[page] = 1
            self.alloc_count += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        if need:
            tm.counter("kv_pool_pages_alloc_total",
                       "KV pages handed out").inc(need)
        pos = s.length + np.arange(n_tokens)
        pages = np.asarray(s.pages, np.int64)
        slots = (pages[pos // ps] * ps + pos % ps).astype(np.int32) \
            if n_tokens else np.empty(0, np.int32)
        s.length += n_tokens
        if self.prefix_cache:
            # only pages covering the appended range can change
            for i in range((s.length - n_tokens) // ps, len(s.pages)):
                if s.length > i * ps:
                    self._used[s.pages[i]] = \
                        max(self._used.get(s.pages[i], 0),
                            min(ps, s.length - i * ps))
            if tokens is not None and not s.opaque and n_tokens:
                s.tokens.extend(int(t) for t in tokens)
                self._register_chain(s, tokens)
        # on every append: a within-page append changes fragmentation
        self._publish_gauges()
        return slots

    # -- prefix cache ------------------------------------------------------
    def match_prefix(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: the number of covered
        tokens and the pages holding them (full pages through the chain
        index, then at most one partial tail page whose content is a
        prefix of the rest).  Read-only."""
        if not self.prefix_cache or not len(tokens):
            return 0, []
        ps = self.config.page_size
        toks = [int(t) for t in tokens]
        digest, i, pages = b"", 0, []
        while i + ps <= len(toks):
            d = _chain(digest, toks[i:i + ps])
            page = self._index.get(d)
            if page is None:
                break
            pages.append(page)
            digest = d
            i += ps
        best = None
        for page, tup in (self._partials.get(digest) or {}).items():
            if (0 < len(tup) <= len(toks) - i
                    and tuple(toks[i:i + len(tup)]) == tup):
                key = (len(tup), -page)   # longest, then lowest page id
                if best is None or key > best[0]:
                    best = (key, page, tup)
        if best is not None:
            pages.append(best[1])
            i += len(best[2])
        return i, pages

    def acquire_prefix(self, seq_id, tokens, pages: List[int]) -> int:
        """Map a ``match_prefix`` result into a new sequence's block
        table at refcount + 1 (cached refcount-0 pages leave the
        evictable set).  ``tokens`` are the covered prompt tokens.
        Returns the hit length."""
        assert seq_id not in self._seqs, f"sequence {seq_id!r} exists"
        hit = len(tokens)
        if not hit:
            return 0
        s = _Seq()
        self._seqs[seq_id] = s
        for page in pages:
            prev = self._refs.get(page, 0)
            if prev == 0:
                self._cached_free.pop(page, None)
            else:
                s.pending_shared += 1
            self._refs[page] = prev + 1
        s.pages = list(pages)
        s.length = hit
        s.tokens = [int(t) for t in tokens]
        s.pending_hit = hit
        ps = self.config.page_size
        n_full = len(pages) if hit % ps == 0 else len(pages) - 1
        s.digest = self._full_key[pages[n_full - 1]] if n_full else b""
        s.tail = [int(t) for t in tokens[n_full * ps:]]
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        self._publish_gauges()
        return hit

    def commit_prefix_hit(self, seq_id):
        """Fold the sequence's acquired-prefix counts into the cache
        counters: called at the first prefill slice that lands, so an
        acquire released again (admission blocked) never counts."""
        s = self._seqs.get(seq_id)
        if s is None or not s.pending_hit:
            return
        hit, s.pending_hit = s.pending_hit, 0
        shared, s.pending_shared = s.pending_shared, 0
        self.hit_tokens += hit
        self.shared_acquires += shared
        tm.counter("kv_prefix_hit_tokens_total",
                   "prompt tokens served from cached prefix pages "
                   "(prefill skipped)").inc(hit)

    def _release(self, pages) -> int:
        """Drop one reference to each page; a page at refcount zero parks
        as an evictable cached page if indexed, else returns to the free
        list.  Returns the pages released."""
        released = 0
        for page in pages:
            self._refs[page] = self._refs.get(page, 1) - 1
            if self._refs[page] <= 0:
                self._refs.pop(page, None)
                released += 1
                if self.prefix_cache and (page in self._full_key
                                          or page in self._page_partial):
                    self._free_gen += 1
                    self._cached_free[page] = self._free_gen
                else:
                    self._free.append(page)
                    if self.prefix_cache:
                        self._used.pop(page, None)
        if released:
            self.free_count += released
            tm.counter("kv_pool_pages_freed_total",
                       "KV pages returned to the pool").inc(released)
        return released

    def truncate_tokens(self, seq_id, n_tokens: int):
        """Roll back the last ``n_tokens`` of ``seq_id`` (JAX
        ``truncate_tokens``): speculative decoding's rejected drafts are
        un-appended, so the next append writes their slots again.  The
        device pools are untouched (an int8 page keeps the scale the
        rejected values raised, as JAX's pools do); host-side, now-empty
        pages are popped under :meth:`free_sequence`'s refcount rules and
        the prefix chain and index rewind to the kept length from the
        sequence's token history.  A kept partial tail page owned by this
        sequence alone drops its stale index entries and re-registers its
        kept content; a shared one stays frozen (the next write forks
        it)."""
        if n_tokens <= 0:
            return
        s = self._seqs[seq_id]
        if n_tokens > s.length:
            raise ValueError(
                f"truncate_tokens: {n_tokens} > length {s.length} of "
                f"sequence {seq_id!r}")
        ps = self.config.page_size
        new_len = s.length - n_tokens
        keep = -(-new_len // ps)  # ceil
        dropped, s.pages = s.pages[keep:], s.pages[:keep]
        self._release(dropped)
        s.length = new_len
        if self.prefix_cache and not s.opaque:
            s.tokens = s.tokens[:new_len]
            n_full = new_len // ps
            digest = b""
            for i in range(n_full):
                digest = _chain(digest, s.tokens[i * ps:(i + 1) * ps])
            s.digest = digest
            s.tail = list(s.tokens[n_full * ps:])
            if s.tail and self._refs.get(s.pages[-1], 0) == 1:
                page = s.pages[-1]
                self._drop_index(page)
                tup = tuple(s.tail)
                self._partials.setdefault(s.digest, {})[page] = tup
                self._page_partial[page] = (s.digest, tup)
                self._used[page] = len(s.tail)
        elif self.prefix_cache and s.opaque:
            if s.pages and new_len % ps \
                    and self._refs.get(s.pages[-1], 0) == 1:
                self._used[s.pages[-1]] = new_len % ps
        self._publish_gauges()

    def take_forks(self) -> List[Tuple[int, int, int]]:
        """Drain pending CoW forks as ``(src_page, dst_page, used)``
        triples; the engine copies each on the device before running the
        step that writes the forked page."""
        out, self._pending_forks = self._pending_forks, []
        return out

    def free_sequence(self, seq_id):
        """Drop the sequence's page references; a page is reclaimed only
        at refcount zero (indexed pages park as evictable cached pages,
        the rest return to the free list in page order)."""
        s = self._seqs.pop(seq_id, None)
        if s is None:
            return
        if self._release(s.pages):
            self._publish_gauges()

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

    def refcount(self, page: int) -> int:
        """Live-sequence references to a page (0: free or cached)."""
        return self._refs.get(page, 0)

    def stats(self) -> dict:
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
                "enabled": self.prefix_cache,
                "hit_tokens": self.hit_tokens,
                "forked_pages": self.forked_pages,
                "evicted_pages": self.evicted_pages,
                "shared_acquires": self.shared_acquires,
                "cached_pages": len(self._cached_free),
                "shared_pages": sum(1 for r in self._refs.values()
                                    if r > 1),
            },
        }
