"""Continuous-batching decode serving runtime (PyTorch port).

Counterpart of ``paddle_tpu/inference/serving.py``: greedy decoding,
``fifo`` admission, no tensor parallelism, no speculative decoding.

* **Paged KV cache** — the allocator of :mod:`.kv_cache` hands out pages
  of per-layer device pools that ``kv_cache_append`` updates in place.
  The pools store float32 (default), bfloat16 or int8
  (``kv_dtype`` / ``FLAGS_kv_cache_dtype``); int8 pools carry per-page
  scale pools, and ``kv_budget_mb`` sizes the pool from a byte budget,
  so bf16 and int8 buy 2x and 4x the pages of f32.
* **Prefix cache** (``prefix_cache`` / ``FLAGS_kv_prefix_cache``) —
  a prompt's already-cached pages map into its block table at refcount
  + 1 and are not prefilled again; the first write into a shared
  partial page forks it (the page and, for int8, its scales are copied
  verbatim on the device before the step that writes).
* **Chunked prefill** (``prefill_chunk`` /
  ``FLAGS_prefill_chunk_tokens``) — a long prompt prefills one slice per
  step, so decode never stalls behind it.
* **Continuous batching** — requests are admitted at every step up to a
  token budget, finished sequences free their pages at once, and pool
  exhaustion preempts the youngest sequence back to the waiting queue
  (recompute on resume).
* **Ragged paged attention** — the decode form attends each query over
  its own pages at its true length: the hand-written CUDA kernel of the
  pool's dtype on the card, their plain PyTorch version for CPU
  tensors.

The JAX package builds its decoder as Programs run by its Executor.
Here the forms (``reference``, ``prefill``, ``decode``, ``chunk``) are
methods of one ``nn.Module`` holding the same parameter names
(:func:`decoder_param_specs`), and feed shapes are bucketed exactly as
there (powers of two in prompt length, batch and block-table width), so
both packages compute on the same padded shapes.  Left out: the JAX
engine's telemetry, tracing and chaos hooks.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..framework.place import resolve_device
from ..ops.decoder_ops import (attention_reference, layer_norm,
                               lookup_table_v2, matmul)
from ..ops.paged_ops import (kv_dequant, live_slots, paged_attention,
                             quant_plan, scatter_rows)
from ..utils.flags import get_flag
from .admission import RequestRejected, get_policy
from .kv_cache import KV_DTYPES, KVCacheConfig, PagedKVCache

__all__ = [
    "DecoderConfig", "DecoderLM", "Request", "StepEvent", "ServingEngine",
    "RequestRejected", "decoder_param_specs", "init_decoder_weights",
    "load_decoder_config", "load_decoder_weights", "NEG_INF",
]

NEG_INF = -1e9  # additive causal-mask value (finite: no NaN in padded rows)


# ==========================================================================
# Model description
# ==========================================================================
@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 128
    hidden: int = 64
    num_heads: int = 4
    num_layers: int = 2
    ffn_hidden: int = 0          # 0 -> 4 * hidden
    max_seq_len: int = 256
    eos_id: int = -1             # -1: no EOS, run to max_new_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def ffn(self) -> int:
        return self.ffn_hidden or 4 * self.hidden

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "vocab_size", "hidden", "num_heads", "num_layers",
            "ffn_hidden", "max_seq_len", "eos_id")}

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderConfig":
        return cls(**{k: d[k] for k in cls().to_dict() if k in d})


def decoder_param_specs(cfg: DecoderConfig) -> Dict[str, tuple]:
    """name -> shape for every weight (shared by all three forms)."""
    h, f = cfg.hidden, cfg.ffn
    specs = {
        "dec_embed": (cfg.vocab_size, h),
        "dec_pos_embed": (cfg.max_seq_len, h),
        "dec_lnf_scale": (h,), "dec_lnf_bias": (h,),
    }
    for i in range(cfg.num_layers):
        p = f"dec_l{i}_"
        specs.update({
            p + "ln1_scale": (h,), p + "ln1_bias": (h,),
            p + "wq": (h, h), p + "wk": (h, h), p + "wv": (h, h),
            p + "wo": (h, h),
            p + "ln2_scale": (h,), p + "ln2_bias": (h,),
            p + "w1": (h, f), p + "w2": (f, h),
        })
    return specs


def init_decoder_weights(cfg: DecoderConfig, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Seeded random weights, bit for bit those of the JAX package."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in decoder_param_specs(cfg).items():
        if name.endswith("_scale"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("_bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[-1])) \
                .astype(np.float32)
    return out


def load_decoder_config(model_dir: str) -> DecoderConfig:
    with open(os.path.join(model_dir, "decoder.json")) as f:
        return DecoderConfig.from_dict(json.load(f))


def load_decoder_weights(model_dir: str
                         ) -> Tuple[DecoderConfig, Dict[str, np.ndarray]]:
    """Read a decoder exported by the JAX package's ``export_decoder``:
    ``decoder.json`` for the config and one ``<name>.npy`` per weight
    (``/`` in a name stored as ``__``).  Only the weights are read; the
    serialized Program beside them is not needed."""
    cfg = load_decoder_config(model_dir)
    weights = {}
    for name in decoder_param_specs(cfg):
        path = os.path.join(model_dir, name.replace("/", "__") + ".npy")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"weight file missing for {name!r}: {path}")
        weights[name] = np.load(path, allow_pickle=False)
    return cfg, weights


class DecoderLM(nn.Module):
    """The pre-LN decoder LM in its four forms.

    ``reference``: full-sequence next-token logits (the oracle).
    ``prefill``: the reference body, plus every prompt position's K/V
    written into the pools.  ``decode``: one token per sequence over the
    paged pools.  ``chunk``: a slice of one prompt at an offset, its K/V
    written first, then attending over the pool pages gathered through
    its block table (the prefix-hit suffix and chunked prefill).  Every
    form returns the logits of one position per row: ``(1, vocab)`` for
    the dense forms (the row ``last_index`` names), ``(batch, vocab)``
    for decode.

    ``kv_pools`` is a list, one ``(k_pool, v_pool)`` pair per layer, of
    ``(kv_heads, num_pages, page_size, head_dim)`` tensors in the storage
    dtype; ``kv_scales`` the int8 pools' ``(k_scale, v_scale)`` pairs of
    ``(kv_heads, num_pages)`` f32, or None.  The forms write into both in
    place."""

    def __init__(self, cfg: DecoderConfig, weights: Dict[str, np.ndarray],
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        for name, shape in decoder_param_specs(cfg).items():
            if name not in weights:
                raise KeyError(f"decoder weight {name!r} missing")
            arr = np.asarray(weights[name], np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"decoder weight {name!r} has shape "
                                 f"{arr.shape}, expected {tuple(shape)}")
            self.register_parameter(name, nn.Parameter(
                torch.tensor(arr, device=device), requires_grad=False))

    def _w(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _embed(self, tokens, positions):
        return (lookup_table_v2(self.dec_embed, tokens)
                + lookup_table_v2(self.dec_pos_embed, positions))

    def _qkv(self, i: int, hid):
        p = f"dec_l{i}_"
        hn = layer_norm(hid, self._w(p + "ln1_scale"),
                        self._w(p + "ln1_bias"))
        return (matmul(hn, self._w(p + "wq")), matmul(hn, self._w(p + "wk")),
                matmul(hn, self._w(p + "wv")))

    def _out_mlp(self, i: int, hid, ctxv):
        p = f"dec_l{i}_"
        hid = hid + matmul(ctxv, self._w(p + "wo"))
        hn2 = layer_norm(hid, self._w(p + "ln2_scale"),
                         self._w(p + "ln2_bias"))
        # exact erf GELU, the op's default approximate=False
        ff = matmul(F.gelu(matmul(hn2, self._w(p + "w1"))), self._w(p + "w2"))
        return hid + ff

    def _head(self, hid):
        hf = layer_norm(hid, self.dec_lnf_scale, self.dec_lnf_bias)
        return matmul(hf, self.dec_embed, transpose_Y=True)

    def _last(self, hid, last_index):
        return self._head(hid.reshape(-1, self.cfg.hidden)[last_index.long()])

    def _writer(self, slot_mapping, kv_pools, kv_scales):
        """``write(i, k, v)``: layer i's K/V rows into its pools at the
        step's live slots (the sentinel filtered, and int8's page plan
        computed, once for all layers)."""
        live = live_slots(slot_mapping, _pad_slot(kv_pools))
        plan = None if kv_scales is None else \
            quant_plan(live[1], kv_pools[0][0].shape[2])
        H, D = self.cfg.num_heads, self.cfg.head_dim

        def write(i, k, v):
            scatter_rows(*kv_pools[i], k.reshape(-1, H, D),
                         v.reshape(-1, H, D), live,
                         None if kv_scales is None else kv_scales[i], plan)
        return write

    def _dense(self, tokens, positions, attn_mask, last_index, write=None):
        """The reference body on ``(1, S)`` tokens; with ``write`` each
        layer's K/V also enter the pools (prefill)."""
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        hid = self._embed(tokens, positions)                  # (1, S, h)
        for i in range(cfg.num_layers):
            q, k, v = self._qkv(i, hid)
            if write is not None:
                write(i, k, v)
            q4, k4, v4 = (t.reshape(t.shape[0], t.shape[1], H, D)
                          .transpose(1, 2) for t in (q, k, v))
            av = attention_reference(q4, k4, v4, attn_mask, D ** -0.5)
            hid = self._out_mlp(i, hid, av.transpose(1, 2)
                                .reshape(av.shape[0], -1, h))
        return self._last(hid, last_index)

    def reference(self, tokens, positions, attn_mask, last_index):
        return self._dense(tokens, positions, attn_mask, last_index)

    def prefill(self, tokens, positions, attn_mask, last_index,
                slot_mapping, kv_pools, kv_scales=None):
        return self._dense(tokens, positions, attn_mask, last_index,
                           self._writer(slot_mapping, kv_pools, kv_scales))

    def chunk(self, tokens, positions, attn_mask, last_index, slot_mapping,
              chunk_tables, kv_pools, kv_scales=None):
        """JAX ``build_decoder_program(mode="chunk")``: the slice's K/V
        enter the pool first; then it attends over the pool window its
        block table ``chunk_tables`` ``(W,)`` gathers, widened to f32
        (``_kv_gather_deq``: a bf16 cast, or int8 codes times their
        page's gathered scale / 127), under the host-built causal and
        context mask ``(1, 1, S, W * page_size)``.  So the slice's own
        positions are read back from the pool after quantization."""
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        write = self._writer(slot_mapping, kv_pools, kv_scales)
        tables = chunk_tables.long()
        hid = self._embed(tokens, positions)                  # (1, S, h)
        for i in range(cfg.num_layers):
            q, k, v = self._qkv(i, hid)
            write(i, k, v)
            q4 = q.reshape(1, -1, H, D).transpose(1, 2)       # (1, H, S, D)
            gathered = []
            for j, pool in enumerate(kv_pools[i]):
                g = pool.index_select(1, tables)              # (H, W, ps, D)
                if pool.dtype != torch.float32:
                    g = kv_dequant(g, None if kv_scales is None else
                                   kv_scales[i][j].index_select(1, tables))
                gathered.append(g.reshape(1, H, -1, D))       # (1, H, C, D)
            av = attention_reference(q4, *gathered, attn_mask, D ** -0.5)
            hid = self._out_mlp(i, hid, av.transpose(1, 2).reshape(1, -1, h))
        return self._last(hid, last_index)

    def decode(self, tokens, positions, block_tables, context_lens,
               slot_mapping, kv_pools, kv_scales=None):
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        write = self._writer(slot_mapping, kv_pools, kv_scales)
        hid = self._embed(tokens, positions)                  # (B, h)
        for i in range(cfg.num_layers):
            q, k, v = self._qkv(i, hid)
            write(i, k, v)
            scales = () if kv_scales is None else kv_scales[i]
            att = paged_attention(q.reshape(-1, H, D), *kv_pools[i],
                                  block_tables, context_lens, D ** -0.5,
                                  *scales)
            hid = self._out_mlp(i, hid, att.reshape(-1, h))
        return self._head(hid)


def _greedy(logits: torch.Tensor) -> List[int]:
    """The arg_max head: each row's largest logit (the first on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).tolist()


def _pad_slot(kv_pools) -> int:
    _, n_pages, page_size, _ = kv_pools[0][0].shape
    return n_pages * page_size


# ==========================================================================
# Requests / events
# ==========================================================================
@dataclass
class Request:
    req_id: object
    prompt: List[int]
    max_new_tokens: int
    arrival_time: float = 0.0
    # filled by the engine
    out_tokens: List[int] = field(default_factory=list)
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    _prefix_hit: int = field(default=0, repr=False)


@dataclass(frozen=True)
class StepEvent:
    req_id: object
    token: int
    finished: bool
    time: float


@dataclass
class _SeqState:
    req: Request
    last_token: int = 0


def _pow2_bucket(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


def _causal_mask(s: int) -> np.ndarray:
    """``(1, 1, s, s)`` additive mask: ``NEG_INF`` above the diagonal."""
    return np.triu(np.full((s, s), NEG_INF, np.float32), k=1)[None, None]


def _worst_case_pages(req: Request, kv_config: KVCacheConfig) -> int:
    total = len(req.prompt) + req.max_new_tokens
    return -(-total // kv_config.page_size)


def _reject_unservable(req: Request, cfg: DecoderConfig,
                       kv_config: KVCacheConfig):
    """Submit-time gate: a request that cannot complete even with the
    whole pool to itself would stall the scheduler.  Raises
    :class:`RequestRejected` (a ValueError) with the reason code."""
    total = len(req.prompt) + req.max_new_tokens
    if total > cfg.max_seq_len:
        raise RequestRejected(
            f"request {req.req_id!r}: prompt+max_new_tokens "
            f"{len(req.prompt)}+{req.max_new_tokens} exceeds "
            f"max_seq_len {cfg.max_seq_len}", "max_seq_len")
    if _worst_case_pages(req, kv_config) > kv_config.num_pages:
        raise RequestRejected(
            f"request {req.req_id!r} needs more KV pages than the "
            f"whole pool holds ({total} tokens, "
            f"{kv_config.num_pages} pages of {kv_config.page_size})",
            "pool")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (see ROADMAP.md)")


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


@dataclass
class _PrefillJob:
    """In-flight prefill of one request: ``pos`` tokens are already in
    the pool (prefix-cache hit plus completed slices); ``first_token`` is
    set when the final slice ran."""
    req: Request
    pos: int = 0
    hit: int = 0
    chunks: int = 0
    first_token: Optional[int] = None


class _EngineCore:
    """The model, its KV pools and the allocator: one decoder on one
    device.

    ``kv_dtype`` (None: ``FLAGS_kv_cache_dtype``) is the pools' storage
    dtype; ``kv_budget_mb`` > 0 sizes the pool from a byte budget instead
    of ``num_pages`` (JAX's formula: the scale pools are charged on top,
    not in the divisor, so int8 buys exactly 4x the f32 pages);
    ``prefix_cache`` (None: ``FLAGS_kv_prefix_cache``) and
    ``prefix_seed`` configure the allocator's prefix cache."""

    def __init__(self, cfg: DecoderConfig, weights: Dict[str, np.ndarray],
                 num_pages: int = 64, page_size: int = 16, device="cuda",
                 prefill_bucket_min: int = 16,
                 kv_dtype: Optional[str] = None, kv_budget_mb: float = 0.0,
                 tp: Optional[int] = None,
                 prefix_cache: Optional[bool] = None, prefix_seed: int = 0,
                 sampling=None):
        if tp not in (None, 1):
            _not_ported(f"tensor-parallel serving (tp={tp})")
        if sampling is not None:
            _not_ported("sampled decoding")
        if kv_dtype is None:
            kv_dtype = str(get_flag("FLAGS_kv_cache_dtype") or "float32")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"bad kv_cache_dtype {kv_dtype!r}")
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.prefill_bucket_min = prefill_bucket_min
        if kv_budget_mb and kv_budget_mb > 0:
            page_bytes = (2 * cfg.num_layers * cfg.num_heads * page_size
                          * cfg.head_dim * _TORCH_DTYPES[kv_dtype].itemsize)
            num_pages = max(1, int(kv_budget_mb * (1 << 20)) // page_bytes)
        self.kv_budget_mb = float(kv_budget_mb or 0.0)
        self.kv_config = KVCacheConfig(
            num_pages=num_pages, page_size=page_size,
            num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
            num_layers=cfg.num_layers, dtype=kv_dtype)
        self.kv = PagedKVCache(self.kv_config, prefix_cache=prefix_cache,
                               seed=prefix_seed)
        self.model = DecoderLM(cfg, weights, self.device)
        self.kv_pools = [
            tuple(torch.zeros(self.kv_config.pool_shape(),
                              dtype=_TORCH_DTYPES[kv_dtype],
                              device=self.device)
                  for _ in range(2))
            for _ in range(cfg.num_layers)]
        # int8: the per-(kv_head, page) scales, 0 marking a page never
        # written (kv_cache_append raises them monotonically)
        self.kv_scales = [
            tuple(torch.zeros(self.kv_config.scale_shape(),
                              dtype=torch.float32, device=self.device)
                  for _ in range(2))
            for _ in range(cfg.num_layers)] \
            if self.kv_config.quantized else None
        self._masks: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_model_dir(cls, model_dir: str, **kw) -> "_EngineCore":
        cfg, weights = load_decoder_weights(model_dir)
        return cls(cfg, weights, **kw)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _mask(self, s: int) -> torch.Tensor:
        # memoized per bucket: prefill and the oracle re-feed the same
        # handful of power-of-two sizes
        m = self._masks.get(s)
        if m is None:
            m = self._masks[s] = self._t(_causal_mask(s))
        return m

    def _dense_feed(self, seq: Sequence[int]):
        """Bucketed ``(tokens, positions, mask, last_index)`` for one
        sequence, and the bucket length S."""
        L = len(seq)
        S = _pow2_bucket(L, self.prefill_bucket_min, None)
        toks = np.zeros((1, S), np.int32)
        toks[0, :L] = seq
        pos = np.minimum(np.arange(S, dtype=np.int32),
                         self.cfg.max_seq_len - 1)[None]
        return (self._t(toks), self._t(pos), self._mask(S),
                self._t(np.array([L - 1], np.int32))), S

    # -- model steps -------------------------------------------------------
    def _apply_forks(self):
        """Replay pending CoW forks as device page copies in every
        layer's K and V pool, and for int8 their scales, verbatim (a
        fork never requantizes).  Runs before the step whose appends
        caused them."""
        forks = self.kv.take_forks()
        if not forks:
            return
        tensors = [t for pair in self.kv_pools for t in pair]
        if self.kv_scales is not None:
            tensors += [t for pair in self.kv_scales for t in pair]
        for src, dst, _used in forks:
            for t in tensors:
                t[:, dst] = t[:, src]

    def start_prefill(self, req: Request) -> _PrefillJob:
        """Open a prefill job: with the prefix cache on, map every cached
        page of the prompt into the request's block table (at most
        prompt - 1 tokens: the last position is always computed, it
        gives the first output token)."""
        job = _PrefillJob(req)
        req._prefix_hit = 0
        if self.kv.prefix_cache and len(req.prompt) > 1:
            hit, pages = self.kv.match_prefix(req.prompt[:-1])
            if hit:
                self.kv.acquire_prefix(req.req_id, req.prompt[:hit], pages)
                job.pos = job.hit = hit
                req._prefix_hit = hit
        return job

    def advance_prefill(self, job: _PrefillJob,
                        max_tokens: Optional[int] = None) -> Optional[bool]:
        """Prefill up to ``max_tokens`` of the rest of the prompt (all of
        it when None).  Returns True when the prompt is fully prefilled
        (``job.first_token`` set), False when slices remain, None on
        pool backpressure (nothing appended)."""
        req = job.req
        L = len(req.prompt)
        remaining = L - job.pos
        n = remaining if max_tokens is None else \
            min(int(max_tokens), remaining)
        chunk = req.prompt[job.pos:job.pos + n]
        slots = self.kv.append_tokens(req.req_id, n, tokens=chunk)
        if slots is None:
            return None
        if job.chunks == 0:
            # the first slice that lands confirms the hit
            self.kv.commit_prefix_hit(req.req_id)
        self._apply_forks()
        final = job.pos + n == L
        if job.pos == 0 and final:
            # cold whole-prompt prefill: the prefill form
            feed, S = self._dense_feed(req.prompt)
            slot_map = np.full(S, self.kv_config.pad_slot, np.int32)
            slot_map[:L] = slots
            logits = self.model.prefill(*feed, self._t(slot_map),
                                        self.kv_pools, self.kv_scales)
            tok = _greedy(logits)[0]
        else:
            tok = self._run_chunk(req, job.pos, chunk, slots)
        job.pos += n
        job.chunks += 1
        if final:
            job.first_token = tok
            return True
        return False

    def _run_chunk(self, req: Request, pos: int, chunk, slots) -> int:
        """One prompt slice at offset ``pos`` through the chunk form,
        bucketed in slice length and block-table width."""
        n = len(chunk)
        S = _pow2_bucket(n, self.prefill_bucket_min, None)
        toks = np.zeros((1, S), np.int32)
        toks[0, :n] = chunk
        posf = np.minimum(pos + np.arange(S, dtype=np.int32),
                          self.cfg.max_seq_len - 1)[None]
        W = _pow2_bucket(self.kv.num_pages_of(req.req_id))
        C = W * self.kv_config.page_size
        tables = self.kv.block_table(req.req_id, W)
        slot_map = np.full(S, self.kv_config.pad_slot, np.int32)
        slot_map[:n] = slots
        # causal + context mask over the gathered pool window: slice
        # position pos+i attends pool slots 0..pos+i (block-table order
        # is token order); tail garbage, padded table entries and padded
        # slice rows are masked
        cols = np.arange(C, dtype=np.int64)[None, :]
        rows = np.arange(S, dtype=np.int64)[:, None]
        mask = np.where(cols <= pos + rows, 0.0, NEG_INF) \
            .astype(np.float32)[None, None]
        logits = self.model.chunk(
            self._t(toks), self._t(posf), self._t(mask),
            self._t(np.array([n - 1], np.int32)), self._t(slot_map),
            self._t(tables), self.kv_pools, self.kv_scales)
        return _greedy(logits)[0]

    def abort_prefill(self, job: _PrefillJob):
        """Release a job's pages (backpressure mid-prefill); with the
        prefix cache on, its completed slices stay cached."""
        self.kv.free_sequence(job.req.req_id)

    def prefill(self, req: Request) -> Optional[int]:
        """Write the prompt's K/V into the pool and return the first
        generated token; None when the pool can't hold the prompt
        (admission backpressure: nothing changed, or with the prefix
        cache on, the acquired prefix pages released again)."""
        job = self.start_prefill(req)
        if self.advance_prefill(job) is None:
            if job.hit:
                self.kv.free_sequence(req.req_id)
            return None
        return job.first_token

    def decode_batch(self, states: Sequence[_SeqState]) -> List[int]:
        """One continuous decode step for ``states`` (each sequence's
        pending token enters the pool, then attends at its true length).
        The caller guarantees page capacity.  Batch and block-table
        width are bucketed to powers of two; pad rows carry context
        length 1, page 0 and the pad slot, so they are computed
        harmlessly and write nothing."""
        B = len(states)
        Bp = _pow2_bucket(max(B, 1))
        toks = np.zeros(Bp, np.int32)
        pos = np.zeros(Bp, np.int32)
        slot_map = np.full(Bp, self.kv_config.pad_slot, np.int32)
        ctx = np.ones(Bp, np.int32)
        for i, st in enumerate(states):
            rid = st.req.req_id
            toks[i] = st.last_token
            pos[i] = min(self.kv.context_len(rid), self.cfg.max_seq_len - 1)
            slots = self.kv.append_tokens(rid, 1, tokens=[st.last_token])
            if slots is None:
                raise RuntimeError("decode_batch: the caller must reserve "
                                   "a page for every sequence")
            slot_map[i] = slots[0]
            ctx[i] = self.kv.context_len(rid)
        self._apply_forks()
        W = _pow2_bucket(max(
            (self.kv.num_pages_of(st.req.req_id) for st in states),
            default=1))
        tables = np.zeros((Bp, W), np.int32)
        for i, st in enumerate(states):
            tables[i] = self.kv.block_table(st.req.req_id, W)
        logits = self.model.decode(
            self._t(toks), self._t(pos), self._t(tables), self._t(ctx),
            self._t(slot_map), self.kv_pools, self.kv_scales)
        return _greedy(logits)[:B]

    def reference_logits(self, seq: Sequence[int]) -> torch.Tensor:
        """Next-token logits ``(vocab,)`` of the reference form after
        ``seq`` (a full recompute)."""
        feed, _ = self._dense_feed(seq)
        return self.model.reference(*feed)[0]

    def reference_next_token(self, seq: Sequence[int]) -> int:
        """One full-recompute next-token step of the reference form (the
        one-at-a-time oracle)."""
        return _greedy(self.reference_logits(seq)[None])[0]

    def greedy_reference(self, prompt: Sequence[int],
                         max_new_tokens: int) -> List[int]:
        seq = list(prompt)
        outs: List[int] = []
        for _ in range(max_new_tokens):
            t = self.reference_next_token(seq)
            outs.append(t)
            seq.append(t)
            if t == self.cfg.eos_id:
                break
        return outs

    def _finished(self, req: Request, token: int) -> bool:
        return (len(req.out_tokens) >= req.max_new_tokens
                or token == self.cfg.eos_id)

    def kv_pool_resident_bytes(self) -> int:
        """Bytes pinned by the K and V pools of every layer, and the
        int8 scale pools."""
        per_pool = (int(np.prod(self.kv_config.pool_shape()))
                    * self.kv_config.itemsize + self.kv_config.scale_bytes())
        return 2 * self.cfg.num_layers * per_pool

    def memory_stats(self) -> dict:
        """JAX ``memory_stats``'s keys: fixed pool residency, the
        allocator's peak pages in bytes, weight bytes, and the device's
        measured peak (``torch.cuda.max_memory_allocated`` on the card,
        ``"unavailable"`` elsewhere)."""
        ps = self.kv.stats()
        token_bytes = (2 * self.cfg.num_layers * self.cfg.num_heads
                       * self.cfg.head_dim * self.kv_config.itemsize)
        weights = sum(p.numel() * p.element_size()
                      for p in self.model.parameters())
        if self.device.type == "cuda":
            measured = {"peak_bytes": int(torch.cuda.max_memory_allocated(
                self.device)), "source": "torch.cuda.max_memory_allocated"}
        else:
            measured = {"peak_bytes": 0, "source": "unavailable"}
        return {
            "kv_pool_resident_bytes": self.kv_pool_resident_bytes(),
            "kv_pool_dtype": self.kv_config.dtype,
            "kv_pool_scale_bytes": int(
                2 * self.cfg.num_layers * self.kv_config.scale_bytes()),
            "kv_pool_capacity_tokens": int(ps["effective_capacity_tokens"]),
            "kv_pool_peak_token_bytes": int(
                ps["peak_pages"] * self.kv_config.page_size * token_bytes),
            "kv_pool_peak_pages": int(ps["peak_pages"]),
            "prefix_cache": ps["prefix_cache"],
            "weight_bytes": int(weights),
            "tp": 1,
            "measured": measured,
        }


class ServingEngine:
    """Continuous (inflight) batching over one :class:`_EngineCore`.

    Scheduling is deterministic for a fixed request sequence: ``fifo``
    admission in submit order (head-of-line blocking, no reordering, no
    shedding), eviction on finish, and youngest-first preemption on pool
    exhaustion, so a seeded trace replays identically and matches the
    JAX engine's event stream.  With the prefix cache on, a hit shrinks
    the admission's cost to the computed suffix; with ``prefill_chunk``
    (None: ``FLAGS_prefill_chunk_tokens``) a long remainder prefills one
    slice per step ahead of new admissions while decode goes on.

    ``device`` defaults to ``"cuda"``; without a CUDA device the engine
    raises unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: Optional[DecoderConfig] = None,
                 weights: Optional[Dict[str, np.ndarray]] = None,
                 model_dir: Optional[str] = None,
                 max_batch: int = 8, token_budget: int = 256,
                 seed: int = 0, admission_policy=None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None, proposer=None,
                 **core_kw):
        if spec_k or proposer is not None:
            _not_ported("speculative decoding")
        self.policy = get_policy(admission_policy)
        if model_dir is not None:
            self.core = _EngineCore.from_model_dir(model_dir, **core_kw)
        else:
            if cfg is None:
                raise ValueError("need cfg or model_dir")
            self.core = _EngineCore(
                cfg, weights or init_decoder_weights(cfg, seed), **core_kw)
        self.cfg = self.core.cfg
        self.kv = self.core.kv
        self.kv_dtype = self.core.kv_dtype
        self.max_batch = max_batch
        self.token_budget = token_budget
        if prefill_chunk is None:
            prefill_chunk = int(get_flag("FLAGS_prefill_chunk_tokens") or 0)
        self.prefill_chunk = max(int(prefill_chunk), 0)
        self._prefill_job: Optional[_PrefillJob] = None
        self.waiting: List[Request] = []
        self.running: List[_SeqState] = []   # admission order
        self.stats = {"admitted": 0, "finished": 0, "preempted": 0,
                      "shed": 0, "decode_steps": 0, "prefill_tokens": 0,
                      "decode_tokens": 0, "prefill_hit_tokens": 0,
                      "prefill_chunks": 0, "max_prefill_step_tokens": 0}

    # -- API ---------------------------------------------------------------
    def submit(self, req: Request):
        _reject_unservable(req, self.cfg, self.core.kv_config)
        if len(req.prompt) + 1 > self.token_budget and not self.prefill_chunk:
            # admission needs prompt+1 tokens inside the budget; a larger
            # prompt would block the FIFO head forever, unless chunked
            # prefill serves it one budget-sized slice per step
            raise RequestRejected(
                f"request {req.req_id!r}: prompt of {len(req.prompt)} "
                f"tokens can never fit token_budget {self.token_budget}",
                "budget")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self._prefill_job is not None)

    def step(self, now: float = 0.0) -> List[StepEvent]:
        """One serving iteration: the in-flight chunked prefill's next
        slice, then admission (in submit order, up to the token budget
        and pool capacity) and the admissions' prefill, preemption while
        the pool cannot grow every running sequence by one token, one
        decode of every running sequence, eviction of finishes.  Returns
        this step's emitted tokens."""
        events: List[StepEvent] = []
        budget = self.token_budget - len(self.running)
        prefilled_this_step = 0
        # --- in-flight chunked prefill: one budget-sized slice per step,
        # ahead of new admissions (it reached the head first) -------------
        if self._prefill_job is not None:
            job = self._prefill_job
            n = min(self.prefill_chunk, len(job.req.prompt) - job.pos,
                    budget)
            if n > 0:
                r = self.core.advance_prefill(job, n)
                if r is None:
                    # the pool can no longer cover the slice: release it
                    # (the prefix cache keeps finished slices) and requeue
                    self.core.abort_prefill(job)
                    self.waiting.insert(0, job.req)
                    self._prefill_job = None
                else:
                    # the completing slice also emits the first token
                    budget -= n + (1 if r else 0)
                    prefilled_this_step += n
                    self._count_prefill(n, job)
                    if r:
                        self._prefill_job = None
                        self._admit_job(job, now, events)
        while (self.waiting and len(self.running) < self.max_batch
               and self._prefill_job is None):
            req = self.waiting[0]
            cost = len(req.prompt) + 1
            if not self.prefill_chunk and not self.kv.prefix_cache:
                # both features off: the plain admission path
                if cost > budget or not self._admission_fits(req):
                    break
                tok = self.core.prefill(req)
                if tok is None:
                    break  # pool backpressure: retry next step
                self.waiting.pop(0)
                budget -= cost
                prefilled_this_step += len(req.prompt)
                if req.admitted_at is None:
                    req.admitted_at = now
                self.stats["admitted"] += 1
                self.stats["prefill_tokens"] += len(req.prompt)
                self._start(_SeqState(req, tok), tok, now, events)
                continue
            # a prefix-cache hit shrinks the admission to the computed
            # suffix (estimated read-only first), and a long suffix goes
            # through the chunked path
            est_hit = self.kv.match_prefix(req.prompt[:-1])[0] \
                if self.kv.prefix_cache and len(req.prompt) > 1 else 0
            if not self._admission_fits(req, len(req.prompt) - est_hit):
                break
            job = self.core.start_prefill(req)
            remaining = len(req.prompt) - job.pos
            # chunk when the remainder exceeds the chunk or cannot fit
            # this step's budget whole
            if self.prefill_chunk and (remaining > self.prefill_chunk
                                       or remaining + 1 > budget):
                n = min(self.prefill_chunk, remaining, budget)
                if n <= 0:
                    self.core.abort_prefill(job)
                    break  # wait for budget headroom
                r = self.core.advance_prefill(job, n)
                if r is None:
                    self.core.abort_prefill(job)
                    break
                self.waiting.pop(0)
                budget -= n + (1 if r else 0)   # +1: first output token
                prefilled_this_step += n
                self._count_prefill(n, job)
                if r:
                    self._admit_job(job, now, events)
                    continue
                # one chunked prefill in flight at a time
                self._prefill_job = job
            else:
                if remaining + 1 > budget:
                    self.core.abort_prefill(job)
                    break
                r = self.core.advance_prefill(job)
                if r is None:
                    self.core.abort_prefill(job)
                    break
                self.waiting.pop(0)
                budget -= remaining + 1
                prefilled_this_step += remaining
                self._count_prefill(remaining, job)
                self._admit_job(job, now, events)
        # --- preemption: decoding adds one token per running seq ----------
        while self.running and not self._can_grow_all():
            victim = self.running.pop(self.policy.victim_index(self.running))
            self.kv.free_sequence(victim.req.req_id)
            victim.req.out_tokens = []
            victim.req.preemptions += 1
            self.waiting.insert(0, victim.req)
            self.stats["preempted"] += 1
        # --- decode -------------------------------------------------------
        if self.running:
            toks = self.core.decode_batch(self.running)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(self.running)
            still = []
            for st, tok in zip(self.running, toks):
                st.req.out_tokens.append(tok)
                st.last_token = tok
                if self.core._finished(st.req, tok):
                    events.append(self._finish(st, tok, now))
                else:
                    events.append(StepEvent(st.req.req_id, tok, False, now))
                    still.append(st)
            self.running = still
        self.stats["max_prefill_step_tokens"] = max(
            self.stats["max_prefill_step_tokens"], prefilled_this_step)
        return events

    def _start(self, st: _SeqState, tok: int, now: float, events: list):
        """An admitted sequence's first token: finished at once, or
        running from here."""
        st.req.out_tokens.append(tok)
        if self.core._finished(st.req, tok):
            events.append(self._finish(st, tok, now))
        else:
            events.append(StepEvent(st.req.req_id, tok, False, now))
            self.running.append(st)

    def _count_prefill(self, n: int, job: _PrefillJob):
        """``prefill_tokens`` counts computed tokens (hits excluded);
        a job's hit counts once, at its first slice."""
        self.stats["prefill_tokens"] += n
        self.stats["prefill_chunks"] += 1
        if job.chunks == 1 and job.hit:
            self.stats["prefill_hit_tokens"] += job.hit

    def _admit_job(self, job: _PrefillJob, now: float, events: list):
        """A completed prefill job becomes a running sequence."""
        req = job.req
        if req.admitted_at is None:
            req.admitted_at = now
        self.stats["admitted"] += 1
        self._start(_SeqState(req, job.first_token), job.first_token, now,
                    events)

    def _can_grow_all(self) -> bool:
        need = sum(self.kv.pages_needed(st.req.req_id, 1)
                   + self.kv.cow_fork_need(st.req.req_id, 1)
                   for st in self.running)
        return need <= self.kv.num_free_pages

    def _admission_fits(self, req: Request,
                        n_tokens: Optional[int] = None) -> bool:
        """Admit only when, after the prompt's pages (and any CoW fork)
        are taken, every running sequence plus the admission can still
        grow one token; otherwise this step's preemption would evict the
        sequence just prefilled (admit/preempt churn).  ``n_tokens``
        narrows the check to the computed suffix after a prefix hit."""
        P = len(req.prompt)
        L = P if n_tokens is None else n_tokens
        ps = self.core.kv_config.page_size
        prompt_pages = self.kv.pages_needed(req.req_id, L) \
            + self.kv.cow_fork_need(req.req_id, L)
        growth = sum(self.kv.pages_needed(st.req.req_id, 1)
                     + self.kv.cow_fork_need(st.req.req_id, 1)
                     for st in self.running)
        if req.max_new_tokens > 1:
            # the admission's own one-token headroom; a request that
            # finishes at prefill never decodes and needs none
            growth += -(-(P + 1) // ps) - -(-P // ps)
        return prompt_pages + growth <= self.kv.num_free_pages

    def _finish(self, st: _SeqState, tok: int, now: float) -> StepEvent:
        self.kv.free_sequence(st.req.req_id)
        st.req.finished_at = now
        self.stats["finished"] += 1
        return StepEvent(st.req.req_id, tok, True, now)

    def run_to_completion(self, now: float = 0.0) -> List[StepEvent]:
        events = []
        while self.has_work():
            events.extend(self.step(now))
        return events

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int) -> List[List[int]]:
        """Submit every prompt, drain, return each prompt's generated
        tokens in submit order."""
        reqs = [Request(i, list(p), max_new_tokens)
                for i, p in enumerate(prompts)]
        for r in reqs:
            self.submit(r)
        self.run_to_completion()
        return [r.out_tokens for r in reqs]
