"""Continuous-batching decode serving runtime (PyTorch port).

Counterpart of ``paddle_tpu/inference/serving.py`` on its default path:
f32 KV pages, greedy decoding, no tensor parallelism, no prefix cache,
no chunked prefill, no speculative decoding, ``fifo`` admission.

* **Paged KV cache** — the allocator of :mod:`.kv_cache` hands out pages
  of per-layer device pools that ``kv_cache_append`` updates in place.
* **Continuous batching** — requests are admitted at every step up to a
  token budget, finished sequences free their pages at once, and pool
  exhaustion preempts the youngest sequence back to the waiting queue
  (recompute on resume).
* **Ragged paged attention** — the decode form attends each query over
  its own pages at its true length: the hand-written CUDA kernel on the
  card, its plain PyTorch version for CPU tensors.

The JAX package builds its decoder as three Programs run by its
Executor.  Here the three forms (``reference``, ``prefill``, ``decode``)
are methods of one ``nn.Module`` holding the same parameter names
(:func:`decoder_param_specs`), and feed shapes are bucketed exactly as
there (powers of two in prompt length, batch and block-table width), so
both packages compute on the same padded shapes.
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
from ..ops.paged_ops import live_slots, paged_attention, scatter_rows
from .admission import RequestRejected, get_policy
from .kv_cache import KVCacheConfig, PagedKVCache

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
    """The pre-LN decoder LM in its three forms.

    ``reference``: full-sequence next-token logits (the oracle).
    ``prefill``: the reference body, plus every prompt position's K/V
    written into the pools.  ``decode``: one token per sequence over the
    paged pools.  Every form returns the logits of one position per
    row: ``(1, vocab)`` for the first two (the row ``last_index``
    names), ``(batch, vocab)`` for decode.

    ``kv_pools`` is a list, one ``(k_pool, v_pool)`` pair per layer, of
    ``(kv_heads, num_pages, page_size, head_dim)`` tensors; the forms
    write into them in place."""

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

    def _mlp(self, i: int, hid):
        p = f"dec_l{i}_"
        hn2 = layer_norm(hid, self._w(p + "ln2_scale"),
                         self._w(p + "ln2_bias"))
        # exact erf GELU, the op's default approximate=False
        ff = matmul(F.gelu(matmul(hn2, self._w(p + "w1"))), self._w(p + "w2"))
        return hid + ff

    def _head(self, hid):
        hf = layer_norm(hid, self.dec_lnf_scale, self.dec_lnf_bias)
        return matmul(hf, self.dec_embed, transpose_Y=True)

    def _dense(self, tokens, positions, attn_mask, last_index, kv=None):
        """The reference body on ``(1, S)`` tokens; with ``kv = (live,
        kv_pools)`` each layer's K/V also enter the pools (prefill)."""
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        hid = self._embed(tokens, positions)                  # (1, S, h)
        for i in range(cfg.num_layers):
            p = f"dec_l{i}_"
            hn = layer_norm(hid, self._w(p + "ln1_scale"),
                            self._w(p + "ln1_bias"))
            q = matmul(hn, self._w(p + "wq"))
            k = matmul(hn, self._w(p + "wk"))
            v = matmul(hn, self._w(p + "wv"))
            if kv is not None:
                live, pools = kv
                scatter_rows(*pools[i], k.reshape(-1, H, D),
                             v.reshape(-1, H, D), live)
            q4, k4, v4 = (t.reshape(t.shape[0], t.shape[1], H, D)
                          .transpose(1, 2) for t in (q, k, v))
            av = attention_reference(q4, k4, v4, attn_mask, D ** -0.5)
            ctxv = av.transpose(1, 2).reshape(av.shape[0], -1, h)
            hid = hid + matmul(ctxv, self._w(p + "wo"))
            hid = self._mlp(i, hid)
        hid = hid.reshape(-1, h)[last_index.long()]           # (1, h)
        return self._head(hid)

    def reference(self, tokens, positions, attn_mask, last_index):
        return self._dense(tokens, positions, attn_mask, last_index)

    def prefill(self, tokens, positions, attn_mask, last_index,
                slot_mapping, kv_pools):
        live = live_slots(slot_mapping, _pad_slot(kv_pools))
        return self._dense(tokens, positions, attn_mask, last_index,
                           kv=(live, kv_pools))

    def decode(self, tokens, positions, block_tables, context_lens,
               slot_mapping, kv_pools):
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        live = live_slots(slot_mapping, _pad_slot(kv_pools))
        hid = self._embed(tokens, positions)                  # (B, h)
        for i in range(cfg.num_layers):
            p = f"dec_l{i}_"
            hn = layer_norm(hid, self._w(p + "ln1_scale"),
                            self._w(p + "ln1_bias"))
            q = matmul(hn, self._w(p + "wq")).reshape(-1, H, D)
            k = matmul(hn, self._w(p + "wk")).reshape(-1, H, D)
            v = matmul(hn, self._w(p + "wv")).reshape(-1, H, D)
            k_pool, v_pool = kv_pools[i]
            scatter_rows(k_pool, v_pool, k, v, live)
            att = paged_attention(q, k_pool, v_pool, block_tables,
                                  context_lens, scale=D ** -0.5)
            hid = hid + matmul(att.reshape(-1, h), self._w(p + "wo"))
            hid = self._mlp(i, hid)
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


class _EngineCore:
    """The model, its KV pools and the allocator: one decoder on one
    device."""

    def __init__(self, cfg: DecoderConfig, weights: Dict[str, np.ndarray],
                 num_pages: int = 64, page_size: int = 16, device="cuda",
                 prefill_bucket_min: int = 16,
                 kv_dtype: Optional[str] = None, tp: Optional[int] = None,
                 prefix_cache: Optional[bool] = None, sampling=None):
        if kv_dtype not in (None, "float32"):
            _not_ported(f"kv_dtype={kv_dtype!r}")
        if tp not in (None, 1):
            _not_ported(f"tensor-parallel serving (tp={tp})")
        if prefix_cache:
            _not_ported("the KV prefix cache")
        if sampling is not None:
            _not_ported("sampled decoding")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefill_bucket_min = prefill_bucket_min
        self.kv_config = KVCacheConfig(
            num_pages=num_pages, page_size=page_size,
            num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
            num_layers=cfg.num_layers)
        self.kv = PagedKVCache(self.kv_config)
        self.model = DecoderLM(cfg, weights, self.device)
        self.kv_pools = [
            tuple(torch.zeros(self.kv_config.pool_shape(),
                              dtype=torch.float32, device=self.device)
                  for _ in range(2))
            for _ in range(cfg.num_layers)]
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
    def prefill(self, req: Request) -> Optional[int]:
        """Write the prompt's K/V into the pool and return the first
        generated token; None when the pool can't hold the prompt
        (admission backpressure, nothing changed)."""
        L = len(req.prompt)
        slots = self.kv.append_tokens(req.req_id, L)
        if slots is None:
            return None
        feed, S = self._dense_feed(req.prompt)
        slot_map = np.full(S, self.kv_config.pad_slot, np.int32)
        slot_map[:L] = slots
        logits = self.model.prefill(*feed, self._t(slot_map), self.kv_pools)
        return _greedy(logits)[0]

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
            slots = self.kv.append_tokens(rid, 1)
            if slots is None:
                raise RuntimeError("decode_batch: the caller must reserve "
                                   "a page for every sequence")
            slot_map[i] = slots[0]
            ctx[i] = self.kv.context_len(rid)
        W = _pow2_bucket(max(
            (self.kv.num_pages_of(st.req.req_id) for st in states),
            default=1))
        tables = np.zeros((Bp, W), np.int32)
        for i, st in enumerate(states):
            tables[i] = self.kv.block_table(st.req.req_id, W)
        logits = self.model.decode(
            self._t(toks), self._t(pos), self._t(tables), self._t(ctx),
            self._t(slot_map), self.kv_pools)
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
        """Bytes pinned by the K and V pools of every layer."""
        return sum(t.numel() * t.element_size()
                   for pair in self.kv_pools for t in pair)


class ServingEngine:
    """Continuous (inflight) batching over one :class:`_EngineCore`.

    Scheduling is deterministic for a fixed request sequence: ``fifo``
    admission in submit order (head-of-line blocking, no reordering),
    eviction on finish, and youngest-first preemption on pool
    exhaustion, so a seeded trace replays identically and matches the
    JAX engine's event stream.

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
        if prefill_chunk:
            _not_ported("chunked prefill")
        if spec_k or proposer is not None:
            _not_ported("speculative decoding")
        if model_dir is not None:
            self.core = _EngineCore.from_model_dir(model_dir, **core_kw)
        else:
            if cfg is None:
                raise ValueError("need cfg or model_dir")
            self.core = _EngineCore(
                cfg, weights or init_decoder_weights(cfg, seed), **core_kw)
        self.cfg = self.core.cfg
        self.kv = self.core.kv
        self.max_batch = max_batch
        self.token_budget = token_budget
        self.policy = get_policy(admission_policy)
        self.waiting: List[Request] = []
        self.running: List[_SeqState] = []   # admission order
        self.stats = {"admitted": 0, "finished": 0, "preempted": 0,
                      "decode_steps": 0, "prefill_tokens": 0,
                      "decode_tokens": 0, "max_prefill_step_tokens": 0}

    # -- API ---------------------------------------------------------------
    def submit(self, req: Request):
        _reject_unservable(req, self.cfg, self.core.kv_config)
        if len(req.prompt) + 1 > self.token_budget:
            # admission needs prompt+1 tokens inside the budget; a larger
            # prompt would block the FIFO head forever
            raise RequestRejected(
                f"request {req.req_id!r}: prompt of {len(req.prompt)} "
                f"tokens can never fit token_budget {self.token_budget}",
                "budget")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self, now: float = 0.0) -> List[StepEvent]:
        """One serving iteration: admit (in submit order, up to the token
        budget and pool capacity), prefill the admissions, preempt while
        the pool cannot grow every running sequence by one token, decode
        every running sequence once, evict finishes.  Returns this
        step's emitted tokens."""
        events: List[StepEvent] = []
        budget = self.token_budget - len(self.running)
        prefilled_this_step = 0
        # --- admission ----------------------------------------------------
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            cost = len(req.prompt) + 1
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
            st = _SeqState(req, tok)
            req.out_tokens.append(tok)
            if self.core._finished(req, tok):
                events.append(self._finish(st, tok, now))
            else:
                events.append(StepEvent(req.req_id, tok, False, now))
                self.running.append(st)
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

    def _can_grow_all(self) -> bool:
        need = sum(self.kv.pages_needed(st.req.req_id, 1)
                   for st in self.running)
        return need <= self.kv.num_free_pages

    def _admission_fits(self, req: Request) -> bool:
        """Admit only when, after the prompt's pages are taken, every
        running sequence plus the admission can still grow one token;
        otherwise this step's preemption would evict the sequence just
        prefilled (admit/preempt churn)."""
        P = len(req.prompt)
        ps = self.core.kv_config.page_size
        prompt_pages = self.kv.pages_needed(req.req_id, P)
        growth = sum(self.kv.pages_needed(st.req.req_id, 1)
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
