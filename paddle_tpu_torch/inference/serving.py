"""Continuous-batching decode serving runtime (PyTorch port).

Counterpart of ``paddle_tpu/inference/serving.py`` at tp=1: greedy,
sampled and speculative decoding, ``fifo`` and ``slo_aware`` admission,
the static-batching baseline, and the engine's telemetry, request
tracing and chaos hooks.

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
  exhaustion preempts a sequence back to the waiting queue (recompute
  on resume).  The admission policy (``admission_policy`` /
  ``FLAGS_admission_policy``, :mod:`.admission`) orders the queue, sheds
  requests whose SLO can no longer be met, and picks the victim.
* **Sampled decoding** (``sampling`` / ``FLAGS_sample_temperature``) —
  every form ends in ``ops/sampling_ops.sample_token`` under per-row RNG
  lanes computed on the host (``spec_decode.rng_lane``); greedy engines
  end in argmax exactly as before.
* **Speculative decoding** (``spec_k`` / ``FLAGS_spec_decode_k``,
  ``proposer``) — a proposer drafts up to ``spec_k`` tokens per sequence,
  the verify form scores every draft position of the batch in one call,
  the agreeing prefix and one bonus token are emitted, and the rejected
  drafts are truncated back out of the pool.
* **Ragged paged attention** — the decode form attends each query over
  its own pages at its true length: the hand-written CUDA kernel of the
  pool's dtype on the card, their plain PyTorch version for CPU
  tensors.
* **The captured decode step** (``FLAGS_cuda_step_session``, ``auto``:
  on for a CUDA engine; JAX jits the decode form once per bucket) — a
  bucket's first decode step runs eagerly on the engine's capture
  stream, its second records the decode form and its head (argmax, or
  the sampled head with the lanes in the bucket's input block) into a
  CUDA graph, and from then on a step copies the bucket's inputs from
  pinned host memory in one copy, replays, and reads the tokens back in
  one small copy.  The KV write has static shapes
  (``ops/paged_ops.write_plan``), so the pools update inside the graph.
  The prefix cache's forks run eagerly ahead of the replay; prefill,
  chunked prefill and verify run eagerly.
* **Observability** — ``utils/telemetry.py`` counters, gauges and
  histograms (``FLAGS_telemetry``), the SLO tracker, request span trees
  (``utils/tracing.py``, ``FLAGS_trace_requests``), serving chaos faults
  (``utils/chaos.py``, ``FLAGS_chaos``) and host profiler events
  (``profiler.py``).  All of it is host-side and off the captured graph.

The JAX package builds its decoder as Programs run by its Executor.
Here the forms (``reference``, ``prefill``, ``decode``, ``chunk``,
``verify``) are methods of one ``nn.Module`` holding the same parameter
names (:func:`decoder_param_specs`), and feed shapes are bucketed
exactly as there (powers of two in prompt length, batch, chunk length
and block-table width), so both packages compute on the same padded
shapes.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..framework.cuda_graph import GraphSet, StepCaptureError
from ..framework.place import resolve_device
from ..ops.decoder_ops import (attention_reference, layer_norm,
                               lookup_table_v2, matmul)
from ..ops.paged_ops import (kv_dequant, paged_attention, scatter_rows,
                             write_plan)
from ..ops.sampling_ops import sample_token
from ..profiler import RecordEvent, instant_event, is_profiler_enabled
from ..utils import chaos
from ..utils import telemetry as tm
from ..utils import tracing
from ..utils.flags import cuda_step_session_enabled, flag_float, get_flag
from .admission import RequestRejected, get_policy
from .kv_cache import KV_DTYPES, KVCacheConfig, PagedKVCache
from .spec_decode import (NGramProposer, Proposer, SamplingParams,
                          get_proposer, rng_lane)

__all__ = [
    "DecoderConfig", "DecoderLM", "Request", "StepEvent", "ServingEngine",
    "StaticBatchingEngine", "RequestRejected", "SamplingParams",
    "decoder_param_specs", "init_decoder_weights", "load_decoder_config",
    "load_decoder_weights", "emit_head", "NEG_INF",
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
    """The pre-LN decoder LM in its five forms.

    ``reference``: full-sequence next-token logits (the oracle).
    ``prefill``: the reference body, plus every prompt position's K/V
    written into the pools.  ``decode``: one token per sequence over the
    paged pools.  ``chunk``: a slice of one prompt at an offset, its K/V
    written first, then attending over the pool pages gathered through
    its block table (the prefix-hit suffix and chunked prefill).
    ``verify``: the chunk form batched over sequences, every position
    scored (speculative decoding's accept-prefix check).  The dense
    forms return the logits of the row ``last_index`` names, ``(1,
    vocab)``; decode ``(batch, vocab)``; verify ``(batch * S, vocab)``.
    :func:`emit_head` turns logits into tokens.

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

    def _writer(self, slot_mapping, kv_pools, kv_scales, touched=None):
        """``write(i, k, v)``: layer i's K/V rows into its pools at the
        step's slots (the static-shape write plan, the pad sentinel's rows
        dropped, made once for all layers; row 0 is always live: every
        form writes at least one token, padding comes after).
        ``touched``: int8 only, the pages the slots fall in (prefill and
        chunk forms: :func:`touched_pages`), requantized once each."""
        plan = write_plan(slot_mapping, _pad_slot(kv_pools),
                          kv_pools[0][0].shape[2], kv_scales is not None,
                          live_row=0, touched=touched)
        H, D = self.cfg.num_heads, self.cfg.head_dim

        def write(i, k, v):
            scatter_rows(*kv_pools[i], k.reshape(-1, H, D),
                         v.reshape(-1, H, D), plan,
                         None if kv_scales is None else kv_scales[i])
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
                slot_mapping, kv_pools, kv_scales=None, touched=None):
        return self._dense(tokens, positions, attn_mask, last_index,
                           self._writer(slot_mapping, kv_pools, kv_scales,
                                        touched))

    def _pool_window(self, i: int, tables: torch.Tensor, kv_pools,
                     kv_scales):
        """Layer i's K and V over the pool windows the ``(B, W)`` block
        ``tables`` gather, widened to f32 (JAX ``_kv_gather_deq``: a bf16
        cast, or int8 codes times their page's gathered scale / 127):
        ``(B, H, W * page_size, D)`` each."""
        H, D = self.cfg.num_heads, self.cfg.head_dim
        out = []
        for j, pool in enumerate(kv_pools[i]):
            g = pool[:, tables]                           # (H, B, W, ps, D)
            if pool.dtype != torch.float32:
                g = kv_dequant(g, None if kv_scales is None else
                               kv_scales[i][j][:, tables])
            out.append(g.transpose(0, 1).reshape(tables.shape[0], H, -1, D))
        return out

    def _windowed(self, tokens, positions, attn_mask, slot_mapping, tables,
                  kv_pools, kv_scales, touched):
        """The chunk and verify body on ``(B, S)`` tokens: each layer's
        K/V enter the pools first, then every position attends over its
        row's pool window under the host-built causal and context mask
        ``(B, 1, S, W * page_size)``, so a slice reads its own positions
        back from the pool after quantization.  Returns the hidden rows
        ``(B, S, hidden)``."""
        cfg = self.cfg
        H, D, h = cfg.num_heads, cfg.head_dim, cfg.hidden
        write = self._writer(slot_mapping, kv_pools, kv_scales, touched)
        tables = tables.long()
        B, S = tokens.shape
        hid = self._embed(tokens, positions)                  # (B, S, h)
        for i in range(cfg.num_layers):
            q, k, v = self._qkv(i, hid)
            write(i, k, v)
            q4 = q.reshape(B, S, H, D).transpose(1, 2)        # (B, H, S, D)
            av = attention_reference(
                q4, *self._pool_window(i, tables, kv_pools, kv_scales),
                attn_mask, D ** -0.5)
            hid = self._out_mlp(i, hid, av.transpose(1, 2).reshape(B, S, h))
        return hid

    def chunk(self, tokens, positions, attn_mask, last_index, slot_mapping,
              chunk_tables, kv_pools, kv_scales=None, touched=None):
        """JAX ``build_decoder_program(mode="chunk")``: the slice's K/V
        enter the pool first; then it attends over the pool window its
        block table ``chunk_tables`` ``(W,)`` gathers, under the mask
        ``(1, 1, S, W * page_size)``."""
        return self._last(self._windowed(
            tokens, positions, attn_mask, slot_mapping, chunk_tables[None],
            kv_pools, kv_scales, touched), last_index)

    def verify(self, tokens, positions, attn_mask, slot_mapping,
               verify_tables, kv_pools, kv_scales=None):
        """JAX ``build_decoder_program(mode="verify")``: the chunk form
        over ``(B, S)`` rows, one sequence's ``[last_token, draft...]``
        each, with ``(B, W)`` block tables and the ``(B * S,)`` slot map;
        the logits of every position, ``(B * S, vocab)``: row ``b * S +
        j`` is the model's next token after row b's position j."""
        hid = self._windowed(tokens, positions, attn_mask, slot_mapping,
                             verify_tables, kv_pools, kv_scales, None)
        return self._head(hid.reshape(-1, self.cfg.hidden))

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


def touched_pages(slots, S: int, page_size: int) -> np.ndarray:
    """The pages that a slice's ``slots`` (one sequence's, in token order)
    fall in, as an int32 array of one length per bucket length ``S``
    (``ceil(S / page_size) + 1``: the most pages S consecutive tokens can
    touch), padded with the first page: the int8 write requantizes each
    listed page once, and a repeat keeps its bits."""
    pages = np.unique(np.asarray(slots, np.int64) // page_size)
    out = np.full(-(-S // page_size) + 1, pages[0], np.int32)
    out[:pages.size] = pages
    return out


def _greedy(logits: torch.Tensor) -> List[int]:
    """The arg_max head: each row's largest logit (the first on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).tolist()


def _sampled(sampling) -> bool:
    return sampling is not None and not sampling.greedy


def emit_head(logits: torch.Tensor, sampling=None,
              lanes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX ``_emit_head``, the token head of every form: the argmax by
    default (and for greedy ``sampling``), ``sample_token`` with the
    sampling params and the per-row RNG ``lanes`` when sampling is
    armed.  ``(rows,)`` int64 tokens on the logits' device."""
    if not _sampled(sampling):
        return torch.argmax(logits, dim=-1)
    return sample_token(logits, lanes, sampling.temperature, sampling.top_k,
                        sampling.top_p)


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
    # set when the admission policy shed this queued request: a third
    # terminal outcome beside finish and the submit rejection
    shed_at: Optional[float] = None
    preemptions: int = 0
    # submit sequence number: slo_aware ordering's tie-breaker
    _seq: int = field(default=0, repr=False)
    # telemetry: previous emit time and per-token gaps (gaps[0] = TTFT)
    # of the current run, reset with out_tokens on preemption
    _tm_last: Optional[float] = field(default=None, repr=False)
    _tm_gaps: List[float] = field(default_factory=list, repr=False)
    # the request's span tree (utils/tracing.Trace) when it was
    # head-sampled under FLAGS_trace_requests, else None
    trace: Optional[object] = field(default=None, repr=False)
    # prompt tokens the last prefill took from cached prefix pages
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


def _observe_token(req: Request, now: float):
    """Per-token latency into the registry with loadgen's convention:
    each token's gap from the previous one, the first from arrival (also
    the TTFT observation).  After a preemption only the final run's
    tokens are observed.  A traced request's observation carries its
    trace id as the bucket's exemplar."""
    first = len(req.out_tokens) == 1
    prev = req.arrival_time if first or req._tm_last is None \
        else req._tm_last
    gap = max(now - prev, 0.0)
    req._tm_gaps.append(gap)
    ex = req.trace.trace_id if req.trace is not None else None
    tm.histogram("serving_token_latency_s",
                 "per-token latency (inter-token gap; first token from "
                 "arrival)").observe(gap, exemplar=ex)
    if first:
        tm.histogram("serving_ttft_s",
                     "time to first token from arrival").observe(
                         gap, exemplar=ex)
    req._tm_last = now


# ==========================================================================
# request tracing hooks (utils/tracing.py), shared by both schedulers;
# each returns at once when the request carries no trace
# ==========================================================================
def _trace_submit(req: Request):
    """Root and queue_wait spans at submit (head-sampled: deterministic
    in (FLAGS_trace_seed, req_id))."""
    if not tracing.enabled() or not tracing.sampled(req.req_id):
        return
    tr = tracing.new_trace(req.req_id)
    req.trace = tr
    tr._root = tr.start("request", t=req.arrival_time, attrs={
        "req": str(req.req_id), "prompt_tokens": len(req.prompt),
        "max_new_tokens": req.max_new_tokens})
    tr._wait = tr.start("queue_wait", t=req.arrival_time, parent=tr._root)


def _trace_reject(req: Request, reason: str, reason_code: str = "unservable"):
    """A request rejected at submit gets a one-span trace, its reason
    code beside the ``serving_rejects_total{reason=}`` count."""
    if not tracing.enabled() or not tracing.sampled(req.req_id):
        return
    tr = tracing.new_trace(req.req_id)
    root = tr.start("request", t=req.arrival_time,
                    attrs={"req": str(req.req_id),
                           "prompt_tokens": len(req.prompt)})
    tr.end(root, t=req.arrival_time,
           attrs={"status": "rejected", "reason": reason,
                  "reject_reason": reason_code})
    tr.finish()


def _trace_shed(req: Request, now: float):
    """A shed request closes its open wait span and its root with
    ``status="shed"``; the SLO tracker is not fed (shed requests are out
    of the goodput denominators)."""
    tr = req.trace
    if tr is None:
        return
    tr.end(tr._wait, t=now)
    tr._wait = None
    tr.end(tr._root, t=now, attrs={
        "status": "shed", "reject_reason": "shed",
        "waited_s": round(now - req.arrival_time, 9),
        "preemptions": req.preemptions})
    tr.finish()


def _trace_backpressure(req: Request, kind: str):
    """Pool backpressure repeats every step the head request waits: a
    counter attr on the open wait span keeps it bounded."""
    tr = req.trace
    if tr is not None and tr._wait is not None:
        tr._wait.attrs[kind] = tr._wait.attrs.get(kind, 0) + 1


def _trace_admit(req: Request, now: float, wall0: float, wall1: float,
                 cached: int = 0, chunks: int = 0):
    """A finished prefill: close the open wait span and record the
    prefill span; ``cached`` / ``chunks`` appear only when the prefix
    cache or chunking engaged."""
    tr = req.trace
    if tr is None:
        return
    tr.end(tr._wait, t=now)
    tr._wait = None
    attrs = {"prompt_tokens": len(req.prompt), "resume": req.preemptions}
    if cached:
        attrs["cached_tokens"] = cached
    if chunks > 1:
        attrs["chunks"] = chunks
    tr.add("prefill", t0=now, wall0=wall0, wall1=wall1, parent=tr._root,
           attrs=attrs)


def _trace_decode(states: Sequence[_SeqState], toks: Sequence[int],
                  now: float, wall0: float, wall1: float, step_no: int,
                  spec: Optional[Sequence[tuple]] = None):
    """One decode_step span per traced request of the batch;
    ``spec`` (speculative steps only) adds each request's ``(proposed,
    accepted)`` draft counts."""
    for i, (st, tok) in enumerate(zip(states, toks)):
        tr = st.req.trace
        if tr is not None:
            attrs = {"step": step_no, "batch": len(states),
                     "token": int(tok)}
            if spec is not None:
                attrs["proposed"] = int(spec[i][0])
                attrs["accepted"] = int(spec[i][1])
            tr.add("decode_step", t0=now, wall0=wall0, wall1=wall1,
                   parent=tr._root, attrs=attrs)


def _trace_preempt(req: Request, now: float):
    """A preemption opens a ``preempted`` wait span; the resume's prefill
    closes it."""
    tr = req.trace
    if tr is None:
        return
    tr._wait = tr.start("preempted", t=now, parent=tr._root,
                        attrs={"cycle": req.preemptions})


def _trace_finish(req: Request, now: float):
    """Close the root span with the outcome and feed the SLO tracker
    (which sees every finished request, sampled or not)."""
    tr = req.trace
    if tr is not None:
        attrs = {"status": "finished", "tokens": len(req.out_tokens),
                 "preemptions": req.preemptions}
        if req._tm_gaps:
            attrs["ttft_s"] = round(req._tm_gaps[0], 9)
        tr.end(tr._root, t=now, attrs=attrs)
        tr.finish()
    if tm.enabled():
        tm.slo_tracker().observe_request(
            req.req_id,
            ttft_s=req._tm_gaps[0] if req._tm_gaps else float("nan"),
            decode_gaps=req._tm_gaps[1:],
            trace_id=tr.trace_id if tr is not None else None,
            prefix_hit_tokens=req._prefix_hit,
            prompt_tokens=len(req.prompt))


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


def _count_reject(e: ValueError):
    """One rejection: the aggregate counter and the by-reason family."""
    tm.counter("serving_rejected_total",
               "requests rejected at submit (unservable)").inc()
    tm.counter("serving_rejects_total",
               "requests refused, by reason (pool / budget / "
               "max_seq_len at submit; shed by the admission policy)",
               labels=("reason",)).labels(
                   reason=getattr(e, "reason", "unservable")).inc()


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (see ROADMAP.md)")


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


@dataclass
class _PrefillJob:
    """In-flight prefill of one request: ``pos`` tokens are already in
    the pool (prefix-cache hit plus completed slices); ``first_token`` is
    set when the final slice ran; ``wall_s`` sums every slice's wall
    time (the prefill span covers all chunks)."""
    req: Request
    pos: int = 0
    hit: int = 0
    chunks: int = 0
    first_token: Optional[int] = None
    wall_s: float = 0.0


class _DecodeBucket:
    """One (batch, table width) bucket's decode step on the card: its
    inputs as one int32 block on the device and its pinned host twin
    (tokens, positions, context lengths, slots, for a sampled engine the
    RNG lanes, then the block table), the tokens on the device and their
    pinned host copy, the event that copy ends with, and from the
    bucket's second step on its CUDA graph."""

    __slots__ = ("batch", "width", "rows", "host", "dev", "out", "host_out",
                 "done", "graph", "warm")

    def __init__(self, batch: int, width: int, device: torch.device,
                 sampled: bool = False):
        self.rows = 5 if sampled else 4
        n = batch * (self.rows + width)
        self.batch, self.width = batch, width
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(n, dtype=torch.int32, device=device)
        self.host_out = torch.empty(batch, dtype=torch.int64,
                                    pin_memory=True)
        self.done = torch.cuda.Event()
        self.out = self.graph = None
        self.warm = False

    def split(self, t: torch.Tensor):
        """``(tokens, positions, context_lens, slot_mapping, tables,
        lanes)`` views of a block laid out as :attr:`host` (lanes None
        for a greedy engine)."""
        b, r = self.batch, self.rows
        lanes = t[4 * b:5 * b] if r == 5 else None
        return (t[:b], t[b:2 * b], t[2 * b:3 * b], t[3 * b:4 * b],
                t[r * b:].reshape(b, self.width), lanes)


class _EngineCore:
    """The model, its KV pools and the allocator: one decoder on one
    device.

    ``kv_dtype`` (None: ``FLAGS_kv_cache_dtype``) is the pools' storage
    dtype; ``kv_budget_mb`` > 0 sizes the pool from a byte budget instead
    of ``num_pages`` (JAX's formula: the scale pools are charged on top,
    not in the divisor, so int8 buys exactly 4x the f32 pages);
    ``prefix_cache`` (None: ``FLAGS_kv_prefix_cache``) and
    ``prefix_seed`` configure the allocator's prefix cache.  ``sampling``
    (a :class:`SamplingParams`; None or greedy: the argmax head) arms the
    sampled head of every form, its lanes keyed on ``sample_seed``."""

    def __init__(self, cfg: DecoderConfig, weights: Dict[str, np.ndarray],
                 num_pages: int = 64, page_size: int = 16, device="cuda",
                 prefill_bucket_min: int = 16,
                 kv_dtype: Optional[str] = None, kv_budget_mb: float = 0.0,
                 tp: Optional[int] = None,
                 prefix_cache: Optional[bool] = None, prefix_seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 sample_seed: int = 0):
        if tp not in (None, 1):
            _not_ported(f"tensor-parallel serving (tp={tp})")
        # greedy normalizes to None: the forms then end in the argmax
        self.sampling = sampling if _sampled(sampling) else None
        self.sample_seed = int(sample_seed)
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
        #: the captured decode steps, one per (batch, width) bucket (the
        #: KV dtype is the engine's), sharing one capture stream and pool
        self._buckets: Dict[Tuple[int, int], _DecodeBucket] = {}
        self._graphs: Optional[GraphSet] = None

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs of the decode step captured so far (at most one
        per bucket)."""
        return self._graphs.captured if self._graphs is not None else 0

    @classmethod
    def from_model_dir(cls, model_dir: str, **kw) -> "_EngineCore":
        cfg, weights = load_decoder_weights(model_dir)
        return cls(cfg, weights, **kw)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _touched(self, slots, S: int) -> Optional[torch.Tensor]:
        """int8 pools: the device list of the pages a prefill or chunk
        slice of bucket length ``S`` writes (:func:`touched_pages`);
        None for f32 and bf16 pools."""
        if self.kv_scales is None:
            return None
        return self._t(touched_pages(slots, S, self.kv_config.page_size))

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

    def _lane(self, req: Request, offset: int = 0) -> int:
        """RNG lane of the token ``offset`` positions past the request's
        next emission: ``len(prompt) + len(out_tokens)`` is the absolute
        index of the next token drawn, so lanes are the same after a
        preemption and between plain and speculative decoding."""
        return rng_lane(self.sample_seed, req.req_id,
                        len(req.prompt) + len(req.out_tokens) + offset)

    def _tokens(self, logits: torch.Tensor, lanes=None) -> List[int]:
        """The head over an eager form's logits, as host ints; ``lanes``
        (a sampled engine's, one per row) is a host sequence."""
        if self.sampling is None:
            return _greedy(logits)
        return emit_head(logits, self.sampling,
                         self._t(np.asarray(lanes, np.int32))).tolist()

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
        wall_t0 = time.perf_counter()
        self._apply_forks()
        final = job.pos + n == L
        if job.pos == 0 and final:
            # cold whole-prompt prefill: the prefill form
            feed, S = self._dense_feed(req.prompt)
            slot_map = np.full(S, self.kv_config.pad_slot, np.int32)
            slot_map[:L] = slots
            with RecordEvent("prefill", cat="serving"):
                logits = self.model.prefill(*feed, self._t(slot_map),
                                            self.kv_pools, self.kv_scales,
                                            self._touched(slots, S))
                tok = self._tokens(logits, None if self.sampling is None
                                   else [self._lane(req)])[0]
        else:
            tok = self._run_chunk(req, job.pos, chunk, slots)
        job.wall_s += time.perf_counter() - wall_t0
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
        with RecordEvent("prefill_chunk", cat="serving"):
            logits = self.model.chunk(
                self._t(toks), self._t(posf), self._t(mask),
                self._t(np.array([n - 1], np.int32)), self._t(slot_map),
                self._t(tables), self.kv_pools, self.kv_scales,
                self._touched(slots, S))
            # the slice's token lands at position pos+n; only the final
            # slice's draw is kept, whose lane is the whole prefill's
            return self._tokens(logits, None if self.sampling is None else
                                [rng_lane(self.sample_seed, req.req_id,
                                          pos + n)])[0]

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
        lanes = None
        if self.sampling is not None:
            lanes = np.zeros(Bp, np.int32)
            for i, st in enumerate(states):
                lanes[i] = self._lane(st.req)
        with RecordEvent("decode_batch", cat="serving"):
            if cuda_step_session_enabled(self.device):
                return self._decode_captured(toks, pos, ctx, slot_map,
                                             tables, lanes)[:B]
            logits = self.model.decode(
                self._t(toks), self._t(pos), self._t(tables), self._t(ctx),
                self._t(slot_map), self.kv_pools, self.kv_scales)
            return self._tokens(logits, lanes)[:B]

    def _decode_tokens(self, bucket: _DecodeBucket) -> torch.Tensor:
        """The decode form and its head over a bucket's device inputs:
        the step a bucket's graph holds."""
        toks, pos, ctx, slots, tables, lanes = bucket.split(bucket.dev)
        logits = self.model.decode(toks, pos, tables, ctx, slots,
                                   self.kv_pools, self.kv_scales)
        return emit_head(logits, self.sampling, lanes)

    def _decode_captured(self, toks, pos, ctx, slot_map, tables,
                         lanes=None) -> List[int]:
        """One decode step through its bucket: the inputs in one copy
        from pinned memory, then the bucket's first step eagerly on the
        capture stream (the warm-up), its second captured and replayed,
        later ones replayed; the tokens back in one small copy."""
        Bp, W = tables.shape
        bucket = self._buckets.get((Bp, W))
        if bucket is None:
            bucket = self._buckets[(Bp, W)] = _DecodeBucket(
                Bp, W, self.device, self.sampling is not None)
        for view, arr in zip(bucket.split(bucket.host.numpy()),
                             (toks, pos, ctx, slot_map, tables, lanes)):
            if view is not None:
                view[...] = arr
        if self._graphs is None:
            self._graphs = GraphSet(self.device)
        graphs = self._graphs
        with graphs.on_stream():
            bucket.dev.copy_(bucket.host, non_blocking=True)
            if not bucket.warm:
                bucket.out = self._decode_tokens(bucket)
                bucket.warm = True
            else:
                if bucket.graph is None:
                    try:
                        bucket.graph, bucket.out = graphs.capture(
                            lambda: self._decode_tokens(bucket))
                    except Exception as e:
                        raise StepCaptureError(
                            f"the decode step (batch {Bp}, table width {W}, "
                            f"{self.kv_dtype} pools) cannot be captured in a "
                            f"CUDA graph ({type(e).__name__}: {e}); "
                            f"FLAGS_cuda_step_session=0 runs it eagerly"
                        ) from e
                bucket.graph.replay()
            bucket.host_out.copy_(bucket.out, non_blocking=True)
            bucket.done.record()
        bucket.done.synchronize()
        return bucket.host_out.tolist()

    def verify_batch(self, items) -> List[List[int]]:
        """One speculative verify step (JAX ``verify_batch``): ``items``
        are ``(_SeqState, draft_tokens)`` pairs.  Each sequence's chunk
        ``[last_token] + draft`` enters the pool (the caller reserved the
        pages), then one verify-form call scores every chunk position of
        every sequence.  Returns, per item, the model's next token after
        each chunk position (``len(draft) + 1`` tokens): row j is what
        plain decoding would emit after accepting j draft tokens.  Batch,
        chunk length and table width are bucketed to powers of two; the
        form runs eagerly, as chunk does."""
        B = len(items)
        Bp = _pow2_bucket(max(B, 1))
        S = _pow2_bucket(max(1 + len(d) for _, d in items))
        toks = np.zeros((Bp, S), np.int32)
        posf = np.zeros((Bp, S), np.int32)
        slot_map = np.full(Bp * S, self.kv_config.pad_slot, np.int32)
        pos0 = []
        for i, (st, draft) in enumerate(items):
            rid = st.req.req_id
            chunk = [int(st.last_token)] + [int(t) for t in draft]
            n = len(chunk)
            p0 = self.kv.context_len(rid)
            pos0.append(p0)
            slots = self.kv.append_tokens(rid, n, tokens=chunk)
            if slots is None:
                raise RuntimeError("verify_batch: the caller must reserve "
                                   "the pages of every chunk")
            toks[i, :n] = chunk
            posf[i] = np.minimum(p0 + np.arange(S, dtype=np.int32),
                                 self.cfg.max_seq_len - 1)
            slot_map[i * S:i * S + n] = slots
        self._apply_forks()
        W = _pow2_bucket(max(
            (self.kv.num_pages_of(st.req.req_id) for st, _ in items),
            default=1))
        C = W * self.kv_config.page_size
        tables = np.zeros((Bp, W), np.int32)
        for i, (st, _d) in enumerate(items):
            tables[i] = self.kv.block_table(st.req.req_id, W)
        # per-row causal + context mask (the chunk form's rule, a slice
        # per batch row); padded rows are fully masked, and softmax over
        # the finite NEG_INF stays NaN-free
        cols = np.arange(C, dtype=np.int64)[None, None, :]
        rows = np.arange(S, dtype=np.int64)[None, :, None]
        base = np.asarray(pos0 + [-1] * (Bp - B),
                          dtype=np.int64)[:, None, None]
        mask = np.where(cols <= base + rows, 0.0, NEG_INF) \
            .astype(np.float32)[:, None]
        lanes = None
        if self.sampling is not None:
            lanes = np.zeros(Bp * S, np.int32)
            for i, (st, draft) in enumerate(items):
                for j in range(len(draft) + 1):
                    # row j draws the token of absolute position
                    # len(prompt) + len(out) + j: plain decoding's lane
                    lanes[i * S + j] = self._lane(st.req, j)
        with RecordEvent("verify_batch", cat="serving"):
            logits = self.model.verify(
                self._t(toks), self._t(posf), self._t(mask),
                self._t(slot_map), self._t(tables), self.kv_pools,
                self.kv_scales)
            flat = self._tokens(logits, lanes)
        return [flat[i * S:i * S + len(d) + 1]
                for i, (_st, d) in enumerate(items)]

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

    Scheduling is deterministic for a fixed request sequence: the
    admission policy (``admission_policy`` / ``FLAGS_admission_policy``,
    :mod:`.admission`) decides admission order, shedding and the
    preemption victim as pure functions of the queue and the SLO
    tracker; the default ``fifo`` admits in submit order (head-of-line
    blocking, no shedding) and preempts the youngest, so a seeded trace
    replays identically and matches the JAX engine's event stream.  With
    the prefix cache on, a hit shrinks the admission's cost to the
    computed suffix; with ``prefill_chunk`` (None:
    ``FLAGS_prefill_chunk_tokens``) a long remainder prefills one slice
    per step ahead of new admissions while decode goes on.

    ``sampling`` (None: ``FLAGS_sample_temperature`` > 0 arms
    ``SamplingParams(temperature)``) samples every token under lanes
    keyed on ``seed``; ``spec_k`` (None: ``FLAGS_spec_decode_k``) > 0
    decodes speculatively with ``proposer`` (a :class:`Proposer` or its
    name; the n-gram proposer by default).

    ``device`` defaults to ``"cuda"``; without a CUDA device the engine
    raises unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: Optional[DecoderConfig] = None,
                 weights: Optional[Dict[str, np.ndarray]] = None,
                 model_dir: Optional[str] = None,
                 max_batch: int = 8, token_budget: int = 256,
                 seed: int = 0, admission_policy=None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None, proposer=None,
                 sampling: Optional[SamplingParams] = None, **core_kw):
        if sampling is None:
            temp = flag_float("FLAGS_sample_temperature")
            if temp > 0.0:
                sampling = SamplingParams(temperature=temp)
        self.sampling = sampling if _sampled(sampling) else None
        core_kw.setdefault("sampling", self.sampling)
        core_kw.setdefault("sample_seed", seed)
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
        if spec_k is None:
            spec_k = int(get_flag("FLAGS_spec_decode_k") or 0)
        self.spec_k = max(int(spec_k), 0)
        if isinstance(proposer, str):
            proposer = get_proposer(proposer)
        self.proposer: Optional[Proposer] = \
            proposer if proposer is not None else \
            (NGramProposer() if self.spec_k else None)
        # verify-call budget debt: tokens a verify emitted beyond the one
        # per sequence this step's budget charged, settled against the
        # next step's budget, so a verify charges accepted+1 tokens as
        # plain decoding does (0 with spec off, and at zero acceptance)
        self._spec_debt = 0
        self._prefill_job: Optional[_PrefillJob] = None
        self.waiting: List[Request] = []
        self.running: List[_SeqState] = []   # admission order
        self.stats = {"admitted": 0, "finished": 0, "preempted": 0,
                      "shed": 0, "decode_steps": 0, "prefill_tokens": 0,
                      "decode_tokens": 0, "prefill_hit_tokens": 0,
                      "prefill_chunks": 0, "max_prefill_step_tokens": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        self._step_no = 0
        self._submit_seq = 0

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs of the decode step captured so far."""
        return self.core.graphs_captured

    # -- API ---------------------------------------------------------------
    def submit(self, req: Request):
        try:
            _reject_unservable(req, self.cfg, self.core.kv_config)
            if len(req.prompt) + 1 > self.token_budget \
                    and not self.prefill_chunk:
                # admission needs prompt+1 tokens inside the budget; a
                # larger prompt would block the queue head forever, unless
                # chunked prefill serves it one budget-sized slice a step
                raise RequestRejected(
                    f"request {req.req_id!r}: prompt of "
                    f"{len(req.prompt)} tokens can never fit "
                    f"token_budget {self.token_budget}", "budget")
        except ValueError as e:
            _count_reject(e)
            _trace_reject(req, str(e), getattr(e, "reason", "unservable"))
            raise
        req._seq = self._submit_seq
        self._submit_seq += 1
        _trace_submit(req)
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self._prefill_job is not None)

    def step(self, now: float = 0.0) -> List[StepEvent]:
        """One serving iteration: the policy's sheds, then the in-flight
        chunked prefill's next slice, admission (in policy order, up to
        the token budget and pool capacity) and the admissions' prefill,
        preemption while the pool cannot grow every running sequence by
        one token, one decode (or speculative verify) of every running
        sequence, eviction of finishes.  Returns this step's emitted
        tokens."""
        events: List[StepEvent] = []
        self._step_no += 1
        chaos.on_serving_step(self, self._step_no)
        for req in self.policy.shed(self, now):
            self._shed(req, now)
        self.policy.order(self, now)
        # last step's verify debt charges this step's budget
        budget = self.token_budget - len(self.running) - self._spec_debt
        self._spec_debt = 0
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
                    _trace_backpressure(job.req, "prefill_backpressure")
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
                if cost > budget:
                    break
                if not self._admission_fits(req):
                    _trace_backpressure(req, "admission_backpressure")
                    break
                wall0 = time.perf_counter()
                tok = self.core.prefill(req)
                if tok is None:
                    _trace_backpressure(req, "prefill_backpressure")
                    break  # pool backpressure: retry next step
                _trace_admit(req, now, wall0, time.perf_counter())
                self.waiting.pop(0)
                budget -= cost
                prefilled_this_step += len(req.prompt)
                self.stats["prefill_tokens"] += len(req.prompt)
                tm.counter("serving_prefill_tokens_total",
                           "prompt tokens prefilled").inc(len(req.prompt))
                self._admitted(req, now)
                self._start(_SeqState(req, tok), tok, now, events)
                continue
            # a prefix-cache hit shrinks the admission to the computed
            # suffix (estimated read-only first), and a long suffix goes
            # through the chunked path
            est_hit = self.kv.match_prefix(req.prompt[:-1])[0] \
                if self.kv.prefix_cache and len(req.prompt) > 1 else 0
            if not self._admission_fits(req, len(req.prompt) - est_hit):
                _trace_backpressure(req, "admission_backpressure")
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
                    _trace_backpressure(req, "prefill_backpressure")
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
                    _trace_backpressure(req, "prefill_backpressure")
                    break
                self.waiting.pop(0)
                budget -= remaining + 1
                prefilled_this_step += remaining
                self._count_prefill(remaining, job)
                self._admit_job(job, now, events)
        # --- preemption: decoding adds one token per running seq ----------
        while self.running and not self._can_grow_all():
            # fifo: the youngest; slo_aware: the least lost work
            victim = self.running.pop(self.policy.victim_index(self.running))
            self.kv.free_sequence(victim.req.req_id)
            victim.req.out_tokens = []
            victim.req._tm_last = None
            victim.req._tm_gaps = []
            victim.req.preemptions += 1
            _trace_preempt(victim.req, now)
            self.waiting.insert(0, victim.req)
            self.stats["preempted"] += 1
            tm.counter("serving_preempted_total",
                       "sequences preempted to the waiting queue on "
                       "pool exhaustion").inc()
            if is_profiler_enabled():
                instant_event("preempt", cat="serving",
                              args={"req": str(victim.req.req_id)})
        # --- decode -------------------------------------------------------
        if self.running and self.spec_k:
            events.extend(self._spec_decode_step(now))
        elif self.running:
            chaos.on_decode_step()
            wall0 = time.perf_counter()
            toks = self.core.decode_batch(self.running)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(self.running)
            _trace_decode(self.running, toks, now, wall0,
                          time.perf_counter(), self.stats["decode_steps"])
            tm.counter("serving_decode_steps_total",
                       "batched decode steps run").inc()
            tm.counter("serving_decode_tokens_total",
                       "tokens produced by decode steps").inc(
                           len(self.running))
            still = []
            for st, tok in zip(self.running, toks):
                st.req.out_tokens.append(tok)
                st.last_token = tok
                _observe_token(st.req, now)
                if self.core._finished(st.req, tok):
                    events.append(self._finish(st, tok, now))
                else:
                    events.append(StepEvent(st.req.req_id, tok, False, now))
                    still.append(st)
            self.running = still
        self.stats["max_prefill_step_tokens"] = max(
            self.stats["max_prefill_step_tokens"], prefilled_this_step)
        return events

    def _spec_decode_step(self, now: float) -> List[StepEvent]:
        """One speculative decode iteration (JAX ``_spec_decode_step``):
        draft up to ``spec_k`` tokens per running sequence, verify every
        chunk in one call, emit each sequence's longest agreeing draft
        prefix and the verify's own next token, truncate the rejected
        drafts back out of the pool.  Greedy acceptance is exact-argmax
        match, so the greedy stream is plain decoding's up to the two
        forms' rounding; sampled row j draws under the lane plain
        decoding uses there.  A zero-accept step emits one token per
        sequence: plain decoding's steps and budget."""
        events: List[StepEvent] = []
        chaos.on_decode_step()
        batch = self.running
        # page capacity: preemption guaranteed one token of growth per
        # sequence; drafts spend only what remains after those, each
        # shrinking until it fits
        bases = [self.kv.pages_needed(st.req.req_id, 1)
                 + self.kv.cow_fork_need(st.req.req_id, 1)
                 for st in batch]
        avail = self.kv.num_free_pages - sum(bases)
        drafts: List[List[int]] = []
        for st, base in zip(batch, bases):
            req = st.req
            # never draft past max_new_tokens - 1: the bonus token always
            # lands, so a full accept finishes exactly at the cap
            cap = min(self.spec_k,
                      req.max_new_tokens - len(req.out_tokens) - 1)
            d = [int(t) for t in self.proposer.propose(req, cap)][:cap] \
                if cap > 0 else []
            while d:
                extra = (self.kv.pages_needed(req.req_id, 1 + len(d))
                         + self.kv.cow_fork_need(req.req_id, 1 + len(d))
                         - base)
                if extra <= avail:
                    avail -= extra
                    break
                d.pop()
            drafts.append(d)
        wall0 = time.perf_counter()
        targets = self.core.verify_batch(list(zip(batch, drafts)))
        wall1 = time.perf_counter()
        self.stats["decode_steps"] += 1
        tm.counter("serving_decode_steps_total",
                   "batched decode steps run").inc()
        # accept while the target agrees with the draft, then cut the
        # emission at max_new_tokens / EOS, where plain decoding stops
        accepts, emits = [], []
        for st, d, tgt in zip(batch, drafts, targets):
            a = 0
            while a < len(d) and tgt[a] == d[a]:
                a += 1
            accepts.append(a)
            room = st.req.max_new_tokens - len(st.req.out_tokens)
            emit = tgt[:min(a + 1, room)]
            if self.cfg.eos_id in emit:
                emit = emit[:emit.index(self.cfg.eos_id) + 1]
            emits.append(emit)
        _trace_decode(batch, [e[-1] for e in emits], now, wall0, wall1,
                      self.stats["decode_steps"],
                      spec=[(len(d), a) for d, a in zip(drafts, accepts)])
        still = []
        for st, d, a, emit in zip(batch, drafts, accepts, emits):
            req = st.req
            fin = False
            for tok in emit:
                req.out_tokens.append(tok)
                _observe_token(req, now)
                if self.core._finished(req, tok):
                    events.append(self._finish(st, tok, now))
                    fin = True
                    break
                events.append(StepEvent(req.req_id, tok, False, now))
            if not fin:
                # roll the rejected drafts back out of the pool (a
                # finished sequence was freed whole)
                if len(d) > a:
                    self.kv.truncate_tokens(req.req_id, len(d) - a)
                st.last_token = emit[-1]
                still.append(st)
        self.running = still
        n_prop = sum(len(d) for d in drafts)
        n_acc = sum(accepts)
        used = sum(len(e) for e in emits)
        self.stats["decode_tokens"] += used
        self.stats["spec_proposed"] += n_prop
        self.stats["spec_accepted"] += n_acc
        self._spec_debt = used - len(batch)
        tm.counter("serving_decode_tokens_total",
                   "tokens produced by decode steps").inc(used)
        tm.counter("spec_proposed_total",
                   "draft tokens proposed to spec-decode verify").inc(n_prop)
        tm.counter("spec_accepted_total",
                   "draft tokens accepted by spec-decode verify").inc(n_acc)
        if self.stats["spec_proposed"]:
            tm.gauge("spec_accept_rate",
                     "cumulative spec-decode draft acceptance rate").set(
                         self.stats["spec_accepted"]
                         / self.stats["spec_proposed"])
        return events

    def _admitted(self, req: Request, now: float):
        """An admission's bookkeeping: its time, the counters, the
        profiler's ``admit`` instant."""
        if req.admitted_at is None:
            req.admitted_at = now
        self.stats["admitted"] += 1
        tm.counter("serving_admitted_total",
                   "requests admitted (prefilled)").inc()
        if is_profiler_enabled():
            instant_event("admit", cat="serving",
                          args={"req": str(req.req_id),
                                "prompt": len(req.prompt)})

    def _start(self, st: _SeqState, tok: int, now: float, events: list):
        """An admitted sequence's first token: finished at once, or
        running from here."""
        st.req.out_tokens.append(tok)
        _observe_token(st.req, now)
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
        tm.counter("serving_prefill_tokens_total",
                   "prompt tokens prefilled").inc(n)

    def _admit_job(self, job: _PrefillJob, now: float, events: list):
        """A completed prefill job becomes a running sequence; its span's
        wall bounds cover every slice."""
        req = job.req
        wall1 = time.perf_counter()
        _trace_admit(req, now, wall1 - job.wall_s, wall1,
                     cached=job.hit, chunks=job.chunks)
        self._admitted(req, now)
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

    def _shed(self, req: Request, now: float):
        """Terminal ``shed`` outcome of a queued request whose SLO the
        policy judged unreachable: traced (root status "shed") and
        counted (``serving_shed_total``, ``serving_rejects_total
        {reason="shed"}``), never fed to the SLO tracker."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return
        req.shed_at = now
        self.stats["shed"] += 1
        tm.counter("serving_shed_total",
                   "queued requests shed by the admission policy "
                   "(predicted TTFT can no longer meet the SLO)").inc()
        tm.counter("serving_rejects_total",
                   "requests refused, by reason (pool / budget / "
                   "max_seq_len at submit; shed by the admission policy)",
                   labels=("reason",)).labels(reason="shed").inc()
        _trace_shed(req, now)
        if is_profiler_enabled():
            instant_event("shed", cat="serving",
                          args={"req": str(req.req_id),
                                "waited": round(now - req.arrival_time, 6)})

    def _finish(self, st: _SeqState, tok: int, now: float) -> StepEvent:
        self.kv.free_sequence(st.req.req_id)
        st.req.finished_at = now
        self.stats["finished"] += 1
        tm.counter("serving_finished_total",
                   "requests finished (pages evicted on finish)").inc()
        _trace_finish(st.req, now)
        if is_profiler_enabled():
            instant_event("evict", cat="serving",
                          args={"req": str(st.req.req_id)})
        return StepEvent(st.req.req_id, tok, True, now)

    def slo_hint(self) -> dict:
        """The SLO tracker's burn rate, goodput and targets: what the
        ``slo_aware`` policy orders and sheds by (``fifo`` never reads
        it)."""
        return tm.slo_tracker().admission_hint()

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


class StaticBatchingEngine:
    """The A/B baseline (JAX ``StaticBatchingEngine``): fixed batches run
    to completion before the next batch forms, with no admission
    mid-decode.  It shares an :class:`_EngineCore` (the same model and
    kernels); only the policy differs.  Group formation reserves each
    member's worst-case pages (prompt + max_new_tokens), so mid-decode
    growth can never exhaust the pool."""

    def __init__(self, core: _EngineCore, batch_size: int = 8):
        self.core = core
        self.batch_size = batch_size
        self.waiting: List[Request] = []
        self.group: List[_SeqState] = []
        self._reserved_pages = 0
        self.stats = {"admitted": 0, "finished": 0, "decode_steps": 0,
                      "decode_tokens": 0, "prefill_tokens": 0}

    def submit(self, req: Request):
        try:
            _reject_unservable(req, self.core.cfg, self.core.kv_config)
        except ValueError as e:
            _count_reject(e)
            _trace_reject(req, str(e), getattr(e, "reason", "unservable"))
            raise
        _trace_submit(req)
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.group)

    def _end(self, st: _SeqState, tok: int, now: float,
             events: list) -> bool:
        """Record ``tok``; True when the request finished (its pages
        freed)."""
        if self.core._finished(st.req, tok):
            self.core.kv.free_sequence(st.req.req_id)
            st.req.finished_at = now
            self.stats["finished"] += 1
            _trace_finish(st.req, now)
            events.append(StepEvent(st.req.req_id, tok, True, now))
            return True
        events.append(StepEvent(st.req.req_id, tok, False, now))
        return False

    def step(self, now: float = 0.0) -> List[StepEvent]:
        events: List[StepEvent] = []
        if not self.group:
            self._reserved_pages = 0
            while self.waiting and len(self.group) < self.batch_size:
                req = self.waiting[0]
                worst = _worst_case_pages(req, self.core.kv_config)
                if self._reserved_pages + worst \
                        > self.core.kv_config.num_pages:
                    break  # the group is as large as worst cases allow
                self._reserved_pages += worst
                wall0 = time.perf_counter()
                tok = self.core.prefill(req)
                if tok is None:
                    break
                _trace_admit(req, now, wall0, time.perf_counter())
                self.waiting.pop(0)
                req.admitted_at = now
                self.stats["admitted"] += 1
                self.stats["prefill_tokens"] += len(req.prompt)
                st = _SeqState(req, tok)
                req.out_tokens.append(tok)
                _observe_token(req, now)
                if not self._end(st, tok, now, events):
                    self.group.append(st)
            return events
        wall0 = time.perf_counter()
        toks = self.core.decode_batch(self.group)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(self.group)
        _trace_decode(self.group, toks, now, wall0, time.perf_counter(),
                      self.stats["decode_steps"])
        still = []
        for st, tok in zip(self.group, toks):
            st.req.out_tokens.append(tok)
            st.last_token = tok
            _observe_token(st.req, now)
            if not self._end(st, tok, now, events):
                still.append(st)
        self.group = still
        return events

    def run_to_completion(self, now: float = 0.0) -> List[StepEvent]:
        events = []
        while self.has_work():
            events.extend(self.step(now))
        return events
