"""In-program token sampling for the serving decode paths (counterpart of
``paddle_tpu/ops/sampling_ops.py``).

One op, ``sample_token``: temperature / top-k / top-p (nucleus) sampling
over a batch of logits, with an explicit per-row RNG *lane*
(``inference/spec_decode.rng_lane``: a pure function of engine seed,
request and position), so a sampled step is a deterministic function of
its inputs: a seeded trace replays bit for bit, and a preempted and
resumed request draws the same tokens at the same positions.

Filtering is JAX's, ties kept: temperature, then top-k (``x < kth``
largest -> -inf), then nucleus (keep where the exclusive cumulative
probability of the descending sort is ``< top_p``, as a threshold on the
sorted logits).  ``temperature <= 0`` is argmax.

The draw is the port's own: Gumbel-max, ``argmax(x + g)`` with
``g = -log(-log(u))`` in float64 and ``u`` a uniform made from a 32-bit
integer hash of (lane, column) (:func:`lane_hash`).  The hash is written
in int64 torch ops whose products stay below 2^34 (32 x 32-bit multiplies
split into 16-bit halves; torch has no unsigned 64-bit arithmetic), so
it gives the same bits on the CPU and on the card, needs no generator
state, and runs inside a CUDA graph.  It is not
``jax.random.categorical`` under ``fold_in(key, lane)``, whose bits
cannot be matched: sampled streams are not token-equal to the JAX
package's (ROADMAP.md, Queue 3).  No Pallas kernel computes this in the
JAX package (XLA fuses it); the sort over the vocabulary is a library
call here.
"""
from __future__ import annotations

import torch

from .registry import op

__all__ = ["sample_token", "lane_hash", "lane_gumbel", "filter_logits"]

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``b``, from 16-bit halves: every product is below 2^33."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    cross = (a_hi * b_lo + a_lo * b_hi) & 0xFFFF
    return (a_lo * b_lo + (cross << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection of [0, 2^32))."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def lane_hash(lanes: torch.Tensor, vocab: int) -> torch.Tensor:
    """``(rows, vocab)`` int64 hashes in [0, 2^32): row r, column c hashed
    from ``(lanes[r], c)``."""
    key = _fmix32((lanes.long() & _M32) ^ 0x9E3779B9)[:, None]
    key2 = _fmix32(key ^ 0x27D4EB2F)
    col = _mul32(torch.arange(vocab, device=lanes.device), 0x85EBCA77)
    h = _fmix32((key + col[None, :]) & _M32)
    return _fmix32(h ^ key2)


def lane_gumbel(lanes: torch.Tensor, vocab: int) -> torch.Tensor:
    """``(rows, vocab)`` float64 Gumbel(0, 1) noise of each row's lane."""
    u = (lane_hash(lanes, vocab).double() + 0.5) * (2.0 ** -32)
    return -torch.log(-torch.log(u))


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """``logits / temperature`` with the entries that top-k and the
    nucleus drop set to -inf (f32, JAX's thresholds, ties kept)."""
    x = logits.float() / temperature
    vocab = x.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.sort(x, dim=-1).values[..., vocab - top_k, None]
        x = torch.where(x < kth, float("-inf"), x)
    if 0.0 < top_p < 1.0:
        xs = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(xs, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        kth = torch.where(keep, xs, float("inf")).amin(dim=-1, keepdim=True)
        x = torch.where(x < kth, float("-inf"), x)
    return x


def sample_token(logits: torch.Tensor, lanes: torch.Tensor,
                 temperature: float, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """``(rows,)`` int64 tokens drawn from ``logits`` ``(rows, vocab)``,
    row r under lane ``lanes[r]`` (padded rows may carry any lane)."""
    if temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1)
    x = filter_logits(logits, temperature, top_k, top_p)
    return torch.argmax(x.double() + lane_gumbel(lanes, x.shape[-1]), dim=-1)


@op("sample_token", no_grad=True)
def _sample_token(ctx):
    """Inputs: Logits ``(num_rows, vocab)``; Seeds ``(num_rows,)`` int32
    RNG lanes.  Attrs: ``temperature`` (<= 0: argmax), ``top_k`` (0:
    off), ``top_p`` (>= 1: off).  Out: ``(num_rows,)`` int64 tokens."""
    ctx.set_out("Out", sample_token(
        ctx.in_("Logits"), ctx.in_("Seeds"),
        float(ctx.attr("temperature", 1.0)), int(ctx.attr("top_k", 0)),
        float(ctx.attr("top_p", 1.0))))
