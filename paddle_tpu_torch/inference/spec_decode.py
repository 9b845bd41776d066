"""Speculative-decoding proposers and the sampled-decode RNG-lane
contract (counterpart of ``paddle_tpu/inference/spec_decode.py``, whole).

Speculative decoding: a cheap *proposer* drafts up to K candidate
tokens, the engine scores all K+1 positions in ONE verify-form call
against the pool-resident K/V, and the longest prefix that agrees with
the target model is accepted.  Greedy acceptance is exact-argmax match,
so greedy speculative decoding gives the non-speculative token stream.

The first drafter is n-gram **prompt lookup** (no draft model): match
the last n tokens of the request's prompt + output against an earlier
occurrence and propose its continuation.  Self-similar streams give it
high acceptance; with nothing to draft the engine runs a plain
one-token verify, which costs exactly the baseline's steps and budget.

RNG lanes: sampled decoding draws through ``ops/sampling_ops.py``'s
``sample_token`` under a per-row integer *lane* computed here as
``rng_lane(engine_seed, req_id, position)``, the same crc32 as the JAX
package's.  The lane is a pure function of the position, so a seeded
trace replays bit for bit and a preempted-then-resumed request draws
with the same lanes at the same positions; verify rows use the lane of
the position they would emit.  The draw itself is the port's own hash
(``sample_token``), not ``jax.random.categorical``: sampled streams are
reproducible within the port, not token-equal to the JAX package's
(ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List


def rng_lane(seed: int, req_id: str, position: int) -> int:
    """Deterministic per-(request, position) RNG lane key.

    Stable across processes (crc32, not ``hash``), non-negative int32
    so it feeds straight into the program as an INT32 tensor.  Position
    is the absolute sequence index of the token being drawn
    (``len(prompt) + len(out_tokens)`` for the next token), so lanes
    are resume-invariant under preemption by construction.
    """
    return zlib.crc32(f"{seed}:{req_id}:{position}".encode()) & 0x7FFFFFFF


@dataclass(frozen=True)
class SamplingParams:
    """Engine-level sampling configuration, baked into the decode
    programs as ``sample_token`` attrs (greedy = temperature 0.0 keeps
    the default argmax programs untouched)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class Proposer:
    """Drafts up to ``k`` candidate next tokens for one request.

    ``propose`` sees the request object (prompt + out_tokens history)
    and must be a pure function of that history — determinism of the
    draft is what extends the token-identity oracle to spec-decode
    (the engine accepts-while-equal, so any deterministic drafter
    yields the baseline token stream; the drafter only controls how
    MANY tokens each verify call accepts).  May return fewer than k
    tokens, or none (the engine then runs a plain 1-token verify).
    """

    def propose(self, req, k: int) -> List[int]:
        raise NotImplementedError


class NGramProposer(Proposer):
    """Prompt-lookup drafting: match the last ``n`` tokens of the
    request's prompt+output history against an earlier occurrence and
    propose its continuation.  Longest match wins (n from ``max_n``
    down to ``min_n``); among equal-length matches, the most recent
    earlier occurrence (code and templated text repeat locally).
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, req, k: int) -> List[int]:
        hist = list(req.prompt) + list(req.out_tokens)
        if k <= 0 or len(hist) < self.min_n + 1:
            return []
        for n in range(min(self.max_n, len(hist) - 1), self.min_n - 1, -1):
            suffix = hist[-n:]
            # most recent earlier occurrence of the suffix
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i:i + n] == suffix:
                    cont = hist[i + n:i + n + k]
                    if cont:
                        return cont
                    break  # suffix only recurs flush at the end
        return []


class NullProposer(Proposer):
    """Never drafts: spec-decode degrades to exactly the monolithic
    baseline (one token per verify, identical step count and budget
    accounting)."""

    def propose(self, req, k: int) -> List[int]:
        return []


_PROPOSERS = {
    "ngram": NGramProposer,
    "null": NullProposer,
}


def get_proposer(name: str, **kw) -> Proposer:
    try:
        cls = _PROPOSERS[name]
    except KeyError:
        raise ValueError(
            f"unknown proposer {name!r} (have {sorted(_PROPOSERS)})")
    return cls(**kw)
