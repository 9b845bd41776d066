"""Open-loop load generation and latency reporting for serving runs.

Counterpart of ``paddle_tpu/utils/loadgen.py``, whole.  Open loop means
arrivals are a Poisson process fixed in advance by a seed: the
generator never waits for the system (closed-loop load hides queueing
collapse).  :func:`replay_trace` drives an engine exposing
``submit(request)`` / ``step(now)`` / ``has_work()`` (``ServingEngine``
and ``StaticBatchingEngine``) on the wall clock, and
:func:`latency_report` turns the replay into tokens/s and latency
percentiles.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["poisson_trace", "replay_trace", "latency_report",
           "per_request_latency", "emit_json", "pct"]


@dataclass(frozen=True)
class TraceEntry:
    req_id: int
    arrival: float
    prompt: List[int]
    max_new_tokens: int


def poisson_trace(num_requests: int, rate: float, vocab_size: int,
                  prompt_len_range=(4, 32), max_new_range=(4, 32),
                  seed: int = 0, prefix_len: int = 0,
                  prefix_share: float = 0.0,
                  repeat_frac: float = 0.0) -> List[TraceEntry]:
    """Seeded open-loop trace: exponential inter-arrivals at ``rate``
    req/s, uniform prompt lengths and output budgets.  The same seed
    yields the same trace for every engine under test (the A/B
    contract).

    ``prefix_len`` > 0 arms the SHARED-PREFIX workload (system prompts /
    few-shot headers): one seeded common prefix of that many tokens is
    prepended to each request's own suffix with probability
    ``prefix_share``.  ``prefix_len=0`` (default) leaves the per-request
    draws unchanged.

    ``repeat_frac`` > 0 arms the SELF-SIMILAR workload (code,
    templated text, retry storms): each prompt is rewritten so roughly
    that fraction of its tokens repeat an n-gram drawn from earlier in
    the same prompt — the trace the n-gram prompt-lookup drafter
    (inference/spec_decode.py) gets its acceptance from.  Like the
    prefix knobs it draws from a DERIVED seed, so ``repeat_frac=0``
    (default) gives the same trace as without it."""
    rng = np.random.RandomState(seed)
    prefix: List[int] = []
    if prefix_len > 0:
        # drawn from a DERIVED seed so arming the prefix knobs never
        # perturbs the per-request draws below
        prefix = np.random.RandomState(seed + 7919).randint(
            0, vocab_size, size=prefix_len).astype(int).tolist()
    rep_rng = np.random.RandomState(seed + 6007) if repeat_frac > 0 else None
    t = 0.0
    out = []
    for i in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        n = int(rng.randint(prompt_len_range[0], prompt_len_range[1] + 1))
        m = int(rng.randint(max_new_range[0], max_new_range[1] + 1))
        prompt = rng.randint(0, vocab_size, size=n).astype(int).tolist()
        if prefix and rng.random_sample() < prefix_share:
            prompt = prefix + prompt
        if rep_rng is not None and len(prompt) >= 4:
            # splice copies of earlier spans over ~repeat_frac of the
            # prompt tail (length preserved; arrival/length draws above
            # came from the primary stream, untouched)
            budget = int(round(repeat_frac * len(prompt)))
            pos = max(2, len(prompt) - budget)
            while pos < len(prompt):
                src = int(rep_rng.randint(0, pos - 1))
                span = int(rep_rng.randint(2, 5))
                span = min(span, len(prompt) - pos, pos - src)
                prompt[pos:pos + span] = prompt[src:src + span]
                pos += span
        out.append(TraceEntry(i, t, prompt, m))
    return out


def replay_trace(engine, trace: Sequence[TraceEntry],
                 request_cls=None) -> Dict:
    """Drive ``engine`` with the trace open-loop: requests are submitted
    when their arrival time passes (wall clock, time-shifted to start
    now); the engine steps continuously while it has work or arrivals
    remain.  Returns raw measurements for :func:`latency_report`."""
    if request_cls is None:
        from ..inference.serving import Request as request_cls  # noqa: N806
    reqs = {e.req_id: request_cls(e.req_id, list(e.prompt),
                                  e.max_new_tokens, e.arrival)
            for e in trace}
    pending = sorted(trace, key=lambda e: (e.arrival, e.req_id))
    t0 = time.perf_counter()
    token_times: Dict[int, List[float]] = {e.req_id: [] for e in trace}
    pool_util: List[float] = []
    i = 0
    while i < len(pending) or engine.has_work():
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].arrival <= now:
            engine.submit(reqs[pending[i].req_id])
            i += 1
        if not engine.has_work():
            if i < len(pending):  # idle until the next arrival
                time.sleep(min(pending[i].arrival - now, 0.05))
            continue
        for ev in engine.step(now):
            token_times[ev.req_id].append(ev.time)
        kv = getattr(engine, "kv", None) or getattr(
            getattr(engine, "core", None), "kv", None)
        if kv is not None:
            pool_util.append(kv.utilization())
    elapsed = time.perf_counter() - t0
    return {
        "requests": reqs,
        "token_times": token_times,
        "elapsed_s": elapsed,
        "pool_utilization": pool_util,
    }


def pct(xs: List[float], q: float) -> float:
    """Percentile with the empty-list NaN convention every serving
    report shares."""
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def latency_report(raw: Dict) -> Dict:
    """tokens/s + per-token latency percentiles from a replay.

    Per-token latency is the request-level inter-token gap (first token
    measured from arrival — TTFT folds into the same distribution the
    way per-token SLOs are usually quoted); preempted-and-restarted
    requests contribute their FINAL run's tokens only (out_tokens is
    reset on preemption), so a preemption shows up as a long gap, not a
    double count."""
    reqs = raw["requests"]
    gaps: List[float] = []
    ttft: List[float] = []
    total_tokens = 0
    for rid, times in raw["token_times"].items():
        req = reqs[rid]
        n_final = len(req.out_tokens)
        times = times[-n_final:] if n_final else []
        total_tokens += len(times)
        prev = req.arrival_time
        for j, t in enumerate(times):
            gaps.append(t - prev)
            if j == 0:
                ttft.append(t - req.arrival_time)
            prev = t
    # a shed request (admission.py slo_aware policy) is a TERMINAL
    # outcome, not a hang: it is counted on its own line
    shed = sum(1 for r in reqs.values()
               if getattr(r, "shed_at", None) is not None)
    unfinished = sum(1 for r in reqs.values()
                     if r.finished_at is None
                     and getattr(r, "shed_at", None) is None)
    util = raw["pool_utilization"]
    return {
        "num_requests": len(reqs),
        "unfinished": unfinished,
        "shed": shed,
        "total_tokens": total_tokens,
        "elapsed_s": round(raw["elapsed_s"], 4),
        "tokens_per_s": round(total_tokens / max(raw["elapsed_s"], 1e-9), 2),
        "p50_token_latency_s": round(pct(gaps, 50), 5),
        "p99_token_latency_s": round(pct(gaps, 99), 5),
        "p50_ttft_s": round(pct(ttft, 50), 5),
        "kv_util_mean": round(float(np.mean(util)), 4) if util else 0.0,
        "kv_util_peak": round(float(np.max(util)), 4) if util else 0.0,
    }


def per_request_latency(raw: Dict) -> Dict:
    """Per-request TTFT + decode gaps from a replay — the INDEPENDENT
    per-request view the online SLO tracker (utils/telemetry.py
    SLOTracker) is reconciled against: same final-run convention as :func:`latency_report` (preempted
    runs' tokens retroactively dropped, first gap from arrival)."""
    out: Dict = {}
    for rid, times in raw["token_times"].items():
        req = raw["requests"][rid]
        n_final = len(req.out_tokens)
        times = times[-n_final:] if n_final else []
        gaps, prev = [], req.arrival_time
        for t in times:
            gaps.append(t - prev)
            prev = t
        out[rid] = {
            "ttft_s": gaps[0] if gaps else float("nan"),
            "decode_gaps": gaps[1:],
            "tokens": len(times),
            "finished": req.finished_at is not None,
            "shed": getattr(req, "shed_at", None) is not None,
            "preemptions": req.preemptions,
        }
    return out


def emit_json(tag: str, payload: Dict) -> str:
    """The stable one-line ``TAG={json}`` report line: greppable, and
    diffable between runs."""
    line = tag + "=" + json.dumps(payload, sort_keys=True)
    print(line)
    return line
