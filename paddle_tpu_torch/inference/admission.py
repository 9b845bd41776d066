"""Pluggable admission / preemption policies for the serving engine
(counterpart of ``paddle_tpu/inference/admission.py``, whole).

The ``ServingEngine`` consults one policy object at fixed points of its
step loop:

* ``shed(engine, now)``    — queued requests to reject with an explicit
  ``shed`` outcome (traced + countered, distinct from the unservable
  submit rejection) BEFORE this step's admission;
* ``order(engine, now)``   — reorder the waiting queue (admission still
  takes the head, so head-of-line semantics — and the backpressure
  break — are policy-independent);
* ``victim_index(running)``— which running sequence to preempt when the
  pool can no longer grow every sequence by one token.

Policies:

``fifo`` (default, ``FLAGS_admission_policy``)
    Never sheds, never reorders, victim = youngest (index -1).

``slo_aware``
    * **Admission order** = remaining SLO slack, least first (earliest
      effective deadline first).  Slack is the declared TTFT target —
      scaled down by the live error-budget burn rate from
      ``ServingEngine.slo_hint()`` (burn > 1 means the budget drains
      unsustainably, so the headroom shrinks) — minus the time the
      request has been queued (the open ``queue_wait``/``preempted``
      span, equivalently ``now - arrival_time``).  With no TTFT target
      declared, slack degenerates to ``-waited`` and the order is
      FIFO's.
    * **Shedding**: a queued request is shed when its predicted TTFT
      under the current burn rate can no longer meet the target —
      ``waited * max(burn_rate, 1) > ttft_target``.  At sustainable
      burn (<= 1) only mathematically-certain misses shed (TTFT is
      measured from arrival, so it can never come in below the time
      already waited); as the budget burns faster the threshold
      tightens, shedding *early* so admitted requests keep their SLO
      instead of every request missing it.
    * **Preemption victim** = least lost work: the sequence whose
      eviction wastes the fewest recomputed tokens on resume (the
      prompt is re-prefilled and every decoded token of the current run
      is regenerated — :func:`lost_work_cost`, read off the request's
      span tree when it is traced).  Ties break youngest-first, so the
      choice is deterministic for a seeded trace.

Every decision is a pure function of (waiting queue, running set,
logical ``now``, SLO-tracker state) — all of which replay identically
for a seeded trace driven on a deterministic clock.
"""
from __future__ import annotations

from typing import List, Optional

from ..utils.flags import get_flag

__all__ = [
    "AdmissionPolicy", "FIFOPolicy", "SLOAwarePolicy", "RequestRejected",
    "get_policy", "lost_work_cost", "POLICIES",
]


class RequestRejected(ValueError):
    """Submit-time rejection carrying a machine-readable reason code
    (``max_seq_len`` / ``pool`` / ``budget``) for the labeled
    ``serving_rejects_total{reason=}`` counter and the reject-span
    annotation.  A plain ``ValueError`` to callers (API unchanged)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


def lost_work_cost(req) -> int:
    """Tokens recomputed if ``req`` is preempted now and later resumed:
    the prompt is re-prefilled and every decoded token of the CURRENT
    run is regenerated one decode step at a time.  SHARED-PAGE-AWARE:
    prompt tokens the last prefill served from cached prefix pages are
    subtracted — a resume re-acquires them from the index instead of
    recomputing (0 with the prefix cache off).  SPEC-DECODE-AWARE:
    a speculative decode_step emits ``accepted + 1`` tokens in one
    verify call, so its span counts that many — only ACCEPTED tokens
    are lost work; rejected drafts were never emitted and cost nothing
    to regenerate (spans without the ``accepted`` attr count 1, so the
    cost is unchanged with spec off).  Read off the span tree when the
    request is traced (prompt_tokens / cached_tokens attrs of the last
    prefill + accepted+1 per decode_step span — the prefill itself
    emits one token); identical to the untraced fallback
    ``len(prompt) - _prefix_hit + len(out_tokens)`` by construction."""
    tr = getattr(req, "trace", None)
    if tr is not None:
        names = [s.name for s in tr.spans]
        if "prefill" in names:
            last = len(names) - 1 - names[::-1].index("prefill")
            prompt = tr.spans[last].attrs.get(
                "prompt_tokens", len(req.prompt))
            cached = tr.spans[last].attrs.get("cached_tokens", 0)
            decoded = sum(
                int(s.attrs.get("accepted", 0)) + 1
                for s in tr.spans[last:] if s.name == "decode_step")
            return int(prompt) - int(cached) + 1 + decoded
    return (len(req.prompt) - int(getattr(req, "_prefix_hit", 0))
            + len(req.out_tokens))


class AdmissionPolicy:
    """Base policy = FIFO behavior (every hook a no-op)."""

    name = "base"

    def shed(self, engine, now: float) -> List:
        """Queued requests to shed before this step's admission."""
        return []

    def order(self, engine, now: float) -> None:
        """Reorder ``engine.waiting`` in place (admission takes the
        head)."""

    def victim_index(self, running) -> int:
        """Index into ``running`` of the preemption victim."""
        return -1


class FIFOPolicy(AdmissionPolicy):
    """Submit-order admission, youngest-first preemption, no shedding
    (the default)."""

    name = "fifo"


class SLOAwarePolicy(AdmissionPolicy):
    """Burn-rate-driven admission order, early shedding, and
    least-lost-work preemption (see the module docstring)."""

    name = "slo_aware"

    def __init__(self):
        # one slo_hint() read per engine step: shed() and order() must
        # see the SAME (target, burn) snapshot — and the hint walks the
        # tracker's rolling window under its lock, so reading it twice
        # per decode step is also wasted hot-path work
        self._hint_key = None
        self._hint_val = (None, 1.0)

    def _hint(self, engine):
        key = (id(engine), getattr(engine, "_step_no", None))
        if key != self._hint_key or key[1] is None:
            hint = engine.slo_hint()
            targets = hint.get("targets") or {}
            burn = max(float(hint.get("burn_rate") or 0.0), 1.0)
            self._hint_key = key
            self._hint_val = (targets.get("ttft_s"), burn)
        return self._hint_val

    @staticmethod
    def slack(req, now: float, ttft_s: Optional[float],
              burn: float) -> float:
        waited = now - req.arrival_time
        if ttft_s is None:
            return -waited
        return ttft_s / burn - waited

    def shed(self, engine, now: float) -> List:
        ttft_s, burn = self._hint(engine)
        if ttft_s is None:
            return []
        return [r for r in engine.waiting
                if (now - r.arrival_time) * burn > ttft_s]

    def order(self, engine, now: float) -> None:
        ttft_s, burn = self._hint(engine)
        engine.waiting.sort(
            key=lambda r: (self.slack(r, now, ttft_s, burn),
                           getattr(r, "_seq", 0)))

    def victim_index(self, running) -> int:
        best, best_key = -1, None
        for i, st in enumerate(running):
            key = (lost_work_cost(st.req), -i)  # ties: youngest
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best


POLICIES = {FIFOPolicy.name: FIFOPolicy, SLOAwarePolicy.name: SLOAwarePolicy}


def get_policy(name=None) -> AdmissionPolicy:
    """Resolve a policy: an ``AdmissionPolicy`` instance passes through
    (the pluggable path), a string names a registered policy, ``None``
    reads ``FLAGS_admission_policy`` (default ``fifo``)."""
    if isinstance(name, AdmissionPolicy):
        return name
    if name is None:
        name = get_flag("FLAGS_admission_policy") or "fifo"
    key = str(name).strip().lower()
    if key not in POLICIES:
        raise ValueError(
            f"unknown admission policy {name!r}: expected one of "
            f"{sorted(POLICIES)} (FLAGS_admission_policy)")
    return POLICIES[key]()
