"""Deterministic serving fault injection (``FLAGS_chaos``).

Counterpart of the serving part of ``paddle_tpu/utils/chaos.py``: the
same schedule grammar, ``;``-separated events, of which the port takes

    seed=N                 RNG seed for probabilistic events (default 0)
    decode_delay=MS@N      sleep MS ms before the Nth batched decode
                           step (1-based, counted per process run)
    decode_delay=MS:P      sleep MS ms before each decode step with
                           probability P (seeded)
    req_burst=N@K          at serving step K, queue N extra synthetic
                           requests for the load generator to inject
                           (:func:`take_burst`: the engine cannot make
                           requests itself)
    pool_spike=P@K:D       at serving step K, seize up to P KV-pool
                           pages for D steps (default 4): admission
                           backpressure and preemption pressure on
                           demand.  Only refcount-0 pages are seized (a
                           live shared prefix is never taken), and they
                           return through the allocator's normal free
                           path

The training faults of the JAX grammar (``kill``, ``rpc_drop``,
``rpc_delay``, ``trunc_ckpt``, ``nan_inject``) raise
``NotImplementedError`` until the training hooks they drive are ported
(ROADMAP.md); an unknown token raises ``ValueError``.

The serving engine calls :func:`on_serving_step` at the start of every
step and :func:`on_decode_step` before every batched decode.  With
``FLAGS_chaos`` unset each hook is one cached ``None`` check.  Every
injection counts in ``chaos_injections_total{kind=}``, annotates the
current request span and marks the ``chaos`` profiler lane.
"""
from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Optional

from . import flags

__all__ = ["FaultSchedule", "SERVING_FAULT_KEYS", "TRAINING_FAULT_KEYS",
           "schedule", "reset", "on_serving_step", "on_decode_step",
           "take_burst"]

#: the fault kinds the port injects: they act inside a serving step loop
SERVING_FAULT_KEYS = frozenset({"decode_delay", "req_burst", "pool_spike"})
#: the JAX grammar's training faults, not ported
TRAINING_FAULT_KEYS = frozenset({"kill", "rpc_drop", "rpc_delay",
                                 "trunc_ckpt", "nan_inject"})


class FaultSchedule:
    """Parsed FLAGS_chaos schedule.  All state (decode counter, pending
    bursts, live spikes, RNG) lives here, so determinism is per process
    run."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self.decode_delay_ms = 0.0
        self.decode_delay_p = 0.0
        self.decode_delay_at = {}          # 1-based decode step -> ms
        self.burst_at = {}                 # serving step -> extra requests
        self.spike_at = {}                 # serving step -> (pages, steps)
        self._decode_n = 0
        self._burst_pending = 0
        self._spike_live = []              # [(release_step, kv weakref, sid)]
        self._lock = threading.Lock()
        self._parse(spec)
        self._rng = random.Random(self.seed)

    def _parse(self, spec: str):
        for raw in spec.split(";"):
            item = raw.strip()
            if not item:
                continue
            key, _, val = item.partition("=") if "=" in item else \
                item.partition("@")
            key, val = key.strip(), val.strip()
            if key == "seed":
                self.seed = int(val)
            elif key == "decode_delay":
                try:
                    if "@" in val:
                        ms, _, n = val.partition("@")
                        self.decode_delay_at[int(n)] = self._ms(ms, item)
                    else:
                        ms, _, p = val.partition(":")
                        self.decode_delay_ms = self._ms(ms, item)
                        self.decode_delay_p = float(p or 1.0)
                except ValueError as e:
                    raise ValueError(
                        f"FLAGS_chaos: decode_delay needs MS@N or "
                        f"MS[:P], got {item!r}") from e
            elif key == "req_burst":
                n, _, at = val.partition("@")
                if not at:
                    raise ValueError(
                        f"FLAGS_chaos: req_burst needs N@STEP, got {item!r}")
                self.burst_at[int(at)] = self.burst_at.get(int(at), 0) \
                    + int(n)
            elif key == "pool_spike":
                pages, _, at = val.partition("@")
                if not at:
                    raise ValueError(
                        f"FLAGS_chaos: pool_spike needs PAGES@STEP[:STEPS], "
                        f"got {item!r}")
                step, _, dur = at.partition(":")
                self.spike_at[int(step)] = (int(pages), int(dur or 4))
            elif key in TRAINING_FAULT_KEYS:
                raise NotImplementedError(
                    f"FLAGS_chaos: the training fault {item!r} is not "
                    f"ported to paddle_tpu_torch yet (ROADMAP.md); the "
                    f"port injects {sorted(SERVING_FAULT_KEYS)}")
            else:
                raise ValueError(f"FLAGS_chaos: unknown event {item!r}")

    @staticmethod
    def _ms(ms: str, item: str) -> float:
        """Strict milliseconds: an empty or non-numeric MS is a parse
        error, never a silently armed 0 ms no-op."""
        ms = ms.strip().rstrip("ms").strip()
        if not ms:
            raise ValueError(f"FLAGS_chaos: missing MS value in {item!r}")
        return float(ms)

    # -- hooks -------------------------------------------------------------
    def on_decode_step(self):
        """Once per batched decode step: sleep before the Nth (or each,
        with probability P) decode."""
        with self._lock:
            self._decode_n += 1
            n = self._decode_n
            ms = self.decode_delay_at.get(n, 0.0)
            if (not ms and self.decode_delay_ms > 0
                    and self._rng.random() < self.decode_delay_p):
                ms = self.decode_delay_ms
        if ms:
            self._mark("decode_delay", "decode", n, f"{ms}ms")
            time.sleep(ms / 1e3)

    def on_serving_step(self, engine, step: int):
        """At engine step ``step`` (the engine's own 1-based counter):
        apply and release pool spikes, queue request bursts.  Keyed on
        the step index, never on wall time."""
        burst = self.burst_at.get(step, 0)
        if burst:
            with self._lock:
                self._burst_pending += burst
            self._mark("req_burst", "serving", step, f"{burst}req")
        kv = getattr(engine, "kv", None)
        if kv is None:
            return
        with self._lock:
            # release this engine's spikes only (two engines may share one
            # schedule with their own step counters); dead engines' entries
            # are pruned, never freed against another pool
            release, keep = [], []
            for rel, kvref, sid in self._spike_live:
                target = kvref()
                if target is None:
                    continue
                if target is kv and rel <= step:
                    release.append(sid)
                else:
                    keep.append((rel, kvref, sid))
            self._spike_live = keep
            spike = self.spike_at.get(step)
        for sid in release:
            kv.free_sequence(sid)
        if spike:
            pages, dur = spike
            sid = f"__chaos_spike_{step}__"
            got = 0
            for _ in range(pages):
                # one full page per append, stopping at exhaustion (a spike
                # squeezes the pool, it never deadlocks it); tokens=None
                # marks the sequence opaque, so its pages are never indexed
                if kv.append_tokens(sid, engine.core.kv_config.page_size,
                                    tokens=None) is None:
                    break
                got += 1
            if got:
                with self._lock:
                    self._spike_live.append(
                        (step + dur, weakref.ref(kv), sid))
                self._mark("pool_spike", "serving", step, f"{got}pg")

    def take_burst(self) -> int:
        """Pop the pending burst count (the load generator's side of
        req_burst)."""
        with self._lock:
            n = self._burst_pending
            self._burst_pending = 0
            return n

    def _mark(self, kind: str, phase: str, n: int, op: str):
        """An injected fault: the counter, an annotation on the current
        request span, and an instant on the ``chaos`` profiler lane."""
        from .. import profiler
        from . import telemetry as tm
        from . import tracing

        tm.counter("chaos_injections_total",
                   "faults injected by the FLAGS_chaos schedule",
                   labels=("kind",)).labels(kind=kind).inc()
        tracing.annotate(f"chaos:{kind}",
                         {"phase": phase, "n": n, "op": op or "?",
                          "seed": self.seed})
        profiler.instant_event(
            f"chaos:{kind}", cat="chaos",
            args={"phase": phase, "n": n, "op": op or "?"})


_cached: Optional[FaultSchedule] = None
_cached_spec: Optional[str] = None
_cache_lock = threading.Lock()


def schedule() -> Optional[FaultSchedule]:
    """The process's schedule (parsed from FLAGS_chaos), or None.  Cached
    on the spec string: a new FLAGS_chaos value starts a fresh schedule."""
    global _cached, _cached_spec
    spec = str(flags.get_flag("FLAGS_chaos") or "")
    if not spec.strip():
        return None
    with _cache_lock:
        if spec != _cached_spec:
            _cached = FaultSchedule(spec)
            _cached_spec = spec
        return _cached


def reset():
    """Drop the cached schedule (re-arm the same spec string)."""
    global _cached, _cached_spec
    with _cache_lock:
        _cached = None
        _cached_spec = None


def on_serving_step(engine, step: int):
    s = schedule()
    if s is not None:
        s.on_serving_step(engine, step)


def on_decode_step():
    s = schedule()
    if s is not None:
        s.on_decode_step()


def take_burst() -> int:
    s = schedule()
    return s.take_burst() if s is not None else 0
