"""Request-scoped tracing (``FLAGS_trace_requests``).

Counterpart of ``paddle_tpu/utils/tracing.py`` for the serving engine: a
span tree per request — submit → queue-wait → prefill → each decode-step
batch → preempt/resume cycles → finish / reject / shed — recorded by
``inference/serving.py`` and, while a profiler session is on, emitted
as complete events on the ``request`` lane (``profiler.py``, one row
per trace).  The parameter-server context propagation of the JAX module
(``server_span``, ``context_meta``) and ``start_request_trace`` wait for
the parameter-server port (ROADMAP.md).

Design rules:

* **Determinism** — trace ids and the head-based sampling decision are
  pure functions of ``(FLAGS_trace_seed, req_id)`` (crc32, no process
  RNG), and span ids are allocated sequentially per trace, so a seeded
  trace replays to an identical *structural* span stream
  (:func:`span_stream` leaves out the wall-clock fields).
* **Two clocks per span** — ``t0``/``t1`` carry the engine's LOGICAL
  time (the ``now`` the caller passes to ``step``), ``wall0``/``wall1``
  ``perf_counter`` stamps.
* **Cardinality discipline** — per-request values live in span
  attributes, never in telemetry labels (telemetry.LABEL_DENYLIST); a
  histogram bucket may carry one trace id as an exemplar.
* **Off is free** — with ``FLAGS_trace_requests=0`` (default) every
  entry point short-circuits on one flag check.

Memory is bounded: the store keeps the most recent :data:`MAX_TRACES`
traces and each trace at most :data:`MAX_SPANS_PER_TRACE` spans (extra
spans count in ``trace.dropped``).
"""
from __future__ import annotations

import contextlib
import threading
import time
import zlib
from collections import OrderedDict
from typing import List, Optional, Tuple

from . import flags

__all__ = [
    "Span", "Trace", "TraceStore", "MAX_TRACES", "MAX_SPANS_PER_TRACE",
    "enabled", "sampled", "trace_id_for", "new_trace", "store", "reset",
    "current", "use_span", "annotate", "span_stream",
]

#: store keeps this many most-recent traces (older evicted FIFO)
MAX_TRACES = 1024
#: per-trace span bound; extras count in ``trace.dropped``
MAX_SPANS_PER_TRACE = 4096
#: per-span event bound (chaos annotations etc.); extras are dropped —
#: an event source that fires per step must aggregate into an attr
MAX_EVENTS_PER_SPAN = 256

#: one lock for store + span allocation: operations are a few
#: instructions, contention is negligible next to the steps being traced
_LOCK = threading.Lock()


def enabled() -> bool:
    """FLAGS_trace_requests resolved at call time (runtime-toggleable)."""
    return flags.flag_bool("FLAGS_trace_requests")


def _crc(s: str) -> int:
    return zlib.crc32(s.encode()) & 0xFFFFFFFF


def sampled(req_key, seed: Optional[int] = None,
            rate: Optional[float] = None) -> bool:
    """Head-based sampling decision, made ONCE at submit and
    deterministic in (seed, req_key): crc32-hash the pair into [0, 1)
    and compare against FLAGS_trace_sample_rate — the same seeded
    loadgen trace samples the same requests on every replay."""
    if rate is None:
        try:
            rate = float(flags.get_flag("FLAGS_trace_sample_rate"))
        except (TypeError, ValueError):
            rate = 1.0
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    if seed is None:
        seed = int(flags.get_flag("FLAGS_trace_seed") or 0)
    return _crc(f"{seed}:{req_key}") / 4294967296.0 < rate


def trace_id_for(req_key, seed: Optional[int] = None) -> str:
    """Deterministic trace id: readable req key + seeded crc suffix."""
    if seed is None:
        seed = int(flags.get_flag("FLAGS_trace_seed") or 0)
    return f"req-{req_key}-{_crc(f'{seed}:{req_key}'):08x}"


class Span:
    """One node of a request's span tree.  ``t0``/``t1`` logical time,
    ``wall0``/``wall1`` perf_counter; ``events`` are zero-duration
    annotations (chaos injections land here)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "wall0", "wall1", "attrs", "events")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, t0: float,
                 wall0: float, attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.wall0 = wall0
        self.wall1: Optional[float] = None
        self.attrs: dict = dict(attrs or {})
        self.events: List[tuple] = []

    @property
    def ended(self) -> bool:
        return self.wall1 is not None

    def wall_duration(self) -> float:
        return max((self.wall1 or self.wall0) - self.wall0, 0.0)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "t0": self.t0, "t1": self.t1,
            "wall0": self.wall0, "wall1": self.wall1,
            "attrs": dict(self.attrs),
            "events": [{"name": n, "attrs": dict(a)}
                       for n, a in self.events],
        }


class Trace:
    """One request's span list + bookkeeping.  Span ids are allocated
    sequentially under the module lock, so a deterministic scheduling
    sequence yields a deterministic span stream."""

    def __init__(self, trace_id: str, req_id=None):
        self.trace_id = trace_id
        self.req_id = req_id
        self.spans: List[Span] = []
        self.finished = False
        self.dropped = 0
        self._next = 1
        # chrome-trace row: one tid per trace inside the request lane
        self.lane_tid = (_crc(trace_id) & 0x3FFFFFFF) or 1
        # engine bookkeeping (inference/serving.py): the open root span
        # and the currently-open wait span (queue_wait or preempted)
        self._root: Optional[Span] = None
        self._wait: Optional[Span] = None

    # ------------------------------------------------------------------
    def start(self, name: str, t: float = 0.0, parent=None,
              attrs: Optional[dict] = None) -> Span:
        """Open a span (ended later via :meth:`end`).  ``parent`` may be
        a Span or a span-id string; None makes a root-level span."""
        pid = parent.span_id if isinstance(parent, Span) else parent
        with _LOCK:
            sid = f"s{self._next}"
            self._next += 1
            span = Span(self.trace_id, sid, pid, name, t,
                        time.perf_counter(), attrs)
            if len(self.spans) < MAX_SPANS_PER_TRACE:
                self.spans.append(span)
            else:
                self.dropped += 1
        return span

    def end(self, span: Optional[Span], t: Optional[float] = None,
            attrs: Optional[dict] = None):
        """Close a span (idempotent: a second end is a no-op) and emit
        its chrome-trace event when a profiler session is live."""
        if span is None or span.ended:
            return
        span.t1 = span.t0 if t is None else t
        span.wall1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        _emit(self, span)

    def add(self, name: str, t0: float = 0.0, t1: Optional[float] = None,
            wall0: Optional[float] = None, wall1: Optional[float] = None,
            parent=None, attrs: Optional[dict] = None) -> Span:
        """Record an already-timed span (the engine wraps core
        prefill/decode calls and retro-records their wall bounds)."""
        span = self.start(name, t=t0, parent=parent, attrs=attrs)
        if wall0 is not None:
            span.wall0 = wall0
        span.t1 = t0 if t1 is None else t1
        span.wall1 = time.perf_counter() if wall1 is None else wall1
        _emit(self, span)
        return span

    def annotate(self, span: Optional[Span], name: str,
                 attrs: Optional[dict] = None):
        """Zero-duration event ON a span (chaos injections): shows up
        in the span's ``events`` list and in the chrome args as a
        comma-joined name list.  Bounded per span
        (:data:`MAX_EVENTS_PER_SPAN`)."""
        if span is not None and len(span.events) < MAX_EVENTS_PER_SPAN:
            span.events.append((name, dict(attrs or {})))

    def finish(self):
        self.finished = True

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def _emit(trace: Trace, span: Span):
    """Span -> chrome-trace complete event on the per-request lane
    (profiler lane "request", tid = the trace's row).  JSON-safe attrs
    ride along as args; no-op without a live profiler session."""
    from .. import profiler

    if not profiler.is_profiler_enabled():
        return
    args = {"trace": trace.trace_id, "span": span.span_id,
            "parent": span.parent_id or "",
            "req": "" if trace.req_id is None else str(trace.req_id)}
    for k, v in span.attrs.items():
        if isinstance(v, (bool, int, float, str)):
            args[k] = v
    if span.events:
        args["events"] = ",".join(n for n, _ in span.events)
    profiler.complete_event(span.name, cat="request", ts=span.wall0,
                            dur=span.wall_duration(),
                            tid=trace.lane_tid, args=args)


class TraceStore:
    """Process-global bounded trace table (most recent MAX_TRACES)."""

    def __init__(self):
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()

    def register(self, trace: Trace) -> Trace:
        with _LOCK:
            while len(self._traces) >= MAX_TRACES:
                self._traces.popitem(last=False)
            self._traces[trace.trace_id] = trace
        return trace

    def get(self, trace_id: str) -> Optional[Trace]:
        with _LOCK:
            return self._traces.get(trace_id)

    def traces(self) -> List[Trace]:
        with _LOCK:
            return list(self._traces.values())

    def finished_traces(self) -> List[Trace]:
        with _LOCK:
            return [t for t in self._traces.values() if t.finished]

    def reset(self):
        with _LOCK:
            self._traces.clear()


_STORE = TraceStore()


def store() -> TraceStore:
    return _STORE


def reset():
    """Drop every recorded trace (tests / fresh measurement windows)."""
    _STORE.reset()


def new_trace(req_id) -> Trace:
    """Create + register a trace with the deterministic id for req_id."""
    return _STORE.register(Trace(trace_id_for(req_id), req_id))


# -- context propagation (thread-local span stack) -------------------------
_ctx = threading.local()


def _stack() -> list:
    st = getattr(_ctx, "stack", None)
    if st is None:
        st = _ctx.stack = []
    return st


def current() -> Optional[Tuple[Trace, Span]]:
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def use_span(trace: Trace, span: Span):
    """Make (trace, span) the thread's current context — chaos
    annotations attach to whatever is current."""
    _stack().append((trace, span))
    try:
        yield span
    finally:
        _stack().pop()


def annotate(name: str, attrs: Optional[dict] = None):
    """Event on the current span, if any (chaos hook entry point)."""
    c = current()
    if c is not None:
        c[0].annotate(c[1], name, attrs)


def span_stream(traces: Optional[List[Trace]] = None) -> list:
    """Canonical STRUCTURAL event stream for determinism tests: per
    trace, each span's (name, parent-name, logical t0/t1, sorted attrs,
    event names) in record order — wall-clock fields excluded (they
    differ run to run), logical fields kept (the engine's ``now`` is
    part of the replayed schedule)."""
    ts = _STORE.traces() if traces is None else traces
    out = []
    for tr in ts:
        names = {s.span_id: s.name for s in tr.spans}
        out.append((tr.req_id, tr.trace_id, tr.finished, tuple(
            (s.name, names.get(s.parent_id), s.t0, s.t1,
             tuple(sorted((k, str(v)) for k, v in s.attrs.items())),
             tuple(n for n, _ in s.events))
            for s in tr.spans)))
    return out
