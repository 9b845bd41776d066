"""Runtime telemetry of the port: one process-wide metrics registry.

Counterpart of ``paddle_tpu/utils/telemetry.py``, whole.  The serving
engine and the KV allocator publish to it; ``snapshot()`` and
``to_prometheus()`` read it out.

Three instrument kinds, Prometheus-shaped:

* :class:`Counter` — monotonically increasing float (``inc``);
* :class:`Gauge` — set-to-current-value float (``set``/``inc``);
* :class:`Histogram` — fixed log-spaced buckets (4 per decade,
  1 µs … 1000 s) with ``sum`` and ``count``, plus quantile
  *bracketing* (``quantile_bounds``), so a reported p50/p99 carries its
  bucket-resolution error bars.

Instruments are **labeled families**: ``counter("serving_rejects_total",
labels=("reason",)).labels(reason="pool").inc()``.  Label cardinality is
bounded per family (:data:`MAX_SERIES`); combinations past the bound
collapse into one shared overflow series.

Gating — ``FLAGS_telemetry`` (default on): when off, the module-level
factories return the shared :data:`NOOP` instrument, whose every method
is a no-op, so no registry state is touched.

The SLO tracker (:class:`SLOTracker`, ``FLAGS_slo_*``) judges every
finished serving request against the declared targets and gives the
``slo_aware`` admission policy its burn rate.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .flags import flag_bool, flag_float

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "NOOP", "MAX_SERIES",
    "LABEL_DENYLIST", "SLOTargets", "SLOTracker", "UNSET",
    "enabled", "registry", "counter", "gauge", "histogram",
    "snapshot", "to_prometheus", "default_buckets",
    "slo_tracker", "reset_slo",
]

#: per-family bound on distinct label combinations; the 65th and later
#: combinations share one overflow series (label values all "~overflow")
MAX_SERIES = 64

#: label keys the registry REJECTS at family creation: per-request
#: identifiers mint one series per request — unbounded cardinality by
#: construction (the overflow series would merely hide it).  Per-request
#: values belong in span attributes (utils/tracing.py); a histogram
#: bucket may carry ONE trace id as an exemplar instead.
LABEL_DENYLIST = frozenset({
    "request_id", "req_id", "req", "trace_id", "span_id",
})

#: label-values tuple of the shared overflow series
OVERFLOW = "~overflow"


def enabled() -> bool:
    """FLAGS_telemetry resolved at call time (runtime-toggleable)."""
    return flag_bool("FLAGS_telemetry")


class _Noop:
    """The shared off-path instrument: every method is a no-op and
    ``labels()`` returns the same singleton, so an instrumented call
    site costs one flag check and zero allocations when telemetry is
    off."""

    __slots__ = ()

    def inc(self, value=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value, exemplar=None):
        pass

    def labels(self, **kv):
        return self

    def get(self):
        return 0.0


NOOP = _Noop()


def default_buckets() -> List[float]:
    """Fixed log-spaced bucket upper bounds in seconds: 4 per decade
    from 1e-6 to 1e+3 (37 edges; one implicit +inf overflow bucket).
    Shared by every histogram so exposition rows line up."""
    return [10.0 ** (-6 + i / 4.0) for i in range(37)]


_DEFAULT_BUCKETS = tuple(default_buckets())


class _Child:
    """One labeled series.  All mutation goes through the family lock —
    increments are a few instructions, contention is negligible next to
    the step/RPC work being measured."""

    __slots__ = ("_lock", "_labels")

    def __init__(self, lock, labels: Tuple[str, ...]):
        self._lock = lock
        self._labels = labels


class Counter(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock, labels):
        super().__init__(lock, labels)
        self._value = 0.0

    def inc(self, value: float = 1.0):
        if value < 0:
            raise ValueError("Counter.inc value must be >= 0")
        with self._lock:
            self._value += value

    def get(self) -> float:
        return self._value


class Gauge(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock, labels):
        super().__init__(lock, labels)
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0):
        with self._lock:
            self._value += value

    def get(self) -> float:
        return self._value


class Histogram(_Child):
    __slots__ = ("_edges", "_counts", "_sum", "_count", "_min", "_max",
                 "_exemplars", "_nonfinite")

    def __init__(self, lock, labels, edges=_DEFAULT_BUCKETS):
        super().__init__(lock, labels)
        self._edges = edges
        self._counts = [0] * (len(edges) + 1)  # last = +inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        # non-finite observations land HERE, never in the buckets:
        # bisect_right(edges, nan) files NaN into an arbitrary bucket
        # and one NaN makes _sum/_min/_max NaN forever, silently
        # poisoning every later quantile bracket.  (SLOTracker
        # legitimately feeds NaN TTFTs for zero-token requests.)
        self._nonfinite = 0
        # bucket index -> last exemplar (a trace id): the histogram ->
        # trace link, one string per bucket — bounded by construction
        self._exemplars: Dict[int, str] = {}

    def observe(self, value: float, exemplar: Optional[str] = None):
        v = float(value)
        if not math.isfinite(v):
            with self._lock:
                self._nonfinite += 1
            return
        i = bisect_right(self._edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[i] = str(exemplar)

    def get(self) -> float:
        """Mean observation (the scalar view other kinds expose)."""
        return self._sum / self._count if self._count else 0.0

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def nonfinite(self) -> int:
        """Observations excluded from buckets/sum for being NaN/Inf."""
        return self._nonfinite

    def _bucket_of_rank(self, k: int) -> int:
        """Index of the bucket holding the k-th (0-based) observation."""
        c = 0
        for i, n in enumerate(self._counts):
            c += n
            if k < c:
                return i
        return len(self._counts) - 1

    def _bounds_of_bucket(self, i: int) -> Tuple[float, float]:
        lo = self._edges[i - 1] if i > 0 else 0.0
        hi = self._edges[i] if i < len(self._edges) else math.inf
        # tighten by the actually observed extremes (exact, cheap)
        if self._count:
            lo = max(lo, self._min) if self._min <= hi else lo
            hi = min(hi, self._max) if self._max >= lo else hi
        return lo, hi

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """(lo, hi) provably bracketing the q-quantile under the
        linear-interpolation rank convention numpy uses: lo is the
        lower edge of the bucket holding the floor-rank sample, hi the
        upper edge of the bucket holding the ceil-rank sample.  The
        exact sample-level quantile (utils/loadgen.py's percentile)
        always lies inside — the property the serving p50/p99 test
        pins.  (nan, nan) when empty."""
        with self._lock:
            n = self._count
            if n == 0:
                return (math.nan, math.nan)
            pos = min(max(q, 0.0), 1.0) * (n - 1)
            lo_b = self._bucket_of_rank(int(math.floor(pos)))
            hi_b = self._bucket_of_rank(int(math.ceil(pos)))
            return (self._bounds_of_bucket(lo_b)[0],
                    self._bounds_of_bucket(hi_b)[1])

    def quantile(self, q: float) -> float:
        """Point estimate: geometric midpoint of the bracketing bounds
        (log-spaced buckets make the geometric mean the unbiased
        choice); falls back to the finite edge when one side is 0/inf."""
        lo, hi = self.quantile_bounds(q)
        if math.isnan(lo):
            return math.nan
        if lo > 0 and math.isfinite(hi):
            return math.sqrt(lo * hi)
        return lo if not math.isfinite(hi) else hi

    def exemplar_for_quantile(self, q: float) -> Optional[str]:
        """The trace id linked to the bucket holding the q-quantile
        sample — "the p99 bucket names a trace you can pull up".  Falls
        back to the nearest bucket with an exemplar when that exact
        bucket recorded none (samples may be observed exemplar-less)."""
        with self._lock:
            if not self._count or not self._exemplars:
                return None
            pos = min(max(q, 0.0), 1.0) * (self._count - 1)
            b = self._bucket_of_rank(int(math.ceil(pos)))
            if b in self._exemplars:
                return self._exemplars[b]
            for i in range(b - 1, -1, -1):
                if i in self._exemplars:
                    return self._exemplars[i]
            for i in range(b + 1, len(self._counts)):
                if i in self._exemplars:
                    return self._exemplars[i]
            return None


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named instrument family: fixed kind + label names, bounded set
    of labeled children."""

    def __init__(self, name: str, kind: str, help_: str,
                 label_names: Tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not label_names:  # unlabeled: the family IS its only child
            self._default = self._make(())
        else:
            self._default = None

    def _make(self, values: Tuple[str, ...]) -> _Child:
        return _KINDS[self.kind](self._lock, values)

    def labels(self, **kv) -> _Child:
        if not self.label_names:
            if kv:
                raise ValueError(f"{self.name} declares no labels")
            return self._only()
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        values = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= MAX_SERIES:
                    values = (OVERFLOW,) * len(self.label_names)
                    child = self._children.get(values)
                    if child is None:
                        child = self._make(values)
                        self._children[values] = child
                else:
                    child = self._make(values)
                    self._children[values] = child
            return child

    # unlabeled convenience: the family proxies its single child
    def _only(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled {self.label_names}: call "
                f".labels(...) first")
        return self._default

    def inc(self, value: float = 1.0):
        return self._only().inc(value)

    def set(self, value: float):
        return self._only().set(value)

    def observe(self, value: float, exemplar=None):
        return self._only().observe(value, exemplar)

    def get(self):
        return self._only().get()

    # delegated Histogram views (unlabeled convenience)
    @property
    def count(self):
        return self._only().count

    @property
    def sum(self):
        return self._only().sum

    @property
    def nonfinite(self):
        return self._only().nonfinite

    def quantile(self, q: float):
        return self._only().quantile(q)

    def quantile_bounds(self, q: float):
        return self._only().quantile_bounds(q)

    def exemplar_for_quantile(self, q: float):
        return self._only().exemplar_for_quantile(q)

    def series(self) -> Dict[Tuple[str, ...], _Child]:
        with self._lock:
            if self._default is not None:  # unlabeled family
                return {(): self._default}
            return dict(self._children)

    def reset(self):
        with self._lock:
            for values in list(self._children):
                self._children[values] = self._make(values)
            if self._default is not None:
                self._default = self._make(())


class Registry:
    """Process-wide family table.  ``counter``/``gauge``/``histogram``
    are idempotent get-or-create (re-declaring with a different kind or
    label set is an error — two subsystems fighting over one name is a
    bug worth surfacing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help_: str,
                labels: Sequence[str]) -> _Family:
        label_names = tuple(labels)
        bad = sorted(l for l in label_names if l in LABEL_DENYLIST)
        if bad:
            raise ValueError(
                f"telemetry instrument {name!r}: label key(s) {bad} are "
                f"per-request identifiers — one series per request is "
                f"unbounded cardinality.  Put per-request values in span "
                f"attributes (utils/tracing.py) or link a trace id as a "
                f"histogram exemplar instead.")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, label_names)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != label_names:
            raise ValueError(
                f"telemetry instrument {name!r} re-declared as "
                f"{kind}{label_names} (was {fam.kind}{fam.label_names})")
        return fam

    def counter(self, name, help="", labels=()) -> _Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()) -> _Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=()) -> _Family:
        return self._family(name, "histogram", help, labels)

    def reset(self):
        """Zero every series, keep the families (between a warm-up and
        a measured run)."""
        with self._lock:
            fams = list(self._families.values())
        for f in fams:
            f.reset()

    def clear(self):
        """Drop everything (tests: a pristine registry)."""
        with self._lock:
            self._families.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict:
        """One JSON-able dict: {name: {type, help, labels, series: [...]}}.
        Histogram series carry cumulative bucket counts as [le, count]
        pairs (Prometheus ``le`` convention) plus sum/count/min/max."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = dict(self._families)
        for name, fam in sorted(fams.items()):
            rows = []
            for values, child in sorted(fam.series().items()):
                row = {"labels": dict(zip(fam.label_names, values))}
                if fam.kind == "histogram":
                    cum = 0
                    buckets = []
                    for i, c in enumerate(child._counts):
                        cum += c
                        le = (child._edges[i] if i < len(child._edges)
                              else math.inf)
                        if c or le is math.inf:
                            buckets.append([le if math.isfinite(le)
                                            else "+Inf", cum])
                    row.update({
                        "count": child._count,
                        "sum": child._sum,
                        "min": (child._min if child._count else None),
                        "max": (child._max if child._count else None),
                        "buckets": buckets,
                    })
                    if child._nonfinite:
                        # only when observed: a zero field on every row
                        # would churn existing snapshot consumers
                        row["nonfinite"] = child._nonfinite
                    # copy under the child lock: a concurrent observe
                    # may INSERT a bucket key (the other lockless reads
                    # here are fixed-size lists/scalars)
                    with child._lock:
                        exemplars = dict(child._exemplars)
                    if exemplars:
                        row["exemplars"] = {
                            (repr(child._edges[i])
                             if i < len(child._edges) else "+Inf"): ex
                            for i, ex in sorted(exemplars.items())}
                else:
                    row["value"] = child.get()
                rows.append(row)
            out[name] = {"type": fam.kind, "help": fam.help,
                         "labels": list(fam.label_names), "series": rows}
        return out

    def to_prometheus(self) -> str:
        """Standard text exposition (histograms: _bucket/_sum/_count)."""
        lines: List[str] = []
        with self._lock:
            fams = dict(self._families)
        for name, fam in sorted(fams.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for values, child in sorted(fam.series().items()):
                lab = ",".join(f'{k}="{v}"'
                               for k, v in zip(fam.label_names, values))
                if fam.kind == "histogram":
                    cum = 0
                    for i, c in enumerate(child._counts):
                        cum += c
                        le = (repr(child._edges[i])
                              if i < len(child._edges) else "+Inf")
                        sep = "," if lab else ""
                        lines.append(
                            f'{name}_bucket{{{lab}{sep}le="{le}"}} {cum}')
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{name}_sum{suffix} {child._sum}")
                    lines.append(f"{name}_count{suffix} {child._count}")
                    if child._nonfinite:
                        lines.append(f"{name}_nonfinite{suffix} "
                                     f"{child._nonfinite}")
                else:
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{name}{suffix} {child.get()}")
        return "\n".join(lines) + ("\n" if lines else "")


_REGISTRY = Registry()


def registry() -> Registry:
    """The process registry (always real — gating lives in the
    module-level factories below, so exporters can read a snapshot even
    while instrumentation is switched off)."""
    return _REGISTRY


# -- gated factories: THE instrumentation surface --------------------------
def counter(name, help="", labels=()):
    return _REGISTRY.counter(name, help, labels) if enabled() else NOOP


def gauge(name, help="", labels=()):
    return _REGISTRY.gauge(name, help, labels) if enabled() else NOOP


def histogram(name, help="", labels=()):
    return _REGISTRY.histogram(name, help, labels) if enabled() else NOOP


def snapshot() -> Dict:
    return _REGISTRY.snapshot()


def to_prometheus() -> str:
    return _REGISTRY.to_prometheus()


# ==========================================================================
# SLO accounting: error-budget burn rate + goodput over finished
# serving requests
# ==========================================================================
@dataclass(frozen=True)
class SLOTargets:
    """Declared serving SLO: latency bounds (None = unset, always met),
    the objective (fraction of requests that must meet the bounds —
    1-objective is the error budget) and the rolling request window the
    burn rate is measured over."""

    ttft_s: Optional[float] = None
    token_s: Optional[float] = None
    objective: float = 0.99
    window: int = 256

    def to_dict(self) -> dict:
        return {"ttft_s": self.ttft_s, "token_s": self.token_s,
                "objective": self.objective, "window": self.window}


#: configure() sentinel: "argument not given — inherit the flag value"
#: (distinct from an explicit None/0, which DISARMS the target)
UNSET = object()


def _flag_targets() -> SLOTargets:
    ttft = flag_float("FLAGS_slo_ttft_ms") / 1e3
    token = flag_float("FLAGS_slo_token_ms") / 1e3
    return SLOTargets(
        ttft_s=ttft or None, token_s=token or None,
        objective=flag_float("FLAGS_slo_objective") or 0.99,
        window=max(int(flag_float("FLAGS_slo_window") or 256), 1))


class SLOTracker:
    """Live SLO accounting over finished requests, fed by the serving
    engines at finish time (inference/serving.py) with the exact
    latency convention utils/loadgen.py reports — TTFT is the first
    token's gap from arrival, decode gaps are the inter-token gaps of
    the request's FINAL run — so the tracker's goodput reconciles
    exactly with loadgen's independently computed per-request numbers.

    * a request is **within SLO** when its TTFT meets the TTFT target
      AND every decode gap meets the per-token target (unset targets
      always met);
    * **goodput** counts requests and tokens served within SLO vs
      total (token granularity: the first token judged against the
      TTFT target, each decode token against the per-token target);
    * **burn rate** = (violating fraction of the last ``window``
      finished requests) / (1 - objective): 1.0 means the error budget
      drains exactly at the sustainable rate, >1 means it drains
      faster.

    ``admission_hint()`` is the read hook the SLO-aware admission
    policy (inference/admission.py) drives its slack ordering and
    shed threshold from; the default ``fifo`` policy never reads it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._targets = _flag_targets()
        self._window: deque = deque(maxlen=self._targets.window)
        self._req_total = 0
        self._req_within = 0
        self._tok_total = 0
        self._tok_within = 0
        self._prefix_hit_tokens = 0
        self._prompt_tokens = 0

    # ------------------------------------------------------------------
    def configure(self, ttft_s=UNSET, token_s=UNSET, objective=UNSET,
                  window=UNSET) -> "SLOTracker":
        """Declare targets for the next measurement window and zero the
        accounting.  Omitted arguments inherit the FLAGS_slo_* values;
        an EXPLICIT ``None``/``0`` target disarms it even when the flag
        armed one (the tools' "0 = unset" CLI contract)."""
        base = _flag_targets()
        with self._lock:
            self._targets = SLOTargets(
                ttft_s=base.ttft_s if ttft_s is UNSET else (ttft_s or None),
                token_s=(base.token_s if token_s is UNSET
                         else (token_s or None)),
                objective=(base.objective if objective is UNSET or not
                           objective else float(objective)),
                window=(base.window if window is UNSET or not window
                        else int(window)))
            self._window = deque(maxlen=max(self._targets.window, 1))
            self._zero_locked()
        return self

    def reset(self):
        """Zero the accounting, keep the declared targets (the
        reset between a warm-up and a measured run)."""
        with self._lock:
            self._window.clear()
            self._zero_locked()

    def _zero_locked(self):
        self._req_total = self._req_within = 0
        self._tok_total = self._tok_within = 0
        self._prefix_hit_tokens = self._prompt_tokens = 0

    @property
    def targets(self) -> SLOTargets:
        return self._targets

    # ------------------------------------------------------------------
    def observe_request(self, req_id, ttft_s: float,
                        decode_gaps: Sequence[float],
                        trace_id: Optional[str] = None,
                        prefix_hit_tokens: int = 0,
                        prompt_tokens: int = 0) -> bool:
        """One finished request.  ``ttft_s`` may be NaN (zero-token
        request) — it then fails an armed TTFT target (a request that
        never produced its first token did not meet it).
        ``prefix_hit_tokens``/``prompt_tokens`` aggregate the
        prefix-cache hit ratio the report/admission hint expose — a
        high ratio means admission is cheap (prefills mostly skip), the
        context a burn-rate-driven policy reads next to the burn."""
        t = self._targets
        has_first = ttft_s == ttft_s  # not NaN
        ok_ttft = t.ttft_s is None or (has_first and ttft_s <= t.ttft_s)
        if t.token_s is None:
            ok_gaps, tok_gap_within = True, len(decode_gaps)
        else:
            tok_gap_within = sum(1 for g in decode_gaps if g <= t.token_s)
            ok_gaps = tok_gap_within == len(decode_gaps)
        within = bool(ok_ttft and ok_gaps)
        ntok = (1 if has_first else 0) + len(decode_gaps)
        ntok_within = (1 if (has_first and ok_ttft) else 0) + tok_gap_within
        with self._lock:
            self._req_total += 1
            self._req_within += within
            self._tok_total += ntok
            self._tok_within += ntok_within
            self._prefix_hit_tokens += int(prefix_hit_tokens)
            self._prompt_tokens += int(prompt_tokens)
            self._window.append(within)
            burn = self._burn_locked()
        # registry mirrors (gated like every instrument; per-request
        # identity stays OUT of the labels — the trace id travels as a
        # histogram exemplar from the engine's latency observations)
        counter("slo_requests_total",
                "finished requests judged against the SLO").inc()
        counter("slo_requests_within_slo_total",
                "finished requests that met every armed target").inc(
                    1.0 if within else 0.0)
        counter("slo_tokens_total",
                "tokens judged against the SLO").inc(ntok)
        counter("slo_tokens_within_slo_total",
                "tokens within their latency target").inc(ntok_within)
        gauge("slo_burn_rate",
              "rolling-window error-budget burn rate (1.0 = budget "
              "drains at exactly the sustainable rate)").set(burn)
        return within

    def _burn_locked(self) -> float:
        if not self._window:
            return 0.0
        budget = max(1.0 - self._targets.objective, 1e-9)
        viol = 1.0 - (sum(self._window) / len(self._window))
        return viol / budget

    def burn_rate(self) -> float:
        with self._lock:
            return self._burn_locked()

    def goodput(self) -> Dict:
        with self._lock:
            return {
                "requests_total": self._req_total,
                "requests_within_slo": self._req_within,
                "request_goodput": (self._req_within / self._req_total
                                    if self._req_total else 1.0),
                "tokens_total": self._tok_total,
                "tokens_within_slo": self._tok_within,
                "token_goodput": (self._tok_within / self._tok_total
                                  if self._tok_total else 1.0),
            }

    def prefix_hit_ratio(self) -> float:
        """Fraction of finished requests' prompt tokens served from
        cached prefix pages (0.0 with the cache off or nothing
        finished)."""
        with self._lock:
            return (self._prefix_hit_tokens / self._prompt_tokens
                    if self._prompt_tokens else 0.0)

    def report(self) -> Dict:
        """The ``slo`` section of a serving report."""
        g = self.goodput()
        with self._lock:
            window_n = len(self._window)
            burn = self._burn_locked()
            hit = (self._prefix_hit_tokens / self._prompt_tokens
                   if self._prompt_tokens else 0.0)
        return {"targets": self._targets.to_dict(), "goodput": g,
                "burn_rate": round(burn, 6), "window_requests": window_n,
                "prefix_hit_ratio": round(hit, 6)}

    def admission_hint(self) -> Dict:
        """THE read hook for SLO-aware admission: live burn rate +
        goodput + declared targets.  Consumed once per engine step by
        inference/admission.py's ``slo_aware`` policy (slack ordering +
        shed threshold); the ``fifo`` default never calls it.  Changing
        its shape changes shedding behavior — it is load-bearing."""
        g = self.goodput()
        return {"burn_rate": self.burn_rate(),
                "request_goodput": g["request_goodput"],
                "token_goodput": g["token_goodput"],
                "prefix_hit_ratio": self.prefix_hit_ratio(),
                "targets": self._targets.to_dict()}


_SLO: Optional[SLOTracker] = None
_SLO_LOCK = threading.Lock()


def slo_tracker() -> SLOTracker:
    """The process SLO tracker (lazy singleton; targets resolved from
    the FLAGS_slo_* defaults until configure() overrides them)."""
    global _SLO
    if _SLO is None:
        with _SLO_LOCK:
            if _SLO is None:
                _SLO = SLOTracker()
    return _SLO


def reset_slo():
    """Re-resolve targets from flags and zero the accounting (tests /
    fresh measurement windows)."""
    slo_tracker().configure()
