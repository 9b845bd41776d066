"""PyTorch port, serving completeness: telemetry, request tracing, the
profiler's serving events and the static-batching engine against the
JAX package on the CPU.

* the registry: the same instrument calls give the same snapshot and
  Prometheus text as JAX's (quantile brackets, non-finite observations,
  the label bound and deny list);
* after a seeded trace the serving, KV, spec, SLO and chaos families
  equal JAX's (names, labels, values; histograms by count and sum: the
  engines observe logical-clock gaps), with preemption, the prefix
  cache, int8 pools and speculative decoding;
* the SLO tracker's goodput and burn rate equal JAX's;
* span streams replay identically and equal JAX's, reconcile with the
  engine's counters, trace rejected requests, and link the latency
  histograms' exemplars;
* with telemetry and tracing off the event streams are byte-identical;
* ``StaticBatchingEngine``'s event stream equals JAX's.
"""
import math

import numpy as np
import pytest

import paddle_tpu.inference.serving as J
from paddle_tpu.utils import telemetry as jtm
from paddle_tpu.utils import tracing as jtracing

import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.utils import telemetry as ttm
from paddle_tpu_torch.utils import tracing as ttracing

from torch_serving_parity import (ENGINE, JCFG, TCFG, drive,
                                  fresh_observability, jax_engine,
                                  mixed_prompts, port_engine, set_flags,
                                  snapshot_rows, stream)


@pytest.fixture(autouse=True)
def _fresh():
    restore = fresh_observability()
    yield
    restore()


def _reqs(pkg, prompt_list, max_new):
    return [pkg.Request(i, list(p), max_new)
            for i, p in enumerate(prompt_list)]


# ==========================================================================
# the registry
# ==========================================================================
def _exercise(tm):
    c = tm.counter("t_calls_total", "calls", labels=("op",))
    for op, n in (("a", 3), ("b", 1), ("a", 2)):
        c.labels(op=op).inc(n)
    g = tm.gauge("t_level", "level")
    g.set(4.5)
    g.inc(-1.25)
    h = tm.histogram("t_latency_s", "latency")
    rng = np.random.RandomState(0)
    for v in rng.lognormal(-5, 2, size=300):
        h.observe(float(v), exemplar=f"ex{int(v * 1e6) % 7}")
    h.observe(float("nan"))
    h.observe(math.inf)
    wide = tm.counter("t_wide_total", labels=("k",))
    for i in range(tm.MAX_SERIES + 5):
        wide.labels(k=i).inc()
    with pytest.raises(ValueError, match="per-request"):
        tm.counter("t_bad_total", labels=("req_id",))
    with pytest.raises(ValueError, match="re-declared"):
        tm.gauge("t_calls_total")
    return (tm.snapshot(), tm.to_prometheus(),
            [h.quantile_bounds(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            h.quantile(0.99), h.exemplar_for_quantile(0.99), h.nonfinite)


def test_registry_equals_jax():
    assert _exercise(ttm) == _exercise(jtm)
    ttm.registry().reset()
    assert ttm.snapshot()["t_level"]["series"][0]["value"] == 0.0
    set_flags(telemetry=0)
    assert ttm.counter("t_calls_total") is ttm.NOOP
    assert ttm.NOOP.labels(op="a").get() == 0.0


def test_slo_tracker_equals_jax():
    rows = [(0, 0.05, [0.01, 0.02]), (1, 0.2, [0.01]),
            (2, 0.05, [0.01, 0.2]), (3, float("nan"), []),
            (4, 0.01, [0.01]), (5, 0.09, [0.06, 0.01])]
    out = []
    for tm in (jtm, ttm):
        t = tm.SLOTracker()
        t.configure(ttft_s=0.1, token_s=0.05, objective=0.9, window=4)
        within = [t.observe_request(rid, ttft, gaps, prefix_hit_tokens=1,
                                    prompt_tokens=4)
                  for rid, ttft, gaps in rows]
        out.append((within, t.goodput(), t.burn_rate(), t.report(),
                    t.admission_hint()))
    assert out[0] == out[1]
    assert out[1][2] == pytest.approx((3 / 4) / 0.1)
    set_flags(slo_ttft_ms=250, slo_objective=0.95, slo_window=16)
    ttm.reset_slo()
    assert ttm.slo_tracker().targets == ttm.SLOTargets(
        ttft_s=0.25, token_s=None, objective=0.95, window=16)


# ==========================================================================
# the serving engine's telemetry and spans against JAX's
# ==========================================================================
@pytest.mark.parametrize("case", ["preempt_prefix", "int8_spec"])
def test_serving_snapshot_and_spans_equal_jax(case):
    kw = {"preempt_prefix": dict(num_pages=6, page_size=4,
                                 prefix_cache=True, seed=0),
          "int8_spec": dict(kv_dtype="int8", num_pages=8, page_size=4,
                            spec_k=4)}[case]
    prompts = mixed_prompts(seed=11) * 2 if case == "preempt_prefix" \
        else mixed_prompts(seed=9)
    set_flags(trace_requests=1, slo_ttft_ms=3000, slo_token_ms=1500)
    out = []
    for pkg, tm, tracing, make in ((J, jtm, jtracing, jax_engine),
                                   (T, ttm, ttracing, port_engine)):
        tm.reset_slo()
        eng = make(**kw)
        ev = drive(eng, _reqs(pkg, prompts, 5), dt=1.0)
        out.append((ev, dict(eng.stats), snapshot_rows(tm.snapshot()),
                    tracing.span_stream(), tm.slo_tracker().report()))
    assert out[1] == out[0]
    names = {row[0] for row in out[1][2]}
    assert {"serving_admitted_total", "serving_finished_total",
            "serving_ttft_s", "kv_pool_pages_in_use",
            "slo_requests_total"} <= names
    if case == "int8_spec":
        assert {"spec_accepted_total", "kv_quant_scale_bytes"} <= names
    else:
        assert out[1][1]["preempted"] >= 1
        assert "kv_prefix_cached_pages" in names


def test_span_stream_replays_and_reconciles_with_counters():
    set_flags(trace_requests=1)
    prompts = mixed_prompts(seed=9)

    def run():
        ttracing.reset()
        eng = port_engine(num_pages=6, page_size=4, seed=0)
        ev = drive(eng, _reqs(T, prompts, 5), dt=1.0)
        return ev, ttracing.span_stream(), eng

    ev_a, spans_a, eng = run()
    ev_b, spans_b, _ = run()
    assert (ev_a, spans_a) == (ev_b, spans_b)
    assert eng.stats["preempted"] >= 1
    traces = ttracing.store().finished_traces()
    assert sum(len(t.spans_named("prefill")) for t in traces) \
        == eng.stats["admitted"]
    assert sum(len(t.spans_named("preempted")) for t in traces) \
        == eng.stats["preempted"]
    for tr in traces:
        root = tr.spans_named("request")[0]
        assert root.attrs["status"] == "finished"
        names = [s.name for s in tr.spans]
        last = len(names) - 1 - names[::-1].index("prefill")
        assert root.attrs["tokens"] == 1 + names[last:].count("decode_step")
    assert len(traces) == eng.stats["finished"]
    # the latency histogram's p99 bucket names a trace in the store
    ex = ttm.histogram("serving_ttft_s").exemplar_for_quantile(0.99)
    assert ex is not None and ttracing.store().get(ex) is not None


def test_rejected_and_sampled_requests_traced_like_jax():
    set_flags(trace_requests=1, trace_sample_rate=0.5, trace_seed=3)
    decisions = {i: ttracing.sampled(i) for i in range(32)}
    assert decisions == {i: jtracing.sampled(i) for i in range(32)}
    assert any(decisions.values()) and not all(decisions.values())
    set_flags(trace_sample_rate=1.0)
    for pkg, make in ((J, jax_engine), (T, port_engine)):
        eng = make(token_budget=8)
        with pytest.raises(ValueError):
            eng.submit(pkg.Request("big", list(range(12)), 2))
    assert ttracing.span_stream() == jtracing.span_stream()
    root = ttracing.store().get(
        ttracing.trace_id_for("big")).spans_named("request")[0]
    assert root.attrs["status"] == "rejected"
    assert "token_budget" in root.attrs["reason"]


def test_flags_off_streams_byte_identical():
    prompts = mixed_prompts(seed=11)
    kw = dict(num_pages=6, page_size=4)
    base = stream(port_engine(**kw), T.Request, prompts, 5, dt=1.0)
    ttm.registry().clear()
    set_flags(telemetry=0, trace_requests=0)
    off = stream(port_engine(**kw), T.Request, prompts, 5, dt=1.0)
    assert ttm.snapshot() == {} and ttracing.store().traces() == []
    set_flags(telemetry=1, trace_requests=1)
    on = stream(port_engine(**kw), T.Request, prompts, 5, dt=1.0)
    assert base == off == on
    assert base == stream(jax_engine(**kw), J.Request, prompts, 5, dt=1.0)


def test_profiler_marks_the_serving_path():
    tprofiler.enable_profiler()
    try:
        eng = port_engine(num_pages=6, page_size=4, spec_k=2)
        drive(eng, _reqs(T, mixed_prompts(seed=9), 5), dt=1.0)
    finally:
        events = tprofiler.disable_profiler()
    names = {(e["name"], e["ph"]) for e in events}
    assert {("prefill", "X"), ("verify_batch", "X"), ("admit", "i"),
            ("evict", "i"), ("preempt", "i")} <= names
    assert not tprofiler.is_profiler_enabled()
    assert tprofiler.get_events() == events


# ==========================================================================
# the static-batching engine
# ==========================================================================
@pytest.mark.parametrize("pool", [dict(num_pages=32, page_size=8),
                                  dict(num_pages=4, page_size=4)])
def test_static_batching_matches_jax(pool):
    prompts = mixed_prompts(seed=13) if pool["num_pages"] == 32 else \
        [[1 + i, 2, 3] for i in range(4)]
    max_new = 5 if pool["num_pages"] == 32 else 8
    set_flags(trace_requests=1)
    out = []
    for pkg, make, tracing in ((J, jax_engine, jtracing),
                               (T, port_engine, ttracing)):
        core = make(seed=0, **pool).core
        eng = pkg.StaticBatchingEngine(core, batch_size=4)
        reqs = _reqs(pkg, prompts, max_new)
        ev = drive(eng, reqs, dt=1.0)
        out.append((ev, dict(eng.stats), [r.out_tokens for r in reqs],
                    tracing.span_stream()))
        with pytest.raises(ValueError):
            eng.submit(pkg.Request(9, list(range(14)), 120))
    assert out[1] == out[0]
    tcore = port_engine(seed=0, **pool).core
    assert out[1][2] == [tcore.greedy_reference(p, max_new)
                         for p in prompts]
    # the same tokens as the continuous engine, in another schedule
    cont = port_engine(seed=0, **pool)
    assert cont.generate(prompts, max_new) == out[1][2]
    assert ENGINE["max_batch"] == 4 and JCFG.hidden == TCFG.hidden
