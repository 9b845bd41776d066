"""PyTorch port, serving completeness: admission policies, shedding and the
serving chaos faults against the JAX package on the CPU.

* policy resolution (flag, name, instance); ``fifo`` from the flag
  default, by name or as an instance gives JAX's event stream;
* ``slo_aware``: slack order, the burn-scaled shed threshold and the
  least-lost-work victim equal JAX's policy on the same queues; on a
  logical clock the port's engine gives JAX's event stream, shed set,
  stats and span stream; ``lost_work_cost`` equals JAX's with and
  without spans (and under speculative decoding); the starvation
  oracle; sheds are traced and counted and out of the goodput;
* labeled reject reasons;
* chaos: the serving grammar parses as JAX's, the training tokens raise
  ``NotImplementedError``, ``pool_spike`` / ``decode_delay`` /
  ``req_burst`` inject as in JAX's tests, and an armed schedule that
  never fires changes nothing;
* ``python -m paddle_tpu_torch.tools.overload_bench --quick --device
  cpu`` as a bounded subprocess.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.inference.admission as JA
import paddle_tpu.inference.serving as J
from paddle_tpu.utils import chaos as jchaos
from paddle_tpu.utils import telemetry as jtm
from paddle_tpu.utils import tracing as jtracing

import paddle_tpu_torch.inference.admission as TA
import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.utils import chaos as tchaos
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import telemetry as ttm
from paddle_tpu_torch.utils import tracing as ttracing

from torch_serving_parity import (drive, fresh_observability, jax_engine,
                                  mixed_prompts, port_engine, set_flags)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's admission-test engine (its seed, 0)
ADM = dict(num_pages=32, page_size=8, max_batch=4, token_budget=64,
           prefill_bucket_min=8, seed=0)


@pytest.fixture(autouse=True)
def _fresh():
    restore = fresh_observability()
    yield
    restore()


def _eng(pkg, **kw):
    kw = {**ADM, **kw}
    return jax_engine(**kw) if pkg is J else port_engine(**kw)


def _reqs(pkg, prompt_list, max_new):
    return [pkg.Request(i, list(p), max_new)
            for i, p in enumerate(prompt_list)]


def _reject_count(tm, reason):
    fam = tm.snapshot().get("serving_rejects_total", {"series": []})
    for s in fam["series"]:
        if s["labels"].get("reason") == reason:
            return s["value"]
    return 0


# ==========================================================================
# policies
# ==========================================================================
def test_policy_resolution_flag_name_instance():
    assert _eng(T).policy.name == "fifo"
    assert _eng(T, admission_policy="slo_aware").policy.name == "slo_aware"
    assert _eng(T, admission_policy=TA.SLOAwarePolicy()).policy.name \
        == "slo_aware"
    tflags.set_flags({"FLAGS_admission_policy": "slo_aware"})
    assert _eng(T).policy.name == "slo_aware"
    with pytest.raises(ValueError, match="unknown admission policy"):
        TA.get_policy("lifo")
    assert sorted(TA.POLICIES) == sorted(JA.POLICIES)


def test_fifo_default_name_and_instance_give_jax_stream():
    prompts = mixed_prompts(seed=11)
    want = drive(_eng(J, num_pages=6, page_size=4),
                 _reqs(J, prompts, 5))
    runs = []
    for kw in ({}, dict(admission_policy="fifo"),
               dict(admission_policy=TA.FIFOPolicy())):
        eng = _eng(T, num_pages=6, page_size=4, **kw)
        runs.append((drive(eng, _reqs(T, prompts, 5)), dict(eng.stats)))
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0] == want
    assert runs[0][1]["preempted"] >= 1 and runs[0][1]["shed"] == 0


class _Hint:
    """An engine stand-in: a waiting queue and an SLO hint."""

    def __init__(self, waiting, burn, ttft):
        self.waiting = waiting
        self._h = {"burn_rate": burn, "targets": {"ttft_s": ttft}}

    def slo_hint(self):
        return self._h


def test_slack_order_and_shed_threshold_equal_jax():
    rng = np.random.RandomState(3)
    for trial in range(20):
        arrivals = rng.rand(6).round(2).tolist()
        burn = [0.0, 0.5, 1.0, 2.0, 5.0][trial % 5]
        ttft = None if trial % 4 == 3 else float(rng.rand() + 0.2)
        now = 1.0 + float(rng.rand())
        out = []
        for pkg, A in ((J, JA), (T, TA)):
            reqs = []
            for i, a in enumerate(arrivals):
                r = pkg.Request(i, [1], 4, a)
                r._seq = i
                reqs.append(r)
            eng = _Hint(reqs, burn, ttft)
            pol = A.SLOAwarePolicy()
            shed = [r.req_id for r in pol.shed(eng, now)]
            pol.order(eng, now)
            out.append((shed, [r.req_id for r in eng.waiting]))
        assert out[0] == out[1]


def test_victim_is_least_lost_work_like_jax():
    rng = np.random.RandomState(8)
    for _ in range(20):
        shapes = [(int(rng.randint(1, 12)), int(rng.randint(0, 6)),
                   int(rng.randint(0, 3))) for _ in range(5)]
        picks = []
        for pkg, A in ((J, JA), (T, TA)):
            running = []
            for i, (p, o, hit) in enumerate(shapes):
                r = pkg.Request(i, list(range(p)), 8)
                r.out_tokens = list(range(o))
                r._prefix_hit = min(hit, p)
                running.append(pkg._SeqState(r, 0))
            picks.append((A.SLOAwarePolicy().victim_index(running),
                          A.FIFOPolicy().victim_index(running),
                          [A.lost_work_cost(st.req) for st in running]))
        assert picks[0] == picks[1]


@pytest.mark.parametrize("spec_k", [0, 4])
def test_lost_work_cost_with_spans_equals_jax(spec_k):
    """Mid-trace, traced: every running request's cost read off its span
    tree equals JAX's and the untraced fallback."""
    set_flags(trace_requests=1)
    costs = []
    for pkg, A in ((J, JA), (T, TA)):
        eng = _eng(pkg, spec_k=spec_k)
        for r in _reqs(pkg, mixed_prompts(), 8):
            eng.submit(r)
        for t in (1.0, 2.0, 3.0):
            eng.step(t)
        assert eng.running
        row = []
        for st in eng.running:
            assert st.req.trace is not None
            cost = A.lost_work_cost(st.req)
            assert cost == len(st.req.prompt) + len(st.req.out_tokens)
            row.append((st.req.req_id, cost))
        costs.append(row)
    assert costs[0] == costs[1]


def _slo_run(pkg, tm, tracing, prompts, **eng_kw):
    set_flags(trace_requests=1)
    tracing.reset()
    tm.registry().reset()
    tm.slo_tracker().configure(ttft_s=6.0, token_s=None, objective=0.9,
                               window=8)
    eng = _eng(pkg, admission_policy="slo_aware", **eng_kw)
    ev = drive(eng, _reqs(pkg, prompts, 5), dt=1.0)
    shed = sorted(r.req_id for r in eng.waiting)  # always empty: drained
    return (ev, dict(eng.stats), shed, tracing.span_stream(),
            tm.slo_tracker().report())


def test_slo_aware_engine_matches_jax():
    """The logical-clock slo_aware run under pool pressure: event stream,
    stats, span stream (shed and preempt spans included) and the SLO
    report equal JAX's, and replay identically."""
    prompts = mixed_prompts(seed=9, n=4) + mixed_prompts(seed=5, n=4)
    kw = dict(num_pages=6, page_size=4, max_batch=4)
    want = _slo_run(J, jtm, jtracing, prompts, **kw)
    got = _slo_run(T, ttm, ttracing, prompts, **kw)
    assert got == want
    assert got == _slo_run(T, ttm, ttracing, prompts, **kw)
    assert got[1]["preempted"] >= 1 or got[1]["shed"] >= 1


def test_shed_is_traced_counted_and_out_of_goodput_like_jax():
    out = []
    for pkg, tm, tracing in ((J, jtm, jtracing), (T, ttm, ttracing)):
        set_flags(trace_requests=1)
        tm.slo_tracker().configure(ttft_s=2.5, token_s=None, objective=0.9,
                                   window=16)
        eng = _eng(pkg, max_batch=1, admission_policy="slo_aware")
        reqs = _reqs(pkg, mixed_prompts(n=4) * 2, 4)
        ev = drive(eng, reqs, dt=1.0)
        shed = [r for r in reqs if r.shed_at is not None]
        finished = [r for r in reqs if r.finished_at is not None]
        assert shed and finished and len(shed) + len(finished) == len(reqs)
        snap = tm.snapshot()
        assert snap["serving_shed_total"]["series"][0]["value"] \
            == len(shed) == _reject_count(tm, "shed") == eng.stats["shed"]
        for r in shed:
            tr = tracing.store().get(tracing.trace_id_for(r.req_id))
            root = tr.spans_named("request")[0]
            assert root.attrs["status"] == "shed" and tr.finished
            assert all(s.t1 is not None for s in tr.spans)
        g = tm.slo_tracker().goodput()
        assert g["requests_total"] == len(finished)
        out.append((ev, [r.req_id for r in shed], g, dict(eng.stats)))
    assert out[0] == out[1]


def test_starvation_oracle_under_saturation():
    ttm.slo_tracker().configure(ttft_s=3.0, token_s=None, objective=0.9,
                                window=16)
    rng = np.random.RandomState(3)
    eng = _eng(T, num_pages=16, page_size=4, max_batch=2, token_budget=32,
               admission_policy="slo_aware")
    reqs, rejected = [], []
    for i in range(24):
        r = T.Request(i, list(map(int, rng.randint(0, 64, size=rng.randint(
            2, 12)))), int(rng.randint(2, 7)))
        reqs.append(r)
        try:
            eng.submit(r)
        except ValueError:
            rejected.append(r)
    steps = 0
    while eng.has_work():
        steps += 1
        assert steps < 400, "starvation: engine failed to drain"
        eng.step(float(steps))
    for r in reqs:
        outcomes = [r.finished_at is not None, r.shed_at is not None,
                    r in rejected]
        assert sum(outcomes) == 1, (r.req_id, outcomes)
    assert not eng.waiting and not eng.running


def test_submit_reject_reasons_are_labeled_like_jax():
    set_flags(trace_requests=1)
    for pkg, tm, tracing in ((J, jtm, jtracing), (T, ttm, ttracing)):
        eng = _eng(pkg, num_pages=4, page_size=4, token_budget=16)
        for rid, prompt, max_new, reason in (
                ("seq", list(range(100)), 60, "max_seq_len"),
                ("pool", list(range(10)), 8, "pool"),
                ("budget", list(range(16)), 0, "budget")):
            with pytest.raises(ValueError):
                eng.submit(pkg.Request(rid, prompt, max_new))
            assert _reject_count(tm, reason) == 1
            root = tracing.store().get(
                tracing.trace_id_for(rid)).spans_named("request")[0]
            assert root.attrs["status"] == "rejected"
            assert root.attrs["reject_reason"] == reason
        assert tm.snapshot()["serving_rejected_total"]["series"][0][
            "value"] == 3
    assert ttracing.span_stream() == jtracing.span_stream()


# ==========================================================================
# chaos serving faults
# ==========================================================================
@pytest.mark.parametrize("spec", [
    "seed=3;decode_delay=5@2;req_burst=4@10;pool_spike=8@3:6",
    "decode_delay=2:0.5", "decode_delay=5ms@3;req_burst=2@1;req_burst=3@1",
    "pool_spike=3@4"])
def test_chaos_serving_grammar_equals_jax(spec):
    j, t = jchaos.FaultSchedule(spec), tchaos.FaultSchedule(spec)
    for attr in ("seed", "decode_delay_ms", "decode_delay_p",
                 "decode_delay_at", "burst_at", "spike_at"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_chaos_bad_and_training_tokens_raise():
    for spec, frag in (("decode_jitter=5@2", "unknown event"),
                       ("req_burst=4", "req_burst"),
                       ("pool_spike=8", "pool_spike"),
                       ("decode_delay=@3", "decode_delay"),
                       ("decode_delay=abc:0.5", "decode_delay")):
        with pytest.raises(ValueError, match=frag):
            tchaos.FaultSchedule(spec)
    for spec in ("kill@3", "kill@3:raise", "rpc_drop=send@2",
                 "rpc_delay=5:0.5", "trunc_ckpt@1", "nan_inject=relu@2",
                 "decode_delay=1@1;kill@9"):
        with pytest.raises(NotImplementedError, match="training fault"):
            tchaos.FaultSchedule(spec)


def test_chaos_pool_spike_seizes_and_releases_per_engine():
    tflags.set_flags({"FLAGS_chaos": "pool_spike=4@2:3"})
    a, b = _eng(T), _eng(T)
    a.step(1.0)
    assert a.kv.num_free_pages == 32
    a.step(2.0)                            # the spike seizes 4 pages
    assert a.kv.num_free_pages == 28
    for t in range(1, 7):                  # B runs past its release step
        b.step(float(t))
    assert b.kv.num_free_pages == 32
    assert a.kv.num_free_pages == 28       # A's seizure untouched by B
    for t in (3.0, 4.0):
        a.step(t)
    assert a.kv.num_free_pages == 28
    a.step(5.0)                            # released at 2 + 3
    assert a.kv.num_free_pages == 32
    kinds = {s["labels"]["kind"]: s["value"] for s in
             ttm.snapshot()["chaos_injections_total"]["series"]}
    assert kinds.get("pool_spike") == 2


def test_chaos_req_burst_and_decode_delay():
    tflags.set_flags({"FLAGS_chaos": "req_burst=3@2;decode_delay=1@1"})
    eng = _eng(T)
    eng.step(1.0)
    assert tchaos.take_burst() == 0
    eng.submit(T.Request(0, [1, 2, 3], 3))
    eng.step(2.0)
    assert tchaos.take_burst() == 3
    assert tchaos.take_burst() == 0
    eng.run_to_completion(3.0)
    kinds = {s["labels"]["kind"]: s["value"] for s in
             ttm.snapshot()["chaos_injections_total"]["series"]}
    assert kinds == {"req_burst": 1, "decode_delay": 1}
    assert eng.stats["finished"] == 1


def test_chaos_under_pressure_matches_jax_and_off_is_free():
    """A spike and a burst under a tight pool give JAX's event stream and
    chaos counts; a schedule that never fires gives the unarmed one."""
    prompts = mixed_prompts(seed=11)

    def run(pkg, spec, **kw):
        set_flags(chaos=spec)
        (jchaos if pkg is J else tchaos).reset()
        eng = _eng(pkg, num_pages=12, page_size=4, **kw)
        return drive(eng, _reqs(pkg, prompts, 5)), dict(eng.stats)

    spec = "pool_spike=6@2:3;req_burst=2@3"
    assert run(T, spec) == run(J, spec)
    assert run(T, "") == run(T, "decode_delay=1@100000")


def test_overload_bench_quick_subprocess():
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.overload_bench",
         "--quick", "--json", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("OVERLOAD=")][-1]
    rep = json.loads(line[len("OVERLOAD="):])
    assert rep["device"] == "cpu"
    comp = rep["comparison"]
    assert comp["slo_aware_strictly_better"] is True
    assert comp["slo_aware_request_goodput"] > comp["fifo_request_goodput"]
    assert comp["fifo_never_sheds"] is True
    for section in (rep, rep["prefix_trace"], rep["kv_quant"]):
        for policy in ("fifo", "slo_aware"):
            p = section["policies"][policy]
            assert p["starvation_free"] is True
            assert p["sheds_visible"] is True
            assert p["outcomes"]["hung"] == 0
    assert rep["policies"]["slo_aware"]["outcomes"]["shed"] > 0
    assert rep["policies"]["fifo"]["burn_trajectory"][-1] > 1.0
    assert rep["kv_quant"]["comparison"]["pressure_strictly_improved"]
