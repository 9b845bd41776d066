"""Shared fixtures of the serving-completeness parity tests
(``tests/test_torch_spec_decode.py``, ``test_torch_admission.py``,
``test_torch_telemetry.py``): the tiny decoder of
``tests/test_torch_serving.py``, seeded prompts, both packages' engines,
and a reset of both packages' flags, registries, trace stores and chaos
schedules.

A JAX engine compiles its forms once per shape bucket, which makes a
fresh one cost seconds on the CPU.  :func:`jax_engine` therefore keeps one
warm ``_EngineCore`` per configuration for the whole process and gives
each new engine that core with a fresh allocator: the compiled forms and
their weights are reused, the allocator state starts empty.  A page is
always written before it is read (an int8 page is reopened at offset 0),
so what earlier runs left in the pools cannot reach a token.
"""
import dataclasses

import numpy as np

import paddle_tpu.inference.serving as J
from paddle_tpu.inference.kv_cache import PagedKVCache as JPagedKVCache
from paddle_tpu.utils import chaos as jchaos
from paddle_tpu.utils import flags as jflags
from paddle_tpu.utils import telemetry as jtm
from paddle_tpu.utils import tracing as jtracing

import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.utils import chaos as tchaos
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import telemetry as ttm
from paddle_tpu_torch.utils import tracing as ttracing

SMALL = dict(vocab_size=64, hidden=32, num_heads=4, num_layers=2,
             max_seq_len=128)
JCFG = J.DecoderConfig(**SMALL)
TCFG = T.DecoderConfig(**SMALL)

#: the engine defaults of the JAX package's serving-completeness tests
ENGINE = dict(num_pages=64, page_size=8, max_batch=4, token_budget=64,
              prefill_bucket_min=8, seed=3)

#: keys of a serving engine's keyword arguments that shape its core
_CORE_KEYS = ("num_pages", "page_size", "prefill_bucket_min", "kv_dtype",
              "kv_budget_mb", "sampling", "seed")

_CORES = {}


def prompts(seed=0, n=5, vocab=64, lo=4, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(lo, hi))))
            for _ in range(n)]


def mixed_prompts(seed=7, n=4, vocab=64):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=ln)))
            for ln in (3, 11, 6, 14)[:n]]


def _with_defaults(kw):
    out = dict(ENGINE)
    out.update(kw)
    return out


def jax_engine(cfg=None, **kw):
    """A JAX ``ServingEngine`` over the warm core of its configuration
    (a fresh allocator, ``cfg``'s ``eos_id``)."""
    kw = _with_defaults(kw)
    cfg = cfg or JCFG
    key = (dataclasses.replace(cfg, eos_id=-1),) + tuple(
        repr(kw.get(k)) for k in _CORE_KEYS)
    prefix_cache = bool(kw.get("prefix_cache", False))
    core = _CORES.get(key)
    if core is None:
        core_kw = {k: kw[k] for k in ("num_pages", "page_size",
                                      "prefill_bucket_min", "kv_dtype",
                                      "kv_budget_mb") if k in kw}
        core = J._EngineCore(
            key[0], J.init_decoder_weights(cfg, kw["seed"]),
            sampling=kw.get("sampling"), sample_seed=kw["seed"], **core_kw)
        _CORES[key] = core
    core.cfg = cfg
    core.kv = JPagedKVCache(core.kv_config, prefix_cache=prefix_cache)
    eng = J.ServingEngine.__new__(J.ServingEngine)
    real = J._EngineCore
    J._EngineCore = lambda *a, **k: core
    try:
        eng.__init__(cfg, weights={}, **{
            k: v for k, v in kw.items()
            if k not in ("num_pages", "page_size", "prefill_bucket_min",
                         "kv_dtype", "kv_budget_mb", "prefix_cache")})
    finally:
        J._EngineCore = real
    return eng


def port_engine(cfg=None, **kw):
    """The port's ``ServingEngine`` on the CPU, same arguments."""
    return T.ServingEngine(cfg or TCFG, device="cpu", **_with_defaults(kw))


def stream(eng, request_cls, prompt_list, max_new, dt=None):
    """Submit every prompt, drain; (events, stats).  ``dt``: step k runs
    at the logical time ``k * dt`` (else 0)."""
    reqs = [request_cls(i, list(p), max_new)
            for i, p in enumerate(prompt_list)]
    for r in reqs:
        eng.submit(r)
    events, t = [], 0.0
    while eng.has_work():
        if dt is not None:
            t += dt
        events.extend((e.req_id, e.token, e.finished) for e in eng.step(t))
    return events, dict(eng.stats)


def drive(eng, reqs, dt=1.0, max_steps=500):
    """Submit ``reqs``, then step on the logical clock ``now = k * dt``;
    the events."""
    for r in reqs:
        eng.submit(r)
    events, t = [], 0.0
    while eng.has_work() and max_steps:
        t += dt
        max_steps -= 1
        events.extend((e.req_id, e.token, e.finished) for e in eng.step(t))
    return events


def set_flags(**flags):
    """The same flags in both packages (JAX short names, the port's
    ``FLAGS_`` names)."""
    jflags.set_flags(dict(flags))
    tflags.set_flags({"FLAGS_" + k: v for k, v in flags.items()})


def fresh_observability():
    """Save both packages' flags and empty their registries, trace stores
    and chaos schedules; returns the restore function."""
    jsaved, tsaved = dict(jflags._flags), dict(tflags._SET)
    for tm, tr, ch in ((jtm, jtracing, jchaos), (ttm, ttracing, tchaos)):
        tm.registry().clear()
        tr.reset()
        ch.reset()

    def restore():
        jflags._flags.clear()
        jflags._flags.update(jsaved)
        tflags._SET.clear()
        tflags._SET.update(tsaved)
        for tm, tr, ch in ((jtm, jtracing, jchaos),
                           (ttm, ttracing, tchaos)):
            tr.reset()
            tm.registry().clear()
            tm.reset_slo()
            ch.reset()
    return restore


def snapshot_rows(snap, prefixes=("serving_", "kv_", "spec_", "slo_",
                                  "chaos_")):
    """A registry snapshot's families of the serving path, as comparable
    rows: (name, type, labels, series); a histogram series by its count
    and sum (the engines observe logical-clock gaps)."""
    out = []
    for name, fam in sorted(snap.items()):
        if not name.startswith(prefixes):
            continue
        series = []
        for row in fam["series"]:
            if fam["type"] == "histogram":
                series.append((row["labels"], row["count"], row["sum"]))
            else:
                series.append((row["labels"], row["value"]))
        out.append((name, fam["type"], fam["labels"], series))
    return out
