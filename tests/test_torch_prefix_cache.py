"""PyTorch port, copy-on-write prefix cache and chunked prefill:
``paddle_tpu_torch`` against the JAX package on the CPU.

* the allocator with the prefix cache on: scripted operation sequences
  (the scenarios of ``tests/test_prefix_cache.py``: full and partial
  pages shared, forks on either writer's first write, refcount-0
  reclaim, seeded eviction, opaque sequences, the feature off) give the
  JAX allocator's slots, block tables, refcounts, forks, match results,
  eviction order and ``stats()`` after every operation;
* engines with the prefix cache on: ``StepEvent`` streams and scheduler
  counters == JAX's for every pool dtype x ``prefill_chunk`` in {0, 4},
  on the seed-7 prompts and a shared-prefix trace; under a tight pool
  (eviction and preemption), a prompt longer than the token budget,
  a shared prefix that diverges inside a partial page, and a preempted
  request whose resume hits its own pages;
* token identity within the port: a prefix hit == the cold
  full-recompute oracle, chunked == monolithic, decode never stalls
  behind a chunked prefill.
"""
import numpy as np
import pytest

import paddle_tpu.inference.serving as J
from paddle_tpu.inference.kv_cache import KVCacheConfig as JKVConfig
from paddle_tpu.inference.kv_cache import PagedKVCache as JPagedKVCache

import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.inference.kv_cache import KVCacheConfig, PagedKVCache

SMALL = dict(vocab_size=64, hidden=32, num_heads=4, num_layers=2,
             max_seq_len=128)


def _allocators(num_pages=8, page_size=4, **kw):
    cfg = dict(num_pages=num_pages, page_size=page_size, num_kv_heads=1,
               head_dim=8)
    return (JPagedKVCache(JKVConfig(**cfg), **kw),
            PagedKVCache(KVCacheConfig(**cfg), **kw))


def _observe(kv):
    return (sorted((s, kv.context_len(s), kv.block_table(s, 8).tolist())
                   for s in kv.live_sequences()),
            {p: kv.refcount(p) for p in range(kv.config.num_pages)},
            kv.num_free_pages, kv.pages_in_use, sorted(kv._cached_free),
            kv.stats())


def _run(kv, script):
    """Apply ``script`` (op, args...) to one allocator; record what every
    op returns and the allocator's observables after it."""
    seen = []
    for op, *args in script:
        if op == "append":
            sid, toks = args
            out = kv.append_tokens(sid, len(toks), tokens=toks)
            out = None if out is None else out.tolist()
        elif op == "opaque":
            out = kv.append_tokens(args[0], args[1]).tolist()
        elif op == "match":
            out = kv.match_prefix(args[0])
        elif op == "acquire":
            sid, toks = args
            hit, pages = kv.match_prefix(toks)
            out = kv.acquire_prefix(sid, toks[:hit], pages)
        elif op == "commit":
            out = kv.commit_prefix_hit(args[0])
        elif op == "forks":
            out = kv.take_forks()
        elif op == "free":
            out = kv.free_sequence(args[0])
        elif op == "need":
            out = (kv.pages_needed(*args), kv.cow_fork_need(*args),
                   kv.can_append(*args))
        seen.append((op, out, _observe(kv)))
    return seen


SCRIPTS = {
    # full pages + a partial tail shared; the sharer forks on its write
    "partial-share-fork": [
        ("append", "A", list(range(100, 110))),
        ("match", list(range(100, 110)) + [1, 2]),
        ("acquire", "B", list(range(100, 110))),
        ("need", "B", 2), ("append", "B", [1, 2]), ("forks",),
        ("append", "A", [55]), ("forks",), ("commit", "B"),
        ("free", "A"), ("free", "B"), ("match", list(range(100, 112)))],
    # the original owner writes first: it forks, the sharer keeps the page
    "writer-side-fork": [
        ("append", "A", list(range(9))),
        ("acquire", "B", list(range(9)) + [40, 41]),
        ("append", "A", [77]), ("forks",), ("append", "B", [40]),
        ("forks",), ("free", "B"), ("free", "A")],
    # frees decrement; reclaim at refcount 0, indexed pages cached
    "refcount-zero-reclaim": [
        ("append", "A", list(range(8))),
        ("acquire", "B", list(range(8)) + [9]), ("commit", "B"),
        ("free", "A"), ("free", "B"), ("match", list(range(8))),
        ("acquire", "C", list(range(8)) + [3]), ("append", "C", [3, 4])],
    # six one-page prompts through a four-page pool: seeded eviction
    "seeded-eviction": [
        step for i in range(6)
        for step in (("append", f"s{i}", [100 + i] * 4),
                     ("free", f"s{i}"))] + [
        ("match", [105] * 4 + [0]), ("match", [100] * 4 + [0])],
    # unknown tokens: never indexed, straight back to the pool
    "opaque": [("opaque", "spike", 4), ("free", "spike"),
               ("append", "x", [1, 2, 3]), ("opaque", "x", 2),
               ("match", [1, 2, 3]), ("free", "x")],
    # a full pool with cached pages: backpressure changes nothing
    "backpressure": [
        ("append", "A", list(range(12))), ("free", "A"),
        ("append", "B", list(range(50, 66))), ("need", "C", 20),
        ("append", "C", list(range(20))), ("free", "B"),
        ("append", "C", list(range(20)))],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("seed", [0, 3])
def test_allocator_matches_jax(name, seed):
    num_pages = 4 if name == "seeded-eviction" else 8
    jkv, tkv = _allocators(num_pages, prefix_cache=True, seed=seed)
    want = _run(jkv, SCRIPTS[name])
    got = _run(tkv, SCRIPTS[name])
    assert got == want
    if name == "seeded-eviction":
        assert tkv.stats()["prefix_cache"]["evicted_pages"] >= 2
    if name == "partial-share-fork":
        assert [s for s in got if s[0] == "forks"][0][1] == [(2, 3, 2)]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_allocator_with_the_cache_off_matches_jax(name):
    script = [s for s in SCRIPTS[name] if s[0] not in ("acquire",)]
    jkv, tkv = _allocators(prefix_cache=False)
    assert _run(tkv, script) == _run(jkv, script)
    assert tkv.stats()["prefix_cache"]["enabled"] is False


# ==========================================================================
# engines
# ==========================================================================
def _prompts(seed=7, lens=(3, 11, 6, 14), vocab=64):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lens]


def _shared_prefix(seed=11, n_prefix=20, suffixes=(5, 3, 9, 1)):
    rng = np.random.RandomState(seed)
    prefix = list(map(int, rng.randint(0, 64, size=n_prefix)))
    return [prefix + list(map(int, rng.randint(0, 64, size=n)))
            for n in suffixes]


TRACES = {"seed7": _prompts, "shared": _shared_prefix}


def _engines(**kw):
    kw.setdefault("num_pages", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("token_budget", 64)
    kw.setdefault("prefill_bucket_min", 8)
    return (J.ServingEngine(J.DecoderConfig(**SMALL), **kw),
            T.ServingEngine(T.DecoderConfig(**SMALL), device="cpu", **kw))


def _stream(eng, request_cls, prompts, max_new):
    reqs = [request_cls(i, list(p), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    events, t = [], 0.0
    while eng.has_work():
        t += 1.0
        events.extend((e.req_id, e.token, e.finished, e.time)
                      for e in eng.step(t))
    return (events, [r.out_tokens for r in reqs],
            [r._prefix_hit for r in reqs], eng.kv.stats())


def _same(jeng, teng, prompts, max_new):
    want = _stream(jeng, J.Request, prompts, max_new)
    got = _stream(teng, T.Request, prompts, max_new)
    assert got == want
    assert teng.stats == {k: jeng.stats[k] for k in teng.stats}
    return teng


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_engine_with_prefix_cache_matches_jax(dtype, chunk, trace):
    teng = _same(*_engines(kv_dtype=dtype, prefix_cache=True,
                           prefill_chunk=chunk), TRACES[trace](), 6)
    if trace == "shared":
        assert teng.stats["prefill_hit_tokens"] > 0


def test_tight_pool_eviction_and_preemption_match_jax():
    rng = np.random.RandomState(13)
    prefix = list(map(int, rng.randint(0, 64, size=12)))
    prompts = [prefix + list(map(int, rng.randint(0, 64, size=n)))
               for n in (3, 9, 5, 7)] + _prompts(seed=1, lens=(5, 11))
    teng = _same(*_engines(num_pages=8, page_size=4, prefix_cache=True,
                           prefill_chunk=8), prompts, 5)
    st = teng.kv.stats()["prefix_cache"]
    assert st["evicted_pages"] > 0 or teng.stats["preempted"] > 0


def test_shared_prefix_diverging_in_a_partial_page_matches_jax():
    """Request 0's prompt is the 13-token prefix (a full page and a
    partial one); requests 1 and 2 share both and fork the partial page
    on their first write."""
    rng = np.random.RandomState(5)
    prefix = list(map(int, rng.randint(0, 64, size=13)))
    prompts = [list(prefix)] + [prefix + [int(t), int(u)] for t, u in
                                rng.randint(0, 64, size=(2, 2))]
    teng = _same(*_engines(prefix_cache=True), prompts, 5)
    assert teng.kv.stats()["prefix_cache"]["forked_pages"] >= 1
    oracle = [teng.core.greedy_reference(p, 5) for p in prompts]
    _, outs, hits, _ = _stream(_engines(prefix_cache=True)[1], T.Request,
                               prompts, 5)
    assert outs == oracle and hits[1] == 13


def test_long_prompt_over_the_token_budget_matches_jax():
    longp = list(map(int, np.random.RandomState(9).randint(0, 64, 80)))
    jeng, teng = _engines(prefill_chunk=16, token_budget=32, num_pages=64)
    _same(jeng, teng, [longp], 4)
    assert teng.stats["max_prefill_step_tokens"] <= 16
    assert teng.stats["prefill_chunks"] == 5
    _, plain = _engines(token_budget=32, num_pages=64)
    with pytest.raises(ValueError):
        plain.submit(T.Request(0, list(longp), 4))


def test_resume_after_preemption_hits_its_own_pages_like_jax():
    prompts = _prompts(seed=9, lens=(5, 11, 6, 14))
    teng = _same(*_engines(num_pages=6, page_size=4, prefix_cache=True),
                 prompts, 5)
    assert teng.stats["preempted"] >= 1
    assert teng.stats["prefill_hit_tokens"] > 0


def test_features_off_run_the_plain_schedule():
    prompts = _prompts(seed=11, lens=(5, 11, 6, 14))
    _, a = _engines(num_pages=6, page_size=4)
    _, b = _engines(num_pages=6, page_size=4, prefix_cache=False,
                    prefill_chunk=0)
    assert _stream(a, T.Request, prompts, 5) == \
        _stream(b, T.Request, prompts, 5)
    assert a.stats == b.stats and a.stats["preempted"] >= 1
    assert a.stats["prefill_chunks"] == a.stats["prefill_hit_tokens"] == 0


# ==========================================================================
# token identity within the port
# ==========================================================================
def test_prefix_hit_equals_the_cold_oracle():
    prompts = _shared_prefix(seed=11)
    _, warm = _engines(prefix_cache=True)
    outs = warm.generate(prompts, max_new_tokens=6)
    assert outs == [warm.core.greedy_reference(p, 6) for p in prompts]
    assert warm.stats["prefill_hit_tokens"] > 0
    assert warm.stats["prefill_tokens"] < sum(len(p) for p in prompts)
    assert warm.kv.pages_in_use == 0


@pytest.mark.parametrize("chunk,lens", [(8, (16, 17, 5)), (4, (12, 31, 8))])
def test_chunked_prefill_equals_monolithic(chunk, lens):
    prompts = _prompts(seed=3, lens=lens)
    _, mono = _engines()
    want = mono.generate(prompts, max_new_tokens=5)
    assert want == [mono.core.greedy_reference(p, 5) for p in prompts]
    _, eng = _engines(prefill_chunk=chunk)
    assert eng.generate(prompts, max_new_tokens=5) == want
    assert eng.stats["prefill_chunks"] > len(prompts)


def test_decode_never_stalls_behind_a_chunked_prefill():
    longp = list(map(int, np.random.RandomState(2).randint(0, 64, 60)))
    _, eng = _engines(prefill_chunk=16, token_budget=128, num_pages=64)
    for i in range(2):
        eng.submit(T.Request(i, _prompts(seed=i, lens=(4,))[0], 30))
    eng.step()
    eng.step()
    eng.stats["max_prefill_step_tokens"] = 0
    eng.submit(T.Request("long", list(longp), 4))
    chunk_steps = starved = 0
    while eng.has_work():
        evs = eng.step()
        if eng._prefill_job is not None:
            chunk_steps += 1
            starved += not any(e.req_id in (0, 1) for e in evs)
    assert chunk_steps >= 2 and starved == 0
    assert eng.stats["max_prefill_step_tokens"] <= 16
