"""PyTorch port, serving completeness: sampled and speculative decoding
against the JAX package on the CPU, at the tiny decoder of
``tests/test_torch_serving.py``.

* RNG lanes and the n-gram proposer's drafts equal JAX's;
* ``sample_token``: the support it keeps equals JAX's filter on the same
  logits (top-k, nucleus, ties), ``temperature <= 0`` is argmax, and a
  fixed-seed chi-square holds its hash draws to the filtered softmax.
  Its draws are the port's own hash, not ``jax.random.categorical``, so
  sampled tokens are compared within the port only;
* ``truncate_tokens`` leaves the allocator exactly as JAX's does (within
  a page, across pages, with and without the prefix cache, a shared
  tail);
* the verify form's logits equal the reference form's (atol 1e-5);
* greedy speculative decoding: event streams and stats equal the JAX
  spec engine's on f32 and int8 pools, under preemption, with the prefix
  cache and chunked prefill, and its tokens equal the port's own
  ``spec_k=0`` stream; zero acceptance is exactly the baseline; EOS
  mid-draft stops as in JAX; the budget charges accepted + 1 tokens;
* sampled decoding replays bit for bit, ``top_k=1`` equals greedy in
  every form, and lanes are the same after a preemption.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as J
from paddle_tpu.inference.kv_cache import KVCacheConfig as JKVConfig
from paddle_tpu.inference.kv_cache import PagedKVCache as JPagedKVCache
from paddle_tpu.inference import spec_decode as jspec
from paddle_tpu.utils import loadgen as jloadgen

import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.inference import spec_decode as tspec
from paddle_tpu_torch.inference.kv_cache import KVCacheConfig, PagedKVCache
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.sampling_ops import filter_logits, sample_token
from paddle_tpu_torch.utils import flags as tflags
from paddle_tpu_torch.utils import loadgen as tloadgen

import jax.numpy as jnp
from torch_serving_parity import (JCFG, TCFG, fresh_observability,
                                  jax_engine, port_engine, prompts, stream)

SP = tspec.SamplingParams(temperature=0.8, top_k=20, top_p=0.95)
K1 = tspec.SamplingParams(temperature=0.7, top_k=1)


@pytest.fixture(autouse=True)
def _fresh():
    restore = fresh_observability()
    yield
    restore()


_BASE = {}


def port_baseline():
    """The port's greedy stream of ``prompts()`` at max_new 10 (engine
    defaults), computed once."""
    if "out" not in _BASE:
        eng = port_engine()
        _BASE["out"] = eng.generate(prompts(), max_new_tokens=10)
        _BASE["decode_steps"] = eng.stats["decode_steps"]
    return _BASE["out"]


# ==========================================================================
# RNG lanes and the proposers
# ==========================================================================
def test_rng_lane_equals_jax():
    for seed in (0, 3, 12345):
        for rid in (0, 7, "r1", "burst-3"):
            for pos in (0, 1, 17, 1023):
                assert tspec.rng_lane(seed, rid, pos) == \
                    jspec.rng_lane(seed, rid, pos)
    lanes = {tspec.rng_lane(3, "r1", p) for p in range(64)}
    assert len(lanes) == 64 and all(0 <= v < 2 ** 31 for v in lanes)


def test_ngram_proposals_equal_jax():
    rng = np.random.RandomState(4)
    for trial in range(60):
        n = int(rng.randint(1, 24))
        hist = rng.randint(0, 5 if trial % 2 else 40, size=n).tolist()
        split = int(rng.randint(0, n + 1))
        want_req = J.Request("x", hist[:split], 8)
        want_req.out_tokens = hist[split:]
        got_req = T.Request("x", hist[:split], 8)
        got_req.out_tokens = hist[split:]
        for max_n, min_n in ((3, 1), (2, 2), (4, 1)):
            for k in (0, 1, 4):
                assert tspec.NGramProposer(max_n, min_n).propose(
                    got_req, k) == jspec.NGramProposer(max_n, min_n).propose(
                        want_req, k)
    assert tspec.NullProposer().propose(got_req, 4) == []
    assert isinstance(tspec.get_proposer("ngram", max_n=2),
                      tspec.NGramProposer)
    with pytest.raises(ValueError):
        tspec.get_proposer("nope")


# ==========================================================================
# the sample_token op
# ==========================================================================
def _jax_filter(logits, temp, top_k, top_p):
    """JAX ``ops/sampling_ops.py:_sample_token``'s filter, line for line
    (the op returns only its draws)."""
    x = jnp.asarray(logits) / temp
    vocab = x.shape[-1]
    if 0 < top_k < vocab:
        kth = jnp.sort(x, axis=-1)[..., vocab - top_k][..., None]
        x = jnp.where(x < kth, -jnp.inf, x)
    if 0.0 < top_p < 1.0:
        import jax

        xs = jnp.sort(x, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(xs, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        keep = (cum - probs) < top_p
        kth = jnp.min(jnp.where(keep, xs, jnp.inf), axis=-1, keepdims=True)
        x = jnp.where(x < kth, -jnp.inf, x)
    return np.isfinite(np.asarray(x))


def _tied_logits():
    rng = np.random.RandomState(2)
    x = np.round(rng.randn(6, 40) * 2).astype(np.float32) / 2   # many ties
    return x


@pytest.mark.parametrize("temp,top_k,top_p,ties", [
    (1.0, 4, 1.0, False), (0.7, 0, 0.5, False), (1.3, 10, 0.8, False),
    (1.0, 5, 0.6, True)])
def test_sample_token_support_equals_jax_filter(temp, top_k, top_p, ties):
    rng = np.random.RandomState(1)
    logits = _tied_logits() if ties else \
        (rng.randn(8, 64) * 3).astype(np.float32)
    want = _jax_filter(logits, temp, top_k, top_p)
    got = torch.isfinite(filter_logits(torch.from_numpy(logits), temp,
                                       top_k, top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    # every draw, under many lanes, lands in the kept support
    lanes = torch.arange(200, dtype=torch.int32) * 7919
    for r in range(logits.shape[0]):
        row = torch.from_numpy(np.tile(logits[r:r + 1], (200, 1)))
        draws = sample_token(row, lanes, temp, top_k, top_p).numpy()
        assert want[r][draws].all()
        if ties:
            # ties at the threshold stay in the support and get drawn
            assert len(set(draws.tolist())) == int(want[r].sum())


def test_sample_token_greedy_is_argmax_and_op_slots():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    lanes = torch.arange(5, dtype=torch.int32)
    assert sample_token(logits, lanes, 0.0).tolist() == \
        torch.argmax(logits, -1).tolist()
    assert sample_token(logits, lanes, -1.0, 3, 0.5).tolist() == \
        torch.argmax(logits, -1).tolist()
    # the registered op: JAX's slots and attrs, deterministic in the lanes
    from paddle_tpu_torch.framework import core as tcore

    prog = tcore.Program()
    blk = prog.global_block()
    for n in ("lg", "sd", "out"):
        blk.create_var(name=n)
    op = blk.append_op("sample_token",
                       inputs={"Logits": ["lg"], "Seeds": ["sd"]},
                       outputs={"Out": ["out"]},
                       attrs={"temperature": 0.8, "top_k": 4, "top_p": 0.9})
    env = {"lg": logits, "sd": lanes}
    treg.run_op(op, env, blk)
    assert env["out"].dtype == torch.int64
    assert env["out"].tolist() == sample_token(logits, lanes, 0.8, 4,
                                               0.9).tolist()


def test_sample_token_chi_square_against_filtered_softmax():
    """Fixed-seed chi-square of 40,000 draws (one lane each) per row
    against the filtered softmax: below the 0.999 quantile of its
    degrees of freedom, and no draw outside the support."""
    from scipy.stats import chi2 as chi2_dist

    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 24) * 1.5).astype(np.float32)
    n = 40000
    lanes = torch.from_numpy(
        (np.arange(n, dtype=np.int64) * 2654435761 % (2 ** 31))
        .astype(np.int32))
    for row, (temp, top_k, top_p) in zip(
            logits, ((1.0, 0, 1.0), (0.8, 10, 1.0), (1.2, 0, 0.7))):
        x = torch.from_numpy(np.tile(row, (n, 1)))
        draws = sample_token(x, lanes, temp, top_k, top_p).numpy()
        keep = filter_logits(torch.from_numpy(row[None]), temp, top_k,
                             top_p)[0]
        p = torch.softmax(keep.double(), -1).numpy()
        support = p > 0
        counts = np.bincount(draws, minlength=row.size)
        assert counts[~support].sum() == 0
        exp = n * p[support]
        chi2 = float(((counts[support] - exp) ** 2 / exp).sum())
        assert chi2 < chi2_dist.ppf(0.999, int(support.sum()) - 1), \
            (temp, top_k, top_p, chi2)


# ==========================================================================
# truncate_tokens: the allocator against JAX's
# ==========================================================================
def _state(kv):
    seqs = {sid: (list(s.pages), s.length, list(s.tokens), s.digest,
                  list(s.tail), s.opaque) for sid, s in kv._seqs.items()}
    return (seqs, list(kv._free), dict(kv._refs), dict(kv._used),
            dict(kv._full_key), dict(kv._index),
            {d: dict(m) for d, m in kv._partials.items()},
            dict(kv._page_partial), dict(kv._cached_free), kv.stats())


def _script(kv, case):
    """One scripted allocator history per case; the observables after
    each truncate."""
    seen = []
    if case == "within_page":
        toks = list(range(100, 106))
        kv.append_tokens("A", 6, tokens=toks)
        kv.truncate_tokens("A", 1)
        seen.append((_state(kv), kv.match_prefix(toks[:5] + [1, 2])))
        seen.append(kv.append_tokens("A", 1, tokens=[55]).tolist())
    elif case == "cross_page":
        toks = list(range(10))
        kv.append_tokens("A", 10, tokens=toks)
        kv.truncate_tokens("A", 4)
        seen.append((_state(kv), kv.match_prefix(toks)))
        kv.append_tokens("A", 3, tokens=[7, 8, 9])
        kv.free_sequence("A")
        seen.append((_state(kv), kv.match_prefix(toks[:6] + [7, 8, 9])))
    elif case == "shared_tail":
        t2 = list(range(50, 59))
        kv.append_tokens("X", 9, tokens=t2)
        hit, pages = kv.match_prefix(t2)
        kv.acquire_prefix("Y", t2, pages)
        kv.truncate_tokens("Y", 1)
        seen.append((_state(kv), kv.refcount(pages[-1])))
        kv.truncate_tokens("Y", 4)
        seen.append((_state(kv), kv.match_prefix(t2)))
        seen.append(kv.append_tokens("Y", 2, tokens=[1, 2]).tolist())
        seen.append(_state(kv))
    else:   # plain: the prefix cache off, opaque appends
        kv.append_tokens("A", 10)
        kv.truncate_tokens("A", 5)
        kv.truncate_tokens("A", 0)
        seen.append(_state(kv))
        kv.append_tokens("B", 7)
        kv.truncate_tokens("A", 5)
        seen.append((_state(kv), kv.append_tokens("A", 6).tolist()))
        try:
            kv.truncate_tokens("A", 7)
        except ValueError as e:
            seen.append(str(e))
    return seen


@pytest.mark.parametrize("case,prefix", [
    ("within_page", True), ("cross_page", True), ("shared_tail", True),
    ("plain", False)])
def test_truncate_tokens_matches_jax(case, prefix):
    kw = dict(num_pages=8, page_size=4, num_kv_heads=1, head_dim=8)
    want = _script(JPagedKVCache(JKVConfig(**kw), prefix_cache=prefix),
                   case)
    got = _script(PagedKVCache(KVCacheConfig(**kw), prefix_cache=prefix),
                  case)
    assert got == want


# ==========================================================================
# the verify form
# ==========================================================================
def test_verify_logits_match_reference_form():
    """Each verify row's logits against the reference form's over the
    same prefix (atol 1e-5), drafts recorded from a speculative run."""
    eng = port_engine(spec_k=3)
    core = eng.core
    rec = {}
    verify = core.model.verify

    def capture(*a, **kw):
        out = verify(*a, **kw)
        if "logits" not in rec and rec.get("items"):
            rec["logits"] = out.clone()
            rec["S"] = a[0].shape[1]
        return out

    batch = core.verify_batch

    def record(items):
        if "items" not in rec and any(d for _, d in items):
            rec["items"] = [(list(st.req.prompt) + list(st.req.out_tokens),
                             list(d)) for st, d in items]
        return batch(items)

    core.model.verify = capture
    core.verify_batch = record
    eng.generate(prompts(seed=8, n=3), max_new_tokens=8)
    assert "logits" in rec, "no verify call carried a draft"
    S = rec["S"]
    for i, (prefix, draft) in enumerate(rec["items"]):
        for j in range(len(draft) + 1):
            want = core.reference_logits(prefix + draft[:j])
            np.testing.assert_allclose(rec["logits"][i * S + j].numpy(),
                                       want.numpy(), atol=1e-5, rtol=0)


# ==========================================================================
# greedy speculative decoding against the JAX spec engine
# ==========================================================================
def _shared_prompts():
    rng = np.random.RandomState(5)
    shared = list(map(int, rng.randint(0, 64, size=20)))
    return [shared + p for p in prompts(seed=6, n=3, lo=3, hi=8)] \
        + prompts(seed=7, n=2)


@pytest.mark.parametrize("case", ["f32", "int8_preempt", "f32_preempt",
                                  "prefix_chunk"])
def test_greedy_spec_matches_jax_and_plain_decoding(case):
    kw, ps, max_new = {
        "f32": ({}, prompts(), 10),
        "int8_preempt": (dict(kv_dtype="int8", num_pages=8, page_size=4),
                         prompts(), 10),
        "f32_preempt": (dict(num_pages=8, page_size=4), prompts(), 10),
        "prefix_chunk": (dict(prefix_cache=True, prefill_chunk=8),
                         _shared_prompts(), 8),
    }[case]
    want = stream(jax_engine(spec_k=4, **kw), J.Request, ps, max_new)
    got = stream(port_engine(spec_k=4, **kw), T.Request, ps, max_new)
    assert got == want
    stats = got[1]
    assert stats["spec_accepted"] > 0
    if "preempt" in case:
        assert stats["preempted"] > 0
    if case == "prefix_chunk":
        assert stats["prefill_hit_tokens"] > 0
        assert stats["prefill_chunks"] > len(ps)
    # the port's own plain decoding gives the same tokens, in more steps
    plain = port_engine(**kw)
    assert plain.generate(ps, max_new) == port_engine(spec_k=4, **kw) \
        .generate(ps, max_new)
    assert plain.stats["decode_steps"] > stats["decode_steps"]


def test_zero_accept_is_exactly_baseline():
    a = stream(port_engine(), T.Request, prompts(), 8)
    null = port_engine(spec_k=4, proposer=tspec.NullProposer())
    b = stream(null, T.Request, prompts(), 8)
    assert b[0] == a[0]
    assert b[1] == a[1]
    assert null._spec_debt == 0


def test_eos_mid_draft_stops_like_jax():
    base = port_baseline()
    eos = next(o[2] for o in base if len(o) > 3)
    jcfg = dataclasses.replace(JCFG, eos_id=int(eos))
    tcfg = dataclasses.replace(TCFG, eos_id=int(eos))
    want = stream(jax_engine(jcfg, spec_k=4), J.Request, prompts(), 10)
    got = stream(port_engine(tcfg, spec_k=4), T.Request, prompts(), 10)
    assert got == want
    outs = port_engine(tcfg, spec_k=4).generate(prompts(), 10)
    assert outs == port_engine(tcfg).generate(prompts(), 10)
    assert any(o[-1] == eos and len(o) < 10 for o in outs)


def test_spec_budget_charges_accepted_plus_one():
    spec = port_engine(spec_k=4)
    out = spec.generate(prompts(), max_new_tokens=10)
    assert out == port_baseline()
    assert spec._spec_debt == 0
    assert spec.stats["decode_tokens"] == \
        sum(len(o) for o in out) - spec.stats["admitted"]
    tight = port_engine(spec_k=4, token_budget=16, max_batch=2)
    assert tight.generate(prompts(), max_new_tokens=10) == out
    assert tight._spec_debt == 0


# ==========================================================================
# sampled decoding
# ==========================================================================
def test_sampled_replay_is_bit_identical():
    def run(**kw):
        eng = port_engine(sampling=SP, **kw)
        return eng.generate(prompts(), max_new_tokens=10), eng.stats

    a = run()
    assert a == run()
    assert run(spec_k=4) == run(spec_k=4)
    assert run(prefill_chunk=4) == run(prefill_chunk=4)
    assert a[0] != port_baseline()     # the sampler really engages


@pytest.mark.parametrize("form", ["plain", "spec", "spec_preempt",
                                  "chunked"])
def test_topk1_sampling_equals_greedy(form):
    kw = {"plain": {}, "spec": dict(spec_k=4),
          "spec_preempt": dict(spec_k=4, num_pages=8, page_size=4),
          "chunked": dict(prefill_chunk=4, prefix_cache=True)}[form]
    eng = port_engine(sampling=K1, **kw)
    assert eng.generate(prompts(), max_new_tokens=10) == port_baseline()
    if form == "spec_preempt":
        assert eng.stats["preempted"] > 0
    if form != "plain" and "spec" in form:
        assert eng.stats["spec_accepted"] > 0


def test_rng_lanes_resume_invariant(monkeypatch):
    orig = T._EngineCore._lane

    def capture():
        lanes = {}

        def rec(self, req, offset=0):
            v = orig(self, req, offset)
            pos = len(req.prompt) + len(req.out_tokens) + offset
            lanes.setdefault((req.req_id, pos), set()).add(v)
            return v

        monkeypatch.setattr(T._EngineCore, "_lane", rec)
        return lanes

    l1 = capture()
    port_engine(sampling=SP, spec_k=4).generate(prompts(), 10)
    l2 = capture()
    eng = port_engine(sampling=SP, spec_k=4, num_pages=8, page_size=4)
    eng.generate(prompts(), 10)
    assert eng.stats["preempted"] > 0
    for lanes in (l1, l2):
        assert lanes and all(len(v) == 1 for v in lanes.values())
    shared = set(l1) & set(l2)
    assert shared
    for key in shared:
        assert l1[key] == l2[key] == {jspec.rng_lane(3, *key)}


def test_flags_arm_spec_and_sampling():
    tflags.set_flags({"FLAGS_spec_decode_k": 2,
                      "FLAGS_sample_temperature": 0.5})
    eng = port_engine()
    assert eng.spec_k == 2 and isinstance(eng.proposer, tspec.NGramProposer)
    assert eng.sampling is not None \
        and eng.sampling.temperature == pytest.approx(0.5)
    eng2 = port_engine(spec_k=0, sampling=tspec.SamplingParams())
    assert eng2.spec_k == 0 and eng2.sampling is None \
        and eng2.core.sampling is None


def test_poisson_trace_equals_jax():
    kw = dict(num_requests=12, rate=30.0, vocab_size=64, seed=9)
    for extra in ({}, dict(repeat_frac=0.6),
                  dict(prefix_len=12, prefix_share=0.8)):
        want = jloadgen.poisson_trace(**kw, **extra)
        got = tloadgen.poisson_trace(**kw, **extra)
        assert [(e.req_id, e.arrival, e.prompt, e.max_new_tokens)
                for e in got] == [(e.req_id, e.arrival, e.prompt,
                                   e.max_new_tokens) for e in want]
