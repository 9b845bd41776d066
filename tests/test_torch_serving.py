"""PyTorch port, decode-serving slice: ``paddle_tpu_torch`` against the JAX
package on the same weights and requests, on the CPU.

* weights: ``init_decoder_weights`` is bit-identical, and a JAX
  ``export_decoder`` directory loads into the port;
* allocator: one op sequence gives equal slots, block tables and stats;
* decoder forms: reference / prefill / decode logits agree with the JAX
  programs' ``_srv_logits`` (atol/rtol 1e-4: two f32 compositions), and
  prefill writes the same K/V pools;
* engine: identical token streams and ``StepEvent`` order, with and
  without preemption, and identical scheduler / allocator counters;
* the package imports neither ``jax`` nor any ``paddle_tpu`` module and
  refuses to fall back to the CPU without being asked.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as J
from paddle_tpu.inference.kv_cache import KVCacheConfig as JKVConfig
from paddle_tpu.inference.kv_cache import PagedKVCache as JPagedKVCache

import paddle_tpu_torch as ptt
import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.inference.kv_cache import KVCacheConfig, PagedKVCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")

SMALL = dict(vocab_size=64, hidden=32, num_heads=4, num_layers=2,
             max_seq_len=128)
JCFG = J.DecoderConfig(**SMALL)
TCFG = T.DecoderConfig(**SMALL)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _prompts(seed=7, lens=(3, 11, 6, 14), vocab=64):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lens]


def _engines(cfg=SMALL, **kw):
    kw.setdefault("num_pages", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("token_budget", 64)
    kw.setdefault("prefill_bucket_min", 8)
    return (J.ServingEngine(J.DecoderConfig(**cfg), **kw),
            T.ServingEngine(T.DecoderConfig(**cfg), device="cpu", **kw))


def _stream(eng, request_cls, prompts, max_new):
    reqs = [request_cls(i, list(p), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    events = []
    while eng.has_work():
        events.extend((e.req_id, e.token, e.finished) for e in eng.step())
    return events, [r.out_tokens for r in reqs], eng.kv.stats()


# ==========================================================================
# weights
# ==========================================================================
@pytest.mark.parametrize("seed", [0, 3])
def test_init_decoder_weights_bit_identical(seed):
    want = J.init_decoder_weights(JCFG, seed)
    got = T.init_decoder_weights(TCFG, seed)
    assert list(got) == list(want)
    assert T.decoder_param_specs(TCFG) == J.decoder_param_specs(JCFG)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].dtype == want[name].dtype


def test_config_round_trip_matches_jax():
    cfg = T.DecoderConfig(vocab_size=50, hidden=24, num_heads=3,
                          num_layers=1, ffn_hidden=40, eos_id=5)
    jcfg = J.DecoderConfig.from_dict(cfg.to_dict())
    assert jcfg.to_dict() == cfg.to_dict()
    assert (cfg.head_dim, cfg.ffn) == (jcfg.head_dim, jcfg.ffn)


def test_export_dir_loads_into_port(tmp_path):
    model_dir = str(tmp_path / "decoder")
    J.export_decoder(model_dir, JCFG, seed=3)
    cfg, weights = T.load_decoder_weights(model_dir)
    assert cfg == TCFG
    for name, arr in J.init_decoder_weights(JCFG, 3).items():
        np.testing.assert_array_equal(weights[name], arr)
    prompts = _prompts(seed=5)
    jeng = J.ServingEngine(model_dir=model_dir, num_pages=32, page_size=8,
                           max_batch=4, token_budget=64,
                           prefill_bucket_min=8)
    teng = T.ServingEngine(model_dir=model_dir, num_pages=32, page_size=8,
                           max_batch=4, token_budget=64,
                           prefill_bucket_min=8, device="cpu")
    assert teng.generate(prompts, 5) == jeng.generate(prompts, 5)


def test_missing_weight_file_raises(tmp_path):
    model_dir = str(tmp_path / "decoder")
    J.export_decoder(model_dir, JCFG, seed=0)
    os.remove(os.path.join(model_dir, "dec_l1_w2.npy"))
    with pytest.raises(FileNotFoundError, match="dec_l1_w2"):
        T.load_decoder_weights(model_dir)


# ==========================================================================
# allocator
# ==========================================================================
def _alloc_ops(kv):
    """One op sequence over an allocator; returns every observable."""
    seen = []
    for op, sid, n in [("a", "a", 9), ("a", "b", 9), ("a", "b", 4),
                       ("a", "a", 3), ("a", "a", 4), ("f", "a", 0),
                       ("a", "c", 12), ("a", "b", 1), ("f", "b", 0),
                       ("a", "d", 5), ("a", "c", 1)]:
        if op == "a":
            s = kv.append_tokens(sid, n)
            seen.append(None if s is None else s.tolist())
        else:
            kv.free_sequence(sid)
        for live in kv.live_sequences():
            seen.append((live, kv.context_len(live), kv.num_pages_of(live),
                         kv.block_table(live, 8).tolist()))
        seen.append((kv.num_free_pages, kv.pages_in_use,
                     kv.pages_needed("b", 5), kv.can_append("c", 9),
                     kv.stats()))
    return seen


@pytest.mark.parametrize("num_pages,page_size", [(6, 4), (8, 2)])
def test_allocator_matches_jax(num_pages, page_size):
    kw = dict(num_pages=num_pages, page_size=page_size, num_kv_heads=2,
              head_dim=8, num_layers=2)
    want = _alloc_ops(JPagedKVCache(JKVConfig(**kw), prefix_cache=False))
    got = _alloc_ops(PagedKVCache(KVCacheConfig(**kw)))
    assert got == want
    assert KVCacheConfig(**kw).pad_slot == JKVConfig(**kw).pad_slot


def test_allocator_backpressure_changes_nothing():
    kv = PagedKVCache(KVCacheConfig(num_pages=4, page_size=4,
                                    num_kv_heads=1, head_dim=8))
    assert kv.append_tokens("a", 9) is not None
    before = kv.stats()
    assert kv.append_tokens("b", 9) is None
    assert kv.stats() == before and "b" not in kv.live_sequences()
    with pytest.raises(ValueError, match="width"):
        kv.block_table("a", 2)


# ==========================================================================
# decoder forms: logits against the JAX programs
# ==========================================================================
def _cores(num_pages=16, page_size=4):
    w = J.init_decoder_weights(JCFG, 0)
    jcore = J._EngineCore(JCFG, w, num_pages=num_pages, page_size=page_size,
                          prefill_bucket_min=8)
    tcore = T._EngineCore(TCFG, w, num_pages=num_pages, page_size=page_size,
                          prefill_bucket_min=8, device="cpu")
    return jcore, tcore


def _jax_logits(core, prog, feed):
    return np.asarray(core.exe.run(prog, feed=feed,
                                   fetch_list=[prog._srv_logits],
                                   scope=core.scope)[0])


def _dense_feed(seq, s):
    toks = np.zeros((1, s), np.int32)
    toks[0, :len(seq)] = seq
    return {"tokens": toks,
            "positions": np.arange(s, dtype=np.int32)[None],
            "attn_mask": T._causal_mask(s),
            "last_index": np.array([len(seq) - 1], np.int32)}


def _t(feed, names):
    return [torch.from_numpy(np.asarray(feed[n])) for n in names]


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(T._causal_mask(8), J._causal_mask(8))
    assert T.NEG_INF == J.NEG_INF


@pytest.mark.parametrize("length", [1, 5, 16])
def test_reference_form_logits_match_jax(length):
    jcore, tcore = _cores()
    seq = _prompts(seed=length, lens=(length,))[0]
    feed = _dense_feed(seq, 16)
    want = _jax_logits(jcore, jcore.ref_prog, feed)
    got = tcore.model.reference(*_t(feed, ["tokens", "positions",
                                           "attn_mask", "last_index"]))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(tcore.reference_logits(seq).numpy(),
                               want[0], **LOGIT_TOL)


def _pools_equal(jcore, tcore):
    for i, (k, v) in enumerate(tcore.kv_pools):
        np.testing.assert_allclose(k.numpy(),
                                   np.asarray(jcore.scope.get(f"kv_k_{i}")),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(jcore.scope.get(f"kv_v_{i}")),
                                   **LOGIT_TOL)


def test_prefill_form_logits_and_pools_match_jax():
    jcore, tcore = _cores()
    seq = _prompts(seed=1, lens=(11,))[0]
    feed = _dense_feed(seq, 16)
    pad = tcore.kv_config.pad_slot
    # pages 3, 0, 2 (not in order); the bucket tail carries the sentinel
    slots = [3 * 4 + j for j in range(4)] + list(range(4)) + \
        [2 * 4 + j for j in range(3)]
    feed["slot_mapping"] = np.array(slots + [pad] * 5, np.int32)
    want = _jax_logits(jcore, jcore.prefill_prog, feed)
    got = tcore.model.prefill(
        *_t(feed, ["tokens", "positions", "attn_mask", "last_index",
                   "slot_mapping"]), tcore.kv_pools)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _pools_equal(jcore, tcore)


def test_decode_form_logits_match_jax():
    """Prefill two prompts through each engine core, then one decode
    step with a bucket-padded batch (3 rows -> 4) fed identically."""
    jcore, tcore = _cores()
    reqs = [J.Request(i, p, 4) for i, p in enumerate(
        _prompts(seed=2, lens=(6, 13, 3)))]
    firsts = []
    for r in reqs:
        firsts.append((jcore.prefill(r), tcore.prefill(r)))
    assert [a for a, _ in firsts] == [b for _, b in firsts]
    _pools_equal(jcore, tcore)
    pad = tcore.kv_config.pad_slot
    toks, pos, slot_map, ctx = (np.zeros(4, np.int32), np.zeros(4, np.int32),
                                np.full(4, pad, np.int32),
                                np.ones(4, np.int32))
    for i, r in enumerate(reqs):
        toks[i] = firsts[i][0]
        pos[i] = tcore.kv.context_len(r.req_id)
        slot_map[i] = tcore.kv.append_tokens(r.req_id, 1)[0]
        jcore.kv.append_tokens(r.req_id, 1)
        ctx[i] = tcore.kv.context_len(r.req_id)
    tables = np.zeros((4, 4), np.int32)
    for i, r in enumerate(reqs):
        tables[i] = tcore.kv.block_table(r.req_id, 4)
    feed = {"tokens": toks, "positions": pos, "block_tables": tables,
            "context_lens": ctx, "slot_mapping": slot_map}
    want = _jax_logits(jcore, jcore.decode_prog, feed)
    got = tcore.model.decode(*_t(feed, ["tokens", "positions",
                                        "block_tables", "context_lens",
                                        "slot_mapping"]), tcore.kv_pools)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _pools_equal(jcore, tcore)


# ==========================================================================
# engine: token streams and event order
# ==========================================================================
@pytest.mark.parametrize("pool,lens", [
    (dict(num_pages=32, page_size=8), (3, 11, 6, 14)),
    (dict(num_pages=6, page_size=4), (3, 11, 6, 14)),     # preempts
    # prompts ending on page boundaries in a tight pool: admission must
    # keep one token of headroom for the admitted sequence itself
    (dict(num_pages=5, page_size=4), (8, 8, 4)),
])
def test_engine_matches_jax_event_stream(pool, lens):
    jeng, teng = _engines(**pool)
    prompts = _prompts(seed=9, lens=lens)
    want = _stream(jeng, J.Request, prompts, 5)
    got = _stream(teng, T.Request, prompts, 5)
    assert got == want
    for key in teng.stats:
        assert teng.stats[key] == jeng.stats[key], key
    if pool["num_pages"] == 6:
        assert teng.stats["preempted"] >= 1      # the scenario really bites


def test_engine_equals_one_at_a_time_reference():
    _, teng = _engines(num_pages=6, page_size=4)
    prompts = _prompts(seed=11)
    outs = teng.generate(prompts, max_new_tokens=6)
    assert outs == [teng.core.greedy_reference(p, 6) for p in prompts]
    assert teng.kv.pages_in_use == 0


def test_eos_stops_generation_like_jax():
    _, probe = _engines()
    prompts = _prompts(seed=3, lens=(3, 11))
    eos = probe.generate(prompts, max_new_tokens=6)[0][2]
    jeng, teng = _engines(cfg={**SMALL, "eos_id": int(eos)})
    want = _stream(jeng, J.Request, prompts, 6)
    got = _stream(teng, T.Request, prompts, 6)
    assert got == want
    assert got[1][0][-1] == eos and len(got[1][0]) <= 3


def test_prefill_only_request_fills_pool_exactly():
    _, teng = _engines(num_pages=4, page_size=4)
    teng.submit(T.Request(0, list(range(1, 17)), 0))
    events = teng.run_to_completion()
    assert [e.finished for e in events] == [True]
    assert teng.stats["finished"] == 1 and teng.kv.pages_in_use == 0


@pytest.mark.parametrize("prompt_len,max_new,num_pages,reason", [
    (120, 20, 32, "max_seq_len"), (14, 8, 4, "pool"),
    (70, 2, 32, "budget")])
def test_submit_rejections_match_jax(prompt_len, max_new, num_pages,
                                     reason):
    jeng, teng = _engines(num_pages=num_pages, page_size=4)
    for eng, req_cls, rej in ((jeng, J.Request, J.RequestRejected),
                              (teng, T.Request, T.RequestRejected)):
        with pytest.raises(rej) as e:
            eng.submit(req_cls(0, list(range(prompt_len)), max_new))
        assert e.value.reason == reason
        assert isinstance(e.value, ValueError)


def test_kv_pool_resident_bytes_matches_jax():
    jcore, tcore = _cores(num_pages=10, page_size=4)
    assert tcore.kv_pool_resident_bytes() == jcore.kv_pool_resident_bytes()


# ==========================================================================
# boundaries: device, unported options, imports
# ==========================================================================
def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ServingEngine(TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DecoderLM(TCFG, T.init_decoder_weights(TCFG, 0))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("kw", [
    dict(tp=2), dict(spec_k=2), dict(sampling=object()),
    dict(admission_policy="slo_aware"), "truncate_tokens"])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        if kw == "truncate_tokens":   # speculative decoding's rollback
            kv = PagedKVCache(KVCacheConfig(num_pages=4, page_size=4,
                                            num_kv_heads=1, head_dim=8))
            kv.append_tokens("a", 5)
            kv.truncate_tokens("a", 2)
        else:
            T.ServingEngine(TCFG, device="cpu", **kw)


def test_unknown_admission_policy_raises():
    with pytest.raises(ValueError, match="unknown admission policy"):
        T.ServingEngine(TCFG, device="cpu", admission_policy="lifo")


def test_import_loads_no_jax_or_paddle_tpu():
    code = (
        "import sys, pkgutil, importlib, paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith("
        "'paddle_tpu_torch')]), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 10 and bad.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_sources_import_no_jax_or_paddle_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 12
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{os.path.relpath(f, ROOT)} imports {mod}"


def test_package_exports_the_entry_points():
    for name in ("DecoderConfig", "Request", "ServingEngine", "StepEvent",
                 "init_decoder_weights", "load_decoder_weights"):
        assert getattr(ptt, name) is getattr(T, name)
