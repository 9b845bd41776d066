"""PyTorch port, quantized KV pools (bf16, int8): ``paddle_tpu_torch``
against the JAX package on the same numpy inputs, on the CPU.

* the int8 write ``quant_scatter_`` / ``kv_cache_append`` with scales ==
  JAX ``_quant_scatter`` / ``kv_cache_append`` bit for bit (codes and
  scales): reset-on-open, the monotone scale, requant on a growing scale,
  several slots of one page in one write, pad sentinels, a zero-scale
  page, seeded random writes; the bf16 write == JAX's cast bit for bit;
* ``kv_dequant`` == JAX ``kv_dequant`` bit for bit;
* the plain paged attention over bf16 and int8 pools == JAX
  ``paged_attention_reference`` and == the Pallas kernel in interpret
  mode (GQA, page boundaries, a context of 0): ``PLAIN_TOL``;
* the decode and chunk forms from one quantized state (the JAX engine's
  pools and scale pools copied into the port's): logits within
  ``LOGIT_TOL``, codes after the step within 1;
* engine event streams == JAX's for every pool dtype x chunk in {0, 4}
  (prefix cache off here; on in ``test_torch_prefix_cache.py``), on the
  seed-7 prompts and a shared-prefix trace; int8 pools and scales after
  the run within 1 code and ``SCALE_RTOL`` of JAX's;
* a byte budget buys exactly 2x (bf16) and 4x (int8) the f32 pages;
  ``kv_pool_resident_bytes`` and ``memory_stats`` equal JAX's;
  ``FLAGS_kv_cache_dtype`` routes, a bad dtype raises as in JAX;
* within a dtype: a prefix hit == a cold run, chunked == monolithic.

Tolerances.  ``PLAIN_TOL`` (atol/rtol 1e-5): the port dequantizes in the
Pallas kernel's order ``k * (s / 127)`` and JAX's reference in
``(k * s) / 127``, up to two f32 ulps apart per element, and the sums run in
another order (measured below 2e-7).  ``LOGIT_TOL`` (1e-4): two f32
compositions of one model, as ``test_torch_serving.py``.  ``SCALE_RTOL``
(1e-5): a scale is the absmax of K or V rows, which torch's and XLA's
matmuls compute an ulp or so apart; for the same reason a code may sit
one rounding step apart.  ``BF16_POOL_TOL`` (one bf16 ulp of the pool's
largest magnitude): the same f32 ulps flip a bf16 rounding now and then,
and the flipped element reaches the next layer's K/V through the
attention (measured: 0.68 of that ulp at most, over these traces).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.inference.serving as J
from paddle_tpu.ops import paged_ops as jpo
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.registry import eager_call
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.inference.serving as T
from paddle_tpu_torch.inference.kv_cache import KVCacheConfig
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import paged_ops as tpo
from paddle_tpu_torch.utils import flags as tflags

SMALL = dict(vocab_size=64, hidden=32, num_heads=4, num_layers=2,
             max_seq_len=128)
PLAIN_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SCALE_RTOL = 1e-5
BF16_POOL_TOL = 2.0 ** -8
DTYPES = ("float32", "bfloat16", "int8")


@pytest.fixture(autouse=True)
def _flags_restored():
    saved_j, saved_t = dict(jflags._flags), dict(tflags._SET)
    yield
    jflags._flags.clear()
    jflags._flags.update(saved_j)
    tflags._SET.clear()
    tflags._SET.update(saved_t)


def _prompts_seed7():
    rng = np.random.RandomState(7)
    return [list(map(int, rng.randint(0, 64, size=n)))
            for n in (3, 11, 6, 14)]


def _shared_prefix():
    rng = np.random.RandomState(11)
    prefix = list(map(int, rng.randint(0, 64, size=20)))
    return [prefix + list(map(int, rng.randint(0, 64, size=n)))
            for n in (5, 3, 9, 1)]


TRACES = {"seed7": _prompts_seed7, "shared": _shared_prefix}


def _engines(**kw):
    kw.setdefault("num_pages", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("token_budget", 64)
    kw.setdefault("prefill_bucket_min", 8)
    return (J.ServingEngine(J.DecoderConfig(**SMALL), **kw),
            T.ServingEngine(T.DecoderConfig(**SMALL), device="cpu", **kw))


def _stream(eng, request_cls, prompts, max_new):
    """Every ``StepEvent`` (frozen: compared whole) on a logical clock."""
    reqs = [request_cls(i, list(p), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    events, t = [], 0.0
    while eng.has_work():
        t += 1.0
        events.extend((e.req_id, e.token, e.finished, e.time)
                      for e in eng.step(t))
    return events, [r.out_tokens for r in reqs], eng.kv.stats()


def jax_pools(jcore):
    """The JAX engine's pools and scale pools, per layer, as numpy."""
    out = []
    for i in range(jcore.cfg.num_layers):
        names = [f"kv_k_{i}", f"kv_v_{i}"]
        if jcore.kv_config.quantized:
            names += [f"kv_k_scale_{i}", f"kv_v_scale_{i}"]
        out.append([np.asarray(jcore.scope.get(n)).copy() for n in names])
    return out


def copy_jax_pools(jcore, tcore):
    """Start a port engine from a JAX engine's KV state: its pools and
    scale pools (bf16 pools through their f32 upcast, exact)."""
    for i, arrays in enumerate(jax_pools(jcore)):
        dst = list(tcore.kv_pools[i]) + list(tcore.kv_scales[i]
                                             if tcore.kv_scales else ())
        for t, a in zip(dst, arrays):
            t.copy_(torch.from_numpy(np.asarray(a, np.float32)
                                     if a.dtype.name == "bfloat16" else a))


def _pools_close(jcore, tcore):
    """int8: codes within 1 and scales within SCALE_RTOL; bf16: every
    element within one bf16 ulp of the pool's largest magnitude
    (``BF16_POOL_TOL``); f32: ``LOGIT_TOL``.  Returns the share of int8
    codes one step off."""
    off = total = 0
    for i, arrays in enumerate(jax_pools(jcore)):
        mine = list(tcore.kv_pools[i]) + list(tcore.kv_scales[i]
                                              if tcore.kv_scales else ())
        for t, a in zip(mine[:2], arrays[:2]):
            got = t.float().numpy()
            want = np.asarray(a, np.float32)
            if tcore.kv_config.quantized:
                diff = np.abs(got - want)
                assert diff.max() <= 1, diff.max()
                off += int((diff > 0).sum())
                total += diff.size
            elif t.dtype == torch.bfloat16:
                assert np.abs(got - want).max() <= \
                    BF16_POOL_TOL * np.abs(want).max()
            else:
                np.testing.assert_allclose(got, want, **LOGIT_TOL)
        for t, a in zip(mine[2:], arrays[2:]):
            np.testing.assert_allclose(t.numpy(), a, rtol=SCALE_RTOL, atol=0)
    return off / total if total else 0.0


# ==========================================================================
# the int8 write, bit for bit
# ==========================================================================
def _jax_scatter(pool, scales, new, slots, ps):
    q, s = jpo._quant_scatter(jnp.asarray(pool), jnp.asarray(scales),
                              jnp.asarray(new), jnp.asarray(slots), ps)
    return np.asarray(q), np.asarray(s)


def _port_scatter(pool, scales, new, slots, ps):
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    s = torch.from_numpy(slots).long()
    keep = s < pool.shape[1] * ps
    tpo.quant_scatter_(tp, ts, torch.from_numpy(new)[:, keep], s[keep])
    return tp.numpy(), ts.numpy()


def _bits_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


def _seeded_pool(rng, n_kv=2, n_pages=4, ps=4, d=8):
    pool = rng.randint(-127, 128, (n_kv, n_pages, ps, d)).astype(np.int8)
    scales = (np.abs(rng.randn(n_kv, n_pages)) + 0.5).astype(np.float32)
    return pool, scales


SCENARIOS = {
    # a write at page offset 0 recycles the page (old codes zeroed)
    "reset-on-open": ([4, 5], 0.3),
    # mid-page smaller values: the scale holds, old codes bit-stable
    "monotone": ([6], 0.05),
    # mid-page larger values: the scale grows, the page requantized
    "requant-growing": ([7], 9.0),
    # several slots of one page in one write (and another page's)
    "one-page-several-slots": ([9, 10, 11, 1], 2.0),
    # the pad sentinel (num_pages * page_size) among the slots, and alone
    "pad-sentinel": ([16, 2, 16], 4.0),
    "only-sentinels": ([16, 16], 4.0),
    # a write into a never-written page (scale 0)
    "zero-scale-page": ([13, 14], 1.5),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_quant_scatter_matches_jax_bit_for_bit(name):
    rng = np.random.RandomState(sorted(SCENARIOS).index(name))
    pool, scales = _seeded_pool(rng)
    scales[:, 3] = 0.0                      # page 3 never written
    pool[:, 3] = 0
    slots, mag = SCENARIOS[name]
    slots = np.asarray(slots, np.int32)
    new = (rng.randn(2, len(slots), 8) * mag).astype(np.float32)
    want = _jax_scatter(pool, scales, new, slots, 4)
    got = _port_scatter(pool, scales, new, slots, 4)
    _bits_equal(got, want)
    if name == "reset-on-open":
        assert (got[0][:, 1, 2:] == 0).all()
    if name == "only-sentinels":
        np.testing.assert_array_equal(got[0], pool)


@pytest.mark.parametrize("seed", range(4))
def test_quant_scatter_random_writes_match_jax(seed):
    rng = np.random.RandomState(100 + seed)
    n_kv, n_pages, ps, d = 2, 6, 4, 8
    pool, scales = _seeded_pool(rng, n_kv, n_pages, ps, d)
    scales *= rng.choice([0.0, 1.0, 4.0], size=scales.shape).astype(
        np.float32)
    for _ in range(25):
        t = rng.randint(1, 7)
        slots = rng.choice(n_pages * ps + 1, size=t,
                           replace=False).astype(np.int32)
        new = (rng.randn(n_kv, t, d) * rng.choice([0.1, 1, 5])).astype(
            np.float32)
        want = _jax_scatter(pool, scales, new, slots, ps)
        got = _port_scatter(pool, scales, new, slots, ps)
        _bits_equal(got, want)
        pool, scales = want


def _jax_append(k, v, slots, kp, vp, ks=None, vs=None):
    ins = {"K": [jnp.asarray(k)], "V": [jnp.asarray(v)],
           "SlotMapping": [jnp.asarray(slots)],
           "KCache": [jnp.asarray(kp)], "VCache": [jnp.asarray(vp)]}
    arity = {"KCacheOut": 1, "VCacheOut": 1}
    if ks is not None:
        ins["KScale"], ins["VScale"] = [jnp.asarray(ks)], [jnp.asarray(vs)]
        arity.update(KScaleOut=1, VScaleOut=1)
    outs = eager_call("kv_cache_append", ins, {}, arity)
    return [np.asarray(outs[k][0]) for k in arity]


@pytest.mark.parametrize("slots", [[0, 1, 2, 16], [5, 6, 7, 8], [16, 16]])
def test_kv_cache_append_int8_matches_jax_and_is_in_place(slots):
    rng = np.random.RandomState(len(slots))
    kp, ks = _seeded_pool(rng)
    vp, vs = _seeded_pool(rng)
    slots = np.asarray(slots, np.int32)
    k = (rng.randn(len(slots), 2, 8) * 3).astype(np.float32)
    v = (rng.randn(len(slots), 2, 8) * 3).astype(np.float32)
    want = _jax_append(k, v, slots, kp, vp, ks, vs)
    mine = [torch.from_numpy(a.copy()) for a in (kp, vp, ks, vs)]
    ptrs = [t.data_ptr() for t in mine]
    assert tpo.kv_cache_append(torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(slots), *mine) is None
    assert [t.data_ptr() for t in mine] == ptrs
    for t, w in zip(mine, want):
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      w.view(np.uint8))


def test_kv_cache_append_bf16_matches_jax():
    rng = np.random.RandomState(5)
    kp = jnp.asarray(rng.randn(2, 4, 4, 8).astype(np.float32)).astype(
        jnp.bfloat16)
    slots = np.array([3, 16, 9, 12], np.int32)
    k = (rng.randn(4, 2, 8) * 5).astype(np.float32)
    want = _jax_append(k, k, slots, kp, kp)
    mine = torch.from_numpy(np.asarray(kp.astype(jnp.float32))).to(
        torch.bfloat16)
    other = mine.clone()
    tpo.kv_cache_append(torch.from_numpy(k), torch.from_numpy(k),
                        torch.from_numpy(slots), mine, other)
    np.testing.assert_array_equal(mine.float().numpy(),
                                  want[0].astype(np.float32))
    assert torch.equal(mine, other)


@pytest.mark.parametrize("with_scale", [True, False])
def test_kv_dequant_matches_jax_bit_for_bit(with_scale):
    rng = np.random.RandomState(9)
    x = rng.randint(-127, 128, (2, 3, 4, 8)).astype(np.int8)
    s = (np.abs(rng.randn(2, 3)) * 3).astype(np.float32)
    ins = {"X": [jnp.asarray(x)]}
    if with_scale:
        ins["Scale"] = [jnp.asarray(s)]
    want = np.asarray(eager_call("kv_dequant", ins, {},
                                 {"Out": 1})["Out"][0])
    got = tpo.kv_dequant(torch.from_numpy(x),
                         torch.from_numpy(s) if with_scale else None).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # bf16 pages: a plain cast
    xb = jnp.asarray(rng.randn(2, 3, 4, 8).astype(np.float32)).astype(
        jnp.bfloat16)
    wantb = np.asarray(eager_call("kv_dequant", {"X": [xb]}, {},
                                  {"Out": 1})["Out"][0])
    gotb = tpo.kv_dequant(torch.from_numpy(
        np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(gotb, wantb)


# ==========================================================================
# plain paged attention over quantized pools
# ==========================================================================
def _q_case(seed, dtype, hq=4, hkv=2, d=16, ps=8, n_pages=12,
            lens=(3, 16, 9, 0, 24)):
    """Pools in ``dtype`` (int8 with scales, one page never written),
    tables drawn without replacement, a context of 0 among the rows."""
    rng = np.random.RandomState(seed)
    need = [max(1, -(-n // ps)) for n in lens]
    width = max(need)
    perm = rng.permutation(n_pages)
    tables = np.zeros((len(lens), width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    q = rng.randn(len(lens), hq, d).astype(np.float32)
    if dtype == "int8":
        kp, vp = (rng.randint(-127, 128, (hkv, n_pages, ps, d))
                  .astype(np.int8) for _ in range(2))
        ks, vs = ((np.abs(rng.randn(hkv, n_pages)) + 0.1).astype(np.float32)
                  for _ in range(2))
        blank = tables[1, 0]
        for a in (kp, vp, ks, vs):
            a[:, blank] = 0
        return (q, kp, vp, tables, np.asarray(lens, np.int32)), (ks, vs)
    kp, vp = (np.asarray(jnp.asarray(rng.randn(hkv, n_pages, ps, d)
                                     .astype(np.float32))
                         .astype(jnp.bfloat16)) for _ in range(2))
    return (q, kp, vp, tables, np.asarray(lens, np.int32)), ()


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_plain_quantized_attention_matches_jax_reference(dtype, hq, hkv):
    arrays, scales = _q_case(1, dtype, hq, hkv)
    want = np.asarray(pk.paged_attention_reference(
        *(jnp.asarray(a) for a in arrays),
        **dict(zip(("k_scale", "v_scale"), map(jnp.asarray, scales)))))
    got = tpa.paged_attention(*(_torch(a) for a in arrays), None,
                              *(_torch(s) for s in scales)).numpy()
    np.testing.assert_allclose(got, want, **PLAIN_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_plain_quantized_attention_matches_pallas_kernel(monkeypatch, dtype):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    arrays, scales = _q_case(2, dtype, lens=(3, 16, 9, 24))
    ker = np.asarray(pk._paged_decode_call(
        *(jnp.asarray(a) for a in arrays), 16 ** -0.5,
        *(jnp.asarray(s) for s in scales)))
    got = tpa.paged_attention(*(_torch(a) for a in arrays), None,
                              *(_torch(s) for s in scales)).numpy()
    np.testing.assert_allclose(got, ker, **PLAIN_TOL)


def test_plain_int8_dequantizes_in_the_pallas_kernels_order():
    """``k * (s / 127)``, not JAX's reference's ``(k * s) / 127``: over
    every code and 4,000 scales the two orders differ on about a third
    of the pairs, by at most two f32 ulps (each rounds twice)."""
    codes = torch.arange(-127, 128, dtype=torch.float32)[:, None]
    s = torch.from_numpy(np.random.RandomState(0).uniform(
        0.01, 50, 4000).astype(np.float32))[None, :]
    kernel = codes * (s / 127.0)
    ref = codes * s / 127.0
    ulp = torch.nextafter(ref.abs(), torch.full_like(ref, np.inf)) - ref.abs()
    ulps = (kernel - ref).abs() / ulp
    assert 0.25 < float((ulps > 0).float().mean()) < 0.45
    assert float(ulps.max()) == 2.0
    # and the plain version is the kernel's order
    x = torch.randint(-127, 128, (1, 3, 2, 4), dtype=torch.int8)
    sc = torch.rand(1, 3) * 5
    want = x.float() * (sc / 127.0)[..., None, None]
    q = torch.randn(3, 1, 4)
    tables = torch.arange(3, dtype=torch.int32)[:, None]
    ctx = torch.full((3,), 2, dtype=torch.int32)
    got = tpa.paged_attention_reference(q, x, x, tables, ctx, 1.0, sc, sc)
    ref = tpa.paged_attention_reference(q, want, want, tables, ctx, 1.0)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


# ==========================================================================
# decode and chunk forms from one quantized state
# ==========================================================================
def _cores(dtype, num_pages=16, page_size=4):
    cfg = dict(SMALL)
    w = J.init_decoder_weights(J.DecoderConfig(**cfg), 0)
    jcore = J._EngineCore(J.DecoderConfig(**cfg), w, num_pages=num_pages,
                          page_size=page_size, prefill_bucket_min=8,
                          kv_dtype=dtype)
    tcore = T._EngineCore(T.DecoderConfig(**cfg), w, num_pages=num_pages,
                          page_size=page_size, prefill_bucket_min=8,
                          kv_dtype=dtype, device="cpu")
    return jcore, tcore


def _jax_logits(core, prog, feed, name=None):
    var = prog._srv_logits if name is None else next(
        n for n in prog.global_block().vars if n.startswith(name))
    return np.asarray(core.exe.run(prog, feed=feed, fetch_list=[var],
                                   scope=core.scope)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_form_from_copied_state_matches_jax(dtype):
    jcore, tcore = _cores(dtype)
    reqs = [J.Request(i, p, 4) for i, p in enumerate(
        [[5, 9, 2, 33, 7, 1], [4] * 13, [60, 61, 62]])]
    for r in reqs:
        assert jcore.prefill(r) == tcore.prefill(r)
    copy_jax_pools(jcore, tcore)
    pad = tcore.kv_config.pad_slot
    toks, pos, slot_map, ctx = (np.array([3, 8, 12, 0], np.int32),
                                np.zeros(4, np.int32),
                                np.full(4, pad, np.int32),
                                np.ones(4, np.int32))
    for i, r in enumerate(reqs):
        pos[i] = tcore.kv.context_len(r.req_id)
        slot_map[i] = tcore.kv.append_tokens(r.req_id, 1)[0]
        jcore.kv.append_tokens(r.req_id, 1)
        ctx[i] = tcore.kv.context_len(r.req_id)
    tables = np.stack([tcore.kv.block_table(r.req_id, 4) for r in reqs]
                      + [np.zeros(4, np.int32)])
    feed = {"tokens": toks, "positions": pos, "block_tables": tables,
            "context_lens": ctx, "slot_mapping": slot_map}
    want = _jax_logits(jcore, jcore.decode_prog, feed)
    got = tcore.model.decode(
        *(torch.from_numpy(feed[n]) for n in
          ("tokens", "positions", "block_tables", "context_lens",
           "slot_mapping")), tcore.kv_pools, tcore.kv_scales)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _pools_close(jcore, tcore)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_form_from_copied_state_matches_jax(dtype):
    """A 13-token prompt's first 8 tokens prefilled, then its last 5
    through the chunk form over the pool (pages 2, 0, 3 of 4 slots)."""
    jcore, tcore = _cores(dtype)
    prompt = [int(t) for t in np.random.RandomState(4).randint(0, 64, 13)]
    head = J.Request("a", prompt[:8], 1)
    assert jcore.prefill(head) == tcore.prefill(head)
    copy_jax_pools(jcore, tcore)
    slots = []
    for core in (jcore, tcore):
        slots.append(core.kv.append_tokens("a", 5))
    np.testing.assert_array_equal(*slots)
    S, W = 8, 4
    toks = np.zeros((1, S), np.int32)
    toks[0, :5] = prompt[8:]
    posf = (8 + np.arange(S, dtype=np.int32))[None]
    slot_map = np.full(S, tcore.kv_config.pad_slot, np.int32)
    slot_map[:5] = slots[1]
    tables = tcore.kv.block_table("a", W)
    cols = np.arange(W * 4)[None, :]
    rows = np.arange(S)[:, None]
    mask = np.where(cols <= 8 + rows, 0.0, T.NEG_INF).astype(
        np.float32)[None, None]
    feed = {"tokens": toks, "positions": posf, "attn_mask": mask,
            "last_index": np.array([4], np.int32),
            "slot_mapping": slot_map, "chunk_tables": tables}
    prog = jcore.chunk_prog_parts[0]
    want = _jax_logits(jcore, prog, feed, name="_srv_logits_")
    got = tcore.model.chunk(
        *(torch.from_numpy(feed[n]) for n in
          ("tokens", "positions", "attn_mask", "last_index",
           "slot_mapping", "chunk_tables")), tcore.kv_pools,
        tcore.kv_scales)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    _pools_close(jcore, tcore)


# ==========================================================================
# engines: event streams, pools after the run
# ==========================================================================
@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_event_stream_matches_jax(dtype, chunk, trace):
    jeng, teng = _engines(kv_dtype=dtype, prefill_chunk=chunk)
    prompts = TRACES[trace]()
    want = _stream(jeng, J.Request, prompts, 6)
    got = _stream(teng, T.Request, prompts, 6)
    assert got == want
    assert teng.stats == {k: jeng.stats[k] for k in teng.stats}
    if chunk:
        assert teng.stats["prefill_chunks"] > len(prompts)
    share = _pools_close(jeng.core, teng.core)
    print(f"{dtype} chunk {chunk} {trace}: int8 codes one step off "
          f"{share:.4%}")


def test_tight_pool_int8_preempts_like_jax():
    jeng, teng = _engines(kv_dtype="int8", num_pages=6, page_size=4)
    prompts = _prompts_seed7()
    want = _stream(jeng, J.Request, prompts, 5)
    got = _stream(teng, T.Request, prompts, 5)
    assert got == want and teng.stats["preempted"] >= 1


# ==========================================================================
# capacity, memory stats, flags
# ==========================================================================
def test_budget_buys_exactly_2x_and_4x_pages():
    n = {}
    for dt in DTYPES:
        jeng, teng = _engines(kv_dtype=dt, kv_budget_mb=1.0)
        n[dt] = teng.core.kv_config.num_pages
        assert n[dt] == jeng.core.kv_config.num_pages
        assert teng.core.kv_pool_resident_bytes() == \
            jeng.core.kv_pool_resident_bytes()
    assert n["bfloat16"] == 2 * n["float32"]
    assert n["int8"] == 4 * n["float32"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_memory_stats_and_pool_bytes_match_jax(dtype):
    jcore, tcore = _cores(dtype)
    for core in (jcore, tcore):
        core.prefill(J.Request("a", list(range(9)), 2))
    want, got = jcore.memory_stats(), tcore.memory_stats()
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "measured":
            assert got[key] == want[key], key
    assert sorted(got["measured"]) == sorted(want["measured"])
    assert got["measured"]["source"] == "unavailable"
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    base = 4 * 4 * 16 * 4 * 8 * itemsize
    scale = 4 * 4 * 16 * 4 if dtype == "int8" else 0
    assert tcore.kv_pool_resident_bytes() == base + scale
    assert got["kv_pool_scale_bytes"] == scale
    # the tensors the port allocated are exactly the bytes it reports
    held = sum(t.numel() * t.element_size() for pair in tcore.kv_pools
               for t in pair)
    held += sum(t.numel() * t.element_size()
                for pair in (tcore.kv_scales or ()) for t in pair)
    assert held == tcore.kv_pool_resident_bytes()
    assert tcore.kv.stats() == jcore.kv.stats()


def test_flag_routes_and_bad_dtype_raises():
    jflags.set_flags({"kv_cache_dtype": "int8"})
    tflags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
    jeng, teng = _engines()
    assert teng.kv_dtype == jeng.kv_dtype == "int8"
    assert teng.kv.stats()["dtype"] == "int8"
    assert teng.core.kv_pools[0][0].dtype == torch.int8
    for make in (lambda: J.ServingEngine(J.DecoderConfig(**SMALL),
                                         kv_dtype="fp4"),
                 lambda: T.ServingEngine(T.DecoderConfig(**SMALL),
                                         device="cpu", kv_dtype="fp4")):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            make()


def test_default_is_float32_and_config_matches_jax():
    _, teng = _engines()
    assert teng.kv_dtype == "float32" and teng.core.kv_scales is None
    from paddle_tpu.inference.kv_cache import KVCacheConfig as JCfg
    for dt in DTYPES:
        kw = dict(num_pages=7, page_size=4, num_kv_heads=3, head_dim=8,
                  dtype=dt)
        a, b = KVCacheConfig(**kw), JCfg(**kw)
        assert (a.quantized, a.pool_shape(), a.scale_shape(),
                a.scale_bytes(), a.pad_slot) == \
            (b.quantized, b.pool_shape(), b.scale_shape(), b.scale_bytes(),
             b.pad_slot)
        assert a.itemsize == np.dtype(b.make_pool().dtype).itemsize


# ==========================================================================
# within a dtype: prefix hit == cold, chunked == monolithic
# ==========================================================================
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_within_dtype_identity_oracles(dtype):
    _, mono = _engines(kv_dtype=dtype)
    prompts = _prompts_seed7()
    want = mono.generate(prompts, max_new_tokens=6)
    _, chunked = _engines(kv_dtype=dtype, prefill_chunk=4)
    assert chunked.generate(prompts, max_new_tokens=6) == want
    shared = [list(range(1, 17)) + [20, 21], list(range(1, 17)) + [30, 31]]
    _, cold = _engines(kv_dtype=dtype)
    _, warm = _engines(kv_dtype=dtype, prefix_cache=True)
    assert warm.generate(shared, 5) == cold.generate(shared, 5)
    assert warm.stats["prefill_hit_tokens"] > 0


def test_fork_copies_int8_pages_and_scales_verbatim():
    _, tcore = _cores("int8")
    tcore.kv.prefix_cache = True
    rng = np.random.RandomState(3)
    for pair in tcore.kv_pools + tcore.kv_scales:
        for t in pair:
            t.copy_(torch.from_numpy(
                rng.randint(-127, 128, t.shape).astype(np.int8)
                if t.dtype == torch.int8 else
                np.abs(rng.randn(*t.shape)).astype(np.float32)))
    before = [[t.clone() for t in pair]
              for pair in tcore.kv_pools + tcore.kv_scales]
    tcore.kv._pending_forks.append((1, 5, 2))
    tcore._apply_forks()
    for pair, old in zip(tcore.kv_pools + tcore.kv_scales, before):
        for t, o in zip(pair, old):
            assert torch.equal(t[:, 5], o[:, 1])
            keep = [p for p in range(t.shape[1]) if p != 5]
            assert torch.equal(t[:, keep], o[:, keep])
