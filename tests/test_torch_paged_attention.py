"""PyTorch port, paged-KV ops: ``paddle_tpu_torch.ops`` against the JAX
package on the same numpy inputs.

* the port's plain paged attention == ``pallas_kernels.
  paged_attention_reference`` and == the Pallas kernel run in interpret
  mode (atol/rtol 1e-5: the same f32 sums, another order);
* ``kv_cache_append`` == the JAX op through ``eager_call``, exactly,
  pad sentinel included, and it writes the pools in place;
* dispatch: a CPU tensor takes the plain version and never counts a
  kernel launch; the kernel's wrapper refuses anything but CUDA tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.registry import eager_call
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.paged_ops import kv_cache_append

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b, hq, hkv, d, ps, n_pages, lens, width=None):
    """Random q/pools, per-sequence page tables drawn without replacement
    (pages of one sequence are not contiguous), padded with page 0."""
    rng = np.random.RandomState(seed)
    need = [-(-n // ps) for n in lens]
    width = width or max(need)
    perm = rng.permutation(n_pages)
    tables = np.zeros((b, width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    q = rng.randn(b, hq, d).astype(np.float32)
    kp = rng.randn(hkv, n_pages, ps, d).astype(np.float32)
    vp = rng.randn(hkv, n_pages, ps, d).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _port(*arrays, **kw):
    return tpa.paged_attention(*(torch.from_numpy(a) for a in arrays),
                               **kw).numpy()


def _jax_ref(*arrays, **kw):
    return np.asarray(pk.paged_attention_reference(
        *(jnp.asarray(a) for a in arrays), **kw))


# ragged lengths: one token, a page boundary (16), a tail page, full width
LENS = [1, 16, 13, 29, 32]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_matches_jax_reference(hq, hkv):
    arrays = _case(0, 5, hq, hkv, 8, 8, 24, LENS)
    np.testing.assert_allclose(_port(*arrays), _jax_ref(*arrays), **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_matches_pallas_kernel_interpret(monkeypatch, hq, hkv):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    d = 16
    arrays = _case(1, 5, hq, hkv, d, 8, 24, LENS)
    ker = np.asarray(pk._paged_decode_call(
        *(jnp.asarray(a) for a in arrays), d ** -0.5))
    np.testing.assert_allclose(_port(*arrays), ker, **TOL)


@pytest.mark.parametrize("lens", [[8, 16, 24], [7, 9, 1]])
def test_page_boundaries_and_wide_tables(lens):
    # a table wider than any sequence needs (the bucketed width): the
    # padded entries point at page 0 and must stay masked
    arrays = _case(2, 3, 4, 2, 8, 8, 16, lens, width=4)
    np.testing.assert_allclose(_port(*arrays), _jax_ref(*arrays), **TOL)


def test_bucket_padding_rows_are_harmless():
    """Decode pads the batch to a power of two with rows of context 1
    and a table of page 0: they compute a finite value and leave the
    real rows exactly as without them."""
    q, kp, vp, tables, lens = _case(3, 3, 4, 4, 8, 8, 12, [5, 17, 9])
    pad_q = np.concatenate([q, np.ones((1, 4, 8), np.float32)])
    pad_tables = np.concatenate([tables, np.zeros((1, 3), np.int32)])
    pad_lens = np.concatenate([lens, [1]]).astype(np.int32)
    padded = _port(pad_q, kp, vp, pad_tables, pad_lens)
    assert np.isfinite(padded).all()
    np.testing.assert_array_equal(padded[:3],
                                  _port(q, kp, vp, tables, lens))
    np.testing.assert_allclose(
        padded, _jax_ref(pad_q, kp, vp, pad_tables, pad_lens), **TOL)


def test_scale_default_and_explicit():
    arrays = _case(4, 2, 4, 2, 8, 8, 8, [3, 11])
    np.testing.assert_allclose(_port(*arrays), _port(*arrays,
                                                     scale=8 ** -0.5),
                               atol=0, rtol=0)
    np.testing.assert_allclose(_port(*arrays, scale=0.3),
                               _jax_ref(*arrays, scale=0.3), **TOL)


def test_mask_value_matches_jax():
    assert tpa.DEFAULT_MASK_VALUE == pk.DEFAULT_MASK_VALUE


@pytest.mark.parametrize("hq,hkv,ok", [(4, 4, True), (4, 2, True),
                                       (6, 4, False), (4, 0, False)])
def test_gqa_group_validation(hq, hkv, ok):
    if ok:
        assert tpa.gqa_group(hq, hkv) == pk._gqa_group(hq, hkv)
    else:
        with pytest.raises(ValueError, match="GQA"):
            tpa.gqa_group(hq, hkv)


def test_cpu_dispatch_takes_plain_version_without_launch():
    arrays = [torch.from_numpy(a) for a in _case(5, 2, 4, 2, 8, 8, 8,
                                                 [3, 11])]
    before = tpa.PAGED_DECODE.launches
    out = tpa.paged_attention(*arrays)
    assert tpa.PAGED_DECODE.launches == before
    assert out.dtype == torch.float32 and out.shape == (2, 4, 8)
    torch.testing.assert_close(out, tpa.paged_attention_reference(*arrays),
                               atol=0, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _case(6, 2, 4, 2, 32, 8, 8,
                                                 [3, 11])]
    before = tpa.PAGED_DECODE.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode(*arrays, 32 ** -0.5)
    assert tpa.PAGED_DECODE.launches == before


def _jax_append(k, v, slots, kp, vp):
    outs = eager_call(
        "kv_cache_append",
        {"K": [jnp.asarray(k)], "V": [jnp.asarray(v)],
         "SlotMapping": [jnp.asarray(slots)],
         "KCache": [jnp.asarray(kp)], "VCache": [jnp.asarray(vp)]},
        {}, {"KCacheOut": 1, "VCacheOut": 1})
    return np.asarray(outs["KCacheOut"][0]), np.asarray(outs["VCacheOut"][0])


@pytest.mark.parametrize("slots", [
    [5, 0, 16],            # last = the pad sentinel (num_pages * page_size)
    [16, 16, 16],          # a fully padded bucket writes nothing
    [15, 3, 8, 12],        # page ends and starts
])
def test_kv_cache_append_matches_jax_exactly(slots):
    rng = np.random.RandomState(7)
    hkv, p, ps, d = 2, 4, 4, 8
    kp = rng.randn(hkv, p, ps, d).astype(np.float32)
    vp = rng.randn(hkv, p, ps, d).astype(np.float32)
    slots = np.asarray(slots, np.int32)
    k = rng.randn(len(slots), hkv, d).astype(np.float32)
    v = rng.randn(len(slots), hkv, d).astype(np.float32)
    want_k, want_v = _jax_append(k, v, slots, kp, vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    k_ptr, v_ptr = tk.data_ptr(), tv.data_ptr()
    assert kv_cache_append(torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(slots), tk, tv) is None
    assert (tk.data_ptr(), tv.data_ptr()) == (k_ptr, v_ptr)   # in place
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [40, 96, 120])
def test_head_dims_match_pallas_kernel_interpret(monkeypatch, d, pool):
    """JAX's kernel engages for any head dim that is a multiple of 8
    (``pallas_kernels.py:1257``); the port's kernels take the same ones,
    at the next instantiated width.  Their oracle, the plain version,
    against the Pallas kernel in interpret mode, for every pool dtype
    (int8 with its per-page scales)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    q, kp, vp, tables, lens = _case(3, 3, 4, 2, d, 8, 12, [1, 13, 29])
    scales = {}
    if pool == "bfloat16":
        kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (kp, vp))
    elif pool == "int8":
        rng = np.random.RandomState(d)
        kp, vp = (rng.randint(-127, 128, a.shape).astype(np.int8)
                  for a in (kp, vp))
        scales = {n: rng.uniform(0.5, 2.0, (2, 12)).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
    ker = np.asarray(pk._paged_decode_call(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)), d ** -0.5,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    if pool == "bfloat16":
        kp, vp = (torch.from_numpy(a.view(np.int16).copy())
                  .view(torch.bfloat16) for a in (kp, vp))
    else:
        kp, vp = torch.from_numpy(kp), torch.from_numpy(vp)
    got = tpa.paged_attention(
        torch.from_numpy(q), kp, vp, torch.from_numpy(tables),
        torch.from_numpy(lens),
        **{n: torch.from_numpy(a) for n, a in scales.items()}).numpy()
    np.testing.assert_allclose(got, ker, **TOL)


# ==========================================================================
# the kernel's split walk: the planner, and a plain model of the
# split-and-merge held to the plain version and to JAX's kernel
# ==========================================================================
@pytest.mark.parametrize("shape,want", [
    # serving (GPT-2 small heads, 8 rows, page 16, a 64-page table)
    ((8, 12, 64, 16), (8, 8)),
    # GQA (8 kv heads)
    ((8, 8, 64, 16), (8, 8)),
    # the engine's decode at batch 8 (profile_decode): the bucketed width
    # of 512-token contexts, and of one 17-token context
    ((8, 12, 32, 16), (4, 8)),
    ((8, 12, 2, 16), (1, 2)),
    # a small engine: page 8 takes 16-page spans (128 tokens)
    ((4, 2, 32, 8), (2, 16)),
    # a wide batch: spans double until the grid is at most 12 CTAs an SM
    ((32, 12, 64, 16), (4, 16)),
    ((64, 12, 64, 16), (2, 32)),
    ((256, 12, 64, 16), (1, 64)),
])
def test_decode_splits_plan(shape, want):
    assert tpa.decode_splits(*shape) == want
    n_seqs, n_kv, width, ps = shape
    n_splits, span = want
    assert (n_splits - 1) * span < width <= n_splits * span


def _largest_smem_bytes(span):
    """The kernel's shared memory at its largest instance (int8 pages:
    the span's page ids and two scale rows; GQA group bound 8, width 256):
    q, the 4 warps' m and l, their acc, the span's words, the ticket's
    word (``Layout::words`` in csrc/paged_attention.cu)."""
    maxg, d, warps = 8, 256, 4
    return 4 * (maxg * d + 2 * warps * maxg + warps * maxg * d + 3 * span
                + 1)


@pytest.mark.parametrize("shape,want", [
    # one sequence over 16,384 one-token pages: 128-page spans
    ((1, 1, 16384, 1), (128, 128)),
    ((2, 2, 16384, 1), (128, 128)),
    # a wide batch over a million-page table: the span stops at its cap
    # of 8,192 pages, and the width takes more splits
    ((64, 12, 1 << 20, 16), (128, 8192)),
    ((8, 8, 100_000, 16), (13, 8192)),
    # the widest table the grid takes
    ((1, 1, 65535 * 8192, 1), (65535, 8192)),
])
def test_decode_splits_any_width(shape, want):
    """Tables wider than 8,192 pages: the plan covers the table, the span
    stays within its cap, so that the largest instance's shared memory
    fits the H100's 227 KB, and the grid within 65,535 splits."""
    assert tpa.decode_splits(*shape) == want
    width = shape[2]
    n_splits, span = want
    assert (n_splits - 1) * span < width <= n_splits * span
    assert span <= tpa._MAX_SPAN and n_splits <= 65535
    assert _largest_smem_bytes(tpa._MAX_SPAN) <= 232448
    with pytest.raises(ValueError, match="spans"):
        tpa.decode_splits(1, 1, 65535 * 8192 + 1, 1)


@pytest.mark.parametrize("shape,group,d,want", [
    ((8, 12, 64, 16), 1, 64, 8 * 12 * 8 * 66),       # serving: 202,752 B
    ((8, 8, 64, 16), 4, 128, 8 * 8 * 8 * 4 * 130),   # GQA: 532,480 B
    ((256, 12, 64, 16), 1, 64, 0),                   # one split: none
])
def test_decode_scratch_sizes(shape, group, d, want):
    n_splits, _ = tpa.decode_splits(*shape)
    assert tpa.decode_scratch_numel(shape[0], shape[1], group, d,
                                    n_splits) == want


def test_split_plan_reads_shapes_only():
    """The plan takes the table's shape, never the context lengths (which
    live on the card): it runs on tensors that hold no data."""
    import inspect
    assert list(inspect.signature(tpa.decode_splits).parameters) == [
        "n_seqs", "n_kv_heads", "width", "page_size"]
    meta = dict(device="meta")
    q = torch.empty(8, 12, 64, **meta)
    kp = torch.empty(12, 1024, 16, 64, dtype=torch.bfloat16, **meta)
    tables = torch.empty(8, 64, dtype=torch.int32, **meta)
    assert tpa.split_plan(q, kp, tables) == (8, 8)


def test_tickets_are_made_outside_a_capture(monkeypatch):
    """A stream's ticket buffer is made zeroed, grows, and is never made
    while a CUDA graph is being captured."""
    dev = torch.device("cpu")
    tpa._TICKETS.pop((None, 12345), None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        tpa._tickets(dev, 12345, 8)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    t = tpa._tickets(dev, 12345, 8)
    assert t.dtype == torch.int32 and t.numel() >= 8 and not t.any()
    assert tpa._tickets(dev, 12345, 8) is t
    big = tpa._tickets(dev, 12345, t.numel() + 1)
    assert big.numel() > t.numel() and not big.any()
    tpa._TICKETS.pop((None, 12345), None)


def _split_merge(q, kp, vp, tables, lens, scale, k_scale=None,
                 v_scale=None):
    """A plain model of the quantized kernels' walk: per (sequence, kv
    head), the softmax state (m, l, acc) of each live span of the
    planner's pages, merged in split order."""
    n_splits, span = tpa.split_plan(q, kp, tables)
    n_seqs, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    g = hq // hkv
    width = tables.shape[1]
    out = torch.zeros_like(q)
    for b in range(n_seqs):
        n = min(int(lens[b]), width * ps)
        n_live = max(1, -(-n // (span * ps)))
        assert n_live <= n_splits
        states = []
        for s in range(n_live):
            t0, t1 = s * span * ps, min(n, (s + 1) * span * ps)
            if t1 <= t0:
                continue
            pages = tables[b, t0 // ps:-(-t1 // ps)].long()
            k = kp.index_select(1, pages).float()
            v = vp.index_select(1, pages).float()
            if k_scale is not None:
                k = k * (k_scale.index_select(1, pages) / 127.0)[..., None,
                                                                 None]
                v = v * (v_scale.index_select(1, pages) / 127.0)[..., None,
                                                                 None]
            k = k.reshape(hkv, -1, d)[:, :t1 - t0].repeat_interleave(g, 0)
            v = v.reshape(hkv, -1, d)[:, :t1 - t0].repeat_interleave(g, 0)
            sc = torch.einsum("hd,htd->ht", q[b].float(), k) * scale
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            states.append((m, p.sum(-1), torch.einsum("ht,htd->hd", p, v)))
        if not states:
            continue   # context 0: zeros
        m_all = torch.stack([st[0] for st in states]).max(0).values
        l_all = torch.zeros_like(m_all)
        acc = torch.zeros(hq, d)
        for m, l, a in states:
            c = torch.exp(m - m_all)
            l_all = l_all + c * l
            acc = acc + c[:, None] * a
        out[b] = acc / l_all[:, None]
    return out


def _pools(pool, kp, vp, rng, hkv, n_pages):
    if pool == "bfloat16":
        return (torch.from_numpy(kp).bfloat16(),
                torch.from_numpy(vp).bfloat16(), {})
    if pool == "int8":
        codes = [torch.from_numpy(rng.randint(-127, 128, kp.shape)
                                  .astype(np.int8)) for _ in range(2)]
        scales = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (hkv, n_pages))
                                      .astype(np.float32))
                  for n in ("k_scale", "v_scale")}
        return codes[0], codes[1], scales
    return torch.from_numpy(kp), torch.from_numpy(vp), {}


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (6, 2), (8, 2), (8, 1)])
def test_split_merge_model_matches_plain(pool, hq, hkv):
    """Contexts of 1, span - 1, span, span + 1 and the whole table (page
    16, 32-page tables: 4 spans of 128 tokens), groups 1-8: only the order
    of the sums differs from the plain version."""
    d, ps, n_pages = 16, 16, 96
    lens = [1, 127, 128, 129, 512]
    q, kp, vp, tables, lens = _case(11, 5, hq, hkv, d, ps, n_pages, lens,
                                    width=32)
    rng = np.random.RandomState(hq + hkv)
    k, v, scales = _pools(pool, kp, vp, rng, hkv, n_pages)
    args = (torch.from_numpy(q), k, v, torch.from_numpy(tables),
            torch.from_numpy(lens))
    assert tpa.split_plan(args[0], k, args[3]) == (4, 8)
    got = _split_merge(*args, d ** -0.5, *scales.values())
    want = tpa.paged_attention_reference(*args, d ** -0.5, **scales)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_split_merge_model_at_a_wide_table_matches_plain(pool):
    """A table of 16,384 one-token pages (wider than 8,192), contexts of
    9,000 and 3 tokens: 128 spans of 128 pages, 71 of them live."""
    d, ps, n_pages, hkv = 8, 1, 16384, 2
    q, kp, vp, tables, lens = _case(13, 2, 4, hkv, d, ps, n_pages,
                                    [9000, 3], width=16384)
    rng = np.random.RandomState(13)
    k, v, scales = _pools(pool, kp, vp, rng, hkv, n_pages)
    args = (torch.from_numpy(q), k, v, torch.from_numpy(tables),
            torch.from_numpy(lens))
    assert tpa.split_plan(args[0], k, args[3]) == (128, 128)
    got = _split_merge(*args, d ** -0.5, *scales.values())
    want = tpa.paged_attention_reference(*args, d ** -0.5, **scales)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pool", ["int8", "float32"])
def test_split_merge_model_matches_pallas_kernel_interpret(monkeypatch,
                                                           pool):
    """The model against JAX's kernel, int8 and f32 pages, in interpret
    mode (2 spans of 128 tokens)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    d, ps, n_pages, hkv = 16, 16, 48, 2
    q, kp, vp, tables, lens = _case(12, 3, 4, hkv, d, ps, n_pages,
                                    [129, 1, 256], width=16)
    rng = np.random.RandomState(12)
    k, v, scales = _pools(pool, kp, vp, rng, hkv, n_pages)
    assert tpa.split_plan(torch.from_numpy(q), k,
                          torch.from_numpy(tables)) == (2, 8)
    ker = np.asarray(pk._paged_decode_call(
        *(jnp.asarray(a) for a in (q, k.numpy(), v.numpy(), tables, lens)),
        d ** -0.5, **{n: jnp.asarray(a.numpy()) for n, a in scales.items()}))
    got = _split_merge(torch.from_numpy(q), k, v, torch.from_numpy(tables),
                       torch.from_numpy(lens), d ** -0.5, *scales.values())
    np.testing.assert_allclose(got.numpy(), ker, **TOL)
