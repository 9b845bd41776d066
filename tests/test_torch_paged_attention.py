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
