"""PyTorch port, the bf16 / fp16 gelu's oracles on the CPU, exhaustively.

* The plain versions (``paddle_tpu_torch/ops/gelu.py``), which the
  kernels of ``csrc/gelu_lowp.cu`` equal bit for bit on the card, against
  ``jax.jit(jax.nn.gelu(x, approximate=False))`` and its ``jax.vjp`` on
  every finite 16-bit input: 65,280 bf16 and 63,488 fp16 values, each
  with one seeded ``dy`` in the backward.  Bit for bit; a NaN only where
  JAX has one.
* The kernels' tables by the plain ops (``gelu_table_reference``): the
  index clamped into the bands (``GELU_BANDS``) gives every input's own
  ``e`` and ``ee`` (a NaN input excepted, whose output is NaN whatever
  they are), and the kernels' ops on them give the plain forward and
  backward bit for bit on every input.
* Kernel 9's tensor-core variant rule (``tc_variant``) at the shapes the
  main paths run.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import gelu as tgelu
from paddle_tpu_torch.ops import matmul_epilogue as tme

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
PLAIN = {"bf16": (tgelu.gelu_bf16_reference, tgelu.gelu_bf16_grad_reference),
         "fp16": (tgelu.gelu_fp16_reference, tgelu.gelu_fp16_grad_reference)}
N_FINITE = {"bf16": 65280, "fp16": 63488}


def _every_input(tag):
    """Every 16-bit pattern of the dtype, as a torch tensor."""
    return torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        DTYPES[tag][0])


def _finite(tag):
    x = _every_input(tag)
    x = x[torch.isfinite(x.float())]
    assert x.numel() == N_FINITE[tag]
    return x


def _jax_gelu():
    def f(x):
        return jax.nn.gelu(x, approximate=False)
    return jax.jit(f), jax.jit(lambda x, dy: jax.vjp(f, x)[1](dy)[0])


def _to_jax(t, tag):
    return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16).view(
        DTYPES[tag][1]))


def _same_bits(got, want_jax):
    """Bit for bit, NaN where JAX has NaN (the NaN's own bits aside)."""
    got = got.view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(want_jax).view(np.uint16)
    gnan = np.isnan(np.asarray(got.view(want_jax.dtype), np.float32))
    wnan = np.isnan(np.asarray(want_jax, np.float32))
    np.testing.assert_array_equal(gnan, wnan)
    np.testing.assert_array_equal(got[~wnan], want[~wnan])


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_plain_gelu_forward_matches_jax_on_every_finite_input(tag):
    x = _finite(tag)
    fwd, _ = _jax_gelu()
    _same_bits(PLAIN[tag][0](x), fwd(_to_jax(x, tag)))


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_plain_gelu_backward_matches_jax_on_every_finite_input(tag):
    x = _finite(tag)
    dy = torch.tensor(np.random.RandomState(12).randn(x.numel()),
                      dtype=torch.float32).to(DTYPES[tag][0])
    _, vjp = _jax_gelu()
    _same_bits(PLAIN[tag][1](x, dy), vjp(_to_jax(x, tag), _to_jax(dy, tag)))


def _table_terms(tag):
    """Every input's e and ee (as f32) as the kernels get them: from the
    tables at |x| clamped into GELU_BANDS, fp16's e below its band from
    the small branch of erfc (XLA's, for |u| < 1)."""
    dt = DTYPES[tag][0]
    (lo_e, hi_e), (lo_ee, hi_ee) = tgelu.GELU_BANDS[dt]
    tab = tgelu.gelu_table_reference(dt).to(torch.int32) & 0xFFFF
    bits = torch.arange(65536, dtype=torch.int64)
    sign, mag = bits >> 15, bits & 0x7FFF
    i = sign * (hi_e - lo_e) + mag.clamp(lo_e, hi_e - 1) - lo_e
    if dt == torch.bfloat16:       # e and ee paired, one band
        e, ee = tab[2 * i], tab[2 * i + 1]
    else:
        e = tab[i]
        ee = tab[tgelu._ee_offset(hi_e - lo_e) + mag.clamp(lo_ee, hi_ee - 1)
                 - lo_ee]
    e, ee = (t.to(torch.int16).view(dt).float() for t in (e, ee))
    if dt == torch.float16:
        u = tgelu._rh(_every_input(tag).float() * -0.70703125)
        small = u.abs() < 1
        e = torch.where(small, tgelu._rh(tgelu.erfc_xla(u)), e)
    return e, ee


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_table_terms_give_the_forward_on_every_input(tag):
    """The forward kernel's ops, rb(rb(0.5 x) * e) with e as the kernels
    get it, give the plain forward bit for bit on every input, and so
    JAX's on every finite one."""
    dt = DTYPES[tag][0]
    x = _every_input(tag)
    e, _ = _table_terms(tag)
    if dt == torch.bfloat16:
        got = tgelu._ftz(tgelu._rb(0.5 * tgelu._ftz(x.float())) * e).to(dt)
    else:
        got = (tgelu._rh(0.5 * x.float()) * e).to(dt)
    want = PLAIN[tag][0](x)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])
    finite = torch.isfinite(x.float())
    fwd, _ = _jax_gelu()
    _same_bits(got[finite], fwd(_to_jax(x[finite], tag)))


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_bands_hold_on_every_input(tag):
    """The kernels read e and ee at |x| clamped into GELU_BANDS (fp16's e
    below its band from erfc's small branch): for every input but NaN
    that is its own e and ee by the plain ops, so the bands lose nothing;
    and each band is tight (an edge entry differs from its inner
    neighbour)."""
    dt = DTYPES[tag][0]
    x = _every_input(tag)
    want_e, want_ee = (t.float() for t in tgelu.gelu_xterms_reference(x))
    got_e, got_ee = _table_terms(tag)
    ok = ~torch.isnan(x.float())
    assert torch.equal(got_e[ok], want_e[ok])
    assert torch.equal(got_ee[ok], want_ee[ok])
    (lo_e, hi_e), (lo_ee, hi_ee) = tgelu.GELU_BANDS[dt]
    mags = torch.tensor([lo_e, lo_e + 1, hi_e - 2, hi_e - 1, lo_ee,
                         lo_ee + 1, hi_ee - 2, hi_ee - 1], dtype=torch.int32)
    xs = torch.cat([mags, mags | 0x8000]).to(torch.int16).view(dt)
    e, ee = (t.view(torch.int16) for t in tgelu.gelu_xterms_reference(xs))
    # an edge is tight when a term it holds changes there, in either sign
    edge = (lambda t, a, b: bool((t[[a, a + 8]] != t[[b, b + 8]]).any()))
    if dt == torch.bfloat16:       # one band for both terms
        assert edge(e, 0, 1) or edge(ee, 0, 1)
        assert edge(e, 3, 2) or edge(ee, 3, 2)
    else:                          # e's band starts at |u| = 1
        assert edge(e, 3, 2) and edge(ee, 4, 5) and edge(ee, 7, 6)


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_table_terms_feed_the_plain_backward(tag):
    """The backward's dy-dependent ops (spelled out as the kernel runs
    them, in f32 with the plain roundings) on the tables' e and ee give
    the plain backward bit for bit, for every input and one seeded dy."""
    dt = DTYPES[tag][0]
    x = _every_input(tag)
    e, ee = _table_terms(tag)
    dy = torch.tensor(np.random.RandomState(13).randn(65536),
                      dtype=torch.float32).to(dt)
    if dt == torch.bfloat16:
        r, d = tgelu._rb, tgelu._ftz(dy.float())
        r3 = r(r(r(0.5 * tgelu._ftz(x.float())) * d) * -1.125)
        t1 = r(r(r3 * ee) * -0.70703125)
        t2 = r(r(d * e) * 0.5)
        got = tgelu._ftz(t1 + t2).to(dt)
    else:
        r, d = tgelu._rh, dy.float()
        m3 = r(r(r(r(x.float() * 0.5) * d) * -1.1279296875) * ee)
        t2 = r(r(d * e) * 0.5)
        got = (t2 - m3 * 0.70703125).to(dt)
    want = PLAIN[tag][1](x, dy)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])


def _f32(v: Fraction) -> Fraction:
    """v rounded to the nearest float32 (ties to even), exactly."""
    lo = np.float32(float(v))
    if Fraction(float(lo)) > v:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    below, above = v - Fraction(float(lo)), Fraction(float(hi)) - v
    if below != above:
        return Fraction(float(lo if below < above else hi))
    return Fraction(float(lo if int(lo.view(np.uint32)) % 2 == 0 else hi))


def test_fp16_small_erfc_by_fma_rounds_as_xla_on_every_input():
    """The fp16 kernels evaluate erfc's small branch (|u| < 1) with each
    Horner step one fma (a single rounding of the exact a * b + c); on
    every fp16 u with |u| < 1 that rounds to the same fp16 as XLA's
    unfused f32 steps (the plain version's)."""
    coef = [Fraction(float(np.float32(c))) for c in (
        7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
        0.112835854, -0.37612626, 1.12837911)]
    mags = np.arange(0x3C00, dtype=np.uint16).view(np.float16)
    us = np.concatenate([mags, -mags]).astype(np.float32)
    small = tgelu._rh(tgelu.erfc_xla(torch.from_numpy(us))).numpy()
    got = np.empty_like(small)
    for j, u32 in enumerate(us):
        u = Fraction(float(u32))
        z = _f32(u * u)
        p = _f32(z * coef[0] + coef[1])
        for c in coef[2:]:
            p = _f32(p * z + c)
        got[j] = np.float16(float(_f32(1 - u * p)))
    assert us.size == 2 * 0x3C00
    np.testing.assert_array_equal(got.astype(np.float16).view(np.uint16),
                                  small.astype(np.float16).view(np.uint16))


@pytest.mark.parametrize("m,k,n,x_aligned,want", [
    (256, 400, 120, True, "tma 64x64"),        # LeNet fc1
    (256, 120, 84, True, "cp.async 64x64"),    # LeNet fc2: N % 8 != 0
    (256, 128, 256, True, "tma 64x64"),        # word2vec
    (1001, 517, 263, True, "cp.async 64x64"),  # ragged
    (22528, 768, 3072, True, "tma 128x128"),   # BERT-base FFN-in
    (22528, 768, 3072, False, "cp.async 64x64"),   # a misaligned view
    (2048, 64, 1024, True, "tma 64x64"),       # 128 large tiles < 132 SMs
    (2048, 64, 1056, True, "tma 128x128"),     # 144 large tiles
], ids=["lenet-fc1", "lenet-fc2", "word2vec", "ragged", "ffn-in",
        "misaligned", "below-a-wave", "a-wave"])
def test_matmul_tc_variant_rule(m, k, n, x_aligned, want):
    assert tme.tc_variant(m, n, k, x_aligned, True) == want
    assert want in tme.TC_VARIANTS
