"""PyTorch port, flash attention: ``paddle_tpu_torch.ops.flash_attention``
and ``fused_ops`` on the CPU against the JAX package on the same numpy
inputs.

* the port's flash front (its plain forward and plain backward from
  lse) == JAX ``flash_attention`` running the Pallas kernels in interpret
  mode, out and q/k/v gradients, causal x bias, single block (s=128) and
  multi-block (s=256 with ``PT_FLASH_BLOCK=128``); the padding bias gets
  a zero gradient on both sides;
* ``fused_multihead_attention`` == JAX ``_mha_forward`` for a padding
  bias, no bias and a full-matrix bias (which is differentiated);
* dropout on the CPU: the plain version with an explicit keep mask ==
  a hand-written masked composition, bit for bit; the flash front's
  seeded mask is the one ``seeded_keep`` gives, in the forward and the
  backward; the keep rate is within binomial bounds;
* dispatch: CPU tensors never launch a kernel, the kernels' wrappers
  refuse CPU tensors.

Tolerances: forward rtol 1e-4 / atol 1e-5 and gradients rtol 1e-3 /
atol 1e-5 (f32, the same sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ops as jfo
from paddle_tpu.ops.pallas_kernels import flash_attention as jflash
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.fused_ops import fused_multihead_attention

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_compiles_in_this_process():
    """The JAX side compiles its Pallas kernels in this process: the
    persistent XLA cache that ``paddle_tpu/__init__.py`` turns on for every
    process is written by every test worker at once, and a cached
    executable is the one state this module's results could take from
    another process (ROADMAP.md Queue 3, the order-dependent failures)."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    cc.reset_cache()


def _rand_qkv(b=2, h=3, s=128, d=32, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda: rng.randn(b, h, s, d).astype(np.float32)  # noqa: E731
    bias = np.where(rng.rand(b, s) > 0.25, 0.0, -10000.0).astype(np.float32)
    return mk(), mk(), mk(), bias


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PT_FLASH_ATTENTION", "1")


def _blocks(monkeypatch, s):
    if s > 128:      # several kv blocks: JAX's online-softmax kernels
        monkeypatch.setenv("PT_FLASH_BLOCK", "128")


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_forward_matches_jax_kernel(interpret_kernel, monkeypatch, s,
                                          causal, with_bias):
    _blocks(monkeypatch, s)
    q, k, v, bias = _rand_qkv(s=s, seed=s)
    bias4 = bias[:, None, None, :] if with_bias else None
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  bias=None if bias4 is None else jnp.asarray(bias4),
                  causal=causal)
    got = tfa.flash_attention(_t(q), _t(k), _t(v),
                              bias=None if bias4 is None else _t(bias4),
                              causal=causal)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, **FWD_TOL, err_msg=_diagnosis(
        got, want, _attention_f64(q, k, v, bias4, causal)))


def _attention_f64(q, k, v, bias4, causal):
    """softmax(q k^T / sqrt(d) + bias, causal) v in float64: the arbiter
    when the two sides differ."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if bias4 is not None:
        s = s + bias4
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v.astype(np.float64))


def _diagnosis(got, want, exact):
    """What a failure reports beside numpy's count and largest
    difference: the elements off and how far each side lies from the
    float64 value, so that a failure names the side at fault."""
    off = ~np.isclose(got, want, **FWD_TOL)
    return (f"{int(off.sum())} of {off.size} elements off by up to "
            f"{float(np.abs(got - want).max()):.3e}; port vs float64 "
            f"{float(np.abs(got - exact).max()):.3e}, JAX vs float64 "
            f"{float(np.abs(want - exact).max()):.3e}")


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_grads_match_jax_kernel(interpret_kernel, monkeypatch, s,
                                      causal, with_bias):
    _blocks(monkeypatch, s)
    q, k, v, bias = _rand_qkv(s=s, seed=3 + s)
    ct = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    b = bias if with_bias else None

    def jloss(q_, k_, v_, b_):
        return jnp.sum(jflash(q_, k_, v_, bias=b_, causal=causal) * ct)

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if b is None else jnp.asarray(b)]
    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(*jargs)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tb = None if b is None else _t(b, True)
    (tfa.flash_attention(tq, tk, tv, bias=tb, causal=causal)
     * _t(ct)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    if with_bias:   # the padding bias is a constant on both sides
        assert float(np.abs(np.asarray(want[3])).max()) == 0.0
        assert float(tb.grad.abs().max()) == 0.0


@pytest.mark.parametrize("bias_kind", ["none", "padding", "matrix"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_mha_matches_jax(interpret_kernel, bias_kind, causal):
    q, k, v, pad = _rand_qkv(b=2, h=2, s=128, d=32, seed=11)
    rng = np.random.RandomState(12)
    bias = {"none": None, "padding": pad[:, None, :],
            "matrix": (0.5 * rng.randn(2, 1, 128, 128)).astype(np.float32)
            }[bias_kind]
    ct = rng.randn(*q.shape).astype(np.float32)
    scale = 0.2

    def jloss(q_, k_, v_, b_):
        out = jfo._mha_forward(q_, k_, v_, b_, scale, causal, 0.0, None)
        return jnp.sum(out * ct), out

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    (_, jout), jg = jax.value_and_grad(jloss, argnums=argnums,
                                       has_aux=True)(*jargs)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tb = None if bias is None else _t(bias, True)
    out = fused_multihead_attention(tq, tk, tv, bias_qk=tb, scale=scale,
                                    causal=causal)
    (out * _t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    grads = [tq.grad, tk.grad, tv.grad] + ([] if tb is None else [tb.grad])
    for got, w in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 200])
def test_plain_kernels_match_autograd_of_reference(causal, s):
    """The plain forward and the plain backward from lse (what the CPU
    path runs, and what the CUDA kernels are held to) == autograd of the
    dense ``attention_reference``, ragged length included."""
    q, k, v, bias = _rand_qkv(b=1, h=2, s=s, d=32, seed=s)
    do = torch.tensor(np.random.RandomState(1).randn(*q.shape),
                      dtype=torch.float32)
    tq, tk, tv, tb = _t(q), _t(k), _t(v), _t(bias)
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, tb, 0.3, causal)
    dq, dk, dv = tfa.flash_bwd_reference(tq, tk, tv, tb, out, lse, do, 0.3,
                                         causal)
    aq, ak, av = (t.clone().requires_grad_() for t in (tq, tk, tv))
    ref = tfa.attention_reference(aq, ak, av, tb, causal, 0.3)
    ref.backward(do)
    torch.testing.assert_close(out, ref.detach(), **FWD_TOL)
    for got, want in ((dq, aq.grad), (dk, ak.grad), (dv, av.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_dropout_with_keep_mask_is_the_masked_composition():
    q, k, v, bias = (_t(a) for a in _rand_qkv(b=2, h=2, s=64, d=32, seed=4))
    rate, scale = 0.25, 0.17
    keep = torch.rand(2, 2, 64, 64, generator=torch.Generator().manual_seed(
        5)) >= rate
    got = tfa.attention_reference(q, k, v, bias, False, scale, rate,
                                  keep=keep)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p, torch.zeros_like(p)) * (1.0 / (1.0 - rate))
    want = torch.einsum("bhqk,bhkd->bhqd", p, v)
    assert torch.equal(got, want)


def test_flash_front_dropout_uses_the_seeded_mask():
    """On the CPU the flash front draws its mask from ``seeded_keep`` of
    the seed, in the forward and again in the backward: its output and
    gradients are autograd's of the dense reference with that mask."""
    q, k, v, bias = _rand_qkv(b=2, h=2, s=96, d=32, seed=6)
    rate = 0.1
    seed = torch.tensor([12345], dtype=torch.int64)
    do = torch.tensor(np.random.RandomState(2).randn(*q.shape),
                      dtype=torch.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq, tk, tv, bias=_t(bias), dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(do)
    keep = tfa.seeded_keep((2, 2, 96, 96), rate, seed, "cpu")
    aq, ak, av = _t(q, True), _t(k, True), _t(v, True)
    ref = tfa.attention_reference(aq, ak, av, _t(bias), False, 32 ** -0.5,
                                  rate, keep=keep)
    ref.backward(do)
    torch.testing.assert_close(out.detach(), ref.detach(), **FWD_TOL)
    for got, want in ((tq.grad, aq.grad), (tk.grad, ak.grad),
                      (tv.grad, av.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL)
    again = tfa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                                dropout_rate=rate, dropout_seed=seed)
    assert torch.equal(again, out.detach())


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_seeded_keep_rate_within_binomial_bounds(rate):
    keep = tfa.seeded_keep((4, 4, 128, 128), rate, 7, "cpu")
    n = keep.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(float(keep.sum()) - n * (1 - rate)) <= 4 * sigma


def test_fused_mha_dropout_draws_from_the_generator():
    q, k, v, bias = (_t(a) for a in _rand_qkv(b=1, h=2, s=64, d=32, seed=8))
    outs = [fused_multihead_attention(
        q, k, v, bias_qk=bias, dropout_rate=0.2,
        generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_cpu_path_launches_no_kernel_and_wrappers_refuse_cpu():
    q, k, v, bias = (_t(a, True) for a in _rand_qkv(b=1, h=1, s=64, d=32))
    kernels = (tfa.FLASH_FWD, tfa.FLASH_BWD_FUSED, tfa.FLASH_BWD_DQ,
               tfa.FLASH_BWD_DKV, tfa.FLASH_DROPOUT_MASK)
    before = [kf.launches for kf in kernels]
    tfa.flash_attention(q, k, v, bias=bias).sum().backward()
    assert [kf.launches for kf in kernels] == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q.detach(), k.detach(), v.detach(), None, 0.1, False)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd(*(t.detach() for t in (q, k, v)), None, q.detach(),
                      q.detach()[..., 0], q.detach(), 0.1, False)
    with pytest.raises(ValueError, match="unsupported attention bias"):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1, 1, 64, 64))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)


# ==========================================================================
# bfloat16: the plain versions round p, pd and dS to bf16 where the TPU
# kernels cast them, as the CUDA kernels do
# ==========================================================================
# bf16 outputs within BF16_ULPS bf16 ulps (2^-8 relative) of the tensor's
# largest magnitude: both sides round at the same points, but JAX's
# multi-block kernel rounds p against the running max of its kv block
# (the plain version against the row's final max), the dense reference's
# autodiff also rounds dP to bf16, and every sum runs in another order, so
# an output may land one rounding step apart and a sum of rounded terms
# moves by about one ulp of its largest term
BF16_ULPS = 4
# lse stays f32
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_pair(a):
    """The bf16 rounding of f32 numpy ``a``: (jax array, torch tensor),
    the same values (both round to nearest even)."""
    t = torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a, jnp.bfloat16), t


def _assert_bf16_close(got, want, what=""):
    """``got`` (torch bf16) within BF16_ULPS ulps of max |want|."""
    assert got.dtype == torch.bfloat16, what
    w = np.asarray(want).astype(np.float32)
    assert w.dtype == np.float32 and np.asarray(want).dtype.name == \
        "bfloat16", what
    tol = BF16_ULPS * 2.0 ** -8 * float(np.abs(w).max())
    err = float(np.abs(got.float().numpy() - w).max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_bf16_forward_matches_jax_kernel(interpret_kernel, monkeypatch,
                                               s, causal, with_bias):
    _blocks(monkeypatch, s)
    q, k, v, bias = _rand_qkv(s=s, seed=40 + s)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(a) for a in (q, k, v))
    b4 = bias[:, None, None, :] if with_bias else None
    want = jflash(jq, jk, jv, bias=None if b4 is None else jnp.asarray(b4),
                  causal=causal)
    got = tfa.flash_attention(tq, tk, tv,
                              bias=None if b4 is None else _t(b4),
                              causal=causal)
    _assert_bf16_close(got, want, "out")


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_grads_match_jax_kernel(interpret_kernel, monkeypatch, s,
                                           causal):
    _blocks(monkeypatch, s)
    q, k, v, bias = _rand_qkv(s=s, seed=50 + s)
    ct = np.random.RandomState(10).randn(*q.shape).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jct, tct) = (
        _bf16_pair(a) for a in (q, k, v, ct))

    def jloss(q_, k_, v_):
        out = jflash(q_, k_, v_, bias=jnp.asarray(bias), causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out = tfa.flash_attention(tq, tk, tv, bias=_t(bias), causal=causal)
    out.backward(tct)
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _assert_bf16_close(got, w, "d" + name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 200])
def test_flash_bf16_plain_matches_jax_attention_reference(causal, s):
    """The plain bf16 forward and backward (what the CPU path runs, and
    what the bf16 CUDA kernels are held to) against JAX's dense
    ``attention_reference`` on the same bf16 inputs and its autodiff."""
    from paddle_tpu.ops.pallas_kernels import attention_reference as jref

    q, k, v, bias = _rand_qkv(b=1, h=2, s=s, d=32, seed=60 + s)
    ct = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jct, tct) = (
        _bf16_pair(a) for a in (q, k, v, ct))

    def jloss(q_, k_, v_):
        out = jref(q_, k_, v_, jnp.asarray(bias), causal, 0.3)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32)), \
            out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(jq, jk, jv)
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, _t(bias), 0.3, causal)
    _assert_bf16_close(out, jout, "out")
    # lse from the bf16 inputs is the f32 lse of their f32 upcasts
    _, lse32 = tfa.flash_fwd_reference(tq.float(), tk.float(), tv.float(),
                                       _t(bias), 0.3, causal)
    torch.testing.assert_close(lse, lse32, **LSE_TOL)
    grads = tfa.flash_bwd_reference(tq, tk, tv, _t(bias), out, lse, tct,
                                    0.3, causal)
    for name, got, w in zip("qkv", grads, jg):
        _assert_bf16_close(got, w, "d" + name)


def test_flash_bf16_rounds_where_the_tpu_kernels_cast():
    """The bf16 plain versions differ from the f32 ones on the same
    (bf16-representable) inputs by about a bf16 rounding, not by f32
    noise: the roundings of p, pd and dS do happen."""
    q, k, v, bias = _rand_qkv(b=1, h=2, s=96, d=32, seed=70)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    do = torch.tensor(np.random.RandomState(3)
                      .randn(*q.shape)).to(torch.bfloat16)
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        a = [t.to(dt) for t in (tq, tk, tv)]
        out, lse = tfa.flash_fwd_reference(*a, _t(bias), 0.2, False)
        grads = tfa.flash_bwd_reference(*a, _t(bias), out, lse, do.to(dt),
                                        0.2, False)
        outs[dt] = [t.float() for t in (out, *grads)]
    for b16, f32 in zip(outs[torch.bfloat16], outs[torch.float32]):
        diff = float((b16 - f32).abs().max())
        scale = float(f32.abs().max())
        assert 2.0 ** -12 * scale < diff <= BF16_ULPS * 2.0 ** -8 * scale


def test_flash_front_takes_a_bf16_bias_and_refuses_float16():
    q, k, v, bias = _rand_qkv(b=1, h=2, s=64, d=32, seed=71)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    b16 = torch.tensor(bias).to(torch.bfloat16)
    got = tfa.flash_attention(tq, tk, tv, bias=b16)
    want = tfa.flash_attention(tq, tk, tv, bias=b16.float())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfa.flash_attention(tq.half(), tk.half(), tv.half())
    with pytest.raises(NotImplementedError, match="not ported"):
        tfa.flash_fwd(tq.half(), tk.half(), tv.half(), None, 0.1, False)
