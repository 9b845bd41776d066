"""PyTorch port, hand-written CUDA kernels on the card (marker ``cuda``).

Each test builds the kernel with ``nvcc`` from the sources in this
checkout and holds it against its plain PyTorch version on CUDA
tensors.  On a host without a CUDA device the tests skip.  Run them on
the GPU, where JAX need not be installed, without the JAX-side
``conftest.py``: ``python -m pytest --noconftest
tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

# f32 kernel vs plain version: the same sums in another order
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels target sm_90a (Hopper)")
    return torch.device("cuda")


def _case(dev, seed, hq, hkv, d, ps, n_pages, lens, n_pad=0):
    rng = np.random.RandomState(seed)
    need = [-(-n // ps) for n in lens]
    width = 1
    while width < max(need):
        width *= 2
    perm = rng.permutation(n_pages)
    tables = np.zeros((len(lens) + n_pad, width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    b = len(lens) + n_pad
    arrays = (rng.randn(b, hq, d), rng.randn(hkv, n_pages, ps, d),
              rng.randn(hkv, n_pages, ps, d))
    q, kp, vp = (torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)
    ctx = np.asarray(list(lens) + [1] * n_pad, np.int32)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx).to(dev))


@pytest.mark.parametrize("hq,hkv,d,ps,lens,n_pad", [
    (12, 12, 64, 16, [1024, 777, 512, 301, 64, 17], 2),   # GPT-2 small
    (32, 8, 128, 16, [1, 16, 33, 250, 512, 700, 1000, 1024], 0),
    (4, 2, 32, 8, [1, 8, 9], 1),
    (8, 1, 256, 16, [40, 3], 0),
])
def test_paged_decode_kernel_matches_plain(cuda, hq, hkv, d, ps, lens,
                                           n_pad):
    case = _case(cuda, 0, hq, hkv, d, ps, 256, lens, n_pad)
    before = tpa.PAGED_DECODE.launches
    got = tpa.paged_attention(*case)
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE.launches == before + 1
    want = tpa.paged_attention_reference(*case)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL


def test_paged_decode_wrapper_raises_on_unsupported(cuda):
    case = list(_case(cuda, 1, 4, 2, 48, 8, 16, [5, 9]))
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*case)
    case = list(_case(cuda, 1, 4, 2, 32, 8, 16, [5, 9]))
    case[1] = case[1].double()
    with pytest.raises(ValueError, match="float32"):
        tpa.paged_attention(*case)


def _q_case(dev, seed, dtype, hq, hkv, d, ps, n_pages, lens, n_pad=0):
    """A decode case over bf16 or int8 pools (int8 with its scales).  The
    first page of the second sequence is never written (int8: codes and
    scale 0); ``lens`` may hold a context of 0."""
    rng = np.random.RandomState(seed)
    need = [max(1, -(-n // ps)) for n in lens]
    width = 1
    while width < max(need):
        width *= 2
    perm = rng.permutation(n_pages)
    b = len(lens) + n_pad
    tables = np.zeros((b, width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    q = torch.tensor(rng.randn(b, hq, d), dtype=torch.float32, device=dev)
    scales = ()
    if dtype == torch.int8:
        kp, vp = (torch.tensor(rng.randint(-127, 128, (hkv, n_pages, ps, d)),
                               dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.tensor(np.abs(rng.randn(hkv, n_pages)) + 0.1,
                               dtype=torch.float32, device=dev)
                  for _ in range(2))
        blank = int(tables[min(1, len(lens) - 1), 0])
        for pool in (kp, vp):
            pool[:, blank] = 0
        ks[:, blank] = 0
        vs[:, blank] = 0
        scales = (ks, vs)
    else:
        kp, vp = (torch.tensor(rng.randn(hkv, n_pages, ps, d),
                               dtype=torch.float32, device=dev).to(dtype)
                  for _ in range(2))
    ctx = np.asarray(list(lens) + [1] * n_pad, np.int32)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx).to(dev)), scales


QUANT_CASES = [   # hq, hkv, d, ps, lens, n_pad
    (12, 12, 64, 16, [1024, 777, 512, 301, 64, 17], 2),   # GPT-2 small
    (32, 8, 128, 16, [1, 16, 33, 250, 512, 700, 1000, 1024], 0),
    (4, 4, 32, 8, [1, 8, 9, 0], 1),
    (8, 1, 256, 16, [40, 3, 0], 0),
    (8, 2, 64, 16, [16, 32, 47, 200], 3),
    (16, 2, 128, 8, [7, 64, 65], 0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d,ps,lens,n_pad", QUANT_CASES)
def test_paged_decode_quantized_kernels_match_plain(cuda, dtype, hq, hkv, d,
                                                    ps, lens, n_pad):
    case, scales = _q_case(cuda, 3, dtype, hq, hkv, d, ps, 512, lens, n_pad)
    fn = (tpa.PAGED_DECODE_INT8 if dtype == torch.int8
          else tpa.PAGED_DECODE_BF16)
    before = (fn.launches, tpa.PAGED_DECODE.launches)
    got = tpa.paged_attention(*case, None, *scales)
    torch.cuda.synchronize()
    assert (fn.launches, tpa.PAGED_DECODE.launches) == (before[0] + 1,
                                                         before[1])
    want = tpa.paged_attention_reference(*case, None, *scales)
    live = case[4] > 0
    assert torch.isfinite(got).all()
    assert float((got[live] - want[live]).abs().max()) <= ATOL
    # a row with context 0 gives zeros, as the TPU kernel's l == 0 guard
    if not live.all():
        assert float(got[~live].abs().max()) == 0.0


def test_paged_decode_quantized_wrappers_raise_on_unsupported(cuda):
    counts = (tpa.PAGED_DECODE_BF16.launches, tpa.PAGED_DECODE_INT8.launches)
    case, scales = _q_case(cuda, 4, torch.int8, 4, 2, 96, 8, 16, [5, 9])
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*case, None, *scales)
    case, scales = _q_case(cuda, 4, torch.int8, 4, 2, 64, 8, 16, [5, 9])
    with pytest.raises(ValueError, match="k_scale"):
        tpa.paged_attention(*case)                      # int8, no scales
    bcase, _ = _q_case(cuda, 4, torch.bfloat16, 4, 2, 64, 8, 16, [5, 9])
    with pytest.raises(ValueError, match="int8"):
        tpa.paged_attention(*bcase, None, *scales)      # bf16 with scales
    hcase = list(bcase)
    hcase[1], hcase[2] = hcase[1].half(), hcase[2].half()
    with pytest.raises(ValueError, match="float16"):
        tpa.paged_attention(*hcase)                     # float16 pools
    with pytest.raises(ValueError, match="expected torch.int8"):
        tpa.paged_decode_int8(*bcase, 0.125, *scales)
    with pytest.raises(ValueError, match="v_scale"):
        tpa.paged_decode_int8(*case, 0.125, scales[0], scales[1].double())
    assert counts == (tpa.PAGED_DECODE_BF16.launches,
                      tpa.PAGED_DECODE_INT8.launches)


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="bfloat16"), dict(kv_dtype="int8"),
    dict(kv_dtype="int8", prefix_cache=True, prefill_chunk=8)],
    ids=["bf16", "int8", "int8-prefix-chunk"])
def test_quantized_engine_launches_its_kernel_per_layer_and_step(cuda, kw):
    """A bf16 / int8 engine on the card launches its pool dtype's kernel
    once per layer and decode step, and no other decode kernel; its
    tokens equal the same engine's on the CPU, or part from them only
    where the reference's top-2 logit margin is a near-tie (5e-2)."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, ServingEngine)

    cfg = DecoderConfig(vocab_size=64, hidden=64, num_heads=2, num_layers=3,
                        max_seq_len=128)
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, 64, 20).tolist()
    prompts = [prefix + rng.randint(0, 64, n).tolist() for n in (3, 9, 30)]
    kernels = {"bfloat16": tpa.PAGED_DECODE_BF16, "int8": tpa.PAGED_DECODE_INT8}
    mine = kernels[kw["kv_dtype"]]
    counts = [k.launches for k in (tpa.PAGED_DECODE, *kernels.values())]
    eng = ServingEngine(cfg, num_pages=32, page_size=8, max_batch=4,
                        device=cuda, **kw)
    before = mine.launches
    outs = eng.generate(prompts, max_new_tokens=6)
    assert mine.launches - before == cfg.num_layers * eng.stats["decode_steps"]
    after = [k.launches for k in (tpa.PAGED_DECODE, *kernels.values())]
    assert [a - b for a, b in zip(after, counts)].count(0) == 2
    cpu = ServingEngine(cfg, num_pages=32, page_size=8, max_batch=4,
                        device="cpu", **kw)
    for p, got, want in zip(prompts, outs, cpu.generate(prompts, 6)):
        if got != want:
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            top2 = torch.topk(cpu.core.reference_logits(p + want[:i]),
                              2).values
            assert float(top2[0] - top2[1]) < 5e-2


# ==========================================================================
# flash attention (csrc/flash_attention.cu): forward, fused backward, split
# dQ and dK/dV, and the dropout mask, against the plain versions
# ==========================================================================
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# gradients: f32 sums of up to s terms in another order than autograd's
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _flash_case(dev, seed, b, h, sq, sk, d, with_bias):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(*s), dtype=torch.float32,
                                device=dev)
                   for s in [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                             (b, h, sq, d)])
    bias = None
    if with_bias:
        bias = torch.tensor(np.where(rng.rand(b, sk) > 0.25, 0.0, -10000.0),
                            dtype=torch.float32, device=dev)
    return q, k, v, do, bias


def _plain_grads(q, k, v, do, bias, causal, rate=0.0, keep=None):
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.attention_reference(qa, ka, va, bias, causal,
                                  q.shape[-1] ** -0.5, rate, keep=keep)
    out.backward(do)
    return out.detach(), qa.grad, ka.grad, va.grad


def _fused_and_split(q, k, v, bias, out, lse, do, scale, causal, rate=0.0,
                     seed=None):
    """(dq, dk, dv) from the fused kernel and from the split pair."""
    args = (q, k, v, bias, do, lse, (do.float() * out.float()).sum(-1),
            scale, causal, rate, seed)
    return [tfa.bwd_fused(*args), (tfa.bwd_dq(*args), *tfa.bwd_dkv(*args))]


@pytest.mark.parametrize("s", [64, 128, 512, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,with_bias", [(False, True), (True, False)])
def test_flash_kernels_match_plain(cuda, s, d, causal, with_bias):
    q, k, v, do, bias = _flash_case(cuda, s + d, 2, 3, s, s, d, with_bias)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal)
    want_out, want_lse = tfa.flash_fwd_reference(q, k, v, bias, scale,
                                                 causal)
    torch.cuda.synchronize()
    assert float((out - want_out).abs().max()) <= ATOL
    assert float((lse - want_lse).abs().max()) <= ATOL
    ref, dq0, dk0, dv0 = _plain_grads(q, k, v, do, bias, causal)
    assert float((out - ref).abs().max()) <= ATOL
    for dq, dk, dv in _fused_and_split(q, k, v, bias, out, lse, do, scale,
                                       causal):
        torch.cuda.synchronize()
        for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
            torch.testing.assert_close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("s,causal", [(128, False), (512, True),
                                      (1024, False)])
def test_flash_dropout_uses_the_dumped_mask(cuda, s, causal):
    q, k, v, do, bias = _flash_case(cuda, 5, 2, 2, s, s, 64, True)
    rate, scale = 0.1, 64 ** -0.5
    seed = torch.tensor([12345], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(2, 2, s, s, rate, seed)
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    ref, dq0, dk0, dv0 = _plain_grads(q, k, v, do, bias, causal, rate, keep)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= ATOL
    grads = _fused_and_split(q, k, v, bias, out, lse, do, scale, causal, rate,
                             seed)
    for dq, dk, dv in grads:
        for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
            torch.testing.assert_close(got, want, **GRAD_TOL)
    # fused and split regenerate the same mask: the same gradients
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_flash_dropout_keep_rate_and_determinism(cuda):
    b, h, s, rate = 4, 12, 512, 0.1
    seed = torch.tensor([7], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(b, h, s, s, rate, seed)
    n = keep.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(float(keep.sum()) - n * (1 - rate)) <= 4 * sigma
    assert torch.equal(keep, tfa.flash_dropout_mask(b, h, s, s, rate, seed))
    other = tfa.flash_dropout_mask(b, h, s, s, rate, seed + 1)
    assert not torch.equal(keep, other)
    q, k, v, _, bias = _flash_case(cuda, 1, 2, 2, 256, 256, 64, True)
    o1, _ = tfa.flash_fwd(q, k, v, bias, 0.125, False, rate, seed)
    o2, _ = tfa.flash_fwd(q, k, v, bias, 0.125, False, rate, seed)
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("s,n_bwd", [(256, 1), (1024, 2)])
def test_flash_attention_front_launches_kernels(cuda, s, n_bwd):
    q, k, v, do, bias = _flash_case(cuda, 2, 1, 2, s, s, 64, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kernels = (tfa.FLASH_FWD, tfa.FLASH_BWD_FUSED, tfa.FLASH_BWD_DQ,
               tfa.FLASH_BWD_DKV)
    before = [kf.launches for kf in kernels]
    out = tfa.flash_attention(q, k, v, bias=bias[:, None, None, :])
    out.backward(do)
    torch.cuda.synchronize()
    fwd, fused, dq, dkv = (kf.launches - n0 for kf, n0 in zip(kernels,
                                                              before))
    assert fwd == 1 and fused + dq + dkv == n_bwd
    assert (fused == 1) == (s <= tfa.FUSED_BWD_MAX_SEQ)


def test_flash_wrappers_raise_on_unsupported(cuda):
    q, k, v, do, bias = _flash_case(cuda, 3, 1, 2, 64, 64, 64, True)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_fwd(q.double(), k.double(), v.double(), None, 0.1, False)
    with pytest.raises(ValueError, match="bfloat16"):   # mixed dtypes
        tfa.flash_fwd(q.bfloat16(), k, v.bfloat16(), None, 0.1, False)
    with pytest.raises(ValueError, match="float32"):    # a bf16 bias
        tfa.flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                      bias.bfloat16(), 0.1, False)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfa.flash_fwd(q.half(), k.half(), v.half(), None, 0.1, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(2, 3), k, v, None, 0.1, False)
    q48, k48, v48, _, _ = _flash_case(cuda, 3, 1, 2, 64, 64, 48, False)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q48, k48, v48, None, 0.1, False)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_fwd(q, k, v, bias, 0.1, False, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q.cpu(), k.cpu(), v.cpu(), None, 0.1, False)


# ==========================================================================
# the bf16 flash kernels against their bf16 plain versions
# ==========================================================================
# Both round p, pd and dS to bf16 at the same points; the forward kernel
# rounds p against the running max of its kv tile (the plain version
# against the final max) and every sum runs in another order, so outputs
# agree within BF16_ULPS bf16 ulps (2^-8 relative) of the tensor's
# largest magnitude; lse is f32 (ATOL)
BF16_ULPS = 4
BF16_KERNELS = (tfa.FLASH_FWD_BF16, tfa.FLASH_BWD_FUSED_BF16,
                tfa.FLASH_BWD_DQ_BF16, tfa.FLASH_BWD_DKV_BF16)
F32_KERNELS = (tfa.FLASH_FWD, tfa.FLASH_BWD_FUSED, tfa.FLASH_BWD_DQ,
               tfa.FLASH_BWD_DKV)


def _bf16_ok(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
    tol = BF16_ULPS * 2.0 ** -8 * float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) <= tol


def _bf16_case(dev, seed, b, h, s, d, with_bias):
    q, k, v, do, bias = _flash_case(dev, seed, b, h, s, s, d, with_bias)
    return (*(t.bfloat16() for t in (q, k, v, do)), bias)


@pytest.mark.parametrize("s", [64, 200, 512, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,with_bias,rate", [
    (False, True, 0.0), (True, False, 0.0), (False, True, 0.1)])
def test_flash_bf16_kernels_match_plain(cuda, s, d, causal, with_bias,
                                        rate):
    q, k, v, do, bias = _bf16_case(cuda, 100 + s + d, 2, 3, s, d, with_bias)
    scale = d ** -0.5
    seed = torch.tensor([99], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(2, 3, s, s, rate, seed) if rate else None
    before = [kf.launches for kf in BF16_KERNELS + F32_KERNELS]
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    want_out, want_lse = tfa.flash_fwd_reference(q, k, v, bias, scale,
                                                 causal, rate, keep)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_ok(out, want_out)
    assert float((lse - want_lse).abs().max()) <= ATOL
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, rate, keep)
    for grads in _fused_and_split(q, k, v, bias, out, lse, do, scale,
                                  causal, rate, seed if rate else None):
        torch.cuda.synchronize()
        for got, w in zip(grads, want):
            assert _bf16_ok(got, w)
    # the bf16 kernels ran, once each, and no f32 kernel
    after = [kf.launches for kf in BF16_KERNELS + F32_KERNELS]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 0, 0, 0, 0]


def test_flash_bf16_and_f32_kernels_differ_by_a_bf16_rounding(cuda):
    """On the same bf16-representable inputs the bf16 kernels differ from
    the f32 ones by about the bf16 roundings they make, far above the f32
    kernels' own noise: a bf16 kernel that computed the f32 path would
    show."""
    q, k, v, do, bias = _bf16_case(cuda, 7, 2, 4, 512, 64, True)
    f32 = [t.float() for t in (q, k, v, do)]
    o16, l16 = tfa.flash_fwd(q, k, v, bias, 0.125, False)
    o32, l32 = tfa.flash_fwd(*f32[:3], bias, 0.125, False)
    g16 = tfa.flash_bwd(q, k, v, bias, o16, l16, do, 0.125, False)
    g32 = tfa.flash_bwd(*f32[:3], bias, o32, l32, f32[3], 0.125, False)
    torch.cuda.synchronize()
    for a, b in zip((o16, *g16), (o32, *g32)):
        diff = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        assert 2.0 ** -12 * scale < diff <= BF16_ULPS * 2.0 ** -8 * scale


@pytest.mark.parametrize("s,n_bwd", [(256, 1), (1024, 2)])
def test_flash_attention_front_launches_bf16_kernels(cuda, s, n_bwd):
    q, k, v, do, bias = _bf16_case(cuda, 8, 1, 2, s, 64, True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [kf.launches for kf in BF16_KERNELS + F32_KERNELS]
    # under AMP the bias arrives in bf16; the front takes its f32 upcast
    out = tfa.flash_attention(q, k, v, bias=bias.bfloat16()[:, None, None],
                              dropout_rate=0.1, dropout_seed=torch.tensor(
                                  [3], dtype=torch.int64, device=cuda))
    out.backward(do)
    torch.cuda.synchronize()
    fwd, fused, dq, dkv, *f32 = (kf.launches - n0 for kf, n0 in zip(
        BF16_KERNELS + F32_KERNELS, before))
    assert fwd == 1 and fused + dq + dkv == n_bwd and f32 == [0] * 4
    assert q.grad.dtype == torch.bfloat16


# ==========================================================================
# the conv epilogue (csrc/bn_act.cu): kernels 7 and 8 against their plain
# versions; "" and relu and the backward bit for bit (both round every
# step in the same order), sigmoid / tanh / gelu within 1e-6
# ==========================================================================
from paddle_tpu_torch.ops import bn_act as tba  # noqa: E402

BN_SHAPES = [((8, 64, 28, 28), 1), ((3, 37, 13, 11), 1), ((3, 13, 11, 37), 3),
             ((4, 7, 7, 64), 3), ((300, 24), 1), ((2, 6, 3, 5), 1)]
BN_IDS = ["nchw", "nchw-ragged", "nhwc-ragged", "nhwc", "mc", "nchw-tiny"]


def _bn_case(dev, seed, shape, c_axis, offset=0):
    """x, z (of ``shape``) and four per-channel vectors; ``offset`` > 0
    makes the big tensors start off 16-byte alignment (the scalar
    path)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(np.prod(shape))

    def big():
        buf = torch.randn(n + offset, device=dev, generator=gen)
        return buf[offset:].view(shape)

    c = shape[c_axis]
    return big(), big(), [torch.randn(c, device=dev, generator=gen)
                          for _ in range(4)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_apply_kernel_matches_plain(cuda, shape, c_axis, act, with_z,
                                           offset):
    x, z, (a, b, _, _) = _bn_case(cuda, 0, shape, c_axis, offset)
    z = z if with_z else None
    before = tba.BN_ACT_APPLY.launches
    got = tba.bn_act_apply(x, a, b, z, act=act, c_axis=c_axis)
    torch.cuda.synchronize()
    assert tba.BN_ACT_APPLY.launches == before + 1
    want = tba.bn_act_apply_reference(x, a, b, z, act=act, c_axis=c_axis)
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_bwd_kernel_matches_plain(cuda, shape, c_axis, act, want_g,
                                         offset):
    x, dy, (cg, mean, cx, c0) = _bn_case(cuda, 1, shape, c_axis, offset)
    y = torch.relu(x + 0.1)
    before = tba.BN_ACT_BWD.launches
    dx, g = tba.bn_act_bwd_apply(y, dy, x, cg, mean, cx, c0, act=act,
                                 c_axis=c_axis, want_g=want_g)
    torch.cuda.synchronize()
    assert tba.BN_ACT_BWD.launches == before + 1
    want_dx, want_gv = tba.bn_act_bwd_reference(y, dy, x, cg, mean, cx, c0,
                                                act, c_axis, want_g)
    assert torch.equal(dx, want_dx)
    if want_g:
        assert torch.equal(g, want_gv)
    else:
        assert g is None


def test_bn_act_wrappers_raise_on_unsupported(cuda):
    x, z, (a, b, _, _) = _bn_case(cuda, 2, (2, 8, 4, 4), 1)
    with pytest.raises(NotImplementedError, match="float16"):
        tba.bn_act_apply(x.half(), a.half(), b.half())
    with pytest.raises(ValueError, match="float32"):   # mixed dtypes
        tba.bn_act_apply(x.bfloat16(), a, b)
    with pytest.raises(ValueError, match="contiguous"):
        tba.bn_act_apply(x.bfloat16().transpose(2, 3), a.bfloat16(),
                         b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tba.bn_act_apply(x.transpose(2, 3), a, b)
    with pytest.raises(ValueError, match="shape"):
        tba.bn_act_apply(x, a[:4].contiguous(), b)
    with pytest.raises(ValueError, match="shape"):
        tba.bn_act_apply(x, a, b, z=z[:1])
    with pytest.raises(ValueError, match="bfloat16"):
        tba.bn_act_bwd_apply(x.bfloat16(), x.bfloat16(), x.bfloat16(), a, a,
                             a, a)
    with pytest.raises(ValueError, match="float32"):   # c0 stays f32
        tba.bn_act_bwd_apply(*(t.bfloat16() for t in (x, x, x, a, a, a, a)))
    with pytest.raises(NotImplementedError):
        tba.bn_act_bwd_apply(x, x, x, a, a, a, a, act="gelu")
    with pytest.raises(ValueError, match="CUDA device"):
        tba.bn_act_apply(x, a.cpu(), b)
    # a CPU tensor takes the plain version and launches nothing
    before = tba.BN_ACT_APPLY.launches
    tba.bn_act_apply(x.cpu(), a.cpu(), b.cpu())
    assert tba.BN_ACT_APPLY.launches == before


def test_resnet18_on_the_card_launches_the_epilogue_kernels(cuda):
    """Two ResNet-18 steps at 32x32 through fluid.Executor(CUDAPlace(0))
    with the fusion and layout flags at auto (NCHW for an f32 program):
    each of the 17 conv chains launches kernel 7 once per step and
    kernel 8 once per step."""
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.tools.train_resnet import build_program, make_batch
    import paddle_tpu_torch.fluid as fluid

    torch.backends.cudnn.allow_tf32 = False
    main, startup, loss, acc1 = build_program(18, 32, 10, 0.1, amp=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    assert exe.fuse_enabled() and not exe.nhwc_enabled(main)
    scope = Scope()
    exe.run(startup, scope=scope)
    img, label = make_batch(4, 32, 10)
    before = (tba.BN_ACT_APPLY.launches, tba.BN_ACT_BWD.launches)
    losses = [float(exe.run(main, feed={"img": img, "label": label},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(2)]
    torch.cuda.synchronize()
    assert np.isfinite(losses).all()
    assert (tba.BN_ACT_APPLY.launches - before[0],
            tba.BN_ACT_BWD.launches - before[1]) == (34, 34)
    assert all(t.device.type == "cuda" for _, t in scope.items())


# ==========================================================================
# the fc epilogue (csrc/matmul_bias_act.cu): kernel 9 against its plain
# version within the tolerance of JAX's own kernel test
# (tests/test_fused_epilogue.py:116-117): f32 sums in another order
# ==========================================================================
from paddle_tpu_torch.ops import matmul_epilogue as tme  # noqa: E402

MM_TOL = dict(rtol=2e-5, atol=2e-4)
MM_ACTS = ["", "relu", "sigmoid", "tanh", "gelu"]
# (M, K, N): LeNet's two fc layers, word2vec's hidden layer, all-odd
# ragged edges, one element, K of a few thousand, several row and column
# tiles with ragged edges on both
MM_SHAPES = [(256, 400, 120), (256, 120, 84), (256, 128, 256), (37, 53, 29),
             (1, 1, 1), (65, 4099, 67), (300, 96, 200)]
MM_IDS = ["lenet-fc1", "lenet-fc2", "word2vec", "odd", "one", "large-k",
          "tiles"]


def _mm_case(dev, seed, m, k, n):
    """x (M, K), w (K, N) scaled as a layer's weights are, bias (N,)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
    return x, w, torch.randn(n, device=dev, generator=gen)


@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("m,k,n", MM_SHAPES, ids=MM_IDS)
def test_matmul_bias_act_kernel_matches_plain(cuda, m, k, n, act):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _mm_case(cuda, 0, m, k, n)
    before = tme.MATMUL_BIAS_ACT_F32.launches
    got = tme.matmul_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert tme.MATMUL_BIAS_ACT_F32.launches == before + 1
    want = tme.matmul_bias_act_reference(x, w, b, act)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **MM_TOL)


def test_matmul_bias_act_wrapper_raises_on_unsupported(cuda):
    x, w, b = _mm_case(cuda, 1, 32, 48, 24)
    before = tme.MATMUL_BIAS_ACT_F32.launches
    with pytest.raises(NotImplementedError, match="float16"):
        tme.matmul_bias_act(x.half(), w.half(), b.half(), "relu")
    with pytest.raises(NotImplementedError, match="float32"):  # mixed
        tme.matmul_bias_act(x, w.bfloat16(), b, "relu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        tme.matmul_bias_act(x.bfloat16().t().contiguous().t(), w.bfloat16(),
                            b, "relu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        tme.matmul_bias_act(x.t().contiguous().t(), w, b, "relu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        tme.matmul_bias_act(x, w.t().contiguous().t(), b)
    with pytest.raises(NotImplementedError, match="act"):
        tme.matmul_bias_act(x, w, b, "swish")
    with pytest.raises(ValueError, match="chain"):
        tme.matmul_bias_act(x, w[:5].contiguous(), b)
    with pytest.raises(ValueError, match="CUDA device"):
        tme.matmul_bias_act(x, w.cpu(), b)
    assert tme.MATMUL_BIAS_ACT_F32.launches == before
    # a CPU tensor takes the plain version and launches nothing
    tme.matmul_bias_act(x.cpu(), w.cpu(), b.cpu(), "relu")
    assert tme.MATMUL_BIAS_ACT_F32.launches == before


@pytest.mark.parametrize("model,chains", [("lenet", 2), ("word2vec", 1)])
def test_book_models_on_the_card_launch_kernel_9(cuda, model, chains):
    """Three steps of each book model at a small batch through
    fluid.Executor(CUDAPlace(0)) with the fusion flag at auto: kernel 9
    launches twice per fc chain per step (the forward and the grad's
    replay), and the card's losses follow the CPU's from the same
    startup scope (f32 sums in another order: rtol 1e-4)."""
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools import train_book as tb
    import paddle_tpu_torch.fluid as fluid

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(tb.DEFAULTS[model], batch=16)
    main, startup, fetch = tb.build_program(model, cfg)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    feed = tb.make_batch(model, cfg)
    losses = {}
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        before = tme.MATMUL_BIAS_ACT_F32.launches
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=fetch[:1],
                                     scope=scope)[0]) for _ in range(3)]
        torch.cuda.synchronize()
        launched = tme.MATMUL_BIAS_ACT_F32.launches - before
        assert launched == (0 if dev == "cpu" else 2 * chains * 3)
    assert all(t.device.type == "cuda" for _, t in scope.items())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ==========================================================================
# static AMP in bf16: kernels 7 and 8 in bf16 against their plain versions
# bit for bit ("" and relu and the backward; both round every multiply and
# add to bf16 in the Pallas kernels' order), sigmoid / tanh / gelu within
# one bf16 ulp of the largest output (f32 libdevice functions of the same
# rounded sum, rounded once)
# ==========================================================================
def _bn16(dev, seed, shape, c_axis, offset=0):
    x, z, vecs = _bn_case(dev, seed, shape, c_axis, offset)
    return x.bfloat16() if offset == 0 else _misaligned16(x, offset), \
        z.bfloat16() if offset == 0 else _misaligned16(z, offset), \
        [v.bfloat16() for v in vecs[:3]] + [vecs[3]]


def _misaligned16(t, offset):
    """A bf16 copy of ``t`` that starts ``offset`` elements (2 bytes each)
    off 16-byte alignment."""
    buf = torch.empty(t.numel() + offset, dtype=torch.bfloat16,
                      device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _bf16_ulps(got, want):
    return float((got.float() - want.float()).abs().max()) / (
        2.0 ** -8 * float(want.float().abs().max()))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_apply_bf16_kernel_matches_plain(cuda, shape, c_axis, act,
                                                with_z, offset):
    x, z, (a, b, _, _) = _bn16(cuda, 0, shape, c_axis, offset)
    z = z if with_z else None
    before = (tba.BN_ACT_APPLY_BF16.launches, tba.BN_ACT_APPLY.launches)
    got = tba.bn_act_apply(x, a, b, z, act=act, c_axis=c_axis)
    torch.cuda.synchronize()
    assert (tba.BN_ACT_APPLY_BF16.launches,
            tba.BN_ACT_APPLY.launches) == (before[0] + 1, before[1])
    want = tba.bn_act_apply_reference(x, a, b, z, act=act, c_axis=c_axis)
    assert got.dtype == want.dtype == torch.bfloat16
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_bwd_bf16_kernel_matches_plain(cuda, shape, c_axis, act,
                                              want_g, offset):
    x, dy, (cg, mean, cx, c0) = _bn16(cuda, 1, shape, c_axis, offset)
    y = torch.relu(x + 0.1)
    before = tba.BN_ACT_BWD_BF16.launches
    dx, g = tba.bn_act_bwd_apply(y, dy, x, cg, mean, cx, c0, act=act,
                                 c_axis=c_axis, want_g=want_g)
    torch.cuda.synchronize()
    assert tba.BN_ACT_BWD_BF16.launches == before + 1
    want_dx, want_gv = tba.bn_act_bwd_reference(y, dy, x, cg, mean, cx, c0,
                                                act, c_axis, want_g)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, want_dx)
    if want_g:
        assert torch.equal(g, want_gv)


# the bf16 kernel 9 against its plain version, the AMP program's unfused
# chain (bf16 product, bias in the promoted dtype, act): the products are
# summed in another order, so a product may round the other way: every
# output within one bf16 ulp of its product (2^-7 |x @ w|) times the
# act's steepest slope (1.13, exact gelu), plus f32 noise and, for a bf16
# bias, the bf16 sum's own rounding
@pytest.mark.parametrize("bias_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("m,k,n", MM_SHAPES, ids=MM_IDS)
def test_matmul_bias_act_bf16_kernel_matches_plain(cuda, m, k, n, act,
                                                   bias_dtype):
    x, w, b = _mm_case(cuda, 0, m, k, n)
    x, w = x.bfloat16(), w.bfloat16()
    if bias_dtype == "bf16":
        b = b.bfloat16()
    before = (tme.MATMUL_BIAS_ACT_BF16.launches,
              tme.MATMUL_BIAS_ACT_F32.launches)
    got = tme.matmul_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert (tme.MATMUL_BIAS_ACT_BF16.launches,
            tme.MATMUL_BIAS_ACT_F32.launches) == (before[0] + 1, before[1])
    want = tme.matmul_bias_act_reference(x, w, b, act)
    assert got.shape == (m, n) and got.dtype == want.dtype == b.dtype
    prod = (x.float() @ w.float()).abs()
    bound = 1.13 * 2.0 ** -7 * prod + 1e-6 * want.float().abs() + 1e-7
    if bias_dtype == "bf16":
        bound = bound + 2.0 ** -8 * want.float().abs()
    assert torch.isfinite(got).all()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


# ==========================================================================
# the bf16 gelu (csrc/gelu_bf16.cu): bit for bit with its plain versions
# ==========================================================================
from paddle_tpu_torch.ops import gelu as tgelu  # noqa: E402


@pytest.mark.parametrize("shape", [(4096, 768), (1001, 37), (7,), (3, 5)],
                         ids=["wide", "ragged", "short", "tiny"])
def test_gelu_bf16_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, device=cuda, generator=gen) * 4).bfloat16()
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, 30.0, -30.0])
    dy = torch.randn(shape, device=cuda, generator=gen).bfloat16()
    before = (tgelu.GELU_FWD_BF16.launches, tgelu.GELU_BWD_BF16.launches)
    xr = x.clone().requires_grad_()
    y = tgelu.gelu_lowp(xr)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (tgelu.GELU_FWD_BF16.launches,
            tgelu.GELU_BWD_BF16.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, tgelu.gelu_bf16_reference(x))
    assert torch.equal(xr.grad, tgelu.gelu_bf16_grad_reference(x, dy))


def test_gelu_bf16_wrappers_raise_on_unsupported(cuda):
    x = torch.randn(8, 8, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="bfloat16"):
        tgelu.gelu_fwd_bf16(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        tgelu.gelu_fwd_bf16(x.t())
    with pytest.raises(ValueError, match="CUDA"):
        tgelu.gelu_bwd_bf16(x, x.cpu())


def test_layer_norm_bf16_on_the_card_matches_the_cpu(cuda):
    """The bf16 LayerNorm on the card (ATen's fused backward with f32
    statistics) against the CPU's spelled-out f32 path: the forward bit
    for bit but for the f32 statistics' summation order (within one bf16
    ulp of the largest output), the gradients within two."""
    from paddle_tpu_torch.ops.nn_ops import layer_norm_lowp

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 768, generator=gen) * 2 + 0.3).bfloat16()
    sc = 1 + 0.1 * torch.randn(768, generator=gen)
    bi = 0.1 * torch.randn(768, generator=gen)
    dy = torch.randn(64, 768, generator=gen).bfloat16()
    outs = {}
    for dev in ("cpu", "cuda"):
        xs, ss, bs = (t.detach().to(dev).requires_grad_()
                      for t in (x, sc, bi))
        y = layer_norm_lowp(xs, ss, bs, (768,))
        y.backward(dy.to(dev))
        outs[dev] = [t.detach().cpu() for t in (y, xs.grad, ss.grad,
                                                bs.grad)]
    for got, want, ulps in zip(outs["cuda"], outs["cpu"], (1, 2, 2, 2)):
        assert got.dtype == want.dtype
        assert _bf16_ulps(got, want) <= ulps


def test_resnet18_amp_on_the_card_launches_the_bf16_epilogue_kernels(cuda):
    """Two ResNet-18 steps at 32x32 under decorate(Momentum) through
    fluid.Executor(CUDAPlace(0)), NHWC and fusion at auto: each of the 17
    conv chains launches the bf16 kernels 7 and 8 once per step and the
    f32 ones never."""
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.tools.train_resnet import build_program, make_batch
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, acc1 = build_program(18, 32, 10, 0.1, amp=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    assert exe.fuse_enabled() and exe.nhwc_enabled(main)
    scope = Scope()
    exe.run(startup, scope=scope)
    img, label = make_batch(4, 32, 10)
    kfs = (tba.BN_ACT_APPLY_BF16, tba.BN_ACT_BWD_BF16, tba.BN_ACT_APPLY,
           tba.BN_ACT_BWD)
    before = [k.launches for k in kfs]
    losses = [float(exe.run(main, feed={"img": img, "label": label},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(2)]
    torch.cuda.synchronize()
    assert np.isfinite(losses).all()
    assert [k.launches - b for k, b in zip(kfs, before)] == [34, 34, 0, 0]
    assert all(t.device.type == "cuda" and t.dtype != torch.bfloat16
               for _, t in scope.items())


@pytest.mark.parametrize("model,chains", [("lenet", 2), ("word2vec", 1)])
def test_book_models_amp_on_the_card_launch_the_bf16_kernel_9(cuda, model,
                                                              chains):
    """Three AMP steps of each book model at a small batch: the bf16
    kernel 9 launches twice per fc chain per step and the f32 one never;
    the card's losses follow the CPU's from one startup scope (bf16
    products summed in two orders: rtol 2e-3)."""
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools import train_book as tb
    import paddle_tpu_torch.fluid as fluid

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dict(tb.DEFAULTS[model], batch=16)
    main, startup, fetch = tb.build_program(model, cfg, amp=True)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    feed = tb.make_batch(model, cfg)
    losses = {}
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        before = (tme.MATMUL_BIAS_ACT_BF16.launches,
                  tme.MATMUL_BIAS_ACT_F32.launches)
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=fetch[:1],
                                     scope=scope)[0]) for _ in range(3)]
        torch.cuda.synchronize()
        launched = (tme.MATMUL_BIAS_ACT_BF16.launches - before[0],
                    tme.MATMUL_BIAS_ACT_F32.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu"
                            else (2 * chains * 3, 0))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-3)
