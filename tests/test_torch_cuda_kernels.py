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
    # head dim 48 (no instantiated width, a multiple of 8) runs, as JAX's
    # kernel takes it; 44 and 264 do not
    case = list(_case(cuda, 1, 4, 2, 48, 8, 16, [5, 9]))
    got = tpa.paged_attention(*case)
    want = tpa.paged_attention_reference(*case)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL
    for d in (44, 264):
        case = list(_case(cuda, 1, 4, 2, d, 8, 16, [5, 9]))
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
    # head dim 96 runs (the next width, 128) and matches; 100 does not
    case, scales = _q_case(cuda, 4, torch.int8, 4, 2, 96, 8, 16, [5, 9])
    got = tpa.paged_attention(*case, None, *scales)
    want = tpa.paged_attention_reference(*case, None, *scales)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL
    # nothing below launches a kernel
    counts = (tpa.PAGED_DECODE_BF16.launches, tpa.PAGED_DECODE_INT8.launches)
    case, scales = _q_case(cuda, 4, torch.int8, 4, 2, 100, 8, 16, [5, 9])
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
    with pytest.raises(ValueError, match="float16"):    # mixed dtypes
        tfa.flash_fwd(q.half(), k.bfloat16(), v.half(), None, 0.1, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(2, 3), k, v, None, 0.1, False)
    # head dim 48 runs at the 64-wide tile and matches; 44 and 136 raise
    q48, k48, v48, _, _ = _flash_case(cuda, 3, 1, 2, 64, 64, 48, False)
    out, lse = tfa.flash_fwd(q48, k48, v48, None, 0.1, False)
    want, _ = tfa.flash_fwd_reference(q48, k48, v48, None, 0.1, False)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= ATOL
    for d in (44, 136):
        qd, kd, vd, _, _ = _flash_case(cuda, 3, 1, 2, 64, 64, d, False)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_fwd(qd, kd, vd, None, 0.1, False)
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
# the fp16 flash kernels against their fp16 plain versions: bf16's
# rounding points, fp16 subnormals kept; FP16_ULPS fp16 ulps (2^-10)
# ==========================================================================
FP16_ULPS = 4
FP16_KERNELS = (tfa.FLASH_FWD_FP16, tfa.FLASH_BWD_FUSED_FP16,
                tfa.FLASH_BWD_DQ_FP16, tfa.FLASH_BWD_DKV_FP16)


def _fp16_ok(got, want):
    assert got.dtype == torch.float16 and want.dtype == torch.float16
    tol = FP16_ULPS * 2.0 ** -10 * float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) <= tol


def _low_case(dev, seed, b, h, s, d, with_bias, dtype):
    q, k, v, do, bias = _flash_case(dev, seed, b, h, s, s, d, with_bias)
    return (*(t.to(dtype) for t in (q, k, v, do)), bias)


@pytest.mark.parametrize("s", [64, 200, 512, 1024])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal,with_bias,rate", [
    (False, True, 0.0), (True, False, 0.0), (False, True, 0.1)])
def test_flash_fp16_kernels_match_plain(cuda, s, d, causal, with_bias,
                                        rate):
    q, k, v, do, bias = _low_case(cuda, 200 + s + d, 2, 3, s, d, with_bias,
                                  torch.float16)
    scale = d ** -0.5
    seed = torch.tensor([98], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(2, 3, s, s, rate, seed) if rate else None
    kernels = FP16_KERNELS + BF16_KERNELS + F32_KERNELS
    before = [kf.launches for kf in kernels]
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    want_out, want_lse = tfa.flash_fwd_reference(q, k, v, bias, scale,
                                                 causal, rate, keep)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert _fp16_ok(out, want_out)
    assert float((lse - want_lse).abs().max()) <= ATOL
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, rate, keep)
    for grads in _fused_and_split(q, k, v, bias, out, lse, do, scale,
                                  causal, rate, seed if rate else None):
        torch.cuda.synchronize()
        for got, w in zip(grads, want):
            assert _fp16_ok(got, w)
    # the fp16 kernels ran, once each, and no bf16 or f32 kernel
    after = [kf.launches for kf in kernels]
    assert [a - b for a, b in zip(after, before)] == [1] * 4 + [0] * 8


def test_flash_fp16_subnormal_ds_matches_plain(cuda):
    """Small scores and a small dO put most of dS below fp16's smallest
    normal: the kernels keep its subnormals as the plain version does
    (a flush to zero would take dq and dk outside the tolerance)."""
    q, k, v, do, bias = _flash_case(cuda, 11, 2, 3, 512, 512, 64, True)
    q, k, do = 0.05 * q, 0.05 * k, 2e-3 * do
    q, k, v, do = (t.half() for t in (q, k, v, do))
    scale = 0.125
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, False)
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   False)
    p = torch.exp(tfa._scores(q, k, bias, scale, False) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - (do.float() * out.float()).sum(-1, keepdim=True))
          * scale).abs()
    assert float((ds[ds > 0] < 2.0 ** -14).float().mean()) > 0.5
    for grads in _fused_and_split(q, k, v, bias, out, lse, do, scale,
                                  False):
        torch.cuda.synchronize()
        for got, w in zip(grads, want):
            assert _fp16_ok(got, w)


def test_flash_fp16_and_f32_kernels_differ_by_an_fp16_rounding(cuda):
    q, k, v, do, bias = _low_case(cuda, 9, 2, 4, 512, 64, True,
                                  torch.float16)
    f32 = [t.float() for t in (q, k, v, do)]
    o16, l16 = tfa.flash_fwd(q, k, v, bias, 0.125, False)
    o32, l32 = tfa.flash_fwd(*f32[:3], bias, 0.125, False)
    g16 = tfa.flash_bwd(q, k, v, bias, o16, l16, do, 0.125, False)
    g32 = tfa.flash_bwd(*f32[:3], bias, o32, l32, f32[3], 0.125, False)
    torch.cuda.synchronize()
    for a, b in zip((o16, *g16), (o32, *g32)):
        diff = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        assert 2.0 ** -14 * scale < diff <= FP16_ULPS * 2.0 ** -10 * scale


@pytest.mark.parametrize("s,n_bwd", [(256, 1), (1024, 2)])
def test_flash_attention_front_launches_fp16_kernels(cuda, s, n_bwd):
    q, k, v, do, bias = _low_case(cuda, 10, 1, 2, s, 64, True, torch.float16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kernels = FP16_KERNELS + BF16_KERNELS + F32_KERNELS
    before = [kf.launches for kf in kernels]
    # under AMP the bias arrives in fp16; the front takes its f32 upcast
    out = tfa.flash_attention(q, k, v, bias=bias.half()[:, None, None],
                              dropout_rate=0.1, dropout_seed=torch.tensor(
                                  [3], dtype=torch.int64, device=cuda))
    out.backward(do)
    torch.cuda.synchronize()
    fwd, fused, dq, dkv, *rest = (kf.launches - n0 for kf, n0 in zip(
        kernels, before))
    assert fwd == 1 and fused + dq + dkv == n_bwd and rest == [0] * 8
    assert q.grad.dtype == torch.float16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "fp16"])
@pytest.mark.parametrize("d", [8, 40, 96, 120])
def test_flash_head_dims_match_plain(cuda, dtype, d):
    """Head dims that are no tile width run at the next one, with the
    real dim as the row stride: forward, fused and split backward."""
    q, k, v, do, bias = _low_case(cuda, 300 + d, 2, 3, 200, d, True, dtype)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, True)
    want_out, _ = tfa.flash_fwd_reference(q, k, v, bias, scale, True)
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale, True)
    grads = _fused_and_split(q, k, v, bias, out, lse, do, scale, True)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((out - want_out).abs().max()) <= ATOL
        for g in grads:
            for got, w in zip(g, want):
                torch.testing.assert_close(got, w, **GRAD_TOL)
    else:
        ok = _fp16_ok if dtype == torch.float16 else _bf16_ok
        assert ok(out, want_out)
        for g in grads:
            assert all(ok(got, w) for got, w in zip(g, want))


# the bf16 and fp16 kernels on the tensor cores (wgmma with TMA-fed
# tiles): the split pair, and the forward and the fused backward on the
# same cases: unequal and ragged lengths (TMA zero-fills rows past each
# head's end), head dims below the tile width (zero-filled columns), the
# dumped dropout mask, determinism (no atomics in the pair; the fused
# kernel sums dQ in a fixed order) and one launch of each kernel per call
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("sq,sk,d", [
    (200, 1000, 64), (1000, 200, 64), (577, 577, 64), (2048, 2048, 64),
    (1024, 1024, 40), (1024, 1024, 96), (1024, 1024, 120),
    (200, 500, 64), (500, 200, 64), (333, 333, 64), (512, 512, 64),
    (300, 300, 40), (300, 300, 96), (300, 300, 120)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_split_pair_low_matches_plain(cuda, dtype, sq, sk, d, causal,
                                            rate):
    b, h = 2, 2
    q, k, v, do, bias = _flash_case(cuda, sq + 3 * sk + d, b, h, sq, sk, d,
                                    True)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    scale = d ** -0.5
    seed = torch.tensor([97], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(b, h, sq, sk, rate, seed) if rate else None
    sd = seed if rate else None
    kernels = [tfa._KERNELS[dtype][n] for n in ("dq", "dkv", "fwd", "fused")]
    before = [kf.launches for kf in kernels]
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd)
    want_out, want_lse = tfa.flash_fwd_reference(q, k, v, bias, scale,
                                                 causal, rate, keep)
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, rate, keep)
    args = (q, k, v, bias, do, lse, (do.float() * out.float()).sum(-1),
            scale, causal, rate, sd)
    ok = _fp16_ok if dtype == torch.float16 else _bf16_ok
    grads = (tfa.bwd_dq(*args), *tfa.bwd_dkv(*args))
    fused = tfa.bwd_fused(*args)
    torch.cuda.synchronize()
    assert [kf.launches - n for kf, n in zip(kernels, before)] == [1] * 4
    assert ok(out, want_out)
    assert float((lse - want_lse).abs().max()) <= ATOL
    for got, w in zip(grads + fused, want + want):
        assert ok(got, w)
    again = (tfa.bwd_dq(*args), *tfa.bwd_dkv(*args), *tfa.bwd_fused(*args),
             *tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd))
    torch.cuda.synchronize()
    for got, g2 in zip(grads + fused + (out, lse), again):
        assert torch.equal(got, g2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_flash_split_pair_takes_unaligned_inputs(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary (TMA's base
    alignment) give what aligned copies give: the split pair, the forward
    and the fused backward."""
    b, h, s, d = 1, 2, 300, 64
    q, k, v, do, bias = _flash_case(cuda, 12, b, h, s, s, d, True)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    out, lse = tfa.flash_fwd(q, k, v, bias, 0.125, False)
    delta = (do.float() * out.float()).sum(-1)

    def shifted(t):   # the same values, 8 bytes into a larger buffer
        n = 8 // t.element_size()
        buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
        view = buf[n:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    want = (tfa.bwd_dq(q, k, v, bias, do, lse, delta, 0.125, False),
            *tfa.bwd_dkv(q, k, v, bias, do, lse, delta, 0.125, False),
            *tfa.bwd_fused(q, k, v, bias, do, lse, delta, 0.125, False),
            out, lse)
    moved = [shifted(t) for t in (q, k, v, do, lse, delta)]
    qs, ks, vs, dos, lses, deltas = moved
    got = (tfa.bwd_dq(qs, ks, vs, bias, dos, lses, deltas, 0.125, False),
           *tfa.bwd_dkv(qs, ks, vs, bias, dos, lses, deltas, 0.125, False),
           *tfa.bwd_fused(qs, ks, vs, bias, dos, lses, deltas, 0.125,
                          False),
           *tfa.flash_fwd(qs, ks, vs, bias, 0.125, False))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [8, 40, 96, 120, 160, 248])
def test_paged_decode_head_dims_match_plain(cuda, dtype, d):
    """Every pool dtype at head dims that are no instantiated width (int8
    at 8, 40, 120 and 248 takes 8-byte slices)."""
    if dtype == torch.float32:
        case = _case(cuda, d, 8, 2, d, 16, 256, [1, 16, 33, 250], 1)
        scales = ()
        fn = tpa.PAGED_DECODE
    else:
        case, scales = _q_case(cuda, d, dtype, 8, 2, d, 16, 256,
                               [1, 16, 33, 250, 0], 1)
        fn = (tpa.PAGED_DECODE_INT8 if dtype == torch.int8
              else tpa.PAGED_DECODE_BF16)
    before = fn.launches
    got = tpa.paged_attention(*case, None, *scales)
    want = tpa.paged_attention_reference(*case, None, *scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    live = case[4] > 0
    assert torch.isfinite(got).all()
    assert float((got[live] - want[live]).abs().max()) <= ATOL


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
    with pytest.raises(ValueError, match="float16"):   # no float64 kernel
        tba.bn_act_apply(x.double(), a.double(), b.double())
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
    with pytest.raises(NotImplementedError, match="fp16"):  # no float64
        tme.matmul_bias_act(x.double(), w.double(), b.double(), "relu")
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
# the bf16 and fp16 gelu (csrc/gelu_lowp.cu): bit for bit with their plain
# versions
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
    # the plain version on the CPU: on the card its exp (CUDA's expf) is a
    # rounding step off at x = -1.71875, where the kernels' table follows
    # the CPU's and JAX's correctly rounded exp
    assert torch.equal(y.cpu(), tgelu.gelu_bf16_reference(x.cpu()))
    assert torch.equal(xr.grad.cpu(),
                       tgelu.gelu_bf16_grad_reference(x.cpu(), dy.cpu()))


@pytest.mark.parametrize("shape", [(4096, 768), (1001, 37), (7,), (3, 5)],
                         ids=["wide", "ragged", "short", "tiny"])
def test_gelu_fp16_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, device=cuda, generator=gen) * 4).half()
    # zeros, saturation, and an fp16 subnormal input
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, 30.0, -3e-6])
    dy = torch.randn(shape, device=cuda, generator=gen).half()
    before = (tgelu.GELU_FWD_FP16.launches, tgelu.GELU_BWD_FP16.launches,
              tgelu.GELU_FWD_BF16.launches)
    xr = x.clone().requires_grad_()
    y = tgelu.gelu_lowp(xr)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (tgelu.GELU_FWD_FP16.launches, tgelu.GELU_BWD_FP16.launches,
            tgelu.GELU_FWD_BF16.launches) == (before[0] + 1, before[1] + 1,
                                              before[2])
    assert torch.equal(y, tgelu.gelu_fp16_reference(x))
    assert torch.equal(xr.grad, tgelu.gelu_fp16_grad_reference(x, dy))


def test_gelu_fp16_wrappers_raise_on_unsupported(cuda):
    x = torch.randn(8, 8, device=cuda).half()
    with pytest.raises(ValueError, match="float16"):
        tgelu.gelu_fwd_fp16(x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tgelu.gelu_bwd_fp16(x.t(), x)


def test_layer_norm_fp16_on_the_card_matches_the_cpu(cuda):
    """The fp16 LayerNorm (one rounding of ``* Scale + Bias``, as XLA's
    CPU does) runs the same f32 math on both devices: within one fp16
    ulp (2^-10) of the largest value (the f32 statistics' summation
    order), the gradients within two."""
    from paddle_tpu_torch.ops.nn_ops import layer_norm_lowp

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 768, generator=gen) * 2 + 0.3).half()
    sc = 1 + 0.1 * torch.randn(768, generator=gen)
    bi = 0.1 * torch.randn(768, generator=gen)
    dy = torch.randn(64, 768, generator=gen).half()
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
        tol = ulps * 2.0 ** -10 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol


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


# ==========================================================================
# static AMP in fp16 (decorate(use_fp16=True)): kernels 7 and 8 in fp16
# against their plain versions bit for bit ("" and relu and the backward:
# both round every multiply and add to fp16 in the Pallas kernels' order),
# sigmoid / tanh / gelu within one fp16 half-ulp (2^-11) of the largest
# output; Inf and NaN through as the plain versions give them, fp16
# subnormals kept; then kernel 9 in fp16
# ==========================================================================
def _as_fp16(t, offset):
    """An fp16 copy of ``t``, starting ``offset`` elements off 16-byte
    alignment when ``offset`` > 0."""
    if offset == 0:
        return t.half()
    buf = torch.empty(t.numel() + offset, dtype=torch.float16,
                      device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _fp16_case(dev, seed, shape, c_axis, offset=0, scale=1.0):
    x, z, vecs = _bn_case(dev, seed, shape, c_axis)
    return (_as_fp16(x * scale, offset), _as_fp16(z * scale, offset),
            [v.half() for v in vecs[:3]] + [vecs[3]])


def _fp16_half_ulps(got, want):
    return float((got.float() - want.float()).abs().max()) / (
        2.0 ** -11 * float(want.float().abs().max()))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_apply_fp16_kernel_matches_plain(cuda, shape, c_axis, act,
                                                with_z, offset):
    x, z, (a, b, _, _) = _fp16_case(cuda, 0, shape, c_axis, offset)
    z = z if with_z else None
    kfs = (tba.BN_ACT_APPLY_FP16, tba.BN_ACT_APPLY_BF16, tba.BN_ACT_APPLY)
    before = [k.launches for k in kfs]
    got = tba.bn_act_apply(x, a, b, z, act=act, c_axis=c_axis)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kfs, before)] == [1, 0, 0]
    want = tba.bn_act_apply_reference(x, a, b, z, act=act, c_axis=c_axis)
    assert got.dtype == want.dtype == torch.float16
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        assert _fp16_half_ulps(got, want) <= 1.0


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("shape,c_axis", BN_SHAPES, ids=BN_IDS)
def test_bn_act_bwd_fp16_kernel_matches_plain(cuda, shape, c_axis, act,
                                              want_g, offset):
    """dy loss-scaled (x 2^12), as the fp16 AMP backward hands it over."""
    x, dy, (cg, mean, cx, c0) = _fp16_case(cuda, 1, shape, c_axis, offset)
    dy = _as_fp16(dy.float() * 4096, offset)
    y = torch.relu(x + 0.1)
    kfs = (tba.BN_ACT_BWD_FP16, tba.BN_ACT_BWD_BF16, tba.BN_ACT_BWD)
    before = [k.launches for k in kfs]
    dx, g = tba.bn_act_bwd_apply(y, dy, x, cg, mean, cx, c0 * 4096, act=act,
                                 c_axis=c_axis, want_g=want_g)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kfs, before)] == [1, 0, 0]
    want_dx, want_gv = tba.bn_act_bwd_reference(y, dy, x, cg, mean, cx,
                                                c0 * 4096, act, c_axis,
                                                want_g)
    assert dx.dtype == torch.float16 and torch.equal(dx, want_dx)
    if want_g:
        assert torch.equal(g, want_gv)


@pytest.mark.parametrize("shape,c_axis", [((2, 16, 5, 8), 1),
                                          ((2, 5, 8, 16), 3),
                                          ((3, 7, 5, 3), 1)],
                         ids=["nchw", "nhwc", "ragged"])
def test_bn_act_fp16_kernels_keep_inf_nan_and_subnormals(cuda, shape,
                                                         c_axis):
    """Inf and NaN in, overflow to Inf, and fp16 subnormals: the kernels
    give exactly what the plain versions give (no saturation, no flush),
    on both the vector and the scalar paths."""
    x, z, (a, b, mean, c0) = _fp16_case(cuda, 3, shape, c_axis, 0)
    flat = x.view(-1)
    flat[0], flat[5], flat[9] = float("inf"), float("nan"), 60000.0
    flat[13], flat[17] = 3e-7, -5e-8            # subnormal inputs
    a = a.clone()
    a[0] = 4.0                                  # 60000 * 4 overflows
    tiny = torch.full_like(b, 2.0 ** -12)
    for act in ("", "relu", "sigmoid"):
        for zz in (None, z):
            got = tba.bn_act_apply(x, a, b, zz, act=act, c_axis=c_axis)
            want = tba.bn_act_apply_reference(x, a, b, zz, act=act,
                                              c_axis=c_axis)
            torch.cuda.synchronize()
            assert torch.equal(got.isnan(), want.isnan())
            ok = ~want.isnan()
            if act == "sigmoid":
                assert _fp16_half_ulps(got[ok], want[ok]) <= 1.0
            else:
                assert torch.equal(got[ok], want[ok])
    # x * 2^-12 lands among the fp16 subnormals for |x| < 2^-2
    got = tba.bn_act_apply(x, tiny, torch.zeros_like(b), act="",
                           c_axis=c_axis)
    want = tba.bn_act_apply_reference(x, tiny, torch.zeros_like(b), act="",
                                      c_axis=c_axis)
    torch.cuda.synchronize()
    sub = (want.abs() < 2.0 ** -14) & (want != 0)
    assert bool(sub.any()) and torch.equal(got[sub], want[sub])
    dy = torch.full_like(x, 30000.0)
    dy.view(-1)[2] = float("inf")
    y = torch.relu(x)
    for act in ("", "relu"):
        dx, g = tba.bn_act_bwd_apply(y, dy, x, a, mean, a, c0, act=act,
                                     c_axis=c_axis, want_g=True)
        rdx, rg = tba.bn_act_bwd_reference(y, dy, x, a, mean, a, c0, act,
                                           c_axis, True)
        torch.cuda.synchronize()
        assert bool(rdx.isinf().any())
        assert torch.equal(dx.isnan(), rdx.isnan())
        ok = ~rdx.isnan()
        assert torch.equal(dx[ok], rdx[ok]) and torch.equal(g.isnan(),
                                                            rg.isnan())
        assert torch.equal(g[~rg.isnan()], rg[~rg.isnan()])


@pytest.mark.parametrize("bias_dtype", ["f32", "fp16"])
@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("m,k,n", MM_SHAPES, ids=MM_IDS)
def test_matmul_bias_act_fp16_kernel_matches_plain(cuda, m, k, n, act,
                                                   bias_dtype):
    """The fp16 kernel 9 against the unfused chain (cuBLAS's fp16 product
    with f32 reductions, the bias, the act): every output within one fp16
    ulp of its product (2^-10 |x @ w|) plus the f32 accumulators' own
    difference (the K products added in two orders: 2^-18 |x| @ |w|,
    which at K = 4099 exceeds an fp16 ulp of a small product; measured
    1.5e-5 there), times the act's steepest slope, plus f32 noise; for an
    fp16 bias (an fp16 output) also the fp16 sum's rounding (a whole
    step of the pre-activation, 2^-10 |x @ w + b|: the two products one
    rounding apart can round the sum apart) through the act, and the
    act's own fp16 rounding."""
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    x, w, b = _mm_case(cuda, 0, m, k, n)
    x, w = x.half(), w.half()
    if bias_dtype == "fp16":
        b = b.half()
    kfs = (tme.MATMUL_BIAS_ACT_FP16, tme.MATMUL_BIAS_ACT_BF16,
           tme.MATMUL_BIAS_ACT_F32)
    before = [kf.launches for kf in kfs]
    got = tme.matmul_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert [kf.launches - c for kf, c in zip(kfs, before)] == [1, 0, 0]
    want = tme.matmul_bias_act_reference(x, w, b, act)
    assert got.shape == (m, n) and got.dtype == want.dtype == b.dtype
    prod = (x.float() @ w.float()).abs()
    acc = x.float().abs() @ w.float().abs()
    bound = (1.13 * (2.0 ** -10 * prod + 2.0 ** -18 * acc)
             + 1e-6 * want.float().abs() + 1e-7)
    if bias_dtype == "fp16":
        pre = (x.float() @ w.float() + b.float()).abs()
        bound = (bound + 1.13 * 2.0 ** -10 * pre
                 + 2.0 ** -11 * want.float().abs())
    assert torch.isfinite(got).all()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_matmul_bias_act_fp16_overflow_and_inf(cuda):
    """A product beyond 65504 is Inf before the bias (the unfused mul's
    fp16 output), with an f32 or an fp16 bias; an Inf operand gives what
    the plain version gives."""
    x = torch.full((70, 40), 64.0, dtype=torch.float16, device=cuda)
    w = torch.full((40, 9), 32.0, dtype=torch.float16, device=cuda)
    w[:, 0] = 0.5
    b = torch.linspace(-1, 1, 9, device=cuda)
    for bias in (b, b.half()):
        got = tme.matmul_bias_act(x, w, bias, "relu")
        want = tme.matmul_bias_act_reference(x, w, bias, "relu")
        torch.cuda.synchronize()
        assert torch.isinf(got[:, 1:]).all() and torch.isfinite(got[:, 0]).all()
        assert torch.equal(got, want)
    x[3, 7] = float("inf")
    got = tme.matmul_bias_act(x, w, b, "")
    want = tme.matmul_bias_act_reference(x, w, b, "")
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~want.isnan()], want[~want.isnan()])


def test_fp16_wrappers_raise_on_unsupported(cuda):
    x, z, (a, b, _, c0) = _fp16_case(cuda, 2, (2, 8, 4, 4), 1)
    with pytest.raises(ValueError, match="float16"):    # mixed dtypes
        tba.bn_act_apply(x, a.float(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tba.bn_act_apply(x.transpose(2, 3), a, b)
    with pytest.raises(ValueError, match="float32"):    # c0 stays f32
        tba.bn_act_bwd_apply(x, x, x, a, a, a, c0.half())
    xm, wm, bm = _mm_case(cuda, 1, 32, 48, 24)
    with pytest.raises(NotImplementedError, match="float16"):   # mixed
        tme.matmul_bias_act(xm.half(), wm, bm)
    with pytest.raises(NotImplementedError, match="float16"):   # bf16 bias
        tme.matmul_bias_act(xm.half(), wm.half(), bm.bfloat16())
    with pytest.raises(NotImplementedError, match="contiguous"):
        tme.matmul_bias_act(xm.half().t().contiguous().t(), wm.half(), bm)
    before = tme.MATMUL_BIAS_ACT_FP16.launches
    tme.matmul_bias_act(xm.half().cpu(), wm.half().cpu(), bm.cpu())
    assert tme.MATMUL_BIAS_ACT_FP16.launches == before


def test_resnet18_fp16_on_the_card_launches_the_fp16_epilogue_kernels(cuda):
    """Two ResNet-18 steps at 32x32 under decorate(Momentum,
    use_fp16=True), NHWC and fusion at auto: each of the 17 conv chains
    launches the fp16 kernels 7 and 8 once per step and the f32 and bf16
    ones never; the loss-scaling state stays on the card."""
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.tools.train_resnet import (build_program,
                                                     loss_scaling_state,
                                                     make_batch)
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, _ = build_program(18, 32, 10, 0.1,
                                           amp_dtype="float16")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    assert exe.fuse_enabled() and exe.nhwc_enabled(main)
    scope = Scope()
    exe.run(startup, scope=scope)
    img, label = make_batch(4, 32, 10)
    kfs = (tba.BN_ACT_APPLY_FP16, tba.BN_ACT_BWD_FP16,
           tba.BN_ACT_APPLY_BF16, tba.BN_ACT_BWD_BF16, tba.BN_ACT_APPLY,
           tba.BN_ACT_BWD)
    before = [k.launches for k in kfs]
    scale_name, found_name = loss_scaling_state(main)
    for _ in range(2):
        out = exe.run(main, feed={"img": img, "label": label},
                      fetch_list=[loss, scale_name, found_name], scope=scope)
        assert np.isfinite(out[0]).all() and out[1][0] > 0
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kfs, before)] == \
        [34, 34, 0, 0, 0, 0]
    assert scope.get(scale_name).device.type == "cuda"
    assert scope.get(found_name).dtype == torch.bool


@pytest.mark.parametrize("model,chains", [("lenet", 2), ("word2vec", 1)])
def test_book_models_fp16_on_the_card_launch_the_fp16_kernel_9(cuda, model,
                                                               chains):
    """Three fp16 AMP steps of each book model at a small batch: the fp16
    kernel 9 launches twice per fc chain per step and no other kernel 9;
    the card's losses follow the CPU's from one startup scope (fp16
    products summed in two orders: rtol 1e-3), and the scale and found-Inf
    history is the CPU's."""
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools import train_book as tb
    from paddle_tpu_torch.tools.train_resnet import loss_scaling_state
    import paddle_tpu_torch.fluid as fluid

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    cfg = dict(tb.DEFAULTS[model], batch=16)
    main, startup, fetch = tb.build_program(model, cfg, amp=True,
                                            amp_dtype="float16")
    scaling = list(loss_scaling_state(main))
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    feed = tb.make_batch(model, cfg)
    losses, history = {}, {}
    kfs = (tme.MATMUL_BIAS_ACT_FP16, tme.MATMUL_BIAS_ACT_BF16,
           tme.MATMUL_BIAS_ACT_F32)
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        before = [k.launches for k in kfs]
        outs = [exe.run(main, feed=feed, fetch_list=fetch[:1] + scaling,
                        scope=scope) for _ in range(3)]
        torch.cuda.synchronize()
        losses[dev] = [float(o[0]) for o in outs]
        history[dev] = [(float(o[1][0]), bool(o[2][0])) for o in outs]
        launched = [k.launches - b for k, b in zip(kfs, before)]
        assert launched == ([0, 0, 0] if dev == "cpu"
                            else [2 * chains * 3, 0, 0])
    assert history["cuda"] == history["cpu"]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


# ==========================================================================
# kernel 9 in bf16 and fp16 on wgmma: every variant (the TMA feed at 64 x
# 64, 128 x 128 and 128 x 256 tiles, the cp.async feed) at the tile edges,
# N = 84 and 16-byte-misaligned views, within the tolerances above
# ==========================================================================
LOW = {"bf16": torch.bfloat16, "fp16": torch.float16}
# (M, K, N) around the 64- and 128-row tiles, the 64-deep stages and the
# 128- and 256-wide column tiles; a K of 72 (one stage and a ragged
# second); LeNet's fc2 (N = 84: no tensor map)
TILE_EDGE_SHAPES = [(127, 128, 129), (128, 129, 127), (129, 127, 128),
                    (255, 256, 257), (256, 257, 255), (257, 255, 256),
                    (200, 72, 136), (256, 120, 84)]
TILE_EDGE_IDS = ["127-128-129", "128-129-127", "129-127-128", "255-256-257",
                 "256-257-255", "257-255-256", "k72", "lenet-fc2"]


def _low_bound(x, w, b, want, tag):
    """The bf16 and fp16 tests' tolerance above, per output."""
    prod = (x.float() @ w.float()).abs()
    if tag == "bf16":
        bound = 1.13 * 2.0 ** -7 * prod + 1e-6 * want.float().abs() + 1e-7
        if b.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -8 * want.float().abs()
        return bound
    acc = x.float().abs() @ w.float().abs()
    bound = (1.13 * (2.0 ** -10 * prod + 2.0 ** -18 * acc)
             + 1e-6 * want.float().abs() + 1e-7)
    if b.dtype == torch.float16:
        pre = (x.float() @ w.float() + b.float()).abs()
        bound = (bound + 1.13 * 2.0 ** -10 * pre
                 + 2.0 ** -11 * want.float().abs())
    return bound


def _low_mm_case(dev, seed, m, k, n, tag, bias_low, offset=0):
    x, w, b = _mm_case(dev, seed, m, k, n)
    dt = LOW[tag]
    if offset:   # views starting `offset` elements past 16-byte alignment
        x, w = (_as_fp16(t, offset).to(dt) if dt == torch.float16
                else _misaligned16(t, offset) for t in (x, w))
        assert x.data_ptr() % 16 and w.data_ptr() % 16
    else:
        x, w = x.to(dt), w.to(dt)
    return x, w, (b.to(dt) if bias_low else b)


@pytest.mark.parametrize("bias_low", [False, True], ids=["f32-bias",
                                                         "low-bias"])
@pytest.mark.parametrize("variant", list(tme.TC_VARIANTS))
@pytest.mark.parametrize("m,k,n", TILE_EDGE_SHAPES, ids=TILE_EDGE_IDS)
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_matmul_bias_act_low_variants_at_tile_edges(cuda, tag, m, k, n,
                                                    variant, bias_low):
    """Each variant that takes the shape (the TMA ones need K and N
    multiples of 8) against the plain version, gelu (the steepest act);
    a second call bit-equal to the first; one launch a call."""
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    kernel, kf = ((tme.matmul_bias_act_bf16, tme.MATMUL_BIAS_ACT_BF16)
                  if tag == "bf16" else
                  (tme.matmul_bias_act_fp16, tme.MATMUL_BIAS_ACT_FP16))
    if variant != "cp.async 64x64" and (k % 8 or n % 8):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernel(*_low_mm_case(cuda, 0, m, k, n, tag, bias_low), "gelu",
                   variant)
        return
    x, w, b = _low_mm_case(cuda, 0, m, k, n, tag, bias_low)
    before = kf.launches
    got = kernel(x, w, b, "gelu", variant)
    again = kernel(x, w, b, "gelu", variant)
    torch.cuda.synchronize()
    assert kf.launches == before + 2
    want = tme.matmul_bias_act_reference(x, w, b, "gelu")
    assert got.shape == (m, n) and got.dtype == want.dtype == b.dtype
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert bool(((got.float() - want.float()).abs()
                 <= _low_bound(x, w, b, want, tag)).all())


@pytest.mark.parametrize("bias_low", [False, True], ids=["f32-bias",
                                                         "low-bias"])
@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("m,k,n", [(255, 256, 257), (256, 120, 84),
                                   (2048, 64, 1056)],
                         ids=["255-256-257", "lenet-fc2", "a-wave"])
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_matmul_bias_act_low_every_act(cuda, tag, m, k, n, act, bias_low):
    """Every act through the front (``matmul_bias_act``, the variant
    ``tc_variant`` picks: cp.async, 64 x 64 TMA, the large TMA tile)."""
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    x, w, b = _low_mm_case(cuda, 1, m, k, n, tag, bias_low)
    got = tme.matmul_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    want = tme.matmul_bias_act_reference(x, w, b, act)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    assert bool(((got.float() - want.float()).abs()
                 <= _low_bound(x, w, b, want, tag)).all())


@pytest.mark.parametrize("m,k,n", [(129, 127, 128), (256, 400, 120),
                                   (300, 96, 200)],
                         ids=["129-127-128", "lenet-fc1", "tiles"])
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_matmul_bias_act_low_misaligned_views(cuda, tag, m, k, n):
    """x and w starting 2 bytes past a 16-byte boundary take the cp.async
    feed (element copies), with both bias dtypes."""
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    assert tme.tc_variant(m, n, k, False, False) == "cp.async 64x64"
    for bias_low in (False, True):
        x, w, b = _low_mm_case(cuda, 2, m, k, n, tag, bias_low, offset=1)
        got = tme.matmul_bias_act(x, w, b, "relu")
        torch.cuda.synchronize()
        want = tme.matmul_bias_act_reference(x, w, b, "relu")
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert bool(((got.float() - want.float()).abs()
                     <= _low_bound(x, w, b, want, tag)).all())


# ==========================================================================
# the gelu tables and kernels on every 16-bit input
# ==========================================================================
def _every16(dt, dev):
    return torch.arange(65536, dtype=torch.int32, device=dev).to(
        torch.int16).view(dt)


def _same16(got, want):
    """Bit for bit, NaN where the plain version has NaN."""
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_tables_match_the_plain_tables(cuda, tag):
    """The device-built tables (the kernels' own arithmetic, exp correctly
    rounded) equal ``gelu_table_reference`` (the plain ops on the CPU,
    JAX's values) bit for bit."""
    band = tgelu.gelu_tables(LOW[tag], cuda)
    assert torch.equal(band.cpu(), tgelu.gelu_table_reference(LOW[tag]))


def _plain_cpu(tag, x, dy=None):
    """The plain version on the CPU (JAX's values on every finite input)
    of the CUDA tensors x (and dy)."""
    if dy is None:
        fn = tgelu.gelu_bf16_reference if tag == "bf16" else \
            tgelu.gelu_fp16_reference
        return fn(x.cpu())
    fn = tgelu.gelu_bf16_grad_reference if tag == "bf16" else \
        tgelu.gelu_fp16_grad_reference
    return fn(x.cpu(), dy.cpu())


@pytest.mark.parametrize("copies", [1, 32], ids=["once", "32-shuffled"])
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_forward_every_input(cuda, tag, copies):
    """All 65,536 inputs (or 32 shuffled copies: 2^21 elements, 256 CTAs)
    bit for bit with the plain version."""
    dt = LOW[tag]
    x = _every16(dt, cuda).repeat(copies)
    x = x[torch.randperm(x.numel(), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))]
    kf = tgelu.GELU_FWD_BF16 if tag == "bf16" else tgelu.GELU_FWD_FP16
    before = kf.launches
    got = (tgelu.gelu_fwd_bf16 if tag == "bf16" else tgelu.gelu_fwd_fp16)(x)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    _same16(got.cpu(), _plain_cpu(tag, x))


@pytest.mark.parametrize("n_dy", [4, 16], ids=["4-dy", "16-dy"])
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_backward_every_input(cuda, tag, n_dy):
    """Every x with ``n_dy`` seeded dy each, bit for bit with the plain
    version."""
    dt = LOW[tag]
    x = _every16(dt, cuda).repeat(n_dy)
    dy = torch.tensor(np.random.RandomState(5).randn(x.numel()),
                      dtype=torch.float32, device=cuda).to(dt)
    kf = tgelu.GELU_BWD_BF16 if tag == "bf16" else tgelu.GELU_BWD_FP16
    before = kf.launches
    got = (tgelu.gelu_bwd_bf16 if tag == "bf16"
           else tgelu.gelu_bwd_fp16)(x, dy)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    _same16(got.cpu(), _plain_cpu(tag, x, dy))


@pytest.mark.parametrize("n", [4099, 2 ** 20 + 3], ids=["short", "long"])
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_kernels_take_misaligned_views(cuda, tag, n):
    """Inputs and outputs starting 2 bytes past a 16-byte boundary take
    the element-wise loops, bit for bit with the plain versions."""
    dt = LOW[tag]
    gen = torch.Generator(device=cuda).manual_seed(3)
    src = torch.randn(n, device=cuda, generator=gen) * 4
    x = _as_fp16(src, 1).to(dt) if dt == torch.float16 else \
        _misaligned16(src, 1)
    dys = torch.randn(n, device=cuda, generator=gen)
    dy = _as_fp16(dys, 1).to(dt) if dt == torch.float16 else \
        _misaligned16(dys, 1)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    fwd, bwd = ((tgelu.gelu_fwd_bf16, tgelu.gelu_bwd_bf16) if tag == "bf16"
                else (tgelu.gelu_fwd_fp16, tgelu.gelu_bwd_fp16))
    y, dx = fwd(x), bwd(x, dy)
    torch.cuda.synchronize()
    _same16(y.cpu(), _plain_cpu(tag, x))
    _same16(dx.cpu(), _plain_cpu(tag, x, dy))


# ==========================================================================
# the gelu plain versions run on the card: every 16-bit input, forward and
# backward, equal to the plain versions on the CPU (their exps are
# correctly rounded on every device)
# ==========================================================================
@pytest.mark.parametrize("tag", ["bf16", "fp16"])
def test_gelu_plain_version_on_the_card_equals_the_cpu(cuda, tag):
    dt = LOW[tag]
    x = _every16(dt, cuda).repeat(4)
    dy = torch.tensor(np.random.RandomState(11).randn(x.numel()),
                      dtype=torch.float32, device=cuda).to(dt)
    fwd, bwd = ((tgelu.gelu_bf16_reference, tgelu.gelu_bf16_grad_reference)
                if tag == "bf16" else
                (tgelu.gelu_fp16_reference, tgelu.gelu_fp16_grad_reference))
    _same16(fwd(x).cpu(), fwd(x.cpu()))
    _same16(bwd(x, dy).cpu(), bwd(x.cpu(), dy.cpu()))
    # where CUDA's f32 expf is 0.61 ulp off and erfc lands on a bf16 tie
    x0 = torch.tensor([-1.71875], dtype=dt, device=cuda)
    want = -0.0732421875 if tag == "bf16" else float(fwd(x0.cpu()))
    assert float(fwd(x0)) == want


# ==========================================================================
# kernel 9 in f32: every variant (128 x 128 and 32 x 64 tiles;
# 16- and 4-byte w copies) at its tile edges and LeNet's N = 84 and the
# ragged K = 517, with every act; two calls bit-identical
# ==========================================================================
def _f32_edge_shapes(variant):
    """(M, K, N) at the variant's tile tm x tn: M and K over 1, tm - 1, tm,
    tm + 1; N over 1, tn - 1, tn, tn + 1 for 4-byte w copies, and over
    multiples of 4 (4, tn - 4, tn, tn + 4) for 16-byte ones; then N = 84
    and K = 517."""
    tm, tn = (int(s) for s in variant.split()[0].split("x"))
    ns = ((4, tn - 4, tn, tn + 4, 84, 84) if variant.endswith("cp16")
          else (1, tn - 1, tn, tn + 1, 84, 263))
    return list(zip((1, tm - 1, tm, tm + 1, tm + 1, 2 * tm + 3),
                    (1, tm, tm + 1, tm - 1, 517, 517), ns))


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("act", MM_ACTS)
@pytest.mark.parametrize("variant", list(tme.F32_VARIANTS))
def test_matmul_bias_act_f32_variants_at_tile_edges(cuda, variant, act,
                                                    case):
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = _f32_edge_shapes(variant)[case]
    x, w, b = _mm_case(cuda, case, m, k, n)
    before = tme.MATMUL_BIAS_ACT_F32.launches
    got = tme.matmul_bias_act_f32(x, w, b, act, variant)
    again = tme.matmul_bias_act_f32(x, w, b, act, variant)
    torch.cuda.synchronize()
    assert tme.MATMUL_BIAS_ACT_F32.launches == before + 2
    want = tme.matmul_bias_act_reference(x, w, b, act)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **MM_TOL)
    assert torch.equal(got, again)


def test_matmul_bias_act_f32_variants_agree_bit_for_bit(cuda):
    """Every output is one fmaf chain over k in increasing order, then the
    bias and the act, whatever the tile: all variants give the same bits."""
    x, w, b = _mm_case(cuda, 5, 300, 517, 200)
    outs = [tme.matmul_bias_act_f32(x, w, b, "gelu", v)
            for v in tme.F32_VARIANTS]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_matmul_bias_act_f32_wide_copies_refuse_unaligned_w(cuda):
    x, w, b = _mm_case(cuda, 6, 64, 32, 83)
    before = tme.MATMUL_BIAS_ACT_F32.launches
    with pytest.raises(ValueError, match="cp16"):
        tme.matmul_bias_act_f32(x, w, b, "", "32x64 cp16")   # N % 4
    wide = torch.empty(32 * 84 + 1, device=cuda)[1:].view(32, 84)
    wide.copy_(torch.randn(32, 84, device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        tme.matmul_bias_act_f32(x, wide, torch.zeros(84, device=cuda), "",
                                "128x128 cp16")
    with pytest.raises(ValueError, match="variant"):
        tme.matmul_bias_act_f32(x, w, b, "", "16x16 cp4")
    assert tme.MATMUL_BIAS_ACT_F32.launches == before
    # the picker takes 4-byte copies for the misaligned view
    got = tme.matmul_bias_act_f32(x, wide, torch.zeros(84, device=cuda))
    torch.testing.assert_close(got, x @ wide, **MM_TOL)


# ==========================================================================
# paged decode over bf16 / int8 pages, split walk: contexts around the
# split boundaries, head dims 8-256 and groups 1-8 against the plain
# version; bit-identical calls, the tickets left zero, graph replay
# ==========================================================================
# (hq, hkv, d): groups 1, 2, 3, 4 and 8 over head dims 8 to 256
SPLIT_HEADS = [(2, 2, 8), (4, 2, 64), (12, 4, 96), (8, 2, 128), (8, 1, 256),
               (16, 2, 40), (6, 6, 64)]


def _run_q(dtype, case, scales):
    fn = tpa.paged_decode_int8 if dtype == torch.int8 else \
        tpa.paged_decode_bf16
    d = case[0].shape[-1]
    return fn(*case, d ** -0.5, *scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d", SPLIT_HEADS)
def test_paged_decode_split_boundaries_match_plain(cuda, dtype, hq, hkv, d):
    """Page 16, a table 32 pages wide: spans of 8 pages (128 tokens), 4
    splits; contexts of 1, span - 1, span, span + 1, the whole table, 0."""
    lens = [1, 127, 128, 129, 512, 0]
    case, scales = _q_case(cuda, 7, dtype, hq, hkv, d, 16, 64, lens)
    assert case[3].shape[1] == 32
    assert tpa.split_plan(case[0], case[1], case[3]) == (4, 8)
    fn = (tpa.PAGED_DECODE_INT8 if dtype == torch.int8
          else tpa.PAGED_DECODE_BF16)
    before = fn.launches
    got = _run_q(dtype, case, scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = tpa.paged_attention_reference(*case, None, *scales)
    live = case[4] > 0
    assert torch.isfinite(got).all()
    assert float((got[live] - want[live]).abs().max()) <= ATOL
    assert float(got[~live].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_decode_split_wide_batch_matches_plain(cuda, dtype):
    """64 sequences x 12 kv heads: the span doubles to 32 pages (2 splits
    of a 64-page table) to keep the grid within 12 CTAs an SM."""
    rng = np.random.RandomState(3)
    lens = rng.randint(1, 1025, 64).tolist()
    lens[:3] = [1024, 512, 513]
    case, scales = _q_case(cuda, 8, dtype, 12, 12, 64, 16, 4200, lens)
    assert tpa.split_plan(case[0], case[1], case[3]) == (2, 32)
    got = _run_q(dtype, case, scales)
    want = tpa.paged_attention_reference(*case, None, *scales)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_decode_split_is_deterministic_and_replays(cuda, dtype):
    """At the serving shape: two calls equal bit for bit, the stream's
    tickets all zero after them, and a CUDA graph of the call (warmed up
    on its capture stream) replayed three times equal to the eager call
    bit for bit, the capture stream's tickets zero after it."""
    case, scales = _q_case(cuda, 9, dtype, 12, 12, 64, 16, 1024,
                           [1024, 777, 512, 301, 64, 17], 2)
    eager = _run_q(dtype, case, scales)
    again = _run_q(dtype, case, scales)
    torch.cuda.synchronize()
    assert torch.equal(eager, again)
    key = (cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    assert int(tpa._TICKETS[key].abs().sum()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run_q(dtype, case, scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = _run_q(dtype, case, scales)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert int(tpa._TICKETS[(cuda.index or 0, side.cuda_stream)]
               .abs().sum()) == 0

