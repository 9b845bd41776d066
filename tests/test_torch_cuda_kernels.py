"""PyTorch port, hand-written CUDA kernels on the card (marker ``cuda``).

Each test builds the kernel with ``nvcc`` from the sources in this
checkout and holds it against its plain PyTorch version on CUDA
tensors.  On a host without a CUDA device the tests skip.  The last
section holds the compiled step (CUDA-graph capture of a static step and
of the decode step) to its eager run.  Run them on the GPU, where JAX need not be installed, without the JAX-side
``conftest.py``: ``python -m pytest --noconftest
tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.utils import flags as tflags

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _eager_steps():
    """The kernel tests hold the eager path, op by op
    (``FLAGS_cuda_step_session=0``), on which their launch counts and
    per-op traces were first taken.  The compiled step's own tests (at
    the end) set the flag themselves, and hold a replayed step's launches
    to an eager step's."""
    tflags.set_flags({"FLAGS_cuda_step_session": "0"})
    yield
    tflags._SET.pop("FLAGS_cuda_step_session", None)

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


# the split pair in every dtype (bf16 and fp16 on the tensor cores,
# wgmma with TMA-fed tiles; f32 register-tiled SIMT over a cp.async ring),
# and the forward and the fused backward on the same cases: unequal and
# ragged lengths (rows past each head's end arrive as zeros), head dims
# below the tile width (zero-filled columns), the dumped dropout mask,
# determinism (no atomics in the pair; the fused kernel sums dQ in a fixed
# order) and one launch of each kernel per call; f32 within ATOL (the
# forward) and GRAD_TOL (the gradients), as test_flash_kernels_match_plain
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "fp16"])
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
    grads = (tfa.bwd_dq(*args), *tfa.bwd_dkv(*args))
    fused = tfa.bwd_fused(*args)
    torch.cuda.synchronize()
    assert [kf.launches - n for kf, n in zip(kernels, before)] == [1] * 4
    assert float((lse - want_lse).abs().max()) <= ATOL
    if dtype == torch.float32:
        assert float((out - want_out).abs().max()) <= ATOL
        for got, w in zip(grads + fused, want + want):
            torch.testing.assert_close(got, w, **GRAD_TOL)
    else:
        ok = _fp16_ok if dtype == torch.float16 else _bf16_ok
        assert ok(out, want_out)
        for got, w in zip(grads + fused, want + want):
            assert ok(got, w)
    again = (tfa.bwd_dq(*args), *tfa.bwd_dkv(*args), *tfa.bwd_fused(*args),
             *tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd))
    torch.cuda.synchronize()
    for got, g2 in zip(grads + fused + (out, lse), again):
        assert torch.equal(got, g2)


# The f32 forward and fused backward at the edges of the fused kernel's
# kv-tile CTAs (128 keys up to head dim 64, 64 above; one CTA stores dQ
# itself, more sum their shares through a scratch and a second launch): sk
# 65, 448, 512, 513 and 1024, ragged sq != sk, causal, head dims 40 / 96 /
# 120 and dropout 0.1 against the dumped mask; f32 within ATOL (the
# forward) and GRAD_TOL (the gradients), one launch of each kernel a call,
# and a second call the same bits
@pytest.mark.parametrize("sq,sk", [(65, 65), (448, 448), (512, 512),
                                   (513, 513), (1024, 1024), (100, 513),
                                   (513, 100), (300, 1024)])
@pytest.mark.parametrize("d", [40, 64, 96, 120])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_f32_forward_and_fused_at_tile_edges(cuda, sq, sk, d, causal,
                                                   rate):
    b, h = 2, 3
    q, k, v, do, bias = _flash_case(cuda, 7 * sq + sk + d, b, h, sq, sk, d,
                                    True)
    scale = d ** -0.5
    seed = torch.tensor([31], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(b, h, sq, sk, rate, seed) if rate else None
    sd = seed if rate else None
    kernels = (tfa.FLASH_FWD, tfa.FLASH_BWD_FUSED)
    before = [kf.launches for kf in kernels]
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd)
    args = (q, k, v, bias, do, lse, (do * out).sum(-1), scale, causal, rate,
            sd)
    fused = tfa.bwd_fused(*args)
    want_out, want_lse = tfa.flash_fwd_reference(q, k, v, bias, scale,
                                                 causal, rate, keep)
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, rate, keep)
    torch.cuda.synchronize()
    assert [kf.launches - n for kf, n in zip(kernels, before)] == [1, 1]
    assert float((out - want_out).abs().max()) <= ATOL
    assert float((lse - want_lse).abs().max()) <= ATOL
    for got, w in zip(fused, want):
        torch.testing.assert_close(got, w, **GRAD_TOL)
    again = (*tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd),
             *tfa.bwd_fused(*args))
    torch.cuda.synchronize()
    for got, g2 in zip((out, lse) + fused, again):
        assert torch.equal(got, g2)


# The f32 fused backward's scratch: one (b, h, sq, d) slice a kv-tile CTA
# (128 keys up to head dim 64, 64 above), as many as 256 MiB holds but at
# least 4, none for one CTA
@pytest.mark.parametrize("b,h,sq,sk,d,parts", [
    (2, 3, 512, 1, 8, 0), (2, 3, 512, 128, 64, 0), (2, 3, 512, 129, 64, 2),
    (1, 1, 64, 65, 120, 2), (44, 12, 512, 512, 64, 4),
    (44, 12, 512, 512, 128, 4), (2, 12, 2048, 2048, 64, 16),
    (4, 16, 1024, 1024, 128, 8), (8, 12, 8192, 8192, 64, 4),
    (2, 3, 100, 4096, 40, 32)])
def test_fused_f32_scratch_parts(cuda, b, h, sq, sk, d, parts):
    assert tfa._fused_f32_parts(b, h, sq, sk, d) == parts


# Where the scratch holds fewer shares than a (b, h) has kv-tile CTAs,
# they run in launches, each summed onto dQ: the plain version's
# gradients within GRAD_TOL, and a second call the same bits
@pytest.mark.parametrize("d", [120, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_f32_fused_in_launches(cuda, d, causal, rate):
    b, h, s = 4, 16, 1024
    assert tfa._fused_f32_parts(b, h, s, s, d) == 8   # of 16 CTAs
    q, k, v, do, bias = _flash_case(cuda, 11 * d + causal, b, h, s, s, d,
                                    True)
    scale = d ** -0.5
    seed = torch.tensor([5], dtype=torch.int64, device=cuda)
    keep = tfa.flash_dropout_mask(b, h, s, s, rate, seed) if rate else None
    sd = seed if rate else None
    out, lse = tfa.flash_fwd(q, k, v, bias, scale, causal, rate, sd)
    args = (q, k, v, bias, do, lse, (do * out).sum(-1), scale, causal, rate,
            sd)
    fused = tfa.bwd_fused(*args)
    want = tfa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                   causal, rate, keep)
    for got, w in zip(fused, want):
        torch.testing.assert_close(got, w, **GRAD_TOL)
    again = tfa.bwd_fused(*args)
    torch.cuda.synchronize()
    for got, g2 in zip(fused, again):
        assert torch.equal(got, g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "fp16"])
def test_flash_split_pair_takes_unaligned_inputs(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary (TMA's base
    alignment, and the f32 pair's 16-byte cp.async) give what aligned
    copies give: the split pair, the forward and the fused backward."""
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


def test_mobilenet_small_on_the_card_matches_the_cpu_port(cuda):
    """MobileNetV3-small f32 on the PaddleClas recipe (L2 decay, the
    warm-up into a cosine in the program) at 32x32, batch 4, 10 classes:
    3 steps on the card (fused: per step kernels 7-8 once for each of
    the 6 relu chains, kernel 9 twice for each of the 9 squeeze-excite
    fcs, its forward and its grad's replay of the pre-activation) and on
    the CPU port (plain ops) from one startup scope; step 1's
    loss within 1e-5 relative (the forward alone: cuDNN's and oneDNN's
    f32 sums in other orders), every loss finite."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools.train_mobilenet import build_program
    from paddle_tpu_torch.tools.train_resnet import (make_batch,
                                                     set_card_precision)

    set_card_precision()
    main, startup, loss, _ = build_program("small", 32, 10, amp=False)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    img, label = make_batch(4, 32, 10)
    before = (tba.BN_ACT_APPLY.launches, tba.BN_ACT_BWD.launches,
              tme.MATMUL_BIAS_ACT_F32.launches)
    losses = {}
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = [float(exe.run(main, feed={"img": img,
                                                 "label": label},
                                     fetch_list=[loss], scope=scope)[0])
                       for _ in range(3)]
    torch.cuda.synchronize()
    assert np.isfinite(losses["cuda"]).all()
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= \
        1e-5 * abs(losses["cpu"][0]), losses
    assert (tba.BN_ACT_APPLY.launches - before[0],
            tba.BN_ACT_BWD.launches - before[1],
            tme.MATMUL_BIAS_ACT_F32.launches - before[2]) == (18, 18, 54)


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
# paged decode, split walk, over every page dtype: contexts around the
# split boundaries, head dims 8-256 and groups 1-8 against the plain
# version; bit-identical calls, the tickets left zero, graph replay;
# tables wider than 8,192 pages
# ==========================================================================
# (hq, hkv, d): groups 1, 2, 3, 4 and 8 over head dims 8 to 256
SPLIT_HEADS = [(2, 2, 8), (4, 2, 64), (12, 4, 96), (8, 2, 128), (8, 1, 256),
               (16, 2, 40), (6, 6, 64)]
PAGE_DTYPES = dict(argnames="dtype",
                   argvalues=[torch.float32, torch.bfloat16, torch.int8],
                   ids=["f32", "bf16", "int8"])
#: each page dtype's wrapper and its launch count
WRAPPERS = {torch.float32: (tpa.paged_decode, tpa.PAGED_DECODE),
            torch.bfloat16: (tpa.paged_decode_bf16, tpa.PAGED_DECODE_BF16),
            torch.int8: (tpa.paged_decode_int8, tpa.PAGED_DECODE_INT8)}


def _run_q(dtype, case, scales):
    d = case[0].shape[-1]
    return WRAPPERS[dtype][0](*case, d ** -0.5, *scales)


@pytest.mark.parametrize(**PAGE_DTYPES)
@pytest.mark.parametrize("hq,hkv,d", SPLIT_HEADS)
def test_paged_decode_split_boundaries_match_plain(cuda, dtype, hq, hkv, d):
    """Page 16, a table 32 pages wide: spans of 8 pages (128 tokens), 4
    splits; contexts of 1, span - 1, span, span + 1, the whole table, 0."""
    lens = [1, 127, 128, 129, 512, 0]
    case, scales = _q_case(cuda, 7, dtype, hq, hkv, d, 16, 64, lens)
    assert case[3].shape[1] == 32
    assert tpa.split_plan(case[0], case[1], case[3]) == (4, 8)
    fn = WRAPPERS[dtype][1]
    before = fn.launches
    got = _run_q(dtype, case, scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = tpa.paged_attention_reference(*case, None, *scales)
    live = case[4] > 0
    assert torch.isfinite(got).all()
    assert float((got[live] - want[live]).abs().max()) <= ATOL
    assert float(got[~live].abs().max()) == 0.0


@pytest.mark.parametrize(**PAGE_DTYPES)
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


@pytest.mark.parametrize(**PAGE_DTYPES)
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


@pytest.mark.parametrize(**PAGE_DTYPES)
def test_paged_decode_takes_a_table_wider_than_8192_pages(cuda, dtype):
    """16,384 one-token pages, d 8: a 9,000-token context walks 71 of 128
    spans of 128 pages, against the plain version; the wrappers no
    longer refuse such a width."""
    case, scales = _q_case(cuda, 10, dtype, 4, 2, 8, 1, 16384, [9000, 3])
    assert case[3].shape[1] == 16384
    assert tpa.split_plan(case[0], case[1], case[3]) == (128, 128)
    fn = WRAPPERS[dtype][1]
    before = fn.launches
    got = _run_q(dtype, case, scales)
    want = tpa.paged_attention_reference(*case, None, *scales)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize(**PAGE_DTYPES)
def test_paged_decode_capped_span_matches_plain(cuda, dtype, monkeypatch):
    """With the span's cap at 2 pages, a 32-page table takes 16 splits
    (the path a table wider than 8,192 x 12 CTAs an SM takes): contexts
    of 0 to the whole table against the plain version, bit-identical
    calls, the tickets left zero."""
    monkeypatch.setattr(tpa, "_MAX_SPAN", 2)
    case, scales = _q_case(cuda, 11, dtype, 8, 2, 64, 16, 64,
                           [1, 31, 32, 33, 127, 512, 0])
    assert tpa.split_plan(case[0], case[1], case[3]) == (16, 2)
    got = _run_q(dtype, case, scales)
    again = _run_q(dtype, case, scales)
    want = tpa.paged_attention_reference(*case, None, *scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    key = (cuda.index or 0, torch.cuda.current_stream().cuda_stream)
    assert int(tpa._TICKETS[key].abs().sum()) == 0
    live = case[4] > 0
    assert float((got[live] - want[live]).abs().max()) <= ATOL
    assert float(got[~live].abs().max()) == 0.0


# ==========================================================================
# the compiled step (FLAGS_cuda_step_session): a static step and the
# decode step captured in CUDA graphs, held to their eager runs bit for
# bit (paddle_tpu_torch/tools/check_step_capture.py)
# ==========================================================================
@pytest.fixture
def capture(cuda):
    from paddle_tpu_torch.tools import check_step_capture as csc
    from paddle_tpu_torch.tools.train_resnet import set_card_precision

    set_card_precision()
    tflags._SET.pop("FLAGS_cuda_step_session", None)     # auto: on
    return csc


@pytest.mark.parametrize("case", ["resnet18-f32", "resnet18-bf16",
                                  "resnet18-fp16", "lenet", "word2vec"])
def test_captured_static_steps_equal_eager_steps(capture, case):
    """Four steps from one startup state, op by op and through the step
    session (warm-up, capture, two replays): the same fetches and scope
    state bit for bit, one graph; fp16 finds an Inf in a step."""
    row = capture.compare_static(case, steps=4)
    assert row["ok"], row


def test_captured_mobilenet_steps_equal_eager_with_the_schedule(capture):
    """MobileNetV3-small under ``decorate`` (bf16): three steps op by op
    and captured (warm-up, capture, replay) give the same fetches and
    state bit for bit, the rate (computed in the program from the step
    counter) among the fetches and new at every step, the counter among
    the state."""
    row = capture.compare_static("mobilenet-bf16", steps=3)
    assert row["ok"], row
    assert len(set(row["rates"])) == 3


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_captured_decode_equals_eager_decode(capture, kv_dtype):
    row = capture.compare_decode(kv_dtype)
    assert row["ok"], row


def test_captured_decode_with_prefix_cache_and_chunks(capture):
    """Forks stay eager ahead of the replay; chunked prefill stays eager."""
    row = capture.compare_decode("int8", n_requests=5, prefix_cache=True,
                                 prefill_chunk=8)
    assert row["ok"], row


def test_scope_set_recaptures_and_a_new_shape_adds_a_graph(capture):
    """Also switches back to the first shape's graph (A, B, A)."""
    row = capture.check_invalidation()
    assert row["ok"], row


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_decode_buckets_8_then_4_then_8_equal_eager(capture, kv_dtype):
    """Graphs of one pool, replayed out of their capture order."""
    row = capture.check_bucket_switch(kv_dtype)
    assert row["ok"], row


def test_a_replay_launches_each_kernel_as_an_eager_step(capture):
    """LeNet f32 (kernel 9) and the f32 decode step (kernel 6): the
    launch counts per step, op by op and replayed, are equal and not 0."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.inference.serving import (DecoderConfig, Request,
                                                    ServingEngine,
                                                    init_decoder_weights)
    from paddle_tpu_torch.ops import matmul_epilogue as me

    main, startup, fetch, feed = capture._build(
        capture.STATIC_CASES["lenet"])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = Scope()
    exe.run(startup, scope=scope)

    def static_step():
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    kernels = {"mm": me.MATMUL_BIAS_ACT_F32, "paged": tpa.PAGED_DECODE}
    eager = capture.launches_per_step(static_step, kernels, "0")
    replayed = capture.launches_per_step(static_step, kernels, "1")
    assert eager == replayed and eager["mm"] > 0 and eager["paged"] == 0
    assert exe.graphs_captured == 1

    cfg = DecoderConfig(**capture.SMALL_DECODER)
    eng = ServingEngine(cfg, init_decoder_weights(cfg, 0), num_pages=64,
                        page_size=8, max_batch=4, device="cuda")
    for i in range(3):
        eng.submit(Request(i, list(range(1, 10 + i)), 30))
    eng.step()                                   # prefill
    eager = capture.launches_per_step(eng.step, kernels, "0")
    replayed = capture.launches_per_step(eng.step, kernels, "1")
    assert eager == replayed == {"mm": 0, "paged": cfg.num_layers}


def test_a_dead_scopes_session_is_dropped(capture):
    """One executor, a new scope per run: the sessions of dead scopes
    (their graphs and bound state) leave the executor."""
    import gc

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import Scope, load_numpy_state

    main, startup, fetch, feed = capture._build(
        capture.STATIC_CASES["lenet"])
    state = capture._startup_state(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    for _ in range(3):
        scope = Scope()
        load_numpy_state(scope, state, "cuda")
        for _ in range(3):                       # warm-up, capture, replay
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        assert len(exe._sessions) == 1
        del scope
        gc.collect()
        assert len(exe._sessions) == 0
    assert exe.graphs_captured == 3


def test_dropout_draws_a_new_mask_on_each_replay(capture):
    row = capture.check_dropout()
    assert row["ok"], row


def test_seeded_random_op_raises_under_capture(capture):
    row = capture.check_raises()
    assert row["ok"], row


def test_host_sync_op_raises_under_capture_and_the_card_recovers(capture):
    """An op whose lowering reads a value back (``.item()``) cannot be
    captured: the second run raises StepCaptureError naming its type,
    and nothing runs eagerly in its place; afterwards the card runs
    other steps, eagerly and captured."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.cuda_graph import StepCaptureError
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.ops import registry

    def host_read(ctx):
        x = ctx.in_("X")
        ctx.set_out("Out", x * float(x.sum().item()))

    registry.op("test_host_read")(host_read)
    try:
        with unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", [4])
                blk = main.global_block()
                out = blk.create_var(name="read_out", dtype="float32")
                blk.append_op("test_host_read", inputs={"X": [x]},
                              outputs={"Out": [out]})
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = Scope()
        feed = {"x": np.ones((2, 4), np.float32)}
        first = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        assert (first == 8.0).all()
        with pytest.raises(StepCaptureError, match="test_host_read"):
            exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        assert exe.graphs_captured == 0
    finally:
        registry.OPS.pop("test_host_read", None)
    torch.cuda.synchronize()
    assert capture.compare_static("lenet", steps=3)["ok"]


def test_trace_ops_needs_the_eager_path(capture):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import Scope

    main, startup, fetch, feed = capture._build(
        capture.STATIC_CASES["lenet"])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = Scope()
    exe.run(startup, scope=scope)
    exe.trace_ops = True
    with pytest.raises(ValueError, match="FLAGS_cuda_step_session=0"):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_staged_feeds_drive_captured_steps(capture, double_buffer):
    """LeNet over four batches staged by ``double_buffered_feeds`` (pinned
    memory, the stager's stream) through the step session: the same
    losses and state, bit for bit, as eager steps on the raw batches."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.executor import FeedStager, double_buffered_feeds
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools import train_book as tb

    main, startup, fetch, _ = capture._build(capture.STATIC_CASES["lenet"])
    state = capture._startup_state(startup)
    cfg = dict(tb.DEFAULTS["lenet"], batch=16)
    batches = [tb.make_batch("lenet", cfg, seed=i) for i in range(4)]
    with capture.deterministic():
        want, want_state, _ = capture._steps(main, state, batches, fetch, "0")
        tflags.set_flags({"FLAGS_cuda_double_buffer": double_buffer})
        scope = Scope()
        load_numpy_state(scope, state, "cuda")
        exe = fluid.Executor(fluid.CUDAPlace(0))
        stager = FeedStager(main, batches[0], fluid.CUDAPlace(0))
        got = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
               for f in double_buffered_feeds(batches, stager)]
        torch.cuda.synchronize()
    tflags._SET.pop("FLAGS_cuda_double_buffer", None)
    assert exe.graphs_captured == 1
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got_state = numpy_state(scope, [n for n, _ in scope.items()])
    for n, v in want_state.items():
        np.testing.assert_array_equal(got_state[n], v, err_msg=n)


# ==========================================================================
# sampled decoding on the card: the hash draws and the captured head
# ==========================================================================
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_captured_sampled_decode_equals_eager(capture, kv_dtype):
    """A sampled engine's decode steps captured (the lanes in the bucket's
    input block, ``sample_token`` in the graph) equal its eager steps:
    tokens, pools and scales bit for bit."""
    from paddle_tpu_torch.inference.spec_decode import SamplingParams

    row = capture.compare_decode(kv_dtype, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.95))
    assert row["ok"], row


def test_sample_token_draws_on_the_card_equal_the_cpu(cuda):
    """The hash of (lane, column) is the same bits on both devices, and so
    are the draws at GPT-2's vocabulary under every filter."""
    from paddle_tpu_torch.ops.sampling_ops import lane_hash, sample_token

    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(16, 50257) * 3).astype(np.float32))
    lanes = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, size=16)
                             .astype(np.int32))
    assert torch.equal(lane_hash(lanes.to(cuda), 50257).cpu(),
                       lane_hash(lanes, 50257))
    for params in ((0.8, 50, 0.95), (1.0, 0, 1.0), (0.7, 0, 0.9),
                   (1.3, 5, 1.0), (0.6, 1, 1.0), (0.0, 0, 1.0)):
        want = sample_token(logits, lanes, *params)
        got = sample_token(logits.to(cuda), lanes.to(cuda), *params)
        assert torch.equal(got.cpu(), want), params
