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
    args = (q, k, v, bias, do, lse, (do * out).sum(-1), scale, causal, rate,
            seed)
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
        tfa.flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), None, 0.1,
                      False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(2, 3), k, v, None, 0.1, False)
    q48, k48, v48, _, _ = _flash_case(cuda, 3, 1, 2, 64, 64, 48, False)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q48, k48, v48, None, 0.1, False)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_fwd(q, k, v, bias, 0.1, False, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q.cpu(), k.cpu(), v.cpu(), None, 0.1, False)
