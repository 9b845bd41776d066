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
    with pytest.raises(ValueError, match="float32"):
        tba.bn_act_apply(x.bfloat16(), a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tba.bn_act_apply(x.transpose(2, 3), a, b)
    with pytest.raises(ValueError, match="shape"):
        tba.bn_act_apply(x, a[:4].contiguous(), b)
    with pytest.raises(ValueError, match="shape"):
        tba.bn_act_apply(x, a, b, z=z[:1])
    with pytest.raises(ValueError, match="float32"):
        tba.bn_act_bwd_apply(x.bfloat16(), x.bfloat16(), x.bfloat16(), a, a,
                             a, a)
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
    with the fusion flag at auto: each of the 17 conv chains launches
    kernel 7 once per step and kernel 8 once per step."""
    from paddle_tpu_torch.framework.scope import Scope
    from paddle_tpu_torch.tools.train_resnet import build_program, make_batch
    import paddle_tpu_torch.fluid as fluid

    torch.backends.cudnn.allow_tf32 = False
    main, startup, loss, acc1 = build_program(18, 32, 10, 0.1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    assert exe.fuse_enabled()
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
