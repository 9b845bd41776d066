"""PyTorch port, the conv-epilogue kernels' plain versions
(``paddle_tpu_torch/ops/bn_act.py``) against the JAX package's Pallas
kernels (``pallas_kernels.bn_act_apply`` / ``bn_act_bwd_apply``) run in
interpret mode on the CPU, as ``tests/test_fused_epilogue.py`` runs them.

Where the Pallas kernel does not engage (its TPU tiling gates: ``c % 8``,
block-divisible extents) the JAX function returns None and the op runs
its jnp composition; that composition is then the reference.  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: rtol 1e-6 / atol 1e-6 everywhere, the same sums in f32 with
XLA free to contract a multiply and an add into one FMA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import bn_act as ba

TOL = dict(rtol=1e-6, atol=1e-6)

#: (shape, channel axis): Pallas-tileable NCHW and NHWC, ragged ones
#: (C = 37, extents no block divides), 2-D channels-last
SHAPES = [((2, 16, 16, 16), 1), ((2, 4, 4, 16), 3), ((3, 37, 13, 11), 1),
          ((3, 13, 11, 37), 3), ((6, 24), 1)]
SHAPE_IDS = ["nchw", "nhwc", "nchw-ragged", "nhwc-ragged", "mc"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")


def _arrays(seed, shape, c_axis):
    rng = np.random.RandomState(seed)
    c = shape[c_axis]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            [rng.randn(c).astype(np.float32) for _ in range(4)])


def _jax_fwd(x, a, b, z, act, c_axis):
    xj, aj, bj = jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)
    zj = None if z is None else jnp.asarray(z)
    out = pk.bn_act_apply(xj, aj, bj, z=zj, act=act, c_axis=c_axis)
    if out is None:   # the op's jnp composition (fused_ops.py:484-488)
        shape = [1] * x.ndim
        shape[c_axis] = x.shape[c_axis]
        out = xj * aj.reshape(shape) + bj.reshape(shape)
        if zj is not None:
            out = out + zj
        out = pk.apply_act(out, act)
    return np.asarray(out)


@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_forward_plain_matches_jax(interpret, shape, c_axis, with_z, act):
    x, z, (a, b, _, _) = _arrays(0, shape, c_axis)
    z = z if with_z else None
    want = _jax_fwd(x, a, b, z, act, c_axis)
    got = ba.bn_act_apply(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b),
                          None if z is None else torch.from_numpy(z),
                          act=act, c_axis=c_axis)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tileable_shapes_run_the_pallas_kernel(interpret):
    """The first two shapes do reach the Pallas kernel in interpret mode
    (so the comparison above is against the kernel, not only against
    the fallback)."""
    for (shape, c_axis) in SHAPES[:2]:
        x, _, (a, b, cg, m) = _arrays(1, shape, c_axis)
        assert pk.bn_act_apply(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                               act="relu", c_axis=c_axis) is not None
        assert pk.bn_act_bwd_apply(
            jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jnp.asarray(cg),
            jnp.asarray(m), jnp.asarray(a), jnp.asarray(b), act="relu",
            c_axis=c_axis) is not None


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_backward_plain_matches_jax(interpret, shape, c_axis, want_g, act):
    x, dy, (cg, mean, cx, c0) = _arrays(2, shape, c_axis)
    y = np.maximum(x + 0.1, 0.0).astype(np.float32)
    j = pk.bn_act_bwd_apply(*(jnp.asarray(v) for v in (y, dy, x, cg, mean,
                                                       cx, c0)),
                            act=act, c_axis=c_axis, want_g=want_g)
    if j is None:   # the op's jnp composition (fused_ops.py:549-556)
        shape_b = [1] * x.ndim
        shape_b[c_axis] = x.shape[c_axis]
        g = np.asarray(pk._act_mask_grad(jnp.asarray(y), jnp.asarray(dy),
                                         act))
        dx = (g * cg.reshape(shape_b) + (x - mean.reshape(shape_b))
              * cx.reshape(shape_b) + c0.reshape(shape_b))
        j = (dx, g if want_g else None)
    t = ba.bn_act_bwd_apply(*(torch.from_numpy(v) for v in (y, dy, x, cg,
                                                            mean, cx, c0)),
                            act=act, c_axis=c_axis, want_g=want_g)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), **TOL)
    if want_g:
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    else:
        assert t[1] is None and j[1] is None


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x = torch.randn(2, 8, 4, 4)
    a, b = torch.randn(8), torch.randn(8)
    before = (ba.BN_ACT_APPLY.launches, ba.BN_ACT_BWD.launches)
    y = ba.bn_act_apply(x, a, b, act="relu")
    torch.testing.assert_close(y, ba.bn_act_apply_reference(x, a, b),
                               rtol=0, atol=0)
    dx, g = ba.bn_act_bwd_apply(y, x, x, a, b, a, b, want_g=True)
    assert g is not None and dx.shape == x.shape
    assert (ba.BN_ACT_APPLY.launches, ba.BN_ACT_BWD.launches) == before


def test_meta_tensors_give_shapes_only():
    x = torch.empty(97, 8, 5, 5, device="meta")
    a = torch.empty(8, device="meta")
    y = ba.bn_act_apply(x, a, a, act="gelu")
    assert y.device.type == "meta" and y.shape == x.shape


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(2, 8, 4, 4)
    a = torch.randn(8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ba.bn_act_apply_f32(x, a, a)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ba.bn_act_bwd_f32(x, x, x, a, a, a, a)
    with pytest.raises(NotImplementedError, match="act grad"):
        ba.bn_act_bwd_f32(x, x, x, a, a, a, a, act="sigmoid")
    with pytest.raises(NotImplementedError, match="act"):
        ba.bn_act_apply_f32(x, a, a, act="swish")
    with pytest.raises(NotImplementedError):
        ba.bn_act_bwd_apply(x, x, x, a, a, a, a, act="tanh")
