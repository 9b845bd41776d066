"""PyTorch port, the conv-epilogue kernels' plain versions
(``paddle_tpu_torch/ops/bn_act.py``) against the JAX package's Pallas
kernels (``pallas_kernels.bn_act_apply`` / ``bn_act_bwd_apply``) run in
interpret mode on the CPU, as ``tests/test_fused_epilogue.py`` runs them.

Where the Pallas kernel does not engage (its TPU tiling gates: ``c % 8``,
block-divisible extents) the JAX function returns None and the op runs
its jnp composition; that composition is then the reference.  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: rtol 1e-6 / atol 1e-6 everywhere in f32, the same sums with
XLA free to contract a multiply and an add into one FMA.

bf16 (static AMP): x, z, a and b in bf16, and in the backward y, dy, x,
cg, mean and cx in bf16 with c0 f32.  Every multiply and add rounds to
bf16 on both sides in the same order, so the forward with "", relu and
tanh and the backward are equal bit for bit; sigmoid and gelu within
``BF16_ACT_ULPS`` bf16 ulps of the largest output (XLA's bf16 logistic
and gelu against PyTorch's f32 functions rounded once; measured at most
1.02 ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import bn_act as ba

TOL = dict(rtol=1e-6, atol=1e-6)
BF16_ACT_ULPS = 2


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
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=_diagnosis(
        got.numpy(), want, _fwd_f64(x, a, b, z, act, c_axis)))


def _fwd_f64(x, a, b, z, act, c_axis):
    """The forward in float64 (the arbiter when the two sides differ)."""
    t = [None if v is None else torch.from_numpy(v).double()
         for v in (x, a, b, z)]
    return ba.bn_act_apply_reference(*t, act=act, c_axis=c_axis).numpy()


def _diagnosis(got, want, exact):
    """What a failure reports beside numpy's count and largest
    difference: the elements off and how far each side lies from the
    float64 value, so that a failure names the side at fault."""
    off = ~np.isclose(got, want, **TOL)
    return (f"{int(off.sum())} of {off.size} elements off by up to "
            f"{float(np.abs(got - want).max()):.3e}; port vs float64 "
            f"{float(np.abs(got - exact).max()):.3e}, JAX vs float64 "
            f"{float(np.abs(want - exact).max()):.3e}")


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


# ==========================================================================
# bf16
# ==========================================================================
def _j16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t16(a):
    return torch.from_numpy(a).bfloat16()


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_forward_plain_matches_jax_bf16(interpret, shape, c_axis, with_z,
                                        act):
    x, z, (a, b, _, _) = _arrays(3, shape, c_axis)
    z = z if with_z else None
    zj = None if z is None else _j16(z)
    want = pk.bn_act_apply(_j16(x), _j16(a), _j16(b), z=zj, act=act,
                           c_axis=c_axis)
    if want is None:   # the op's jnp composition (fused_ops.py:484-488)
        shape_b = [1] * x.ndim
        shape_b[c_axis] = x.shape[c_axis]
        want = _j16(x) * _j16(a).reshape(shape_b) + _j16(b).reshape(shape_b)
        if zj is not None:
            want = want + zj
        want = pk.apply_act(want, act)
    got = ba.bn_act_apply(_t16(x), _t16(a), _t16(b),
                          None if z is None else _t16(z), act=act,
                          c_axis=c_axis)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    g, w = got.float().numpy(), _f32(want)
    if act in ("", "relu", "tanh"):
        np.testing.assert_array_equal(g, w)
    else:
        assert np.abs(g - w).max() <= BF16_ACT_ULPS * 2.0 ** -8 * \
            np.abs(w).max()


def test_tileable_shapes_run_the_pallas_kernel_bf16(interpret):
    for (shape, c_axis) in SHAPES[:2]:
        x, _, (a, b, cg, m) = _arrays(1, shape, c_axis)
        assert pk.bn_act_apply(_j16(x), _j16(a), _j16(b), act="relu",
                               c_axis=c_axis) is not None
        assert pk.bn_act_bwd_apply(
            _j16(x), _j16(x), _j16(x), _j16(cg), _j16(m), _j16(a),
            jnp.asarray(b), act="relu", c_axis=c_axis) is not None


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_backward_plain_matches_jax_bf16(interpret, shape, c_axis, want_g,
                                         act):
    """c0 stays f32 and is rounded to bf16 inside (Pallas :1140); dx comes
    out in x's dtype and g in dy's, both bf16."""
    x, dy, (cg, mean, cx, c0) = _arrays(4, shape, c_axis)
    y = np.maximum(x + 0.1, 0.0).astype(np.float32)
    args = [_j16(v) for v in (y, dy, x, cg, mean, cx)] + [jnp.asarray(c0)]
    j = pk.bn_act_bwd_apply(*args, act=act, c_axis=c_axis, want_g=want_g)
    if j is None:   # the op's jnp composition (fused_ops.py:549-556)
        shape_b = [1] * x.ndim
        shape_b[c_axis] = x.shape[c_axis]
        yj, dyj, xj, cgj, mj, cxj, c0j = args
        g = pk._act_mask_grad(yj, dyj, act)
        dx = (g * cgj.reshape(shape_b) + (xj - mj.reshape(shape_b))
              * cxj.reshape(shape_b) + c0j.reshape(shape_b).astype(g.dtype))
        j = (dx.astype(xj.dtype), g if want_g else None)
    t = ba.bn_act_bwd_apply(*(_t16(v) for v in (y, dy, x, cg, mean, cx)),
                            torch.from_numpy(c0), act=act, c_axis=c_axis,
                            want_g=want_g)
    assert t[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(t[0].float().numpy(), _f32(j[0]))
    if want_g:
        np.testing.assert_array_equal(t[1].float().numpy(), _f32(j[1]))
    else:
        assert t[1] is None


def test_cpu_tensors_of_any_float_dtype_take_the_plain_version():
    """bf16 and float16 CPU tensors take the plain versions (the card
    refuses float16: ``tests/test_torch_cuda_kernels.py``) and launch
    nothing."""
    x = torch.randn(2, 8, 4, 4)
    a = torch.randn(8)
    before = (ba.BN_ACT_APPLY_BF16.launches, ba.BN_ACT_BWD_BF16.launches)
    for dt in (torch.bfloat16, torch.float16):
        y = ba.bn_act_apply(x.to(dt), a.to(dt), a.to(dt))
        assert y.dtype == dt
        dx, _ = ba.bn_act_bwd_apply(*(t.to(dt) for t in (y, x, x, a, a, a)),
                                    a)
        assert dx.dtype == dt
    assert (ba.BN_ACT_APPLY_BF16.launches,
            ba.BN_ACT_BWD_BF16.launches) == before
