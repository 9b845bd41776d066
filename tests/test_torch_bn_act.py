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

fp16 (static AMP with loss scaling): the same dtypes with fp16 for bf16.
The plain versions round every multiply and add to fp16 in the kernels'
term order, which numpy's sequential fp16 arithmetic reproduces bit for
bit here.  JAX's jnp composition (the fallback at ragged shapes, one
eager op at a time) equals them bit for bit for "", relu and tanh;
sigmoid and gelu within ``FP16_ACT_ULPS`` fp16 half-ulps (2^-11
relative) of the largest output.  The Pallas kernel in interpret mode is
one XLA computation, and XLA's CPU runs its fp16 body in f32 and rounds
where its fusion pass puts the converts (without z, once at the end), so
at the tileable shapes it lies within ``FP16_KERNEL_ULPS`` half-ulps of
the largest output (measured at most 3.0 forward, with tanh and z, and
1.3 backward).
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
FP16_ACT_ULPS = 2
FP16_KERNEL_ULPS = 4


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
    """bf16 and float16 CPU tensors take the plain versions and launch
    nothing."""
    x = torch.randn(2, 8, 4, 4)
    a = torch.randn(8)
    kernels = (ba.BN_ACT_APPLY_BF16, ba.BN_ACT_BWD_BF16,
               ba.BN_ACT_APPLY_FP16, ba.BN_ACT_BWD_FP16)
    before = [k.launches for k in kernels]
    for dt in (torch.bfloat16, torch.float16):
        y = ba.bn_act_apply(x.to(dt), a.to(dt), a.to(dt))
        assert y.dtype == dt
        dx, _ = ba.bn_act_bwd_apply(*(t.to(dt) for t in (y, x, x, a, a, a)),
                                    a)
        assert dx.dtype == dt
    assert [k.launches for k in kernels] == before


# ==========================================================================
# fp16
# ==========================================================================
def _h(a):
    """numpy float32 -> the float32 values of its fp16 rounding."""
    return np.asarray(a, np.float16).astype(np.float32)


def _ulps16(got, want):
    """|got - want| in fp16 half-ulps (2^-11) of the largest |want|."""
    return float(np.abs(got - want).max()) / (2.0 ** -11 * max(
        float(np.abs(want).max()), 1e-30))


def _seq_fwd16(x, a, b, z, c_axis):
    """x*a + b (+ z) with every step rounded to fp16, in numpy."""
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    y = _h(_h(x * a.reshape(shape)) + b.reshape(shape))
    return y if z is None else _h(y + z)


@pytest.mark.parametrize("act", ["", "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("with_z", [False, True], ids=["no-z", "z"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_forward_plain_matches_jax_fp16(interpret, shape, c_axis, with_z,
                                        act):
    x, z, (a, b, _, _) = _arrays(3, shape, c_axis)
    x, z, a, b = _h(x), _h(z), _h(a), _h(b)
    z = z if with_z else None
    jx, ja, jb = (jnp.asarray(v, jnp.float16) for v in (x, a, b))
    zj = None if z is None else jnp.asarray(z, jnp.float16)
    want = pk.bn_act_apply(jx, ja, jb, z=zj, act=act, c_axis=c_axis)
    kernel = want is not None
    if want is None:   # the op's jnp composition (fused_ops.py:484-488)
        shape_b = [1] * x.ndim
        shape_b[c_axis] = x.shape[c_axis]
        want = jx * ja.reshape(shape_b) + jb.reshape(shape_b)
        if zj is not None:
            want = want + zj
        want = pk.apply_act(want, act)
    t = [None if v is None else torch.from_numpy(v).half()
         for v in (x, a, b, z)]
    got = ba.bn_act_apply(*t, act=act, c_axis=c_axis)
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    g, w = got.float().numpy(), _f32(want)
    if act in ("", "relu"):   # the rounding points themselves
        seq = _seq_fwd16(x, a, b, z, c_axis)
        np.testing.assert_array_equal(g, np.maximum(seq, 0) if act else seq)
    if kernel:
        assert _ulps16(g, w) <= FP16_KERNEL_ULPS, _ulps16(g, w)
    elif act in ("", "relu", "tanh"):
        np.testing.assert_array_equal(g, w)
    else:
        assert _ulps16(g, w) <= FP16_ACT_ULPS, _ulps16(g, w)


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("want_g", [False, True], ids=["dx", "dx-and-g"])
@pytest.mark.parametrize("shape,c_axis", SHAPES, ids=SHAPE_IDS)
def test_backward_plain_matches_jax_fp16(interpret, shape, c_axis, want_g,
                                         act):
    """c0 stays f32 and is rounded to fp16 inside; dx and g fp16.  g is
    a select, equal everywhere; dx equal to the jnp composition and to
    numpy's sequential fp16 arithmetic, and within FP16_KERNEL_ULPS of
    the Pallas kernel."""
    x, dy, (cg, mean, cx, c0) = _arrays(4, shape, c_axis)
    x, dy, cg, mean, cx = (_h(v) for v in (x, dy, cg, mean, cx))
    y = _h(np.maximum(x + 0.1, 0.0))
    args = [jnp.asarray(v, jnp.float16) for v in (y, dy, x, cg, mean, cx)]
    args.append(jnp.asarray(c0))
    j = pk.bn_act_bwd_apply(*args, act=act, c_axis=c_axis, want_g=want_g)
    kernel = j is not None
    if j is None:   # the op's jnp composition (fused_ops.py:549-556)
        shape_b = [1] * x.ndim
        shape_b[c_axis] = x.shape[c_axis]
        yj, dyj, xj, cgj, mj, cxj, c0j = args
        g = pk._act_mask_grad(yj, dyj, act)
        dx = (g * cgj.reshape(shape_b) + (xj - mj.reshape(shape_b))
              * cxj.reshape(shape_b) + c0j.reshape(shape_b).astype(g.dtype))
        j = (dx.astype(xj.dtype), g if want_g else None)
    t = ba.bn_act_bwd_apply(*(torch.from_numpy(v).half()
                              for v in (y, dy, x, cg, mean, cx)),
                            torch.from_numpy(c0), act=act, c_axis=c_axis,
                            want_g=want_g)
    assert t[0].dtype == torch.float16
    shape_b = [1] * x.ndim
    shape_b[c_axis] = x.shape[c_axis]
    g = np.where(y > 0, dy, 0).astype(np.float32) if act else dy
    seq = _h(_h(_h(g * cg.reshape(shape_b))
                + _h(_h(x - mean.reshape(shape_b)) * cx.reshape(shape_b)))
             + _h(c0).reshape(shape_b))
    got = t[0].float().numpy()
    np.testing.assert_array_equal(got, seq)
    if kernel:
        assert _ulps16(got, _f32(j[0])) <= FP16_KERNEL_ULPS
    else:
        np.testing.assert_array_equal(got, _f32(j[0]))
    if want_g:
        np.testing.assert_array_equal(t[1].float().numpy(), _f32(j[1]))
    else:
        assert t[1] is None


def test_fp16_overflow_and_subnormals_follow_fp16():
    """What loss scaling leans on: an fp16 sum beyond 65504 is Inf (and a
    loss-scaled Inf gradient stays Inf through the backward, where relu
    lets it through), and fp16 subnormals are kept, not flushed."""
    x = torch.tensor([[60000.0, 1e-5, -3e-5, 2.0]], dtype=torch.float16)
    a = torch.tensor([2.0, 0.5, 0.25, 1.0], dtype=torch.float16)
    b = torch.zeros(4, dtype=torch.float16)
    y = ba.bn_act_apply(x, a, b, act="", c_axis=1)
    assert torch.isinf(y[0, 0]) and y[0, 0] > 0
    assert 0 < float(y[0, 1]) < 2.0 ** -14 and float(y[0, 2]) < 0
    dy = torch.tensor([[float("inf"), 1e-6, 3.0, 1.0]], dtype=torch.float16)
    dx, g = ba.bn_act_bwd_apply(torch.ones_like(x), dy, x, a, b, b,
                                torch.zeros(4), act="relu", c_axis=1,
                                want_g=True)
    assert torch.isinf(dx[0, 0]) and torch.isinf(g[0, 0])
    assert 0 < float(dx[0, 1]) < 2.0 ** -14
