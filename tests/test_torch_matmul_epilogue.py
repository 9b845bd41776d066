"""PyTorch port, the fc epilogue (``ops/matmul_epilogue.py`` and the
``fused_matmul_bias_act`` op) against the JAX package on the CPU.

* The plain version of kernel 9 against JAX's ``_matmul_bias_act_jnp``
  (``fused_ops.py:577``) for every act on ragged 2-D shapes, and the
  fused op's forward against JAX's with ``x_num_col_dims`` 1 and 2 and a
  bias on a non-trailing axis.
* The plain version against the Pallas kernel itself, in interpret mode,
  at shapes its block ladders tile (``tests/test_fused_epilogue.py:99``).
* The fused grad op against JAX's through ``registry.run_op`` on both
  sides, relu and sigmoid (and tanh, gelu), forward and grad.
* The wrapper's dispatch on the CPU: the plain version, no launch.

Tolerances, f32: rtol 1e-5 / atol 1e-5 where both sides sum the same
products in another order over K <= 64, rtol 2e-5 / atol 2e-4 against the
Pallas kernel (the tolerance of JAX's own kernel test, K = 512).

bf16 (static AMP): x and w bf16, the bias f32.  The port follows the
AMP program's unfused chain: the product rounded to bf16 (the ``mul``
output), the f32 bias added (bf16 + f32 promotes to f32), the act in f32,
an f32 output, as JAX's ``_matmul_bias_act_jnp`` does.  Against it, each
element within one bf16 ulp of its product (at most ``2^-7 |x @ w|``;
the products are summed in another order, so a product may round the
other way) plus f32 noise in the act (measured at 256 x 512 x 256:
at most 0.5 bf16 ulps of the largest output, with tanh).  JAX's Pallas
kernel instead adds the bias to the unrounded f32 accumulator and stores
bf16 (``result_type(x, w)``), so it disagrees with its own fallback;
against it, after rounding the port's output to bf16, each element within
that product rounding plus the two output roundings,
``2^-8 (|x @ w| + 2 |out|)`` (measured: 14.5% (relu) to 41.4% (gelu) of
the elements differ, by up to 2.0 bf16 ulps of the largest output, with
tanh, whose outputs are much smaller than its inputs).

fp16 (static AMP with loss scaling, ``decorate(use_fp16=True)``): the same
chain with the product rounded to fp16, so the same tests with one fp16
ulp (``2^-10 |x @ w|``) where bf16 has one bf16 ulp, and against the
Pallas kernel the fp16 roundings ``2^-11 (|x @ w| + 2 |out|)``; the fused
op and grad equal the unfused chain bit for bit, as in bf16.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import fused_ops as jfused
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import matmul_epilogue as tme

from test_torch_static_ops import SUMS, _check

TIGHT = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-4)
ACTS = ["", "relu", "sigmoid", "tanh", "gelu"]


def _case(seed, m, k, n, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32) * scale,
            (rng.randn(k, n) / k ** 0.5).astype(np.float32),
            rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (1, 1, 1), (8, 400, 120),
                                   (8, 120, 84), (3, 64, 32)],
                         ids=["odd", "one", "lenet-fc1", "lenet-fc2",
                              "word2vec-tiny"])
def test_plain_version_matches_jax_composition(m, k, n, act):
    x, w, b = _case(0, m, k, n)
    want = np.asarray(jfused._matmul_bias_act_jnp(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act, 1, -1))
    got = tme.matmul_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), act)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "gelu"])
@pytest.mark.parametrize("xshape,wshape,bias_n,xnc,axis", [
    ((4, 3, 5), (15, 6), 6, 1, 1),        # x flattened from 3-D
    ((4, 3, 5), (5, 6), 6, 2, -1),        # x_num_col_dims 2, trailing bias
    ((4, 3, 5), (5, 6), 6, 2, 2),         # the same, axis named
    ((6, 5), (5, 6), 6, 1, 0),            # bias on the rows' axis
], ids=["xnc1-3d", "xnc2", "xnc2-axis2", "axis0"])
def test_fused_forward_matches_jax(xshape, wshape, bias_n, xnc, axis, act):
    rng = np.random.RandomState(3)
    ins = {"X": [("x", rng.randn(*xshape).astype(np.float32))],
           "Y": [("y", rng.randn(*wshape).astype(np.float32) * 0.3)],
           "Bias": [("b", rng.randn(bias_n).astype(np.float32))]}
    _check("fused_matmul_bias_act", ins, {"Out": ["o"]},
           {"act_type": act, "x_num_col_dims": xnc, "axis": axis},
           tol=TIGHT)


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_the_pallas_kernel(monkeypatch, act):
    """JAX's kernel in interpret mode, at word2vec's hidden-layer shape
    (M 64, K 128, N 256) and JAX's own test shape (256 x 512 x 128)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    for seed, (m, k, n) in enumerate(((64, 128, 256), (256, 512, 128))):
        x, w, b = _case(seed, m, k, n, scale=2.0)
        want = pk.matmul_bias_act(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), act)
        assert want is not None, "the Pallas kernel must engage"
        got = tme.matmul_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("xshape,wshape,xnc", [
    ((6, 4, 2, 2), (16, 10), 1),          # LeNet's pool -> fc flattening
    ((3, 4, 7), (7, 5), 2),
], ids=["4d-xnc1", "3d-xnc2"])
def test_fused_grad_matches_jax(xshape, wshape, xnc, act):
    rng = np.random.RandomState(7)
    ins = {"X": [("x", rng.randn(*xshape).astype(np.float32))],
           "Y": [("y", rng.randn(*wshape).astype(np.float32) * 0.4)],
           "Bias": [("b", rng.randn(wshape[1]).astype(np.float32))]}
    _, t = _check("fused_matmul_bias_act", ins, {"Out": ["o"]},
                  {"act_type": act, "x_num_col_dims": xnc, "axis": -1},
                  cot_of=["o"], tol=SUMS)
    assert {"x@GRAD", "y@GRAD", "b@GRAD"} <= set(t)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, w, b = (torch.from_numpy(a) for a in _case(1, 9, 13, 5))
    before = tme.MATMUL_BIAS_ACT_F32.launches
    got = tme.matmul_bias_act(x, w, b, "tanh")
    assert torch.equal(got, tme.matmul_bias_act_reference(x, w, b, "tanh"))
    # shape inference runs the plain version on meta tensors
    meta = tme.matmul_bias_act(x.to("meta"), w.to("meta"), b.to("meta"),
                               "relu")
    assert meta.shape == (9, 5) and meta.device.type == "meta"
    assert tme.MATMUL_BIAS_ACT_F32.launches == before
    with pytest.raises(NotImplementedError, match="act"):
        tme.matmul_bias_act(x, w, b, "swish")


# ==========================================================================
# bf16
# ==========================================================================
def _bf16_case(seed, m, k, n):
    x, w, b = _case(seed, m, k, n, scale=2.0)
    x16 = torch.from_numpy(x).bfloat16()
    w16 = torch.from_numpy(w).bfloat16()
    # the exact f32 product of the bf16 operands' values
    prod = np.abs(x16.double().numpy() @ w16.double().numpy())
    return x16, w16, b, prod


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (8, 400, 120),
                                   (256, 512, 256)],
                         ids=["odd", "lenet-fc1", "pallas"])
def test_bf16_plain_version_follows_the_unfused_chain(m, k, n, act):
    x16, w16, b, prod = _bf16_case(5, m, k, n)
    want = np.asarray(jfused._matmul_bias_act_jnp(
        jnp.asarray(x16.float().numpy(), jnp.bfloat16),
        jnp.asarray(w16.float().numpy(), jnp.bfloat16), jnp.asarray(b),
        act, 1, -1))
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b), act)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    err = np.abs(got.numpy() - want)
    assert (err <= 2.0 ** -7 * prod + 1e-6 * np.abs(want) + 1e-7).all(), \
        float(err.max())


@pytest.mark.parametrize("act", ACTS)
def test_bf16_plain_version_against_the_pallas_kernel(monkeypatch, act):
    """JAX's kernel in interpret mode at its own test's shape; it returns
    bf16 where the port (and JAX's fallback) return f32."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    x16, w16, b, prod = _bf16_case(6, 256, 512, 256)
    want = pk.matmul_bias_act(jnp.asarray(x16.float().numpy(), jnp.bfloat16),
                              jnp.asarray(w16.float().numpy(), jnp.bfloat16),
                              jnp.asarray(b), act)
    assert want is not None and str(want.dtype) == "bfloat16"
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b), act)
    g = got.bfloat16().float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert (np.abs(g - w) <= 2.0 ** -8 * (prod + 2 * np.abs(w))).all()
    # the divergence is real: the kernel's rounding point is not the
    # Program's (measured: 14.5-41.4% of the elements differ)
    assert np.mean(g != w) > 0.1


def test_bf16_fused_op_and_grad_follow_the_unfused_ops():
    """The fused op on a bf16 product and an f32 bias (an AMP program's
    fc chain), forward and grad, equals the unfused mul ->
    elementwise_add -> relu chain of the port bit for bit: Out f32, dX
    and dY bf16 (the cast grads bring them to f32), dBias f32."""
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(9)
    x16 = torch.from_numpy(rng.randn(6, 4, 2, 2).astype(np.float32)).bfloat16()
    w16 = torch.from_numpy(rng.randn(16, 10).astype(np.float32)
                           * 0.4).bfloat16()
    b = torch.from_numpy(rng.randn(10).astype(np.float32))
    dout = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    fused = {}
    env = {"x": x16, "y": w16, "b": b, "o@GRAD": dout}

    class _Op:
        def __init__(self, type_, ins, outs, attrs):
            self.type, self.inputs, self.outputs = type_, ins, outs
            self.attrs = attrs

    attrs = {"act_type": "relu", "x_num_col_dims": 1, "axis": -1}
    treg.OPS["fused_matmul_bias_act"].lower(treg.LowerCtx(
        _Op("fused_matmul_bias_act", {"X": ["x"], "Y": ["y"],
                                      "Bias": ["b"]}, {"Out": ["o"]},
            attrs), env))
    treg.OPS["fused_matmul_bias_act_grad"].lower(treg.LowerCtx(
        _Op("fused_matmul_bias_act_grad",
            {"X": ["x"], "Y": ["y"], "Bias": ["b"], "Out@GRAD": ["o@GRAD"]},
            {"X@GRAD": ["dx"], "Y@GRAD": ["dy"], "Bias@GRAD": ["db"]},
            attrs), env))
    fused = {k: env[k] for k in ("o", "dx", "dy", "db")}
    xr, wr, br = (t.clone().requires_grad_() for t in (x16, w16, b))
    out = torch.relu(torch.matmul(xr.reshape(6, 16), wr) + br)
    out.backward(dout)
    assert fused["o"].dtype == torch.float32
    assert torch.equal(fused["o"], out.detach())
    assert fused["dx"].dtype == torch.bfloat16
    assert torch.equal(fused["dx"], xr.grad)
    assert torch.equal(fused["dy"], wr.grad)
    assert torch.equal(fused["db"], br.grad)


# ==========================================================================
# fp16
# ==========================================================================
def _fp16_case(seed, m, k, n):
    x, w, b = _case(seed, m, k, n, scale=2.0)
    x16 = torch.from_numpy(x).half()
    w16 = torch.from_numpy(w).half()
    # the exact product of the fp16 operands' values
    prod = np.abs(x16.double().numpy() @ w16.double().numpy())
    return x16, w16, b, prod


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (8, 400, 120),
                                   (256, 512, 256)],
                         ids=["odd", "lenet-fc1", "pallas"])
def test_fp16_plain_version_follows_the_unfused_chain(m, k, n, act):
    """Against ``_matmul_bias_act_jnp`` on fp16 operands and an f32 bias:
    f32 out, each element within one fp16 ulp of its product (measured:
    equal but for the act's f32 noise, since both sides accumulate the
    products in f32 and round once)."""
    x16, w16, b, prod = _fp16_case(5, m, k, n)
    want = np.asarray(jfused._matmul_bias_act_jnp(
        jnp.asarray(x16.numpy()), jnp.asarray(w16.numpy()), jnp.asarray(b),
        act, 1, -1))
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b), act)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    err = np.abs(got.numpy() - want)
    assert (err <= 2.0 ** -10 * prod + 1e-6 * np.abs(want) + 1e-7).all(), \
        float(err.max())


@pytest.mark.parametrize("act", ACTS)
def test_fp16_plain_version_against_the_pallas_kernel(monkeypatch, act):
    """JAX's kernel in interpret mode: it adds the f32 bias to the
    unrounded accumulator and returns fp16, where the port (and JAX's
    fallback) round the product first and return f32."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    x16, w16, b, prod = _fp16_case(6, 256, 512, 256)
    want = pk.matmul_bias_act(jnp.asarray(x16.numpy()),
                              jnp.asarray(w16.numpy()), jnp.asarray(b), act)
    assert want is not None and str(want.dtype) == "float16"
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b), act)
    g = got.half().float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert (np.abs(g - w) <= 2.0 ** -11 * (prod + 2 * np.abs(w))).all()
    assert np.mean(g != w) > 0.01


def test_fp16_fp16_bias_and_overflow_follow_the_unfused_chain():
    """An fp16 bias keeps the output fp16 (fp16 + fp16), and a product
    beyond fp16's range is Inf before the bias, as the unfused ``mul``'s
    fp16 output is."""
    x = torch.full((2, 4), 200.0, dtype=torch.float16)
    w = torch.full((4, 3), 100.0, dtype=torch.float16)
    b = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float16)
    got = tme.matmul_bias_act(x, w, b, "relu")
    assert got.dtype == torch.float16 and torch.isinf(got).all()
    got = tme.matmul_bias_act(x, w, b.float(), "")
    assert got.dtype == torch.float32 and torch.isinf(got).all()
    x16, w16, b32, _ = _fp16_case(8, 9, 33, 7)
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b32).half(), "tanh")
    want = torch.tanh(torch.matmul(x16, w16) + torch.from_numpy(b32).half())
    assert got.dtype == torch.float16 and torch.equal(got, want)


def test_fp16_fused_op_and_grad_follow_the_unfused_ops():
    """The fused op on an fp16 product and an f32 bias, forward and grad,
    equals the port's unfused mul -> elementwise_add -> relu chain bit for
    bit: Out f32, dX and dY fp16, dBias f32."""
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(9)
    x16 = torch.from_numpy(rng.randn(6, 4, 2, 2).astype(np.float32)).half()
    w16 = torch.from_numpy(rng.randn(16, 10).astype(np.float32) * 0.4).half()
    b = torch.from_numpy(rng.randn(10).astype(np.float32))
    dout = torch.from_numpy(rng.randn(6, 10).astype(np.float32) * 1000)
    env = {"x": x16, "y": w16, "b": b, "o@GRAD": dout}

    class _Op:
        def __init__(self, type_, ins, outs, attrs):
            self.type, self.inputs, self.outputs = type_, ins, outs
            self.attrs = attrs

    attrs = {"act_type": "relu", "x_num_col_dims": 1, "axis": -1}
    treg.OPS["fused_matmul_bias_act"].lower(treg.LowerCtx(
        _Op("fused_matmul_bias_act", {"X": ["x"], "Y": ["y"],
                                      "Bias": ["b"]}, {"Out": ["o"]},
            attrs), env))
    treg.OPS["fused_matmul_bias_act_grad"].lower(treg.LowerCtx(
        _Op("fused_matmul_bias_act_grad",
            {"X": ["x"], "Y": ["y"], "Bias": ["b"], "Out@GRAD": ["o@GRAD"]},
            {"X@GRAD": ["dx"], "Y@GRAD": ["dy"], "Bias@GRAD": ["db"]},
            attrs), env))
    xr, wr, br = (t.clone().requires_grad_() for t in (x16, w16, b))
    out = torch.relu(torch.matmul(xr.reshape(6, 16), wr) + br)
    out.backward(dout)
    assert env["o"].dtype == torch.float32
    assert torch.equal(env["o"], out.detach())
    assert env["dx"].dtype == torch.float16
    assert torch.equal(env["dx"], xr.grad)
    assert torch.equal(env["dy"], wr.grad)
    assert torch.equal(env["db"], br.grad)


def test_fp16_cpu_tensors_take_the_plain_version():
    x16, w16, b, _ = _fp16_case(3, 5, 7, 4)
    before = tme.MATMUL_BIAS_ACT_FP16.launches
    got = tme.matmul_bias_act(x16, w16, torch.from_numpy(b), "sigmoid")
    assert torch.equal(got, tme.matmul_bias_act_reference(
        x16, w16, torch.from_numpy(b), "sigmoid"))
    assert tme.MATMUL_BIAS_ACT_FP16.launches == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        tme.matmul_bias_act_fp16(x16, w16, torch.from_numpy(b))
