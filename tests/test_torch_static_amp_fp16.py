"""PyTorch port, static float16 AMP (``decorate(use_fp16=True)``: the
program rewrite to fp16, the loss scaling and its two ops) against the
JAX package on the CPU, on the same numpy inputs.

* Programs: ``decorate(use_fp16=True).minimize`` builds JAX's program op
  for op (types, slots, names, dtypes, attrs) with dynamic scaling, with
  a static scale of 128 and with a static scale of 1, for LeNet, word2vec
  and ResNet-18; ``rewrite_program`` to fp16 gives JAX's casts and dtypes.
* Lowerings: each op of the fp16 path, forward and grad, on fp16 inputs
  against the JAX lowering under ``jax.jit``, each tolerance stated at its
  case in fp16 half-ulps (2^-11 relative to the largest output; one fp16
  rounding is at most one of them).  XLA's CPU runs an fp16 elementwise
  fusion in f32 and rounds once at its output, where the port (like bf16,
  and like the Pallas kernel's storage-dtype arithmetic) rounds after
  each multiply and add: BatchNorm's ``x * a + b`` differs by one
  rounding on about a quarter of the elements (ROADMAP.md, Queue 3).
* The loss-scaling ops bit for bit: ``amp_check_finite_and_scale`` on
  gradients with an Inf, with a NaN and all finite, in f32 and fp16;
  ``update_loss_scaling`` over a scripted 12-step found-Inf pattern that
  takes both branches, both counter resets and the 1e-10 floor.
* Training from JAX's startup scope copied into the port: LeNet and
  word2vec 4 steps (the port fused and unfused equal bit for bit, and the
  scale and found-Inf history JAX's at every step); ResNet-18 under
  decorate's defaults, where every step finds an Inf, step for step
  (found-Inf, scale, counters, parameters unchanged), and a clean
  ResNet-18 run at a scale of 1024 held to a JAX twin's noise envelope;
  in the port alone, fused == unfused bit for bit and NHWC == NCHW at
  step 1 on that clean run.
* The tools' ``--amp-dtype float16``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu.ops.registry as jreg  # noqa: F401  (registers JAX's ops)
from paddle_tpu.framework.dtype import VarType as JVarType
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework.dtype import VarType as TVarType
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)

from test_torch_static_amp import (JAX, LISTS, PORT, _CONV, _BN_GRAD_OUTS,
                                   _BN_OUTS, _bn_spec, _book_feed, _build,
                                   _desc, _f32, _grad_run, _jit_op,
                                   _port_op, _r, _set_flags, _start_scope,
                                   jflags, jlists, jutils, junique, jfluid,
                                   tlists, tutils, tunique)
from test_torch_static_amp_resnet import _check_after_step_1, _resnet_feed
from torch_resnet_parity import NOISE, rel_errs

#: one fp16 half-ulp: the unit of every fp16 tolerance below
HALF_ULP = 2.0 ** -11
SCALINGS = {
    "dynamic": dict(use_fp16=True),
    "static128": dict(use_fp16=True, use_dynamic_loss_scaling=False,
                      init_loss_scaling=128.0),
    "static1": dict(use_fp16=True, use_dynamic_loss_scaling=False,
                    init_loss_scaling=1.0),
}


# ==========================================================================
# programs
# ==========================================================================
@pytest.mark.parametrize("scaling", sorted(SCALINGS))
@pytest.mark.parametrize("model", ["lenet", "word2vec", "resnet18"])
def test_decorate_fp16_minimize_builds_the_jax_program(model, scaling):
    (jmain, jstart, _), (tmain, tstart, _) = [
        _build(pkg, model.rstrip("18"), train=True, amp=SCALINGS[scaling])
        for pkg in (JAX, PORT)]
    assert _desc(tmain) == _desc(jmain)
    assert _desc(tstart) == _desc(jstart)
    types = [o.type for o in tmain.global_block().ops]
    assert types.count("cast") == types.count("cast_grad") > 0
    dyn = scaling == "dynamic"
    assert types.count("update_loss_scaling") == int(dyn)
    assert types.count("amp_check_finite_and_scale") == int(dyn)
    assert types.count("elementwise_mul") == int(dyn)
    # the static scale: one op on the loss and one per gradient
    assert types.count("scale") == (0 if scaling != "static128" else
                                    1 + types.count("momentum")
                                    + types.count("sgd"))
    fp16 = {v.name for v in tmain.global_block().vars.values()
            if v.dtype == TVarType.FP16}
    assert fp16 and all(".cast_4" in n or "@GRAD" in n or "tmp" in n
                        or "conv2d" in n or "fc" in n for n in fp16), fp16


@pytest.mark.parametrize("model", ["fc", "lenet", "word2vec", "resnet18"])
def test_rewrite_program_fp16_matches_jax(model):
    """One serialized forward Program rewritten by each package's
    ``rewrite_program`` to fp16: the same casts (named ``.cast_4_<n>``,
    the enum member formatted as its number in both), the same cast
    cache and var dtypes."""
    main, _, _ = _build(JAX, model.rstrip("18"))
    text = main.serialize_to_string()
    jp = jfluid.Program.parse_from_string(text)
    tp = tfluid.Program.parse_from_string(text)
    for un, utils, amp_lists, prog, vt in (
            (junique, jutils, jlists, jp, JVarType.FP16),
            (tunique, tutils, tlists, tp, TVarType.FP16)):
        prev = un.switch()
        try:
            utils.rewrite_program(prog, amp_lists.AutoMixedPrecisionLists(
                **LISTS["default"]), vt)
        finally:
            un.switch(prev)
    assert _desc(tp) == _desc(jp)
    casts = [o for o in tp.global_block().ops if o.type == "cast"]
    assert casts and any(".cast_4_" in o.output("Out")[0] for o in casts)


# ==========================================================================
# lowerings on fp16 inputs against the JAX lowering under jax.jit
# ==========================================================================
def _h(a):
    return np.asarray(a, np.float16)


def _spec_pairs(spec):
    """{slot: [(numpy f32, "f16" | "f32")]} -> JAX and torch values."""
    jins, tins = {}, {}
    for slot, items in spec.items():
        jv, tv = [], []
        for a, dt in items:
            a = _h(a) if dt == "f16" else np.asarray(a)
            jv.append(jnp.asarray(a))
            tv.append(torch.from_numpy(np.array(a)))
        jins[slot], tins[slot] = jv, tv
    return jins, tins


def _units(g, w):
    """|g - w| in fp16 half-ulps of the largest finite |w|; the
    non-finite elements (an fp16 overflow, which loss scaling exists to
    catch) must be the same on both sides."""
    gw, ww = _f32(g), _f32(w)
    assert gw.shape == ww.shape
    bad = ~np.isfinite(ww)
    np.testing.assert_array_equal(gw[bad], ww[bad])
    assert np.isfinite(gw[~bad]).all()
    if bad.all():
        return 0.0
    gw, ww = gw[~bad], ww[~bad]
    return float(np.abs(gw - ww).max()) / (
        HALF_ULP * max(float(np.abs(ww).max()), 1e-30))


def _compare16(op_type, spec, attrs, outs, ulps=0.0, f32_tol=0.0):
    """Run both: every output's dtype equal; fp16 outputs within ``ulps``
    half-ulps of their largest value, f32 outputs within ``f32_tol``
    relative to theirs (0: bit for bit).  Returns {slot: error}."""
    jins, tins = _spec_pairs(spec)
    want = _jit_op(op_type, jins, attrs, outs)
    got = _port_op(op_type, tins, attrs, outs)
    errs = {}
    for slot in outs:
        for w, g in zip(want[slot], got[slot]):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), (
                slot, g.dtype, w.dtype)
            if str(w.dtype) == "float16":
                errs[slot] = _units(g, w)
                assert errs[slot] <= ulps, (slot, errs[slot])
            else:
                gw, ww = _f32(g), _f32(w)
                scale = max(float(np.abs(ww).max()), 1e-30)
                errs[slot] = float(np.abs(gw - ww).max()) / scale
                assert errs[slot] <= f32_tol, (slot, errs[slot])
    return errs


def _compare_grad16(op_type, spec, attrs, outs, cot_of, ulps, f32_tol,
                    grad_f32_tol=None, cot_scale=1.0, seed=0):
    """The forward and the grad ops of ``op_type``, JAX's under one
    ``jax.jit``, with cotangents (noise plus the output, times
    ``cot_scale``, as a loss-scaled backward sees them) in each output's
    dtype: fp16 values within ``ulps`` half-ulps, f32 values within
    ``f32_tol`` (f32 gradients ``grad_f32_tol``) relative to their
    largest.  Returns {var: error}."""
    ins = {s: [(f"{s.lower()}{i}", _h(a) if dt == "f16" else a)
               for i, (a, dt) in enumerate(items)]
           for s, items in spec.items()}
    fwd, _ = _grad_run(op_type, ins, outs, attrs, {})
    rng = np.random.RandomState(seed)
    cots = {}
    for n in cot_of:
        y = _f32(fwd[n])
        c = ((rng.randn(*y.shape) + y / max(float(y.std()), 1e-30))
             * cot_scale).astype(np.float32)
        cots[n + "@GRAD"] = _h(c) if str(fwd[n].dtype) == "float16" else c
    want, got = _grad_run(op_type, ins, outs, attrs, cots)
    assert set(got) == set(want), (sorted(got), sorted(want))
    errs = {}
    for n, w in want.items():
        g = got[n]
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), (n,)
        if str(w.dtype) == "float16":
            errs[n] = _units(g, w)
            assert errs[n] <= ulps, (n, errs[n], "half-ulps")
        else:
            gw, ww = _f32(g), _f32(w)
            errs[n] = float(np.abs(gw - ww).max()) / max(
                float(np.abs(ww).max()), 1e-30)
            tol = (grad_f32_tol if n.endswith("@GRAD")
                   and grad_f32_tol is not None else f32_tol)
            assert errs[n] <= tol, (n, errs[n])
    return errs


def _bn16(x, c, seed=5):
    spec = _bn_spec(None, c, seed)
    spec["X"] = [(x, "f16")]
    return spec


def _conv16(fmt):
    x = _r(1, 2, 6, 9, 9) if fmt == "NCHW" else _r(1, 2, 9, 9, 6)
    return {"Input": [(x, "f16")],
            "Filter": [(_r(2, 8, 6, 3, 3, scale=0.3), "f16")]}


def _fused_conv16(fmt, with_z):
    spec = {k: v for k, v in _bn_spec(None, 8).items() if k != "X"}
    nchw = fmt == "NCHW"
    spec["Input"] = [(_r(13, 2, 6, 7, 7) if nchw else _r(13, 2, 7, 7, 6),
                      "f16")]
    spec["Filter"] = [(_r(14, 8, 6, 3, 3, scale=0.3), "f16")]
    if with_z:
        spec["Z"] = [(_r(15, 2, 8, 7, 7) if nchw else _r(15, 2, 7, 7, 8),
                      "f16")]
    return spec, dict(_CONV, data_format=fmt, momentum=0.9, epsilon=1e-5,
                      act_type="relu")


_FUSED_CONV_OUTS = {"Output": 1, "ConvOut": 1, "MeanOut": 1,
                    "VarianceOut": 1, "SavedMean": 1, "SavedVariance": 1}
_FUSED_CONV_GRAD_OUTS = {"Output": ["out"], "ConvOut": ["conv_out"],
                         "MeanOut": ["mean0"], "VarianceOut": ["variance0"],
                         "SavedMean": ["sm"], "SavedVariance": ["sv"]}
_BN_ATTRS = {"momentum": 0.9, "epsilon": 1e-5}

LOWERINGS = {
    # the casts both ways: exact (fp16 subnormals and overflow included)
    "cast-to-fp16": lambda: _compare16(
        "cast", {"X": [(np.concatenate([_r(0, 30, scale=3), [1e-6, 5e-8,
                                                             7e4, -7e4]]
                                       ).astype(np.float32), "f32")]},
        {"in_dtype": 5, "out_dtype": 4}, {"Out": 1}),
    "cast-to-f32": lambda: _compare16(
        "cast", {"X": [(_r(0, 5, 6, scale=3), "f16")]},
        {"in_dtype": 4, "out_dtype": 5}, {"Out": 1}),
    # fp16 products: both accumulate in f32 and round once; the sums run
    # in another order, so an output may round the other way (measured
    # equal here, mul 0 too; its grad 0.6)
    "conv2d-nchw": lambda: _compare16(
        "conv2d", _conv16("NCHW"), dict(_CONV, data_format="NCHW"),
        {"Output": 1}, ulps=1),
    "conv2d-nhwc": lambda: _compare16(
        "conv2d", _conv16("NHWC"), dict(_CONV, data_format="NHWC"),
        {"Output": 1}, ulps=1),
    "mul": lambda: _compare16(
        "mul", {"X": [(_r(3, 64, 400), "f16")],
                "Y": [(_r(4, 400, 120, scale=0.05), "f16")]},
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": 1}, ulps=1),
    # fp16 + f32 promotes to f32 (the fc bias add), fp16 + fp16 stays
    "elementwise_add-fp16-f32": lambda: _compare16(
        "elementwise_add", {"X": [(_r(5, 4, 6), "f16")],
                            "Y": [(_r(6, 6), "f32")]},
        {"axis": 1}, {"Out": 1}),
    "elementwise_add-fp16": lambda: _compare16(
        "elementwise_add", {"X": [(_r(5, 2, 3, 4, 4), "f16")],
                            "Y": [(_r(6, 2, 3, 4, 4), "f16")]},
        {"axis": -1}, {"Out": 1}),
    "relu": lambda: _compare16("relu", {"X": [(_r(7, 5, 6), "f16")]}, {},
                               {"Out": 1}),
    # the loss scaling's f32 ops: exact
    "elementwise_mul-scaled-loss": lambda: _compare16(
        "elementwise_mul", {"X": [(_r(8, 1), "f32")],
                            "Y": [(np.array([32768.0], np.float32), "f32")]},
        {"axis": -1}, {"Out": 1}),
    "elementwise_mul-fp16": lambda: _compare16(
        "elementwise_mul", {"X": [(_r(8, 4, 6), "f16")],
                            "Y": [(_r(9, 4, 6), "f16")]},
        {"axis": -1}, {"Out": 1}),
    "reciprocal": lambda: _compare16(
        "reciprocal", {"X": [(np.array([32768.0, 26214.4, 3.0, 1e-10],
                                       np.float32), "f32")]},
        {}, {"Out": 1}),
    "scale-f32": lambda: _compare16(
        "scale", {"X": [(_r(10, 5, 6, scale=1000), "f32")]},
        {"scale": 1.0 / 128, "bias": 0.0, "bias_after_scale": True},
        {"Out": 1}),
    # fp16: the factor rounded to fp16 first, as JAX's weak typing does
    "scale-fp16": lambda: _compare16(
        "scale", {"X": [(_r(10, 5, 6), "f16")]},
        {"scale": 0.1, "bias": 0.0, "bias_after_scale": True}, {"Out": 1}),
    # f32 statistics of fp16 x (the sums in another order, measured
    # below 5e-5 relative); y = x * a + b: the port rounds the product and
    # the sum, XLA once (measured 0.85 and 0.99 half-ulps; 1.34 with the
    # relu)
    "batch_norm-nchw": lambda: _compare16(
        "batch_norm", _bn16(_r(8, 4, 8, 5, 5, scale=2), 8),
        dict(_BN_ATTRS, data_layout="NCHW"), _BN_OUTS, ulps=2,
        f32_tol=1e-5),
    "batch_norm-nhwc-batch16": lambda: _compare16(
        "batch_norm", _bn16(_r(9, 16, 3, 3, 8, scale=2) + 1, 8),
        dict(_BN_ATTRS, data_layout="NHWC"), _BN_OUTS, ulps=2,
        f32_tol=1e-5),
    "fused_batch_norm_act": lambda: _compare16(
        "fused_batch_norm_act", _bn16(_r(10, 4, 8, 5, 5, scale=2), 8),
        dict(_BN_ATTRS, data_layout="NCHW", act_type="relu"), _BN_OUTS,
        ulps=2, f32_tol=1e-5),
    "pool2d-max": lambda: _compare16(
        "pool2d", {"X": [(_r(11, 2, 3, 8, 8), "f16")]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1]}, {"Out": 1}),
    "pool2d-avg-global": lambda: _compare16(
        "pool2d", {"X": [(_r(12, 2, 3, 4, 4), "f16")]},
        {"pooling_type": "avg", "global_pooling": True, "ksize": [1, 1]},
        {"Out": 1}, ulps=1),
    # the fused conv: ConvOut as conv2d, Output with the BN rounding above
    # (measured 0.52); the f32 statistics within 1e-4 (measured < 5e-5)
    "fused_conv_bn_act": lambda: _compare16(
        "fused_conv_bn_act", *_fused_conv16("NCHW", False),
        _FUSED_CONV_OUTS, ulps=2, f32_tol=1e-4),
    "fused_matmul_bias_act": lambda: _compare16(
        "fused_matmul_bias_act",
        {"X": [(_r(15, 6, 16), "f16")], "Y": [(_r(16, 16, 10), "f16")],
         "Bias": [(_r(17, 10), "f32")]},
        {"act_type": "relu", "x_num_col_dims": 1, "axis": -1}, {"Out": 1},
        f32_tol=2.0 ** -10),
    # ---- the backward, with loss-scaled cotangents (x 1024)
    "conv2d_grad-nchw": lambda: _compare_grad16(
        "conv2d", _conv16("NCHW"), dict(_CONV, data_format="NCHW"),
        {"Output": ["out"]}, ["out"], ulps=1, f32_tol=0, cot_scale=1024),
    "conv2d_grad-nhwc": lambda: _compare_grad16(
        "conv2d", _conv16("NHWC"), dict(_CONV, data_format="NHWC"),
        {"Output": ["out"]}, ["out"], ulps=1, f32_tol=0, cot_scale=1024),
    "batch_norm_grad-nchw": lambda: _compare_grad16(
        "batch_norm", _bn16(_r(8, 4, 8, 5, 5, scale=2), 8),
        dict(_BN_ATTRS, data_layout="NCHW"), _BN_GRAD_OUTS, ["y"],
        ulps=BN_GRAD_ULPS, f32_tol=1e-5, grad_f32_tol=BN_GRAD_F32),
    "batch_norm_grad-nhwc": lambda: _compare_grad16(
        "batch_norm", _bn16(_r(9, 16, 3, 3, 8, scale=2) + 1, 8),
        dict(_BN_ATTRS, data_layout="NHWC"), _BN_GRAD_OUTS, ["y"],
        ulps=BN_GRAD_ULPS, f32_tol=1e-5, grad_f32_tol=BN_GRAD_F32),
    "fused_batch_norm_act_grad": lambda: _compare_grad16(
        "fused_batch_norm_act", _bn16(_r(10, 4, 8, 5, 5, scale=2), 8),
        dict(_BN_ATTRS, data_layout="NCHW", act_type="relu"),
        _BN_GRAD_OUTS, ["y"], ulps=FUSED_BN_GRAD_ULPS, f32_tol=1e-5,
        cot_scale=1024),
    "fused_bn_add_activation_grad": lambda: _compare_grad16(
        "fused_bn_add_activation",
        dict(_bn16(_r(10, 4, 8, 5, 5, scale=2), 8),
             Z=[(_r(11, 4, 8, 5, 5), "f16")]),
        dict(_BN_ATTRS, data_layout="NCHW", act_type="relu"),
        _BN_GRAD_OUTS, ["y"], ulps=FUSED_BN_GRAD_ULPS, f32_tol=1e-5,
        cot_scale=1024),
    "fused_conv_bn_act_grad-nchw": lambda: _compare_grad16(
        "fused_conv_bn_act", *_fused_conv16("NCHW", False),
        _FUSED_CONV_GRAD_OUTS, ["out"], ulps=FUSED_CONV_GRAD_ULPS,
        f32_tol=1e-4, grad_f32_tol=1e-3, cot_scale=1024),
    "fused_conv_bn_act_grad-nhwc-z": lambda: _compare_grad16(
        "fused_conv_bn_act", *_fused_conv16("NHWC", True),
        _FUSED_CONV_GRAD_OUTS, ["out"], ulps=FUSED_CONV_GRAD_ULPS,
        f32_tol=1e-4, grad_f32_tol=1e-3, cot_scale=1024),
    "mul_grad": lambda: _compare_grad16(
        "mul", {"X": [(_r(3, 64, 400), "f16")],
                "Y": [(_r(4, 400, 120, scale=0.05), "f16")]},
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": ["out"]},
        ["out"], ulps=1, f32_tol=0, cot_scale=1024),
    "elementwise_add_grad-fp16-f32": lambda: _compare_grad16(
        "elementwise_add", {"X": [(_r(5, 4, 6), "f16")],
                            "Y": [(_r(6, 6), "f32")]},
        {"axis": 1}, {"Out": ["out"]}, ["out"], ulps=0, f32_tol=0,
        cot_scale=1024),
    "elementwise_mul_grad-scaled-loss": lambda: _compare_grad16(
        "elementwise_mul", {"X": [(_r(8, 1), "f32")],
                            "Y": [(np.array([32768.0], np.float32),
                                   "f32")]},
        {"axis": -1}, {"Out": ["out"]}, ["out"], ulps=0, f32_tol=0),
    "scale_grad": lambda: _compare_grad16(
        "scale", {"X": [(_r(10, 5, 6), "f32")]},
        {"scale": 128.0, "bias": 0.0, "bias_after_scale": True},
        {"Out": ["out"]}, ["out"], ulps=0, f32_tol=0),
    "cast_grad-fp16": lambda: _compare_grad16(
        "cast", {"X": [(_r(0, 5, 6, scale=3), "f32")]},
        {"in_dtype": 5, "out_dtype": 4}, {"Out": ["out"]}, ["out"], ulps=0,
        f32_tol=0, cot_scale=1024),
}
#: batch_norm_grad, which JAX replays under jax.vjp, with unscaled
#: cotangents: XLA's CPU sums the fp16 products dy * x and dy in fp16, as
#: it does in bf16 (a divergence, ROADMAP.md Queue 3; the port sums in
#: f32, as JAX's fused BN grads do), so dX within BN_GRAD_ULPS half-ulps of
#: its largest (measured 3.6 NCHW, 2.2 NHWC) and dScale / dBias (f32)
#: within BN_GRAD_F32 relative (measured 1.7e-3); loss-scaled, those fp16
#: sums overflow (test below).  The fused BN grads (closed forms, f32 sums
#: on both sides: dScale and dBias equal) and the fused conv grad (with
#: the conv's summation order) within FUSED_BN_GRAD_ULPS and
#: FUSED_CONV_GRAD_ULPS half-ulps, from the forward's BN rounding
#: (measured 1.9 and 1.7)
BN_GRAD_ULPS, BN_GRAD_F32 = 8, 4e-3
FUSED_BN_GRAD_ULPS = 4
FUSED_CONV_GRAD_ULPS = 4


@pytest.mark.parametrize("case", sorted(LOWERINGS))
def test_fp16_lowering_matches_jax(case):
    LOWERINGS[case]()


def test_jax_batch_norm_grad_overflows_fp16_under_loss_scaling():
    """The divergence above at a loss scale of 1024: JAX's fp16 partial
    sums of dy overflow (dBias Inf, dX NaN), the port's f32 sums do not
    (dBias 1024 times the unscaled one within BN_GRAD_F32)."""
    spec = _bn16(_r(8, 4, 8, 5, 5, scale=2), 8)
    ins = {s: [(f"{s.lower()}{i}", _h(a) if dt == "f16" else a)
               for i, (a, dt) in enumerate(items)]
           for s, items in spec.items()}
    attrs = dict(_BN_ATTRS, data_layout="NCHW")
    fwd, _ = _grad_run("batch_norm", ins, _BN_GRAD_OUTS, attrs, {})
    y = _f32(fwd["y"])
    dy = np.random.RandomState(0).randn(*y.shape) + y / float(y.std())
    base = None
    for scale in (1, 1024):
        want, got = _grad_run("batch_norm", ins, _BN_GRAD_OUTS, attrs,
                              {"y@GRAD": _h(dy * scale)})
        if scale == 1:
            base = _f32(got["bias0@GRAD"])
            continue
        assert not np.isfinite(_f32(want["bias0@GRAD"])).all()
        assert not np.isfinite(_f32(want["x0@GRAD"])).all()
        db = _f32(got["bias0@GRAD"])
        assert np.isfinite(_f32(got["x0@GRAD"])).all()
        np.testing.assert_allclose(db, 1024 * base, rtol=BN_GRAD_F32,
                                   atol=BN_GRAD_F32 * np.abs(db).max())


# ==========================================================================
# the loss-scaling ops, bit for bit
# ==========================================================================
def _bits(v):
    a = np.ascontiguousarray(_f32(v) if str(getattr(v, "dtype", "")) in (
        "bfloat16", "torch.bfloat16") else np.asarray(v))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("bad", ["inf", "nan", "finite"])
def test_amp_check_finite_and_scale_matches_jax_bit_for_bit(bad):
    """Three f32 and one fp16 gradient (an fp16 gradient comes out f32, as
    jnp promotes it against the f32 scale): on a clean step each times the
    scale, on a found-Inf step every one zero (+0, a select)."""
    grads = [_r(0, 5, 6, scale=100), _r(1, 7, scale=1e-3), _r(2, 3, 2, 2),
             _h(_r(3, 9))]
    if bad != "finite":
        grads[2].flat[5] = np.inf if bad == "inf" else np.nan
        grads[0].flat[0] = -np.inf if bad == "inf" else 1.0
    spec = {"X": [(np.asarray(g), "f16" if g.dtype == np.float16 else "f32")
                  for g in grads],
            "Scale": [(np.array([1.0 / 26214.4], np.float32), "f32")]}
    jins, tins = _spec_pairs(spec)
    outs = {"Out": 4, "FoundInfinite": 1}
    want = _jit_op("amp_check_finite_and_scale", jins, {}, outs)
    got = _port_op("amp_check_finite_and_scale", tins, {}, outs)
    assert bool(got["FoundInfinite"][0][0]) == (bad != "finite")
    assert got["FoundInfinite"][0].dtype == torch.bool
    np.testing.assert_array_equal(got["FoundInfinite"][0].numpy(),
                                  want["FoundInfinite"][0])
    for w, g in zip(want["Out"], got["Out"]):
        assert str(g.dtype) == "torch.float32" == "torch." + str(w.dtype)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        if bad != "finite":
            assert not np.signbit(g.numpy()).any() and not g.any()


def test_update_loss_scaling_matches_jax_over_a_scripted_run():
    """12 steps with incr_every_n_steps=3, decr_every_n_nan_or_inf=2 and a
    decrease ratio of 0.25 from a scale of 1e-10: two increases (the good
    run reset each time), two decreases onto the 1e-10 floor (the bad run
    reset), a clean step resetting the bad run and a found-Inf step
    resetting the good run; every output bit for bit at every step."""
    pattern = [False, False, False, True, True, False, True, False, False,
               False, True, True]
    attrs = {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.25}
    outs = {"LossScalingOut": 1, "OutGoodSteps": 1, "OutBadSteps": 1}
    state = (np.array([1e-10], np.float32), np.array([0], np.int32),
             np.array([0], np.int32))
    seen = []
    for found in pattern:
        spec = {"FoundInfinite": [np.array([found])],
                "PrevLossScaling": [state[0]], "InGoodSteps": [state[1]],
                "InBadSteps": [state[2]]}
        want = _jit_op("update_loss_scaling",
                       {k: [jnp.asarray(a) for a in v]
                        for k, v in spec.items()}, attrs, outs)
        got = _port_op("update_loss_scaling",
                       {k: [torch.from_numpy(np.array(a)) for a in v]
                        for k, v in spec.items()}, attrs, outs)
        for slot in outs:
            g, w = got[slot][0].numpy(), want[slot][0]
            assert g.dtype == w.dtype and g.shape == w.shape == (1,)
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=slot)
        state = tuple(got[s][0].numpy() for s in outs)
        seen.append((float(state[0][0]), int(state[1][0]),
                     int(state[2][0])))
    scales = [s for s, _, _ in seen]
    assert scales[2] == np.float32(2e-10) and scales[4] == np.float32(1e-10)
    assert scales[9] == np.float32(2e-10) and scales[11] == np.float32(1e-10)
    assert [g for _, g, _ in seen] == [1, 2, 0, 0, 0, 1, 0, 1, 2, 0, 0, 0]
    assert [b for _, _, b in seen] == [0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0]


def test_load_numpy_state_carries_int32_and_bool_state():
    """The scaling state JAX's startup scope hands over (int32 counters,
    an f32 scale; the found-Inf flag is bool), and fp16 end to end: the
    dtype map and a fetched fp16 value, which numpy holds as it is."""
    from paddle_tpu_torch.executor import as_numpy
    from paddle_tpu_torch.framework.dtype import to_torch_dtype

    assert to_torch_dtype(TVarType.FP16) == torch.float16
    assert as_numpy(torch.ones(2, dtype=torch.float16)).dtype == np.float16
    scope = TScope()
    load_numpy_state(scope, {"good": np.array([3], np.int32),
                             "found": np.array([True]),
                             "scale": np.array([32768.0], np.float32)},
                     "cpu")
    assert scope.get("good").dtype == torch.int32
    assert scope.get("found").dtype == torch.bool and bool(scope.get("found"))
    back = numpy_state(scope, ["good", "found", "scale"])
    assert back["good"].dtype == np.int32 and back["found"].dtype == np.bool_


# ==========================================================================
# training
# ==========================================================================
def _scaling_names(program):
    """(scale, found-Inf, good steps, bad steps) var names of a program
    under dynamic loss scaling (either package)."""
    op_ = next(o for o in program.global_block().ops
               if o.type == "update_loss_scaling")
    return (op_.input("PrevLossScaling")[0], op_.input("FoundInfinite")[0],
            op_.input("InGoodSteps")[0], op_.input("InBadSteps")[0])


def _history(exe, main, loss, feed, scope, steps, snapshot=()):
    """Per step: the loss, then the scale, found-Inf flag and the two
    counters after it; with ``snapshot``, those vars' values after each
    step too."""
    names = _scaling_names(main)
    hist, snaps = [], []
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss, *names],
                      scope=scope)
        hist.append((float(np.asarray(out[0])), float(out[1][0]),
                     bool(out[2][0]), int(out[3][0]), int(out[4][0])))
        snaps.append({n: np.array(np.asarray(scope.get(n)) if not
                                  isinstance(scope.get(n), torch.Tensor)
                                  else scope.get(n).numpy())
                      for n in snapshot})
    return hist, snaps


def _train_fp16(model, feed, steps, amp=SCALINGS["dynamic"], depth=18,
                image=32, snapshot=False):
    (jmain, jstart, jloss), (tmain, _, tloss) = [
        _build(pkg, model, depth, image, train=True, amp=amp)
        for pkg in (JAX, PORT)]
    jexe = pt.Executor(pt.CPUPlace())
    jscope, start = _start_scope(jexe, jstart)
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = [n for n in start if "velocity" not in n and "loss_scal" not in n
              and "_mean" not in n and "_variance" not in n] \
        if snapshot else ()
    jh, _ = _history(jexe, jmain, jloss, feed, jscope, steps)
    th, snaps = _history(texe, tmain, tloss, feed, tscope, steps, params)
    plan = list(texe._cache.values())[-1]
    return jh, th, start, snaps, [o.type for o in plan.ops]


#: the book models, 4 fp16 steps from one startup scope: every loss within
#: 1e-5 relative of JAX's (measured: LeNet 6.8e-8, equal but at step 3;
#: word2vec equal)
BOOK16_RTOL = 1e-5


@pytest.mark.parametrize("model", ["lenet", "word2vec"])
def test_book_models_fp16_training_matches_jax(monkeypatch, model):
    """JAX unfused (its fused AMP fc grad fails, below) against the port
    unfused and fused, which agree bit for bit; the scale and found-Inf
    history (no Inf here: the scale stays 2^15) equal at every step."""
    _set_flags(monkeypatch, False, False)
    jh, th, _, _, _ = _train_fp16(model, _book_feed(model), 4)
    _set_flags(monkeypatch, True, False)
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "0")
    _, th_fused, _, _, types = _train_fp16(model, _book_feed(model), 4)
    assert types.count("fused_matmul_bias_act") == {"lenet": 2,
                                                    "word2vec": 1}[model]
    assert th_fused == th
    assert [h[1:] for h in th] == [h[1:] for h in jh]
    assert [h[1:3] for h in th] == [(32768.0, False)] * 4
    tl, jl = [h[0] for h in th], [h[0] for h in jh]
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=BOOK16_RTOL)


def test_jax_fused_matmul_grad_cannot_run_an_fp16_amp_program(monkeypatch):
    """As in bf16: JAX's fused fc grad hands ``jax.vjp`` an fp16
    cotangent for the f32 output, and JAX refuses it."""
    _set_flags(monkeypatch, True, False)
    jmain, jstart, jloss = _build(JAX, "lenet", train=True,
                                  amp=SCALINGS["dynamic"])
    jexe = pt.Executor(pt.CPUPlace())
    jscope, _ = _start_scope(jexe, jstart)
    with pytest.raises(Exception, match="VJP|vjp"):
        jexe.run(jmain, feed=_book_feed("lenet"), fetch_list=[jloss],
                 scope=jscope)


def test_resnet18_fp16_finds_inf_at_every_step_as_jax(monkeypatch):
    """ResNet-18 at batch 4, 32x32 under decorate's defaults (2^15): both
    packages find an Inf at each of 4 steps, so every gradient is zeroed,
    the parameters never move, the loss stays where it was, and the scale
    walks 32768, 26214.4, 26214.4, 20971.52 with the bad-step run
    1, 0 (reset by the decrease), 1, 0.  The step-1 loss within 2e-3
    relative (measured 1.0e-3: BatchNorm's fp16 rounding, above)."""
    _set_flags(monkeypatch, False, False)
    jh, th, start, snaps, _ = _train_fp16("resnet", _resnet_feed(32), 4,
                                          snapshot=True)
    assert [h[1:] for h in th] == [h[1:] for h in jh]
    assert all(h[2] for h in th)
    decr = np.float32(0.8)
    assert [h[1] for h in th] == [32768.0, np.float32(32768.0) * decr,
                                  np.float32(32768.0) * decr,
                                  np.float32(32768.0) * decr * decr]
    assert [(h[3], h[4]) for h in th] == [(0, 1), (0, 0), (0, 1), (0, 0)]
    assert len({h[0] for h in th}) == 1
    assert abs(th[0][0] - jh[0][0]) <= 2e-3 * abs(jh[0][0])
    for snap in snaps:
        for n, v in snap.items():
            np.testing.assert_array_equal(v, start[n], err_msg=n)


#: a clean fp16 ResNet-18 run (batch 4, 32x32) at init_loss_scaling 1024,
#: where no step finds an Inf in either package (at 2^15 every step does,
#: above): the found-Inf history and the scale equal; step 1 within 2e-3
#: relative (measured 1.0e-3), and every state tensor after step 1 within
#: the JAX noise envelope (``_check_after_step_1``)
CLEAN_SCALE = 1024.0


def test_resnet18_fp16_clean_run_matches_jax(monkeypatch):
    _set_flags(monkeypatch, False, False)
    amp = dict(use_fp16=True, init_loss_scaling=CLEAN_SCALE)
    (jmain, jstart, jloss), (tmain, _, tloss) = [
        _build(pkg, "resnet", train=True, amp=amp) for pkg in (JAX, PORT)]
    jexe = pt.Executor(pt.CPUPlace())
    jscope, start = _start_scope(jexe, jstart)
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = _resnet_feed(32)
    jh, _ = _history(jexe, jmain, jloss, feed, jscope, 1)
    th, _ = _history(texe, tmain, tloss, feed, tscope, 1)
    want = {n: np.asarray(jscope.get(n)) for n in start}
    errs = rel_errs(numpy_state(tscope, list(start)), want)
    jh2, _ = _history(jexe, jmain, jloss, feed, jscope, 2)
    th2, _ = _history(texe, tmain, tloss, feed, tscope, 2)
    assert [h[1:] for h in th + th2] == [h[1:] for h in jh + jh2]
    assert not any(h[2] for h in th + th2)
    assert abs(th[0][0] - jh[0][0]) <= 2e-3 * abs(jh[0][0])
    assert th2[-1][0] < th[0][0]
    twin = JScope()
    for n, v in start.items():
        twin.set(n, v.copy())
    noisy = feed["img"] * (1 + NOISE * np.random.RandomState(1).randn(
        *feed["img"].shape))
    jexe.run(jmain, feed={"img": noisy.astype(np.float32),
                          "label": feed["label"]},
             fetch_list=[jloss], scope=twin)
    noise = rel_errs({n: np.asarray(twin.get(n)) for n in start}, want)
    state = {n for n in start if "loss_scaling" not in n}
    _check_after_step_1({n: e for n, e in errs.items() if n in state},
                        {n: e for n, e in noise.items() if n in state})


def test_port_fp16_fusion_and_layout_change_no_number(monkeypatch):
    """The fp16 ResNet-18 program from a clean scale (CLEAN_SCALE) in the
    port alone: fused == unfused bit for bit over 2 steps (losses, the
    scale history and every state tensor: the fused ops round where the
    unfused chain rounds), and NHWC's step 1 within 1e-6 of NCHW's (the
    same products in another memory order)."""
    amp = dict(use_fp16=True, init_loss_scaling=CLEAN_SCALE)
    runs, states = {}, {}
    for fuse, nhwc in ((False, False), (True, False), (True, True)):
        _set_flags(monkeypatch, fuse, nhwc)
        main, startup, loss = _build(PORT, "resnet", train=True, amp=amp)
        scope = TScope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs[(fuse, nhwc)], _ = _history(exe, main, loss, _resnet_feed(32),
                                         scope, 2)
        states[(fuse, nhwc)] = numpy_state(scope, [n for n, _ in
                                                   scope.items()])
        types = [o.type for o in list(exe._cache.values())[-1].ops]
        assert types.count("fused_conv_bn_act") == (17 if fuse else 0)
        assert (types.count("transpose2") > 0) == nhwc
    assert runs[(False, False)] == runs[(True, False)]
    assert not any(h[2] for h in runs[(True, False)])
    unfused, fused = states[(False, False)], states[(True, False)]
    assert sorted(unfused) == sorted(fused)
    for n in unfused:
        np.testing.assert_array_equal(fused[n], unfused[n], err_msg=n)
    a, b = runs[(True, False)][0][0], runs[(True, True)][0][0]
    assert abs(a - b) <= 1e-6 * abs(a)


# ==========================================================================
# the tools
# ==========================================================================
def test_train_resnet_tool_amp_dtype_float16(capsys):
    from paddle_tpu_torch.tools import train_resnet as tool

    main, _, _, _ = tool.build_program(18, 32, 10, 0.1, amp_dtype="float16")
    assert tool.loss_scaling_state(main) is not None
    assert tool.loss_scaling_state(
        tool.build_program(18, 32, 10, 0.1)[0]) is None
    with pytest.raises(ValueError, match="amp_dtype"):
        tool.build_program(18, 32, 10, 0.1, amp_dtype="float8")
    tool.main(["--tiny", "--device", "cpu", "--amp-dtype", "float16",
               "--log-every", "1", "--warmup", "0"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3 and all("scale" in ln and "found_inf" in ln
                                   for ln in lines)


@pytest.mark.parametrize("model", ["lenet", "word2vec"])
def test_train_book_tool_fp16_tiny_on_cpu(capsys, model):
    from paddle_tpu_torch.tools import train_book as tool

    tool.main(["--model", model, "--tiny", "--device", "cpu", "--amp-dtype",
               "float16", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "(AMP fp16)" in out and "scale 32768" in out
    run = tool.train(model, tool.TINY[model], steps=2, device="cpu",
                     log_every=0, amp=True, amp_dtype="float16")
    assert run["found_inf"] == [False, False]
    assert run["loss_scaling"] == [32768.0, 32768.0]
