"""PyTorch port, the lowerings of JAX's ``math_ops`` and ``nn_ops`` that
the port's first slices left out (the activations and unary math, the
norms, arg and index ops, the predicates and logical ops, the transposed
and 3-D convolutions, group and instance norm, prelu, the pads, the
interpolations, grid sampling, the metrics and the simple losses, and
the input forms ``top_k`` with a K tensor, adaptive ``pool2d`` and
average pooling over explicit pads) against the JAX package's, one
parametrised case per op type and variant, forward and grad, through
``test_torch_static_ops``'s harness (each package's ``registry.run_op``,
then the grad op its grad maker writes, on the same cotangents), JAX's
side under one ``jax.jit`` a case, as JAX's executor runs a program.

The cases put the edge points in the inputs (``_edges``): there the
port follows JAX's gradient, not torch's: ``abs'(0) = 1``,
``leaky_relu'(0) = 1``, half the gradient at each edge of a clip
(``relu6``, ``brelu``, ``soft_relu``) and at a tie of ``maximum`` /
``minimum``, and ``p_norm``'s NaN at the zero vector (NaN equals NaN in
the comparison).

Tolerances, f32: rtol 1e-5 / atol 1e-5 (``TIGHT``) for elementwise and
reduction results; 1e-4 (``SUMS``) where a convolution or resize sums
products in another order; 2e-5 for the transcendental functions whose
ulps differ between XLA's CPU and ATen (``TRANS``).
"""
import jax
import numpy as np
import pytest

import paddle_tpu.framework.core as jcore
import paddle_tpu.ops.registry as jreg
from test_torch_static_ops import GRAD, SUMS, TIGHT, _jax, _port, _r, _run

TRANS = dict(rtol=2e-5, atol=2e-5)


def _jax_jit(op_type, ins, outs, attrs, cot_of, int_slots, seed):
    """JAX's forward and grad in one ``jax.jit`` (one XLA compile a case,
    not one per primitive, as the JAX executor runs a program): the
    cotangents shaped by ``jax.eval_shape`` of the forward; (results,
    cotangents)."""
    arrays = {n: a for items in ins.values() for n, a in items}

    def run(arrs, cots):
        traced = {slot: [(n, arrs[n]) for n, _ in items]
                  for slot, items in ins.items()}
        return _run(jcore, jreg, lambda v: v, lambda v: v, op_type, traced,
                    outs, attrs, cots, int_slots=int_slots)

    shapes = jax.eval_shape(lambda a: run(a, {}), arrays)
    rng = np.random.RandomState(seed)
    cots = {n + GRAD: np.asarray(rng.randn(*shapes[n].shape), np.float32)
            for n in cot_of}
    res = jax.jit(run)(arrays, cots)
    return {n: np.asarray(v) for n, v in res.items()}, cots


def _check(op_type, ins, outs, attrs=None, cot_of=(), tol=TIGHT,
           int_slots=(), seed=0):
    """``test_torch_static_ops._check`` with JAX's side under ``jax.jit``
    (an op whose lowering reads a value on the host runs op by op)."""
    attrs = attrs or {}
    try:
        j, cots = _jax_jit(op_type, ins, outs, attrs, cot_of, int_slots,
                           seed)
    except jax.errors.ConcretizationTypeError:
        rng = np.random.RandomState(seed)
        fwd = _jax(op_type, ins, outs, attrs, {}, int_slots=int_slots)
        cots = {n + GRAD: np.asarray(rng.randn(*np.shape(fwd[n])),
                                     np.float32) for n in cot_of}
        j = _jax(op_type, ins, outs, attrs, cots, int_slots=int_slots)
    t = _port(op_type, ins, outs, attrs, cots, int_slots=int_slots)
    assert set(t) == set(j), (sorted(t), sorted(j))
    for n in j:
        assert np.shape(t[n]) == np.shape(j[n]), n
        np.testing.assert_allclose(np.asarray(t[n], np.float64),
                                   np.asarray(j[n], np.float64),
                                   err_msg=n, **tol)
    return j, t


def _edges(*points, scale=4.0):
    x = _r(0, 6, 7) * scale
    x.flat[:len(points)] = points
    return x


def _unary(op_type, x, attrs=None, grad=True, tol=TIGHT):
    return _check(op_type, {"X": [("x", x)]}, {"Out": ["o"]}, attrs,
                  cot_of=["o"] if grad else (), tol=tol)


def _pair(op_type, x, y, attrs=None, grad=True, tol=TIGHT):
    return _check(op_type, {"X": [("x", x)], "Y": [("y", y)]},
                  {"Out": ["o"]}, attrs, cot_of=["o"] if grad else (),
                  tol=tol)


_UNIT = np.tanh(_r(3, 5, 6)) * 0.95            # inside (-1, 1)
_POS = np.abs(_r(4, 5, 6)) + 0.1
_TIES = np.where(np.arange(30).reshape(5, 6) % 4 == 0, _r(0, 5, 6),
                 _r(1, 5, 6))

CASES = {
    # -- the activations and unary math, edges in their inputs ------------
    "abs": lambda: _unary("abs", _edges(0.0, -0.0, 1.0, -1.0)),
    "acos": lambda: _unary("acos", _UNIT, tol=TRANS),
    "asin": lambda: _unary("asin", _UNIT, tol=TRANS),
    "atan": lambda: _unary("atan", _r(0, 5, 6) * 3, tol=TRANS),
    "cosh": lambda: _unary("cosh", _r(0, 5, 6) * 2, tol=TRANS),
    "sinh": lambda: _unary("sinh", _r(0, 5, 6) * 2, tol=TRANS),
    "tan": lambda: _unary("tan", _UNIT * 1.3, tol=TRANS),
    "sin": lambda: _unary("sin", _r(0, 5, 6) * 3, tol=TRANS),
    "log": lambda: _unary("log", _POS, tol=TRANS),
    "log2": lambda: _unary("log2", _POS, tol=TRANS),
    "log10": lambda: _unary("log10", _POS, tol=TRANS),
    "log1p": lambda: _unary("log1p", _POS - 0.5, tol=TRANS),
    "expm1": lambda: _unary("expm1", _r(0, 5, 6), tol=TRANS),
    "round": lambda: _unary("round", _edges(0.5, 1.5, -0.5, 2.5, -2.5)),
    "logsigmoid": lambda: _unary("logsigmoid", _edges(0.0, 30.0, -30.0),
                                 tol=TRANS),
    "tanh_shrink": lambda: _unary("tanh_shrink", _r(0, 5, 6), tol=TRANS),
    "softplus": lambda: _unary("softplus", _edges(0.0, 30.0, -30.0),
                               tol=TRANS),
    "softsign": lambda: _unary("softsign", _edges(0.0, -0.0)),
    "leaky_relu": lambda: _unary("leaky_relu", _edges(0.0, -0.0),
                                 {"alpha": 0.1}),
    "relu6": lambda: _unary("relu6", _edges(0.0, 6.0, -0.0),
                            {"threshold": 6.0}),
    "elu": lambda: _unary("elu", _edges(0.0), {"alpha": 1.5}, tol=TRANS),
    "swish": lambda: _unary("swish", _edges(0.0), {"beta": 1.3},
                            tol=TRANS),
    "silu": lambda: _unary("silu", _edges(0.0), tol=TRANS),
    "brelu": lambda: _unary("brelu", _edges(-1.0, 2.0),
                            {"t_min": -1.0, "t_max": 2.0}),
    "stanh": lambda: _unary("stanh", _r(0, 5, 6),
                            {"scale_a": 0.67, "scale_b": 1.7159}, tol=TRANS),
    "soft_relu": lambda: _unary("soft_relu", _edges(3.0, -3.0),
                                {"threshold": 3.0}, tol=TRANS),
    "thresholded_relu": lambda: _unary("thresholded_relu", _edges(1.0),
                                       {"threshold": 1.0}),
    "hard_shrink": lambda: _unary("hard_shrink", _edges(0.5, -0.5),
                                  {"threshold": 0.5}),
    "pow": lambda: _unary("pow", _POS, {"factor": 2.5}, tol=TRANS),
    "pow-int-factor": lambda: _unary("pow", _edges(0.0, -2.0),
                                     {"factor": 3.0}),
    "pow-factor-tensor": lambda: _check(
        "pow", {"X": [("x", _POS)],
                "FactorTensor": [("f", np.array([1.7], np.float32))]},
        {"Out": ["o"]}, cot_of=["o"], tol=TRANS),
    # -- norms, log-sum-exp ------------------------------------------------
    "p_norm": lambda: _unary(
        "p_norm", np.concatenate([np.zeros((1, 6), np.float32),
                                  _r(0, 4, 6)]),
        {"porder": 2.0, "axis": -1, "keepdim": False}),
    "p_norm-1": lambda: _unary("p_norm", _edges(0.0),
                               {"porder": 1.0, "axis": 0, "keepdim": True}),
    "p_norm-3": lambda: _unary("p_norm", _edges(0.0),
                               {"porder": 3.0, "axis": 1}, tol=TRANS),
    "p_norm-inf": lambda: _unary("p_norm", _edges(0.0),
                                 {"porder": float("inf"), "axis": 1}),
    "p_norm-neg-inf": lambda: _unary("p_norm", _edges(0.0),
                                     {"porder": float("-inf"), "axis": 1}),
    "p_norm-0": lambda: _unary("p_norm", _edges(0.0, 0.0),
                               {"porder": 0.0, "axis": 1}),
    "frobenius_norm": lambda: _unary(
        "frobenius_norm", _r(0, 3, 4, 5),
        {"dim": [1, 2], "keep_dim": False, "reduce_all": False}),
    "frobenius_norm-all": lambda: _unary(
        "frobenius_norm", _r(0, 3, 4),
        {"dim": [0], "keep_dim": True, "reduce_all": True}),
    "logsumexp": lambda: _unary(
        "logsumexp", _r(0, 3, 4, 5) * 3,
        {"axis": [1, 2], "keepdim": True, "reduce_all": False}),
    "logsumexp-all": lambda: _unary(
        "logsumexp", _r(0, 3, 4) * 3, {"axis": [0], "reduce_all": True}),
    # -- arg ops, sort, top-k, cumsum (ties: the first index wins) --------
    "arg_max": lambda: _unary("arg_max", np.round(_r(0, 4, 7)), {"axis": 1},
                              grad=False),
    "arg_max-keepdims": lambda: _unary(
        "arg_max", _r(0, 4, 7), {"axis": 0, "keepdims": True}, grad=False),
    "arg_max-flatten": lambda: _unary(
        "arg_max", _r(0, 4, 7), {"axis": 0, "flatten": True}, grad=False),
    "arg_min": lambda: _unary("arg_min", np.round(_r(0, 4, 7)),
                              {"axis": -1}, grad=False),
    "argsort": lambda: _check(
        "argsort", {"X": [("x", np.round(_r(0, 4, 9)))]},
        {"Out": ["o"], "Indices": ["i"]}, {"axis": -1}),
    "argsort-descending": lambda: _check(
        "argsort", {"X": [("x", np.round(_r(0, 6, 4)))]},
        {"Out": ["o"], "Indices": ["i"]}, {"axis": 0, "descending": True}),
    "top_k_v2": lambda: _check(
        "top_k_v2", {"X": [("x", _edges(np.nan, scale=0.7).round()[:5])]},
        {"Out": ["o"], "Indices": ["i"]}, {"k": 3, "axis": 0}),
    "top_k_v2-smallest": lambda: _check(
        "top_k_v2", {"X": [("x", np.round(_r(0, 5, 8)))]},
        {"Out": ["o"], "Indices": ["i"]}, {"k": 4, "largest": False}),
    "top_k-k-tensor": lambda: _check(
        "top_k", {"X": [("x", _r(0, 4, 10))],
                  "K": [("k", np.array(2, np.int32))]},
        {"Out": ["o"], "Indices": ["i"]}, {"k": 5}, int_slots=("K",)),
    "cumsum": lambda: _unary("cumsum", _r(0, 3, 5), {"axis": 1}),
    "cumsum-reverse-exclusive": lambda: _unary(
        "cumsum", _r(0, 3, 5), {"axis": 0, "reverse": True,
                                "exclusive": True}),
    "cumsum-flatten": lambda: _unary("cumsum", _r(0, 3, 5),
                                     {"flatten": True, "exclusive": True}),
    # -- products, elementwise pairs --------------------------------------
    "dot": lambda: _pair("dot", _r(0, 4, 6), _r(1, 4, 6)),
    "addmm": lambda: _check(
        "addmm", {"Input": [("i", _r(2, 4, 5))], "X": [("x", _r(0, 4, 6))],
                  "Y": [("y", _r(1, 6, 5))]},
        {"Out": ["o"]}, {"Alpha": 0.5, "Beta": 2.0}, cot_of=["o"],
        tol=SUMS),
    "kron": lambda: _pair("kron", _r(0, 2, 3), _r(1, 3, 2)),
    "trace": lambda: _check(
        "trace", {"Input": [("x", _r(0, 3, 4, 5))]}, {"Out": ["o"]},
        {"offset": 1, "axis1": 1, "axis2": 2}, cot_of=["o"]),
    "matmul_with_flatten": lambda: _pair(
        "matmul_with_flatten", _r(0, 4, 2, 3), _r(1, 6, 5),
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, tol=SUMS),
    "maximum": lambda: _pair("maximum", _r(0, 5, 6), _TIES),
    "minimum": lambda: _pair("minimum", _r(0, 5, 6), _TIES),
    # -- predicates and logical ops (no grads) ----------------------------
    "isfinite": lambda: _unary("isfinite", _edges(np.inf), grad=False),
    "isfinite-clean": lambda: _unary("isfinite", _r(0, 3, 4), grad=False),
    "isfinite_v2": lambda: _unary("isfinite_v2", _edges(np.inf, -np.inf,
                                                        np.nan), grad=False),
    "isinf": lambda: _unary("isinf", _edges(-np.inf), grad=False),
    "isinf_v2": lambda: _unary("isinf_v2", _edges(np.inf, np.nan),
                               grad=False),
    "isnan": lambda: _unary("isnan", _edges(np.nan), grad=False),
    "isnan-clean": lambda: _unary("isnan", _edges(np.inf), grad=False),
    "isnan_v2": lambda: _unary("isnan_v2", _edges(np.inf, np.nan),
                               grad=False),
    "logical_and": lambda: _pair("logical_and", _r(0, 4, 5) > 0,
                                 _r(1, 4, 5) > 0, grad=False),
    "logical_or": lambda: _pair("logical_or", _r(0, 4, 5) > 0,
                                _r(1, 5) > 0, {"axis": -1}, grad=False),
    "logical_xor": lambda: _pair("logical_xor", _r(0, 4, 5) > 0,
                                 _r(1, 4, 5) > 0, grad=False),
    "logical_not": lambda: _unary("logical_not", _r(0, 4, 5) > 0,
                                  grad=False),
}


# -- convolutions ----------------------------------------------------------
def _conv_t(op_type, x, w, tol=SUMS, **attrs):
    a = dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1], groups=1,
             data_format="NCHW")
    a.update(attrs)
    return _check(op_type, {"Input": [("x", x)], "Filter": [("w", w)]},
                  {"Output": ["o"]}, a, cot_of=["o"], tol=tol)


_W3 = dict(strides=[1, 1, 1], paddings=[0, 0, 0], dilations=[1, 1, 1],
           data_format="NCDHW")

CASES.update({
    "conv2d_transpose": lambda: _conv_t(
        "conv2d_transpose", _r(1, 2, 4, 5, 5), _r(2, 4, 3, 3, 3) * 0.3,
        strides=[2, 2], paddings=[1, 1]),
    "conv2d_transpose-output-padding-groups": lambda: _conv_t(
        "conv2d_transpose", _r(1, 2, 4, 5, 6), _r(2, 4, 3, 3, 2) * 0.3,
        strides=[2, 3], paddings=[1, 0], groups=2, output_padding=[1, 2],
        dilations=[1, 2]),
    "conv2d_transpose-asym-nhwc": lambda: _conv_t(
        "conv2d_transpose", _r(1, 2, 5, 5, 4), _r(2, 4, 3, 3, 3) * 0.3,
        strides=[2, 2], paddings=[1, 2, 0, 1], data_format="NHWC"),
    "depthwise_conv2d_transpose": lambda: _conv_t(
        "depthwise_conv2d_transpose", _r(1, 2, 4, 5, 5),
        _r(2, 4, 1, 3, 3) * 0.3, strides=[2, 2], paddings=[1, 1],
        groups=4),
    "conv3d": lambda: _conv_t(
        "conv3d", _r(1, 2, 3, 5, 6, 5), _r(2, 4, 3, 3, 3, 3) * 0.3,
        **dict(_W3, strides=[1, 2, 1], paddings=[1, 1, 0])),
    "conv3d-groups-asym-ndhwc": lambda: _conv_t(
        "conv3d", _r(1, 2, 5, 5, 6, 4), _r(2, 6, 2, 3, 1, 3) * 0.3,
        **dict(_W3, paddings=[1, 0, 0, 0, 2, 1], groups=2,
               data_format="NDHWC")),
    "conv3d_transpose": lambda: _conv_t(
        "conv3d_transpose", _r(1, 2, 3, 4, 3, 4), _r(2, 3, 2, 3, 3, 2) * 0.3,
        **dict(_W3, strides=[2, 1, 2], paddings=[1, 1, 0])),
})


# -- norms, prelu ----------------------------------------------------------
def _norm(op_type, x, c, outs, **attrs):
    rng = np.random.RandomState(5)
    return _check(op_type, {
        "X": [("x", x)],
        "Scale": [("s", (1 + 0.2 * rng.randn(c)).astype(np.float32))],
        "Bias": [("b", rng.randn(c).astype(np.float32))]},
        outs, attrs, cot_of=["y"])


def _prelu(mode, alpha):
    x = _edges(0.0, -0.0, scale=2.0).reshape(2, 3, 7)
    return _check("prelu", {"X": [("x", x)], "Alpha": [("a", alpha)]},
                  {"Out": ["o"]}, {"mode": mode}, cot_of=["o"])


CASES.update({
    "group_norm": lambda: _norm(
        "group_norm", _r(0, 2, 6, 4, 5) * 2 + 1, 6,
        {"Y": ["y"], "Mean": ["m"], "Variance": ["v"]},
        groups=3, epsilon=1e-5),
    "instance_norm": lambda: _norm(
        "instance_norm", _r(0, 2, 4, 5, 5) * 2 + 1, 4,
        {"Y": ["y"], "SavedMean": ["m"], "SavedVariance": ["v"]},
        epsilon=1e-5),
    "prelu": lambda: _prelu("all", np.array([0.25], np.float32)),
    "prelu-channel": lambda: _prelu("channel", _r(6, 1, 3, 1)),
    "prelu-element": lambda: _prelu("element", _r(6, 1, 3, 7)),
})


# -- pads, interpolation, sampling, shifts, indexed pooling ----------------
def _pad2d(mode, fmt):
    x = _r(0, 2, 3, 5, 4) if fmt == "NCHW" else _r(0, 2, 5, 4, 3)
    return _unary("pad2d", x, {"paddings": [1, 2, 0, 3], "mode": mode,
                               "pad_value": 0.5, "data_format": fmt})


def _interp(method, hw, out, **attrs):
    attrs = dict({"align_corners": True, "align_mode": 1}, **attrs)
    if out is not None:
        attrs["out_h"], attrs["out_w"] = out
    return _unary(method + "_interp", _r(0, 2, 3, *hw), attrs, tol=SUMS)


def _grid(mode, pad, align):
    g = np.random.RandomState(3).uniform(-1.2, 1.2, (2, 4, 5, 2))
    return _check("grid_sampler", {"X": [("x", _r(0, 2, 3, 5, 6))],
                                   "Grid": [("g", g.astype(np.float32))]},
                  {"Output": ["o"]}, {"mode": mode, "padding_mode": pad,
                                      "align_corners": align},
                  cot_of=["o"], tol=SUMS)


CASES.update({
    "pad": lambda: _unary("pad", _r(0, 3, 4),
                          {"paddings": [1, 0, 2, 3], "pad_value": 1.5}),
    "pad2d": lambda: _pad2d("constant", "NCHW"),
    "pad2d-reflect": lambda: _pad2d("reflect", "NCHW"),
    "pad2d-edge-nhwc": lambda: _pad2d("edge", "NHWC"),
    "pad3d": lambda: _unary("pad3d", _r(0, 2, 2, 3, 4, 5), {
        "paddings": [1, 0, 2, 1, 0, 2], "mode": "constant", "value": 0.5}),
    "pad3d-reflect": lambda: _unary("pad3d", _r(0, 2, 2, 3, 4, 5), {
        "paddings": [1, 2, 2, 1, 0, 2], "mode": "reflect"}),
    "pad3d-replicate-ndhwc": lambda: _unary("pad3d", _r(0, 2, 3, 4, 5, 2), {
        "paddings": [1, 0, 2, 1, 0, 2], "mode": "replicate",
        "data_format": "NDHWC"}),
    "bilinear_interp": lambda: _interp("bilinear", (6, 5), (13, 11)),
    "bilinear_interp-down": lambda: _interp("bilinear", (12, 10), (5, 4)),
    "bilinear_interp-scale": lambda: _interp("bilinear", (6, 5), None,
                                             scale=1.5, align_corners=False),
    "bilinear_interp-from-1x1": lambda: _interp("bilinear", (1, 1), (6, 6)),
    "nearest_interp": lambda: _interp("nearest", (5, 6), (11, 13)),
    "nearest_interp-down": lambda: _interp("nearest", (12, 11), (5, 4)),
    "bicubic_interp": lambda: _interp("bicubic", (6, 5), (13, 11)),
    "bicubic_interp-down": lambda: _interp("bicubic", (12, 10), (5, 4)),
    "grid_sampler": lambda: _grid("bilinear", "zeros", True),
    "grid_sampler-border": lambda: _grid("bilinear", "border", False),
    "grid_sampler-reflection": lambda: _grid("bilinear", "reflection",
                                             False),
    "grid_sampler-nearest": lambda: _grid("nearest", "zeros", False),
    "temporal_shift": lambda: _unary("temporal_shift", _r(0, 6, 8, 3, 3),
                                     {"seg_num": 3, "shift_ratio": 0.25}),
    "max_pool2d_with_index": lambda: _check(
        "max_pool2d_with_index", {"X": [("x", np.round(_r(0, 2, 3, 7, 7)))]},
        {"Out": ["o"], "Mask": ["m"]},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
        cot_of=["o"]),
    "max_pool2d_with_index-adaptive": lambda: _check(
        "max_pool2d_with_index", {"X": [("x", _r(0, 2, 3, 6, 6))]},
        {"Out": ["o"], "Mask": ["m"]}, {"ksize": [2, 3], "adaptive": True},
        cot_of=["o"]),
    "index_sample": lambda: _check(
        "index_sample", {"X": [("x", _r(0, 4, 6))],
                         "Index": [("i", np.array(
                             [[0, 5], [2, 2], [1, 0], [3, 4]], np.int64))]},
        {"Out": ["o"]}, cot_of=["o"], int_slots=("Index",)),
})


# -- pool2d's input forms: adaptive, average over explicit pads ------------
def _pool(x, tol=TIGHT, **attrs):
    a = {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
         "paddings": [0, 0], "global_pooling": False, "ceil_mode": False,
         "exclusive": True, "data_format": "NCHW",
         "padding_algorithm": "EXPLICIT"}
    a.update(attrs)
    return _unary("pool2d", x, a, tol=tol)


CASES.update({
    "pool2d-adaptive-avg": lambda: _pool(_r(0, 2, 3, 6, 6), ksize=[2, 3],
                                         adaptive=True),
    "pool2d-adaptive-max-ties": lambda: _pool(
        np.round(_r(0, 2, 3, 6, 6)), ksize=[3, 2], adaptive=True,
        pooling_type="max"),
    "pool2d-adaptive-avg-nhwc": lambda: _pool(
        _r(0, 2, 6, 6, 3), ksize=[3, 3], adaptive=True, data_format="NHWC"),
    "pool2d-avg-ceil-exclusive": lambda: _pool(
        _r(0, 2, 3, 7, 7), ksize=[3, 3], paddings=[1, 1], ceil_mode=True),
    "pool2d-avg-ceil-inclusive": lambda: _pool(
        _r(0, 2, 3, 7, 7), ksize=[3, 3], paddings=[1, 1], ceil_mode=True,
        exclusive=False),
    "pool2d-avg-asym-pads": lambda: _pool(
        _r(0, 2, 3, 8, 7), ksize=[3, 3], paddings=[2, 0, 1, 2]),
})


# -- metrics and the simple losses ------------------------------------------
def _mean_iou(label):
    pred = np.random.RandomState(1).randint(0, 5, (2, 6, 6))
    return _check("mean_iou", {"Predictions": [("p", pred.astype(np.int64))],
                               "Labels": [("l", label.astype(np.int64))]},
                  {"OutMeanIou": ["miou"], "OutWrong": ["w"],
                   "OutCorrect": ["c"]}, {"num_classes": 5},
                  int_slots=("Predictions", "Labels"))


def _labels_with(ignore, shape=(2, 6, 6), n=5, seed=2):
    rng = np.random.RandomState(seed)
    lbl = rng.randint(0, n, shape)
    lbl[rng.rand(*shape) < 0.2] = ignore
    return lbl


_PROB = 1 / (1 + np.exp(-_r(0, 4, 5)))
_BIN = (np.random.RandomState(2).rand(4, 5) > 0.5).astype(np.float32)

CASES.update({
    "mean_iou": lambda: _mean_iou(_labels_with(255)),
    "mean_iou-negative-labels": lambda: _mean_iou(_labels_with(-1)),
    "cvm": lambda: _check("cvm", {"X": [("x", np.abs(_r(0, 4, 6)))]},
                          {"Y": ["y"]}, {"use_cvm": True}, cot_of=["y"]),
    "cvm-drop": lambda: _check("cvm", {"X": [("x", np.abs(_r(0, 4, 6)))]},
                               {"Y": ["y"]}, {"use_cvm": False},
                               cot_of=["y"]),
    "bce_loss": lambda: _check("bce_loss", {"X": [("x", _PROB)],
                                            "Label": [("l", _BIN)]},
                               {"Out": ["o"]}, cot_of=["o"], tol=TRANS),
    "hinge_loss": lambda: _check(
        "hinge_loss", {"Logits": [("x", _r(0, 4, 1))],
                       "Labels": [("l", _BIN[:, :1])]},
        {"Loss": ["o"]}, cot_of=["o"]),
    "huber_loss": lambda: _check(
        "huber_loss", {"X": [("x", _edges(1.0))],
                       "Y": [("y", np.zeros((6, 7), np.float32))]},
        {"Residual": ["r"], "Out": ["o"]}, {"delta": 1.0}, cot_of=["o"]),
    "kldiv_loss": lambda: _check(
        "kldiv_loss", {"X": [("x", _r(0, 4, 5))],
                       "Target": [("t", np.where(_BIN > 0, _PROB, 0.0))]},
        {"Loss": ["o"]}, {"reduction": "mean"}, cot_of=["o"], tol=TRANS),
    "kldiv_loss-batchmean": lambda: _check(
        "kldiv_loss", {"X": [("x", _r(0, 4, 5))], "Target": [("t", _PROB)]},
        {"Loss": ["o"]}, {"reduction": "batchmean"}, cot_of=["o"],
        tol=TRANS),
    "kldiv_loss-none": lambda: _check(
        "kldiv_loss", {"X": [("x", _r(0, 4, 5))], "Target": [("t", _PROB)]},
        {"Loss": ["o"]}, {"reduction": "none"}, cot_of=["o"], tol=TRANS),
    "log_loss": lambda: _check(
        "log_loss", {"Predicted": [("p", _PROB[:, :1])],
                     "Labels": [("l", _BIN[:, :1])]},
        {"Loss": ["o"]}, {"epsilon": 1e-4}, cot_of=["o"], tol=TRANS),
    "mse_loss": lambda: _pair("mse_loss", _r(0, 4, 5), _r(1, 4, 5)),
    "rank_loss": lambda: _check(
        "rank_loss", {"Label": [("l", _BIN[:, :1])],
                      "Left": [("a", _r(0, 4, 1))],
                      "Right": [("b", _r(1, 4, 1))]},
        {"Out": ["o"]}, cot_of=["o"], tol=TRANS),
    "smooth_l1_loss": lambda: _check(
        "smooth_l1_loss", {"X": [("x", _edges(1.0, -1.0))],
                           "Y": [("y", np.zeros((6, 7), np.float32))]},
        {"Diff": ["d"], "Out": ["o"]}, {"sigma": 1.0}, cot_of=["o"]),
    "smooth_l1_loss-weights": lambda: _check(
        "smooth_l1_loss", {"X": [("x", _r(0, 4, 5))],
                           "Y": [("y", _r(1, 4, 5))],
                           "InsideWeight": [("iw", _PROB)],
                           "OutsideWeight": [("ow", _BIN)]},
        {"Diff": ["d"], "Out": ["o"]}, {"sigma": 2.0}, cot_of=["o"]),
    "squared_l2_distance": lambda: _check(
        "squared_l2_distance", {"X": [("x", _r(0, 4, 5))],
                                "Y": [("y", _r(1, 4, 5))]},
        {"sub_result": ["d"], "Out": ["o"]}, cot_of=["o"]),
    "sigmoid_cross_entropy_with_logits": lambda: _check(
        "sigmoid_cross_entropy_with_logits",
        {"X": [("x", _edges(0.0, -0.0)[:4, :5].copy())],
         "Label": [("l", _BIN)]},
        {"Out": ["o"]}, {"ignore_index": -100}, cot_of=["o"], tol=TRANS),
    "sigmoid_cross_entropy_with_logits-normalize-ignore": lambda: _check(
        "sigmoid_cross_entropy_with_logits",
        {"X": [("x", _r(0, 4, 5))],
         "Label": [("l", np.where(_PROB > 0.7, -1.0, _BIN).astype(
             np.float32))]},
        {"Out": ["o"]}, {"ignore_index": -1, "normalize": True},
        cot_of=["o"], tol=TRANS),
    # PSPNet's loss: labels of 255 ignored (outside the classes), one
    # counted from the end
    "softmax_with_cross_entropy-ignore-255": lambda: _check(
        "softmax_with_cross_entropy",
        {"Logits": [("x", _r(0, 8, 5))],
         "Label": [("l", np.array([[0], [255], [4], [-1], [255], [2], [3],
                                   [1]], np.int64))]},
        {"Softmax": ["s"], "Loss": ["loss"]},
        {"soft_label": False, "ignore_index": 255, "axis": -1},
        cot_of=["loss"], int_slots=("Label",), tol=TRANS),
    "label_smooth": lambda: _unary("label_smooth", _BIN, {"epsilon": 0.1}),
    "label_smooth-prior": lambda: _check(
        "label_smooth", {"X": [("x", _BIN)],
                         "PriorDist": [("p", _PROB[:1])]},
        {"Out": ["o"]}, {"epsilon": 0.2}, cot_of=["o"]),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    CASES[case]()


def test_non_divisible_adaptive_pool_raises_in_both_packages():
    """Adaptive pooling to a size that does not divide the input raises
    ``NotImplementedError`` in both packages, as JAX's reshape form
    needs."""
    attrs = {"pooling_type": "avg", "ksize": [4, 4], "adaptive": True,
             "strides": [1, 1], "paddings": [0, 0]}
    for run in (_jax, _port):
        with pytest.raises(NotImplementedError):
            run("pool2d", {"X": [("x", _r(0, 1, 2, 6, 6))]},
                {"Out": ["o"]}, attrs, {})


def test_interp_out_size_input_raises_in_both_packages():
    for run in (_jax, _port):
        with pytest.raises(NotImplementedError):
            run("bilinear_interp",
                {"X": [("x", _r(0, 1, 2, 4, 4))],
                 "OutSize": [("s", np.array([8, 8], np.int32))]},
                {"Out": ["o"]}, {"out_h": 8, "out_w": 8}, {})
