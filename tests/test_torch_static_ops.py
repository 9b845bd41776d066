"""PyTorch port, the static path's op lowerings against the JAX package's,
one parametrised case per op: the same numpy inputs go through
``registry.run_op`` of each package, forward, then the grad op that
package's grad maker writes (the JAX generic ones replay the forward
under ``jax.vjp``; the port's conv2d, pool2d, batch_norm, mul and fused
ops have explicit grad lowerings), with the same cotangents.

Tolerances, f32 throughout: rtol 1e-5 / atol 1e-5 for elementwise and
reduction results; rtol 1e-4 / atol 1e-4 where a convolution or matrix
product sums hundreds of products in another order (oneDNN against XLA).
"""
import numpy as np
import pytest

import paddle_tpu.framework.core as jcore
import paddle_tpu.ops.registry as jreg
import paddle_tpu_torch.framework.core as tcore
import paddle_tpu_torch.ops.registry as treg

import jax.numpy as jnp
import torch

TIGHT = dict(rtol=1e-5, atol=1e-5)
SUMS = dict(rtol=1e-4, atol=1e-4)
GRAD = "@GRAD"


def _run(core, reg, to_arr, from_arr, op_type, ins, outs, attrs, cots,
         int_slots=()):
    """Forward + grad of one op in one package; {var name: numpy}."""
    prog = core.Program()
    blk = prog.global_block()
    env = {}
    for slot, items in ins.items():
        for name, arr in items:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                           stop_gradient=slot in int_slots)
            env[name] = to_arr(arr)
    for slot, names in outs.items():
        for n in names:
            blk.create_var(name=n)
    op = blk.append_op(op_type, inputs={s: [n for n, _ in v]
                                        for s, v in ins.items()},
                       outputs=outs, attrs=dict(attrs))
    reg.run_op(op, env, blk)
    result = {n: from_arr(env[n]) for names in outs.values() for n in names
              if n in env}
    if cots:
        no_grad = {n for s in int_slots for n, _ in ins.get(s, [])}
        for desc in reg.make_grad_ops(op, frozenset(no_grad)):
            # as append_backward does: a cotangent nobody produced is
            # @EMPTY@ (zeros)
            fwd_outs = desc.get("attrs", {}).get("__fwd_out_slots__")
            cot_slots = ({s + GRAD for s in fwd_outs} if fwd_outs else
                         {s for s in desc["inputs"] if s.endswith(GRAD)})
            for slot in cot_slots & set(desc["inputs"]):
                desc["inputs"][slot] = [n if n in cots else "@EMPTY@"
                                        for n in desc["inputs"][slot]]
            for names in list(desc["inputs"].values()) + \
                    list(desc["outputs"].values()):
                for n in names:
                    if n != "@EMPTY@" and not blk.has_var(n):
                        blk.create_var(name=n)
            gop = blk.append_op(desc["type"], inputs=desc["inputs"],
                                outputs=desc["outputs"],
                                attrs=desc.get("attrs"))
            for n, arr in cots.items():
                env[n] = to_arr(arr)
            reg.run_op(gop, env, blk)
            for names in desc["outputs"].values():
                for n in names:
                    if n in env and n not in cots:
                        result[n] = from_arr(env[n])
    return result


def _jax(*a, **k):
    return _run(jcore, jreg, jnp.asarray, np.asarray, *a, **k)


def _port(*a, **k):
    return _run(tcore, treg, lambda v: torch.from_numpy(np.array(v)),
                lambda v: v.numpy(), *a, **k)


def _check(op_type, ins, outs, attrs=None, cot_of=(), tol=TIGHT,
           int_slots=(), seed=0, skip=()):
    """Run both packages and compare every output and gradient; the
    cotangents of the outputs in ``cot_of`` are random numpy arrays,
    shaped as JAX's forward made them."""
    attrs = attrs or {}
    rng = np.random.RandomState(seed)
    fwd = _jax(op_type, ins, outs, attrs, {}, int_slots=int_slots)
    cots = {n + GRAD: np.asarray(rng.randn(*np.shape(fwd[n])), np.float32)
            for n in cot_of}
    j = _jax(op_type, ins, outs, attrs, cots, int_slots=int_slots)
    t = _port(op_type, ins, outs, attrs, cots, int_slots=int_slots)
    assert set(t) == set(j), (sorted(t), sorted(j))
    for n in j:
        if n in skip:
            continue
        assert np.shape(t[n]) == np.shape(j[n]), n
        np.testing.assert_allclose(np.asarray(t[n], np.float64),
                                   np.asarray(j[n], np.float64),
                                   err_msg=n, **tol)
    return j, t


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bn_ins(x, c, seed=5):
    rng = np.random.RandomState(seed)
    return {"X": [("x", x)],
            "Scale": [("scale", (1 + 0.1 * rng.randn(c)).astype(np.float32))],
            "Bias": [("bias", rng.randn(c).astype(np.float32))],
            "Mean": [("mean", rng.randn(c).astype(np.float32))],
            "Variance": [("var", rng.rand(c).astype(np.float32) + 0.5)]}


_BN_OUTS = {"Y": ["y"], "MeanOut": ["mean"], "VarianceOut": ["var"],
            "SavedMean": ["sm"], "SavedVariance": ["sv"]}

_CONV = dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1], groups=1,
             data_format="NCHW", padding_algorithm="EXPLICIT")


def _conv_case(fmt, stride, pad, k=3, groups=1):
    x = _r(1, 2, 6, 9, 9) if fmt == "NCHW" else _r(1, 2, 9, 9, 6)
    w = _r(2, 8, 6 // groups, k, k) * 0.3
    attrs = dict(_CONV, strides=[stride, stride], paddings=pad,
                 data_format=fmt, groups=groups)
    return {"Input": [("x", x)], "Filter": [("w", w)]}, attrs


def _conv2d(fmt, stride, pad, k=3, groups=1):
    ins, attrs = _conv_case(fmt, stride, pad, k, groups)
    return _check("conv2d", ins, {"Output": ["o"]}, attrs, cot_of=["o"],
                  tol=SUMS)


CASES = {
    "fill_constant": lambda: _check(
        "fill_constant", {}, {"Out": ["o"]},
        {"shape": [2, 3], "value": 1.5, "dtype": 5}),
    "elementwise_add": lambda: _check(
        "elementwise_add", {"X": [("x", _r(0, 3, 4))], "Y": [("y", _r(1, 3, 4))]},
        {"Out": ["o"]}, {"axis": -1}, cot_of=["o"]),
    "elementwise_add-bias": lambda: _check(
        "elementwise_add", {"X": [("x", _r(0, 3, 4))], "Y": [("y", _r(1, 4))]},
        {"Out": ["o"]}, {"axis": 1}, cot_of=["o"]),
    "relu": lambda: _check("relu", {"X": [("x", _r(0, 5, 6))]},
                           {"Out": ["o"]}, cot_of=["o"]),
    "mean": lambda: _check("mean", {"X": [("x", _r(0, 5, 6))]},
                           {"Out": ["o"]}, cot_of=["o"]),
    "sum": lambda: _check("sum", {"X": [("a", _r(0, 4, 3)),
                                        ("b", _r(1, 4, 3))]},
                          {"Out": ["o"]}),
    "mul": lambda: _check(
        "mul", {"X": [("x", _r(0, 4, 2, 3))], "Y": [("y", _r(1, 6, 5))]},
        {"Out": ["o"]}, {"x_num_col_dims": 1, "y_num_col_dims": 1},
        cot_of=["o"], tol=SUMS),
    "top_k": lambda: _check("top_k", {"X": [("x", _r(0, 4, 10))]},
                            {"Out": ["o"], "Indices": ["i"]}, {"k": 3}),
    "accuracy": lambda: _check(
        "accuracy", {"Out": [("o", _r(0, 6, 2))],
                     "Indices": [("i", np.array([[1, 2], [0, 4], [3, 3],
                                                 [5, 1], [2, 2], [0, 1]],
                                                np.int64))],
                     "Label": [("l", np.array([[2], [1], [3], [0], [2], [9]],
                                              np.int64))]},
        {"Accuracy": ["acc"], "Correct": ["c"], "Total": ["n"]},
        int_slots=("Indices", "Label")),
    "softmax_with_cross_entropy": lambda: _check(
        "softmax_with_cross_entropy",
        {"Logits": [("x", _r(0, 6, 10))],
         "Label": [("l", np.random.RandomState(1).randint(
             0, 10, (6, 1)).astype(np.int64))]},
        {"Softmax": ["s"], "Loss": ["loss"]},
        {"soft_label": False, "ignore_index": -100, "axis": -1},
        cot_of=["loss"], int_slots=("Label",)),
    "conv2d-nchw": lambda: _conv2d("NCHW", 1, [1, 1]),
    "conv2d-nhwc-stride2": lambda: _conv2d("NHWC", 2, [1, 1]),
    "conv2d-7x7-asym-pad": lambda: _conv2d("NCHW", 2, [3, 2, 1, 3], k=7),
    "conv2d-groups": lambda: _conv2d("NCHW", 1, [0, 0], k=1, groups=2),
    "pool2d-max-3x3-s2-p1": lambda: _check(
        "pool2d", {"X": [("x", _r(0, 2, 3, 9, 9))]}, {"Out": ["o"]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
         "exclusive": True, "data_format": "NCHW",
         "padding_algorithm": "EXPLICIT"}, cot_of=["o"]),
    "pool2d-max-relu-ties": lambda: _check(
        "pool2d", {"X": [("x", np.maximum(_r(3, 2, 3, 8, 8), 0))]},
        {"Out": ["o"]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
         "exclusive": True, "data_format": "NCHW",
         "padding_algorithm": "EXPLICIT"}, cot_of=["o"]),
    "pool2d-avg-global": lambda: _check(
        "pool2d", {"X": [("x", _r(0, 2, 5, 4, 4))]}, {"Out": ["o"]},
        {"pooling_type": "avg", "ksize": [-1, -1], "strides": [1, 1],
         "paddings": [0, 0], "global_pooling": True, "ceil_mode": False,
         "exclusive": True, "data_format": "NCHW",
         "padding_algorithm": "EXPLICIT"}, cot_of=["o"]),
    "pool2d-max-global-nhwc": lambda: _check(
        "pool2d", {"X": [("x", _r(0, 2, 4, 4, 5))]}, {"Out": ["o"]},
        {"pooling_type": "max", "ksize": [-1, -1], "strides": [1, 1],
         "paddings": [0, 0], "global_pooling": True, "ceil_mode": False,
         "exclusive": True, "data_format": "NHWC",
         "padding_algorithm": "EXPLICIT"}, cot_of=["o"]),
    "pool2d-avg-2x2": lambda: _check(
        "pool2d", {"X": [("x", _r(0, 2, 3, 6, 6))]}, {"Out": ["o"]},
        {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
         "paddings": [0, 0], "global_pooling": False, "ceil_mode": False,
         "exclusive": True, "data_format": "NCHW",
         "padding_algorithm": "EXPLICIT"}, cot_of=["o"]),
    "batch_norm-nchw": lambda: _check(
        "batch_norm", _bn_ins(_r(0, 4, 6, 5, 5) * 3 + 2, 6), _BN_OUTS,
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
         "data_layout": "NCHW", "use_global_stats": False}, cot_of=["y"]),
    "batch_norm-nhwc-batch16": lambda: _check(
        "batch_norm", _bn_ins(_r(0, 16, 3, 3, 6) + 5, 6), _BN_OUTS,
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
         "data_layout": "NHWC", "use_global_stats": False}, cot_of=["y"]),
    "batch_norm-test": lambda: _check(
        "batch_norm", _bn_ins(_r(0, 4, 6, 5, 5), 6), _BN_OUTS,
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": True,
         "data_layout": "NCHW", "use_global_stats": False}, cot_of=["y"]),
    "momentum": lambda: _check(
        "momentum", {"Param": [("p", _r(0, 4, 3))], "Grad": [("g", _r(1, 4, 3))],
                     "Velocity": [("v", _r(2, 4, 3))],
                     "LearningRate": [("lr", np.array([0.1], np.float32))]},
        {"ParamOut": ["p"], "VelocityOut": ["v"]},
        {"mu": 0.9, "use_nesterov": False}),
    "momentum-nesterov": lambda: _check(
        "momentum", {"Param": [("p", _r(0, 4, 3))], "Grad": [("g", _r(1, 4, 3))],
                     "Velocity": [("v", _r(2, 4, 3))],
                     "LearningRate": [("lr", np.array([0.1], np.float32))]},
        {"ParamOut": ["p"], "VelocityOut": ["v"]},
        {"mu": 0.9, "use_nesterov": True}),
    "sgd": lambda: _check(
        "sgd", {"Param": [("p", _r(0, 4, 3))], "Grad": [("g", _r(1, 4, 3))],
                "LearningRate": [("lr", np.array([0.1], np.float32))]},
        {"ParamOut": ["p"]}),
}


def _fused_bn(op_type, fmt, with_z):
    x = _r(0, 4, 6, 5, 5) if fmt == "NCHW" else _r(0, 4, 5, 5, 6)
    ins = _bn_ins(x * 2 + 1, 6)
    if with_z:
        ins["Z"] = [("z", _r(9, *x.shape))]
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": fmt, "use_global_stats": False,
             "act_type": "relu"}
    return _check(op_type, ins, _BN_OUTS, attrs, cot_of=["y"])


def _fused_conv(fmt, with_z, stride):
    cins, cattrs = _conv_case(fmt, stride, [1, 1])
    ins = dict(cins)
    bn = _bn_ins(np.zeros(1, np.float32), 8)
    for k in ("Scale", "Bias", "Mean", "Variance"):
        ins[k] = bn[k]
    out_hw = 9 if stride == 1 else 5
    if with_z:
        zs = (2, 8, out_hw, out_hw) if fmt == "NCHW" else (2, out_hw, out_hw, 8)
        ins["Z"] = [("z", _r(9, *zs))]
    attrs = dict(cattrs, momentum=0.9, epsilon=1e-5, is_test=False,
                 use_global_stats=False, act_type="relu")
    outs = {"Output": ["o"], "ConvOut": ["co"], "MeanOut": ["mean"],
            "VarianceOut": ["var"], "SavedMean": ["sm"],
            "SavedVariance": ["sv"]}
    return _check("fused_conv_bn_act", ins, outs, attrs, cot_of=["o"],
                  tol=SUMS)


def _ids(seed, n, vocab, pad=None):
    ids = np.random.RandomState(seed).randint(0, vocab, (n, 1))
    if pad is not None:
        ids[::3] = pad
    return ids.astype(np.int64)


def _random_moments(op_type, attrs, mean, std, n=20000):
    """Random ops: the two packages' streams differ, so each package's
    draws are held to the shape, the dtype and the moments of ``n`` draws
    (5 standard errors), as ``test_random_ops_shapes_and_moments``
    does for the port alone."""
    attrs = dict(attrs, shape=[n], dtype=5, seed=0)
    for draws in (_jax(op_type, {}, {"Out": ["o"]}, attrs, {})["o"],
                  _port(op_type, {}, {"Out": ["o"]}, attrs, {})["o"]):
        v = np.asarray(draws)
        assert v.shape == (n,) and v.dtype == np.float32
        assert abs(v.mean() - mean) < 5 * std / n ** 0.5
        assert abs(v.std() - std) < 0.05 * std


CASES.update({
    "gaussian_random": lambda: _random_moments(
        "gaussian_random", {"mean": 0.5, "std": 2.0}, 0.5, 2.0),
    "uniform_random": lambda: _random_moments(
        "uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4.0 / 12 ** 0.5),
    "sigmoid": lambda: _check("sigmoid", {"X": [("x", _r(0, 5, 6) * 3)]},
                              {"Out": ["o"]}, cot_of=["o"]),
    "softmax": lambda: _check("softmax", {"X": [("x", _r(0, 4, 7) * 2)]},
                              {"Out": ["o"]}, {"axis": -1}, cot_of=["o"]),
    "softmax-axis0": lambda: _check("softmax", {"X": [("x", _r(1, 5, 3))]},
                                    {"Out": ["o"]}, {"axis": 0},
                                    cot_of=["o"]),
    "concat": lambda: _check(
        "concat", {"X": [("a", _r(0, 4, 3)), ("b", _r(1, 4, 5)),
                         ("c", _r(2, 4, 1))]},
        {"Out": ["o"]}, {"axis": 1}, cot_of=["o"]),
    "reshape2": lambda: _check(
        "reshape2", {"X": [("x", _r(0, 4, 6))]},
        {"Out": ["o"], "XShape": ["xs"]}, {"shape": [0, -1, 3]},
        cot_of=["o"]),
    # the bf16 casts of static AMP: test_torch_static_amp.py
    "cast": lambda: _check("cast", {"X": [("x", _r(0, 4, 6) * 5)]},
                           {"Out": ["o"]}, {"in_dtype": 5, "out_dtype": 2}),
    "cast-f32": lambda: _check("cast", {"X": [("x", _r(1, 4, 6))]},
                               {"Out": ["o"]},
                               {"in_dtype": 5, "out_dtype": 5},
                               cot_of=["o"]),
    "transpose2": lambda: _check(
        "transpose2", {"X": [("x", _r(0, 2, 3, 4, 5))]},
        {"Out": ["o"], "XShape": ["xs"]}, {"axis": [0, 2, 3, 1]},
        cot_of=["o"], skip=("xs",)),
    "lookup_table": lambda: _check(
        "lookup_table", {"W": [("w", _r(0, 11, 5))],
                         "Ids": [("ids", _ids(1, 9, 11))]},
        {"Out": ["o"]}, {"padding_idx": -1, "is_sparse": False},
        cot_of=["o"], int_slots=("Ids",)),
    "lookup_table-padding-idx": lambda: _check(
        "lookup_table", {"W": [("w", _r(0, 11, 5))],
                         "Ids": [("ids", _ids(2, 9, 11, pad=4))]},
        {"Out": ["o"]}, {"padding_idx": 4, "is_sparse": False},
        cot_of=["o"], int_slots=("Ids",)),
    "fused_matmul_bias_act": lambda: _check(
        "fused_matmul_bias_act",
        {"X": [("x", _r(0, 5, 7))], "Y": [("y", _r(1, 7, 3))],
         "Bias": [("b", _r(2, 3))]},
        {"Out": ["o"]}, {"act_type": "relu", "x_num_col_dims": 1,
                         "axis": 1}, cot_of=["o"], tol=SUMS),
})

def _with_inf(seed, *shape, bad=np.inf):
    a = _r(seed, *shape)
    a.flat[3] = bad
    return a


def _update_loss_scaling(found, good, bad, **attrs):
    return _check(
        "update_loss_scaling",
        {"FoundInfinite": [("found", np.array([found]))],
         "PrevLossScaling": [("scale", np.array([32768.0], np.float32))],
         "InGoodSteps": [("good", np.array([good], np.int32))],
         "InBadSteps": [("bad", np.array([bad], np.int32))]},
        {"LossScalingOut": ["scale_out"], "OutGoodSteps": ["good_out"],
         "OutBadSteps": ["bad_out"]},
        dict({"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
              "incr_ratio": 2.0, "decr_ratio": 0.8}, **attrs),
        tol=dict(rtol=0, atol=0))


# the float16 AMP ops (decorate(use_fp16=True)); their float16 cases and
# the state machine over many steps: test_torch_static_amp_fp16.py
CASES.update({
    "elementwise_mul": lambda: _check(
        "elementwise_mul", {"X": [("x", _r(0, 4, 6))],
                            "Y": [("y", _r(1, 4, 6))]},
        {"Out": ["o"]}, {"axis": -1}, cot_of=["o"]),
    "elementwise_mul-scaled-loss": lambda: _check(
        "elementwise_mul", {"X": [("x", _r(0, 1))],
                            "Y": [("y", np.array([32768.0], np.float32))]},
        {"Out": ["o"]}, {"axis": -1}, cot_of=["o"], int_slots=("Y",)),
    "elementwise_mul-bias-axis": lambda: _check(
        "elementwise_mul", {"X": [("x", _r(0, 2, 3, 4))],
                            "Y": [("y", _r(1, 3))]},
        {"Out": ["o"]}, {"axis": 1}, cot_of=["o"]),
    "reciprocal": lambda: _check(
        "reciprocal", {"X": [("x", np.abs(_r(0, 5, 6)) + 0.5)]},
        {"Out": ["o"]}, cot_of=["o"]),
    "scale": lambda: _check(
        "scale", {"X": [("x", _r(0, 5, 6))]}, {"Out": ["o"]},
        {"scale": 2.5, "bias": 0.5, "bias_after_scale": True},
        cot_of=["o"]),
    "scale-bias-first": lambda: _check(
        "scale", {"X": [("x", _r(0, 5, 6))]}, {"Out": ["o"]},
        {"scale": 1.0 / 128, "bias": -1.0, "bias_after_scale": False},
        cot_of=["o"]),
    "scale-int": lambda: _check(
        "scale", {"X": [("x", np.arange(6, dtype=np.int32))]},
        {"Out": ["o"]}, {"scale": 3.0, "bias": 1.0}),
    "amp_check_finite_and_scale": lambda: _check(
        "amp_check_finite_and_scale",
        {"X": [("g0", _r(0, 5, 6)), ("g1", _r(1, 7))],
         "Scale": [("inv", np.array([2.0 ** -15], np.float32))]},
        {"Out": ["g0o", "g1o"], "FoundInfinite": ["found"]},
        tol=dict(rtol=0, atol=0)),
    "amp_check_finite_and_scale-inf": lambda: _check(
        "amp_check_finite_and_scale",
        {"X": [("g0", _r(0, 5, 6)), ("g1", _with_inf(1, 7))],
         "Scale": [("inv", np.array([2.0 ** -15], np.float32))]},
        {"Out": ["g0o", "g1o"], "FoundInfinite": ["found"]},
        tol=dict(rtol=0, atol=0)),
    "update_loss_scaling-clean": lambda: _update_loss_scaling(False, 1, 1),
    "update_loss_scaling-incr": lambda: _update_loss_scaling(False, 2, 0),
    "update_loss_scaling-decr": lambda: _update_loss_scaling(True, 2, 1),
})

def _unary(op_type, x, attrs=None, grad=True, tol=TIGHT):
    return _check(op_type, {"X": [("x", x)]}, {"Out": ["o"]}, attrs,
                  cot_of=["o"] if grad else (), tol=tol)


def _binary(op_type, x, y, axis=-1, grad=True):
    return _check(op_type, {"X": [("x", x)], "Y": [("y", y)]},
                  {"Out": ["o"]}, {"axis": axis},
                  cot_of=["o"] if grad else ())


def _edges(*points):
    """Random inputs with the clip edges of an activation among them."""
    x = _r(0, 6, 7) * 4
    x.flat[:len(points)] = points
    return x


# the ops of MobileNetV3 and its training recipe: depthwise convs, the
# hard activations (their grads at the clip edges: the mobilenet tests),
# L1 decay's sign, and the schedules' counter, arithmetic, comparisons
# and selects (tests/test_torch_lr_regularizer.py runs them in programs)
_POS = np.abs(_r(1, 3, 4)) + 0.5
CASES.update({
    "depthwise_conv2d": lambda: _check(
        "depthwise_conv2d",
        {"Input": [("x", _r(1, 2, 6, 9, 9))],
         "Filter": [("w", _r(2, 12, 1, 3, 3) * 0.3)]},
        {"Output": ["o"]}, dict(_CONV, groups=6), cot_of=["o"], tol=SUMS),
    "hard_swish": lambda: _unary(
        "hard_swish", _edges(-3.0, 3.0, 0.0, -4.0, 4.0),
        {"threshold": 6.0, "scale": 6.0, "offset": 3.0}),
    # edges where slope * x + offset is exact: the JAX run here is op by
    # op, where jit contracts it into one fused multiply-add (the port's
    # rounding; tests/test_torch_mobilenet.py holds it to jax.jit)
    "hard_sigmoid": lambda: _unary(
        "hard_sigmoid", _edges(-2.0, 2.0, 0.0),
        {"slope": 0.25, "offset": 0.5}),
    "hard_sigmoid-slope-1667": lambda: _unary(
        "hard_sigmoid", _r(0, 6, 7) * 4, {"slope": 0.1667, "offset": 0.5}),
    "sign": lambda: _unary("sign", _edges(0.0, -0.0, 1.0)),
    "floor": lambda: _unary("floor", _edges(1.0, -1.0, 0.5)),
    "ceil": lambda: _unary("ceil", _edges(1.0, -1.0, 0.5)),
    "cos": lambda: _unary("cos", _r(0, 6, 7) * 3),
    "exp": lambda: _unary("exp", _r(0, 6, 7)),
    "increment": lambda: _unary("increment",
                                np.array([3.0], np.float32), {"step": 1.0}),
    "increment-int": lambda: _unary(
        "increment", np.array([3], np.int32), {"step": 2.0}, grad=False),
    "elementwise_sub": lambda: _binary("elementwise_sub", _r(0, 3, 4),
                                       _r(1, 3, 4)),
    "elementwise_sub-axis": lambda: _binary("elementwise_sub",
                                            _r(0, 2, 3, 4), _r(1, 3), 1),
    "elementwise_div": lambda: _binary("elementwise_div", _r(0, 3, 4),
                                       _POS),
    "elementwise_max": lambda: _binary(
        "elementwise_max", _r(0, 3, 4),
        np.where(np.arange(12).reshape(3, 4) % 3 == 0, _r(0, 3, 4),
                 _r(1, 3, 4))),
    "elementwise_min": lambda: _binary(
        "elementwise_min", _r(0, 3, 4),
        np.where(np.arange(12).reshape(3, 4) % 3 == 0, _r(0, 3, 4),
                 _r(1, 3, 4))),
    "elementwise_pow": lambda: _binary("elementwise_pow", _POS,
                                       _r(2, 3, 4)),
    "elementwise_pow-scalar-base": lambda: _binary(
        "elementwise_pow", np.array([0.9], np.float32), _POS),
    "elementwise_mod": lambda: _binary("elementwise_mod", _r(0, 3, 4) * 5,
                                       _POS * np.sign(_r(2, 3, 4)),
                                       grad=False),
    "elementwise_floordiv": lambda: _binary(
        "elementwise_floordiv", _r(0, 3, 4) * 5,
        _POS * np.sign(_r(2, 3, 4)), grad=False),
    "where": lambda: _check(
        "where", {"Condition": [("c", _r(3, 3, 4) > 0)],
                  "X": [("x", _r(0, 3, 4))], "Y": [("y", _r(1, 3, 4))]},
        {"Out": ["o"]}, cot_of=["o"], int_slots=("Condition",)),
})
for _c in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"):
    CASES[_c] = (lambda c=_c: _binary(
        c, np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32),
        np.array([2.0, 2.0, 7.0], np.float32), grad=False))


def _dropout_train(impl, p=0.3, seed=7):
    """Training dropout: the two packages draw different masks, so each
    package's mask is held to its keep rate (5 standard errors) and its
    output to the mask (x, upscaled or not, where kept, else 0); then
    both grad ops run on JAX's mask with the same cotangent."""
    x = _r(0, 64, 50) + 3.0
    attrs = {"dropout_prob": p, "is_test": False, "fix_seed": True,
             "seed": seed, "dropout_implementation": impl}
    scale = np.float32(1.0 / (1.0 - p) if impl == "upscale_in_train" else 1)
    masks = {}
    for name, run in (("jax", _jax), ("port", _port)):
        r = run("dropout", {"X": [("x", x)]}, {"Out": ["o"], "Mask": ["m"]},
                attrs, {})
        m = np.asarray(r["m"])
        assert m.dtype == np.uint8 and m.shape == x.shape, name
        keep = m.astype(bool)
        assert abs(keep.mean() - (1 - p)) < 5 * (p * (1 - p) / x.size) ** 0.5
        np.testing.assert_allclose(np.asarray(r["o"]),
                                   np.where(keep, x * scale, 0), **TIGHT)
        masks[name] = m
    ins = {"Mask": [("m", masks["jax"])], "Out@GRAD": [("g", _r(3, 64, 50))]}
    j = _jax("dropout_grad", ins, {"X@GRAD": ["dx"]}, attrs, {})
    t = _port("dropout_grad", ins, {"X@GRAD": ["dx"]}, attrs, {})
    np.testing.assert_allclose(t["dx"], j["dx"], **TIGHT)


CASES.update({
    "dropout-upscale": lambda: _dropout_train("upscale_in_train"),
    "dropout-downgrade": lambda: _dropout_train("downgrade_in_infer"),
    "dropout-test-upscale": lambda: _check(
        "dropout", {"X": [("x", _r(0, 5, 6))]}, {"Out": ["o"], "Mask": ["m"]},
        {"dropout_prob": 0.3, "is_test": True,
         "dropout_implementation": "upscale_in_train"}, cot_of=["o"]),
    "dropout-test-downgrade": lambda: _check(
        "dropout", {"X": [("x", _r(0, 5, 6))]}, {"Out": ["o"], "Mask": ["m"]},
        {"dropout_prob": 0.3, "is_test": True,
         "dropout_implementation": "downgrade_in_infer"}, cot_of=["o"]),
})

for _t in ("fused_batch_norm_act", "fused_bn_add_activation"):
    for _f in ("NCHW", "NHWC"):
        CASES[f"{_t}-{_f.lower()}"] = (
            lambda t=_t, f=_f: _fused_bn(t, f, t == "fused_bn_add_activation"))
for _f in ("NCHW", "NHWC"):
    for _z in (False, True):
        CASES[f"fused_conv_bn_act-{_f.lower()}-{'z' if _z else 'no-z'}"] = (
            lambda f=_f, z=_z: _fused_conv(f, z, 2 if z else 1))


def _sample_token(attrs):
    """``sample_token`` where both packages' draws are the argmax: at
    temperature 0, and at top_k 1 (the only token left).  Its sampled
    draws differ by design (the port's hash against
    ``jax.random.categorical``; tests/test_torch_spec_decode.py)."""
    ins = {"Logits": [("lg", _r(3, 6, 40))],
           "Seeds": [("sd", np.arange(6, dtype=np.int32) * 977)]}
    _check("sample_token", ins, {"Out": ["o"]}, attrs, int_slots=("Seeds",))


CASES.update({
    "sample_token-greedy": lambda: _sample_token(
        {"temperature": 0.0, "top_k": 0, "top_p": 1.0}),
    "sample_token-top1": lambda: _sample_token(
        {"temperature": 0.8, "top_k": 1, "top_p": 0.9}),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    CASES[case]()


def test_every_registered_op_has_a_parity_case():
    """The port's op-coverage meter: no forward op lands in the registry
    without a case above (a case's name is its op type, then an optional
    ``-variant``)."""
    forward = {t for t, d in treg.OPS.items()
               if d.lower is not None and not t.endswith("_grad")}
    covered = {case.split("-")[0] for case in CASES}
    assert sorted(forward - covered) == []
    assert sorted(covered - forward) == []


def test_op_coverage_tool_counts_the_port_against_jax():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    try:
        import op_coverage
    finally:
        sys.path.pop(0)
    rep = op_coverage.coverage()
    port = {t for t, d in treg.OPS.items()
            if d.lower is not None and not t.endswith("_grad")}
    # every port op is one of JAX's, and the report adds up
    assert set(rep["ported"]) == port
    assert rep["ported_count"] == len(port) and rep["extra"] == []
    assert rep["ported_count"] + len(rep["missing"]) == rep["jax_count"]
    assert "fused_matmul_bias_act" in rep["ported"]
    assert "lookup_table_v2" in rep["missing"]


def test_fused_conv_matches_the_jax_pallas_kernels(monkeypatch):
    """The fused conv op with JAX's Pallas epilogue kernels engaged
    (interpret mode; C = 8 and 9x9 NHWC rows tile)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    _fused_conv("NHWC", True, 1)
    _fused_conv("NHWC", False, 1)


def test_random_ops_shapes_and_moments():
    """The two packages' random streams differ: shapes, dtypes and the
    moments of 20k draws (5 standard errors) are what must agree."""
    prog = tcore.Program()
    blk = prog.global_block()
    n = 20000
    for typ, attrs, mean, std in (
            ("gaussian_random", {"mean": 0.5, "std": 2.0}, 0.5, 2.0),
            ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0,
             4.0 / 12 ** 0.5)):
        blk.create_var(name=typ, shape=(n,), dtype="float32")
        op = blk.append_op(typ, outputs={"Out": [typ]},
                           attrs=dict(attrs, shape=[n], dtype=5, seed=0))
        env = {}
        gen = torch.Generator().manual_seed(0)
        treg.run_op(op, env, blk, gen, torch.device("cpu"))
        v = env[typ].numpy()
        assert v.shape == (n,) and v.dtype == np.float32
        assert abs(v.mean() - mean) < 5 * std / n ** 0.5
        assert abs(v.std() - std) < 0.05 * std
    # a nonzero seed attr draws from its own stream: the same numbers
    # whatever the executor's generator
    blk.create_var(name="s", shape=(5,), dtype="float32")
    op = blk.append_op("uniform_random", outputs={"Out": ["s"]},
                       attrs={"shape": [5], "min": 0.0, "max": 1.0,
                              "seed": 7, "dtype": 5})
    draws = []
    for g in (1, 2):
        env = {}
        treg.run_op(op, env, blk, torch.Generator().manual_seed(g),
                    torch.device("cpu"))
        draws.append(env["s"])
    assert torch.equal(*draws)


def test_shape_inference_allocates_nothing():
    """Random ops under compile-time inference run on the meta device."""
    prog = tcore.Program()
    blk = prog.global_block()
    v = blk.create_var(name="w", shape=(), dtype="float32")
    blk.append_op("gaussian_random", outputs={"Out": ["w"]},
                  attrs={"shape": [3, 4], "mean": 0.0, "std": 1.0,
                         "seed": 0, "dtype": 5})
    assert v.shape == (3, 4)
