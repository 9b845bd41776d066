"""The update, clip and fused optimizer ops' parity cases, as numpy
inputs made from a seed: ``CASES`` maps a case name (the op type, then an
optional ``-variant``) to ``(op_type, ins, outs, attrs, grad_of, tol)``.
``tests/test_torch_static_ops.py`` runs each op type's first case (its
``CASES`` needs one per registered op) and
``tests/test_torch_optimizer_ops.py`` the variants.

Tolerances, f32: ``ELEMENTWISE`` (rtol 1e-6) where each output element
is a fixed chain of elementwise roundings (the two packages' f32
``sqrt``, ``pow`` and division may differ in the last bit); ``NORMS``
(rtol 1e-5) where an output depends on a whole-tensor sum (LARS, LAMB,
``clip_by_norm``, ``squared_l2_norm``, ``dpsgd``'s clip), whose
summation order differs between XLA and ATen.
"""
import numpy as np

ELEMENTWISE = dict(rtol=1e-6, atol=1e-7)
NORMS = dict(rtol=1e-5, atol=1e-6)
SHAPE = (4, 3)


def r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def pos(seed, *shape):
    """Positive values (squares, second moments)."""
    return (np.random.RandomState(seed).rand(*shape) + 0.1).astype(
        np.float32)


def _update(op_type, accs=(), attrs=None, p=None, g=None, lr=0.1,
            tol=ELEMENTWISE):
    """An update op on a [4, 3] parameter: ``accs`` are (in slot, out
    slot, name, value) of its accumulators, each output named as its
    input (the executor's in-place contract)."""
    ins = {"Param": [("p", r(0, *SHAPE) if p is None else p)],
           "Grad": [("g", r(1, *SHAPE) if g is None else g)],
           "LearningRate": [("lr", np.array([lr], np.float32))]}
    outs = {"ParamOut": ["p"]}
    for in_slot, out_slot, name, value in accs:
        ins[in_slot] = [(name, value)]
        if out_slot:
            outs[out_slot] = [name]
    return (op_type, ins, outs, dict(attrs or {}), (), tol)


def _velocity():
    return [("Velocity", "VelocityOut", "v", r(2, *SHAPE))]


def _adam_accs(b1p=0.9 ** 3, b2p=0.999 ** 3):
    return [("Moment1", "Moment1Out", "m1", 0.1 * r(2, *SHAPE)),
            ("Moment2", "Moment2Out", "m2", 0.1 * pos(3, *SHAPE)),
            ("Beta1Pow", "Beta1PowOut", "b1p", np.array([b1p], np.float32)),
            ("Beta2Pow", "Beta2PowOut", "b2p", np.array([b2p], np.float32))]


_ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
_LARS = {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}
_ZEROS = np.zeros(SHAPE, np.float32)


def _rmsprop(momentum, centered):
    accs = [("Moment", "MomentOut", "mom", 0.1 * r(2, *SHAPE)),
            ("MeanSquare", "MeanSquareOut", "ms", pos(3, *SHAPE) + 0.5),
            ("MeanGrad", "MeanGradOut", "mg", 0.1 * r(4, *SHAPE))]
    return _update("rmsprop", accs, {"epsilon": 1e-6, "decay": 0.95,
                                     "momentum": momentum,
                                     "centered": centered})


def _ftrl(l1, l2):
    accs = [("SquaredAccumulator", "SquaredAccumOut", "sq", pos(2, *SHAPE)),
            ("LinearAccumulator", "LinearAccumOut", "lin", r(3, *SHAPE))]
    return _update("ftrl", accs, {"l1": l1, "l2": l2, "lr_power": -0.5})


def _average(num_acc, old_num, num_upd, window, min_w, max_w):
    """``average_accumulates`` with its ``[1]`` int64 counters at the
    given values."""
    ins = {"param": [("p", r(0, *SHAPE))],
           "in_sum_1": [("s1", r(1, *SHAPE))],
           "in_sum_2": [("s2", r(2, *SHAPE))],
           "in_sum_3": [("s3", r(3, *SHAPE))],
           "in_num_accumulates": [("na", np.array([num_acc], np.int64))],
           "in_old_num_accumulates": [("ona", np.array([old_num],
                                                       np.int64))],
           "in_num_updates": [("nu", np.array([num_upd], np.int64))]}
    outs = {"out_sum_1": ["s1"], "out_sum_2": ["s2"], "out_sum_3": ["s3"],
            "out_num_accumulates": ["na"],
            "out_old_num_accumulates": ["ona"], "out_num_updates": ["nu"]}
    return ("average_accumulates", ins, outs,
            {"average_window": window, "min_average_window": min_w,
             "max_average_window": max_w}, (), ELEMENTWISE)


#: the parameters of the fused cases: three shapes, one a vector
FUSED_SHAPES = ((4, 3), (5,), (2, 3, 2))


def fused(op_type, slots, attrs, seed=0):
    """A ``fused_<op_type>`` case over FUSED_SHAPES: ``slots`` are
    (in slot, out slot, name prefix, make(seed, shape)) of the
    accumulators."""
    ins = {"Param": [], "Grad": [],
           "LearningRate": [("lr", np.array([0.1], np.float32))]}
    outs = {"ParamOut": []}
    for i, shape in enumerate(FUSED_SHAPES):
        ins["Param"].append((f"p{i}", r(seed + 10 * i, *shape)))
        ins["Grad"].append((f"g{i}", r(seed + 10 * i + 1, *shape)))
        outs["ParamOut"].append(f"p{i}")
        for j, (in_slot, out_slot, prefix, make) in enumerate(slots):
            ins.setdefault(in_slot, []).append(
                (f"{prefix}{i}", make(seed + 10 * i + 2 + j, shape)))
            outs.setdefault(out_slot, []).append(f"{prefix}{i}")
    return ("fused_" + op_type, ins, outs, dict(attrs), (), ELEMENTWISE)


FUSED_SLOTS = {
    "sgd": [],
    "momentum": [("Velocity", "VelocityOut", "v",
                  lambda s, shape: r(s, *shape))],
    "adam": [("Moment1", "Moment1Out", "m1",
              lambda s, shape: 0.1 * r(s, *shape)),
             ("Moment2", "Moment2Out", "m2",
              lambda s, shape: 0.1 * pos(s, *shape)),
             ("Beta1Pow", "Beta1PowOut", "b1p",
              lambda s, shape: np.array([0.9 ** (s % 4)], np.float32)),
             ("Beta2Pow", "Beta2PowOut", "b2p",
              lambda s, shape: np.array([0.999 ** (s % 4)], np.float32))],
}
FUSED_ATTRS = {"sgd": {}, "momentum": {"mu": 0.9, "use_nesterov": False},
               "adam": dict(_ADAM, lazy_mode=False)}


def _unary(op_type, x, attrs=None, tol=ELEMENTWISE):
    return (op_type, {"X": [("x", x)]}, {"Out": ["o"]}, dict(attrs or {}),
            ("o",), tol)


CASES = {
    # LARS: the layer-wise rate, and each zero-norm branch (local rate lr)
    "lars_momentum": _update("lars_momentum", _velocity(), _LARS,
                             tol=NORMS),
    "lars_momentum-zero-param": _update("lars_momentum", _velocity(), _LARS,
                                        p=_ZEROS, tol=NORMS),
    "lars_momentum-zero-grad": _update("lars_momentum", _velocity(), _LARS,
                                       g=_ZEROS, tol=NORMS),
    "lars_momentum-epsilon": _update("lars_momentum", _velocity(),
                                     dict(_LARS, epsilon=1e-3), tol=NORMS),
    "adam": _update("adam", _adam_accs(), dict(_ADAM, lazy_mode=False)),
    "adam-first-step": _update("adam", _adam_accs(1.0, 1.0),
                               dict(_ADAM, lazy_mode=False)),
    "adamw": _update("adamw", _adam_accs(),
                     dict(_ADAM, coeff=0.01, with_decay=True)),
    "adamw-no-decay": _update("adamw", _adam_accs(),
                              dict(_ADAM, coeff=0.01, with_decay=False)),
    "adamax": _update("adamax", [
        ("Moment", "MomentOut", "m", 0.1 * r(2, *SHAPE)),
        ("InfNorm", "InfNormOut", "u", pos(3, *SHAPE)),
        ("Beta1Pow", None, "b1p", np.array([0.81], np.float32))], _ADAM),
    "adagrad": _update("adagrad", [("Moment", "MomentOut", "m",
                                    pos(2, *SHAPE))], {"epsilon": 1e-6}),
    "decayed_adagrad": _update("decayed_adagrad", [
        ("Moment", "MomentOut", "m", pos(2, *SHAPE))],
        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": _update("adadelta", [
        ("AvgSquaredGrad", "AvgSquaredGradOut", "asg", pos(2, *SHAPE)),
        ("AvgSquaredUpdate", "AvgSquaredUpdateOut", "asu",
         0.01 * pos(3, *SHAPE))], {"epsilon": 1e-6, "rho": 0.95}),
    "rmsprop": _rmsprop(0.0, False),
    "rmsprop-momentum": _rmsprop(0.9, False),
    "rmsprop-centered": _rmsprop(0.0, True),
    "rmsprop-centered-momentum": _rmsprop(0.9, True),
    "ftrl": _ftrl(0.01, 0.01),
    "ftrl-shrink": _ftrl(1.0, 0.0),
    "lamb": _update("lamb", _adam_accs(), dict(_ADAM, epsilon=1e-6,
                                               weight_decay=0.01),
                    tol=NORMS),
    "lamb-zero-param": _update("lamb", _adam_accs(),
                               dict(_ADAM, epsilon=1e-6, weight_decay=0.01),
                               p=_ZEROS, tol=NORMS),
    "lamb-no-decay": _update("lamb", _adam_accs(1.0, 1.0),
                             dict(_ADAM, epsilon=1e-6, weight_decay=0.0),
                             tol=NORMS),
    # sigma 0: the noise is zero, so both packages agree draw or not
    "dpsgd": _update("dpsgd", (), {"clip": 10.0, "batch_size": 2.0,
                                   "sigma": 0.0}, tol=NORMS),
    "dpsgd-clipped": _update("dpsgd", (), {"clip": 1.0, "batch_size": 2.0,
                                           "sigma": 0.0}, tol=NORMS),
    # ModelAverage's counters: plain accumulation, the 16384-update spill
    # into sum_2, the window's roll into sum_3, and both at once
    "average_accumulates": _average(1, 0, 5, 0.5, 2, 100),
    "average_accumulates-spill": _average(1, 0, 16383, 0.0, 10000, 10000),
    "average_accumulates-roll": _average(4, 3, 9, 1.0, 5, 5),
    "average_accumulates-spill-and-roll": _average(9999, 0, 16383, 0.15,
                                                   10000, 10000),
    "average_accumulates-window-short": _average(4, 0, 9, 0.1, 2, 100),
    "fused_sgd": fused("sgd", FUSED_SLOTS["sgd"], FUSED_ATTRS["sgd"]),
    "fused_momentum": fused("momentum", FUSED_SLOTS["momentum"],
                            FUSED_ATTRS["momentum"]),
    "fused_momentum-nesterov": fused(
        "momentum", FUSED_SLOTS["momentum"],
        dict(FUSED_ATTRS["momentum"], use_nesterov=True)),
    "fused_adam": fused("adam", FUSED_SLOTS["adam"], FUSED_ATTRS["adam"]),
    "clip": _unary("clip", r(0, 5, 6), {"min": -0.5, "max": 0.7}),
    "clip_by_norm": _unary("clip_by_norm", r(0, 5, 6), {"max_norm": 1.0},
                           tol=NORMS),
    "clip_by_norm-below": _unary("clip_by_norm", r(0, 5, 6),
                                 {"max_norm": 100.0}, tol=NORMS),
    "sqrt": _unary("sqrt", pos(0, 5, 6)),
    "squared_l2_norm": _unary("squared_l2_norm", r(0, 5, 6), tol=NORMS),
    "assign": _unary("assign", r(0, 5, 6)),
}


def first_cases():
    """The first case of each op type (by name order, the plain one)."""
    out = {}
    for name in sorted(CASES):
        out.setdefault(name.split("-")[0], name)
    return sorted(out.values())
