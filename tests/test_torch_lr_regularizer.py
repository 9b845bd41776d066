"""PyTorch port, the training recipe's program pieces against the JAX
package on the CPU: the learning-rate schedules
(``layers/learning_rate_scheduler.py``), the weight decay
(``regularizer.py`` and ``Optimizer._append_regularization_ops``) and the
Python operators on ``Variable`` (``layers/math_op_patch.py``).

* Every schedule builds the same program in both packages, op for op,
  and its rate over 6 executor steps equals JAX's within rtol 1e-6 (the
  f32 ``cos``, ``exp`` and ``pow`` of XLA and of ATen may differ in the
  last bit; measured: equal or 1 ulp).
* ``L1Decay`` and ``L2Decay`` on one Momentum step of a small fc model,
  and a ``ParamAttr(regularizer=)`` taking precedence over the
  optimizer's: the same program, and every parameter and velocity after
  the step within rtol 1e-6 / atol 1e-7 of JAX's, from JAX's startup
  scope.
* The dygraph form (``Optimizer._eager_regularize``, JAX
  ``optimizer.py:266-274``): a port ``AdamOptimizer`` step with weight
  decay against JAX's decayed gradient fed to JAX's ``adam`` op, rtol
  1e-6.
* The recipe's modules import no ``jax`` and no ``paddle_tpu``.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.ops.registry import eager_call

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)
from paddle_tpu_torch.optimizer import AdamOptimizer

STEPS = 6


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _in_both(make):
    """``make(fluid)`` under a fresh name generator and program pair in
    each package: [(main, startup, result), JAX then port]."""
    out = []
    for fluid, un in ((jfluid, junique), (tfluid, tunique)):
        prev = un.switch()
        try:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                out.append((main, startup, make(fluid)))
        finally:
            un.switch(prev)
    return out


# ==========================================================================
# the schedules
# ==========================================================================
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 3, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "exponential-staircase": lambda L: L.exponential_decay(0.1, 2, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 2, 0.5),
    "natural_exp-staircase": lambda L: L.natural_exp_decay(0.1, 2, 0.5,
                                                           staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "inverse_time-staircase": lambda L: L.inverse_time_decay(0.1, 2, 0.5,
                                                             staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 4, 0.001, power=2.0),
    "polynomial-cycle": lambda L: L.polynomial_decay(0.1, 4, 0.001,
                                                     power=2.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 3),
    "linear_lr_warmup-cosine": lambda L: L.linear_lr_warmup(
        L.cosine_decay(0.1, 2, 3), 3, 0.0, 0.1),
    "linear_lr_warmup-number": lambda L: L.linear_lr_warmup(0.05, 4, 0.01,
                                                            0.05),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    (jmain, jstart, jlr), (tmain, tstart, tlr) = _in_both(
        lambda fluid: SCHEDULES[name](fluid.layers))
    assert _desc(tmain) == _desc(jmain)
    assert tmain.global_block().ops[0].type == "increment"
    jexe, jscope = pt.Executor(pt.CPUPlace()), JScope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), TScope()
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    jr = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr],
                                    scope=jscope)[0]).reshape(-1)[0])
          for _ in range(STEPS)]
    tr = [float(texe.run(tmain, fetch_list=[tlr], scope=tscope)[0]
                .reshape(-1)[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    # the counter advanced once a step, in the scope's own tensor
    assert float(tscope.get("@LR_DECAY_COUNTER@")[0]) == STEPS
    assert len(set(jr)) > 1


def test_linear_warmup_rates_by_value():
    """The recipe's rate, by hand: steps 1-2 ramp 0 -> 0.1 over 3 warm-up
    steps, then the cosine of floor(step / 2) epochs over 3."""
    (_, _, _), (tmain, tstart, tlr) = _in_both(
        lambda fluid: SCHEDULES["linear_lr_warmup-cosine"](fluid.layers))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), TScope()
    exe.run(tstart, scope=scope)
    got = [float(exe.run(tmain, fetch_list=[tlr], scope=scope)[0][0])
           for _ in range(STEPS)]
    want = [0.1 * s / 3 if s < 3 else
            0.05 * (np.cos((s // 2) * np.pi / 3) + 1)
            for s in range(1, STEPS + 1)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_variable_operators_build_the_jax_ops():
    """``+ - * / ** % //`` with Variables and scalars, unary minus and the
    comparisons: the same ops in both packages (scalars through
    ``scale``, or a ``[1]`` ``fill_constant``)."""
    def make(fluid):
        x = fluid.layers.data("x", [3], append_batch_size=False)
        y = fluid.layers.data("y", [3], append_batch_size=False)
        outs = [x + y, x - 2.0, 2.0 - x, x * 3.0, 3.0 * x, x / 4.0,
                1.0 / x, x ** 2.0, 2.0 ** x, x % y, x // y, -x, x / y]
        outs += [x < y, x <= y, x > y, x >= y, x == y, x != y, x < 1.0]
        return outs

    (jmain, _, jouts), (tmain, _, touts) = _in_both(make)
    assert _desc(tmain) == _desc(jmain)
    feed = {"x": np.array([1.5, -2.0, 3.0], np.float32),
            "y": np.array([2.0, 2.5, -3.0], np.float32)}
    j = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed, fetch_list=jouts,
                                       scope=JScope())
    t = tfluid.Executor(tfluid.CPUPlace()).run(tmain, feed=feed,
                                               fetch_list=touts,
                                               scope=TScope())
    for a, b in zip(j, t):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        touts[0][0]


# ==========================================================================
# weight decay
# ==========================================================================
def _decay_program(fluid, reg, param_reg=None):
    x = fluid.layers.data("x", [6])
    h = fluid.layers.fc(x, 5, act="relu",
                        param_attr=fluid.ParamAttr(regularizer=param_reg))
    loss = fluid.layers.mean(fluid.layers.fc(h, 3))
    fluid.optimizer.MomentumOptimizer(
        0.1, 0.9, regularization=reg).minimize(loss)
    return loss


@pytest.mark.parametrize("case", ["l2", "l1", "param-attr-l1-over-l2"])
def test_weight_decay_matches_jax(case):
    def make(fluid):
        R = fluid.regularizer
        if case == "l2":
            return _decay_program(fluid, R.L2Decay(0.05))
        if case == "l1":
            return _decay_program(fluid, R.L1Decay(0.05))
        return _decay_program(fluid, R.L2Decay(0.05), R.L1Decay(0.2))

    (jmain, jstart, jloss), (tmain, _, tloss) = _in_both(make)
    assert _desc(tmain) == _desc(jmain)
    types = [o.type for o in tmain.global_block().ops]
    # the first fc's weight: L1 wherever L1 is asked for, the others L2
    n_sign = {"l2": 0, "l1": 4, "param-attr-l1-over-l2": 1}[case]
    assert types.count("sign") == n_sign
    jexe, jscope = pt.Executor(pt.CPUPlace()), JScope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block().vars.values()
             if v.persistable]
    start = {n: np.asarray(jscope.get(n)) for n in names}
    # nonzero biases, so the decay shows on every parameter
    for n in start:
        if ".b_" in n and "velocity" not in n:
            start[n] = np.random.RandomState(3).randn(
                *start[n].shape).astype(np.float32)
            jscope.set(n, start[n])
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype(np.float32)}
    jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=[tloss], scope=tscope)
    got = numpy_state(tscope, names)
    for n in names:
        np.testing.assert_allclose(got[n], np.asarray(jscope.get(n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_dygraph_weight_decay_matches_jax():
    """One AdamOptimizer step with ``L2Decay`` (and a parameter whose own
    ``L1Decay`` takes precedence) against JAX's eager regularization
    feeding JAX's ``adam`` op."""
    from paddle_tpu.regularizer import L1Decay as JL1, L2Decay as JL2
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    rng = np.random.RandomState(4)
    params = [rng.randn(5, 3).astype(np.float32),
              rng.randn(3).astype(np.float32)]
    grads = [rng.randn(*p.shape).astype(np.float32) for p in params]
    jopt = jfluid.optimizer.AdamOptimizer(0.01, regularization=JL2(0.1))
    want = []
    for i, (p, g) in enumerate(zip(params, grads)):
        jp = type("P", (), {"_value": jnp.asarray(p),
                            "regularizer": JL1(0.3) if i == 1 else None})
        gd = jopt._eager_regularize(jp, jnp.asarray(g))
        outs = eager_call(
            "adam", {"Param": [p], "Grad": [np.asarray(gd)],
                     "Moment1": [np.zeros_like(p)],
                     "Moment2": [np.zeros_like(p)],
                     "Beta1Pow": [np.ones(1, np.float32)],
                     "Beta2Pow": [np.ones(1, np.float32)],
                     "LearningRate": [np.array([0.01], np.float32)]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
            {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
             "Beta1PowOut": 1, "Beta2PowOut": 1})
        want.append(np.asarray(outs["ParamOut"][0]))
    tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    tparams[1].regularizer = L1Decay(0.3)
    opt = AdamOptimizer(0.01, parameter_list=tparams,
                        regularization=L2Decay(0.1))
    for tp, g in zip(tparams, grads):
        tp.grad = torch.tensor(g)
    opt.minimize(None)
    for tp, w in zip(tparams, want):
        np.testing.assert_allclose(tp.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7)


def test_recipe_modules_import_no_jax():
    import os
    import subprocess
    import sys

    mods = ["paddle_tpu_torch.regularizer",
            "paddle_tpu_torch.layers.learning_rate_scheduler",
            "paddle_tpu_torch.layers.math_op_patch",
            "paddle_tpu_torch.nn.functional",
            "paddle_tpu_torch.models.mobilenet",
            "paddle_tpu_torch.tools.train_mobilenet",
            "paddle_tpu_torch.tools.check_step_capture"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
