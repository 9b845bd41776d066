"""PyTorch port, the optimizer family against the JAX package on the CPU
(``optimizer.py``, ``clip.py``, ``fuse_optimizer_ops_pass``).

* Every static optimizer and wrapper of ``paddle_tpu/optimizer.py`` but
  ``DGCMomentum`` and ``Pipeline``, each under one gradient clip (by
  global norm, by value, by norm, in turn), on a two-layer fc net (width
  16): the same serialized main and startup programs as JAX, then 5
  steps from JAX's startup scope; every loss within rtol 1e-5 of JAX's,
  and every parameter and accumulator within 1e-5 of its largest
  magnitude (the forward's f32 sums run in another order than XLA's; a
  step moves that difference by the update's sensitivity, largest for
  Adam's ``m / sqrt(v)``: measured 1.3e-6 after 5 steps).
* ``set_gradient_clip``, and an optimizer's own clip taking precedence;
  a per-parameter rate (``ParamAttr(learning_rate=)``, a ``scale`` op).
* ``ExponentialMovingAverage`` and ``ModelAverage``: the parameters
  ``apply`` swaps in equal JAX's within the same tolerance, and
  ``restore`` brings back the trained ones.
* ResNet-18 at 32x32, batch 4, under LARS with the recipe's rate
  (``linear_lr_warmup(polynomial_decay(...))``): 3 steps at the ResNet
  oracle's tolerances (``tests/torch_resnet_parity.py``).
* ``fuse_optimizer_ops_pass``: the fused program equals the unfused one
  bit for bit on the CPU for sgd, momentum and adam.
* The dygraph SGD, Momentum and Adagrad against JAX's eager ops.

Both packages build from one helper called from one line, so their
``op_callstack`` attrs agree too.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu import clip as jclip
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.ops.registry import eager_call as jeager_call

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import ir as tir
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import Scope as TScope
from paddle_tpu_torch.framework.scope import (load_numpy_state, numpy_state,
                                              scope_guard as tscope_guard)
from paddle_tpu_torch.regularizer import L2Decay

import torch_resnet_parity as rp
from paddle_tpu.utils import flags as jflags

STEPS = 5
LOSS_RTOL = 1e-5
STATE_TOL = 1e-5
PKGS = ((jfluid, junique), (tfluid, tunique))


@pytest.fixture(autouse=True)
def _jax_pass_verifier_off(monkeypatch):
    """JAX's reference programs compile without its pass verifier
    (``FLAGS_verify_passes``, on under pytest): it checks the JAX
    package's own passes, which its tests cover, never changes a number,
    and takes two thirds of a ResNet-18 compile."""
    monkeypatch.setitem(jflags._flags, "FLAGS_verify_passes", False)


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _net(fluid, lr_scale=1.0):
    """The two-layer fc classifier: (loss,)."""
    x = fluid.layers.data("x", [8])
    y = fluid.layers.data("y", [1], dtype="int64")
    h = fluid.layers.fc(x, 16, act="relu", param_attr=fluid.ParamAttr(
        learning_rate=lr_scale))
    logits = fluid.layers.fc(h, 4)
    return fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits, y))


def _build(pkg, make, lr_scale=1.0):
    """(main, startup, loss, handle): ``make(fluid, loss)`` adds the
    optimizer (and returns what the test needs), under a fresh name
    generator."""
    fluid, un = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.program_guard(main, startup):
            loss = _net(fluid, lr_scale)
            handle = make(fluid, loss)
    finally:
        un.switch(prev)
    return main, startup, loss, handle


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(6, 8).astype(np.float32),
            "y": rng.randint(0, 4, (6, 1)).astype(np.int64)}


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _train(make, steps=STEPS, lr_scale=1.0):
    """Build in both packages (one line, so the callstacks agree), check
    the programs are equal, train ``steps`` steps from JAX's startup
    scope; returns both runs' {"loss", "scope", "state", "handle",
    "main"} and the persistable names."""
    built = [_build(pkg, make, lr_scale) for pkg in PKGS]
    (jmain, jstart, jloss, jh), (tmain, tstart, tloss, th) = built
    assert _desc(tmain) == _desc(jmain)
    assert _desc(tstart) == _desc(jstart)
    jexe, jscope = pt.Executor(pt.CPUPlace()), JScope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.global_block().vars.values()
                   if v.persistable)
    tscope = TScope()
    load_numpy_state(tscope, {n: np.asarray(jscope.get(n)) for n in names},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed()
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0])))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                 scope=tscope)[0]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    want = {n: np.asarray(jscope.get(n)) for n in names}
    got = numpy_state(tscope, names)
    errs = {n: _rel(got[n], want[n]) for n in names}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STATE_TOL, (worst, errs[worst])
    return ({"loss": jl, "scope": jscope, "handle": jh, "main": jmain},
            {"loss": tl, "scope": tscope, "handle": th, "main": tmain,
             "executor": texe}, names)


#: every optimizer and wrapper, as ``make(fluid, clip)`` -> optimizer
OPTIMIZERS = {
    "sgd": lambda f, c: f.optimizer.SGD(0.1, grad_clip=c),
    "momentum": lambda f, c: f.optimizer.Momentum(0.1, 0.9, grad_clip=c),
    "momentum-nesterov": lambda f, c: f.optimizer.Momentum(
        0.1, 0.9, use_nesterov=True, grad_clip=c),
    "lars_momentum": lambda f, c: f.optimizer.LarsMomentum(
        1.0, 0.9, grad_clip=c),
    "adam": lambda f, c: f.optimizer.Adam(0.01, grad_clip=c),
    "adamw": lambda f, c: f.optimizer.AdamW(0.01, weight_decay=0.1,
                                            grad_clip=c),
    "adagrad": lambda f, c: f.optimizer.Adagrad(0.1, grad_clip=c),
    "decayed_adagrad": lambda f, c: f.optimizer.DecayedAdagradOptimizer(
        0.01, grad_clip=c),
    "adadelta": lambda f, c: f.optimizer.Adadelta(1.0, grad_clip=c),
    "adamax": lambda f, c: f.optimizer.Adamax(0.01, grad_clip=c),
    "rmsprop": lambda f, c: f.optimizer.RMSProp(0.01, grad_clip=c),
    "rmsprop-centered-momentum": lambda f, c: f.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True, grad_clip=c),
    "ftrl": lambda f, c: f.optimizer.Ftrl(0.1, l1=0.001, l2=0.01,
                                          grad_clip=c),
    "lamb": lambda f, c: f.optimizer.Lamb(
        0.01, exclude_from_weight_decay_fn=lambda p: p.name.endswith(
            ".b_0"), grad_clip=c),
    "dpsgd": lambda f, c: f.optimizer.Dpsgd(0.1, clip=1.0, batch_size=1.0,
                                            sigma=0.0, grad_clip=c),
    "recompute": lambda f, c: _recompute(f, c),
    "lookahead": lambda f, c: f.optimizer.LookaheadOptimizer(
        f.optimizer.Momentum(0.1, 0.9, grad_clip=c), alpha=0.5, k=2),
}

#: the gradient clips; their bounds bind on this net's gradients
CLIPS = {
    "no-clip": lambda f: None,
    "by-value": lambda f: f.GradientClipByValue(0.05),
    "by-norm": lambda f: f.GradientClipByNorm(0.1),
    "by-global-norm": lambda f: f.GradientClipByGlobalNorm(0.2),
}


def _recompute(fluid, clip):
    opt = fluid.optimizer.RecomputeOptimizer(
        fluid.optimizer.SGD(0.1, grad_clip=clip))
    opt._set_checkpoints(["fc_0.tmp_2"])
    return opt


#: each optimizer under one clip, the three clips in turn (a JAX compile
#: takes about 1.5 s a program, so the whole cross would take minutes);
#: the no-clip path is the other tests'
CLIP_OF = {name: ("by-global-norm", "by-value", "by-norm")[i % 3]
           for i, name in enumerate(sorted(OPTIMIZERS))}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    clip = CLIP_OF[name]
    _, port, _ = _train(lambda f, loss: OPTIMIZERS[name](
        f, CLIPS[clip](f)).minimize(loss))
    types = [o.type for o in port["main"].global_block().ops]
    assert ("clip" in types) == (clip == "by-value")
    assert ("clip_by_norm" in types) == (clip == "by-norm")
    assert ("squared_l2_norm" in types) == (clip == "by-global-norm")
    assert port["loss"][-1] < port["loss"][0]


def test_clips_bind_on_the_net():
    """Each clip changes the port's first update: its bound is below the
    gradients' values / norms (so the parity cases above clip)."""
    first = {}
    for clip in sorted(CLIPS):
        (main, startup, loss, _), = [_build(PKGS[1], lambda f, loss: (
            f.optimizer.SGD(0.1, grad_clip=CLIPS[clip](f)).minimize(loss)))]
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), TScope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        first[clip] = numpy_state(scope, [p.name
                                          for p in main.all_parameters()])
    for clip in ("by-value", "by-norm", "by-global-norm"):
        assert all(not np.array_equal(first[clip][n], first["no-clip"][n])
                   for n in first[clip]), clip


@pytest.fixture
def global_clip():
    """Restore both packages' set_gradient_clip slot."""
    yield
    jclip._global_clip[0] = None
    tclip._global_clip[0] = None


def test_set_gradient_clip(global_clip):
    """The global clip applies to an optimizer without its own; an
    optimizer's own clip takes precedence."""
    def make(fluid, loss):
        (tclip if fluid is tfluid else jclip).set_gradient_clip(
            fluid.GradientClipByValue(0.05))
        return fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)

    with pytest.warns(UserWarning, match="deprecated"):
        _, port, _ = _train(make)
    assert "clip" in [o.type for o in port["main"].global_block().ops]

    # the optimizer's own clip
    (main, _, _, _), = [_build(PKGS[1], lambda f, loss: f.optimizer.Momentum(
        0.1, 0.9, grad_clip=f.GradientClipByNorm(0.1)).minimize(loss))]
    types = [o.type for o in main.global_block().ops]
    assert "clip_by_norm" in types and "clip" not in types


def test_per_parameter_rate():
    """``ParamAttr(learning_rate=0.5)`` on the first fc's weight: a
    ``scale`` of the rate feeds its update op alone (so it is not fused
    with the others)."""
    _, port, _ = _train(lambda f, loss: f.optimizer.Momentum(
        0.1, 0.9).minimize(loss), lr_scale=0.5)
    ops = port["main"].global_block().ops
    scaled = [o for o in ops if o.type == "scale"
              and o.input("X")[0].startswith("learning_rate")]
    assert len(scaled) == 1 and scaled[0].attr("scale") == 0.5
    plan = next(iter(port["executor"]._cache.values()))
    types = [o.type for o in plan.ops]
    assert types.count("momentum") == 1 and types.count(
        "fused_momentum") == 1


def _np(v):
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)


def _swapped(run, fluid, scope_guard, apply):
    """The parameters inside ``apply()`` and after it, with the run's
    program the default main program (whose parameters ``apply`` swaps)
    and its scope the global scope."""
    main, scope = run["main"], run["scope"]
    names = [p.name for p in main.all_parameters()]
    with fluid.program_guard(main), scope_guard(scope):
        with apply():
            inside = {n: _np(scope.get(n)) for n in names}
    return inside, {n: _np(scope.get(n)) for n in names}


def test_exponential_moving_average_apply_restore():
    def make(fluid, loss):
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(0.8)
        ema.update()
        return ema

    jax_run, port, names = _train(make)
    params = [p.name for p in port["main"].all_parameters()]
    assert all(n + "@EMA" in names for n in params)
    j_in, j_after = _swapped(jax_run, jfluid, jscope_guard,
                             jax_run["handle"].apply)
    t_in, t_after = _swapped(port, tfluid, tscope_guard,
                             port["handle"].apply)
    for n in params:
        assert _rel(t_in[n], j_in[n]) <= STATE_TOL, n
        np.testing.assert_array_equal(
            t_in[n], port["scope"].get(n + "@EMA").numpy())
        assert _rel(t_after[n], j_after[n]) <= STATE_TOL, n
        assert not np.array_equal(t_in[n], t_after[n])


def test_model_average_apply_restore():
    """A window of 2-3 updates over 5 steps: the sums roll into sum_3."""
    def make(fluid, loss):
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return fluid.optimizer.ModelAverage(
            0.5, min_average_window=2, max_average_window=3)

    jax_run, port, names = _train(make)
    params = [p.name for p in port["main"].all_parameters()]
    for n in params:
        assert int(port["scope"].get(n + "_old_num_accumulates")[0]) > 0
    ja, ta = jax_run["handle"], port["handle"]
    j_in, j_after = _swapped(jax_run, jfluid, jscope_guard,
                             lambda: ja.apply(scope=jax_run["scope"]))
    t_in, t_after = _swapped(port, tfluid, tscope_guard,
                             lambda: ta.apply(scope=port["scope"]))
    for n in params:
        assert _rel(t_in[n], j_in[n]) <= STATE_TOL, n
        assert _rel(t_after[n], j_after[n]) <= STATE_TOL, n
        assert not np.array_equal(t_in[n], t_after[n])
    # restore() after apply(need_restore=False)
    with ta.apply(need_restore=False, scope=port["scope"]):
        pass
    ta.restore(scope=port["scope"])
    for n in params:
        np.testing.assert_array_equal(port["scope"].get(n).numpy(),
                                      t_after[n])


def _lars(fluid, lr0=2.0, decay_steps=10, warmup=2):
    """LARS at Paddle's defaults on the recipe's rate: a linear warm-up to
    ``lr0``, then a power-2 polynomial decay to 1e-4."""
    L = fluid.layers
    rate = L.linear_lr_warmup(
        L.polynomial_decay(lr0, decay_steps, 1e-4, power=2.0), warmup, 0.0,
        lr0)
    return fluid.optimizer.LarsMomentum(rate, 0.9)


def test_resnet18_lars_matches_jax(monkeypatch):
    types = rp.check_training(18, 32, False, monkeypatch, opt=_lars)
    assert types.count("lars_momentum") == 62
    assert "momentum" not in types and "fused_momentum" not in types


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_fused_program_equals_unfused(monkeypatch, kind):
    """The port's step with ``fuse_optimizer_ops_pass`` against the same
    program with the pass made a no-op: losses and every state tensor
    equal bit for bit over 3 steps."""
    make = {"sgd": lambda f: f.optimizer.SGD(0.1),
            "momentum": lambda f: f.optimizer.Momentum(0.1, 0.9),
            "adam": lambda f: f.optimizer.Adam(0.01)}[kind]
    (main, startup, loss, _), = [_build(
        PKGS[1], lambda f, loss: make(f).minimize(loss))]
    runs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(tir.FuseOptimizerOpsPass, "apply_impl",
                                lambda self, program: program)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), TScope()
        exe.run(startup, scope=scope)
        losses = [exe.run(main, feed=_feed(), fetch_list=[loss],
                          scope=scope)[0] for _ in range(3)]
        names = sorted(n for n, _ in scope.items())
        types = [o.type for o in next(
            p for k, p in exe._cache.items() if k[0] == main._uid).ops]
        assert (("fused_" + kind) in types) == fused
        assert (kind in types) != fused
        runs.append((losses, numpy_state(scope, names)))
    (fl, fs), (ul, us) = runs
    for a, b in zip(fl, ul):
        np.testing.assert_array_equal(a, b)
    assert fs.keys() == us.keys()
    for n in fs:
        np.testing.assert_array_equal(fs[n], us[n], err_msg=n)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adagrad"])
def test_dygraph_update_matches_jax_ops(kind):
    """3 dygraph steps of SGD / Momentum / Adagrad (with L2 decay on
    one parameter) against JAX's eager op calls."""
    rng = np.random.RandomState(0)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    params[1].regularizer = L2Decay(0.1)
    opt = {"sgd": lambda: topt.SGD(0.1, parameter_list=params),
           "momentum": lambda: topt.Momentum(0.1, 0.9,
                                             parameter_list=params),
           "adagrad": lambda: topt.Adagrad(
               0.1, initial_accumulator_value=0.1,
               parameter_list=params)}[kind]()
    lr = np.array([0.1], np.float32)
    want = [p.copy() for p in p0]
    state = [{} for _ in p0]
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        opt.minimize(None)
        for i, g in enumerate(step):
            if i == 1:
                g = g + np.float32(0.1) * want[i]
            ins = {"Param": [want[i]], "Grad": [g], "LearningRate": [lr]}
            if kind == "momentum":
                v = state[i].setdefault("v", np.zeros_like(want[i]))
                out = jeager_call("momentum", dict(ins, Velocity=[v]),
                                  {"mu": 0.9, "use_nesterov": False},
                                  {"ParamOut": 1, "VelocityOut": 1})
                state[i]["v"] = np.asarray(out["VelocityOut"][0])
            elif kind == "adagrad":
                m = state[i].setdefault("m", np.full_like(want[i], 0.1))
                out = jeager_call("adagrad", dict(ins, Moment=[m]),
                                  {"epsilon": 1e-6},
                                  {"ParamOut": 1, "MomentOut": 1})
                state[i]["m"] = np.asarray(out["MomentOut"][0])
            else:
                out = jeager_call("sgd", ins, {}, {"ParamOut": 1})
            want[i] = np.asarray(out["ParamOut"][0])
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7)


def test_collective_optimizers_and_left_out_dygraph_forms_raise():
    with pytest.raises(NotImplementedError, match="collectives"):
        topt.DGCMomentumOptimizer(0.1, 0.9)
    with pytest.raises(NotImplementedError, match="pipeline"):
        topt.PipelineOptimizer(topt.SGD(0.1))
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    for opt in (topt.AdamW(0.01, parameter_list=[p]),
                topt.Lamb(0.01, parameter_list=[p]),
                topt.RMSProp(0.01, parameter_list=[p])):
        with pytest.raises(NotImplementedError, match="dygraph"):
            opt.minimize(None)

