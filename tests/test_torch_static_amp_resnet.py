"""PyTorch port, static AMP in bf16: ResNet training under
``decorate(MomentumOptimizer)`` against the JAX package on the CPU, from
JAX's startup scope copied into the port, on one numpy batch (the
programs and lowerings are held in ``test_torch_static_amp.py``).

* ResNet-18, batch 4, 32x32, 3 steps, with the epilogue fusion on and
  off (JAX's Pallas kernels in interpret mode, the port's plain versions)
  and in NCHW and NHWC (``FLAGS_tpu_nhwc`` / ``FLAGS_cuda_nhwc``);
  ResNet-18 at batch 16, 64x64, one step;
* ResNet-50 at the ``torch_resnet_parity`` oracle size, fused, 2 steps;
* after step 1, every parameter and velocity against JAX's, within the
  envelope of a JAX twin whose images carry 1e-6 relative noise
  (``torch_resnet_parity.NOISE``), as ``test_torch_resnet.py`` holds
  f32 ResNet-50;
* in the port alone: fused == unfused bit for bit (losses and state),
  NHWC == NCHW at step 1.

A deep untrained BN net at batch 4 is chaotic (``test_torch_resnet.py``),
and bf16 roundings in two summation orders feed that chaos more than f32
noise does; each tolerance is stated with what was measured.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)

from test_torch_static_amp import (JAX, PORT, _build, _set_flags,
                                   _start_scope)
from torch_resnet_parity import NOISE, rel_errs


def _resnet_feed(image, batch=4, classes=100, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 3, image, image).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def _train_both(feed, steps, depth=18, image=32):
    """Both packages' losses over ``steps`` steps from JAX's startup
    scope; per persistable tensor, the port's error after step 1
    (``rel_errs``: the largest difference over JAX's largest magnitude)
    and that of a JAX twin whose step-1 images carry ``NOISE`` relative
    noise; and the port's plan op types."""
    (jmain, jstart, jloss), (tmain, _, tloss) = [
        _build(pkg, "resnet", depth, image, train=True)
        for pkg in (JAX, PORT)]
    jexe = pt.Executor(pt.CPUPlace())
    jscope, start = _start_scope(jexe, jstart)
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl = [], []
    for step in range(steps):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0])))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                 scope=tscope)[0]))
        if step == 0:
            want = {n: np.asarray(jscope.get(n)) for n in start}
            errs = rel_errs(numpy_state(tscope, list(start)), want)
    twin = JScope()
    for n, v in start.items():
        twin.set(n, v.copy())
    noisy = feed["img"] * (1 + NOISE * np.random.RandomState(1).randn(
        *feed["img"].shape))
    jexe.run(jmain, feed={"img": noisy.astype(np.float32),
                          "label": feed["label"]},
             fetch_list=[jloss], scope=twin)
    noise = rel_errs({n: np.asarray(twin.get(n)) for n in start}, want)
    plan = list(texe._cache.values())[-1]
    return jl, tl, errs, noise, [o.type for o in plan.ops]


def _check_after_step_1(errs, noise):
    """The port's state after step 1 against the JAX twin's envelope, for
    the velocities (the step-1 gradients) and for the other tensors
    (parameters, BN statistics) apart: the worst tensor within twice the
    twin's worst, the median tensor within twice the twin's median."""
    for group in (lambda n: "velocity" in n, lambda n: "velocity" not in n):
        got = {n: e for n, e in errs.items() if group(n)}
        env = [e for n, e in noise.items() if group(n)]
        worst = max(got, key=got.get)
        assert got[worst] <= 2 * max(env), (worst, got[worst], max(env))
        med = float(np.median(list(got.values())))
        assert med <= 2 * float(np.median(env)), (med, np.median(env))


#: ResNet-18, batch 4, 32x32: step 1 within 2e-3 relative (measured
#: 4.3e-4 in all four layouts and fusions: bf16 roundings of the convs in
#: two summation orders); steps 2 and 3 within LATER_RTOL relative and
#: the loss falling (measured: up to 4.9% at step 2, 18.5% at step 3,
#: unfused NHWC: the roundings fed through a chaotic net and Momentum).
#: After step 1 every parameter and velocity (the step-1 gradient) is
#: held to the JAX noise envelope (``_check_after_step_1``): no fixed
#: tolerance can hold them here, because 1e-6 relative noise on the
#: images (below a bf16 ulp: it flips the roundings of a few pixels)
#: moves JAX's own velocities by up to 1.7x their largest value, median
#: 0.89 (the other tensors: worst 1.38, median 0.011); the port,
#: measured: velocities worst 1.65, median 0.96; the others worst 1.40,
#: median 0.012
RESNET_STEP1_RTOL = 2e-3
LATER_RTOL = 0.3


@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_resnet18_amp_training_matches_jax(monkeypatch, fuse, nhwc):
    _set_flags(monkeypatch, fuse, nhwc)
    jl, tl, errs, noise, types = _train_both(_resnet_feed(32), 3)
    assert types.count("fused_conv_bn_act") == (17 if fuse else 0)
    assert (types.count("transpose2") > 0) == nhwc
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    assert abs(tl[0] - jl[0]) / abs(jl[0]) <= RESNET_STEP1_RTOL, (jl, tl)
    for a, b in zip(jl[1:], tl[1:]):
        assert abs(a - b) <= LATER_RTOL * abs(a), (jl, tl)
    _check_after_step_1(errs, noise)


#: ResNet-18 at batch 16, 64x64, where the step is less chaotic (the
#: last stage's BN sees 64 values a channel, not 4), unfused in both:
#: 1e-6 image noise moves JAX's own velocities by at most 0.55 of their
#: largest, median 0.28 (the other tensors: 0.39, median 7.6e-4); the
#: port, measured: velocities worst 0.40, median 0.24; the others 0.33,
#: median 6.5e-4.  The envelope catches a grad op that is grossly wrong
#: (a zero or sign-flipped gradient is 1 or 2 relative to its largest);
#: a subtle one (cx off by 5% in the bf16 BN backward moved the velocity
#: median from 0.236 to 0.234) only the op-level grad cases of
#: ``test_torch_static_amp.py`` catch.
def test_resnet18_amp_step_at_batch_16_64px_matches_jax(monkeypatch):
    _set_flags(monkeypatch, False, False)
    jl, tl, errs, noise, _ = _train_both(_resnet_feed(64, batch=16), 1,
                                         image=64)
    assert abs(tl[0] - jl[0]) / abs(jl[0]) <= RESNET_STEP1_RTOL, (jl, tl)
    _check_after_step_1(errs, noise)


#: ResNet-50 at the oracle size (batch 4, 32x32; BN over 1x1 maps of 4
#: values in the last stage, where 1e-6 of input noise moves JAX's own
#: f32 loss by 6e-4): step 1 within 1e-2 relative (measured 1.5e-3),
#: step 2 within LATER_RTOL (measured 9.7e-3); after step 1 the noise
#: envelope, which here scrambles the gradients (the twin's velocities:
#: worst 2.1, median 1.36, the other tensors 2.1, median 0.10; the
#: port's, measured: 1.9, median 1.32, and 1.8, median 0.11), so it
#: only bounds them; the op-level grad cases in
#: ``test_torch_static_amp.py`` hold the backward tightly
RESNET50_STEP1_RTOL = 1e-2


def test_resnet50_amp_at_the_oracle_size_matches_jax(monkeypatch):
    _set_flags(monkeypatch, True, False)
    jl, tl, errs, noise, types = _train_both(_resnet_feed(32), 2, depth=50)
    assert types.count("fused_conv_bn_act") == 49
    assert np.isfinite(tl).all()
    assert abs(tl[0] - jl[0]) / abs(jl[0]) <= RESNET50_STEP1_RTOL, (jl, tl)
    assert abs(tl[1] - jl[1]) <= LATER_RTOL * abs(jl[1]), (jl, tl)
    _check_after_step_1(errs, noise)


def test_port_amp_fusion_and_layout_change_no_step_1_number(monkeypatch):
    """In the port, fused == unfused bit for bit for both steps, losses
    and every state tensor (the fused ops round where the unfused chain
    rounds), and NHWC == NCHW at
    step 1 within 1e-6 (the same products in another memory order;
    measured equal); NHWC's second step within LATER_RTOL (measured
    2.4e-4)."""
    runs, states = {}, {}
    for fuse, nhwc in ((False, False), (True, False), (True, True)):
        _set_flags(monkeypatch, fuse, nhwc)
        main, startup, loss = _build(PORT, "resnet", train=True)
        scope = TScope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs[(fuse, nhwc)] = [float(exe.run(main, feed=_resnet_feed(32),
                                            fetch_list=[loss],
                                            scope=scope)[0])
                              for _ in range(2)]
        states[(fuse, nhwc)] = numpy_state(scope, [n for n, _ in
                                                   scope.items()])
    assert runs[(False, False)] == runs[(True, False)]
    unfused, fused = states[(False, False)], states[(True, False)]
    assert sorted(unfused) == sorted(fused)
    for n in unfused:
        np.testing.assert_array_equal(fused[n], unfused[n], err_msg=n)
    a, b = runs[(True, False)], runs[(True, True)]
    assert abs(a[0] - b[0]) <= 1e-6 * abs(a[0])
    for x, y in zip(a[1:], b[1:]):
        assert abs(x - y) <= LATER_RTOL * abs(x)
