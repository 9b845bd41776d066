"""PyTorch port, static PSPNet segmentation training
(``tests/torch_static_pspnet.py``) against the JAX package: the program
both build, op for op; 3 Momentum steps of :data:`TINY` (a dilated
ResNet-50 layout with one bottleneck a stage at base width 8, the
pyramid pooling module over bins 1 / 2 / 3 / 6, the auxiliary head, 5
classes, batch 2 of 96x96 crops with about 10% of the pixels ignored;
dropout off: the two packages' masks differ) from JAX's startup scope
copied as numpy, on JAX's serialized program, in f32 and under bf16
``decorate``; the mean IoU the program fetches; the conv -> BN -> ReLU
chains the port's pipeline fuses.

Tolerances (relative to each tensor's largest magnitude, at least
1e-3): f32 1e-5 on each step's loss, 1e-4 on every parameter, momentum
and running statistic after the last step (1.8e-5 measured, on a
BatchNorm bias's momentum), the mean IoU to 1e-6; bf16 2e-3 on the
losses (4.5e-4 measured), 1e-2 on the convolutions' weights and biases
(3.2e-3 measured: the 16-bit products round in another order), the mean
IoU to 2e-3 (an argmax flips where two logits nearly tie).  Under bf16
the rest of the state (the momenta, convolutions' among them, and the
BatchNorm parameters and running statistics) is not fixed by the inputs
at bf16 precision: JAX against itself, on images carrying half a bf16
rounding step of noise (its twin), moves a convolution's momentum by up
to 2.6 times its size and a BatchNorm bias by 91% of its size (the
port: 2.0 times and 24%).  Each such tensor is held within
TWIN_ENVELOPE times the twin's distance from JAX (at most 2.33 times
measured, on a running mean; 0.94 on a convolution's momentum).
JAX's bf16 ``batch_norm_grad`` summing in bf16 (a known divergence,
ROADMAP.md Queue 3) is not the cause: with its sums in f32 the
distances stay the same.  f32 runs at batch 4: BatchNorm over the 1x1 bin of a batch of 2 divides
by a variance small enough to amplify the summation order's last bits
(9% on a momentum at batch 2).  JAX's runs turn its pass verifier off.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)
from paddle_tpu_torch.utils import flags as tflags

import torch_static_pspnet as psp

STEPS = 3
#: (batch, rate) a run
RUN = {None: (4, 0.01), "bfloat16": (2, 0.01)}
TOL = {None: dict(loss=1e-5, state=1e-4, miou=1e-6),
       "bfloat16": dict(loss=2e-3, state=1e-2, miou=2e-3)}
#: bf16: the state outside the convolutions' parameters against JAX's
#: distance from its twin on images with half a rounding step of noise
TWIN_NOISE = 2.0 ** -9
TWIN_ENVELOPE = 3.0


@pytest.fixture
def flags(monkeypatch):
    monkeypatch.setitem(jflags._flags, "FLAGS_verify_passes", "0")
    old_j = jflags._flags.get("FLAGS_tpu_fuse")
    old_t = dict(tflags._SET)
    yield
    jflags._flags["FLAGS_tpu_fuse"] = old_j
    tflags._SET.clear()
    tflags._SET.update(old_t)


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_port_builds_the_jax_program(amp):
    """``build_pspnet`` gives one program in both packages: ops, attrs
    and vars; its startup program too."""
    cfg = dict(psp.TINY, dropout=0.1)
    (jm, js, _, _), (tm, ts, _, _) = (
        psp.build_pspnet(f, u, cfg, amp=amp)
        for f, u in ((jfluid, junique), (tfluid, tunique)))
    jd, td = _desc(jm), _desc(tm)
    assert td == jd
    assert _desc(ts) == _desc(js)
    types = [o["type"] for o in td["blocks"][0]["ops"]]
    for t in ("bilinear_interp", "bilinear_interp_grad", "arg_max",
              "mean_iou", "pool2d_grad"):
        assert t in types, t
    assert types.count("bilinear_interp") == len(cfg["bins"]) + 2


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's run of each dtype, made once for the module's tests."""
    return {}


def _jax_train(jmain, start, fetch, batch, noise=0.0):
    """JAX's losses, mean IoUs and final state, STEPS steps from
    ``start``, the images times (1 + ``noise`` N(0, 1))."""
    exe = pt.Executor(pt.CPUPlace())
    scope = JScope()
    for n, v in start.items():
        scope.set(n, v)
    losses, mious = [], []
    for step in range(STEPS):
        feed = psp.pspnet_feed(psp.TINY, batch, seed=step)
        if noise:
            r = np.random.RandomState(100 + step).randn(*feed["image"].shape)
            feed["image"] = (feed["image"] * (1 + noise * r)).astype(
                np.float32)
        r = exe.run(jmain, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(r[0])))
        mious.append(float(np.asarray(r[1])))
    return losses, mious, {n: np.asarray(scope.get(n), np.float64)
                           for n in start}


def _run_jax(amp, runs):
    """JAX's losses, mean IoUs and final state, its serialized program and
    startup state (bf16: its twin's final state too), from ``runs`` or
    made into it."""
    if amp not in runs:
        batch, lr = RUN[amp]
        jflags._flags["FLAGS_tpu_fuse"] = "0"
        jmain, jstart, loss, miou = psp.build_pspnet(
            jfluid, junique, psp.TINY, lr=lr, decay_steps=10, amp=amp)
        scope = JScope()
        pt.Executor(pt.CPUPlace()).run(jstart, scope=scope)
        start = {v.name: np.asarray(scope.get(v.name))
                 for v in jstart.global_block().vars.values()
                 if v.persistable}
        fetch = [loss.name, miou.name]
        losses, mious, state = _jax_train(jmain, start, fetch, batch)
        runs[amp] = dict(
            program=jmain.serialize_to_string(), start=start, fetch=fetch,
            losses=losses, mious=mious, state=state,
            twin=amp and _jax_train(jmain, start, fetch, batch,
                                    TWIN_NOISE)[2])
    return runs[amp]


def _train_port(amp, fuse, ref):
    """The port's losses, mean IoUs, final state and compiled op types on
    JAX's serialized program from JAX's startup state."""
    batch, _ = RUN[amp]
    tflags.set_flags({"FLAGS_cuda_fuse": "1" if fuse else "0"})
    tmain = tfluid.Program.parse_from_string(ref["program"])
    scope = TScope()
    load_numpy_state(scope, ref["start"], "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, mious = [], []
    for step in range(STEPS):
        r = exe.run(tmain, feed=psp.pspnet_feed(psp.TINY, batch, seed=step),
                    fetch_list=ref["fetch"], scope=scope)
        losses.append(float(r[0]))
        mious.append(float(r[1]))
    state = {n: np.asarray(v, np.float64)
             for n, v in numpy_state(scope, list(ref["state"])).items()}
    plan = next(iter(exe._cache.values()))
    return losses, mious, state, [o.type for o in plan.ops]


@pytest.mark.parametrize("amp,fuse", [(None, False), (None, True),
                                      ("bfloat16", False)],
                         ids=["f32", "f32-fused", "bf16"])
def test_pspnet_trains_like_jax(flags, jax_runs, amp, fuse):
    """3 steps against JAX's (unfused: its fused ops run the same jnp
    math on the CPU): each step's loss and the mean IoU it fetches, and
    after the last step the state within TOL of JAX's (bf16: the
    convolutions' parameters; the rest within TWIN_ENVELOPE times JAX's
    distance from its twin); fused, every conv -> BN (+ add) -> ReLU
    chain is one fused_conv_bn_act and its grad: the backbone's 13 (the
    stem and three a block; the shortcuts' BatchNorms have no ReLU), the
    4 bins' and the two heads'."""
    ref = _run_jax(amp, jax_runs)
    tl, tm, state, types = _train_port(amp, fuse, ref)
    tol = TOL[amp]
    assert np.isfinite(tl).all(), tl
    for a, b in zip(ref["losses"], tl):
        assert abs(a - b) <= tol["loss"] * abs(a), (ref["losses"], tl)
    np.testing.assert_allclose(tm, ref["mious"], rtol=0, atol=tol["miou"])
    assert all(0.0 <= m <= 1.0 for m in tm)
    for n, want in ref["state"].items():
        gap = np.abs(state[n] - want).max()
        if amp is None or (n.startswith("conv2d") and "velocity" not in n):
            scale = max(np.abs(want).max(), 1e-3)
            assert gap <= tol["state"] * scale, n
        else:
            assert gap <= TWIN_ENVELOPE * np.abs(ref["twin"][n] - want).max(
            ), n
    blocks = sum(psp.TINY["blocks"])
    chains = 3 * blocks + 1 + len(psp.TINY["bins"]) + 2
    assert types.count("fused_conv_bn_act") == (chains if fuse else 0)
    assert types.count("fused_conv_bn_act_grad") == (chains if fuse else 0)


def test_mean_iou_with_ignore_labels_matches_jax():
    """The mean_iou op on a 19-class prediction against labels with 255
    and -1 among them: JAX's ``.at[label, pred].add`` drops the 255
    pairs and counts -1 as the last class; the port's the same, without
    an index outside the matrix."""
    from test_torch_static_ops import _check
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 19, (2, 30, 30))
    label = rng.randint(0, 19, (2, 30, 30))
    label[rng.rand(2, 30, 30) < 0.1] = 255
    label[rng.rand(2, 30, 30) < 0.02] = -1
    j, t = _check("mean_iou", {"Predictions": [("p", pred.astype(np.int64))],
                               "Labels": [("l", label.astype(np.int64))]},
                  {"OutMeanIou": ["m"], "OutWrong": ["w"],
                   "OutCorrect": ["c"]}, {"num_classes": 19},
                  int_slots=("Predictions", "Labels"),
                  tol=dict(rtol=1e-6, atol=0))
    assert 0 < float(t["m"]) < 1


@pytest.mark.parametrize("fluid,unique", [(jfluid, junique),
                                          (tfluid, tunique)],
                         ids=["jax", "port"])
def test_non_divisible_adaptive_pool_raises(fluid, unique):
    """At an 80x80 crop the output-stride-8 map is 10x10, which bins 3
    and 6 do not divide: the pyramid's ``adaptive_pool2d`` raises
    NotImplementedError in both packages when the step runs."""
    prev = unique.switch()
    try:
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            x = fluid.data("x", [-1, 4, 10, 10], "float32")
            out = fluid.layers.adaptive_pool2d(x, 3, pool_type="avg")
    finally:
        unique.switch(prev)
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(NotImplementedError):
        exe.run(main, feed={"x": np.ones((2, 4, 10, 10), np.float32)},
                fetch_list=[out.name])


def test_pspnet_module_trains_the_port_and_imports_no_jax():
    """``tests/torch_static_pspnet.py``, as chip_smoke.py uses it, trains
    the port's TINY PSPNet on the CPU from its command line and imports
    neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import torch_static_pspnet as p\n"
            "p.main(['--tiny', '--device', 'cpu', '--steps', '1'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert sum(ln.startswith("step ") for ln in lines) == 1
