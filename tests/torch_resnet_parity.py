"""Shared by the port's ResNet parity tests (``test_torch_resnet.py``,
``test_torch_static_core.py``): build the same ResNet train program in
both packages, copy the JAX startup scope into the port, train both on
one numpy feed, and hold the port's distance to JAX after step 1 to
the tolerances ``test_torch_resnet.py`` states and explains.

Run as a script, it prints both packages' loss at every step of longer
runs on one repeated batch, to compare their training dynamics:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_resnet_parity.py \
        --lr 0.1 --depth 50 --batch 16 --image 64 --classes 1000 --steps 12
"""
import argparse
import os

import numpy as np

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.resnet import build_resnet as jbuild_resnet
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)
from paddle_tpu_torch.models.resnet import build_resnet as tbuild_resnet
from paddle_tpu_torch.utils import flags as tflags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (jfluid, junique, jbuild_resnet)
PORT = (tfluid, tunique, tbuild_resnet)
STEPS = 3
#: (depth, image) -> step-1 loss rtol
LOSS_RTOL = {(18, 32): 1e-5, (50, 64): 1e-5, (50, 32): 2e-4}
#: (depth, image) -> after-step-1 tolerance, relative to each tensor's
#: largest magnitude (absent: the JAX noise envelope)
AFTER1_TOL = {(18, 32): 2e-3}
#: relative input noise of the envelope's JAX twin
NOISE = 1e-6


def build(pkg, depth, image, lr=0.01, classes=100, opt=None):
    """(main, startup, loss, acc1) of the ResNet train program in the
    package ``pkg`` = (fluid, unique_name, build_resnet), from a fresh
    name generator; the optimizer is ``opt(fluid)``, by default
    Momentum 0.9 at ``lr``."""
    fluid, un, build_resnet = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, acc1, _, _ = build_resnet(img, label, depth=depth,
                                            class_num=classes)
            (opt(fluid) if opt is not None else
             fluid.optimizer.MomentumOptimizer(lr, 0.9)).minimize(loss)
    finally:
        un.switch(prev)
    return main, startup, loss, acc1


def feed(image, seed=0, batch=4, classes=100):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 3, image, image).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def rel_errs(got, want):
    """Per tensor: largest |got - want| over the largest |want|."""
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-12) for n, w in want.items()}


def train_both(depth, image, envelope, opt=None):
    """Losses of STEPS steps in each package, the relative errors of the
    port's state after step 1, and the port's compiled op types; with
    ``envelope`` also the errors of a JAX twin whose step-1 images carry
    ``NOISE`` relative noise.  ``opt`` as :func:`build`'s."""
    jmain, jstart, jloss, jacc = build(JAX, depth, image, opt=opt)
    tmain, _, tloss, tacc = build(PORT, depth, image, opt=opt)
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block().vars.values()
             if v.persistable]
    start = {n: np.asarray(jscope.get(n)) for n in names}
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    data = feed(image)
    losses = {"jax": [], "port": []}
    errs = {}
    for step in range(STEPS):
        j = jexe.run(jmain, feed=data, fetch_list=[jloss, jacc], scope=jscope)
        t = texe.run(tmain, feed=data, fetch_list=[tloss, tacc], scope=tscope)
        losses["jax"].append(float(np.asarray(j[0])))
        losses["port"].append(float(t[0]))
        if step == 0:
            want = {n: np.asarray(jscope.get(n)) for n in names}
            errs["port"] = rel_errs(numpy_state(tscope, names), want)
    if envelope:
        twin = JScope()
        for n, v in start.items():
            twin.set(n, v.copy())
        noisy = data["img"] * (1 + NOISE * np.random.RandomState(1).randn(
            *data["img"].shape))
        jexe.run(jmain, feed={"img": noisy.astype(np.float32),
                              "label": data["label"]},
                 fetch_list=[jloss], scope=twin)
        errs["noise"] = rel_errs({n: np.asarray(twin.get(n))
                                  for n in names}, want)
    plan = next(iter(texe._cache.values()))
    return losses, errs, [o.type for o in plan.ops]


def check_training(depth, image, fuse, monkeypatch, opt=None):
    """Train both packages with the fusion forced on or off (the JAX
    Pallas kernels in interpret mode) and hold the port to the
    tolerances above; ``opt`` as :func:`build`'s.  Returns the port's
    compiled op types."""
    if fuse:
        monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "1" if fuse else "0")
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse", "1" if fuse else "0")
    tol = AFTER1_TOL.get((depth, image))
    losses, errs, types = train_both(depth, image, envelope=tol is None,
                                     opt=opt)
    n_chains = {18: 17, 50: 49}[depth]
    assert types.count("fused_conv_bn_act") == (n_chains if fuse else 0)
    assert types.count("fused_conv_bn_act_grad") == (n_chains if fuse else 0)

    jl, tl = losses["jax"], losses["port"]
    assert np.isfinite(tl).all(), tl
    assert abs(tl[0] - jl[0]) / abs(jl[0]) <= LOSS_RTOL[(depth, image)], \
        (jl, tl)
    for a, b in zip(jl[1:], tl[1:]):
        assert abs(a - b) <= max(1e-3, 0.2 * abs(a)), (jl, tl)

    worst = max(errs["port"], key=errs["port"].get)
    bound = tol if tol is not None else 2 * max(errs["noise"].values())
    assert errs["port"][worst] <= bound, (worst, errs["port"][worst], bound)
    return types


def trajectories(depth, batch, image, classes, lr, steps):
    """Each package's loss at every step on one repeated batch, both from
    the JAX startup scope; fusion at each package's default."""
    jmain, jstart, jloss, _ = build(JAX, depth, image, lr, classes)
    tmain, _, tloss, _ = build(PORT, depth, image, lr, classes)
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    tscope = TScope()
    load_numpy_state(tscope, {
        v.name: np.asarray(jscope.get(v.name))
        for v in jstart.global_block().vars.values() if v.persistable},
        "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    data = feed(image, batch=batch, classes=classes)
    for step in range(steps):
        j = jexe.run(jmain, feed=data, fetch_list=[jloss], scope=jscope)
        t = texe.run(tmain, feed=data, fetch_list=[tloss], scope=tscope)
        print(f"lr {lr} step {step}: jax {float(np.asarray(j[0])):.4f} "
              f"port {float(t[0]):.4f}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=12)
    a = ap.parse_args()
    trajectories(a.depth, a.batch, a.image, a.classes, a.lr, a.steps)
