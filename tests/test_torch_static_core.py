"""PyTorch port, the static-graph core: the Program IR against the JAX
package's, the pass pipeline, the executor's contract.

* IR: a ResNet train program the JAX package serialized parses in the
  port with an equal ``desc_dict``; the port's own ``fluid`` layers build
  the same program (main and startup), before and after ``minimize``.
* Passes: with the epilogue fusion forced on, the port's pipeline leaves
  the same op types as JAX's, apart from the optimizer ops JAX's
  ``fuse_optimizer_ops_pass`` rewrites (not ported); ResNet-50 gets 49
  ``fused_conv_bn_act`` (+ 49 grads), 4 ``conv2d`` and 4 ``batch_norm``.
* Executor: state updated in place, fetches that do not alias it, no
  card means an error, the plan cache.

Both packages build from the same helper, called from one line, so the
``op_callstack`` attrs (the build-site frames outside the packages) are
equal too.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.models.resnet import build_resnet as jbuild_resnet
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import Scope
from paddle_tpu_torch.models.resnet import build_resnet as tbuild_resnet
from paddle_tpu_torch.utils import flags as tflags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (jfluid, junique, jbuild_resnet)
PORT = (tfluid, tunique, tbuild_resnet)


@pytest.fixture
def fuse_flags():
    """Restore both packages' fusion flags after the test."""
    old_j = {k: jflags._flags.get(k) for k in ("FLAGS_tpu_fuse",
                                               "FLAGS_tpu_nhwc")}
    old_t = dict(tflags._SET)
    yield
    jflags._flags.update(old_j)
    tflags._SET.clear()
    tflags._SET.update(old_t)


def _resnet(pkg, depth=50, image=32, classes=100, minimize=True):
    """(main, startup, loss) of the oracle-size ResNet train program, from
    a fresh name generator."""
    fluid, un, build = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, _, _, _ = build(img, label, depth=depth, class_num=classes)
            if minimize:
                fluid.optimizer.MomentumOptimizer(0.01, 0.9).minimize(loss)
    finally:
        un.switch(prev)
    return main, startup, loss


def _both(**kw):
    return [_resnet(pkg, **kw) for pkg in (JAX, PORT)]


# ==========================================================================
# IR
# ==========================================================================
@pytest.mark.parametrize("depth", [18, 50])
def test_jax_serialized_program_parses_in_port(depth):
    (jmain, jstart, _), = [_resnet(JAX, depth=depth)]
    for prog in (jmain, jstart):
        parsed = tfluid.Program.parse_from_string(prog.serialize_to_string())
        assert parsed.desc_dict() == prog.desc_dict()
        # and back: the port's serialization reads the same in JAX
        back = jfluid.Program.parse_from_string(parsed.serialize_to_string())
        assert back.desc_dict() == prog.desc_dict()


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("minimize", [False, True],
                         ids=["forward", "minimize"])
def test_port_builds_the_jax_program(depth, minimize):
    (jmain, jstart, jloss), (tmain, tstart, tloss) = _both(
        depth=depth, minimize=minimize)
    assert tmain.desc_dict() == jmain.desc_dict()
    assert tstart.desc_dict() == jstart.desc_dict()
    assert tloss.name == jloss.name and tloss.shape == jloss.shape


def test_clone_keeps_random_seed_and_prunes_backward():
    main, _, _ = _resnet(PORT, depth=18)
    main.random_seed = 11
    test_prog = main.clone(for_test=True)
    assert test_prog.random_seed == 11
    types = {o.type for o in test_prog.global_block().ops}
    assert "momentum" not in types and not any(t.endswith("_grad")
                                               for t in types)
    assert all(o.attrs["is_test"] for o in test_prog.global_block().ops
               if o.type == "batch_norm")


# ==========================================================================
# the pass pipeline
# ==========================================================================
#: optimizer ops the JAX pipeline's fuse_optimizer_ops_pass rewrites
_OPT_TYPES = ("momentum", "fused_momentum", "sgd", "fused_sgd")


def _pipeline_types(depth, fuse):
    jflags._flags["FLAGS_tpu_fuse"] = "1" if fuse else "0"
    jflags._flags["FLAGS_tpu_nhwc"] = "0"
    tflags.set_flags({"FLAGS_cuda_fuse": "1" if fuse else "0"})
    (jmain, _, jloss), (tmain, _, tloss) = _both(depth=depth)
    jrew = pt.Executor(pt.CPUPlace())._apply_ir_passes(jmain, [jloss.name])
    trew = tfluid.Executor(tfluid.CPUPlace())._apply_ir_passes(
        tmain, [tloss.name])
    return ([o.type for o in jrew.global_block().ops],
            [o.type for o in trew.global_block().ops], trew)


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_pass_pipeline_matches_jax(fuse_flags, depth, fuse):
    jtypes, ttypes, trew = _pipeline_types(depth, fuse)
    assert ([t for t in ttypes if t not in _OPT_TYPES]
            == [t for t in jtypes if t not in _OPT_TYPES])
    # one momentum op per trainable parameter (JAX fuses them into one)
    assert ttypes.count("momentum") == sum(
        p.trainable for p in trew.all_parameters())
    if depth == 50 and fuse:
        assert ttypes.count("fused_conv_bn_act") == 49
        assert ttypes.count("fused_conv_bn_act_grad") == 49
        assert ttypes.count("conv2d") == 4
        assert ttypes.count("batch_norm") == 4
        assert "fused_batch_norm_act" not in ttypes
        assert "fused_bn_add_activation" not in ttypes
    if not fuse:
        assert "fused_conv_bn_act" not in ttypes


def test_fc_relu_chain_stays_unfused(fuse_flags):
    """An fc+relu chain stays unfused only with the fusion off; with it
    forced on, the executor's pipeline rewrites the chain, forward and
    grad, onto fused_matmul_bias_act (kernel 9's op) and its grad."""
    with tunique.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", [8])
            h = tfluid.layers.fc(x, 16, act="relu")
            loss = tfluid.layers.mean(h)
            tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    chain = ("mul", "elementwise_add", "relu", "relu_grad",
             "elementwise_add_grad", "mul_grad")
    exe = tfluid.Executor(tfluid.CPUPlace())
    tflags.set_flags({"FLAGS_cuda_fuse": "0"})
    types = [o.type for o in exe._apply_ir_passes(
        main, [loss.name]).global_block().ops]
    assert "fused_matmul_bias_act" not in types
    assert all(t in types for t in chain)
    tflags.set_flags({"FLAGS_cuda_fuse": "1"})
    rew = exe._apply_ir_passes(main, [loss.name])
    types = [o.type for o in rew.global_block().ops]
    assert types.count("fused_matmul_bias_act") == 1
    assert types.count("fused_matmul_bias_act_grad") == 1
    assert not any(t in types for t in chain)
    fwd, = [o for o in rew.global_block().ops
            if o.type == "fused_matmul_bias_act"]
    assert (fwd.attrs["act_type"], fwd.attrs["x_num_col_dims"]) == ("relu", 1)
    assert fwd.input("X") == ["x"] and fwd.output("Out") == [h.name]


def test_fusion_flag_auto_follows_the_device(fuse_flags):
    tflags.set_flags({"FLAGS_cuda_fuse": "auto"})
    assert tflags.cuda_fuse_enabled(torch.device("cuda")) is True
    assert tflags.cuda_fuse_enabled(torch.device("cpu")) is False
    tflags.set_flags({"FLAGS_cuda_fuse": "1"})
    assert tflags.cuda_fuse_enabled(torch.device("cpu")) is True
    with pytest.raises(KeyError):
        tflags.set_flags({"FLAGS_tpu_fuse": "1"})


# ==========================================================================
# the executor
# ==========================================================================
def _tiny_fc_program():
    with tunique.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = 3
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", [4])
            y = tfluid.layers.fc(x, 3)
            loss = tfluid.layers.mean(y)
            tfluid.optimizer.MomentumOptimizer(0.5, 0.9).minimize(loss)
    return main, startup, loss


def test_executor_updates_state_in_place_and_copies_fetches():
    main, startup, loss = _tiny_fc_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    w = scope.get("fc_0.w_0")
    w0 = w.clone()
    feed = {"x": np.ones((2, 4), np.float32)}
    fetched = exe.run(main, feed=feed, fetch_list=[loss, "fc_0.w_0"],
                      scope=scope)
    assert scope.get("fc_0.w_0") is w          # the same tensor, updated
    assert not torch.equal(w, w0)
    snap = fetched[1].copy()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(fetched[1], snap)   # not an alias
    # one plan per (program, version, feed signature, fetches, fuse flag)
    assert len(exe._cache) == 3


def test_executor_momentum_matches_numpy():
    """One step of the tiny program against the update written out:
    dW = x^T dOut with dOut = 1/numel, v = dW, w -= lr * v."""
    main, startup, loss = _tiny_fc_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    w0 = scope.get("fc_0.w_0").numpy().copy()
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    dw = x.T @ np.full((2, 3), 1.0 / 6, np.float32)
    np.testing.assert_allclose(scope.get("fc_0.w_0").numpy(),
                               w0 - 0.5 * dw, rtol=1e-6, atol=1e-7)


def test_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor(tfluid.CUDAPlace(0))


def test_unported_pieces_raise():
    from paddle_tpu_torch import optimizer as topt
    main, _, loss = _tiny_fc_program()
    with pytest.raises(NotImplementedError, match="not ported"):
        tfluid.gradients(loss, [main.global_block().var("x")])
    with pytest.raises(NotImplementedError, match="no static form"):
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            x = tfluid.layers.data("x", [4])
            topt.AdamOptimizer(0.1).minimize(tfluid.layers.mean(
                tfluid.layers.fc(x, 2)))
    with pytest.raises(NotImplementedError, match="not ported"):
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            x = tfluid.layers.data("x", [8, 6, 6])
            tfluid.layers.conv2d(x, 8, 3, groups=8)


@pytest.mark.parametrize("name", ["fuse_optimizer_ops_pass",
                                  "memory_relief_pass"])
def test_unported_passes_raise(name):
    from paddle_tpu_torch.framework.ir import get_pass
    main, _, _ = _tiny_fc_program()
    with pytest.raises(NotImplementedError, match="not ported"):
        get_pass(name).apply(main)


@pytest.mark.parametrize("flag", sorted(tflags.UNPORTED))
def test_unported_flags_raise(fuse_flags, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        tflags.set_flags({flag: 1})


def test_cost_model_calibration_raises():
    from paddle_tpu_torch.utils import cost_model
    with pytest.raises(NotImplementedError, match="not ported"):
        cost_model.set_measured_profile(0.1)


def test_static_core_imports_no_jax():
    mods = ["paddle_tpu_torch.fluid", "paddle_tpu_torch.executor",
            "paddle_tpu_torch.framework.ir", "paddle_tpu_torch.ops.bn_act",
            "paddle_tpu_torch.ops.matmul_epilogue",
            "paddle_tpu_torch.models.resnet",
            "paddle_tpu_torch.models.lenet",
            "paddle_tpu_torch.models.word2vec",
            "paddle_tpu_torch.tools.train_resnet",
            "paddle_tpu_torch.tools.train_book"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


# ==========================================================================
# ResNet-50 where its last stage is not degenerate (2x2 maps): step 1 holds
# at rtol 1e-5 (``test_torch_resnet.py`` explains the oracle size's 2e-4)
# ==========================================================================
def test_resnet50_at_64_matches_jax_step1(monkeypatch):
    from torch_resnet_parity import check_training
    check_training(50, 64, False, monkeypatch)
