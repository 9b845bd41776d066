"""PyTorch port, the book models' static training against the JAX
package: LeNet-5 (``models/lenet.py``) and the word2vec N-gram model
(``models/word2vec.py``).

* Both packages build the same train program (main and startup, equal
  ``desc_dict``), and their ``fuse_epilogue_pass`` rewrites it to the
  same op list and ``desc_dict``: LeNet's two fc+relu chains and
  word2vec's fc+sigmoid chain become ``fused_matmul_bias_act`` with its
  grad.
* Training: the JAX startup program runs once and its scope is copied
  into the port's; both then train on one numpy batch, the fusion forced
  on in both or off in both.  LeNet at batch 8 (``bench.py:_lenet_losses``'s
  program: Momentum 0.05 / 0.9, program seed 5, images from numpy seed 7)
  and word2vec at the JAX test's sizes (vocabulary 50, embedding 16,
  hidden 32, ``tests/test_book_models.py:79``) with SGD 0.1.  Per-step
  losses within rtol 1e-5: no BatchNorm, so f32 noise (oneDNN against
  XLA, in summation order) stays near 1e-7 relative instead of growing.
* On the CPU the fused program's losses equal the unfused program's bit
  for bit (JAX's contract, ``tests/test_fused_epilogue.py:184-190``).
* ``tools/train_book.py --tiny`` runs both models.
"""
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.ir import get_pass as jget_pass
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.lenet import build_lenet as jbuild_lenet
from paddle_tpu.models.word2vec import build_word2vec as jbuild_word2vec
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.ir import get_pass as tget_pass
from paddle_tpu_torch.framework.scope import Scope as TScope, load_numpy_state
from paddle_tpu_torch.models.lenet import build_lenet as tbuild_lenet
from paddle_tpu_torch.models.word2vec import build_word2vec as tbuild_word2vec
from paddle_tpu_torch.utils import flags as tflags

from torch_resnet_parity import ROOT

JAX = (jfluid, junique, {"lenet": jbuild_lenet, "word2vec": jbuild_word2vec})
PORT = (tfluid, tunique, {"lenet": tbuild_lenet, "word2vec": tbuild_word2vec})
MODELS = ["lenet", "word2vec"]
STEPS = 4
LOSS_RTOL = 1e-5
#: word2vec at the JAX test's sizes
W2V = dict(dict_size=50, embed_dim=16, hidden_size=32)
#: fused chains: LeNet's two relu fc layers, word2vec's sigmoid layer
CHAINS = {"lenet": 2, "word2vec": 1}


def build(pkg, model):
    """(main, startup, loss) of ``model``'s train program in ``pkg``, from
    a fresh name generator."""
    fluid, un, builders = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 5
        with fluid.program_guard(main, startup):
            if model == "lenet":
                img = fluid.layers.data("img", [1, 28, 28])
                label = fluid.layers.data("label", [1], dtype="int64")
                loss, _, _ = builders[model](img, label)
                fluid.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
            else:
                words = [fluid.layers.data(f"w{i}", [1], dtype="int64")
                         for i in range(4)]
                target = fluid.layers.data("target", [1], dtype="int64")
                loss, _ = builders[model](words, target, **W2V)
                fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    finally:
        un.switch(prev)
    return main, startup, loss


def both(model):
    return [build(pkg, model) for pkg in (JAX, PORT)]


def feed(model, batch=8):
    rng = np.random.RandomState(7)
    if model == "lenet":
        return {"img": rng.rand(batch, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    ids = rng.randint(0, W2V["dict_size"], (batch, 5)).astype(np.int64)
    out = {f"w{i}": ids[:, i:i + 1] for i in range(4)}
    out["target"] = ids[:, 4:]
    return out


@pytest.fixture
def fuse(monkeypatch):
    """Set both packages' fusion flags: ``fuse(True)`` / ``fuse(False)``."""
    def set_(on):
        monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse",
                            "1" if on else "0")
        monkeypatch.setitem(jflags._flags, "FLAGS_tpu_nhwc", "0")
        monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse",
                            "1" if on else "0")
    return set_


@pytest.mark.parametrize("model", MODELS)
def test_port_builds_the_jax_program(model):
    (jmain, jstart, jloss), (tmain, tstart, tloss) = both(model)
    assert tmain.desc_dict() == jmain.desc_dict()
    assert tstart.desc_dict() == jstart.desc_dict()
    assert tloss.name == jloss.name


@pytest.mark.parametrize("model", MODELS)
def test_fuse_epilogue_pass_matches_jax(model):
    (jmain, _, jloss), (tmain, _, tloss) = both(model)
    jp = jget_pass("fuse_epilogue_pass", protected=(jloss.name,))
    tp = tget_pass("fuse_epilogue_pass", protected=(tloss.name,))
    # one line, so the fused ops' op_callstack attrs are equal too
    jrew, trew = [p.apply(f.Program.from_desc_dict(m.desc_dict()))
                  for p, f, m in ((jp, jfluid, jmain), (tp, tfluid, tmain))]
    assert tp.fused_count == jp.fused_count == CHAINS[model]
    types = [o.type for o in trew.global_block().ops]
    assert types == [o.type for o in jrew.global_block().ops]
    assert types.count("fused_matmul_bias_act") == CHAINS[model]
    assert types.count("fused_matmul_bias_act_grad") == CHAINS[model]
    assert trew.desc_dict() == jrew.desc_dict()
    acts = {o.attrs["act_type"] for o in trew.global_block().ops
            if o.type == "fused_matmul_bias_act"}
    assert acts == ({"relu"} if model == "lenet" else {"sigmoid"})
    assert [r["kind"] for r in tp.report] == ["matmul_bias_act"] * \
        CHAINS[model]


def train_both(model):
    """Per-step losses of each package from the JAX startup scope, and the
    op types the port's executor ran."""
    (jmain, jstart, jloss), (tmain, _, tloss) = both(model)
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    tscope = TScope()
    load_numpy_state(tscope, {
        v.name: np.asarray(jscope.get(v.name))
        for v in jstart.global_block().vars.values() if v.persistable},
        "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    data = feed(model)
    losses = {"jax": [], "port": []}
    for _ in range(STEPS):
        j = jexe.run(jmain, feed=data, fetch_list=[jloss], scope=jscope)
        t = texe.run(tmain, feed=data, fetch_list=[tloss], scope=tscope)
        losses["jax"].append(float(np.asarray(j[0])))
        losses["port"].append(float(t[0]))
    plan = next(iter(texe._cache.values()))
    return losses, [o.type for o in plan.ops]


@pytest.mark.parametrize("on", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("model", MODELS)
def test_training_matches_jax(fuse, model, on):
    fuse(on)
    losses, types = train_both(model)
    assert types.count("fused_matmul_bias_act") == (CHAINS[model] if on
                                                    else 0)
    assert types.count("fused_matmul_bias_act_grad") == (CHAINS[model] if on
                                                         else 0)
    jl, tl = losses["jax"], losses["port"]
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("model", MODELS)
def test_fusion_changes_no_number_in_the_port(fuse, model):
    runs = []
    for on in (False, True):
        fuse(on)
        main, startup, loss = build(PORT, model)
        scope = TScope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed(model), fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(STEPS)])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("model", MODELS)
def test_train_book_tool_tiny_on_cpu(model):
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_book",
         "--model", model, "--tiny", "--device", "cpu", "--log-every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "examples/s" in r.stdout
