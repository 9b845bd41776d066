"""PyTorch port, the book's text models against the JAX package: attention
seq2seq translation (``models/seq2seq.py``: training and the beam-search
decode) and the sentiment nets (``models/sentiment.py``:
``stacked_lstm_net`` and ``convolution_net``), all with the SelectedRows
embedding gradient (``is_sparse=True``, the models' default).

* Both packages build the same programs (main and startup, equal
  ``desc_dict``): seq2seq's train and decode programs and both
  sentiment nets.
* Training: the JAX startup program runs once and its scope is copied
  into the port's as numpy; both then take 3 steps on one numpy batch.
  Seq2seq (``DICT`` 20, T 5, the model's default widths, the JAX book
  test's Adam 0.01, fusion off and on): per-step losses within rtol
  1e-5 and every updated parameter within rtol / atol 1e-4 (the Adam
  steps divide by ``sqrt(v) + eps`` of gradients that differ in their
  last bits: oneDNN against XLA in summation order).  The sentiment nets
  (vocabulary 30, T 6, ragged lengths fed, the book's Adagrad 0.002,
  whose update of the embedding is the sparse one): losses within rtol
  1e-5, parameters within 1e-4.
* Decode: ``build_decode`` (beam 2, ``max_length`` 6) on the trained
  scopes gives equal ``SentenceIds`` and ``SentenceLength`` and scores
  within rtol 1e-4.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
import paddle_tpu.models.seq2seq as js2s
import paddle_tpu.models.sentiment as jsent
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.models.seq2seq as ts2s
import paddle_tpu_torch.models.sentiment as tsent
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import Scope as TScope, load_numpy_state
from paddle_tpu_torch.utils import flags as tflags

JAX = (jfluid, junique, js2s, jsent)
PORT = (tfluid, tunique, ts2s, tsent)
DICT, T, BOS, EOS, BEAM = 20, 5, 0, 1, 2
VOCAB, TLEN = 30, 6
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def build(pkg, what):
    """(main, startup, fetches) of one program in ``pkg``, from a fresh
    name generator: ``train`` / ``decode`` (seq2seq), ``lstm`` / ``conv``
    (sentiment)."""
    fluid, un, s2s, sent = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        with fluid.program_guard(main, startup):
            if what == "train":
                src = fluid.layers.data("src", [T], dtype="int64")
                trg = fluid.layers.data("trg", [T], dtype="int64")
                label = fluid.layers.data("label", [T, 1], dtype="int64")
                loss, _ = s2s.build_train(src, trg, label, DICT)
                fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
                fetches = [loss]
            elif what == "decode":
                src = fluid.layers.data("src_d", [T], dtype="int64")
                ids = fluid.layers.data("init_ids", [1], dtype="int64")
                scores = fluid.layers.data("init_scores", [1],
                                           dtype="float32")
                fetches = list(s2s.build_decode(
                    src, ids, scores, DICT, beam_size=BEAM,
                    max_length=T + 1, eos_id=EOS))
            else:
                data = fluid.layers.data("words", [TLEN], dtype="int64")
                label = fluid.layers.data("label", [1], dtype="int64")
                length = fluid.layers.data("length", [], dtype="int64")
                net = (sent.stacked_lstm_net if what == "lstm"
                       else sent.convolution_net)
                loss, acc, _ = net(data, label, input_dim=VOCAB,
                                   length=length)
                fluid.optimizer.AdagradOptimizer(0.002).minimize(loss)
                fetches = [loss, acc]
    finally:
        un.switch(prev)
    return main, startup, fetches


def both(what):
    return [build(pkg, what) for pkg in (JAX, PORT)]


def feed(what):
    rng = np.random.RandomState(3)
    if what == "train":
        src = rng.randint(2, DICT, (16, T)).astype(np.int64)
        trg = np.concatenate([np.full((16, 1), BOS, np.int64),
                              src[:, :-1]], 1)
        return {"src": src, "trg": trg, "label": src[..., None]}
    words = rng.randint(0, VOCAB, (8, TLEN)).astype(np.int64)
    words[:, 0] = words[:, 1]        # a duplicate id in every row
    return {"words": words,
            "label": rng.randint(0, 2, (8, 1)).astype(np.int64),
            "length": np.array([6, 3, 1, 6, 4, 2, 5, 6], np.int64)}


@pytest.fixture
def fuse(monkeypatch):
    def set_(on):
        monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse",
                            "1" if on else "0")
        monkeypatch.setitem(jflags._flags, "FLAGS_tpu_nhwc", "0")
        monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse",
                            "1" if on else "0")
    return set_


@pytest.mark.parametrize("what", ["train", "decode", "lstm", "conv"])
def test_port_builds_the_jax_program(what):
    (jmain, jstart, jf), (tmain, tstart, tf) = both(what)
    assert tmain.desc_dict() == jmain.desc_dict()
    assert tstart.desc_dict() == jstart.desc_dict()
    assert [v.name for v in tf] == [v.name for v in jf]


def train_both(what):
    """Both packages' per-step fetches from the JAX startup scope: (jax
    fetches, port fetches, jax scope, port scope, the port executor)."""
    (jmain, jstart, jf), (tmain, _, tf) = both(what)
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    tscope = TScope()
    load_numpy_state(tscope, {
        v.name: np.asarray(jscope.get(v.name))
        for v in jstart.global_block().vars.values() if v.persistable},
        "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    data = feed(what)
    j, t = [], []
    for _ in range(STEPS):
        j.append([np.asarray(v) for v in jexe.run(
            jmain, feed=data, fetch_list=jf, scope=jscope)])
        t.append(texe.run(tmain, feed=data, fetch_list=tf, scope=tscope))
    return j, t, jscope, tscope, texe, jstart


def assert_params_close(jscope, tscope, startup):
    for v in startup.global_block().vars.values():
        if v.persistable:
            np.testing.assert_allclose(
                tscope.get(v.name).numpy(), np.asarray(jscope.get(v.name)),
                err_msg=v.name, **PARAM_TOL)


@pytest.mark.parametrize("on", [False, True], ids=["unfused", "fused"])
def test_seq2seq_trains_and_decodes_like_jax(fuse, on):
    fuse(on)
    j, t, jscope, tscope, texe, jstart = train_both("train")
    jl = [float(s[0]) for s in j]
    tl = [float(s[0]) for s in t]
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_params_close(jscope, tscope, jstart)
    types = [o.type for o in next(iter(texe._cache.values())).ops]
    assert types.count("lookup_table_sparse_grad") == 2
    assert types.count("fused_matmul_bias_act") == (2 if on else 0)

    # the beam decode over each package's trained scope
    (jdec, _, jf), (tdec, _, tf) = both("decode")
    rng = np.random.RandomState(5)
    src = np.repeat(rng.randint(2, DICT, (4, T)).astype(np.int64), BEAM, 0)
    dfeed = {"src_d": src,
             "init_ids": np.full((4 * BEAM, 1), BOS, np.int64),
             "init_scores": np.tile(np.array([[0.0], [-1e9]], np.float32),
                                    (4, 1))}
    jids, jsc, jlen = [np.asarray(v) for v in pt.Executor(
        pt.CPUPlace()).run(jdec, feed=dfeed, fetch_list=jf, scope=jscope)]
    tids, tsc, tlen = tfluid.Executor(tfluid.CPUPlace()).run(
        tdec, feed=dfeed, fetch_list=tf, scope=tscope)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlen, jlen)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-4)


@pytest.mark.parametrize("net", ["lstm", "conv"])
def test_sentiment_trains_like_jax(net):
    j, t, jscope, tscope, texe, jstart = train_both(net)
    jl = [float(s[0]) for s in j]
    tl = [float(s[0]) for s in t]
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert [float(s[1]) for s in t] == [float(s[1]) for s in j]
    assert_params_close(jscope, tscope, jstart)
    types = [o.type for o in next(iter(texe._cache.values())).ops]
    assert types.count("lookup_table_sparse_grad") == 1


@pytest.mark.parametrize("model", ["seq2seq", "stacked_lstm", "conv"])
def test_train_text_tool_tiny_on_cpu(model, capsys):
    from paddle_tpu_torch.tools import train_text
    train_text.main(["--model", model, "--tiny", "--device", "cpu",
                     "--decode"])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "tokens/s" in out
    assert ("decode: beam 2" in out) == (model == "seq2seq")


@pytest.mark.parametrize("model", ["stacked_lstm", "conv"])
def test_train_text_against_cpu_tiny(model, capsys):
    """The second-witness mode on the CPU: both sides the CPU port from
    one startup state, so the losses are equal."""
    import json

    from paddle_tpu_torch.tools import train_text
    train_text.main(["--model", model, "--tiny", "--device", "cpu",
                     "--against-cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["steps"] == 3 and len(row["cpu"]) == 3
    assert row["device"] == "cpu" and row["on_device"] == row["cpu"]
    assert row["max_rel_diff"] == 0.0


def test_text_modules_import_no_jax():
    import subprocess
    import sys

    from torch_resnet_parity import ROOT
    mods = ["paddle_tpu_torch.framework.selected_rows",
            "paddle_tpu_torch.ops.sequence_ops",
            "paddle_tpu_torch.layers.rnn",
            "paddle_tpu_torch.layers.sequence_lod",
            "paddle_tpu_torch.models.seq2seq",
            "paddle_tpu_torch.models.sentiment",
            "paddle_tpu_torch.tools.train_text"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
