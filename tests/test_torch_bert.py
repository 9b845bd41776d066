"""PyTorch port, BERT/ERNIE dygraph pretraining slice: ``paddle_tpu_torch``
against the JAX package on the CPU, with the JAX model's weights carried
into the port one to one (no transposes: both keep Paddle's layouts).

* a tiny ``BertForPretraining`` (vocab 128, hidden 64, 4 heads, 2
  layers, intermediate 128, 128 positions; batch 2, seq 128, dropout 0,
  an attention mask with padding): equal state_dict names and shapes,
  equal loss (rtol 1e-5), equal per-parameter gradients (rtol 1e-4), and
  over 3 steps of ``AdamOptimizer(1e-3)`` equal per-step losses and final
  parameters (rtol 1e-4, atol 1e-5), through eager ``minimize`` and
  through ``jit_train_step``, for both ``fuse_attention`` settings and
  ``fuse_qkv``; one case runs JAX's attention through the Pallas kernels
  in interpret mode;
* Adam alone against JAX ``eager_call("adam", ...)`` over 5 steps;
* the op lowerings against JAX ``eager_call``; initializers; dropout;
* a head dim that is no tile width (96) trains as JAX's does;
* the new entry points raise without a card, the left-out options raise
  ``NotImplementedError`` (an AMP dtype that is none raises
  ``ValueError``), and the new modules import no JAX;
* ``tools/train_bert.py --tiny`` trains on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.models import bert as JB
from paddle_tpu.ops.registry import eager_call

from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch.dygraph import (Dropout, LayerNorm, Linear,
                                      jit_train_step, load_state_dict_numpy)
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.decoder_ops import matmul
from paddle_tpu_torch.optimizer import AdamOptimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
# per-parameter gradients: the key biases' true gradient is 0 (softmax is
# shift-invariant), so both sides hold rounding noise there: atol 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(seed=0, b=2, s=128, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype("int64")
    labels = rng.randint(0, vocab, (b, s)).astype("int64")
    mask = np.ones((b, s), np.float32)
    mask[1, s - 28:] = 0.0
    return ids, labels, mask


def _pair(**over):
    """(JAX model, port model on the CPU) with the JAX weights carried
    across; must run inside ``jdy.guard()``."""
    cfg = dict(TINY, **over)
    jm = JB.BertForPretraining(JB.BertConfig(**cfg))
    tm = TB.BertForPretraining(TB.BertConfig(**cfg), device="cpu")
    load_state_dict_numpy(tm, {k: np.array(v.value())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _jloss(jm, ids, labels, mask):
    v = jdy.to_variable
    return jm(v(ids), v(labels), attention_mask=v(mask))


def _tloss(tm, ids, labels, mask):
    return tm(torch.from_numpy(ids), torch.from_numpy(labels),
              attention_mask=torch.from_numpy(mask))


MODEL_CASES = [dict(), dict(fuse_attention=False), dict(fuse_qkv=True)]


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_state_dict_names_and_shapes_match(fuse_qkv):
    with jdy.guard():
        jm, tm = _pair(fuse_qkv=fuse_qkv)
        jsd, tsd = jm.state_dict(), tm.state_dict()
        assert list(jsd) == list(tsd)
        for name in jsd:
            assert tuple(jsd[name].shape) == tuple(tsd[name].shape), name
        assert [n for n, _ in jm.named_parameters()] == [
            n for n, _ in tm.named_parameters()]


@pytest.mark.parametrize("over", MODEL_CASES)
def test_loss_and_gradients_match(over):
    ids, labels, mask = _batch()
    with jdy.guard():
        jm, tm = _pair(**over)
        jl = _jloss(jm, ids, labels, mask)
        jl.backward()
        tl = _tloss(tm, ids, labels, mask)
        tl.backward()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), **LOSS_TOL)
        n_grads = 0
        for (name, jp), (_, tp) in zip(jm.named_parameters(),
                                       tm.named_parameters()):
            g = jp.gradient()
            assert (g is None) == (tp.grad is None), name
            if g is not None:
                n_grads += 1
                np.testing.assert_allclose(tp.grad.numpy(), g, **GRAD_TOL,
                                           err_msg=name)
        # the pooler and NSP head get no gradient from the MLM loss
        assert n_grads == len(tm.parameters()) - 4


def _trajectories(over, via_step, steps=3):
    ids, labels, mask = _batch(1)
    with jdy.guard():
        jm, tm = _pair(**over)
        jopt = fluid.optimizer.AdamOptimizer(
            1e-3, parameter_list=jm.parameters())
        topt = AdamOptimizer(1e-3, parameter_list=tm.parameters())
        jlosses, tlosses = [], []
        if via_step:
            fn = lambda m, i, l, a: m(i, l, attention_mask=a)  # noqa: E731
            jstep = jdy.jit_train_step(jm, jopt, fn)
            tstep = jit_train_step(tm, topt, fn)
            for _ in range(steps):
                jlosses.append(float(np.asarray(
                    jstep(ids, labels, mask).value())))
                tlosses.append(float(tstep(ids, labels, mask)))
        else:
            for _ in range(steps):
                jl = _jloss(jm, ids, labels, mask)
                jl.backward()
                jopt.minimize(jl)
                jm.clear_gradients()
                tl = _tloss(tm, ids, labels, mask)
                tl.backward()
                topt.minimize(tl)
                tm.clear_gradients()
                jlosses.append(float(jl.numpy()))
                tlosses.append(float(tl))
        jparams = {n: np.asarray(p.value()) for n, p in jm.named_parameters()}
        tparams = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    return jlosses, tlosses, jparams, tparams


@pytest.mark.parametrize("over", MODEL_CASES)
@pytest.mark.parametrize("via_step", [False, True])
def test_adam_trajectory_matches(over, via_step):
    jl, tl, jp, tp = _trajectories(over, via_step)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert tl[-1] < tl[0]
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], **TRAJ_TOL,
                                   err_msg=name)


def test_trajectory_matches_jax_pallas_kernels(monkeypatch):
    """JAX's attention through its Pallas flash kernels (interpret mode,
    forward from fwd_res, backward from bwd_res) against the port's."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PT_FLASH_ATTENTION", "1")
    jl, tl, jp, tp = _trajectories({}, via_step=False, steps=2)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], **TRAJ_TOL,
                                   err_msg=name)


def test_trajectory_at_head_dim_96_matches_jax_pallas_kernels(monkeypatch):
    """A head dim that is no tile width (hidden 192, 2 heads: d 96), which
    JAX's flash kernels take and so must the port's: 3 ``jit_train_step``
    steps in f32 against JAX's through its Pallas kernels (interpret
    mode)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PT_FLASH_ATTENTION", "1")
    jl, tl, jp, tp = _trajectories(dict(hidden_size=192, num_attention_heads=2,
                                        intermediate_size=384), via_step=True)
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert tl[-1] < tl[0]
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], **TRAJ_TOL,
                                   err_msg=name)


def test_adam_matches_jax_adam_op():
    rng = np.random.RandomState(3)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = AdamOptimizer(0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                        parameter_list=tparams)
    state = [dict(m1=np.zeros_like(p), m2=np.zeros_like(p),
                  b1p=np.ones(1, np.float32), b2p=np.ones(1, np.float32))
             for p in params]
    for step in range(5):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        for i, (p, g, st) in enumerate(zip(params, grads, state)):
            if step == 2 and i == 1:
                continue           # no gradient this step: left alone
            outs = eager_call(
                "adam", {"Param": [p], "Grad": [g], "Moment1": [st["m1"]],
                         "Moment2": [st["m2"]], "Beta1Pow": [st["b1p"]],
                         "Beta2Pow": [st["b2p"]],
                         "LearningRate": [np.array([0.01], np.float32)]},
                {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6},
                {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
                 "Beta1PowOut": 1, "Beta2PowOut": 1})
            params[i] = np.asarray(outs["ParamOut"][0])
            st.update(m1=np.asarray(outs["Moment1Out"][0]),
                      m2=np.asarray(outs["Moment2Out"][0]),
                      b1p=np.asarray(outs["Beta1PowOut"][0]),
                      b2p=np.asarray(outs["Beta2PowOut"][0]))
        for i, (tp, g) in enumerate(zip(tparams, grads)):
            tp.grad = None if (step == 2 and i == 1) else torch.tensor(g)
        opt.minimize(None)
        for tp, p in zip(tparams, params):
            np.testing.assert_allclose(tp.detach().numpy(), p, rtol=1e-6,
                                       atol=1e-7)


# ==========================================================================
# op lowerings, initializers, dropout
# ==========================================================================
def _jop(type_, ins, attrs, outs):
    return {k: [np.asarray(x) for x in v]
            for k, v in eager_call(type_, ins, attrs, outs).items()}


def test_softmax_with_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 11).astype(np.float32) * 3
    label = rng.randint(0, 11, (6, 1)).astype(np.int64)
    label[2, 0] = 5
    for ignore in (-100, 5):
        want = _jop("softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"ignore_index": ignore}, {"Loss": 1, "Softmax": 1})
        x = torch.tensor(logits, requires_grad=True)
        loss = nn_ops.softmax_with_cross_entropy(x, torch.tensor(label),
                                                 ignore_index=ignore)
        np.testing.assert_allclose(loss.detach().numpy(), want["Loss"][0],
                                   rtol=1e-6, atol=1e-6)
        dloss = rng.rand(6, 1).astype(np.float32)
        loss.backward(torch.tensor(dloss))
        jg = _jop("softmax_with_cross_entropy_grad",
                  {"Softmax": want["Softmax"], "Label": [label],
                   "Loss@GRAD": [dloss]}, {"ignore_index": ignore},
                  {"Logits@GRAD": 1})["Logits@GRAD"][0]
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["layer_norm", "gelu", "lookup", "tanh",
                                  "unsqueeze2", "mean", "einsum", "matmul"])
def test_op_lowerings_match_jax(case):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 8).astype(np.float32)
    tx = torch.tensor(x)
    if case == "layer_norm":     # the LayerNorm layer the model runs
        sc, bi = rng.randn(8).astype(np.float32), rng.randn(8).astype(
            np.float32)
        want = _jop("layer_norm", {"X": [x], "Scale": [sc], "Bias": [bi]},
                    {"begin_norm_axis": 2, "epsilon": 1e-5},
                    {"Y": 1, "Mean": 1, "Variance": 1})["Y"][0]
        layer = LayerNorm(8, device="cpu").set_dict({"weight": sc,
                                                     "bias": bi})
        got = layer(tx).detach()
    elif case in ("gelu", "tanh"):
        want = _jop(case, {"X": [x]}, {}, {"Out": 1})["Out"][0]
        got = nn_ops.activation(tx, case)
    elif case == "lookup":
        w = rng.randn(10, 4).astype(np.float32)
        ids = np.array([[0, 3, 9], [12, 3, 1]], np.int64)  # 12: clipped
        for pad in (-1, 3):
            want = _jop("lookup_table_v2", {"W": [w], "Ids": [ids]},
                        {"padding_idx": pad}, {"Out": 1})["Out"][0]
            got = nn_ops.lookup_table_v2(torch.tensor(w), torch.tensor(ids),
                                         pad)
            np.testing.assert_array_equal(got.numpy(), want)
        return
    elif case == "unsqueeze2":
        want = _jop("unsqueeze2", {"X": [x]}, {"axes": [3, 1]},
                    {"Out": 1})["Out"][0]
        got = nn_ops.unsqueeze2(tx, [3, 1])
    elif case == "mean":
        want = _jop("mean", {"X": [x]}, {}, {"Out": 1})["Out"][0]
        got = torch.mean(tx)
    elif case == "einsum":
        w = rng.randn(8, 2, 4).astype(np.float32)
        want = _jop("einsum", {"Operands": [x, w]},
                    {"equation": "bsh,hnd->bnsd"}, {"Out": 1})["Out"][0]
        got = torch.einsum("bsh,hnd->bnsd", tx, torch.tensor(w))
    else:
        y = rng.randn(2, 5, 8).astype(np.float32)
        want = _jop("matmul", {"X": [x], "Y": [y]},
                    {"transpose_Y": True, "alpha": 0.5}, {"Out": 1})["Out"][0]
        got = matmul(tx, torch.tensor(y), transpose_Y=True, alpha=0.5)
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_initializers():
    gen = torch.Generator().manual_seed(0)
    t = torch.empty(400, 300)
    tinit.TruncatedNormalInitializer(0.5, 0.02)(t, gen)
    assert float(t.min()) >= 0.5 - 0.04 and float(t.max()) <= 0.5 + 0.04
    assert abs(float(t.mean()) - 0.5) < 1e-3
    # a normal truncated at 2 sigma has std 0.8796 sigma
    assert abs(float(t.std()) - 0.8796 * 0.02) < 5e-4
    tinit.ConstantInitializer(1.5)(t, gen)
    assert bool((t == 1.5).all())
    tinit.XavierInitializer()(t, gen)
    lim = (6.0 / 700) ** 0.5
    assert float(t.abs().max()) <= lim and float(t.abs().max()) > 0.9 * lim
    a, b = torch.empty(50), torch.empty(50)
    tinit.TruncatedNormalInitializer(seed=3)(a, gen)
    tinit.TruncatedNormalInitializer(seed=3)(b, gen)
    assert torch.equal(a, b)


def test_dropout_semantics():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(1)
    up = nn_ops.dropout(x, 0.25, implementation="upscale_in_train",
                        generator=gen)
    assert set(up.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    assert abs(float((up > 0).float().mean()) - 0.75) < 0.03
    assert torch.equal(nn_ops.dropout(x, 0.25, is_test=True,
                                      implementation="upscale_in_train"), x)
    down = nn_ops.dropout(x, 0.25, generator=gen)
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(nn_ops.dropout(x, 0.25, is_test=True), x * 0.75)
    fixed = Dropout(0.5, seed=7, device="cpu")
    assert torch.equal(fixed(x), fixed(x))
    layer = Dropout(0.5, device="cpu").eval()
    assert torch.equal(layer(x), x * 0.5)


def test_eval_mode_turns_dropout_off():
    """With dropout in the config, eval() gives the dropout-free loss
    of the same weights; train() draws masks (a different loss)."""
    ids, labels, mask = _batch(2)
    drop = TB.BertForPretraining(TB.BertConfig(**dict(
        TINY, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)),
        device="cpu")
    plain = TB.BertForPretraining(TB.BertConfig(**TINY), device="cpu")
    plain.set_dict(drop.state_dict())
    with torch.no_grad():
        want = float(_tloss(plain, ids, labels, mask))
        assert float(_tloss(drop.eval(), ids, labels, mask)) == want
        trained = float(_tloss(drop.train(), ids, labels, mask))
    assert np.isfinite(trained) and trained != want


# ==========================================================================
# boundaries: device, left-out options, imports, the tool
# ==========================================================================
def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TB.BertConfig(**TINY)
    for build in (lambda: TB.BertForPretraining(cfg),
                  lambda: TB.BertModel(cfg), lambda: Linear(4, 4),
                  lambda: Dropout(0.1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    from paddle_tpu_torch.tools import train_bert
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bert.train(TB.BertConfig(**TINY), batch=2, seq=8, steps=1)


def test_left_out_options_raise():
    from paddle_tpu_torch.dygraph import Embedding, jit
    from paddle_tpu_torch.nn import functional as nn_functional
    m = Linear(2, 2, device="cpu")
    opt = AdamOptimizer(1e-3, parameter_list=m.parameters())
    # AMP runs in bf16 or fp16 (tests/test_torch_amp.py); no other dtype
    with pytest.raises(ValueError, match="AMP dtype"):
        jit_train_step(m, opt, lambda m, x: m(x).sum(), amp=True,
                       amp_dtype="float64")
    # LAMB, AdamW and grad_clip= are ported (tests/test_torch_optimizers.py)
    # a ParamAttr regularizer is ported (tests/test_torch_lr_regularizer.py),
    # and so is every name of nn.functional
    # (tests/test_torch_layers_functional.py)
    assert callable(nn_functional.gelu)
    for build in (lambda: jit.TracedLayer(),
                  lambda: jit.compiled_forward(m),
                  lambda: Embedding([4, 2], is_sparse=True, device="cpu")):
        with pytest.raises(NotImplementedError, match="not ported"):
            build()


def test_new_modules_import_no_jax():
    mods = ["paddle_tpu_torch.ops.flash_attention",
            "paddle_tpu_torch.ops.fused_ops", "paddle_tpu_torch.ops.nn_ops",
            "paddle_tpu_torch.dygraph", "paddle_tpu_torch.models.bert",
            "paddle_tpu_torch.optimizer", "paddle_tpu_torch.initializer",
            "paddle_tpu_torch.tools.train_bert",
            "paddle_tpu_torch.contrib.mixed_precision",
            "paddle_tpu_torch.contrib.mixed_precision.decorator",
            "paddle_tpu_torch.contrib.mixed_precision.fp16_utils",
            "paddle_tpu_torch.ops.gelu", "paddle_tpu_torch.ops.tensor_ops",
            "paddle_tpu_torch.dygraph.amp", "paddle_tpu_torch.dygraph.base",
            "paddle_tpu_torch.clip", "paddle_tpu_torch.ops.optimizer_ops",
            "paddle_tpu_torch.framework.ir"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_train_bert_tool_tiny_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_bert", "--tiny",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss ")[1]) for ln in lines]
    # steps 0 and 2 are printed (every 20th step and the last)
    assert len(losses) == 2 and losses[-1] < losses[0]


def test_train_bert_tool_tiny_fp16_on_cpu():
    """``--amp-dtype float16`` is ``jit_train_step``'s fp16 AMP: the tiny
    model trains at O2 with fp16-resident parameters."""
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_bert", "--tiny",
         "--device", "cpu", "--amp-dtype", "float16", "--amp-level", "O2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "(AMP O2 float16)" in r.stdout
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss ")[1]) for ln in lines]
    assert len(losses) == 2 and losses[-1] < losses[0]
