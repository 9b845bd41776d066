"""PyTorch port, static AMP in bf16 (``fluid.contrib.mixed_precision``:
``rewrite_program``, ``decorate``; the ``cast`` op and layer;
``layout_transform_pass`` under ``FLAGS_cuda_nhwc``) against the JAX
package on the CPU, on the same numpy inputs.

* Programs: ``layers.cast`` / ``Variable.astype`` build JAX's op;
  ``rewrite_program`` turns the same serialized Program into the same
  ops as JAX's (types, slots, cast names, the cast cache, var dtypes) for
  an fc model, LeNet, word2vec and ResNet-18; ``decorate(opt).minimize``
  builds the same train program; the NHWC layout pass rewrites the same
  AMP program to the same op list.
* Lowerings: each op of the AMP path on bf16 inputs against the JAX
  lowering under ``jax.jit`` (as the JAX executor runs it): the output
  dtypes equal, the values equal bit for bit where both sides round at
  the same points, else within ``BF16_ULPS`` bf16 ulps (2^-8 relative)
  of the largest output, where a product is summed in another order,
  and f32 outputs within 1e-5 relative (2^-7, one bf16 ulp, for the fc
  chain's f32 output, whose bf16 product may round the other way; the
  fused conv's case states its own).  The backward likewise: each grad
  op of the path (conv2d, batch_norm, the fused BN forms, the fused
  conv, mul, the fc bias add) with cotangents in the outputs' dtypes,
  JAX's under ``jax.jit``, each tolerance stated at its case.
* Training from JAX's startup scope, copied into the port: LeNet and
  word2vec 4 steps of ``decorate(optimizer)``.  The port's fused and
  unfused programs give the same losses bit for bit, as in f32.  JAX's fused
  program cannot run an AMP fc chain (its ``fused_matmul_bias_act_grad``
  hands ``jax.vjp`` a bf16 cotangent for the f32 output; pinned below),
  so the book models compare with JAX's unfused program.
* The tools: ``train_resnet`` builds the AMP program by default,
  ``train_book --amp`` runs both book models.

The ResNet training runs are in ``test_torch_static_amp_resnet.py``.

The tolerances of the training runs are stated at each test, with what
was measured.  A deep untrained BN net at batch 4 is chaotic
(``test_torch_resnet.py``), and bf16 roundings in two summation orders
feed that chaos more than f32 noise does.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
import paddle_tpu.framework.core as jcore
import paddle_tpu.ops.registry as jreg
from paddle_tpu.contrib.mixed_precision import fp16_lists as jlists
from paddle_tpu.contrib.mixed_precision import fp16_utils as jutils
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.ir import get_pass as jget_pass
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.lenet import build_lenet as jbuild_lenet
from paddle_tpu.models.resnet import build_resnet as jbuild_resnet
from paddle_tpu.models.word2vec import build_word2vec as jbuild_word2vec
from paddle_tpu.ops.registry import eager_call
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.framework.core as tcore
from paddle_tpu_torch.contrib.mixed_precision import fp16_lists as tlists
from paddle_tpu_torch.contrib.mixed_precision import fp16_utils as tutils
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.ir import get_pass as tget_pass
from paddle_tpu_torch.framework.scope import Scope as TScope, load_numpy_state
from paddle_tpu_torch.models.lenet import build_lenet as tbuild_lenet
from paddle_tpu_torch.models.resnet import build_resnet as tbuild_resnet
from paddle_tpu_torch.models.word2vec import build_word2vec as tbuild_word2vec
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.utils import flags as tflags

from test_torch_static_ops import _run as _graph_run
from torch_resnet_parity import ROOT

JAX = (jfluid, junique, {"resnet": jbuild_resnet, "lenet": jbuild_lenet,
                         "word2vec": jbuild_word2vec})
PORT = (tfluid, tunique, {"resnet": tbuild_resnet, "lenet": tbuild_lenet,
                          "word2vec": tbuild_word2vec})
BF16_ULPS = 2
#: word2vec at the JAX test's sizes
W2V = dict(dict_size=50, embed_dim=16, hidden_size=32)


# ==========================================================================
# programs
# ==========================================================================
def _build(pkg, model, depth=18, image=32, train=False):
    """(main, startup, loss) of ``model``'s program from a fresh name
    generator: the fc model, LeNet, word2vec or a ResNet; with ``train``,
    the optimizer under ``decorate`` (Momentum for LeNet and the ResNets,
    SGD for word2vec) minimizes the loss."""
    fluid, un, builders = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 5
        with fluid.program_guard(main, startup):
            if model == "fc":
                x = fluid.layers.data("x", [12])
                label = fluid.layers.data("label", [1], dtype="int64")
                h = fluid.layers.fc(x, 16, act="relu")
                logits = fluid.layers.fc(h, 4)
                loss = fluid.layers.mean(
                    fluid.layers.softmax_with_cross_entropy(logits, label))
            elif model == "lenet":
                img = fluid.layers.data("img", [1, 28, 28])
                label = fluid.layers.data("label", [1], dtype="int64")
                loss, _, _ = builders["lenet"](img, label)
            elif model == "word2vec":
                words = [fluid.layers.data(f"w{i}", [1], dtype="int64")
                         for i in range(4)]
                target = fluid.layers.data("target", [1], dtype="int64")
                loss, _ = builders["word2vec"](words, target, **W2V)
            else:
                img = fluid.layers.data("img", [3, image, image])
                label = fluid.layers.data("label", [1], dtype="int64")
                loss, _, _, _ = builders["resnet"](img, label, depth=depth,
                                                   class_num=100)
            if train:
                if model == "word2vec":
                    opt = fluid.optimizer.SGDOptimizer(0.1)
                elif model == "lenet":
                    opt = fluid.optimizer.MomentumOptimizer(0.05, 0.9)
                else:
                    opt = fluid.optimizer.MomentumOptimizer(0.01, 0.9)
                fluid.contrib.mixed_precision.decorate(opt).minimize(loss)
    finally:
        un.switch(prev)
    return main, startup, loss


def _desc(program):
    """The serialized program as a dict, without the build call stacks."""
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def test_cast_layer_and_astype_build_the_jax_ops():
    descs = []
    for fluid, un, _ in (JAX[:2] + (None,), PORT[:2] + (None,)):
        prev = un.switch()
        try:
            main = fluid.Program()
            with fluid.program_guard(main, fluid.Program()):
                x = fluid.layers.data("x", [3, 4])
                y = fluid.layers.cast(x, "bfloat16")
                z = y.astype("float32")
                fluid.layers.cast(z, "int32")
        finally:
            un.switch(prev)
        descs.append(_desc(main))
    assert descs[0] == descs[1]
    ops = descs[1]["blocks"][0]["ops"]
    assert [o["type"] for o in ops] == ["cast"] * 3
    dts = {v["name"]: v["dtype"] for v in descs[1]["blocks"][0]["vars"]}
    assert [dts[o["outputs"]["Out"][0]] for o in ops] == [
        "bfloat16", "float32", "int32"]


LISTS = {
    "default": {},
    "custom": dict(custom_white_list=["elementwise_add"],
                   custom_black_list=["mul"]),
    "black-varnames": dict(custom_black_varnames=["x"]),
}


@pytest.mark.parametrize("model,lists", [
    ("fc", "default"), ("fc", "custom"), ("fc", "black-varnames"),
    ("lenet", "default"), ("word2vec", "default"), ("resnet18", "default")])
def test_rewrite_program_matches_jax(model, lists):
    """One serialized forward Program, read by both packages and
    rewritten by each package's ``rewrite_program``: the same ops (types,
    slots, cast names and the cast cache) and var dtypes."""
    main, _, _ = _build(JAX, model.rstrip("18"))
    text = main.serialize_to_string()
    jp = jfluid.Program.parse_from_string(text)
    tp = tfluid.Program.parse_from_string(text)
    for un, utils, amp_lists, prog in (
            (junique, jutils, jlists, jp), (tunique, tutils, tlists, tp)):
        prev = un.switch()   # cast names from a fresh generator in both
        try:
            utils.rewrite_program(prog, amp_lists.AutoMixedPrecisionLists(
                **LISTS[lists]))
        finally:
            un.switch(prev)
    assert _desc(tp) == _desc(jp)
    ops = json.loads(tp.serialize_to_string())["blocks"][0]["ops"]
    assert any(o["type"] == "cast" for o in ops)


@pytest.mark.parametrize("model", ["lenet", "word2vec", "resnet18"])
def test_decorate_minimize_builds_the_jax_program(model):
    (jmain, jstart, jloss), (tmain, tstart, tloss) = [
        _build(pkg, model.rstrip("18"), train=True) for pkg in (JAX, PORT)]
    assert _desc(tmain) == _desc(jmain)
    assert _desc(tstart) == _desc(jstart)
    types = [o.type for o in tmain.global_block().ops]
    assert types.count("cast") == types.count("cast_grad") > 0


def test_decorate_leaves_loss_scaling_and_float16_out():
    from paddle_tpu_torch.contrib import mixed_precision as mp

    opt = mp.decorate(tfluid.optimizer.MomentumOptimizer(0.1, 0.9))
    assert opt.get_loss_scaling() == 1.0
    assert opt.get_loss_scaling_var() is None
    with pytest.raises(NotImplementedError, match="slice 8"):
        mp.decorate(tfluid.optimizer.SGDOptimizer(0.1), use_fp16=True)
    for op_type in ("amp_check_finite_and_scale", "update_loss_scaling"):
        with pytest.raises(NotImplementedError, match="slice 8"):
            treg.resolve(op_type)


def test_layout_transform_pass_matches_jax():
    """The BN fusions, then the NHWC pass, on one serialized AMP ResNet-18
    train program in each package: the same op list (transposes at the
    chain's ends, NHWC aliases, flipped layout attrs), then the same
    epilogue fusion on top."""
    main, _, loss = _build(JAX, "resnet", train=True)
    text = main.serialize_to_string()
    results = []
    for fluid, get_pass in ((jfluid, jget_pass), (tfluid, tget_pass)):
        prog = fluid.Program.parse_from_string(text)
        for name in ("fuse_bn_add_act_pass", "fuse_bn_act_pass",
                     "layout_transform_pass", "fuse_epilogue_pass"):
            prog = get_pass(name, protected=(loss.name,)).apply(prog)
        results.append(_desc(prog))
    assert results[1] == results[0]
    ops = results[1]["blocks"][0]["ops"]
    types = [o["type"] for o in ops]
    assert types.count("fused_conv_bn_act") == 17
    assert all(o["attrs"]["data_format"] == "NHWC" for o in ops
               if o["type"] == "fused_conv_bn_act")
    assert 0 < types.count("transpose2") <= 6


def test_cuda_nhwc_flag(monkeypatch):
    """``auto`` is NHWC on a CUDA device for a program whose convolutions
    read bf16 (under ``decorate``) and NCHW for an f32 one; ``"1"``
    forces NHWC anywhere."""
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_nhwc", "auto")
    assert not tflags.cuda_nhwc_enabled(torch.device("cpu"), True)
    assert tflags.cuda_nhwc_enabled(torch.device("cuda"), True)
    assert not tflags.cuda_nhwc_enabled(torch.device("cuda"), False)
    amp, _, _ = _build(PORT, "resnet", train=True)
    f32 = _build(PORT, "resnet")[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.device = torch.device("cuda")  # resolve as a CUDA place would
    assert exe.nhwc_enabled(amp) and not exe.nhwc_enabled(f32)
    tflags.set_flags({"FLAGS_cuda_nhwc": "1"})
    assert tflags.cuda_nhwc_enabled(torch.device("cpu"), False)
    assert "FLAGS_cuda_nhwc" not in tflags.UNPORTED


# ==========================================================================
# lowerings on bf16 inputs against the JAX lowering under jax.jit
# ==========================================================================
def _jit_op(op_type, ins, attrs, outs):
    """The JAX lowering of one op under ``jax.jit``; {slot: [numpy]}."""
    slots = list(ins)

    def f(*vals):
        it = iter(vals)
        packed = {s: [next(it) for _ in ins[s]] for s in slots}
        res = eager_call(op_type, packed, attrs, outs)
        return {k: list(v) for k, v in res.items()}

    flat = [v for s in slots for v in ins[s]]
    res = jax.jit(f)(*flat)
    return {k: [np.asarray(v) for v in vs] for k, vs in res.items()}


def _port_op(op_type, ins, attrs, outs):
    """The port's lowering of one op through a LowerCtx."""
    env = {}
    names = {}
    for s, vals in ins.items():
        names[s] = []
        for i, v in enumerate(vals):
            n = f"{s}{i}"
            env[n] = v
            names[s].append(n)

    class _Op:
        type = op_type
        inputs = names
        outputs = {s: [f"{s}@out{i}" for i in range(k)]
                   for s, k in outs.items()}

    _Op.attrs = dict(attrs)
    treg.resolve(op_type).lower(treg.LowerCtx(_Op, env))
    return {s: [env[n] for n in _Op.outputs[s]] for s in outs}


def _pair(a, dt):
    """(jax value, torch value) of the numpy array ``a`` in ``dt``."""
    if dt == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _f32(v):
    return (v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v).astype(np.float32))


def _compare(op_type, spec, attrs, outs, exact=(), ulps=BF16_ULPS,
             f32_tol=1e-5):
    """Run both; every output's dtype equal; the ``exact`` slots equal bit
    for bit, the other bf16 outputs within ``ulps`` bf16 ulps of their
    largest value, f32 outputs within ``f32_tol`` relative to theirs."""
    jins, tins = {}, {}
    for slot, items in spec.items():
        jins[slot], tins[slot] = zip(*[_pair(a, dt) for a, dt in items])
    want = _jit_op(op_type, {k: list(v) for k, v in jins.items()}, attrs,
                   outs)
    got = _port_op(op_type, {k: list(v) for k, v in tins.items()}, attrs,
                   outs)
    for slot in outs:
        for w, g in zip(want[slot], got[slot]):
            wdt = "bfloat16" if str(w.dtype) == "bfloat16" else str(w.dtype)
            assert str(g.dtype).replace("torch.", "") == wdt, (slot, g.dtype,
                                                               w.dtype)
            gw, ww = _f32(g), _f32(w)
            assert gw.shape == ww.shape, slot
            scale = max(float(np.abs(ww).max()), 1e-30)
            if slot in exact:
                np.testing.assert_array_equal(gw, ww, err_msg=slot)
            elif wdt == "bfloat16":
                err = float(np.abs(gw - ww).max())
                assert err <= ulps * 2.0 ** -8 * scale, (slot, err / scale)
            else:
                err = float(np.abs(gw - ww).max())
                assert err <= f32_tol * scale, (slot, err / scale)


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


_CONV = dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1], groups=1,
             padding_algorithm="EXPLICIT")


def _bn_spec(x, c, seed=5):
    rng = np.random.RandomState(seed)
    return {"X": [(x, "bf16")],
            "Scale": [((1 + 0.1 * rng.randn(c)).astype(np.float32), "f32")],
            "Bias": [(rng.randn(c).astype(np.float32), "f32")],
            "Mean": [(rng.randn(c).astype(np.float32), "f32")],
            "Variance": [(rng.rand(c).astype(np.float32) + 0.5, "f32")]}


_BN_OUTS = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
            "SavedVariance": 1}

def _fused_conv_case():
    """The fused conv on bf16 Input and Filter with f32 BN parameters:
    ConvOut and Output bf16 within 4 bf16 ulps of their largest values
    (the conv sums in another order; the BN then normalizes; measured
    equal here); the f32 statistics of the bf16 conv output, summed in
    another order: the means within a tenth of a bf16 ulp of the largest
    ConvOut (measured 0.018), the variances and the inverse standard
    deviations within 1e-3 relative (measured 2.9e-4 and 6.0e-4)."""
    spec = {k: v for k, v in _bn_spec(None, 8).items() if k != "X"}
    spec["Input"] = [(_r(13, 2, 6, 7, 7), "bf16")]
    spec["Filter"] = [(_r(14, 8, 6, 3, 3, scale=0.3), "bf16")]
    jins, tins = {}, {}
    for slot, items in spec.items():
        jins[slot], tins[slot] = (list(v) for v in
                                  zip(*[_pair(a, dt) for a, dt in items]))
    attrs = dict(_CONV, data_format="NCHW", momentum=0.9, epsilon=1e-5,
                 act_type="relu")
    outs = {"Output": 1, "ConvOut": 1, "MeanOut": 1, "VarianceOut": 1,
            "SavedMean": 1, "SavedVariance": 1}
    want = _jit_op("fused_conv_bn_act", jins, attrs, outs)
    got = _port_op("fused_conv_bn_act", tins, attrs, outs)
    ulp = 2.0 ** -8 * float(np.abs(_f32(want["ConvOut"][0])).max())
    for slot in outs:
        w, g = want[slot][0], got[slot][0]
        gw, ww = _f32(g), _f32(w)
        if slot in ("Output", "ConvOut"):
            assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
            assert np.abs(gw - ww).max() <= 4 * 2.0 ** -8 * np.abs(ww).max()
        elif slot in ("MeanOut", "SavedMean"):
            assert g.dtype == torch.float32 and w.dtype == np.float32
            assert np.abs(gw - ww).max() <= 0.1 * ulp, slot
        else:
            assert g.dtype == torch.float32 and w.dtype == np.float32
            np.testing.assert_allclose(gw, ww, rtol=1e-3, err_msg=slot)


def _bf16_np(a):
    """numpy float32 -> numpy bfloat16 (round to nearest even)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _to_torch(a):
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _grad_run(op_type, ins, outs, attrs, cots):
    """Forward and the grad ops its grad maker writes, in each package:
    JAX's under one ``jax.jit`` (as the executor traces a step), the
    port's through its registry; {var: value} of each."""
    names = [n for items in ins.values() for n, _ in items]

    def f(*vals):
        v = dict(zip(names + list(cots), vals))
        return _graph_run(jcore, jreg, lambda a: a, lambda a: a, op_type,
                          {s: [(n, v[n]) for n, _ in items]
                           for s, items in ins.items()},
                          outs, attrs, {n: v[n] for n in cots})

    flat = [a for items in ins.values() for _, a in items] + list(
        cots.values())
    want = {k: np.asarray(x) for k, x in
            jax.jit(f)(*[jnp.asarray(a) for a in flat]).items()}
    got = _graph_run(tcore, treg, _to_torch, lambda a: a, op_type, ins,
                     outs, attrs, cots)
    return want, got


def _compare_grad(op_type, spec, attrs, outs, cot_of, ulps, f32_tol,
                  grad_f32_tol=None, seed=0):
    """The forward and grad ops of ``op_type`` on ``spec`` ({slot:
    [(numpy f32, "bf16" | "f32")]}), with cotangents (noise plus the
    output itself) in each output's dtype for the outputs ``cot_of``: every value's dtype equal,
    bf16 values within ``ulps`` bf16 ulps of their largest, f32 values
    within ``f32_tol`` (f32 gradients: ``grad_f32_tol``, by default the
    same) relative to their largest; {var: error} of each, in those
    units."""
    ins = {s: [(f"{s.lower()}{i}", _bf16_np(a) if dt == "bf16" else a)
               for i, (a, dt) in enumerate(items)]
           for s, items in spec.items()}
    fwd, _ = _grad_run(op_type, ins, outs, attrs, {})
    rng = np.random.RandomState(seed)
    cots = {}
    for n in cot_of:
        # correlated with the output, so that the BN backward's
        # batch-statistic terms (sum(dy * xhat)) are not near zero
        y = _f32(fwd[n])
        c = (rng.randn(*y.shape) + y / max(float(y.std()), 1e-30)).astype(
            np.float32)
        cots[n + "@GRAD"] = (_bf16_np(c) if str(fwd[n].dtype) == "bfloat16"
                             else c)
    want, got = _grad_run(op_type, ins, outs, attrs, cots)
    assert set(got) == set(want), (sorted(got), sorted(want))
    errs = {}
    for n, w in want.items():
        g = got[n]
        wdt = str(w.dtype)
        assert str(g.dtype).replace("torch.", "") == wdt, (n, g.dtype, wdt)
        gw, ww = _f32(g), _f32(w)
        assert gw.shape == ww.shape, n
        scale = max(float(np.abs(ww).max()), 1e-30)
        err = float(np.abs(gw - ww).max()) / scale
        if wdt == "bfloat16":
            errs[n] = err / 2.0 ** -8
            assert errs[n] <= ulps, (n, errs[n], "bf16 ulps")
        else:
            errs[n] = err
            tol = (grad_f32_tol if n.endswith("@GRAD")
                   and grad_f32_tol is not None else f32_tol)
            assert err <= tol, (n, err)
    return errs


def _conv_grad_case(fmt):
    x = _r(1, 2, 6, 9, 9) if fmt == "NCHW" else _r(1, 2, 9, 9, 6)
    _compare_grad("conv2d", {"Input": [(x, "bf16")],
                             "Filter": [(_r(2, 8, 6, 3, 3, scale=0.3),
                                         "bf16")]},
                  dict(_CONV, data_format=fmt), {"Output": ["out"]},
                  ["out"], ulps=0, f32_tol=0)


#: batch_norm's outputs as a program names them (running stats in place)
_BN_GRAD_OUTS = {"Y": ["y"], "MeanOut": ["mean0"],
                 "VarianceOut": ["variance0"], "SavedMean": ["sm"],
                 "SavedVariance": ["sv"]}


def _bn_grad_case(op_type, fmt, x, z=None, act=None):
    spec = _bn_spec(x, x.shape[1] if fmt == "NCHW" else x.shape[-1])
    if z is not None:
        spec["Z"] = [(z, "bf16")]
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": fmt}
    if act:
        attrs["act_type"] = act
    if op_type == "batch_norm":
        tols = dict(ulps=8, f32_tol=1e-5, grad_f32_tol=10 * 2.0 ** -8)
    else:
        tols = dict(ulps=0, f32_tol=1e-5)
    _compare_grad(op_type, spec, attrs, _BN_GRAD_OUTS, ["y"], **tols)


def _fused_conv_grad_case(fmt, with_z):
    spec = {k: v for k, v in _bn_spec(None, 8).items() if k != "X"}
    nchw = fmt == "NCHW"
    spec["Input"] = [(_r(13, 2, 6, 7, 7) if nchw else _r(13, 2, 7, 7, 6),
                      "bf16")]
    spec["Filter"] = [(_r(14, 8, 6, 3, 3, scale=0.3), "bf16")]
    if with_z:
        spec["Z"] = [(_r(15, 2, 8, 7, 7) if nchw else _r(15, 2, 7, 7, 8),
                      "bf16")]
    attrs = dict(_CONV, data_format=fmt, momentum=0.9, epsilon=1e-5,
                 act_type="relu")
    outs = {"Output": ["out"], "ConvOut": ["conv_out"],
            "MeanOut": ["mean0"], "VarianceOut": ["variance0"],
            "SavedMean": ["sm"], "SavedVariance": ["sv"]}
    errs = _compare_grad("fused_conv_bn_act", spec, attrs, outs, ["out"],
                         ulps=3, f32_tol=5e-3, grad_f32_tol=2e-3)
    assert errs["bias0@GRAD"] == 0 and errs.get("z0@GRAD", 0) == 0, errs


LOWERINGS = {
    # the cast both ways: exact
    "cast-to-bf16": lambda: _compare(
        "cast", {"X": [(_r(0, 5, 6, scale=3), "f32")]},
        {"in_dtype": 5, "out_dtype": 22}, {"Out": 1}, exact=("Out",)),
    "cast-to-f32": lambda: _compare(
        "cast", {"X": [(_r(0, 5, 6, scale=3), "bf16")]},
        {"in_dtype": 22, "out_dtype": 5}, {"Out": 1}, exact=("Out",)),
    # bf16 products: f32 accumulation rounded once, in another order
    "conv2d-nchw": lambda: _compare(
        "conv2d", {"Input": [(_r(1, 2, 6, 9, 9), "bf16")],
                   "Filter": [(_r(2, 8, 6, 3, 3, scale=0.3), "bf16")]},
        dict(_CONV, data_format="NCHW"), {"Output": 1}),
    "conv2d-nhwc": lambda: _compare(
        "conv2d", {"Input": [(_r(1, 2, 9, 9, 6), "bf16")],
                   "Filter": [(_r(2, 8, 6, 3, 3, scale=0.3), "bf16")]},
        dict(_CONV, data_format="NHWC"), {"Output": 1}),
    "mul": lambda: _compare(
        "mul", {"X": [(_r(3, 4, 2, 3), "bf16")],
                "Y": [(_r(4, 6, 5), "bf16")]},
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": 1}),
    # bf16 + f32 promotes to f32 (the fc bias add); bf16 + bf16 stays
    "elementwise_add-bf16-f32": lambda: _compare(
        "elementwise_add", {"X": [(_r(5, 4, 6), "bf16")],
                            "Y": [(_r(6, 6), "f32")]},
        {"axis": 1}, {"Out": 1}, exact=("Out",)),
    "elementwise_add-bf16": lambda: _compare(
        "elementwise_add", {"X": [(_r(5, 2, 3, 4, 4), "bf16")],
                            "Y": [(_r(6, 2, 3, 4, 4), "bf16")]},
        {"axis": -1}, {"Out": 1}, exact=("Out",)),
    "relu": lambda: _compare("relu", {"X": [(_r(7, 5, 6), "bf16")]}, {},
                             {"Out": 1}, exact=("Out",)),
    # statistics in f32 from bf16 x, y = x * a + b in bf16
    "batch_norm-nchw": lambda: _compare(
        "batch_norm", _bn_spec(_r(8, 4, 8, 5, 5, scale=2), 8),
        {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW"},
        _BN_OUTS),
    "batch_norm-nhwc-batch16": lambda: _compare(
        "batch_norm", _bn_spec(_r(9, 16, 3, 3, 8, scale=2) + 1, 8),
        {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NHWC"},
        _BN_OUTS),
    "fused_batch_norm_act": lambda: _compare(
        "fused_batch_norm_act", _bn_spec(_r(10, 4, 8, 5, 5, scale=2), 8),
        {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW",
         "act_type": "relu"}, _BN_OUTS),
    "pool2d-max": lambda: _compare(
        "pool2d", {"X": [(_r(11, 2, 3, 8, 8), "bf16")]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1]}, {"Out": 1}, exact=("Out",)),
    "pool2d-avg-global": lambda: _compare(
        "pool2d", {"X": [(_r(12, 2, 3, 4, 4), "bf16")]},
        {"pooling_type": "avg", "global_pooling": True, "ksize": [1, 1]},
        {"Out": 1}),
    "fused_conv_bn_act": lambda: _fused_conv_case(),
    "fused_matmul_bias_act": lambda: _compare(
        "fused_matmul_bias_act",
        {"X": [(_r(15, 6, 16), "bf16")], "Y": [(_r(16, 16, 10), "bf16")],
         "Bias": [(_r(17, 10), "f32")]},
        {"act_type": "relu", "x_num_col_dims": 1, "axis": -1}, {"Out": 1},
        f32_tol=2.0 ** -7),
    # ---- the backward: each grad op its grad maker writes, JAX's under
    # jax.jit (the generic ones replay the lowering under jax.vjp), with
    # cotangents in the outputs' dtypes
    # the conv backward: the same products, bit for bit
    "conv2d_grad-nchw": lambda: _conv_grad_case("NCHW"),
    "conv2d_grad-nhwc": lambda: _conv_grad_case("NHWC"),
    # dX within 8 bf16 ulps of its largest (measured 4.1 NCHW, 5.4
    # NHWC; 12.5 and 16.2 with cx off by 5%) and dScale/dBias (f32)
    # within 10 bf16 ulps of their largest (measured up to 6.0): XLA's
    # CPU reduction of the bf16 product dy * x and of dy rounds every
    # partial sum to bf16 (the compiled reducer converts f32 -> bf16 ->
    # f32; a sequential bf16 sum in numpy reproduces JAX's dBias bit for
    # bit), and those sums reach dX through the statistics' vjp; the
    # port sums in f32, as JAX's fused grads do; the forward's f32
    # statistics within 1e-5 (measured 7.3e-7)
    "batch_norm_grad-nchw": lambda: _bn_grad_case(
        "batch_norm", "NCHW", _r(8, 4, 8, 5, 5, scale=2)),
    "batch_norm_grad-nhwc": lambda: _bn_grad_case(
        "batch_norm", "NHWC", _r(9, 16, 3, 3, 8, scale=2) + 1),
    # the fused BN grads (explicit in both): bf16 bit for bit, f32
    # dScale within 1e-5 (measured 1.6e-7)
    "fused_batch_norm_act_grad": lambda: _bn_grad_case(
        "fused_batch_norm_act", "NCHW", _r(10, 4, 8, 5, 5, scale=2),
        act="relu"),
    "fused_bn_add_activation_grad": lambda: _bn_grad_case(
        "fused_bn_add_activation", "NCHW", _r(10, 4, 8, 5, 5, scale=2),
        z=_r(11, 4, 8, 5, 5), act="relu"),
    # the fused conv grad (cg, mean, cx bf16, c0 f32; kernel 8's plain
    # version): dInput/dFilter within 3 bf16 ulps of their largest
    # (measured up to 2.0: the f32 statistics of the bf16 ConvOut, summed
    # in another order, move cx and c0, and dConv rounds an element the
    # other way); dZ and dBias bit for bit; dScale within 2e-3 (measured
    # 3.6e-4); the forward statistics within 5e-3 (measured 1.3e-3)
    "fused_conv_bn_act_grad-nchw": lambda: _fused_conv_grad_case(
        "NCHW", False),
    "fused_conv_bn_act_grad-nchw-z": lambda: _fused_conv_grad_case(
        "NCHW", True),
    "fused_conv_bn_act_grad-nhwc": lambda: _fused_conv_grad_case(
        "NHWC", False),
    "fused_conv_bn_act_grad-nhwc-z": lambda: _fused_conv_grad_case(
        "NHWC", True),
    # the fc chain unfused, at LeNet's fc1 (400 -> 120): the products
    # within BF16_ULPS (measured: out 0.001, dX 0.075 bf16 ulps, dY
    # equal);
    # the bias add's grads bit for bit (dX the f32 cotangent cast to bf16)
    "mul_grad": lambda: _compare_grad(
        "mul", {"X": [(_r(3, 64, 400), "bf16")],
                "Y": [(_r(4, 400, 120, scale=0.05), "bf16")]},
        {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": ["out"]},
        ["out"], ulps=BF16_ULPS, f32_tol=0),
    "elementwise_add_grad-bf16-f32": lambda: _compare_grad(
        "elementwise_add", {"X": [(_r(5, 4, 6), "bf16")],
                            "Y": [(_r(6, 6), "f32")]},
        {"axis": 1}, {"Out": ["out"]}, ["out"], ulps=0, f32_tol=0),
}


@pytest.mark.parametrize("case", sorted(LOWERINGS))
def test_bf16_lowering_matches_jax(case):
    LOWERINGS[case]()


# ==========================================================================
# training
# ==========================================================================
def _start_scope(jexe, startup):
    jscope = JScope()
    jexe.run(startup, scope=jscope)
    names = [v.name for v in startup.global_block().vars.values()
             if v.persistable]
    return jscope, {n: np.asarray(jscope.get(n)) for n in names}


def _set_flags(monkeypatch, fuse, nhwc):
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "1" if fuse else "0")
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_nhwc", "1" if nhwc else "0")
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse", "1" if fuse else "0")
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_nhwc", "1" if nhwc else "0")
    if fuse:
        monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")


def _train_both(model, feed, steps, depth=18, image=32):
    """Both packages' losses over ``steps`` steps from JAX's startup
    scope, and the port's plan op types."""
    (jmain, jstart, jloss), (tmain, _, tloss) = [
        _build(pkg, model, depth, image, train=True) for pkg in (JAX, PORT)]
    jexe = pt.Executor(pt.CPUPlace())
    jscope, start = _start_scope(jexe, jstart)
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0])))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                 scope=tscope)[0]))
    plan = list(texe._cache.values())[-1]
    return jl, tl, [o.type for o in plan.ops]


def _book_feed(model, batch=8):
    rng = np.random.RandomState(7)
    if model == "lenet":
        return {"img": rng.rand(batch, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    ids = rng.randint(0, W2V["dict_size"], (batch, 5)).astype(np.int64)
    out = {f"w{i}": ids[:, i:i + 1] for i in range(4)}
    out["target"] = ids[:, 4:]
    return out


#: the book models, 4 steps: step 1 within 1e-3 relative (measured
#: 2.1e-4 LeNet, 7.8e-5 word2vec), every step within 2e-2 relative
#: (measured 6.4e-3 by LeNet's fourth step: bf16 products in two orders,
#: fed back through Momentum)
BOOK_STEP1_RTOL, BOOK_RTOL = 1e-3, 2e-2


@pytest.mark.parametrize("model", ["lenet", "word2vec"])
def test_book_models_amp_training_matches_jax(monkeypatch, model):
    """JAX unfused (its fused AMP fc grad fails, below) against the port
    fused and unfused, which agree bit for bit."""
    _set_flags(monkeypatch, False, False)
    jl, tl, _ = _train_both(model, _book_feed(model), 4)
    _set_flags(monkeypatch, True, False)
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "0")
    jl2, tl_fused, types = _train_both(model, _book_feed(model), 4)
    assert jl2 == jl
    assert types.count("fused_matmul_bias_act") == {"lenet": 2,
                                                    "word2vec": 1}[model]
    assert tl_fused == tl
    assert tl[-1] < tl[0]
    assert abs(tl[0] - jl[0]) / abs(jl[0]) <= BOOK_STEP1_RTOL, (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=BOOK_RTOL)


def test_jax_fused_matmul_grad_cannot_run_an_amp_program(monkeypatch):
    """A divergence of the JAX package from itself, which the port does
    not copy: with the epilogue fusion on, JAX's
    ``fused_matmul_bias_act_grad`` casts the cotangent of the f32 output
    to bf16 (``fused_ops.py:645``) and ``jax.vjp`` refuses it."""
    _set_flags(monkeypatch, True, False)
    (jmain, jstart, jloss) = _build(JAX, "lenet", train=True)
    jexe = pt.Executor(pt.CPUPlace())
    jscope, _ = _start_scope(jexe, jstart)
    with pytest.raises(Exception, match="VJP|vjp"):
        jexe.run(jmain, feed=_book_feed("lenet"), fetch_list=[jloss],
                 scope=jscope)


# ==========================================================================
# the tools
# ==========================================================================
def test_train_resnet_tool_runs_amp_by_default(monkeypatch):
    """``train_resnet`` builds the example's AMP program unless given
    ``--no-amp`` (``test_torch_resnet.py`` runs the tool itself)."""
    from paddle_tpu_torch.tools import train_resnet as tool

    main, _, _, _ = tool.build_program(18, 32, 10, 0.1)
    assert sum(o.type == "cast" for o in main.global_block().ops) > 0
    main, _, _, _ = tool.build_program(18, 32, 10, 0.1, amp=False)
    assert not any(o.type == "cast" for o in main.global_block().ops)
    seen = []

    def fake_train(*args, amp, **kw):
        seen.append(amp)
        return {"images_per_s": 1.0, "ms_per_step": 1.0}

    monkeypatch.setattr(tool, "train", fake_train)
    tool.main(["--tiny", "--device", "cpu"])
    tool.main(["--tiny", "--device", "cpu", "--amp"])
    tool.main(["--tiny", "--device", "cpu", "--no-amp"])
    assert seen == [True, True, False]


@pytest.mark.parametrize("model", ["lenet", "word2vec"])
def test_train_book_tool_amp_tiny_on_cpu(model):
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_book",
         "--model", model, "--tiny", "--device", "cpu", "--amp"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "(AMP bf16)" in r.stdout
