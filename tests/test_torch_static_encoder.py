"""PyTorch port, the static BERT encoder (``tests/torch_static_encoder.py``)
against the JAX package: the program both build, their pass pipelines op
for op, and 3 Adam steps of a small encoder (2 layers, hidden 64, 4
heads, seq 64, vocabulary 128, dropout off: the two packages' masks
differ) from JAX's startup scope copied as numpy, on JAX's serialized
program, in f32 and under bf16 and fp16 ``decorate``.

Tolerances on the per-step losses (relative): f32 1e-5 (unfused, and
fused against JAX fused: the port's plain kernel 9 against JAX's jnp
fallback); bf16 1e-3 and fp16 2e-4 (the 16-bit products round the
parameters' gradients in another summation order, oneDNN against XLA,
and the Adam step carries the difference into the next loss: 4e-5 and
4e-6 measured after 3 steps).  Both packages' ``fused_multihead_attention``
runs in float32 under ``decorate``: the white-listed ``mul`` gives bf16
or fp16, the f32 bias add of ``fc`` promotes it back, so Q, K and V
arrive in f32 (:func:`test_attention_dtype_under_decorate`).

JAX's runs turn its pass verifier (``FLAGS_verify_passes``) off: it
checks JAX's own passes and changes no number.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
import paddle_tpu.ops.registry as jreg
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops.registry as treg
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import Scope as TScope, load_numpy_state
from paddle_tpu_torch.utils import flags as tflags

import torch_static_encoder as enc

SEQ, BATCH, STEPS, LR = 64, 2, 3, 1e-3
LOSS_RTOL = {None: 1e-5, "bfloat16": 1e-3, "float16": 2e-4}


@pytest.fixture
def flags(monkeypatch):
    """Both packages' fusion flags restored after the test; JAX's pass
    verifier off."""
    monkeypatch.setitem(jflags._flags, "FLAGS_verify_passes", "0")
    old_j = jflags._flags.get("FLAGS_tpu_fuse")
    old_t = dict(tflags._SET)
    yield
    jflags._flags["FLAGS_tpu_fuse"] = old_j
    tflags._SET.clear()
    tflags._SET.update(old_t)


def _set_fuse(fuse):
    jflags._flags["FLAGS_tpu_fuse"] = "1" if fuse else "0"
    tflags.set_flags({"FLAGS_cuda_fuse": "1" if fuse else "0"})


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


@pytest.mark.parametrize("amp", [None, "bfloat16", "float16"])
def test_port_builds_the_jax_program(amp):
    """``build_encoder`` gives one program in both packages, op for op and
    var for var, but for the Lse vars' declared shapes: JAX infers its CPU
    sentinel's (1,), the port its (b, h, s) lse."""
    cfg = dict(enc.TINY, hidden_dropout=0.1, attn_dropout=0.1)
    (jm, js, _), (tm, ts, _) = (
        enc.build_encoder(f, u, cfg, SEQ, amp=amp)
        for f, u in ((jfluid, junique), (tfluid, tunique)))
    jd, td = _desc(jm), _desc(tm)
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert _desc(ts) == _desc(js)
    jv, tv = jd["blocks"][0]["vars"], td["blocks"][0]["vars"]
    jv = {v["name"]: v for v in jv} if isinstance(jv, list) else jv
    tv = {v["name"]: v for v in tv} if isinstance(tv, list) else tv
    lse = {o["outputs"]["Lse"][0] for o in jd["blocks"][0]["ops"]
           if o["type"] == "fused_multihead_attention"}
    assert len(lse) == cfg["layers"] and set(jv) == set(tv)
    for n in jv:
        if n in lse:
            assert jv[n]["shape"] == [1]
            assert tv[n]["shape"] == [-1, cfg["heads"], SEQ]
        else:
            assert tv[n] == jv[n], n


def _spy(reg, seen):
    """Record the runtime dtype of the attention op's Q."""
    d = reg.OPS["fused_multihead_attention"]
    orig = d.lower

    def lower(ctx):
        seen.add(str(ctx.in_("Q").dtype).replace("torch.", ""))
        return orig(ctx)

    d.lower = lower
    return lambda: setattr(d, "lower", orig)


def _train_both(amp, fuse):
    """Losses of STEPS steps in each package on JAX's serialized program
    from JAX's startup scope, the port's compiled op types, and the
    runtime dtypes of each package's attention Q."""
    _set_fuse(fuse)
    jmain, jstart, jloss = enc.build_encoder(jfluid, junique, enc.TINY,
                                             SEQ, lr=LR, amp=amp)
    tmain = tfluid.Program.parse_from_string(jmain.serialize_to_string())
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    start = {v.name: np.asarray(jscope.get(v.name))
             for v in jstart.global_block().vars.values() if v.persistable}
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = enc.encoder_feed(enc.TINY, BATCH, SEQ)
    losses = {"jax": [], "port": []}
    dtypes = {"jax": set(), "port": set()}
    undo = [_spy(jreg, dtypes["jax"]), _spy(treg, dtypes["port"])]
    try:
        for _ in range(STEPS):
            j = jexe.run(jmain, feed=feed, fetch_list=[jloss.name],
                         scope=jscope)
            t = texe.run(tmain, feed=feed, fetch_list=[jloss.name],
                         scope=tscope)
            losses["jax"].append(float(np.asarray(j[0])))
            losses["port"].append(float(t[0]))
    finally:
        for u in undo:
            u()
    plan = next(iter(texe._cache.values()))
    return losses, [o.type for o in plan.ops], dtypes


@pytest.mark.parametrize("amp,fuse", [(None, False), (None, True),
                                      ("bfloat16", False),
                                      ("float16", False)],
                         ids=["f32", "f32-fused", "bf16", "fp16"])
def test_encoder_trains_like_jax(flags, amp, fuse):
    """3 Adam steps: every step's loss within LOSS_RTOL of JAX's, the loss
    falling; fused, the FFN-in fc (mul -> add -> gelu) of each layer is
    one fused_matmul_bias_act and its grad, and no other chain fuses
    (the other fcs have no act).  Under decorate JAX runs unfused: its
    fused fc grad cannot run an AMP program (ROADMAP.md Queue 3)."""
    losses, types, dtypes = _train_both(amp, fuse)
    # the attention runs in f32 under decorate too, in both packages
    assert dtypes == {"jax": {"float32"}, "port": {"float32"}}
    jl, tl = losses["jax"], losses["port"]
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    for a, b in zip(jl, tl):
        assert abs(a - b) <= LOSS_RTOL[amp] * abs(a), (jl, tl)
    n = enc.TINY["layers"] if fuse else 0
    assert types.count("fused_matmul_bias_act") == n
    assert types.count("fused_matmul_bias_act_grad") == n
    assert types.count("fused_multihead_attention") == enc.TINY["layers"]
    assert types.count("fused_adam") == 1 and "adam" not in types


@pytest.mark.parametrize("amp", ["bfloat16", "float16"])
def test_attention_dtype_under_decorate(amp):
    """``fused_multihead_attention`` is on no AMP list, so it runs in the
    dtype its inputs arrive in (float32 in both packages at run time:
    :func:`test_encoder_trains_like_jax`): each Q / K / V comes from the
    fc's f32 bias add after the 16-bit ``mul``, through a reshape and a
    transpose; its Out stays declared f32, and the MLM head's
    softmax_with_cross_entropy reads the f32 head add with no cast."""
    main, _, _ = enc.build_encoder(tfluid, tunique, enc.TINY, SEQ, amp=amp)
    blk = main.global_block()
    ops = blk.ops
    prod = {n: o for o in ops for names in o.outputs.values() for n in names}
    for mha in [o for o in ops if o.type == "fused_multihead_attention"]:
        assert blk.var(mha.output("Out")[0]).dtype == blk.var(
            mha.input("Q")[0]).dtype
        for slot in ("Q", "K", "V"):
            chain = [prod[mha.input(slot)[0]]]
            for _ in range(3):
                chain.append(prod[chain[-1].input("X")[0]])
            assert [o.type for o in chain] == [
                "transpose2", "reshape2", "elementwise_add", "mul"]
            assert blk.var(chain[1].input("X")[0]).dtype == blk.var(
                mha.output("Out")[0]).dtype
            assert blk.var(chain[3].output("Out")[0]).dtype != blk.var(
                chain[2].output("Out")[0]).dtype
    ce, = [o for o in ops if o.type == "softmax_with_cross_entropy"]
    assert prod[ce.input("Logits")[0]].type == "elementwise_add"


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_pass_pipeline_matches_jax(flags, amp, fuse):
    """Each executor's pipeline (fuse_optimizer_ops_pass, then the
    epilogue fusion when on) on one serialized encoder program: the same
    program, op for op, attr for attr; the cost model picks the layers'
    FFN-in chains and nothing else."""
    _set_fuse(fuse)
    jmain, _, loss = enc.build_encoder(jfluid, junique, enc.TINY, SEQ,
                                       amp=amp)
    tmain = tfluid.Program.parse_from_string(jmain.serialize_to_string())
    jrew = pt.Executor(pt.CPUPlace())._apply_ir_passes(jmain, [loss.name])
    trew = tfluid.Executor(tfluid.CPUPlace())._apply_ir_passes(
        tmain, [loss.name])
    assert _desc(trew)["blocks"][0]["ops"] == _desc(jrew)["blocks"][0]["ops"]
    types = [o.type for o in trew.global_block().ops]
    n = enc.TINY["layers"] if fuse else 0
    assert types.count("fused_matmul_bias_act") == n
    assert types.count("gelu") == enc.TINY["layers"] - n
    assert types.count("fused_adam") == 1


def test_fused_ffn_takes_kernel_9s_route(flags):
    """The fused FFN-in op's X is the (b, s, hidden) activation with
    x_num_col_dims 2 and a trailing 1-D bias: the lowering flattens it to
    (b * s, hidden) and runs kernel 9's wrapper (its plain version on the
    CPU), once in the forward and once in the grad's replay."""
    from paddle_tpu_torch.ops import fused_ops

    _set_fuse(True)
    calls = []
    orig = fused_ops.matmul_bias_act

    def spy(x, w, b, act=""):
        if x.device.type != "meta":     # not the pass's shape inference
            calls.append((tuple(x.shape), tuple(w.shape), act))
        return orig(x, w, b, act)

    fused_ops.matmul_bias_act = spy
    try:
        losses, types, _ = _train_both(None, True)
    finally:
        fused_ops.matmul_bias_act = orig
    h, inter = enc.TINY["hidden"], enc.TINY["intermediate"]
    want = [((BATCH * SEQ, h), (h, inter), "gelu"),
            ((BATCH * SEQ, h), (h, inter), "")] * enc.TINY["layers"]
    assert sorted(calls) == sorted(want * STEPS)


def test_encoder_module_trains_the_port_and_imports_no_jax():
    """``tests/torch_static_encoder.py``, as chip_smoke.py uses it, runs
    the port's encoder on the CPU (its command line, 3 tiny steps, the loss
    falling) and imports neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import torch_static_encoder as e\n"
            "e.main(['--tiny', '--device', 'cpu', '--lr', '1e-3'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
