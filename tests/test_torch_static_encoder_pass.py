"""PyTorch port, ``fuse_multihead_attention_pass`` and the pattern matcher
(``framework/ir.py``) against the JAX package's (``tests/test_ir_pass.py``
is JAX's oracle): the naive attention chain in each of its four variants
(scale and mask each there or not) rewritten to the same ops as JAX's
pass gives, the fused program's outputs and, with a backward appended
after the rewrite, its gradients equal to the unfused program's (the
fused op has no Lse, so its grad runs the forward for lse), and a chain
whose softmax output is read outside it left alone.

Tolerance: rtol 1e-5 / atol 1e-5 for the port's fused program against
its unfused one (the plain flash versions against the composed ops) and
against JAX's fused program.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.ir import get_pass as jget_pass
from paddle_tpu.framework.scope import Scope as JScope

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.ir import (OpTemplate, get_pass as tget_pass,
                                           match_pattern)
from paddle_tpu_torch.framework.scope import Scope as TScope, load_numpy_state

TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = [(True, True), (True, False), (False, True), (False, False)]
IDS = ["scale-mask", "scale", "mask", "bare"]
B, H, S, D = 2, 2, 8, 16


def _naive(fluid, unique_name, with_scale, with_mask, backward=False,
           fuse=False, probe=False):
    """(main, startup, names) of the naive attention chain over
    parameters Q, K, V (b, h, s, d) with an optional (b, 1, 1, s) mask
    feed; with ``fuse`` the pass rewrites it before ``backward`` appends
    the grads of ``reduce_mean(out)``; ``probe`` reads the softmax output
    outside the chain."""
    L = fluid.layers
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            q, k, v = (L.create_parameter([B, H, S, D], "float32", name=n)
                       for n in ("q", "k", "v"))
            cur = L.matmul(q, k, transpose_y=True, alpha=0.5)
            if with_scale:
                cur = L.scale(cur, scale=0.25)
            if with_mask:
                cur = L.elementwise_add(cur, fluid.data("mask", [B, 1, 1, S]))
            sm = L.softmax(cur)
            out = L.matmul(sm, v)
            extra = L.scale(sm, scale=2.0) if probe else None
            p = None
            if fuse:
                p = (jget_pass if fluid is jfluid else tget_pass)(
                    "fuse_multihead_attention_pass")
                p.apply(main)
            loss = L.reduce_mean(out)
            if backward:
                fluid.append_backward(loss)
    return main, startup, dict(out=out.name, loss=loss.name, sm=sm.name,
                               extra=extra.name if extra is not None else None,
                               fused=p.fused_count if p else None)


def _ops(program):
    d = json.loads(program.serialize_to_string())
    ops = d["blocks"][0]["ops"]
    for o in ops:
        o["attrs"].pop("op_callstack", None)
    return ops


@pytest.mark.parametrize("with_scale,with_mask", VARIANTS, ids=IDS)
def test_pass_rewrites_like_jax(with_scale, with_mask):
    """One fused_multihead_attention in place of the chain in both
    packages, with the same inputs, outputs and attrs (scale = alpha x
    the scale op's), every other op untouched."""
    jm, _, jn = _naive(jfluid, junique, with_scale, with_mask, fuse=True)
    tm, _, tn = _naive(tfluid, tunique, with_scale, with_mask, fuse=True)
    assert jn["fused"] == tn["fused"] == 1
    assert _ops(tm) == _ops(jm)
    fused, = [o for o in _ops(tm) if o["type"] == "fused_multihead_attention"]
    assert fused["attrs"]["scale"] == (0.125 if with_scale else 0.5)
    assert ("BiasQK" in fused["inputs"]) == with_mask
    assert not {"softmax", "matmul", "scale"} & {o["type"]
                                                  for o in _ops(tm)}


def _run(fluid, exe, scope, main, startup, fetch, feed):
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("with_scale,with_mask", VARIANTS, ids=IDS)
def test_fused_program_equals_unfused(with_scale, with_mask):
    """The rewritten program's output and, with the backward appended
    after the rewrite, its loss and Q / K / V gradients: the port fused
    against the port unfused and against JAX fused, from one set of
    parameters."""
    rng = np.random.RandomState(0)
    feed = {}
    if with_mask:
        feed["mask"] = np.where(rng.rand(B, 1, 1, S) > 0.25, 0.0,
                                -1e4).astype(np.float32)
    params = {n: rng.randn(B, H, S, D).astype(np.float32)
              for n in ("q", "k", "v")}
    fetch = ["out", "loss", "q@GRAD", "k@GRAD", "v@GRAD"]
    results = {}
    for key, fluid, un, fuse in (("port", tfluid, tunique, False),
                                 ("port-fused", tfluid, tunique, True),
                                 ("jax-fused", jfluid, junique, True)):
        main, startup, names = _naive(fluid, un, with_scale, with_mask,
                                      backward=True, fuse=fuse)
        names = [names.get(n, n) for n in fetch]
        if fluid is tfluid:
            scope = TScope()
            load_numpy_state(scope, params, "cpu")
            exe = tfluid.Executor(tfluid.CPUPlace())
        else:
            scope = JScope()
            for n, a in params.items():
                scope.set(n, a)
            exe = pt.Executor(pt.CPUPlace())
        results[key] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=names, scope=scope)]
        if fuse:
            types = [o.type for o in main.global_block().ops]
            assert "fused_multihead_attention_grad" in types
            assert "softmax_grad" not in types
    for other in ("port-fused", "jax-fused"):
        for n, a, b in zip(fetch, results[other], results["port"]):
            np.testing.assert_allclose(a, b, err_msg=f"{other} {n}", **TOL)


def test_fusion_blocked_by_shared_intermediate():
    """A softmax output read outside the chain keeps the chain, in both
    packages (the detector's IsIntermediate rule)."""
    for fluid, un in ((jfluid, junique), (tfluid, tunique)):
        main, _, names = _naive(fluid, un, False, False, fuse=True,
                                probe=True)
        assert names["fused"] == 0
        assert "fused_multihead_attention" not in [
            o.type for o in main.global_block().ops]


def test_match_pattern_chain():
    """A two-op chain matches once; with the intermediate read elsewhere
    it matches only under ``allow_shared_intermediates``."""
    with tunique.guard():
        main = tfluid.Program()
        with tfluid.program_guard(main, tfluid.Program()):
            x = tfluid.data("x", [-1, 4])
            h = tfluid.layers.relu(x)
            tfluid.layers.tanh(h)
            tfluid.layers.exp(h)
    block = main.global_block()
    chain = [OpTemplate("r", "relu"), OpTemplate("t", "tanh", {"X": "r.Out"})]
    assert match_pattern(block, chain) == []
    m, = match_pattern(block, chain, allow_shared_intermediates=True)
    assert (m["r"].type, m["t"].type) == ("relu", "tanh")
