"""PyTorch port, dygraph AMP in bfloat16 and float16
(``paddle_tpu_torch.dygraph`` ``amp_guard`` / ``amp_cast`` /
``jit_train_step(amp=True)``, the O2 master weights of
``AdamOptimizer``) against the JAX package on the CPU, on the same numpy
inputs.

* ``amp_guard``'s list semantics (white, black, custom lists, O2's
  lookup ops, nesting, ``enable=False``) == the JAX tracer's state, and
  the cast each op type gets == ``Tracer._amp_cast_inputs``'s;
* the cast cache: a tensor read by two white-list ops is cast once, and
  its gradient is the f32 upcast of the two bf16 gradients summed in bf16
  (exactly), as on the JAX tape;
* ``layer_norm``, ``softmax_with_cross_entropy``, ``dropout`` and ``gelu``
  in bf16 and in fp16 == the JAX lowerings;
* O2: the master is seeded from the bf16 / fp16 parameter's upcast, and
  Adam steps on bf16 / fp16 parameters == JAX ``_eager_update``;
* a tiny BERT (2 layers, hidden 64, dropout off) from the same weights,
  3 ``jit_train_step`` steps at O1 and at O2 in bf16 and in fp16 ==
  JAX's; bf16 and fp16 weights load into an O2 model.

Tolerances: bf16 values within ``BF16_ULPS`` ulps (2^-8 relative) and fp16
values within ``FP16_ULPS`` ulps (2^-10 relative) of the tensor's largest
magnitude, where both sides round at the same points but sum in another
order; the trajectories as stated at their test.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as fluid
import paddle_tpu.layers as JF
from paddle_tpu import dygraph as jdy
from paddle_tpu.framework.core import _current_tracer
from paddle_tpu.models import bert as JB
from paddle_tpu.ops.registry import eager_call

from paddle_tpu_torch.dygraph import (Embedding, LayerNorm, amp_cast,
                                      amp_guard, jit_train_step,
                                      load_state_dict_numpy)
from paddle_tpu_torch.dygraph.base import amp_state
from paddle_tpu_torch.dygraph.jit import _cast_params_resident
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.decoder_ops import matmul
from paddle_tpu_torch.optimizer import AdamOptimizer

BF16_ULPS = 2
FP16_ULPS = 2
#: an ulp relative to 1, by AMP dtype
ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}
AMP_DTYPES = ["bfloat16", "float16"]


def _bf16_close(got, want, ulps=BF16_ULPS, what="", ulp=2.0 ** -8):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got).astype(np.float32)
    w = np.asarray(want).astype(np.float32)
    tol = ulps * ulp * float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


def _fp16_close(got, want, ulps=FP16_ULPS, what=""):
    _bf16_close(got, want, ulps, what, ulp=2.0 ** -10)


def _jax_state():
    t = _current_tracer()
    white, black = t._amp_lists()
    return t._amp_enabled, t._amp_dtype, set(white), set(black)


def _port_state():
    st = amp_state()
    white, black = st.lists()
    return st.enabled, st.dtype, set(white), set(black)


# ==========================================================================
# amp_guard: the lists and the cast rule
# ==========================================================================
GUARDS = {
    "default": dict(),
    "O2": dict(level="O2"),
    "custom": dict(custom_white_list=["elementwise_add", "softmax"],
                   custom_black_list=["matmul"]),
    "custom-O2": dict(custom_black_list=["lookup_table_v2"], level="O2"),
    "fp16": dict(dtype="float16"),
    "fp16-O2": dict(dtype="float16", level="O2"),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_amp_guard_lists_match_jax(name):
    kw = GUARDS[name]
    with jdy.guard():
        assert _jax_state()[0] is False and _port_state()[0] is False
        with jdy.amp_guard(**kw), amp_guard(**kw):
            assert _port_state() == _jax_state()
            # a nested plain guard keeps the enclosing lists
            with jdy.amp_guard(), amp_guard():
                assert _port_state() == _jax_state()
            # enable=False turns an enclosing guard off
            with jdy.amp_guard(enable=False), amp_guard(enable=False):
                assert _port_state() == _jax_state()
                assert _port_state()[0] is False
            assert _port_state() == _jax_state()
        assert _port_state()[0] is False


OPS = ["matmul", "fused_multihead_attention", "lookup_table_v2", "mean",
       "softmax", "softmax_with_cross_entropy", "elementwise_add",
       "layer_norm", "einsum"]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16),
          "int64": (np.int32, torch.int64)}


@pytest.mark.parametrize("amp_dtype", AMP_DTYPES)
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op_type", OPS)
def test_cast_rule_matches_jax(level, op_type, amp_dtype):
    """The dtype each op type's input gets == ``_amp_cast_inputs``'s (an
    int input passes through on both sides): under fp16
    ``softmax_with_cross_entropy`` takes the f32 black-list cast, under
    bf16 it is exempt."""
    from paddle_tpu.dygraph.varbase import VarBase
    kw = dict(level=level, dtype=amp_dtype)
    with jdy.guard():
        with jdy.amp_guard(**kw), amp_guard(**kw):
            for name, (jdt, tdt) in DTYPES.items():
                jv = VarBase(jnp.ones((2, 3), jdt))
                want = _current_tracer()._amp_cast_inputs(
                    op_type, {"X": jv})["X"]._value.dtype
                (got,) = amp_cast(op_type, torch.ones(2, 3, dtype=tdt))
                if name == "int64":
                    assert got.dtype == torch.int64 and str(want) == "int32"
                else:
                    assert str(got.dtype) == f"torch.{want}", (name, want)
                if (op_type == "softmax_with_cross_entropy"
                        and name == amp_dtype):
                    assert got.dtype == (torch.float32
                                         if amp_dtype == "float16"
                                         else torch.bfloat16)
        # outside a guard nothing is cast
        (same,) = amp_cast(op_type, torch.ones(2))
        assert same.dtype == torch.float32


def test_float16_amp_runs_and_other_dtypes_raise():
    """``amp_guard(dtype="float16")`` casts white-list inputs to fp16,
    ``jit_train_step(amp_dtype="float16")`` at O2 makes every parameter
    fp16-resident, as JAX's ``_cast_params_resident`` does (the BERT has
    no BatchNorm, which JAX would keep f32), and a dtype that is not an
    AMP dtype raises."""
    with amp_guard(dtype="float16"):
        (x,) = amp_cast("matmul", torch.ones(2, 2))
        assert x.dtype == torch.float16
    with jdy.guard():
        jm = JB.BertForPretraining(JB.BertConfig(**TINY))
        from paddle_tpu.dygraph.jit import _cast_params_resident as jcast
        jcast(jm, "float16")
        want = {n: str(np.asarray(p.value()).dtype)
                for n, p in jm.named_parameters()}
    m = TB.BertForPretraining(TB.BertConfig(**TINY), device="cpu")
    opt = AdamOptimizer(1e-3, parameter_list=m.parameters())
    jit_train_step(m, opt, _loss_fn, amp=True, amp_dtype="float16",
                   amp_level="O2")
    got = {n: str(p.dtype).replace("torch.", "")
           for n, p in m.named_parameters()}
    assert got == want and set(got.values()) == {"float16"}
    with pytest.raises(ValueError, match="AMP dtype"):
        with amp_guard(dtype="float64"):
            pass


# ==========================================================================
# the cast cache and the tied-weight gradient
# ==========================================================================
def _two_consumer_grads(w, x1, x2, c1, c2, consumers=(0, 1)):
    """W's gradient of sum(c1 * (x1 @ W)) + sum(c2 * (x2 @ W)) under the
    guard, each matmul a white-list op; ``consumers`` picks the terms."""
    tw = torch.tensor(w, requires_grad=True)
    with amp_guard():
        terms = []
        for i, (x, c) in enumerate(((x1, c1), (x2, c2))):
            if i in consumers:
                y = matmul(torch.tensor(x), tw)
                assert y.dtype == torch.bfloat16
                terms.append((y * torch.tensor(c)).sum())
        sum(terms).backward()
    return tw.grad


def test_cast_cache_casts_once_and_sums_the_gradient_in_bf16():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 8).astype(np.float32)
    x1, x2 = (rng.randn(5, 16).astype(np.float32) for _ in range(2))
    c1, c2 = (rng.randn(5, 8).astype(np.float32) for _ in range(2))
    t = torch.tensor(w, requires_grad=True)
    with amp_guard():
        (a,) = amp_cast("matmul", t)
        (b,) = amp_cast("matmul", t)
        assert a is b and a.dtype == torch.bfloat16
        with torch.no_grad():
            t.add_(1.0)             # an in-place update: a new cast
        (c,) = amp_cast("matmul", t)
        assert c is not a
    with amp_guard():               # a new guard: a new cache
        (d,) = amp_cast("matmul", t)
        assert d is not c
    both = _two_consumer_grads(w, x1, x2, c1, c2)
    g1 = _two_consumer_grads(w, x1, x2, c1, c2, (0,))
    g2 = _two_consumer_grads(w, x1, x2, c1, c2, (1,))
    # each consumer's gradient is a bf16 upcast; the tape sums them in bf16
    assert torch.equal(g1, g1.bfloat16().float())
    summed_bf16 = (g1.bfloat16() + g2.bfloat16()).float()
    assert torch.equal(both, summed_bf16)
    assert not torch.equal(summed_bf16, g1 + g2)   # the order shows
    # and JAX's tracer gives the same gradient
    with jdy.guard():
        jw = jdy.to_variable(w)
        jw.stop_gradient = False
        with jdy.amp_guard():
            loss = None
            for x, c in ((x1, c1), (x2, c2)):
                y = JF.matmul(jdy.to_variable(x), jw)
                term = JF.reduce_sum(JF.elementwise_mul(
                    y, jdy.to_variable(c)))
                loss = term if loss is None else loss + term
        loss.backward()
        _bf16_close(both, jw.gradient(), what="dW")


# ==========================================================================
# the lowerings in bf16
# ==========================================================================
def _jop(type_, ins, attrs, outs):
    return {k: [np.asarray(x) for x in v]
            for k, v in eager_call(type_, ins, attrs, outs).items()}


def _pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


def _jit_lowering(type_, attrs, in_slots, out_slot):
    """``jax.jit`` of one JAX lowering, as ``jit_train_step`` and the
    static executor run it: the compiled form is the reference, because
    XLA keeps only some of the source's bf16 roundings."""
    def f(*vals):
        return eager_call(type_, {s: [v] for s, v in zip(in_slots, vals)},
                          attrs, {out_slot: 1})[out_slot][0]
    return jax.jit(f), jax.jit(
        lambda *a: jax.vjp(f, *a[:-1])[1](a[-1]))


@pytest.mark.parametrize("params", ["f32", "bf16"])
def test_layer_norm_bf16_matches_jax(params):
    """Forward: bit for bit with the compiled lowering (three roundings:
    the normalized value, * Scale, + Bias).  Backward: dX bit for bit
    (measured: 0 of 1344 differ); dScale and dBias within
    ``LN_PARAM_GRAD_ULPS`` bf16 ulps of their largest magnitude, because
    XLA's CPU reduction rounds every partial sum to bf16 where the port
    sums in f32 and rounds once (measured here: 55-64% of elements
    differ, by at most 0.78% of the largest, 2.0 ulps)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 7, 64) * 3 + 1).astype(np.float32)
    sc = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bi = (0.1 * rng.randn(64)).astype(np.float32)
    dy = rng.randn(3, 7, 64).astype(np.float32)
    jx, tx = _pair(x)
    jp = [jnp.asarray(a, jnp.bfloat16 if params == "bf16" else jnp.float32)
          for a in (sc, bi)]
    fwd, vjp = _jit_lowering("layer_norm", {"begin_norm_axis": 2,
                                            "epsilon": 1e-5},
                             ("X", "Scale", "Bias"), "Y")
    want = np.asarray(fwd(jx, *jp))
    layer = LayerNorm(64, device="cpu").set_dict({"weight": sc, "bias": bi})
    if params == "bf16":
        layer.weight.data = layer.weight.data.bfloat16()
        layer.bias.data = layer.bias.data.bfloat16()
    tx.requires_grad_()
    got = layer(tx)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  want.astype(np.float32))
    got.backward(torch.tensor(dy).bfloat16())
    wdx, wds, wdb = vjp(jx, *jp, jnp.asarray(dy, jnp.bfloat16))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(wdx).astype(np.float32))
    for g, w, what in ((layer.weight.grad, wds, "dScale"),
                       (layer.bias.grad, wdb, "dBias")):
        assert g.dtype == layer.weight.dtype
        _bf16_close(g, w, ulps=LN_PARAM_GRAD_ULPS, what=what)


LN_PARAM_GRAD_ULPS = 3


@pytest.mark.parametrize("params", ["f32", "fp16"])
def test_layer_norm_fp16_matches_jax(params):
    """fp16 rounds at other points than bf16: XLA's CPU computes the fused
    ``* Scale + Bias`` in f32 and rounds once (the three bf16 roundings
    differ from it on 27% of these outputs).  Forward and dX bit for bit
    with the compiled lowering (dX: ``g = dy * Scale`` rounded to fp16
    first); dScale and dBias within ``LN_PARAM_GRAD_ULPS`` fp16 ulps of
    their largest magnitude (measured here: 72% and 64% of elements
    differ, by at most 0.76 ulp)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 7, 64) * 3 + 1).astype(np.float32)
    sc = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bi = (0.1 * rng.randn(64)).astype(np.float32)
    dy = rng.randn(3, 7, 64).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.float16), torch.tensor(x).half()
    jp = [jnp.asarray(a, jnp.float16 if params == "fp16" else jnp.float32)
          for a in (sc, bi)]
    fwd, vjp = _jit_lowering("layer_norm", {"begin_norm_axis": 2,
                                            "epsilon": 1e-5},
                             ("X", "Scale", "Bias"), "Y")
    want = np.asarray(fwd(jx, *jp))
    layer = LayerNorm(64, device="cpu").set_dict({"weight": sc, "bias": bi})
    if params == "fp16":
        layer.weight.data = layer.weight.data.half()
        layer.bias.data = layer.bias.data.half()
    tx.requires_grad_()
    got = layer(tx)
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  want.astype(np.float32))
    # the bf16 rounding points would not do
    y3 = F.layer_norm(tx.detach().float(), (64,), None, None, 1e-5).half()
    y3 = ((y3 * torch.tensor(sc).half()) + torch.tensor(bi).half())
    assert np.mean(y3.float().numpy() != want.astype(np.float32)) > 0.2
    got.backward(torch.tensor(dy).half())
    wdx, wds, wdb = vjp(jx, *jp, jnp.asarray(dy, jnp.float16))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(wdx).astype(np.float32))
    for g, w, what in ((layer.weight.grad, wds, "dScale"),
                       (layer.bias.grad, wdb, "dBias")):
        assert g.dtype == layer.weight.dtype
        _fp16_close(g, w, ulps=LN_PARAM_GRAD_ULPS, what=what)


def test_softmax_with_cross_entropy_bf16_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(6, 40) * 3).astype(np.float32)
    label = rng.randint(0, 40, (6, 1)).astype(np.int64)
    jl, tl = _pair(logits)
    want = _jop("softmax_with_cross_entropy",
                {"Logits": [jl], "Label": [label]}, {},
                {"Loss": 1, "Softmax": 1})
    x = tl.clone().requires_grad_()
    with amp_guard():       # black-listed, but exempt under bf16: no cast
        loss = nn_ops.softmax_with_cross_entropy(x, torch.tensor(label))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want["Loss"][0],
                               rtol=1e-6, atol=1e-6)
    dloss = rng.rand(6, 1).astype(np.float32)
    loss.backward(torch.tensor(dloss))
    jg = _jop("softmax_with_cross_entropy_grad",
              {"Softmax": want["Softmax"], "Label": [label],
               "Loss@GRAD": [dloss]}, {}, {"Logits@GRAD": 1})
    assert x.grad.dtype == torch.bfloat16
    _bf16_close(x.grad, jg["Logits@GRAD"][0], what="dlogits")


def test_softmax_with_cross_entropy_takes_f32_under_fp16():
    """Under fp16 AMP the op is black-listed with no exemption: the fp16
    logits reach the lowering as their f32 cast, loss and gradient match
    JAX's f32 lowering, and the gradient flows back to the fp16 logits
    through the cast (``tracer.py:99-103``)."""
    rng = np.random.RandomState(2)
    logits = (rng.randn(6, 40) * 3).astype(np.float32)
    label = rng.randint(0, 40, (6, 1)).astype(np.int64)
    l16 = np.asarray(jnp.asarray(logits, jnp.float16)).astype(np.float32)
    want = _jop("softmax_with_cross_entropy",
                {"Logits": [jnp.asarray(l16)], "Label": [label]}, {},
                {"Loss": 1, "Softmax": 1})
    x = torch.tensor(logits).half().requires_grad_()
    with amp_guard(dtype="float16"):
        loss = nn_ops.softmax_with_cross_entropy(x, torch.tensor(label))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want["Loss"][0],
                               rtol=1e-6, atol=1e-6)
    dloss = rng.rand(6, 1).astype(np.float32)
    loss.backward(torch.tensor(dloss))
    jg = _jop("softmax_with_cross_entropy_grad",
              {"Softmax": want["Softmax"], "Label": [label],
               "Loss@GRAD": [dloss]}, {}, {"Logits@GRAD": 1})
    assert x.grad.dtype == torch.float16
    np.testing.assert_array_equal(
        x.grad.float().numpy(),
        jg["Logits@GRAD"][0].astype(np.float16).astype(np.float32))


def test_dropout_and_gelu_bf16_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4000).astype(np.float32)
    jx, tx = _pair(x)
    # p 0: identity on both sides
    want = _jop("dropout", {"X": [jx]},
                {"dropout_prob": 0.0, "dropout_implementation":
                 "upscale_in_train"}, {"Out": 1, "Mask": 1})["Out"][0]
    got = nn_ops.dropout(tx, 0.0, implementation="upscale_in_train",
                         generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    # p 0.1: the kept values are x times the factor rounded to bf16
    # (1/0.9 -> 1.109375), JAX's jnp.asarray(scale, x.dtype)
    got = nn_ops.dropout(tx, 0.1, implementation="upscale_in_train",
                         generator=torch.Generator().manual_seed(0))
    kept = got != 0
    factor = torch.tensor(1.0 / 0.9).to(torch.bfloat16)
    assert float(factor) == 1.109375
    assert torch.equal(got[kept], (tx * factor)[kept])
    jd = _jop("dropout", {"X": [jx]}, {"dropout_prob": 0.1,
                                       "dropout_implementation":
                                       "upscale_in_train"},
              {"Out": 1, "Mask": 1})
    jk = jd["Mask"][0].astype(bool)
    np.testing.assert_array_equal(
        jd["Out"][0][jk].astype(np.float32),
        (tx * factor).float().numpy()[jk])
    # tanh: one op, rounded once on both sides
    want = _jop("tanh", {"X": [jx]}, {}, {"Out": 1})["Out"][0]
    got = nn_ops.activation(tx, "tanh")
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, what="tanh")
    # gelu: bit for bit with the compiled lowering, forward and backward
    # (bf16(0.5x * bf16(erfc(-0.70703125 x))) with XLA's f32 erfc; the
    # vjp rounds after every op).  ``F.gelu``, which rounds once, differs
    # from it on 25.6% of these inputs forward and 53.0% backward
    # (measured; held below to more than a fifth)
    fwd, vjp = _jit_lowering("gelu", {}, ("X",), "Out")
    want = np.asarray(fwd(jx)).astype(np.float32)
    tx.requires_grad_()
    got = nn_ops.activation(tx, "gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    dy = rng.randn(4000).astype(np.float32)
    got.backward(torch.tensor(dy).bfloat16())
    (wdx,) = vjp(jx, jnp.asarray(dy, jnp.bfloat16))
    wdx = np.asarray(wdx).astype(np.float32)
    np.testing.assert_array_equal(tx.grad.float().numpy(), wdx)
    one = tx.detach().clone().requires_grad_()
    once = torch.nn.functional.gelu(one)
    once.backward(torch.tensor(dy).bfloat16())
    assert np.mean(once.detach().float().numpy() != want) > 0.2
    assert np.mean(one.grad.float().numpy() != wdx) > 0.2


def test_dropout_and_gelu_fp16_match_jax():
    """fp16 dropout scales by the factor rounded to fp16 (1/0.9 ->
    1.111328125); the fp16 gelu equals the compiled lowering bit for bit,
    forward and backward, on 4,000 inputs at two scales.  ``F.gelu``
    rounded once differs from it on 31.8% of the unit-scale inputs
    forward and 52.1% backward (measured; held below to more than a
    fifth), so the port rounds where XLA does (``ops/gelu.py``)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4000).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.float16), torch.tensor(x).half()
    got = nn_ops.dropout(tx, 0.1, implementation="upscale_in_train",
                         generator=torch.Generator().manual_seed(0))
    kept = got != 0
    factor = torch.tensor(1.0 / 0.9).half()
    assert float(factor) == 1.111328125 and got.dtype == torch.float16
    assert torch.equal(got[kept], (tx * factor)[kept])
    jd = _jop("dropout", {"X": [jx]}, {"dropout_prob": 0.1,
                                       "dropout_implementation":
                                       "upscale_in_train"},
              {"Out": 1, "Mask": 1})
    jk = jd["Mask"][0].astype(bool)
    np.testing.assert_array_equal(jd["Out"][0][jk].astype(np.float32),
                                  (tx * factor).float().numpy()[jk])
    fwd, vjp = _jit_lowering("gelu", {}, ("X",), "Out")
    dy = rng.randn(4000).astype(np.float32)
    for scale in (1.0, 4.0):
        jx = jnp.asarray(x * scale, jnp.float16)
        tx = torch.tensor(x * scale).half().requires_grad_()
        want = np.asarray(fwd(jx)).astype(np.float32)
        got = nn_ops.activation(tx, "gelu")
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
        got.backward(torch.tensor(dy).half())
        (wdx,) = vjp(jx, jnp.asarray(dy, jnp.float16))
        wdx = np.asarray(wdx).astype(np.float32)
        np.testing.assert_array_equal(tx.grad.float().numpy(), wdx)
        if scale == 1.0:
            one = tx.detach().float().requires_grad_()
            once = torch.nn.functional.gelu(one)
            once.backward(torch.tensor(dy).half().float())
            assert np.mean(once.detach().half().float().numpy()
                           != want) > 0.2
            assert np.mean(one.grad.half().float().numpy() != wdx) > 0.2


# ==========================================================================
# O2: master weights
# ==========================================================================
@pytest.mark.parametrize("amp_dtype", AMP_DTYPES)
def test_o2_master_is_seeded_from_the_bf16_parameter(amp_dtype):
    tdt = getattr(torch, amp_dtype)
    m = LayerNorm(64, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, 64))
    f32 = m.weight.detach().clone()
    _cast_params_resident(m, amp_dtype)
    assert all(p.dtype == tdt for p in m.parameters())
    opt = AdamOptimizer(1e-3, parameter_list=m.parameters())
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.minimize(None)
    st = opt._state[id(m.weight)]
    # the master started at the bf16 value, not at the f32 one (Adam's
    # first step moves every element by -lr * sign(g), here -1e-3)
    start = st["master"] + 1e-3
    assert torch.allclose(start, f32.to(tdt).float(), rtol=0, atol=1e-6)
    assert not torch.allclose(start, f32, rtol=0, atol=1e-6)
    assert st["master"].dtype == st["m1"].dtype == st["m2"].dtype == \
        torch.float32
    assert torch.equal(m.weight.detach(), st["master"].to(tdt))


@pytest.mark.parametrize("amp_dtype", AMP_DTYPES)
def test_adam_on_bf16_params_matches_jax_eager_update(amp_dtype):
    jdt, tdt = getattr(jnp, amp_dtype), getattr(torch, amp_dtype)
    rng = np.random.RandomState(4)
    shapes = [(7, 5), (5,)]
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    lr = 1e-2
    jopt = fluid.optimizer.AdamOptimizer(lr, beta1=0.8, beta2=0.99,
                                         epsilon=1e-6)

    class _P:                   # what _eager_update reads and writes
        def __init__(self, v):
            self._value = jnp.asarray(v, jdt)

    jps = [_P(v) for v in vals]
    jstates = [{} for _ in vals]
    tps = [torch.nn.Parameter(torch.tensor(v).to(tdt)) for v in vals]
    topt = AdamOptimizer(lr, beta1=0.8, beta2=0.99, epsilon=1e-6,
                         parameter_list=tps)
    for _ in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        for p, g, st in zip(jps, grads, jstates):
            jopt._eager_update(p, jnp.asarray(g, jdt), st,
                               jnp.asarray([lr], jnp.float32))
        for p, g in zip(tps, grads):
            p.grad = torch.tensor(g).to(tdt)
        topt.minimize(None)
        for jp, tp, st in zip(jps, tps, jstates):
            tst = topt._state[id(tp)]
            np.testing.assert_allclose(tst["master"].numpy(),
                                       np.asarray(st["master"]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(tst["m2"].numpy(),
                                       np.asarray(st["m2"]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_array_equal(
                tp.detach().float().numpy(),
                np.asarray(jp._value).astype(np.float32))


# ==========================================================================
# the whole model
# ==========================================================================
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# per-step losses, 3 AdamOptimizer(1e-3) steps: bf16 roundings of the two
# frameworks' summation orders (measured on the CPU: 2.3e-5 at O1, 6.5e-5
# at O2, at step 3)
AMP_LOSS_RTOL = 1e-4
STEPS, LR = 3, 1e-3


def _batch(seed=1, b=2, s=128, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype("int64")
    labels = rng.randint(0, vocab, (b, s)).astype("int64")
    mask = np.ones((b, s), np.float32)
    mask[1, s - 28:] = 0.0
    return ids, labels, mask


def _loss_fn(m, i, l, a):
    return m(i, l, attention_mask=a)


@pytest.mark.parametrize("amp_dtype", AMP_DTYPES)
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_bert_amp_trajectory_matches_jax(level, amp_dtype, monkeypatch):
    """3 ``jit_train_step`` steps under AMP from the same weights: the
    losses within ``AMP_LOSS_RTOL``; the parameters: Adam moves each
    element by about lr per step whatever its gradient's size, so an
    element whose gradient is rounding noise (the key biases, whose true
    gradient is 0) may step the other way: every element within
    2 lr x steps, and at most 3% of them (measured: bf16 0.1% at O1,
    1.1% at O2; fp16 0.13% and 1.1%) further apart than 1e-4 + 2 ulps of
    the AMP dtype of their value; fp16 losses within 6.1e-7 relative.

    fp16 runs with no loss scale, as in JAX, and JAX's attention runs
    through its Pallas flash kernels (interpret mode), the TPU path whose
    roundings the port's kernels take: below seq 1024 JAX's CPU takes its
    dense reference, which keeps dS in f32, while the kernels round dS to
    fp16.  At this size's initialisation dS lies below fp16's smallest
    normal, and that rounding alone moves the sign of 82% of the query
    weights' first updates (measured against the dense path)."""
    if amp_dtype == "float16":
        monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("PT_FLASH_ATTENTION", "1")
    ids, labels, mask = _batch()
    with jdy.guard():
        jm = JB.BertForPretraining(JB.BertConfig(**TINY))
        tm = TB.BertForPretraining(TB.BertConfig(**TINY), device="cpu")
        load_state_dict_numpy(tm, {k: np.array(v.value())
                                   for k, v in jm.state_dict().items()})
        jstep = jdy.jit_train_step(
            jm, fluid.optimizer.AdamOptimizer(
                LR, parameter_list=jm.parameters()), _loss_fn, amp=True,
            amp_dtype=amp_dtype, amp_level=level)
        tstep = jit_train_step(
            tm, AdamOptimizer(LR, parameter_list=tm.parameters()), _loss_fn,
            amp=True, amp_dtype=amp_dtype, amp_level=level)
        jl, tl = [], []
        for _ in range(STEPS):
            jl.append(float(np.asarray(jstep(ids, labels, mask).value())))
            tl.append(float(tstep(ids, labels, mask)))
        jp = {n: np.asarray(p.value()).astype(np.float32)
              for n, p in jm.named_parameters()}
        tp = {n: p.detach() for n, p in tm.named_parameters()}
    np.testing.assert_allclose(tl, jl, rtol=AMP_LOSS_RTOL)
    assert tl[-1] < tl[0]
    want_dt = getattr(torch, amp_dtype) if level == "O2" else torch.float32
    n = far = 0
    for name, w in jp.items():
        assert tp[name].dtype == want_dt, name
        d = np.abs(tp[name].float().numpy() - w)
        assert float(d.max()) <= 2 * LR * STEPS, name
        n += d.size
        far += int((d > 1e-4 + 2 * ULP[amp_dtype] * np.abs(w)).sum())
    assert far <= 0.03 * n, far / n


@pytest.mark.parametrize("amp_dtype", AMP_DTYPES)
def test_o2_model_loads_bf16_weights_and_gives_its_state_dict(amp_dtype):
    """JAX's O2 weights (bf16 arrays, ``ml_dtypes`` in numpy, or fp16
    ones) load into an O2 port model bit for bit, ``state_dict()``
    returns them, and they load back into a JAX O2 model unchanged."""
    with jdy.guard():
        jm = JB.BertForPretraining(JB.BertConfig(**TINY))
        from paddle_tpu.dygraph.jit import _cast_params_resident as jcast
        jcast(jm, amp_dtype)
        arrays = {k: np.asarray(v.value())
                  for k, v in jm.state_dict().items()}
    assert arrays["bert.word_emb.weight"].dtype.name == amp_dtype
    tm = TB.BertForPretraining(TB.BertConfig(**TINY), device="cpu")
    _cast_params_resident(tm, amp_dtype)
    load_state_dict_numpy(tm, arrays)
    sd = tm.state_dict()
    if amp_dtype == "float16":      # and back into JAX, both ways
        with jdy.guard():
            jm2 = JB.BertForPretraining(JB.BertConfig(**TINY))
            jcast(jm2, amp_dtype)
            jm2.set_dict({k: v.numpy() for k, v in sd.items()})
            for k, v in jm2.state_dict().items():
                np.testing.assert_array_equal(np.asarray(v.value()),
                                              arrays[k])
    for name, a in arrays.items():
        assert sd[name].dtype == getattr(torch, amp_dtype)
        np.testing.assert_array_equal(sd[name].float().numpy(),
                                      a.astype(np.float32))
    # and an f32 port model takes them as their exact upcasts
    f32 = TB.BertForPretraining(TB.BertConfig(**TINY), device="cpu")
    f32.set_dict(arrays)
    assert torch.equal(f32.bert.word_emb.weight.detach(),
                       sd["bert.word_emb.weight"].float())


def test_embedding_is_white_only_under_o2():
    emb = Embedding([10, 4], device="cpu")
    ids = torch.tensor([[1, 2, 3]])
    with amp_guard():
        assert emb(ids).dtype == torch.float32
    with amp_guard(level="O2"):
        assert emb(ids).dtype == torch.bfloat16
