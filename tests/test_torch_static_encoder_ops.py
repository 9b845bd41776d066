"""PyTorch port, the static encoder's ops beyond their one case in
``test_torch_static_ops.py``: ``fused_multihead_attention`` and its grad
against the JAX package's op, the static ``gelu`` and ``layer_norm`` on
bf16 / fp16 inputs, and the dropout seed.

``fused_multihead_attention`` runs as the JAX package's own tests run it
on the CPU: its dense ``attention_reference`` path (the Pallas kernels
engage only on a TPU), with the port's plain flash versions on the
other side, at s 64 (the fused backward's route on the card, s <= 512)
and s 520 (the split pair's); the padding bias's gradient is zeros in
the port and on JAX's kernel path, which
:func:`test_padding_bias_matches_jax_kernel_path` runs in interpret
mode.  Tolerance rtol 1e-4 / atol 1e-4: the products sum in another
order (XLA against oneDNN).  Parity runs at ``dropout_rate`` 0: the two
packages' masks differ by design (only the keep rate is contractual).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.framework.core as tcore
import paddle_tpu_torch.ops.registry as treg
from paddle_tpu_torch.ops.flash_attention import (attention_reference,
                                                  seeded_keep)

from test_torch_static_ops import SUMS, _check, _port, _r

GRAD = "@GRAD"


def _mha_ins(b, h, s, d, bias_kind, seed=0):
    ins = {"Q": [("q", _r(seed, b, h, s, d))],
           "K": [("k", _r(seed + 1, b, h, s, d))],
           "V": [("v", _r(seed + 2, b, h, s, d))]}
    lens = np.linspace(s, max(s // 3, 1), b).astype(int)
    pad = np.where(np.arange(s)[None, :] < lens[:, None], 0.0,
                   -10000.0).astype(np.float32)
    if bias_kind == "padding-4d":
        ins["BiasQK"] = [("bias", pad.reshape(b, 1, 1, s))]
    elif bias_kind == "padding-2d":
        ins["BiasQK"] = [("bias", pad)]
    elif bias_kind == "full":
        ins["BiasQK"] = [("bias", _r(seed + 3, b, 1, s, s))]
    return ins


def _attrs(causal, scale=0.0, rate=0.0):
    return {"scale": scale, "causal": causal, "dropout_rate": rate}


@pytest.mark.parametrize("seq", [64, 520])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("bias_kind",
                         ["none", "padding-4d", "padding-2d", "full"])
def test_fused_mha_matches_jax(bias_kind, causal, seq):
    b, h, d = (2, 3, 16) if seq <= 512 else (1, 2, 8)
    skip = ("lse",) if bias_kind in ("none", "full") else ("lse",
                                                           "bias@GRAD")
    _check("fused_multihead_attention", _mha_ins(b, h, seq, d, bias_kind),
           {"Out": ["o"], "Lse": ["lse"]}, _attrs(causal),
           cot_of=["o"], tol=SUMS, skip=skip)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padding_bias_matches_jax_kernel_path(monkeypatch, causal):
    """JAX's op with its Pallas kernels engaged (interpret mode, s 128):
    its Lse is the kernels' 4-D residual, its grad runs the backward
    kernel from it and gives the padding bias zeros, as the port's does
    always."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PT_FLASH_ATTENTION", "1")
    j, t = _check("fused_multihead_attention",
                  _mha_ins(2, 2, 128, 16, "padding-4d", seed=4),
                  {"Out": ["o"], "Lse": ["lse"]}, _attrs(causal, 0.25),
                  cot_of=["o"], tol=SUMS, skip=("lse",))
    assert np.ndim(j["lse"]) == 4 and np.shape(t["lse"]) == (2, 2, 128)
    assert not np.any(j["bias@GRAD"]) and not np.any(t["bias@GRAD"])


def _program(ins, outs, attrs):
    """A port program holding the op, and its grad desc."""
    blk = tcore.Program().global_block()
    op = blk.append_op("fused_multihead_attention",
                       inputs={s: [n for n, _ in v] for s, v in ins.items()},
                       outputs=outs, attrs=attrs)
    desc, = treg.make_grad_ops(op)
    for names in (list(op.inputs.values()) + list(op.outputs.values())
                  + list(desc["inputs"].values())
                  + list(desc["outputs"].values())):
        for n in names:
            if not blk.has_var(n):
                blk.create_var(name=n)
    return blk, op, desc


def _forward(ins, outs, attrs, generator=None):
    blk, op, _ = _program(ins, outs, attrs)
    env = {n: torch.from_numpy(np.array(a)) for items in ins.values()
           for n, a in items}
    treg.run_op(op, env, blk, generator)
    return env


def _grads(ins, outs, attrs, env, slots):
    """dQ, dK, dV (and dBiasQK) of the grad op given only ``slots`` of
    its desc's inputs, over ``env``."""
    blk, _, desc = _program(ins, outs, attrs)
    gop = blk.append_op(desc["type"], inputs={
        s: v for s, v in desc["inputs"].items() if s in slots},
        outputs=desc["outputs"], attrs=desc["attrs"])
    env = dict(env)
    treg.run_op(gop, env, blk)
    return [env[n + GRAD] for n in ("q", "k", "v", "bias")]


@pytest.mark.parametrize("lse", ["sentinel", "absent"])
def test_grad_without_a_saved_lse_runs_the_forward(lse):
    """The grad's rule: a 3-D Lse is the forward's; a (1,) sentinel (the
    dense path's, or JAX's where its kernel did not engage) or no Lse
    at all (the op fuse_multihead_attention_pass builds) makes it run
    the forward for lse first.  Either way the gradients are the saved
    lse's, bit for bit."""
    ins = _mha_ins(2, 3, 32, 8, "padding-4d")
    outs = {"Out": ["o"], "Lse": ["lse"]}
    env = _forward(ins, outs, _attrs(False))
    assert env["lse"].shape == (2, 3, 32)
    env["o@GRAD"] = torch.from_numpy(_r(9, 2, 3, 32, 8))
    slots = ("Q", "K", "V", "BiasQK", "Out" + GRAD)
    want = _grads(ins, outs, _attrs(False), env, slots + ("Lse", "Out"))
    if lse == "sentinel":
        env["lse"] = torch.zeros((1,), dtype=torch.float32)
        slots += ("Lse", "Out")
    for a, b in zip(_grads(ins, outs, _attrs(False), env, slots), want):
        assert torch.equal(a, b)


def test_dropout_seed_and_one_mask():
    """With dropout the op draws its Seed from the executor's generator
    (a float32 (1,) integer below 2**23, a new one each call); Out and
    the grads are the dense attention's under the one mask that seed
    keys, in the forward and the backward."""
    ins = _mha_ins(2, 2, 24, 8, "padding-4d", seed=3)
    outs = {"Out": ["o"], "Seed": ["seed"], "Lse": ["lse"]}
    attrs = _attrs(False, 0.3, 0.25)
    gen = torch.Generator().manual_seed(5)
    env = _forward(ins, outs, attrs, gen)
    seed = env["seed"]
    assert seed.dtype == torch.float32 and seed.shape == (1,)
    assert 0 <= float(seed) < 2 ** 23 and float(seed) == int(seed)
    assert float(_forward(ins, outs, attrs, gen)["seed"]) != float(seed)
    q, k, v, bias = (env[n].clone().requires_grad_(True)
                     for n in ("q", "k", "v", "bias"))
    keep = seeded_keep((2, 2, 24, 24), 0.25, int(seed), q.device)
    assert abs(keep.float().mean().item() - 0.75) < 0.05
    ref = attention_reference(q, k, v, bias, False, 0.3, 0.25, keep=keep)
    torch.testing.assert_close(env["o"], ref.detach(), rtol=1e-5, atol=1e-5)
    env["o@GRAD"] = torch.from_numpy(_r(9, 2, 2, 24, 8))
    want = torch.autograd.grad(ref, (q, k, v), env["o@GRAD"])
    got = _grads(ins, outs, attrs, env, ("Q", "K", "V", "BiasQK", "Seed",
                                         "Lse", "Out", "Out" + GRAD))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert not got[3].any()


def test_shape_inference_of_the_outputs():
    """Compile-time shapes: Out is Q's, Lse the port's (b, h, s) f32 (JAX
    declares its CPU sentinel's (1,); ROADMAP.md Queue 3), Seed (1,)
    f32."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework import unique_name

    with unique_name.guard():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            q = fluid.data("q", [-1, 4, 32, 16])
            out = fluid.layers.fused_multihead_attention(
                q, q, q, dropout_rate=0.1)
    op, = main.global_block().ops
    blk = main.global_block()
    assert tuple(out.shape) == (-1, 4, 32, 16)
    lse = blk.var(op.output("Lse")[0])
    seed = blk.var(op.output("Seed")[0])
    assert tuple(lse.shape) == (-1, 4, 32) and tuple(seed.shape) == (1,)
    assert str(seed.dtype).lower().endswith(("fp32", "5", "float32"))


def _bits(x):
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_static_gelu_lowp_matches_jax_jit(dtype):
    """The static gelu and gelu_grad ops on 16-bit inputs: the gelu_lowp
    plain versions, equal to ``jax.jit`` of JAX's lowering (``jax.nn.gelu``
    exact) and its vjp, bit for bit."""
    rng = np.random.RandomState(0)
    x32 = np.concatenate([rng.randn(3000) * 3, rng.randn(1000) * 0.01,
                          [0.0, -1.71875, 5.5, -6.0]]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
    tdt = getattr(torch, dtype)
    x = jnp.asarray(x32).astype(jdt)
    dy = jnp.asarray(rng.randn(x32.size).astype(np.float32)).astype(jdt)
    f = lambda a: jax.nn.gelu(a, approximate=False)  # noqa: E731
    jy = jax.jit(f)(x)
    jdx = jax.jit(lambda a, g: jax.vjp(f, a)[1](g)[0])(x, dy)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt)
    tdy = torch.from_numpy(np.asarray(dy.astype(jnp.float32))).to(tdt)
    ins = {"X": [tx]}
    y = treg.eager_call("gelu", ins, {"approximate": False},
                        {"Out": 1})["Out"][0]
    dx = treg.eager_call("gelu_grad", {"X": [tx], "Out@GRAD": [tdy]},
                         {"approximate": False},
                         {"X@GRAD": 1})["X@GRAD"][0]
    assert y.dtype == tdt and dx.dtype == tdt
    np.testing.assert_array_equal(
        y.view(torch.int16).numpy().view(np.uint16), _bits(jy))
    np.testing.assert_array_equal(
        dx.view(torch.int16).numpy().view(np.uint16), _bits(jdx))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_static_layer_norm_lowp_matches_jax(dtype):
    """The static layer_norm on a 16-bit x (f32 Scale and Bias, as a
    decorated program holds them): JAX's lowering under ``jax.jit``
    against the port's op and its grad, within one ulp of the dtype
    (of each tensor's largest magnitude) for Y and dX and two for the
    f32-summed dScale and dBias (XLA's CPU rounds partial sums)."""
    import paddle_tpu.ops.registry as jreg
    import paddle_tpu.framework.core as jcore

    rng = np.random.RandomState(1)
    x32 = (rng.randn(4, 6, 32) * 2 + 1).astype(np.float32)
    s32 = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b32 = rng.randn(32).astype(np.float32)
    g32 = rng.randn(4, 6, 32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
    tdt = getattr(torch, dtype)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10
    attrs = {"begin_norm_axis": 2, "epsilon": 1e-5}

    def jln(x, s, b):
        prog = jcore.Program()
        blk = prog.global_block()
        for n in ("x", "s", "b", "y", "m", "v"):
            blk.create_var(name=n)
        op = blk.append_op("layer_norm", inputs={"X": ["x"], "Scale": ["s"],
                                                 "Bias": ["b"]},
                           outputs={"Y": ["y"], "Mean": ["m"],
                                    "Variance": ["v"]}, attrs=attrs)
        env = {"x": x, "s": s, "b": b}
        jreg.run_op(op, env, blk)
        return env["y"]

    x = jnp.asarray(x32).astype(jdt)
    y, vjp = jax.vjp(jax.jit(jln), x, jnp.asarray(s32), jnp.asarray(b32))
    jdx, jds, jdb = vjp(jnp.asarray(g32).astype(jdt))
    tx = torch.from_numpy(x32).to(tdt)
    ts, tb = torch.from_numpy(s32), torch.from_numpy(b32)
    out = treg.eager_call("layer_norm", {"X": [tx], "Scale": [ts],
                                         "Bias": [tb]}, attrs,
                          {"Y": 1, "Mean": 1, "Variance": 1})
    tg = torch.from_numpy(g32).to(tdt)
    grads = treg.eager_call(
        "layer_norm_grad",
        {"X": [tx], "Scale": [ts], "Bias": [tb], "Y": out["Y"],
         "Mean": out["Mean"], "Variance": out["Variance"],
         "Y@GRAD": [tg]}, attrs,
        {"X@GRAD": 1, "Scale@GRAD": 1, "Bias@GRAD": 1})
    for got, want, ulps in ((out["Y"][0], y, 1), (grads["X@GRAD"][0], jdx, 1),
                            (grads["Scale@GRAD"][0], jds, 2),
                            (grads["Bias@GRAD"][0], jdb, 2)):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=0, atol=ulps * ulp * float(np.abs(want).max()))


def test_static_range_and_shape_read_the_host():
    """``range`` and ``shape`` on a program's values (float32 arange, as
    JAX's; int32 dims)."""
    r = _port("range", {"Start": [("a", np.array([0], np.int64))],
                        "End": [("e", np.array([5], np.int64))],
                        "Step": [("s", np.array([2], np.int64))]},
              {"Out": ["o"]}, {}, {}, int_slots=("Start", "End", "Step"))
    assert r["o"].dtype == np.float32 and r["o"].tolist() == [0, 2, 4]
