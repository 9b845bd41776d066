"""PyTorch port, MobileNetV3 static training against the JAX package on
the CPU.

* ``depthwise_conv2d`` forward and grad (kernel 3 and 5, stride 1 and 2,
  channel multiplier 1 and 2, NCHW and NHWC) through each package's
  ``registry.run_op``, as ``test_torch_static_ops.py`` runs every op;
  rtol / atol 1e-4, since the convolutions sum their products in another
  order (oneDNN against XLA);
* ``hard_swish`` and ``hard_sigmoid``, forward and grad, against
  ``jax.jit`` of the JAX lowering and its vjp: every finite bf16 and fp16
  input bit for bit (but for bf16 subnormals, which XLA's CPU flushes to
  zero and the port keeps), f32 random inputs bit for bit, and JAX's half
  gradient at each edge of the clip pinned by value;
* MobileNetV3 small and large at 32x32, batch 4, 10 classes, on the
  PaddleClas recipe (Momentum 0.9, ``L2Decay``, ``linear_lr_warmup`` into
  ``cosine_decay``), one step from JAX's startup scope copied into the
  port, the epilogue fusion on in both (JAX's Pallas kernels in
  interpret mode, the port's plain versions): the step-1 loss within
  rtol 1e-5 (measured 8.7e-7 small, 2.8e-6 large), and every state
  tensor after it within the envelope of a JAX twin whose images carry
  1e-6 relative noise (:func:`_state_errs`);
* small under ``decorate`` in bf16 and fp16: ``test_torch_mobilenet_amp.py``;
* the pass pipeline (the BatchNorm fusions, NHWC, the epilogue fusion)
  on one serialized program in each package: the same op list, with
  ``fused_conv_bn_act`` (``depthwise=True`` on the depthwise chains) and
  ``fused_matmul_bias_act`` where JAX's passes put them.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

import paddle_tpu as pt
import paddle_tpu.fluid as jfluid
import paddle_tpu.ops.registry as jreg
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.ir import get_pass as jget_pass
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.mobilenet import build_mobilenet_v3 as jbuild
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops.registry as treg
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.ir import get_pass as tget_pass
from paddle_tpu_torch.framework.scope import (Scope as TScope,
                                              load_numpy_state, numpy_state)
from paddle_tpu_torch.models.mobilenet import build_mobilenet_v3 as tbuild
from paddle_tpu_torch.utils import flags as tflags

from test_torch_static_ops import SUMS, _check, _r

JAX = (jfluid, junique, jbuild)
PORT = (tfluid, tunique, tbuild)
#: relative input noise of the envelope's JAX twin
NOISE = 1e-6
#: relative input noise of the AMP loss envelope's JAX twins
AMP_NOISE = (1e-6, 1e-5, 1e-4)
#: {scale: (fused_conv_bn_act, fused_matmul_bias_act)} in a train program
FUSED = {"small": (6, 9), "large": (12, 8)}


# ==========================================================================
# depthwise_conv2d
# ==========================================================================
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_depthwise_conv2d_matches_jax(k, stride, mult, fmt):
    c = 6
    x = _r(1, 2, c, 9, 9) if fmt == "NCHW" else _r(1, 2, 9, 9, c)
    attrs = dict(strides=[stride, stride], paddings=[(k - 1) // 2] * 2,
                 dilations=[1, 1], groups=c, data_format=fmt,
                 padding_algorithm="EXPLICIT")
    _check("depthwise_conv2d",
           {"Input": [("x", x)], "Filter": [("w", _r(2, c * mult, 1, k, k))]},
           {"Output": ["o"]}, attrs, cot_of=["o"], tol=SUMS)


# ==========================================================================
# the hard activations against jax.jit
# ==========================================================================
_ACTS = {
    "hard_swish": {"threshold": 6.0, "scale": 6.0, "offset": 3.0},
    "hard_sigmoid": {"slope": 0.2, "offset": 0.5},
}


class _JaxCtx:
    def __init__(self, x, attrs):
        self.x, self.attrs, self.op, self.out = x, attrs, None, None

    def in_(self, slot):
        return self.x

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_out(self, slot, v):
        self.out = v


class _PortCtx:
    def __init__(self, ins, attrs):
        self.ins, self.attrs, self.outs = ins, attrs, {}

    def in_(self, slot):
        return self.ins[slot]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_out(self, slot, v):
        self.outs[slot] = v


def _jax_act(op_type, attrs, x, g):
    """JAX's lowering of ``op_type`` and its vjp under ``jax.jit``."""
    def f(v):
        ctx = _JaxCtx(v, attrs)
        jreg.OPS[op_type].lower(ctx)
        return ctx.out

    y = jax.jit(f)(jnp.asarray(x))
    dx = jax.jit(lambda v, c: jax.vjp(f, v)[1](c)[0])(jnp.asarray(x),
                                                      jnp.asarray(g))
    return np.asarray(y), np.asarray(dx)


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_act(op_type, attrs, x, g):
    ctx = _PortCtx({"X": _as_torch(x)}, attrs)
    treg.OPS[op_type].lower(ctx)
    gctx = _PortCtx({"X": _as_torch(x), "Out@GRAD": _as_torch(g)}, attrs)
    treg.OPS[op_type + "_grad"].lower(gctx)
    return (ctx.outs["Out"].float().numpy(),
            gctx.outs["X@GRAD"].float().numpy())


def _every_input(dtype):
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = bits.view(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float16)
    return x[np.isfinite(x.astype(np.float32))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("op_type", sorted(_ACTS))
def test_hard_activation_matches_jax_jit(op_type, dtype):
    """Bit for bit against the compiled JAX lowering: the port rounds
    where XLA's CPU does (op by op in bf16, one fused multiply-add for
    ``slope * x + offset`` and for the grad's last sum in f32 and fp16,
    ``ops/math_ops.py`` ``_fma``).  XLA's CPU flushes bf16 subnormals to
    zero; the port keeps them, so bf16 inputs and JAX results below the
    smallest normal are left out."""
    attrs = _ACTS[op_type]
    if dtype == "float32":
        x = np.random.RandomState(0).randn(1 << 14).astype(np.float32) * 4
    else:
        x = _every_input(dtype)
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    g = g.astype(x.dtype)
    jy, jdx = _jax_act(op_type, attrs, x, g)
    ty, tdx = _port_act(op_type, attrs, x, g)
    jy, jdx = jy.astype(np.float32), jdx.astype(np.float32)
    keep = np.ones(x.shape, bool)
    if dtype == "bfloat16":
        tiny = np.finfo(np.float32).tiny
        for v in (x.astype(np.float32), ty, tdx):
            keep &= ~((v != 0) & (np.abs(v) < tiny))
        assert keep.mean() > 0.98
    for got, want in ((ty, jy), (tdx, jdx)):
        np.testing.assert_array_equal(got[keep], want[keep])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_half_gradient_at_the_clip_edges(dtype):
    """JAX's vjp of ``jnp.clip`` (a maximum, then a minimum) splits the
    gradient at a tie; ``F.hardswish``'s grad does not (it gives 0 at -3
    and 1 at 3).  At every edge, in every dtype, the port gives JAX's."""
    cases = (
        ("hard_swish", _ACTS["hard_swish"], [-3.0, 3.0, -4.0, 4.0],
         [-0.25, 1.25, 0.0, 1.0]),
        # slope 0.25: slope * x + offset is exact at the edges
        ("hard_sigmoid", {"slope": 0.25, "offset": 0.5}, [-2.0, 2.0, 3.0],
         [0.125, 0.125, 0.0]),
    )
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    for op_type, attrs, xs, want in cases:
        x = np.array(xs, np.float32).astype(np_dt)
        g = np.ones(len(xs), np.float32).astype(np_dt)
        _, jdx = _jax_act(op_type, attrs, x, g)
        _, tdx = _port_act(op_type, attrs, x, g)
        np.testing.assert_array_equal(jdx.astype(np.float32), want)
        np.testing.assert_array_equal(tdx, want)
    ref = torch.tensor([-3.0, 3.0], requires_grad=True)
    torch.nn.functional.hardswish(ref).sum().backward()
    assert ref.grad.tolist() == [0.0, 1.0]


# ==========================================================================
# the model
# ==========================================================================
def _build(pkg, scale, amp=None, image=32, classes=10, lr=0.1):
    """(main, startup, loss) of the PaddleClas-recipe train program from
    a fresh name generator: MobileNetV3 ``scale``, Momentum 0.9,
    ``L2Decay(2e-5)``, 3 warm-up steps into a cosine over 5 epochs of 10
    steps; ``amp``: the AMP dtype of ``decorate``."""
    fluid, un, build = pkg
    prev = un.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, _, _ = build(img, label, classes, scale)
            rate = fluid.layers.linear_lr_warmup(
                fluid.layers.cosine_decay(lr, 10, 5), 3, 0.0, lr)
            opt = fluid.optimizer.MomentumOptimizer(
                rate, 0.9, regularization=fluid.regularizer.L2Decay(2e-5))
            if amp is not None:
                opt = fluid.contrib.mixed_precision.decorate(
                    opt, use_fp16=amp == "float16")
            opt.minimize(loss)
    finally:
        un.switch(prev)
    return main, startup, loss


def _feed(batch=4, image=32, classes=10):
    rng = np.random.RandomState(0)
    return {"img": rng.rand(batch, 3, image, image).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


@pytest.fixture
def fused(monkeypatch):
    """The epilogue fusion on in both packages (JAX's Pallas kernels in
    interpret mode), NHWC off."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "1")
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_nhwc", "0")
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse", "1")
    monkeypatch.setitem(tflags._SET, "FLAGS_cuda_nhwc", "0")


def _state_errs(got, want):
    """Per tensor, the largest difference over the tensor's largest
    magnitude, floored at 1e-4 of the largest magnitude in the whole
    state.  The floor keeps tensors that are zero but for rounding out
    of the ratio: the bias and running mean of a BatchNorm whose input is
    another BatchNorm's affine output through a linear conv have an exact
    gradient and mean of 0 (measured magnitudes 1e-9 to 1e-6 against 17
    to 25 for the largest velocity), and JAX's own twin moves them by
    100-200% of themselves."""
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), floor) for n, w in want.items()}


def _step_both(scale, amp=None):
    """One step of each package from JAX's startup scope: (JAX loss, port
    loss, port state errors, JAX twin's errors, port plan op types)."""
    (jmain, jstart, jloss), (tmain, _, tloss) = [
        _build(pkg, scale, amp) for pkg in (JAX, PORT)]
    jexe = pt.Executor(pt.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.global_block().vars.values()
             if v.persistable]
    start = {n: np.asarray(jscope.get(n)) for n in names}
    tscope = TScope()
    load_numpy_state(tscope, start, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed()
    jl = float(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                   scope=jscope)[0]))
    tl = float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                        scope=tscope)[0])
    types = [o.type for o in list(texe._cache.values())[-1].ops]
    if amp is not None:
        # JAX's own step-1 loss from the same scope on noisy images
        moves = []
        for k, noise in enumerate(AMP_NOISE):
            twin = JScope()
            for n, v in start.items():
                twin.set(n, v.copy())
            img = feed["img"] * (1 + noise * np.random.RandomState(
                k + 1).randn(*feed["img"].shape))
            moved = float(np.asarray(jexe.run(
                jmain, feed={"img": img.astype(np.float32),
                             "label": feed["label"]},
                fetch_list=[jloss], scope=twin)[0]))
            moves.append(abs(moved - jl) / abs(jl))
        return jl, tl, None, moves, types
    want = {n: np.asarray(jscope.get(n)) for n in names}
    errs = _state_errs(numpy_state(tscope, names), want)
    twin = JScope()
    for n, v in start.items():
        twin.set(n, v.copy())
    noisy = feed["img"] * (1 + NOISE * np.random.RandomState(1).randn(
        *feed["img"].shape))
    jexe.run(jmain, feed={"img": noisy.astype(np.float32),
                          "label": feed["label"]},
             fetch_list=[jloss], scope=twin)
    noise = _state_errs({n: np.asarray(twin.get(n)) for n in names}, want)
    return jl, tl, errs, noise, types


@pytest.mark.parametrize("scale", ["small", "large"])
def test_training_step_matches_jax(fused, scale):
    jl, tl, errs, noise, types = _step_both(scale)
    assert abs(tl - jl) / abs(jl) <= 1e-5, (jl, tl)
    worst = max(errs, key=errs.get)
    bound = 2 * max(noise.values())
    assert errs[worst] <= bound, (worst, errs[worst], bound)
    n_conv, n_mm = FUSED[scale]
    assert types.count("fused_conv_bn_act") == n_conv
    assert types.count("fused_conv_bn_act_grad") == n_conv
    assert types.count("fused_matmul_bias_act") == n_mm
    assert types.count("fused_matmul_bias_act_grad") == n_mm
    assert types[0] == "increment"


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


@pytest.mark.parametrize("scale,amp,nhwc", [
    ("small", None, False), ("large", None, False),
    ("small", "bfloat16", True), ("large", "float16", True)])
def test_pass_pipeline_matches_jax(scale, amp, nhwc):
    """JAX's pipeline (the BatchNorm fusions, NHWC when on, the epilogue
    fusion) and the port's on one serialized train program: the same
    program, op for op, attr for attr."""
    main, _, loss = _build(JAX, scale, amp)
    text = main.serialize_to_string()
    names = ["fuse_bn_add_act_pass", "fuse_bn_act_pass"] + \
        (["layout_transform_pass"] if nhwc else []) + ["fuse_epilogue_pass"]
    results = []
    for fluid, get_pass in ((jfluid, jget_pass), (tfluid, tget_pass)):
        prog = fluid.Program.parse_from_string(text)
        for name in names:
            prog = get_pass(name, protected=(loss.name,)).apply(prog)
        results.append(_desc(prog))
    assert results[1] == results[0]
    ops = results[1]["blocks"][0]["ops"]
    types = [o["type"] for o in ops]
    n_conv, n_mm = FUSED[scale]
    fused_convs = [o for o in ops if o["type"] == "fused_conv_bn_act"]
    assert len(fused_convs) == n_conv
    assert sum(bool(o["attrs"].get("depthwise")) for o in fused_convs) == \
        n_conv // 2
    assert types.count("fused_matmul_bias_act") == n_mm
    assert "fused_batch_norm_act" not in types
