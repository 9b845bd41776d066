"""PyTorch port, the ``fluid.layers`` names that emit the activation,
norm, pad, interpolation and loss ops, and every name of
``paddle.nn.functional``, against the JAX package: each is called with
the same arguments in both packages, in a fresh program under a fresh
name generator, and the two programs must serialize alike, op for op and
attr for attr (startup programs too, for the layers that make
parameters).  No number is computed, so no tolerance is stated."""
import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.nn.functional as jF
from paddle_tpu.framework import unique_name as junique

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.framework import unique_name as tunique

PKGS = ((jfluid, jF, junique), (tfluid, tF, tunique))


def _desc(program):
    d = json.loads(program.serialize_to_string())
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _build(fluid, F, unique, body):
    prev = unique.switch()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 4, 6, 6], "float32")
            y = fluid.data("y", [-1, 4, 6, 6], "float32")
            p = fluid.data("p", [-1, 5], "float32")
            lbl = fluid.data("lbl", [-1, 1], "int64")
            body(fluid.layers, F, x, y, p, lbl)
    finally:
        unique.switch(prev)
    return _desc(main), _desc(startup)


LAYERS = {
    "conv2d_transpose": lambda L, F, x, y, p, l: L.conv2d_transpose(
        x, 6, filter_size=3, stride=2, padding=1, act="relu"),
    "adaptive_pool2d": lambda L, F, x, y, p, l: L.adaptive_pool2d(
        x, [2, 3], pool_type="avg"),
    "relu6": lambda L, F, x, y, p, l: L.relu6(x, threshold=5.0),
    "leaky_relu": lambda L, F, x, y, p, l: L.leaky_relu(x, alpha=0.1),
    "swish": lambda L, F, x, y, p, l: L.swish(x, beta=1.5),
    "prelu": lambda L, F, x, y, p, l: [L.prelu(x, m) for m in
                                       ("all", "channel", "element")],
    "sigmoid_cross_entropy_with_logits": lambda L, F, x, y, p, l:
        L.sigmoid_cross_entropy_with_logits(x, y, ignore_index=-1,
                                            normalize=True),
    "mse_loss": lambda L, F, x, y, p, l: L.mse_loss(x, y),
    "pad2d": lambda L, F, x, y, p, l: L.pad2d(x, [1, 0, 2, 1],
                                              mode="reflect"),
    "argmax": lambda L, F, x, y, p, l: L.argmax(x, axis=1),
    "argmin": lambda L, F, x, y, p, l: L.argmin(x, axis=-1),
    "argsort": lambda L, F, x, y, p, l: L.argsort(x, axis=1,
                                                  descending=True),
    "resize_bilinear": lambda L, F, x, y, p, l: L.resize_bilinear(
        x, out_shape=[9, 11]),
    "resize_nearest": lambda L, F, x, y, p, l: L.resize_nearest(
        x, scale=2.0),
    "unary": lambda L, F, x, y, p, l: [getattr(L, n)(x) for n in (
        "abs", "log", "logsigmoid", "round", "sin", "softplus", "softsign",
        "sqrt", "reciprocal", "sign")],
    "huber_loss": lambda L, F, x, y, p, l: L.huber_loss(x, y, 1.5),
    "kldiv_loss": lambda L, F, x, y, p, l: L.kldiv_loss(x, y, "batchmean"),
    "label_smooth": lambda L, F, x, y, p, l: L.label_smooth(p, epsilon=0.2),
    "log_loss": lambda L, F, x, y, p, l: L.log_loss(x, y, epsilon=1e-3),
    "smooth_l1": lambda L, F, x, y, p, l: L.smooth_l1(x, y, sigma=2.0),
    "square_error_cost": lambda L, F, x, y, p, l: L.square_error_cost(x, y),
    "pad": lambda L, F, x, y, p, l: L.pad(p, [0, 1, 2, 0], 0.5),
    "increment": lambda L, F, x, y, p, l: L.increment(p, 2.0,
                                                      in_place=False),
    "l2_normalize": lambda L, F, x, y, p, l: L.l2_normalize(x, axis=1),
    "cos_sim": lambda L, F, x, y, p, l: L.cos_sim(p, p),
    "mean_iou": lambda L, F, x, y, p, l: L.mean_iou(
        L.argmax(p, axis=1), l, 5),
}

FUNCTIONAL = {
    "activations": lambda L, F, x, y, p, l: [getattr(F, n)(x) for n in (
        "relu", "relu6", "sigmoid", "tanh", "softmax", "log_softmax",
        "leaky_relu", "gelu", "swish", "hardswish", "softplus", "softsign",
        "elu", "silu", "hardsigmoid")] + [F.prelu(x, "channel")],
    "blocks": lambda L, F, x, y, p, l: [
        F.linear(p, 3), F.conv2d(x, 2, 3), F.conv2d_transpose(
            x, 2, filter_size=2), F.embedding(l, [10, 3]),
        F.dropout(x, 0.5), F.batch_norm(x), F.layer_norm(x),
        F.one_hot(l, 5), F.pad(p, [1, 0, 0, 1]), F.interpolate(
            x, out_shape=[3, 3]), F.upsample(x, out_shape=[12, 12])],
    "pools": lambda L, F, x, y, p, l: [
        F.avg_pool2d(x, 2), F.max_pool2d(x, 3, 2, 1),
        F.adaptive_avg_pool2d(x, 3), F.adaptive_max_pool2d(x, [2, 1])],
    "losses": lambda L, F, x, y, p, l: [
        F.cross_entropy(p, l), F.square_error_cost(x, y), F.mse_loss(x, y),
        F.kl_div(x, y), F.log_loss(x, y), F.smooth_l1_loss(x, y),
        F.binary_cross_entropy_with_logits(x, y), F.label_smooth(p),
        F.normalize(x), F.l1_loss(x, y), F.l1_loss(x, y, "sum"),
        F.l1_loss(x, y, "none"), F.nll_loss(p, l)],
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_emits_the_jax_program(name):
    (jm, js), (tm, ts) = (_build(f, F, u, LAYERS[name]) for f, F, u in PKGS)
    assert tm == jm
    assert ts == js


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_emits_the_jax_program(name):
    (jm, js), (tm, ts) = (_build(f, F, u, FUNCTIONAL[name])
                          for f, F, u in PKGS)
    assert tm == jm
    assert ts == js


def test_no_functional_name_raises():
    """The 32 names that raised before, with the ones the port had, are
    all JAX's public callables, and each builds without raising
    (:func:`test_functional_emits_the_jax_program` calls every one)."""
    public = sorted(n for n in dir(jF) if not n.startswith("_")
                    and callable(getattr(jF, n))
                    and getattr(getattr(jF, n), "__module__", "").startswith(
                        ("paddle_tpu.nn", "paddle_tpu.layers")))
    called = set()
    for body in FUNCTIONAL.values():
        for c in body.__code__.co_names + body.__code__.co_consts:
            called.update(c if isinstance(c, tuple) else (c,))
    for n in public:
        assert hasattr(tF, n), n
        assert n in called, n


def test_layers_run_on_the_cpu():
    """The port's programs of the layer cases run (on the CPU, random
    feeds): every op lowers."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(2, 4, 6, 6).astype(np.float32) + 0.1,
            "y": rng.rand(2, 4, 6, 6).astype(np.float32),
            "p": rng.rand(2, 5).astype(np.float32) + 0.1,
            "lbl": rng.randint(0, 5, (2, 1)).astype(np.int64)}
    for name, body in sorted(LAYERS.items()) + sorted(FUNCTIONAL.items()):
        prev = tunique.switch()
        try:
            main, startup = tfluid.Program(), tfluid.Program()
            with tfluid.program_guard(main, startup):
                x = tfluid.data("x", [-1, 4, 6, 6], "float32")
                y = tfluid.data("y", [-1, 4, 6, 6], "float32")
                p = tfluid.data("p", [-1, 5], "float32")
                lbl = tfluid.data("lbl", [-1, 1], "int64")
                out = body(tfluid.layers, tF, x, y, p, lbl)
        finally:
            tunique.switch(prev)
        outs = out if isinstance(out, (list, tuple)) else [out]
        flat = []
        for o in outs:
            flat.extend(o if isinstance(o, (list, tuple)) else [o])
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        got = exe.run(main, feed=feed, fetch_list=[o.name for o in flat])
        assert len(got) == len(flat), name
