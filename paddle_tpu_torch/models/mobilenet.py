"""MobileNetV3 (small and large) — static-graph builder (counterpart of
``paddle_tpu/models/mobilenet.py``; PaddleClas-style).

A hard-swish stem, inverted-residual bottlenecks with depthwise convs
(``depthwise_conv2d``: cuDNN's grouped convolution) and squeeze-excite
blocks gated by a hard sigmoid, then a hard-swish head.  Built with the
port's ``fluid.layers``, so the program equals the JAX package's op for
op.  With ``FLAGS_cuda_fuse`` on (the default on a CUDA device) the
relu bottlenecks' expand and depthwise chains (conv -> BN -> relu) run
as ``fused_conv_bn_act``, whose epilogue is the hand-written kernels 7-8
(``ops/bn_act.py``), and each squeeze-excite block's first fc (mul ->
bias -> relu) runs as ``fused_matmul_bias_act``, kernel 9
(``ops/matmul_epilogue.py``); the hard-swish chains and the projections
keep a plain ``batch_norm``, as in JAX.
"""
from __future__ import annotations

from .. import layers
from ..nn.functional import hardsigmoid as _hardsigmoid

__all__ = ["build_mobilenet_v3"]


def _hard_sigmoid(x):
    return _hardsigmoid(x, slope=0.2, offset=0.5)


def _act(x, act):
    if act == "relu":
        return layers.relu(x)
    if act == "hswish":
        return layers.hard_swish(x)
    return x


def _conv_bn(x, filters, ksize, stride=1, groups=1, act=None, is_test=False):
    y = layers.conv2d(x, num_filters=filters, filter_size=ksize,
                      stride=stride, padding=(ksize - 1) // 2,
                      groups=groups, bias_attr=False)
    y = layers.batch_norm(y, is_test=is_test)
    return _act(y, act)


def _se_block(x, reduction=4):
    ch = int(x.shape[1])
    pooled = layers.pool2d(x, pool_type="avg", global_pooling=True)
    sq = layers.fc(pooled, ch // reduction, act="relu")
    ex = layers.fc(sq, ch)
    gate = _hard_sigmoid(ex)
    gate = layers.reshape(gate, [-1, ch, 1, 1])
    return layers.elementwise_mul(x, gate)


def _bneck(x, ksize, expand, out_ch, use_se, act, stride, is_test=False):
    in_ch = int(x.shape[1])
    y = _conv_bn(x, expand, 1, act=act, is_test=is_test)          # expand
    y = _conv_bn(y, expand, ksize, stride=stride, groups=expand,  # depthwise
                 act=act, is_test=is_test)
    if use_se:
        y = _se_block(y)
    y = _conv_bn(y, out_ch, 1, act=None, is_test=is_test)         # project
    if stride == 1 and in_ch == out_ch:
        y = layers.elementwise_add(x, y)
    return y


# (ksize, expand, out, SE, act, stride) — the published V3 configs
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]
_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]


def build_mobilenet_v3(img, label=None, class_num=1000, scale="small",
                       is_test=False):
    """Returns (loss, acc1, logits) with label, else logits."""
    cfg, last_exp, last_ch = ((_SMALL, 576, 1024) if scale == "small"
                              else (_LARGE, 960, 1280))
    x = _conv_bn(img, 16, 3, stride=2, act="hswish", is_test=is_test)
    for (k, e, o, se, act, s) in cfg:
        x = _bneck(x, k, e, o, se, act, s, is_test=is_test)
    x = _conv_bn(x, last_exp, 1, act="hswish", is_test=is_test)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    x = layers.fc(x, last_ch)
    x = layers.hard_swish(x)
    logits = layers.fc(x, class_num)
    if label is None:
        return logits
    loss = layers.softmax_with_cross_entropy(logits, label)
    loss = layers.mean(loss)
    acc1 = layers.accuracy(layers.softmax(logits), label, k=1)
    return loss, acc1, logits
