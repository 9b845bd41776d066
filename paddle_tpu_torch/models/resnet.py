"""ResNet family — static-graph builder (counterpart of
``paddle_tpu/models/resnet.py``; PaddleClas-style ResNet-vB, all depths).

Built with the port's ``fluid.layers``, so the program equals the JAX
package's op for op.  The executor runs it op by op; with
``FLAGS_cuda_fuse`` on (the default on a CUDA device) each conv -> BN
(-> add) -> relu chain runs as ``fused_conv_bn_act``, whose epilogue is
the hand-written kernels of ``ops/bn_act.py``.
"""
from __future__ import annotations

import math

from .. import layers
from ..initializer import UniformInitializer
from ..param_attr import ParamAttr


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False):
    conv = layers.conv2d(
        input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        bias_attr=False,
        param_attr=ParamAttr(name=name + "_weights") if name else None,
    )
    bn_name = ("bn_" + name) if name else None
    return layers.batch_norm(
        conv, act=act, is_test=is_test,
        param_attr=ParamAttr(name=bn_name + "_scale") if bn_name else None,
        bias_attr=ParamAttr(name=bn_name + "_offset") if bn_name else None,
        moving_mean_name=bn_name + "_mean" if bn_name else None,
        moving_variance_name=bn_name + "_variance" if bn_name else None,
    )


def shortcut(input, ch_out, stride, name=None, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, name=None, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + "_branch2a" if name else None,
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu",
                          name=name + "_branch2b" if name else None,
                          is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1,
                          name=name + "_branch2c" if name else None,
                          is_test=is_test)
    short = shortcut(input, num_filters * 4, stride,
                     name=name + "_branch1" if name else None, is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride, name=None, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu",
                          name=name + "_branch2a" if name else None,
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3,
                          name=name + "_branch2b" if name else None,
                          is_test=is_test)
    short = shortcut(input, num_filters, stride,
                     name=name + "_branch1" if name else None, is_test=is_test)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def build_resnet(img, label=None, depth=50, class_num=1000, is_test=False):
    """Build ResNet; returns (loss, acc1, acc5, logits) with a label,
    else the logits."""
    block_type, counts = _DEPTH_CFG[depth]
    num_filters = [64, 128, 256, 512]

    conv = conv_bn_layer(img, 64, 7, stride=2, act="relu", name="conv1",
                         is_test=is_test)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage != 0 else 1
            name = f"res{stage + 2}{chr(97 + i)}"
            if block_type == "bottleneck":
                conv = bottleneck_block(conv, num_filters[stage], stride,
                                        name=name, is_test=is_test)
            else:
                conv = basic_block(conv, num_filters[stage], stride,
                                   name=name, is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    logits = layers.fc(
        pool, class_num,
        param_attr=ParamAttr(name="fc_0.w_0",
                             initializer=UniformInitializer(-stdv, stdv)),
        bias_attr=ParamAttr(name="fc_0.b_0"),
    )
    if label is None:
        return logits
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc1 = layers.accuracy(logits, label, k=1)
    acc5 = layers.accuracy(logits, label, k=5)
    return loss, acc1, acc5, logits


def build_resnet50(img, label=None, class_num=1000, is_test=False):
    return build_resnet(img, label, 50, class_num, is_test)
