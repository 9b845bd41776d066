"""LeNet-5 MNIST, static graph (counterpart of
``paddle_tpu/models/lenet.py``; reference analog:
python/paddle/fluid/tests/book/test_recognize_digits.py).

Built with the port's ``fluid.layers``, so the program equals the JAX
package's op for op.  With ``FLAGS_cuda_fuse`` on (the default on a CUDA
device) the two ``fc(act="relu")`` layers run as
``fused_matmul_bias_act``, whose epilogue is kernel 9
(``ops/matmul_epilogue.py``).
"""
from __future__ import annotations

from .. import layers


def build_lenet(img, label):
    """Static-graph LeNet.  img: [N,1,28,28], label: [N,1] int64."""
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                          act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = layers.fc(pool2, size=120, act="relu")
    fc2 = layers.fc(fc1, size=84, act="relu")
    logits = layers.fc(fc2, size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
