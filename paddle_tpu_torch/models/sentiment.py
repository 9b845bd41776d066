"""The sentiment-classification book models, static graph: the book's
understand_sentiment chapter (counterpart of
``paddle_tpu/models/sentiment.py``; reference analog:
python/paddle/fluid/tests/book/notest_understand_sentiment.py).

``stacked_lstm_net``: an embedding, an fc, then ``stacked_num`` layers
of (fc, ``dynamic_lstm``) alternating direction (the reversed ones
through ``sequence_reverse``), max pools over time, a softmax
classifier.  ``convolution_net``: two ``sequence_conv`` + ``sqrt`` pool
branches (windows 3 and 4), a softmax classifier.
"""
from __future__ import annotations

from .. import layers

__all__ = ["stacked_lstm_net", "convolution_net"]


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=32,
                     hid_dim=32, stacked_num=3, is_sparse=True,
                     length=None):
    """data: ``[N, T]`` int64 tokens; label: ``[N, 1]`` int64.  Returns
    (avg_cost, accuracy, prediction)."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(data, size=[input_dim, emb_dim],
                           is_sparse=is_sparse)
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim * 4)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(layers.concat(inputs, axis=2), size=hid_dim * 4,
                       num_flatten_dims=2)
        rev = (i % 2) == 0
        lstm_in = layers.sequence_reverse(fc, length=length) if rev else fc
        lstm, _ = layers.dynamic_lstm(lstm_in, size=hid_dim * 4)
        if rev:
            lstm = layers.sequence_reverse(lstm, length=length)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], pool_type="max",
                                   length=length)
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max",
                                     length=length)
    prediction = layers.fc(layers.concat([fc_last, lstm_last], axis=1),
                           size=class_dim, act="softmax")
    avg_cost = layers.mean(layers.cross_entropy(prediction, label))
    return avg_cost, layers.accuracy(prediction, label), prediction


def convolution_net(data, label, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32, is_sparse=True, length=None):
    """Two sequence_conv + sqrt pool branches (windows 3 and 4) ->
    softmax."""
    emb = layers.embedding(data, size=[input_dim, emb_dim],
                           is_sparse=is_sparse)
    conv3 = layers.sequence_conv(emb, num_filters=hid_dim, filter_size=3,
                                 act="tanh", length=length)
    conv4 = layers.sequence_conv(emb, num_filters=hid_dim, filter_size=4,
                                 act="tanh", length=length)
    pool3 = layers.sequence_pool(conv3, pool_type="sqrt", length=length)
    pool4 = layers.sequence_pool(conv4, pool_type="sqrt", length=length)
    prediction = layers.fc(layers.concat([pool3, pool4], axis=1),
                           size=class_dim, act="softmax")
    avg_cost = layers.mean(layers.cross_entropy(prediction, label))
    return avg_cost, layers.accuracy(prediction, label), prediction
