"""word2vec (N-gram language model), static graph: the book's word2vec
chapter (counterpart of ``paddle_tpu/models/word2vec.py``; reference
analog: python/paddle/fluid/tests/book/test_word2vec.py).

Four context words through one shared embedding table, concatenated,
a sigmoid hidden layer and a softmax over the vocabulary.  With
``FLAGS_cuda_fuse`` on the hidden ``fc(act="sigmoid")`` runs as
``fused_matmul_bias_act``, whose epilogue is kernel 9
(``ops/matmul_epilogue.py``).
"""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def build_word2vec(context_words, target_word, dict_size,
                   embed_dim=32, hidden_size=256):
    """``context_words``: list of int64 [N, 1] tensors; ``target_word``
    int64 [N, 1].  Returns (avg_loss, predict_probs)."""
    shared = ParamAttr(name="shared_w")
    embeds = [
        layers.embedding(w, size=[dict_size, embed_dim], param_attr=shared)
        for w in context_words
    ]
    concat = layers.concat(
        [layers.reshape(e, [-1, embed_dim]) for e in embeds], axis=1)
    hidden = layers.fc(concat, hidden_size, act="sigmoid")
    logits = layers.fc(hidden, dict_size)
    predict = layers.softmax(logits)
    loss = layers.softmax_with_cross_entropy(logits, target_word)
    return layers.mean(loss), predict
