"""Attention seq2seq translation with a beam-search decode, static graph:
the book's machine-translation chapter (counterpart of
``paddle_tpu/models/seq2seq.py``; reference analog:
python/paddle/fluid/tests/book/test_machine_translation.py).

An embedding, an ``fc(tanh)`` to the 4H x-projection and a
``dynamic_lstm`` encode the source; a GRU cell with additive
(Bahdanau) attention over the encoder's outputs decodes, unrolled by
``layers.rnn`` in training and over ``max_length`` ``beam_search`` steps
in the decode program.  Every parameter carries a ``ParamAttr`` name, so
the decode program, built apart, reads the trained ones from the scope.
With ``FLAGS_cuda_fuse`` on, the encoder's ``fc(tanh,
num_flatten_dims=2)`` and the decoder's initial-state ``fc(tanh)`` run as
``fused_matmul_bias_act``, whose epilogue is kernel 9
(``ops/matmul_epilogue.py``).
"""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["encoder", "AttentionDecoderCell", "build_train", "build_decode"]


def encoder(src_word_id, dict_size, word_dim=16, hidden_dim=32,
            is_sparse=True):
    """embedding -> fc(tanh, 4H) -> dynamic_lstm; (last hidden, all
    hidden)."""
    src_embedding = layers.embedding(
        src_word_id, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=ParamAttr(name="src_emb"))
    fc1 = layers.fc(src_embedding, size=hidden_dim * 4, act="tanh",
                    num_flatten_dims=2,
                    param_attr=ParamAttr(name="enc_fc_w"),
                    bias_attr=ParamAttr(name="enc_fc_b"))
    lstm_hidden0, _ = layers.dynamic_lstm(
        fc1, size=hidden_dim * 4,
        param_attr=ParamAttr(name="enc_lstm_w"),
        bias_attr=ParamAttr(name="enc_lstm_b"))
    return layers.sequence_last_step(lstm_hidden0), lstm_hidden0


class AttentionDecoderCell(layers.RNNCell):
    """A GRU cell over ``[input, context]``, the context an additive
    attention of the state over the encoder's outputs."""

    def __init__(self, hidden_size, encoder_out, name="attn_dec"):
        self.hidden_size = hidden_size
        self.encoder_out = encoder_out  # [N, T, H]
        self.name = name
        self._gru = layers.GRUCell(
            hidden_size,
            param_attr=ParamAttr(name=f"{name}_gru"),
            bias_attr=ParamAttr(name=f"{name}_gru_b"))

    def _attend(self, state):
        # score_t = v^T tanh(W_e e_t + W_s s)
        enc_proj = layers.fc(self.encoder_out, size=self.hidden_size,
                             num_flatten_dims=2, bias_attr=False,
                             param_attr=ParamAttr(name=f"{self.name}_We"))
        s_proj = layers.fc(state, size=self.hidden_size, bias_attr=False,
                           param_attr=ParamAttr(name=f"{self.name}_Ws"))
        s_proj = layers.unsqueeze(s_proj, axes=[1])  # [N, 1, H]
        scores = layers.fc(
            layers.tanh(layers.elementwise_add(enc_proj, s_proj)),
            size=1, num_flatten_dims=2, bias_attr=False,
            param_attr=ParamAttr(name=f"{self.name}_v"))  # [N, T, 1]
        weights = layers.softmax(scores, axis=1)
        return layers.reduce_sum(
            layers.elementwise_mul(self.encoder_out, weights), dim=1)

    def call(self, inputs, states):
        state = states[0] if isinstance(states, (list, tuple)) else states
        gru_in = layers.concat([inputs, self._attend(state)], axis=1)
        return self._gru.call(gru_in, state)


def build_train(src, trg, label, dict_size, word_dim=16, hidden_dim=32,
                is_sparse=True):
    """The training graph: (avg_cost, logits).  src / trg ``[N, T]``
    int64 token ids; label ``[N, T, 1]`` the next tokens."""
    enc_last, enc_out = encoder(src, dict_size, word_dim, hidden_dim,
                                is_sparse)
    trg_embedding = layers.embedding(
        trg, size=[dict_size, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr=ParamAttr(name="trg_emb"))
    init_state = layers.fc(enc_last, size=hidden_dim, act="tanh",
                           param_attr=ParamAttr(name="dec_init"),
                           bias_attr=ParamAttr(name="dec_init_b"))
    cell = AttentionDecoderCell(hidden_dim, enc_out)
    dec_out, _ = layers.rnn(cell, trg_embedding,
                            initial_states=[init_state])
    logits = layers.fc(dec_out, size=dict_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name="dec_proj_w"),
                       bias_attr=ParamAttr(name="dec_proj_b"))
    cost = layers.softmax_with_cross_entropy(logits, label)
    return layers.mean(cost), logits


def build_decode(src, init_ids, init_scores, dict_size, word_dim=16,
                 hidden_dim=32, beam_size=2, max_length=8, eos_id=1,
                 is_sparse=True):
    """The beam-search decode graph over the trained parameters (same
    ``ParamAttr`` names), unrolled over ``max_length`` steps: each step
    feeds the full-vocabulary log-probs ``[N*B, V]`` to ``beam_search``
    and regathers the decoder state by ``ParentIdx``.  ``src`` is tiled
    to ``[N*B, T]``; ``init_ids`` ``[N*B, 1]`` int64 (bos);
    ``init_scores`` ``[N*B, 1]`` (0 for each source's beam 0, a large
    negative for the rest).  Returns (sentence_ids, sentence_scores,
    lengths)."""
    enc_last, enc_out = encoder(src, dict_size, word_dim, hidden_dim,
                                is_sparse)
    state = layers.fc(enc_last, size=hidden_dim, act="tanh",
                      param_attr=ParamAttr(name="dec_init"),
                      bias_attr=ParamAttr(name="dec_init_b"))
    cell = AttentionDecoderCell(hidden_dim, enc_out)

    pre_ids, pre_scores = init_ids, init_scores
    step_ids, step_scores, step_parents = [], [], []
    for _ in range(max_length):
        word_emb = layers.embedding(
            pre_ids, size=[dict_size, word_dim], dtype="float32",
            is_sparse=is_sparse, param_attr=ParamAttr(name="trg_emb"))
        word_emb = layers.reshape(word_emb, [-1, word_dim])
        out, new_states = cell.call(word_emb, [state])
        logits = layers.fc(out, size=dict_size,
                           param_attr=ParamAttr(name="dec_proj_w"),
                           bias_attr=ParamAttr(name="dec_proj_b"))
        probs = layers.log_softmax(logits)  # [N*B, V]
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, None, probs, beam_size=beam_size,
            end_id=eos_id)
        step_ids.append(sel_ids)
        step_scores.append(sel_scores)
        step_parents.append(parent)
        pre_ids, pre_scores = sel_ids, sel_scores
        new_state = (new_states[0] if isinstance(new_states, (list, tuple))
                     else new_states)
        # a surviving hypothesis continues from its parent's state
        state = layers.gather(new_state, parent)

    return layers.beam_search_decode(step_ids, step_scores, step_parents,
                                     beam_size=beam_size, end_id=eos_id)
