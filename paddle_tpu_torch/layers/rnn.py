"""fluid.layers' RNN API for the static path (counterpart of
``paddle_tpu/layers/rnn.py``): the cells ``RNNCell`` :23, ``LSTMCell``
:37 and ``GRUCell`` :70, ``rnn`` :128 (a build-time unroll over the
static T, the state frozen past each row's length), ``birnn`` :178, the
fused ``lstm`` :191 and ``gru`` :227 ops, ``dynamic_lstm`` :259,
``dynamic_gru`` :291, and the beam-search wrappers ``beam_search`` :447
and ``beam_search_decode`` :467.  The ops lower in
``ops/sequence_ops.py``.

``StaticRNN`` (:315) records a step block for ``recurrent_op``: it needs
the control-flow ops, which are not ported (ROADMAP.md item 7), so it
raises.
"""
from __future__ import annotations

import copy

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import nn as _nn
from . import tensor as _tensor

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "rnn", "birnn", "lstm", "gru",
           "dynamic_lstm", "dynamic_gru", "StaticRNN", "beam_search",
           "beam_search_decode"]


class RNNCell:
    """The step interface: ``call(inputs, states) -> (out, new_states)``."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0):
        raise NotImplementedError


class LSTMCell(RNNCell):
    """One step of a basic LSTM: an fc over ``[inputs, h]`` to the four
    gates, then ``lstm_unit``."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.forget_bias = forget_bias
        self.dtype = dtype
        self.name = name

    def call(self, inputs, states):
        pre_hidden, pre_cell = states
        concat = _tensor.concat([inputs, pre_hidden], axis=1)
        gates = _nn.fc(concat, 4 * self.hidden_size,
                       param_attr=self.param_attr, bias_attr=self.bias_attr)
        helper = LayerHelper("lstm_unit", input=gates)
        c = helper.create_variable_for_type_inference(self.dtype)
        h = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op("lstm_unit",
                         inputs={"X": [gates], "C_prev": [pre_cell]},
                         outputs={"C": [c], "H": [h]},
                         attrs={"forget_bias": self.forget_bias})
        return h, [h, c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


class GRUCell(RNNCell):
    """One GRU step: an fc to the ``3H`` x-projection, then ``gru_unit``
    with a hidden weight of the cell's own (named ``<name>_hidden_w``
    when the cell's ``param_attr`` has a name, so that a program built
    apart, such as a decode program, shares it through the scope)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell"):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.dtype = dtype
        self.name = name
        self._helper = LayerHelper(name)
        self._weight = None

    def call(self, inputs, states):
        pre_hidden = (states[0] if isinstance(states, (list, tuple))
                      else states)
        xproj = _nn.fc(inputs, 3 * self.hidden_size,
                       param_attr=self.param_attr, bias_attr=self.bias_attr)
        helper = LayerHelper("gru_unit", input=xproj)
        if self._weight is None:
            attr = ParamAttr._to_attr(self.param_attr)
            w_attr = None
            if attr is not None and attr.name:
                w_attr = copy.copy(attr)
                w_attr.name = attr.name + "_hidden_w"
            self._weight = helper.create_parameter(
                w_attr, shape=[self.hidden_size, 3 * self.hidden_size],
                dtype=self.dtype)
        gate = helper.create_variable_for_type_inference(self.dtype)
        rhp = helper.create_variable_for_type_inference(self.dtype)
        hidden = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op("gru_unit",
                         inputs={"Input": [xproj], "HiddenPrev": [pre_hidden],
                                 "Weight": [self._weight]},
                         outputs={"Gate": [gate], "ResetHiddenPrev": [rhp],
                                  "Hidden": [hidden]})
        return hidden, [hidden]

    @property
    def state_shape(self):
        return [[self.hidden_size]]


def _zeros_like_state(batch_ref, size, dtype):
    """``[N, size]`` zeros with ``batch_ref``'s leading dim."""
    return _tensor.fill_constant_batch_size_like(
        batch_ref, shape=[-1, size], dtype=dtype, value=0.0)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run ``cell`` over the time axis, unrolled at build time over the
    static T; with ``sequence_length`` a row's state freezes past its
    end and its outputs there are 0."""
    T_axis = 0 if time_major else 1
    T = inputs.shape[T_axis]
    if T < 0:
        raise ValueError("rnn() needs a static time dimension")
    if initial_states is None:
        initial_states = [_zeros_like_state(inputs, s[-1], "float32")
                          for s in cell.state_shape]
    states = (list(initial_states)
              if isinstance(initial_states, (list, tuple))
              else [initial_states])
    if sequence_length is not None:
        from .sequence_lod import sequence_mask
        mask_all = sequence_mask(sequence_length, maxlen=T, dtype="float32")
    step_outs = []
    order = range(T - 1, -1, -1) if is_reverse else range(T)
    for t in order:
        xt = _nn.squeeze(
            _nn.slice(inputs, axes=[T_axis], starts=[t], ends=[t + 1]),
            axes=[T_axis])
        out, new_states = cell(xt, states if len(states) > 1 else states[0])
        if not isinstance(new_states, (list, tuple)):
            new_states = [new_states]
        new_states = list(new_states)
        if sequence_length is not None:
            mt = _nn.slice(mask_all, axes=[1], starts=[t], ends=[t + 1])
            new_states = [
                _nn.elementwise_add(
                    _nn.elementwise_mul(ns, mt),
                    _nn.elementwise_mul(s, _nn.scale(mt, -1.0, 1.0)))
                for ns, s in zip(new_states, states)]
            out = _nn.elementwise_mul(out, mt)
        states = new_states
        step_outs.append(out)
    if is_reverse:
        step_outs.reverse()
    outs = _nn.stack(step_outs, axis=T_axis)
    return outs, (states if len(states) > 1 else states[0])


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    states_fw, states_bw = (initial_states if initial_states is not None
                            else (None, None))
    out_fw, st_fw = rnn(cell_fw, inputs, states_fw, sequence_length,
                        time_major=time_major)
    out_bw, st_bw = rnn(cell_bw, inputs, states_bw, sequence_length,
                        time_major=time_major, is_reverse=True)
    return _tensor.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


def _fused_params(helper, input, hidden_size, num_layers, dirs, gates):
    dtype, D = input.dtype, input.shape[-1]
    wis, whs, bs = [], [], []
    for layer in range(num_layers):
        in_dim = D if layer == 0 else hidden_size * dirs
        for _ in range(dirs):
            wis.append(helper.create_parameter(
                None, shape=[in_dim, gates * hidden_size], dtype=dtype))
            whs.append(helper.create_parameter(
                None, shape=[hidden_size, gates * hidden_size], dtype=dtype))
            bs.append(helper.create_parameter(
                None, shape=[gates * hidden_size], dtype=dtype, is_bias=True))
    return {"Input": [input], "WeightIh": wis, "WeightHh": whs, "Bias": bs}


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False, is_test=False,
         name=None, default_initializer=None, seed=-1, sequence_length=None):
    """The fused multi-layer LSTM op (the reference's cudnn LSTM)."""
    helper = LayerHelper("lstm", input=input, name=name)
    dtype = input.dtype
    ins = _fused_params(helper, input, hidden_size, num_layers,
                        2 if is_bidirec else 1, 4)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    if init_h is not None:
        ins["InitH"] = [init_h]
    if init_c is not None:
        ins["InitC"] = [init_c]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length]
    helper.append_op("lstm", inputs=ins,
                     outputs={"Out": [out], "LastH": [last_h],
                              "LastC": [last_c]},
                     attrs={"is_bidirec": is_bidirec,
                            "num_layers": num_layers,
                            "hidden_size": hidden_size,
                            "dropout_prob": dropout_prob})
    return out, last_h, last_c


def gru(input, hidden_size, num_layers=1, is_bidirec=False, init_h=None,
        name=None, sequence_length=None):
    """The fused multi-layer GRU op."""
    helper = LayerHelper("gru", input=input, name=name)
    dtype = input.dtype
    ins = _fused_params(helper, input, hidden_size, num_layers,
                        2 if is_bidirec else 1, 3)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    if init_h is not None:
        ins["InitH"] = [init_h]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length]
    helper.append_op("gru", inputs=ins,
                     outputs={"Out": [out], "LastH": [last_h]},
                     attrs={"is_bidirec": is_bidirec,
                            "num_layers": num_layers,
                            "hidden_size": hidden_size})
    return out, last_h


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 sequence_length=None):
    """``input`` is the ``[N, T, 4H]`` x-projection (``size`` = 4H);
    returns (hidden, cell)."""
    hidden = size // 4
    helper = LayerHelper("dynamic_lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    w = helper.create_parameter(param_attr, shape=[hidden, 4 * hidden],
                                dtype=dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 4 * hidden],
                                dtype=dtype, is_bias=True)
    hid = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    lh = helper.create_variable_for_type_inference(dtype)
    lc = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length]
    helper.append_op("dynamic_lstm", inputs=ins,
                     outputs={"Hidden": [hid], "Cell": [cell],
                              "LastH": [lh], "LastC": [lc]},
                     attrs={"is_reverse": is_reverse,
                            "use_peepholes": use_peepholes})
    return hid, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32",
                sequence_length=None):
    """``input`` is the ``[N, T, 3H]`` x-projection (``size`` = H)."""
    helper = LayerHelper("dynamic_gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 3 * size], dtype=dtype,
                                is_bias=True)
    hid = helper.create_variable_for_type_inference(dtype)
    lh = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length]
    helper.append_op("dynamic_gru", inputs=ins,
                     outputs={"Hidden": [hid], "LastH": [lh]},
                     attrs={"is_reverse": is_reverse})
    return hid


class StaticRNN:
    """The step-block RNN builder: it needs the control-flow ops
    (``recurrent_op``), which are not ported."""

    def __init__(self, name=None):
        raise NotImplementedError(
            "StaticRNN needs the control-flow ops, which are not ported "
            "(ROADMAP.md Queue 1 item 7); layers.rnn() with a cell unrolls "
            "the same recurrence")


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One beam-search step over the flat ``[N*B, V]`` log-probs."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    parent = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op("beam_search",
                     inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                             "Scores": [scores]},
                     outputs={"SelectedIds": [sel_ids],
                              "SelectedScores": [sel_scores],
                              "ParentIdx": [parent]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id,
                       name=None):
    """The whole hypotheses from the per-step lists of ids, scores and
    parents: (ids, scores, lengths)."""
    helper = LayerHelper("beam_search_decode", name=name)
    out_ids = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    out_scores = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    out_len = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op("beam_search_decode",
                     inputs={"Ids": list(ids), "Scores": list(scores),
                             "ParentIdx": list(parent_idx)},
                     outputs={"SentenceIds": [out_ids],
                              "SentenceScores": [out_scores],
                              "SentenceLength": [out_len]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return out_ids, out_scores, out_len
