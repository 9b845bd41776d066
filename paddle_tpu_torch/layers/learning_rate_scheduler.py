"""Learning-rate schedules as program ops (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``; reference:
``fluid/layers/learning_rate_scheduler.py``).

Each schedule builds, in the main program, the ops that compute the rate
from a global step counter, so the rate is part of the step: on the card
it stays on the device (no host read), and a captured step (the CUDA
graph of ``FLAGS_cuda_step_session``) advances it on every replay.  The
counter is the persistable f32 ``@LR_DECAY_COUNTER@``, filled with 0 by
the startup program and advanced by an ``increment`` op prepended to the
main program, so the first step sees 1, as in JAX.
"""
from __future__ import annotations

import math

from ..backward import OP_ROLE_KEY, OpRole
from ..framework.core import (Variable, default_main_program,
                              default_startup_program)
from ..framework.dtype import VarType
from ..layer_helper import LayerHelper
from . import nn as nn_layers
from . import tensor as tensor_layers

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]

COUNTER = "@LR_DECAY_COUNTER@"


def _global_step_counter():
    """The step counter of the main program, made on first use
    (reference: ``layers/tensor.py autoincreased_step_counter``)."""
    main_block = default_main_program().global_block()
    if main_block.has_var(COUNTER):
        return main_block.var(COUNTER)
    var = main_block.create_var(name=COUNTER, shape=(1,), dtype=VarType.FP32,
                                persistable=True, stop_gradient=True)
    startup = default_startup_program().global_block()
    startup.create_var(name=COUNTER, shape=(1,), dtype=VarType.FP32,
                       persistable=True)
    startup.append_op("fill_constant", outputs={"Out": [COUNTER]},
                      attrs={"shape": [1], "value": 0.0,
                             "dtype": int(VarType.FP32)})
    main_block._prepend_op(
        "increment", inputs={"X": [COUNTER]}, outputs={"Out": [COUNTER]},
        attrs={"step": 1.0, OP_ROLE_KEY: OpRole.LRSched})
    return var


def _less_than(x, y, helper_name):
    helper = LayerHelper(helper_name)
    out = helper.create_variable_for_type_inference(VarType.BOOL)
    helper.append_op("less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step_counter()
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return learning_rate * (d_model ** -0.5) * nn_layers.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn_layers.floor(div)
    return learning_rate * (float(decay_rate) ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn_layers.floor(div)
    return learning_rate * nn_layers.exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn_layers.floor(div)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step_counter()
    if cycle:
        div = nn_layers.ceil(step / float(decay_steps))
        one = tensor_layers.fill_constant([1], "float32", 1.0)
        div = nn_layers.elementwise_max(div, one)
        decay_steps_var = div * float(decay_steps)
    else:
        decay_steps_var = tensor_layers.fill_constant(
            [1], "float32", float(decay_steps))
        step = nn_layers.elementwise_min(step, tensor_layers.fill_constant(
            [1], "float32", float(decay_steps)))
    frac = step / decay_steps_var
    return ((learning_rate - end_learning_rate)
            * ((1.0 - frac) ** power)) + end_learning_rate


def piecewise_decay(boundaries, values):
    """``values[i]`` while the step is below ``boundaries[i]``, the last
    value after: nested ``where`` ops over ``less_than``."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay needs one more value than "
                         "boundaries")
    step = _global_step_counter()
    lr = tensor_layers.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        bvar = tensor_layers.fill_constant([1], "float32", float(b))
        # JAX builds this difference too, and nothing reads it
        nn_layers.elementwise_sub(step, bvar)
        is_lt = _less_than(step, bvar, "piecewise_decay")
        vvar = tensor_layers.fill_constant([1], "float32", float(v))
        lr = nn_layers.where(is_lt, vvar, lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step_counter()
    epoch = nn_layers.floor(step / float(step_each_epoch))
    return learning_rate * 0.5 * (
        nn_layers.cos(epoch * (math.pi / float(epochs))) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A linear ramp from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a schedule's var or a
    number)."""
    step = _global_step_counter()
    wvar = tensor_layers.fill_constant([1], "float32", float(warmup_steps))
    in_warmup = _less_than(step, wvar, "lr_warmup")
    warm = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor_layers.fill_constant(
            [1], "float32", float(learning_rate))
    return nn_layers.where(in_warmup, warm, learning_rate)
