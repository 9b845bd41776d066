"""The static AMP optimizer decorator (counterpart of
``paddle_tpu/contrib/mixed_precision/decorator.py``: ``OptimizerWith
MixedPrecision`` :33, ``decorate`` :171; reference:
``fluid/contrib/mixed_precision/decorator.py:27,218``).

``minimize`` rewrites the program to mixed precision
(:func:`.fp16_utils.rewrite_program`), then runs the wrapped optimizer's
backward and update.  The default low dtype is bfloat16, whose exponent
range is float32's, so the loss is not scaled.  ``use_fp16=True`` is the
reference's float16 AMP: the loss is multiplied by a persistable
``loss_scaling`` var before the backward, and after it a ``reciprocal``,
an ``amp_check_finite_and_scale`` (every gradient unscaled, or all of
them zeroed on a step that found an Inf or a NaN) and an
``update_loss_scaling`` (the scale and its good / bad step counters) run
in the program (``ops/extra_ops.py``), so the executor keeps that state
on the device like any other.  With ``use_dynamic_loss_scaling=False``
the scale is a constant: a ``scale`` op on the loss and one on each
gradient, unless the scale is 1.
"""
from __future__ import annotations

from ...backward import OP_ROLE_KEY, OpRole
from ...framework import unique_name
from ...framework.dtype import VarType
from ...layers import nn as nn_layers
from ...layers import tensor as tensor_layers
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["OptimizerWithMixedPrecision", "decorate"]


class OptimizerWithMixedPrecision:
    """``optimizer`` with the program rewrite (and, in float16, the loss
    scaling) around its backward; every other attribute is the wrapped
    optimizer's."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype=VarType.BF16):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = init_loss_scaling
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._scaled_loss = None
        self._loss_scaling_var = None
        self._found_inf_var = None
        self._good_steps_var = None
        self._bad_steps_var = None

    def get_loss_scaling(self):
        """The initial scale; under dynamic scaling the live one is the
        persistable var (:meth:`get_loss_scaling_var`)."""
        return self._loss_scaling

    def get_loss_scaling_var(self):
        return self._loss_scaling_var

    def get_found_inf_var(self):
        return self._found_inf_var

    def get_scaled_loss(self):
        return self._scaled_loss

    def _dynamic(self) -> bool:
        return (self._dest_dtype == VarType.FP16
                and self._use_dynamic_loss_scaling)

    def _init_scaling_state(self):
        if self._loss_scaling_var is not None:
            return
        self._loss_scaling_var = tensor_layers.create_global_var(
            shape=[1], value=float(self._loss_scaling), dtype="float32",
            persistable=True, name=unique_name.generate("loss_scaling"))
        self._good_steps_var = tensor_layers.create_global_var(
            shape=[1], value=0, dtype="int32", persistable=True,
            name=unique_name.generate("loss_scaling_good_steps"))
        self._bad_steps_var = tensor_layers.create_global_var(
            shape=[1], value=0, dtype="int32", persistable=True,
            name=unique_name.generate("loss_scaling_bad_steps"))

    def _append_dynamic_unscale(self, block, params_grads):
        """After the backward: every gradient times the live 1/scale, or
        all zeroed when any is not finite, then one step of the scale's
        state machine."""
        grads = [g.name for _, g in params_grads if g is not None]
        if not grads:
            return
        scale = self._loss_scaling_var.name
        inv = unique_name.generate("loss_scaling_inv")
        block.create_var(name=inv, shape=[1], dtype=VarType.FP32)
        block.append_op("reciprocal", inputs={"X": [scale]},
                        outputs={"Out": [inv]},
                        attrs={OP_ROLE_KEY: int(OpRole.Backward)})
        found = unique_name.generate("found_infinite")
        self._found_inf_var = block.create_var(
            name=found, shape=[1], dtype=VarType.BOOL, persistable=True)
        block.append_op(
            "amp_check_finite_and_scale",
            inputs={"X": list(grads), "Scale": [inv]},
            outputs={"Out": list(grads), "FoundInfinite": [found]},
            attrs={OP_ROLE_KEY: int(OpRole.Backward)})
        good, bad = self._good_steps_var.name, self._bad_steps_var.name
        block.append_op(
            "update_loss_scaling",
            inputs={"FoundInfinite": [found], "PrevLossScaling": [scale],
                    "InGoodSteps": [good], "InBadSteps": [bad]},
            outputs={"LossScalingOut": [scale], "OutGoodSteps": [good],
                     "OutBadSteps": [bad]},
            attrs={"incr_every_n_steps": int(self._incr_every_n_steps),
                   "decr_every_n_nan_or_inf":
                       int(self._decr_every_n_nan_or_inf),
                   "incr_ratio": float(self._incr_ratio),
                   "decr_ratio": float(self._decr_ratio),
                   OP_ROLE_KEY: int(OpRole.Optimize)})

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        rewrite_program(loss.block.program, self._amp_lists,
                        self._dest_dtype)
        if self._dynamic():
            self._init_scaling_state()
            self._scaled_loss = nn_layers.elementwise_mul(
                loss, self._loss_scaling_var)
            params_grads = self._optimizer.backward(
                self._scaled_loss, startup_program, parameter_list,
                no_grad_set, callbacks)
            self._append_dynamic_unscale(loss.block, params_grads)
            return params_grads
        static = (self._dest_dtype == VarType.FP16
                  and self._loss_scaling != 1.0)
        self._scaled_loss = (nn_layers.scale(loss, self._loss_scaling)
                             if static else loss)
        params_grads = self._optimizer.backward(
            self._scaled_loss, startup_program, parameter_list, no_grad_set,
            callbacks)
        if static:
            inv = 1.0 / self._loss_scaling
            params_grads = [(p, nn_layers.scale(g, inv) if g is not None
                             else g) for p, g in params_grads]
        return params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self._optimizer.apply_gradients(params_grads), params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8, use_dynamic_loss_scaling=True,
             use_fp16=False):
    """Wrap ``optimizer`` for mixed precision (reference:
    ``decorator.py:218``): bfloat16 by default, with the loss-scaling
    arguments ignored (scaling off, scale 1), as in the JAX package;
    float16 with ``use_fp16=True``, the reference's AMP, with dynamic
    loss scaling unless ``use_dynamic_loss_scaling=False``."""
    dest = VarType.FP16 if use_fp16 else VarType.BF16
    if dest == VarType.BF16:
        init_loss_scaling = 1.0
        use_dynamic_loss_scaling = False
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest)
