"""The static AMP optimizer decorator (counterpart of
``paddle_tpu/contrib/mixed_precision/decorator.py``: ``OptimizerWith
MixedPrecision`` :33, ``decorate`` :171; reference:
``fluid/contrib/mixed_precision/decorator.py:27,218``).

``minimize`` rewrites the program to mixed precision
(:func:`.fp16_utils.rewrite_program`), then runs the wrapped optimizer's
backward and update.  The low dtype is bfloat16, whose exponent range is
float32's, so the loss is not scaled.  float16 with (dynamic) loss
scaling (``use_fp16=True``, the ``amp_check_finite_and_scale`` and
``update_loss_scaling`` ops) is not ported (ROADMAP.md, slice 8).
"""
from __future__ import annotations

from ...framework.dtype import VarType
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["OptimizerWithMixedPrecision", "decorate"]

_FP16 = ("float16 AMP with loss scaling (use_fp16=True, "
         "amp_check_finite_and_scale, update_loss_scaling) is not ported "
         "(ROADMAP.md, slice 8)")


class OptimizerWithMixedPrecision:
    """``optimizer`` with the bf16 program rewrite in front of its
    backward; every other attribute is the wrapped optimizer's."""

    def __init__(self, optimizer, amp_lists=None, dest_dtype=VarType.BF16):
        if dest_dtype != VarType.BF16:
            raise NotImplementedError(_FP16)
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = dest_dtype
        self._loss_scaling = 1.0
        self._scaled_loss = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def get_loss_scaling_var(self):
        return None

    def get_found_inf_var(self):
        return None

    def get_scaled_loss(self):
        return self._scaled_loss

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        rewrite_program(loss.block.program, self._amp_lists,
                        self._dest_dtype)
        self._scaled_loss = loss
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

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
    """Wrap ``optimizer`` for bf16 mixed precision (reference:
    ``decorator.py:218``).  In bf16 the loss-scaling arguments are
    ignored, as in the JAX package (scaling off, scale 1)."""
    if use_fp16:
        raise NotImplementedError(_FP16)
    return OptimizerWithMixedPrecision(optimizer, amp_lists, VarType.BF16)
