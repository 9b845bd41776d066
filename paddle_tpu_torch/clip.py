"""Gradient clipping (counterpart of ``paddle_tpu/clip.py``; reference:
python/paddle/fluid/clip.py).

An optimizer's ``grad_clip=`` (or, without one, the clip given to
:func:`set_gradient_clip`) rewrites its sorted ``(param, grad)`` pairs
before the weight decay and the update ops (``Optimizer.apply_gradients``):
``GradientClipByValue`` clips each gradient elementwise (``clip``),
``GradientClipByNorm`` each gradient by its own L2 norm
(``clip_by_norm``), and ``GradientClipByGlobalNorm`` scales every
gradient by ``clip_norm / max(global_norm, clip_norm)``, the global norm
from one ``squared_l2_norm`` per gradient, a ``sum`` and a ``sqrt``.  The
ops are the JAX package's, so both packages build the same program.
"""
from __future__ import annotations

import warnings

from .layer_helper import LayerHelper
from .layers import nn as nn_layers
from .layers import tensor as tensor_layers

__all__ = ["GradientClipBase", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ClipByValue", "ClipByNorm",
           "ClipByGlobalNorm", "set_gradient_clip"]


class GradientClipBase:
    def _process(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _process(self, params_grads):
        return [(p, g if g is None else nn_layers.clip(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        return [(p, g if g is None
                 else nn_layers.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]


class GradientClipByGlobalNorm(GradientClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        helper = LayerHelper("global_norm_clip")
        sq_sums = []
        for _, g in params_grads:
            if g is None:
                continue
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": [g]},
                             outputs={"Out": [sq]})
            sq_sums.append(sq)
        if not sq_sums:
            return params_grads
        total = helper.create_variable_for_type_inference(sq_sums[0].dtype)
        helper.append_op("sum", inputs={"X": sq_sums},
                         outputs={"Out": [total]})
        global_norm = helper.create_variable_for_type_inference(total.dtype)
        helper.append_op("sqrt", inputs={"X": [total]},
                         outputs={"Out": [global_norm]})
        max_norm = tensor_layers.fill_constant([1], total.dtype,
                                               self.clip_norm)
        denom = nn_layers.elementwise_max(global_norm, max_norm)
        scale_var = nn_layers.elementwise_div(max_norm, denom)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("elementwise_mul",
                             inputs={"X": [g], "Y": [scale_var]},
                             outputs={"Out": [ng]}, attrs={"axis": -1})
            out.append((p, ng))
        return out


# reference-era aliases
ClipByValue = GradientClipByValue
ClipByNorm = GradientClipByNorm
ClipByGlobalNorm = GradientClipByGlobalNorm


def set_gradient_clip(clip, param_list=None, program=None):
    """Clip the gradients of every optimizer built without a
    ``grad_clip`` of its own (deprecated, as in JAX)."""
    warnings.warn("set_gradient_clip is deprecated; pass grad_clip to the "
                  "optimizer")
    _global_clip[0] = clip


#: the clip of :func:`set_gradient_clip` (a one-slot list, as in JAX)
_global_clip = [None]
