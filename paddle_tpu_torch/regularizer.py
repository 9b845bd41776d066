"""Weight decay (counterpart of ``paddle_tpu/regularizer.py``; reference:
``fluid/regularizer.py``).

A regularizer appends, for one parameter, the ops that add its decay to
the gradient and returns the new gradient var: ``L2Decay`` adds ``coeff *
param`` (``scale`` then ``sum``), ``L1Decay`` adds ``coeff * sign(param)``.
``Optimizer(regularization=...)`` applies one to every parameter, and a
parameter's own ``ParamAttr(regularizer=...)`` takes precedence
(``optimizer.py`` ``_append_regularization_ops``).
"""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _decayed(param, grad, block, decay):
    new_grad = block.create_var(dtype=param.dtype, shape=param.shape)
    block.append_op("sum", inputs={"X": [grad, decay]},
                    outputs={"Out": [new_grad]})
    return new_grad


def _scaled(x, coeff, param, block):
    out = block.create_var(dtype=param.dtype, shape=param.shape)
    block.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                    attrs={"scale": coeff})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = _scaled(param, self.regularization_coeff, param, block)
        return _decayed(param, grad, block, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = _scaled(sign, self.regularization_coeff, param, block)
        return _decayed(param, grad, block, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
