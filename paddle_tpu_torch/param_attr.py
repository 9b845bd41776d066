"""``ParamAttr`` (counterpart of ``paddle_tpu/param_attr.py``): how a
layer (dygraph or static) creates one parameter."""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    """``initializer`` fills the parameter; ``trainable=False`` makes it
    need no gradient.  ``learning_rate`` scales the static optimizers'
    rate for this parameter (the ``optimize_attr`` of the program's
    Parameter); the dygraph optimizers use the global rate, as the JAX
    package's eager path does.  ``regularizer`` (``regularizer.L1Decay``
    or ``L2Decay``) decays this parameter in place of the optimizer's
    ``regularization``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """None -> the default attr; False -> no parameter; a string -> a
        named attr; an initializer -> an attr that uses it."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return None
        return ParamAttr(initializer=arg)
