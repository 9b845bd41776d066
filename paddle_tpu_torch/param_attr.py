"""``ParamAttr`` (counterpart of ``paddle_tpu/param_attr.py``): how a
layer creates one parameter."""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    """``initializer`` fills the parameter; ``trainable=False`` makes it
    need no gradient.  ``learning_rate`` is kept for the API; the dygraph
    optimizers use the global rate, as the JAX package's eager path does.
    A ``regularizer`` is not ported."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        if regularizer is not None:
            raise NotImplementedError(
                "ParamAttr(regularizer=...) is not ported (ROADMAP.md)")
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
