"""Optimizer update-op lowerings of the static path (counterpart of
``paddle_tpu/ops/optimizer_ops.py``: ``sgd`` :60, ``momentum`` :74).

An update op's ``ParamOut`` carries the ``Param``'s var name (and
``VelocityOut`` the velocity's), so the executor writes the new values
back into the scope's own tensors, in place.  Both ops are no_grad.
"""
from __future__ import annotations

from .registry import op

__all__ = []


@op("sgd", no_grad=True)
def _sgd(ctx):
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    lr = ctx.in_("LearningRate").reshape(()).to(p.dtype)
    ctx.set_out("ParamOut", p - lr * g.to(p.dtype))


@op("momentum", no_grad=True)
def _momentum(ctx):
    """``v = mu * v + g``; ``p -= lr * v`` (or, Nesterov,
    ``p -= (g + mu * v) * lr``)."""
    p, g, v = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Velocity")
    lr = ctx.in_("LearningRate").reshape(()).to(p.dtype)
    mu = ctx.attr("mu", 0.9)
    g = g.to(p.dtype)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_out("ParamOut", p_new)
    ctx.set_out("VelocityOut", v_new)
