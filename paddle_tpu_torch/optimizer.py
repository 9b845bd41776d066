"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``), static and
dygraph.

Static (``optimizer.py:108-351``): ``Optimizer.minimize(loss)`` on a
program ``Variable`` runs ``append_backward`` and appends one update op
per parameter (``sgd``, ``momentum``; ``ops/optimizer_ops.py``), with
the learning rate as a persistable ``[1]`` var and the accumulators
(Momentum's velocity) initialized in the startup program, as in JAX.
``SGDOptimizer`` and ``MomentumOptimizer`` have this form; the other
optimizers' static forms are not ported.

Dygraph: ``minimize(loss)`` on a tensor applies one update from each
parameter's ``.grad``.  Ported: :class:`AdamOptimizer`
(``optimizer.py:514-643``) with the ``adam`` op's update
(``ops/optimizer_ops.py:126-165``).  It is Paddle's Adam, not
``torch.optim.Adam``: the beta-power accumulators start at 1.0 and are
multiplied after each update, and epsilon is added to the *uncorrected*
``sqrt(v)``:

    lr_t = lr * sqrt(1 - b2p * beta2) / (1 - b1p * beta1)
    m    = beta1 * m + (1 - beta1) * g
    v    = beta2 * v + (1 - beta2) * g * g
    p   -= lr_t * m / (sqrt(v) + epsilon)
    b1p *= beta1;  b2p *= beta2

Each parameter keeps its own accumulators and is updated only on a step
that gave it a gradient, as in JAX.  Parameters whose beta powers agree
are updated together by ``torch._foreach_*`` ops, in place (this takes
the place of the JAX package's flattened multi-tensor update, a speed
detail).

Master weights (AMP O2; ``optimizer.py:567-592``, ``_apply_fused_mp``
:653-683, ``_eager_update`` :867-906).  A bf16 parameter gets an f32
master in its state, seeded from the upcast of the bf16 value at its
first update (not from any earlier f32 value), and f32 moments; its
gradient is upcast to f32, the update runs on the master, and the
parameter becomes the bf16 cast of the master after every step.  JAX
packs the masters into one flat buffer, a TPU layout; the per-parameter
``_foreach`` update over the masters computes the same elementwise
update.  LAMB, AdamW and the other optimizers, regularization and
gradient clipping are not ported.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .backward import OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole, append_backward
from .framework import unique_name
from .framework.core import (Variable, default_main_program,
                             default_startup_program)

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "LambOptimizer", "AdamWOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization and grad_clip are not ported (ROADMAP.md)")
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameter_list)
                                if parameter_list is not None else None)
        self._name = name
        # static form: accumulator vars by kind and parameter name, and
        # the learning-rate var of each program
        self._accumulators: Dict[str, Dict[str, Variable]] = \
            defaultdict(dict)
        self._learning_rate_map: Dict[int, Variable] = {}

    # -- static form ---------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program._uid in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program._uid] = self._learning_rate
            return
        from .layers import tensor as tensor_layers

        self._learning_rate_map[program._uid] = \
            tensor_layers.create_global_var(
                shape=[1], value=float(self._learning_rate),
                dtype="float32", persistable=True,
                name=unique_name.generate("learning_rate"))

    def _global_learning_rate(self):
        return self._learning_rate_map.get(default_main_program()._uid)

    def _create_param_lr(self, param):
        lr = self._global_learning_rate()
        plr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if plr != 1.0:
            raise NotImplementedError("a per-parameter learning rate (the "
                                      "scale op) is not ported")
        return lr

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(f"{param.name}_{name}")
        var = default_main_program().global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        startup_block = default_startup_program().global_block()
        startup_block.create_var(name=var_name, shape=shape, dtype=dtype,
                                 persistable=True)
        startup_block.append_op(
            "fill_constant", outputs={"Out": [var_name]},
            attrs={"shape": shape, "value": float(fill_value),
                   "dtype": int(dtype)})
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError(
            f"{type(self).__name__} has no static form in the port")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        parameter_list = parameter_list or self._parameter_list
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        main_block = default_main_program().global_block()
        self._create_global_learning_rate()
        self._create_accumulators(
            main_block, [p for p, g in params_grads if g is not None])
        optimize_ops = []
        for p, g in params_grads:
            if g is None:
                continue
            op = self._append_optimize_op(main_block, (p, g))
            op.attrs[OP_ROLE_KEY] = OpRole.Optimize
            op.attrs[OP_ROLE_VAR_KEY] = [p.name, g.name]
            optimize_ops.append(op)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Static (``loss`` a program ``Variable``): append the backward
        and the update ops; returns ``(optimize_ops, params_grads)``.
        Dygraph (``loss`` a tensor, or None): apply one update from each
        parameter's ``.grad`` (the caller has run ``loss.backward()``);
        parameters without a gradient are left alone; returns
        ``(None, [(param, grad), ...])``."""
        if isinstance(loss, Variable):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            return self.apply_gradients(params_grads), params_grads
        params = parameter_list or self._parameter_list or []
        params_grads = [(p, p.grad) for p in params if p.grad is not None]
        with torch.no_grad():
            self._apply(params_grads)
        return None, params_grads

    def _apply(self, params_grads):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """``p -= lr * g`` (static form; ``optimizer.py:307``)."""

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    """``v = mu * v + g; p -= lr * v`` (static form;
    ``optimizer.py:330``)."""

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        if lazy_mode:
            raise NotImplementedError("Adam lazy_mode (sparse rows) is not "
                                      "ported")
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # per parameter: moment1, moment2 (tensors) and the beta powers
        # (float32 scalars, as the JAX op's (1,) f32 accumulators)
        self._state: Dict[int, dict] = {}

    def _param_state(self, p) -> dict:
        """p's state; a bf16 / fp16 ``p`` also gets its f32 ``master``,
        seeded from p's upcast when it first needs one."""
        st = self._state.get(id(p))
        if st is None:
            st = {"b1p": np.float32(1.0), "b2p": np.float32(1.0)}
            self._state[id(p)] = st
        if p.dtype != torch.float32 and "master" not in st:
            st["master"] = p.detach().float()
        if "m1" not in st:
            ref = st.get("master", p)
            st["m1"], st["m2"] = torch.zeros_like(ref), torch.zeros_like(ref)
        return st

    def _apply(self, params_grads):
        lr = np.float32(self._learning_rate)
        b1, b2 = np.float32(self._beta1), np.float32(self._beta2)
        one = np.float32(1.0)
        groups: Dict[tuple, List] = defaultdict(list)
        for p, g in params_grads:
            st = self._param_state(p)
            groups[(float(st["b1p"]), float(st["b2p"]))].append((p, g, st))
        for (b1p, b2p), items in groups.items():
            b1p, b2p = np.float32(b1p), np.float32(b2p)
            lr_t = lr * np.sqrt(one - b2p * b2) / (one - b1p * b1)
            # the update runs on the f32 master where there is one
            ps = [st.get("master", p) for p, _, st in items]
            gs = [g.float() for _, g, _ in items]
            m1 = [st["m1"] for _, _, st in items]
            m2 = [st["m2"] for _, _, st in items]
            # the moment coefficients as the JAX op forms them: Python
            # floats applied to f32 tensors
            torch._foreach_mul_(m1, self._beta1)
            torch._foreach_add_(m1, gs, alpha=1.0 - self._beta1)
            torch._foreach_mul_(m2, self._beta2)
            torch._foreach_addcmul_(m2, gs, gs, value=1.0 - self._beta2)
            denom = torch._foreach_sqrt(m2)
            torch._foreach_add_(denom, float(self._epsilon))
            torch._foreach_addcdiv_(ps, m1, denom, value=-float(lr_t))
            for p, _, st in items:
                if "master" in st:
                    p.copy_(st["master"])
                st["b1p"] = b1p * b1
                st["b2p"] = b2p * b2


def _unported(name):
    def init(self, *a, **k):
        raise NotImplementedError(f"{name} is not ported (ROADMAP.md)")
    return type(name, (Optimizer,), {"__init__": init})


LambOptimizer = _unported("LambOptimizer")
AdamWOptimizer = _unported("AdamWOptimizer")
