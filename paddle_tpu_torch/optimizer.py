"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``), static and
dygraph.

Static (``optimizer.py:107-306``): ``Optimizer.minimize(loss)`` on a
program ``Variable`` runs ``append_backward``, then ``apply_gradients``
in JAX's order: the ``(param, grad)`` pairs sorted by name, the gradient
clip (the optimizer's ``grad_clip=``, else the one given to
``clip.set_gradient_clip``: ``clip.py``), the weight decay
(``regularization=``, or a parameter's ``ParamAttr(regularizer=)``,
which takes precedence: ``regularizer.py``), then one update op per
parameter (``ops/optimizer_ops.py``), each reading the learning rate (a
persistable ``[1]`` var, or the var a schedule of
``layers/learning_rate_scheduler.py`` computes in the program; a
``scale`` of it for a ``ParamAttr(learning_rate=)`` other than 1), with
the accumulators initialized in the startup program, as in JAX.  Every
optimizer of the JAX module has this form:

* ``SGDOptimizer`` (``sgd``), ``MomentumOptimizer`` (``momentum``),
  ``LarsMomentumOptimizer`` :487 (``lars_momentum``),
  ``AdamOptimizer`` :514 (``adam``, beta-power accumulators per
  parameter), ``AdamWOptimizer`` :915, ``AdagradOptimizer`` :941,
  ``DecayedAdagradOptimizer`` :983, ``AdadeltaOptimizer`` :1006,
  ``AdamaxOptimizer`` :1032 (its beta power advanced by a ``scale``
  op), ``RMSPropOptimizer`` :1067, ``FtrlOptimizer`` :1099,
  ``LambOptimizer`` :1126 (``exclude_from_weight_decay_fn``),
  ``DpsgdOptimizer`` :1157, and the short aliases :1480-1494;
* the wrappers ``RecomputeOptimizer`` :1177 (forwards and records its
  checkpoints), ``LookaheadOptimizer`` :1263 (an ``@SLOW`` copy of each
  parameter moved toward it every step), ``ExponentialMovingAverage``
  :1303 (``@EMA`` vars; ``apply`` swaps them into the global scope and
  restores the parameters on exit) and ``ModelAverage`` :1364
  (``average_accumulates`` ops; ``apply(scope=)`` swaps in the window
  average, ``restore`` swaps back).

The executor's ``fuse_optimizer_ops_pass`` turns the ``sgd``,
``momentum`` and ``adam`` ops of a program into one fused op each, as
JAX's does.  ``DGCMomentumOptimizer`` and ``PipelineOptimizer`` need
collectives and the pipeline runner, which the port does not have: they
raise.

Dygraph: ``minimize(loss)`` on a tensor applies one update from each
parameter's ``.grad`` (the weight decay added first,
``optimizer.py:266-274``), on the parameter's own device.  SGD, Momentum
and Adagrad update through their static ops' lowerings
(``registry.eager_call``), as JAX's ``_eager_update`` does (:321, :353,
:965).  :class:`AdamOptimizer` (``optimizer.py:514-643``) is Paddle's
Adam, not ``torch.optim.Adam``: the beta-power accumulators start at 1.0
and are multiplied after each update, and epsilon is added to the
*uncorrected* ``sqrt(v)``:

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
master in its state (an fp16 one likewise), seeded from the upcast of
the bf16 value at its first update (not from any earlier f32 value), and
f32 moments; its gradient is upcast to f32, the update runs on the
master, and the parameter becomes the bf16 cast of the master after
every step.  JAX packs the masters into one flat buffer, a TPU layout;
the per-parameter ``_foreach`` update over the masters computes the same
elementwise update.  The other dygraph forms (AdamW, LAMB and the rest)
are not ported.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .backward import OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole, append_backward
from .framework import unique_name
from .framework.core import (Variable, default_main_program,
                             default_startup_program, program_guard)
from .framework.dtype import VarType
from .layer_helper import LayerHelper
from .ops.registry import eager_call

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "DGCMomentumOptimizer", "LarsMomentumOptimizer", "AdamOptimizer",
           "AdamWOptimizer", "AdagradOptimizer", "DecayedAdagradOptimizer",
           "AdadeltaOptimizer", "AdamaxOptimizer", "RMSPropOptimizer",
           "FtrlOptimizer", "LambOptimizer", "DpsgdOptimizer",
           "RecomputeOptimizer", "PipelineOptimizer", "LookaheadOptimizer",
           "ExponentialMovingAverage", "ModelAverage", "SGD", "Momentum",
           "Adam", "AdamW", "Adagrad", "Adamax", "Adadelta", "RMSProp",
           "Ftrl", "Lamb", "Dpsgd", "LarsMomentum"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._parameter_list = (list(parameter_list)
                                if parameter_list is not None else None)
        self._name = name
        # static form: accumulator vars by kind and parameter name, and
        # the learning-rate var of each program
        self._accumulators: Dict[str, Dict[str, Variable]] = \
            defaultdict(dict)
        self._learning_rate_map: Dict[int, Variable] = {}
        # dygraph form: each parameter's state, by id
        self._state: Dict[int, dict] = {}

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
        """The rate var of ``param``: the global one, or a ``scale`` of it
        by the parameter's ``ParamAttr(learning_rate=)``."""
        lr = self._global_learning_rate()
        plr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if plr == 1.0:
            return lr
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference(lr.dtype,
                                                        stop_gradient=True)
        helper.append_op("scale", inputs={"X": [lr]}, outputs={"Out": [out]},
                         attrs={"scale": float(plr),
                                OP_ROLE_KEY: OpRole.Optimize})
        return out

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

    def _finish_update(self, block, params_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        parameter_list = parameter_list or self._parameter_list
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Clip, decay and update ``params_grads`` (sorted by name, as in
        JAX); returns the update ops."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        if self._grad_clip is not None:
            params_grads = self._grad_clip._process(params_grads)
        else:
            from .clip import _global_clip

            if _global_clip[0] is not None:
                params_grads = _global_clip[0]._process(params_grads)
        params_grads = self._append_regularization_ops(params_grads)
        return self._create_optimization_pass(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(default_main_program(), startup_program):
            return self.apply_gradients(params_grads)

    def _regularizer(self, param):
        """The parameter's own regularizer, else the optimizer's."""
        return getattr(param, "regularizer", None) or self.regularization

    def _append_regularization_ops(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            reg = self._regularizer(p)
            out.append((p, g) if g is None or reg is None
                       else (p, reg(p, g, block)))
        return out

    def _create_optimization_pass(self, params_grads):
        main_block = default_main_program().global_block()
        self._create_global_learning_rate()
        self._create_accumulators(
            main_block, [p for p, g in params_grads if g is not None])
        optimize_ops = []
        for p, g in params_grads:
            if g is None:
                continue
            op = self._append_optimize_op(main_block, (p, g))
            if op is not None:
                op.attrs[OP_ROLE_KEY] = OpRole.Optimize
                op.attrs[OP_ROLE_VAR_KEY] = [p.name, g.name]
                optimize_ops.append(op)
        self._finish_update(main_block, params_grads)
        return optimize_ops

    def _eager_regularize(self, p, g):
        """The dygraph form of the weight decay, on tensors."""
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer

        reg = self._regularizer(p)
        if isinstance(reg, L2DecayRegularizer):
            return g + reg.regularization_coeff * p
        if isinstance(reg, L1DecayRegularizer):
            return g + reg.regularization_coeff * torch.sign(p)
        return g

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
            self._apply([(p, self._eager_regularize(p, g))
                         for p, g in params_grads])
        return None, params_grads

    # -- dygraph form --------------------------------------------------
    def _eager_lr(self, device) -> torch.Tensor:
        """The rate as JAX's eager update feeds it: a ``[1]`` f32 tensor
        (of a schedule's current value when the rate is callable)."""
        lr = self._learning_rate
        if callable(lr):
            lr = lr()
        return torch.tensor([float(lr)], dtype=torch.float32, device=device)

    def _apply(self, params_grads):
        """One update of each ``(param, grad)``: each parameter through
        :meth:`_eager_update`, with its state."""
        lrs: Dict[torch.device, torch.Tensor] = {}
        for p, g in params_grads:
            lr = lrs.get(p.device)
            if lr is None:
                lr = lrs[p.device] = self._eager_lr(p.device)
            self._eager_update(p, g, self._state.setdefault(id(p), {}), lr)

    def _eager_update(self, p, g, state, lr):
        raise NotImplementedError(
            f"{type(self).__name__} has no dygraph update in the port")


class SGDOptimizer(Optimizer):
    """``p -= lr * g`` (``optimizer.py:307``)."""

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]})

    def _eager_update(self, p, g, state, lr):
        outs = eager_call("sgd", {"Param": [p], "Grad": [g],
                                  "LearningRate": [lr]}, {}, {"ParamOut": 1})
        p.copy_(outs["ParamOut"][0])


class MomentumOptimizer(Optimizer):
    """``v = mu * v + g; p -= lr * v`` (``optimizer.py:330``)."""

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

    def _eager_update(self, p, g, state, lr):
        if "velocity" not in state:
            state["velocity"] = torch.zeros_like(p)
        outs = eager_call(
            "momentum", {"Param": [p], "Grad": [g],
                         "Velocity": [state["velocity"]],
                         "LearningRate": [lr]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
            {"ParamOut": 1, "VelocityOut": 1})
        p.copy_(outs["ParamOut"][0])
        state["velocity"] = outs["VelocityOut"][0]


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression (``optimizer.py:371``): its sparse
    exchange and dense ``c_allreduce_sum`` need the collectives, which
    the port does not have (ROADMAP Queue 1 item 5)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DGCMomentumOptimizer needs the "
                                  "collectives, which are not ported")


class LarsMomentumOptimizer(Optimizer):
    """Layer-wise adaptive rate scaling (You, Gitman and Ginsburg,
    arXiv:1708.03888; ``optimizer.py:487``): momentum on a per-parameter
    rate ``lr * lars_coeff * |p| / (|g| + lars_weight_decay * |p|)``."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdamOptimizer(Optimizer):
    """Adam.  ``lazy_mode`` updates only the rows a SelectedRows gradient
    touches, and acts only on an ``adam`` op that
    ``fuse_optimizer_ops_pass`` leaves alone: the pass, as JAX's, groups
    a sparse update with the dense ones sharing its rate and attributes
    into ``fused_adam``, which sees the densified gradient, so with two
    or more such parameters every row's moments decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    # -- static form (optimizer.py:523-545) ----------------------------
    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=1.0,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=1.0,
                                  shape=[1])

    def _adam_slots(self, p, g):
        """(inputs, outputs) of p's Adam-family update op."""
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return ({"Param": [p], "Grad": [g], "Moment1": [m1],
                 "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                 "LearningRate": [self._create_param_lr(p)]},
                {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                 "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]})

    def _append_optimize_op(self, block, param_and_grad):
        inputs, outputs = self._adam_slots(*param_and_grad)
        return block.append_op(
            "adam", inputs=inputs, outputs=outputs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})

    # -- dygraph form --------------------------------------------------
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


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay (``optimizer.py:915``); its
    dygraph form is not ported."""

    _apply = Optimizer._apply

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        inputs, outputs = self._adam_slots(*param_and_grad)
        return block.append_op(
            "adamw", inputs=inputs, outputs=outputs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "coeff": self._coeff,
                   "with_decay": True})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})

    def _eager_update(self, p, g, state, lr):
        if "moment" not in state:
            state["moment"] = torch.full_like(p, self._initial)
        outs = eager_call(
            "adagrad", {"Param": [p], "Grad": [g],
                        "Moment": [state["moment"]], "LearningRate": [lr]},
            {"epsilon": self._epsilon}, {"ParamOut": 1, "MomentOut": 1})
        p.copy_(outs["ParamOut"][0])
        state["moment"] = outs["MomentOut"][0]


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        op = block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        # the beta power advances after the update
        block.append_op("scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1,
                               OP_ROLE_KEY: OpRole.Optimize})
        return op


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """Layer-wise adaptive moments (``optimizer.py:1126``): Adam's
    moments with a per-parameter trust ratio; ``exclude_from_weight_
    decay_fn(param)`` true turns the decay off for that parameter.  Its
    dygraph form is not ported."""

    _apply = Optimizer._apply

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        inputs, outputs = self._adam_slots(*param_and_grad)
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            "lamb", inputs=inputs, outputs=outputs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class RecomputeOptimizer(Optimizer):
    """Activation recompute (``optimizer.py:1177``): forwards to the
    inner optimizer and records the checkpoints, as JAX's does (JAX
    plans their use at trace time; the port's op-by-op executor keeps
    every activation the backward reads)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self._optimizer.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class PipelineOptimizer:
    """Pipeline parallelism (``optimizer.py:1212``): its runner splits a
    program across devices, which the port does not have (ROADMAP Queue
    1 item 5)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("PipelineOptimizer needs the pipeline "
                                  "runner, which is not ported")


class LookaheadOptimizer:
    """Slow / fast weights (``optimizer.py:1263``), as JAX forms them:
    after the inner update, each parameter's ``@SLOW`` copy (seeded from
    the parameter in the startup program) moves toward the parameter
    by ``alpha / k`` every step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        mini_out = self.inner_optimizer.minimize(loss, startup_program)
        helper = LayerHelper("lookahead")
        block = default_main_program().global_block()
        rate = self.alpha / float(self.k)
        for p in default_main_program().all_parameters():
            slow = self._slow_var(p)
            mixed = helper.create_variable_for_type_inference(p.dtype)
            block.append_op("scale", inputs={"X": [slow]},
                            outputs={"Out": [slow]},
                            attrs={"scale": 1.0 - rate,
                                   OP_ROLE_KEY: OpRole.Optimize})
            block.append_op("scale", inputs={"X": [p]},
                            outputs={"Out": [mixed]},
                            attrs={"scale": rate,
                                   OP_ROLE_KEY: OpRole.Optimize})
            block.append_op("sum", inputs={"X": [slow, mixed]},
                            outputs={"Out": [slow]},
                            attrs={OP_ROLE_KEY: OpRole.Optimize})
        return mini_out

    def _slow_var(self, p):
        name = p.name + "@SLOW"
        block = default_main_program().global_block()
        if block.has_var(name):
            return block.var(name)
        var = block.create_var(name=name, shape=p.shape, dtype=p.dtype,
                               persistable=True, stop_gradient=True)
        sblock = default_startup_program().global_block()
        sblock.create_var(name=name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
        sblock.append_op("assign", inputs={"X": [p.name]},
                         outputs={"Out": [name]})
        return var


class ExponentialMovingAverage:
    """``@EMA`` copies of every parameter (``optimizer.py:1303``):
    ``update()`` appends ``ema = decay * ema + (1 - decay) * p`` for each
    to the main program (each seeded from its parameter in the startup
    program); ``apply()`` is a context in which the global scope holds
    the averages in the parameters' names, restored on exit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars = {}

    def update(self):
        block = default_main_program().global_block()
        helper = LayerHelper("ema")
        for p in default_main_program().all_parameters():
            ema = self._create_ema_var(p)
            tmp = helper.create_variable_for_type_inference(p.dtype)
            block.append_op("scale", inputs={"X": [ema]},
                            outputs={"Out": [ema]},
                            attrs={"scale": self._decay})
            block.append_op("scale", inputs={"X": [p]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op("sum", inputs={"X": [ema, tmp]},
                            outputs={"Out": [ema]})

    def _create_ema_var(self, p):
        name = p.name + "@EMA" + self._name
        if name in self._ema_vars:
            return self._ema_vars[name]
        block = default_main_program().global_block()
        var = block.create_var(name=name, shape=p.shape, dtype=p.dtype,
                               persistable=True, stop_gradient=True)
        sblock = default_startup_program().global_block()
        sblock.create_var(name=name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
        sblock.append_op("assign", inputs={"X": [p.name]},
                         outputs={"Out": [name]})
        self._ema_vars[name] = var
        return var

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def _guard():
            from .framework.scope import global_scope

            saved = {}
            scope = global_scope()
            for p in default_main_program().all_parameters():
                ema_name = p.name + "@EMA" + self._name
                if scope.has(ema_name):
                    saved[p.name] = scope.get(p.name)
                    # a copy: a step run meanwhile updates the parameter,
                    # never the average
                    scope.set(p.name, scope.get(ema_name).clone())
            try:
                yield
            finally:
                if need_restore:
                    for name, val in saved.items():
                        scope.set(name, val)

        return _guard()

    def restore(self, executor=None):
        pass


class ModelAverage(Optimizer):
    """Windowed parameter averaging (``optimizer.py:1364``): one
    ``average_accumulates`` op per trainable parameter of the current
    main program (build it after ``minimize``); ``apply(scope=)`` swaps
    each parameter for ``(sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates)`` and ``restore()`` (or the context's exit)
    swaps back."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization=regularization, name=name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._accums = []  # (param_name, s1, s2, s3, na, ona, nu)
        main = default_main_program()
        startup = default_startup_program()
        for p in main.all_parameters():
            if not getattr(p, "trainable", True):
                continue
            self._append_average_accumulate_op(main, startup, p)
        self._restore_vals = None

    def _append_average_accumulate_op(self, main, startup, param):
        block = main.global_block()
        sblock = startup.global_block()

        def acc(suffix, shape, dtype, value=0.0):
            name = f"{param.name}_{suffix}{self._name or ''}"
            block.create_var(name=name, shape=shape, dtype=dtype,
                             persistable=True)
            sblock.create_var(name=name, shape=shape, dtype=dtype,
                              persistable=True)
            sblock.append_op(
                "fill_constant", inputs={}, outputs={"Out": [name]},
                attrs={"shape": list(shape), "value": value,
                       "dtype": int(VarType(dtype))})
            return name

        shape = list(param.shape)
        s1 = acc("sum_1", shape, param.dtype)
        s2 = acc("sum_2", shape, param.dtype)
        s3 = acc("sum_3", shape, param.dtype)
        na = acc("num_accumulates", [1], VarType.INT64)
        ona = acc("old_num_accumulates", [1], VarType.INT64)
        nu = acc("num_updates", [1], VarType.INT64)
        block.append_op(
            "average_accumulates",
            inputs={"param": [param.name], "in_sum_1": [s1],
                    "in_sum_2": [s2], "in_sum_3": [s3],
                    "in_num_accumulates": [na],
                    "in_old_num_accumulates": [ona],
                    "in_num_updates": [nu]},
            outputs={"out_sum_1": [s1], "out_sum_2": [s2],
                     "out_sum_3": [s3], "out_num_accumulates": [na],
                     "out_old_num_accumulates": [ona],
                     "out_num_updates": [nu]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window,
                   OP_ROLE_KEY: OpRole.Optimize})
        self._accums.append((param.name, s1, s2, s3, na, ona, nu))

    def _averaged(self, scope, entry) -> torch.Tensor:
        """The window average of one parameter, on its device (a count of
        0 divides by 1)."""
        _, s1, s2, s3, na, ona, _ = entry
        total = scope.get(s1) + scope.get(s2) + scope.get(s3)
        count = (scope.get(na) + scope.get(ona)).to(total.dtype)
        return total / count.clamp_min(1.0)

    def apply(self, executor=None, need_restore=True, scope=None):
        @contextlib.contextmanager
        def _guard():
            self._swap_in(scope)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor, scope=scope)

        return _guard()

    def _resolve_scope(self, scope):
        if scope is not None:
            return scope
        from .framework.scope import global_scope

        return global_scope()

    def _swap_in(self, scope=None):
        scope = self._resolve_scope(scope)
        self._restore_vals = {}
        for entry in self._accums:
            pname = entry[0]
            if scope.get(entry[1]) is None:
                raise RuntimeError(
                    f"ModelAverage accumulators for {pname!r} not found in "
                    "the scope: pass the training scope via "
                    "apply(..., scope=your_scope) when not using the "
                    "global scope")
            self._restore_vals[pname] = scope.get(pname)
            scope.set(pname, self._averaged(scope, entry))

    def restore(self, executor=None, scope=None):
        if not self._restore_vals:
            return
        scope = self._resolve_scope(scope)
        for name, val in self._restore_vals.items():
            scope.set(name, val)
        self._restore_vals = None


# 2.0-style short aliases (reference: paddle.optimizer namespace)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
Dpsgd = DpsgdOptimizer
LarsMomentum = LarsMomentumOptimizer
