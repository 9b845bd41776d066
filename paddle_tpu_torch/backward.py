"""Static autodiff: append_backward as a program rewrite (counterpart of
``paddle_tpu/backward.py``; reference:
python/paddle/fluid/backward.py:1193).

Grad ops are real ops in the program, made by the op registry's grad
makers (``ops/registry.py``), so the port writes the same backward
program as the JAX package.  Repeated-grad accumulation is done online:
when a second partial for ``X@GRAD`` is produced it is renamed and
immediately summed.  ``gradients`` (:217) is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .framework import unique_name
from .framework.core import (
    EMPTY_VAR_NAME,
    GRAD_SUFFIX,
    Block,
    Parameter,
    Variable,
)
from .framework.dtype import VarType
from .ops import registry

# Reference op-role attr values (framework.h OpRole) so transpilers /
# AMP passes can classify ops the same way the reference does.
class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


OP_ROLE_KEY = "op_role"
OP_ROLE_VAR_KEY = "op_role_var"


def _ensure_grad_var(block: Block, grad_name: str):
    if grad_name == EMPTY_VAR_NAME or block.has_var(grad_name):
        return
    base = grad_name
    # renamed accumulation slots (X@GRAD@RENAME_0) and higher-order
    # collision renames (X@GRAD@GRADX_0) both reduce to their base name
    if "@RENAME" in base:
        base = base.split("@RENAME")[0]
    if "@GRADX" in base:
        base = base.split("@GRADX")[0]
    fwd_name = base[: -len(GRAD_SUFFIX)] if base.endswith(GRAD_SUFFIX) else None
    fvar = block._find_var_recursive(fwd_name) if fwd_name else None
    if fvar is not None:
        block.create_var(
            name=grad_name, shape=fvar.shape, dtype=fvar.dtype, persistable=False
        )
    else:
        block.create_var(name=grad_name, shape=(), dtype=VarType.FP32)


def _collect_no_grad(block: Block, no_grad_set) -> Set[str]:
    names = set(no_grad_set or [])
    for var in block.vars.values():
        if var.stop_gradient and not isinstance(var, Parameter):
            names.add(var.name)
        if isinstance(var, Parameter) and not var.trainable:
            names.add(var.name)
    return names


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set=None,
    callbacks=None,
    checkpoints=None,
) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for ``loss`` and return [(param, grad_var)]."""
    block = loss.block
    program = block.program
    no_grad_names = _collect_no_grad(block, no_grad_set)

    loss_idx = None
    for i, op_ in enumerate(block.ops):
        if loss.name in op_.output_arg_names:
            loss_idx = i
    if loss_idx is None:
        raise ValueError(f"loss var {loss.name!r} is not produced by any op")

    # d(loss)/d(loss) = 1
    loss_grad_name = loss.name + GRAD_SUFFIX
    _ensure_grad_var(block, loss_grad_name)
    block.append_op(
        "fill_constant",
        outputs={"Out": [loss_grad_name]},
        attrs={
            "shape": list(loss.shape),
            "value": 1.0,
            "dtype": int(loss.dtype),
            OP_ROLE_KEY: OpRole.Backward | OpRole.Loss,
        },
    )

    known_grads: Set[str] = {loss_grad_name}
    produced: Set[str] = {loss_grad_name}
    # Higher-order support: when a grad var name collides with one that
    # already exists in the block from an earlier append_backward (e.g.
    # "x@GRAD" while computing grad-of-grad), this pass's grad gets a
    # fresh name; the map tracks original->actual for this pass.
    rename: Dict[str, str] = {}
    created: Set[str] = {loss_grad_name}

    def _actual_out(n: str) -> str:
        if n == EMPTY_VAR_NAME or not n.endswith(GRAD_SUFFIX):
            return n
        if n in rename:
            return rename[n]
        if block.has_var(n) and n not in created:
            fresh = unique_name.generate(n + "@GRADX")
            rename[n] = fresh
            return fresh
        return n

    for op_ in reversed(block.ops[: loss_idx + 1]):
        if not registry.has_grad(op_.type):
            continue
        out_grads = [n + GRAD_SUFFIX for n in op_.output_arg_names if n != EMPTY_VAR_NAME]
        if not any(g in known_grads for g in out_grads):
            continue
        grad_descs = registry.make_grad_ops(op_, no_grad_names)
        for desc in grad_descs:
            # cotangent slots: the ones the maker added for the fwd op's
            # outputs (an endswith test would also catch @GRAD-named DATA
            # inputs of grad-of-grad ops)
            fwd_outs = desc.get("attrs", {}).get("__fwd_out_slots__")
            if fwd_outs is not None:
                cot_slots = {s + GRAD_SUFFIX for s in fwd_outs}
            else:
                cot_slots = {s for s in desc["inputs"]
                             if s.endswith(GRAD_SUFFIX)}
            # rewrite unavailable input grads to @EMPTY@ (treated as
            # zeros), mapping through this pass's renames
            for slot, names in desc["inputs"].items():
                if slot in cot_slots:
                    desc["inputs"][slot] = [
                        (rename.get(n, n)
                         if n in known_grads or not n.endswith(GRAD_SUFFIX)
                         else EMPTY_VAR_NAME)
                        for n in names
                    ]
            # online accumulation of repeated grads (names first mapped
            # through the higher-order rename)
            accum_pairs = []
            for slot, names in desc["outputs"].items():
                new_names = []
                for n in names:
                    if n == EMPTY_VAR_NAME or not n.endswith(GRAD_SUFFIX):
                        new_names.append(n)
                        continue
                    actual = _actual_out(n)
                    if n in produced:
                        renamed = unique_name.generate(actual + "@RENAME")
                        accum_pairs.append((actual, renamed))
                        new_names.append(renamed)
                    else:
                        new_names.append(actual)
                        created.add(actual)
                    produced.add(n)
                    known_grads.add(n)
                desc["outputs"][slot] = new_names

            for slot, names in {**desc["inputs"], **desc["outputs"]}.items():
                for n in names:
                    _ensure_grad_var(block, n)
            attrs = dict(desc.get("attrs") or {})
            attrs.setdefault(OP_ROLE_KEY, OpRole.Backward)
            block.append_op(
                desc["type"], inputs=desc["inputs"], outputs=desc["outputs"], attrs=attrs
            )
            for target, renamed in accum_pairs:
                block.append_op(
                    "sum",
                    inputs={"X": [target, renamed]},
                    outputs={"Out": [target]},
                    attrs={OP_ROLE_KEY: OpRole.Backward},
                )

    # collect (param, grad) pairs
    params: List[Parameter]
    if parameter_list is not None:
        params = [
            block.var_recursive(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = program.all_parameters()
    result = []
    for p in params:
        if not getattr(p, "trainable", True) or p.name in no_grad_names:
            continue
        gname = p.name + GRAD_SUFFIX
        if gname in known_grads:
            gvar = block.var_recursive(rename.get(gname, gname))
            result.append((p, gvar))
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: fluid.gradients — not ported (ROADMAP.md)."""
    raise NotImplementedError("fluid.gradients is not ported (ROADMAP.md)")
