"""Program rewrite passes (counterpart of ``paddle_tpu/framework/ir.py``).

Reference: paddle/fluid/framework/ir/pass.h:38 (Pass / PassRegistry),
ir/fuse_pass_base.h.  The Program's op list is the graph (vars link ops
by name), so a pass is a Python function over Blocks.

Ported: the registry (``Pass``, ``register_pass``, ``get_pass``,
``PassManager``, :30-98), the graph helpers (:99-126), the BatchNorm
fusions ``fuse_bn_act_pass`` (:489) and ``fuse_bn_add_act_pass`` (:570),
and the conv half of ``fuse_epilogue_pass`` (:711-869), which maps conv
-> BN (-> add) -> relu chains, forward and backward together, onto
``fused_conv_bn_act`` and its grad, whose epilogues are the hand-written
kernels of ``ops/bn_act.py``.  The rewrites are the JAX package's, op
for op, so both packages compile a program to the same op list.

Not ported (ROADMAP.md): the static verifier that brackets every pass
under ``FLAGS_verify_passes``, the matmul half of the epilogue pass,
``layout_transform_pass``, ``fuse_optimizer_ops_pass`` and the other
passes of the JAX module.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .core import Block, Operator, Program

__all__ = ["PASS_REGISTRY", "Pass", "register_pass", "get_pass",
           "PassManager", "producer_map", "consumer_count", "remove_ops",
           "FuseBNActPass", "FuseBNAddActPass", "FuseEpiloguePass"]

# --------------------------------------------------------------------------
# pass registry (reference: pass.h REGISTER_PASS)
# --------------------------------------------------------------------------
PASS_REGISTRY: Dict[str, type] = {}


class Pass:
    """Base pass: override apply_impl(program) -> program."""

    name: str = ""

    def apply(self, program: Program) -> Program:
        out = self.apply_impl(program)
        return out if out is not None else program

    def apply_impl(self, program: Program) -> Optional[Program]:
        raise NotImplementedError

    def set(self, **attrs):
        """Attribute injection like the reference's Pass::Set."""
        for k, v in attrs.items():
            setattr(self, k, v)
        return self


def register_pass(name: str):
    def deco(cls):
        cls.name = name
        PASS_REGISTRY[name] = cls
        return cls

    return deco


def get_pass(name: str, **attrs) -> Pass:
    try:
        cls = PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"pass {name!r} is not registered; have {sorted(PASS_REGISTRY)}"
        ) from None
    return cls().set(**attrs)


class _NotPorted(Pass):
    """A JAX-package pass the port has not taken yet: getting it works
    (a pipeline may name it), applying it raises."""

    def apply_impl(self, program):
        raise NotImplementedError(f"{self.name} is not ported (ROADMAP.md)")


for _name in ("layout_transform_pass", "fuse_optimizer_ops_pass",
              "memory_relief_pass"):
    register_pass(_name)(type(_name, (_NotPorted,), {}))


class PassManager:
    """Ordered pass pipeline (reference: the analysis pass manager /
    build-strategy pass application loop)."""

    def __init__(self, passes: Sequence):
        self.passes = [p if isinstance(p, Pass) else get_pass(p)
                       for p in passes]

    def apply(self, program: Program) -> Program:
        for p in self.passes:
            program = p.apply(program)
        return program


# --------------------------------------------------------------------------
# graph utilities
# --------------------------------------------------------------------------
def producer_map(block: Block) -> Dict[str, Operator]:
    """var name -> last op writing it (SSA-enough for matched subgraphs)."""
    prod = {}
    for op_ in block.ops:
        for names in op_.outputs.values():
            for n in names:
                prod[n] = op_
    return prod


def consumer_count(block: Block) -> Dict[str, int]:
    cnt: Dict[str, int] = {}
    for op_ in block.ops:
        for names in op_.inputs.values():
            for n in names:
                cnt[n] = cnt.get(n, 0) + 1
    return cnt


def remove_ops(block: Block, ops: Sequence[Operator]):
    dead = set(id(o) for o in ops)
    block.ops[:] = [o for o in block.ops if id(o) not in dead]
    block.program._bump_version()


# --------------------------------------------------------------------------
# BatchNorm + activation fusions (reference: BuildStrategy
# fuse_bn_act_ops / fuse_bn_add_act_ops)
# --------------------------------------------------------------------------
def _consumers(block):
    cons: Dict[str, List[Operator]] = {}
    for op_ in block.ops:
        for names in op_.inputs.values():
            for n in names:
                cons.setdefault(n, []).append(op_)
    return cons


class _FuseBNActBase(Pass):
    #: vars the rewrite must not make unavailable (fetch targets)
    protected: Sequence[str] = ()

    def apply_impl(self, program):
        fused = 0
        for block in program.blocks:
            # vars referenced from ANY other block (while/cond carries,
            # sub-block free vars) are invisible to this block's consumer
            # map — never fuse away their producers
            external = set()
            for other in program.blocks:
                if other is block:
                    continue
                for op_ in other.ops:
                    for names in op_.inputs.values():
                        external.update(names)
                    for names in op_.outputs.values():
                        external.update(names)
            fused += self._apply_block(block, external)
        self.fused_count = fused
        if fused:
            program._bump_version()
        return program


@register_pass("fuse_bn_act_pass")
class FuseBNActPass(_FuseBNActBase):
    """batch_norm -> relu  (and its grad chain)  ==> fused_batch_norm_act."""

    def _apply_block(self, block, external=()):
        protected = set(self.protected) | set(external)
        fused = 0
        changed = True
        while changed:
            changed = False
            cons = _consumers(block)
            for bn in list(block.ops):
                if bn.type != "batch_norm":
                    continue
                y0 = bn.outputs.get("Y", [None])[0]
                if not y0 or y0 in protected:
                    continue
                users = cons.get(y0, [])
                relu = next((o for o in users if o.type == "relu"
                             and o.inputs.get("X", [None])[0] == y0), None)
                if relu is None:
                    continue
                bn_grad = next((o for o in users if o.type == "batch_norm_grad"
                                and o.inputs.get("Y", [None])[0] == y0), None)
                relu_grad = next(
                    (o for o in users if o.type == "relu_grad"
                     and o.inputs.get("X", [None])[0] == y0), None)
                allowed = {id(relu), id(bn_grad), id(relu_grad)}
                if any(id(o) not in allowed for o in users):
                    continue
                y1 = relu.outputs["Out"][0]
                if (bn_grad is None) != (relu_grad is None):
                    continue  # half a backward: leave it alone
                if bn_grad is not None:
                    # relu_grad must feed exactly bn_grad's dY, and the
                    # rewrite stops producing dy0 — so it must not be a
                    # fetch target either
                    dy0 = relu_grad.outputs.get("X@GRAD", [None])[0]
                    if (dy0 in protected
                            or bn_grad.inputs.get("Y@GRAD", [None])[0] != dy0
                            or any(id(o) != id(bn_grad)
                                   for o in cons.get(dy0, []))):
                        continue
                    if relu_grad.inputs.get("Out", [None])[0] != y1:
                        continue
                # ---- rewrite forward
                idx = block.ops.index(bn)
                attrs = dict(bn.attrs)
                attrs["act_type"] = "relu"
                inputs = {k: list(v) for k, v in bn.inputs.items()}
                outputs = {k: list(v) for k, v in bn.outputs.items()}
                outputs["Y"] = [y1]
                remove_ops(block, [bn, relu])
                block._insert_op(idx, "fused_batch_norm_act",
                                 inputs=inputs, outputs=outputs, attrs=attrs)
                # ---- rewrite backward
                if bn_grad is not None:
                    gidx = block.ops.index(relu_grad)
                    ginputs = {
                        "X": list(bn.inputs["X"]),
                        "Y": [y1],
                        "Scale": list(bn.inputs["Scale"]),
                        "SavedMean": list(bn.outputs["SavedMean"]),
                        "SavedVariance": list(bn.outputs["SavedVariance"]),
                        "Y@GRAD": list(relu_grad.inputs["Out@GRAD"]),
                    }
                    goutputs = {
                        "X@GRAD": list(bn_grad.outputs.get("X@GRAD", [])),
                        "Scale@GRAD": list(bn_grad.outputs.get("Scale@GRAD", [])),
                        "Bias@GRAD": list(bn_grad.outputs.get("Bias@GRAD", [])),
                    }
                    remove_ops(block, [relu_grad, bn_grad])
                    block._insert_op(gidx, "fused_batch_norm_act_grad",
                                     inputs=ginputs, outputs=goutputs,
                                     attrs=dict(attrs))
                fused += 1
                changed = True
                break
        return fused


@register_pass("fuse_bn_add_act_pass")
class FuseBNAddActPass(_FuseBNActBase):
    """batch_norm -> elementwise_add -> relu (and grads) ==>
    fused_bn_add_activation.  Only same-shape adds with the default axis
    are fused (a broadcasting add is not the cudnn pattern and the fused
    kernel would reinterpret it)."""

    def _apply_block(self, block, external=()):
        protected = set(self.protected) | set(external)
        fused = 0
        changed = True
        while changed:
            changed = False
            cons = _consumers(block)
            for bn in list(block.ops):
                if bn.type != "batch_norm":
                    continue
                y0 = bn.outputs.get("Y", [None])[0]
                if not y0 or y0 in protected:
                    continue
                users = cons.get(y0, [])
                add = next((o for o in users if o.type == "elementwise_add"
                            and o.attrs.get("axis", -1) == -1
                            and y0 in (o.inputs.get("X", [None])[0],
                                       o.inputs.get("Y", [None])[0])), None)
                if add is None:
                    continue
                bn_grad = next((o for o in users if o.type == "batch_norm_grad"
                                and o.inputs.get("Y", [None])[0] == y0), None)
                # the replayed elementwise_add_grad desc re-reads the
                # forward's X/Y, so it legitimately appears among y0's
                # (and ya's) consumers
                add_grad = next(
                    (o for o in users if o.type == "elementwise_add_grad"
                     and o.inputs.get("X", [None]) == add.inputs.get("X")
                     and o.inputs.get("Y", [None]) == add.inputs.get("Y")),
                    None)
                if any(id(o) not in {id(add), id(bn_grad), id(add_grad)}
                       for o in users):
                    continue
                # z = the other operand; shapes must match exactly
                xn, yn = add.inputs["X"][0], add.inputs["Y"][0]
                z = xn if yn == y0 else yn
                bn_slot_is_y = yn == y0
                vy, vz = block._find_var_recursive(y0), \
                    block._find_var_recursive(z)
                if (vy is None or vz is None or vy.shape is None
                        or list(vy.shape) != list(vz.shape)):
                    continue
                ya = add.outputs["Out"][0]
                if ya in protected:
                    continue
                ya_users = cons.get(ya, [])
                relu = next((o for o in ya_users if o.type == "relu"
                             and o.inputs.get("X", [None])[0] == ya), None)
                if relu is None:
                    continue
                relu_grad = next(
                    (o for o in ya_users if o.type == "relu_grad"
                     and o.inputs.get("X", [None])[0] == ya), None)
                if any(id(o) not in {id(relu), id(relu_grad), id(add_grad)}
                       for o in ya_users):
                    continue
                if bn_grad is not None or relu_grad is not None \
                        or add_grad is not None:
                    if bn_grad is None or relu_grad is None \
                            or add_grad is None:
                        continue  # half a backward: leave it alone
                    dya = relu_grad.outputs.get("X@GRAD", [None])[0]
                    if (dya in protected
                            or add_grad.inputs.get("Out@GRAD", [None])[0] != dya
                            or any(id(o) != id(add_grad)
                                   for o in cons.get(dya, []))):
                        continue
                    # add_grad's bn-side output must feed exactly bn_grad
                    bn_side = "Y@GRAD" if bn_slot_is_y else "X@GRAD"
                    z_side = "X@GRAD" if bn_slot_is_y else "Y@GRAD"
                    dy0 = add_grad.outputs.get(bn_side, [None])[0]
                    if (dy0 is None or dy0 in protected
                            or bn_grad.inputs.get("Y@GRAD", [None])[0] != dy0
                            or any(id(o) != id(bn_grad)
                                   for o in cons.get(dy0, []))):
                        continue
                    dz = add_grad.outputs.get(z_side, [None])[0]
                    if relu_grad.inputs.get("Out", [None])[0] != \
                            relu.outputs["Out"][0]:
                        continue
                y1 = relu.outputs["Out"][0]
                # ---- rewrite forward
                idx = block.ops.index(relu)
                idx -= sum(1 for o in (bn, add)
                           if block.ops.index(o) < idx)
                attrs = dict(bn.attrs)
                attrs["act_type"] = "relu"
                inputs = {k: list(v) for k, v in bn.inputs.items()}
                inputs["Z"] = [z]
                outputs = {k: list(v) for k, v in bn.outputs.items()}
                outputs["Y"] = [y1]
                remove_ops(block, [bn, add, relu])
                block._insert_op(idx, "fused_bn_add_activation",
                                 inputs=inputs, outputs=outputs, attrs=attrs)
                # ---- rewrite backward
                if bn_grad is not None:
                    gidx = block.ops.index(relu_grad)
                    ginputs = {
                        "X": list(bn.inputs["X"]),
                        "Y": [y1],
                        "Scale": list(bn.inputs["Scale"]),
                        "SavedMean": list(bn.outputs["SavedMean"]),
                        "SavedVariance": list(bn.outputs["SavedVariance"]),
                        "Y@GRAD": list(relu_grad.inputs["Out@GRAD"]),
                    }
                    goutputs = {
                        "X@GRAD": list(bn_grad.outputs.get("X@GRAD", [])),
                        "Scale@GRAD": list(bn_grad.outputs.get("Scale@GRAD", [])),
                        "Bias@GRAD": list(bn_grad.outputs.get("Bias@GRAD", [])),
                        "Z@GRAD": [dz] if dz else [],
                    }
                    remove_ops(block, [relu_grad, add_grad, bn_grad])
                    block._insert_op(gidx, "fused_bn_add_activation_grad",
                                     inputs=ginputs, outputs=goutputs,
                                     attrs=dict(attrs))
                fused += 1
                changed = True
                break
        return fused


# --------------------------------------------------------------------------
# epilogue fusion: utils/cost_model.find_fusion_chains supplies the
# structural matches (so ranking and rewrite can never disagree) and
# rank_fusion_candidates orders them by saved bytes; this pass rewrites
# them best first onto fused_conv_bn_act (ops/fused_ops.py), forward and
# the matching grad chain together.  Gated by FLAGS_cuda_fuse in the
# executor pipeline, after the BatchNorm fusions.
# --------------------------------------------------------------------------
@register_pass("fuse_epilogue_pass")
class FuseEpiloguePass(Pass):
    """conv2d -> batch_norm/fused_batch_norm_act/fused_bn_add_activation
    (+ grads) ==> fused_conv_bn_act (+ fused_conv_bn_act_grad)."""

    #: vars the rewrite must not make unavailable (fetch targets)
    protected: Sequence[str] = ()

    #: attrs the fused_conv_bn_act lowering reads, by source op
    _CONV_ATTRS = ("strides", "paddings", "dilations", "groups",
                   "padding_algorithm", "data_format")
    _BN_ATTRS = ("momentum", "epsilon", "is_test", "use_global_stats")

    def apply_impl(self, program):
        from ..utils import cost_model as cmod

        block = program.global_block()
        protected = set(self.protected)
        for other in program.blocks:
            if other is block:
                continue
            for op_ in other.ops:
                for names in op_.inputs.values():
                    protected.update(names)
                for names in op_.outputs.values():
                    protected.update(names)
        fused = 0
        self.report: List[dict] = []
        changed = True
        while changed:
            changed = False
            # re-rank after every rewrite: a fusion changes the consumer
            # structure the next match must see
            for cand in cmod.rank_fusion_candidates(program):
                if cand["saved_bytes"] <= 0:
                    continue
                if self._rewrite_conv(block, cand["chain"], protected):
                    fused += 1
                    self.report.append({k: cand[k] for k in
                                        ("kind", "ops", "out",
                                         "saved_bytes")})
                    changed = True
                    break
        self.fused_count = fused
        if fused:
            program._bump_version()
        return program

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _merged_role_attrs(*grad_ops):
        out = {}
        roles = [o.attrs.get("op_role") for o in grad_ops
                 if o is not None and "op_role" in o.attrs]
        if roles:
            out["op_role"] = roles[0]
        rv: List[str] = []
        for o in grad_ops:
            if o is not None:
                rv.extend(o.attrs.get("op_role_var", []) or [])
        if rv:
            out["op_role_var"] = rv
        return out

    def _rewrite_conv(self, block, ch, protected):
        conv, bn = ch["conv"], ch["bn"]
        conv_grad, bn_grad = ch["conv_grad"], ch["bn_grad"]
        act_op, act_grad = ch["act_op"], ch["act_grad"]
        # vars the rewrite stops producing must not be fetch targets
        gone = set()
        if bn_grad is not None:
            gone.add(ch["dconv"])
        if ch.get("bn_y"):
            gone.add(ch["bn_y"])
            if act_grad is not None:
                gone.add(ch["bn_y"] + "@GRAD")
        if gone & protected:
            return False
        attrs = {k: conv.attrs[k] for k in self._CONV_ATTRS
                 if k in conv.attrs}
        attrs.update({k: bn.attrs[k] for k in self._BN_ATTRS
                      if k in bn.attrs})
        attrs["act_type"] = ch["act"]
        if conv.type == "depthwise_conv2d":
            attrs["depthwise"] = True
        if "op_role" in bn.attrs:
            attrs["op_role"] = bn.attrs["op_role"]
        inputs = {
            "Input": list(conv.inputs["Input"]),
            "Filter": list(conv.inputs["Filter"]),
            "Scale": list(bn.inputs["Scale"]),
            "Bias": list(bn.inputs["Bias"]),
            "Mean": list(bn.inputs["Mean"]),
            "Variance": list(bn.inputs["Variance"]),
        }
        if ch["z"]:
            inputs["Z"] = [ch["z"]]
        outputs = {
            "Output": [ch["out"]],
            "ConvOut": [ch["conv_out"]],
            "MeanOut": list(bn.outputs.get("MeanOut", [])),
            "VarianceOut": list(bn.outputs.get("VarianceOut", [])),
            "SavedMean": list(bn.outputs.get("SavedMean", [])),
            "SavedVariance": list(bn.outputs.get("SavedVariance", [])),
        }
        dead_fwd = [conv, bn] + ([act_op] if act_op is not None else [])
        last = act_op if act_op is not None else bn
        idx = block.ops.index(last)
        idx -= sum(1 for o in dead_fwd[:-1] if block.ops.index(o) < idx)
        remove_ops(block, dead_fwd)
        block._insert_op(idx, "fused_conv_bn_act",
                         inputs=inputs, outputs=outputs, attrs=attrs)
        if bn_grad is not None:
            gattrs = {k: v for k, v in attrs.items() if k != "op_role"}
            gattrs.update(self._merged_role_attrs(act_grad, bn_grad,
                                                  conv_grad))
            dy_in = (act_grad.inputs["Out@GRAD"] if act_grad is not None
                     else bn_grad.inputs["Y@GRAD"])
            ginputs = {
                "Input": list(conv.inputs["Input"]),
                "Filter": list(conv.inputs["Filter"]),
                "ConvOut": [ch["conv_out"]],
                "Output": [ch["out"]],
                "Scale": list(bn.inputs["Scale"]),
                "SavedMean": list(bn.outputs["SavedMean"]),
                "SavedVariance": list(bn.outputs["SavedVariance"]),
                "Output@GRAD": list(dy_in),
            }
            goutputs = {
                "Input@GRAD": list(conv_grad.outputs.get("Input@GRAD", [])),
                "Filter@GRAD": list(conv_grad.outputs.get("Filter@GRAD", [])),
                "Scale@GRAD": list(bn_grad.outputs.get("Scale@GRAD", [])),
                "Bias@GRAD": list(bn_grad.outputs.get("Bias@GRAD", [])),
            }
            if ch["z"] and bn_grad.outputs.get("Z@GRAD"):
                goutputs["Z@GRAD"] = list(bn_grad.outputs["Z@GRAD"])
            dead_bwd = ([act_grad] if act_grad is not None else []) + \
                [bn_grad, conv_grad]
            gidx = block.ops.index(dead_bwd[0])
            remove_ops(block, dead_bwd)
            block._insert_op(gidx, "fused_conv_bn_act_grad",
                             inputs=ginputs, outputs=goutputs, attrs=gattrs)
        return True
