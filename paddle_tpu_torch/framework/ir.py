"""Program rewrite passes (counterpart of ``paddle_tpu/framework/ir.py``).

Reference: paddle/fluid/framework/ir/pass.h:38 (Pass / PassRegistry),
ir/fuse_pass_base.h.  The Program's op list is the graph (vars link ops
by name), so a pass is a Python function over Blocks.

Ported: the registry (``Pass``, ``register_pass``, ``get_pass``,
``PassManager``, :30-98), the graph helpers (:99-126), the pattern
matcher (``OpTemplate``, ``match_pattern``, :127-231),
``fuse_multihead_attention_pass`` (:336-443: the naive attention chain,
in four variants, onto one ``fused_multihead_attention`` op; it is no
part of the executor's default pipeline, as in JAX), the BatchNorm
fusions ``fuse_bn_act_pass`` (:489) and ``fuse_bn_add_act_pass`` (:570),
``layout_transform_pass`` (:1470-1743, the NHWC propagation under
``FLAGS_cuda_nhwc``) and ``fuse_epilogue_pass`` (:711-912), which maps
conv -> BN (-> add) -> relu chains onto ``fused_conv_bn_act`` and mul /
matmul -> bias add -> act chains onto ``fused_matmul_bias_act``, forward
and backward together; their epilogues are the hand-written kernels of
``ops/bn_act.py`` and ``ops/matmul_epilogue.py``; and
``fuse_optimizer_ops_pass`` (:2445-2488, with ``_FUSABLE_OPT``
:1316-1327), which merges the per-parameter ``sgd``, ``momentum`` and
``adam`` ops into ``fused_sgd`` / ``fused_momentum`` / ``fused_adam``.
The rewrites are the JAX package's, op for op, so both packages compile
a program to the same op list.

Not ported (ROADMAP.md): the static verifier that brackets every pass
under ``FLAGS_verify_passes``, ``memory_relief_pass`` and the other
passes of the JAX module.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .core import Block, Operator, Program
from .dtype import VarType

__all__ = ["PASS_REGISTRY", "Pass", "register_pass", "get_pass",
           "PassManager", "producer_map", "consumer_count", "remove_ops",
           "OpTemplate", "match_pattern", "FuseMultiheadAttentionPass",
           "FuseBNActPass", "FuseBNAddActPass", "LayoutTransformPass",
           "FuseEpiloguePass", "FuseOptimizerOpsPass"]

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


register_pass("memory_relief_pass")(
    type("memory_relief_pass", (_NotPorted,), {}))


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
# pattern matcher (reference: graph_pattern_detector.cc)
# --------------------------------------------------------------------------
class OpTemplate:
    """One PDNode: an op of ``type`` whose given input slots are fed by
    the named output of an earlier template (``"producer.Slot"``)."""

    def __init__(self, name: str, type: str,
                 inputs: Optional[Dict[str, str]] = None,
                 predicate: Optional[Callable[[Operator], bool]] = None):
        self.name = name
        self.type = type
        self.inputs = inputs or {}
        self.predicate = predicate


def match_pattern(block: Block, templates: Sequence[OpTemplate],
                  allow_shared_intermediates: bool = False
                  ) -> List[Dict[str, Operator]]:
    """Non-overlapping matches of the template DAG, as the reference's
    GraphPatternDetector finds them: templates match in order, each
    non-root template's constrained input slots fed by the var an
    earlier template's op produced (and nothing wrote since); the first
    match of a root wins.  Unless ``allow_shared_intermediates``, a
    match whose intermediate vars (produced and consumed inside it) have
    a consumer outside it is dropped (the detector's IsIntermediate()
    rule, which keeps a rewrite from deleting a value someone reads)."""
    prod = producer_map(block)
    cons = consumer_count(block)
    by_type: Dict[str, List[Operator]] = {}
    for op_ in block.ops:
        by_type.setdefault(op_.type, []).append(op_)
    matches: List[Dict[str, Operator]] = []
    used: set = set()

    def fed(t: OpTemplate, cand: Operator, bound) -> bool:
        for slot, src in t.inputs.items():
            src_name, src_slot = src.split(".")
            src_op = bound.get(src_name)
            if src_op is None:
                return False
            in_names = cand.inputs.get(slot, [])
            out_names = src_op.outputs.get(src_slot, [])
            if not in_names or not out_names or in_names[0] not in out_names:
                return False
            if prod.get(in_names[0]) is not src_op:
                return False  # someone overwrote the var in between
        return True

    def backtrack(i: int, bound: Dict[str, Operator]) -> bool:
        if i == len(templates):
            matches.append(dict(bound))
            return True
        t = templates[i]
        for cand in by_type.get(t.type, []):
            if id(cand) in used or any(cand is o for o in bound.values()):
                continue
            if t.predicate is not None and not t.predicate(cand):
                continue
            if not fed(t, cand, bound):
                continue
            bound[t.name] = cand
            if backtrack(i + 1, bound):
                return True
            del bound[t.name]
        return False

    root_t = templates[0]
    for root in list(by_type.get(root_t.type, [])):
        if id(root) in used:
            continue
        if root_t.predicate is not None and not root_t.predicate(root):
            continue
        if backtrack(1, {root_t.name: root}):
            m = matches[-1]
            if not allow_shared_intermediates and not _intermediates_private(
                    m, cons):
                matches.pop()
                continue
            used.update(id(o) for o in m.values())
    return matches


def _intermediates_private(match: Dict[str, Operator],
                           cons: Dict[str, int]) -> bool:
    """Whether every var a match's ops produce and read is read by those
    ops only."""
    ops = list(match.values())
    produced = {n for o in ops for names in o.outputs.values()
                for n in names}
    internal: Dict[str, int] = {}
    for o in ops:
        for names in o.inputs.values():
            for n in names:
                if n in produced:
                    internal[n] = internal.get(n, 0) + 1
    return all(cons.get(n, 0) == k for n, k in internal.items())


# --------------------------------------------------------------------------
# fuse_multihead_attention_pass (reference intent:
# ir/multihead_matmul_fuse_pass.cc)
# --------------------------------------------------------------------------
def _is_scale_like(op_):
    return op_.type == "scale" and op_.attrs.get("bias", 0.0) in (0, 0.0)


def _is_qk_matmul(op_):
    """Q @ K^T with a plain Q; its alpha folds into the fused scale."""
    return (op_.attrs.get("transpose_Y", False)
            and not op_.attrs.get("transpose_X", False))


def _is_av_matmul(op_):
    """probs @ V, untransposed and unscaled: the fused op has no epilogue
    scale."""
    return (not op_.attrs.get("transpose_Y", False)
            and not op_.attrs.get("transpose_X", False)
            and op_.attrs.get("alpha", 1.0) in (1, 1.0))


def _is_last_axis_softmax(op_):
    return op_.attrs.get("axis", -1) in (-1, 3)


def _is_default_axis_add(op_):
    """BiasQK broadcasts as numpy does in the fused op; an add with an
    explicit paddle axis would be reinterpreted, so only the default
    (trailing-aligned) form fuses."""
    return op_.attrs.get("axis", -1) == -1


@register_pass("fuse_multihead_attention_pass")
class FuseMultiheadAttentionPass(Pass):
    """The naive attention chain over (batch, heads, seq, head_dim) Q, K,
    V::

        qk  = matmul(Q, K, transpose_Y=True)   [any alpha]
        s   = scale(qk)                        [optional, bias 0]
        m   = elementwise_add(s, mask)         [optional, axis -1]
        sm  = softmax(m)                       [last axis]
        out = matmul(sm, V)

    becomes one ``fused_multihead_attention`` op (scale = alpha times the
    scale op's factor; the mask its BiasQK; no Lse output, so its grad
    runs the forward for lse).  The longest variant is tried first, so
    optional ops are claimed when present; ``fused_count`` counts the
    rewrites."""

    def apply_impl(self, program):
        block = program.global_block()
        qk = OpTemplate("qk", "matmul", predicate=_is_qk_matmul)
        sm = ("softmax", "softmax")
        av = OpTemplate("av", "matmul", {"X": "softmax.Out"},
                        predicate=_is_av_matmul)

        def chain(*mid):
            ts, prev = [qk], "qk"
            for name, typ, pred in mid + (sm + (_is_last_axis_softmax,),):
                ts.append(OpTemplate(name, typ, {"X": prev + ".Out"},
                                     predicate=pred))
                prev = name
            return ts + [av]

        scale = ("scale", "scale", _is_scale_like)
        mask = ("mask", "elementwise_add", _is_default_axis_add)
        fused = 0
        for templates in (chain(scale, mask), chain(scale), chain(mask),
                          chain()):
            for m in match_pattern(block, templates):
                self._rewrite(block, m)
                fused += 1
        self.fused_count = fused
        return program

    @staticmethod
    def _rewrite(block, m):
        qk, av = m["qk"], m["av"]
        scale = qk.attrs.get("alpha", 1.0)
        if "scale" in m:
            scale = scale * m["scale"].attrs.get("scale", 1.0)
        inputs = {"Q": [qk.inputs["X"][0]], "K": [qk.inputs["Y"][0]],
                  "V": [av.inputs["Y"][0]]}
        if "mask" in m:
            inputs["BiasQK"] = [m["mask"].inputs["Y"][0]]
        # at the av matmul's place: every value the fused op reads (Q, K,
        # V and the mask) exists there, which is not sure at qk's (the
        # mask may be computed after it)
        idx = block.ops.index(av)
        idx -= sum(1 for o in m.values() if block.ops.index(o) < idx)
        remove_ops(block, list(m.values()))
        block._insert_op(idx, "fused_multihead_attention", inputs=inputs,
                         outputs={"Out": av.outputs["Out"]},
                         attrs={"scale": float(scale), "causal": False})


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
# NHWC layout propagation (JAX ``layout_transform_pass``, ir.py:1470-1743;
# reference: ir/conv_bn_fuse_pass + the cudnn NHWC kernels).  Under
# FLAGS_cuda_nhwc the executor rewrites conv2d / pool2d / batch_norm and
# the fused BN and conv-epilogue forms (and their grads) to compute in
# NHWC, the layout of cuDNN's channels-last (tensor-core) convolutions:
#
# * a converted op consumes and produces ``<name>@NHWC`` aliases, vars
#   that hold the NHWC value, and its layout attr (``data_format`` /
#   ``data_layout``) flips to "NHWC" (also in a grad op's
#   ``__fwd_attrs__``);
# * layout-agnostic elementwise ops (relu, cast, sum, elementwise_add and
#   their grads) ride along in NHWC when all their data inputs already
#   are;
# * a ``transpose2`` is inserted only at subgraph boundaries: NCHW ->
#   NHWC on the first NHWC use of an NCHW value, NHWC -> NCHW on the
#   first NCHW use of an NHWC value, so an unbroken conv -> bn -> relu ->
#   conv chain has one transpose in and one out.
#
# Filters stay OIHW: the NHWC conv lowering views the NHWC tensor as
# NCHW with channels-last strides (``ops/nn_ops.py`` ``_nchw``), so
# weights, their grads and the optimizer state keep their layout.
# --------------------------------------------------------------------------
_NHWC_SUFFIX = "@NHWC"

#: op type -> (layout attr, data input slots, data output slots).  Slots
#: not listed (Filter, Scale, running stats, ...) are per-channel or
#: kernel-layout values the NHWC lowering consumes unchanged.
_LAYOUT_OPS: Dict[str, tuple] = {
    "conv2d": ("data_format", ("Input",), ("Output",)),
    "depthwise_conv2d": ("data_format", ("Input",), ("Output",)),
    "conv2d_grad": ("data_format", ("Input", "Output", "Output@GRAD"),
                    ("Input@GRAD",)),
    "depthwise_conv2d_grad": ("data_format",
                              ("Input", "Output", "Output@GRAD"),
                              ("Input@GRAD",)),
    "pool2d": ("data_format", ("X",), ("Out",)),
    "pool2d_grad": ("data_format", ("X", "Out", "Out@GRAD"), ("X@GRAD",)),
    "batch_norm": ("data_layout", ("X",), ("Y",)),
    "batch_norm_grad": ("data_layout", ("X", "Y", "Y@GRAD"), ("X@GRAD",)),
    "fused_batch_norm_act": ("data_layout", ("X",), ("Y",)),
    "fused_batch_norm_act_grad": ("data_layout", ("X", "Y", "Y@GRAD"),
                                  ("X@GRAD",)),
    "fused_bn_add_activation": ("data_layout", ("X", "Z"), ("Y",)),
    "fused_bn_add_activation_grad": ("data_layout", ("X", "Y", "Y@GRAD"),
                                     ("X@GRAD", "Z@GRAD")),
    # r14 fused conv epilogues: ONE layout attr (data_format) governs
    # conv and BN; Filter/Filter@GRAD stay OIHW in both layouts
    "fused_conv_bn_act": ("data_format", ("Input", "Z"),
                          ("Output", "ConvOut")),
    "fused_conv_bn_act_grad": ("data_format",
                               ("Input", "ConvOut", "Output",
                                "Output@GRAD"),
                               ("Input@GRAD", "Z@GRAD")),
}

#: elementwise ops that compute identically in any layout: converted to
#: consume/produce NHWC aliases when every 4-D data input already has
#: one, so they never force a transpose back to NCHW mid-chain.
_LAYOUT_AGNOSTIC: Dict[str, tuple] = {
    "relu": (("X",), ("Out",)),
    "relu_grad": (("X", "Out", "Out@GRAD"), ("X@GRAD",)),
    "cast": (("X",), ("Out",)),
    "cast_grad": (("X", "Out", "Out@GRAD"), ("X@GRAD",)),
    "elementwise_add": (("X", "Y"), ("Out",)),
    "elementwise_add_grad": (("X", "Y", "Out", "Out@GRAD"),
                             ("X@GRAD", "Y@GRAD")),
    "sum": (("X",), ("Out",)),
}


@register_pass("layout_transform_pass")
class LayoutTransformPass(Pass):
    """NCHW -> NHWC propagation over conv/bn/pool/elementwise chains."""

    #: var names whose NCHW value must stay addressable (fetch targets)
    protected: Sequence[str] = ()

    def apply_impl(self, program):
        block = program.global_block()
        keep_nchw = set(self.protected)
        # names referenced from other blocks (while/cond bodies) must
        # keep their NCHW binding — sub-blocks are not rewritten
        for other in program.blocks:
            if other is block:
                continue
            for op_ in other.ops:
                for names in op_.inputs.values():
                    keep_nchw.update(names)
                for names in op_.outputs.values():
                    keep_nchw.update(names)
        self.converted_count = self._apply_block(block, keep_nchw)
        if self.converted_count:
            program._bump_version()
        return program

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _is_4d(block, name):
        if not name or name == "@EMPTY@":
            return False
        v = block._find_var_recursive(name)
        return v is not None and v.shape is not None and len(v.shape) == 4

    def _eligible(self, op_, block, attr_name, din, dout):
        if op_.attrs.get(attr_name, "NCHW") not in ("NCHW", "AnyLayout"):
            return False
        if op_.type.startswith("pool2d"):
            if op_.attrs.get("adaptive", False) and \
                    not op_.attrs.get("global_pooling", False):
                return False  # NHWC adaptive: only the lowering's
                #                divisible path; stay conservative
        names = []
        for slot in din:
            names.extend(op_.inputs.get(slot, []))
        for slot in dout:
            names.extend(n for n in op_.outputs.get(slot, [])
                         if n != "@EMPTY@")
        if not names:
            return False
        return all(self._is_4d(block, n) for n in names
                   if n != "@EMPTY@")

    # -- main walk ---------------------------------------------------------
    def _apply_block(self, block, keep_nchw):
        converted = 0
        new_ops: List[Operator] = []
        alias: Dict[str, str] = {}   # NCHW name -> live NHWC alias
        pending: set = set()         # names whose NCHW value is not
        #                              materialized (only alias is live)

        def alias_var(name):
            aname = name + _NHWC_SUFFIX
            if not block.has_var(aname):
                v = block._find_var_recursive(name)
                s = list(v.shape)
                block.create_var(name=aname,
                                 shape=(s[0], s[2], s[3], s[1]),
                                 dtype=v.dtype)
            return aname

        def to_nhwc(name):
            a = alias.get(name)
            if a is not None:
                return a
            a = alias_var(name)
            new_ops.append(Operator(
                block, "transpose2", inputs={"X": [name]},
                outputs={"Out": [a]}, attrs={"axis": [0, 2, 3, 1]}))
            alias[name] = a
            return a

        def to_nchw(name):
            if name in pending:
                new_ops.append(Operator(
                    block, "transpose2", inputs={"X": [alias[name]]},
                    outputs={"Out": [name]}, attrs={"axis": [0, 3, 1, 2]}))
                pending.discard(name)
            return name

        def invalidate_outputs(op_, except_slots=()):
            """An op overwriting an aliased name makes the alias stale."""
            for slot, names in op_.outputs.items():
                if slot in except_slots:
                    continue
                for n in names:
                    if n in alias:
                        alias.pop(n, None)
                        pending.discard(n)

        def convert(op_, attr_name, din, dout):
            """Rewrite one op to compute in NHWC: data input slots take
            (or create) aliases, data output slots produce aliases, the
            layout attr flips — including the __fwd_attrs__ snapshot the
            vjp replay of grad ops reads."""
            data_out_names = {n for slot in dout
                              for n in op_.outputs.get(slot, [])}
            # non-data input slots are per-channel/kernel values that
            # should never be pending; stay safe if one is
            for slot, names in list(op_.inputs.items()):
                if slot in din:
                    op_.inputs[slot] = [
                        to_nhwc(n) if n != "@EMPTY@" else n for n in names]
                else:
                    for n in names:
                        if n in pending:
                            to_nchw(n)
            invalidate_outputs(op_, except_slots=dout)
            for slot in dout:
                names = op_.outputs.get(slot, [])
                rewritten = []
                for n in names:
                    if n == "@EMPTY@":
                        rewritten.append(n)
                        continue
                    a = alias_var(n)
                    alias[n] = a
                    pending.add(n)
                    rewritten.append(a)
                if names:
                    op_.outputs[slot] = rewritten
            if attr_name is not None:
                op_.attrs[attr_name] = "NHWC"
                fa = op_.attrs.get("__fwd_attrs__")
                if isinstance(fa, dict):
                    fa = dict(fa)
                    fa[attr_name] = "NHWC"
                    op_.attrs["__fwd_attrs__"] = fa
            new_ops.append(op_)
            # fetch targets / persistables need their NCHW value live NOW
            for n in data_out_names:
                if n != "@EMPTY@" and n in pending:
                    v = block._find_var_recursive(n)
                    if n in keep_nchw or (v is not None and
                                          getattr(v, "persistable", False)):
                        to_nchw(n)

        for op_ in list(block.ops):
            spec = _LAYOUT_OPS.get(op_.type)
            agn = _LAYOUT_AGNOSTIC.get(op_.type)
            if spec is not None:
                attr_name, din, dout = spec
                if self._eligible(op_, block, din=din, dout=dout,
                                  attr_name=attr_name):
                    convert(op_, attr_name, din, dout)
                    converted += 1
                    continue
            elif agn is not None and self._agnostic_ok(op_, block, alias,
                                                       *agn):
                din, dout = agn
                convert(op_, None, din, dout)
                converted += 1
                continue
            # generic op: consume NCHW — materialize any pending input
            for names in op_.inputs.values():
                for n in names:
                    if n in pending:
                        to_nchw(n)
            invalidate_outputs(op_)
            new_ops.append(op_)

        # live-out NHWC values someone outside the block may read
        for n in sorted(pending):
            v = block._find_var_recursive(n)
            if n in keep_nchw or (v is not None
                                  and getattr(v, "persistable", False)):
                to_nchw(n)
        if converted:
            block.ops[:] = new_ops
        return converted

    def _agnostic_ok(self, op_, block, alias, din, dout):
        """Every 4-D data input must already be NHWC; elementwise_add
        additionally needs the default axis and equal shapes (a
        broadcasting add is layout-sensitive)."""
        names_in = [n for slot in din for n in op_.inputs.get(slot, [])
                    if n != "@EMPTY@"]
        names_out = [n for slot in dout for n in op_.outputs.get(slot, [])
                     if n != "@EMPTY@"]
        if not names_in or not names_out:
            return False
        if not all(self._is_4d(block, n) for n in names_in + names_out):
            return False
        if not all(n in alias for n in names_in):
            return False
        if op_.type.startswith("elementwise_add"):
            if op_.attrs.get("axis", -1) != -1:
                return False
            shapes = {tuple(block._find_var_recursive(n).shape)
                      for n in names_in}
            if len(shapes) != 1:
                return False
        return True


# --------------------------------------------------------------------------
# epilogue fusion: utils/cost_model.find_fusion_chains supplies the
# structural matches (so ranking and rewrite can never disagree) and
# rank_fusion_candidates orders them by saved bytes; this pass rewrites
# them best first onto fused_conv_bn_act / fused_matmul_bias_act
# (ops/fused_ops.py), forward and the matching grad chain together.
# Gated by FLAGS_cuda_fuse in the executor pipeline, after the BatchNorm
# fusions.
# --------------------------------------------------------------------------
@register_pass("fuse_epilogue_pass")
class FuseEpiloguePass(Pass):
    """conv2d -> batch_norm/fused_batch_norm_act/fused_bn_add_activation
    (+ grads) ==> fused_conv_bn_act (+ fused_conv_bn_act_grad); mul /
    matmul -> elementwise_add (1-D bias) -> act (+ grads) ==>
    fused_matmul_bias_act (+ fused_matmul_bias_act_grad)."""

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
                if self._rewrite(block, cand["chain"], protected):
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

    def _rewrite(self, block, ch, protected):
        if ch["kind"] == "conv_bn_act":
            return self._rewrite_conv(block, ch, protected)
        return self._rewrite_matmul(block, ch, protected)

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

    def _rewrite_matmul(self, block, ch, protected):
        mm, add, act_op = ch["mm"], ch["add"], ch["act_op"]
        mm_grad, add_grad, act_grad = \
            ch["mm_grad"], ch["add_grad"], ch["act_grad"]
        gone = {ch["mm_out"], ch["add_out"]}
        if act_grad is not None:
            gone |= {ch["add_out"] + "@GRAD", ch["mm_out"] + "@GRAD"}
        if gone & protected:
            return False
        attrs = {
            "act_type": ch["act"],
            "x_num_col_dims": ch["xnc"],
            "axis": add.attrs.get("axis", -1),
        }
        if "op_role" in act_op.attrs:
            attrs["op_role"] = act_op.attrs["op_role"]
        inputs = {"X": list(mm.inputs["X"]), "Y": list(mm.inputs["Y"]),
                  "Bias": list(add.inputs["Y"])}
        idx = block.ops.index(act_op)
        idx -= sum(1 for o in (mm, add) if block.ops.index(o) < idx)
        remove_ops(block, [mm, add, act_op])
        block._insert_op(idx, "fused_matmul_bias_act", inputs=inputs,
                         outputs={"Out": [ch["out"]]}, attrs=attrs)
        if act_grad is not None:
            gattrs = {k: v for k, v in attrs.items() if k != "op_role"}
            gattrs.update(self._merged_role_attrs(act_grad, add_grad,
                                                  mm_grad))
            ginputs = {
                "X": list(mm.inputs["X"]), "Y": list(mm.inputs["Y"]),
                "Bias": list(add.inputs["Y"]),
                "Out@GRAD": list(act_grad.inputs["Out@GRAD"]),
            }
            goutputs = {
                "X@GRAD": list(mm_grad.outputs.get("X@GRAD", [])),
                "Y@GRAD": list(mm_grad.outputs.get("Y@GRAD", [])),
                "Bias@GRAD": list(add_grad.outputs.get("Y@GRAD", [])),
            }
            gidx = block.ops.index(act_grad)
            remove_ops(block, [act_grad, add_grad, mm_grad])
            block._insert_op(gidx, "fused_matmul_bias_act_grad",
                             inputs=ginputs, outputs=goutputs, attrs=gattrs)
        return True


# --------------------------------------------------------------------------
# fused optimizer ops (reference: ir/fuse_optimizer_ops_pass/ --
# fuse_sgd_op_pass.cc, fuse_momentum_op_pass.cc, fuse_adam_op_pass.cc):
# merge the per-parameter update ops that share one rate var and their
# hyperparameters into one multi-slot fused op (ops/optimizer_ops.py)
# --------------------------------------------------------------------------
_FUSABLE_OPT = {
    "sgd": (("Param", "Grad"), ("ParamOut",)),
    "momentum": (("Param", "Grad", "Velocity"), ("ParamOut", "VelocityOut")),
    "adam": (("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
             ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")),
}


@register_pass("fuse_optimizer_ops_pass")
class FuseOptimizerOpsPass(Pass):
    """Group the ``sgd`` / ``momentum`` / ``adam`` ops of the global block
    by (type, LearningRate var, attrs other than the op_role ones); each
    group of two or more becomes one ``fused_<type>`` op where its last
    member was.  An op whose gradient is SELECTED_ROWS keeps its own."""

    def apply_impl(self, program):
        fused = 0
        block = program.global_block()
        groups: Dict[tuple, List[Operator]] = {}
        for op_ in block.ops:
            if op_.type not in _FUSABLE_OPT:
                continue
            gname = op_.inputs.get("Grad", [None])[0]
            gvar = block._find_var_recursive(gname) if gname else None
            if gvar is not None and gvar.type == VarType.SELECTED_ROWS:
                continue
            attr_key = frozenset(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in op_.attrs.items()
                if k not in ("op_role", "op_namescope", "op_callstack",
                             "op_role_var"))
            key = (op_.type, op_.inputs["LearningRate"][0], attr_key)
            groups.setdefault(key, []).append(op_)
        for (otype, lr, _), ops_ in groups.items():
            if len(ops_) < 2:
                continue
            in_slots, out_slots = _FUSABLE_OPT[otype]
            inputs = {"LearningRate": [lr]}
            for s in in_slots:
                inputs[s] = [o.inputs[s][0] for o in ops_]
            outputs = {s: [o.outputs[s][0] for o in ops_] for s in out_slots}
            # where the last member was: every grad is made by then, and
            # the updates are the program's tail
            last = max(block.ops.index(o) for o in ops_)
            last -= sum(1 for o in ops_ if block.ops.index(o) < last)
            remove_ops(block, ops_)
            block._insert_op(last, "fused_" + otype, inputs=inputs,
                             outputs=outputs, attrs=dict(ops_[0].attrs))
            fused += 1
        self.fused_count = fused
        if fused:
            program._bump_version()
        return program
