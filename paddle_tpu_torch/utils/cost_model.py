"""The structural half of the epilogue-fusion finder (counterpart of
``paddle_tpu/utils/cost_model.py:300-606``).

:func:`find_fusion_chains` matches every conv2d -> batch_norm /
fused_batch_norm_act / fused_bn_add_activation (-> relu) chain with its
matching grad chain, with the JAX package's exclusivity rules, and
:func:`rank_fusion_candidates` orders the matches by the bytes fusion
saves (:func:`chain_saved_traffic`).  ``framework/ir.py``
``fuse_epilogue_pass`` rewrites them best first.

Not ported: the JAX ``CostModel`` and its measured-profile calibration,
whose constants are TPU measurements; without a profile the JAX ranking
is this same order by saved bytes, and the order never changes which
chains fuse.  The matmul -> bias -> act chains (``_matmul_chain``) come
with the fused matmul kernel; until then no matmul chain is matched.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["find_fusion_chains", "chain_saved_traffic",
           "rank_fusion_candidates", "set_measured_profile"]

#: bn-shaped ops a conv epilogue can absorb.  Plain ``batch_norm`` is
#: matched only with a trailing ``relu`` (the raw conv -> BN -> ReLU
#: triple): a ReLU-less BN keeps its unfused backward.
_BN_OPS = ("batch_norm", "fused_batch_norm_act", "fused_bn_add_activation")

#: the batch size a dynamic (-1) dim stands for when counting bytes
ASSUMED_BATCH = 64


def _consumer_map(ops) -> Dict[str, List]:
    cons: Dict[str, List] = {}
    for op_ in ops:
        for names in op_.inputs.values():
            for n in names:
                cons.setdefault(n, []).append(op_)
    return cons


def _only(users, allowed) -> bool:
    allowed_ids = {id(a) for a in allowed if a is not None}
    return all(id(u) in allowed_ids for u in users)


def _first(users, pred):
    return next((u for u in users if pred(u)), None)


def _conv_chain(conv, cons, block):
    y0 = conv.outputs.get("Output", [None])[0]
    if not y0 or y0 == "@EMPTY@":
        return None
    users = cons.get(y0, [])
    bn = _first(users, lambda o: o.type in _BN_OPS
                and o.inputs.get("X", [None])[0] == y0)
    if bn is None:
        return None
    cf = conv.attrs.get("data_format", "NCHW")
    if bn.attrs.get("data_layout", "NCHW") != cf:
        return None  # mixed-layout chain: the fused op has ONE layout attr
    if bn.type != "batch_norm" and \
            bn.attrs.get("act_type", "relu") != "relu":
        return None
    bn_grad = _first(users, lambda o: o.type == bn.type + "_grad"
                     and o.inputs.get("X", [None])[0] == y0)
    conv_grad = _first(users, lambda o: o.type == conv.type + "_grad"
                       and o.inputs.get("Output", [None])[0] == y0)
    if not _only(users, (bn, bn_grad, conv_grad)):
        return None
    if (bn_grad is None) != (conv_grad is None):
        return None  # half a backward: leave it alone
    bn_y = bn.outputs.get("Y", [None])[0]
    act_op = act_grad = None
    out = bn_y
    if bn.type == "batch_norm":
        # the raw triple: BN must feed a relu
        b_users = cons.get(bn_y, [])
        act_op = _first(b_users, lambda o: o.type == "relu"
                        and o.inputs.get("X", [None])[0] == bn_y)
        if act_op is None:
            return None
        act_grad = _first(b_users, lambda o: o.type == "relu_grad"
                          and o.inputs.get("X", [None])[0] == bn_y)
        if not _only(b_users, (act_op, act_grad, bn_grad)):
            return None
        if (act_grad is None) != (bn_grad is None):
            return None
        out = act_op.outputs["Out"][0]
        if bn_grad is not None:
            dy1 = act_grad.outputs.get("X@GRAD", [None])[0]
            if (not dy1 or bn_grad.inputs.get("Y@GRAD", [None])[0] != dy1
                    or not _only(cons.get(dy1, []), (bn_grad,))
                    or act_grad.inputs.get("Out", [None])[0] != out):
                return None
    if bn_grad is not None:
        # the BN backward's dX must feed exactly conv_grad's Output@GRAD
        dy0 = bn_grad.outputs.get("X@GRAD", [None])[0]
        if (not dy0 or dy0 == "@EMPTY@"
                or conv_grad.inputs.get("Output@GRAD", [None])[0] != dy0
                or not _only(cons.get(dy0, []), (conv_grad,))):
            return None
        if bn.type != "batch_norm" and \
                bn_grad.inputs.get("Y", [None])[0] != out:
            return None
    z = bn.inputs.get("Z", [None])[0] if bn.type == "fused_bn_add_activation" \
        else None
    return {
        "kind": "conv_bn_act", "conv": conv, "bn": bn,
        "conv_grad": conv_grad, "bn_grad": bn_grad,
        "act_op": act_op, "act_grad": act_grad,
        "act": "relu", "z": z, "conv_out": y0,
        "bn_y": bn_y if act_op is not None else None, "out": out,
        "dconv": (bn_grad.outputs["X@GRAD"][0] if bn_grad is not None
                  else None),
    }


def find_fusion_chains(block) -> List[dict]:
    """Structural matches for every conv epilogue chain in ``block`` (fwd
    + the matching grad chain, or fwd-only in inference programs).  The
    IR pass adds the protected/fetch and cross-block checks."""
    cons = _consumer_map(block.ops)
    chains = []
    for op_ in block.ops:
        if op_.type in ("conv2d", "depthwise_conv2d"):
            ch = _conv_chain(op_, cons, block)
            if ch is not None:
                chains.append(ch)
    return chains


def _dims(block, name, assumed_batch) -> Optional[List[int]]:
    var = block._find_var_recursive(name)
    if var is None or var.shape is None:
        return None
    return [assumed_batch if int(d) < 0 else int(d) for d in var.shape]


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= max(d, 1)
    return n


def chain_saved_traffic(chain, block, assumed_batch=ASSUMED_BATCH) -> dict:
    """Modeled device-memory bytes the fused rewrite stops moving, per
    intermediate, at 4 B per element: the conv output's separate
    normalize-pass re-read folds into the single epilogue pass (2 passes
    when frozen statistics let the whole tensor die), a raw triple's
    pre-relu BN output and its gradient disappear, and the grad chain's
    dX-of-BN intermediate is never written (write + read)."""

    def nbytes(name):
        dims = _dims(block, name, assumed_batch)
        return _numel(dims) * 4 if dims else 0

    saved = {}
    frozen = bool(chain["bn"].attrs.get("is_test")
                  or chain["bn"].attrs.get("use_global_stats"))
    saved[chain["conv_out"]] = nbytes(chain["conv_out"]) * \
        (2.0 if frozen else 1.0)
    if chain.get("bn_y"):
        saved[chain["bn_y"]] = nbytes(chain["bn_y"]) * 2.0
        if chain["act_grad"] is not None:
            saved[chain["bn_y"] + "@GRAD"] = nbytes(chain["bn_y"]) * 2.0
    if chain["bn_grad"] is not None:
        saved[chain["dconv"]] = nbytes(chain["dconv"]) * 2.0
    return {"per_tensor": saved, "total_bytes": float(sum(saved.values()))}


def rank_fusion_candidates(program) -> List[dict]:
    """Every fusible chain of ``program``'s global block, most saved
    bytes first (a stable sort: ties keep program order)."""
    block = program.global_block()
    out = []
    for chain in find_fusion_chains(block):
        traffic = chain_saved_traffic(chain, block)
        out.append({
            "kind": chain["kind"],
            "ops": [o.type for o in (chain["conv"], chain["bn"],
                                     chain["act_op"], chain["bn_grad"],
                                     chain["act_grad"]) if o is not None],
            "out": chain["out"],
            "saved_bytes": int(traffic["total_bytes"]),
            "per_tensor": traffic["per_tensor"],
            "chain": chain,
        })
    out.sort(key=lambda r: -r["saved_bytes"])
    return out


def set_measured_profile(step_s, per_op_s=None, source=""):
    """The JAX cost model's calibration from a measured profile
    (``cost_model.py:101``): its constants are TPU measurements, and the
    port has no cost model to calibrate yet."""
    raise NotImplementedError("the cost model and its measured-profile "
                              "calibration are not ported (ROADMAP.md)")
