"""The structural half of the epilogue-fusion finder (counterpart of
``paddle_tpu/utils/cost_model.py:300-606``).

:func:`find_fusion_chains` matches, with the JAX package's exclusivity
rules, every conv2d -> batch_norm / fused_batch_norm_act /
fused_bn_add_activation (-> relu) chain and every mul / matmul ->
elementwise_add (1-D bias) -> act chain (``FUSABLE_ACTS``; exact-erf gelu
only), each with its matching grad chain or none of it;
:func:`rank_fusion_candidates` orders the matches by the bytes fusion
saves (:func:`chain_saved_traffic`).  ``framework/ir.py``
``fuse_epilogue_pass`` rewrites them best first.

Not ported: the JAX ``CostModel`` and its measured-profile calibration,
whose constants are TPU measurements; without a profile the JAX ranking
is this same order by saved bytes, and the order never changes which
chains fuse.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["FUSABLE_ACTS", "find_fusion_chains", "chain_saved_traffic",
           "rank_fusion_candidates", "set_measured_profile"]

#: bn-shaped ops a conv epilogue can absorb.  Plain ``batch_norm`` is
#: matched only with a trailing ``relu`` (the raw conv -> BN -> ReLU
#: triple): a ReLU-less BN keeps its unfused backward.
_BN_OPS = ("batch_norm", "fused_batch_norm_act", "fused_bn_add_activation")
#: activations the fused matmul epilogue supports
FUSABLE_ACTS = ("relu", "sigmoid", "tanh", "gelu")

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


def _matmul_ok(op_, block):
    if op_.type == "mul":
        return int(op_.attrs.get("y_num_col_dims", 1)) == 1
    if op_.type in ("matmul", "matmul_v2"):
        if op_.attrs.get("transpose_X") or op_.attrs.get("transpose_Y") or \
                op_.attrs.get("trans_x") or op_.attrs.get("trans_y"):
            return False
        if float(op_.attrs.get("alpha", 1.0) or 1.0) != 1.0:
            return False
        xv = block._find_var_recursive(op_.inputs.get("X", [None])[0] or "")
        return xv is not None and xv.shape is not None and len(xv.shape) == 2
    return False


def _matmul_chain(mm, cons, block):
    if not _matmul_ok(mm, block):
        return None
    y0 = mm.outputs.get("Out", [None])[0]
    wv = block._find_var_recursive(mm.inputs.get("Y", [None])[0] or "")
    if not y0 or wv is None or wv.shape is None or len(wv.shape) != 2:
        return None
    users = cons.get(y0, [])
    xnc = int(mm.attrs.get("x_num_col_dims", 1))

    def _bias_add(o):
        if o.type != "elementwise_add" or o.inputs.get("X", [None])[0] != y0:
            return False
        bvar = block._find_var_recursive(o.inputs.get("Y", [None])[0] or "")
        if bvar is None or bvar.shape is None or len(bvar.shape) != 1:
            return False
        return int(o.attrs.get("axis", -1)) in (-1, xnc)

    add = _first(users, _bias_add)
    if add is None:
        return None
    mm_grad = _first(users, lambda o: o.type == mm.type + "_grad")
    add_grad = _first(users, lambda o: o.type == "elementwise_add_grad"
                      and o.inputs.get("X", [None])[0] == y0)
    if not _only(users, (add, add_grad, mm_grad)):
        return None
    ya = add.outputs["Out"][0]
    a_users = cons.get(ya, [])
    act_op = _first(a_users, lambda o: o.type in FUSABLE_ACTS
                    and o.inputs.get("X", [None])[0] == ya)
    if act_op is None:
        return None
    if act_op.type == "gelu" and act_op.attrs.get("approximate"):
        return None  # the kernel and its plain version are exact-erf only
    act_grad = _first(a_users, lambda o: o.type == act_op.type + "_grad"
                      and o.inputs.get("X", [None])[0] == ya)
    if not _only(a_users, (act_op, act_grad, add_grad)):
        return None
    grads = (act_grad, add_grad, mm_grad)
    if any(g is None for g in grads) != all(g is None for g in grads):
        return None  # part of a backward: leave it alone
    y1 = act_op.outputs["Out"][0]
    if act_grad is not None:
        dya = act_grad.outputs.get("X@GRAD", [None])[0]
        if (not dya or add_grad.inputs.get("Out@GRAD", [None])[0] != dya
                or not _only(cons.get(dya, []), (add_grad,))):
            return None
        dy0 = add_grad.outputs.get("X@GRAD", [None])[0]
        if (not dy0 or mm_grad.inputs.get("Out@GRAD", [None])[0] != dy0
                or not _only(cons.get(dy0, []), (mm_grad,))):
            return None
        if act_grad.inputs.get("Out", [None])[0] != y1:
            return None
    return {
        "kind": "matmul_bias_act", "mm": mm, "add": add, "act_op": act_op,
        "mm_grad": mm_grad, "add_grad": add_grad, "act_grad": act_grad,
        "act": act_op.type, "mm_out": y0, "add_out": ya, "out": y1,
        "xnc": xnc,
    }


def find_fusion_chains(block) -> List[dict]:
    """Structural matches for every epilogue chain in ``block`` (fwd +
    the matching grad chain, or fwd-only in inference programs).  The IR
    pass adds the protected/fetch and cross-block checks."""
    cons = _consumer_map(block.ops)
    chains = []
    for op_ in block.ops:
        if op_.type in ("conv2d", "depthwise_conv2d"):
            ch = _conv_chain(op_, cons, block)
        elif op_.type in ("mul", "matmul", "matmul_v2"):
            ch = _matmul_chain(op_, cons, block)
        else:
            ch = None
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
    intermediate, at 4 B per element.  Conv chains: the conv output's
    separate normalize-pass re-read folds into the single epilogue pass
    (2 passes when frozen statistics let the whole tensor die), a raw
    triple's pre-relu BN output and its gradient disappear, and the grad
    chain's dX-of-BN intermediate is never written (write + read).
    Matmul chains: the product and the pre-act sum (and their
    gradients) are never written (write + read each)."""

    def nbytes(name):
        dims = _dims(block, name, assumed_batch)
        return _numel(dims) * 4 if dims else 0

    saved = {}
    if chain["kind"] == "conv_bn_act":
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
    else:
        saved[chain["mm_out"]] = nbytes(chain["mm_out"]) * 2.0
        saved[chain["add_out"]] = nbytes(chain["add_out"]) * 2.0
        if chain["act_grad"] is not None:
            saved[chain["add_out"] + "@GRAD"] = nbytes(chain["add_out"]) * 2.0
            saved[chain["mm_out"] + "@GRAD"] = nbytes(chain["mm_out"]) * 2.0
    return {"per_tensor": saved, "total_bytes": float(sum(saved.values()))}


def rank_fusion_candidates(program) -> List[dict]:
    """Every fusible chain of ``program``'s global block, most saved
    bytes first (a stable sort: ties keep program order).  ``ops`` names
    the chain's anchor (the conv or the matmul) and then its epilogue ops,
    forward and grad, as the JAX ranking lists them."""
    block = program.global_block()
    out = []
    for chain in find_fusion_chains(block):
        traffic = chain_saved_traffic(chain, block)
        if chain["kind"] == "conv_bn_act":
            ops = (chain["conv"], chain["bn"], chain["act_op"],
                   chain["bn_grad"], chain["act_grad"])
        else:
            ops = (chain["mm"], chain["add"], chain["act_op"],
                   chain["add_grad"], chain["act_grad"])
        out.append({
            "kind": chain["kind"],
            "ops": [o.type for o in ops if o is not None],
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
