"""Op registry: op type -> (lowering, infer_shape, grad maker), for the
static Program path (counterpart of ``paddle_tpu/ops/registry.py``).

* **lower**: a plain function of a lowering context that reads its input
  slots as torch tensors and binds its outputs.  The executor
  (``executor.py``) runs a block op by op, eagerly, so a lowering is the
  whole of an op's run-time work.
* **infer_shape**: an op's own where it registers one
  (:func:`infer_for`, as ``reshape2`` does in JAX), else the lowering
  itself run on ``meta`` tensors (the counterpart of the JAX package's
  ``jax.eval_shape``), so compile-time shapes are exactly what the
  lowering computes.  ``-1``
  (dynamic batch) stands in as 97 while it runs, as in JAX; 64-bit result
  types are recorded as 32-bit (``dtype.canonical_dtype``), as JAX's
  default mode records them.
* **grad**: program-level grad-op descs from the same grad makers as the
  JAX package, so ``append_backward`` writes the same program.  A grad op
  with no lowering of its own replays the forward lowering under
  ``torch.func.vjp`` (:func:`generic_grad_lower`).  In an op-by-op
  executor that replay runs the forward a second time (JAX's XLA CSE
  removes it inside one jitted program), so the ops whose forward is
  expensive (conv2d, batch_norm, pool2d, mul and the fused ops) register
  explicit grad lowerings instead.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..framework.core import EMPTY_VAR_NAME, GRAD_SUFFIX, Block, Operator
from ..framework.dtype import canonical_dtype, to_torch_dtype
from ..framework.selected_rows import SelectedRows

__all__ = ["OPS", "OpDef", "op", "grad_maker", "infer_for", "resolve",
           "LowerCtx", "infer_shape", "run_op", "eager_call", "has_grad",
           "make_grad_ops", "default_grad_maker", "generic_grad_lower"]

_SENTINEL_DIM = 97  # stands in for -1 (dynamic batch) during inference
_META = torch.device("meta")

OPS: Dict[str, "OpDef"] = {}


class OpDef:
    __slots__ = ("type", "lower", "grad_maker", "infer_shape", "no_grad",
                 "host", "_generic_grad")

    def __init__(self, type):
        self.type = type
        self.lower: Optional[Callable] = None
        self.grad_maker: Optional[Callable] = None
        self.infer_shape: Optional[Callable] = None
        self.no_grad = False
        self.host = False
        self._generic_grad = False


def op(type: str, *, no_grad: bool = False, host: bool = False):
    """Decorator registering a forward lowering for ``type``.  A ``host``
    op reads its inputs back to the host (its output's shape or values
    come from the data), so a program that holds one runs op by op,
    never as a captured step (JAX's ``host=True`` ops)."""

    def deco(fn):
        d = OPS.setdefault(type, OpDef(type))
        d.lower = fn
        d.no_grad = no_grad
        d.host = host
        return fn

    return deco


def grad_maker(type: str):
    """Decorator registering a custom grad-desc maker for ``type``."""

    def deco(fn):
        OPS.setdefault(type, OpDef(type)).grad_maker = fn
        return fn

    return deco


def infer_for(type: str):
    """Decorator registering a custom compile-time shape inference
    ``fn(op, block)`` for ``type``, in place of running the lowering on
    ``meta`` tensors (JAX ``infer_for``)."""

    def deco(fn):
        OPS.setdefault(type, OpDef(type)).infer_shape = fn
        return fn

    return deco


def resolve(type: str) -> OpDef:
    """The op's definition; an unregistered ``*_grad`` whose forward has
    a lowering materializes as the generic vjp grad."""
    d = OPS.get(type)
    if d is not None and d.lower is not None:
        return d
    if type.endswith("_grad"):
        fwd = type[: -len("_grad")]
        if fwd in OPS and OPS[fwd].lower is not None:
            gd = OPS.setdefault(type, OpDef(type))
            if gd.lower is None:
                gd.lower = generic_grad_lower
                gd.no_grad = True
                gd._generic_grad = True
            return gd
    raise NotImplementedError(f"op {type!r} is not registered in the port")


# --------------------------------------------------------------------------
# Lowering contexts
# --------------------------------------------------------------------------
class LowerCtx:
    """What a lowering sees: slot values, attrs, the executor's random
    generator and device, output binding."""

    def __init__(self, op: Operator, env: Dict[str, Any], block=None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        self.op = op
        self.env = env
        self.block = block
        self.generator = generator
        self.device = device

    #: the registered ops that take a SelectedRows input as it is (JAX
    #: ``ops/registry.py:193-201``; reference: the optimizers'
    #: SelectedRows kernels); every other op sees it densified, so no
    #: result depends on an op's sparse support
    SPARSE_AWARE = frozenset({
        "sgd", "momentum", "adam", "adagrad", "sum", "scale",
        "clip_by_norm",
    })

    # inputs ---------------------------------------------------------------
    def ins(self, slot: str, missing_ok: bool = False) -> List[Any]:
        sparse_ok = self.op.type in self.SPARSE_AWARE
        out = []
        for n in self.op.inputs.get(slot, []):
            if n == EMPTY_VAR_NAME:
                out.append(None)
                continue
            if n not in self.env:
                if missing_ok:
                    out.append(None)
                    continue
                raise KeyError(
                    f"op {self.op.type}: input var {n!r} (slot {slot}) "
                    f"has no value — not initialized or not fed")
            v = self.env[n]
            if not sparse_ok and isinstance(v, SelectedRows):
                v = v.to_dense()
            out.append(v)
        return out

    def in_(self, slot: str):
        vals = self.ins(slot)
        return vals[0] if vals else None

    def has_input(self, slot: str) -> bool:
        ns = self.op.inputs.get(slot, [])
        return bool(ns) and ns[0] != EMPTY_VAR_NAME

    # outputs --------------------------------------------------------------
    def out_names(self, slot: str) -> List[str]:
        return self.op.outputs.get(slot, [])

    def set_out(self, slot: str, *vals):
        names = self.op.outputs.get(slot, [])
        if len(vals) == 1 and type(vals[0]) in (list, tuple):
            vals = tuple(vals[0])
        for n, v in zip(names, vals):
            if n != EMPTY_VAR_NAME:
                self.env[n] = v

    def has_output(self, slot: str) -> bool:
        ns = self.op.outputs.get(slot, [])
        return bool(ns) and ns[0] != EMPTY_VAR_NAME

    # attrs ----------------------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    # rng ------------------------------------------------------------------
    def rng(self) -> Optional[torch.Generator]:
        """The executor's generator (None under shape inference, where
        random ops allocate nothing)."""
        return self.generator


class _ReplayCtx:
    """LowerCtx stand-in for vjp replay and shape inference: takes
    explicit slot -> values and captures outputs."""

    def __init__(self, ins_vals: Dict[str, List[Any]], attrs: Dict[str, Any],
                 out_arity: Dict[str, int],
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        self._ins = ins_vals
        self.attrs = attrs
        self._out_arity = out_arity
        self.outs: Dict[str, List[Any]] = {}
        self.generator = generator
        self.device = device
        self.op = None
        self.env = {}

    def ins(self, slot, missing_ok=False):
        return list(self._ins.get(slot, []))

    def in_(self, slot):
        vals = self._ins.get(slot, [])
        return vals[0] if vals else None

    def has_input(self, slot):
        vals = self._ins.get(slot, [])
        return bool(vals) and vals[0] is not None

    def out_names(self, slot):
        return ["_"] * self._out_arity.get(slot, 1)

    def set_out(self, slot, *vals):
        if len(vals) == 1 and type(vals[0]) in (list, tuple):
            vals = tuple(vals[0])
        self.outs[slot] = list(vals)

    def has_output(self, slot):
        return self._out_arity.get(slot, 0) > 0

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self):
        return self.generator


# --------------------------------------------------------------------------
# Shape inference
# --------------------------------------------------------------------------
def infer_shape(op: Operator, block: Block):
    """Compile-time shape/dtype inference for ``op``'s outputs, run at
    append_op time (the analog of OpDesc-level InferShape in the
    reference, operator.h:442)."""
    d = OPS.get(op.type)
    if d is None:
        return  # unknown ops carry no inference
    if op.type.endswith("_grad"):
        _infer_grad_shapes(op, block)
        return
    if d.infer_shape is not None:
        d.infer_shape(op, block)
        return
    if d.lower is None:
        return
    _generic_infer(op, block, d)


def _meta_tensor(var) -> torch.Tensor:
    shape = tuple(_SENTINEL_DIM if s == -1 else s for s in var.shape)
    return torch.empty(shape, dtype=to_torch_dtype(var.dtype), device=_META)


def _generic_infer(op: Operator, block: Block, d: OpDef):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                vals.append(None)
            else:
                v = block._find_var_recursive(n)
                if v is None:
                    return  # can't infer
                vals.append(_meta_tensor(v))
        ins[slot] = vals
    out_arity = {s: len(ns) for s, ns in op.outputs.items()}
    ctx = _ReplayCtx(ins, op.attrs, out_arity, device=_META)
    try:
        with torch.no_grad():
            d.lower(ctx)
    except Exception:
        return  # leave output shapes as declared, as the JAX package does
    for slot, vals in ctx.outs.items():
        for n, v in zip(op.outputs.get(slot, []), vals):
            if n == EMPTY_VAR_NAME or not isinstance(v, torch.Tensor):
                continue
            var = block._find_var_recursive(n)
            if var is None:
                continue
            var.shape = tuple(-1 if s == _SENTINEL_DIM else int(s)
                              for s in v.shape)
            var.dtype = canonical_dtype(v.dtype)


def _infer_grad_shapes(op: Operator, block: Block):
    """Grad var shape == forward var shape; cheap, no tracing."""
    for slot, names in op.outputs.items():
        for n in names:
            if n == EMPTY_VAR_NAME:
                continue
            base = n
            if "@RENAME" in base:
                base = base.split("@RENAME")[0]
            if "@GRADX" in base:
                base = base.split("@GRADX")[0]
            if not base.endswith(GRAD_SUFFIX):
                continue
            gvar = block._find_var_recursive(n)
            fvar = block._find_var_recursive(base[: -len(GRAD_SUFFIX)])
            if gvar is not None and fvar is not None:
                gvar.shape = fvar.shape
                gvar.dtype = fvar.dtype


# --------------------------------------------------------------------------
# Execution of one op against an env
# --------------------------------------------------------------------------
def run_op(op: Operator, env: Dict[str, Any], block=None,
           generator: Optional[torch.Generator] = None,
           device: Optional[torch.device] = None) -> LowerCtx:
    d = resolve(op.type)
    ctx = LowerCtx(op, env, block, generator, device)
    try:
        d.lower(ctx)
    except Exception as e:
        _raise_with_callstack(op, e)
    return ctx


def _raise_with_callstack(op: Operator, e: Exception):
    """Attach the op's Python build-site callstack to the error
    (reference: framework/op_call_stack.cc InsertCallStackInfo)."""
    stack = op.attrs.get("op_callstack")
    where = ""
    if stack:
        where = "\n  op built at:\n    " + "\n    ".join(stack)
    e.add_note(f"[operator {op.type!r} error]{where}")
    raise e


def eager_call(type: str, ins: Dict[str, List[Any]],
               attrs: Optional[Dict[str, Any]] = None,
               out_arity: Optional[Dict[str, int]] = None,
               generator: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None) -> Dict[str, List[Any]]:
    """Run ``type``'s lowering on tensors outside a program (JAX
    ``eager_call``): ``ins`` maps slots to values, ``out_arity`` slots to
    their number of outputs; returns ``{slot: [values]}``.  The dygraph
    optimizers update through the static ops' lowerings this way."""
    ctx = _ReplayCtx(ins, dict(attrs or {}), dict(out_arity or {}),
                     generator, device)
    resolve(type).lower(ctx)
    return ctx.outs


# --------------------------------------------------------------------------
# Grad machinery
# --------------------------------------------------------------------------
def has_grad(type: str) -> bool:
    d = OPS.get(type)
    if d is None:
        if type.endswith("_grad"):
            fwd = type[: -len("_grad")]
            return fwd in OPS and OPS[fwd].lower is not None
        return False
    if d.no_grad:
        return bool(d._generic_grad)
    return True


def make_grad_ops(op: Operator, no_grad_names=frozenset()) -> List[dict]:
    """Grad op descs (dicts with type/inputs/outputs/attrs), the
    reference's per-op GradOpMaker contract (grad_op_desc_maker.h)."""
    d = OPS.get(op.type)
    if d is None and op.type.endswith("_grad"):
        try:
            d = resolve(op.type)
        except NotImplementedError:
            return []
    if d is None:
        return []
    if d.no_grad and not d._generic_grad:
        return []
    if d.grad_maker is not None:
        return d.grad_maker(op, no_grad_names)
    return default_grad_maker(op, no_grad_names)


def default_grad_maker(op: Operator, no_grad_names=frozenset()) -> List[dict]:
    inputs: Dict[str, List[str]] = {s: list(ns) for s, ns in op.inputs.items()}
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)  # forward outputs available to custom grads
        inputs[slot + GRAD_SUFFIX] = [
            n + GRAD_SUFFIX if n != EMPTY_VAR_NAME else EMPTY_VAR_NAME
            for n in names
        ]
    outputs = {}
    for slot, names in op.inputs.items():
        outputs[slot + GRAD_SUFFIX] = [
            (n + GRAD_SUFFIX) if n not in no_grad_names and n != EMPTY_VAR_NAME
            else EMPTY_VAR_NAME
            for n in names
        ]
    attrs = dict(op.attrs)
    attrs["__fwd_attrs__"] = dict(op.attrs)
    attrs["__fwd_out_slots__"] = {s: len(ns) for s, ns in op.outputs.items()}
    attrs["__fwd_type__"] = op.type
    return [
        dict(type=op.type + "_grad", inputs=inputs, outputs=outputs,
             attrs=attrs)
    ]


def _is_diff(v) -> bool:
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def generic_grad_lower(ctx):
    """vjp-replay grad kernel shared by every ``*_grad`` op that has no
    lowering of its own: the forward lowering runs again under
    ``torch.func.vjp`` and the cotangents (``<slot>@GRAD`` inputs,
    missing ones as zeros) pull back to ``<slot>@GRAD`` outputs."""
    gop = ctx.op
    attrs_all = gop.attrs
    in_slot_names = list(gop.inputs)
    fwd_type = attrs_all.get("__fwd_type__") or gop.type[: -len("_grad")]
    fdef = resolve(fwd_type)
    out_arity: Dict[str, int] = dict(attrs_all.get("__fwd_out_slots__") or {})

    cot_slots = {s + GRAD_SUFFIX for s in out_arity}
    fwd_in_slots = [s for s in in_slot_names
                    if s not in out_arity and s not in cot_slots]
    ins_vals = {s: ctx.ins(s) for s in fwd_in_slots}
    spec = [(s, i) for s in fwd_in_slots
            for i, v in enumerate(ins_vals[s]) if _is_diff(v)]
    flat = [ins_vals[s][i] for s, i in spec]

    fwd_attrs = attrs_all.get("__fwd_attrs__")
    fwd_attrs = (dict(fwd_attrs) if fwd_attrs is not None else
                 {k: v for k, v in attrs_all.items()
                  if not k.startswith("__")})
    out_slot_order = sorted(out_arity)

    def run_forward(*flat_vals):
        merged = {s: list(vs) for s, vs in ins_vals.items()}
        for (s, i), v in zip(spec, flat_vals):
            merged[s][i] = v
        rctx = _ReplayCtx(merged, fwd_attrs, out_arity, ctx.generator,
                          ctx.device)
        fdef.lower(rctx)
        outs = []
        for slot in out_slot_order:
            vals = list(rctx.outs.get(slot, []))
            outs.extend(vals + [None] * (out_arity[slot] - len(vals)))
        return outs

    # which forward outputs carry a cotangent: float tensors only
    probe = []

    def f(*flat_vals):
        outs = run_forward(*flat_vals)
        probe[:] = [_is_diff(o) for o in outs]
        return tuple(o for o in outs if _is_diff(o))

    if not flat:
        return  # no float input: nothing to differentiate
    primal, vjp_fn = torch.func.vjp(f, *flat)
    cots = []
    k = 0
    j = 0
    for slot in out_slot_order:
        gvals = (ctx.ins(slot + GRAD_SUFFIX, missing_ok=True)
                 if (slot + GRAD_SUFFIX) in in_slot_names else [])
        for i in range(out_arity[slot]):
            if probe[k]:
                p = primal[j]
                g = gvals[i] if i < len(gvals) else None
                cots.append(torch.zeros_like(p) if g is None
                            else g.to(p.dtype))
                j += 1
            k += 1
    grads = vjp_fn(tuple(cots))
    by_slot: Dict[str, Dict[int, Any]] = {}
    for (s, i), g in zip(spec, grads):
        by_slot.setdefault(s, {})[i] = g
    for s in fwd_in_slots:
        for i, n in enumerate(gop.outputs.get(s + GRAD_SUFFIX, [])):
            v = by_slot.get(s, {}).get(i)
            if n != EMPTY_VAR_NAME and v is not None:
                ctx.env[n] = v
