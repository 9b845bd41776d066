"""Graph IR: Program / Block / Operator / Variable (counterpart of
``paddle_tpu/framework/core.py``, which imports no JAX; this is the
port's own copy, so a program serializes to the same JSON in both
packages and ``Program.parse_from_string`` reads one the JAX package
wrote).

Reference: paddle/fluid/framework/framework.proto:40-216 and the Python
mirror python/paddle/fluid/framework.py (Program:3852, Block:2391,
Operator:1822, Variable:835).

* One level of objects: the Python object *is* the desc, with JSON
  serialization for round-trips (``Program.serialize_to_string``).
* Compile-time shape inference runs at ``append_op`` time through the op
  registry (``ops/registry.py``), on ``meta`` tensors.
* The executor (``executor.py``) runs a block op by op on torch tensors;
  the IR carries no kernel-type information.
"""
from __future__ import annotations

import contextlib
import copy
import json
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .dtype import VarType, convert_dtype, dtype_name

GRAD_SUFFIX = "@GRAD"
EMPTY_VAR_NAME = "@EMPTY@"


# --------------------------------------------------------------------------
# Variable
# --------------------------------------------------------------------------
class Variable:
    """A named slot in a Block (reference: framework.py:835 Variable /
    framework.proto VarDesc).  Holds static metadata only; values live in a
    Scope at run time or on a dygraph VarBase in eager mode."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype=VarType.FP32,
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        type: VarType = VarType.LOD_TENSOR,
        is_data: bool = False,
        need_check_feed: bool = False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = VarType(type)
        self.is_data = is_data
        self.need_check_feed = need_check_feed
        # attached by layers for sharding annotation (TPU-native extension):
        self.sharding: Optional[tuple] = None

    # -- desc-ish API ------------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    def desc_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": dtype_name(self.dtype) if self.dtype is not None else None,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": int(self.type),
            "is_data": self.is_data,
        }

    @staticmethod
    def from_desc_dict(block: "Block", d: dict) -> "Variable":
        cls = Parameter if d.get("is_parameter") else Variable
        var = cls.__new__(cls)
        Variable.__init__(
            var,
            block,
            name=d["name"],
            shape=d["shape"],
            dtype=d["dtype"],
            lod_level=d.get("lod_level", 0),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            type=VarType(d.get("type", VarType.LOD_TENSOR)),
            is_data=d.get("is_data", False),
        )
        if isinstance(var, Parameter):
            var.trainable = d.get("trainable", True)
            var.optimize_attr = d.get("optimize_attr", {"learning_rate": 1.0})
            var.regularizer = None
            var.do_model_average = None
            var.is_distributed = False
        return var

    def __repr__(self):
        dt = dtype_name(self.dtype) if self.dtype is not None else "?"
        return f"var {self.name} : {self.type.name}.shape{self.shape}.dtype({dt})"

    __str__ = __repr__

    # numpy-ish sugar -------------------------------------------------------
    def astype(self, dtype):
        raise NotImplementedError("the cast layer is not ported (ROADMAP.md)")

    @property
    def grad_name(self) -> str:
        return self.name + GRAD_SUFFIX

    # math operators are monkey-patched in layers/math_op_patch.py


class Parameter(Variable):
    """Trainable persistable variable (reference: framework.py:4962)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        kwargs["stop_gradient"] = kwargs.get("stop_gradient", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.do_model_average = kwargs.get("do_model_average", None)
        self.is_distributed = kwargs.get("is_distributed", False)

    def desc_dict(self):
        d = super().desc_dict()
        d["is_parameter"] = True
        d["trainable"] = self.trainable
        d["optimize_attr"] = self.optimize_attr
        return d


# --------------------------------------------------------------------------
# Operator
# --------------------------------------------------------------------------
class Operator:
    """An op node (reference: framework.py:1822 Operator / proto OpDesc).

    inputs/outputs are slot->list-of-var-names dicts; attrs is a plain dict
    (values: python scalars, lists, strings, VarType ints, Block refs stored
    as block indices — mirroring the reference's BLOCK attr type).
    """

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = OrderedDict()
        self.outputs: Dict[str, List[str]] = OrderedDict()
        self.attrs: Dict[str, Any] = dict(attrs or {})
        for slot, vars_ in (inputs or {}).items():
            self.inputs[slot] = _to_name_list(vars_)
        for slot, vars_ in (outputs or {}).items():
            self.outputs[slot] = _to_name_list(vars_)

    # -- accessors mirroring the reference OpDesc API ----------------------
    def input(self, slot: str) -> List[str]:
        return list(self.inputs.get(slot, []))

    def output(self, slot: str) -> List[str]:
        return list(self.outputs.get(slot, []))

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name: str) -> bool:
        return name in self.attrs

    def _set_attr(self, name: str, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    set_attr = _set_attr

    def rename_input(self, old: str, new: str):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]
        self.block.program._bump_version()

    def rename_output(self, old: str, new: str):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]
        self.block.program._bump_version()

    def desc_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _attrs_to_json(self.attrs),
        }

    @staticmethod
    def from_desc_dict(block: "Block", d: dict) -> "Operator":
        return Operator(
            block,
            d["type"],
            inputs=d.get("inputs", {}),
            outputs=d.get("outputs", {}),
            attrs=_attrs_from_json(d.get("attrs", {})),
        )

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{Op({self.type}) inputs({ins}) outputs({outs})}}"

    __str__ = __repr__


def _to_name_list(vars_) -> List[str]:
    if vars_ is None:
        return []
    if isinstance(vars_, (Variable, str)):
        vars_ = [vars_]
    out = []
    for v in vars_:
        out.append(v.name if isinstance(v, Variable) else str(v))
    return out


_JSONABLE = (bool, int, float, str, type(None))


def _attrs_to_json(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, VarType):
            out[k] = {"__vartype__": int(v)}
        elif isinstance(v, Block):
            out[k] = {"__block__": v.idx}
        elif isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (list, tuple)):
            out[k] = [int(x) if isinstance(x, np.integer) else x for x in v]
        elif isinstance(v, dict):
            # plain dict attr (e.g. grad ops' __fwd_out_slots__); wrapped
            # so _attrs_from_json can tell it apart from the typed markers
            out[k] = {"__dict__": _attrs_to_json(v)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, _JSONABLE):
            out[k] = v
        else:
            out[k] = repr(v)  # last resort; non-round-trippable
    return out


def _attrs_from_json(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__vartype__" in v:
            out[k] = VarType(v["__vartype__"])
        elif isinstance(v, dict) and "__block__" in v:
            out[k] = ("__block__", v["__block__"])  # resolved by Program loader
        elif isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        elif isinstance(v, dict) and "__dict__" in v:
            out[k] = _attrs_from_json(v["__dict__"])
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# Block
# --------------------------------------------------------------------------
class Block:
    """Reference: framework.py:2391 / proto BlockDesc."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars: "OrderedDict[str, Variable]" = OrderedDict()
        self.ops: List[Operator] = []

    # -- var management ----------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        param = Parameter(self, **kwargs)
        self.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"var {name!r} not in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (
                self.program.blocks[blk.parent_idx]
                if blk.parent_idx >= 0
                else None
            )
        return None

    def var_recursive(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"var {name!r} not found (recursively)")
        return v

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _remove_var(self, name: str):
        self.vars.pop(name, None)
        self.program._bump_version()

    def _rename_var(self, old: str, new: str):
        """Rename the var AND every reference to it: this block's ops,
        their ``op_role_var`` attr lists, and ops in DESCENDANT blocks
        (cond/while bodies capture parent vars by name) unless a block
        on the path declares its own ``old`` — a shadowed name refers
        to the local var, not this one.  Renaming only the local op
        list (the pre-verifier behavior) left orphaned references the
        static verifier now flags as ``orphaned-read``."""
        var = self.vars.pop(old)
        var.name = new
        self.vars[new] = var
        blocks = [self]
        for blk in self.program.blocks:
            if blk is self:
                continue
            # visible from blk iff self is on blk's parent chain with no
            # intermediate (or local) declaration of `old` shadowing it
            cur, shadowed, on_chain = blk, old in blk.vars, False
            while cur is not None:
                parent = cur.parent_block
                if parent is self:
                    on_chain = True
                    break
                if parent is not None and old in parent.vars:
                    shadowed = True
                cur = parent
            if on_chain and not shadowed:
                blocks.append(blk)
        for blk in blocks:
            for op in blk.ops:
                op.rename_input(old, new)
                op.rename_output(old, new)
                rv = op.attrs.get("op_role_var")
                if rv and old in rv:
                    op.attrs["op_role_var"] = [
                        new if n == old else n for n in rv]
        self.program._bump_version()

    # -- op management -----------------------------------------------------
    def append_op(
        self, type: str, inputs=None, outputs=None, attrs=None, index=None
    ) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        dev = self.program._current_device
        if dev is not None and "op_device" not in op.attrs:
            op.attrs["op_device"] = dev
        if "op_callstack" not in op.attrs:
            # build-site callstack for error attribution (reference:
            # framework/op_call_stack.cc + op_proto_maker OpCreationCallstack);
            # user frames only — package internals (paddle_tpu and
            # paddle_tpu_torch alike) are noise.  Walk raw
            # frames innermost-out and stop after 3 user frames so
            # transpiler/optimizer-inserted ops (all internal frames) pay
            # almost nothing and no source lines are read eagerly.
            import sys

            frames = []
            f = sys._getframe(1)
            while f is not None and len(frames) < 3:
                fname = f.f_code.co_filename
                if "paddle_tpu" not in fname:
                    frames.append(f'File "{fname}", line {f.f_lineno}, '
                                  f"in {f.f_code.co_name}")
                f = f.f_back
            if frames:
                op.attrs["op_callstack"] = frames[::-1]  # outermost first
        from ..ops import registry  # local import to avoid cycles

        registry.infer_shape(op, self)
        if index is None:
            self.ops.append(op)
        else:
            self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        return self.append_op(type, inputs, outputs, attrs, index=index)

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.append_op(type, inputs, outputs, attrs, index=0)

    def _remove_op(self, index: int):
        del self.ops[index]
        self.program._bump_version()

    @property
    def parent_block(self) -> Optional["Block"]:
        return (
            self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None
        )

    def desc_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.desc_dict() for v in self.vars.values()],
            "ops": [op.desc_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"block {self.idx} (parent {self.parent_idx})"]
        lines += [f"  {v}" for v in self.vars.values()]
        lines += [f"  {op}" for op in self.ops]
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------
class Program:
    """Reference: framework.py:3852 / proto ProgramDesc."""

    _uid_counter = 0

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # monotonic program identity for executor caches: id() is reused
        # after GC, so a long-lived Executor serving short-lived Programs
        # could hit a stale compiled entry keyed on id(program)
        Program._uid_counter += 1
        self._uid = Program._uid_counter
        self._op_role = 0  # OpRole.Forward
        self._is_distributed = False
        self._seed_counter = 0
        # distillation of reference's Program attributes used by transpilers
        self._parameters_on_pservers = None
        self._sharding_spec = None  # TPU-native: program-level default sharding
        # fluid.device_guard state (reference: framework.py:5420): ops
        # appended inside the guard carry an `op_device` attr; the pipeline
        # splitter groups contiguous annotations into stages.
        self._current_device = None
        self._pipeline_opt = None

    # -- blocks ------------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        if parent_idx is None:
            parent_idx = self.current_block_idx
        blk = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._bump_version()
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def _next_seed(self) -> int:
        """Deterministic per-op seed allocator for random ops."""
        self._seed_counter += 1
        return self._seed_counter

    # -- parameters / io ---------------------------------------------------
    def all_parameters(self) -> List[Parameter]:
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep clone (reference: framework.py Program.clone).  With
        ``for_test=True``, backward/optimize/lr-sched-role ops are pruned
        (reference: framework.py:4194-4209 — cloning after ``minimize()``
        yields a forward-only program) and the surviving ops flip their
        ``is_test`` attr (dropout/batch_norm change behavior)."""
        p = Program.from_desc_dict(self.desc_dict())
        p.random_seed = self.random_seed
        if for_test:
            # roles are recorded as op attrs at build time, so the clone
            # needs no graph analysis to drop the training tail.  Note
            # OpRole.RPC (3) overlaps the Backward|Optimize bits and is
            # pruned too — an RPC op has no place in a test program.
            from ..backward import OpRole

            role_mask = OpRole.Backward | OpRole.Optimize | OpRole.LRSched
            for blk in p.blocks:
                blk.ops[:] = [
                    op for op in blk.ops
                    if not (int(op.attrs.get("op_role", 0)) & role_mask)
                ]
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type == "dropout":
                        op.attrs["is_test"] = True
            p._bump_version()
        return p

    # -- serialization -----------------------------------------------------
    def desc_dict(self) -> dict:
        return {
            "version": 1,
            "blocks": [b.desc_dict() for b in self.blocks],
        }

    @staticmethod
    def from_desc_dict(d: dict) -> "Program":
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd.get("parent_idx", -1))
            blk.forward_block_idx = bd.get("forward_block_idx", -1)
            for vd in bd["vars"]:
                var = Variable.from_desc_dict(blk, vd)
                blk.vars[var.name] = var
            p.blocks.append(blk)
        # ops in a second pass so block-attr refs can resolve
        for bd, blk in zip(d["blocks"], p.blocks):
            for od in bd["ops"]:
                op = Operator.from_desc_dict(blk, od)
                for k, v in list(op.attrs.items()):
                    if isinstance(v, tuple) and len(v) == 2 and v[0] == "__block__":
                        op.attrs[k] = p.blocks[v[1]]
                blk.ops.append(op)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        p.current_block_idx = 0
        return p

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.desc_dict()).encode("utf-8")

    @staticmethod
    def parse_from_string(s: bytes) -> "Program":
        return Program.from_desc_dict(json.loads(s.decode("utf-8")))

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


# --------------------------------------------------------------------------
# default program / guards (reference: framework.py:5167-5420)
# --------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


@contextlib.contextmanager
def device_guard(device=None):
    """reference: framework.py:5420 fluid.device_guard.  Ops appended
    inside the guard are annotated with ``op_device``; PipelineOptimizer
    uses contiguous annotations as stage boundaries."""
    prog = _main_program
    prev = prog._current_device
    prog._current_device = device
    try:
        yield
    finally:
        prog._current_device = prev


@contextlib.contextmanager
def name_scope(prefix: str):
    """API-compat no-op grouping scope (reference: framework.py name_scope)."""
    yield


# -- dygraph mode flag (reference: framework.py:180 in_dygraph_mode) --------
_dygraph_tracer = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer is not None


def _set_dygraph_tracer(tracer):
    global _dygraph_tracer
    _dygraph_tracer = tracer


def _current_tracer():
    return _dygraph_tracer
