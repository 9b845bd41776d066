"""Executor: runs a Program op by op on torch tensors (counterpart of
``paddle_tpu/executor.py``; reference: python/paddle/fluid/executor.py:461
and framework/executor.cc:184).

Where the JAX executor traces a whole block into one ``jax.jit``, this
one interprets it eagerly, as the reference's Executor does
(executor.cc:469-476): each op's lowering (``ops/``) runs in turn on the
executor's device and launches its own kernels.

* **The plan** (``_compile``): the IR pass pipeline (the two BatchNorm
  fusions always, the NHWC layout pass under ``FLAGS_cuda_nhwc``, whose
  ``auto`` takes only programs with bf16 convolutions, then
  the epilogue fusion under ``FLAGS_cuda_fuse``, in the JAX order,
  :797-799, :807-810, :811-820) on a clone of the program, the
  state analysis (``analyze_state``: what the op list reads before it
  writes, and which persistable vars it writes), the feed-conversion
  plan, and the last reader of every intermediate.  A plan is cached per
  program uid and version, feed signature, fetch list and the two
  flags.
* **State** lives in the scope as tensors on the device.  A step binds
  them, runs the ops, and writes every state output back *into the
  scope's own tensor* (``copy_``): parameters, velocities and BatchNorm
  statistics are updated in place, and a tensor taken from the scope
  keeps tracking its variable.
* **Memory**: each intermediate is dropped after its last reader, so the
  step holds what the backward still needs and little else.
* **Random ops** draw from a ``torch.Generator`` of the executor, one
  per program, seeded from the program's ``random_seed`` at its first
  run.  (The JAX package threads a key through the scope as
  ``@RNG_KEY@``; the two streams never match, so parity tests copy the
  startup scope.)
* **Fetches** are copies: numpy arrays by default, or tensors that no
  later step overwrites.

Not ported (ROADMAP.md): the hybrid host-op path, data-parallel and
pipeline runners, ``fuse_optimizer_ops_pass``, the memory plan, the numerics probes and ``check_nan_inf``, CUDA-graph
capture of the step.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import (EMPTY_VAR_NAME, Program, Variable,
                             default_main_program)
from .framework.dtype import VarType, to_torch_dtype
from .framework.place import resolve_place
from .framework.scope import Scope, global_scope
from .ops import registry
from .utils.flags import cuda_fuse_enabled, cuda_nhwc_enabled

__all__ = ["Executor", "analyze_state", "build_feed_plan", "as_numpy"]


def analyze_state(ops, block, feed_names, scope):
    """Which vars the op list reads before writing (``state_in``), and
    which persistable or scope-resident vars it writes (``state_out``)."""
    feed_names = set(feed_names)
    written: set = set()
    state_in: List[str] = []
    for op_ in ops:
        for name in op_.input_arg_names:
            if (name not in written and name not in feed_names
                    and name != EMPTY_VAR_NAME and name not in state_in):
                state_in.append(name)
        written.update(op_.output_arg_names)
    written.discard(EMPTY_VAR_NAME)
    state_out = sorted(
        n for n in written
        if ((v := block._find_var_recursive(n)) is not None and v.persistable)
        or scope.has(n))
    return state_in, state_out


def build_feed_plan(block, feed):
    """Target torch dtype per feed name (None = as given)."""
    plan = {}
    for k in feed:
        var = block._find_var_recursive(k)
        plan[k] = (to_torch_dtype(var.dtype)
                   if var is not None and var.dtype is not None else None)
    return plan


def _fetch_name(f) -> str:
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError(f"bad fetch entry: {f!r}")


def as_numpy(value) -> np.ndarray:
    """A numpy copy of a fetched value; a bfloat16 tensor, which numpy
    cannot hold, comes back as its exact float32 upcast."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy().copy()
    return np.array(value)


class _Plan:
    """One compiled program: the rewritten op list, its state in/out, the
    feed plan, and per op the intermediates it is the last reader of."""

    __slots__ = ("program", "ops", "state_in", "state_out", "feed_plan",
                 "fetch_names", "free_after", "fused")

    def __init__(self, program, ops, state_in, state_out, feed_plan,
                 fetch_names, free_after, fused):
        self.program = program
        self.ops = ops
        self.state_in = state_in
        self.state_out = state_out
        self.feed_plan = feed_plan
        self.fetch_names = fetch_names
        self.free_after = free_after
        self.fused = fused


def _bf16_convs(program: Program) -> bool:
    """Whether ``program`` has a convolution whose Input is bf16 (a
    program under ``decorate``)."""
    for blk in program.blocks:
        for op_ in blk.ops:
            if op_.type in ("conv2d", "depthwise_conv2d"):
                v = blk._find_var_recursive(op_.input("Input")[0])
                if v is not None and v.dtype == VarType.BF16:
                    return True
    return False


def _free_schedule(ops, keep) -> List[List[str]]:
    """Per op, the vars to drop after it runs: those it reads or writes
    last, unless they are state or fetches (``keep``)."""
    last: Dict[str, int] = {}
    for i, op_ in enumerate(ops):
        for n in op_.input_arg_names + op_.output_arg_names:
            if n != EMPTY_VAR_NAME:
                last[n] = i
    free: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            free[i].append(n)
    return free


class Executor:
    """reference: python/paddle/fluid/executor.py:461 Executor.

    ``place`` is a ``CPUPlace``/``CUDAPlace``, a ``torch.device`` or a
    string; the default is ``CUDAPlace(0)``, which raises without a
    card."""

    def __init__(self, place=None):
        self.device = resolve_place(place)
        self.place = place
        self._cache: Dict[tuple, _Plan] = {}
        self._generators: Dict[int, torch.Generator] = {}
        self._closed = False
        #: host seconds of the last ``run`` (ends in the fetches' copy)
        self.last_run_s: Optional[float] = None
        #: wrap each op in a ``torch.profiler.record_function("op:<type>")``
        #: range, so a trace attributes device time to op types
        self.trace_ops = False

    def fuse_enabled(self) -> bool:
        """FLAGS_cuda_fuse resolved against this executor's device."""
        return cuda_fuse_enabled(self.device)

    def nhwc_enabled(self, program: Program) -> bool:
        """FLAGS_cuda_nhwc resolved against this executor's device and
        ``program``'s convolutions (``auto``: NHWC where they read
        bf16)."""
        return cuda_nhwc_enabled(self.device, _bf16_convs(program))

    # ------------------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            feed_var_name: str = "feed", fetch_var_name: str = "fetch",
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True):
        if self._closed:
            raise RuntimeError("Executor is closed")
        t0 = time.perf_counter()
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = dict(feed or {})
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        plan = self._compile(program, feed, fetch_names, scope)
        out = self._execute(plan, program, feed, scope, return_numpy)
        self.last_run_s = time.perf_counter() - t0
        return out

    def close(self):
        self._closed = True
        self._cache.clear()

    # ------------------------------------------------------------------
    def _compile(self, program: Program, feed, fetch_names, scope) -> _Plan:
        fuse, nhwc = self.fuse_enabled(), self.nhwc_enabled(program)
        feed_spec = tuple(sorted(
            (k, tuple(np.shape(v)), str(getattr(v, "dtype", None)))
            for k, v in feed.items()))
        key = (program._uid, program._version, feed_spec,
               tuple(fetch_names), fuse, nhwc)
        plan = self._cache.get(key)
        if plan is not None:
            return plan
        rewritten = self._apply_ir_passes(program, fetch_names, fuse, nhwc)
        block = rewritten.global_block()
        ops = list(block.ops)
        state_in, state_out = analyze_state(ops, block, feed, scope)
        keep = set(state_in) | set(state_out) | set(fetch_names)
        plan = _Plan(rewritten, ops, state_in, state_out,
                     build_feed_plan(block, feed), list(fetch_names),
                     _free_schedule(ops, keep), fuse)
        self._cache[key] = plan
        return plan

    def _apply_ir_passes(self, program: Program, fetch_names,
                         fuse: Optional[bool] = None,
                         nhwc: Optional[bool] = None) -> Program:
        """The training-time pass pipeline on a clone of ``program``
        (the user's program stays as built): fuse_bn_add_act_pass and
        fuse_bn_act_pass when the program has a batch_norm, then
        layout_transform_pass when NHWC is on and it has a conv2d (after
        the BN fusions, so it sees the fused forms), then
        fuse_epilogue_pass when fusion is on and it has a conv2d or a
        matrix product (after the layout pass, so the chains it matches
        are in their final layout)."""
        from .framework.ir import PassManager, get_pass

        fuse = self.fuse_enabled() if fuse is None else fuse
        nhwc = self.nhwc_enabled(program) if nhwc is None else nhwc
        types = {o.type for b in program.blocks for o in b.ops}
        protected = tuple(fetch_names)
        passes = []
        if "batch_norm" in types:
            passes += [get_pass("fuse_bn_add_act_pass", protected=protected),
                       get_pass("fuse_bn_act_pass", protected=protected)]
        if nhwc and types & {"conv2d", "depthwise_conv2d"}:
            passes.append(get_pass("layout_transform_pass",
                                   protected=protected))
        if fuse and types & {"conv2d", "depthwise_conv2d", "mul", "matmul",
                             "matmul_v2"}:
            passes.append(get_pass("fuse_epilogue_pass",
                                   protected=protected))
        if not passes:
            return program
        clone = Program.from_desc_dict(program.desc_dict())
        clone.random_seed = program.random_seed
        return PassManager(passes).apply(clone)

    # ------------------------------------------------------------------
    def _generator(self, program: Program) -> torch.Generator:
        gen = self._generators.get(program._uid)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(program.random_seed or 0))
            self._generators[program._uid] = gen
        return gen

    def _state_value(self, scope: Scope, name: str) -> torch.Tensor:
        val = scope.get(name)
        if val is None:
            raise RuntimeError(
                f"Variable {name!r} is read by the program but has no value "
                f"in scope — run the startup program first or feed it")
        if not isinstance(val, torch.Tensor) or val.device != self.device:
            val = torch.as_tensor(np.asarray(val) if not isinstance(
                val, torch.Tensor) else val).to(self.device)
            scope.set(name, val)
        return val

    def _execute(self, plan: _Plan, program: Program, feed, scope: Scope,
                 return_numpy: bool):
        dev = self.device
        env: Dict[str, Any] = {}
        for k, v in feed.items():
            want = plan.feed_plan.get(k)
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)))
            env[k] = t.to(device=dev, dtype=want or t.dtype)
        for n in plan.state_in:
            env[n] = self._state_value(scope, n)
        block = plan.program.global_block()
        gen = self._generator(program)
        with torch.no_grad():
            for op_, dead in zip(plan.ops, plan.free_after):
                if self.trace_ops:
                    with torch.profiler.record_function("op:" + op_.type):
                        registry.run_op(op_, env, block, gen, dev)
                else:
                    registry.run_op(op_, env, block, gen, dev)
                for n in dead:
                    env.pop(n, None)
            for n in plan.state_out:
                if n not in env:
                    continue
                val, cur = env[n], scope.get(n)
                if (isinstance(cur, torch.Tensor) and cur is not val
                        and cur.shape == val.shape and cur.dtype == val.dtype
                        and cur.device == val.device):
                    cur.copy_(val)
                else:
                    scope.set(n, val)
        fetched = [env[n] for n in plan.fetch_names]
        if return_numpy:
            return [as_numpy(v) for v in fetched]
        return [v.clone() if isinstance(v, torch.Tensor) else v
                for v in fetched]
