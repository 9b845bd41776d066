"""Executor: runs a Program op by op on torch tensors (counterpart of
``paddle_tpu/executor.py``; reference: python/paddle/fluid/executor.py:461
and framework/executor.cc:184).

Where the JAX executor traces a whole block into one ``jax.jit``, this
one interprets it eagerly, as the reference's Executor does
(executor.cc:469-476): each op's lowering (``ops/``) runs in turn on the
executor's device and launches its own kernels.

* **The plan** (``_compile``): the IR pass pipeline (the two BatchNorm
  fusions and ``fuse_optimizer_ops_pass`` always, the NHWC layout pass
  under ``FLAGS_cuda_nhwc``, whose ``auto`` takes only programs with
  bf16 or fp16 convolutions, then the epilogue fusion under
  ``FLAGS_cuda_fuse``, in the JAX order, :797-820) on a clone of the
  program, the
  state analysis (``analyze_state``: what the op list reads before it
  writes, and which persistable vars it writes), the feed-conversion
  plan, and the last reader of every intermediate.  A plan is cached per
  program uid and version, feed signature, fetch list and the two
  flags.
* **State** lives in the scope as tensors on the device.  A step binds
  them, runs the ops, and writes every state output back *into the
  scope's own tensor* (``copy_``): parameters, velocities and BatchNorm
  statistics are updated in place, and a tensor taken from the scope
  keeps tracking its variable.  (The fused update ops write into the
  scope's tensors themselves, so the writeback finds them current.)
* **Memory**: each intermediate is dropped after its last reader, so the
  step holds what the backward still needs and little else.
* **Random ops** draw from a ``torch.Generator`` of the executor, one
  per program, seeded from the program's ``random_seed`` at its first
  run.  (The JAX package threads a key through the scope as
  ``@RNG_KEY@``; the two streams never match, so parity tests copy the
  startup scope.)
* **Fetches** are copies: numpy arrays by default, or tensors that no
  later step overwrites.
* **The compiled step** (``FLAGS_cuda_step_session``, ``auto``: on for a
  CUDA executor; JAX's step session, :75, and its one executable per
  signature): a step session per plan and scope.  The first run of a
  signature runs eagerly on the capture stream (a warm-up: cuBLAS,
  cuDNN's plans, the gelu tables and the paged kernel's tickets); the
  second records the op list into a CUDA graph and replays it; later
  runs copy the feeds into the session's static buffers, replay and
  fetch.  The state is the scope's own tensors, whose addresses the
  in-place writeback keeps; a scope write since the capture
  (``Scope.mutation_counter``) drops the graph, and the step warms up
  and captures again.  The program's generator is registered with each
  graph, so a replay draws fresh numbers.  A session goes when its scope
  dies.  An op that cannot be captured
  raises :class:`~.framework.cuda_graph.StepCaptureError` with its type;
  nothing falls back to an eager run.  ``FLAGS_cuda_step_session=0``
  runs every step op by op, as before; ``trace_ops`` needs that.  A
  program that holds a host op (``beam_search_decode``, whose output
  comes from a backtrack on the host) runs op by op whatever the flag.
* **SelectedRows** (``framework/selected_rows.py``): a sparse
  embedding's gradient lives in the step's env between its grad op and
  its update; a fetch of one is its dense value (JAX :236-238,
  :1077-1081).
* **Feed staging** (:class:`FeedStager`, :func:`double_buffered_feeds`,
  JAX :149-222): batch k+1 is cast into pinned host memory and copied to
  the card on a side stream while step k runs
  (``FLAGS_cuda_double_buffer``).

Not ported (ROADMAP.md): the hybrid host-op path, data-parallel and
pipeline runners, the memory plan, the numerics probes and
``check_nan_inf``.
"""
from __future__ import annotations

import concurrent.futures
import time
import weakref
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import (EMPTY_VAR_NAME, Program, Variable,
                             default_main_program)
from .framework.cuda_graph import GraphSet, StepCaptureError
from .framework.dtype import VarType, to_torch_dtype
from .framework.place import resolve_place
from .framework.scope import Scope, global_scope
from .framework.selected_rows import maybe_dense
from .ops import registry
from .utils.flags import (cuda_fuse_enabled, cuda_nhwc_enabled,
                          cuda_step_session_enabled, flag_bool)

__all__ = ["Executor", "analyze_state", "build_feed_plan", "as_numpy",
           "FeedStager", "StagedFeed", "double_buffered_feeds",
           "StepCaptureError"]


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


def _dtype_key(v) -> str:
    """A feed value's dtype as torch names it: a numpy array and a tensor
    of one dtype and shape are one feed signature (one plan, one graph)."""
    dt = getattr(v, "dtype", None)
    if isinstance(dt, np.dtype):
        try:
            dt = torch.from_numpy(np.empty(0, dt)).dtype
        except TypeError:           # no torch counterpart: keep numpy's
            pass
    return str(dt)


def _fetch_name(f) -> str:
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError(f"bad fetch entry: {f!r}")


def as_numpy(value) -> np.ndarray:
    """A numpy copy of a fetched value; a bfloat16 tensor, which numpy
    cannot hold, comes back as its exact float32 upcast (float16 stays
    float16)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy().copy()
    return np.array(value)


class _Plan:
    """One compiled program: the rewritten op list, its state in/out, the
    feed plan, and per op the intermediates it is the last reader of."""

    __slots__ = ("key", "program", "ops", "state_in", "state_out",
                 "feed_plan", "fetch_names", "free_after", "fused", "host")

    def __init__(self, key, program, ops, state_in, state_out, feed_plan,
                 fetch_names, free_after, fused):
        self.key = key
        self.program = program
        self.ops = ops
        self.state_in = state_in
        self.state_out = state_out
        self.feed_plan = feed_plan
        self.fetch_names = fetch_names
        self.free_after = free_after
        self.fused = fused
        #: a host op (``registry.op(host=True)``) is in the op list: the
        #: step runs op by op, never captured
        self.host = any(registry.OPS[o.type].host for o in ops
                        if o.type in registry.OPS)


def _low_precision_convs(program: Program) -> bool:
    """Whether ``program`` has a convolution whose Input is bf16 or fp16
    (a program under ``decorate``)."""
    for blk in program.blocks:
        for op_ in blk.ops:
            if op_.type in ("conv2d", "depthwise_conv2d"):
                v = blk._find_var_recursive(op_.input("Input")[0])
                if v is not None and v.dtype in (VarType.BF16, VarType.FP16):
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




class _StepSession:
    """The compiled step of one (plan, scope) pair: the feeds' static
    device buffers (and the pinned host buffers numpy feeds are cast
    into), the scope stamp after the last eager warm-up, and once
    captured the CUDA graph, the stamp it was captured at, the fetched
    tensors it writes and the state tensors it reads and writes (held,
    so that their memory outlives the graph)."""

    __slots__ = ("scope_ref", "feeds", "staging", "warm_stamp", "stamp",
                 "graph", "fetches", "bound")

    def __init__(self, scope: Scope, on_dead=None):
        self.scope_ref = weakref.ref(scope, on_dead)
        self.feeds: Dict[str, torch.Tensor] = {}
        self.staging: Dict[str, list] = {}
        self.warm_stamp: Optional[int] = None
        self.stamp: Optional[int] = None
        self.graph = None
        self.fetches: Optional[list] = None
        self.bound: Optional[list] = None

    def drop_graph(self):
        self.graph = self.fetches = self.bound = None


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
        self._sessions: Dict[tuple, _StepSession] = {}
        self._graphs: Optional[GraphSet] = None
        self._closed = False
        #: host seconds of the last ``run`` (ends in the fetches' copy)
        self.last_run_s: Optional[float] = None
        #: wrap each op in a ``torch.profiler.record_function("op:<type>")``
        #: range, so a trace attributes device time to op types (the eager
        #: path only: ``FLAGS_cuda_step_session=0``)
        self.trace_ops = False
        #: captured graphs dropped because a scope was written since
        self.session_invalidations = 0

    def fuse_enabled(self) -> bool:
        """FLAGS_cuda_fuse resolved against this executor's device."""
        return cuda_fuse_enabled(self.device)

    def nhwc_enabled(self, program: Program) -> bool:
        """FLAGS_cuda_nhwc resolved against this executor's device and
        ``program``'s convolutions (``auto``: NHWC where they read bf16 or
        fp16)."""
        return cuda_nhwc_enabled(self.device, _low_precision_convs(program))

    def session_enabled(self) -> bool:
        """FLAGS_cuda_step_session resolved against this executor's
        device (``"1"`` on the CPU raises)."""
        return cuda_step_session_enabled(self.device)

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs this executor has captured so far."""
        return self._graphs.captured if self._graphs is not None else 0

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
        ready = getattr(feed, "ready", None)
        feed = dict(feed or {})
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        plan = self._compile(program, feed, fetch_names, scope)
        if self.session_enabled() and not plan.host:
            fetched = self._run_session(plan, program, feed, ready, scope)
        else:
            if ready is not None:
                _consume_staged(feed, ready, torch.cuda.current_stream(
                    self.device))
            fetched = self._execute(plan, program, feed, scope)
        out = ([as_numpy(v) for v in fetched] if return_numpy else
               [v.clone() if isinstance(v, torch.Tensor) else v
                for v in fetched])
        self.last_run_s = time.perf_counter() - t0
        return out

    def close(self):
        self._closed = True
        self._cache.clear()
        self._sessions.clear()

    # ------------------------------------------------------------------
    def _compile(self, program: Program, feed, fetch_names, scope) -> _Plan:
        fuse, nhwc = self.fuse_enabled(), self.nhwc_enabled(program)
        feed_spec = tuple(sorted(
            (k, tuple(np.shape(v)), _dtype_key(v)) for k, v in feed.items()))
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
        plan = _Plan(key, rewritten, ops, state_in, state_out,
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
        fuse_optimizer_ops_pass when it has an sgd, momentum or adam op,
        then layout_transform_pass when NHWC is on and it has a conv2d (after
        the BN fusions, so it sees the fused forms), then
        fuse_epilogue_pass when fusion is on and it has a conv2d or a
        matrix product (after the layout pass, so the chains it matches
        are in their final layout)."""
        from .framework.ir import _FUSABLE_OPT, PassManager, get_pass

        fuse = self.fuse_enabled() if fuse is None else fuse
        nhwc = self.nhwc_enabled(program) if nhwc is None else nhwc
        types = {o.type for b in program.blocks for o in b.ops}
        protected = tuple(fetch_names)
        passes = []
        if "batch_norm" in types:
            passes += [get_pass("fuse_bn_add_act_pass", protected=protected),
                       get_pass("fuse_bn_act_pass", protected=protected)]
        if types & set(_FUSABLE_OPT):
            # JAX keeps per-parameter updates under FLAGS_dp_sharding on
            # its collective path; the port has no collectives yet
            passes.append(get_pass("fuse_optimizer_ops_pass"))
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


    # -- the eager path --------------------------------------------------
    def _execute(self, plan: _Plan, program: Program, feed, scope: Scope):
        """One step op by op (the CPU's path, and the card's with the
        session off): the fetched values."""
        dev = self.device
        env: Dict[str, Any] = {}
        for k, v in feed.items():
            want = plan.feed_plan.get(k)
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)))
            env[k] = t.to(device=dev, dtype=want or t.dtype)
        return self._run_ops(plan, program, env, scope)

    def _run_ops(self, plan: _Plan, program: Program, env, scope: Scope,
                 capturing: bool = False):
        """Bind the state, run the op list over ``env`` and write the
        state back into the scope: in place where the scope's tensor
        takes the value (same shape, dtype and device), else by a
        ``scope.set``, which a capture may not do.  Returns the fetched
        values."""
        for n in plan.state_in:
            env[n] = self._state_value(scope, n)
        block = plan.program.global_block()
        gen = self._generator(program)
        dev = self.device
        with torch.no_grad():
            for op_, dead in zip(plan.ops, plan.free_after):
                if capturing:
                    try:
                        registry.run_op(op_, env, block, gen, dev)
                    except Exception as e:
                        raise StepCaptureError(
                            f"op {op_.type!r} cannot run inside a CUDA graph "
                            f"capture ({type(e).__name__}: {e}); "
                            f"FLAGS_cuda_step_session=0 runs the step op by "
                            f"op") from e
                elif self.trace_ops:
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
                elif capturing and cur is not val:
                    raise StepCaptureError(
                        f"state var {n!r} would be rebound in the scope "
                        f"inside a CUDA graph capture")
                elif cur is not val:
                    scope.set(n, val)
        return [maybe_dense(env[n]) for n in plan.fetch_names]

    # -- the compiled step -----------------------------------------------
    def _run_session(self, plan: _Plan, program: Program, feed, ready,
                     scope: Scope):
        """One step through the (plan, scope) pair's step session: an
        eager warm-up on the capture stream when the scope was written
        since the last one (or none ran yet), else a capture of the step
        when there is no valid graph, then a replay.  Returns the fetched
        tensors (the graph's own on a replay)."""
        if self.trace_ops:
            raise ValueError("Executor.trace_ops needs the eager path: set "
                             "FLAGS_cuda_step_session=0 to trace op ranges")
        if self._graphs is None:
            self._graphs = GraphSet(self.device)
        graphs = self._graphs
        key = (plan.key, id(scope))
        sess = self._sessions.get(key)
        if sess is None or sess.scope_ref() is not scope:
            sess = self._sessions[key] = _StepSession(
                scope, _forget_session(self._sessions, key))
        with graphs.on_stream():
            if ready is not None:
                _consume_staged(feed, ready, graphs.stream)
            env = self._load_feeds(sess, plan, feed)
            stamp = Scope.mutation_counter
            if sess.graph is not None and sess.stamp != stamp:
                # a scope write since the capture: the bound state may
                # no longer be the scope's (JAX :979-996)
                sess.drop_graph()
                self.session_invalidations += 1
            if sess.graph is None and sess.warm_stamp != stamp:
                fetched = self._run_ops(plan, program, env, scope)
                sess.warm_stamp = Scope.mutation_counter
                return fetched
            if sess.graph is None:
                self._capture(sess, plan, program, env, scope)
            sess.graph.replay()
            return sess.fetches

    def _load_feeds(self, sess: _StepSession, plan: _Plan, feed):
        """Copy this run's feeds into the session's static device buffers
        (of the signature's shapes and the program's dtypes), on the
        current stream: a device tensor directly, a host value cast into
        a pinned buffer first (cast on the host, as the eager path's
        ``.to`` does) and copied without blocking."""
        for k, v in feed.items():
            want = plan.feed_plan.get(k)
            t = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)))
            dt = want or t.dtype
            buf = sess.feeds.get(k)
            if buf is None:
                buf = sess.feeds[k] = torch.empty(
                    t.shape, dtype=dt, device=self.device)
            if t.device.type == "cuda":
                buf.copy_(t)
                continue
            slot = sess.staging.get(k)
            if slot is None:
                slot = sess.staging[k] = [
                    torch.empty(t.shape, dtype=dt, pin_memory=True), None]
            host, done = slot
            if done is not None:
                done.synchronize()      # the last copy out of it is over
            host.copy_(t)
            buf.copy_(host, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record()
        return dict(sess.feeds)

    def _capture(self, sess: _StepSession, plan: _Plan, program: Program,
                 env, scope: Scope):
        """Record the op list over the session's static feeds and the
        scope's state tensors into a CUDA graph (nothing runs), with the
        program's generator registered."""
        stamp = Scope.mutation_counter
        state = {n: self._state_value(scope, n) for n in plan.state_in}
        if Scope.mutation_counter != stamp:
            raise StepCaptureError("the scope was written while binding "
                                   "the step's state for a capture")
        env.update(state)
        outs = [scope.get(n) for n in plan.state_out]
        graph, fetched = self._graphs.capture(
            lambda: self._run_ops(plan, program, env, scope, capturing=True),
            generators=[self._generator(program)])
        sess.graph, sess.fetches = graph, fetched
        sess.bound = list(state.values()) + outs
        sess.stamp = Scope.mutation_counter


def _forget_session(sessions: Dict[tuple, _StepSession], key: tuple):
    """The callback of a session's scope reference: when the scope dies,
    its session (graph, feed buffers, bound state) leaves ``sessions``."""
    def forget(ref):
        sess = sessions.get(key)
        if sess is not None and sess.scope_ref is ref:
            del sessions[key]
    return forget


def _consume_staged(feed, ready, stream) -> None:
    """``stream`` waits for a :class:`StagedFeed`'s copies, and the
    staged tensors are marked as used on it (the caching allocator then
    keeps their memory until that stream's work is done)."""
    stream.wait_event(ready)
    for v in feed.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            v.record_stream(stream)


# ==========================================================================
# Feed staging (JAX :149-222)
# ==========================================================================
class StagedFeed(dict):
    """A feed dict whose values already sit on the executor's device in
    the program's dtypes (:meth:`FeedStager.stage`).  On the card,
    ``ready`` is the CUDA event that ends their copies: ``Executor.run``
    makes the step wait on it.  None on the CPU."""

    ready = None


class FeedStager:
    """Feed staging for the step loop: each value is cast to its feed
    var's dtype (``build_feed_plan``, the executor's rules) and put on
    ``place``.  On the card a host value is cast into pinned host memory
    and copied without blocking on a stream of the stager's own, which
    an event closes; the staged values are the stager's own memory, so a
    data loader may reuse its host buffers at once."""

    def __init__(self, program: Program, feed_names: Iterable[str],
                 place=None):
        self.plan = build_feed_plan(program.global_block(), list(feed_names))
        self.device = resolve_place(place)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def stage(self, feed: Dict[str, Any]) -> StagedFeed:
        out = StagedFeed()
        if self._stream is None:
            for k, v in feed.items():
                t = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(v)))
                out[k] = t.to(device=self.device,
                              dtype=self.plan.get(k) or t.dtype, copy=True)
            return out
        # a device value may still be in the making on the caller's stream
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for k, v in feed.items():
                want = self.plan.get(k)
                if isinstance(v, torch.Tensor) and v.device == self.device:
                    out[k] = v.to(dtype=want or v.dtype, copy=True)
                    continue
                t = (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(v)))
                host = torch.empty(t.shape, dtype=want or t.dtype,
                                   pin_memory=True)
                host.copy_(t)
                out[k] = host.to(self.device, non_blocking=True)
            out.ready = torch.cuda.Event()
            out.ready.record(self._stream)
        return out


def double_buffered_feeds(feeds: Iterable[Dict[str, Any]],
                          stager: FeedStager) -> Iterator[StagedFeed]:
    """Staged feed dicts, batch k+1 staged on a background thread while
    the caller runs step k (JAX ``double_buffered_feeds``).
    ``FLAGS_cuda_double_buffer=0`` stages each batch on the caller's
    thread when it is asked for: the same values, no overlap.  A staging
    error surfaces on the caller's thread at its batch."""
    it = iter(feeds)
    if not flag_bool("FLAGS_cuda_double_buffer"):
        for f in it:
            yield stager.stage(f)
        return
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="feed-stage")
    try:
        fut = None
        for f in it:
            nxt = pool.submit(stager.stage, f)
            if fut is not None:
                yield fut.result()      # batch k out while k+1 stages
            fut = nxt
        if fut is not None:
            yield fut.result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
