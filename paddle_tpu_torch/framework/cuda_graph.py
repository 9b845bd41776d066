"""Step capture: whole steps as CUDA graphs (the port's counterpart of
the JAX package's one compiled executable per feed signature).

A :class:`GraphSet` belongs to one owner, an ``Executor`` or a serving
engine core.  It holds one capture stream and one memory pool that all
of the owner's graphs share: they never run at the same time, so one
graph's scratch may be another's.  The owner runs every captured step,
and the eager warm-up before it, on the capture stream
(:meth:`GraphSet.on_stream`), so that what the warm-up sets up per
stream (cuBLAS's workspace, cuDNN's plans, the paged kernel's ticket
buffer) is what the capture records.

A capture only records: nothing runs until :meth:`CapturedStep.replay`.
So the hand-written kernels' wrappers count no launch while a step is
captured (:func:`~paddle_tpu_torch.kernel_build.recorded_launches`),
and each replay adds what the capture recorded: a kernel's ``launches``
go up where it runs, by as much as an eager step's would.  An error inside the capture ends it and propagates; the
owners turn it into a :class:`StepCaptureError` that names the op, and
never fall back to an eager run.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Sequence

import torch

from ..kernel_build import recorded_launches

__all__ = ["CapturedStep", "GraphSet", "StepCaptureError"]


class StepCaptureError(RuntimeError):
    """A step could not be captured in a CUDA graph: one of its ops syncs
    with the host, copies from pageable host memory or draws from a
    generator the graph does not know.  ``FLAGS_cuda_step_session=0``
    runs the step op by op instead."""


class CapturedStep:
    """A captured CUDA graph and the hand-written kernel launches it
    holds (``{KernelFunction: count}``)."""

    __slots__ = ("graph", "launches")

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        """Replay the graph; each kernel it holds counts its launches."""
        self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n


class GraphSet:
    """One capture stream and one memory pool on ``device``, and the
    count of graphs captured with them (:attr:`captured`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        #: a graph of one small fill, alive as long as the set: the pool
        #: lives while a graph holds it, and a dropped graph must not
        #: take it with it before the next capture
        self._keeper = None
        #: graphs captured so far (each a new signature, bucket or a
        #: re-capture after a scope write)
        self.captured = 0

    @contextlib.contextmanager
    def on_stream(self):
        """Run the body on the capture stream, after the work already
        queued on the current stream; the current stream then waits for
        the body's work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def capture(self, fn: Callable, generators: Sequence = ()):
        """``(CapturedStep, fn())``: ``fn`` recorded into a new CUDA graph
        in the shared pool, on the current stream (call it inside
        :meth:`on_stream`), with the kernel launches it records.  Each of
        ``generators`` is registered with the graph, so a replay draws the
        numbers an eager run would draw next instead of the captured
        ones."""
        if self._keeper is None:
            keeper = torch.cuda.CUDAGraph()
            keeper.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")
            buf = torch.zeros(1, device=self.device)
            keeper.capture_end()
            self._keeper = (keeper, buf)
        # the capture allocates from the set's own pool, which cannot
        # take the regular pool's cached free blocks, and no block can be
        # freed while a capture runs: a step as large as the card
        # (BERT-base at batch 44) needs that memory released first
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            with recorded_launches() as launches:
                out = fn()
        except BaseException:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # "graph is empty"
                    graph.capture_end()
            except Exception:   # the capture is invalid: fn's error stands
                pass
            raise
        graph.capture_end()
        self.captured += 1
        return CapturedStep(graph, launches), out
