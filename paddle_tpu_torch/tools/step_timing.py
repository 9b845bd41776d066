"""Wall and device-busy time of a step, with the compiled step on and off.

``session_turns(step, steps)`` runs ``step`` (any callable that runs one
training or decode step and ends in a host read, as ``Executor.run`` and
``ServingEngine.step`` do) with ``FLAGS_cuda_step_session`` set in turns
(off, on, on, off by default, so that a drift of the card's clock shows
as a difference between the two runs of one setting).  Each turn warms
up (the first runs of the session on warm up and capture its graph),
times ``steps`` steps on the host's clock, then traces as many again (or
``traced``) with ``torch.profiler`` and sums the kernels' own device time
(one stream: they do not overlap).  Per turn: wall ms and busy ms per step and the
idle share ``1 - busy / wall``.

``feed_turns(exe, program, scope, fetch, batches, steps)`` times the
same step with the session on and host (numpy) batches fed three ways,
in turns: straight to ``Executor.run`` (cast into the session's pinned
buffer and copied at the start of the step), staged by
``double_buffered_feeds`` with ``FLAGS_cuda_double_buffer=0`` (staged on
the caller's thread when asked for) and with it on (batch k+1 staged on a
background thread while step k runs).  A GPU is needed.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from ..utils.flags import get_flag, set_flags

__all__ = ["device_busy_ms", "feed_turns", "session_turns",
           "self_device_us"]


def self_device_us(evt) -> float:
    """A profiler event's own device time in us (the attribute was
    renamed from ``self_cuda_time_total``)."""
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def device_busy_ms(step: Callable[[], object], steps: int) -> float:
    """Device busy ms per step over ``steps`` traced steps: the kernels'
    own time (op-range annotations are not kernels).  0.0 when the trace
    holds no device time (not measured)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(self_device_us(e) for e in prof.key_averages()
               if e.device_type == cuda and self_device_us(e) > 0
               and not e.key.startswith("op:"))
    return busy / steps / 1e3


def session_turns(step: Callable[[], object], steps: int,
                  turns: Sequence[str] = ("0", "1", "1", "0"),
                  warmup: int = 2, traced: int = 0,
                  between: Optional[Callable[[], None]] = None
                  ) -> Dict[str, object]:
    """``{"turns": [...], "off": {...}, "on": {...}}``: per turn the
    session setting, wall and busy ms per step and the idle share; under
    ``off`` and ``on`` the lowest wall and busy of that setting's turns
    and the idle share between them.  ``between`` runs after each turn
    (to drop a turn's graph, whose pool would otherwise hold a step's
    memory through the next turn)."""
    prev = get_flag("FLAGS_cuda_step_session")
    rows = []
    try:
        for value in turns:
            set_flags({"FLAGS_cuda_step_session": value})
            for _ in range(warmup):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            busy = device_busy_ms(step, traced or steps)
            rows.append({"session": "on" if value == "1" else "off",
                         "wall_ms": wall, "busy_ms": busy or "not measured",
                         "idle_share": 1.0 - busy / wall if busy else
                         "not measured"})
            if between is not None:
                between()
    finally:
        set_flags({"FLAGS_cuda_step_session": prev})
    out: Dict[str, object] = {"turns": rows}
    for side in ("off", "on"):
        mine = [r for r in rows if r["session"] == side]
        if not mine:
            continue
        wall = min(r["wall_ms"] for r in mine)
        busies = [r["busy_ms"] for r in mine
                  if not isinstance(r["busy_ms"], str)]
        busy = min(busies) if busies else "not measured"
        out[side] = {"wall_ms": wall, "busy_ms": busy,
                     "idle_share": (1.0 - busy / wall if busies
                                    else "not measured")}
    return out


def feed_turns(exe, program, scope, fetch, batches: Sequence[dict],
               steps: int, order: Sequence[str] = (
                   "host", "staged_sync", "staged_overlap", "staged_overlap",
                   "staged_sync", "host")) -> Dict[str, object]:
    """``{"turns": [...], mode: lowest wall ms per step}``: ``steps``
    steps per turn over host ``batches`` (numpy feed dicts, cycled), the
    session on, fed per ``order`` (``host``, ``staged_sync``,
    ``staged_overlap``: see the module docstring).  Each turn first runs
    two untimed steps (the session's warm-up and capture, once)."""
    from ..executor import FeedStager, double_buffered_feeds

    prev = {n: get_flag(n) for n in ("FLAGS_cuda_step_session",
                                     "FLAGS_cuda_double_buffer")}
    stager = FeedStager(program, batches[0], exe.device)
    rows = []
    try:
        set_flags({"FLAGS_cuda_step_session": "1"})
        for mode in order:
            set_flags({"FLAGS_cuda_double_buffer":
                       mode == "staged_overlap"})
            n = steps + 2
            feeds = [batches[i % len(batches)] for i in range(n)]
            if mode != "host":
                feeds = double_buffered_feeds(feeds, stager)
            for i, feed in enumerate(feeds):
                if i == 2:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
            torch.cuda.synchronize()
            rows.append({"feed": mode, "wall_ms":
                         (time.perf_counter() - t0) / steps * 1e3})
    finally:
        set_flags(prev)
    out: Dict[str, object] = {"turns": rows}
    for mode in dict.fromkeys(order):
        out[mode] = min(r["wall_ms"] for r in rows if r["feed"] == mode)
    return out
