"""Host events of the serving engine and request tracing: the part of
``paddle_tpu/profiler.py`` they call.

* :class:`RecordEvent` marks a host range (the engine's ``prefill``,
  ``decode_batch``, ``verify_batch``); while a session is on it also
  opens a ``torch.profiler.record_function`` range of the same name, so
  a ``torch.profiler`` trace of the card shows the range over the
  kernels it launched.
* :func:`instant_event` marks a moment (an admission, a preemption, a
  shed, an injected fault) and :func:`complete_event` records a range
  timed elsewhere (a request's span, ``utils/tracing.py``).
* :func:`enable_profiler` / :func:`disable_profiler` open and close a
  session; events go to a process-local list (:func:`get_events`).

Off (the default), every entry point costs one flag check.  The rest of
the JAX module (summaries, the chrome-trace file, the calibration feed)
is not ported (ROADMAP.md, Queue 1 item 9).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

__all__ = ["RecordEvent", "instant_event", "complete_event",
           "is_profiler_enabled", "enable_profiler", "disable_profiler",
           "get_events"]

_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: List[dict] = []


def is_profiler_enabled() -> bool:
    return _ENABLED


def _append(ev: dict):
    with _LOCK:
        _EVENTS.append(ev)


class RecordEvent:
    """``with RecordEvent("decode_batch", cat="serving"): ...``: a host
    range on lane ``cat``; a no-op while no session is on."""

    def __init__(self, name: str, cat: str = "host"):
        self.name = name
        self.cat = cat
        self._begin = None
        self._range = None

    def __enter__(self):
        if _ENABLED:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self._begin = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._begin is None:
            return False
        end = time.perf_counter()
        self._range.__exit__(*exc)
        _append({"name": self.name, "cat": self.cat, "ts": self._begin,
                 "dur": end - self._begin, "tid": threading.get_ident(),
                 "ph": "X"})
        self._begin = self._range = None
        return False


def instant_event(name: str, cat: str = "host",
                  args: Optional[dict] = None):
    """A zero-duration marker on lane ``cat``."""
    if not _ENABLED:
        return
    ev = {"name": name, "cat": cat, "ts": time.perf_counter(), "dur": 0.0,
          "tid": threading.get_ident(), "ph": "i"}
    if args:
        ev["args"] = dict(args)
    _append(ev)


def complete_event(name: str, cat: str = "host", ts: float = 0.0,
                   dur: float = 0.0, tid: Optional[int] = None,
                   args: Optional[dict] = None):
    """An already-timed range; ``tid`` overrides the thread id (a
    request's spans share one row)."""
    if not _ENABLED:
        return
    ev = {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur),
          "tid": threading.get_ident() if tid is None else int(tid),
          "ph": "X"}
    if args:
        ev["args"] = dict(args)
    _append(ev)


def enable_profiler():
    """Start a session with an empty event list."""
    global _ENABLED
    with _LOCK:
        _EVENTS.clear()
    _ENABLED = True


def disable_profiler() -> List[dict]:
    """End the session; returns its events."""
    global _ENABLED
    _ENABLED = False
    return get_events()


def get_events() -> List[dict]:
    with _LOCK:
        return list(_EVENTS)
