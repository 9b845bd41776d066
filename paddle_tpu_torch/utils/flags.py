"""Flags of the port (counterpart of ``paddle_tpu/utils/flags.py``).

Only the flags the ported paths read.  A flag's value comes from, in
order: :func:`set_flags`, the environment variable of the same name, the
default below.  The TPU-named flags get CUDA names here:

* ``FLAGS_cuda_fuse`` (JAX ``FLAGS_tpu_fuse``): the epilogue fusion
  (``framework/ir.py`` ``fuse_epilogue_pass``).  ``"auto"`` turns it on
  when the executor's place is a CUDA device and off on the CPU; ``"1"``
  and ``"0"`` force it on or off.
* ``FLAGS_cuda_nhwc`` (JAX ``FLAGS_tpu_nhwc``): the NHWC layout pass
  (``framework/ir.py`` ``layout_transform_pass``), the same ``"1"`` /
  ``"0"``.  Its ``"auto"`` is on for a CUDA device only when the
  program's convolutions read bf16 or fp16 (an AMP program): cuDNN's
  tensor-core convolutions in those dtypes are fastest channels-last, its
  f32 ones are not (an f32 ResNet-50 step
  takes 199.8 ms NHWC against 185.8 ms NCHW on an H100 80GB HBM3 at
  700 W, ``tools/train_resnet.py --profile``; ``PERF.md`` section 5).
* ``FLAGS_cuda_step_session`` (JAX ``FLAGS_tpu_step_session``): the
  compiled step.  On, a steady-state ``Executor.run`` and a steady-state
  ``ServingEngine`` decode step each replay one CUDA graph (captured on
  the second run of a feed signature or bucket, the first running
  eagerly to warm up; ``executor.py``, ``inference/serving.py``).
  ``"auto"`` turns it on for a CUDA executor or engine and off on the
  CPU; ``"0"`` runs every step op by op, as the CPU does; ``"1"`` forces
  it on and raises on the CPU, where there is no graph to capture.
* ``FLAGS_cuda_double_buffer`` (JAX ``FLAGS_tpu_double_buffer``):
  ``executor.double_buffered_feeds`` stages batch k+1 (the cast into
  pinned host memory and the copy to the card on a side stream) on a
  background thread while step k runs.  ``"0"`` stages each batch on
  the caller's thread when it is asked for: the same values, no overlap.

The serving flags keep the JAX names and defaults and are read where the
JAX engine reads them (``inference/serving.py``, ``inference/kv_cache.py``):

* ``FLAGS_kv_cache_dtype`` ("float32"): the KV pools' storage dtype,
  "float32", "bfloat16" or "int8";
* ``FLAGS_kv_prefix_cache`` (False): the copy-on-write prefix cache;
* ``FLAGS_prefill_chunk_tokens`` (0): the chunked-prefill slice;
* ``FLAGS_sample_temperature`` (0.0): > 0 arms sampled decoding with
  that temperature (``inference/spec_decode.SamplingParams``);
* ``FLAGS_spec_decode_k`` (0): > 0 arms speculative decoding with that
  many drafted tokens a step (the n-gram proposer);
* ``FLAGS_admission_policy`` ("fifo"): "fifo" or "slo_aware"
  (``inference/admission.py``).

The observability flags keep the JAX names and defaults too, read where
the JAX package reads them:

* ``FLAGS_telemetry`` (True): the metrics registry of
  ``utils/telemetry.py``; off, every instrument is the shared no-op;
* ``FLAGS_slo_ttft_ms``, ``FLAGS_slo_token_ms`` (0.0: unset),
  ``FLAGS_slo_objective`` (0.99), ``FLAGS_slo_window`` (256): the SLO
  tracker's targets;
* ``FLAGS_trace_requests`` (False), ``FLAGS_trace_sample_rate`` (1.0),
  ``FLAGS_trace_seed`` (0): request span trees (``utils/tracing.py``);
* ``FLAGS_chaos`` (""): the serving fault schedule (``utils/chaos.py``).
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["DEFAULTS", "UNPORTED", "set_flags", "get_flag", "flag_bool",
           "flag_float",
           "cuda_fuse_enabled", "cuda_nhwc_enabled",
           "cuda_step_session_enabled"]

DEFAULTS: Dict[str, Any] = {
    "FLAGS_cuda_fuse": "auto",
    "FLAGS_cuda_nhwc": "auto",
    "FLAGS_cuda_step_session": "auto",
    "FLAGS_cuda_double_buffer": True,
    "FLAGS_kv_cache_dtype": "float32",
    "FLAGS_kv_prefix_cache": False,
    "FLAGS_prefill_chunk_tokens": 0,
    "FLAGS_sample_temperature": 0.0,
    "FLAGS_spec_decode_k": 0,
    "FLAGS_admission_policy": "fifo",
    "FLAGS_telemetry": True,
    "FLAGS_slo_ttft_ms": 0.0,
    "FLAGS_slo_token_ms": 0.0,
    "FLAGS_slo_objective": 0.99,
    "FLAGS_slo_window": 256,
    "FLAGS_trace_requests": False,
    "FLAGS_trace_sample_rate": 1.0,
    "FLAGS_trace_seed": 0,
    "FLAGS_chaos": "",
}
#: JAX-package flags whose machinery the port has not taken yet
#: (ROADMAP.md): setting one raises ``NotImplementedError``
UNPORTED: Dict[str, str] = {
    "FLAGS_verify_passes": "the static verifier (framework/verifier.py)",
    "FLAGS_hbm_budget_mb": "the memory plan (framework/memory_plan.py)",
    "FLAGS_memory_relief": "memory_relief_pass and the memory plan",
    "FLAGS_check_nan_inf": "the numerics probes",
}
_SET: Dict[str, Any] = {}


def set_flags(flags: Dict[str, Any]) -> None:
    """``fluid.set_flags``: set flags for this process."""
    for k, v in flags.items():
        if k in UNPORTED:
            raise NotImplementedError(f"{k}: {UNPORTED[k]} is not ported "
                                      f"(ROADMAP.md)")
        if k not in DEFAULTS:
            raise KeyError(f"unknown flag {k!r}; the port has "
                           f"{sorted(DEFAULTS)}")
        _SET[k] = v


def get_flag(name: str):
    if name in _SET:
        return _SET[name]
    if name in os.environ:
        return os.environ[name]
    return DEFAULTS[name]


def flag_float(name: str) -> float:
    """A numeric flag as a float (an environment string parsed)."""
    return float(get_flag(name) or 0.0)


def flag_bool(name: str) -> bool:
    """A boolean flag: a bool as set, or a string from the environment
    ("1", "true", "yes", "on" are true)."""
    v = get_flag(name)
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _on_for(name: str, device) -> bool:
    s = str(get_flag(name)).strip().lower()
    if s == "auto":
        return device.type == "cuda"
    return s in ("1", "true", "yes", "on")


def cuda_fuse_enabled(device) -> bool:
    """FLAGS_cuda_fuse resolved against the executor's ``torch.device``."""
    return _on_for("FLAGS_cuda_fuse", device)


def cuda_nhwc_enabled(device, low_precision_convs: bool) -> bool:
    """FLAGS_cuda_nhwc resolved against the executor's ``torch.device``
    and, for ``"auto"``, whether the program's convolutions read a 16-bit
    float type (bf16 or fp16: ``low_precision_convs``)."""
    if str(get_flag("FLAGS_cuda_nhwc")).strip().lower() == "auto":
        return device.type == "cuda" and low_precision_convs
    return _on_for("FLAGS_cuda_nhwc", device)


def cuda_step_session_enabled(device) -> bool:
    """FLAGS_cuda_step_session resolved against a ``torch.device``:
    ``"auto"`` is on for a CUDA device only; ``"1"`` on any other device
    raises, since there is no graph to capture there."""
    on = _on_for("FLAGS_cuda_step_session", device)
    if on and device.type != "cuda":
        raise ValueError(
            f"FLAGS_cuda_step_session={get_flag('FLAGS_cuda_step_session')!r} "
            f"captures the step in a CUDA graph: it needs a CUDA device, "
            f"not {device}")
    return on
