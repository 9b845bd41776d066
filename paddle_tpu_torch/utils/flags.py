"""Flags of the port (counterpart of ``paddle_tpu/utils/flags.py``).

Only the flags the ported paths read.  A flag's value comes from, in
order: :func:`set_flags`, the environment variable of the same name, the
default below.  The TPU-named flags get CUDA names here:

* ``FLAGS_cuda_fuse`` (JAX ``FLAGS_tpu_fuse``): the epilogue fusion
  (``framework/ir.py`` ``fuse_epilogue_pass``).  ``"auto"`` turns it on
  when the executor's place is a CUDA device and off on the CPU; ``"1"``
  and ``"0"`` force it on or off.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["DEFAULTS", "UNPORTED", "set_flags", "get_flag", "cuda_fuse_enabled"]

DEFAULTS: Dict[str, Any] = {
    "FLAGS_cuda_fuse": "auto",
}
#: JAX-package flags whose machinery the port has not taken yet
#: (ROADMAP.md): setting one raises ``NotImplementedError``
UNPORTED: Dict[str, str] = {
    "FLAGS_verify_passes": "the static verifier (framework/verifier.py)",
    "FLAGS_hbm_budget_mb": "the memory plan (framework/memory_plan.py)",
    "FLAGS_memory_relief": "memory_relief_pass and the memory plan",
    "FLAGS_cuda_nhwc": "layout_transform_pass (JAX FLAGS_tpu_nhwc)",
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


def cuda_fuse_enabled(device) -> bool:
    """FLAGS_cuda_fuse resolved against the executor's ``torch.device``."""
    v = get_flag("FLAGS_cuda_fuse")
    s = str(v).strip().lower()
    if s == "auto":
        return device.type == "cuda"
    return s in ("1", "true", "yes", "on")
