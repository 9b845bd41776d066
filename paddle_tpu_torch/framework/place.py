"""Device placement for the port (counterpart of
``paddle_tpu/framework/place.py``).

Every entry point takes ``device="cuda"`` by default and resolves it
here.  Without a CUDA device that raises: nothing falls back to the CPU
unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` for a CUDA device this process cannot use."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r}: only "
                               f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
