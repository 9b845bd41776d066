"""Device placement for the port (counterpart of
``paddle_tpu/framework/place.py``).

Every entry point takes ``device="cuda"`` (or ``CUDAPlace(0)``) by
default and resolves it here.  Without a CUDA device that raises:
nothing falls back to the CPU unless the caller asks for ``"cpu"`` or
``CPUPlace()``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace",
           "resolve_place", "is_compiled_with_cuda"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string, ``torch.device`` or place) as a
    ``torch.device``; raises ``RuntimeError`` for a CUDA device this
    process cannot use."""
    if isinstance(device, Place):
        return device.device
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


class Place:
    """Base of the fluid places; ``device`` is the resolved
    ``torch.device``."""

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class CPUPlace(Place):
    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def resolve_place(place=None) -> torch.device:
    """An executor's place as a ``torch.device``: None means
    ``CUDAPlace(0)``, which raises without a card."""
    return resolve_device(CUDAPlace(0) if place is None else place)


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()
