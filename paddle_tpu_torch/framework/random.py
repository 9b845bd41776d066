"""Default random generators (the port's counterpart of the program
``random_seed`` the JAX package threads through its tracer).

Every random draw of the port takes an explicit ``torch.Generator``.  A
layer or op called without one draws from :func:`default_generator` of
its device: one generator per device, seeded with 0.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["default_generator", "seeded_generator"]

_GENERATORS: Dict[torch.device, torch.Generator] = {}


def default_generator(device) -> torch.Generator:
    """The shared generator of ``device`` (created on first use)."""
    dev = torch.device(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        _GENERATORS[dev] = gen
    return gen


def seeded_generator(device, seed: int) -> torch.Generator:
    """A new generator of ``device`` seeded with ``seed``: a random op with
    a fixed seed draws the same numbers on every run.  Raises inside a
    CUDA graph capture, whose replays could not re-seed it."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"a random op with a fixed seed ({seed}) re-seeds a generator "
            f"of its own on every run, which a CUDA graph cannot replay")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen
