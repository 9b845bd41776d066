"""Parameter initializers (counterpart of ``paddle_tpu/initializer.py``).

Each initializer fills a tensor in place, drawing from an explicit
``torch.Generator`` on the tensor's device (or, when the initializer was
given a nonzero ``seed``, from a generator of its own seeded with it, as
the JAX lowerings key their draw by a nonzero ``seed`` attr).  The values
are not JAX's: the two packages' random streams differ, so parity tests
carry weights across instead.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["Initializer", "ConstantInitializer",
           "TruncatedNormalInitializer", "XavierInitializer"]


class Initializer:
    seed = 0

    def __call__(self, param: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self._fill(param, self._generator(param, generator))

    def _generator(self, param, generator):
        if self.seed:
            gen = torch.Generator(device=param.device)
            gen.manual_seed(self.seed)
            return gen
        return generator

    def _fill(self, param, generator):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0, force_cpu: bool = False):
        self.value = value

    def _fill(self, param, generator):
        param.fill_(float(self.value))


class TruncatedNormalInitializer(Initializer):
    """``loc + scale * N(0, 1)`` truncated to two standard deviations
    (the JAX lowering's ``truncated_normal(-2, 2)``), by the inverse CDF
    of a uniform draw."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def _fill(self, param, generator):
        lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
                  for x in (-2.0, 2.0))
        u = torch.empty_like(param, dtype=torch.float32)
        u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        param.copy_(x * self.scale + self.loc)


def fan_in_out(shape: Sequence[int]) -> Tuple[int, int]:
    """Paddle's fans: a 2-D weight is ``[in, out]``; a conv filter is
    ``[out, in, *kernel]``."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def _fill(self, param, generator):
        fi, fo = fan_in_out(list(param.shape))
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            param.uniform_(-limit, limit, generator=generator)
        else:
            param.normal_(0.0, math.sqrt(2.0 / (fi + fo)),
                          generator=generator)
