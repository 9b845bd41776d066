"""Exact-erf GELU on bfloat16 tensors, rounding where the JAX package's
compiled lowering rounds: the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd function that joins them.

The JAX package computes a bf16 gelu as ``jax.nn.gelu(x,
approximate=False)`` (``paddle_tpu/ops/math_ops.py``), that is
``0.5 * x * erfc(-x * sqrt_half)`` with ``sqrt_half`` first rounded to
bf16 (0.70703125).  Both ``jit_train_step`` and the static executor run it
under ``jit``, and the bf16 rounding points of XLA's compiled form on the
CPU are the ``convert`` pairs that survive in the compiled HLO
(``jax.jit(f).lower(x).compile().as_text()``), not the source's:

* forward: ``bf16(bf16(0.5*x) * bf16(erfc(-x*0.70703125)))``, the erfc in
  f32 by XLA's own polynomials (:func:`erfc_xla`);
* backward (``jax.vjp``): every op rounds, see :func:`gelu_bf16_grad_reference`;
* the CPU flushes subnormal results to zero and reads subnormal inputs
  as zero.

``F.gelu`` computes in f32 and rounds once, and differed from the
compiled form on about a fifth of bf16 inputs.  :func:`gelu_lowp` is the
bf16 gelu of the port: the kernels ``gelu_fwd_bf16`` / ``gelu_bwd_bf16``
(``csrc/gelu_bf16.cu``) on the card, the plain versions below on the CPU;
the kernels do the plain versions' ops in one pass and equal them bit for
bit on the card.  Neither replaces a Pallas kernel: XLA fuses the JAX
lowering on its own.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["erfc_xla", "gelu_bf16_reference", "gelu_bf16_grad_reference",
           "gelu_fwd_bf16", "gelu_bwd_bf16", "gelu_lowp", "GELU",
           "GELU_FWD_BF16", "GELU_BWD_BF16"]

_P = ctypes.c_void_p
_L = ctypes.c_longlong
#: the hand-written Hopper kernels' library (csrc/gelu_bf16.cu)
GELU = CudaKernel("gelu_bf16.cu", {
    "paddle_gelu_fwd_bf16": [_P, _P, _L, _P],
    "paddle_gelu_bwd_bf16": [_P, _P, _P, _L, _P],
})
GELU_FWD_BF16 = KernelFunction(GELU, "paddle_gelu_fwd_bf16", "gelu_fwd_bf16")
GELU_BWD_BF16 = KernelFunction(GELU, "paddle_gelu_bwd_bf16", "gelu_bwd_bf16")

_FLT_MIN = 1.1754943508222875e-38
_SQRT_HALF = 0.70703125      # sqrt(1/2) rounded to bf16
_TWO_OVER_SQRT_PI = 1.125    # 2/sqrt(pi) rounded to bf16


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to (signed) zero."""
    return t * (t.abs() >= _FLT_MIN).to(t.dtype)


def _rb(t: torch.Tensor) -> torch.Tensor:
    """An f32 result flushed, then rounded to bf16 (kept as f32)."""
    return _ftz(t).to(torch.bfloat16).float()


def erfc_xla(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfc (the Cephes ``erfcf`` polynomials), op for op."""
    au, z = u.abs(), u * u
    p = z * 7.85386146e-05 + (-0.000801019371)
    for c in (0.00518832775, -0.0268538129, 0.112835854, -0.37612626,
              1.12837911):
        p = p * z + c
    small = 1.0 - u * p
    q = _ftz(_ftz(torch.exp(-z)) * (1.0 / au))
    w = 1.0 / z
    r1 = w * 0.0232682 + (-0.138703942)
    for c in (0.368742466, -0.582473278, 0.621000469, -0.494451523,
              0.340488, -0.274112701, 0.563825965):
        r1 = r1 * w + c
    r2 = w * (-10.477664) + 12.9772
    for c in (-7.49551868, 2.92101908, -1.01526523, 0.42184633,
              -0.282076746, 0.564189494):
        r2 = r2 * w + c
    y = _ftz(q * torch.where(au < 2.0, r1, r2))
    y = torch.where(-z < -88.7228394, torch.zeros_like(y), y)
    y = torch.where(u < 0, 2.0 - y, y)
    return torch.where(au < 1.0, small, y)


def gelu_bf16_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gelu_fwd_bf16``."""
    x32 = _ftz(x.float())
    e = _rb(erfc_xla(x32 * -_SQRT_HALF))
    return _ftz(_rb(0.5 * x32) * e).to(torch.bfloat16)


def gelu_bf16_grad_reference(x: torch.Tensor, dy: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of ``gelu_bwd_bf16``: dx of the compiled ``jax.vjp``
    of the bf16 gelu, every op rounded to bf16."""
    x32, d = _ftz(x.float()), _ftz(dy.float())
    u32 = x32 * -_SQRT_HALF
    e = _rb(erfc_xla(u32))
    r3 = _rb(_rb(_rb(0.5 * x32) * d) * -_TWO_OVER_SQRT_PI)
    u = _rb(u32)
    ee = _rb(_ftz(torch.exp(-_rb(u * u))))
    t1 = _rb(-_rb(_rb(r3 * ee) * _SQRT_HALF))
    t2 = _rb(_rb(d * e) * 0.5)
    return _ftz(t1 + t2).to(torch.bfloat16)


def _check(name, **tensors):
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}; the kernel "
                             f"takes CUDA tensors on one device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} is {t.dtype}, not bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def gelu_fwd_bf16(x: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_fwd_bf16`` on the current stream."""
    dev = _check("gelu_fwd_bf16", x=x)
    y = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(dev):
            GELU_FWD_BF16(x.data_ptr(), y.data_ptr(), x.numel(),
                          torch.cuda.current_stream(dev).cuda_stream)
    return y


def gelu_bwd_bf16(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_bwd_bf16`` on the current stream."""
    dev = _check("gelu_bwd_bf16", x=x, dy=dy)
    if dy.shape != x.shape:
        raise ValueError(f"gelu_bwd_bf16: dy{tuple(dy.shape)} is not "
                         f"x{tuple(x.shape)}")
    dx = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(dev):
            GELU_BWD_BF16(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                          x.numel(), torch.cuda.current_stream(dev).cuda_stream)
    return dx


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"gelu: no path for device {x.device}")


class _GeluBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_fwd_bf16(x) if _on_card(x) else gelu_bf16_reference(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dy = dy.to(torch.bfloat16).contiguous()
        if _on_card(x):
            return gelu_bwd_bf16(x, dy)
        return gelu_bf16_grad_reference(x, dy)


def gelu_lowp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 gelu, with its gradient: the kernels for a CUDA tensor,
    the plain versions on the CPU."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_lowp takes bfloat16, not {x.dtype}")
    return _GeluBf16.apply(x.contiguous())
