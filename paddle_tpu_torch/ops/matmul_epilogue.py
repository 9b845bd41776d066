"""The fc epilogue of a fused matmul -> bias -> activation chain: the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas_kernels.py``
:func:`matmul_bias_act` (:1207, kernel ``_matmul_bias_act_kernel``
:1186): ``act(x @ w + bias)`` on 2-D ``x (M, K)``, ``w (K, N)`` and
``bias (N,)``, with the bias and the activation applied to the f32
accumulator before the one store of each output tile.  ``act`` is one of
"", relu, sigmoid, tanh and exact-erf gelu (``apply_act``).

Divergence from the TPU kernel: JAX engages it only where its block
ladders tile the shape without padding (M % 8, K % 128, N % 128,
``_pick_div`` :1215-1219) and only on a TPU (``_epilogue_engages``
:1003), running the jnp composition everywhere else.  Those are facts of
the TPU's (8, 128) tiling: the CUDA kernel masks its ragged edges and
takes any M, N, K >= 1, so LeNet's 120-, 84- and 400-wide layers run it
too.

bf16 operands (static AMP) take the bf16 kernel
(``csrc/matmul_bias_act_bf16.cu``, tensor cores, f32 accumulation), which
rounds as the AMP program's unfused chain does: the product to bf16 (the
``mul`` output), then the bias added in the promoted dtype (f32 for an f32
bias, as jnp promotes bf16 + f32), then the act in that dtype.  JAX's
Pallas kernel instead adds the bias to the unrounded accumulator and
stores bf16; its own fallback, which the Program's var dtypes describe,
does what the port does (ROADMAP.md, Queue 3).

Dispatch: a tensor on the CPU (or the ``meta`` device, under shape
inference) takes the plain version; a CUDA tensor launches the kernel of
its dtype or raises (float32 or bf16 x and w, contiguous; float16 is not
ported).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction
from .bn_act import ACTS, apply_act

__all__ = ["matmul_bias_act", "matmul_bias_act_reference",
           "matmul_bias_act_f32", "matmul_bias_act_bf16", "MATMUL_BIAS_ACT",
           "MATMUL_BIAS_ACT_F32", "MATMUL_BIAS_ACT_BF16_LIB",
           "MATMUL_BIAS_ACT_BF16"]

_P = ctypes.c_void_p
_L = ctypes.c_longlong
#: the hand-written Hopper kernel's library (csrc/matmul_bias_act.cu)
MATMUL_BIAS_ACT = CudaKernel("matmul_bias_act.cu", {
    "paddle_matmul_bias_act_f32": [_P, _P, _P, _P, _L, _L, _L,
                                   ctypes.c_int, _P],
})
#: its kernel; ``launches`` counts every launch of the wrapper below
MATMUL_BIAS_ACT_F32 = KernelFunction(MATMUL_BIAS_ACT,
                                     "paddle_matmul_bias_act_f32",
                                     "matmul_bias_act_f32")
#: the bf16 tensor-core kernel's library (csrc/matmul_bias_act_bf16.cu)
MATMUL_BIAS_ACT_BF16_LIB = CudaKernel("matmul_bias_act_bf16.cu", {
    "paddle_matmul_bias_act_bf16": [_P, _P, _P, _P, _L, _L, _L,
                                    ctypes.c_int, ctypes.c_int, _P],
})
MATMUL_BIAS_ACT_BF16 = KernelFunction(MATMUL_BIAS_ACT_BF16_LIB,
                                      "paddle_matmul_bias_act_bf16",
                                      "matmul_bias_act_bf16")


def matmul_bias_act_reference(x, w, bias, act=""):
    """Plain version of kernel 9: the product (in x's and w's dtype), then
    the bias (the sum promoted as jnp promotes), then the act, in the
    order JAX's ``_matmul_bias_act_jnp`` composes them."""
    return apply_act(torch.matmul(x, w) + bias, act)


def _shapes(name, x, w, bias):
    if x.dim() != 2 or w.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"{name}: x, w and bias must be 2-D, 2-D and 1-D; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(bias.shape)}")
    m, k = x.shape
    if w.shape[0] != k or bias.shape[0] != w.shape[1]:
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} @ "
                         f"w{tuple(w.shape)} + bias{tuple(bias.shape)} do "
                         f"not chain")
    return m, w.shape[1], k


def matmul_bias_act_f32(x, w, bias, act=""):
    """Launch kernel 9 on ``torch.cuda.current_stream()``; returns
    ``act(x @ w + bias)``, float32 of shape (M, N)."""
    name = "matmul_bias_act_f32"
    if act not in ACTS:
        raise NotImplementedError(f"{name}: act {act!r} not in {list(ACTS)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}, not a CUDA device")
    m, n, k = _shapes(name, x, w, bias)
    for key, t in (("x", x), ("w", w), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected the "
                             f"CUDA device of x ({dev})")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: {key} is {t.dtype}; the kernel takes float32 (bf16 "
                f"goes to matmul_bias_act_bf16)")
        if not t.is_contiguous():
            raise NotImplementedError(f"{name}: {key} must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError(f"{name}: K is 0")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        MATMUL_BIAS_ACT_F32(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), m, n, k, ACTS[act], stream)
    return out


def matmul_bias_act_bf16(x, w, bias, act=""):
    """Launch the bf16 kernel 9 on ``torch.cuda.current_stream()``;
    returns ``act(bf16(x @ w) + bias)`` of shape (M, N), float32 for an
    f32 bias and bf16 for a bf16 one."""
    name = "matmul_bias_act_bf16"
    if act not in ACTS:
        raise NotImplementedError(f"{name}: act {act!r} not in {list(ACTS)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}, not a CUDA device")
    m, n, k = _shapes(name, x, w, bias)
    for key, t, ok in (("x", x, (torch.bfloat16,)),
                       ("w", w, (torch.bfloat16,)),
                       ("bias", bias, (torch.float32, torch.bfloat16))):
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected the "
                             f"CUDA device of x ({dev})")
        if t.dtype not in ok:
            raise NotImplementedError(f"{name}: {key} is {t.dtype}; the "
                                      f"kernel takes {ok}")
        if not t.is_contiguous():
            raise NotImplementedError(f"{name}: {key} must be contiguous")
    out = torch.empty((m, n), dtype=bias.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError(f"{name}: K is 0")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        MATMUL_BIAS_ACT_BF16(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), m, n, k, ACTS[act],
                             int(bias.dtype == torch.bfloat16), stream)
    return out


def matmul_bias_act(x, w, bias, act=""):
    """``act(x @ w + bias)``: the kernel of x's dtype for a CUDA tensor,
    the plain version on the CPU."""
    if x.device.type in ("cpu", "meta"):
        return matmul_bias_act_reference(x, w, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bias_act: no path for device {x.device}")
    if x.dtype == torch.bfloat16:
        return matmul_bias_act_bf16(x, w, bias, act)
    if x.dtype == torch.float16:
        raise NotImplementedError("matmul_bias_act: the float16 variant is "
                                  "not ported (ROADMAP.md, slice 8)")
    return matmul_bias_act_f32(x, w, bias, act)
