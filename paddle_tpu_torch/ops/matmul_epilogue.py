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

bf16 and fp16 operands (static AMP) take the tensor-core kernel of their
dtype (``csrc/matmul_bias_act_tc.cu``: wgmma over a ring of swizzled
shared-memory tiles, f32 accumulation) in the variant :func:`tc_variant`
picks from the shape and alignment, which rounds as
the AMP program's unfused chain does: the product to the operands' dtype
(the ``mul`` output; beyond 65504 an fp16 product is Inf), then the bias
added in the promoted dtype (f32 for an f32 bias, as jnp promotes
bf16 + f32 and fp16 + f32), then the act in that dtype.  JAX's Pallas
kernel instead adds the bias to the unrounded accumulator and stores the
operands' dtype; its own fallback, which the Program's var dtypes
describe, does what the port does (ROADMAP.md, Queue 3).

Dispatch: a tensor on the CPU (or the ``meta`` device, under shape
inference) takes the plain version; a CUDA tensor launches the kernel of
its dtype or raises (float32, bf16 or fp16 x and w, contiguous).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction
from .bn_act import ACTS, apply_act

__all__ = ["matmul_bias_act", "matmul_bias_act_reference", "tc_variant",
           "TC_VARIANTS",
           "matmul_bias_act_f32", "matmul_bias_act_bf16",
           "matmul_bias_act_fp16", "MATMUL_BIAS_ACT", "MATMUL_BIAS_ACT_F32",
           "MATMUL_BIAS_ACT_TC", "MATMUL_BIAS_ACT_BF16",
           "MATMUL_BIAS_ACT_FP16"]

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
_TC_ARGS = [_P, _P, _P, _P, _L, _L, _L, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P]
#: the 16-bit tensor-core kernels' library (csrc/matmul_bias_act_tc.cu)
MATMUL_BIAS_ACT_TC = CudaKernel("matmul_bias_act_tc.cu", {
    "paddle_matmul_bias_act_bf16": _TC_ARGS,
    "paddle_matmul_bias_act_fp16": _TC_ARGS,
})
MATMUL_BIAS_ACT_BF16 = KernelFunction(MATMUL_BIAS_ACT_TC,
                                      "paddle_matmul_bias_act_bf16",
                                      "matmul_bias_act_bf16")
MATMUL_BIAS_ACT_FP16 = KernelFunction(MATMUL_BIAS_ACT_TC,
                                      "paddle_matmul_bias_act_fp16",
                                      "matmul_bias_act_fp16")
#: the tensor-core kernel of each operand dtype
_TC = {torch.bfloat16: MATMUL_BIAS_ACT_BF16,
       torch.float16: MATMUL_BIAS_ACT_FP16}
#: the tensor-core kernel's variants, as csrc/matmul_bias_act_tc.cu numbers
#: them: its operand feed and output tile (rows x columns)
TC_VARIANTS = {"cp.async 64x64": 0, "tma 64x64": 1, "tma 128x128": 2}
_SMS = 132   # the H100's streaming multiprocessors


def tc_variant(m, n, k, x_aligned=True, w_aligned=True):
    """The variant of the tensor-core kernel 9 for an (M, K) x (K, N)
    product whose x and w start 16-byte aligned or not: the TMA feed needs
    16-byte row strides (K and N multiples of 8) and aligned bases, and
    every other shape takes the cp.async feed; a TMA product whose 128 x
    128 tiles would not fill the card's SMs takes 64 x 64 tiles, four
    times as many CTAs."""
    if k % 8 or n % 8 or not (x_aligned and w_aligned):
        return "cp.async 64x64"
    if -(-m // 128) * -(-n // 128) >= _SMS:
        return "tma 128x128"
    return "tma 64x64"


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
                f"and fp16 go to matmul_bias_act_bf16 / _fp16)")
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


def _launch_tc(name, low, x, w, bias, act, variant=None):
    """Launch the tensor-core kernel 9 of the 16-bit dtype ``low`` on
    ``torch.cuda.current_stream()`` in ``variant`` (a key of
    :data:`TC_VARIANTS`; by default :func:`tc_variant`'s); returns
    ``act(low(x @ w) + bias)`` of shape (M, N), float32 for an f32 bias
    and ``low`` for a ``low`` one."""
    if act not in ACTS:
        raise NotImplementedError(f"{name}: act {act!r} not in {list(ACTS)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}, not a CUDA device")
    m, n, k = _shapes(name, x, w, bias)
    for key, t, ok in (("x", x, (low,)), ("w", w, (low,)),
                       ("bias", bias, (torch.float32, low))):
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
    if variant is None:
        variant = tc_variant(m, n, k, x.data_ptr() % 16 == 0,
                             w.data_ptr() % 16 == 0)
    if variant not in TC_VARIANTS:
        raise ValueError(f"{name}: variant {variant!r} not in "
                         f"{list(TC_VARIANTS)}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _TC[low](x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), m, n, k, ACTS[act], int(bias.dtype == low),
                 TC_VARIANTS[variant], stream)
    return out


def matmul_bias_act_bf16(x, w, bias, act="", variant=None):
    """Launch the bf16 kernel 9: ``act(bf16(x @ w) + bias)``, float32 for
    an f32 bias and bf16 for a bf16 one."""
    return _launch_tc("matmul_bias_act_bf16", torch.bfloat16, x, w, bias,
                      act, variant)


def matmul_bias_act_fp16(x, w, bias, act="", variant=None):
    """Launch the fp16 kernel 9: ``act(fp16(x @ w) + bias)``, float32 for
    an f32 bias and fp16 for an fp16 one."""
    return _launch_tc("matmul_bias_act_fp16", torch.float16, x, w, bias,
                      act, variant)


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
        return matmul_bias_act_fp16(x, w, bias, act)
    return matmul_bias_act_f32(x, w, bias, act)
