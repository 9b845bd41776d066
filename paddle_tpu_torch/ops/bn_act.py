"""The conv epilogue of a fused conv -> BN (-> add) -> activation chain:
the CUDA kernels' wrappers and their plain PyTorch versions.

Counterparts of ``paddle_tpu/ops/pallas_kernels.py``:

* :func:`bn_act_apply` (``bn_act_apply`` :1100, kernel
  ``_scale_shift_act_kernel`` :1039): ``y = act(x*a + b [+ z])`` with
  per-channel ``a`` and ``b`` in x's dtype (the folded BN scale and
  shift);
* :func:`bn_act_bwd_apply` (``bn_act_bwd_apply`` :1146, kernel
  ``_bn_act_bwd_kernel`` :1131): one pass over ``(y, dy, x)`` giving
  ``g = act'(y) * dy`` and ``dx = g*cg + (x - mean)*cx + c0``, with ``g``
  written out too when ``want_g`` (the residual add's gradient).

``act`` is one of "", relu, sigmoid, tanh and exact-erf gelu for the
forward (``apply_act`` :1010), "" or relu for the backward
(``_act_mask_grad`` :1027; any other raises, as in JAX).  The channel
axis ``c_axis`` may be any axis: 1 for NCHW, the last for NHWC.  The
TPU's tiling gates (``c % 8``, the block ladders, ``_channel_tiling``
returning None) are TPU facts: the kernels take any shape with C >= 1.

Dtypes: float32 (the f32 program), bfloat16 (static AMP) or float16
(static AMP with loss scaling), one kernel each (``csrc/bn_act.cu``,
templated on the storage type).  In bf16 and fp16 every tensor and
per-channel vector is of that dtype except the backward's ``c0``, which
stays f32 and is rounded to the storage dtype before its add, as in the
Pallas kernel (:1140); ``dx`` comes out in x's dtype and ``g`` in dy's.

Dispatch: a tensor on the CPU (or the ``meta`` device, under shape
inference) takes the plain version; a CUDA tensor launches the kernel of
its dtype or raises.  The plain versions are PyTorch ops in the tensors'
dtype, in the kernels' term order, so each multiply and add rounds to
that dtype where the Pallas kernel's storage-dtype arithmetic rounds, and
on the card the kernels equal them bit for bit for "" and relu and in the
backward.  (XLA's CPU runs the Pallas kernel's fp16 body in f32 and
rounds less often, so in fp16 JAX on the CPU lies up to two fp16 rounding
steps away: ROADMAP.md, Queue 3.)
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["ACTS", "apply_act", "act_mask_grad", "bn_act_apply",
           "bn_act_apply_reference", "bn_act_apply_f32", "bn_act_bwd_apply",
           "bn_act_bwd_reference", "bn_act_bwd_f32", "BN_ACT",
           "BN_ACT_APPLY", "BN_ACT_BWD",
           "BN_ACT_APPLY_BF16", "BN_ACT_BWD_BF16", "BN_ACT_APPLY_FP16",
           "BN_ACT_BWD_FP16"]

#: the activation codes of csrc/bn_act.cu
ACTS = {"": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "gelu": 4}
_BWD_ACTS = ("", "relu")

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
#: the hand-written Hopper kernels' library (csrc/bn_act.cu)
_FWD_ARGS = [_P, _P, _P, _P, _P, _L, _L, _L, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _P]
BN_ACT = CudaKernel("bn_act.cu", {
    "paddle_bn_act_fwd_f32": _FWD_ARGS, "paddle_bn_act_bwd_f32": _BWD_ARGS,
    "paddle_bn_act_fwd_bf16": _FWD_ARGS, "paddle_bn_act_bwd_bf16": _BWD_ARGS,
    "paddle_bn_act_fwd_fp16": _FWD_ARGS, "paddle_bn_act_bwd_fp16": _BWD_ARGS,
})
#: its kernels; ``launches`` counts every launch of the wrappers below
BN_ACT_APPLY = KernelFunction(BN_ACT, "paddle_bn_act_fwd_f32",
                              "bn_act_apply_f32")
BN_ACT_BWD = KernelFunction(BN_ACT, "paddle_bn_act_bwd_f32",
                            "bn_act_bwd_f32")
BN_ACT_APPLY_BF16 = KernelFunction(BN_ACT, "paddle_bn_act_fwd_bf16",
                                   "bn_act_apply_bf16")
BN_ACT_BWD_BF16 = KernelFunction(BN_ACT, "paddle_bn_act_bwd_bf16",
                                 "bn_act_bwd_bf16")
BN_ACT_APPLY_FP16 = KernelFunction(BN_ACT, "paddle_bn_act_fwd_fp16",
                                   "bn_act_apply_fp16")
BN_ACT_BWD_FP16 = KernelFunction(BN_ACT, "paddle_bn_act_bwd_fp16",
                                 "bn_act_bwd_fp16")
#: (forward, backward) kernel of each storage dtype
_KERNELS = {torch.float32: (BN_ACT_APPLY, BN_ACT_BWD),
            torch.bfloat16: (BN_ACT_APPLY_BF16, BN_ACT_BWD_BF16),
            torch.float16: (BN_ACT_APPLY_FP16, BN_ACT_BWD_FP16)}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue's activation menu (JAX ``apply_act``)."""
    if not act:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "gelu":
        return F.gelu(y)
    raise NotImplementedError(f"fused epilogue act {act!r}")


def act_mask_grad(y: torch.Tensor, dy: torch.Tensor, act: str):
    """``g = act'(y) * dy`` from the saved output ``y`` (JAX
    ``_act_mask_grad``)."""
    if not act:
        return dy
    if act == "relu":
        return torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                  device=dy.device))
    raise NotImplementedError(f"fused epilogue act grad {act!r}")


def _bshape(x: torch.Tensor, c_axis: int):
    c_axis %= x.dim()
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return shape


def bn_act_apply_reference(x, a, b, z=None, act="relu", c_axis=1):
    """Plain version of kernel 7: ``act(x*a + b [+ z])``."""
    shape = _bshape(x, c_axis)
    y = x * a.reshape(shape) + b.reshape(shape)
    if z is not None:
        y = y + z
    return apply_act(y, act)


def bn_act_bwd_reference(y, dy, x, cg, mean, cx, c0, act="relu", c_axis=1,
                         want_g=False):
    """Plain version of kernel 8: ``(dx, g if want_g else None)``."""
    shape = _bshape(x, c_axis)
    g = act_mask_grad(y, dy, act)
    dx = (g * cg.reshape(shape) + (x - mean.reshape(shape))
          * cx.reshape(shape) + c0.reshape(shape).to(g.dtype))
    return dx.to(x.dtype), (g if want_g else None)


def _geometry(name, x, c_axis) -> Tuple[int, int]:
    """(channels, inner): element ``i`` of ``x`` is in channel
    ``(i // inner) % channels``."""
    if x.dim() == 0:
        raise ValueError(f"{name}: x must have a channel axis")
    c_axis %= x.dim()
    channels = x.shape[c_axis]
    if channels < 1:
        raise ValueError(f"{name}: no channels in x{tuple(x.shape)}")
    return channels, math.prod(x.shape[c_axis + 1:])


def _check(name, dev, tensors, shapes, dtypes):
    """Every tensor contiguous, on ``dev`` (a CUDA device), of its
    expected dtype and shape."""
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"the CUDA device of x ({dev})")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected "
                             f"{dtypes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")


def _storage(name, x) -> torch.dtype:
    if x.dtype not in _KERNELS:
        raise ValueError(f"{name}: x is {x.dtype}; the kernels take "
                         f"float32, bfloat16 and float16")
    return x.dtype


def _launch_fwd(name, x, a, b, z, act, c_axis, want_dtype=None):
    if act not in ACTS:
        raise NotImplementedError(f"{name}: act {act!r} not in {list(ACTS)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}, not a CUDA device")
    dt = _storage(name, x)
    if want_dtype is not None and dt != want_dtype:
        raise ValueError(f"{name}: x is {dt}, expected {want_dtype}")
    channels, inner = _geometry(name, x, c_axis)
    tensors = {"x": x, "a": a, "b": b}
    shapes = {"x": x.shape, "a": (channels,), "b": (channels,)}
    if z is not None:
        tensors["z"], shapes["z"] = z, x.shape
    _check(name, dev, tensors, shapes, dict.fromkeys(tensors, dt))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[dt][0](x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        z.data_ptr() if z is not None else None,
                        y.data_ptr(), x.numel(), channels, inner, ACTS[act],
                        stream)
    return y


def _launch_bwd(name, y, dy, x, cg, mean, cx, c0, act, c_axis, want_g,
                want_dtype=None):
    if act not in _BWD_ACTS:
        raise NotImplementedError(f"{name}: act grad {act!r} is not "
                                  f"supported (only {list(_BWD_ACTS)})")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}, not a CUDA device")
    dt = _storage(name, x)
    if want_dtype is not None and dt != want_dtype:
        raise ValueError(f"{name}: x is {dt}, expected {want_dtype}")
    channels, inner = _geometry(name, x, c_axis)
    vec = (channels,)
    tensors = {"y": y, "dy": dy, "x": x, "cg": cg, "mean": mean, "cx": cx,
               "c0": c0}
    shapes = {"y": x.shape, "dy": x.shape, "x": x.shape, "cg": vec,
              "mean": vec, "cx": vec, "c0": vec}
    dtypes = dict.fromkeys(tensors, dt)
    dtypes["c0"] = torch.float32
    _check(name, dev, tensors, shapes, dtypes)
    dx = torch.empty_like(x)
    g = torch.empty_like(x) if want_g else None
    if x.numel() == 0:
        return dx, g
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _KERNELS[dt][1](y.data_ptr(), dy.data_ptr(), x.data_ptr(),
                        cg.data_ptr(), mean.data_ptr(), cx.data_ptr(),
                        c0.data_ptr(), dx.data_ptr(),
                        g.data_ptr() if want_g else None, x.numel(),
                        channels, inner, ACTS[act], stream)
    return dx, g


def bn_act_apply_f32(x, a, b, z=None, act="relu", c_axis=1):
    """Launch kernel 7 (f32) on ``torch.cuda.current_stream()``; returns
    y."""
    return _launch_fwd("bn_act_apply_f32", x, a, b, z, act, c_axis,
                       torch.float32)


def bn_act_bwd_f32(y, dy, x, cg, mean, cx, c0, act="relu", c_axis=1,
                   want_g=False):
    """Launch kernel 8 (f32) on ``torch.cuda.current_stream()``; returns
    ``(dx, g if want_g else None)``."""
    return _launch_bwd("bn_act_bwd_f32", y, dy, x, cg, mean, cx, c0, act,
                       c_axis, want_g, torch.float32)


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "meta"):
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"bn_act: no path for device {x.device}")


def bn_act_apply(x, a, b, z: Optional[torch.Tensor] = None, act="relu",
                 c_axis=1) -> torch.Tensor:
    """``act(x*a + b [+ z])``: the kernel of x's dtype for a CUDA tensor,
    the plain version on the CPU."""
    if _route(x) == "kernel":
        return _launch_fwd("bn_act_apply", x, a, b, z, act, c_axis)
    return bn_act_apply_reference(x, a, b, z, act, c_axis)


def bn_act_bwd_apply(y, dy, x, cg, mean, cx, c0, act="relu", c_axis=1,
                     want_g=False):
    """``(dx, g if want_g else None)``: the kernel of x's dtype for a CUDA
    tensor, the plain version on the CPU."""
    if _route(x) == "kernel":
        return _launch_bwd("bn_act_bwd_apply", y, dy, x, cg, mean, cx, c0,
                           act, c_axis, want_g)
    return bn_act_bwd_reference(y, dy, x, cg, mean, cx, c0, act, c_axis,
                                want_g)
