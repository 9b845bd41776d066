"""Dtype / VarType model (counterpart of ``paddle_tpu/framework/dtype.py``).

The same ``VarType`` enum values as the JAX package, so that a serialized
program reads the same in both, with numpy and torch interop.  bfloat16
has no numpy type here: it maps to ``torch.bfloat16`` only.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = ["VarType", "FLOAT_TYPES", "convert_dtype", "to_numpy_dtype",
           "to_torch_dtype", "dtype_name", "is_float", "canonical_dtype"]


class VarType(enum.IntEnum):
    # Tensor element dtypes (the reference proto enum's values).
    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    UINT8 = 20
    INT8 = 21
    BF16 = 22
    COMPLEX64 = 23
    COMPLEX128 = 24

    # Variable container types.
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18


_NP_TO_VT = {
    np.dtype(np.bool_): VarType.BOOL,
    np.dtype(np.int16): VarType.INT16,
    np.dtype(np.int32): VarType.INT32,
    np.dtype(np.int64): VarType.INT64,
    np.dtype(np.float16): VarType.FP16,
    np.dtype(np.float32): VarType.FP32,
    np.dtype(np.float64): VarType.FP64,
    np.dtype(np.uint8): VarType.UINT8,
    np.dtype(np.int8): VarType.INT8,
    np.dtype(np.complex64): VarType.COMPLEX64,
    np.dtype(np.complex128): VarType.COMPLEX128,
}
_VT_TO_NP = {v: k for k, v in _NP_TO_VT.items()}

_TORCH_TO_VT = {
    torch.bool: VarType.BOOL,
    torch.int16: VarType.INT16,
    torch.int32: VarType.INT32,
    torch.int64: VarType.INT64,
    torch.float16: VarType.FP16,
    torch.float32: VarType.FP32,
    torch.float64: VarType.FP64,
    torch.uint8: VarType.UINT8,
    torch.int8: VarType.INT8,
    torch.bfloat16: VarType.BF16,
    torch.complex64: VarType.COMPLEX64,
    torch.complex128: VarType.COMPLEX128,
}
_VT_TO_TORCH = {v: k for k, v in _TORCH_TO_VT.items()}

_STR_TO_VT = {
    "bool": VarType.BOOL,
    "int16": VarType.INT16,
    "int32": VarType.INT32,
    "int64": VarType.INT64,
    "float16": VarType.FP16,
    "float32": VarType.FP32,
    "float64": VarType.FP64,
    "uint8": VarType.UINT8,
    "int8": VarType.INT8,
    "bfloat16": VarType.BF16,
    "complex64": VarType.COMPLEX64,
    "complex128": VarType.COMPLEX128,
}
_VT_TO_STR = {v: k for k, v in _STR_TO_VT.items()}

FLOAT_TYPES = frozenset(
    {VarType.FP16, VarType.FP32, VarType.FP64, VarType.BF16}
)

#: the 32-bit type a compile-time result of a 64-bit type is recorded as
#: (see :func:`canonical_dtype`)
_CANONICAL = {VarType.INT64: VarType.INT32, VarType.FP64: VarType.FP32,
              VarType.COMPLEX128: VarType.COMPLEX64}


def convert_dtype(dtype) -> VarType:
    """Accept VarType / numpy dtype / torch dtype / str / python type and
    return VarType."""
    if isinstance(dtype, VarType):
        return dtype
    if isinstance(dtype, torch.dtype):
        try:
            return _TORCH_TO_VT[dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype: {dtype!r}") from None
    if isinstance(dtype, str):
        try:
            return _STR_TO_VT[dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype string: {dtype!r}") from None
    if dtype in (float,):
        return VarType.FP32
    if dtype in (int,):
        return VarType.INT64
    if dtype in (bool,):
        return VarType.BOOL
    npdt = np.dtype(dtype)
    try:
        return _NP_TO_VT[npdt]
    except KeyError:
        raise ValueError(f"unsupported dtype: {dtype!r}") from None


def to_numpy_dtype(dtype) -> np.dtype:
    vt = convert_dtype(dtype)
    if vt not in _VT_TO_NP:
        raise ValueError(f"{vt.name} has no numpy dtype here")
    return _VT_TO_NP[vt]


def to_torch_dtype(dtype) -> torch.dtype:
    return _VT_TO_TORCH[convert_dtype(dtype)]


def dtype_name(dtype) -> str:
    return _VT_TO_STR[convert_dtype(dtype)]


def is_float(dtype) -> bool:
    return convert_dtype(dtype) in FLOAT_TYPES


def canonical_dtype(dtype) -> VarType:
    """The dtype compile-time shape inference records for a result of
    ``dtype``: 64-bit types as their 32-bit counterparts.  The JAX
    package infers shapes with ``jax.eval_shape`` in JAX's default
    32-bit mode, which records (for example) ``top_k``'s int64 indices
    as int32; recording them the same way keeps a program built here
    equal, desc for desc, to one built there.  Run-time tensors keep
    their own dtypes."""
    vt = convert_dtype(dtype)
    return _CANONICAL.get(vt, vt)
