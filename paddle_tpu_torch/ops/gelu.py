"""Exact-erf GELU on bfloat16 and float16 tensors, rounding where the JAX
package's compiled lowering rounds: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd function that joins them.

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

In float16 the compiled form rounds at other points (its ``f16``
multiplies survive, and XLA's CPU keeps fp16 subnormals): see
:func:`gelu_fp16_reference` and :func:`gelu_fp16_grad_reference`.

``F.gelu`` computes in f32 and rounds once, and differed from the
compiled form on about a fifth of bf16 inputs and on 31.8% of fp16
inputs (forward; 52.1% backward).  :func:`gelu_lowp` is the bf16 and fp16
gelu of the port: the kernels ``gelu_fwd_bf16`` / ``gelu_bwd_bf16`` and
``gelu_fwd_fp16`` / ``gelu_bwd_fp16`` (``csrc/gelu_lowp.cu``) on the card,
the plain versions below on the CPU; the kernels equal the plain versions
bit for bit on the card.  None replaces a Pallas kernel: XLA fuses the JAX
lowering on its own.

What depends on x alone sits in tables that a kernel builds once per
device and dtype (:func:`gelu_tables`): the ``e = erfc`` and ``ee = exp``
terms of the inputs whose magnitude lies in their bands,
:data:`GELU_BANDS` (outside a band they equal those at its nearer edge,
so the kernels clamp the index; bf16 pairs the two terms over one band,
fp16 evaluates e's ``|u| < 1`` branch instead of tabling it); the
forward is ``rb(rb(0.5 x) * e)``, the backward the dy-dependent rest.
:func:`gelu_table_reference` computes the same tables with the plain ops.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernel_build import CudaKernel, KernelFunction

__all__ = ["erfc_xla", "gelu_bf16_reference", "gelu_bf16_grad_reference",
           "gelu_fp16_reference", "gelu_fp16_grad_reference",
           "gelu_table_reference", "gelu_xterms_reference", "gelu_tables",
           "GELU_BANDS",
           "gelu_fwd_bf16", "gelu_bwd_bf16", "gelu_fwd_fp16",
           "gelu_bwd_fp16", "gelu_lowp", "GELU", "GELU_FWD_BF16",
           "GELU_BWD_BF16", "GELU_FWD_FP16", "GELU_BWD_FP16",
           "GELU_TABLES_BF16", "GELU_TABLES_FP16"]

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
#: the hand-written Hopper kernels' library (csrc/gelu_lowp.cu)
GELU = CudaKernel("gelu_lowp.cu", {
    "paddle_gelu_tables_bf16": [_P, _I, _I, _I, _I, _P],
    "paddle_gelu_tables_fp16": [_P, _I, _I, _I, _I, _P],
    "paddle_gelu_fwd_bf16": [_P, _P, _L, _P, _I, _I, _I, _I, _P],
    "paddle_gelu_bwd_bf16": [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P],
    "paddle_gelu_fwd_fp16": [_P, _P, _L, _P, _I, _I, _I, _I, _P],
    "paddle_gelu_bwd_fp16": [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P],
})
GELU_FWD_BF16 = KernelFunction(GELU, "paddle_gelu_fwd_bf16", "gelu_fwd_bf16")
GELU_BWD_BF16 = KernelFunction(GELU, "paddle_gelu_bwd_bf16", "gelu_bwd_bf16")
GELU_FWD_FP16 = KernelFunction(GELU, "paddle_gelu_fwd_fp16", "gelu_fwd_fp16")
GELU_BWD_FP16 = KernelFunction(GELU, "paddle_gelu_bwd_fp16", "gelu_bwd_fp16")
#: the tables' builders, launched once per device and dtype
GELU_TABLES_BF16 = KernelFunction(GELU, "paddle_gelu_tables_bf16",
                                  "gelu_tables_bf16")
GELU_TABLES_FP16 = KernelFunction(GELU, "paddle_gelu_tables_fp16",
                                  "gelu_tables_fp16")
#: the kernels by dtype: (forward, backward, table builder)
_KERNELS = {torch.bfloat16: (GELU_FWD_BF16, GELU_BWD_BF16, GELU_TABLES_BF16),
            torch.float16: (GELU_FWD_FP16, GELU_BWD_FP16, GELU_TABLES_FP16)}
#: per dtype, the bands ((lo, hi) of |x|'s 15 bits, x's bits without the
#: sign) over which the tables hold e (each sign) and ee: at and below lo
#: a term equals that of lo, at and above hi - 1 (Inf included) that of
#: hi - 1.  bf16 pairs e and ee over one band (each sign); fp16 holds ee
#: (even in x) over its own band of one sign, and its e band starts at
#: 1.4140625, the least |x| whose u = fp16(0.70703125 |x|) is 1: below it
#: the kernels evaluate the small branch of erfc.
#: tests/test_torch_gelu_lowp.py proves the bands on every input.
GELU_BANDS = {torch.bfloat16: ((15136, 16725), (15136, 16725)),
              torch.float16: ((15784, 17804), (9641, 17893))}

_FLT_MIN = 1.1754943508222875e-38
_SQRT_HALF = 0.70703125      # sqrt(1/2) rounded to bf16
_TWO_OVER_SQRT_PI = 1.125    # 2/sqrt(pi) rounded to bf16
_TWO_OVER_SQRT_PI_FP16 = 1.1279296875   # and to fp16 (sqrt(1/2) is the same)


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to (signed) zero."""
    return t * (t.abs() >= _FLT_MIN).to(t.dtype)


def _rb(t: torch.Tensor) -> torch.Tensor:
    """An f32 result flushed, then rounded to bf16 (kept as f32)."""
    return _ftz(t).to(torch.bfloat16).float()


def _exp(t: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor, correctly rounded to f32 on every device: in
    float64, rounded once.  (f32 ``torch.exp`` is CUDA's ``expf`` on the
    card, up to 2 ulps off: 0.61 ulp at -z of bf16 x = -1.71875, enough to
    put erfc there on a bf16 rounding tie; XLA's CPU exp and the CPU's
    ``torch.exp`` are correctly rounded at every input the gelus reach.)"""
    return torch.exp(t.double()).float()


def erfc_xla(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfc (the Cephes ``erfcf`` polynomials), op for op."""
    au, z = u.abs(), u * u
    p = z * 7.85386146e-05 + (-0.000801019371)
    for c in (0.00518832775, -0.0268538129, 0.112835854, -0.37612626,
              1.12837911):
        p = p * z + c
    small = 1.0 - u * p
    q = _ftz(_ftz(_exp(-z)) * (1.0 / au))
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
    ee = _rb(_ftz(_exp(-_rb(u * u))))
    t1 = _rb(-_rb(_rb(r3 * ee) * _SQRT_HALF))
    t2 = _rb(_rb(d * e) * 0.5)
    return _ftz(t1 + t2).to(torch.bfloat16)


def _rh(t: torch.Tensor) -> torch.Tensor:
    """An f32 result rounded to fp16, subnormals kept (kept as f32)."""
    return t.to(torch.float16).float()


def gelu_fp16_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gelu_fwd_fp16``:
    ``fp16(fp16(0.5 x) * fp16(erfc(fp16(-x * 0.70703125))))``."""
    x32 = x.float()
    e = _rh(erfc_xla(_rh(x32 * -_SQRT_HALF)))
    return (_rh(0.5 * x32) * e).to(torch.float16)


def gelu_fp16_grad_reference(x: torch.Tensor, dy: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of ``gelu_bwd_fp16``: dx of the compiled ``jax.vjp``
    of the fp16 gelu, every op rounded to fp16 but ``m3 * 0.70703125``,
    which is exact in f32."""
    x32, d = x.float(), dy.float()
    u = _rh(x32 * -_SQRT_HALF)
    e = _rh(erfc_xla(u))
    r3 = _rh(_rh(_rh(x32 * 0.5) * d) * -_TWO_OVER_SQRT_PI_FP16)
    m3 = _rh(r3 * _rh(_exp(-_rh(u * u))))
    t2 = _rh(_rh(d * e) * 0.5)
    return (t2 - m3 * _SQRT_HALF).to(torch.float16)


def gelu_xterms_reference(x: torch.Tensor) -> tuple:
    """The x-only terms of the bf16 or fp16 backward, ``e`` (erfc) and
    ``ee`` (exp), by the plain ops (those of ``gelu_*_grad_reference``),
    in x's dtype."""
    if x.dtype == torch.bfloat16:
        u32 = _ftz(x.float()) * -_SQRT_HALF
        e = _rb(erfc_xla(u32))
        u = _rb(u32)
        ee = _rb(_ftz(_exp(-_rb(u * u))))
    else:
        u = _rh(x.float() * -_SQRT_HALF)
        e = _rh(erfc_xla(u))
        ee = _rh(_exp(-_rh(u * u)))
    return e.to(x.dtype), ee.to(x.dtype)


def _ee_offset(span_e: int) -> int:
    """Where the ee table starts: after the e table, 16-byte aligned."""
    return -(-2 * span_e // 8) * 8


def _table_len(dtype, bands) -> int:
    (lo_e, hi_e), (lo_ee, hi_ee) = bands
    if dtype == torch.bfloat16:
        return 4 * (hi_e - lo_e)
    return _ee_offset(hi_e - lo_e) + hi_ee - lo_ee


def gelu_table_reference(dtype, bands=None) -> torch.Tensor:
    """The ``dtype`` (bf16 or fp16) kernels' tables by the plain ops on the
    CPU, as :func:`gelu_tables` lays them out (int16), over ``bands`` =
    ((lo_e, hi_e), (lo_ee, hi_ee)) (by default :data:`GELU_BANDS`'), for
    the input of sign ``s`` and magnitude bits ``a``, ``i = s * (hi_e -
    lo_e) + a - lo_e``: bf16 holds e at ``2 i`` and ee at ``2 i + 1`` (its
    ee band is e's); fp16 holds e at ``i`` and, from ``2 * (hi_e - lo_e)``
    rounded up to a multiple of 8, ee of magnitude bits ``a`` at ``a -
    lo_ee``."""
    bands = bands or GELU_BANDS[dtype]
    (lo_e, hi_e), (lo_ee, hi_ee) = bands
    mags = torch.arange(lo_e, hi_e, dtype=torch.int32)
    xe = torch.cat([mags, mags | 0x8000]).to(torch.int16).view(dtype)
    e, ee = (t.view(torch.int16) for t in gelu_xterms_reference(xe))
    out = torch.zeros(_table_len(dtype, bands), dtype=torch.int16)
    if dtype == torch.bfloat16:
        out[0::2], out[1::2] = e, ee
        return out
    xee = torch.arange(lo_ee, hi_ee, dtype=torch.int32).to(
        torch.int16).view(dtype)
    out[:2 * (hi_e - lo_e)] = e
    out[_ee_offset(hi_e - lo_e):] = gelu_xterms_reference(xee)[1].view(
        torch.int16)
    return out


def _bands_args(dtype) -> tuple:
    (lo_e, hi_e), (lo_ee, hi_ee) = GELU_BANDS[dtype]
    return lo_e, hi_e - lo_e, lo_ee, hi_ee - lo_ee


#: {(dtype, device index): the kernels' tables} on the card
_TABLES = {}


def gelu_tables(dtype, device) -> torch.Tensor:
    """The ``dtype`` kernels' tables on the CUDA ``device``: built by the
    ``gelu_tables_*`` kernel at the first call for that device (not while a
    CUDA graph is being captured), kept for the process."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"gelu_tables: {dev} is not a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dtype, dev.index)
    if key not in _TABLES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "gelu_tables: the gelu tables are built outside a CUDA "
                "graph capture; call gelu_tables(dtype, device) (or the "
                "gelu once) before capturing")
        tables = torch.zeros(_table_len(dtype, GELU_BANDS[dtype]),
                             dtype=torch.int16, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            _KERNELS[dtype][2](tables.data_ptr(), *_bands_args(dtype),
                               stream.cuda_stream)
            stream.synchronize()   # ready for launches on any stream
        _TABLES[key] = tables
    return _TABLES[key]


def _check(name, dtype, **tensors):
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}; the kernel "
                             f"takes CUDA tensors on one device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, not "
                             f"{str(dtype).replace('torch.', '')}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def _fwd(dtype, x: torch.Tensor) -> torch.Tensor:
    kernel = _KERNELS[dtype][0]
    dev = _check(kernel.name, dtype, x=x)
    y = torch.empty_like(x)
    if x.numel():
        tables = gelu_tables(dtype, dev)
        with torch.cuda.device(dev):
            kernel(x.data_ptr(), y.data_ptr(), x.numel(), tables.data_ptr(),
                   *_bands_args(dtype),
                   torch.cuda.current_stream(dev).cuda_stream)
    return y


def _bwd(dtype, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    kernel = _KERNELS[dtype][1]
    dev = _check(kernel.name, dtype, x=x, dy=dy)
    if dy.shape != x.shape:
        raise ValueError(f"{kernel.name}: dy{tuple(dy.shape)} is not "
                         f"x{tuple(x.shape)}")
    dx = torch.empty_like(x)
    if x.numel():
        tables = gelu_tables(dtype, dev)
        with torch.cuda.device(dev):
            kernel(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel(),
                   tables.data_ptr(), *_bands_args(dtype),
                   torch.cuda.current_stream(dev).cuda_stream)
    return dx


def gelu_fwd_bf16(x: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_fwd_bf16`` on the current stream."""
    return _fwd(torch.bfloat16, x)


def gelu_bwd_bf16(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_bwd_bf16`` on the current stream."""
    return _bwd(torch.bfloat16, x, dy)


def gelu_fwd_fp16(x: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_fwd_fp16`` on the current stream."""
    return _fwd(torch.float16, x)


def gelu_bwd_fp16(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch ``gelu_bwd_fp16`` on the current stream."""
    return _bwd(torch.float16, x, dy)


#: the plain versions by dtype: (forward, backward)
_PLAIN = {torch.bfloat16: (gelu_bf16_reference, gelu_bf16_grad_reference),
          torch.float16: (gelu_fp16_reference, gelu_fp16_grad_reference)}


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"gelu: no path for device {x.device}")


class _GeluLowp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if _on_card(x):
            return _fwd(x.dtype, x)
        return _PLAIN[x.dtype][0](x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if _on_card(x):
            return _bwd(x.dtype, x, dy)
        return _PLAIN[x.dtype][1](x, dy)


def gelu_lowp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 or fp16 gelu, with its gradient: the kernels for a CUDA
    tensor, the plain versions on the CPU."""
    if x.dtype not in _KERNELS:
        raise ValueError(f"gelu_lowp takes bfloat16 or float16, not "
                         f"{x.dtype}")
    return _GeluLowp.apply(x.contiguous())
