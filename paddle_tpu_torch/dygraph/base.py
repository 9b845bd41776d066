"""Dygraph AMP state and ``amp_guard`` (counterpart of
``paddle_tpu/dygraph/base.py:76-121`` and the tracer's AMP fields,
``paddle_tpu/dygraph/tracer.py:48-58, 70-78``).

The state is one process-wide record, as the JAX package keeps it on its
one tracer: whether AMP is on, its dtype, and the white and black op
lists (None: the default lists of
:mod:`~paddle_tpu_torch.contrib.mixed_precision.fp16_lists`, with
``fused_multihead_attention`` white).  :func:`amp_guard` sets it for a
block; :func:`~paddle_tpu_torch.dygraph.amp.amp_cast` reads it at each op
front.  The guard also holds the per-step cast cache (one cast of each
tensor, whatever the number of white-list ops that read it): the
outermost guard opens it and drops it on exit.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..contrib.mixed_precision.fp16_lists import (AutoMixedPrecisionLists,
                                                  black_list, white_list)

__all__ = ["amp_guard", "auto_cast", "amp_state", "AMP_DTYPES"]

#: the AMP dtypes the port runs, by name (float16 is not ported)
AMP_DTYPES = {"bfloat16": torch.bfloat16}


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.white: Optional[set] = None
        self.black: Optional[set] = None
        self.cache: Optional[dict] = None

    def lists(self):
        """(white, black): the guard's lists, else the defaults."""
        if self.white is None:
            return (set(white_list) | {"fused_multihead_attention"},
                    set(black_list))
        return self.white, self.black


_STATE = _AmpState()


def amp_state() -> _AmpState:
    return _STATE


def check_amp_dtype(dtype: str) -> None:
    """Raise ``NotImplementedError`` for an AMP dtype the port lacks."""
    if str(dtype) not in AMP_DTYPES:
        raise NotImplementedError(
            f"AMP dtype {dtype!r} is not ported (ROADMAP.md): the port "
            f"runs AMP in bfloat16")


@contextlib.contextmanager
def amp_guard(enable=True, custom_white_list=None, custom_black_list=None,
              dtype="bfloat16", level="O1"):
    """Dygraph auto-mixed-precision for the block: white-list ops
    (``matmul``, ``fused_multihead_attention``, ...) take bf16 casts of
    their f32 inputs, black-list ops (``mean``, ``softmax``, ...) f32
    casts of their bf16 inputs (``softmax_with_cross_entropy`` excepted
    under bf16: it upcasts inside), every other op runs in the dtype it
    receives.  The casts are autograd ops, so the backward runs in the
    forward's precisions.

    ``enable=False`` turns off an enclosing guard.  Custom lists merge
    as :class:`AutoMixedPrecisionLists` does; ``level="O2"`` also makes
    ``lookup_table`` and ``lookup_table_v2`` white, so the activations
    stay bf16 from the embeddings on.  A guard with neither keeps the
    enclosing guard's lists.  ``dtype="float16"`` raises
    ``NotImplementedError`` (not ported)."""
    if enable:
        check_amp_dtype(dtype)
    st = _STATE
    prev = (st.enabled, st.dtype, st.white, st.black, st.cache)
    st.enabled = bool(enable)
    st.dtype = str(dtype)
    if custom_white_list or custom_black_list or level == "O2":
        lists = AutoMixedPrecisionLists(custom_white_list, custom_black_list)
        st.white = lists.white_list | {"fused_multihead_attention"}
        if level == "O2":
            st.white |= {"lookup_table", "lookup_table_v2"}
        st.black = lists.black_list
    if st.cache is None:
        st.cache = {}
    try:
        yield
    finally:
        st.enabled, st.dtype, st.white, st.black, st.cache = prev


# paddle 2.0 name
auto_cast = amp_guard
