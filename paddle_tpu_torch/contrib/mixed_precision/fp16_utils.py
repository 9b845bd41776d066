"""The static AMP program rewrite (counterpart of
``paddle_tpu/contrib/mixed_precision/fp16_utils.py``; reference:
``fluid/contrib/mixed_precision/fp16_utils.py:190 rewrite_program``).

:func:`rewrite_program` walks the forward program once: it casts the
float32 inputs of white-list ops to the low dtype (bfloat16, or float16
for ``decorate(use_fp16=True)``) and marks
their float32 outputs low, and casts the low inputs of black-list ops
back to float32.  Gray-list ops are left as they are: they run in
whichever dtype their inputs arrive in, and the program keeps their
declared dtype.  The backward needs no pass of its own: ``append_backward``
differentiates the inserted ``cast`` ops like any other, so an f32
parameter read through a bf16 cast gets an f32 gradient.

Cast names (``<var>.cast_bf16_<n>`` / ``<var>.cast_<dtype>_<n>``, the
dtype as its ``VarType`` number: ``4`` for float16, ``5`` for float32) and the
cast cache (one cast per (var, dtype) for the whole program) are the JAX
package's, so a program rewritten by either package serializes to the
same ops.
"""
from __future__ import annotations

from typing import Dict

from ...framework import unique_name
from ...framework.core import Block, Program
from ...framework.dtype import VarType

__all__ = ["rewrite_program", "cast_model_to_fp16"]


def _insert_cast(block: Block, idx: int, in_name: str, dst_dtype: VarType,
                 cache: Dict) -> str:
    key = (in_name, int(dst_dtype))
    if key in cache:
        return cache[key][0]
    src_var = block._find_var_recursive(in_name)
    tag = "bf16" if dst_dtype == VarType.BF16 else dst_dtype
    out_name = unique_name.generate(f"{in_name}.cast_{tag}")
    block.create_var(name=out_name, shape=src_var.shape, dtype=dst_dtype)
    block._insert_op(
        idx, "cast",
        inputs={"X": [in_name]}, outputs={"Out": [out_name]},
        attrs={"in_dtype": int(src_var.dtype), "out_dtype": int(dst_dtype)},
    )
    cache[key] = (out_name, idx)
    return out_name


def _cast_inputs(block, op_, i, cache, want, dst, skip=frozenset()):
    """Replace each input of ``op_`` whose var has dtype ``want`` by a
    cast of it to ``dst`` (inserted before position ``i``)."""
    for slot, names in list(op_.inputs.items()):
        new_names = []
        for n in names:
            var = block._find_var_recursive(n)
            if var is not None and var.dtype == want and n not in skip:
                n = _insert_cast(block, i, n, dst, cache)
            new_names.append(n)
        op_.inputs[slot] = new_names


def rewrite_program(main_program: Program, amp_lists,
                    dest_dtype=VarType.BF16) -> Program:
    """Insert the casts around white- and black-list ops of the global
    block's forward ops, in place."""
    block = main_program.global_block()
    cache: Dict = {}
    i = 0
    while i < len(block.ops):
        op_ = block.ops[i]
        if op_.type == "cast":
            i += 1
            continue
        if op_.type in amp_lists.white_list:
            _cast_inputs(block, op_, i, cache, VarType.FP32, dest_dtype,
                         amp_lists.black_varnames)
            i = block.ops.index(op_)   # the casts went in before it
            for names in op_.outputs.values():
                for n in names:
                    var = block._find_var_recursive(n)
                    if var is not None and var.dtype == VarType.FP32:
                        var.dtype = dest_dtype
        elif op_.type in amp_lists.black_list:
            _cast_inputs(block, op_, i, cache, dest_dtype, VarType.FP32)
            i = block.ops.index(op_)
        i += 1
    main_program._bump_version()
    return main_program


def cast_model_to_fp16(program, amp_lists=None, dest_dtype=VarType.BF16):
    """The whole-program low-precision conversion (reference:
    ``fp16_utils.py cast_model_to_fp16``): :func:`rewrite_program` with
    the default lists."""
    from .fp16_lists import AutoMixedPrecisionLists

    return rewrite_program(program, amp_lists or AutoMixedPrecisionLists(),
                           dest_dtype)
