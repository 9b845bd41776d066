"""SelectedRows: the sparse row-set gradient value (counterpart of
``paddle_tpu/framework/selected_rows.py``; reference:
paddle/fluid/framework/selected_rows.h:32, a {rows, value, height}
triple made by a sparse embedding's backward and consumed by the
optimizers' SelectedRows kernels).

``rows`` are the raw ids, duplicates kept, so every shape is static and
a step that makes or reads one stays capturable in a CUDA graph.  Every
sum over duplicate ids runs in one fixed order: :meth:`to_dense` and
:meth:`merge_rows` go through ``index_put_`` with ``accumulate``, which
on the card sorts the ids and adds each id's rows in turn (never float
atomics), so two runs, or a captured step and an eager one, give the
same bits.

Ops that are not sparse-aware see the dense value
(``ops/registry.py`` ``LowerCtx.ins``, ``SPARSE_AWARE``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "maybe_dense", "gather_rows", "add_rows",
           "scatter_rows"]


class SelectedRows:
    """rows: ``[n]`` int64 row indices (duplicates allowed); values:
    ``[n, *dim]`` per-row values; height: the row count of the dense
    equivalent."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to_dense(self) -> torch.Tensor:
        """The dense ``[height, *dim]`` value: each row added into its
        id's row, duplicates summed in one order, a sentinel slot of
        :meth:`merge_rows` dropped."""
        dense = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return add_rows(dense, self, self.values)

    def merge_rows(self) -> "SelectedRows":
        """Duplicate rows summed (reference: math::scatter::MergeAdd), in
        a fixed order: a stable sort of the ids, then one accumulating
        ``index_put_`` into the sorted segments.  The result keeps length
        n (static shapes): each distinct row once, in ascending order,
        then the leftover slots, whose row is the sentinel ``height`` and
        whose value is 0 (:func:`gather_rows` and :func:`scatter_rows`
        skip them)."""
        n = self.rows.shape[0]
        order = torch.sort(self.rows, stable=True)[1]
        r_s = self.rows[order]
        v_s = self.values[order]
        boundary = torch.ones_like(r_s)
        boundary[1:] = (r_s[1:] != r_s[:-1]).to(r_s.dtype)
        seg = torch.cumsum(boundary, 0) - 1
        merged = torch.zeros_like(self.values).index_put_(
            (seg,), v_s, accumulate=True)
        rows_m = torch.full((n,), self.height, dtype=r_s.dtype,
                            device=r_s.device).index_put_((seg,), r_s)
        return SelectedRows(rows_m, merged, self.height)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        # dense + sparse -> dense
        return maybe_dense(other) + self.to_dense()

    __radd__ = __add__

    def numpy(self) -> np.ndarray:
        return self.to_dense().detach().cpu().numpy()


def maybe_dense(v):
    """Densify a SelectedRows, pass anything else through."""
    return v.to_dense() if isinstance(v, SelectedRows) else v


def gather_rows(t: torch.Tensor, merged: SelectedRows) -> torch.Tensor:
    """``t``'s rows at a merged SelectedRows' rows, 0 at its sentinel
    slots (JAX ``t.at[rows].get(mode="fill", fill_value=0)``)."""
    valid = merged.rows < merged.height
    got = t[merged.rows.clamp(max=merged.height - 1)]
    return torch.where(_bcast(valid, got), got, torch.zeros_like(got))


def add_rows(t: torch.Tensor, sr: SelectedRows,
             vals: torch.Tensor) -> torch.Tensor:
    """``t`` (in place) with ``vals`` added at ``sr``'s rows, duplicates
    summed in one order, sentinel slots dropped (JAX
    ``t.at[rows].add(vals)``, whose out-of-range rows drop)."""
    valid = sr.rows < sr.height
    rows = torch.where(valid, sr.rows, torch.zeros_like(sr.rows))
    vals = torch.where(_bcast(valid, vals), vals, torch.zeros_like(vals))
    return t.index_put_((rows,), vals.to(t.dtype), accumulate=True)


def scatter_rows(t: torch.Tensor, merged: SelectedRows,
                 new_rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its rows at a merged SelectedRows' rows set to
    ``new_rows`` and the sentinel slots dropped (JAX
    ``t.at[rows].set(new, mode="drop")``).  A sentinel slot writes the
    first slot's row and value again (slot 0 always holds a real row),
    so every write of a row carries the same value and the result does
    not depend on the order of the writes."""
    valid = merged.rows < merged.height
    rows = torch.where(valid, merged.rows, merged.rows[:1])
    vals = torch.where(_bcast(valid, new_rows), new_rows, new_rows[:1])
    return t.clone().index_put_((rows,), vals.to(t.dtype))


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))
