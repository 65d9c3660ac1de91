"""SelectedRows: the sparse-gradient value type (port of
``paddle_tpu/core/selected_rows.py``; reference
framework/selected_rows.h:41).

A (rows, values) pair standing for a tall [height, ...] tensor of which
only ``rows`` are populated: the gradient of an embedding lookup touches
batch-many rows of a vocabulary-sized table, and the dense [V, D]
gradient would cost memory and a pass over the table.

``rows`` has the fixed length of the lookup's id count, duplicates
allowed. Every function here keeps fixed output shapes, with no
``torch.unique`` and no ``nonzero`` (whose shapes depend on the data and
which read the device from the host), so a compiled step captures them
in a CUDA graph. Duplicate rows are summed deterministically: a stable
sort of the ids, then one float32 ``segment_reduce`` a group, as the
lookup's dense gradient sums them (``ops/tensor_ops.py`` ``_Lookup``);
no ``index_add_`` of floats, whose atomics sum in a run-dependent order
on the card.

The ops that understand SelectedRows: ``lookup_table_sparse_grad``
makes them, ``sum`` concatenates them (a mix with dense inputs
densifies), ``sgd``, ``momentum`` and lazy ``adam``/``adamw`` update the
touched rows, and every other optimizer densifies first."""

from __future__ import annotations

from typing import List, Tuple

import torch


class SelectedRows:
    __slots__ = ("rows", "values", "height")

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 height: int):
        self.rows = rows            # [N] int64 row ids (duplicates ok)
        self.values = values        # [N, D...] row values
        self.height = int(height)   # the dense dim 0 (vocabulary size)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to_dense(self) -> torch.Tensor:
        """The dense [height, ...] tensor: each row the sum of its
        values, in the ids' order, in float32, cast to the values'
        dtype. A row id of ``height`` (an id that was out of range)
        adds nothing."""
        return _group_sum(self.rows.reshape(-1).long(), self.values,
                          self.height + 1)[:self.height]

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nrows={self.values.shape[0]})")


def _group_sum(ids: torch.Tensor, values: torch.Tensor, segments: int
               ) -> torch.Tensor:
    """[segments, ...]: row s the float32 sum, in the order the values
    come, of the values whose id is s, cast back to their dtype (ids in
    [0, segments))."""
    order = torch.sort(ids, stable=True)[1]
    counts = torch.zeros(segments, dtype=torch.int64,
                         device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))
    flat = values.reshape(values.shape[0], -1).float()
    out = torch.segment_reduce(flat.index_select(0, order), "sum",
                               lengths=counts, unsafe=True)
    return out.to(values.dtype).reshape((segments,)
                                        + tuple(values.shape[1:]))


def merge_duplicates(sr: SelectedRows) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's merge step (operators/math/selected_rows_functor.cc
    MergeAdd) under static shapes: (rows_u [N], values_u [N, ...]). The
    rows are sorted; group g (the g-th distinct row) has its row id in
    slot g and the sum of its values there; the unused slots past the
    last group carry the sentinel row id ``height`` and zero values.
    Optimizers with state take each touched row's total gradient once."""
    rows = sr.rows.reshape(-1).long()
    n = rows.shape[0]
    srt, order = torch.sort(rows, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(first.long(), 0) - 1          # [N] group index
    counts = torch.zeros(n, dtype=torch.int64,
                         device=rows.device).index_add_(
        0, seg, torch.ones_like(seg))
    vals = sr.values.index_select(0, order)
    flat = vals.reshape(n, -1).float()
    values_u = torch.segment_reduce(flat, "sum", lengths=counts,
                                    unsafe=True).to(vals.dtype).reshape(
        vals.shape)
    rows_u = torch.full((n,), sr.height, dtype=torch.int64,
                        device=rows.device).scatter_(0, seg, srt)
    return rows_u, values_u


def write_slots(sr: SelectedRows) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(rows_w [N], values_w [N, ...], live [N]) for a row-wise update,
    the reference's scatter with mode='drop' under static shapes:
    ``merge_duplicates``, with every sentinel slot pointed at the last
    group (its row and its summed values). Such a slot writes the value
    the last group's own slot writes, computed from the same inputs, so
    the row gets one value whatever order the writes land in. ``live``
    is false only where no group is a row of the table (every id out of
    range): there an update writes each row's old value back. rows_w is
    always a row of the table."""
    rows_u, values_u = merge_duplicates(sr)
    valid = rows_u < sr.height
    n = rows_u.shape[0]
    last = (valid.sum() - 1).clamp_min(0)
    src = torch.where(valid, torch.arange(n, device=rows_u.device), last)
    return (rows_u[src].clamp_max(sr.height - 1), values_u[src],
            valid[src])


def concat(parts: List[SelectedRows]) -> SelectedRows:
    """Gradient accumulation of SelectedRows: the rows concatenated (the
    SelectedRows branch of sum_op.cc; duplicates merge where an
    optimizer takes them)."""
    if not parts or not all(isinstance(p, SelectedRows) for p in parts):
        raise TypeError("concat takes a non-empty list of SelectedRows")
    return SelectedRows(torch.cat([p.rows.reshape(-1) for p in parts]),
                        torch.cat([p.values for p in parts]),
                        parts[0].height)
