"""In-memory row buffer with sorting.

The port of ``parquet_tpu/algebra/buffer.py``: rows accumulate as the
writer's :class:`ColumnData` a leaf; a sort is one ``np.lexsort`` over
the sorting columns' keys (``compare.sort_key``) and one gather a column
(:func:`permute_column`; byte arrays through the C++
``host.gather_byte_arrays``), on the host as in the JAX package.  A
column is flat, a list in the per-level offsets form (``list_offsets``,
one array a repeated level) or in the raw-level (Dremel) form of any
depth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..io.writer import ColumnData, ParquetWriter, _extend_cd
from ..ops import host
from ..schema.schema import Schema


@dataclass
class SortingColumn:
    """A sorting column: its dotted path, direction and null placement
    (nulls first or last whatever the direction)."""

    path: str
    descending: bool = False
    nulls_first: bool = False


class TableBuffer:
    """Columnar rows bound to a schema; sortable by its flat sorting
    columns, written out as one row group."""

    def __init__(self, schema: Schema,
                 sorting: Optional[Sequence[SortingColumn]] = None):
        self.schema = schema
        self.sorting = list(sorting or [])
        self.columns: Dict[str, ColumnData] = {}
        self.num_rows = 0

    def write(self, columns: Dict[str, ColumnData], num_rows: int) -> None:
        if not self.columns:
            self.columns = columns
            self.num_rows = num_rows
            return
        for k, v in columns.items():
            _extend_cd(self.columns[k], v)
        self.num_rows += num_rows

    def write_arrow(self, table) -> None:
        """Buffer the rows of a ``pyarrow.Table`` (``columns_from_arrow``)."""
        from ..io.writer import columns_from_arrow

        self.write(columns_from_arrow(table, self.schema), table.num_rows)

    def sort_indices(self) -> np.ndarray:
        """The row permutation that orders the buffer by the sorting
        columns (stable)."""
        if not self.sorting:
            return np.arange(self.num_rows)
        keys = [self._sort_key(sc) for sc in reversed(self.sorting)]
        return (np.lexsort(keys) if len(keys) > 1
                else np.argsort(keys[0], kind="stable"))

    def _sort_key(self, sc: SortingColumn) -> np.ndarray:
        from .compare import sort_key

        leaf = self.schema.leaf(sc.path)
        if leaf.max_repetition_level:
            raise ValueError("cannot sort by a repeated column")
        return sort_key(leaf, self.columns[leaf.dotted_path], self.num_rows,
                        descending=sc.descending, nulls_first=sc.nulls_first)

    def sort(self) -> None:
        """Permute every column by the sort order (one gather a column)."""
        perm = self.sort_indices()
        for leaf in self.schema.leaves:
            cd = self.columns[leaf.dotted_path]
            self.columns[leaf.dotted_path] = permute_column(cd, perm, leaf)

    def flush_to(self, writer: ParquetWriter) -> None:
        if self.sorting:
            self.sort()
        writer.write_row_group(self.columns, self.num_rows)
        self.columns = {}
        self.num_rows = 0


def permute_column(cd: ColumnData, perm: np.ndarray, leaf) -> ColumnData:
    """Rows of one leaf column in the order ``perm``: flat, lists in the
    per-level offsets form, or the raw-level form of any depth."""
    if cd.def_levels is not None or cd.rep_levels is not None:
        return _permute_raw_levels(cd, perm, leaf)
    if cd.list_offsets is None:
        return _permute_flat(cd, perm)
    idx = np.asarray(perm, np.int64)
    lvs = cd.list_validity or [None] * len(cd.list_offsets)
    new_lo, new_lv = [], []
    for o, lv in zip(cd.list_offsets, lvs):
        o = np.asarray(o, np.int64)
        lens = (o[1:] - o[:-1])[idx]
        lo = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=lo[1:])
        new_lo.append(lo)
        new_lv.append(None if lv is None else np.asarray(lv)[idx])
        idx = _gather_ranges(o[:-1][idx], lens)  # the next level's entries
    out = _permute_flat(ColumnData(values=cd.values, offsets=cd.offsets,
                                   validity=cd.validity), idx)
    out.list_offsets = new_lo
    out.list_validity = None if all(v is None for v in new_lv) else new_lv
    return out


def _permute_raw_levels(cd: ColumnData, perm: np.ndarray,
                        leaf) -> ColumnData:
    """Rows of a raw-level (Dremel) column of any depth in a new order:
    a row is the span from one rep-0 slot to the next, the values are
    the slots at the leaf's max def level; whole-column vector ops."""
    de = np.asarray(cd.def_levels if cd.def_levels is not None
                    else np.full(_rows_of_raw(cd), leaf.max_definition_level,
                                 np.int32), np.int32)
    rep = (np.asarray(cd.rep_levels, np.int32)
           if cd.rep_levels is not None else None)
    if rep is not None:
        row_starts = np.flatnonzero(rep == 0)
        row_ends = np.append(row_starts[1:], len(rep))
    else:  # a struct chain: one slot a row
        row_starts = np.arange(len(de), dtype=np.int64)
        row_ends = row_starts + 1
    new_lens = (row_ends - row_starts)[perm]
    slot_idx = _gather_ranges(row_starts[perm], new_lens)
    present = de == leaf.max_definition_level
    vidx = (np.cumsum(present) - 1)[slot_idx[present[slot_idx]]]
    vals = np.asarray(cd.values)
    out = ColumnData(values=vals, def_levels=de[slot_idx],
                     rep_levels=None if rep is None else rep[slot_idx])
    if cd.offsets is not None:
        out.values, out.offsets = host.gather_byte_arrays(vals, cd.offsets,
                                                          vidx)
    else:
        out.values = vals[vidx] if len(vidx) else vals[:0]
    return out


def _rows_of_raw(cd: ColumnData) -> int:
    return len(cd.rep_levels) if cd.rep_levels is not None else len(
        np.asarray(cd.values))


def _permute_flat(cd: ColumnData, perm: np.ndarray) -> ColumnData:
    """Slots ``perm`` of a flat column (or a list's elements): validity
    gathered by slot, the dense values by the present slots' ordinals."""
    vals = np.asarray(cd.values)
    validity = cd.validity
    if validity is None:
        sel, new_valid = perm, None
    else:
        validity = np.asarray(validity, bool)
        new_valid = validity[perm]
        sel = (np.cumsum(validity) - 1)[perm[new_valid]]
    if cd.offsets is not None:
        values, offsets = host.gather_byte_arrays(vals, cd.offsets, sel)
        return ColumnData(values=values, offsets=offsets,
                          validity=new_valid)
    return ColumnData(values=vals[sel], validity=new_valid)


def _gather_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The indexes ``starts[i] .. starts[i] + lens[i]``, concatenated."""
    return (np.repeat(np.asarray(starts, np.int64), lens)
            + host.segment_ranges(lens))
