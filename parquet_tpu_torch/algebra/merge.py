"""Ordered merging of sorted row groups and files.

The port of ``parquet_tpu/algebra/merge.py``.  :func:`merge_row_groups`
is the in-memory merge (concatenate, one stable argsort).  :func:`iter_merged`
and :func:`merge_files` are the streaming k-way merge: each run is pulled
through the streamed read (``io/stream.py::iter_batches`` on ``device``,
one device decode a pull of pages, each batch brought to the host once,
one copy a tensor), runs without buffered rows pull their next batch, the
window (every buffered row) is argsorted once on the host, and the rows
at or below the frontier (the least last-pulled key among the runs that
still have data) go out; the rest carry over.  Memory is O(k batch_rows).
The window's sort and permutes stay numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io.reader import ParquetFile, resolve_device
from ..io.writer import ColumnData, ParquetWriter, WriterOptions, _extend_cd
from ..schema.schema import Schema
from .buffer import SortingColumn, TableBuffer, permute_column
from .convert import (column_to_data, convert_column_data, null_fill_column,
                      structural_conflict)


def merge_row_groups(sources: Sequence, sorting: Sequence[SortingColumn],
                     schema: Optional[Schema] = None,
                     device="cuda") -> TableBuffer:
    """Merge sorted row groups into one sorted in-memory buffer (every
    input decoded on ``device`` and held; :func:`merge_files` streams).
    ``schema`` converts every input to it first."""
    if not sources:
        raise ValueError("no row groups to merge")
    target = schema or sources[0].file.schema
    buf = TableBuffer(target, sorting)
    for rg in sources:
        cols = {leaf.dotted_path: convert_column_data(
            rg, leaf, rg.file.schema, device) for leaf in target.leaves}
        buf.write(cols, rg.num_rows)
    buf.sort()  # concatenated sorted runs + a stable sort == the merge
    return buf


def _batch_rows(batch) -> int:
    """A streamed batch's rows, from its first column."""
    col = next(iter(batch.values()))
    return (col.list_offsets[0].shape[0] - 1 if col.list_offsets
            else col.num_slots)


class _RunCursor:
    """Row-aligned batches of one sorted file, pulled through the stream
    on ``device`` and converted to the target schema's ColumnData."""

    def __init__(self, pf: ParquetFile, target: Schema, batch_rows: int,
                 device):
        from ..io.stream import iter_batches

        self.pf = pf
        self.target = target
        same = pf.schema is target or (
            [leaf.dotted_path for leaf in pf.schema.leaves]
            == [leaf.dotted_path for leaf in target.leaves])
        cols = None if same else [leaf.dotted_path for leaf in target.leaves
                                  if _has_leaf(pf.schema, leaf.dotted_path)]
        # rows are counted from a column: a run holding none of the
        # target's reads its first one for the count alone
        self._count_only = cols == []
        if self._count_only:
            cols = [pf.schema.leaves[0].dotted_path]
        self._it = iter_batches(
            pf, columns=cols, batch_rows=batch_rows, device=device,
            keep_levels=any(leaf.max_repetition_level > 1
                            for leaf in target.leaves))
        self.exhausted = False

    def pull(self) -> Optional[Tuple[Dict[str, ColumnData], int]]:
        t = next(self._it, None)
        if t is None:
            self.exhausted = True
            return None
        n = _batch_rows(t)
        if self._count_only:
            t = {}
        cols: Dict[str, ColumnData] = {}
        for leaf in self.target.leaves:
            p = leaf.dotted_path
            if p in t:
                src_leaf = self.pf.schema.leaf(p)
                if src_leaf.max_repetition_level != leaf.max_repetition_level:
                    raise TypeError(
                        f"cannot merge {p!r}: source is nested depth "
                        f"{src_leaf.max_repetition_level}, target depth "
                        f"{leaf.max_repetition_level}")
                cols[p] = column_to_data(t[p], src_leaf, leaf)
            else:
                if structural_conflict(self.pf.schema, leaf):
                    raise TypeError(
                        f"cannot merge {p!r}: source stores a column of "
                        "different nesting structure under the same name")
                cols[p] = null_fill_column(leaf, n)
        return cols, n


def _open_files(paths_or_files) -> Tuple[List[ParquetFile],
                                         List[ParquetFile]]:
    """(every file, the ones opened here, which the caller closes); a
    failed open closes those opened before it."""
    files: List[ParquetFile] = []
    opened: List[ParquetFile] = []
    try:
        for p in paths_or_files:
            if isinstance(p, ParquetFile):
                files.append(p)
            else:
                pf = ParquetFile(p)
                files.append(pf)
                opened.append(pf)
    except BaseException:
        for pf in opened:
            pf.close()
        raise
    if not files:
        raise ValueError("no files to merge")
    return files, opened


def _has_leaf(schema: Schema, path: str) -> bool:
    try:
        schema.leaf(path)
        return True
    except KeyError:
        return False


def _merge_keys(target: Schema, sorting: Sequence[SortingColumn],
                cols: Dict[str, ColumnData], n: int) -> List[np.ndarray]:
    """The window's key columns, primary first: ranks (consistent within
    the window, which is all the frontier test needs), a float key split
    into (NaN as +inf, is-NaN) so that NaN orders after every number
    under plain comparisons."""
    from .compare import sort_key

    keys: List[np.ndarray] = []
    for sc in sorting:
        leaf = target.leaf(sc.path)
        if leaf.max_repetition_level:
            raise ValueError("cannot merge by a repeated column")
        k = np.asarray(sort_key(leaf, cols[leaf.dotted_path], n,
                                descending=sc.descending,
                                nulls_first=sc.nulls_first))
        if k.dtype.kind == "f":
            nan = np.isnan(k)
            keys.append(np.where(nan, np.inf, k))
            keys.append(nan.astype(np.int8))
        else:
            keys.append(k)
    return keys


def _check_runs_sorted(keys: List[np.ndarray], origin: np.ndarray,
                       n: int) -> None:
    """Within the window, each run's rows (in arrival order) must not
    decrease under the merge key: a run that is not sorted raises."""
    if n < 2:
        return
    ordv = np.argsort(origin, kind="stable")  # rows by run, in order
    same = origin[ordv][1:] == origin[ordv][:-1]
    if not same.any():
        return
    lt = np.zeros(n - 1, bool)  # next < previous, lexicographically
    eq = np.ones(n - 1, bool)
    for k in keys:
        a = k[ordv]
        lt |= eq & (a[1:] < a[:-1])
        eq &= a[1:] == a[:-1]
    if (same & lt).any():
        bad = int(origin[ordv][1:][same & lt][0])
        raise ValueError(
            f"merge input run {bad} is not sorted by the merge key; "
            "merge requires pre-sorted runs (sort each input first)")


def iter_merged(paths_or_files, sorting: Sequence[SortingColumn],
                schema: Optional[Schema] = None,
                batch_rows: int = 1 << 16, device="cuda",
                ) -> Iterator[Tuple[Dict[str, ColumnData], int]]:
    """The k-way ordered merge of sorted files as sorted ``(columns,
    num_rows)`` chunks that concatenate to the whole merge, holding
    O(k batch_rows) rows; each run read through the stream on ``device``.
    Files opened here are closed when the generator ends or is closed;
    a caller's :class:`ParquetFile` stays open."""
    device = resolve_device(device)
    files, opened = _open_files(paths_or_files)
    try:
        yield from _iter_merged_open(files, sorting, schema, batch_rows,
                                     device)
    finally:
        for pf in opened:
            pf.close()


def _iter_merged_open(files, sorting, schema, batch_rows, device):
    target = schema or files[0].schema
    cursors = [_RunCursor(f, target, batch_rows, device) for f in files]
    paths = [leaf.dotted_path for leaf in target.leaves]
    leaves = {leaf.dotted_path: leaf for leaf in target.leaves}

    if not sorting:  # no order: the runs one after another
        for cur in cursors:
            while True:
                got = cur.pull()
                if got is None:
                    break
                yield got
        return

    window: Optional[Dict[str, ColumnData]] = None
    win_n = 0
    origin = np.empty(0, np.int32)

    def append(cols: Dict[str, ColumnData], n: int, who: int) -> None:
        nonlocal window, win_n, origin
        if window is None:
            window = cols
        else:
            for p in paths:
                _extend_cd(window[p], cols[p])
        win_n += n
        origin = np.concatenate([origin, np.full(n, who, np.int32)])

    while True:
        counts = (np.bincount(origin, minlength=len(cursors)) if win_n
                  else np.zeros(len(cursors), np.int64))
        for i, cur in enumerate(cursors):
            if not cur.exhausted and counts[i] == 0:
                got = cur.pull()
                if got is not None:
                    append(got[0], got[1], i)
        if win_n == 0:
            return
        live = [i for i, c in enumerate(cursors) if not c.exhausted]
        keys = _merge_keys(target, sorting, window, win_n)
        _check_runs_sorted(keys, origin, win_n)
        perm = (np.lexsort(tuple(reversed(keys))) if len(keys) > 1
                else np.argsort(keys[0], kind="stable"))
        if live:
            pos = np.empty(win_n, np.int64)
            pos[perm] = np.arange(win_n)
            # the frontier: the least of the live runs' last rows
            lasts = np.full(len(cursors), -1, np.int64)
            lasts[origin] = np.arange(win_n)
            cands = [int(lasts[i]) for i in live if lasts[i] >= 0]
            f = min(cands, key=lambda r: pos[r])
            less = np.zeros(win_n, bool)
            eq = np.ones(win_n, bool)
            for k in keys:
                fk = k[f]
                less |= eq & (k < fk)
                eq &= k == fk
            emit = int((less | eq).sum())  # rows <= the frontier: a prefix
        else:
            emit = win_n  # every run done: drain the window
        out_idx = perm[:emit]
        yield ({p: permute_column(window[p], out_idx, leaves[p])
                for p in paths}, emit)
        if emit == win_n:
            window, win_n, origin = None, 0, np.empty(0, np.int32)
        else:
            keep = np.sort(perm[emit:])
            window = {p: permute_column(window[p], keep, leaves[p])
                      for p in paths}
            origin = origin[keep]
            win_n -= emit


def merge_files(paths_or_files, sorting: Sequence[SortingColumn], sink,
                options: Optional[WriterOptions] = None,
                batch_rows: int = 1 << 16,
                row_group_rows: int = 1 << 20,
                schema: Optional[Schema] = None,
                device="cuda") -> ParquetWriter:
    """Compaction: stream-merge sorted files into one sorted file with
    O(k batch_rows + row_group_rows) rows in memory, each run read on
    ``device``.  Row groups follow ``options.row_group_size`` where
    ``options`` is given, else ``row_group_rows``; returns the closed
    writer."""
    files, opened = _open_files(paths_or_files)
    try:
        schema = schema or files[0].schema
        opts = options if options is not None else WriterOptions(
            sorting_columns=[(s.path, s.descending, s.nulls_first)
                             for s in sorting],
            row_group_size=row_group_rows)
        w = ParquetWriter(sink, schema, opts)
        try:
            for cols, n in iter_merged(files, sorting, schema,
                                       batch_rows=batch_rows, device=device):
                w.write(cols, n)
            w.close()
        except BaseException:
            w.abort()  # a path this writer opened is removed
            raise
        return w
    finally:
        for pf in opened:
            pf.close()
