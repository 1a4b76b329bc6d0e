"""SortingWriter: sorted writes in bounded memory, by spill and merge.

The port of ``parquet_tpu/algebra/sorting.py``: rows buffer up to
``buffer_rows``; each full buffer is sorted and spilled as a sorted run (a
Snappy file in a temporary directory of its own), and :meth:`close`
merges the runs into the sink through the streaming merge
(``merge.py::merge_files``, each run read on ``device``), hierarchically
where there are more runs than the fan-in.  No spill is left after
:meth:`close`, :meth:`abort` or an error: the temporary directory goes
whole.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence

from ..io.reader import resolve_device
from ..io.writer import ColumnData, ParquetWriter, WriterOptions
from ..schema.schema import Schema
from .buffer import SortingColumn, TableBuffer
from .merge import merge_files


def _unlink_all(paths: Iterable[str]) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def _spill_options(**kw) -> WriterOptions:
    """A run's options: Snappy, no page index, 64 KiB pages (the merge
    holds a pull of pages a run, so small pages bound its window), and
    neither the atomic commit nor the fsyncs: a run lives only until
    :meth:`SortingWriter.close`, and only the output needs durability."""
    return WriterOptions(compression="snappy", write_page_index=False,
                         data_page_size=1 << 16, atomic_commit=False,
                         fsync=False, **kw)


class SortingWriter:
    def __init__(self, sink, schema: Schema, sorting: Sequence[SortingColumn],
                 options: Optional[WriterOptions] = None,
                 buffer_rows: int = 1 << 20, device="cuda"):
        self.sink = sink
        self.schema = schema
        self.sorting = list(sorting)
        self.options = options or WriterOptions()
        self.options.sorting_columns = [
            (s.path, s.descending, s.nulls_first) for s in self.sorting]
        self.buffer_rows = buffer_rows
        self.device = resolve_device(device)
        self._buf = TableBuffer(schema, self.sorting)
        self._spills: List[str] = []
        self._tmpdir = tempfile.mkdtemp(prefix="parquet_tpu_torch_sort_")
        self._closed = False
        # the WriteStats of the writer of the output (runs not counted):
        # None until close
        self.write_stats = None

    def write(self, columns: Dict[str, ColumnData], num_rows: int) -> None:
        self._buf.write(columns, num_rows)
        if self._buf.num_rows >= self.buffer_rows:
            self._spill()

    def write_arrow(self, table) -> None:
        """Buffer the rows of a ``pyarrow.Table``, spilling a full
        buffer as :meth:`write` does."""
        self._buf.write_arrow(table)
        if self._buf.num_rows >= self.buffer_rows:
            self._spill()

    @property
    def spills(self) -> List[str]:
        """The sorted runs spilled so far (paths in the temporary
        directory)."""
        return list(self._spills)

    def _spill(self) -> None:
        if self._buf.num_rows == 0:
            return
        path = os.path.join(self._tmpdir,
                            f"run{len(self._spills):05d}.parquet")
        w = ParquetWriter(path, self.schema, _spill_options())
        try:
            self._buf.flush_to(w)  # sorts, writes one row group
            w.close()
        except BaseException:
            w.abort()
            raise
        self._spills.append(path)

    def close(self) -> None:
        if self._closed:
            return
        try:
            if not self._spills:  # everything fit: sort and write
                w = ParquetWriter(self.sink, self.schema, self.options)
                try:
                    if self._buf.num_rows:
                        self._buf.flush_to(w)
                    w.close()
                except BaseException:
                    w.abort()
                    raise
                self.write_stats = w.write_stats
            else:
                self._spill()
                self._merge_spills()
        finally:
            self._discard()

    def abort(self) -> None:
        """Drop the buffered rows and every spill; the sink is not
        written.  Idempotent."""
        self._buf = TableBuffer(self.schema, self.sorting)
        self._discard()

    def _discard(self) -> None:
        # every spill and every merge generation lives in the directory
        shutil.rmtree(self._tmpdir, ignore_errors=True)
        self._spills = []
        self._closed = True

    def _merge_spills(self) -> None:
        """The streaming merge of the runs, whose window is O(k batch)
        rows: a run's batch is ``buffer_rows / k``, and past ``max_fanin``
        runs (64 at most, one descriptor a run) groups of runs merge into
        intermediate runs first, so that every pass keeps k batch <=
        buffer_rows."""
        spill_opts = _spill_options(row_group_size=self.buffer_rows)
        max_fanin = max(2, min(64, self.buffer_rows // 1024))
        runs = list(self._spills)
        gen = 0
        while len(runs) > max_fanin:
            nxt: List[str] = []
            for gi in range(0, len(runs), max_fanin):
                group = runs[gi:gi + max_fanin]
                path = os.path.join(self._tmpdir,
                                    f"gen{gen}_{len(nxt):05d}.parquet")
                merge_files(group, self.sorting, path, spill_opts,
                            batch_rows=max(1024,
                                           self.buffer_rows // len(group)),
                            device=self.device)
                nxt.append(path)
            _unlink_all(runs)  # consumed: the disk holds one generation
            runs = nxt
            gen += 1
        batch = max(1024, self.buffer_rows // max(1, len(runs)))
        # the output writer buffers a row group: at most buffer_rows
        out_opts = self.options
        if out_opts.row_group_size > self.buffer_rows:
            out_opts = dataclasses.replace(out_opts,
                                           row_group_size=self.buffer_rows)
        w = merge_files(runs, self.sorting, self.sink, out_opts,
                        batch_rows=batch, device=self.device)
        self.write_stats = w.write_stats

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.close()
