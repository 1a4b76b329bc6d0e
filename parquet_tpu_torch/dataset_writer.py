"""Writable tables: ingest into part files, commit by manifest, compact.

The port of ``parquet_tpu/dataset_writer.py``.  A table is a directory of
part files and one manifest (``io/manifest.py``) that names the parts of
the current snapshot.

- :class:`DatasetWriter` buffers rows and writes them into part files (by
  row count, or by a hash of a key column), each under a unique name
  through an :class:`~parquet_tpu_torch.io.sink.AtomicFileSink`, sorted by
  the table's sorting columns when it has them
  (:class:`~parquet_tpu_torch.algebra.sorting.SortingWriter`: the footer
  declares the order and the page index an ascending ``boundary_order``).
  :meth:`DatasetWriter.commit` replaces the manifest atomically, the one
  commit point: a crash at any byte leaves the old snapshot or the new
  one, and :func:`recover_table` sweeps what a dead writer left.  Ingest
  encodes on the host, as the JAX package's does.
- :func:`open_table` pins a snapshot: the manifest is read once and every
  part opened at once, so a compaction's later unlinks cannot take bytes
  from a reader.  The dataset carries the manifest's zone maps, so a
  prune, plan or scan drops a part without opening it, and its reads,
  scans, lookups and aggregates run on the card.
- :func:`compact_table` folds parts into one through
  :func:`~parquet_tpu_torch.algebra.merge.merge_files`, which reads each
  run on ``device`` (the card unless the caller names the CPU), and
  commits through the same path; a rival commit that removed an input
  aborts it.  :class:`BackgroundCompactor` runs it on a thread.

The JAX package's ``table.*`` meters, its ``table.pending`` ledger
account with the memory-pressure check, and its op scopes belong to the
port's ``obs/`` slice.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from .algebra.buffer import SortingColumn, TableBuffer, permute_column
from .dataset import Dataset
from .format.enums import Type
from .io.manifest import (Manifest, collect_entry, commit_manifest,
                          manifest_path, part_file_name, read_manifest,
                          register_sweep_exempt, sweep_orphans)
from .io.sink import AtomicFileSink
from .io.writer import ColumnData, ParquetWriter, WriterOptions
from .obs import scope as _oscope
from .obs.ledger import ledger_account, maybe_check_pressure
from .obs.metrics import counter as _counter
from .obs.metrics import histogram as _histogram
from .schema.schema import Schema

_M_COMMITS = _counter("table.commits")
_M_FILES_WRITTEN = _counter("table.files_written")
_M_ROWS_INGESTED = _counter("table.rows_ingested")
_M_BYTES_INGESTED = _counter("table.bytes_ingested")
_M_COMPACTIONS = _counter("table.compactions")
_M_FILES_COMPACTED = _counter("table.files_compacted")
_M_CONFLICTS = _counter("table.commit_conflicts")
_M_COMPACT_ERRORS = _counter("table.compaction_errors")
_M_COMMIT_S = _histogram("table.commit_s")
# the ledger's account of the rows buffered in every DatasetWriter and
# not yet flushed into a part
_ACC_PENDING = ledger_account("table.pending")

__all__ = ["DatasetWriter", "open_table", "compact_table",
           "BackgroundCompactor", "recover_table", "table_debug"]

# the open writers, held weakly so that a dropped writer never pins itself
_LIVE_WRITERS: "weakref.WeakSet[DatasetWriter]" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()

# the merged parts of running compactions, by absolute table directory:
# until its commit a merged part looks like an orphan on disk
_COMPACTING: Dict[str, set] = {}
_COMPACTING_LOCK = threading.Lock()


def _uncommitted_parts(table_dir_abs: str) -> set:
    """The parts an orphan sweep must leave alone: the live writers'
    flushed but uncommitted parts, and the running compactions' merged
    parts.  A writer that died drops out of the weak set with its last
    reference, so its leavings are swept."""
    names: set = set()
    with _LIVE_LOCK:
        writers = [w for w in _LIVE_WRITERS if not w._closed]
    for w in writers:
        if os.path.abspath(w.table_dir) == table_dir_abs:
            names.update(list(w._flushed))
    with _COMPACTING_LOCK:
        names.update(_COMPACTING.get(table_dir_abs, ()))
    return names


register_sweep_exempt(_uncommitted_parts)


def _nbytes(a) -> int:
    if isinstance(a, (list, tuple)):  # one array a repeated level
        return sum(_nbytes(x) for x in a if x is not None)
    nb = getattr(a, "nbytes", None)
    return int(nb) if nb is not None else len(a)


def _cd_nbytes(cd: ColumnData) -> int:
    return sum(_nbytes(a) for a in (cd.values, cd.offsets, cd.validity,
                                    cd.list_offsets, cd.list_validity,
                                    cd.def_levels, cd.rep_levels)
               if a is not None)


def _cols_nbytes(cols: Dict[str, ColumnData]) -> int:
    return sum(_cd_nbytes(cd) for cd in cols.values())


def _partition_ids(leaf, cd: ColumnData, n: int, k: int) -> np.ndarray:
    """Each row's partition from a hash of its key: the splitmix64
    finalizer over the int64 key in numpy ``uint64`` (a key goes to the
    same partition as in the JAX package), a null key to partition 0."""
    if cd.def_levels is not None or cd.rep_levels is not None \
            or cd.list_offsets is not None:
        raise ValueError("partition_on must be a flat column")
    if leaf.physical_type not in (Type.INT32, Type.INT64):
        raise ValueError(
            f"partition_on supports INT32/INT64 key columns, not "
            f"{leaf.physical_type.name} ({leaf.dotted_path!r})")
    vals = np.asarray(cd.values).astype(np.int64).view(np.uint64)
    valid = None if cd.validity is None else np.asarray(cd.validity, bool)
    if valid is not None:
        aligned = np.zeros(n, np.uint64)
        aligned[valid] = vals
    else:
        aligned = vals
    x = aligned.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    ids = (x % np.uint64(k)).astype(np.int64)
    if valid is not None:
        ids[~valid] = 0
    return ids


class DatasetWriter:
    """Ingest into a table directory, one writer on one thread.

    Rows buffer as :class:`~parquet_tpu_torch.io.writer.ColumnData` a
    leaf; every ``rows_per_file`` buffered rows flush as one part file
    (``part-<rand>.parquet``, through an atomic sink), sorted by
    ``sorting`` where given.  With ``partition_on`` (an INT32/INT64 column)
    rows go to ``num_partitions`` buffers by a hash of the key, so equal
    keys share a part.  Nothing is visible until :meth:`commit` replaces
    the manifest (version + 1, zone maps from the parts' footers);
    :meth:`abort` drops the buffers and removes the uncommitted parts.
    Writers of one table commit one after another and add up.
    ``_sink_wrap`` wraps every sink the writer opens, the manifest's too
    (``io/faults.py::SharedCrashState.wrap``)."""

    def __init__(self, table_dir, schema: Schema,
                 sorting: Optional[Sequence[SortingColumn]] = None,
                 options: Optional[WriterOptions] = None,
                 rows_per_file: int = 1 << 20,
                 partition_on: Optional[str] = None,
                 num_partitions: int = 8, _sink_wrap=None):
        if rows_per_file < 1:
            raise ValueError("rows_per_file must be >= 1")
        self.table_dir = os.fspath(table_dir)
        os.makedirs(self.table_dir, exist_ok=True)
        self.schema = schema
        self.sorting = list(sorting or [])
        self.options = options or WriterOptions()
        self.rows_per_file = rows_per_file
        self.partition_on = partition_on
        self.num_partitions = max(1, int(num_partitions))
        self._part_leaf = (schema.leaf(partition_on)
                           if partition_on is not None else None)
        self._sink_wrap = _sink_wrap
        self._buffers: Dict[int, TableBuffer] = {}
        self._pending_bytes: Dict[int, int] = {}
        self._pending_rows: Dict[int, int] = {}
        self._flushed: List[str] = []  # on disk, in no manifest yet
        self.version: Optional[int] = None  # the last committed snapshot
        self.commits = 0
        self._closed = False
        with _LIVE_LOCK:
            _LIVE_WRITERS.add(self)

    # ------------------------------------------------------------- ingest
    def write(self, columns: Dict[str, ColumnData], num_rows: int) -> None:
        """Buffer ``num_rows`` rows (one ColumnData a leaf); full part
        files flush as their buffers reach ``rows_per_file``."""
        if self._closed:
            raise ValueError("write on a closed DatasetWriter")
        if self._part_leaf is None:
            self._append(0, columns, num_rows)
        else:
            ids = _partition_ids(self._part_leaf,
                                 columns[self._part_leaf.dotted_path],
                                 num_rows, self.num_partitions)
            for pid in np.unique(ids):
                idx = np.flatnonzero(ids == pid)
                sel = {leaf.dotted_path: permute_column(
                    columns[leaf.dotted_path], idx, leaf)
                    for leaf in self.schema.leaves}
                self._append(int(pid), sel, len(idx))
        for pid in [p for p, b in self._buffers.items()
                    if b.num_rows >= self.rows_per_file]:
            self._flush_buffer(pid)

    def write_arrow(self, table) -> None:
        """Buffer the rows of a ``pyarrow.Table`` as :meth:`write` does."""
        from .io.writer import columns_from_arrow

        self.write(columns_from_arrow(table, self.schema), table.num_rows)

    def _append(self, pid: int, cols: Dict[str, ColumnData],
                n: int) -> None:
        if n == 0:
            return
        buf = self._buffers.get(pid)
        if buf is None:
            buf = self._buffers[pid] = TableBuffer(self.schema, self.sorting)
            self._pending_bytes[pid] = 0
            self._pending_rows[pid] = 0
        nb = _cols_nbytes(cols)
        buf.write(cols, n)
        self._pending_bytes[pid] += nb
        self._pending_rows[pid] += n
        _ACC_PENDING.add(nb)
        # a growth site: buffered rows can cross a watermark
        maybe_check_pressure()

    # -------------------------------------------------------------- flush
    def pending_rows(self) -> int:
        return sum(self._pending_rows.values())

    def pending_bytes(self) -> int:
        return sum(self._pending_bytes.values())

    def flush(self) -> None:
        """Write every buffer into part files (invisible until
        :meth:`commit`)."""
        for pid in list(self._buffers):
            self._flush_buffer(pid)

    def _flush_buffer(self, pid: int) -> None:
        buf = self._buffers.pop(pid)
        # the rows leave the pending count (and the ledger) whether or
        # not the write succeeds: a crashed flush's rows are lost to the
        # table
        _ACC_PENDING.sub(self._pending_bytes.pop(pid, 0))
        self._pending_rows.pop(pid, None)
        if buf.num_rows == 0:
            return
        name = part_file_name(secrets.token_hex(8))
        sink = AtomicFileSink(os.path.join(self.table_dir, name))
        if self._sink_wrap is not None:
            sink = self._sink_wrap(sink)
        rows = buf.num_rows
        try:
            if self.sorting:
                from .algebra.sorting import SortingWriter

                # buffer_rows covers the part: the rows sort in memory and
                # no run is spilled or read back, so no device is needed
                sw = SortingWriter(sink, self.schema, self.sorting,
                                   self.options, buffer_rows=max(rows, 1),
                                   device="cpu")
                sw.write(buf.columns, rows)
                sw.close()
            else:
                w = ParquetWriter(sink, self.schema, self.options)
                try:
                    w.write(buf.columns, rows)
                    w.close()
                except BaseException:
                    w.abort()
                    raise
            sink.close()  # the part's fsync and rename
        except BaseException:
            sink.abort()  # a crashed sink leaves its temp to recovery
            raise
        self._flushed.append(name)

    # ------------------------------------------------------------- commit
    def commit(self) -> Optional[Manifest]:
        """Flush, then publish every part written since the last commit:
        the new manifest (the live parts, then the new ones with their
        zone maps) replaces the live one in one rename.  Returns it, or
        the live manifest where there was nothing to commit."""
        if self._closed:
            raise ValueError("commit on a closed DatasetWriter")
        t0 = time.perf_counter()
        with _oscope.maybe_op_scope("table.commit", dir=self.table_dir):
            try:
                return self._commit_impl()
            finally:
                _M_COMMIT_S.observe(time.perf_counter() - t0)

    def _commit_impl(self) -> Optional[Manifest]:
        self.flush()
        if not self._flushed:
            live = read_manifest(self.table_dir)
            if live is not None:
                self.version = live.version
            return live
        entries = [collect_entry(self.table_dir, name)
                   for name in self._flushed]
        spec = [(s.path, s.descending, s.nulls_first) for s in self.sorting]

        def mutate(live: Manifest) -> Manifest:
            return Manifest(files=list(live.files) + entries,
                            sorting=spec or list(live.sorting))

        new = commit_manifest(self.table_dir, mutate,
                              sink_wrap=self._sink_wrap)
        _oscope.account(_M_COMMITS)
        _oscope.account(_M_FILES_WRITTEN, len(entries))
        _oscope.account(_M_ROWS_INGESTED, sum(e.num_rows for e in entries))
        _oscope.account(_M_BYTES_INGESTED,
                        sum(e.file_size for e in entries))
        self._flushed = []
        self.commits += 1
        self.version = new.version
        return new

    # ------------------------------------------------------------ cleanup
    def abort(self) -> None:
        """Drop the buffered rows and remove the uncommitted parts."""
        self._buffers.clear()
        _ACC_PENDING.sub(sum(self._pending_bytes.values()))
        self._pending_bytes.clear()
        self._pending_rows.clear()
        for name in self._flushed:
            try:
                os.unlink(os.path.join(self.table_dir, name))
            except OSError:
                pass
        self._flushed = []
        self._closed = True

    def close(self) -> None:
        """Commit what is pending, then close."""
        if self._closed:
            return
        try:
            self.commit()
        finally:
            self._closed = True

    def __enter__(self) -> "DatasetWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    def __repr__(self) -> str:
        return (f"DatasetWriter({self.table_dir!r}, "
                f"{self.pending_rows()} pending row(s), "
                f"{len(self._flushed)} uncommitted part(s))")


# ---------------------------------------------------------------------------
# snapshot-pinned reads
# ---------------------------------------------------------------------------

def open_table(table_dir, options=None, policy=None,
               pin: bool = True) -> Dataset:
    """The table's current snapshot as a
    :class:`~parquet_tpu_torch.dataset.Dataset`.  The manifest is read
    once; with ``pin`` every part opens now, so the dataset reads that
    snapshot's bytes even after a compaction unlinks its parts.  The
    dataset carries the manifest's zone maps (``_file_stats``) and its
    version (``snapshot_version``).  A part unlinked between the manifest
    read and the open (a compaction committed in between) sends it back
    to the new manifest."""
    table_dir = os.fspath(table_dir)
    last_err = None
    for _ in range(8):
        live = read_manifest(table_dir)
        if live is None:
            raise FileNotFoundError(
                f"no table manifest at {manifest_path(table_dir)!r} "
                "(never committed, or not a table directory)")
        paths = [os.path.join(table_dir, n) for n in live.names()]
        ds = Dataset._from_paths(paths, options, policy)
        ds._file_stats = dict(zip(paths, live.files))
        ds.snapshot_version = live.version
        if not (pin and paths):
            return ds
        try:
            ds.files  # open every part: its bytes stay this snapshot's
            return ds
        except FileNotFoundError as e:
            last_err = e
            ds.close()
    raise last_err


def recover_table(table_dir) -> List[str]:
    """Crash recovery: remove the ``*.tmp`` files and the parts the live
    manifest does not name (``io/manifest.py::sweep_orphans``); committed
    data is never touched.  Returns the removed names."""
    return sweep_orphans(table_dir)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def compact_table(table_dir, max_files: Optional[int] = None,
                  options: Optional[WriterOptions] = None,
                  batch_rows: int = 1 << 16, device="cuda",
                  _sink_wrap=None) -> Optional[Manifest]:
    """Replace parts with one merged part through the commit path of
    ingest.  The inputs merge through ``merge_files`` (by the table's
    sorting spec; one after another for a table without one), each read
    on ``device``, into a new part; the commit checks that every input is
    still live, and a rival commit that removed one aborts this compaction
    (the merged part removed, the manifest untouched).  Parts an ingest
    committed meanwhile stay.  ``max_files`` caps the parts one pass folds,
    the smallest first, merged in snapshot order.  Returns the committed
    manifest, or None where there was nothing to do or a conflict."""
    from .io.reader import resolve_device

    dev = resolve_device(device)
    table_dir = os.fspath(table_dir)
    live = read_manifest(table_dir)
    if live is None or len(live.files) < 2:
        return None
    victims = list(live.files)
    if max_files is not None and len(victims) > max_files:
        victims = sorted(victims, key=lambda e: e.file_size)[:max_files]
        if len(victims) < 2:
            return None
        # snapshot order: rows with equal keys keep their ingest order
        order = {e.name: i for i, e in enumerate(live.files)}
        victims.sort(key=lambda e: order[e.name])
    sorting = [SortingColumn(p, d, nf) for p, d, nf in live.sorting]
    name = part_file_name(secrets.token_hex(8))
    dir_abs = os.path.abspath(table_dir)
    with _COMPACTING_LOCK:  # shield the merged part from a sweep
        _COMPACTING.setdefault(dir_abs, set()).add(name)
    try:
        return _compact_run(table_dir, victims, sorting, name, options,
                            batch_rows, dev, _sink_wrap)
    finally:
        with _COMPACTING_LOCK:
            got = _COMPACTING.get(dir_abs)
            if got is not None:
                got.discard(name)
                if not got:
                    del _COMPACTING[dir_abs]


def _compact_run(table_dir, victims, sorting, name, options, batch_rows,
                 device, _sink_wrap) -> Optional[Manifest]:
    # a compaction is an op of its own (unless the caller's is active)
    with _oscope.maybe_op_scope("table.compact", dir=table_dir,
                                inputs=len(victims)):
        return _compact_run_impl(table_dir, victims, sorting, name,
                                 options, batch_rows, device, _sink_wrap)


def _compact_run_impl(table_dir, victims, sorting, name, options,
                      batch_rows, device, _sink_wrap) -> Optional[Manifest]:
    from .algebra.merge import merge_files
    from .io.cache import invalidate_path

    merged_path = os.path.join(table_dir, name)
    victim_names = {e.name for e in victims}
    sink = AtomicFileSink(merged_path)
    if _sink_wrap is not None:
        sink = _sink_wrap(sink)
    try:
        merge_files([os.path.join(table_dir, e.name) for e in victims],
                    sorting, sink, options, batch_rows=batch_rows,
                    device=device)
        sink.close()  # the merged part's fsync and rename
    except BaseException:
        sink.abort()
        raise
    entry = collect_entry(table_dir, name)

    def mutate(cur: Manifest) -> Optional[Manifest]:
        if not victim_names <= set(cur.names()):
            return None  # an input is gone: a rival commit won
        return Manifest(files=[entry] + [e for e in cur.files
                                         if e.name not in victim_names],
                        sorting=list(cur.sorting))

    new = commit_manifest(table_dir, mutate, sink_wrap=_sink_wrap)
    if new is None:
        _oscope.account(_M_CONFLICTS)
        try:
            os.unlink(merged_path)
        except OSError:
            pass
        return None
    # the replaced parts: open readers keep their maps and descriptors,
    # and no cache may serve them again
    for e in victims:
        p = os.path.join(table_dir, e.name)
        invalidate_path(p)
        try:
            os.unlink(p)
        except OSError:
            pass
    _oscope.account(_M_COMPACTIONS)
    _oscope.account(_M_FILES_COMPACTED, len(victims))
    return new


class BackgroundCompactor:
    """A thread that compacts the table whenever its live part count
    reaches ``min_files``, every ``interval_s``.  A failed pass (counted
    in ``table.compaction_errors``, its error kept in ``last_error``)
    leaves the table at a valid snapshot, and the next tick tries again.
    ``close()`` stops and joins the thread."""

    def __init__(self, table_dir, interval_s: float = 1.0,
                 min_files: int = 4, max_files: Optional[int] = None,
                 options: Optional[WriterOptions] = None, device="cuda"):
        from .io.reader import resolve_device

        self.table_dir = os.fspath(table_dir)
        self.interval_s = interval_s
        self.min_files = max(2, int(min_files))
        self.max_files = max_files
        self.options = options
        self.device = resolve_device(device)
        self.passes = 0
        self.last_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="pqt-table-compactor",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                live = read_manifest(self.table_dir)
                if live is not None and len(live.files) >= self.min_files:
                    if compact_table(self.table_dir,
                                     max_files=self.max_files,
                                     options=self.options,
                                     device=self.device) is not None:
                        self.passes += 1
            except Exception as e:
                # one failed pass must not stop the compactor
                _oscope.account(_M_COMPACT_ERRORS)
                self.last_error = e

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def __enter__(self) -> "BackgroundCompactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def table_debug() -> dict:
    """Every open :class:`DatasetWriter`: its directory, pending rows and
    bytes, uncommitted parts, commits and last committed version."""
    with _LIVE_LOCK:
        writers = [w for w in _LIVE_WRITERS if not w._closed]
    return {"writers": [
        {"dir": w.table_dir,
         "pending_rows": w.pending_rows(),
         "pending_bytes": w.pending_bytes(),
         "uncommitted_parts": len(w._flushed),
         "commits": w.commits,
         "version": w.version}
        for w in writers]}
