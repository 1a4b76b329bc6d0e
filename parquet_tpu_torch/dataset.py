"""Many Parquet files as one readable, prunable, shardable unit.

The port's cut of ``parquet_tpu/dataset.py``: :func:`expand_paths` and
:class:`Dataset` with its file handles, row accounting, sharding, schema
check, footer pruning and scan plans, and :meth:`Dataset.read`, which
reads every file on a list of devices through
``parallel/mesh.py::read_dataset_device`` and concatenates the per-file
columns in file order, and :meth:`Dataset.scan`, the host scan of every
file that survives the footer prune (``parallel/host_scan.py::
scan_files``), :meth:`Dataset.find_rows`, the batched point lookup
over every file (``io/lookup.py::dataset_find_rows``),
:meth:`Dataset.iter_batches`, the streamed read of file after file
(``io/stream.py``), and :meth:`Dataset.aggregate`, the aggregation
cascade over every file (``io/aggregate.py``).  Each takes
``policy``/``report`` (``io/faults.py``) as the JAX package's: a call's
policy overrides the dataset's, every file reads under it, and under
``on_corrupt='skip_row_group'`` a file that cannot be opened or read
drops as a unit into ``report.files_skipped``.  Every file opens with
the dataset's ``options`` (``io/reader.py::ReadOptions``).  A dataset
that ``dataset_writer.py::open_table`` opened carries its table's
manifest: ``snapshot_version`` names the pinned snapshot, and
``_file_stats`` maps each path to its manifest entry, whose zone maps
drop a part from a prune, plan or scan without opening it
(``io/manifest.py::manifest_may_match``) and answer a covered part of an
aggregate.  Remote URLs and the shared chunk cache belong to later
slices.
"""

from __future__ import annotations

import glob as _glob
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .errors import CorruptedError, DeadlineError
from .io.column import Column, concat_columns
from .io.reader import ParquetFile, _empty_column, _select_leaves
from .io.search import _as_expr, prune_file
from .obs import scope as _oscope
from .obs.metrics import histogram as _ohistogram
from .utils.pool import map_in_order

_M_READ_S = _ohistogram("dataset.read_s")
_M_SCAN_S = _ohistogram("dataset.scan_s")

__all__ = ["Dataset", "expand_paths"]

_GLOB_CHARS = frozenset("*?[")


def expand_paths(paths_or_glob) -> List[str]:
    """Paths and glob patterns as one path list: a pattern expands sorted
    (``**`` recurses), explicit paths keep the caller's order, a repeated
    path keeps its first place, and a path that exists is never read as a
    pattern (``part[1].parquet``).  A URL is taken literally, except that
    an ``http(s)://`` or ``s3://`` prefix ending in ``/`` expands, sorted,
    through its listing (``io/remote.py::list_prefix``,
    ``list_prefix_s3``).  A pattern or prefix that matches nothing raises
    ``FileNotFoundError``."""
    if isinstance(paths_or_glob, (str, os.PathLike)):
        items = [os.fspath(paths_or_glob)]
    else:
        items = [os.fspath(p) for p in paths_or_glob]
    out: List[str] = []
    seen = set()
    for item in items:
        if "://" in item:
            if (item.startswith(("http://", "https://", "s3://"))
                    and item.endswith("/")):
                from .io.remote import list_prefix, list_prefix_s3

                got = (list_prefix_s3 if item.startswith("s3://")
                       else list_prefix)(item)
            else:
                got = [item]
        elif _GLOB_CHARS & set(item) and not os.path.lexists(item):
            got = sorted(_glob.glob(item, recursive="**" in item))
            if not got:
                raise FileNotFoundError(f"glob {item!r} matched no files")
        else:
            got = [item]
        for p in got:
            if p not in seen:
                seen.add(p)
                out.append(p)
    return out


def _leaf_signature(pf: ParquetFile) -> tuple:
    """Each leaf's path, physical type, width, logical annotation with its
    parameters, and levels: files that differ in any of these cannot be
    read as one (an INT64 decimal of scale 2 beside one of scale 3 would
    mis-scale every value of one file)."""
    return tuple((leaf.name, int(leaf.physical_type), leaf.type_length,
                  leaf.logical_kind,
                  tuple(sorted((leaf.logical_params or {}).items())),
                  leaf.max_definition_level, leaf.max_repetition_level)
                 for leaf in pf.schema.leaves)


class Dataset:
    """Parquet files read as one.

    ``paths_or_glob`` is a path, a glob pattern, or a list of both
    (:func:`expand_paths`).  Files open at first use and stay open until
    :meth:`close`; every file must have the first one's leaves
    (:func:`_leaf_signature`), checked as each is read or pruned.
    ``options`` (:class:`~parquet_tpu_torch.io.reader.ReadOptions`) open
    every file; ``policy`` applies to every file (a call's ``policy=``
    overrides it)."""

    def __init__(self, paths_or_glob, options=None, policy=None):
        self.paths = expand_paths(paths_or_glob)
        if not self.paths:
            raise ValueError("Dataset needs at least one path")
        self.options = options
        self.policy = policy
        self._init()

    def _init(self) -> None:
        self._files: Dict[int, ParquetFile] = {}
        self._lock = threading.Lock()
        self._schema_sig = None
        # a table's dataset (dataset_writer.open_table): each path's
        # manifest entry, for pruning without opening, and the pinned
        # snapshot's version; None for a dataset of paths
        self._file_stats = None
        self.snapshot_version = None

    @classmethod
    def _from_paths(cls, paths: List[str], options, policy) -> "Dataset":
        """A dataset of exactly ``paths`` (no glob expansion; may be
        empty)."""
        obj = object.__new__(cls)
        obj.paths = list(paths)
        obj.options = options
        obj.policy = policy
        obj._init()
        return obj

    # ------------------------------------------------------------- files
    def file(self, i: int) -> ParquetFile:
        """The i-th file, opened at first use and kept."""
        with self._lock:
            pf = self._files.get(i)
        if pf is not None:
            return pf
        pf = ParquetFile(self.paths[i], options=self.options,
                         policy=self.policy)
        with self._lock:
            cur = self._files.setdefault(i, pf)
        if cur is not pf:  # another thread opened it first
            pf.close()
        return cur

    @property
    def files(self) -> List[ParquetFile]:
        """Every file, the ones not yet open opened on the shared pool."""
        with self._lock:
            cached = [self._files.get(i) for i in range(len(self.paths))]
        if all(pf is not None for pf in cached):
            return cached
        return map_in_order(self.file, range(len(self.paths)))

    @property
    def num_files(self) -> int:
        return len(self.paths)

    @property
    def num_rows(self) -> int:
        return int(sum(pf.num_rows for pf in self.files))

    @property
    def schema(self):
        if not self.paths:
            raise ValueError("empty dataset shard has no schema; check "
                             "num_files first")
        return self.file(0).schema

    def row_offsets(self) -> np.ndarray:
        """``offsets[i]``: the dataset-wide ordinal of file i's first row
        (``offsets[num_files]``: the row count); :meth:`read` is in file
        order."""
        offs = np.zeros(len(self.paths) + 1, np.int64)
        np.cumsum([pf.num_rows for pf in self.files], out=offs[1:])
        return offs

    def shard(self, index: int, count: int) -> "Dataset":
        """File shard ``index`` of ``count``: ``paths[index::count]``, so
        shards are disjoint, cover the dataset and differ by at most one
        file; a shard may be empty."""
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} out of range [0, {count})")
        sub = Dataset._from_paths(self.paths[index::count], self.options,
                                  self.policy)
        # a shard of a table keeps its zone maps and its snapshot
        sub._file_stats = self._file_stats
        sub.snapshot_version = self.snapshot_version
        return sub

    def _resolve(self, policy, report):
        """The call's policy (else the dataset's), its report (a fresh one
        under a policy), and whether files drop whole."""
        from .io.faults import ReadReport

        pol = policy if policy is not None else self.policy
        if report is None and pol is not None:
            report = ReadReport()
        return pol, report, pol is not None and pol.skip_corrupt

    def _check_schema(self, pf: ParquetFile, path: str) -> None:
        sig = _leaf_signature(pf)
        with self._lock:
            if self._schema_sig is None:
                self._schema_sig = (path, sig)
                return
            ref_path, ref_sig = self._schema_sig
        if sig != ref_sig:
            raise ValueError(
                f"dataset schema mismatch: {path!r} does not match "
                f"{ref_path!r} (leaf paths/types differ)")

    # -------------------------------------------------------------- read
    def read(self, columns: Optional[Sequence[str]] = None, device="cuda",
             policy=None, report=None) -> Dict[str, Column]:
        """Every file's selected columns (all by default) as one
        ``{dotted path: Column}``, the files in order.  ``device`` is one
        device or a list of them (a mesh: ``"cuda"`` is every card, and an
        entry may repeat): file ``i`` decodes on ``mesh[i % len(mesh)]``
        (``parallel/mesh.py::read_dataset_device``), and the result lies on
        ``mesh[0]``.  A file the device route refuses reads on the host
        decode.  Under a ``policy`` (or with a ``report``) a file whose
        staging or decode fails reads again through
        ``ParquetFile.read(policy=...)`` on its device, where corrupt row
        groups drop; under ``skip_row_group`` a file that cannot be opened
        or read at all drops whole (``report.files_skipped``, its rows,
        where its footer parsed, in ``rows_dropped``).  The result's
        ``report`` is the call's."""
        t0 = time.perf_counter()
        # the whole fan-out, the files' reads on pool workers included, is
        # one op (unless the caller's is active)
        with _oscope.maybe_op_scope("dataset.read", files=len(self.paths)):
            try:
                return self._read_impl(columns, device, policy, report)
            finally:
                _M_READ_S.observe(time.perf_counter() - t0)

    def _read_impl(self, columns, device, policy,
                   report) -> Dict[str, Column]:
        from .io.faults import NON_DATA_ERRORS, ReadReport
        from .io.reader import ColumnSet
        from .parallel.mesh import read_dataset_device, resolve_mesh

        if not self.paths:
            raise ValueError("read on an empty dataset shard (no schema to "
                             "type an empty table by); check num_files first")
        pol, report, skip = self._resolve(policy, report)
        devs = resolve_mesh(device)
        with_reports = report is not None

        def read_one(i, dev):
            """File ``i`` under the policy: ``(parts, report, rows,
            error)``, a dropped file's parts None."""
            sub = ReadReport() if with_reports else None
            rows = 0
            try:
                pf = self.file(i)
                self._check_schema(pf, self.paths[i])
                rows = pf.num_rows
                got = pf.read(columns=columns, device=dev, policy=pol,
                              report=sub)
                return ({p: [c] for p, c in got.items()}, sub, rows, None)
            except DeadlineError:
                raise
            except NON_DATA_ERRORS:
                raise
            except (CorruptedError, OSError) as e:
                if not skip:
                    raise
                return None, sub, rows, e

        def host_read(i, dev):
            if with_reports:
                return read_one(i, dev)
            return self._host_read(i, columns, dev)

        parts: Dict[str, List[Column]] = {}
        first = None  # the first file read: its schema types the result
        spans = []  # the rows read, for ColumnSet.to_arrow
        for i, got in enumerate(read_dataset_device(
                self, columns, host_read, devs, with_reports=with_reports,
                policy=pol)):
            skipped = ()
            if with_reports:
                got, sub, rows, err = got
                if got is None:
                    if sub is not None:
                        report.retries += sub.retries  # they happened
                    report.record_file_skip(self.paths[i], rows=rows,
                                            error=err)
                    continue
                report.merge(sub)
                skipped = sub.row_groups_skipped if sub is not None else ()
            if first is None:
                first = i
            pf = self.file(i)
            spans += [(pf, g, 0, rg.num_rows)
                      for g, rg in enumerate(pf.row_groups)
                      if g not in skipped]
            for path, cols in got.items():
                parts.setdefault(path, []).extend(cols)
        if first is None:
            raise CorruptedError(
                "dataset read: every file failed "
                f"({', '.join(report.files_skipped) if report else ''})")
        out = ColumnSet(schema=self.file(first).schema,
                        num_rows=sum(s[3] for s in spans), spans=spans,
                        device=devs[0])
        for leaf in _select_leaves(out.schema, columns):
            cols = [c.to(devs[0]) for c in parts.get(leaf.name, [])]
            out[leaf.name] = (concat_columns(cols) if cols
                              else _empty_column(leaf, devs[0]))
        out.report = report
        return out

    def _host_read(self, i: int, columns, device) -> Dict[str, List[Column]]:
        """File ``i`` decoded chunk by chunk on the host, moved to
        ``device``: the read of a file the device route refuses."""
        from .io.reader import decode_chunk_host

        pf = self.file(i)
        self._check_schema(pf, self.paths[i])
        return {leaf.name: [decode_chunk_host(rg.column(leaf.column_index),
                                              device)
                            for rg in pf.row_groups]
                for leaf in _select_leaves(pf.schema, columns)}

    # ------------------------------------------------------------- prune
    def _prepare_where(self, path, lo, hi, values, where, skip=False):
        """One predicate tree, prepared once against the schema of the
        first file that opens (every file must share it); with ``skip`` a
        file that does not open is passed over here and recorded by the
        per-file loops."""
        from .algebra.expr import prepare
        from .io.faults import NON_DATA_ERRORS

        expr = _as_expr(path, lo, hi, values, where)
        for i in range(len(self.paths)):
            try:
                pf = self.file(i)
            except DeadlineError:
                raise
            except NON_DATA_ERRORS:
                raise
            except (CorruptedError, OSError):
                if not skip:
                    raise
                continue
            return prepare(expr, pf.schema)
        return expr  # nothing opened: the per-file loops record each

    # -------------------------------------------------------------- scan
    def scan(self, path: Optional[str] = None, lo=None, hi=None,
             columns: Optional[Sequence[str]] = None, use_bloom: bool = True,
             values: Optional[Sequence] = None, policy=None, report=None,
             where=None, device="cuda") -> Dict[str, object]:
        """The host scan of the whole dataset: the predicate (``path``
        with ``lo``/``hi``/``values``, or a ``where=`` tree) is prepared
        once, files are pruned by their footers' statistics (the schema
        checked), and the survivors scan on the shared pool
        (``parallel/host_scan.py::scan_files``), merged in file order, in
        ``scan_filtered``'s forms.  ``device`` is a mesh (a device, a
        list whose entries may repeat, or ``"cuda"`` for every card): file
        ``i`` of the survivors plans its bloom probe on ``mesh[i %
        len(mesh)]``; the results are the same on any mesh.  Under a
        degraded ``policy`` unopenable files, files that fail mid-scan and
        corrupt row groups all drop, the loss in ``report``."""
        t0 = time.perf_counter()
        with _oscope.maybe_op_scope("dataset.scan", files=len(self.paths)):
            try:
                return self._scan_impl(path, lo, hi, columns, use_bloom,
                                       values, policy, report, where, device)
            finally:
                _M_SCAN_S.observe(time.perf_counter() - t0)

    def _scan_impl(self, path, lo, hi, columns, use_bloom, values, policy,
                   report, where, device) -> Dict[str, object]:
        from .parallel.host_scan import (_output_columns, _typed_empty,
                                         scan_files)
        from .parallel.mesh import resolve_mesh

        if not self.paths:
            raise ValueError("scan on an empty dataset shard (no schema to "
                             "type empty results by); check num_files first")
        pol, report, skip = self._resolve(policy, report)
        devs = resolve_mesh(device)
        raw = _as_expr(path, lo, hi, values, where)
        expr = self._prepare_where(path, lo, hi, values, where, skip)
        fcols = sorted(raw.columns())
        keep, skipped = self._prune_indices(expr, skip, report)
        pfs = [self.file(i) for i in keep]
        if pfs:
            # the default selection is pinned to the first survivor: a
            # predicate that folds to a constant in one file would change
            # the columns that file's scan returns
            got = scan_files(pfs, where=expr,
                             columns=_output_columns(pfs[0], fcols, columns),
                             use_bloom=use_bloom, devices=devs, policy=pol,
                             report=report, skip_files=skip)
            if got:
                return got
        # nothing survived: typed empties, the selection validated as the
        # scan validates it, by the first file that opened
        sig = next((i for i in range(len(self.paths)) if i not in skipped),
                   None)
        if sig is None:
            raise CorruptedError(
                "dataset scan: every file failed "
                f"({', '.join(report.files_skipped) if report else ''})")
        pf0 = self.file(sig)
        return {c: _typed_empty(pf0.schema.leaf(c))
                for c in _output_columns(pf0, fcols, columns)}

    def _prune_indices(self, expr, skip: bool = False, report=None):
        """``(kept, skipped)``: the files whose manifest entries and
        footers may match, and with ``skip`` those that could not be
        opened or checked (each recorded in ``report``, 0 rows).  A part
        that its manifest entry proves dead is dropped without being
        opened."""
        from .io.faults import NON_DATA_ERRORS
        from .io.manifest import manifest_may_match

        stats = self._file_stats

        def check(i):
            try:
                ent = (stats.get(self.paths[i]) if stats is not None
                       else None)
                if ent is not None and not manifest_may_match(ent, expr):
                    return False
                pf = self.file(i)
                self._check_schema(pf, self.paths[i])
                return prune_file(pf, where=expr)
            except DeadlineError:
                raise
            except NON_DATA_ERRORS:
                raise
            except (CorruptedError, OSError) as e:
                if not skip:
                    raise
                return e

        keep, skipped = [], []
        for i, r in enumerate(map_in_order(check, range(len(self.paths)))):
            if r is True:
                keep.append(i)
            elif isinstance(r, Exception):
                skipped.append(i)
                if report is not None:
                    report.record_file_skip(self.paths[i], rows=0, error=r)
        return keep, skipped

    def prune(self, path: Optional[str] = None, lo=None, hi=None,
              values: Optional[Sequence] = None, policy=None, report=None,
              where=None) -> List[str]:
        """The paths of the files that may hold matching rows, by their
        footers' chunk statistics alone (``io/search.py::prune_file``; no
        chunk byte is read).  ``where`` takes a predicate tree over any
        number of columns.  Under a degraded ``policy`` an unopenable file
        is left out and recorded in ``report``."""
        with _oscope.maybe_op_scope("dataset.prune", files=len(self.paths)):
            _, report, skip = self._resolve(policy, report)
            expr = self._prepare_where(path, lo, hi, values, where, skip)
            return [self.paths[i]
                    for i in self._prune_indices(expr, skip, report)[0]]

    def plan(self, path: Optional[str] = None, lo=None, hi=None,
             use_bloom: bool = False, values: Optional[Sequence] = None,
             where=None, device="cuda"):
        """Files pruned by their footers, then the survivors' pages
        planned (``io/planner.py::ScanPlanner``, the bloom stage on
        ``device``): ``{path: [PagePlan, ...]}`` for the single-column
        form, ``{path: ScanPlan}`` for ``where=``; files without a
        surviving row group are left out."""
        from .io.planner import ScanPlanner
        from .io.reader import resolve_device

        dev = resolve_device(device)
        expr = self._prepare_where(path, lo, hi, values, where)
        out = {}
        for i in self._prune_indices(expr)[0]:
            plan = ScanPlanner(self.file(i), device=dev).plan(
                expr, use_bloom=use_bloom)
            if where is None:
                plans = plan.page_plans()
                if plans:
                    out[self.paths[i]] = plans
            elif plan.survivors:
                out[self.paths[i]] = plan
        return out

    # ------------------------------------------------------------ lookup
    def find_rows(self, path: str, keys,
                  columns: Optional[Sequence[str]] = None, policy=None,
                  report=None, device="cuda"):
        """The batched point lookup over the whole dataset: the rows where
        column ``path`` equals each of ``keys``, as dataset-wide row
        ordinals (:meth:`row_offsets` indexing), with the row-aligned
        values of ``columns``.  The keys are prepared once, the files fan
        out on the shared pool, and each runs the cascade of
        ``io/lookup.py::find_rows`` on ``device`` (CUDA unless the caller
        names the CPU).  Under a degraded ``policy`` an unreadable file
        drops as a unit (``report.files_skipped``) and a corrupt row group
        of a readable one drops whole."""
        from .io.lookup import dataset_find_rows

        if not self.paths:
            raise ValueError("find_rows on an empty dataset shard (no "
                             "schema to probe keys against); check "
                             "num_files first")
        return dataset_find_rows(self, path, keys, columns=columns,
                                 device=device, policy=policy, report=report)

    def iter_batches(self, columns: Optional[Sequence[str]] = None,
                     batch_rows: int = 65536,
                     strict_batch_rows: bool = False, device="cuda",
                     policy=None, report=None):
        """Stream the files in order as ``ColumnSet`` batches
        (:meth:`ParquetFile.iter_batches`, each file's drain with its own
        prefetcher): batches never span files.  Under a degraded
        ``policy`` a file that fails to open, or dies mid-drain beyond what
        row-group skipping absorbs, is dropped (batches already yielded
        from it stay valid), and ``report.files_skipped`` counts only its
        rows neither delivered nor already dropped."""
        if batch_rows <= 0:
            raise ValueError("batch_rows must be positive")
        gen = self._iter_batches_gen(columns, batch_rows, strict_batch_rows,
                                     device, policy, report)
        # active around each pull; the files' drains join it
        return _oscope.scoped_iter("dataset.iter_batches", gen,
                                   files=len(self.paths))

    def _iter_batches_gen(self, columns, batch_rows, strict_batch_rows,
                          device, policy, report):
        from .io.faults import NON_DATA_ERRORS, ReadReport

        pol, report, skip = self._resolve(policy, report)
        for i in range(len(self.paths)):
            rows = 0
            sub = ReadReport() if report is not None else None
            try:
                pf = self.file(i)
                self._check_schema(pf, self.paths[i])
                rows = pf.num_rows
                yield from pf.iter_batches(
                    columns=columns, batch_rows=batch_rows,
                    strict_batch_rows=strict_batch_rows, device=device,
                    policy=pol, report=sub)
            except DeadlineError:
                raise
            except NON_DATA_ERRORS:
                raise
            except (CorruptedError, OSError) as e:
                if not skip:
                    raise
                report.merge(sub)
                # the rows the file delivered, and those its row-group
                # skips already counted, are not lost twice
                report.record_file_skip(
                    self.paths[i],
                    rows=max(rows - sub.rows_read - sub.rows_dropped, 0),
                    error=e)
                continue
            if report is not None:
                report.merge(sub)

    def aggregate(self, aggs, where=None, group_by=None, device="cuda",
                  policy=None, report=None):
        """Answer aggregates (``algebra/aggregate.py``'s nodes) over every
        file at the cheapest tier that proves each row group's answer
        (``io/aggregate.py::dataset_aggregate``): the predicate prepares
        once, the files resolve on the shared pool with their dictionary
        and exact tiers on ``device`` (CUDA unless the caller names the
        CPU), and the partial states merge in file order.  Under a
        degraded ``policy`` an unreadable file drops as a unit
        (``report.files_skipped``) and a corrupt row group of a readable
        one drops its contribution whole."""
        from .io.aggregate import dataset_aggregate

        return dataset_aggregate(self, aggs, where=where, group_by=group_by,
                                 device=device, policy=policy, report=report)

    # -------------------------------------------------------------- misc
    def close(self) -> None:
        with self._lock:
            files, self._files = list(self._files.values()), {}
        for pf in files:
            pf.close()

    def __enter__(self) -> "Dataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        if not self.paths:
            return "Dataset(0 files: an empty shard)"
        return f"Dataset({len(self.paths)} file(s), first={self.paths[0]!r})"
