"""The host scan, the device pushdown scan, and the routed scan.

The port's copy of ``parquet_tpu/parallel/host_scan.py``:

- :func:`scan_expr` (and its single-column face :func:`scan_filtered`):
  the host scan of a predicate tree over any number of flat columns.  The
  planner (``io/planner.py``) prunes row groups and pages by statistics,
  page index and bloom filters (the bloom stage on the scan's device);
  phase 1 decodes the filter columns' candidate spans on the host
  (``io/search.py::read_row_range``) and evaluates the exact predicate
  (:func:`expr_mask`); phase 2 late-materializes: each output column
  decodes only the pages under [first survivor, last survivor] of a span,
  and a span without survivors is never read.  Spans fan out on the
  shared pool above :data:`_POOL_MIN_CELLS` cells, each read admitted
  through ``utils/pool.py::read_admission`` under the ``scan`` tier (its
  chunk's uncompressed size prorated to its rows; the tier is off unless
  a budget is set).  :func:`scan_files`
  runs it over many files in file order and :func:`merge_scan_results`
  joins their results;
- :func:`scan_filtered_device` = :func:`stage_scan` + :func:`decoded_scan`:
  each surviving span's pages of the key and output columns are planned
  and staged (``device_reader.build_plan``/``stage_plan``, one staging
  batch and one copy a span); then, on the device, each span decodes
  (``decode_staged``, whose dictionary and delta streams run the read
  path's CUDA kernels), the key predicate becomes a row mask, and every
  output column's surviving rows are compacted to a prefix by one cumsum
  and one scatter, with the survivor counts read back
  :data:`_SYNC_EVERY` spans at a time.  :func:`scan_filtered_sharded`
  stages the spans round-robin over a mesh of devices;
- :func:`scan`: one of the two, chosen by ``io/planner.py::route_scan``;
- :func:`aligned_key_mask`: the point lookup's face of the predicate.

Every entry point takes ``policy``/``report`` as the JAX package's
(``io/faults.py``): preads retry under the policy, the call runs under
its deadline, and under ``on_corrupt='skip_row_group'`` a corrupt row
group drops whole: at planning (its index structures), in phase 1 or 2
of the host scan (its spans), or at staging in the device scan, recorded
with its candidate rows.  ``scan_files(skip_files=True)`` drops a file
that fails outright, and the routed scan keeps a device attempt's skips
only where that attempt's result is kept.

The predicate holds in each column's order domain: signed or unsigned
integers (an unsigned column's values and bounds compared as unsigned),
decimals by their unscaled integers, byte arrays and fixed-length byte
arrays by their bytes, floats as numpy compares them (``>=`` / ``<=``:
NaN never matches and ``-0.0 == 0.0``; the JAX package's device route
orders doubles by their IEEE total order instead, and so disagrees with
its own host scan there, where the port's two routes agree).  NULL never
matches a range or IN leaf, negated or not.  Phase 1 has the JAX
package's fused variant (``io/fused.py``'s page cursors, chosen by
``io/planner.py::choose_fused``), whose masks equal the materializing
phase 1's; the JAX package's fused span program of the device scan has no
counterpart here: the eager torch ops run.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..algebra.compare import int_domain, is_unsigned, normalize
from ..errors import CorruptedError, DeadlineError, _Unsupported
from ..format.enums import Encoding, Type
from ..obs import scope as _oscope
from ..obs import trace as _otrace
from ..obs.metrics import counter as _ocounter
from ..obs.metrics import histogram as _ohistogram
from ..obs.metrics import pool_wait_seconds as _pool_wait_seconds
from ..ops import device as dev
from ..schema.types import LogicalKind, empty_values, logical_np_dtype
from ..utils.pool import read_admission

__all__ = ["scan", "scan_expr", "scan_filtered", "scan_files",
           "merge_scan_results", "expr_mask", "stage_scan", "decoded_scan",
           "scan_filtered_device", "scan_filtered_sharded",
           "aligned_key_mask"]

# spans between survivor-count reads: bounds the device memory held by
# uncompacted spans while one read serves many spans
_SYNC_EVERY = 8
# the host scan runs serially below this many (candidate rows x columns)
# cells: a pool task costs about as much as decoding a small span
_POOL_MIN_CELLS = 2_000_000

_M_SCAN_FILE_S = _ohistogram("dataset.scan_file_s")
_M_ROWS_PRUNED = _ocounter("scan.rows_pruned")
_M_ROWS_DECODED = _ocounter("scan.rows_decoded")

_HOST_RAGGED = "host_ragged"
_DICT_ENCODINGS = (Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY)


# ---------------------------------------------------------------------------
# the host scan's predicate
# ---------------------------------------------------------------------------


def expr_mask(expr, env: Dict[str, tuple], n: int) -> np.ndarray:
    """The exact row mask of a prepared tree over ``n`` rows of
    row-aligned filter columns (``env[path] -> (values, validity)``), with
    the comparison semantics of every filtered scan."""
    from ..algebra.expr import And, Const, Pred

    if isinstance(expr, Const):
        return np.full(n, expr.value, bool)
    if isinstance(expr, Pred):
        return _pred_mask(expr, env[expr.path], n)
    masks = [expr_mask(c, env, n) for c in expr.children]
    out = masks[0].copy()
    for m in masks[1:]:
        if isinstance(expr, And):
            out &= m
        else:
            out |= m
    return out


def _fused_span_mask(pf, rg_i: int, s: int, count: int,
                     fcols: Sequence[str], expr) -> np.ndarray:
    """Phase 1, fused: the span's filter pages decoded, evaluated and
    dropped a block at a time on the union page grid of the filter
    columns (each block lies in one page of each; a cursor drops its page
    as it moves on), so no whole filter span is ever alive.  Raises
    ``FusedUnsupported`` where a filter column has no offset index."""
    from ..io.fused import PageCursor, count_fused

    rg = pf.row_groups[rg_i]
    cursors = {c: PageCursor(rg, pf.schema.leaf(c)) for c in fcols}
    e = s + count
    mask = np.empty(count, bool)
    cuts = sorted({cc for cur in cursors.values() for cc in cur.grid(s, e)})
    bounds = [s] + cuts + [e]
    for bs, be in zip(bounds, bounds[1:]):
        env = {c: cursors[c].aligned(bs, be) for c in fcols}
        mask[bs - s:be - s] = expr_mask(expr, env, be - bs)
    count_fused("scan_spans")
    return mask


def _pred_mask(pred, span_val: tuple, n: int) -> np.ndarray:
    """One leaf's exact mask in the leaf's order domain (byte arrays by
    their bytes, decimals by their unscaled integers, unsigned columns as
    unsigned); NULL never matches a range or IN leaf, negated or not."""
    from ..algebra.compare import decode_order_value

    keys, key_valid = span_val
    leaf = pred.leaf
    if pred.kind == "null":
        return (np.zeros(n, bool) if key_valid is None
                else ~np.asarray(key_valid, bool))
    if pred.kind == "notnull":
        return (np.ones(n, bool) if key_valid is None
                else np.asarray(key_valid, bool))
    lo, hi = pred.lo, pred.hi
    flba_rows = (not isinstance(keys, list)
                 and getattr(keys, "ndim", 1) == 2
                 and keys.dtype == np.uint8)
    if isinstance(keys, list) or flba_rows:
        # byte-array and FLBA keys: Python comparisons in the order domain
        if flba_rows:
            keys = [bytes(r) for r in np.asarray(keys)]
            if key_valid is not None:
                keys = [k if v else None for k, v in zip(keys, key_valid)]
        keys = [None if x is None else decode_order_value(bytes(x), leaf)
                for x in keys]
        if pred.kind == "in":
            probe_set = set(pred.values)
            base = np.fromiter((x is not None and x in probe_set
                                for x in keys), bool, count=len(keys))
        else:
            base = np.fromiter(
                ((x is not None
                  and (lo is None or x >= lo) and (hi is None or x <= hi))
                 for x in keys), bool, count=len(keys))
        if pred.negated:
            present = np.fromiter((x is not None for x in keys), bool,
                                  count=len(keys))
            return present & ~base
        return base
    if is_unsigned(leaf) and keys.dtype in (np.dtype(np.int32),
                                            np.dtype(np.int64)):
        keys = keys.view(np.uint32 if keys.dtype == np.dtype(np.int32)
                         else np.uint64)
    if pred.kind == "in":
        probes = np.array(pred.values, dtype=keys.dtype)
        base = np.isin(keys, probes)
    else:
        base = np.ones(len(keys), bool)
        if lo is not None:
            base &= keys >= lo
        if hi is not None:
            base &= keys <= hi
    valid = None if key_valid is None else np.asarray(key_valid, bool)
    if pred.negated:
        return ~base if valid is None else valid & ~base
    if valid is not None:
        base &= valid  # NULL fails the predicate
    return base


def order_view(leaf, values: np.ndarray) -> np.ndarray:
    """Host values in the leaf's order domain: an unsigned column's
    int32/int64 as uint32/uint64 (the same bits)."""
    values = np.asarray(values)
    if is_unsigned(leaf) and values.dtype.kind == "i":
        return values.view(f"u{values.dtype.itemsize}")
    return values


def aligned_key_mask(leaf, key, values, validity) -> np.ndarray:
    """Rows of a row-aligned span equal to one normalized ``key``: the
    scan's :func:`_pred_mask` over the one-point range ``key <= v <=
    key``, so the lookup matches keys as every filtered scan does."""
    from ..algebra.expr import Pred

    if isinstance(values, tuple):
        values = list(values)
    n = len(values) if validity is None else len(validity)
    pred = Pred(leaf.name, "range", lo=key, hi=key, leaf=leaf,
                prepared=True)
    return _pred_mask(pred, (values, validity), n)


# ---------------------------------------------------------------------------
# the host scan
# ---------------------------------------------------------------------------


def scan_filtered(pf, path: str, lo=None, hi=None,
                  columns: Optional[Sequence[str]] = None,
                  num_threads: Optional[int] = None, use_bloom: bool = True,
                  values: Optional[Sequence] = None, device="cuda",
                  policy=None, report=None) -> Dict[str, object]:
    """The rows of ``columns`` where ``lo <= pf[path] <= hi`` (or, with
    ``values``, ``pf[path] in values``): :func:`scan_expr` over the
    one-leaf tree."""
    from ..algebra.expr import single_pred

    return scan_expr(pf, single_pred(path, lo=lo, hi=hi, values=values),
                     columns=columns, num_threads=num_threads,
                     use_bloom=use_bloom, device=device, policy=policy,
                     report=report)


_NESTED_MSG = ("column {c!r} is nested; scan_filtered returns row-aligned "
               "arrays - use read_row_range per plan for nested columns")


def scan_expr(pf, where, columns: Optional[Sequence[str]] = None,
              num_threads: Optional[int] = None, use_bloom: bool = True,
              device="cuda", policy=None, report=None) -> Dict[str, object]:
    """The rows of ``columns`` (every flat column outside the predicate by
    default) that match the predicate tree ``where``
    (:mod:`parquet_tpu_torch.algebra.expr`), scanned on the host.

    The planner prunes cheapest first (statistics, page index, then the
    bloom filters of equality leaves, probed on ``device``: CUDA unless
    the caller names the CPU); phase 1 decodes the filter columns'
    candidate pages and evaluates the exact predicate; phase 2 decodes
    each output column only under [first survivor, last survivor] of each
    span.  ``num_threads``: None fans the spans out on the shared pool
    above 2,000,000 cells (serial inside a pool worker), 1 is serial,
    another count a private pool for this call.

    Returns ``{column: values}`` in file order: numpy arrays; a nullable
    number column as ``np.ma.MaskedArray`` (masked at nulls; an FLBA or
    INT96 column's ``(n, width)`` rows masked whole); a byte-array column
    as a list of ``bytes`` with ``None`` at nulls.  ``policy`` (default:
    the file's) and ``report``: the module docstring."""
    from ..io.faults import resolve_policy
    from ..io.reader import resolve_device

    device = resolve_device(device)
    pol, report = resolve_policy(pf, policy, report)
    # an op of its own unless the caller's (or the dataset's) is active
    with _oscope.maybe_op_scope("file.scan", file=pf._path):
        if pol is None and report is None:
            return _scan_expr_impl(pf, where, columns, num_threads,
                                   use_bloom, device)
        with pf._resilient_op(policy, report, "scan_expr"):
            return _scan_expr_impl(pf, where, columns, num_threads,
                                   use_bloom, device, pol=pol,
                                   report=report)


def _check_flat(pf, cols, what: str) -> None:
    """``KeyError`` for a column ``pf`` lacks, ``ValueError`` for a nested
    one."""
    nested = {leaf.name for leaf in pf.schema.leaves
              if leaf.max_repetition_level}
    flat = {leaf.name for leaf in pf.schema.leaves} - nested
    for c in cols:
        if c in nested:
            raise ValueError(_NESTED_MSG.format(c=c))
        if c not in flat:
            raise KeyError(f"unknown {what}{c!r}")


def _output_columns(pf, pred_cols, columns) -> list:
    """``columns``, checked, or by default every flat column outside the
    predicate's ``pred_cols`` (a nested column has no row-aligned
    array)."""
    if columns is not None:
        _check_flat(pf, columns, "column ")
        return list(columns)
    return sorted(leaf.name for leaf in pf.schema.leaves
                  if leaf.max_repetition_level == 0
                  and leaf.name not in set(pred_cols))


def _fan_width(n_tasks: int, cells: int, num_threads: Optional[int]) -> int:
    """The threads :func:`_fan_out` runs ``n_tasks`` tasks on."""
    from ..ops.host import available_cpus
    from ..utils.pool import in_shared_pool, pool_width

    if num_threads == 1 or n_tasks <= 1 or (
            num_threads is None and (cells < _POOL_MIN_CELLS
                                     or in_shared_pool()
                                     or available_cpus() < 2)):
        return 1
    return min(n_tasks, num_threads or pool_width())


def _fan_out(fn, tasks: list, cells: int, num_threads: Optional[int]):
    """``[fn(t) for t in tasks]``: serially for one task, ``num_threads=1``
    or (by default) under :data:`_POOL_MIN_CELLS` cells; on the shared pool
    by default (serially inside a pool worker, where a nested map would
    wait on futures no free worker can run); on a private pool of
    ``num_threads``, closed before returning, otherwise.  Each pooled task
    keeps its native calls to one thread, and runs in a copy of the
    caller's context (its op scope follows it; ``utils/pool.py::
    instrument_task``)."""
    from ..ops import host
    from ..utils.pool import instrument_task, map_in_order

    if _fan_width(len(tasks), cells, num_threads) == 1:
        return [fn(t) for t in tasks]

    def one(t):
        with host.native_thread_cap(1):
            return fn(t)

    if num_threads is None:
        return map_in_order(one, tasks)
    with ThreadPoolExecutor(max_workers=num_threads,
                            thread_name_prefix="pqt-scan") as pool:
        return list(pool.map(instrument_task(one, name="scan_read"),
                             tasks))


def _materialize_ba(values: np.ndarray, offs: np.ndarray,
                    sel: np.ndarray) -> List[bytes]:
    """Python ``bytes`` for the selected value ordinals only: the
    survivors gathered in C++, then sliced."""
    from ..ops import host

    if len(sel) == 0:
        return []
    gv, go = host.gather_byte_arrays(values, offs, sel)
    return [gv[go[i]:go[i + 1]].tobytes() for i in range(len(sel))]


def _typed_empty(leaf):
    """A column's result when nothing survives, in the JAX package's
    form: ``[]`` for a byte array, else a 1-D empty of the leaf's
    presented dtype (uint8 for FLBA and INT96)."""
    if leaf.physical_type == Type.BYTE_ARRAY:
        return []
    return np.empty(0, logical_np_dtype(
        leaf.physical_type, leaf.logical_kind, leaf.logical_params or {})
        or np.uint8)


class _SpanFailure:
    """A span task's located data error, kept beside its siblings'
    results so the row group can be dropped or the error raised."""

    __slots__ = ("rg_index", "error")

    def __init__(self, rg_index: int, error: Exception):
        self.rg_index = rg_index
        self.error = error


def _scan_expr_impl(pf, where, columns, num_threads, use_bloom, device,
                    pol=None, report=None,
                    timings: Optional[dict] = None) -> Dict[str, object]:
    from ..algebra.expr import Expr, prepare
    from ..io.faults import read_context
    from ..io.planner import ScanPlanner, _collect_preds
    from ..io.search import BA_ARRAYS, read_row_range

    if not isinstance(where, Expr):
        raise TypeError("where must be an Expr tree (build with col(); "
                        f"got {type(where).__name__})")
    pred_cols = sorted(where.columns())
    _check_flat(pf, pred_cols, "predicate column ")
    out_cols = _output_columns(pf, pred_cols, columns)
    t0 = time.perf_counter()
    expr = prepare(where, pf.schema)
    plan = ScanPlanner(pf, device=device, policy=pol,
                       report=report).plan(expr, use_bloom=use_bloom)
    fcols = sorted({p.path for p in _collect_preds(expr)})
    rg_base = np.zeros(len(pf.row_groups), np.int64)
    np.cumsum([rg.num_rows for rg in pf.row_groups[:-1]], out=rg_base[1:])
    # the surviving (row group, file row, rows) spans, in row order
    spans = [(d.rg_index, int(rg_base[d.rg_index]) + s, e - s)
             for d in plan.survivors for (s, e) in d.ranges]
    cand_rows = sum(count for _, _, count in spans)
    rg_cand: Dict[int, int] = {}
    for rg_i, _, count in spans:
        rg_cand[rg_i] = rg_cand.get(rg_i, 0) + count
    skip = pol is not None and pol.skip_corrupt
    t1 = time.perf_counter()
    admission = read_admission()
    bytes_per_row: Dict[tuple, float] = {}

    def span_bytes(rg_i: int, c: str, count: int) -> int:
        """The span's admission estimate, as the JAX package's: the
        chunk's uncompressed size prorated to the span's rows."""
        got = bytes_per_row.get((rg_i, c))
        if got is None:
            rg_meta = pf.metadata.row_groups[rg_i]
            meta = rg_meta.columns[pf.schema.leaf(c).column_index].meta_data
            got = bytes_per_row[(rg_i, c)] = (
                (meta.total_uncompressed_size or 0)
                / max(rg_meta.num_rows or 1, 1))
        return int(got * count)

    def read_one(task):
        rg_i, start, count, c, form = task
        try:
            with read_context(path=pf._path, row_group=rg_i, column=c):
                with admission.admit(span_bytes(rg_i, c, count),
                                     tier="scan"):
                    return read_row_range(pf, c, start, count, aligned=form)
        except DeadlineError:
            raise
        except CorruptedError as e:  # dropped or raised below
            return _SpanFailure(rg_i, e)

    def drop_bad_rgs(failures) -> set:
        """Drop every span of each corrupt row group (a partial group
        would misalign the filter and output columns) and record it; or
        raise the first failure."""
        if not skip:
            raise failures[0].error
        bad: Dict[int, Exception] = {}
        for f in failures:
            bad.setdefault(f.rg_index, f.error)
        for rg_i in sorted(bad):
            report.record_skip(rg_i, rows=rg_cand.get(rg_i, 0),
                               error=bad[rg_i])
        return set(bad)

    # phase 1: the filter columns' candidate spans, row-aligned, and the
    # exact predicate over them; fused (io/planner.py::choose_fused on the
    # plan's filter bytes), each span's filter pages are evaluated and
    # dropped a page at a time on the union page grid, at the cost of
    # reading a filter column that is also an output column again in
    # phase 2
    from ..io.fused import FusedUnsupported, count_fused
    from ..io.planner import choose_fused

    use_fused = bool(fcols) and bool(spans) and \
        choose_fused(plan.est_bytes([]))
    k = len(fcols)
    p1_span = (_otrace.span("scan.phase1", file=pf._path,
                            spans=len(spans), cand_rows=cand_rows)
               if _otrace.TRACE_ENABLED else _otrace.NULL_SPAN)
    with p1_span:  # a fan-out that raises still records the span
        if use_fused:
            def mask_one(si):
                rg_i, gstart, count = spans[si]
                s = int(gstart - rg_base[rg_i])
                try:
                    with read_context(path=pf._path, row_group=rg_i):
                        try:
                            return _fused_span_mask(pf, rg_i, s, count, fcols,
                                                    expr)
                        except FusedUnsupported:
                            count_fused("fallbacks")
                            env = {}
                            for c in fcols:
                                with admission.admit(span_bytes(rg_i, c, count),
                                                     tier="scan"):
                                    env[c] = read_row_range(pf, c, gstart, count,
                                                            aligned=True)
                            return expr_mask(expr, env, count)
                except DeadlineError:
                    raise
                except CorruptedError as e:
                    return _SpanFailure(rg_i, e)

            tasks1 = list(range(len(spans)))
            res1 = _fan_out(mask_one, tasks1, cand_rows * max(k, 1),
                            num_threads)
            failures = [r for r in res1 if isinstance(r, _SpanFailure)]
            if failures:
                bad = drop_bad_rgs(failures)
                keep = [i for i, sp in enumerate(spans) if sp[0] not in bad]
                res1 = [res1[i] for i in keep]
                spans = [spans[i] for i in keep]
            envs = [{} for _ in spans]  # filter pages were folded and dropped
            masks = res1
        else:
            tasks1 = [(rg_i, start, count, c, True)
                      for (rg_i, start, count) in spans for c in fcols]
            res1 = _fan_out(read_one, tasks1, cand_rows * max(k, 1),
                            num_threads)
            failures = [r for r in res1 if isinstance(r, _SpanFailure)]
            if failures:
                bad = drop_bad_rgs(failures)
                keep = [i for i, sp in enumerate(spans) if sp[0] not in bad]
                res1 = [res1[i * k + j] for i in keep for j in range(k)]
                spans = [spans[i] for i in keep]
            envs = [{c: res1[i * k + j] for j, c in enumerate(fcols)}
                    for i in range(len(spans))]
            masks = [expr_mask(expr, env, count)
                     for (_, _, count), env in zip(spans, envs)]
    t2 = time.perf_counter()

    # phase 2: each output column outside the filter decoded under [first
    # survivor, last survivor] of each span with a survivor
    trims = []
    for mask in masks:
        idx = np.flatnonzero(mask)
        trims.append((int(idx[0]), int(idx[-1]) + 1) if len(idx) else None)
    fset = set() if use_fused else set(fcols)
    read2_cols = [c for c in out_cols if c not in fset]
    tasks2 = [(spans[si][0], spans[si][1] + t0_, t1_ - t0_, c, "arrays")
              for si, trim in enumerate(trims) if trim is not None
              for t0_, t1_ in [trim] for c in read2_cols]
    cells2 = sum(b - a for t in trims if t is not None
                 for a, b in [t]) * max(len(read2_cols), 1)
    p2_span = (_otrace.span("scan.phase2", file=pf._path,
                            tasks=len(tasks2), cells=cells2)
               if _otrace.TRACE_ENABLED else _otrace.NULL_SPAN)
    with p2_span:
        res2 = _fan_out(read_one, tasks2, cells2, num_threads)
    failures = [r for r in res2 if isinstance(r, _SpanFailure)]
    if failures:
        bad = drop_bad_rgs(failures)
        by_span, ti = {}, 0  # each span's phase-2 results
        for si, trim in enumerate(trims):
            if trim is not None:
                by_span[si] = res2[ti:ti + len(read2_cols)]
                ti += len(read2_cols)
        keep = [i for i, sp in enumerate(spans) if sp[0] not in bad]
        envs = [envs[i] for i in keep]
        masks = [masks[i] for i in keep]
        trims = [trims[i] for i in keep]
        res2 = [r for i in keep if i in by_span for r in by_span[i]]
        spans = [spans[i] for i in keep]

    # assembly
    parts: Dict[str, List] = {c: [] for c in out_cols}
    vparts: Dict[str, List] = {c: [] for c in out_cols}
    ti = 0
    for si, ((_, _, count), mask, trim) in enumerate(
            zip(spans, masks, trims)):
        if trim is None:
            continue  # no survivor: its output pages were never decoded
        a, b = trim
        span2 = {c: res2[ti + j] for j, c in enumerate(read2_cols)}
        ti += len(read2_cols)
        idx = np.flatnonzero(mask)
        m_t = mask[a:b]
        for c in out_cols:
            if c in envs[si]:
                vals, valid = envs[si][c]  # phase 1's aligned form
                if isinstance(vals, list):
                    parts[c].append([vals[i] for i in idx])
                else:
                    parts[c].append(np.asarray(vals)[mask])
                    if valid is not None:
                        vparts[c].append(np.asarray(valid, bool)[mask])
                    elif vparts[c]:  # an earlier span had nulls
                        vparts[c].append(np.ones(int(mask.sum()), bool))
                continue
            vals, valid = span2[c]
            if isinstance(vals, tuple) and vals and vals[0] == BA_ARRAYS:
                _, v_u8, offs = vals
                idx_t = np.flatnonzero(m_t)
                if valid is None:
                    parts[c].append(_materialize_ba(v_u8, offs, idx_t))
                else:
                    ords = np.cumsum(valid) - 1  # row -> present ordinal
                    tv = np.asarray(valid, bool)[idx_t]
                    got = _materialize_ba(v_u8, offs, ords[idx_t][tv])
                    woven = [None] * len(idx_t)
                    for p, v in zip(np.flatnonzero(tv), got):
                        woven[p] = v
                    parts[c].append(woven)
            elif isinstance(vals, list):
                parts[c].append([vals[i] for i in np.flatnonzero(m_t)])
            else:
                parts[c].append(np.asarray(vals)[m_t])
                if valid is not None:
                    vparts[c].append(np.asarray(valid, bool)[m_t])
                elif vparts[c]:  # an earlier span had nulls
                    vparts[c].append(np.ones(int(m_t.sum()), bool))
    out: Dict[str, object] = {}
    for c in out_cols:
        if parts[c] and isinstance(parts[c][0], list):
            out[c] = [v for chunk in parts[c] for v in chunk]
        elif parts[c]:
            vals = np.concatenate(parts[c])
            if vparts[c]:
                # spans before the first with nulls had none
                n_missing = len(vals) - sum(len(v) for v in vparts[c])
                valid = np.concatenate(
                    ([np.ones(n_missing, bool)] if n_missing else [])
                    + vparts[c])
                mask = ~valid
                if vals.ndim == 2:  # FLBA / INT96 rows masked whole
                    mask = np.broadcast_to(mask[:, None], vals.shape)
                out[c] = np.ma.MaskedArray(vals, mask=mask)
            else:
                out[c] = vals
        else:
            out[c] = _typed_empty(pf.schema.leaf(c))
    if report is not None and out_cols:
        report.rows_read += len(out[out_cols[0]])
    # rows the pushdown never decoded, and the survivors (the masks are
    # final here, a degraded scan's drops included)
    _oscope.account(_M_ROWS_PRUNED, int(pf.num_rows) - cand_rows)
    _oscope.account(_M_ROWS_DECODED, int(sum(int(m.sum()) for m in masks)))
    if timings is not None:
        timings.update(
            plan_s=t1 - t0, phase1_s=t2 - t1,
            phase2_s=time.perf_counter() - t2, candidate_rows=cand_rows,
            survivors=int(sum(int(m.sum()) for m in masks)),
            spans=len(spans), tasks=len(tasks1) + len(tasks2),
            threads=[_fan_width(len(tasks1), cand_rows * max(len(fcols), 1),
                                num_threads),
                     _fan_width(len(tasks2), cells2, num_threads)],
            plan_counters=dict(plan.counters))
    return out


# ---------------------------------------------------------------------------
# many files
# ---------------------------------------------------------------------------


def merge_scan_results(parts: List[Dict[str, object]],
                       out_cols: Sequence[str]) -> Dict[str, object]:
    """Per-file host-scan results joined in list order: byte-array lists
    chain, number columns concatenate (as ``np.ma.MaskedArray`` when any
    part has nulls).  Zero-row parts are dropped first: a file whose rows
    all pruned gives the 1-D typed empty even for an ``(n, width)`` FLBA
    or INT96 column."""
    out: Dict[str, object] = {}
    for c in out_cols:
        vals = [p[c] for p in parts]
        if any(isinstance(v, list) for v in vals):
            out[c] = [x for v in vals for x in v]
            continue
        filled = [v for v in vals if len(v)]
        if not filled:
            out[c] = vals[0]
        elif len(filled) == 1:
            out[c] = filled[0]
        elif any(isinstance(v, np.ma.MaskedArray) for v in filled):
            out[c] = np.ma.concatenate(filled)
        else:
            out[c] = np.concatenate(filled)
    return out


def scan_files(pfs: Sequence, path: Optional[str] = None, lo=None, hi=None,
               columns: Optional[Sequence[str]] = None,
               use_bloom: bool = True, values: Optional[Sequence] = None,
               policy=None, report=None, skip_files: bool = False,
               where=None, devices: Optional[Sequence] = None
               ) -> Dict[str, object]:
    """The host scan over many opened files, one file a task on the shared
    pool (each file's scan serial inside its worker), results merged in
    file order (:func:`merge_scan_results`); ``{}`` when no file gives a
    row.  ``where`` takes a predicate tree (prepared once for the whole
    set, if the caller likes), else ``path`` with ``lo``/``hi``/``values``.
    ``devices`` (a mesh: a device, a list, or ``"cuda"``, every card, by
    default) plans file ``i``'s bloom probe on ``devices[i % n]``.  Each
    file's row-group skips under a degraded ``policy`` fold into
    ``report``; ``skip_files=True`` drops a file whose scan fails
    outright, recorded with its full row count (its partial accounting
    dropped, its retries kept), and needs a ``report``.  Deadlines and the
    environment's errors always raise."""
    from ..io.faults import NON_DATA_ERRORS, ReadReport
    from ..utils.pool import map_in_order
    from .mesh import resolve_mesh

    if skip_files and report is None:
        raise ValueError("skip_files=True requires a report to account "
                         "the dropped files")
    if (where is None) == (path is None):
        raise ValueError("pass exactly one of path (+ lo/hi/values) or "
                         "where= (a predicate tree)")
    if not pfs:
        return {}
    devs = resolve_mesh(devices)

    def one(item):
        i, pf = item
        d = devs[i % len(devs)]
        sub = ReadReport() if report is not None else None
        t0 = time.perf_counter()
        try:
            if where is not None:
                got = scan_expr(pf, where, columns=columns,
                                use_bloom=use_bloom, device=d, policy=policy,
                                report=sub)
            else:
                got = scan_filtered(pf, path, lo=lo, hi=hi, columns=columns,
                                    use_bloom=use_bloom, values=values,
                                    device=d, policy=policy, report=sub)
        except DeadlineError:
            raise
        except NON_DATA_ERRORS:
            raise
        except (CorruptedError, OSError) as e:
            if not skip_files:
                raise
            return None, sub, e
        finally:
            _M_SCAN_FILE_S.observe(time.perf_counter() - t0)
        return got, sub, None

    oks = []
    for pf, (got, sub, err) in zip(pfs, map_in_order(
            one, list(enumerate(pfs)))):
        if got is None:
            if sub is not None:
                report.retries += sub.retries  # they happened
            report.record_file_skip(pf._path or "<memory>",
                                    rows=pf.num_rows, error=err)
            continue
        if report is not None and sub is not None:
            report.merge(sub)
        oks.append(got)
    if not oks:
        return {}
    return merge_scan_results(oks, list(oks[0]))


# ---------------------------------------------------------------------------
# the routed scan
# ---------------------------------------------------------------------------


def scan(pf, path: str, lo=None, hi=None,
         columns: Optional[Sequence[str]] = None, use_bloom: bool = True,
         values: Optional[Sequence] = None, device="cuda", policy=None,
         report=None):
    """The pushdown scan, on the host or on ``device`` as the planner's
    cost model decides (``io/planner.py::choose_route``): the device's
    kind, whether the device scan takes the shape (the footer's mirror of
    its refusals), the bytes to decode and the candidate rows of a
    statistics-only plan, and the measured rates of
    :func:`~parquet_tpu_torch.io.planner.route_history`.  On the CPU the
    host scan always runs; ``PARQUET_TPU_TORCH_ROUTE=host|device`` pins
    the route.  A device-scan refusal seen only in the pages
    (``ValueError: ... use the host scan``, such as a dictionary chunk
    that falls back to PLAIN mid-file) falls back to the host scan; every
    other error raises.

    NOTE the two routes' output forms differ: the device route's are
    :func:`decoded_scan`'s, resident on the card, the host route's are
    :func:`scan_filtered`'s numpy arrays and byte lists, and on a card
    the chosen route, hence the form, can change with the plan's size and
    the measured history.  A caller that needs one form calls
    :func:`scan_filtered` or :func:`scan_filtered_device`, or pins the
    route.

    ``policy``/``report``: the device attempt records into a scratch
    report, merged only where its result is kept; on a fallback only its
    retries carry over (the host scan records the skips again), and the
    host scan runs on what is left of the deadline.  Each route's
    observation in the history carries the shared pool's wait during the
    scan (``obs.metrics.pool_wait_seconds``)."""
    with _oscope.maybe_op_scope("file.scan", file=pf._path):
        return _scan_routed(pf, path, lo, hi, columns, use_bloom, values,
                            device, policy, report)


def _scan_routed(pf, path, lo, hi, columns, use_bloom, values, device,
                 policy=None, report=None):
    import dataclasses

    from ..io.faults import ReadReport
    from ..io.planner import route_history, route_scan
    from ..io.reader import resolve_device

    device = resolve_device(device)
    pol = policy if policy is not None else pf.policy
    decision = route_scan(pf, path, lo=lo, hi=hi, columns=columns,
                          values=values, device=device)
    if decision.route == "device":
        t0 = time.monotonic()
        w0 = _pool_wait_seconds()
        scratch = ReadReport() if report is not None else None
        if scratch is not None:
            # its skips publish once, where the attempt is kept: a
            # fallback's host scan records them again
            scratch._publish = False
        try:
            got = scan_filtered_device(pf, path, lo=lo, hi=hi,
                                       columns=columns, use_bloom=use_bloom,
                                       values=values, device=device,
                                       policy=policy, report=scratch)
            if device.type == "cuda":  # the history times finished work
                torch.cuda.synchronize(device)
            route_history().observe("device", decision.est_bytes,
                                    time.monotonic() - t0,
                                    pool_wait_s=_pool_wait_seconds() - w0)
            if report is not None:
                report.merge(scratch)
                scratch.publish_skips()
            return got
        except ValueError as e:
            # only the device scan's documented refusals fall back
            if "use the host scan" not in str(e):
                raise
            if scratch is not None:
                report.retries += scratch.retries
        if pol is not None and pol.deadline_s is not None:
            # the fallback continues the same scan, on the budget left
            remaining = pol.deadline_s - (time.monotonic() - t0)
            if remaining <= 0:
                raise DeadlineError(
                    "deadline exceeded during scan (device attempt spent "
                    "the budget before falling back to the host scan)")
            policy = dataclasses.replace(pol, deadline_s=remaining)
    t0 = time.monotonic()
    w0 = _pool_wait_seconds()
    got = scan_filtered(pf, path, lo=lo, hi=hi, columns=columns,
                        use_bloom=use_bloom, values=values, device=device,
                        num_threads=decision.pool_width, policy=policy,
                        report=report)
    # the pool's saturation during this scan (queue waits and prefetch
    # stalls, process-wide) discounts the route's effective rate
    route_history().observe("host", decision.est_bytes,
                            time.monotonic() - t0,
                            pool_wait_s=_pool_wait_seconds() - w0)
    return got


# ---------------------------------------------------------------------------
# the key predicate
# ---------------------------------------------------------------------------


def _int_bound(v, up: bool):
    """An integer column's bound ``v`` as an int (``up``: a lower bound,
    rounded up), or +-inf / nan as they come."""
    if isinstance(v, float) and math.isfinite(v):
        return math.ceil(v) if up else math.floor(v)
    return v


class _KeyFilter:
    """The scan's key predicate, prepared once a scan in the key column's
    order domain: range bounds clamped to it (so no bound overflows the
    column's dtype), IN probes sorted on the device, and for a dictionary
    string key the raw bounds and probes that :meth:`verdicts` tests each
    entry against."""

    def __init__(self, leaf, lo, hi, probe: Optional[list], device):
        self.leaf = leaf
        self.probe = probe
        self.lo, self.hi = normalize(leaf, lo), normalize(leaf, hi)
        self.empty = False
        self.probes = None
        t = leaf.physical_type
        self.unsigned = is_unsigned(leaf) and t in (Type.INT32, Type.INT64)
        if t == Type.BYTE_ARRAY:
            return
        if probe is not None:
            self.probes = self._probe_tensor(probe, device)
            self.empty = self.probes.shape[0] == 0
            self._probes_on = {self.probes.device: self.probes}
        elif t in (Type.INT32, Type.INT64):
            self._int_range()

    def _probe_tensor(self, probe: list, device) -> torch.Tensor:
        t = self.leaf.physical_type
        if t == Type.INT32:
            arr = np.array(probe, np.int64)
            if self.unsigned:
                arr -= 2 ** 31
            arr = arr.astype(np.int32)
        elif t == Type.FLOAT:
            arr = np.array(probe, np.float32)
            arr = arr[~np.isnan(arr)]  # NaN equals nothing
        elif t == Type.BOOLEAN:
            arr = np.array(probe, np.bool_).astype(np.uint8)
        else:
            raise ValueError("device IN-list needs a single-word key; use "
                             "the host scan")
        return torch.from_numpy(np.unique(arr)).to(device)

    def _int_range(self) -> None:
        dlo, dhi = int_domain(self.leaf)  # [dlo, dhi)
        lo, hi = _int_bound(self.lo, True), _int_bound(self.hi, False)
        if lo is not None:
            if lo != lo or lo >= dhi:
                self.empty = True
            lo = None if lo <= dlo else lo
        if hi is not None:
            if hi != hi or hi < dlo:
                self.empty = True
            hi = None if hi >= dhi - 1 else hi
        if self.unsigned:  # to the signed keys of sign_flip
            half = 2 ** (31 if self.leaf.physical_type == Type.INT32
                         else 63)
            lo = None if lo is None else lo - half
            hi = None if hi is None else hi - half
        self.lo, self.hi = lo, hi

    def verdicts(self, dictionary_host) -> np.ndarray:
        """A dictionary string key: whether each entry matches (uint8)."""
        dvals, doffs = dictionary_host
        doffs = np.asarray(doffs, np.int64)
        dvals = np.asarray(dvals)
        entries = [dvals[doffs[i]:doffs[i + 1]].tobytes()
                   for i in range(len(doffs) - 1)]
        if self.probe is not None:
            probe_set = set(self.probe)
            match = [e in probe_set for e in entries]
        else:
            match = [(self.lo is None or e >= self.lo)
                     and (self.hi is None or e <= self.hi) for e in entries]
        return np.array(match, np.uint8)

    def mask(self, vals, table) -> torch.Tensor:
        """The rows of a row-aligned span that match (validity not yet
        applied); ``table`` is a dictionary key's staged verdicts."""
        if isinstance(vals, tuple):  # dictionary string key
            return dev.dict_gather(table, vals[1]) != 0
        n = vals.shape[0]
        if self.empty:
            return torch.zeros(n, dtype=torch.bool, device=vals.device)
        if vals.dtype == torch.bool:
            vals = vals.to(torch.uint8)
        if self.unsigned:
            vals = dev.sign_flip(vals)
        if self.probes is not None:
            probes = self._probes_on.get(vals.device)
            if probes is None:  # a span staged on another mesh device
                probes = self._probes_on.setdefault(
                    vals.device, self.probes.to(vals.device))
            return dev.in_mask(vals, probes)
        return dev.range_mask(vals, self.lo, self.hi)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def stage_scan(pf, path: str, lo=None, hi=None,
               columns: Optional[Sequence[str]] = None,
               use_bloom: bool = True, values: Optional[Sequence] = None,
               device="cuda", policy=None, report=None,
               devices: Optional[Sequence] = None) -> dict:
    """The host phase of a device scan: the pushdown plan, each surviving
    span's prescan and its staging on ``device`` (CUDA unless the caller
    names the CPU; a CUDA request without a card raises).  ``devices`` (a
    mesh, whose entries may repeat) stages span ``i`` on
    ``devices[i % len(devices)]`` instead and plans on the first.
    Returns the staged state :func:`decoded_scan` consumes, as often as it
    likes.

    Flat columns only; the key cannot be a fixed-length byte array, INT96,
    a decimal byte array or a PLAIN byte array, an IN-list needs a key of
    one 32-bit word or less, and a chunk the device route refuses cannot
    be scanned: each of these raises ``ValueError`` saying to use the host
    scan (never wrapped: the routed scan falls back on it).  ``policy``
    and ``report`` cover the staging, where all the scan's IO happens:
    preads retry under the policy, and under ``skip_row_group`` a row
    group whose pages fail drops at staging, recorded with its candidate
    rows."""
    from ..io.faults import resolve_policy
    from ..io.prefetch import make_chunk_prefetcher
    from ..io.reader import resolve_device

    if devices is not None:
        from .mesh import resolve_mesh

        devs = resolve_mesh(devices)
    else:
        devs = [resolve_device(device)]
    pol, report = resolve_policy(pf, policy, report)
    with pf._resilient_op(policy, report, "stage_scan"):
        pre = make_chunk_prefetcher(pf.source)
        if pre is None:
            return _stage_scan_impl(pf, path, lo, hi, columns, use_bloom,
                                    values, devs, pol=pol, report=report)
        try:
            with pf._source_override(pre):
                return _stage_scan_impl(pf, path, lo, hi, columns, use_bloom,
                                        values, devs, prefetcher=pre,
                                        pol=pol, report=report)
        finally:
            pre.close()


def _refuse(what: str) -> ValueError:
    return ValueError(f"{what}; use the host scan")


def _check_key(pf, path: str, out_cols: list, values) -> None:
    """The device scan's documented refusals, before any IO."""
    flat = {leaf.name for leaf in pf.schema.leaves
            if leaf.max_repetition_level == 0}
    for c in [path] + out_cols:
        if c not in flat:
            raise _refuse(f"column {c!r} is nested or unknown; the device "
                          "scan handles flat columns")
    key = pf.schema.leaf(path)
    t = key.physical_type
    if t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        raise _refuse(f"device scan key {path!r} has physical type {t.name}")
    if t == Type.BYTE_ARRAY and key.logical_kind == LogicalKind.DECIMAL:
        # a decimal orders by its unscaled value, not by its bytes
        raise _refuse(f"device scan key {path!r} is a decimal byte array")
    if values is not None and t in (Type.INT64, Type.DOUBLE):
        raise _refuse(f"device scan IN-list on 64-bit key {path!r} is not "
                      "supported")


def _stage_scan_impl(pf, path, lo, hi, columns, use_bloom, values, devs,
                     prefetcher=None, pol=None, report=None) -> dict:
    from ..algebra.compare import normalize_probe
    from ..io.faults import read_context
    from ..io.search import pages_and_base, plan_scan
    from .device_reader import _StagingBatch, build_plan, stage_plan

    if columns is not None:
        out_cols = list(columns)
    else:
        out_cols = sorted(leaf.name for leaf in pf.schema.leaves
                          if leaf.max_repetition_level == 0
                          and leaf.name != path)
    _check_key(pf, path, out_cols, values)
    leaves = {c: pf.schema.leaf(c) for c in [path] + out_cols}
    key_leaf = leaves[path]
    device = devs[0]
    plans = plan_scan(pf, path, lo=lo, hi=hi, use_bloom=use_bloom,
                      values=values, device=device, policy=pol,
                      report=report)
    rgs = pf.row_groups
    if prefetcher is not None:
        # only the surviving spans' chunks are read
        seen = set()
        for p in plans:
            for c in leaves:
                br = rgs[p.rg_index].column(leaves[c].column_index).byte_range
                if br not in seen:
                    seen.add(br)
                    prefetcher.plan(*br)
    probe = (sorted({normalize_probe(key_leaf, v) for v in values} - {None})
             if values is not None else None)
    keyf = _KeyFilter(key_leaf, lo, hi, probe, device)
    skip = pol is not None and pol.skip_corrupt
    failed: Dict[int, Exception] = {}  # row group -> its data error

    def staging(rg_i: int, c: str):
        """One column of a span: a data error is located (the device
        scan's refusals, ``ValueError``, pass unwrapped)."""
        return read_context(path=pf._path, row_group=rg_i, column=c,
                            kinds=(CorruptedError, OSError))

    def fail(rg_i: int, e: Exception) -> None:
        if not skip:
            raise e
        failed.setdefault(rg_i, e)

    # each span's pages, and whether each column takes the host-ragged
    # form there, decided from the page headers before anything is planned
    spans_pages = []
    for plan in plans:
        if plan.rg_index in failed:
            continue
        rg = rgs[plan.rg_index]
        row_start, row_end = plan.first_row, plan.first_row + plan.row_count
        cols = {}
        try:
            for c, leaf in leaves.items():
                with staging(plan.rg_index, c):
                    chunk = rg.column(leaf.column_index)
                    pages, first = pages_and_base(chunk, row_start, row_end)
                    kinds = (_data_page_kinds(pages)
                             if leaf.physical_type == Type.BYTE_ARRAY
                             else {True})
                if True not in kinds and c == path:
                    raise _refuse(f"device scan key {c!r}: plain-encoded "
                                  "BYTE_ARRAY has no row-aligned device "
                                  "form")
                cols[c] = (chunk, pages, row_start - first, kinds)
        except DeadlineError:
            raise
        except CorruptedError as e:
            fail(plan.rg_index, e)
            continue
        spans_pages.append((plan, cols))
    # a column dictionary-encoded in one span and PLAIN in another takes
    # the host-ragged form in every span, so that its parts share one form
    mixed = {c for c in out_cols
             if len({True in cols[c][3] for _, cols in spans_pages}) == 2}
    spans = []
    for si, (plan, cols) in enumerate(spans_pages):
        if plan.rg_index in failed:
            continue
        span_dev = devs[si % len(devs)]
        batch = _StagingBatch()
        per_col, staged, table = {}, {}, None
        try:
            for c, (chunk, pages, trim, kinds) in cols.items():
                # a span mixing both kinds of page is planned, and refused
                if True not in kinds or (c in mixed and kinds == {True}):
                    with staging(plan.rg_index, c):
                        per_col[c] = _host_ragged_span(chunk, pages, trim,
                                                       plan.row_count)
                    continue
                try:
                    with staging(plan.rg_index, c):
                        dplan = build_plan(chunk, pages=pages)
                        staged[c] = stage_plan(dplan, span_dev, batch.put)
                except _Unsupported as e:
                    raise _refuse(f"device scan column {c!r}: {e}") from None
                per_col[c] = [dplan, None, trim, chunk, pages]
                if c == path and key_leaf.physical_type == Type.BYTE_ARRAY:
                    table = batch.put(keyf.verdicts(dplan.dictionary_host))
        except DeadlineError:
            raise
        except CorruptedError as e:
            fail(plan.rg_index, e)
            continue
        (staged, table), _ = batch.commit((staged, table), span_dev)
        for c, got in staged.items():
            per_col[c][1] = got
        spans.append((plan, per_col, table))
    if failed:  # a corrupt row group drops whole, its spans staged or not
        for rg_i in sorted(failed):
            report.record_skip(rg_i, rows=sum(p.row_count for p in plans
                                              if p.rg_index == rg_i),
                               error=failed[rg_i])
        spans = [sp for sp in spans if sp[0].rg_index not in failed]
    return {"path": path, "out_cols": out_cols, "key": keyf,
            "spans": spans, "leaves": leaves, "device": device,
            "devices": devs}


def _data_page_kinds(pages) -> set:
    """Whether each data page of ``pages`` (:class:`PageInfo` objects) is
    dictionary-encoded, by its header, as a set: a byte-array span without
    a dictionary page has no device form here, and one with both kinds is
    refused by the planner (``mixed_page_kinds``)."""
    kinds = set()
    for p in pages:
        h = p.header.data_page_header or p.header.data_page_header_v2
        if h is not None:
            kinds.add(h.encoding in _DICT_ENCODINGS)
    return kinds


def _host_ragged_span(chunk, pages, trim: int, n_rows: int) -> tuple:
    """A PLAIN string output column's span on the host, decoded from the
    span's pages: ``("host_ragged", values, offsets, validity)``, the
    offsets over the present values and the validity (None without
    nulls) over the span's rows."""
    from ..io.reader import decode_chunk_host
    from ..io.search import _trim_host

    col = decode_chunk_host(chunk, "cpu", pages=pages)
    (_, vals, offs), valid = _trim_host(col, trim, n_rows, "arrays")
    return (_HOST_RAGGED, np.asarray(vals), np.asarray(offs, np.int64),
            None if valid is None else np.asarray(valid, bool))


# ---------------------------------------------------------------------------
# the device phase
# ---------------------------------------------------------------------------


def _row_aligned_device(col, trim: int, n_rows: int, no_nulls: bool):
    """A decoded flat column as row-aligned ``(values, validity)``, cut to
    the span's rows (its pages may start before them).  A dictionary
    string column gives ``((dictionary, indices), validity)``.  With
    ``no_nulls`` (known on the host from the plan's counts) the validity
    is dropped unread."""
    validity = None if no_nulls else col.validity
    if col.is_dictionary_encoded():
        idx = col.dict_indices
        if validity is not None:
            idx = dev.scatter_valid(idx, validity)
        vals = (col.dictionary, idx[trim:trim + n_rows])
    else:
        vals = col.values
        if validity is not None:
            vals = dev.scatter_valid(vals, validity)
        vals = vals[trim:trim + n_rows]
    return vals, (None if validity is None
                  else validity[trim:trim + n_rows])


class _ScanCarrier:
    """The spans' results between dispatch and assembly: each column's
    compacted parts (a tensor; ``(dictionary, indices, dictionary bytes)``;
    or a host-ragged tuple with the device's survivor rows last), their
    validity, and the survivor counts still on the device."""

    def __init__(self, out_cols):
        self.parts: Dict[str, List] = {c: [] for c in out_cols}
        self.vparts: Dict[str, List] = {c: [] for c in out_cols}
        self.any_valid = {c: False for c in out_cols}
        self.counts: List[torch.Tensor] = []
        self.ks_all: List[int] = []
        self.flushed = 0

    def flush(self, out_cols, upto: int) -> None:
        """Read back the counts of spans ``[flushed, upto)`` in one read,
        then cut each span's parts to its survivors."""
        if upto <= self.flushed:
            return
        ks = torch.stack(self.counts[self.flushed:upto]).tolist()
        self.ks_all.extend(ks)
        for si, k in zip(range(self.flushed, upto), ks):
            for c in out_cols:
                p = self.parts[c][si]
                if isinstance(p, tuple) and p[0] == _HOST_RAGGED:
                    self.parts[c][si] = p[:4] + (p[4][:k],)
                elif isinstance(p, tuple):
                    self.parts[c][si] = (p[0], p[1][:k], p[2])
                else:
                    self.parts[c][si] = p[:k]
                if self.vparts[c][si] is not None:
                    self.vparts[c][si] = self.vparts[c][si][:k]
        self.flushed = upto


def _scan_dispatch(state, carrier: _ScanCarrier,
                   sync_every: Optional[int] = _SYNC_EVERY) -> None:
    """Every span, decoded and filtered with no read-back but the counts,
    batched ``sync_every`` spans at a time (None: none before assembly):
    the key's mask, its survivors' targets, and each output column's rows
    compacted to a prefix."""
    from .device_reader import decode_staged

    path, out_cols = state["path"], state["out_cols"]
    keyf: _KeyFilter = state["key"]
    device = state["device"]
    for plan, per_col, table in state["spans"]:
        n_rows = plan.row_count
        kplan, kstaged, ktrim, _, _ = per_col[path]
        key = decode_staged(kplan, kstaged, device)
        kvals, kvalid = _row_aligned_device(
            key, ktrim, n_rows, kplan.total_values == kplan.total_slots)
        mask = keyf.mask(kvals, table)
        if kvalid is not None:
            mask &= kvalid  # NULL never matches
        tgt, cnt = dev.compact_targets(mask)
        ragged_idx = None
        for c in out_cols:
            part = per_col[c]
            if part[0] == _HOST_RAGGED:
                if ragged_idx is None:
                    ragged_idx = dev.compact_prefix(
                        torch.arange(n_rows, device=device), tgt)
                carrier.parts[c].append(part + (ragged_idx,))
                carrier.vparts[c].append(None)
                continue
            cplan, cstaged, ctrim, _, _ = part
            col = key if c == path else decode_staged(cplan, cstaged, device)
            vals, valid = _row_aligned_device(
                col, ctrim, n_rows, cplan.total_values == cplan.total_slots)
            if isinstance(vals, tuple):  # dictionary strings: their indexes
                nbytes = int(cplan.dictionary_host[1][-1])
                out = (vals[0], dev.compact_prefix(vals[1], tgt), nbytes)
            else:
                out = dev.compact_prefix(vals, tgt)
            carrier.parts[c].append(out)
            carrier.vparts[c].append(None if valid is None
                                     else dev.compact_prefix(valid, tgt))
            carrier.any_valid[c] |= valid is not None
        carrier.counts.append(cnt)
        if sync_every and len(carrier.counts) - carrier.flushed >= \
                sync_every:
            carrier.flush(out_cols, len(carrier.counts))


def _empty_device_result(leaf, device):
    """The typed empty of a column's output form."""
    t = leaf.physical_type
    if t == Type.BYTE_ARRAY:
        return ((torch.zeros(0, dtype=torch.uint8, device=device),
                 torch.zeros(1, dtype=torch.int64, device=device)),
                torch.zeros(0, dtype=torch.int32, device=device))
    return empty_values(t, leaf.type_length, device)


def _concat_dictionaries(parts) -> tuple:
    """Each span's ``(dictionary, indices, dictionary bytes)`` as one
    rebased dictionary and its indices: span i's indexes shift by the
    entries of the dictionaries before it, which are concatenated (an
    entry repeated across row groups is kept).  The byte counts come from
    the plans' host dictionaries, so nothing is read back."""
    if len(parts) == 1:
        return parts[0][:2]
    idx_parts, off_parts, base, vbase = [], [], 0, 0
    for (dv, do), idx, nbytes in parts:
        idx_parts.append(idx + base)
        off_parts.append(do[:-1] + vbase)
        base += do.shape[0] - 1
        vbase += nbytes
    (_, last_do), _, last_nbytes = parts[-1]
    off_parts.append(last_do[-1:] + (vbase - last_nbytes))
    return ((torch.cat([p[0][0] for p in parts]), torch.cat(off_parts)),
            torch.cat(idx_parts))


def _assemble_host_ragged(parts, ks: List[int]):
    """A PLAIN string column's survivors, gathered on the host: the spans'
    survivor rows come back in one read, map to present-value ordinals
    through each span's validity, and their bytes form one ``(uint8
    values, int64 offsets)`` pair (a null: an empty entry), wrapped as
    ``(form, validity)`` where a null survives."""
    from ..ops import host

    rows_all = torch.cat([p[4] for p in parts]).cpu().numpy()
    vals_parts, lens_parts, valid_parts = [], [], []
    any_nulls = False
    at = 0
    for (_, hv, ho, hvalid, _), k in zip(parts, ks):
        rows = rows_all[at:at + k].astype(np.int64)
        at += k
        if hvalid is None:
            v = np.ones(k, bool)
            ords = rows
        else:
            v = hvalid[rows]
            ords = (np.cumsum(hvalid, dtype=np.int64) - 1)[rows]
            any_nulls = any_nulls or not bool(v.all())
        sel = ords[v]
        vals_parts.append(host.gather_byte_arrays(hv, ho, sel)[0])
        lens = np.zeros(k, np.int64)
        lens[v] = ho[sel + 1] - ho[sel]
        lens_parts.append(lens)
        valid_parts.append(v)
    offs = np.zeros(at + 1, np.int64)
    np.cumsum(np.concatenate(lens_parts), out=offs[1:])
    form = (np.concatenate(vals_parts).astype(np.uint8, copy=False), offs)
    return (form, np.concatenate(valid_parts)) if any_nulls else form


def _scan_assemble(state, carrier: _ScanCarrier) -> Dict[str, object]:
    """The last counts read back, then each column's parts as one form."""
    out_cols, device = state["out_cols"], state["device"]
    carrier.flush(out_cols, len(carrier.counts))
    out: Dict[str, object] = {}
    for c in out_cols:
        parts = carrier.parts[c]
        if not parts:
            out[c] = _empty_device_result(state["leaves"][c], device)
            continue
        if isinstance(parts[0], tuple) and parts[0][0] == _HOST_RAGGED:
            out[c] = _assemble_host_ragged(parts, carrier.ks_all)
            continue
        if isinstance(parts[0], tuple):
            form = _concat_dictionaries(parts)
            rows = [p[1].shape[0] for p in parts]
        else:
            form = parts[0] if len(parts) == 1 else torch.cat(parts)
            rows = [p.shape[0] for p in parts]
        if carrier.any_valid[c]:
            valid = torch.cat([
                v if v is not None
                else torch.ones(n, dtype=torch.bool, device=device)
                for v, n in zip(carrier.vparts[c], rows)])
            out[c] = (form, valid)
        else:
            out[c] = form
    return out


def decoded_scan(state) -> Dict[str, object]:
    """The device phase of the scan on a :func:`stage_scan` state: decode
    the staged pages, evaluate the key predicate and gather the surviving
    rows, in file order.  Each column's form (a typed empty when nothing
    survives): a fixed-width column is a 1-D tensor (64-bit types native);
    a dictionary-encoded string column ``((values, offsets), indices)``,
    the row groups' dictionaries rebased into one; a PLAIN string column a
    host ``(uint8 values, int64 offsets)`` pair of the survivors; a
    nullable column ``(form, validity)``."""
    carrier = _ScanCarrier(state["out_cols"])
    _scan_dispatch(state, carrier)
    return _scan_assemble(state, carrier)


def scan_filtered_device(pf, path: str, lo=None, hi=None,
                         columns: Optional[Sequence[str]] = None,
                         use_bloom: bool = True,
                         values: Optional[Sequence] = None,
                         device="cuda", policy=None,
                         report=None) -> Dict[str, object]:
    """The rows where ``lo <= pf[path] <= hi`` (or ``pf[path] in values``)
    of ``columns`` (every other flat column by default), pushdown-planned,
    decoded and filtered on ``device``: :func:`stage_scan` then
    :func:`decoded_scan`."""
    return decoded_scan(stage_scan(pf, path, lo=lo, hi=hi, columns=columns,
                                   use_bloom=use_bloom, values=values,
                                   device=device, policy=policy,
                                   report=report))


def scan_filtered_sharded(pf, path: str, lo=None, hi=None,
                          columns: Optional[Sequence[str]] = None,
                          mesh=None, use_bloom: bool = True, policy=None,
                          report=None) -> Dict[str, object]:
    """The device scan with its surviving spans staged round-robin over
    ``mesh`` (a device, a list whose entries may repeat, or None or
    ``"cuda"`` for every card), span ``i`` decoded and filtered on
    ``mesh[i % len(mesh)]``.  Every shard's spans are dispatched before
    any shard's survivor counts are read, so the devices work at once.

    Returns ``{column: [per-device results]}`` (one entry a device that
    holds a span, in mesh order, each in :func:`decoded_scan`'s forms and
    resident on its device) plus ``"#rows"``, the survivors in all."""
    from .mesh import resolve_mesh

    devs = resolve_mesh(mesh)
    state = stage_scan(pf, path, lo=lo, hi=hi, columns=columns,
                       use_bloom=use_bloom, devices=devs, policy=policy,
                       report=report)
    out_cols = state["out_cols"]
    if "#rows" in out_cols:
        raise ValueError('a column named "#rows" collides with the result '
                         "total; select it via scan_filtered instead")
    shards = []  # (sub-state, carrier)
    for di, d in enumerate(devs):
        spans = [sp for si, sp in enumerate(state["spans"])
                 if si % len(devs) == di]
        if spans:
            shards.append((dict(state, spans=spans, device=d),
                           _ScanCarrier(out_cols)))
    for sub, carrier in shards:  # each shard's memory is its own share
        _scan_dispatch(sub, carrier, sync_every=None)
    per_dev: Dict[str, List] = {c: [] for c in out_cols}
    total = 0
    for sub, carrier in shards:
        got = _scan_assemble(sub, carrier)
        for c in out_cols:
            per_dev[c].append(got[c])
        total += sum(carrier.ks_all)
    result: Dict[str, object] = dict(per_dev)
    result["#rows"] = total
    return result
