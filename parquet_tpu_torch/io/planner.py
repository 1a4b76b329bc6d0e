"""The scan planner: one cascade for every filtered read.

The port's cut of ``parquet_tpu/io/planner.py``, its planning half:

- **Input** is a predicate tree (:mod:`parquet_tpu_torch.algebra.expr`)
  over any number of columns, prepared against the file's schema; the
  single-column ``lo``/``hi``/IN-list signatures build a one-leaf tree.
- **Cheapest-first probes** per row group: the footer's chunk statistics
  (parsed already, no IO), then the page-index zone maps (one small read
  a chunk, memoized), then the bloom filters (equality leaves only).
  ``And``/``Or`` short-circuit; a row group a cheaper probe kills is never
  probed again, and its chunk bytes are never read.
- **Output** is a :class:`ScanPlan`: the surviving (row group, row range)
  slices, per-leaf page intervals intersected and united through the tree,
  with byte estimates and the cascade's counters; :meth:`ScanPlan.explain`
  says which probe killed what.

Where the reference probes each row group's filters as it reaches them,
here the bloom stage runs once over every row group that survives the
statistics and the page index: each equality leaf's hashes of each such
row group with a filter go into one
:func:`~parquet_tpu_torch.io.bloom.check_hashes_multi` on the planner's
device (one launch of the ``bloom_check`` kernel on a card), and the tree
is then folded per row group over those verdicts, counting its probes as
the reference counts them.  A single-leaf tree reads the same filters; a
tree of several equality leaves may read a filter the reference's
short-circuit would have skipped.

The route half: :func:`device_encoding_supported`, which says from the
footer alone whether the device route can place every chunk of a file,
and :data:`ROUTE_REFUSALS`, the files and chunks it refused, by reason;
and the routed scan's cost model: :func:`route_scan` builds
:class:`CostInputs` from a statistics-only plan (no IO) and
:func:`device_route_supported`, :func:`choose_route` picks the host or
the device scan, and :class:`RouteHistory` feeds the measured rates
back.  The aggregation cascade's half: the coverage proofs
(:func:`_stats_covers`, :func:`_tree_covers`, :func:`_bounds_cover`) and
:func:`choose_fused`, the gate of the fused page cursor
(``io/fused.py``) under ``PARQUET_TPU_TORCH_FUSED``.  Left out for later
slices: the pool-wait meter (the routed scan observes no pool wait), and
the route meters, metrics, trace spans and ``/debugz`` section.
"""

from __future__ import annotations

import contextlib

import threading
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..algebra.expr import And, Const, Expr, Or, Pred, prepare
from ..format.enums import Encoding
from ..obs import trace as _trace
from ..obs.export import register_debugz_provider as _register_debugz
from ..obs.metrics import counter as _mcounter
from ..obs.metrics import gauge as _mgauge
from ..obs.scope import account as _maccount

__all__ = ["ScanPlanner", "ScanPlan", "RowGroupDecision",
           "device_encoding_supported", "ROUTE_REFUSALS",
           "count_device_refusal", "reset_route_refusals", "CostInputs",
           "RouteDecision", "RouteHistory", "route_history", "choose_route",
           "device_route_supported", "route_scan"]

# local row intervals: half-open (start, end)
_Intervals = List[Tuple[int, int]]

# the cascade, cheapest first; ``use_bloom=False`` drops its last stage
_CASCADE = ("stats", "pages", "bloom")


def _merge_intervals(iv: _Intervals) -> _Intervals:
    if len(iv) <= 1:
        return iv
    iv = sorted(iv)
    out = [iv[0]]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect_intervals(a: _Intervals, b: _Intervals) -> _Intervals:
    out: _Intervals = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


@dataclass
class RowGroupDecision:
    """One row group's fate through the cascade."""

    rg_index: int
    num_rows: int
    pruned_by: Optional[str] = None  # "stats" | "pages" | "bloom" |
    #                                  "const" | None (survived)
    killer: Optional[str] = None  # repr of the leaf that killed it
    ranges: _Intervals = field(default_factory=list)  # local [start, end)
    page_sel: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # single-leaf page info: (ords, first_row, row_count), or ("all",
    # column) for a row group without a usable index
    _legacy: Optional[tuple] = None

    @property
    def candidate_rows(self) -> int:
        return sum(e - s for s, e in self.ranges)


def _file_name(pf) -> str:
    return getattr(pf.source, "path", None) or "<memory>"


class ScanPlan:
    """The survivors and the cascade's accounting for one file's filtered
    read."""

    def __init__(self, pf, expr: Expr, decisions: List[RowGroupDecision],
                 counters: Dict[str, int], stages: Tuple[str, ...]):
        self.pf = pf
        self.expr = expr
        self.decisions = decisions
        self.counters = counters
        self.stages = stages

    @property
    def survivors(self) -> List[RowGroupDecision]:
        return [d for d in self.decisions if d.pruned_by is None and d.ranges]

    @property
    def candidate_rows(self) -> int:
        return sum(d.candidate_rows for d in self.survivors)

    def est_bytes(self, out_cols: Sequence[str] = ()) -> int:
        """Compressed bytes the scan is expected to decode: the selected
        pages of the filter columns (where a page index narrowed them) and
        the output columns' chunk bytes prorated by the candidate rows."""
        total = 0
        filter_cols = {p.path for p in _collect_preds(self.expr)}
        rgs = self.pf.row_groups
        for d in self.survivors:
            rg = rgs[d.rg_index]
            frac = d.candidate_rows / max(d.num_rows, 1)
            for path in set(out_cols) | filter_cols:
                chunk = rg.column(self.pf.schema.leaf(path).column_index)
                nbytes = chunk.meta.total_compressed_size or 0
                sel = d.page_sel.get(path)
                if sel is not None and sel[1]:
                    total += int(nbytes * (sel[0] / sel[1]))
                else:
                    total += int(nbytes * frac)
        return total

    def page_plans(self) -> list:
        """The single-column form of ``plan_scan``: one covering
        :class:`~parquet_tpu_torch.io.search.PagePlan` a surviving row
        group.  Defined for one-leaf positive range/IN trees only."""
        from .search import PagePlan

        out = []
        rgs = None
        for d in self.decisions:
            if d.pruned_by is not None:
                continue
            info = d._legacy
            if info is None:
                raise ValueError(
                    "page_plans() is the single-predicate form; this plan "
                    "was built from a multi-leaf tree: use .survivors / "
                    ".decisions instead")
            if info[0] == "all":
                rgs = rgs or self.pf.row_groups
                oi = rgs[d.rg_index].column(info[1]).offset_index()
                n = len(oi.page_locations) if oi and oi.page_locations else 0
                out.append(PagePlan(d.rg_index, list(range(n)) if oi else [],
                                    0, d.num_rows))
            else:
                ords, first_row, row_count = info
                out.append(PagePlan(d.rg_index, ords, first_row, row_count))
        return out

    def explain(self) -> str:
        """The cascade as text: which probe killed which row group, the
        surviving candidate ranges and the probe totals."""
        c = self.counters
        lines = [f"scan plan: {_file_name(self.pf)}",
                 f"  predicate: {self.expr!r}",
                 f"  stages: {' -> '.join(self.stages)}"]
        for d in self.decisions:
            if d.pruned_by is not None:
                why = d.pruned_by + (f" ({d.killer})" if d.killer else "")
                lines.append(f"  rg {d.rg_index} ({d.num_rows} rows): "
                             f"pruned by {why}")
                continue
            pages = ", ".join(f"{p}={s}/{t}"
                              for p, (s, t) in sorted(d.page_sel.items()))
            lines.append(
                f"  rg {d.rg_index} ({d.num_rows} rows): "
                f"{len(d.ranges)} range(s), {d.candidate_rows} candidate "
                f"rows" + (f", pages {pages}" if pages else ""))
        total_rows = sum(d.num_rows for d in self.decisions)
        cand = self.candidate_rows
        pct = 100.0 * cand / total_rows if total_rows else 0.0
        lines.append(
            f"  probes: stats={c.get('stats_probes', 0)} "
            f"pages={c.get('page_probes', 0)} "
            f"bloom={c.get('bloom_probes', 0)}; pruned row groups: "
            f"stats={c.get('rg_pruned_stats', 0)} "
            f"pages={c.get('rg_pruned_pages', 0)} "
            f"bloom={c.get('rg_pruned_bloom', 0)}; candidates "
            f"{cand}/{total_rows} rows ({pct:.2f}%)")
        return "\n".join(lines)


# the fused page cursor pays a header parse and mask bookkeeping a page:
# under this many estimated decode bytes the materializing tier's one span
# read wins (``auto`` only; ``on``/``off`` pin the choice)
FUSED_AUTO_MIN_BYTES = 8 << 20


def choose_fused(est_bytes: int, device=None) -> bool:
    """Whether the fused page cursor (``io/fused.py``) replaces the
    materializing exact tier: ``PARQUET_TPU_TORCH_FUSED=on`` pins the
    cursor, ``off`` the materializing tier; ``auto`` (the default) keeps
    the JAX package's rule (fuse once ``est_bytes``, the bytes the exact
    tier would otherwise decode, reach :data:`FUSED_AUTO_MIN_BYTES`) on
    the CPU and in the host scan, and never fuses for a CUDA ``device``:
    the card decodes a contended span whole in one plan, where a page at
    a time would cost a pull a page."""
    from ..utils.env import env_str

    mode = env_str("PARQUET_TPU_TORCH_FUSED").strip().lower() or "auto"
    if mode in ("on", "1", "true", "always"):
        return True
    if mode in ("off", "0", "false", "never"):
        return False
    if device is not None:
        import torch

        if torch.device(device).type == "cuda":
            return False
    return int(est_bytes) >= FUSED_AUTO_MIN_BYTES


def _collect_preds(expr: Expr) -> List[Pred]:
    if isinstance(expr, Pred):
        return [expr]
    if isinstance(expr, (And, Or)):
        out = []
        for c in expr.children:
            out.extend(_collect_preds(c))
        return out
    return []


def _eval_tree(expr: Expr, leaf_fn) -> Tuple[bool, Optional[Pred]]:
    """The boolean fold with short-circuit: ``(may_match, killing
    leaf)``.  ``leaf_fn(pred) -> bool`` is conservative ("may this row
    group hold a matching row?")."""
    if isinstance(expr, Const):
        return expr.value, None
    if isinstance(expr, Pred):
        ok = leaf_fn(expr)
        return ok, (None if ok else expr)
    if isinstance(expr, And):
        for c in expr.children:
            ok, killer = _eval_tree(c, leaf_fn)
            if not ok:
                return False, killer
        return True, None
    assert isinstance(expr, Or), expr
    last = None
    for c in expr.children:
        ok, killer = _eval_tree(c, leaf_fn)
        if ok:
            return True, None
        last = killer if killer is not None else last
    return False, last


def _tree_intervals(expr: Expr, leaf_fn) -> Optional[_Intervals]:
    """Candidate row intervals through the tree (None: the whole row
    group, no leaf narrowed it)."""
    if isinstance(expr, Const):
        return None if expr.value else []
    if isinstance(expr, Pred):
        return leaf_fn(expr)
    if isinstance(expr, And):
        acc: Optional[_Intervals] = None
        for c in expr.children:
            got = _tree_intervals(c, leaf_fn)
            if got is None:
                continue
            acc = got if acc is None else _intersect_intervals(acc, got)
            if acc == []:
                return []
        return acc
    assert isinstance(expr, Or), expr
    acc = []
    for c in expr.children:
        got = _tree_intervals(c, leaf_fn)
        if got is None:
            return None
        acc.extend(got)
    return _merge_intervals(acc)


class ScanPlanner:
    """Plans filtered reads of one
    :class:`~parquet_tpu_torch.io.reader.ParquetFile` through the
    cascade; the bloom stage probes on ``device``.  Under a ``policy``
    with ``on_corrupt='skip_row_group'``, a row group whose statistics,
    page index or bloom filter cannot be read is skipped (``pruned_by``
    ``"corrupt"``) and recorded in ``report`` with its full row count;
    without one its located error raises."""

    def __init__(self, pf, device="cuda", policy=None, report=None):
        self.pf = pf
        self.device = device
        self.policy = policy
        self.report = report

    def any_match_stats(self, expr: Expr) -> bool:
        """May any row group match?  The statistics stage alone (no I/O),
        stopping at the first row group that survives it: the file-level
        prune of the dataset layer, on the same leaf probes as the
        cascade."""
        expr = prepare(expr, self.pf.schema)
        if isinstance(expr, Const):
            return expr.value and bool(self.pf.row_groups)
        for rg in self.pf.row_groups:
            alive, _ = _eval_tree(expr, lambda p: _stats_alive(p, rg))
            if alive:
                return True
        return False

    def plan(self, expr: Expr, use_bloom: bool = True,
             stages: Tuple[str, ...] = _CASCADE) -> ScanPlan:
        """Run the cascade over every row group.  ``stages``, a prefix of
        the cascade, says how deep it goes (the router plans with
        ``("stats",)``: no IO); ``use_bloom=False`` skips the bloom
        stage."""
        stages = tuple(stages)
        if stages != _CASCADE[:len(stages)]:
            raise ValueError(f"stages must be a prefix of {_CASCADE}, got "
                             f"{stages}")
        expr = prepare(expr, self.pf.schema)
        if not use_bloom:
            stages = tuple(s for s in stages if s != "bloom")
        single = self._single_positive(expr)
        counters: Dict[str, int] = {
            "rg_total": 0, "rg_pruned_stats": 0, "rg_pruned_pages": 0,
            "rg_pruned_bloom": 0, "rg_pruned_const": 0,
            "rg_skipped_corrupt": 0, "rg_survivors": 0,
            "stats_probes": 0, "page_probes": 0, "bloom_probes": 0,
            "pages_total": 0, "pages_selected": 0}
        rgs = self.pf.row_groups
        counters["rg_total"] = len(rgs)
        ctx_col = ",".join(sorted({p.path for p in _collect_preds(expr)})) \
            or None
        errors: Dict[int, Exception] = {}  # row group -> its data error
        decisions = []
        plan_span = (_trace.span("planner.plan", file=self.pf._path,
                                 stages=",".join(stages))
                     if _trace.TRACE_ENABLED else _trace.NULL_SPAN)
        with plan_span:  # a probe that raises still closes the span
            for rg in rgs:
                d = RowGroupDecision(rg.index, rg.num_rows)
                with self._guard(rg, d, ctx_col, errors):
                    self._plan_rg(rg, expr, d, counters, single,
                                  "pages" in stages)
                decisions.append(d)
            if "bloom" in stages and not isinstance(expr, Const):
                self._bloom_stage(rgs, expr, decisions, counters, ctx_col,
                                  errors)
        if errors:  # the first row group's error, or each recorded
            if not (self.policy is not None and self.policy.skip_corrupt):
                raise errors[min(errors)]
            if self.report is not None:
                for i in sorted(errors):
                    self.report.record_skip(i, rows=rgs[i].num_rows,
                                            error=errors[i])
        for d in decisions:
            if d.pruned_by is None:
                counters["rg_survivors"] += 1
            elif d.pruned_by == "corrupt":
                counters["rg_skipped_corrupt"] += 1
            else:
                counters[f"rg_pruned_{d.pruned_by}"] += 1
        # the plan's counters stay its own view; the registry (and the
        # op) accumulate them under planner.*
        for k, v in counters.items():
            if v:
                _maccount(_mcounter("planner." + _REGISTRY_KEY.get(k, k)),
                          v)
        return ScanPlan(self.pf, expr, decisions, counters, stages)

    @contextlib.contextmanager
    def _guard(self, rg, d: RowGroupDecision, ctx_col, errors):
        """A stage of one row group: a data error (located by
        ``read_context``) marks the row group corrupt and is kept in
        ``errors``; a deadline raises."""
        from ..errors import CorruptedError, DeadlineError
        from .faults import read_context

        try:
            with read_context(path=self.pf._path, row_group=rg.index,
                              column=ctx_col,
                              kinds=(CorruptedError, OSError)):
                yield
        except DeadlineError:
            raise
        except CorruptedError as e:
            errors.setdefault(rg.index, e)
            d.pruned_by = "corrupt"
            d.killer = None
            d.ranges = []

    @staticmethod
    def _single_positive(expr: Expr) -> Optional[Pred]:
        """The one positive range/IN leaf of a single-leaf tree, or
        None."""
        if isinstance(expr, Pred) and not expr.negated \
                and expr.kind in ("range", "in"):
            return expr
        return None

    def _plan_rg(self, rg, expr, d: RowGroupDecision,
                 counters: Dict[str, int], single: Optional[Pred],
                 pages: bool = True) -> None:
        """The statistics and (with ``pages``) page-index stages of one
        row group."""
        if isinstance(expr, Const):
            if expr.value:
                d.ranges = [(0, rg.num_rows)]
            else:
                d.pruned_by = "const"
            return
        def stats_probe(p: Pred) -> bool:
            counters["stats_probes"] += 1
            return _stats_alive(p, rg)

        alive, killer = _eval_tree(expr, stats_probe)
        if not alive:
            d.pruned_by = "stats"
            d.killer = repr(killer) if killer is not None else None
            return
        if not pages:
            d.ranges = [(0, rg.num_rows)]
        elif single is not None:
            self._pages_single(rg, single, d, counters)
        else:
            self._pages_tree(rg, expr, d, counters)

    def _bloom_stage(self, rgs, expr: Expr, decisions, counters,
                     ctx_col=None, errors=None) -> None:
        """Every surviving row group's equality leaves against its filters,
        all in one device probe; then the tree folded per row group.  A
        filter that cannot be read marks its row group corrupt."""
        from .bloom import check_hashes_multi

        eq = [p for p in _collect_preds(expr) if p.is_equality]
        if not eq:
            return
        keys, filters, batches = [], [], []
        for d in decisions:
            if d.pruned_by is not None:
                continue
            rg = rgs[d.rg_index]
            got = []
            with self._guard(rg, d, ctx_col, errors):
                for j, p in enumerate(eq):
                    bf = rg.column(p.leaf.column_index).bloom_filter()
                    hashes = _pred_hashes(p) if bf is not None else None
                    if hashes is not None:
                        got.append(((d.rg_index, j), bf, hashes))
            if d.pruned_by is None:
                for k, bf, hashes in got:
                    keys.append(k)
                    filters.append(bf)
                    batches.append(hashes)
        live = [d for d in decisions if d.pruned_by is None]
        hits = check_hashes_multi(filters, batches, self.device)
        verdict = {k: bool(h.any()) for k, h in zip(keys, hits)}
        slot = {id(p): j for j, p in enumerate(eq)}
        for d in live:
            rg = rgs[d.rg_index]

            def bloom_probe(p: Pred) -> bool:
                if not p.is_equality:
                    return True
                if rg.column(p.leaf.column_index).bloom_filter() is None:
                    return True
                counters["bloom_probes"] += 1
                return verdict.get((d.rg_index, slot[id(p)]), True)

            alive, killer = _eval_tree(expr, bloom_probe)
            if not alive:
                d.pruned_by = "bloom"
                d.killer = repr(killer) if killer is not None else None
                d.ranges = []

    def _pages_single(self, rg, pred: Pred, d: RowGroupDecision,
                      counters: Dict[str, int]) -> None:
        """The single-leaf page selection: the candidate range is the
        covering span of the selected pages (gaps included)."""
        from .search import (_npages, pages_overlapping,
                             pages_overlapping_values)

        chunk = rg.column(pred.leaf.column_index)
        ci = chunk.column_index()
        oi = chunk.offset_index()
        if ci is None or oi is None:
            d.ranges = [(0, rg.num_rows)]
            d._legacy = ("all", pred.leaf.column_index)
            return
        counters["page_probes"] += 1
        if pred.kind == "in":
            ords = pages_overlapping_values(ci, pred.leaf, pred.values)
        else:
            ords = pages_overlapping(ci, pred.leaf, pred.lo, pred.hi)
        n_pages = _npages(oi)
        counters["pages_total"] += n_pages
        counters["pages_selected"] += len(ords)
        d.page_sel[pred.path] = (len(ords), n_pages)
        if not ords:
            d.pruned_by = "pages"
            d.killer = repr(pred)
            return
        locs = oi.page_locations
        first_row = locs[ords[0]].first_row_index
        last = ords[-1]
        end_row = (locs[last + 1].first_row_index if last + 1 < len(locs)
                   else rg.num_rows)
        d.ranges = [(first_row, end_row)]
        d._legacy = (ords, first_row, end_row - first_row)

    def _pages_tree(self, rg, expr, d: RowGroupDecision,
                    counters: Dict[str, int]) -> None:
        def page_iv(p: Pred) -> Optional[_Intervals]:
            chunk = rg.column(p.leaf.column_index)
            ci = chunk.column_index()
            oi = chunk.offset_index()
            if ci is None or oi is None or not oi.page_locations:
                return None
            counters["page_probes"] += 1
            ords = _pred_page_ords(p, ci)
            locs = oi.page_locations
            n = len(locs)
            counters["pages_total"] += n
            counters["pages_selected"] += len(ords)
            prev = d.page_sel.get(p.path)
            if prev is None or len(ords) > prev[0]:
                d.page_sel[p.path] = (len(ords), n)
            iv = []
            for o in ords:
                s = locs[o].first_row_index
                e = (locs[o + 1].first_row_index if o + 1 < n
                     else rg.num_rows)
                iv.append((s, e))
            return _merge_intervals(iv)

        iv = _tree_intervals(expr, page_iv)
        if iv == []:
            d.pruned_by = "pages"
            return
        d.ranges = iv if iv is not None else [(0, rg.num_rows)]


# ---------------------------------------------------------------------------
# leaf probes
# ---------------------------------------------------------------------------


def _not_in_covers(sorted_vals, mn, mx) -> bool:
    """Does the sorted unique probe list cover every value in [mn, mx]?
    Provable for a constant span in any domain, and for an integer span
    the probes blanket (``vals[i0] == mn`` and ``vals[i0 + span] == mx``,
    one bisect); inconclusive (False) for anything else."""
    try:
        if mn == mx:
            return _bisect_contains(sorted_vals, mn)
        if isinstance(mn, bool) or isinstance(mx, bool) \
                or not isinstance(mn, (int, np.integer)) \
                or not isinstance(mx, (int, np.integer)):
            return False
        span = int(mx) - int(mn)
        i0 = bisect_left(sorted_vals, mn)
        if i0 + span >= len(sorted_vals):
            return False
        v0, v1 = sorted_vals[i0], sorted_vals[i0 + span]
        return v0 == mn and v1 == mx \
            and isinstance(v0, (int, np.integer)) \
            and not isinstance(v0, bool)
    except TypeError:
        return False


def _bisect_contains(sorted_vals, v) -> bool:
    i = bisect_left(sorted_vals, v)
    return i < len(sorted_vals) and sorted_vals[i] == v


def _stats_alive(pred: Pred, rg) -> bool:
    """May this row group hold a row matching ``pred``?  Inconclusive
    statistics answer True."""
    chunk = rg.column(pred.leaf.column_index)
    st = chunk.statistics()
    nv = chunk.meta.num_values
    null_count = st.null_count if st is not None else None
    if pred.kind == "null":
        if pred.leaf.max_definition_level == 0:
            return False  # a required column holds no null
        return null_count is None or null_count > 0
    if pred.kind == "notnull":
        return not (null_count is not None and nv is not None
                    and null_count >= nv)
    # range / in need a non-null value
    if null_count is not None and nv is not None and null_count >= nv:
        return False
    if st is None or st.min_value is None or st.max_value is None:
        return True
    mn, mx = st.min_value, st.max_value
    try:
        if pred.kind == "range":
            if not pred.negated:
                from .statistics import may_contain_range

                return may_contain_range(st, pred.lo, pred.hi)
            # negated: dead only when every value lies inside
            return not ((pred.lo is None or pred.lo <= mn)
                        and (pred.hi is None or mx <= pred.hi))
        from .search import _any_in_range

        if not pred.negated:
            return _any_in_range(pred.values, mn, mx)
        return not _not_in_covers(pred.values, mn, mx)
    except TypeError:
        return True  # a probe the bounds' domain cannot compare


def _tree_covers(expr: Expr, leaf_fn) -> bool:
    """The coverage dual of :func:`_eval_tree`: does ``expr`` provably
    match every row?  ``leaf_fn(pred)`` answers True only on proof; an And
    covers where all its children do, an Or where any does."""
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, Pred):
        return leaf_fn(expr)
    if isinstance(expr, And):
        return all(_tree_covers(c, leaf_fn) for c in expr.children)
    return any(_tree_covers(c, leaf_fn) for c in expr.children)


def _stats_covers(pred: Pred, rg) -> bool:
    """Do the row group's footer statistics prove that every row matches
    ``pred``?  (The answering dual of :func:`_stats_alive`.)"""
    chunk = rg.column(pred.leaf.column_index)
    st = chunk.statistics()
    if st is None:
        return False
    return _bounds_cover(pred, st.min_value, st.max_value, st.null_count,
                         chunk.meta.num_values)


def _pred_hashes(pred: Pred) -> Optional[np.ndarray]:
    """The bloom hashes of an equality leaf's probes, memoized on the
    leaf; None where they do not encode in the column's type (the probe
    is then inconclusive)."""
    if pred._hashes is None:
        from .bloom import probe_hashes

        vals = [pred.lo] if pred.kind == "range" else pred.values
        got = probe_hashes(pred.leaf, vals)
        pred._hashes = False if got is None else got
    return None if pred._hashes is False else pred._hashes


def _bounds_cover(pred: Pred, mn, mx, nulls, nv, page_rows=None) -> bool:
    """Do conservative [mn, mx] bounds and the null count prove that every
    row of the span matches ``pred``?  The dual of :func:`_stats_alive`.
    Stored bounds only ever widen a true span, and every proof here fails
    on a wider one, so a truncated bound never proves wrongly; a missing
    input proves nothing.  Float statistics drop NaN, so a positive value
    leaf on a float domain is never proved (a NaN row fails it); a negated
    one stays provable (a NaN row matches the negation)."""
    if pred.kind == "null":
        rows = page_rows if page_rows is not None else nv
        return nulls is not None and rows is not None and nulls >= rows \
            and rows > 0
    if pred.kind == "notnull":
        return nulls == 0
    if nulls != 0 or mn is None or mx is None:
        return False
    if not pred.negated and (isinstance(mn, float) or isinstance(mx, float)):
        return False
    try:
        if pred.kind == "range":
            if not pred.negated:
                return (pred.lo is None or pred.lo <= mn) and \
                    (pred.hi is None or mx <= pred.hi)
            return (pred.lo is not None and mx < pred.lo) or \
                (pred.hi is not None and mn > pred.hi)
        if not pred.negated:
            return _not_in_covers(pred.values, mn, mx)
        from .search import _any_in_range

        return not _any_in_range(pred.values, mn, mx)
    except TypeError:
        return False


def _pred_page_ords(pred: Pred, ci) -> List[int]:
    """Page ordinals that may hold a matching row, per leaf kind."""
    from .search import (decoded_bounds, pages_overlapping,
                         pages_overlapping_values)

    if not pred.negated and pred.kind == "range":
        return pages_overlapping(ci, pred.leaf, pred.lo, pred.hi)
    if not pred.negated and pred.kind == "in":
        return pages_overlapping_values(ci, pred.leaf, pred.values)
    nulls = list(ci.null_pages or [])
    n = len(nulls)
    if pred.kind == "null":
        ncounts = ci.null_counts
        return [i for i in range(n)
                if nulls[i] or ncounts is None or (ncounts[i] or 0) > 0]
    if pred.kind == "notnull":
        return [i for i in range(n) if not nulls[i]]
    # negated range / in: a page is dead when provably all inside
    mins, maxs = decoded_bounds(ci, pred.leaf)
    out = []
    for i in range(n):
        if nulls[i]:
            continue
        if i >= len(mins) or mins[i] is None or maxs[i] is None:
            out.append(i)
            continue
        try:
            if pred.kind == "in":
                dead = _not_in_covers(pred.values, mins[i], maxs[i])
            else:
                dead = ((pred.lo is None or pred.lo <= mins[i])
                        and (pred.hi is None or maxs[i] <= pred.hi))
        except TypeError:
            dead = False
        if not dead:
            out.append(i)
    return out


# ---------------------------------------------------------------------------
# What the device route refuses, known from the footer
# ---------------------------------------------------------------------------

#: the encodings the device route's plan can place on the card
_DEVICE_ENCODINGS = frozenset((
    Encoding.PLAIN, Encoding.RLE, Encoding.PLAIN_DICTIONARY,
    Encoding.RLE_DICTIONARY, Encoding.DELTA_BINARY_PACKED,
    Encoding.DELTA_LENGTH_BYTE_ARRAY, Encoding.DELTA_BYTE_ARRAY,
    Encoding.BYTE_STREAM_SPLIT))


def device_encoding_supported(pf, columns: Optional[Sequence[str]] = None
                              ) -> Tuple[bool, str]:
    """``(True, "")`` when every chunk of the selected leaves (those whose
    dotted path ``columns`` names; all by default) lists only encodings the
    device route places on the card, else ``(False, why)``: the footer's
    answer, before any byte of the file is staged.  Shapes seen only in the
    pages still take the host decode chunk by chunk (``HOST_ROUTE``)."""
    want = set(columns) if columns is not None else None
    for leaf in pf.schema.leaves:
        if want is not None and leaf.name not in want:
            continue
        for rg in pf.metadata.row_groups or []:
            for e in rg.columns[leaf.column_index].meta_data.encodings or []:
                try:
                    enc = Encoding(e)
                except ValueError:
                    return False, (f"column {leaf.name!r} carries unknown "
                                   f"encoding {e}")
                if enc not in _DEVICE_ENCODINGS:
                    return False, (f"column {leaf.name!r} carries encoding "
                                   f"{enc.name} with no device kernel")
    return True, ""


#: files and chunks the multi-file device read sent to the host decode:
#: ``unsupported`` (the footer lists an encoding the card does not decode,
#: or a chunk's plan refused it) and ``error`` (the file's staging raised
#: ``CorruptedError`` or ``OSError``)
ROUTE_REFUSALS = {"unsupported": 0, "error": 0}
_refusal_lock = threading.Lock()
# the closed label set of device.route_refusals: a reason outside it
# counts as "other", so no refusal mints a series nobody declared
_REFUSAL_REASONS = ("unsupported", "policy", "budget", "error", "other")
_REFUSAL_KEEP = 16  # the latest refusals' details kept for /debugz
_refusal_recent: List[Tuple[str, str]] = []


def count_device_refusal(reason: str, detail: str = "") -> None:
    """Count one refusal of the device route in :data:`ROUTE_REFUSALS`
    and ``device.route_refusals{reason=}``, and keep its detail for the
    ``/debugz`` routes section."""
    label = reason if reason in _REFUSAL_REASONS else "other"
    _maccount(_mcounter("device.route_refusals", labels={"reason": label}))
    with _refusal_lock:  # counted on the pool's workers
        ROUTE_REFUSALS[reason] += 1
        _refusal_recent.append((label, detail or reason))
        del _refusal_recent[:-_REFUSAL_KEEP]


def reset_route_refusals() -> None:
    with _refusal_lock:
        for k in ROUTE_REFUSALS:
            ROUTE_REFUSALS[k] = 0
        _refusal_recent.clear()


# ---------------------------------------------------------------------------
# The route half: host scan or device scan, by a cost model
# ---------------------------------------------------------------------------

# The cost model's priors, until the history has measured this process:
# GB/s of the plan's estimated compressed bytes, the scan's wall clock
# (staging included), from chip_smoke.py's phase 5e {"route_rates": ...}
# line on "NVIDIA H100 80GB HBM3, 700.00 W" (run DA in PERF.md): the
# median over cfg 5's range and IN-list and lineitem's Q6 dates of each
# route's best warm scan (host 0.506, device 1.364), the device's cold
# minus warm scan (0.0101 s), and its smallest case, 14,894,211 bytes,
# at which the device scan was already the faster (10.7 against 29.4 ms).
_HOST_PRIOR_GBPS = 0.5
_DEVICE_PRIOR_GBPS = 1.36
_DEVICE_FIXED_S = 0.01
_DEVICE_MIN_BYTES = 14 << 20
_POOL_MIN_CELLS = 2_000_000  # the host scan's serial/threaded crossover


@dataclass
class CostInputs:
    """Everything :func:`choose_route` looks at: pure data, so the routing
    is testable on stubbed inputs."""

    backend: str  # the scan device's kind: "cpu" | "gpu"
    supported: bool  # the device scan takes this shape (the footer's word)
    reason: str = ""  # why not, when it does not
    est_bytes: int = 0  # compressed bytes the scan will decode
    est_rows: int = 0  # candidate rows after the statistics stage
    total_rows: int = 0
    n_columns: int = 1  # filter + output columns
    reuse: int = 1  # expected reuses of the staged scan state
    host_gbps: Optional[float] = None  # measured (RouteHistory)
    device_gbps: Optional[float] = None
    pin: Optional[str] = None  # PARQUET_TPU_TORCH_ROUTE


@dataclass
class RouteDecision:
    route: str  # "host" | "device"
    reason: str
    pool_width: Optional[int] = None  # host fan-out: None auto, 1 serial
    est_host_s: Optional[float] = None
    est_device_s: Optional[float] = None
    est_bytes: int = 0  # what the history observes against the wall time


def route_history() -> "RouteHistory":
    """The process-wide history of measured scan rates the router reads."""
    return _HISTORY


class RouteHistory:
    """An EWMA of each route's measured scan rate, bucketed by (route,
    mesh size): the router starts from its priors and converges on what
    this host and card do.  Rates are the router's own byte estimate over
    the wall time (both routes observe the same estimate for the same
    scan, so they compare even where the estimate is off), and a device
    observation includes its staging, so :func:`choose_route` drops the
    fixed-cost prior once a device rate is measured.  ``pool_wait_s``, the
    time the scan's tasks queued on the shared pool, discounts a route's
    effective rate by the share of its wall time spent waiting."""

    def __init__(self, alpha: float = 0.3):
        self._lock = threading.Lock()
        self._alpha = alpha
        self._gbps: Dict[str, float] = {}
        self._wait_frac: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    @staticmethod
    def _key(route: str, mesh_size: int) -> str:
        """The bucket of (route, mesh size); mesh size 1 is the bare
        route name."""
        return route if mesh_size <= 1 else f"{route}@{mesh_size}"

    def observe(self, route: str, nbytes: int, seconds: float,
                pool_wait_s: float = 0.0, mesh_size: int = 1) -> None:
        """Fold one scan in; a scan under :data:`_DEVICE_MIN_BYTES` is
        dominated by its fixed cost and is left out."""
        if seconds <= 0 or nbytes < _DEVICE_MIN_BYTES:
            return
        gbps = nbytes / seconds / 1e9
        wf = min(max(pool_wait_s, 0.0) / seconds, 0.95)
        key = self._key(route, mesh_size)
        a = self._alpha
        with self._lock:
            cur = self._gbps.get(key)
            self._gbps[key] = gbps if cur is None else (1 - a) * cur + a * gbps
            curw = self._wait_frac.get(key)
            self._wait_frac[key] = wf if curw is None else \
                (1 - a) * curw + a * wf
            self._n[key] = self._n.get(key, 0) + 1
            eff = self._gbps[key] * (1.0 - self._wait_frac[key])
        # the label is the bucket key: a mesh size's series stays apart
        _mgauge("route.gbps", labels={"route": key}).set(round(eff, 4))
        _maccount(_mcounter("route.observations", labels={"route": key}))

    def gbps(self, route: str, mesh_size: int = 1) -> Optional[float]:
        """The effective rate: the EWMA discounted by the EWMA wait
        share; None before the first observation."""
        key = self._key(route, mesh_size)
        with self._lock:
            g = self._gbps.get(key)
            if g is None:
                return None
            return g * (1.0 - self._wait_frac.get(key, 0.0))

    def observations(self, route: str, mesh_size: int = 1) -> int:
        with self._lock:
            return self._n.get(self._key(route, mesh_size), 0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Each bucket's effective rate and observations (``/debugz``)."""
        with self._lock:
            return {k: {"gbps": round(
                self._gbps[k] * (1.0 - self._wait_frac.get(k, 0.0)), 4),
                "observations": self._n.get(k, 0)}
                for k in sorted(self._gbps)}

    def reset(self) -> None:
        with self._lock:
            self._gbps.clear()
            self._wait_frac.clear()
            self._n.clear()


_HISTORY = RouteHistory()
_PIN_NAME = "PARQUET_TPU_TORCH_ROUTE"

# plan-counter key -> registry name where they differ (Prometheus appends
# _total to a counter: rg_total would render as ..._rg_total_total)
_REGISTRY_KEY = {"rg_total": "rg_considered", "pages_total":
                 "pages_considered"}


def choose_route(inp: CostInputs) -> RouteDecision:
    """Host or device, and the host scan's pool width, from the cost
    inputs: a pure function of ``inp``."""
    cells = inp.est_rows * max(inp.n_columns, 1)
    width = 1 if cells < _POOL_MIN_CELLS else None
    if inp.pin in ("host", "device"):
        if inp.pin == "device" and not inp.supported:
            return RouteDecision("host", f"{_PIN_NAME}=device pinned but "
                                 f"shape unsupported: {inp.reason}", width)
        return RouteDecision(inp.pin, f"{_PIN_NAME}={inp.pin} pin",
                             width if inp.pin == "host" else None)
    if inp.backend == "cpu":
        return RouteDecision(
            "host", "cpu backend: the threaded host scan beats the device "
            "scan's plain versions", width)
    if not inp.supported:
        return RouteDecision("host", f"device route unsupported: "
                             f"{inp.reason}", width)
    if inp.est_bytes < _DEVICE_MIN_BYTES:
        return RouteDecision(
            "host", f"plan too small ({inp.est_bytes} bytes) to amortize "
            "H2D staging", width)
    host_s = inp.est_bytes / ((inp.host_gbps or _HOST_PRIOR_GBPS) * 1e9)
    dev_s = inp.est_bytes / ((inp.device_gbps or _DEVICE_PRIOR_GBPS) * 1e9)
    if inp.device_gbps is None:  # a measured rate holds the fixed cost
        dev_s += _DEVICE_FIXED_S / max(inp.reuse, 1)
    if dev_s <= host_s:
        return RouteDecision(
            "device", f"cost model: device {dev_s * 1e3:.1f}ms <= host "
            f"{host_s * 1e3:.1f}ms", None, host_s, dev_s)
    return RouteDecision(
        "host", f"cost model: host {host_s * 1e3:.1f}ms < device "
        f"{dev_s * 1e3:.1f}ms", width, host_s, dev_s)


def device_route_supported(pf, path: str, columns: Optional[Sequence[str]],
                           values: Optional[Sequence] = None
                           ) -> Tuple[bool, str]:
    """The device scan's refusals (``parallel/host_scan.py::_check_key``)
    answered from the footer alone, plus a byte-array key chunk without
    a dictionary encoding: ``(True, "")`` or ``(False, why)``.  Shapes
    seen only in the pages (a dictionary that falls back to PLAIN
    mid-chunk) pass here; ``stage_scan`` refuses them and the routed scan
    falls back to the host scan."""
    from ..format.enums import Type
    from ..schema.types import LogicalKind

    flat = {leaf.name for leaf in pf.schema.leaves
            if leaf.max_repetition_level == 0}
    out_cols = list(columns) if columns is not None else sorted(flat - {path})
    for c in [path] + out_cols:
        if c not in flat:
            return False, f"column {c!r} is nested or unknown"
    key = pf.schema.leaf(path)
    t = key.physical_type
    if t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        return False, f"key {path!r} has physical type {t.name}"
    if t == Type.BYTE_ARRAY and key.logical_kind == LogicalKind.DECIMAL:
        return False, f"key {path!r} is a decimal byte array"
    if values is not None and t in (Type.INT64, Type.DOUBLE):
        return False, f"IN-list on 64-bit key {path!r}"
    if t == Type.BYTE_ARRAY:
        for rg in pf.metadata.row_groups or []:
            encs = rg.columns[key.column_index].meta_data.encodings or []
            if not any(e in _DICT_ENCODING_IDS for e in encs):
                return False, f"key {path!r} has a non-dictionary chunk"
    return True, ""


_DICT_ENCODING_IDS = frozenset((int(Encoding.PLAIN_DICTIONARY),
                                int(Encoding.RLE_DICTIONARY)))


def route_scan(pf, path: str, lo=None, hi=None,
               columns: Optional[Sequence[str]] = None,
               values: Optional[Sequence] = None, device="cuda",
               backend: Optional[str] = None,
               reuse: int = 1) -> RouteDecision:
    """Route one single-column scan: :class:`CostInputs` from the footer
    (a statistics-only plan, no IO) and :data:`route_history`, then
    :func:`choose_route`.  ``backend`` is ``"cpu"`` for a CPU ``device``
    and ``"gpu"`` for a card; a test may name it."""
    from ..algebra.expr import single_pred
    from .reader import resolve_device

    if backend is None:
        backend = "cpu" if resolve_device(device).type == "cpu" else "gpu"
    pin = _route_pin()
    if pin == "host" or (backend == "cpu" and pin is None):
        # choose_route answers host here whatever the inputs: skip them
        reason = (f"{_PIN_NAME}=host pin" if pin == "host" else
                  "cpu backend: the threaded host scan beats the device "
                  "scan's plain versions")
        _maccount(_mcounter("route.chosen", labels={"route": "host"}))
        return RouteDecision("host", reason)
    try:
        supported, reason = device_route_supported(pf, path, columns, values)
    except KeyError as e:
        supported, reason = False, f"unknown column {e}"
    est_bytes = est_rows = 0
    flat = {leaf.name for leaf in pf.schema.leaves
            if leaf.max_repetition_level == 0}
    out_cols = list(columns) if columns is not None else sorted(flat - {path})
    try:
        plan = ScanPlanner(pf, device="cpu").plan(
            single_pred(path, lo, hi, values), stages=("stats",))
        est_rows = plan.candidate_rows
        est_bytes = plan.est_bytes(out_cols)
    except (KeyError, ValueError):
        pass  # the scan itself raises the precise error
    h = _HISTORY
    decision = choose_route(CostInputs(
        backend=backend, supported=supported, reason=reason,
        est_bytes=est_bytes, est_rows=est_rows, total_rows=pf.num_rows,
        n_columns=1 + len(out_cols), reuse=reuse,
        host_gbps=h.gbps("host"), device_gbps=h.gbps("device"), pin=pin))
    decision.est_bytes = est_bytes
    _maccount(_mcounter("route.chosen", labels={"route": decision.route}))
    return decision


def _route_pin() -> Optional[str]:
    from ..utils.env import env_str

    v = env_str(_PIN_NAME).lower()
    if v in ("host", "cpu"):
        return "host"
    if v in ("device", "cuda"):
        return "device"
    return None


def _routes_debugz() -> Dict[str, object]:
    """``/debugz``'s "routes" section: the measured rate of each (route,
    mesh size) beside the latest device-route refusals."""
    with _refusal_lock:
        recent = [{"reason": r, "detail": d} for r, d in _refusal_recent]
    return {"history": _HISTORY.snapshot(), "refusals_recent": recent}


_register_debugz("routes", _routes_debugz)
