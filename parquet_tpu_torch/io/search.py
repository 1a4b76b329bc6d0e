"""Page-index search and predicate pushdown.

The port's cut of ``parquet_tpu/io/search.py``: :func:`find` (the
reference's ``parquet.Find``), :func:`pages_overlapping` and
:func:`pages_overlapping_values` over a ``ColumnIndex`` whose bounds
:func:`decoded_bounds` decodes once per chunk; :func:`prune_file`, a
whole file ruled out by its footer's statistics, and
:func:`prune_row_group` and :func:`prune_row_group_values`, a row group
by its chunk's statistics and bloom filter; :func:`plan_scan`, the
batch pushdown plan of a single-column predicate (one :class:`PagePlan`
a surviving row group, from the planner's cascade in ``io/planner.py``);
the seek of a row span, :func:`seek_pages` and :func:`pages_and_base`
(with :func:`dictionary_pages`, the dictionary half of a seek); and
:func:`read_row_range`, a column's rows decoded from just the pages
that cover them (a flat column's on the host; a nested column's with its
level streams, cut at the exact rows).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..algebra.compare import normalize
from ..format import metadata as md
from ..format.enums import BoundaryOrder, Encoding, PageType, Type
from ..schema.schema import Leaf
from .statistics import decode_stat_value

_DICT_ENCODINGS = {Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY}


def decoded_bounds(column_index: md.ColumnIndex, leaf: Leaf):
    """Per-page ``(mins, maxs)`` in the leaf's order domain, memoized on
    the parsed index (which the chunk reader memoizes in turn)."""
    got = getattr(column_index, "_decoded_bounds", None)
    if got is None:
        got = ([decode_stat_value(m, leaf)
                for m in (column_index.min_values or [])],
               [decode_stat_value(m, leaf)
                for m in (column_index.max_values or [])])
        column_index._decoded_bounds = got
    return got


def find(column_index: md.ColumnIndex, value, leaf: Leaf) -> int:
    """First page ordinal whose [min, max] may contain ``value`` (the
    number of pages when none can): a binary search where the boundary
    order allows, else a linear scan."""
    value = normalize(leaf, value)
    n = len(column_index.null_pages or [])
    mins, maxs = decoded_bounds(column_index, leaf)
    order = BoundaryOrder(column_index.boundary_order or 0)
    nulls = column_index.null_pages or [False] * n

    def may_contain(i: int) -> bool:
        if nulls[i]:
            return False
        return mins[i] <= value <= maxs[i]

    if order == BoundaryOrder.ASCENDING:
        lo, hi = 0, n  # first page with max >= value
        while lo < hi:
            mid = (lo + hi) // 2
            if nulls[mid] or maxs[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        return lo if lo < n and may_contain(lo) else n
    if order == BoundaryOrder.DESCENDING:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if nulls[mid] or mins[mid] > value:
                lo = mid + 1
            else:
                hi = mid
        return lo if lo < n and may_contain(lo) else n
    for i in range(n):
        if may_contain(i):
            return i
    return n


def pages_overlapping(column_index: md.ColumnIndex, leaf: Leaf,
                      lo=None, hi=None) -> List[int]:
    """Every page ordinal whose [min, max] meets [lo, hi] (None = open)."""
    lo, hi = normalize(leaf, lo), normalize(leaf, hi)
    n = len(column_index.null_pages or [])
    mins, maxs = decoded_bounds(column_index, leaf)
    nulls = column_index.null_pages or [False] * n
    out = []
    for i in range(n):
        if nulls[i]:
            continue
        if mins[i] is None or maxs[i] is None:
            out.append(i)
            continue
        if lo is not None and maxs[i] < lo:
            continue
        if hi is not None and mins[i] > hi:
            continue
        out.append(i)
    return out


def _any_in_range(sorted_vals: List, lo, hi) -> bool:
    """Does the sorted probe list meet [lo, hi]?  (None bound = open.)"""
    if not sorted_vals:
        return False
    i = 0 if lo is None else bisect_left(sorted_vals, lo)
    return i < len(sorted_vals) and (hi is None or sorted_vals[i] <= hi)


def pages_overlapping_values(column_index: md.ColumnIndex, leaf: Leaf,
                             sorted_vals: List) -> List[int]:
    """Page ordinals whose [min, max] holds at least one probe value."""
    n = len(column_index.null_pages or [])
    mins, maxs = decoded_bounds(column_index, leaf)
    nulls = column_index.null_pages or [False] * n
    out = []
    for i in range(n):
        if nulls[i]:
            continue
        if mins[i] is None or maxs[i] is None or _any_in_range(
                sorted_vals, mins[i], maxs[i]):
            out.append(i)
    return out


def page_row_spans(oi: md.OffsetIndex, num_rows: int
                   ) -> List[Tuple[int, int]]:
    """Each page's local ``[start, end)`` rows from the offset index (the
    last page ends at the row group's ``num_rows``)."""
    locs = oi.page_locations or []
    out = []
    for i, pl in enumerate(locs):
        end = locs[i + 1].first_row_index if i + 1 < len(locs) else num_rows
        out.append((pl.first_row_index, end))
    return out


def pred_cover_page_ords(pred, column_index: md.ColumnIndex, leaf: Leaf,
                         spans: List[Tuple[int, int]]) -> List[int]:
    """The page ordinals whose zone maps prove that every row matches
    ``pred``: the answering dual of :func:`pages_overlapping`, which the
    aggregation cascade counts and bounds without decoding.  A missing
    null count proves nothing."""
    from .planner import _bounds_cover

    nulls = list(column_index.null_pages or [])
    ncounts = column_index.null_counts
    mins, maxs = decoded_bounds(column_index, leaf)
    out = []
    for i in range(len(nulls)):
        rows = spans[i][1] - spans[i][0]
        if pred.kind == "null" and nulls[i] and rows > 0:
            out.append(i)  # a declared null page holds only nulls
            continue
        nc = None if ncounts is None else ncounts[i]
        mn = mins[i] if i < len(mins) else None
        mx = maxs[i] if i < len(maxs) else None
        if nulls[i]:
            mn = mx = None  # a null page carries no value bounds
        if _bounds_cover(pred, mn, mx, nc, rows, page_rows=rows):
            out.append(i)
    return out


@dataclass
class PagePlan:
    """The selected pages of one chunk: which page ordinals to decode and
    the rows they cover."""

    rg_index: int
    page_ordinals: List[int]
    first_row: int  # first row of the first selected page, in its group
    row_count: int


def plan_scan(pf, path, lo=None, hi=None, use_bloom: bool = False,
              values: Optional[Sequence] = None,
              device="cuda", policy=None, report=None) -> List[PagePlan]:
    """The batch pushdown plan of ``lo <= file[path] <= hi`` (or, with
    ``values``, ``file[path] in values``): for each surviving row group,
    the page ordinals whose zone maps meet the predicate.  The predicate
    becomes a one-leaf tree and the planner (``io/planner.py``) runs its
    cascade (statistics -> page index -> bloom); with ``use_bloom`` the
    bloom stage probes every surviving row group's filter on ``device``
    in one batch.  Planning reads the column and offset indexes and the
    filters, never a data page; under ``policy``'s
    ``on_corrupt='skip_row_group'`` a row group whose index structures are
    corrupt is skipped and recorded in ``report``
    (:class:`~parquet_tpu_torch.io.planner.ScanPlanner`)."""
    from ..algebra.expr import single_pred
    from .planner import ScanPlanner
    from .reader import resolve_device

    planner = ScanPlanner(pf, device=resolve_device(device), policy=policy,
                          report=report)
    return planner.plan(single_pred(path, lo=lo, hi=hi, values=values),
                        use_bloom=use_bloom).page_plans()


def _chunk_of(rg, path):
    if isinstance(path, int):
        return rg.column(path)
    if isinstance(path, Leaf):
        path = path.name
    return rg.column(rg.file.schema.leaf(path).column_index)


def prune_row_group(rg, path, lo=None, hi=None, use_bloom: bool = False,
                    equals=None, device="cuda") -> bool:
    """True when row group ``rg`` may hold a row with ``lo <= path <= hi``
    (and, with ``equals``, ``path == equals``), by the chunk's statistics;
    with ``use_bloom`` an ``equals`` probe also asks its bloom filter,
    through ``check_hashes_batch`` on ``device`` (one hash takes the host
    probe).  A probe that does not encode in the column's type is
    inconclusive (True)."""
    from .bloom import probe_hashes
    from .statistics import may_contain_range

    chunk = _chunk_of(rg, path)
    lo, hi = normalize(chunk.leaf, lo), normalize(chunk.leaf, hi)
    equals = normalize(chunk.leaf, equals)
    st = chunk.statistics()
    if not may_contain_range(st, lo, hi):
        return False
    if equals is not None and not may_contain_range(st, equals, equals):
        return False
    if use_bloom and equals is not None:
        bf = chunk.bloom_filter()
        h = None if bf is None else probe_hashes(chunk.leaf, [equals])
        if h is not None and not bf.check_hashes_batch(
                h, device=device).any():
            return False
    return True


def prune_row_group_values(rg, path, sorted_vals: List,
                           hashes: Optional[np.ndarray] = None,
                           device="cuda") -> bool:
    """IN-list pruning: True when row group ``rg`` may hold one of
    ``sorted_vals``.  The statistics meet the sorted probes (one bisect);
    with ``hashes`` (the probes' xxh64) the bloom filter is probed for the
    whole batch at once by ``check_hashes_batch`` on ``device``: a batch
    of at least ``SplitBlockFilter._DEVICE_PROBE_MIN`` hashes launches
    ``bloom_check`` there."""
    chunk = _chunk_of(rg, path)
    st = chunk.statistics()
    if st is not None and st.min_value is not None \
            and st.max_value is not None:
        if not _any_in_range(sorted_vals, st.min_value, st.max_value):
            return False
    if hashes is not None:
        bf = chunk.bloom_filter()
        if bf is not None and not bf.check_hashes_batch(
                hashes, device=device).any():
            return False
    return True


def prune_file(pf, path=None, lo=None, hi=None,
               values: Optional[Sequence] = None, where=None) -> bool:
    """True when any row group of the file may hold a matching row, by the
    footer's chunk statistics alone (no I/O): the planner's statistics
    stage (``ScanPlanner.any_match_stats``), the dataset layer's file
    prune.  ``where`` takes a predicate tree in place of the
    single-column ``path``/``lo``/``hi``/``values`` form."""
    from .planner import ScanPlanner

    return ScanPlanner(pf).any_match_stats(
        _as_expr(path, lo, hi, values, where))


def _as_expr(path, lo, hi, values, where):
    """One predicate tree from either calling convention."""
    from ..algebra.expr import single_pred

    if where is not None:
        if path is not None or lo is not None or hi is not None \
                or values is not None:
            raise ValueError("pass either where= (a predicate tree) or the "
                             "single-column path/lo/hi/values form, not both")
        return where
    if path is None:
        raise ValueError("need a predicate: where= or path (+ lo/hi/values)")
    if isinstance(path, Leaf):
        path = path.name
    return single_pred(path, lo=lo, hi=hi, values=values)


def _npages(oi) -> int:
    return len(oi.page_locations) if oi and oi.page_locations else 0


def pages_and_base(chunk, row_start: int, row_end: int):
    """The pages covering rows ``[row_start, row_end)`` of a chunk (its
    dictionary page first) and the first row the selection starts at,
    the base of a caller's trim."""
    pages = list(seek_pages(chunk, row_start, row_end))
    first = 0
    oi = chunk.offset_index()
    if oi is not None and oi.page_locations:
        firsts = [pl.first_row_index for pl in oi.page_locations]
        first = firsts[max(bisect_right(firsts, row_start) - 1, 0)]
    return pages, first


def seek_pages(chunk, row_start: int, row_end: int):
    """Yield the dictionary page (if any) and the data pages covering rows
    ``[row_start, row_end)``: one read of the selected pages' bytes through
    the offset index, or every page of a chunk without one."""
    oi = chunk.offset_index()
    if oi is None or not oi.page_locations:
        yield from chunk.pages()
        return
    locs = oi.page_locations
    firsts = [pl.first_row_index for pl in locs]
    i0 = max(bisect_right(firsts, row_start) - 1, 0)
    i1 = min(bisect_left(firsts, row_end, lo=i0), len(locs))
    if i1 <= i0:
        return
    yield from dictionary_pages(chunk, locs[0].offset)
    span_start = locs[i0].offset
    span_len = (locs[i1 - 1].offset + locs[i1 - 1].compressed_page_size
                - span_start)
    yield from chunk.pages_at(span_start, span_len, num_pages=i1 - i0)


#: tag of the columnar byte-array form of :func:`read_row_range`:
#: ``("ba_arrays", uint8 values, int64 offsets)``
BA_ARRAYS = "ba_arrays"


def read_row_range(pf, path, row_start: int, row_count: int,
                   aligned=False):
    """Rows ``[row_start, row_start + row_count)`` of the column ``path``,
    decoded from only the pages that cover them.  A flat column on the
    host: ``aligned=False`` gives the present values (numpy; a list of
    ``bytes`` for byte arrays), ``aligned=True`` ``(values, validity)``
    with one entry a row, a null holding 0 (``None`` for byte arrays),
    ``validity`` None where the span has no null, and
    ``aligned="arrays"`` the same with a byte-array span as
    ``("ba_arrays", values, offsets)`` over its present values.  A nested
    column (``aligned`` refused) gives a :class:`Column` on the CPU of
    exactly those rows: its level streams decoded with the span, cut at
    row starts (``rep == 0``) and assembled again."""
    from .reader import decode_chunk_host

    leaf = pf.schema.leaf(path)
    nested = leaf.max_repetition_level > 0
    if aligned and nested:
        raise ValueError("aligned=True is only defined for flat columns")
    parts = []
    start, remaining = row_start, row_count
    for rg in pf.row_groups:
        if remaining <= 0:
            break
        if start >= rg.num_rows:
            start -= rg.num_rows
            continue
        take = min(rg.num_rows - start, remaining)
        chunk = rg.column(leaf.column_index)
        pages, first = pages_and_base(chunk, start, start + take)
        if nested:
            from ..parallel.device_reader import decode_chunk_span

            col = decode_chunk_span(chunk, "cpu", pages=pages,
                                    keep_levels=True)
            parts.append(_trim_nested(col, start - first, take))
        else:
            col = decode_chunk_host(chunk, "cpu", pages=pages)
            parts.append(_trim_host(col, start - first, take, aligned))
        start = 0
        remaining -= take
    if nested:
        from .column import concat_columns

        return (concat_columns(parts) if parts
                else _nested_column(leaf, np.zeros(0, np.int32),
                                    np.zeros(0, np.int32), None, None))
    return _concat_ranges(leaf, parts, aligned)


def _trim_nested(col, offset: int, count: int):
    """Rows ``[offset, offset + count)`` of a nested span decoded with its
    level streams: the streams cut at row starts, the dense values to the
    matching span, the lists assembled again for just those rows."""
    rep = np.asarray(col.rep_levels)
    d = np.asarray(col.def_levels)
    starts = np.flatnonzero(rep == 0)
    s0 = int(starts[offset]) if offset < len(starts) else len(rep)
    s1 = (int(starts[offset + count]) if offset + count < len(starts)
          else len(rep))
    present = d == col.leaf.max_definition_level
    v0 = int(np.count_nonzero(present[:s0]))
    v1 = v0 + int(np.count_nonzero(present[s0:s1]))
    col.materialize()
    values = col.values.numpy()
    if col.offsets is not None:
        offs = col.offsets.numpy()
        return _nested_column(col.leaf, d[s0:s1], rep[s0:s1],
                              values[offs[v0]:offs[v1]],
                              offs[v0:v1 + 1] - offs[v0])
    return _nested_column(col.leaf, d[s0:s1], rep[s0:s1], values[v0:v1],
                          None)


def _nested_column(leaf, d, r, values, offsets):
    """A CPU :class:`Column` of a nested leaf from its level streams and
    dense values (None: no value)."""
    import torch

    from ..ops import levels
    from ..schema.types import empty_values
    from .column import Column

    cpu = torch.device("cpu")
    asm = levels.assemble(d, r, leaf)
    if values is None:
        vals = empty_values(leaf.physical_type, leaf.type_length, cpu)
        if leaf.physical_type == Type.BYTE_ARRAY:
            offsets = np.zeros(1, np.int64)
    else:
        vals = torch.from_numpy(np.array(values, copy=True))

    def put(a):
        return None if a is None else torch.from_numpy(np.array(a,
                                                                copy=True))

    return Column(leaf=leaf, values=vals, offsets=put(offsets),
                  validity=put(asm.validity), num_slots=len(d),
                  list_offsets=[put(o) for o in asm.list_offsets],
                  list_validity=[put(v) for v in asm.list_validity],
                  def_levels=np.asarray(d, np.int32),
                  rep_levels=np.asarray(r, np.int32))


def _trim_host(col, offset: int, count: int, aligned):
    """Rows ``[offset, offset + count)`` of a host-decoded flat span in
    :func:`read_row_range`'s ``aligned`` form."""
    got = col.materialize_host()
    if isinstance(got, dict):  # a struct chain's leaf keeps its levels
        got = got["values"]
    validity = None if col.validity is None else col.validity.cpu().numpy()
    if not isinstance(got, tuple):  # fixed width
        vals, vmask = _trim_flat_aligned(got, validity, offset, count)
        if aligned:
            return vals, vmask
        return vals if vmask is None else vals[vmask]
    values, offs = got
    offs = np.asarray(offs, np.int64)
    vmask = None if validity is None else validity[offset:offset + count]
    v0 = offset if validity is None else int(np.count_nonzero(
        validity[:offset]))
    v1 = v0 + (count if vmask is None else int(np.count_nonzero(vmask)))
    if aligned == "arrays":
        base = int(offs[v0])
        return ((BA_ARRAYS, values[base:int(offs[v1])],
                 offs[v0:v1 + 1] - base), vmask)
    items = [values[offs[i]:offs[i + 1]].tobytes() for i in range(v0, v1)]
    if not aligned:
        return items
    if vmask is None:
        return items, None
    out = [None] * count
    for p, v in zip(np.flatnonzero(vmask).tolist(), items):
        out[p] = v
    return out, vmask


def _concat_ranges(leaf, parts: list, aligned):
    """:func:`read_row_range`'s row-group parts as one."""
    ba = leaf.physical_type == Type.BYTE_ARRAY
    if not aligned:
        if ba:
            return [v for p in parts for v in p]
        if not parts:
            return _empty_host(leaf)
        return np.concatenate(parts)
    if not parts:
        if ba and aligned == "arrays":
            return ((BA_ARRAYS, np.zeros(0, np.uint8),
                     np.zeros(1, np.int64)), None)
        return ([] if ba else _empty_host(leaf)), None
    vparts = [p[0] for p in parts]
    if ba and aligned == "arrays":
        offs, base = [np.zeros(1, np.int64)], 0
        for _, v, o in vparts:
            offs.append(o[1:] + base)
            base += int(o[-1])
        vals = (BA_ARRAYS, np.concatenate([v for _, v, _ in vparts]),
                np.concatenate(offs))
        lens = [len(o) - 1 for _, _, o in vparts]
    elif ba:
        vals = [v for p in vparts for v in p]
        lens = [len(p) for p in vparts]
    else:
        vals = np.concatenate(vparts)
        lens = [len(p) for p in vparts]
    if all(p[1] is None for p in parts):
        return vals, None
    return vals, np.concatenate([p[1] if p[1] is not None
                                 else np.ones(n, bool)
                                 for p, n in zip(parts, lens)])


def _empty_host(leaf) -> np.ndarray:
    from ..schema.types import PHYSICAL_NP_DTYPE

    if leaf.physical_type == Type.FIXED_LEN_BYTE_ARRAY:
        return np.zeros((0, leaf.type_length or 0), np.uint8)
    if leaf.physical_type == Type.INT96:
        return np.zeros((0, 3), np.int32)
    return np.zeros(0, PHYSICAL_NP_DTYPE[leaf.physical_type])


def dictionary_pages(chunk, first_data_offset: int):
    """Yield the chunk's dictionary page, if it has one, given the offset
    of its first data page."""
    m = chunk.meta
    dict_off = m.dictionary_page_offset
    if dict_off is not None and 0 < dict_off < first_data_offset:
        yield from chunk.pages_at(dict_off, first_data_offset - dict_off)
    elif dict_off is None and any(Encoding(e) in _DICT_ENCODINGS
                                  for e in (m.encodings or [])):
        # a writer may leave dictionary_page_offset out: walk the headers
        for p in chunk.pages():
            if p.page_type == PageType.DICTIONARY_PAGE:
                yield p
                break


def _trim_flat_aligned(values: np.ndarray, validity: Optional[np.ndarray],
                       offset: int, count: int
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Rows ``[offset, offset + count)`` of a decoded flat span (dense
    present ``values``, per-slot ``validity`` or None) as row-aligned
    ``(values, validity)``: a null slot holds a zero fill."""
    if validity is None:
        return values[offset:offset + count], None
    validity = np.asarray(validity, bool)
    vmask = validity[offset:offset + count]
    vstart = int(np.count_nonzero(validity[:offset]))
    vend = vstart + int(np.count_nonzero(vmask))
    out = np.zeros((int(count),) + values.shape[1:], values.dtype)
    out[vmask] = values[vstart:vend]
    return out, vmask
