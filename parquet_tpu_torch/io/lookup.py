"""Batched point lookups: the rows where a column equals each of many keys.

The port of ``parquet_tpu/io/lookup.py::find_rows`` for flat
INT32/INT64/FLOAT/DOUBLE key columns.  Each row group runs the reference's
cheapest-first cascade, with the same counters:

1. chunk statistics (no IO): keys outside [min, max], and every key of an
   all-null chunk, are pruned;
2. the bloom filter, probed once with the hashes of every surviving key.
   Stages 1 and 2 run over every row group first, so that the row groups
   whose batch has 32,768 hashes or more are probed together: one
   :func:`~parquet_tpu_torch.io.bloom.check_hashes_multi`, one launch of
   the ``bloom_check`` CUDA kernel per lookup on the lookup's device; a
   smaller batch takes the numpy probe, as in the reference;
3. the page index: a binary search (:func:`~.search.find`) per key on a
   cleanly ordered index, the zone-map walk otherwise;
4. page reads: the needed pages of a chunk coalesce into runs of adjacent
   pages, one pread per run (and one for the dictionary, once per chunk),
   each run decoded on the lookup's device
   (:mod:`~parquet_tpu_torch.parallel.device_reader`, whose dictionary
   columns launch the read path's kernels) and copied back to host numpy
   row-aligned, then matched exactly (an in-page binary search where the
   row group declares its rows sorted by the key, else
   :func:`~parquet_tpu_torch.parallel.host_scan.aligned_key_mask`).

A chunk without a page index decodes whole (``chunk_fallbacks``).  The
requested output columns are read through the same coalesced page runs.
Where the reference loops over keys in Python, the statistics stage, the
page search of a cleanly ordered numeric index and the gather of output
values run on numpy arrays of keys instead; survivors, stage order and
counters are the reference's.

Keys of an unsigned column (the INT annotation's ``signed=false``)
compare in unsigned order at every stage, and a ``Decimal`` key of a
decimal stored as INT32/INT64 compares as its unscaled integer.

Not in this port: the page cache and the negative-lookup memo, admission
control, fault policies, metrics and op scopes, key sharding across
workers, dataset lookups, and BYTE_ARRAY / FLBA / BOOLEAN keys (decimals
stored as byte arrays among them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import unsupported
from ..format.enums import BoundaryOrder, Type
from ..schema.types import NUMERIC, PHYSICAL_NP_DTYPE

__all__ = ["KeyHits", "LookupResult", "find_rows"]

_UNSET = object()  # memo sentinel: None is a valid decoded dictionary

COUNTER_KEYS = ("keys", "keys_pruned_stats", "keys_pruned_bloom",
                "keys_pruned_pages", "rows_matched", "preads", "pages_read",
                "pages_coalesced", "chunk_fallbacks", "binary_search_hits")


@dataclass
class KeyHits:
    """Every match of one key: ascending file-local row ordinals, and for
    each requested column its row-aligned values (numpy) and validity (a
    bool mask, or None where the pages read carried none)."""

    key: object
    rows: np.ndarray
    values: Dict[str, np.ndarray] = field(default_factory=dict)
    validity: Dict[str, Optional[np.ndarray]] = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return len(self.rows)


class LookupResult:
    """Per-key hits aligned with the input keys, and the batch's stage
    counters."""

    def __init__(self, hits: List[KeyHits], counters: Dict[str, int]):
        self.hits = hits
        self.counters = counters

    def __len__(self) -> int:
        return len(self.hits)

    def __getitem__(self, i) -> KeyHits:
        return self.hits[i]

    def __iter__(self):
        return iter(self.hits)

    @property
    def rows_total(self) -> int:
        return sum(h.num_rows for h in self.hits)

    def __repr__(self) -> str:
        return (f"LookupResult({len(self.hits)} key(s), "
                f"{self.rows_total} row(s))")


# ---------------------------------------------------------------------------
# key preparation, once per batch
# ---------------------------------------------------------------------------


@dataclass
class _PreparedKeys:
    """``uniq``: the distinct normalized keys in first-seen order;
    ``key_map[i]``: the uniq ordinal of input key i (-1: can never match);
    ``hashes``: xxh64 of each uniq key (None: no bloom encoding);
    ``order``: ``uniq`` as an int64/float64 array where that compares
    exactly as the python values do (None otherwise)."""

    uniq: List
    key_map: np.ndarray
    hashes: Optional[np.ndarray]
    order: Optional[np.ndarray]


def _prepare_keys(leaf, keys) -> _PreparedKeys:
    from ..algebra.compare import normalize_probe
    from .bloom import probe_hashes

    fast = _prepare_int_array(leaf, keys)
    if fast is not None:
        return fast
    uniq: List = []
    seen: Dict = {}
    key_map = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        nk = normalize_probe(leaf, k)
        if nk is None:
            key_map[i] = -1
            continue
        got = seen.get(nk)
        if got is None:
            got = seen[nk] = len(uniq)
            uniq.append(nk)
        key_map[i] = got
    hashes = probe_hashes(leaf, uniq) if uniq else None
    return _PreparedKeys(uniq, key_map, hashes, _order_array(leaf, uniq))


def _prepare_int_array(leaf, keys) -> Optional[_PreparedKeys]:
    """The same preparation for a numpy integer array of keys on an integer
    column, without a Python loop: out-of-range keys never match, the rest
    dedupe in first-seen order."""
    from ..algebra.compare import int_domain, is_unsigned
    from .bloom import hash_values

    if (leaf.physical_type not in (Type.INT32, Type.INT64)
            or not isinstance(keys, np.ndarray) or keys.ndim != 1
            or keys.dtype.kind != "i"):
        return None
    arr = keys.astype(np.int64)
    unsigned = is_unsigned(leaf)
    width = 4 if leaf.physical_type == Type.INT32 else 8
    if unsigned or keys.dtype.itemsize > width:
        lo, hi = int_domain(leaf)
        ok = arr >= lo
        if hi < 2 ** 63:
            ok &= arr < hi
    else:
        ok = np.ones(len(arr), bool)
    key_map = np.full(len(arr), -1, np.int64)
    if not ok.any():
        return _PreparedKeys([], key_map, None, np.empty(0, np.int64))
    u, first, inv = np.unique(arr[ok], return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(u), np.int64)
    rank[order] = np.arange(len(u))
    key_map[ok] = rank[inv.reshape(-1)]
    uniq_arr = u[order]
    dt = np.dtype(f"{'u' if unsigned else 'i'}{width}")
    hashes = hash_values(leaf, uniq_arr.astype(dt))
    # the order array holds every value of the leaf's domain
    order_arr = uniq_arr.astype(np.uint64) if dt == np.uint64 else uniq_arr
    return _PreparedKeys(uniq_arr.tolist(), key_map, hashes, order_arr)


def _order_array(leaf, uniq: List) -> Optional[np.ndarray]:
    if not uniq:
        return None
    if leaf.physical_type in (Type.INT32, Type.INT64):
        # normalize_probe: ints in the leaf's domain
        from ..algebra.compare import is_unsigned

        unsigned64 = is_unsigned(leaf) and leaf.physical_type == Type.INT64
        return np.array(uniq, np.uint64 if unsigned64 else np.int64)
    if all(type(v) is float for v in uniq):
        return np.array(uniq, np.float64)
    return None


def _is_number(v, order: np.ndarray) -> bool:
    return type(v) is (int if order.dtype.kind in "iu" else float)


# ---------------------------------------------------------------------------
# page fetch: coalesced runs, decoded on the lookup's device
# ---------------------------------------------------------------------------


class _PageEntry:
    """One decoded page, row-aligned on the host."""

    __slots__ = ("values", "validity", "first_row", "num_rows")

    def __init__(self, values, validity, first_row: int, num_rows: int):
        self.values = values
        self.validity = validity
        self.first_row = first_row
        self.num_rows = num_rows


def decode_aligned(chunk, device, pages=None, dictionary=None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Decode a chunk, or the span ``pages`` of it with its ``dictionary``,
    on ``device`` and return it row-aligned as host numpy ``(values,
    validity)``.  Validity is None where no page's levels needed expanding,
    as the reference's host decode has it."""
    from ..errors import _Unsupported
    from ..parallel.device_reader import (HOST_ROUTE, build_plan,
                                          decode_staged, stage_plan)
    from .reader import PageTable, decode_chunk_host
    from .search import _trim_flat_aligned

    if pages is not None and not isinstance(pages, PageTable):
        pages = list(pages)  # the host route may read them again
    expanded = False
    try:
        plan = build_plan(chunk, pages=pages, dictionary=dictionary)
        col = decode_staged(plan, stage_plan(plan, device), device)
        expanded = plan.defs_expanded
    except _Unsupported as e:  # the read's host route, for this span
        HOST_ROUTE[e.reason] += 1
        col = decode_chunk_host(chunk, device, pages=pages,
                                dictionary=dictionary)
    values = col.values.cpu().numpy()
    validity = None
    if col.validity is not None:
        validity = col.validity.cpu().numpy()
    elif expanded:
        validity = np.ones(col.num_slots, bool)
    return _trim_flat_aligned(values, validity, 0, col.num_slots)


class _PageFetcher:
    """Decoded row-aligned pages of one column chunk: requested page
    ordinals coalesce into runs of adjacent pages, each run one pread and
    one device decode; the dictionary is read and decoded once per
    chunk."""

    def __init__(self, rg, chunk, counters: Dict[str, int], device):
        self.rg = rg
        self.chunk = chunk
        self.counters = counters
        self.device = device
        self.locs = chunk.offset_index().page_locations
        self.firsts = [pl.first_row_index for pl in self.locs]
        self._firsts_arr = np.asarray(self.firsts, np.int64)
        self._dict = _UNSET

    def page_rows(self, o: int) -> int:
        nxt = (self.firsts[o + 1] if o + 1 < len(self.firsts)
               else self.rg.num_rows)
        return nxt - self.firsts[o]

    def ords_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.maximum(
            np.searchsorted(self._firsts_arr, rows, side="right") - 1, 0)

    def _dictionary(self):
        if self._dict is _UNSET:
            from .reader import decode_dictionary_page
            from .search import dictionary_pages

            pages = list(dictionary_pages(self.chunk, self.locs[0].offset))
            if pages:
                self.counters["preads"] += 1
                self._dict = decode_dictionary_page(self.chunk, pages[0])
            else:
                self._dict = None
        return self._dict

    def fetch(self, ords: Sequence[int]) -> Dict[int, _PageEntry]:
        out: Dict[int, _PageEntry] = {}
        wanted = sorted(set(ords))
        if not wanted:
            return out
        runs: List[List[int]] = [[wanted[0]]]
        for o in wanted[1:]:
            if o == runs[-1][-1] + 1:
                runs[-1].append(o)
            else:
                runs.append([o])
        for run in runs:
            first, last = run[0], run[-1]
            span_start = self.locs[first].offset
            span_len = (self.locs[last].offset
                        + self.locs[last].compressed_page_size - span_start)
            dictionary = self._dictionary()
            pages = self.chunk.page_table_at(span_start, span_len,
                                             num_pages=len(run))
            vals, valid = decode_aligned(self.chunk, self.device, pages,
                                         dictionary)
            self.counters["preads"] += 1
            self.counters["pages_read"] += len(run)
            self.counters["pages_coalesced"] += len(run) - 1
            base = self.firsts[first]
            for o in run:
                a, n = self.firsts[o] - base, self.page_rows(o)
                out[o] = _PageEntry(vals[a:a + n],
                                    None if valid is None else valid[a:a + n],
                                    self.firsts[o], n)
        return out


# ---------------------------------------------------------------------------
# the cascade: stages 1-2 over every row group, then the rest per row group
# ---------------------------------------------------------------------------


def _stats_alive(st, nv, prep: _PreparedKeys, alive: np.ndarray
                 ) -> np.ndarray:
    """The statistics stage over the alive keys: the all-null early-out,
    then :func:`~.statistics.may_contain_range` per key (on the key array
    where it compares exactly)."""
    from .statistics import may_contain_range

    if st is not None and st.null_count is not None and nv is not None \
            and st.null_count >= nv:
        return np.zeros(len(alive), bool)  # every value is null
    if st is None or st.min_value is None or st.max_value is None:
        return np.ones(len(alive), bool)
    mn, mx = st.min_value, st.max_value
    if (prep.order is not None and _is_number(mn, prep.order)
            and _is_number(mx, prep.order)):
        keys = prep.order[alive]
        return ~((mx < keys) | (mn > keys))
    return np.fromiter((may_contain_range(st, prep.uniq[u], prep.uniq[u])
                        for u in alive), bool, count=len(alive))


def _ordered_searchable(ci, leaf) -> bool:
    """May the binary search run on this index?  Only when the boundary
    order is declared and no page is null-only or missing a bound (a null
    page breaks the bisection's invariant)."""
    got = getattr(ci, "_ordered_searchable", None)
    if got is None:
        from .search import decoded_bounds

        order = BoundaryOrder(ci.boundary_order or 0)
        if order not in (BoundaryOrder.ASCENDING, BoundaryOrder.DESCENDING):
            got = False
        else:
            mins, maxs = decoded_bounds(ci, leaf)
            got = (not any(ci.null_pages or [])
                   and all(m is not None for m in mins)
                   and all(m is not None for m in maxs))
        ci._ordered_searchable = got
    return got


def _key_page_ords(ci, leaf, key) -> List[int]:
    """Page ordinals that may hold ``key``: :func:`~.search.find` on a
    cleanly ordered index, extended over the contiguous run of pages that
    may hold it (one key's duplicates can span pages); the zone-map walk
    otherwise."""
    from .search import decoded_bounds, find, pages_overlapping

    if _ordered_searchable(ci, leaf):
        i = find(ci, key, leaf)
        n = len(ci.null_pages or [])
        if i >= n:
            return []
        mins, maxs = decoded_bounds(ci, leaf)
        out = [i]
        j = i + 1
        while j < n and mins[j] <= key <= maxs[j]:
            out.append(j)
            j += 1
        return out
    return pages_overlapping(ci, leaf, lo=key, hi=key)


def _sorted_bounds(ci, leaf, order: np.ndarray):
    """(mins, maxs) as arrays of ``order``'s dtype when the index has no
    null page, every bound is a number of that domain and both ladders
    are non-decreasing; else None.  On such an index :func:`_key_page_ords`
    returns the pages ``[searchsorted(maxs, key, 'left'),
    searchsorted(mins, key, 'right'))`` for ASCENDING and UNORDERED
    declarations alike."""
    from .search import decoded_bounds

    got = getattr(ci, "_sorted_bounds", _UNSET)
    if got is _UNSET:
        got = None
        order_decl = BoundaryOrder(ci.boundary_order or 0)
        mins, maxs = decoded_bounds(ci, leaf)
        if (order_decl != BoundaryOrder.DESCENDING
                and not any(ci.null_pages or []) and mins
                and all(_is_number(v, order) for v in mins)
                and all(_is_number(v, order) for v in maxs)):
            amin = np.array(mins, order.dtype)
            amax = np.array(maxs, order.dtype)
            if (np.all(amin[1:] >= amin[:-1])
                    and np.all(amax[1:] >= amax[:-1])):
                got = (amin, amax)
        ci._sorted_bounds = got
    return got


def _page_ords_of_keys(ci, leaf, prep: _PreparedKeys, alive: np.ndarray
                       ) -> List[Tuple[int, List[int]]]:
    """``(uniq ordinal, page ordinals)`` for each alive key, in order."""
    bounds = (_sorted_bounds(ci, leaf, prep.order)
              if prep.order is not None else None)
    if bounds is None:
        return [(int(u), _key_page_ords(ci, leaf, prep.uniq[u]))
                for u in alive]
    amin, amax = bounds
    keys = prep.order[alive]
    lo = np.searchsorted(amax, keys, side="left")
    hi = np.searchsorted(amin, keys, side="right")
    # a NaN key compares False with every bound: the reference's walk keeps
    # every page of an unordered index for it, so it takes that walk
    nan = np.isnan(keys) if keys.dtype.kind == "f" else np.zeros(len(keys),
                                                                 bool)
    return [(u, _key_page_ords(ci, leaf, prep.uniq[u]) if isnan
             else list(range(a, b)) if a < b else [])
            for u, a, b, isnan in zip(alive.tolist(), lo.tolist(),
                                      hi.tolist(), nan.tolist())]


def _rg_sorted_by(rg, leaf) -> Optional[bool]:
    """``nulls_first`` when the row group declares its rows sorted
    ascending by ``leaf`` (its first sorting column), else None."""
    scs = rg.sorting_columns or []
    if not scs:
        return None
    sc = scs[0]
    if sc.column_idx != leaf.column_index or sc.descending:
        return None
    return bool(sc.nulls_first)


def _sorted_page_hits(leaf, key, entry: _PageEntry,
                      nulls_first: bool) -> Optional[np.ndarray]:
    """Page-local rows equal to ``key`` by binary search within a page of
    rows sorted by the key; None where that is not provably exact (float
    pages, whose NaNs break the search, or nulls that are not one
    contiguous run at the declared end): the caller then masks."""
    from ..parallel.host_scan import order_view

    vals, valid = order_view(leaf, entry.values), entry.validity
    a, b = 0, entry.num_rows
    if valid is not None:
        k = int(valid.sum())
        if k == 0:
            return np.empty(0, np.int64)
        if nulls_first:
            a = entry.num_rows - k
            if not valid[a:].all():
                return None
        else:
            b = k
            if not valid[:b].all():
                return None
    if vals.dtype.kind not in "iu" or isinstance(key, bool) or not isinstance(
            key, (int, np.integer)):
        return None
    needle = vals.dtype.type(key)
    seg = vals[a:b]
    lo = int(np.searchsorted(seg, needle, side="left"))
    hi = int(np.searchsorted(seg, needle, side="right"))
    return a + np.arange(lo, hi, dtype=np.int64)


def _prune_row_groups(row_groups, leaf, prep: _PreparedKeys,
                      counters: Dict[str, int], device
                      ) -> List[np.ndarray]:
    """Stages 1 and 2 over every row group: the uniq ordinals alive in each
    after its chunk statistics and its bloom filter.  Each row group's
    surviving hashes are one probe, routed by size alone as the reference
    routes them: the batches of at least ``_DEVICE_PROBE_MIN`` hashes are
    probed together by one :func:`~.bloom.check_hashes_multi` on
    ``device``, the others by the numpy probe.  A row group that the
    statistics prune entirely reads no filter."""
    from . import bloom

    alive_by_rg: List[np.ndarray] = []
    on_device = []  # (row group ordinal, filter, hashes)
    for rg in row_groups:
        chunk = rg.column(leaf.column_index)
        alive = np.arange(len(prep.uniq), dtype=np.int64)
        # ---- stage 1: chunk statistics (no IO)
        keep = _stats_alive(chunk.statistics(), chunk.meta.num_values, prep,
                            alive)
        counters["keys_pruned_stats"] += int(len(alive) - keep.sum())
        alive = alive[keep]
        # ---- stage 2: the bloom filter, every surviving key in one probe
        bf = (chunk.bloom_filter() if len(alive) and prep.hashes is not None
              else None)
        if bf is not None:
            hashes = prep.hashes[alive]
            if len(hashes) >= bf._DEVICE_PROBE_MIN:
                on_device.append((len(alive_by_rg), bf, hashes))
            else:
                alive = _bloom_survivors(alive, bf.check_hashes(hashes),
                                         counters)
        alive_by_rg.append(alive)
    if on_device:
        keeps = bloom.check_hashes_multi([bf for _, bf, _ in on_device],
                                         [h for _, _, h in on_device], device)
        for (j, _, _), keep in zip(on_device, keeps):
            alive_by_rg[j] = _bloom_survivors(alive_by_rg[j], keep, counters)
    return alive_by_rg


def _bloom_survivors(alive: np.ndarray, keep: np.ndarray,
                     counters: Dict[str, int]) -> np.ndarray:
    counters["keys_pruned_bloom"] += int((~keep).sum())
    return alive[keep]


def _lookup_rg(rg, leaf, prep: _PreparedKeys, alive: np.ndarray, out_leaves,
               counters: Dict[str, int], device):
    """Match and gather one row group's ``alive`` keys (the survivors of
    :func:`_prune_row_groups`).  Returns ``(rows, cols)``: ``rows[u]`` the
    local row ordinals of uniq key ``u`` and ``cols[u][name]`` its
    ``(values, validity)``; None when no key matched."""
    from ..parallel.host_scan import aligned_key_mask

    if not len(alive):
        return None
    chunk = rg.column(leaf.column_index)
    # ---- stage 3: the page index, then page reads
    ci = chunk.column_index()
    oi = chunk.offset_index()
    per_uniq_rows: Dict[int, np.ndarray] = {}
    if ci is None or oi is None or not oi.page_locations:
        counters["chunk_fallbacks"] += 1
        vals, valid = decode_aligned(chunk, device)
        for u in alive.tolist():
            rows = np.flatnonzero(aligned_key_mask(leaf, prep.uniq[u], vals,
                                                   valid))
            if len(rows):
                per_uniq_rows[u] = rows.astype(np.int64)
    else:
        key_pages = []
        needed = set()
        for u, ords in _page_ords_of_keys(ci, leaf, prep, alive):
            if not ords:
                counters["keys_pruned_pages"] += 1
                continue
            key_pages.append((u, ords))
            needed.update(ords)
        if not key_pages:
            return None
        entries = _PageFetcher(rg, chunk, counters, device).fetch(needed)
        per_uniq_rows = _match_keys(rg, leaf, prep, key_pages, entries,
                                    counters)
    if not per_uniq_rows:
        return None
    counters["rows_matched"] += sum(len(r) for r in per_uniq_rows.values())
    return per_uniq_rows, _gather_columns(rg, per_uniq_rows, out_leaves,
                                          counters, device)


def _match_keys(rg, leaf, prep: _PreparedKeys, key_pages, entries,
                counters: Dict[str, int]) -> Dict[int, np.ndarray]:
    """The local rows equal to each key in its fetched pages: an in-page
    binary search where the row group declares its rows sorted by the key
    and the page allows it, the exact mask otherwise."""
    from ..parallel.host_scan import aligned_key_mask

    nulls_first = _rg_sorted_by(rg, leaf)
    per_uniq_rows: Dict[int, np.ndarray] = {}
    for u, ords in key_pages:
        key = prep.uniq[u]
        parts = []
        for o in ords:
            e = entries[o]
            hit = None
            if nulls_first is not None:
                hit = _sorted_page_hits(leaf, key, e, nulls_first)
            if hit is None:
                hit = np.flatnonzero(aligned_key_mask(
                    leaf, key, e.values, e.validity))
            else:
                counters["binary_search_hits"] += 1
            if len(hit):
                parts.append(e.first_row + hit)
        if parts:
            per_uniq_rows[u] = (parts[0] if len(parts) == 1
                                else np.concatenate(parts))
    return per_uniq_rows


def _gather_columns(rg, per_uniq_rows: Dict[int, np.ndarray], out_leaves,
                    counters: Dict[str, int], device):
    """Each output column's row-aligned values at every matched row, read
    through one coalesced page fetch per chunk, then cut per key.  A key's
    validity is None when none of the pages its rows lie in carried one,
    as the reference concatenates it."""
    us = list(per_uniq_rows)
    lens = np.array([len(per_uniq_rows[u]) for u in us], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    rows = np.concatenate([per_uniq_rows[u] for u in us])
    cols: Dict[int, Dict[str, tuple]] = {u: {} for u in us}
    for out_leaf in out_leaves:
        chunk = rg.column(out_leaf.column_index)
        oi = chunk.offset_index()
        if oi is None or not oi.page_locations:
            counters["chunk_fallbacks"] += 1
            vals, valid = decode_aligned(chunk, device)
            got_vals = vals[rows]
            got_valid = None if valid is None else valid[rows]
            has_valid = np.full(len(us), valid is not None)
        else:
            fetcher = _PageFetcher(rg, chunk, counters, device)
            ords = fetcher.ords_of_rows(rows)
            entries = fetcher.fetch(np.unique(ords).tolist())
            got_vals, got_valid, row_valid = _gather_pages(entries, rows,
                                                           ords)
            has_valid = (np.add.reduceat(row_valid, starts[:-1]) > 0
                         if len(rows) else np.zeros(len(us), bool))
        for j, u in enumerate(us):
            a, b = starts[j], starts[j + 1]
            cols[u][out_leaf.name] = (
                got_vals[a:b], got_valid[a:b] if has_valid[j] else None)
    return cols


def _gather_pages(entries: Dict[int, _PageEntry], rows: np.ndarray,
                  ords: np.ndarray):
    """(values, validity, row_has_validity) at ``rows`` (page ``ords``)."""
    first = next(iter(entries.values()))
    vals = np.empty(len(rows), first.values.dtype)
    valid = np.ones(len(rows), bool)
    row_valid = np.zeros(len(rows), np.int64)
    by_page = np.argsort(ords, kind="stable")
    uo, cut = np.unique(ords[by_page], return_index=True)
    cut = np.append(cut, len(rows))
    for o, a, b in zip(uo.tolist(), cut[:-1].tolist(), cut[1:].tolist()):
        e = entries[o]
        sel = by_page[a:b]
        local = rows[sel] - e.first_row
        vals[sel] = e.values[local]
        if e.validity is not None:
            valid[sel] = e.validity[local]
            row_valid[sel] = 1
    return vals, valid, row_valid


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _empty_values(leaf) -> np.ndarray:
    return np.empty(0, PHYSICAL_NP_DTYPE[leaf.physical_type])


def find_rows(pf, path: str, keys, columns: Optional[Sequence[str]] = None,
              device="cuda") -> LookupResult:
    """Every row of ``pf`` where column ``path`` equals each of ``keys``.
    ``hits[i]`` of the result belongs to ``keys[i]``: ascending file-local
    rows and the row-aligned values of each of ``columns``.  NULL cells
    never match; a key outside the column's domain matches nothing.  The
    bloom probe and the page decodes run on ``device``: CUDA unless the
    caller names the CPU, and a CUDA request without a card raises."""
    from .reader import resolve_device

    dev = resolve_device(device)
    leaf = pf.schema.leaf(path)  # KeyError on an unknown column
    out_leaves = [pf.schema.leaf(c) for c in (columns or [])]
    for lf in [leaf] + out_leaves:
        if lf.max_repetition_level or lf.max_definition_level > 1:
            raise unsupported(
                f"a point lookup over the nested column {lf.name!r}",
                "the lookup leftovers (nested key and value columns)")
        if lf.physical_type not in NUMERIC:
            raise unsupported(
                f"a point lookup over the {lf.physical_type.name} column "
                f"{lf.name!r}", "the lookup leftovers (byte-array, boolean "
                "and fixed-length keys and values)")
    counters = {k: 0 for k in COUNTER_KEYS}
    counters["keys"] = len(keys)
    prep = _prepare_keys(leaf, keys)
    per_uniq: Dict[int, List[tuple]] = {}
    if prep.uniq:
        row_groups = pf.row_groups
        rg_base = 0
        for rg, alive in zip(row_groups, _prune_row_groups(
                row_groups, leaf, prep, counters, dev)):
            got = _lookup_rg(rg, leaf, prep, alive, out_leaves, counters,
                             dev)
            if got is not None:
                rows_map, cols_map = got
                for u, rows in rows_map.items():
                    per_uniq.setdefault(u, []).append(
                        (rows + rg_base, cols_map[u]))
            rg_base += rg.num_rows
    return LookupResult(_assemble_hits(keys, prep, per_uniq, out_leaves),
                        counters)


def _assemble_hits(keys, prep: _PreparedKeys, per_uniq, out_leaves
                   ) -> List[KeyHits]:
    """One :class:`KeyHits` per uniq key, shared by its duplicates in the
    input; a key with no rows gets empty arrays (shared, being empty) and
    None validity."""
    names = [leaf.name for leaf in out_leaves]
    no_rows = np.empty(0, np.int64)
    no_values = {leaf.name: _empty_values(leaf) for leaf in out_leaves}
    no_validity = dict.fromkeys(names)

    def build(u: int, key) -> KeyHits:
        parts = per_uniq[u]
        if len(parts) == 1:
            rows, cols = parts[0]
            h = KeyHits(key, rows)
            for c in names:
                h.values[c], h.validity[c] = cols[c]
            return h
        h = KeyHits(key, np.concatenate([p[0] for p in parts]))
        for c in names:
            vparts = [p[1][c][0] for p in parts]
            valparts = [p[1][c][1] for p in parts]
            h.values[c] = np.concatenate(vparts)
            h.validity[c] = (None if all(v is None for v in valparts) else
                             np.concatenate([
                                 v if v is not None else np.ones(len(p), bool)
                                 for v, p in zip(valparts, vparts)]))
        return h

    built: Dict[int, KeyHits] = {}
    hits: List[KeyHits] = []
    for k, u in zip(keys, prep.key_map.tolist()):
        got = built.get(u)
        if got is None:
            if u >= 0 and u in per_uniq:
                got = build(u, k)
            else:
                got = KeyHits(k, no_rows, dict(no_values), dict(no_validity))
            if u >= 0:
                built[u] = got
        hits.append(got)
    return hits
