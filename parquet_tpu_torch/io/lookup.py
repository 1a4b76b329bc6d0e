"""Batched point lookups: the rows where a column equals each of many keys.

The port of ``parquet_tpu/io/lookup.py`` (``find_rows`` and
``dataset_find_rows``) for flat key and value columns of every physical
type.  Each row group runs the reference's cheapest-first cascade, with
the same counters:

0. the negative-lookup memo (``io/cache.py::NEGS``): keys an earlier
   lookup proved absent from the chunk are dropped first (``neg_hits``);
1. chunk statistics (no IO): keys outside [min, max], and every key of an
   all-null chunk, are pruned;
2. the bloom filter, probed once with the hashes of every surviving key
   (the C++ ``pq_xxh64_batch`` hashes byte-array keys).  Stages 1 and 2
   run over every row group first, so that the row groups whose batch has
   32,768 hashes or more are probed together: one
   :func:`~parquet_tpu_torch.io.bloom.check_hashes_multi`, one launch of
   the ``bloom_check`` CUDA kernel per lookup on the lookup's device; a
   smaller batch takes the numpy probe, as in the reference;
3. the page index: a binary search (:func:`~.search.find`) per key on a
   cleanly ordered index, the zone-map walk otherwise;
4. page reads: each needed page is looked up in the page cache
   (``io/cache.py::PAGES``) first (``page_cache_hits``); the others
   coalesce into runs of adjacent pages, one pread per run (and one for
   the dictionary, once per chunk), each run admitted through the lookup
   tier of the read gate (``utils/pool.py::lookup_admission``), decoded
   on the lookup's device (:mod:`~parquet_tpu_torch.parallel.
   device_reader`, whose dictionary and bit-packed streams launch the read
   path's kernels), copied back to host numpy row-aligned and cached page
   by page, frozen; then every key of the row group is matched at once
   against one sorted table of the fetched rows (:class:`_RowTable`: by
   value for numbers, by xxh64 for byte-array and fixed-length keys with
   each candidate's bytes compared, by python value for booleans and
   decimals of byte storage), giving the rows the reference's in-page
   binary search or exact mask gives.

The keys a row group's cascade leaves unmatched enter the memo.  A chunk
without a page index decodes whole (``chunk_fallbacks``), admitted at its
compressed size.  The requested output columns are read through the same
cached, coalesced page runs; a byte-array column's values come back as a
list of ``bytes`` (None at a null row), a fixed-length one's as ``(n, w)``
uint8 rows, as in the reference.  Where the reference loops over keys in
Python, the statistics stage, the page search of a cleanly ordered numeric
index and the gather of output values run on numpy arrays of keys instead;
survivors, stage order and counters are the reference's.

The reference's key sharding (slices of the key set, each running the
whole cascade on a pool worker) is not ported: a lookup's per-row-group
work is Python and numpy under the GIL, and shards of it on 8 pool
workers ran 1.5-1.9 times slower than one thread on an H100 host
(PERF.md, PR 16).  ``key_shards`` stays 0.

Keys of an unsigned column (the INT annotation's ``signed=false``)
compare in unsigned order at every stage, and a ``Decimal`` key of a
decimal compares as its unscaled integer.

A key or value column may be a leaf under optional structs (no repeated
level): a null anywhere on its struct chain never matches, and such a
value's validity is False; a repeated column raises ``ValueError``, as in
the reference.  ``policy``/``report`` are the reference's: preads retry
under the policy, the call runs under its deadline, and with
``on_corrupt='skip_row_group'`` a row group whose index, bloom filter or
pages are corrupt drops whole (rows and values together, its full row
count recorded).

Not in this port: metrics and op scopes.
"""

from __future__ import annotations

import time
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import CorruptedError, DeadlineError
from ..format.enums import BoundaryOrder, Type
from ..obs import scope as _oscope
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..schema.types import PHYSICAL_NP_DTYPE, LogicalKind
from ..utils.debug import counters
from .cache import ByteRows, PageEntry

_M_FIND_S = _histogram("lookup.find_rows_s")
_M_DS_FIND_S = _histogram("dataset.find_rows_s")
# each counter key's registry family: lookup.<key>
_METRIC = {k: _counter("lookup." + k) for k in (
    "keys", "keys_pruned_stats", "keys_pruned_bloom", "keys_pruned_pages",
    "rows_matched", "preads", "pages_read", "pages_coalesced",
    "chunk_fallbacks", "neg_hits", "binary_search_hits")}


def _count(cdict: Dict[str, int], key: str, n: int) -> None:
    """Count ``n`` in the lookup's ``cdict[key]``, in ``lookup.<key>``
    and in the current op: once a batch or a row group, never a key."""
    if n:
        cdict[key] += n
        _oscope.account(_METRIC[key], n)


__all__ = ["KeyHits", "LookupResult", "find_rows", "dataset_find_rows"]

_UNSET = object()  # memo sentinel: None is a valid decoded dictionary

# the reference's counters, in its order.  ``binary_search_hits`` is
# derived for parity (:func:`_searches_answered`): the (key, page) probes
# the reference answers by an in-page binary search; the port matches
# every key against a sorted table and runs no such search.  The port
# does not shard a batch, so ``key_shards`` is 0.
COUNTER_KEYS = ("keys", "keys_pruned_stats", "keys_pruned_bloom",
                "keys_pruned_pages", "rows_matched", "preads", "pages_read",
                "pages_coalesced", "page_cache_hits", "chunk_fallbacks",
                "neg_hits", "binary_search_hits", "key_shards")


@dataclass
class KeyHits:
    """Every match of one key: ascending row ordinals (file-local from
    :func:`find_rows`, dataset-wide from :func:`dataset_find_rows`), and
    for each requested column its row-aligned values (a numpy array,
    ``(n, w)`` uint8 rows for a fixed-length byte array, a list of
    ``bytes`` with None at null rows for a byte array) and validity (a
    bool mask, or None where the pages read carried none)."""

    key: object
    rows: np.ndarray
    values: Dict[str, object] = field(default_factory=dict)
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
        self.report = None  # the call's ReadReport under a policy

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


def _new_counters() -> Dict[str, int]:
    return {k: 0 for k in COUNTER_KEYS}


# ---------------------------------------------------------------------------
# key preparation, once per batch (once per dataset)
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
    if leaf.physical_type in (Type.FLOAT, Type.DOUBLE) and all(
            type(v) is float for v in uniq):
        return np.array(uniq, np.float64)
    return None


def _is_number(v, order: np.ndarray) -> bool:
    return type(v) is (int if order.dtype.kind in "iu" else float)


def _bytes_keyed(leaf) -> bool:
    """Does the leaf match keys by their bytes (a byte array or
    fixed-length byte array that is not a decimal)?"""
    return (leaf.physical_type in (Type.BYTE_ARRAY,
                                   Type.FIXED_LEN_BYTE_ARRAY)
            and leaf.logical_kind != LogicalKind.DECIMAL)


# ---------------------------------------------------------------------------
# page fetch: the page cache, then coalesced runs decoded on the device
# ---------------------------------------------------------------------------


def _byte_rows(values: np.ndarray, offsets: np.ndarray,
               validity: Optional[np.ndarray]) -> ByteRows:
    """Dense present byte arrays as :class:`ByteRows`: one row a slot, a
    null slot empty."""
    offsets = np.asarray(offsets, np.int64)
    data = values[offsets[0]:offsets[-1]]
    if validity is None:
        return ByteRows(data, offsets - offsets[0])
    lens = np.zeros(len(validity), np.int64)
    lens[validity] = np.diff(offsets)
    row_offs = np.zeros(len(validity) + 1, np.int64)
    np.cumsum(lens, out=row_offs[1:])
    return ByteRows(data, row_offs)


def _slice_rows(values, a: int, n: int):
    """Rows ``[a, a + n)`` of a row-aligned span."""
    if isinstance(values, ByteRows):
        offs = values.offsets[a:a + n + 1]
        return ByteRows(values.data[offs[0]:offs[-1]], offs - offs[0])
    return values[a:a + n]


def decode_aligned(chunk, device, pages=None, dictionary=None):
    """Decode a chunk, or the span ``pages`` of it with its ``dictionary``,
    on ``device`` and return it row-aligned on the host as ``(values,
    validity)``: values a numpy array (``(n, w)`` rows for fixed-length
    byte arrays) or :class:`~.cache.ByteRows`, a null row zero-filled or
    empty.  Validity is None where no page's levels needed expanding, as
    the reference's host decode has it."""
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
    validity = None
    if col.validity is not None:
        validity = col.validity.cpu().numpy()
    elif expanded:
        validity = np.ones(col.num_slots, bool)
    if chunk.leaf.physical_type == Type.BYTE_ARRAY:
        col.materialize()
        return (_byte_rows(col.values.cpu().numpy(),
                           col.offsets.cpu().numpy(), validity), validity)
    return _trim_flat_aligned(col.values.cpu().numpy(), validity, 0,
                              col.num_slots)


class _PageFetcher:
    """Decoded row-aligned pages of one column chunk: each requested page
    comes from the page cache when it is there; the others coalesce into
    runs of adjacent pages, each run one admitted pread and one device
    decode, and are cached page by page; the dictionary is read and
    decoded once per chunk, and only where a page is missing."""

    def __init__(self, pf, rg, chunk, counters: Dict[str, int], device):
        self.rg = rg
        self.chunk = chunk
        self.counters = counters
        self.device = device
        self.locs = chunk.offset_index().page_locations
        self.firsts = [pl.first_row_index for pl in self.locs]
        self._firsts_arr = np.asarray(self.firsts, np.int64)
        self._dict = _UNSET
        fk = pf._cache_key
        # the CRC check is part of a page's identity: a page decoded
        # unchecked must not answer a reader that checks
        self._key_base = (None if fk is None
                          else (fk, rg.index, chunk.leaf.name,
                                pf.options.verify_crc))

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
                _count(self.counters, "preads", 1)
                self._dict = decode_dictionary_page(self.chunk, pages[0])
                counters.inc("dict_pages_decoded")
            else:
                self._dict = None
        return self._dict

    def fetch(self, ords: Sequence[int]) -> Dict[int, PageEntry]:
        from ..utils.pool import lookup_admission
        from .cache import PAGES, make_page_entry

        out: Dict[int, PageEntry] = {}
        missing: List[int] = []
        base = self._key_base
        for o in sorted(set(ords)):
            entry = PAGES.get(base + (o,)) if base is not None else None
            if entry is not None:
                self.counters["page_cache_hits"] += 1
                out[o] = entry
            else:
                missing.append(o)
        if not missing:
            return out
        runs: List[List[int]] = [[missing[0]]]
        for o in missing[1:]:
            if o == runs[-1][-1] + 1:
                runs[-1].append(o)
            else:
                runs.append([o])
        admission = lookup_admission()
        for run in runs:
            first, last = run[0], run[-1]
            span_start = self.locs[first].offset
            span_len = (self.locs[last].offset
                        + self.locs[last].compressed_page_size - span_start)
            with admission.admit(span_len):
                dictionary = self._dictionary()
                pages = self.chunk.page_table_at(span_start, span_len,
                                                 num_pages=len(run))
                vals, valid = decode_aligned(self.chunk, self.device, pages,
                                             dictionary)
            _count(self.counters, "preads", 1)
            _count(self.counters, "pages_read", len(run))
            _count(self.counters, "pages_coalesced", len(run) - 1)
            at = self.firsts[first]
            for o in run:
                a, n = self.firsts[o] - at, self.page_rows(o)
                pv = _slice_rows(vals, a, n)
                pvalid = None if valid is None else valid[a:a + n]
                out[o] = (PAGES.put(base + (o,), pv, pvalid, self.firsts[o], n)
                          if base is not None else
                          make_page_entry(pv, pvalid, self.firsts[o], n))
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


def _sorted_byte_bounds(ci, leaf):
    """(mins, maxs) as lists of ``bytes`` when the index has no null page,
    every bound is bytes and both ladders are non-decreasing; else None:
    :func:`_sorted_bounds` for byte keys, searched with ``bisect``."""
    from .search import decoded_bounds

    got = getattr(ci, "_sorted_byte_bounds", _UNSET)
    if got is _UNSET:
        got = None
        mins, maxs = decoded_bounds(ci, leaf)
        if (BoundaryOrder(ci.boundary_order or 0) != BoundaryOrder.DESCENDING
                and not any(ci.null_pages or []) and mins
                and all(type(v) is bytes for v in mins)
                and all(type(v) is bytes for v in maxs)
                and all(a <= b for a, b in zip(mins, mins[1:]))
                and all(a <= b for a, b in zip(maxs, maxs[1:]))):
            got = (list(mins), list(maxs))
        ci._sorted_byte_bounds = got
    return got


def _page_ords_of_keys(ci, leaf, prep: _PreparedKeys, alive: np.ndarray,
                       counters: Dict[str, int]
                       ) -> List[Tuple[int, List[int]]]:
    """``(uniq ordinal, page ordinals)`` for each alive key that some page
    may hold, in order; the others count in ``keys_pruned_pages``."""
    bounds = (_sorted_bounds(ci, leaf, prep.order)
              if prep.order is not None else None)
    byte_bounds = (_sorted_byte_bounds(ci, leaf)
                   if bounds is None and _bytes_keyed(leaf) else None)
    if byte_bounds is not None:
        mins, maxs = byte_bounds
        got = []
        for u in alive.tolist():
            key = prep.uniq[u]
            if type(key) is bytes:
                got.append((u, list(range(bisect_left(maxs, key),
                                          bisect_right(mins, key)))))
            else:
                got.append((u, _key_page_ords(ci, leaf, key)))
    elif bounds is None:
        got = [(int(u), _key_page_ords(ci, leaf, prep.uniq[u]))
               for u in alive]
    else:
        amin, amax = bounds
        keys = prep.order[alive]
        lo = np.searchsorted(amax, keys, side="left")
        hi = np.searchsorted(amin, keys, side="right")
        # a NaN key compares False with every bound: the reference's walk
        # keeps every page of an unordered index for it, so it takes that
        # walk
        nan = (np.isnan(keys) if keys.dtype.kind == "f"
               else np.zeros(len(keys), bool))
        got = [(u, _key_page_ords(ci, leaf, prep.uniq[u]) if isnan
                else list(range(a, b)) if a < b else [])
               for u, a, b, isnan in zip(alive.tolist(), lo.tolist(),
                                         hi.tolist(), nan.tolist())]
    out = [(u, ords) for u, ords in got if ords]
    _count(counters, "keys_pruned_pages", len(got) - len(out))
    return out


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


def _prune_row_groups(pf, row_groups, leaf, prep: _PreparedKeys,
                      counters: Dict[str, int], device
                      ) -> Tuple[List[np.ndarray], List[Optional[tuple]],
                                 List[np.ndarray]]:
    """Stages 0-2 over every row group.  Returns, for each row group, the
    uniq ordinals alive after its chunk statistics and bloom filter, its
    key in the negative-lookup memo (None: the file is not cached) and the
    ordinals the memo left to the cascade (the ones a clean run may enter
    in it), and the located data error of a row group whose statistics or
    filter could not be read (None for the others).  Each row group's surviving hashes are one probe, routed by
    size alone as the reference routes them: the batches of at least
    ``_DEVICE_PROBE_MIN`` hashes are probed together by one
    :func:`~.bloom.check_hashes_multi` on ``device``, the others by the
    numpy probe.  A row group that the memo or the statistics prune
    entirely reads no filter."""
    from . import bloom

    alive_by_rg: List[np.ndarray] = []
    neg_keys: List[Optional[tuple]] = []
    probed: List[np.ndarray] = []
    failed: List[Optional[CorruptedError]] = []
    on_device = []  # (row group ordinal, filter, hashes)
    fk = pf._cache_key
    none = np.empty(0, np.int64)
    for rg in row_groups:
        try:
            with _rg_context(pf, rg, leaf):
                alive, neg_key, tried, bf = _prune_one(
                    rg, leaf, prep, counters, fk)
        except DeadlineError:
            raise
        except CorruptedError as e:  # the row group fails at its turn
            alive_by_rg.append(none)
            neg_keys.append(None)
            probed.append(none)
            failed.append(e)
            continue
        neg_keys.append(neg_key)
        probed.append(tried)
        failed.append(None)
        # ---- stage 2: the bloom filter, every surviving key in one probe
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
    return alive_by_rg, neg_keys, probed, failed


def _rg_context(pf, rg, leaf):
    """The located-error scope of one row group's cascade, as the
    reference's: only data errors (``CorruptedError``, ``OSError``) are
    wrapped."""
    from .faults import read_context

    return read_context(path=pf._path, row_group=rg.index, column=leaf.name,
                        kinds=(CorruptedError, OSError))


def _prune_one(rg, leaf, prep: _PreparedKeys, counters: Dict[str, int], fk):
    """Stages 0-1 of one row group, and its bloom filter where keys
    survive them: ``(alive, memo key, ordinals the memo left, filter or
    None)``."""
    from .cache import NEGS

    chunk = rg.column(leaf.column_index)
    alive = np.arange(len(prep.uniq), dtype=np.int64)
    # ---- stage 0: keys this chunk was proven not to hold
    # with the CRC check in the key: an unchecked probe of corrupt pages
    # cannot prove a key absent to a reader that checks
    neg_key = (None if fk is None else (fk, rg.index, leaf.name,
                                        rg.file.options.verify_crc))
    if neg_key is not None:
        known = NEGS.absent_mask(neg_key, prep.uniq)
        if known is not None:
            _count(counters, "neg_hits", int(known.sum()))
            alive = alive[~known]
    tried = alive
    if len(alive):
        # ---- stage 1: chunk statistics (no IO)
        keep = _stats_alive(chunk.statistics(), chunk.meta.num_values,
                            prep, alive)
        _count(counters, "keys_pruned_stats",
               int(len(alive) - keep.sum()))
        alive = alive[keep]
    bf = (chunk.bloom_filter() if len(alive) and prep.hashes is not None
          else None)
    return alive, neg_key, tried, bf


def _bloom_survivors(alive: np.ndarray, keep: np.ndarray,
                     counters: Dict[str, int]) -> np.ndarray:
    _count(counters, "keys_pruned_bloom", int((~keep).sum()))
    return alive[keep]


def _lookup_rg(pf, rg, leaf, prep: _PreparedKeys, alive: np.ndarray,
               out_leaves, counters: Dict[str, int], device):
    """Stages 3-4 of one row group for its ``alive`` keys (the survivors
    of :func:`_prune_row_groups`): the page search, the page reads, the
    match and the gather of the output columns.  Returns ``(rows,
    cols)``: ``rows[u]`` the local row ordinals of uniq key ``u`` and
    ``cols[u][name]`` its ``(values, validity)``; None when no key
    matched."""
    from ..utils.pool import lookup_admission

    if not len(alive):
        return None
    chunk = rg.column(leaf.column_index)
    ci = chunk.column_index()
    oi = chunk.offset_index()
    if ci is None or oi is None or not oi.page_locations:
        # the whole chunk, matched as an unsorted row group, as the
        # reference matches it there
        _count(counters, "chunk_fallbacks", 1)
        with lookup_admission().admit(chunk.meta.total_compressed_size or 0):
            vals, valid = decode_aligned(chunk, device)
        entries = {0: PageEntry(vals, valid, 0, rg.num_rows)}
        key_pages = [(u, [0]) for u in alive.tolist()]
        nulls_first = None
    else:
        # ---- stage 3: the page index, then page reads
        key_pages = _page_ords_of_keys(ci, leaf, prep, alive, counters)
        if not key_pages:
            return None
        needed = set()
        for _, ords in key_pages:
            needed.update(ords)
        entries = _PageFetcher(pf, rg, chunk, counters, device).fetch(needed)
        nulls_first = _rg_sorted_by(rg, leaf)
    per_uniq_rows = _match(leaf, prep, key_pages, entries, nulls_first,
                           counters)
    if not per_uniq_rows:
        return None
    _count(counters, "rows_matched",
           sum(len(r) for r in per_uniq_rows.values()))
    return per_uniq_rows, _gather_columns(pf, rg, per_uniq_rows, out_leaves,
                                          counters, device)


# ---------------------------------------------------------------------------
# stage 4's match: every key of a row group at once, against one sorted
# table of its fetched rows
# ---------------------------------------------------------------------------


def _row_hashes(entry: PageEntry) -> np.ndarray:
    """The xxh64 of each byte row of a byte-array or fixed-length page,
    computed once an entry."""
    got = entry.memo.get("hashes")
    if got is None:
        from ..ops import host

        v = entry.values
        if isinstance(v, ByteRows):
            got = host.xxh64_batch(v.data, v.offsets)
        else:
            w = v.shape[1]
            got = host.xxh64_batch(
                v.reshape(-1), np.arange(len(v) + 1, dtype=np.int64) * w)
        entry.memo["hashes"] = got
    return got


def _row_objects(leaf, entry: PageEntry) -> np.ndarray:
    """Each row of a page as a python value of the leaf's order domain
    (:func:`~parquet_tpu_torch.algebra.compare.decode_order_value`'s): a
    decimal of byte storage as its unscaled integer, other byte rows as
    ``bytes``, booleans and numbers as python scalars."""
    from ..algebra.compare import decode_order_value
    from ..parallel.host_scan import order_view

    v = entry.values
    if isinstance(v, ByteRows):
        got = [decode_order_value(v.row(i), leaf) for i in range(len(v))]
    elif v.ndim == 2:
        got = [decode_order_value(r.tobytes(), leaf) for r in v]
    else:
        got = order_view(leaf, v).tolist()
    out = np.empty(len(got), object)
    out[:] = got
    return out


def _equals_itself(values: np.ndarray) -> np.ndarray:
    """False at a NaN, which equals no key."""
    if values.dtype.kind == "f":
        return values == values
    if values.dtype.kind == "O":
        return np.fromiter((v == v for v in values.tolist()), bool,
                           count=len(values))
    return np.ones(len(values), bool)


class _RowTable:
    """Every present row of a row group's fetched pages, sorted by a key
    of its own: its value in the leaf's order domain, or the hash of its
    bytes.  A key's candidate rows are one ``searchsorted`` away, however
    many pages its bounds span (a page index whose bounds were cut to a
    common prefix gives a key every page of that prefix)."""

    def __init__(self, entries: Dict[int, PageEntry], sort_key):
        parts, pages, rows = [], [], []
        for o in sorted(entries):
            e = entries[o]
            live = (np.arange(e.num_rows) if e.validity is None
                    else np.flatnonzero(e.validity))
            vals = sort_key(e)[live]
            keep = _equals_itself(vals)
            parts.append(vals[keep])
            pages.append(np.full(int(keep.sum()), o, np.int64))
            rows.append(live[keep])
        values = np.concatenate(parts)
        order = np.argsort(values, kind="stable")
        self.values = values[order]
        self.pages = np.concatenate(pages)[order]
        self.rows = np.concatenate(rows)[order]
        self.firsts = np.zeros(max(entries) + 1, np.int64)
        for o, e in entries.items():
            self.firsts[o] = e.first_row

    def match(self, key_pages, needles: np.ndarray, exact=None
              ) -> Dict[int, np.ndarray]:
        """``{uniq ordinal: ascending local rows}`` of the keys of
        ``key_pages``: the rows whose sort key is the key's ``needles``
        entry, on a page its bounds allow, and where ``exact(key index,
        page, row)`` is given, for which it holds.  A NaN needle matches
        nothing."""
        from ..ops.host import segment_ranges

        ok = _equals_itself(needles)
        if not ok.all():
            key_pages = [x for x, keep in zip(key_pages, ok.tolist())
                         if keep]
            needles = needles[ok]
        if not key_pages:
            return {}
        lo = np.searchsorted(self.values, needles, "left")
        hi = np.searchsorted(self.values, needles, "right")
        counts = hi - lo
        kidx = np.repeat(np.arange(len(needles)), counts)
        j = np.repeat(lo, counts) + segment_ranges(counts)
        pages, rows = self.pages[j], self.rows[j]
        first = np.array([ords[0] for _, ords in key_pages], np.int64)
        last = np.array([ords[-1] for _, ords in key_pages], np.int64)
        keep = (pages >= first[kidx]) & (pages <= last[kidx])
        # a key whose pages are not one run (the zone-map walk) checks
        # each candidate page
        for i, (_, ords) in enumerate(key_pages):
            if len(ords) != ords[-1] - ords[0] + 1 and counts[i]:
                sel = np.flatnonzero(kidx == i)
                allowed = set(ords)
                keep[sel] &= np.fromiter((p in allowed
                                          for p in pages[sel].tolist()),
                                         bool, count=len(sel))
        if exact is not None and keep.any():
            sel = np.flatnonzero(keep)
            keep[sel] = np.fromiter(
                (exact(i, p, r) for i, p, r in zip(
                    kidx[sel].tolist(), pages[sel].tolist(),
                    rows[sel].tolist())), bool, count=len(sel))
        kidx, rows = kidx[keep], self.firsts[pages[keep]] + rows[keep]
        order = np.lexsort((rows, kidx))
        kidx, rows = kidx[order], rows[order]
        cut = np.flatnonzero(np.diff(kidx)) + 1
        return {key_pages[int(part_k[0])][0]: part_r
                for part_k, part_r in zip(np.split(kidx, cut),
                                          np.split(rows, cut))
                if len(part_k)}


def _match(leaf, prep: _PreparedKeys, key_pages, entries,
           nulls_first: Optional[bool], counters: Dict[str, int]
           ) -> Dict[int, np.ndarray]:
    """The local rows equal to each key of ``key_pages`` in its fetched
    pages, ascending, by one :class:`_RowTable` a domain: numbers of the
    column's order domain (``prep.order``) by value; byte keys of a byte
    array or fixed-length column that is not a decimal by the rows'
    xxh64, each candidate's bytes then compared; every other key
    (booleans, decimals of byte storage) by its python value in the order
    domain.  The rows are those the reference's in-page binary search or
    exact mask gives."""
    from ..parallel.host_scan import order_view

    if nulls_first is not None:
        _count(counters, "binary_search_hits", _searches_answered(
            leaf, prep, key_pages, entries, nulls_first))
    first = next(iter(entries.values())).values
    if (prep.order is not None and isinstance(first, np.ndarray)
            and first.ndim == 1 and first.dtype.kind in "iuf"):
        table = _RowTable(entries, lambda e: order_view(leaf, e.values))
        needles = prep.order[np.fromiter((u for u, _ in key_pages), np.int64,
                                         count=len(key_pages))]
        return table.match(key_pages, needles.astype(table.values.dtype))
    hashed, rest = [], key_pages
    if _bytes_keyed(leaf) and prep.hashes is not None:
        hashed = [x for x in key_pages
                  if isinstance(prep.uniq[x[0]], (bytes, bytearray))]
        rest = [x for x in key_pages
                if not isinstance(prep.uniq[x[0]], (bytes, bytearray))]
    got: Dict[int, np.ndarray] = {}
    if hashed:
        def same_bytes(i, p, r):
            v = entries[p].values
            row = v.row(r) if isinstance(v, ByteRows) else v[r].tobytes()
            return row == prep.uniq[hashed[i][0]]

        table = _RowTable(entries, _row_hashes)
        got.update(table.match(hashed, prep.hashes[[u for u, _ in hashed]],
                               same_bytes))
    if rest:
        table = _RowTable(entries, lambda e: _row_objects(leaf, e))
        needles = np.empty(len(rest), object)
        needles[:] = [prep.uniq[u] for u, _ in rest]
        got.update(table.match(rest, needles))
    return got


def _searches_answered(leaf, prep: _PreparedKeys, key_pages, entries,
                       nulls_first: bool) -> int:
    """``binary_search_hits``, derived for parity with the reference: the
    (key, page) probes that the reference answers by a binary search
    within the page of a row group sorted by the key (the port matches
    every key against a :class:`_RowTable`, so no such search runs).  A
    page answers any key when all of it is null, and otherwise only where
    its nulls are one run at the declared end and it holds integers for
    an integer key or, outside a decimal, byte arrays for a bytes key."""
    from collections import Counter
    from itertools import chain

    verdict = {}  # page: 2 any key, 1 a key of its kind, 0 none
    for o, e in entries.items():
        v, valid = e.values, e.validity
        if valid is not None:
            k = int(valid.sum())
            if k == 0:
                verdict[o] = 2
                continue
            run = valid[e.num_rows - k:] if nulls_first else valid[:k]
            if not run.all():
                verdict[o] = 0
                continue
        if isinstance(v, ByteRows):
            verdict[o] = int(leaf.logical_kind != LogicalKind.DECIMAL)
        else:
            verdict[o] = int(v.ndim == 1 and v.dtype.kind in "iu")
    if not any(verdict.values()):
        return 0
    if isinstance(next(iter(entries.values())).values, ByteRows):
        kind_ok = [isinstance(prep.uniq[u], (bytes, bytearray))
                   for u, _ in key_pages]
    elif prep.order is not None and prep.order.dtype.kind in "iu":
        kind_ok = None  # integers of the column's domain, every one
    else:
        kind_ok = [isinstance(prep.uniq[u], (int, np.integer))
                   and not isinstance(prep.uniq[u], bool)
                   for u, _ in key_pages]
    if kind_ok is None:
        uses = Counter(chain.from_iterable(ords for _, ords in key_pages))
        return sum(n for o, n in uses.items() if verdict[o])
    return sum(verdict[o] == 2 or (verdict[o] == 1 and ok)
               for (_, ords), ok in zip(key_pages, kind_ok) for o in ords)


def _take(values, validity, idx: np.ndarray):
    """Row-aligned ``(values, validity)`` at ``idx``: byte rows become a
    list of ``bytes`` with None at null rows."""
    valid = None if validity is None else validity[idx]
    if isinstance(values, ByteRows):
        idx = idx.tolist()
        flags = [True] * len(idx) if valid is None else valid.tolist()
        return [values.row(i) if f else None
                for i, f in zip(idx, flags)], valid
    return values[idx], valid


def _gather_columns(pf, rg, per_uniq_rows: Dict[int, np.ndarray], out_leaves,
                    counters: Dict[str, int], device):
    """Each output column's row-aligned values at every matched row, read
    through one coalesced page fetch per chunk, then cut per key.  A key's
    validity is None when none of the pages its rows lie in carried one,
    as the reference concatenates it."""
    from ..utils.pool import lookup_admission

    us = list(per_uniq_rows)
    lens = np.array([len(per_uniq_rows[u]) for u in us], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    rows = np.concatenate([per_uniq_rows[u] for u in us])
    cols: Dict[int, Dict[str, tuple]] = {u: {} for u in us}
    for out_leaf in out_leaves:
        chunk = rg.column(out_leaf.column_index)
        oi = chunk.offset_index()
        if oi is None or not oi.page_locations:
            _count(counters, "chunk_fallbacks", 1)
            with lookup_admission().admit(
                    chunk.meta.total_compressed_size or 0):
                vals, valid = decode_aligned(chunk, device)
            got_vals, got_valid = _take(vals, valid, rows)
            has_valid = np.full(len(us), valid is not None)
        else:
            fetcher = _PageFetcher(pf, rg, chunk, counters, device)
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


def _gather_pages(entries: Dict[int, PageEntry], rows: np.ndarray,
                  ords: np.ndarray):
    """(values, validity, row_has_validity) at ``rows`` (page ``ords``);
    byte rows gather into a list."""
    first = next(iter(entries.values())).values
    if isinstance(first, ByteRows):
        vals = [None] * len(rows)
    else:
        vals = np.empty((len(rows),) + first.shape[1:], first.dtype)
    valid = np.ones(len(rows), bool)
    row_valid = np.zeros(len(rows), np.int64)
    by_page = np.argsort(ords, kind="stable")
    uo, cut = np.unique(ords[by_page], return_index=True)
    cut = np.append(cut, len(rows))
    for o, a, b in zip(uo.tolist(), cut[:-1].tolist(), cut[1:].tolist()):
        e = entries[o]
        sel = by_page[a:b]
        local = rows[sel] - e.first_row
        part, pvalid = _take(e.values, e.validity, local)
        if isinstance(vals, list):
            for i, v in zip(sel.tolist(), part):
                vals[i] = v
        else:
            vals[sel] = part
        if pvalid is not None:
            valid[sel] = pvalid
            row_valid[sel] = 1
    return vals, valid, row_valid


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _empty_values(leaf):
    """A key's values of ``leaf`` where it has no rows, in the reference's
    forms."""
    if leaf.physical_type == Type.BYTE_ARRAY:
        return []
    if leaf.physical_type == Type.FIXED_LEN_BYTE_ARRAY:
        return np.empty((0, leaf.type_length or 0), np.uint8)
    return np.empty(0, PHYSICAL_NP_DTYPE[leaf.physical_type])


def _validate_flat(pf, path: str):
    """The leaf at ``path``: a flat column or a leaf under optional
    structs; a repeated one raises ``ValueError``, as in the reference."""
    leaf = pf.schema.leaf(path)  # KeyError on an unknown column
    if leaf.max_repetition_level > 0:
        raise ValueError(f"column {path!r} is nested; find_rows matches "
                         "flat columns (the keyed-serving shape)")
    return leaf


def find_rows(pf, path: str, keys, columns: Optional[Sequence[str]] = None,
              device="cuda", policy=None, report=None) -> LookupResult:
    """Every row of ``pf`` where column ``path`` equals each of ``keys``.
    ``hits[i]`` of the result belongs to ``keys[i]``: ascending file-local
    rows and the row-aligned values of each of ``columns``.  NULL cells
    never match; a key outside the column's domain matches nothing.  The
    bloom probe and the page decodes run on ``device``: CUDA unless the
    caller names the CPU, and a CUDA request without a card raises.
    ``policy``/``report``: the module docstring; the result's ``report``
    is the call's."""
    t0 = time.perf_counter()
    with _oscope.maybe_op_scope("lookup.find_rows", file=pf._path,
                                keys=len(keys)):
        try:
            return _find_rows_impl(pf, path, keys, columns, device, policy,
                                   report)
        finally:
            # failures count too
            _M_FIND_S.observe(time.perf_counter() - t0)


def _find_rows_impl(pf, path, keys, columns, device, policy,
                    report) -> LookupResult:
    from .faults import resolve_policy
    from .reader import resolve_device

    dev = resolve_device(device)
    leaf = _validate_flat(pf, path)
    out_leaves = [_validate_flat(pf, c) for c in (columns or [])]
    pol, report = resolve_policy(pf, policy, report)
    prep = _prepare_keys(leaf, keys)
    _oscope.account(_METRIC["keys"], len(keys))
    if pol is None and report is None:
        counters, per_uniq = _lookup_file(pf, leaf, prep, out_leaves, dev)
    else:
        with pf._resilient_op(policy, report, "lookup"):
            counters, per_uniq = _lookup_file(
                pf, leaf, prep, out_leaves, dev,
                skip=pol is not None and pol.skip_corrupt, report=report)
    counters["keys"] = len(keys)
    res = LookupResult(_assemble_hits(keys, prep, per_uniq, out_leaves),
                       counters)
    res.report = report
    return res


def _lookup_file(pf, leaf, prep: _PreparedKeys, out_leaves, dev,
                 skip: bool = False, report=None):
    """The cascade over every row group of ``pf`` for a prepared batch:
    ``(counters, {uniq ordinal: [(file-local rows, {column: (values,
    validity)}), ...]})``, the keys not counted.  A row group's data error
    raises at its turn, or with ``skip`` drops the row group whole into
    ``report``."""
    from .cache import NEGS

    counters = _new_counters()
    per_uniq: Dict[int, List[tuple]] = {}
    if not prep.uniq:
        return counters, per_uniq
    row_groups = pf.row_groups
    alive_by_rg, neg_keys, probed, failed = _prune_row_groups(
        pf, row_groups, leaf, prep, counters, dev)
    rg_base = 0
    for rg, alive, neg_key, tried, err in zip(
            row_groups, alive_by_rg, neg_keys, probed, failed):
        got = None
        if err is None:
            try:
                with _rg_context(pf, rg, leaf):
                    got = _lookup_rg(pf, rg, leaf, prep, alive, out_leaves,
                                     counters, dev)
            except DeadlineError:
                raise
            except CorruptedError as e:
                err = e
        if err is not None:
            if not skip:
                raise err
            report.record_skip(rg.index, rows=rg.num_rows, error=err)
            rg_base += rg.num_rows
            continue
        if got is not None:
            rows_map, cols_map = got
            for u, rows in rows_map.items():
                per_uniq.setdefault(u, []).append((rows + rg_base,
                                                   cols_map[u]))
        if neg_key is not None and len(tried):
            # the row group's cascade ran to its end: what it left
            # unmatched is absent
            if got is not None:
                tried = tried[~np.isin(tried, np.fromiter(
                    got[0], np.int64, count=len(got[0])))]
            NEGS.add(neg_key, _uniq_keys(prep, tried))
        rg_base += rg.num_rows
    return counters, per_uniq


def _uniq_keys(prep: _PreparedKeys, us: np.ndarray) -> list:
    """The uniq keys at ordinals ``us`` (integers read off the key array
    in one call)."""
    if prep.order is not None and prep.order.dtype.kind in "iu":
        return prep.order[us].tolist()
    return [prep.uniq[u] for u in us.tolist()]


def _concat_values(vparts):
    if isinstance(vparts[0], list):
        return [v for p in vparts for v in p]
    return vparts[0] if len(vparts) == 1 else np.concatenate(vparts)


def _concat_validity(vparts, valparts):
    if all(v is None for v in valparts):
        return None
    return np.concatenate([v if v is not None else np.ones(len(p), bool)
                           for v, p in zip(valparts, vparts)])


def _assemble_hits(keys, prep: _PreparedKeys, per_uniq, out_leaves
                   ) -> List[KeyHits]:
    """One :class:`KeyHits` per uniq key, shared by its duplicates in the
    input; a key with no rows gets empty values and None validity."""
    names = [leaf.name for leaf in out_leaves]
    no_rows = np.empty(0, np.int64)
    no_values = {c: _empty_values(lf) for c, lf in zip(names, out_leaves)}
    lists = [c for c, v in no_values.items() if isinstance(v, list)]
    no_validity = dict.fromkeys(names)

    def empty(key) -> KeyHits:  # empty arrays shared, lists each their own
        values = dict(no_values)
        for c in lists:
            values[c] = []
        return KeyHits(key, no_rows, values, dict(no_validity))

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
            h.values[c] = _concat_values(vparts)
            h.validity[c] = _concat_validity(vparts,
                                             [p[1][c][1] for p in parts])
        return h

    built: Dict[int, KeyHits] = {}
    hits: List[KeyHits] = []
    for k, u in zip(keys, prep.key_map.tolist()):
        got = built.get(u)
        if got is None:
            got = build(u, k) if u >= 0 and u in per_uniq else empty(k)
            if u >= 0:
                built[u] = got
        hits.append(got)
    return hits


def dataset_find_rows(ds, path: str, keys,
                      columns: Optional[Sequence[str]] = None,
                      device="cuda", policy=None,
                      report=None) -> LookupResult:
    """:func:`find_rows` over every file of a
    :class:`~parquet_tpu_torch.dataset.Dataset`: the keys are normalized
    and hashed once for the corpus (``keys`` counted once), the files fan
    out on the shared pool (each on ``device``, schemas checked against the
    first), and the hits merge in file order with dataset-wide row
    ordinals (:meth:`~parquet_tpu_torch.dataset.Dataset.row_offsets`);
    the other counters are the files' sums.  Under a degraded ``policy``
    a file that cannot be opened or read drops as a unit
    (``report.files_skipped``); a skipped file whose footer parsed keeps
    its span of the row ordinals."""
    t0 = time.perf_counter()
    with _oscope.maybe_op_scope("dataset.find_rows", files=len(ds.paths),
                                keys=len(keys)):
        try:
            return _dataset_find_rows_impl(ds, path, keys, columns, device,
                                           policy, report)
        finally:
            _M_DS_FIND_S.observe(time.perf_counter() - t0)


def _dataset_find_rows_impl(ds, path, keys, columns, device, policy,
                            report) -> LookupResult:
    from ..utils.pool import map_in_order
    from .faults import NON_DATA_ERRORS, ReadReport
    from .reader import resolve_device

    dev = resolve_device(device)
    pol, report, skip = ds._resolve(policy, report)
    prep = leaf = None
    out_leaves = []
    for i in range(len(ds.paths)):  # the first footer that opens
        try:
            pf0 = ds.file(i)
        except DeadlineError:
            raise
        except NON_DATA_ERRORS:
            raise
        except (CorruptedError, OSError):
            if not skip:
                raise
            continue  # recorded by the per-file loop below
        ds._check_schema(pf0, ds.paths[i])
        leaf = _validate_flat(pf0, path)
        out_leaves = [_validate_flat(pf0, c) for c in (columns or [])]
        prep = _prepare_keys(leaf, keys)
        _oscope.account(_METRIC["keys"], len(keys))  # once a batch
        break

    def one(i):
        sub = ReadReport() if report is not None else None
        rows = 0
        try:
            pf = ds.file(i)
            ds._check_schema(pf, ds.paths[i])
            rows = pf.num_rows
            lf = pf.schema.leaf(path)
            outs = [pf.schema.leaf(c) for c in (columns or [])]
            if pol is None and sub is None:
                got = _lookup_file(pf, lf, prep, outs, dev)
            else:
                sub.bind(pf._path)
                with pf._resilient_op(pol, sub, "lookup"):
                    got = _lookup_file(pf, lf, prep, outs, dev,
                                       skip=skip, report=sub)
            return got, sub, rows, None
        except DeadlineError:
            raise
        except NON_DATA_ERRORS:
            raise
        except (CorruptedError, OSError) as e:
            if not skip:
                raise
            return None, sub, rows, e

    results = map_in_order(one, range(len(ds.paths)))
    counters = _new_counters()
    per_uniq: Dict[int, List[tuple]] = {}
    base = 0
    for i, (got, sub, rows, err) in enumerate(results):
        if got is None:
            if sub is not None:
                report.retries += sub.retries  # they happened
            report.record_file_skip(ds.paths[i], rows=rows, error=err)
            base += rows
            continue
        if report is not None and sub is not None:
            report.merge(sub)
        file_counters, parts = got
        for k, v in file_counters.items():
            counters[k] += v
        for u, ps in parts.items():
            per_uniq.setdefault(u, []).extend((r + base, c) for r, c in ps)
        base += rows
    if prep is None or len(report.files_skipped if report else ()) \
            == len(ds.paths):
        raise CorruptedError(
            "dataset find_rows: every file failed "
            f"({', '.join(report.files_skipped) if report else ''})")
    counters["keys"] = len(keys)
    res = LookupResult(_assemble_hits(keys, prep, per_uniq, out_leaves),
                       counters)
    res.report = report
    return res
