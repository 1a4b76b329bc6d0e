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
3. the page index: the page runs of every key at once (``searchsorted``
   over a cleanly ordered index's bounds, the zone-map walk over the
   sorted keys otherwise; :func:`_page_ords_of_keys`);
4. page reads: each needed page is looked up in the page cache
   (``io/cache.py::PAGES``) first (``page_cache_hits``); the others
   coalesce into runs of adjacent pages, one pread per run (and one for
   the dictionary, once per chunk), each run admitted through the lookup
   tier of the read gate (``utils/pool.py::lookup_admission``), decoded
   on the lookup's device (:mod:`~parquet_tpu_torch.parallel.
   device_reader`, whose dictionary and bit-packed streams launch the read
   path's kernels), copied back to host numpy row-aligned and cached page
   by page, frozen; then every key of the row group is matched at once in
   one C++ call (``csrc/host_lookup.cpp`` through
   :func:`~parquet_tpu_torch.ops.host.lookup_match`: the fetched rows
   sorted by value for numbers, by xxh64 for byte-array and fixed-length
   keys with each candidate's bytes compared), giving the rows the
   reference's in-page binary search or exact mask gives; booleans and
   decimals of byte storage match in numpy over python values.

The keys a row group's cascade leaves unmatched enter the memo.  A chunk
without a page index decodes whole (``chunk_fallbacks``) through the
decoded whole-chunk cache (``io/cache.py::CHUNKS``, the reference's
``ParquetFile._decode_chunk_ctx``): a hit is served gate-free and decodes
nothing, a miss is admitted at the chunk's compressed size, decoded on
the lookup's device and cached frozen.  The requested output columns are
read through the same cached, coalesced page runs (or whole chunks) and
gathered at the matched rows in one C++ call a column
(:func:`~parquet_tpu_torch.ops.host.lookup_gather`); a row group's result
stays in arrays until :func:`_assemble_hits` cuts it per key.  A
byte-array column's values come back as a list of ``bytes`` (None at a
null row), a fixed-length one's as ``(n, w)`` uint8 rows, as in the
reference.  Survivors, stage order and counters are the reference's.

Key sharding (:func:`_dispatch_probes`, the reference's rule; its floor
``PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD`` is 0, off, by default, where the
reference's is 1,024: shards ran slower than one thread on an H100 host,
whose stages 3-4 are mostly Python a page): a batch of at least twice the
floor in uniq keys splits into contiguous slices of the keys' sorted
order, each running stages 3-4 of every row group on a pool worker in the
caller's context; stages 0-2 stay whole for the batch (one ``bloom_check``
launch a lookup).  The shards share their page fetchers, so each page is
read and decoded once, and the C++ match and gather release the
interpreter lock, so they run side by side.  ``key_shards`` counts the
slices; the counters are the serial run's but for ``preads`` and
``pages_coalesced`` (the shards' runs of adjacent pages are shorter).

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
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..errors import CorruptedError, DeadlineError
from ..format.enums import BoundaryOrder, Type
from ..obs import scope as _oscope
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..schema.types import PHYSICAL_NP_DTYPE, LogicalKind
from ..utils.debug import counters as _debug_counters
from ..utils.env import env_int
from ..utils.locks import make_lock
from .cache import ByteRows, PageEntry

_M_FIND_S = _histogram("lookup.find_rows_s")
_M_DS_FIND_S = _histogram("dataset.find_rows_s")
# each counter key's registry family: lookup.<key>
_METRIC = {k: _counter("lookup." + k) for k in (
    "keys", "keys_pruned_stats", "keys_pruned_bloom", "keys_pruned_pages",
    "rows_matched", "preads", "pages_read", "pages_coalesced",
    "chunk_fallbacks", "neg_hits", "binary_search_hits", "key_shards")}


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
# every key in C++ and runs no such search.
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
    # what the cascade derives from the batch once (:func:`_is_bytes`,
    # :func:`_is_int`, :func:`_object_keys`, :func:`_key_bytes`)
    memo: dict = field(default_factory=dict, repr=False)


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


def _is_bytes(prep: _PreparedKeys) -> np.ndarray:
    """Which uniq keys are byte strings, once a batch."""
    got = prep.memo.get("is_bytes")
    if got is None:
        got = prep.memo["is_bytes"] = np.fromiter(
            (isinstance(k, (bytes, bytearray)) for k in prep.uniq), bool,
            count=len(prep.uniq))
    return got


def _is_int(prep: _PreparedKeys) -> np.ndarray:
    """Which uniq keys are integers (not booleans), once a batch."""
    got = prep.memo.get("is_int")
    if got is None:
        got = prep.memo["is_int"] = np.fromiter(
            (isinstance(k, (int, np.integer)) and not isinstance(k, bool)
             for k in prep.uniq), bool, count=len(prep.uniq))
    return got


def _object_keys(prep: _PreparedKeys) -> np.ndarray:
    """The uniq keys as an object array, once a batch."""
    got = prep.memo.get("objects")
    if got is None:
        got = np.empty(len(prep.uniq), object)
        got[:] = prep.uniq
        prep.memo["objects"] = got
    return got


def _key_bytes(prep: _PreparedKeys) -> Tuple[np.ndarray, np.ndarray]:
    """``(uint8 bytes, int64 offsets)`` of every uniq key, a key that is
    not a byte string empty: the needles' bytes of the C++ match, once a
    batch."""
    got = prep.memo.get("bytes")
    if got is None:
        parts = [bytes(k) if isinstance(k, (bytes, bytearray)) else b""
                 for k in prep.uniq]
        offs = np.zeros(len(parts) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, parts), np.int64, count=len(parts)),
                  out=offs[1:])
        got = prep.memo["bytes"] = (
            np.frombuffer(b"".join(parts), np.uint8), offs)
    return got


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
    """Decoded row-aligned pages of one column chunk for one role (the key
    column's match or an output column's gather): each requested page
    comes from the page cache when it is there; the others coalesce into
    runs of adjacent pages, each run one admitted pread and one device
    decode, and are cached page by page; the dictionary is read and
    decoded once per chunk, and only where a page is missing.  A chunk
    without a page index comes whole through :func:`_decode_chunk_ctx`
    (``chunk_fallbacks``).  What one fetcher got is kept, so the key
    shards of a lookup, which share their fetchers, read and decode each
    page once; a shared fetcher fetches under its own lock."""

    def __init__(self, pf, rg, chunk, device, shared: bool):
        self.pf = pf
        self.rg = rg
        self.chunk = chunk
        self.device = device
        self._lock = (make_lock("lookup.fetch", tier=False) if shared
                      else contextlib.nullcontext())
        self._got: Dict[int, PageEntry] = {}
        self._whole: Optional[PageEntry] = None
        self._dict = _UNSET
        self._locs = None
        fk = pf._cache_key
        # the CRC check is part of a page's identity: a page decoded
        # unchecked must not answer a reader that checks
        self._key_base = (None if fk is None
                          else (fk, rg.index, chunk.leaf.name,
                                pf.options.verify_crc))

    def _index(self):
        """The page locations and each page's first row, read at first
        use (a chunk without a page index never asks)."""
        if self._locs is None:
            locs = self.chunk.offset_index().page_locations
            self._firsts = np.asarray([pl.first_row_index for pl in locs],
                                      np.int64)
            self._locs = locs  # last: a racing shard sees both or neither
        return self._locs, self._firsts

    def page_rows(self, o: int) -> int:
        _, firsts = self._index()
        nxt = int(firsts[o + 1]) if o + 1 < len(firsts) else self.rg.num_rows
        return nxt - int(firsts[o])

    def ords_of_rows(self, rows: np.ndarray) -> np.ndarray:
        _, firsts = self._index()
        return np.maximum(np.searchsorted(firsts, rows, side="right") - 1, 0)

    def whole(self, counters: Dict[str, int]) -> PageEntry:
        """The whole chunk, once a fetcher: counted in ``chunk_fallbacks``
        and served by :func:`_decode_chunk_ctx`."""
        with self._lock:
            if self._whole is None:
                _count(counters, "chunk_fallbacks", 1)
                self._whole = _decode_chunk_ctx(self.pf, self.rg, self.chunk,
                                                self.device)
            return self._whole

    def _dictionary(self, counters: Dict[str, int]):
        if self._dict is _UNSET:
            from .reader import decode_dictionary_page
            from .search import dictionary_pages

            pages = list(dictionary_pages(self.chunk,
                                          self._index()[0][0].offset))
            if pages:
                _count(counters, "preads", 1)
                self._dict = decode_dictionary_page(self.chunk, pages[0])
                _debug_counters.inc("dict_pages_decoded")
            else:
                self._dict = None
        return self._dict

    def fetch(self, ords: np.ndarray, counters: Dict[str, int]
              ) -> Dict[int, PageEntry]:
        """The pages ``ords`` (ascending distinct ordinals)."""
        with self._lock:
            return self._fetch(ords, counters)

    def _fetch(self, ords, counters: Dict[str, int]) -> Dict[int, PageEntry]:
        from ..utils.pool import lookup_admission
        from .cache import PAGES, make_page_entry

        out: Dict[int, PageEntry] = {}
        missing: List[int] = []
        base = self._key_base
        for o in np.asarray(ords).tolist():  # a loop over pages
            entry = self._got.get(o)
            if entry is None and base is not None:
                entry = PAGES.get(base + (o,))
                if entry is not None:
                    counters["page_cache_hits"] += 1
                    self._got[o] = entry
            if entry is not None:
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
        locs, firsts = self._index()
        admission = lookup_admission()
        for run in runs:
            first, last = run[0], run[-1]
            span_start = locs[first].offset
            span_len = (locs[last].offset
                        + locs[last].compressed_page_size - span_start)
            with admission.admit(span_len):
                dictionary = self._dictionary(counters)
                pages = self.chunk.page_table_at(span_start, span_len,
                                                 num_pages=len(run))
                vals, valid = decode_aligned(self.chunk, self.device, pages,
                                             dictionary)
            _count(counters, "preads", 1)
            _count(counters, "pages_read", len(run))
            _count(counters, "pages_coalesced", len(run) - 1)
            at = int(firsts[first])
            for o in run:
                f = int(firsts[o])
                a, n = f - at, self.page_rows(o)
                pv = _slice_rows(vals, a, n)
                pvalid = None if valid is None else valid[a:a + n]
                out[o] = self._got[o] = (
                    PAGES.put(base + (o,), pv, pvalid, f, n)
                    if base is not None else
                    make_page_entry(pv, pvalid, f, n))
        return out


class _Fetchers:
    """One :class:`_PageFetcher` a (row group, column, role): a serial
    lookup makes a set a row group, a sharded one a set its shards
    share."""

    def __init__(self, pf, device, shared: bool):
        self.pf = pf
        self.device = device
        self.shared = shared
        self._by: Dict[tuple, _PageFetcher] = {}

    def get(self, rg, chunk, role: str) -> _PageFetcher:
        key = (rg.index, chunk.leaf.column_index, role)
        got = self._by.get(key)
        if got is None:
            # setdefault is atomic: two shards that race keep one fetcher
            got = self._by.setdefault(key, _PageFetcher(
                self.pf, rg, chunk, self.device, self.shared))
        return got


def _decode_chunk_ctx(pf, rg, chunk, device) -> PageEntry:
    """A whole chunk's row-aligned rows, as the reference's
    ``ParquetFile._decode_chunk_ctx`` serves the lookup: from the decoded
    whole-chunk cache (``io/cache.py::CHUNKS``) when the file has a cache
    key, gate-free on a hit; a miss is admitted through the lookup tier of
    the read gate at the chunk's compressed size, decoded on ``device``
    and put frozen.  A source without a cache key (in-memory bytes, an
    injector) neither fills the cache nor is served from it; its rows are
    frozen all the same."""
    from ..utils.pool import lookup_admission
    from .cache import CHUNKS, make_page_entry

    fk = pf._cache_key
    key = (None if fk is None
           else (fk, rg.index, chunk.leaf.name, pf.options.verify_crc))
    if key is not None:
        got = CHUNKS.get(key)
        if got is not None:
            return got
    with lookup_admission().admit(chunk.meta.total_compressed_size or 0):
        vals, valid = decode_aligned(chunk, device)
    if key is None:
        return make_page_entry(vals, valid, 0, rg.num_rows)
    return CHUNKS.put_and_freeze(key, vals, valid, rg.num_rows)


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


@dataclass
class _KeyPages:
    """Stage 3's answer for a row group: the uniq ordinals ``us`` of the
    keys some page may hold, each with its page run ``[lo, hi)`` and, where
    ``lists = (offsets, pages)`` gives a key a non-empty ascending list
    (the zone-map walk's pages, when they are not one run), only those
    pages."""

    us: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    lists: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def needed(self) -> np.ndarray:
        """The ascending distinct pages of every key."""
        if not len(self.us):
            return np.empty(0, np.int64)
        n = int(self.hi.max()) + 1
        edge = np.zeros(n + 1, np.int64)
        if self.lists is None:
            np.add.at(edge, self.lo, 1)
            np.add.at(edge, self.hi, -1)
            return np.flatnonzero(np.cumsum(edge)[:n] > 0)
        offs, pages = self.lists
        runs = offs[1:] == offs[:-1]
        np.add.at(edge, self.lo[runs], 1)
        np.add.at(edge, self.hi[runs], -1)
        return np.union1d(np.flatnonzero(np.cumsum(edge)[:n] > 0), pages)

    def per_key_sum(self, weight: np.ndarray) -> np.ndarray:
        """Each key's sum of ``weight`` (an array over page ordinals) over
        its pages."""
        csum = np.concatenate([[0], np.cumsum(weight)])
        got = csum[self.hi] - csum[self.lo]
        if self.lists is not None:
            offs, pages = self.lists
            listed = offs[1:] > offs[:-1]
            if listed.any():
                sums = np.add.reduceat(weight[pages], offs[:-1][listed])
                got[listed] = sums
        return got


def _key_pages_of_lists(us, lists: List[List[int]]) -> _KeyPages:
    """A :class:`_KeyPages` of per-key page lists (each non-empty and
    ascending)."""
    us = np.asarray(us, np.int64)
    lo = np.array([ords[0] for ords in lists], np.int64)
    hi = np.array([ords[-1] + 1 for ords in lists], np.int64)
    lens = np.array([len(ords) for ords in lists], np.int64)
    if np.array_equal(lens, hi - lo):
        return _KeyPages(us, lo, hi)
    offs = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(np.where(lens == hi - lo, 0, lens), out=offs[1:])
    pages = [p for ords, n, a, b in zip(lists, lens.tolist(), lo.tolist(),
                                        hi.tolist()) if n != b - a
             for p in ords]
    return _KeyPages(us, lo, hi, (offs, np.array(pages, np.int64)))


def _key_pages_of_pairs(us: np.ndarray, kidx: np.ndarray,
                        pg: np.ndarray) -> _KeyPages:
    """A :class:`_KeyPages` of (key index, page) pairs, the keys with no
    page dropped."""
    order = np.lexsort((pg, kidx))
    kidx, pg = kidx[order], pg[order]
    cnt = np.bincount(kidx, minlength=len(us))
    keep = cnt > 0
    offs = np.zeros(len(us) + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    lo = pg[offs[:-1][keep]]
    hi = pg[offs[1:][keep] - 1] + 1
    cnt = cnt[keep]
    if np.array_equal(cnt, hi - lo):
        return _KeyPages(us[keep], lo, hi)
    run = cnt == hi - lo
    loffs = np.zeros(len(cnt) + 1, np.int64)
    np.cumsum(np.where(run, 0, cnt), out=loffs[1:])
    listed = np.repeat(~run, cnt)
    return _KeyPages(us[keep], lo, hi, (loffs, pg[listed]))


def _walk_bounds(ci, leaf, domain):
    """The zone-map walk's bounds as arrays of ``domain`` (a numpy dtype,
    or ``bytes`` for an object array of byte strings): ``(pages with
    bounds, their mins, their maxs, open pages)``, an open page being a
    non-null page with a missing or NaN bound (it may hold any key); None
    when a bound is of another kind (the per-key walk then runs)."""
    from .search import decoded_bounds

    memo = getattr(ci, "_walk_bounds", None)
    if memo is None:
        memo = ci._walk_bounds = {}
    got = memo.get(domain, _UNSET)
    if got is not _UNSET:
        return got
    mins, maxs = decoded_bounds(ci, leaf)
    nulls = list(ci.null_pages or [])
    want = (bytes if domain is bytes
            else int if np.dtype(domain).kind in "iu" else float)
    bounded, open_ = [], []
    got = None
    for i, null in enumerate(nulls):
        if null:
            continue
        mn = mins[i] if i < len(mins) else None
        mx = maxs[i] if i < len(maxs) else None
        if mn is None or mx is None or mn != mn or mx != mx:
            open_.append(i)
        elif type(mn) is want and type(mx) is want:
            bounded.append(i)
        else:
            break
    else:
        dt = object if domain is bytes else domain
        got = (np.array(bounded, np.int64),
               np.array([mins[i] for i in bounded], dt),
               np.array([maxs[i] for i in bounded], dt),
               np.array(open_, np.int64))
    memo[domain] = got
    return got


def _walk_pairs(keys: np.ndarray, walk) -> Tuple[np.ndarray, np.ndarray]:
    """The zone-map walk (:func:`~.search.pages_overlapping`) for every key
    at once: the (key index, page) pairs with ``min <= key <= max`` on a
    bounded page, every key on an open page, and a NaN key (which compares
    False with every bound) on every non-null page."""
    from ..ops.host import segment_ranges

    pages, amin, amax, open_ = walk
    m = len(keys)
    nan = (keys != keys) if keys.dtype.kind == "f" else np.zeros(m, bool)
    ok = np.flatnonzero(~nan)
    order = ok[np.argsort(keys[ok], kind="stable")]
    sk = keys[order]
    a = np.searchsorted(sk, amin, "left")
    b = np.searchsorted(sk, amax, "right")
    cnt = np.maximum(b - a, 0)
    kidx = [order[np.repeat(a, cnt) + segment_ranges(cnt)]]
    pg = [np.repeat(pages, cnt)]
    if len(open_):
        kidx.append(np.tile(np.arange(m, dtype=np.int64), len(open_)))
        pg.append(np.repeat(open_, m))
    nan_idx = np.flatnonzero(nan)
    if len(nan_idx) and len(pages):
        kidx.append(np.repeat(nan_idx, len(pages)))
        pg.append(np.tile(pages, len(nan_idx)))
    return np.concatenate(kidx), np.concatenate(pg)


def _page_ords_of_keys(ci, leaf, prep: _PreparedKeys, alive: np.ndarray,
                       counters: Dict[str, int]) -> _KeyPages:
    """Stage 3's page search for the alive keys, on arrays of keys: a
    cleanly ascending index by ``searchsorted`` over its bounds, an index
    the binary search may not take (unordered, or with null pages or
    missing bounds) by the zone-map walk over the sorted keys
    (:func:`_walk_pairs`); the keys that no page may hold count in
    ``keys_pruned_pages``.  The per-key search of the reference
    (:func:`_key_page_ords`) still answers a NaN key on an ordered index,
    a DESCENDING index, an ordered index whose ladders do not ascend, and
    keys of the python-object domain (booleans, byte-stored decimals)."""
    got = None
    if prep.order is not None:
        keys = prep.order[alive]
        bounds = _sorted_bounds(ci, leaf, prep.order)
        if bounds is not None:
            got = _run_pages(ci, leaf, prep, alive, keys, bounds)
        elif not _ordered_searchable(ci, leaf):
            walk = _walk_bounds(ci, leaf, prep.order.dtype.type)
            if walk is not None:
                got = _key_pages_of_pairs(alive, *_walk_pairs(keys, walk))
    elif _bytes_keyed(leaf) and _is_bytes(prep)[alive].all():
        keys = _object_keys(prep)[alive]
        byte_bounds = _sorted_byte_bounds(ci, leaf)
        if byte_bounds is not None:
            mins, maxs = (np.array(b, object) for b in byte_bounds)
            lo = np.searchsorted(maxs, keys, "left")
            hi = np.searchsorted(mins, keys, "right")
            keep = lo < hi
            got = _KeyPages(alive[keep], lo[keep].astype(np.int64),
                            hi[keep].astype(np.int64))
        elif not _ordered_searchable(ci, leaf):
            walk = _walk_bounds(ci, leaf, bytes)
            if walk is not None:
                got = _key_pages_of_pairs(alive, *_walk_pairs(keys, walk))
    if got is None:  # the reference's search, key by key
        pairs = [(u, _key_page_ords(ci, leaf, prep.uniq[u]))
                 for u in alive.tolist()]
        pairs = [(u, ords) for u, ords in pairs if ords]
        got = (_key_pages_of_lists([u for u, _ in pairs],
                                   [ords for _, ords in pairs])
               if pairs else _KeyPages(*(np.empty(0, np.int64),) * 3))
    _count(counters, "keys_pruned_pages", len(alive) - len(got.us))
    return got


def _run_pages(ci, leaf, prep: _PreparedKeys, alive: np.ndarray,
               keys: np.ndarray, bounds) -> _KeyPages:
    """Page runs ``[searchsorted(maxs, key, 'left'), searchsorted(mins,
    key, 'right'))`` on a cleanly ascending index (:func:`_sorted_bounds`);
    a NaN key, which compares False with every bound, takes the reference's
    search."""
    amin, amax = bounds
    lo = np.searchsorted(amax, keys, side="left").astype(np.int64)
    hi = np.searchsorted(amin, keys, side="right").astype(np.int64)
    keep = lo < hi
    nan_pos = (np.flatnonzero(np.isnan(keys)) if keys.dtype.kind == "f"
               else np.empty(0, np.int64))
    listed = {}
    for i in nan_pos.tolist():  # NaN keys only
        ords = _key_page_ords(ci, leaf, prep.uniq[int(alive[i])])
        keep[i] = bool(ords)
        if ords:
            lo[i], hi[i] = ords[0], ords[-1] + 1
            if len(ords) != hi[i] - lo[i]:
                listed[i] = ords
    kept = np.flatnonzero(keep)
    if not listed:
        return _KeyPages(alive[kept], lo[kept], hi[kept])
    at = np.searchsorted(kept, np.fromiter(listed, np.int64))
    cnt = np.zeros(len(kept), np.int64)
    cnt[at] = [len(v) for v in listed.values()]
    offs = np.zeros(len(kept) + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    pages = np.concatenate([np.asarray(listed[i], np.int64)
                            for i in sorted(listed)])
    return _KeyPages(alive[kept], lo[kept], hi[kept], (offs, pages))


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


class _Part(NamedTuple):
    """A row group's hits, in arrays until :func:`_assemble_hits`: the
    matched keys' uniq ordinals ``us``; key ``j``'s rows are
    ``rows[offs[j]:offs[j + 1]]`` (ascending); ``cols[name]`` is the output
    column's ``(values, valid, row_valid)`` at those rows (values a numpy
    array or :class:`~.cache.ByteRows`, ``valid`` True where the row's
    page carried no validity, ``row_valid`` whether it carried one)."""

    us: np.ndarray
    offs: np.ndarray
    rows: np.ndarray
    cols: Dict[str, tuple]


def _lookup_rg(pf, rg, leaf, prep: _PreparedKeys, alive: np.ndarray,
               out_leaves, counters: Dict[str, int], device,
               fetchers: "_Fetchers") -> Optional[_Part]:
    """Stages 3-4 of one row group for its ``alive`` keys (the survivors
    of :func:`_prune_row_groups`, or a shard's slice of them): the page
    search, the page reads, the match and the gather of the output
    columns.  Returns the row group's :class:`_Part` (row-group rows), or
    None when no key matched."""
    if not len(alive):
        return None
    chunk = rg.column(leaf.column_index)
    ci = chunk.column_index()
    oi = chunk.offset_index()
    fetcher = fetchers.get(rg, chunk, "key")
    if ci is None or oi is None or not oi.page_locations:
        # the whole chunk, matched as an unsorted row group, as the
        # reference matches it there
        entries = {0: fetcher.whole(counters)}
        kp = _KeyPages(alive, np.zeros(len(alive), np.int64),
                       np.ones(len(alive), np.int64))
        nulls_first = None
    else:
        # ---- stage 3: the page index, then page reads
        kp = _page_ords_of_keys(ci, leaf, prep, alive, counters)
        if not len(kp.us):
            return None
        entries = fetcher.fetch(kp.needed(), counters)
        nulls_first = _rg_sorted_by(rg, leaf)
    us, offs, rows = _match(leaf, prep, kp, entries, nulls_first, counters)
    if not len(us):
        return None
    _count(counters, "rows_matched", len(rows))
    return _Part(us, offs, rows,
                 _gather_columns(rg, rows, out_leaves, counters, fetchers))


# ---------------------------------------------------------------------------
# stage 4's match: every key of a row group at once, against the rows of
# its fetched pages, in C++ (ops/host.py::lookup_match)
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


def _live_rows(entry: PageEntry) -> np.ndarray:
    """The present rows of a page, computed once an entry."""
    got = entry.memo.get("live")
    if got is None:
        got = entry.memo["live"] = (
            np.arange(entry.num_rows, dtype=np.int64)
            if entry.validity is None else np.flatnonzero(entry.validity))
    return got


# a numeric page's dtype kind -> the 8-byte key domain of the C++ match
def _number_kind(dtype: np.dtype) -> str:
    if dtype.kind == "f":
        return "f64"
    return "u64" if dtype == np.uint64 else "i64"


def _number_keys(leaf, entry: PageEntry) -> np.ndarray:
    """The present rows' values in the leaf's order domain, widened to the
    8-byte key of :func:`_number_kind`, computed once an entry."""
    from ..parallel.host_scan import order_view

    got = entry.memo.get("number_keys")
    if got is None:
        v = order_view(leaf, entry.values)
        dt = {"f64": np.float64, "u64": np.uint64,
              "i64": np.int64}[_number_kind(v.dtype)]
        got = entry.memo["number_keys"] = v[_live_rows(entry)].astype(dt)
    return got


def _row_table(entries: Dict[int, PageEntry], keys_of):
    """The present rows of the fetched pages in page and row order: their
    8-byte keys, page ordinals and rows in the page, and each page
    ordinal's first row and row count.  A loop over pages."""
    n = max(entries) + 1
    page_first = np.zeros(n, np.int64)
    page_rows = np.zeros(n, np.int64)
    keys, pages, local = [], [], []
    for o in sorted(entries):
        e = entries[o]
        page_first[o], page_rows[o] = e.first_row, e.num_rows
        live = _live_rows(e)
        keys.append(keys_of(e))
        pages.append(np.full(len(live), o, np.int64))
        local.append(live)
    return (np.concatenate(keys), np.concatenate(pages),
            np.concatenate(local), page_first, page_rows)


def _matched(us: np.ndarray, offs: np.ndarray, rows: np.ndarray):
    """``(us, offs, rows)`` without the keys that matched no row."""
    cnt = np.diff(offs)
    keep = cnt > 0
    if keep.all():
        return us, offs, rows
    new = np.zeros(int(keep.sum()) + 1, np.int64)
    np.cumsum(cnt[keep], out=new[1:])
    return us[keep], new, rows


def _subset(kp: _KeyPages, sel: np.ndarray) -> _KeyPages:
    """The keys ``sel`` (a bool mask) of ``kp``."""
    if kp.lists is None:
        return _KeyPages(kp.us[sel], kp.lo[sel], kp.hi[sel])
    from ..ops.host import segment_ranges

    offs, pages = kp.lists
    cnt = np.diff(offs)[sel]
    new = np.zeros(len(cnt) + 1, np.int64)
    np.cumsum(cnt, out=new[1:])
    idx = np.repeat(offs[:-1][sel], cnt) + segment_ranges(cnt)
    return _KeyPages(kp.us[sel], kp.lo[sel], kp.hi[sel], (new, pages[idx]))


def _match(leaf, prep: _PreparedKeys, kp: _KeyPages, entries,
           nulls_first: Optional[bool], counters: Dict[str, int]):
    """The rows equal to each key of ``kp`` in its fetched pages, as
    ``(us, offs, rows)`` of the keys that matched (row-group rows,
    ascending a key): numbers of the column's order domain (``prep.order``)
    by value, and byte keys of a byte array or fixed-length column that is
    not a decimal by the rows' xxh64 with each candidate's bytes compared,
    each domain in one C++ call (:func:`~parquet_tpu_torch.ops.host.
    lookup_match`); every other key (booleans, decimals of byte storage)
    by its python value in the order domain (:func:`_match_objects`).  The
    rows are those the reference's in-page binary search or exact mask
    gives."""
    from ..ops import host

    if nulls_first is not None:
        _count(counters, "binary_search_hits", _searches_answered(
            leaf, prep, kp, entries, nulls_first))
    first = next(iter(entries.values())).values
    if (prep.order is not None and isinstance(first, np.ndarray)
            and first.ndim == 1 and first.dtype.kind in "iuf"):
        from ..parallel.host_scan import order_view

        vdt = order_view(leaf, first[:0]).dtype
        kind = _number_kind(vdt)
        keys, pages, local, pfirst, prows = _row_table(
            entries, lambda e: _number_keys(leaf, e))
        # a needle compares as the column's values do (a float32 column
        # rounds it, as numpy compares a float32 array with a float)
        needles = prep.order[kp.us].astype(vdt)
        offs, rows = host.lookup_match(kind, keys, pages, local, pfirst,
                                       prows, needles, kp.lo, kp.hi,
                                       kp.lists)
        return _matched(kp.us, offs, rows)
    parts = []
    rest = kp
    if _bytes_keyed(leaf) and prep.hashes is not None:
        hashed = _is_bytes(prep)[kp.us]
        rest = _subset(kp, ~hashed) if not hashed.all() else None
        if hashed.any():
            sub = kp if rest is None else _subset(kp, hashed)
            keys, pages, local, pfirst, prows = _row_table(
                entries, lambda e: _row_hashes(e)[_live_rows(e)])
            values = [None] * len(pfirst)
            for o, e in entries.items():
                values[o] = e.values
            offs, rows = host.lookup_match(
                "hash", keys, pages, local, pfirst, prows,
                prep.hashes[sub.us], sub.lo, sub.hi, sub.lists,
                page_values=values, key_table=_key_bytes(prep),
                needle_ids=sub.us)
            parts.append(_matched(sub.us, offs, rows))
    if rest is not None and len(rest.us):
        parts.append(_match_objects(leaf, prep, rest, entries))
    if len(parts) == 1:
        return parts[0]
    us = np.concatenate([p[0] for p in parts])
    lens = np.concatenate([np.diff(p[1]) for p in parts])
    offs = np.zeros(len(us) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return us, offs, np.concatenate([p[2] for p in parts])


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


def _match_objects(leaf, prep: _PreparedKeys, kp: _KeyPages, entries):
    """:func:`_match` for keys of the python-object domain (booleans,
    decimals of byte storage), in numpy over python values: the rows are
    sorted by value and each key's candidates are one ``searchsorted``
    away; a key whose pages are not one run checks each candidate page."""
    from ..ops.host import segment_ranges

    parts, pages, rows = [], [], []
    firsts = np.zeros(max(entries) + 1, np.int64)
    for o in sorted(entries):
        e = entries[o]
        firsts[o] = e.first_row
        live = _live_rows(e)
        vals = _row_objects(leaf, e)[live]
        keep = _equals_itself(vals)
        parts.append(vals[keep])
        pages.append(np.full(int(keep.sum()), o, np.int64))
        rows.append(live[keep])
    values = np.concatenate(parts)
    order = np.argsort(values, kind="stable")
    values = values[order]
    tpages = np.concatenate(pages)[order]
    trows = np.concatenate(rows)[order]
    needles = np.empty(len(kp.us), object)
    needles[:] = [prep.uniq[u] for u in kp.us.tolist()]
    # a NaN needle matches nothing, and is kept out of the search (numpy's
    # search of object arrays assumes the needles compare)
    ok = np.flatnonzero(_equals_itself(needles))
    lo = np.zeros(len(needles), np.int64)
    counts = np.zeros(len(needles), np.int64)
    lo[ok] = np.searchsorted(values, needles[ok], "left")
    counts[ok] = np.searchsorted(values, needles[ok], "right") - lo[ok]
    kidx = np.repeat(np.arange(len(needles)), counts)
    j = np.repeat(lo, counts) + segment_ranges(counts)
    pg, rw = tpages[j], trows[j]
    keep = (pg >= kp.lo[kidx]) & (pg < kp.hi[kidx])
    if kp.lists is not None:
        loffs, lpages = kp.lists
        for i in np.flatnonzero(np.diff(loffs) > 0).tolist():
            sel = np.flatnonzero(kidx == i)
            keep[sel] &= np.isin(pg[sel], lpages[loffs[i]:loffs[i + 1]])
    kidx, out = kidx[keep], firsts[pg[keep]] + rw[keep]
    order = np.lexsort((out, kidx))
    kidx, out = kidx[order], out[order]
    offs = np.zeros(len(needles) + 1, np.int64)
    np.cumsum(np.bincount(kidx, minlength=len(needles)), out=offs[1:])
    return _matched(kp.us, offs, out)


def _searches_answered(leaf, prep: _PreparedKeys, kp: _KeyPages, entries,
                       nulls_first: bool) -> int:
    """``binary_search_hits``, derived for parity with the reference: the
    (key, page) probes that the reference answers by a binary search
    within the page of a row group sorted by the key (the port matches
    every key in C++, so no such search runs).  A page answers any key
    when all of it is null, and otherwise only where its nulls are one run
    at the declared end and it holds integers for an integer key or,
    outside a decimal, byte arrays for a bytes key.  A loop over pages;
    the keys are summed on arrays."""
    verdict = np.zeros(max(entries) + 1, np.int64)  # 2 any key, 1 its kind
    for o, e in entries.items():
        v, valid = e.values, e.validity
        if valid is not None:
            k = int(valid.sum())
            if k == 0:
                verdict[o] = 2
                continue
            run = valid[e.num_rows - k:] if nulls_first else valid[:k]
            if not run.all():
                continue
        if isinstance(v, ByteRows):
            verdict[o] = int(leaf.logical_kind != LogicalKind.DECIMAL)
        else:
            verdict[o] = int(v.ndim == 1 and v.dtype.kind in "iu")
    if not verdict.any():
        return 0
    if isinstance(next(iter(entries.values())).values, ByteRows):
        kind_ok = _is_bytes(prep)[kp.us]
    elif prep.order is not None and prep.order.dtype.kind in "iu":
        return int(kp.per_key_sum(verdict > 0).sum())
    else:
        kind_ok = _is_int(prep)[kp.us]
    anykey = kp.per_key_sum(verdict == 2)
    itskind = kp.per_key_sum(verdict == 1)
    return int(anykey.sum() + itskind[kind_ok].sum())


def _gather_columns(rg, rows: np.ndarray, out_leaves,
                    counters: Dict[str, int], fetchers: "_Fetchers"
                    ) -> Dict[str, tuple]:
    """Each output column's row-aligned ``(values, valid, row_valid)`` at
    the matched ``rows``, read through one coalesced page fetch per chunk
    (or the whole chunk) and gathered in one C++ call
    (:func:`~parquet_tpu_torch.ops.host.lookup_gather`)."""
    from ..ops import host

    cols: Dict[str, tuple] = {}
    for out_leaf in out_leaves:
        chunk = rg.column(out_leaf.column_index)
        fetcher = fetchers.get(rg, chunk, "out")
        oi = chunk.offset_index()
        if oi is None or not oi.page_locations:
            pages = [fetcher.whole(counters)]
        else:
            got = fetcher.fetch(np.unique(fetcher.ords_of_rows(rows)),
                                counters)
            pages = [got[o] for o in sorted(got)]
        vals, valid, row_valid = host.lookup_gather(
            [(e.first_row, e.num_rows, e.values, e.validity) for e in pages],
            rows)
        if isinstance(vals, tuple):
            vals = ByteRows(*vals)
        cols[out_leaf.name] = (vals, valid, row_valid)
    return cols


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
        counters, parts = _lookup_file(pf, leaf, prep, out_leaves, dev)
    else:
        with pf._resilient_op(policy, report, "lookup"):
            counters, parts = _lookup_file(
                pf, leaf, prep, out_leaves, dev,
                skip=pol is not None and pol.skip_corrupt, report=report)
    counters["keys"] = len(keys)
    res = LookupResult(_assemble_hits(keys, prep, parts, out_leaves),
                       counters)
    res.report = report
    return res


def _lookup_file(pf, leaf, prep: _PreparedKeys, out_leaves, dev,
                 skip: bool = False, report=None):
    """The cascade over every row group of ``pf`` for a prepared batch:
    ``(counters, parts)``, each :class:`_Part` with file-local rows, in
    row-group order, the keys not counted.  A row group's data error
    raises at its turn, or with ``skip`` drops the row group whole into
    ``report``."""
    from .cache import NEGS

    counters = _new_counters()
    if not prep.uniq:
        return counters, []
    row_groups = pf.row_groups
    alive_by_rg, neg_keys, probed, failed = _prune_row_groups(
        pf, row_groups, leaf, prep, counters, dev)
    got_by_rg = _dispatch_probes(pf, row_groups, leaf, prep, alive_by_rg,
                                 failed, out_leaves, counters, dev, skip)
    parts: List[_Part] = []
    rg_base = 0
    for rg, neg_key, tried, err, got in zip(row_groups, neg_keys, probed,
                                            failed, got_by_rg):
        if isinstance(got, CorruptedError):
            err = got
        if err is not None:
            if not skip:
                raise err
            report.record_skip(rg.index, rows=rg.num_rows, error=err)
            rg_base += rg.num_rows
            continue
        parts.extend(p._replace(rows=p.rows + rg_base) for p in got)
        if neg_key is not None and len(tried):
            # the row group's cascade ran to its end: what it left
            # unmatched is absent
            if got:
                tried = tried[~np.isin(tried, np.concatenate(
                    [p.us for p in got]))]
            NEGS.add(neg_key, _uniq_keys(prep, tried))
        rg_base += rg.num_rows
    return counters, parts


def _key_shard_min() -> int:
    """The fewest uniq keys a shard takes before a large batch fans its
    row groups' stages 3-4 out across pool workers
    (``PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD``; ``0``, the port's default,
    no sharding: the reference's 1,024 made phase 5's lookup slower on
    an H100 host, PERF.md)."""
    return max(0, env_int("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD"))


def _dispatch_probes(pf, row_groups, leaf, prep: _PreparedKeys,
                     alive_by_rg, failed, out_leaves,
                     counters: Dict[str, int], dev, skip: bool) -> list:
    """Stages 3-4 of every row group: for each, its list of
    :class:`_Part` (row-group rows), or the ``CorruptedError`` that
    stopped it (None for a row group stages 0-2 already failed).

    Key sharding, the reference's rule: when the floor
    (:func:`_key_shard_min`) is set, the batch holds at least twice it in
    uniq keys, the policy does not skip corrupt row groups, the caller is
    not itself on the shared pool (a dataset lookup's per-file workers
    stay serial) and no row group failed stages 0-2, the uniq keys split
    into ``min(pool_width(), nuniq // floor)`` contiguous slices of their
    sorted order, each slice running stages 3-4 over every row group on a
    pool worker (:func:`~parquet_tpu_torch.utils.pool.map_in_order`, in
    the caller's context: its op scope, deadline and page pin), starting
    at its own row group.  The shards share one :class:`_Fetchers`, so
    each page and whole chunk is read and decoded once; the C++ match and
    gather release the interpreter lock, so the shards' matches and
    gathers run side by side.  ``key_shards`` counts the slices."""
    from ..utils.pool import in_shared_pool, map_in_order, pool_width

    floor = _key_shard_min()
    nuniq = len(prep.uniq)
    nshards = 0
    if floor and nuniq >= 2 * floor and not skip and not in_shared_pool() \
            and not any(e is not None for e in failed):
        nshards = min(pool_width(), nuniq // floor)
    if nshards < 2:
        out = []
        for rg, alive, err in zip(row_groups, alive_by_rg, failed):
            if err is not None:
                out.append(None)
                continue
            try:
                with _rg_context(pf, rg, leaf):
                    got = _lookup_rg(pf, rg, leaf, prep, alive, out_leaves,
                                     counters, dev,
                                     _Fetchers(pf, dev, shared=False))
            except DeadlineError:
                raise
            except CorruptedError as e:
                if not skip:
                    raise
                out.append(e)
                continue
            out.append([] if got is None else [got])
        return out
    _count(counters, "key_shards", nshards)
    rank = np.empty(nuniq, np.int64)
    rank[_key_order(prep)] = np.arange(nuniq, dtype=np.int64)
    cuts = np.linspace(0, nuniq, nshards + 1).astype(np.int64)
    shard_of = np.searchsorted(cuts[1:], rank, side="right")
    fetchers = _Fetchers(pf, dev, shared=True)
    shard_counters = [_new_counters() for _ in range(nshards)]
    nrg = len(row_groups)

    def one(si: int) -> Dict[int, _Part]:
        got_by = {}
        start = si * nrg // nshards
        for j in list(range(start, nrg)) + list(range(start)):
            alive = alive_by_rg[j]
            mine = alive[shard_of[alive] == si]
            if not len(mine):
                continue
            with _rg_context(pf, row_groups[j], leaf):
                got = _lookup_rg(pf, row_groups[j], leaf, prep, mine,
                                 out_leaves, shard_counters[si], dev,
                                 fetchers)
            if got is not None:
                got_by[j] = got
        return got_by

    shards = map_in_order(one, range(nshards))
    for sc in shard_counters:
        # the registry saw each shard's counts once already
        for k, v in sc.items():
            counters[k] += v
    return [[s[j] for s in shards if j in s] for j in range(nrg)]


def _key_order(prep: _PreparedKeys) -> np.ndarray:
    """The uniq ordinals in the keys' sorted order where they have one (a
    slice of it touches few pages of a file sorted by the key), else in
    arrival order."""
    if prep.order is not None:
        return np.argsort(prep.order, kind="stable")
    if _is_bytes(prep).all():
        return np.argsort(_object_keys(prep), kind="stable")
    return np.arange(len(prep.uniq), dtype=np.int64)


def _uniq_keys(prep: _PreparedKeys, us: np.ndarray) -> list:
    """The uniq keys at ordinals ``us`` (integers read off the key array
    in one call)."""
    if prep.order is not None and prep.order.dtype.kind in "iu":
        return prep.order[us].tolist()
    return [prep.uniq[u] for u in us.tolist()]


def _flat_values(vparts: list):
    """One column's values of several parts, concatenated."""
    if isinstance(vparts[0], ByteRows):
        sizes = np.array([len(p.data) for p in vparts], np.int64)
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        offs = np.concatenate([vparts[0].offsets[:1]] + [
            p.offsets[1:] - p.offsets[0] + b
            for p, b in zip(vparts, base.tolist())])
        return ByteRows(np.concatenate([p.data for p in vparts]), offs)
    return vparts[0] if len(vparts) == 1 else np.concatenate(vparts)


def _assemble_hits(keys, prep: _PreparedKeys, parts: List[_Part],
                   out_leaves) -> List[KeyHits]:
    """One :class:`KeyHits` per uniq key, shared by its duplicates in the
    input; a key with no rows gets empty values and None validity.  The
    parts' arrays are put in key order at once; a key's validity of a
    column is None when none of its rows' pages carried one, as the
    reference concatenates it."""
    from ..ops import host
    from ..ops.host import segment_ranges

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

    found: Dict[int, Tuple[int, int]] = {}
    if parts:
        us = np.concatenate([p.us for p in parts])
        lens = np.concatenate([np.diff(p.offs) for p in parts])
        sizes = np.array([len(p.rows) for p in parts], np.int64)
        base = np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                         [len(p.us) for p in parts])
        starts = np.concatenate([p.offs[:-1] for p in parts]) + base
        order = np.argsort(us, kind="stable")  # a key's parts in file order
        lens = lens[order]
        idx = np.repeat(starts[order], lens) + segment_ranges(lens)
        rows = np.concatenate([p.rows for p in parts])[idx]
        ku, first = np.unique(us[order], return_index=True)
        bounds = np.concatenate([np.concatenate([[0], np.cumsum(lens)])[
            first], [len(idx)]])
        cols = {}
        for c in names:
            vals = _flat_values([p.cols[c][0] for p in parts])
            valid = np.concatenate([p.cols[c][1] for p in parts])[idx]
            row_valid = np.concatenate([p.cols[c][2] for p in parts])[idx]
            has_valid = np.maximum.reduceat(row_valid, bounds[:-1]) \
                if len(idx) else np.zeros(0, bool)
            if isinstance(vals, ByteRows):
                data, offs = host.gather_byte_arrays(vals.data, vals.offsets,
                                                     idx)
                vals = (data.tobytes(), offs.tolist(), valid.tolist())
            else:
                vals = vals[idx]
            cols[c] = (vals, valid, has_valid)
        found = {u: (a, b, i) for i, (u, a, b) in enumerate(zip(
            ku.tolist(), bounds[:-1].tolist(), bounds[1:].tolist()))}

    def build(key, a: int, b: int, i: int) -> KeyHits:
        h = KeyHits(key, rows[a:b])
        for c in names:
            vals, valid, has_valid = cols[c]
            if isinstance(vals, tuple):  # byte rows: bytes, None at a null
                buf, offs, ok = vals
                h.values[c] = [buf[offs[r]:offs[r + 1]] if ok[r] else None
                               for r in range(a, b)]
            else:
                h.values[c] = vals[a:b]
            h.validity[c] = valid[a:b] if has_valid[i] else None
        return h

    built: Dict[int, KeyHits] = {}
    hits: List[KeyHits] = []
    for k, u in zip(keys, prep.key_map.tolist()):
        got = built.get(u)
        if got is None:
            where = found.get(u)
            got = build(k, *where) if where is not None else empty(k)
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
    parts: List[_Part] = []
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
        file_counters, file_parts = got
        for k, v in file_counters.items():
            counters[k] += v
        parts.extend(p._replace(rows=p.rows + base) for p in file_parts)
        base += rows
    if prep is None or len(report.files_skipped if report else ()) \
            == len(ds.paths):
        raise CorruptedError(
            "dataset find_rows: every file failed "
            f"({', '.join(report.files_skipped) if report else ''})")
    counters["keys"] = len(keys)
    res = LookupResult(_assemble_hits(keys, prep, parts, out_leaves),
                       counters)
    res.report = report
    return res
