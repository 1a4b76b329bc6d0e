"""Process-wide caches of the lookup path: parsed footers, decoded pages,
and keys proven absent.

The port's cut of ``parquet_tpu/io/cache.py``.  Every tier keys a file by
its source's open-time ``stat_key`` = ``(absolute path, inode, mtime_ns,
size)`` (``io/source.py``), so a rewritten file cannot serve stale entries;
an in-memory source has no ``stat_key`` and is never cached.

- :data:`FOOTERS` (:class:`FooterCache`): the parsed ``FileMetaData`` and
  ``Schema`` of a file, so a reopen skips the tail preads and the thrift
  parse (``ParquetFile._open_footer``).  An LRU of
  ``PARQUET_TPU_TORCH_FOOTER_CACHE`` entries (256; ``0`` off).
- :data:`PAGES` (:class:`PageCache`): decoded row-aligned pages of the
  lookup path, keyed ``(file key, row group, leaf path, page ordinal)``:
  a warm key reads and decodes nothing.  A byte-capped LRU
  (``PARQUET_TPU_TORCH_PAGE_CACHE``, 64 MiB; ``0`` off); an entry larger
  than half the cap is refused; entries are frozen (read-only numpy that
  owns its bytes).
- :data:`NEGS` (:class:`NegLookupCache`): per chunk, the keys a lookup's
  cascade proved absent, so a repeated miss skips even the statistics and
  bloom stages (``neg_hits``).  A byte-capped LRU of chunks
  (``PARQUET_TPU_TORCH_NEG_LOOKUP``, 4 MiB; ``0`` off).

The port's writer calls :func:`invalidate_path` when it closes a path it
wrote, which closes the one gap of the fstat key: an in-place rewrite of
the same size inside one tick of the file system's clock.  Not in this
port: the whole-chunk ``ChunkCache`` (it serves the streamed reads), page
pins of the serving daemon's tenants, the resource ledger's accounts and
its reclaim pass.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.env import env_bytes, env_int

__all__ = ["CacheStats", "FooterCache", "PageCache", "NegLookupCache",
           "PageEntry", "ByteRows", "make_page_entry", "cache_stats",
           "clear_caches", "invalidate_path", "footer_cache_entries",
           "page_cache_bytes", "neg_lookup_cache_bytes", "FOOTERS", "PAGES",
           "NEGS"]


def footer_cache_entries() -> int:
    """The footer cache's capacity in entries (``0``: off), read per call."""
    return max(0, env_int("PARQUET_TPU_TORCH_FOOTER_CACHE"))


def page_cache_bytes() -> int:
    """The page cache's capacity in bytes (``0``: off), read per call."""
    return env_bytes("PARQUET_TPU_TORCH_PAGE_CACHE")


def neg_lookup_cache_bytes() -> int:
    """The negative-lookup memo's capacity in bytes (``0``: off)."""
    return env_bytes("PARQUET_TPU_TORCH_NEG_LOOKUP")


@dataclass
class CacheStats:
    """What the caches did: process-lifetime counters (diff two
    :func:`cache_stats` snapshots to meter one operation) and what each
    tier holds now."""

    footer_hits: int = 0
    footer_misses: int = 0
    footer_entries: int = 0
    page_hits: int = 0
    page_misses: int = 0
    page_evictions: int = 0
    page_entries: int = 0
    page_bytes: int = 0
    page_capacity: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FooterCache:
    """An entry-bounded LRU of parsed footers: key -> (FileMetaData,
    Schema).  Both are immutable after the open, so ParquetFile instances
    share them."""

    def __init__(self, stats: CacheStats):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Any]" = OrderedDict()
        self.stats = stats

    def get(self, key) -> Optional[Any]:
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                self.stats.footer_misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.footer_hits += 1
            return got

    def put(self, key, value) -> None:
        cap = footer_cache_entries()
        if cap <= 0:
            return
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = value
            while len(self._entries) > cap:
                self._entries.popitem(last=False)
            self.stats.footer_entries = len(self._entries)

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0] == ap]:
                del self._entries[key]
            self.stats.footer_entries = len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats.footer_entries = 0


class ByteRows(NamedTuple):
    """A byte-array page, row-aligned: row ``i`` is ``data[offsets[i]:
    offsets[i + 1]]`` (a null row is empty; the entry's validity says which
    rows are null)."""

    data: np.ndarray  # uint8
    offsets: np.ndarray  # int64[num_rows + 1]

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.offsets.nbytes

    def row(self, i: int) -> bytes:
        return self.data[self.offsets[i]:self.offsets[i + 1]].tobytes()


def _readonly(a):
    """A read-only view of ``a`` that owns its bytes: a view into a larger
    buffer (a slice of a whole decoded span, or of the file's map) is
    copied first, so a cached entry pins no more than it accounts for."""
    if a is None:
        return None
    if isinstance(a, ByteRows):
        return ByteRows(_readonly(a.data), _readonly(a.offsets))
    a = np.asarray(a)
    if a.base is not None:
        a = a.copy()
    v = a.view()
    v.flags.writeable = False
    return v


@dataclass(frozen=True)
class PageEntry:
    """One decoded page of a flat column, row-aligned: ``values`` has one
    entry a row (a read-only numpy array, ``(n, width)`` uint8 rows for
    FIXED_LEN_BYTE_ARRAY, or :class:`ByteRows` for BYTE_ARRAY; a null row
    holds a zero fill), ``validity`` a read-only bool mask or None (no
    nulls), ``first_row`` the page's first row within its row group.
    ``memo`` keeps what the lookup derives from the page once (the byte
    rows' hashes)."""

    values: Any
    validity: Optional[np.ndarray]
    first_row: int
    num_rows: int
    memo: dict = field(default_factory=dict, compare=False, repr=False)

    def nbytes(self) -> int:
        return int(self.values.nbytes) + (
            0 if self.validity is None else int(self.validity.nbytes))


def make_page_entry(values, validity, first_row: int,
                    num_rows: int) -> PageEntry:
    """A frozen :class:`PageEntry`, cached or not: a lookup's pages are
    read-only either way."""
    return PageEntry(_readonly(values), _readonly(validity), int(first_row),
                     int(num_rows))


class PageCache:
    """A byte-capped LRU of decoded pages (:class:`PageEntry`).  An entry
    larger than half the cap is refused, so one page cannot evict the
    whole working set; eviction is global and by size."""

    def __init__(self, stats: CacheStats):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[PageEntry, int]]" = \
            OrderedDict()
        self._bytes = 0
        self.stats = stats

    def get(self, key) -> Optional[PageEntry]:
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                self.stats.page_misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.page_hits += 1
            return got[0]

    def _publish_locked(self, cap: int) -> None:
        self.stats.page_entries = len(self._entries)
        self.stats.page_bytes = self._bytes
        self.stats.page_capacity = cap

    def _evict_locked(self, target: int) -> int:
        evicted = 0
        while self._bytes > max(0, target) and self._entries:
            _, (_, nb) = self._entries.popitem(last=False)
            self._bytes -= nb
            evicted += 1
        self.stats.page_evictions += evicted
        return evicted

    def put(self, key, values, validity, first_row: int,
            num_rows: int) -> PageEntry:
        """Freeze one decoded page and keep it when the cache is on and the
        page fits in half the cap; returns the frozen entry either way."""
        cap = page_cache_bytes()
        entry = make_page_entry(values, validity, first_row, num_rows)
        nb = entry.nbytes()
        if cap <= 0 or nb > cap // 2:
            return entry
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (entry, nb)
            self._bytes += nb
            self._evict_locked(cap)
            self._publish_locked(cap)
        return entry

    def shrink_to(self, target_bytes: int) -> int:
        """Evict LRU-first until the cache holds at most ``target_bytes``;
        returns how many entries went."""
        with self._lock:
            evicted = self._evict_locked(target_bytes)
            self._publish_locked(page_cache_bytes())
        return evicted

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0][0] == ap]:
                _, nb = self._entries.pop(key)
                self._bytes -= nb
            self._publish_locked(page_cache_bytes())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._publish_locked(page_cache_bytes())


def _key_nbytes(k) -> int:
    """What one memoized key costs the memo's cap: the JAX package's
    measure (64 bytes, and a byte string's length on top)."""
    if isinstance(k, (bytes, bytearray, str)):
        return 64 + len(k)
    return 64


class NegLookupCache:
    """Per chunk ``(file key, row group, leaf path)``, the set of keys the
    lookup's cascade proved absent.  A key enters only after its row
    group's cascade ran to its end without matching it; the memo is an LRU
    of chunks capped in bytes (:func:`_key_nbytes` a key)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, list]" = OrderedDict()
        self._bytes = 0

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def absent_mask(self, chunk_key, keys) -> Optional[np.ndarray]:
        """A bool per key of ``keys``: True where the chunk's memo holds
        it; None where the chunk has no memo."""
        with self._lock:
            got = self._entries.get(chunk_key)
            if got is None:
                return None
            self._entries.move_to_end(chunk_key)
            known = got[0]
            return np.fromiter((k in known for k in keys), bool,
                               count=len(keys))

    def add(self, chunk_key, keys) -> None:
        """Memoize the distinct ``keys`` as absent from the chunk, then
        evict the least recently used chunks down to the cap."""
        cap = neg_lookup_cache_bytes()
        if cap <= 0 or not len(keys):
            return
        with self._lock:
            if len(keys) * _key_nbytes(0) > cap:
                # the chunk's entry alone would pass the cap, so eviction
                # would empty the memo, this entry last: skip the inserts
                self._entries.clear()
                self._bytes = 0
                return
            got = self._entries.get(chunk_key)
            if got is None:
                got = self._entries[chunk_key] = [set(), 0]
            self._entries.move_to_end(chunk_key)
            known = got[0]
            for k in keys:
                if k not in known:
                    known.add(k)
                    nb = _key_nbytes(k)
                    got[1] += nb
                    self._bytes += nb
            while self._bytes > cap and self._entries:
                _, e = self._entries.popitem(last=False)
                self._bytes -= e[1]

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0][0] == ap]:
                self._bytes -= self._entries.pop(key)[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0


_STATS = CacheStats()
FOOTERS = FooterCache(_STATS)
PAGES = PageCache(_STATS)
NEGS = NegLookupCache()


def invalidate_path(path) -> None:
    """Drop every cached footer, page and absent-key memo of ``path``: the
    port's writer calls it when it closes a path it wrote, and a remote
    source when an object's HEAD validators moved (a URL is its own
    identity)."""
    path = os.fspath(path)
    ap = path if "://" in path else os.path.abspath(path)
    FOOTERS.invalidate_path(ap)
    PAGES.invalidate_path(ap)
    NEGS.invalidate_path(ap)


def cache_stats() -> CacheStats:
    """A snapshot of the caches' counters (a copy)."""
    s = dataclasses.replace(_STATS)
    s.page_capacity = page_cache_bytes()
    return s


def clear_caches(reset_stats: bool = False) -> None:
    """Drop every cached footer, page and absent-key memo (tests,
    benchmarks); ``reset_stats=True`` also zeroes the counters."""
    FOOTERS.clear()
    PAGES.clear()
    NEGS.clear()
    if reset_stats:
        _STATS.__dict__.update(CacheStats().__dict__)
