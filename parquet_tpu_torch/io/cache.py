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
the same size inside one tick of the file system's clock.

Every tier moves the JAX package's ``cache.*`` counters through
``obs.scope.account`` (so an op's report holds its own hits and misses)
and keeps its resource-ledger account (``cache.footer``, ``cache.page``,
``cache.neg_lookup``) current inside the critical section that moves its
bytes; each registers a reclaimer that the ledger's soft watermark runs,
and ``top_entries`` lists its largest entries for ``/debugz``.

Tenant pins (the serving daemon's page-residency contract): inside
:func:`page_pin_scope` every page the block's lookups put in the page
cache lands pinned to the tenant, exempt from the LRU's and the soft
watermark's eviction, until the tenant's pinned bytes reach its cap; a
page past the cap goes to the LRU (``cache.page_pin_refusals``).  Pinned
bytes are charged to the ``cache.page_pinned`` ledger account and the
``cache.page_pinned_bytes`` gauge, and :meth:`PageCache.unpin_tenant`
hands a tenant's pages back to the LRU.  Not in this port: the
whole-chunk ``ChunkCache`` (it serves the host whole-chunk reads), whose
families (``cache.chunk_*``, the ``cache.chunk`` account) stay at 0.
"""

from __future__ import annotations

import contextvars
import dataclasses
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from ..obs.ledger import LEDGER, ledger_account
from ..obs.ledger import maybe_check_pressure as _maybe_pressure
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.scope import account as _account
from ..utils.env import env_bytes, env_int

__all__ = ["CacheStats", "FooterCache", "PageCache", "NegLookupCache",
           "PageEntry", "ByteRows", "make_page_entry", "cache_stats",
           "clear_caches", "invalidate_path", "footer_cache_entries",
           "page_cache_bytes", "neg_lookup_cache_bytes", "page_pin_scope",
           "current_pin", "FOOTERS", "PAGES", "NEGS"]


def footer_cache_entries() -> int:
    """The footer cache's capacity in entries (``0``: off), read per call."""
    return max(0, env_int("PARQUET_TPU_TORCH_FOOTER_CACHE"))


def page_cache_bytes() -> int:
    """The page cache's capacity in bytes (``0``: off), read per call."""
    return env_bytes("PARQUET_TPU_TORCH_PAGE_CACHE")


def neg_lookup_cache_bytes() -> int:
    """The negative-lookup memo's capacity in bytes (``0``: off)."""
    return env_bytes("PARQUET_TPU_TORCH_NEG_LOOKUP")


_M_FOOTER_HITS = _counter("cache.footer_hits")
_M_FOOTER_MISSES = _counter("cache.footer_misses")
_M_FOOTER_ENTRIES = _gauge("cache.footer_entries")
_M_PAGE_HITS = _counter("cache.page_hits")
_M_PAGE_MISSES = _counter("cache.page_misses")
_M_PAGE_EVICTIONS = _counter("cache.page_evictions")
_M_PAGE_ENTRIES = _gauge("cache.page_entries")
_M_PAGE_BYTES = _gauge("cache.page_bytes")
_M_PAGE_PINS = _counter("cache.page_pins")
_M_PAGE_PIN_REFUSALS = _counter("cache.page_pin_refusals")
_M_PAGE_PINNED_BYTES = _gauge("cache.page_pinned_bytes")

# the ledger's accounts, moved inside the critical sections that move each
# tier's own bytes, so the ledger cannot drift from the tier
_ACC_PAGE = ledger_account("cache.page", capacity=page_cache_bytes)
_ACC_PINNED = ledger_account("cache.page_pinned")
_ACC_FOOTER = ledger_account("cache.footer")
_ACC_NEG = ledger_account("cache.neg_lookup",
                          capacity=neg_lookup_cache_bytes)


# the active (tenant, pin cap in bytes): a context variable, so the pins
# follow a request's work onto pool workers as its op scope does
_PIN: "contextvars.ContextVar[Optional[Tuple[str, int]]]" = \
    contextvars.ContextVar("parquet_tpu_torch_page_pin", default=None)


def current_pin() -> "Optional[Tuple[str, int]]":
    """The active ``(tenant, cap_bytes)`` pin contract, or None."""
    return _PIN.get()


@contextmanager
def page_pin_scope(tenant: str, cap_bytes: int):
    """Pin, for ``tenant``, every page the block puts in the page cache,
    until the tenant's pinned bytes would pass ``cap_bytes``
    (:class:`PageCache`).  A cap of 0 or less pins nothing."""
    if cap_bytes <= 0:
        yield
        return
    token = _PIN.set((tenant, int(cap_bytes)))
    try:
        yield
    finally:
        _PIN.reset(token)


def _top_entries(items: list, n: int) -> list:
    """The largest ``(key, nbytes)`` pairs, as ``/debugz`` shows them."""
    items.sort(key=lambda kv: kv[1], reverse=True)
    return [{"key": [str(p) for p in k], "bytes": nb}
            for k, nb in items[:n]]


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
    page_pins: int = 0
    page_pin_refusals: int = 0
    page_pinned_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FooterCache:
    """An entry-bounded LRU of parsed footers: key -> (FileMetaData,
    Schema).  Both are immutable after the open, so ParquetFile instances
    share them.  An entry weighs its serialized footer's length in the
    ledger (what the parsed structures pin grows with it)."""

    def __init__(self, stats: CacheStats):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.stats = stats

    def get(self, key) -> Optional[Any]:
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                self.stats.footer_misses += 1
                _account(_M_FOOTER_MISSES)
                return None
            self._entries.move_to_end(key)
            self.stats.footer_hits += 1
            _account(_M_FOOTER_HITS)
            return got[0]

    def _publish_locked(self) -> None:
        self.stats.footer_entries = len(self._entries)
        _M_FOOTER_ENTRIES.set(len(self._entries))
        _ACC_FOOTER.set(self._bytes)

    def put(self, key, value, nbytes: int = 0) -> None:
        cap = footer_cache_entries()
        if cap <= 0:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while len(self._entries) > cap:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
            self._publish_locked()
        _maybe_pressure()

    def top_entries(self, n: int = 10) -> list:
        """The largest cached footers by bytes (``/debugz``)."""
        with self._lock:
            items = [(k, nb) for k, (_, nb) in self._entries.items()]
        return _top_entries(items, n)

    def shrink_to(self, target_entries: int) -> int:
        """Evict LRU-first down to ``target_entries`` (the soft-pressure
        response); returns how many entries went."""
        evicted = 0
        with self._lock:
            while len(self._entries) > max(0, target_entries):
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted += 1
            self._publish_locked()
        return evicted

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0] == ap]:
                self._bytes -= self._entries.pop(key)[1]
            self._publish_locked()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._publish_locked()


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
    whole working set; eviction is global and by size.

    Beside the LRU, the pinned region: entries keyed as the LRU's but
    charged to the tenant that pinned them (:func:`page_pin_scope`).
    They serve :meth:`get` first, no cap or pressure evicts them, and they
    count against the tenant's pin cap, not the LRU's;
    :meth:`unpin_tenant` moves a tenant's pins back into the LRU."""

    def __init__(self, stats: CacheStats):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[PageEntry, int]]" = \
            OrderedDict()
        self._bytes = 0
        # key -> (entry, nbytes, tenant); each tenant's pinned bytes
        self._pinned: "Dict[tuple, Tuple[PageEntry, int, str]]" = {}
        self._pin_bytes: "Dict[str, int]" = {}
        self.stats = stats

    def get(self, key) -> Optional[PageEntry]:
        with self._lock:
            pinned = self._pinned.get(key)
            if pinned is not None:
                self.stats.page_hits += 1
                _account(_M_PAGE_HITS)
                return pinned[0]
            got = self._entries.get(key)
            if got is None:
                self.stats.page_misses += 1
                _account(_M_PAGE_MISSES)
                return None
            self._entries.move_to_end(key)
            self.stats.page_hits += 1
            _account(_M_PAGE_HITS)
            return got[0]

    def pinned_bytes(self, tenant: Optional[str] = None) -> int:
        """The bytes pinned by ``tenant``, or by every tenant."""
        with self._lock:
            if tenant is not None:
                return self._pin_bytes.get(tenant, 0)
            return sum(self._pin_bytes.values())

    def unpin_tenant(self, tenant: str) -> int:
        """Move every page ``tenant`` pinned back into the LRU (as the
        most recently used: they were hot) and drop its pinned bytes;
        returns how many pages moved.  The LRU's cap applies again."""
        moved = 0
        cap = page_cache_bytes()
        with self._lock:
            for key in [k for k, v in self._pinned.items()
                        if v[2] == tenant]:
                entry, nb, _ = self._pinned.pop(key)
                moved += 1
                if cap > 0 and nb <= cap // 2:
                    old = self._entries.pop(key, None)
                    if old is not None:
                        self._bytes -= old[1]
                    self._entries[key] = (entry, nb)
                    self._bytes += nb
            self._pin_bytes.pop(tenant, None)
            if cap > 0:
                self._evict_locked(cap)
            self._publish_locked(cap)
        return moved

    def _publish_locked(self, cap: int) -> None:
        # under self._lock: the gauges and the ledger accounts move in the
        # critical section that moved the bytes
        pinned = sum(self._pin_bytes.values())
        self.stats.page_entries = len(self._entries) + len(self._pinned)
        self.stats.page_bytes = self._bytes
        self.stats.page_capacity = cap
        self.stats.page_pinned_bytes = pinned
        _M_PAGE_ENTRIES.set(len(self._entries) + len(self._pinned))
        _M_PAGE_BYTES.set(self._bytes)
        _M_PAGE_PINNED_BYTES.set(pinned)
        _ACC_PAGE.set(self._bytes)
        _ACC_PINNED.set(pinned)

    def _evict_locked(self, target: int) -> int:
        # the LRU's entries only: pins answer to their tenant's cap
        evicted = 0
        while self._bytes > max(0, target) and self._entries:
            _, (_, nb) = self._entries.popitem(last=False)
            self._bytes -= nb
            evicted += 1
        self.stats.page_evictions += evicted
        _account(_M_PAGE_EVICTIONS, evicted)
        return evicted

    def put(self, key, values, validity, first_row: int,
            num_rows: int) -> PageEntry:
        """Freeze one decoded page and keep it: pinned inside a
        :func:`page_pin_scope` while the tenant's cap allows, else in the
        LRU when the cache is on and the page fits in half its cap.
        Returns the entry that serves the key (frozen either way)."""
        cap = page_cache_bytes()
        entry = make_page_entry(values, validity, first_row, num_rows)
        nb = entry.nbytes()
        pin = _PIN.get()
        if pin is not None:
            tenant, pin_cap = pin
            with self._lock:
                got = self._pinned.get(key)
                if got is not None:
                    return got[0]
                pinned = self._pin_bytes.get(tenant, 0) + nb <= pin_cap
                if pinned:
                    old = self._entries.pop(key, None)
                    if old is not None:
                        self._bytes -= old[1]
                    self._pinned[key] = (entry, nb, tenant)
                    self._pin_bytes[tenant] = \
                        self._pin_bytes.get(tenant, 0) + nb
                    self.stats.page_pins += 1
                    _account(_M_PAGE_PINS)
                    self._publish_locked(cap)
                else:
                    # past the tenant's cap: no pin (the cap is the
                    # contract); the page goes to the LRU
                    self.stats.page_pin_refusals += 1
                    _account(_M_PAGE_PIN_REFUSALS)
            if pinned:
                _maybe_pressure()  # pins grow the ledger as any tier
                return entry
        if cap <= 0 or nb > cap // 2:
            return entry
        with self._lock:
            got = self._pinned.get(key)
            if got is not None:
                return got[0]
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (entry, nb)
            self._bytes += nb
            self._evict_locked(cap)
            self._publish_locked(cap)
        _maybe_pressure()
        return entry

    def top_entries(self, n: int = 10) -> list:
        """The largest resident pages by bytes, pinned ones included
        (``/debugz``; keys are (file key, row group, leaf path, page
        ordinal) tuples)."""
        with self._lock:
            items = [(k, nb) for k, (_, nb) in self._entries.items()]
            items += [(k, v[1]) for k, v in self._pinned.items()]
        return _top_entries(items, n)

    def shrink_to(self, target_bytes: int) -> int:
        """Evict LRU-first until the LRU holds at most ``target_bytes``
        (pins stay); returns how many entries went."""
        with self._lock:
            evicted = self._evict_locked(target_bytes)
            self._publish_locked(page_cache_bytes())
        return evicted

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0][0] == ap]:
                _, nb = self._entries.pop(key)
                self._bytes -= nb
            # a pin holds residency, never a stale page
            for key in [k for k in self._pinned if k[0][0] == ap]:
                _, nb, tenant = self._pinned.pop(key)
                self._pin_bytes[tenant] = self._pin_bytes.get(tenant, 0) - nb
            self._publish_locked(page_cache_bytes())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pinned.clear()
            self._pin_bytes.clear()
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
                _ACC_NEG.set(0)
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
            _ACC_NEG.set(self._bytes)
        _maybe_pressure()

    def invalidate_path(self, ap: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0][0] == ap]:
                self._bytes -= self._entries.pop(key)[1]
            _ACC_NEG.set(self._bytes)

    def shrink_to(self, target_bytes: int) -> int:
        """Evict whole chunks LRU-first down to ``target_bytes``; returns
        how many went."""
        evicted = 0
        with self._lock:
            while self._bytes > max(0, target_bytes) and self._entries:
                _, e = self._entries.popitem(last=False)
                self._bytes -= e[1]
                evicted += 1
            _ACC_NEG.set(self._bytes)
        return evicted

    def top_entries(self, n: int = 10) -> list:
        with self._lock:
            items = [(k, e[1]) for k, e in self._entries.items()]
        return _top_entries(items, n)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            _ACC_NEG.set(0)


_STATS = CacheStats()
FOOTERS = FooterCache(_STATS)
PAGES = PageCache(_STATS)
NEGS = NegLookupCache()


def _reclaim_pages(fraction: float) -> int:
    return PAGES.shrink_to(int(PAGES.stats.page_bytes * fraction))


def _reclaim_negs(fraction: float) -> int:
    return NEGS.shrink_to(int(NEGS.resident_bytes * fraction))


def _reclaim_footers(fraction: float) -> int:
    return FOOTERS.shrink_to(int(FOOTERS.stats.footer_entries * fraction))


# the soft watermark's order: the decoded pages first, the memo next, the
# parsed footers last (small, and the dearest to rebuild a byte)
for _fn in (_reclaim_pages, _reclaim_negs, _reclaim_footers):
    LEDGER.register_reclaimer(_fn)


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
