"""Process-wide resource ledger: one answer to "where is the memory".

The port's copy of ``parquet_tpu/obs/ledger.py``.  Every tier that holds
host bytes keeps a named :class:`Account` (:data:`CORE_ACCOUNTS`: the
whole-chunk cache, the page cache and its tenant pins, the footer cache,
the negative-lookup memo, the prefetcher's ring and segment buffers, the
writer's writeback buffer, the read gate's grants, the trace buffer, the
remote hedges in flight, a table writer's pending rows, and the mesh
read's staged payloads) current at its own mutation site, inside the
critical section that moves the tier's bytes, so the ledger cannot drift
from the tier.  ``write.pended`` is declared and stays at 0: the port has
no background emitter.

- Accounts publish as ``ledger.resident_bytes{account=...}`` /
  ``ledger.high_water_bytes{...}`` / ``ledger.capacity_bytes{...}``
  gauges, and ``/debugz`` (obs/export.py) renders the live table.
- **Pressure watermarks** (``PARQUET_TPU_TORCH_MEM_SOFT`` /
  ``PARQUET_TPU_TORCH_MEM_HARD``, bytes, default off): when the total
  crosses the soft watermark, the registered reclaimers (the LRU cache
  tiers) shrink to a fraction, metered as ``ledger.pressure_evictions``,
  until the total is back under; at the hard watermark the read gate
  (utils/pool.py) also blocks new admissions until the total drops.
  Every state change increments ``ledger.pressure_transitions{state=}``
  and, with tracing on, lands a ``ledger.pressure`` span.

The ledger changes no bytes itself: pressure responses evict caches and
delay admissions, both of which are correctness-neutral (byte-identity
of every read path holds with watermarks and budgets enabled).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..utils.env import env_bytes
from .metrics import counter as _counter
from .metrics import gauge as _gauge
from ..utils.locks import make_lock

__all__ = ["Account", "ResourceLedger", "LEDGER", "ledger_account",
           "ledger_snapshot", "soft_watermark_bytes",
           "hard_watermark_bytes", "CORE_ACCOUNTS"]

# every byte-holding tier in the process; pre-declared so the gauge
# families render (at 0) before any operation runs — scrapers alert on
# absence, not zero, same contract as metrics._CORE_COUNTERS
CORE_ACCOUNTS = (
    ("cache.chunk", "decoded whole-chunk LRU (io/cache.py)"),
    ("cache.page", "decoded-page LRU, the lookup serving tier"),
    ("cache.page_pinned", "tenant-pinned decoded pages (eviction-exempt "
     "up to each tenant's pin cap)"),
    ("cache.footer", "parsed footers (thrift bytes at parse time)"),
    ("cache.neg_lookup", "negative-lookup memo (keys known absent)"),
    ("prefetch.ring", "in-flight/completed readahead window bytes"),
    ("prefetch.segments", "allocated readahead segment buffers"),
    ("write.buffer", "writeback bytes coalescing in BufferedSinks"),
    ("write.pended", "encoded row groups queued behind slow sinks"),
    ("admission.in_flight", "bytes granted through the read gate"),
    ("trace.buffer", "buffered trace events (estimated bytes)"),
    ("remote.hedge_in_flight", "bytes of in-flight hedged remote reads"),
    ("table.pending", "ingest bytes buffered in DatasetWriters awaiting "
     "a part-file flush"),
    ("device.staging", "raw page payloads staged (or queued for staging) "
     "H2D by mesh-sharded device reads"),
)

# soft response: each reclaimer shrinks its tier to this fraction of its
# current residency per pass (repeated passes converge to empty)
PRESSURE_EVICT_FRACTION = 0.5
_MAX_RECLAIM_PASSES = 4


def soft_watermark_bytes() -> int:
    """``PARQUET_TPU_TORCH_MEM_SOFT`` (bytes; 0/unset = off).  Read per check so
    tests and long-lived servers can flip pressure live."""
    return env_bytes("PARQUET_TPU_TORCH_MEM_SOFT")


def hard_watermark_bytes() -> int:
    """``PARQUET_TPU_TORCH_MEM_HARD`` (bytes; 0/unset = off)."""
    return env_bytes("PARQUET_TPU_TORCH_MEM_HARD")


class Account:
    """One tier's row in the ledger: resident bytes, lifetime high water,
    and (when the tier has one) its capacity.  ``set``/``add``/``sub``
    are called inside the tier's own critical section, so the account is
    exact by construction — the lock here only orders concurrent tiers'
    updates to the shared gauges."""

    __slots__ = ("name", "_lock", "_resident", "high_water", "_capacity",
                 "_g_res", "_g_hw", "_g_cap")

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("ledger.account")
        self._resident = 0
        self.high_water = 0
        self._capacity: Optional[Callable[[], int]] = None
        self._g_res = _gauge("ledger.resident_bytes",
                             labels={"account": name},
                             help="bytes resident per ledger account")
        self._g_hw = _gauge("ledger.high_water_bytes",
                            labels={"account": name},
                            help="max bytes ever resident per account")
        self._g_cap = _gauge("ledger.capacity_bytes",
                             labels={"account": name},
                             help="configured capacity per ledger account")

    @property
    def resident(self) -> int:
        return self._resident

    def set(self, n: int) -> None:
        """Pin the account to the tier's authoritative residency (the LRU
        tiers call this with their own byte counter — idempotent, so the
        ledger can never drift from the tier)."""
        with self._lock:
            self._resident = n
            if n > self.high_water:
                self.high_water = n
                self._g_hw.set(n)
            self._g_res.set(n)

    def add(self, n: int) -> None:
        if not n:
            return
        with self._lock:
            self._resident += n
            if self._resident > self.high_water:
                self.high_water = self._resident
                self._g_hw.set(self.high_water)
            self._g_res.set(self._resident)

    def sub(self, n: int) -> None:
        if not n:
            return
        with self._lock:
            self._resident -= n
            self._g_res.set(self._resident)

    def capacity(self) -> Optional[int]:
        fn = self._capacity
        if fn is None:
            return None
        try:
            return int(fn())
        except Exception:
            return None

    def _reset(self) -> None:
        """Test isolation: forget the high-water mark (residency is owned
        by the tier and untouched)."""
        with self._lock:
            self.high_water = self._resident
            self._g_hw.set(self.high_water)


class ResourceLedger:
    """The process balance sheet: named accounts, watermark evaluation,
    and the soft-pressure reclaim loop.  One instance per process
    (:data:`LEDGER`); tiers reach it through :func:`ledger_account`."""

    def __init__(self):
        self._lock = make_lock("ledger.registry")
        self._accounts: "Dict[str, Account]" = {}
        self._reclaimers: "List[Callable[[float], int]]" = []
        self._state = "ok"
        self._responding = threading.local()
        self._g_total = _gauge("ledger.total_bytes",
                               help="sum of all ledger accounts")
        self._c_evict = _counter(
            "ledger.pressure_evictions",
            help="cache entries evicted by soft-pressure response")
        self._c_trans = {
            s: _counter("ledger.pressure_transitions",
                        labels={"state": s},
                        help="watermark state transitions")
            for s in ("ok", "soft", "hard")}
        for name, _hlp in CORE_ACCOUNTS:
            self.account(name)

    # ------------------------------------------------------------ accounts
    def account(self, name: str,
                capacity: Optional[Callable[[], int]] = None) -> Account:
        """Get-or-create the named account.  ``capacity`` (a zero-arg
        callable, read per snapshot so env repoints apply live) is
        attached by the owning tier; later callers without one leave the
        existing capacity in place."""
        with self._lock:
            acct = self._accounts.get(name)
            if acct is None:
                acct = self._accounts[name] = Account(name)
        if capacity is not None:
            acct._capacity = capacity
        return acct

    def accounts(self) -> "Dict[str, Account]":
        with self._lock:
            return dict(self._accounts)

    def register_reclaimer(self, fn: Callable[[float], int]) -> None:
        """Register a soft-pressure reclaimer: ``fn(fraction)`` shrinks
        one evictable tier to ``fraction`` of its current residency and
        returns the number of entries evicted.  The LRU cache tiers
        register at import (io/cache.py)."""
        with self._lock:
            if fn not in self._reclaimers:
                self._reclaimers.append(fn)

    def total(self) -> int:
        with self._lock:
            accounts = list(self._accounts.values())
        return sum(a.resident for a in accounts)

    # ------------------------------------------------------------ pressure
    def state(self) -> str:
        """Current watermark state — ``ok`` / ``soft`` / ``hard`` —
        recomputed from live totals (and transition counters moved when
        it changed).  Cheap: two env reads and a 10-account sum."""
        return self._refresh()

    def _classify(self, total: int) -> str:
        hard = hard_watermark_bytes()
        if hard > 0 and total >= hard:
            return "hard"
        soft = soft_watermark_bytes()
        if soft > 0 and total >= soft:
            return "soft"
        return "ok"

    def _refresh(self) -> str:
        total = self.total()
        self._g_total.set(total)
        new = self._classify(total)
        with self._lock:
            if new != self._state:
                self._state = new
                self._c_trans[new].inc()
        return new

    def check_pressure(self) -> str:
        """Evaluate the watermarks and, when over the soft one, run the
        reclaim loop (evict-to-fraction over the registered tiers until
        the total is back under, bounded passes).  Called by the growth
        sites — cache puts, sink buffering, admission, writer pend —
        OUTSIDE their own tier locks (reclaimers take cache locks).
        Returns the post-response state."""
        state = self._refresh()
        if state == "ok":
            return state
        if getattr(self._responding, "flag", False):
            return state  # a reclaimer's own accounting re-entered
        self._responding.flag = True
        try:
            # local import: trace.py holds the ledger's trace.buffer
            # account, so the dependency must point one way at import
            from . import trace as _trace

            span = (_trace.span("ledger.pressure", state=state,
                                total_bytes=self.total())
                    if _trace.TRACE_ENABLED else _trace.NULL_SPAN)
            with span:
                self._respond()
        finally:
            self._responding.flag = False
        return self._refresh()

    def _respond(self) -> None:
        soft = soft_watermark_bytes()
        hard = hard_watermark_bytes()
        target = soft if soft > 0 else hard
        with self._lock:
            reclaimers = list(self._reclaimers)
        for _ in range(_MAX_RECLAIM_PASSES):
            if self.total() < target or not reclaimers:
                return
            evicted = 0
            for fn in reclaimers:
                try:
                    evicted += int(fn(PRESSURE_EVICT_FRACTION) or 0)
                except Exception:
                    continue  # one tier's failure must not stop the rest
            if evicted:
                self._c_evict.inc(evicted)
            else:
                return  # nothing left to evict: backpressure-only now

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """Per-account residency/capacity/high-water plus the total and
        watermark state — the ``/debugz`` ledger table."""
        out: "Dict[str, dict]" = {}
        total = 0
        for name, acct in sorted(self.accounts().items()):
            cap = acct.capacity()  # env-driven: resolved per snapshot
            total += acct.resident
            out[name] = {"resident_bytes": acct.resident,
                         "capacity_bytes": cap,
                         "high_water_bytes": acct.high_water}
            if cap is not None:
                acct._g_cap.set(cap)
        self._g_total.set(total)
        return {"accounts": out, "total_bytes": total,
                "state": self._classify(total),
                "soft_watermark_bytes": soft_watermark_bytes() or None,
                "hard_watermark_bytes": hard_watermark_bytes() or None}

    def _reset_high_water(self) -> None:
        for acct in self.accounts().values():
            acct._reset()


LEDGER = ResourceLedger()


def ledger_account(name: str,
                   capacity: Optional[Callable[[], int]] = None) -> Account:
    """The process-wide ledger's named account (tiers resolve their
    handle once at import; hot-path rule, no get-or-create per update)."""
    return LEDGER.account(name, capacity=capacity)


def ledger_snapshot() -> dict:
    """Per-account residency/capacity/high-water, total, and pressure
    state — the programmatic face of ``/debugz``'s ledger table."""
    return LEDGER.snapshot()


def maybe_check_pressure() -> None:
    """The growth-site fast path: run the watermark check (and any
    reclaim it triggers) only when a watermark is actually configured —
    two env reads otherwise.  Every tier that can GROW calls this after
    releasing its own lock: cache puts, footer/memo inserts, sink
    buffering, prefetch planning, writer pends."""
    if soft_watermark_bytes() or hard_watermark_bytes():
        LEDGER.check_pressure()
