"""Process-wide metrics: counters, gauges and fixed-bucket histograms with
percentiles.

The port's copy of ``parquet_tpu/obs/metrics.py``: :class:`Counter`,
:class:`Gauge`, :class:`Histogram` (the same log-spaced bucket ladder, and
percentiles interpolated inside the covering bucket, clamped to the
observed min and max), the get-or-create :class:`MetricsRegistry`, and
:func:`metrics_snapshot`, :func:`metrics_delta`, :func:`reset_metrics`
and :func:`pool_wait_seconds`.  Each metric has its own lock, so
increments from any number of threads add up exactly; the registry's lock
guards only get-or-create.

Every family the port's modules move is declared at import, under the JAX
package's names and help, so that a scrape shows it at 0 before the first
operation that moves it (scrapers alert on absence, not on zero).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "metrics_snapshot",
           "metrics_delta", "reset_metrics", "pool_wait_seconds",
           "DEFAULT_LATENCY_BUCKETS"]

# log-spaced 10 us to 60 s; the overflow bucket above the last edge is
# implicit
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str],
                                                          ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """A monotonic counter (int or float increments)."""

    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels=(), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """A value at a point in time."""

    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels=(), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """A fixed-bucket histogram.  ``observe`` is one bisect over the edges
    and a few additions under the metric's lock; bucket counts are kept
    per bucket, and :meth:`bucket_counts` gives them cumulative."""

    __slots__ = ("name", "labels", "help", "buckets", "_lock", "_counts",
                 "_sum", "_count", "_min", "_max")

    def __init__(self, name: str, labels=(), help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.labels = labels
        self.help = help
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last: overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, v: float) -> None:
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """The estimated q-quantile (q in [0, 1]): linear inside the
        covering bucket, clamped to the observed [min, max], so one
        sample answers its own value."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> Optional[float]:
        if self._count == 0:
            return None
        target = q * self._count
        cum = 0
        for i, n in enumerate(self._counts):
            if n == 0:
                continue
            if cum + n >= target:
                lo = self.buckets[i - 1] if i > 0 else self._min
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                est = lo + (target - cum) / n * (hi - lo)
                return min(max(est, self._min), self._max)
            cum += n
        return self._max

    def summary(self) -> dict:
        with self._lock:
            out = {"count": self._count, "sum": round(self._sum, 6),
                   "min": self._min, "max": self._max,
                   "p50": self._percentile_locked(0.50),
                   "p95": self._percentile_locked(0.95),
                   "p99": self._percentile_locked(0.99)}
        for k in ("p50", "p95", "p99"):
            if out[k] is not None:
                out[k] = round(out[k], 6)
        return out

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs ending at ``(inf, total)``."""
        with self._lock:
            out, cum = [], 0
            for edge, n in zip(self.buckets, self._counts):
                cum += n
                out.append((edge, cum))
            out.append((float("inf"), cum + self._counts[-1]))
            return out

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None


class MetricsRegistry:
    """Every metric, keyed by ``(name, sorted labels)``.  A name has one
    type: asking for it as another raises ``TypeError``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], object] = {}

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            got = self._metrics.get(key)
            if got is not None:
                if not isinstance(got, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(got).__name__}, not {cls.__name__}")
                return got
            m = self._metrics[key] = cls(name, labels=key[1], help=help,
                                         **kw)
            return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def collect(self) -> List[object]:
        """Every metric, sorted by key."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """``{"counters": {key: value}, "gauges": {key: value},
        "histograms": {key: summary with buckets}}``, where ``key`` is
        ``name`` or ``name{label=value,...}``."""
        counters: Dict[str, object] = {}
        gauges: Dict[str, object] = {}
        hists: Dict[str, dict] = {}
        for m in self.collect():
            key = _render_key(m.name, m.labels)
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = m.value
            else:
                d = m.summary()
                d["buckets"] = [[le, n] for le, n in m.bucket_counts()]
                hists[key] = d
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def reset(self) -> None:
        """Zero every metric; they stay registered."""
        for m in self.collect():
            m._reset()


REGISTRY = MetricsRegistry()


def counter(name: str, labels: Optional[Dict[str, str]] = None,
            help: str = "") -> Counter:
    return REGISTRY.counter(name, labels, help)


def gauge(name: str, labels: Optional[Dict[str, str]] = None,
          help: str = "") -> Gauge:
    return REGISTRY.gauge(name, labels, help)


def histogram(name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "",
              buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
              ) -> Histogram:
    return REGISTRY.histogram(name, labels, help, buckets)


def metrics_snapshot() -> dict:
    """Every counter, gauge and histogram (with p50/p95/p99) now; diff two
    with :func:`metrics_delta` to meter one operation."""
    return REGISTRY.snapshot()


def metrics_delta(before: dict, after: dict) -> dict:
    """What moved between two snapshots: counter differences (unchanged
    ones dropped), gauges at their ``after`` value, and histogram count
    and sum differences beside their lifetime percentiles (fixed buckets
    cannot rewind)."""
    out = {"counters": {}, "gauges": dict(after.get("gauges", {})),
           "histograms": {}}
    b_c = before.get("counters", {})
    for k, v in after.get("counters", {}).items():
        d = v - b_c.get(k, 0)
        if d:
            out["counters"][k] = round(d, 6) if isinstance(d, float) else d
    b_h = before.get("histograms", {})
    for k, h in after.get("histograms", {}).items():
        dc = h["count"] - b_h.get(k, {}).get("count", 0)
        if dc:
            out["histograms"][k] = {
                "count": dc,
                "sum": round(h["sum"] - b_h.get(k, {}).get("sum", 0.0), 6),
                "p50": h["p50"], "p95": h["p95"], "p99": h["p99"]}
    return out


def reset_metrics() -> None:
    """Zero every registered metric (tests, benchmarks)."""
    REGISTRY.reset()


def pool_wait_seconds() -> float:
    """Cumulative seconds operations spent waiting on the shared pool:
    task queue→run wait (utils/pool.py) plus prefetch-window waits
    (io/prefetch.py).  The saturation signal — diff it across one
    operation and hand the delta to ``RouteHistory.observe(...,
    pool_wait_s=)`` so a saturated pool discounts the route's effective
    GB/s, not just its wall clock.  Both components are LIVE (observed
    as each wait ends, not published at drain close), so a delta window
    sees only the waits that actually happened inside it — the
    close-time ``prefetch.pool_wait_s`` counter would lump a whole
    drain's lifetime stalls into whichever window straddled its close."""
    return float(histogram("pool.queue_wait_s").sum
                 + histogram("prefetch.wait_s").sum)


# ---------------------------------------------------------------------------
# Pre-declared core families: the operational contract of `stats --prom` is
# that the cache/prefetch/planner/route/read/write families EXIST (at 0)
# even before any operation ran — scrapers alert on absence, not on zero.
# ---------------------------------------------------------------------------
_CORE_COUNTERS = (
    ("cache.footer_hits", "footer cache hits (open skipped parse)"),
    ("cache.footer_misses", "footer cache misses"),
    ("cache.chunk_hits", "decoded-chunk LRU hits"),
    ("cache.chunk_misses", "decoded-chunk LRU misses"),
    ("cache.chunk_evictions", "decoded-chunk LRU evictions"),
    ("cache.page_hits", "decoded-page LRU hits (lookup served with no IO)"),
    ("cache.page_misses", "decoded-page LRU misses"),
    ("cache.page_evictions", "decoded-page LRU evictions"),
    ("prefetch.hits", "preads served from readahead state"),
    ("prefetch.misses", "preads read through around readahead"),
    ("prefetch.windows_issued", "readahead windows issued/hinted"),
    ("prefetch.bytes_prefetched", "bytes issued ahead of consumption"),
    ("prefetch.bytes_discarded", "prefetched bytes dropped unconsumed"),
    ("prefetch.bytes_dropbehind", "page-cache bytes released behind "
     "one-shot drains (PARQUET_TPU_MMAP_DROPBEHIND)"),
    ("prefetch.pool_wait_s", "seconds blocked on unfinished windows"),
    # "considered", not the plan-counter key "rg_total": the Prometheus
    # renderer appends _total to counters, and rg_total_total is a trap
    # for every dashboard written against the natural name
    ("planner.rg_considered", "row groups considered by the scan planner"),
    ("planner.rg_pruned_stats", "row groups pruned by footer stats"),
    ("planner.rg_pruned_pages", "row groups pruned by the page index"),
    ("planner.rg_pruned_bloom", "row groups pruned by bloom filters"),
    ("planner.rg_survivors", "row groups that survived the cascade"),
    ("planner.stats_probes", "stats-stage predicate probes"),
    ("planner.page_probes", "page-index predicate probes"),
    ("planner.bloom_probes", "bloom-filter predicate probes"),
    ("planner.pages_considered", "pages considered by the page stage"),
    ("planner.pages_selected", "pages selected by the page stage"),
    ("read.retries", "transient pread retries performed"),
    ("read.bytes_read", "bytes fetched from byte sources"),
    ("scan.rows_pruned", "candidate rows excluded before decode by pruning"),
    ("scan.rows_decoded", "survivor rows materialized by filtered scans"),
    ("read.rows_dropped", "rows lost to degraded-mode skips"),
    ("read.row_groups_skipped", "row groups dropped by degraded reads"),
    ("read.files_skipped", "whole files dropped by degraded reads"),
    ("write.row_groups", "row groups written"),
    ("write.bytes_flushed", "bytes flushed toward the OS by writers"),
    ("write.sink_flushes", "coalesced sink flushes"),
    # WriteStats publish families (io/sink.py): the encode/emit overlap
    # meters — float-seconds totals land as counters so per-op deltas
    # and rates stay derivable
    ("write.overlapped_groups", "row groups whose encode overlapped the "
     "previous group's emit"),
    ("write.encode_s", "cumulative seconds in parallel/serial encode"),
    ("write.emit_s", "cumulative seconds emitting pages to sinks"),
    ("write.pool_wait_s", "seconds writers blocked on pended encodes"),
    ("write.bytes_buffered", "bytes coalesced through BufferedSinks"),
    ("write.writev_flushes", "vectored os.writev sink flushes"),
    ("pool.tasks", "tasks dispatched to the shared pool"),
    ("trace.events_dropped", "trace events dropped at the buffer cap"),
    # sampling decisions (obs/scope.py): fleets alert on trace-buffer
    # pressure and sampler behavior from these
    ("trace.ops_sampled", "ops head-sampled into the trace"),
    ("trace.ops_skipped", "ops skipped by head sampling"),
    ("trace.ops_slow_kept", "slow ops kept by tail capture"),
    # point-lookup serving path (io/lookup.py): per-stage key attrition,
    # coalescing ratio (pages_read vs preads), and admission pressure
    ("lookup.keys", "keys probed by batched find_rows"),
    ("lookup.keys_pruned_stats", "lookup keys killed by chunk statistics"),
    ("lookup.keys_pruned_bloom", "lookup keys killed by bloom filters"),
    ("lookup.keys_pruned_pages", "lookup keys killed by the page index"),
    ("lookup.rows_matched", "rows returned by batched lookups"),
    ("lookup.preads", "ranged preads issued by the lookup page fetcher"),
    ("lookup.pages_read", "pages decoded from storage by lookups"),
    ("lookup.pages_coalesced", "extra pages riding an already-issued pread"),
    ("lookup.chunk_fallbacks", "index-less chunks decoded whole by lookups"),
    ("lookup.admission_waits", "lookup admissions that had to block"),
    ("lookup.neg_hits", "lookup keys skipped by the negative-lookup memo"),
    # the unified read gate (utils/pool.py): scan/stream-tier admissions
    # through the same FIFO budget the lookup path pioneered
    ("read.admission_waits", "scan/stream admissions that had to block"),
    # remote sources (io/remote.py): request volume, hedging, breaker
    # fail-fasts, and cache-identity movement — the serving fleet's
    # object-store health dashboard families
    ("remote.preads", "range requests served by remote sources"),
    ("remote.bytes", "bytes fetched from remote sources"),
    ("remote.hedges_issued", "hedged second attempts launched"),
    ("remote.hedges_won", "preads whose hedge finished first"),
    ("remote.breaker_fail_fast", "requests refused by an open circuit"),
    ("remote.validator_changes", "remote rewrites detected by HEAD "
     "validators (caches invalidated)"),
    # writable tables (dataset_writer.py + io/manifest.py): ingest and
    # compaction volume, commit conflicts, and recovery sweeps — the
    # continuous-ingest health dashboard families
    ("table.commits", "manifest snapshots committed"),
    ("table.files_written", "part-files committed by ingest"),
    ("table.rows_ingested", "rows committed into tables"),
    ("table.bytes_ingested", "part-file bytes committed into tables"),
    ("table.compactions", "compaction passes committed"),
    ("table.files_compacted", "part-files replaced by compaction"),
    ("table.commit_conflicts", "optimistic commits aborted by a rival"),
    ("table.compaction_errors", "background compaction passes that died"),
    ("table.orphans_swept", "orphan files removed by table recovery"),
    # point-lookup fast paths (io/lookup.py): sorted-page binary search
    # and very-large-batch key sharding
    ("lookup.binary_search_hits", "page probes answered by in-page "
     "binary search on sorted files"),
    ("lookup.key_shards", "key-shard tasks fanned out for very large "
     "lookup batches"),
    # aggregation pushdown (io/aggregate.py): per-tier resolution — how
    # many row groups each cascade tier ANSWERED (stats = zero IO/decode,
    # pages = zone-map math only, dict = dictionary + index stream,
    # decoded = exact fallback), plus manifest-level file answers
    ("agg.rg_answered_stats", "row groups answered by footer statistics "
     "(zero IO, zero decode)"),
    ("agg.rg_answered_pages", "row groups answered by page-index zone "
     "maps (no value decode)"),
    ("agg.rg_answered_dict", "row groups answered over dictionary pages "
     "without expanding values"),
    ("agg.rg_answered_decoded", "row groups resolved by the exact decode "
     "fallback"),
    ("agg.files_answered_manifest", "dataset part-files answered or "
     "dropped from manifest zone maps alone (zero footer IO)"),
    # multi-range remote reads (io/remote.py parallel_preads): ranges
    # fetched concurrently across connection-pool slots
    ("remote.parallel_preads", "disjoint ranges fetched concurrently "
     "across connection-pool slots"),
    # mmap write-sink experiment (io/sink.py MmapFileSink)
    ("write.mmap_commits", "files committed through the mmap-backed "
     "sink (PARQUET_TPU_MMAP_SINK)"),
    # tenant pins of the page cache (io/cache.py page_pin_scope): pins
    # granted and refused at a tenant's cap
    ("cache.page_pins", "decoded pages pinned by tenants "
     "(eviction-exempt)"),
    ("cache.page_pin_refusals", "pin attempts refused at the tenant's "
     "pin cap (entry fell back to the LRU)"),
    # the serving daemon (serve/server.py); the per-class and per-tenant
    # request and shed counters are label families declared below
    ("serve.errors", "requests that failed with a 5xx"),
    ("serve.writes_committed", "table commits performed by /v1/write"),
    ("serve.rows_served", "rows returned across all serve endpoints"),
    # remote auth hooks (io/remote.py): 401/403 -> refresh-and-retry
    ("remote.auth_refreshes", "credential refreshes triggered by "
     "401/403 responses (auth hook re-invoked)"),
    # the daemon's per-tenant request-rate and bearer-token gates
    ("serve.qps_rejections", "requests refused 429 by a tenant's "
     "token-bucket QPS limit"),
    ("serve.auth_failures", "requests refused 401 by the per-tenant "
     "bearer-token check"),
    # the fleet (serve/cluster.py): consistent-hash routing,
    # scatter-gather, peer hedging, and the commit arbiter of
    # io/manifest.py (a compare-and-swap on the manifest's version)
    ("fleet.forwards", "lookup key subsets / sub-requests forwarded to "
     "ring-owner peers"),
    ("fleet.gathers", "scatter-gather requests coordinated across the "
     "fleet"),
    ("fleet.peer_errors", "peer sub-requests that failed (before any "
     "local fallback)"),
    ("fleet.local_fallbacks", "peer shards recomputed locally after a "
     "peer failure or hedge win"),
    ("fleet.hedges_issued", "local hedge executions launched against "
     "slow peer sub-requests"),
    ("fleet.hedges_won", "peer sub-requests whose local hedge finished "
     "first"),
    ("fleet.peer_skips", "peer shards dropped from a degraded gather "
     "(skip accounting in the response)"),
    ("fleet.cas_commits", "manifest commits arbitrated through the CAS "
     "hook"),
    ("fleet.cas_conflicts", "CAS commit attempts aborted by a rival "
     "version (re-read and re-mutated)"),
    # fused single-pass execution (io/fused.py): page-at-a-time
    # decode+mask+fold streaming with no whole-column intermediates
    ("fused.rg_folds", "row groups resolved by the fused streaming fold"),
    ("fused.pages_folded", "pages decoded or masked-emitted through the "
     "fused fold (at most one alive per column at a time)"),
    ("fused.pages_masked_emit", "pages whose filter mask applied INSIDE "
     "the decode loop (masked-emit kernels)"),
    ("fused.fallbacks", "fused-path attempts that fell back to the "
     "materializing exact tier (unsupported layout/encoding)"),
    ("fused.scan_spans", "scan filter spans evaluated page-by-page "
     "through the fused phase-1 path"),
    ("agg.rg_answered_dict_partial", "partially-covered row groups whose "
     "covered rows answered from the dictionary while only contended "
     "pages took the exact path"),
    # device-scale dataset reads (parallel/mesh.py read_dataset_sharded):
    # files round-robined over the mesh with double-buffered H2D staging
    ("device.files_sharded", "dataset files round-robined over mesh "
     "devices by device-scale reads"),
    ("device.stage_overlapped", "files whose H2D staging overlapped the "
     "previous file's on-chip decode"),
)


def _declare_core() -> None:
    for name, hlp in _CORE_COUNTERS:
        REGISTRY.counter(name, help=hlp)
    for route in ("host", "device", "device_mesh"):
        REGISTRY.counter("route.chosen", labels={"route": route},
                         help="scans routed by the cost model")
    for cls in ("retryable", "terminal", "throttled"):
        REGISTRY.counter("remote.errors", labels={"class": cls},
                         help="remote failures by retry class")
    for state in ("open", "half_open", "closed"):
        REGISTRY.counter("remote.breaker_transitions",
                         labels={"state": state},
                         help="per-host circuit-breaker transitions")
    REGISTRY.histogram("remote.pread_s",
                       help="remote range-request latency (seeds the "
                            "adaptive hedge delay)")
    REGISTRY.histogram("pool.queue_wait_s",
                       help="shared-pool task queue->run wait")
    REGISTRY.histogram("lookup.find_rows_s",
                       help="batched point-lookup latency (p50/p99 serving "
                            "meter)")
    REGISTRY.histogram("read.admission_wait_s",
                       help="scan/stream block time on the read gate")
    REGISTRY.histogram("table.commit_s",
                       help="table commit latency (flush + zone-map "
                            "collection + manifest rename)")
    REGISTRY.histogram("agg.aggregate_s",
                       help="per-file aggregation-pushdown latency")
    REGISTRY.histogram("dataset.aggregate_s",
                       help="whole-dataset aggregation latency")
    REGISTRY.histogram("fused.fold_s",
                       help="per-row-group fused decode+mask+fold latency")
    # device-scale dataset reads: stage/decode split so the overlap win
    # (h2d hidden under decode) is measurable from a scrape alone
    REGISTRY.histogram("device.h2d_s",
                       help="per-file H2D staging latency on the "
                            "mesh-sharded device read path")
    REGISTRY.histogram("device.decode_s",
                       help="per-file on-chip decode latency on the "
                            "mesh-sharded device read path")
    # the reason axis is closed; runtime refusals outside it fold into
    # "other" (device_refusal_reason) so every series exists at 0
    for reason in ("unsupported", "policy", "budget", "error", "other"):
        REGISTRY.counter("device.route_refusals", labels={"reason": reason},
                         help="device-route refusals that fell back to "
                              "the host path, by reason")
    # every family a module get-or-creates is declared here too, so a
    # process that never imported that module still scrapes it
    REGISTRY.histogram("prefetch.wait_s",
                       help="per-wait seconds blocked on unfinished "
                            "readahead windows (live)")
    REGISTRY.histogram("lookup.admission_wait_s",
                       help="lookup-tier block time on the read gate")
    REGISTRY.histogram("dataset.find_rows_s",
                       help="dataset-wide batched-lookup latency")
    REGISTRY.histogram("dataset.read_s",
                       help="whole-dataset read latency")
    REGISTRY.histogram("dataset.scan_s",
                       help="whole-dataset filtered-scan latency")
    REGISTRY.histogram("dataset.scan_file_s",
                       help="per-file filtered-scan latency")
    REGISTRY.histogram("read.file_s",
                       help="per-file whole-read latency")
    REGISTRY.gauge("cache.footer_entries",
                   help="footers resident in the cache")
    REGISTRY.gauge("cache.chunk_entries",
                   help="decoded chunks resident in the LRU")
    REGISTRY.gauge("cache.chunk_bytes",
                   help="decoded bytes resident in the LRU")
    REGISTRY.gauge("cache.page_entries",
                   help="decoded pages resident in the page LRU")
    REGISTRY.gauge("cache.page_bytes",
                   help="decoded bytes resident in the page LRU")
    REGISTRY.gauge("pool.active", help="pool tasks currently running")
    REGISTRY.gauge("lookup.admitted_bytes",
                   help="bytes currently admitted through the read gate")
    for route in ("host", "device", "device_mesh"):
        REGISTRY.gauge("route.gbps", labels={"route": route},
                       help="EWMA effective GB/s per route")
        REGISTRY.counter("route.observations", labels={"route": route},
                         help="measured samples folded into the route "
                              "EWMA")
    REGISTRY.gauge("cache.page_pinned_bytes",
                   help="decoded bytes pinned by tenants "
                        "(eviction-exempt)")
    # the daemon's per-class families: the class axis is closed, so every
    # class's series exists at 0; a tenant's series (labels tenant and
    # class) appear as its requests arrive
    for klass in ("latency", "default", "bulk"):
        REGISTRY.counter("serve.requests", labels={"class": klass},
                         help="requests served per priority class")
        REGISTRY.counter("serve.shed", labels={"class": klass},
                         help="requests shed 429 under hard pressure")
        REGISTRY.histogram("serve.request_s", labels={"class": klass},
                           help="end-to-end request latency per "
                                "priority class")


_declare_core()
