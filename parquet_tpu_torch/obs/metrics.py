"""Process-wide metrics: counters, gauges and fixed-bucket histograms with
percentiles.

The port's copy of ``parquet_tpu/obs/metrics.py``: :class:`Counter`,
:class:`Gauge`, :class:`Histogram` (the same log-spaced bucket ladder, and
percentiles interpolated inside the covering bucket, clamped to the
observed min and max), the get-or-create :class:`MetricsRegistry`, and
:func:`metrics_snapshot`, :func:`metrics_delta` and
:func:`reset_metrics`.  Each metric has its own lock, so increments from
any number of threads add up exactly; the registry's lock guards only
get-or-create.

The families declared at import are those the port increments: the
remote sources' (``io/remote.py``).  A family exists at 0 before the
first operation that moves it.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "metrics_snapshot",
           "metrics_delta", "reset_metrics", "DEFAULT_LATENCY_BUCKETS"]

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


# the families the port moves, declared at import so that a snapshot
# shows them at 0 before the first operation
_CORE_COUNTERS = (
    ("remote.preads", "range requests served by remote sources"),
    ("remote.bytes", "bytes fetched from remote sources"),
    ("remote.hedges_issued", "hedged second attempts launched"),
    ("remote.hedges_won", "preads whose hedge finished first"),
    ("remote.breaker_fail_fast", "requests refused by an open circuit"),
    ("remote.validator_changes", "remote rewrites seen in the HEAD "
     "validators (caches invalidated)"),
    ("remote.parallel_preads", "disjoint ranges fetched concurrently "
     "across connection-pool slots"),
    ("remote.auth_refreshes", "credential refreshes after a 401 or 403"),
)


def _declare_core() -> None:
    for name, hlp in _CORE_COUNTERS:
        REGISTRY.counter(name, help=hlp)
    for cls in ("retryable", "terminal", "throttled"):
        REGISTRY.counter("remote.errors", labels={"class": cls},
                         help="remote failures by retry class")
    for state in ("open", "half_open", "closed"):
        REGISTRY.counter("remote.breaker_transitions",
                         labels={"state": state},
                         help="per-host circuit-breaker transitions")
    REGISTRY.histogram("remote.pread_s",
                       help="remote range-request latency (its p95 is the "
                            "adaptive hedge delay)")


_declare_core()
