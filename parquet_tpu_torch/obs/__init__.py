"""The port's observability: metrics, spans, per-operation scopes, the
resource ledger, and their export.

- :mod:`.metrics` — the process-wide registry of counters, gauges and
  fixed-bucket latency histograms (p50/p95/p99); the per-operation stats
  dataclasses (``ReadStats``, ``WriteStats``, ``CacheStats``,
  ``ReadReport``, the planner's counters, ``RouteHistory``) publish here.
- :mod:`.trace` — span tracing behind a module-level bool gate, written
  as Chrome trace-event JSON for Perfetto;
  ``PARQUET_TPU_TORCH_TRACE=/path.json`` turns it on for the process.
- :mod:`.export` — Prometheus text rendering, ``/debugz``, and the scrape
  endpoint (:func:`start_metrics_server`).
- :mod:`.ledger` — the resource ledger: every byte-holding tier keeps a
  named account current, with soft and hard watermarks
  (``PARQUET_TPU_TORCH_MEM_SOFT``/``_HARD``) that shrink the caches and
  gate read admissions.
- :mod:`.scope` — ``op_scope(name)`` gives every operation its own
  identity (exact per-op attribution across pool workers, a trace track
  of its own), with 1-in-N head sampling
  (``PARQUET_TPU_TORCH_TRACE_SAMPLE``) and slow-op capture
  (``PARQUET_TPU_TORCH_SLOW_OP_S`` / ``_SLOW_LOG``).
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      counter, gauge, histogram, metrics_delta,
                      metrics_snapshot, pool_wait_seconds, reset_metrics)
# NOTE: the live gate is ``trace.TRACE_ENABLED`` on the MODULE —
# instrumentation sites import the module and read the attribute each
# time (a re-exported copy of the bool would go stale on enable/disable)
from . import trace
from .trace import (NULL_SPAN, disable_tracing, enable_tracing, enabled,
                    flush_trace, reset_trace, span, trace_events,
                    trace_span)
from .export import (MetricsServer, debugz_snapshot, render_prometheus,
                     start_metrics_server)
from . import ledger
from .ledger import (LEDGER, ResourceLedger, ledger_account,
                     ledger_snapshot)
from . import scope
from .scope import OpScope, current_op, live_ops, maybe_op_scope, op_scope

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "metrics_delta",
           "metrics_snapshot", "pool_wait_seconds", "reset_metrics",
           "NULL_SPAN", "trace", "disable_tracing", "enable_tracing",
           "enabled", "flush_trace", "reset_trace", "span", "trace_events",
           "trace_span", "render_prometheus", "MetricsServer",
           "start_metrics_server", "debugz_snapshot", "ledger", "LEDGER",
           "ResourceLedger", "ledger_account", "ledger_snapshot", "scope",
           "OpScope", "current_op", "live_ops", "maybe_op_scope",
           "op_scope"]
