"""Prometheus text rendering of the metrics registry, the ``/debugz``
snapshot, and the live scrape endpoint.

The port's copy of ``parquet_tpu/obs/export.py``.  The text follows the
Prometheus exposition format 0.0.4, with the JAX package's names, so that
a dashboard written for one reads the other:

- metric names are ``parquet_tpu_`` + the registry name with dots mapped
  to underscores; counters get the ``_total`` suffix;
- one ``# HELP`` / ``# TYPE`` pair per family (label variants share it);
- histograms render the cumulative ``_bucket{le="..."}`` series plus
  ``_sum`` and ``_count``.

:func:`start_metrics_server` serves the registry from a thread of its
own: ``/metrics`` (Prometheus 0.0.4), ``/metrics.json`` (the
``metrics_snapshot()`` dict), ``/debugz`` (:func:`debugz_snapshot`) and
``/healthz`` (the ledger's pressure state, ``ok``/``soft``/``hard``, a
line of text).  The serving daemon (serve/server.py) answers the same
four on its own port.
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      metrics_snapshot)

__all__ = ["render_prometheus", "start_metrics_server", "MetricsServer",
           "debugz_snapshot", "register_debugz_provider",
           "unregister_debugz_provider"]

_PREFIX = "parquet_tpu_"
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PREFIX + _BAD_CHARS.sub("_", name.replace(".", "_"))


def _prom_value(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
        return repr(v)
    return str(v)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels, extra=None) -> str:
    parts = [f'{k}="{_esc(str(v))}"' for k, v in labels]
    if extra:
        parts.extend(f'{k}="{_esc(str(v))}"' for k, v in extra)
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus exposition text format."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    seen_headers = set()

    def header(fam: str, help_text: str, typ: str) -> None:
        if fam in seen_headers:
            return
        seen_headers.add(fam)
        lines.append(f"# HELP {fam} {help_text or fam}")
        lines.append(f"# TYPE {fam} {typ}")

    for m in reg.collect():
        if isinstance(m, Counter):
            fam = _prom_name(m.name) + "_total"
            header(fam, m.help, "counter")
            lines.append(f"{fam}{_label_str(m.labels)} "
                         f"{_prom_value(m.value)}")
        elif isinstance(m, Gauge):
            fam = _prom_name(m.name)
            header(fam, m.help, "gauge")
            lines.append(f"{fam}{_label_str(m.labels)} "
                         f"{_prom_value(m.value)}")
        elif isinstance(m, Histogram):
            fam = _prom_name(m.name)
            header(fam, m.help, "histogram")
            for le, cum in m.bucket_counts():
                lines.append(
                    f"{fam}_bucket"
                    f"{_label_str(m.labels, [('le', _prom_value(float(le)))])}"
                    f" {cum}")
            lines.append(f"{fam}_sum{_label_str(m.labels)} "
                         f"{_prom_value(m.sum)}")
            lines.append(f"{fam}_count{_label_str(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# live introspection
# ---------------------------------------------------------------------------


# extension point: subsystems that only exist in SOME processes (the
# planner's route table) register a named section provider so
# /debugz includes them without this module importing them — the same
# lazy-answer contract as the tables/remote sections
_DEBUGZ_PROVIDERS: dict = {}


def register_debugz_provider(name: str, fn) -> None:
    """Add section ``name`` (a zero-arg callable returning a JSONable
    dict) to every future :func:`debugz_snapshot`.  A provider that
    raises renders as an error string — introspection must answer."""
    _DEBUGZ_PROVIDERS[name] = fn


def unregister_debugz_provider(name: str) -> None:
    _DEBUGZ_PROVIDERS.pop(name, None)


def debugz_snapshot(top_n: int = 10) -> dict:
    """The ``/debugz`` payload: live residency of every buffer tier.

    - ``ledger``: per-account resident/capacity/high-water bytes, the
      process total, watermark state and thresholds (obs/ledger.py);
    - ``caches``: per-cache entry/byte counts plus the top-N entries by
      bytes WITH their keys — "which file's chunks or pages are pinning
      memory" answered from a running process;
    - ``admission``: the unified read gate — bytes in flight, queue
      depth (waiters), lifetime blocked-acquire count, high water, and
      the effective budgets;
    - ``pool``: shared-pool width, tasks running, dispatch queue depth;
    - ``ops``: the op-scope table — every currently-open operation with
      its age (a stuck op shows up here long before a timeout fires);
    - ``remote``: per-host circuit-breaker states and failure streaks,
      hedge bytes in flight, and the observed pread-latency EWMA;
    - ``tables``: open :class:`~parquet_tpu_torch.dataset_writer.DatasetWriter`
      instances — pending (buffered) ingest rows/bytes, uncommitted
      flushed parts, committed version.

    Imported lazily: the endpoint must answer even in a process that
    never touched the IO layer (families just render empty)."""
    from ..utils.pool import pool_debug, read_admission
    from .ledger import ledger_snapshot
    from .scope import live_ops

    out = {"ledger": ledger_snapshot(), "pool": pool_debug(),
           "ops": live_ops()}
    try:
        from ..dataset_writer import table_debug

        out["tables"] = table_debug()
    except ImportError:  # pragma: no cover - the package always imports
        out["tables"] = {"writers": []}
    try:
        from ..io.remote import remote_debug

        out["remote"] = remote_debug()
    except ImportError:  # pragma: no cover - the IO layer always imports
        out["remote"] = {}
    adm = read_admission()
    out["admission"] = {
        "in_flight_bytes": adm.in_flight_bytes(),
        "queue_depth": adm.queue_depth(),
        "waits": adm.waits,
        "high_water_bytes": adm.high_water,
        "budget_bytes": {"global": adm.global_budget_bytes(),
                         "lookup": adm.budget_bytes("lookup"),
                         "scan": adm.budget_bytes("scan")},
        "tenants": adm.tenant_debug(),
    }
    try:
        from ..io import cache as _cache

        st = _cache.cache_stats()
        out["caches"] = {
            "chunk": {"entries": st.chunk_entries, "bytes": st.chunk_bytes,
                      "capacity": st.chunk_capacity,
                      "top": _cache.CHUNKS.top_entries(top_n)},
            "page": {"entries": st.page_entries, "bytes": st.page_bytes,
                     "capacity": st.page_capacity,
                     "top": _cache.PAGES.top_entries(top_n)},
            "footer": {"entries": st.footer_entries,
                       "top": _cache.FOOTERS.top_entries(top_n)},
            "neg_lookup": {"bytes": _cache.NEGS.resident_bytes,
                           "capacity": _cache.neg_lookup_cache_bytes(),
                           "top": _cache.NEGS.top_entries(top_n)},
        }
    except ImportError:  # pragma: no cover - the IO layer always imports
        out["caches"] = {}
    for name, fn in list(_DEBUGZ_PROVIDERS.items()):
        try:
            out[name] = fn()
        except Exception as e:  # introspection must answer regardless
            out[name] = {"error": str(e)}
    return out


# ---------------------------------------------------------------------------
# live scrape endpoint
# ---------------------------------------------------------------------------

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def healthz_body() -> bytes:
    """``/healthz``: the ledger's pressure state and a newline (``ok`` under
    the watermarks, ``soft`` or ``hard`` over them), so a health check
    learns of memory pressure from the probe it already runs."""
    from .ledger import LEDGER

    return (LEDGER.state() + "\n").encode("utf-8")


class _MetricsHandler(BaseHTTPRequestHandler):
    """GET-only handler: ``/metrics`` (Prometheus 0.0.4), ``/metrics.json``
    (the ``metrics_snapshot()`` dict), ``/debugz`` (live buffer-tier
    residency, :func:`debugz_snapshot`), ``/healthz`` (liveness and the
    memory pressure state: ``ok``/``soft``/``hard``)."""

    server_version = "parquet-tpu-torch-metrics/1.0"

    def do_GET(self):  # noqa: N802 (http.server naming)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics.json", "/metrics/json"):
            body = json.dumps(metrics_snapshot(), sort_keys=True) \
                .encode("utf-8")
            ctype = "application/json"
        elif path in ("/metrics", "/"):
            body = render_prometheus(self.server._registry).encode("utf-8")
            ctype = _PROM_CONTENT_TYPE
        elif path == "/debugz":
            body = json.dumps(debugz_snapshot(), sort_keys=True) \
                .encode("utf-8")
            ctype = "application/json"
        elif path == "/healthz":
            body = healthz_body()
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404, "unknown path (try /metrics)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass


class MetricsServer:
    """A running scrape endpoint: ``.port``/``.url`` to reach it,
    ``.close()`` to stop it.  Context-manager friendly."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.host, self.port = httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def join(self) -> None:
        """Block until the server stops (``stats --serve`` of the CLI
        runs until interrupted)."""
        self._thread.join()

    def close(self) -> None:
        """Stop serving, join the request threads, then the server's."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: Optional[MetricsRegistry] = None
                         ) -> MetricsServer:
    """Serve the metrics registry over HTTP on a thread of its own:
    ``/metrics`` in Prometheus exposition 0.0.4, ``/metrics.json`` as the
    snapshot dict, ``/debugz`` and ``/healthz``.  ``port=0`` binds an ephemeral port
    (read it back from the returned server's ``.port``).  Each request
    runs on a thread that :meth:`MetricsServer.close` joins."""
    httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
    httpd.daemon_threads = False  # server_close() joins request threads
    httpd._registry = registry if registry is not None else REGISTRY
    thread = threading.Thread(target=httpd.serve_forever,
                              name="pqt-metrics-server", daemon=True)
    thread.start()
    return MetricsServer(httpd, thread)
