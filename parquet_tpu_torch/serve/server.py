"""The serving daemon: one long-lived process that hosts datasets behind
HTTP endpoints with multi-tenant QoS, answering from the card.

The port's copy of ``parquet_tpu/serve/server.py``.  :class:`Server`
(``Server(config, port=0, device="cuda")``) mounts, on one port:

- ``POST /v1/lookup``: a batched ``find_rows`` (latency class by
  default): ``{"dataset", "column", "keys", "columns"?}`` -> each key's
  rows and row-aligned values;
- ``POST /v1/scan``: a predicate tree and a column selection, streamed
  one chunk a file, as JSON lines (the default) or one Arrow IPC stream
  (``"format": "arrow"``); with ``limit`` / ``page_token``, JSON pages
  that concatenate to the unbounded stream byte for byte;
- ``POST /v1/aggregate``: ``{"aggs": ["count", "sum:v", ...], "where"?,
  "group_by"?}`` through the aggregation cascade;
- ``POST /v1/write``: columnar ingest into a writable table, one manifest
  commit a request; the served snapshot refreshes on commit;
- ``GET /metrics``, ``/metrics.json``, ``/healthz``, ``/debugz`` (with a
  ``tenants`` section of per-tenant accounting).

Every lookup, scan, read and aggregate runs on the server's ``device``:
the card's bloom probe and dictionary gather answer lookups, its unpack
kernels whole-file scans and the aggregates' dictionary tier.  A device
error is a 500, never a host answer.

Each request runs inside ``tenant_context`` (its tenant's class, budget
and weight at the admission gate) and ``op_scope("serve.<endpoint>")``,
whose report the ``/debugz`` tenants section folds.  A tenant with
``pin_bytes`` pins its lookups' pages (io/cache.py).  Requests name
their tenant in ``X-Tenant``; a tenant with a token must present it as
``Authorization: Bearer``; a tenant over its ``qps`` gets 429 with
``Retry-After``; and under hard memory pressure bulk-class requests shed
with 429 while latency-class requests keep flowing.  :meth:`Server.close`
stops accepting, drains the requests in flight up to
``PARQUET_TPU_TORCH_SERVE_DRAIN_S``, and joins every thread the server
started.

A config with a ``cluster`` block makes the daemon a fleet member
(serve/cluster.py): its lookups scatter their keys to the keys' ring
owners, its scans and aggregates their files to the files' owners, and
each owner answers its shard by reads on its own device (a peer that
fails is covered by a local run of its shard); its commits are
arbitrated at the table's ring owner (``/v1/fleet/commit``).  The
answers equal a single node's: JSON scan lines byte for byte, the
lookup's global row ordinals, the aggregates merged from the shards'
partial states.  Sub-requests carry ``X-Fleet-Internal``, which skips
the QPS bucket (the request that fanned out paid its token).  Several
members may share a process (the tests' and the card's in-process
fleet) if they share one tenant table; the first owns the process-wide
state (the tenant table, the ``/debugz`` sections, the commit arbiter),
which passes to a surviving member at ``close``.
"""

from __future__ import annotations

import base64
import hmac
import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..dataset import Dataset
from ..errors import CorruptedError
from ..io.cache import PAGES, page_pin_scope
from ..io.reader import resolve_device
from ..obs import export as _export
from ..obs import scope as _oscope
from ..obs.ledger import LEDGER
from ..obs.metrics import REGISTRY, metrics_snapshot
from ..utils.pool import read_admission, tenant_context
from .codecs import (columns_to_arrow_batch, columns_to_jsonable,
                     expr_from_wire, jsonable, lookup_to_jsonable,
                     parse_aggs)
from .config import (DatasetSpec, ServeConfig, drain_timeout_s,
                     load_config, max_body_bytes, shed_retry_after_s)

__all__ = ["Server"]

# the Server that owns the process-wide QoS state (tenant table, pins,
# /debugz sections, commit arbiter), and every open Server: more than one
# only for fleet members that share a tenant table
_ACTIVE: "Optional[Server]" = None
_SERVERS: "List[Server]" = []
_ACTIVE_LOCK = threading.Lock()

# the class axis is closed: each class's series resolved once; a tenant's
# labelled series are got-or-created as its requests arrive
_CLASSES = ("latency", "default", "bulk")
_M_REQS = {c: REGISTRY.counter("serve.requests", labels={"class": c})
           for c in _CLASSES}
_M_SHED = {c: REGISTRY.counter("serve.shed", labels={"class": c})
           for c in _CLASSES}
_H_REQ_S = {c: REGISTRY.histogram("serve.request_s", labels={"class": c})
            for c in _CLASSES}
_M_ERRORS = REGISTRY.counter("serve.errors")
_M_COMMITS = REGISTRY.counter("serve.writes_committed")
_M_ROWS = REGISTRY.counter("serve.rows_served")
_M_AUTH_FAIL = REGISTRY.counter("serve.auth_failures")
_M_QPS_REJ = REGISTRY.counter("serve.qps_rejections")

_JSON = "application/json"
_ARROW = "application/vnd.apache.arrow.stream"


class _HttpError(Exception):
    """A failure the client sees: a status and a one-line message."""

    def __init__(self, status: int, message: str, headers=None):
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


class _ChunkedWriter:
    """An HTTP/1.1 chunked body (the handler sends the ``Transfer-Encoding:
    chunked`` header first), file-like enough for Arrow's IPC writer."""

    closed = False  # probed by the Arrow IPC writer

    def __init__(self, wfile):
        self._w = wfile

    def writable(self) -> bool:
        return True

    def close(self) -> None:  # the IPC writer may close its sink; the
        pass  # terminating chunk is finish()'s

    def write(self, data) -> int:
        data = bytes(data)
        if data:
            self._w.write(f"{len(data):x}\r\n".encode("ascii"))
            self._w.write(data)
            self._w.write(b"\r\n")
        return len(data)

    def finish(self) -> None:
        self._w.write(b"0\r\n\r\n")

    def flush(self) -> None:
        self._w.flush()


class _TenantStats:
    """Each tenant's requests, folded from their op reports: the data half
    of the ``/debugz`` tenants section."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by: Dict[str, dict] = {}

    def _row(self, tenant: str) -> dict:
        row = self._by.get(tenant)
        if row is None:
            row = self._by[tenant] = {
                "requests": 0, "shed": 0, "errors": 0, "rows": 0,
                "bytes_read": 0, "cache_hits": 0, "cache_misses": 0,
                "seconds": 0.0}
        return row

    def shed(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["shed"] += 1

    def error(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["errors"] += 1

    def fold(self, tenant: str, report: dict, rows: int,
             seconds: float) -> None:
        with self._lock:
            row = self._row(tenant)
            row["requests"] += 1
            row["rows"] += int(rows)
            row["bytes_read"] += int(report.get("bytes_read", 0))
            row["cache_hits"] += int(report.get("cache_hits", 0))
            row["cache_misses"] += int(report.get("cache_misses", 0))
            row["seconds"] = round(row["seconds"] + seconds, 6)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {t: dict(r) for t, r in self._by.items()}


class _HttpServer(ThreadingHTTPServer):
    """One thread a connection, each joined by :meth:`server_close`; the
    open connections are tracked so that a close can end idle keep-alive
    ones (a thread blocked reading the next request would never end)."""

    daemon_threads = False  # ThreadingHTTPServer's default is True

    def __init__(self, address, handler):
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        super().__init__(address, handler)

    def track(self, conn, alive: bool) -> None:
        with self._conns_lock:
            if alive:
                self._conns.add(conn)
            else:
                self._conns.discard(conn)

    def hang_up(self) -> None:
        """End every open connection: a handler waiting for a request
        reads end-of-file, one writing a response gets an error."""
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class Server:
    """A running serving daemon (the module docstring).

    ``config`` is a :class:`~parquet_tpu_torch.serve.config.ServeConfig`,
    the same dict, or the path of a ``serve.json``.  ``port=0`` binds an
    ephemeral port (``.port``).  ``device`` is where every read, scan,
    lookup and aggregate runs: CUDA unless the caller names the CPU (no
    card: ``RuntimeError``).  One Server a process, or several fleet
    members with one tenant table.  A context manager; :meth:`close`
    drains."""

    def __init__(self, config, host: Optional[str] = None,
                 port: Optional[int] = None, device="cuda"):
        if isinstance(config, str):
            config = load_config(config)
        elif isinstance(config, dict):
            config = ServeConfig.from_dict(config)
        if not isinstance(config, ServeConfig):
            raise TypeError(f"config must be a ServeConfig, dict, or "
                            f"path, got {type(config).__name__}")
        self.device = resolve_device(device)
        self.config = config
        self._ds_lock = threading.Lock()
        self._datasets: Dict[str, Dataset] = {
            name: self._open_dataset(spec)
            for name, spec in config.datasets.items()}
        self.tenant_stats = _TenantStats()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._closed = False
        self._compactors: List = []
        self._tokens_lock = threading.Lock()
        self._tokens: Dict[str, str] = dict(config.tokens)
        self.fleet = None
        # the tenant table, the pins, the /debugz sections and the commit
        # arbiter are process-wide: a second daemon would change the
        # first's contracts under its running requests.  Fleet members
        # with one tenant table may share a process; the first owns the
        # state, and a close hands it to a survivor
        global _ACTIVE
        with _ACTIVE_LOCK:
            refusal = None
            if _ACTIVE is not None:
                if config.cluster is None or _ACTIVE.config.cluster is None:
                    refusal = ("a Server is already running in this "
                               "process (the tenant QoS state is "
                               "process-global); close it before starting "
                               "another")
                elif config.tenants != _ACTIVE.config.tenants:
                    refusal = ("fleet members sharing a process must share "
                               "one tenant QoS table (the admission gate "
                               "is process-global)")
                self._qos_owner = False
            else:
                _ACTIVE = self
                self._qos_owner = True
            if refusal is None:
                _SERVERS.append(self)
        if refusal is not None:
            self._close_datasets()
            raise RuntimeError(refusal)
        try:
            server = self

            class Handler(_RequestHandler):
                daemon = server

            # bind first: a port in use fails before any process-wide
            # state is installed or any thread starts
            self._httpd = _HttpServer(
                (host if host is not None else config.host,
                 port if port is not None else config.port), Handler)
        except BaseException:
            with _ACTIVE_LOCK:
                if _ACTIVE is self:
                    _ACTIVE = None
                _SERVERS.remove(self)
            self._close_datasets()
            raise
        if self._qos_owner:
            read_admission().configure_tenants(config.tenants)
        if config.compact_interval_s:
            from ..dataset_writer import BackgroundCompactor

            for spec in config.datasets.values():
                if spec.writable:
                    self._compactors.append(BackgroundCompactor(
                        spec.table, interval_s=config.compact_interval_s,
                        device=self.device))
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pqt-serve", daemon=True)
        self._thread.start()
        self.host, self.port = self._httpd.server_address[:2]
        if config.cluster is not None:
            from ..io.manifest import set_commit_arbiter
            from .cluster import FleetRouter

            self.fleet = FleetRouter(config.cluster, tokens=config.tokens)
            # the arbiter is process-wide; every member's resolver names
            # the same ring owner and the local compare-and-swap stays
            # right under any of them: the latest member's is installed,
            # and close() hands it on
            set_commit_arbiter(self.fleet.arbiter_resolver())
        if self._qos_owner:
            _export.register_debugz_provider("tenants", self._tenants_debugz)
            if self.fleet is not None:
                _export.register_debugz_provider("fleet", self.fleet.debug)

    # ------------------------------------------------------------ datasets
    @staticmethod
    def _open_dataset(spec: DatasetSpec) -> Dataset:
        if spec.table is not None:
            from ..dataset_writer import open_table

            return open_table(spec.table)
        return Dataset(spec.paths)

    def dataset(self, name: str) -> Dataset:
        with self._ds_lock:
            ds = self._datasets.get(name)
        if ds is None:
            raise _HttpError(404, f"unknown dataset {name!r}")
        return ds

    def _refresh_dataset(self, name: str) -> None:
        """Serve a fresh snapshot after a commit: requests in flight keep
        the snapshot they hold (``open_table`` pins its parts), new ones
        see the new version."""
        fresh = self._open_dataset(self.config.datasets[name])
        with self._ds_lock:
            self._datasets[name] = fresh

    def _close_datasets(self) -> None:
        with self._ds_lock:
            datasets = list(self._datasets.values())
        for ds in datasets:
            ds.close()

    # -------------------------------------------------------------- debugz
    def _tenants_debugz(self) -> dict:
        gate = read_admission().tenant_debug()
        stats = self.tenant_stats.snapshot()
        out: Dict[str, dict] = {}
        for t in sorted(set(gate) | set(stats)):
            row = dict(gate.get(t, {}))
            row.update(stats.get(t, {}))
            row["pinned_bytes"] = PAGES.pinned_bytes(t)
            out[t] = row
        return out

    # ------------------------------------------------------------ lifetime
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _enter_request(self) -> bool:
        with self._inflight_cv:
            if self._closed:
                return False
            self._inflight += 1
            return True

    def _exit_request(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def inflight(self) -> int:
        with self._inflight_cv:
            return self._inflight

    def close(self, drain: bool = True) -> bool:
        """Stop accepting, wait for the requests in flight (up to
        ``PARQUET_TPU_TORCH_SERVE_DRAIN_S``; none with ``drain=False``),
        end the open connections, join every thread the server started
        (its fleet router's too), and release the tenant table, the pins,
        the ``/debugz`` sections and the commit arbiter, or, where another
        fleet member of the process is still open, hand them to it.  True
        when the drain completed.  Idempotent."""
        global _ACTIVE
        with self._inflight_cv:
            if self._closed:
                return True
            self._closed = True
        self._httpd.shutdown()  # no new connection; requests in flight go on
        drained = True
        if drain:
            deadline = time.monotonic() + max(drain_timeout_s(), 0.0)
            with self._inflight_cv:
                while self._inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        drained = False
                        break
                    self._inflight_cv.wait(timeout=min(remaining, 0.25))
        for c in self._compactors:
            c.close()
        self._httpd.hang_up()
        self._httpd.server_close()  # joins the connections' threads
        self._thread.join()
        if self.fleet is not None:
            self.fleet.close()  # joins the gather's threads
        with _ACTIVE_LOCK:
            _SERVERS.remove(self)
            survivor = _SERVERS[0] if _SERVERS else None
            was_owner = self._qos_owner
            if was_owner and survivor is not None:
                survivor._qos_owner = True
            if _ACTIVE is self:
                _ACTIVE = survivor
        if was_owner:
            _export.unregister_debugz_provider("tenants")
            if self.fleet is not None:
                _export.unregister_debugz_provider("fleet")
        if self.fleet is not None:
            from ..io.manifest import set_commit_arbiter

            set_commit_arbiter(
                survivor.fleet.arbiter_resolver()
                if survivor is not None and survivor.fleet is not None
                else None)
        if survivor is None:
            for t in self.config.tenants:
                PAGES.unpin_tenant(t)
            read_admission().clear_tenants()
        elif was_owner:
            _export.register_debugz_provider("tenants",
                                             survivor._tenants_debugz)
            if survivor.fleet is not None:
                _export.register_debugz_provider("fleet",
                                                 survivor.fleet.debug)
        self._close_datasets()
        return drained

    def chaos_kill(self) -> None:
        """An abrupt death for chaos tests: the listener closes now with no
        drain, so peers see refused connections as from a killed process.
        The connections' threads are still joined, and the process-wide
        state still passes to a survivor (the storage's crash matrix
        covers a death with no hand-off)."""
        self.close(drain=False)

    # --------------------------------------------------------------- fleet
    def set_peers(self, urls: Dict[str, str]) -> None:
        """Repoint the fleet peers' base URLs after an ephemeral-port boot
        (bind first, then tell every member where the others landed)."""
        if self.fleet is None:
            raise RuntimeError("this daemon has no cluster config")
        self.fleet.set_peers(urls)

    # ---------------------------------------------------------------- auth
    def rotate_token(self, tenant: str, token: Optional[str]) -> None:
        """Install (or with None clear) ``tenant``'s bearer token for the
        next requests; requests in flight finish under the token they
        presented."""
        with self._tokens_lock:
            if token is None:
                self._tokens.pop(tenant, None)
            else:
                self._tokens[tenant] = str(token)

    def _token_for(self, tenant: str) -> Optional[str]:
        with self._tokens_lock:
            return self._tokens.get(tenant)

    def join(self) -> None:
        """Block until the listener stops."""
        self._thread.join()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _RequestHandler(BaseHTTPRequestHandler):
    """One connection: routing, the tenant, the QoS gates, dispatch."""

    daemon: Server  # bound by the per-Server subclass
    protocol_version = "HTTP/1.1"
    server_version = "parquet-tpu-serve/1.0"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # the metrics are the log
        pass

    def setup(self):
        super().setup()
        self.server.track(self.connection, True)

    def finish(self):
        try:
            super().finish()
        finally:
            self.server.track(self.connection, False)

    # ------------------------------------------------------------ plumbing
    def _send(self, status: int, body: bytes, ctype: str = _JSON,
              headers=None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if status >= 400:
            # an error may leave the request body unread on the wire (a
            # 413 refuses before reading it, bad JSON stops mid-parse):
            # keeping the connection would desync the next request
            self.send_header("Connection", "close")
            self.close_connection = True
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, doc: dict, headers=None) -> None:
        self._send(status, json.dumps(doc, sort_keys=True,
                                      allow_nan=True).encode("utf-8"),
                   headers=headers)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        cap = max_body_bytes()
        if length > cap:
            raise _HttpError(413, f"request body {length} bytes exceeds "
                                  f"the {cap}-byte cap "
                                  f"(PARQUET_TPU_TORCH_SERVE_MAX_BODY)")
        raw = self.rfile.read(length) if length else b"{}"
        try:
            doc = json.loads(raw or b"{}")
        except ValueError as e:
            raise _HttpError(400, f"request body is not valid JSON "
                                  f"({e})") from e
        if not isinstance(doc, dict):
            raise _HttpError(400, "request body must be a JSON object")
        return doc

    # ---------------------------------------------------------------- GET
    def do_GET(self):  # noqa: N802 (http.server naming)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            self._send(200, _export.render_prometheus().encode("utf-8"),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path in ("/metrics.json", "/metrics/json"):
            self._send(200, json.dumps(metrics_snapshot(),
                                       sort_keys=True).encode("utf-8"))
        elif path == "/debugz":
            self._send(200, json.dumps(_export.debugz_snapshot(),
                                       sort_keys=True).encode("utf-8"))
        elif path == "/healthz":
            self._send(200, _export.healthz_body(),
                       "text/plain; charset=utf-8")
        else:
            self._send_json(404, {"error": "unknown path (POST "
                                           "/v1/lookup|scan|aggregate|"
                                           "write; GET /metrics "
                                           "/healthz /debugz)"})

    # --------------------------------------------------------------- POST
    _ENDPOINTS = {"/v1/lookup": "lookup", "/v1/scan": "scan",
                  "/v1/aggregate": "aggregate", "/v1/write": "write",
                  "/v1/fleet/commit": "fleet_commit"}

    def do_POST(self):  # noqa: N802
        daemon = self.daemon
        endpoint = self._ENDPOINTS.get(self.path.split("?", 1)[0])
        if endpoint is None:
            self._send_json(404, {"error": f"unknown path {self.path!r}"})
            return
        if not daemon._enter_request():
            self._send_json(503, {"error": "server is shutting down"},
                            headers={"Connection": "close"})
            return
        try:
            self._dispatch(daemon, endpoint)
        finally:
            daemon._exit_request()

    def _dispatch(self, daemon: Server, endpoint: str) -> None:
        tenant = (self.headers.get("X-Tenant") or "default").strip() \
            or "default"
        # the token is checked against the tenant asked for, before an
        # unknown tenant collapses: a wrong token is a 401, never a quiet
        # fall to the default tenant's contract
        expected = daemon._token_for(tenant)
        if expected is not None:
            presented = self.headers.get("Authorization") or ""
            ok = presented.startswith("Bearer ") and hmac.compare_digest(
                presented[len("Bearer "):].encode("utf-8"),
                expected.encode("utf-8"))
            if not ok:
                _oscope.account(_M_AUTH_FAIL)
                _oscope.account(REGISTRY.counter(
                    "serve.auth_failures", labels={"tenant": tenant}))
                self._send_json(
                    401, {"error": f"tenant {tenant!r} requires a "
                                   f"valid bearer token"},
                    headers={"WWW-Authenticate": "Bearer"})
                return
        if tenant != "default" and tenant not in daemon.config.tenants:
            # the header is the client's: a series, a gate lane and a
            # stats row a value would let any caller grow the process and
            # /metrics for ever, so an unknown tenant runs as default
            tenant = "default"
        klass = daemon.config.klass_for(tenant, endpoint)
        # a fleet's sub-requests (scatter legs, commit arbitration) skip
        # the QPS bucket: the request that fanned out paid its token, and
        # N legs must not charge it N times
        internal = self.headers.get("X-Fleet-Internal") == "1"
        retry_in = None if internal else \
            read_admission().try_request(tenant)
        if retry_in is not None:
            _oscope.account(_M_QPS_REJ)
            _oscope.account(REGISTRY.counter(
                "serve.qps_rejections", labels={"tenant": tenant}))
            daemon.tenant_stats.shed(tenant)
            self._send_json(
                429, {"error": f"tenant {tenant!r} over its QPS contract",
                      "retry_after_s": retry_in},
                headers={"Retry-After":
                         str(max(int(math.ceil(retry_in)), 1))})
            return
        self._internal = internal
        self._tenant = tenant
        # under hard pressure the bulk tier sheds first, with a prompt
        # 429 rather than a wait the gate would impose anyway; the
        # latency tier keeps flowing
        if klass == "bulk" and LEDGER.state() == "hard":
            _oscope.account(_M_SHED[klass])
            _oscope.account(REGISTRY.counter(
                "serve.shed", labels={"tenant": tenant, "class": klass}))
            daemon.tenant_stats.shed(tenant)
            self._send_json(
                429, {"error": "shed: memory pressure (bulk tier)",
                      "retry_after_s": shed_retry_after_s()},
                headers={"Retry-After":
                         str(max(int(shed_retry_after_s()), 1))})
            return
        t0 = time.perf_counter()
        rows = 0
        op_report = None
        respond = None
        self._streamed = False
        try:
            body = self._body()
            pin_cap = daemon.config.pin_bytes.get(tenant, 0)
            with tenant_context(tenant, klass):
                with _oscope.op_scope(f"serve.{endpoint}", tenant=tenant,
                                      klass=klass) as op:
                    if endpoint == "lookup" and pin_cap > 0:
                        with page_pin_scope(tenant, pin_cap):
                            rows, respond = self._handle(daemon, endpoint,
                                                         body)
                    else:
                        rows, respond = self._handle(daemon, endpoint, body)
                op_report = op.report()
        except _HttpError as e:
            if e.status >= 500:
                _oscope.account(_M_ERRORS)
                daemon.tenant_stats.error(tenant)
            if self._abort_stream():
                return
            self._send_json(e.status, {"error": str(e)},
                            headers=e.headers)
            return
        except (ValueError, KeyError, TypeError) as e:
            if self._abort_stream():
                return
            self._send_json(400, {"error": str(e)})
            return
        except BrokenPipeError:
            self.close_connection = True
            return  # the client left mid-stream: nothing to send
        except (CorruptedError, OSError, RuntimeError) as e:
            # a device error (torch raises RuntimeError) is a 500 too:
            # the daemon never answers a failed card call from the host
            _oscope.account(_M_ERRORS)
            daemon.tenant_stats.error(tenant)
            if self._abort_stream():
                return
            self._send_json(500, {"error": str(e)})
            return
        finally:
            dur = time.perf_counter() - t0
            _H_REQ_S[klass].observe(dur)
            REGISTRY.histogram(
                "serve.request_s",
                labels={"tenant": tenant, "class": klass}).observe(dur)
            _oscope.account(_M_REQS[klass])
            _oscope.account(REGISTRY.counter(
                "serve.requests",
                labels={"tenant": tenant, "class": klass}))
            if rows:
                _oscope.account(_M_ROWS, rows)
            if op_report is not None:
                daemon.tenant_stats.fold(tenant, op_report, rows, dur)
        # the response (or the stream's last chunk) goes out only after
        # the request was metered: a client holding the whole response
        # finds it in /metrics and /debugz
        try:
            respond()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    # ------------------------------------------------------------ handlers
    def _handle(self, daemon: Server, endpoint: str, body: dict):
        """``(rows, responder)``: the work happens here, inside the op
        scope; ``responder()`` writes the response after metering."""
        if endpoint == "lookup":
            return self._lookup(daemon, body)
        if endpoint == "scan":
            return self._scan(daemon, body)
        if endpoint == "aggregate":
            return self._aggregate(daemon, body)
        if endpoint == "fleet_commit":
            return self._fleet_commit(daemon, body)
        return self._write(daemon, body)

    def _abort_stream(self) -> bool:
        """True where the headers already went out as a chunked stream:
        the honest failure left is an unterminated stream and a closed
        connection (the client sees an incomplete read, not a short
        success)."""
        if self._streamed:
            self.close_connection = True
            return True
        return False

    @staticmethod
    def _required(body: dict, key: str):
        v = body.get(key)
        if v is None:
            raise _HttpError(400, f"request needs {key!r}")
        return v

    def _accepts_gzip(self) -> bool:
        accept = (self.headers.get("Accept-Encoding") or "").lower()
        return "gzip" in accept

    def _maybe_gzip(self, body: bytes, headers: dict):
        """Compress a buffered body where the client asked for gzip (mtime
        0, so the bytes are deterministic)."""
        if not self._accepts_gzip() or not body:
            return body, headers
        import gzip as _gzip
        import io as _io

        buf = _io.BytesIO()
        with _gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
            gz.write(body)
        headers = dict(headers)
        headers["Content-Encoding"] = "gzip"
        return buf.getvalue(), headers

    def _respond_json(self, doc: dict, headers=None):
        data = json.dumps(doc, sort_keys=True,
                          allow_nan=True).encode("utf-8")
        data, headers = self._maybe_gzip(data, dict(headers or {}))
        return lambda: self._send(200, data, _JSON, headers=headers)

    def _fleet_for(self, daemon: Server, ds: Dataset):
        """The router where this request scatters: a fleet member, not a
        fleet's own leg, more than one member, and files to read."""
        if self._internal or daemon.fleet is None:
            return None
        if len(daemon.fleet.ring.nodes) < 2 or not ds.paths:
            return None
        return daemon.fleet

    def _forward(self, fleet, path: str, body: dict, key: str):
        """The remote leg of a scatter: ``body`` without its ``_``-keys,
        with ``key`` set to the shard's payload, POSTed to the peer."""
        base = {k: v for k, v in body.items() if not str(k).startswith("_")}

        def remote(peer, payload):
            return fleet.post(peer, path, {**base, key: payload},
                              tenant=self._tenant)
        return remote

    @staticmethod
    def _by_path_owner(fleet, ds: Dataset) -> Dict[str, list]:
        """The dataset's ``[global index, path]`` pairs by ring owner."""
        shards: Dict[str, list] = {}
        for i, path in enumerate(ds.paths):
            shards.setdefault(fleet.ring.owner_of_path(path),
                              []).append([i, path])
        return shards

    @staticmethod
    def _record_skips(shards: Dict[str, list], skips: List[dict]) -> dict:
        """Each skipped shard's files in ``read.files_skipped`` (a
        default ``ReadReport`` publishes at record time), and the
        ``X-Fleet-Skipped`` header naming the skipped peers."""
        if not skips:
            return {}
        from ..io.faults import ReadReport

        rep = ReadReport()
        for s in skips:
            for _gi, path in shards.get(s["peer"], []):
                rep.record_file_skip(path, rows=0, error=s["error"])
        return {"X-Fleet-Skipped": json.dumps(sorted(s["peer"]
                                                     for s in skips))}

    # -------------------------------------------------------------- lookup
    def _lookup(self, daemon: Server, body: dict):
        ds = daemon.dataset(str(self._required(body, "dataset")))
        column = str(self._required(body, "column"))
        keys = self._required(body, "keys")
        if not isinstance(keys, list) or not keys:
            raise _HttpError(400, "'keys' must be a non-empty list")
        columns = body.get("columns") or []
        fleet = self._fleet_for(daemon, ds)
        if fleet is not None:
            return self._fleet_lookup(fleet, body, ds, column, keys,
                                      columns)
        res = ds.find_rows(column, keys, columns=columns,
                           device=daemon.device)
        doc = {"hits": lookup_to_jsonable(res, keys),
               "rows_total": res.rows_total}
        return res.rows_total, lambda: self._send_json(200, doc)

    def _fleet_lookup(self, fleet, body: dict, ds: Dataset, column: str,
                      keys: list, columns: list):
        """Scatter the keys to their ring owners (splitmix64 of the key,
        the writer's partition hash), gather each key's hits, and merge
        them in the request's key order.  Each owner answers its keys over
        the whole dataset, so the row ordinals stay global."""
        shards: Dict[str, list] = {}
        for k in keys:
            shards.setdefault(fleet.ring.owner_of_key(k), []).append(k)
        device = self.daemon.device

        def local(peer, subkeys):
            res = ds.find_rows(column, subkeys, columns=columns,
                               device=device)
            return {"hits": lookup_to_jsonable(res, subkeys),
                    "rows_total": res.rows_total}

        results, skips = fleet.gather(
            shards, self._forward(fleet, "/v1/lookup", body, "keys"), local,
            exact=bool(body.get("exact")))
        by_key: Dict = {}
        total = 0
        for peer, doc in results.items():
            total += int(doc.get("rows_total", 0))
            for k, hit in zip(shards[peer], doc.get("hits", [])):
                by_key[self._key_id(k)] = hit
        hits = []
        for k in keys:
            hit = by_key.get(self._key_id(k))
            if hit is None:  # its shard was skipped (a degraded gather)
                hit = {"key": jsonable(k), "rows": [], "values": {},
                       "skipped": True}
            hits.append(hit)
        doc = {"hits": hits, "rows_total": total}
        if skips:
            doc["fleet"] = {"skipped": skips}
        return total, lambda: self._send_json(200, doc)

    @staticmethod
    def _key_id(k):
        # a key's identity in the merge: a float by its repr (NaN != NaN
        # would lose its hit), anything else itself
        if isinstance(k, float):
            return ("f", repr(k))
        return k

    # ---------------------------------------------------------------- scan
    @staticmethod
    def _file_batches(pf, prepared, columns, device):
        """The Arrow batches one file adds to a scan stream."""
        import pyarrow as pa

        from ..parallel.host_scan import scan_expr

        if prepared is not None:
            return [columns_to_arrow_batch(
                scan_expr(pf, prepared, columns=columns, device=device))]
        atab = pf.read(columns=columns, device=device).to_arrow() \
            .combine_chunks()
        batches = atab.to_batches()
        if not batches:
            # a file of 0 rows has no batch, but the stream needs its
            # schema (an empty body is no IPC stream)
            batches = [pa.record_batch(
                [pa.array([], type=f.type) for f in atab.schema],
                schema=atab.schema)]
        return batches

    @staticmethod
    def _file_json_line(pf, prepared, columns, device):
        """One file's JSON scan line and its rows: the unit of the scan's
        bytes, the same in the stream and in its pages."""
        from ..parallel.host_scan import scan_expr

        if prepared is not None:
            doc = columns_to_jsonable(
                scan_expr(pf, prepared, columns=columns, device=device))
        else:
            doc = {k: [jsonable(x) for x in v]
                   for k, v in pf.read(columns=columns, device=device)
                   .to_arrow().to_pydict().items()}
        n = len(next(iter(doc.values()))) if doc else 0
        line = (json.dumps({"columns": doc, "num_rows": n},
                           sort_keys=True) + "\n").encode("utf-8")
        return line, n

    @staticmethod
    def _done_line(total: int) -> bytes:
        return (json.dumps({"done": True, "num_rows": total})
                + "\n").encode("utf-8")

    def _file_arrow_stream(self, pf, prepared, columns, device):
        """One file's scan as a whole Arrow IPC stream: a fleet shard's
        unit on the wire, re-batched by the coordinator into one stream
        in the dataset's file order."""
        import io as _io

        import pyarrow as pa

        sink = _io.BytesIO()
        writer = None
        rows = 0
        for batch in self._file_batches(pf, prepared, columns, device):
            if writer is None:
                writer = pa.ipc.new_stream(sink, batch.schema)
            writer.write_batch(batch)
            rows += batch.num_rows
        if writer is not None:
            writer.close()
        return sink.getvalue(), rows

    def _scan(self, daemon: Server, body: dict):
        ds = daemon.dataset(str(self._required(body, "dataset")))
        expr = expr_from_wire(body.get("where"))
        columns = body.get("columns")
        fmt = body.get("format", "json")
        if fmt not in ("json", "arrow"):
            raise _HttpError(400, f"unknown format {fmt!r} (json|arrow)")
        files = body.get("_files")
        if files is not None:
            # a fleet's scan leg: no outside caller may send one
            if not self._internal:
                raise _HttpError(400, "'_files' is fleet-internal")
            doc = self._shard_scan(self._shard_pairs(files), expr, columns,
                                   fmt)
            return (sum(e["rows"] for e in doc["files"]),
                    lambda: self._send_json(200, doc))
        device = daemon.device
        if body.get("limit") is not None \
                or body.get("page_token") is not None:
            if fmt != "json":
                raise _HttpError(400, "pagination supports the json "
                                      "format")
            return self._scan_page(ds, expr, columns, body.get("limit"),
                                   body.get("page_token"), device)
        fleet = self._fleet_for(daemon, ds)
        if fleet is not None:
            return self._fleet_scan(fleet, body, ds, expr, columns, fmt)
        prepared = ds._prepare_where(None, None, None, None, expr) \
            if expr is not None else None
        # streamed: one chunk a file as each file scans, so the response
        # starts before the last file is read
        gz = self._accepts_gzip()
        self._streamed = True
        self.send_response(200)
        self.send_header("Content-Type", _ARROW if fmt == "arrow" else _JSON)
        if gz:
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        chunks = _ChunkedWriter(self.wfile)
        if gz:
            import gzip as _gzip

            out = _gzip.GzipFile(fileobj=chunks, mode="wb", mtime=0)
        else:
            out = chunks
        total = 0
        if fmt == "arrow":
            import pyarrow as pa

            writer = None
            for i in range(ds.num_files):
                for batch in self._file_batches(ds.file(i), prepared,
                                                columns, device):
                    if writer is None:
                        writer = pa.ipc.new_stream(out, batch.schema)
                    writer.write_batch(batch)
                    total += batch.num_rows
            if writer is not None:
                writer.close()
        else:
            for i in range(ds.num_files):
                line, n = self._file_json_line(ds.file(i), prepared,
                                               columns, device)
                out.write(line)
                total += n
            out.write(self._done_line(total))
        if gz:
            out.close()  # the gzip trailer into the chunk stream
        return total, chunks.finish

    def _scan_page(self, ds: Dataset, expr, columns, limit, token, device):
        """A page of the JSON scan, whole files at a time: file lines from
        the token's cursor until ``limit`` rows are in.  The pages
        concatenate to the unbounded stream byte for byte: the last page
        ends with the done line of the total the token carried."""
        lim = None
        if limit is not None:
            try:
                lim = int(limit)
            except (TypeError, ValueError) as e:
                raise _HttpError(400, f"bad limit: {e}") from e
            if lim <= 0:
                raise _HttpError(400, "'limit' must be a positive "
                                      "integer")
        start, prior = 0, 0
        if token is not None:
            try:
                tdoc = json.loads(base64.urlsafe_b64decode(
                    str(token).encode("ascii")))
                start, prior = int(tdoc["f"]), int(tdoc["n"])
            except (ValueError, KeyError, TypeError) as e:
                raise _HttpError(400, f"bad page_token: {e}") from e
            if not (0 <= start <= ds.num_files) or prior < 0:
                raise _HttpError(400, "page_token does not match this "
                                      "dataset")
        prepared = ds._prepare_where(None, None, None, None, expr) \
            if expr is not None else None
        parts = []
        page_rows = 0
        i = start
        while i < ds.num_files:
            line, n = self._file_json_line(ds.file(i), prepared, columns,
                                           device)
            parts.append(line)
            page_rows += n
            i += 1
            if lim is not None and page_rows >= lim:
                break
        headers = {}
        if i >= ds.num_files:
            parts.append(self._done_line(prior + page_rows))
        else:
            headers["X-Next-Page-Token"] = base64.urlsafe_b64encode(
                json.dumps({"f": i, "n": prior + page_rows},
                           sort_keys=True).encode("ascii")).decode("ascii")
        data, headers = self._maybe_gzip(b"".join(parts), headers)
        return page_rows, lambda: self._send(200, data, _JSON,
                                             headers=headers)

    def _shard_scan(self, pairs: list, expr, columns, fmt: str) -> dict:
        """A fleet scan shard's answer: for each ``(global index, path)``
        the file's unit (its JSON line, or its Arrow stream in base64) and
        rows, read on the daemon's device.  The coordinator's snapshot
        names the part files, so a member whose own snapshot lags a commit
        scans the same bytes (shared storage)."""
        device = self.daemon.device
        sub = Dataset([p for _, p in pairs])
        try:
            prepared = sub._prepare_where(None, None, None, None, expr) \
                if expr is not None else None
            out = []
            for j, (gi, _path) in enumerate(pairs):
                pf = sub.file(j)
                if fmt == "json":
                    line, n = self._file_json_line(pf, prepared, columns,
                                                   device)
                    out.append({"file": gi, "rows": n,
                                "line": line.decode("utf-8")})
                else:
                    data, n = self._file_arrow_stream(pf, prepared, columns,
                                                      device)
                    out.append({"file": gi, "rows": n,
                                "arrow": base64.b64encode(data)
                                .decode("ascii")})
        finally:
            sub.close()
        return {"files": out}

    @staticmethod
    def _shard_pairs(files) -> list:
        if not isinstance(files, list) or not files:
            raise _HttpError(400, "'_files' must be a non-empty list of "
                                  "[index, path] pairs")
        pairs = []
        for ent in files:
            if not (isinstance(ent, list) and len(ent) == 2
                    and isinstance(ent[0], int)
                    and isinstance(ent[1], str)):
                raise _HttpError(400, "'_files' entries must be "
                                      "[index, path] pairs")
            pairs.append((ent[0], ent[1]))
        return pairs

    def _fleet_scan(self, fleet, body: dict, ds: Dataset, expr, columns,
                    fmt: str):
        """Scatter the files to their path's ring owners, gather each
        file's unit, and splice them in the dataset's file order: with
        nothing skipped a JSON scan is the single node's stream byte for
        byte.  A shard that no one could serve degrades the answer to the
        files served, with the skips accounted (``fleet.peer_skips``,
        ``X-Fleet-Skipped``, ``read.files_skipped``), unless ``"exact":
        true`` asked for a failure instead."""
        shards = self._by_path_owner(fleet, ds)
        results, skips = fleet.gather(
            shards, self._forward(fleet, "/v1/scan", body, "_files"),
            lambda peer, pairs: self._shard_scan(
                self._shard_pairs(pairs), expr, columns, fmt),
            exact=bool(body.get("exact")))
        entries: Dict[int, dict] = {}
        for doc in results.values():
            for ent in doc.get("files", []):
                entries[int(ent["file"])] = ent
        ordered = [entries[i] for i in sorted(entries)]
        total = sum(int(e["rows"]) for e in ordered)
        headers = self._record_skips(shards, skips)
        if fmt == "json":
            data = b"".join([e["line"].encode("utf-8") for e in ordered]
                            + [self._done_line(total)])
            ctype = _JSON
        else:
            import io as _io

            import pyarrow as pa

            sink = _io.BytesIO()
            writer = None
            for e in ordered:
                for batch in pa.ipc.open_stream(base64.b64decode(e["arrow"])):
                    if writer is None:
                        writer = pa.ipc.new_stream(sink, batch.schema)
                    writer.write_batch(batch)
            if writer is not None:
                writer.close()
            data = sink.getvalue()
            ctype = _ARROW
        data, headers = self._maybe_gzip(data, headers)
        return total, lambda: self._send(200, data, ctype, headers=headers)

    # ----------------------------------------------------------- aggregate
    def _aggregate(self, daemon: Server, body: dict):
        ds = daemon.dataset(str(self._required(body, "dataset")))
        aggs = parse_aggs(self._required(body, "aggs"))
        expr = expr_from_wire(body.get("where"))
        group_by = body.get("group_by")
        files = body.get("_files")
        if files is not None:
            if not self._internal:
                raise _HttpError(400, "'_files' is fleet-internal")
            doc = self._shard_aggregate(self._shard_pairs(files), aggs,
                                        expr, group_by)
            return 0, lambda: self._send_json(200, doc)
        fleet = self._fleet_for(daemon, ds)
        if fleet is not None:
            return self._fleet_aggregate(fleet, body, ds, aggs, expr,
                                         group_by)
        res = ds.aggregate(aggs, where=expr, group_by=group_by,
                           device=daemon.device)
        doc = {"aggregates": {k: jsonable(v) for k, v in res.items()},
               "tiers": {k: v for k, v in res.counters.items() if v}}
        if res.groups is not None:
            doc["groups"] = [jsonable(k) for k in res.groups]
        return 0, self._respond_json(doc)

    def _shard_aggregate(self, pairs: list, aggs, expr, group_by) -> dict:
        """A fleet aggregate shard's answer: the named files' partial state
        (the accumulators, not finalized values, which would lose the
        distinct sets a merged ``distinct`` needs) through the lossless
        state codec, folded on the daemon's device."""
        from ..io.aggregate import dataset_aggregate, encode_agg_state

        sub = Dataset([p for _, p in pairs])
        try:
            state = dataset_aggregate(sub, aggs, where=expr,
                                      group_by=group_by,
                                      device=self.daemon.device,
                                      _state_only=True)
        finally:
            sub.close()
        return {"state": encode_agg_state(state)}

    def _fleet_aggregate(self, fleet, body: dict, ds: Dataset, aggs, expr,
                         group_by):
        """Scatter an aggregate to the files' ring owners and merge their
        partial states as the dataset merges its files' states.  The legs
        carry the request's agg strings: ``_expand_derived`` is
        deterministic, so every member derives the same positional base
        list and the state documents line up."""
        from ..io.aggregate import (_COUNTER_KEYS, _Acc, _expand_derived,
                                    _finalize, _validate, decode_agg_state)

        base, plan = _expand_derived(aggs)
        leaves, _gleaf = _validate(ds.schema, base, group_by)
        shards = self._by_path_owner(fleet, ds)
        results, skips = fleet.gather(
            shards, self._forward(fleet, "/v1/aggregate", body, "_files"),
            lambda peer, pairs: self._shard_aggregate(
                self._shard_pairs(pairs), aggs, expr, group_by),
            exact=bool(body.get("exact")))
        counters = {k: 0 for k in _COUNTER_KEYS}
        lines = [f"aggregate: fleet of {len(shards)} shard(s), "
                 f"{len(ds.paths)} file(s)"]
        accs = [_Acc(a, leaves[i]) for i, a in enumerate(base)]
        groups: Optional[dict] = {} if group_by is not None else None
        for peer in sorted(results):
            doc = results[peer]
            if not isinstance(doc.get("state"), dict):
                raise _HttpError(502, f"peer {peer!r} returned no "
                                      "aggregate state")
            paccs, pgroups, pcounters = decode_agg_state(doc["state"], base,
                                                         leaves)
            for k in _COUNTER_KEYS:
                counters[k] += pcounters.get(k, 0)
            for acc, d in zip(accs, paccs):
                acc.merge(d)
            for k, daccs in (pgroups or {}).items():
                cur = groups.get(k)
                if cur is None:
                    groups[k] = daccs
                else:
                    for acc, d in zip(cur, daccs):
                        acc.merge(d)
        headers = self._record_skips(shards, skips)
        for s in skips:
            counters["files_skipped"] += len(shards.get(s["peer"], []))
        res = _finalize(base, accs, groups, counters, lines, None, plan=plan)
        doc = {"aggregates": {k: jsonable(v) for k, v in res.items()},
               "tiers": {k: v for k, v in res.counters.items() if v}}
        if res.groups is not None:
            doc["groups"] = [jsonable(k) for k in res.groups]
        if skips:
            doc["fleet"] = {"skipped": skips}
        return 0, self._respond_json(doc, headers=headers)

    # -------------------------------------------------------- fleet commit
    def _fleet_commit(self, daemon: Server, body: dict):
        """The commit arbiter: the table's ring owner runs every manifest
        commit of the fleet through its local compare-and-swap, so two
        daemons ingesting one table converge on one linear history.  Only
        a fleet's own sub-request may call it
        (``FleetRouter.arbiter_resolver``)."""
        if daemon.fleet is None:
            raise _HttpError(404, "not a fleet member")
        if not self._internal:
            raise _HttpError(400, "/v1/fleet/commit is fleet-internal")
        import os

        from ..io.manifest import Manifest, cas_commit_local

        table_dir = str(self._required(body, "table_dir"))
        hosted = {os.path.abspath(spec.table): name
                  for name, spec in daemon.config.datasets.items()
                  if spec.table}
        name = hosted.get(os.path.abspath(table_dir))
        if name is None:
            # no arbitration for a directory this daemon does not host:
            # the caller's local compare-and-swap (shared storage, the
            # O_EXCL claim) still serializes
            raise _HttpError(403, f"table {table_dir!r} is not hosted "
                                  "here")
        try:
            expected = int(self._required(body, "expected_version"))
            man = Manifest.deserialize(
                str(self._required(body, "manifest")).encode("utf-8"))
        except (ValueError, KeyError, TypeError) as e:
            raise _HttpError(400, f"bad commit request: {e}") from e
        committed, version = cas_commit_local(table_dir, expected, man)
        if committed:
            daemon._refresh_dataset(name)
        doc = {"committed": bool(committed), "version": int(version)}
        return 0, lambda: self._send_json(200, doc)

    # --------------------------------------------------------------- write
    def _write(self, daemon: Server, body: dict):
        name = str(self._required(body, "dataset"))
        spec = daemon.config.datasets.get(name)
        if spec is None:
            raise _HttpError(404, f"unknown dataset {name!r}")
        if not spec.writable:
            raise _HttpError(403, f"dataset {name!r} is not writable")
        rows = self._required(body, "rows")
        if not isinstance(rows, dict) or not rows:
            raise _HttpError(400, "'rows' must be a non-empty object of "
                                  "column -> value list")
        lengths = {len(v) for v in rows.values() if isinstance(v, list)}
        if len(lengths) != 1 or not all(isinstance(v, list)
                                        for v in rows.values()):
            raise _HttpError(400, "'rows' columns must be equal-length "
                                  "lists")
        n = lengths.pop()
        import pyarrow as pa

        from ..algebra import SortingColumn
        from ..dataset_writer import DatasetWriter

        ds = daemon.dataset(name)
        tab = pa.table(rows)
        sorting = [SortingColumn(spec.sorting)] if spec.sorting else None
        # one writer a request: the rows show at the manifest commit or
        # not at all.  Concurrent commits serialize in the manifest's own
        # locked read-modify-write, so the daemon holds no lock here.
        w = DatasetWriter(spec.table, ds.schema, sorting=sorting,
                          rows_per_file=spec.rows_per_file)
        try:
            w.write_arrow(tab)
            manifest = w.commit()
        finally:
            w.close()
        daemon._refresh_dataset(name)
        _oscope.account(_M_COMMITS)
        doc = {"version": manifest.version if manifest else None, "rows": n}
        return n, lambda: self._send_json(200, doc)
