"""Remote byte sources: objects read by HTTP(S) range requests.

The port's copy of ``parquet_tpu/io/remote.py``.  ``io/source.py::
as_source`` opens an ``http(s)://`` URL as an :class:`HttpSource` and an
``s3://bucket/key`` URL as an :class:`ObjectStoreSource` against
``PARQUET_TPU_TORCH_S3_ENDPOINT``, so every read, stream, lookup, scan,
aggregate and ``Dataset`` of the port runs over them unchanged: the bytes
come over the network, the plan, staging and decode are those of a local
file.  Around the transport sits the fault envelope:

- **Classification**: a failure raises a
  :class:`~parquet_tpu_torch.errors.RemoteError` with host, status,
  attempt and byte range, retryable (refused or reset connection, 5xx,
  429 with its ``Retry-After``, a torn body, a stall) or terminal (other
  4xx, an unsatisfiable range).  ``io/faults.py::retry_call`` reads the
  class, so a ``FaultPolicy``'s retries, deadline and degraded reads
  apply as they do to a local file.
- **Hedged preads**: after :func:`hedge_delay_s` (the p95 of the
  ``remote.pread_s`` histogram, or ``PARQUET_TPU_TORCH_REMOTE_HEDGE``), a
  second attempt races the first and the first success wins.  The hedge
  takes its own grant from the read admission gate (``hedge`` tier) and
  withdraws from its queue once the primary has won; its bytes in flight
  are counted (:func:`remote_debug`) and drain to 0.  The race's wait
  keeps the operation's deadline.
- **Circuit breakers** per host: ``PARQUET_TPU_TORCH_REMOTE_BREAKER``
  consecutive connection failures open the host's circuit; requests then
  fail fast with :class:`~parquet_tpu_torch.errors.RemoteCircuitOpenError`
  until the cooldown lets one half-open probe through.
- **Auth hooks** (:func:`register_auth_hook`): header callbacks or
  presigned URLs, refreshed on 401/403.
- **Cache identity**: ``stat_key`` is ``(url, etag, last_modified,
  size)`` from the HEAD, so the footer and page caches serve a warm
  re-open with one HEAD and no GET; a moved validator drops the URL's
  cached entries (``io/cache.py::invalidate_path``).
- **Listing**: :func:`list_prefix` (a JSON or HTML listing of an
  ``http(s)://.../prefix/``) and :func:`list_prefix_s3` (ListObjectsV2,
  paginated) expand a ``Dataset`` prefix as a glob expands a directory.
- :func:`parallel_preads`: disjoint ranges fetched at once, one per
  pooled connection (the remote aggregate's pre-fetch).

Every counter moves through ``obs.scope.account`` (the op's report sees
it), a pread's bytes land in ``read.bytes_read``, and the hedges' bytes in
flight are the ledger's ``remote.hedge_in_flight`` account.  The chaos
side, ``FaultInjectingRemoteTransport`` and the loopback
``LocalRangeServer``, is in ``io/faults.py``.
"""

from __future__ import annotations

import re
import socket
import threading
import time
from collections import OrderedDict
from http.client import HTTPConnection, HTTPException, HTTPSConnection
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from ..errors import (CorruptedError, DeadlineError, RemoteCircuitOpenError,
                      RemoteError, RemoteTerminalError, RemoteThrottledError,
                      RemoteTransientError)
from ..obs.ledger import ledger_account
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.scope import account as _account
from ..obs.scope import account_bytes as _account_bytes
from ..utils.env import env_float, env_int, env_str
from ..utils.pool import read_admission
from .source import Source
from ..utils import locks as _locks
from ..utils.locks import make_condition, make_lock

__all__ = ["HttpSource", "ObjectStoreSource", "HttpTransport",
           "CircuitBreaker", "breaker_for", "breakers", "reset_breakers",
           "remote_debug", "hedge_delay_s", "observed_pread_ewma",
           "drain_connection_pools", "parallel_preads",
           "parallel_pread_slots", "register_auth_hook",
           "unregister_auth_hook", "list_prefix", "list_prefix_s3",
           "resolve_s3_url", "s3_endpoint", "classify_status",
           "gunzip_body", "hedge_in_flight_bytes"]

_M_PREADS = _counter("remote.preads")
_M_BYTES = _counter("remote.bytes")
_M_HEDGES = _counter("remote.hedges_issued")
_M_HEDGES_WON = _counter("remote.hedges_won")
_M_FAIL_FAST = _counter("remote.breaker_fail_fast")
_M_VALIDATOR_CHANGES = _counter("remote.validator_changes")
_M_PARALLEL_PREADS = _counter("remote.parallel_preads")
_M_AUTH_REFRESHES = _counter("remote.auth_refreshes")
_M_ERRORS = {c: _counter("remote.errors", labels={"class": c})
             for c in ("retryable", "terminal", "throttled")}
_M_TRANSITIONS = {s: _counter("remote.breaker_transitions",
                              labels={"state": s})
                  for s in ("open", "half_open", "closed")}
_H_PREAD_S = _histogram("remote.pread_s")

_CONTENT_RANGE = re.compile(r"bytes\s+(\d+)-(\d+)/(\d+|\*)")

# the hedge delay before remote.pread_s has seen enough preads, and the
# bounds of the adaptive one
DEFAULT_HEDGE_DELAY_S = 0.05
_HEDGE_WARMUP_COUNT = 16
_HEDGE_MIN_S = 0.002
_HEDGE_MAX_S = 2.0
# a host whose pread EWMA passes this is "remote_far" to the prefetcher
_FAR_LATENCY_S = 0.03

# the hedges' duplicate bytes in flight: added when a hedge starts its
# fetch, taken away when it ends (won, lost or abandoned)
_ACC_HEDGE = ledger_account("remote.hedge_in_flight")


def hedge_in_flight_bytes() -> int:
    """Bytes the hedged second attempts are fetching now (0 at rest): a
    view of the ledger's ``remote.hedge_in_flight`` account."""
    return _ACC_HEDGE.resident


# ---------------------------------------------------------------------------
# Transport: range requests over http.client, keep-alive connections pooled
# per host
# ---------------------------------------------------------------------------
class _HostPool:
    """The idle keep-alive connections to one (scheme, host), shared by
    every transport to it; at most ``cap`` are kept, the rest close."""

    def __init__(self, cap: int):
        self.cap = cap
        self._lock = make_lock("remote.host_pool")
        self._idle: List = []

    def get(self):
        with self._lock:
            return self._idle.pop() if self._idle else None

    def put(self, conn) -> None:
        with self._lock:
            if len(self._idle) < self.cap:
                self._idle.append(conn)
                return
        conn.close()

    def drain(self) -> int:
        with self._lock:
            conns, self._idle = self._idle, []
        for c in conns:
            c.close()
        return len(conns)

    def __len__(self) -> int:
        with self._lock:
            return len(self._idle)


_POOLS: Dict[tuple, _HostPool] = {}
_POOLS_LOCK = make_lock("remote.pools_registry")


def _host_pool(scheme: str, host: str, timeout_s: float,
               cap: int) -> _HostPool:
    key = (scheme, host, timeout_s)
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = _HostPool(cap)
        return pool


def drain_connection_pools() -> int:
    """Close every idle pooled connection (tests, shutdown); returns how
    many closed.  Requests in flight are not touched."""
    with _POOLS_LOCK:
        pools = list(_POOLS.values())
    return sum(p.drain() for p in pools)


class HttpTransport:
    """Ranged HTTP (and the fleet's peer POSTs, :meth:`post`) over
    ``http.client``, with the host's pool of keep-alive connections
    (``PARQUET_TPU_TORCH_REMOTE_POOL``, 4): concurrent preads each check
    out a connection and return it when their response is drained.  ``timeout_s`` (``PARQUET_TPU_TORCH_REMOTE_TIMEOUT``, 30 s)
    bounds every socket operation, so a stalled server surfaces as
    ``socket.timeout``.  A pooled connection the server closed while it
    idled fails its first reuse with a reset, and is retried once on
    another connection; a timeout is never retried here.

    Mechanism only: it returns ``(status, lowercase headers, body)`` or
    raises the ``OSError``; :class:`HttpSource` classifies and retries,
    and ``io/faults.py::FaultInjectingRemoteTransport`` wraps this
    interface."""

    def __init__(self, url: str, pool_size: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"HttpTransport needs an http(s) URL, "
                             f"got {url!r}")
        if not parts.netloc:
            raise ValueError(f"URL {url!r} has no host")
        self.url = url
        self.host = parts.netloc
        self._scheme = parts.scheme
        self._request_path = parts.path or "/"
        if parts.query:
            self._request_path += "?" + parts.query
        self.pool_size = (pool_size if pool_size is not None
                          else env_int("PARQUET_TPU_TORCH_REMOTE_POOL"))
        self.timeout_s = (timeout_s if timeout_s is not None
                          else env_float("PARQUET_TPU_TORCH_REMOTE_TIMEOUT"))
        self._pool = _host_pool(parts.scheme, parts.netloc, self.timeout_s,
                                self.pool_size)
        self._closed = False

    def _checkout(self):
        """``(connection, reused)``: a reused one may retry a reset."""
        if self._closed:
            raise ValueError(f"request on closed transport {self.url!r}")
        conn = self._pool.get()
        if conn is not None:
            return conn, True
        cls = HTTPSConnection if self._scheme == "https" else HTTPConnection
        return cls(self.host, timeout=self.timeout_s), False

    def _roundtrip(self, method: str, headers: Optional[dict] = None,
                   path_override: Optional[str] = None,
                   body: Optional[bytes] = None
                   ) -> Tuple[int, Dict[str, str], bytes]:
        path = (self._request_path if path_override is None
                else path_override)
        while True:
            conn, reused = self._checkout()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                status = resp.status
                hdrs = {k.lower(): v for k, v in resp.getheaders()}
                # read the body whole: a half-read response would poison
                # the connection for its next request
                body = resp.read()
                reusable = not resp.will_close
            except socket.timeout:
                conn.close()
                raise  # a stall is real, never a stale connection
            except (HTTPException, OSError):
                conn.close()
                if reused:
                    continue  # the server idled this connection out
                raise
            except BaseException:
                conn.close()
                raise
            if reusable:
                self._pool.put(conn)
            else:
                conn.close()
            return status, hdrs, body

    def head(self, extra_headers: Optional[dict] = None,
             path_override: Optional[str] = None
             ) -> Tuple[int, Dict[str, str]]:
        status, hdrs, _ = self._roundtrip("HEAD", dict(extra_headers or {}),
                                          path_override)
        return status, hdrs

    def get_range(self, offset: int, size: int,
                  extra_headers: Optional[dict] = None,
                  path_override: Optional[str] = None
                  ) -> Tuple[int, Dict[str, str], bytes]:
        headers = dict(extra_headers or {})
        headers["Range"] = f"bytes={offset}-{offset + size - 1}"
        return self._roundtrip("GET", headers, path_override)

    def post(self, path: str, body: bytes,
             extra_headers: Optional[dict] = None
             ) -> Tuple[int, Dict[str, str], bytes]:
        """POST ``body`` to ``path`` on this transport's host (the fleet's
        peer protocol), on the same pooled connections and with the same
        one retry after a stale reuse as the GETs: every peer sub-request
        is idempotent (a read, or a commit conditional on a version)."""
        headers = dict(extra_headers or {})
        headers.setdefault("Content-Type", "application/json")
        headers["Content-Length"] = str(len(body))
        return self._roundtrip("POST", headers, path_override=path,
                               body=body)

    def idle_connections(self) -> int:
        return len(self._pool)

    def close(self) -> None:
        # the idle pool is the host's: other transports keep using it
        self._closed = True


# ---------------------------------------------------------------------------
# Circuit breakers, one per host
# ---------------------------------------------------------------------------
def breaker_threshold() -> int:
    """``PARQUET_TPU_TORCH_REMOTE_BREAKER``: consecutive failures that open
    a host's circuit (0: never), read at each check."""
    return env_int("PARQUET_TPU_TORCH_REMOTE_BREAKER")


def breaker_cooldown_s() -> float:
    """``PARQUET_TPU_TORCH_REMOTE_BREAKER_COOLDOWN``: seconds an open
    circuit waits before one half-open probe."""
    return env_float("PARQUET_TPU_TORCH_REMOTE_BREAKER_COOLDOWN")


class CircuitBreaker:
    """The consecutive-failure breaker of one host.

    ``closed`` turns ``open`` after :func:`breaker_threshold` consecutive
    connection failures (refused, reset, timeout, 5xx); an open circuit
    refuses every request until :func:`breaker_cooldown_s` has passed,
    then turns ``half_open`` and lets one probe through: its success
    closes the circuit, its failure opens it again.  A 4xx, a 429 or a
    torn body from a host that answered leaves the streak alone.  A probe
    whose outcome never came back holds its slot for one cooldown at
    most.  Each transition counts in ``remote.breaker_transitions``."""

    def __init__(self, host: str):
        self.host = host
        self._lock = make_lock("remote.breaker")
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures

    def _transition(self, new: str) -> None:
        self._state = new  # under self._lock
        _account(_M_TRANSITIONS[new])

    def allow(self) -> bool:
        """May a request go out now?"""
        if breaker_threshold() <= 0:
            return True
        with self._lock:
            if self._state == "closed":
                return True
            now = time.monotonic()
            if self._state == "open":
                if now - self._opened_at < breaker_cooldown_s():
                    return False
                self._transition("half_open")
                self._probe_in_flight = False
            if self._probe_in_flight and (now - self._probe_started_at
                                          < breaker_cooldown_s()):
                return False
            self._probe_in_flight = True
            self._probe_started_at = now
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            if self._state != "closed":
                self._transition("closed")

    def record_inconclusive(self) -> None:
        """An outcome that says nothing of the host's health (a 429, a
        deadline): free the probe slot, move nothing else."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        threshold = breaker_threshold()
        if threshold <= 0:
            return
        with self._lock:
            self._failures += 1
            self._probe_in_flight = False
            if self._state == "half_open" or (
                    self._state == "closed" and self._failures >= threshold):
                self._transition("open")
                self._opened_at = time.monotonic()


_BREAKERS: Dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = make_lock("remote.breakers_registry")


def breaker_for(host: str) -> CircuitBreaker:
    """The process-wide breaker of ``host``."""
    with _BREAKERS_LOCK:
        b = _BREAKERS.get(host)
        if b is None:
            b = _BREAKERS[host] = CircuitBreaker(host)
        return b


def breakers() -> Dict[str, CircuitBreaker]:
    """Every host's breaker, as a copy."""
    with _BREAKERS_LOCK:
        return dict(_BREAKERS)


def reset_breakers() -> None:
    """Forget every breaker (tests)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


# ---------------------------------------------------------------------------
# Observed latency: the hedge delay and the prefetcher's latency class
# ---------------------------------------------------------------------------
_LAT_LOCK = make_lock("remote.latency_ewma")
_LAT_EWMA: Dict[str, float] = {}  # host -> seconds


def _observe_pread(seconds: float, host: str) -> None:
    _H_PREAD_S.observe(seconds)
    with _LAT_LOCK:
        prev = _LAT_EWMA.get(host)
        _LAT_EWMA[host] = (seconds if prev is None
                           else 0.2 * seconds + 0.8 * prev)


def observed_pread_ewma(host: str) -> Optional[float]:
    """The EWMA of ``host``'s successful pread seconds (None before the
    first), per host: a far bucket does not make a near one far."""
    with _LAT_LOCK:
        return _LAT_EWMA.get(host)


def _reset_latency() -> None:
    """Forget the observed latencies (tests)."""
    with _LAT_LOCK:
        _LAT_EWMA.clear()


def hedge_delay_s() -> Optional[float]:
    """Seconds before a pread's hedged second attempt, or None when
    hedging is off.  ``PARQUET_TPU_TORCH_REMOTE_HEDGE``: ``0``/``off``
    none, a number pins the delay, ``auto`` takes the p95 of
    ``remote.pread_s`` clamped to [2 ms, 2 s] (50 ms until 16 preads were
    seen)."""
    mode = env_str("PARQUET_TPU_TORCH_REMOTE_HEDGE").lower()
    if mode in ("0", "off", "false", "no"):
        return None
    if mode not in ("", "1", "auto"):
        try:
            return max(0.0, float(mode))
        except ValueError:
            pass
    if _H_PREAD_S.count < _HEDGE_WARMUP_COUNT:
        return DEFAULT_HEDGE_DELAY_S
    p95 = _H_PREAD_S.percentile(0.95)
    if p95 is None:
        return DEFAULT_HEDGE_DELAY_S
    return min(max(p95, _HEDGE_MIN_S), _HEDGE_MAX_S)


# ---------------------------------------------------------------------------
# Auth hooks
# ---------------------------------------------------------------------------
_AUTH_HOOKS: Dict[str, object] = {}  # URL prefix -> hook
_AUTH_HOOKS_LOCK = make_lock("remote.auth_hooks")


def register_auth_hook(url_prefix: str, hook) -> None:
    """Authenticate every :class:`HttpSource` whose URL starts with
    ``url_prefix`` (the longest registered prefix wins):
    ``hook(url, refresh)`` is called before the first request
    (``refresh=False``, its answer kept by the source) and again with
    ``refresh=True`` on a 401 or 403, at most
    ``PARQUET_TPU_TORCH_REMOTE_AUTH_RETRY`` times a request (counted in
    ``remote.auth_refreshes``).  It returns request headers, or a dict
    with a ``"url"`` key: a presigned URL on the same host to request in
    place of the object's path.  ``HttpSource(auth=...)`` overrides the
    registry for one source."""
    if not callable(hook):
        raise TypeError("auth hook must be callable(url, refresh)")
    with _AUTH_HOOKS_LOCK:
        _AUTH_HOOKS[url_prefix] = hook


def unregister_auth_hook(url_prefix: str) -> None:
    with _AUTH_HOOKS_LOCK:
        _AUTH_HOOKS.pop(url_prefix, None)


def _auth_hook_for(url: str):
    with _AUTH_HOOKS_LOCK:
        best = None
        for prefix, hook in _AUTH_HOOKS.items():
            if url.startswith(prefix) and (best is None
                                           or len(prefix) > len(best[0])):
                best = (prefix, hook)
        return best[1] if best else None


def _reset_auth_hooks() -> None:
    """Forget every registered hook (tests)."""
    with _AUTH_HOOKS_LOCK:
        _AUTH_HOOKS.clear()


def auth_refresh_attempts() -> int:
    """``PARQUET_TPU_TORCH_REMOTE_AUTH_RETRY``: refreshes per request."""
    return max(0, env_int("PARQUET_TPU_TORCH_REMOTE_AUTH_RETRY"))


# ---------------------------------------------------------------------------
# Validators: the cache identity of a URL
# ---------------------------------------------------------------------------
_VALIDATOR_CAP = 4096  # URLs remembered, least recently opened dropped
_VALIDATORS: "OrderedDict[str, tuple]" = OrderedDict()
_VALIDATORS_LOCK = make_lock("remote.validators")


def _note_validator(url: str, validator: tuple) -> None:
    """Remember the object's HEAD validator.  One that moved means the
    object was rewritten: every cached footer, page and absent-key memo
    of the URL is dropped.  A URL the bounded memo forgot loses only the
    detection: its cache entries are keyed by the validator anyway."""
    with _VALIDATORS_LOCK:
        old = _VALIDATORS.pop(url, None)
        _VALIDATORS[url] = validator
        while len(_VALIDATORS) > _VALIDATOR_CAP:
            _VALIDATORS.popitem(last=False)
    if old is not None and old != validator:
        from .cache import invalidate_path  # deferred: cache is heavier

        _account(_M_VALIDATOR_CHANGES)
        invalidate_path(url)


def _reset_validators() -> None:
    """Forget every remembered validator (tests)."""
    with _VALIDATORS_LOCK:
        _VALIDATORS.clear()


def _check_read_args(offset: int, size: int) -> None:
    if offset < 0 or size < 0:
        raise CorruptedError(f"invalid read: offset={offset} size={size}")


def _retry_after(hdrs: Dict[str, str]) -> Optional[float]:
    v = hdrs.get("retry-after", "").strip()
    if not v:
        return None
    try:
        return max(0.0, float(v))
    except ValueError:
        return None  # the HTTP-date form: unspecified


# ---------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------
class HttpSource(Source):
    """A remote object read by HTTP range requests.

    The constructor sends a HEAD (retried twice on a transient failure:
    an open runs before any policy wraps the source) for
    ``Content-Length`` and the validators.  ``stat_key`` is ``(url, etag,
    last_modified, size)`` where the server sends a validator and the
    transport is a plain :class:`HttpTransport`; else None, and the file
    is never cached (a wrapped transport may change the bytes).

    Each pread asks the host's :class:`CircuitBreaker`, races a hedged
    second attempt after :func:`hedge_delay_s`, classifies its failure
    and counts ``remote.preads``, ``remote.bytes`` and
    ``remote.pread_s``."""

    def __init__(self, url: str, transport=None,
                 pool_size: Optional[int] = None,
                 timeout_s: Optional[float] = None, auth=None):
        self.url = url
        self._transport = (transport if transport is not None
                           else HttpTransport(url, pool_size=pool_size,
                                              timeout_s=timeout_s))
        self.host = (getattr(self._transport, "host", None)
                     or urlsplit(url).netloc)
        self._breaker = breaker_for(self.host)
        self._closed = False
        self._auth_hook = auth if auth is not None else _auth_hook_for(url)
        self._auth_lock = make_lock("remote.auth_state")
        self._auth_cached: Optional[dict] = None
        status, hdrs = self._head()
        cl = hdrs.get("content-length")
        if cl is None:
            raise RemoteTerminalError(
                "HEAD response has no Content-Length: cannot size the "
                "remote object", host=self.host, status=status,
                path=self.url)
        self._size = int(cl)
        etag = hdrs.get("etag")
        last_modified = hdrs.get("last-modified")
        if isinstance(self._transport, HttpTransport) and (etag
                                                           or last_modified):
            self.stat_key = (url, etag, last_modified, self._size)
            _note_validator(url, (etag, last_modified, self._size))
        else:
            self.stat_key = None

    @property
    def path(self) -> str:
        """The URL: a remote file's place in error messages."""
        return self.url

    @property
    def latency_class(self) -> str:
        """The prefetcher's latency class (``io/prefetch.py``):
        ``remote``, or ``remote_far`` once the host's pread EWMA passes
        30 ms."""
        e = observed_pread_ewma(self.host)
        return ("remote_far" if e is not None and e > _FAR_LATENCY_S
                else "remote")

    def _auth(self, refresh: bool = False):
        """``(extra headers or None, presigned path or None)`` from the
        auth hook; ``refresh`` asks the hook anew."""
        if self._auth_hook is None:
            return None, None
        with self._auth_lock:
            if refresh or self._auth_cached is None:
                got = self._auth_hook(self.url, refresh)
                if got is None:
                    got = {}
                if not isinstance(got, dict):
                    raise RemoteTerminalError(
                        "auth hook must return a header dict (or one "
                        "with a 'url' presign key)", host=self.host,
                        path=self.url)
                self._auth_cached = dict(got)
                if refresh:
                    _account(_M_AUTH_REFRESHES)
            hdrs = dict(self._auth_cached)
        presigned = hdrs.pop("url", None)
        path_override = None
        if presigned:
            parts = urlsplit(str(presigned))
            path_override = ((parts.path or "/")
                             + ("?" + parts.query if parts.query else ""))
        return (hdrs or None), path_override

    def _request(self, call):
        """``call(extra_headers, path_override)`` (plain when no hook),
        asked again after a refresh on a 401 or 403."""
        refreshes = 0
        while True:
            if self._auth_hook is not None:
                ah, override = self._auth()
                got = call(ah, override)
            else:
                got = call(None, None)
            if (got[0] in (401, 403) and self._auth_hook is not None
                    and refreshes < auth_refresh_attempts()):
                refreshes += 1  # the host answered: no breaker movement
                self._auth(refresh=True)
                continue
            return got

    def _fail_fast(self, **where) -> RemoteCircuitOpenError:
        _account(_M_FAIL_FAST)
        return RemoteCircuitOpenError(f"circuit open for {self.host}",
                                      host=self.host, path=self.url,
                                      **where)

    def _head(self) -> Tuple[int, Dict[str, str]]:
        from .faults import FaultPolicy, retry_call

        def head(ah, override):
            if ah is None and override is None:
                return self._transport.head()
            return self._transport.head(extra_headers=ah,
                                        path_override=override)

        def once(_o, _s):
            # the breaker is asked at each attempt: a retry must not
            # hammer a circuit its own failures opened
            if not self._breaker.allow():
                raise self._fail_fast()
            try:
                status, hdrs = self._request(head)
            except RemoteError:
                raise
            except (HTTPException, OSError) as e:
                self._breaker.record_failure()
                raise RemoteTransientError(f"HEAD failed: {e}",
                                           host=self.host,
                                           path=self.url) from e
            if status == 429:
                self._breaker.record_inconclusive()
                raise RemoteThrottledError(
                    "throttled on HEAD", retry_after=_retry_after(hdrs),
                    host=self.host, status=status, path=self.url)
            if 500 <= status < 600:
                self._breaker.record_failure()
                raise RemoteTransientError(
                    "server error on HEAD", host=self.host, status=status,
                    path=self.url)
            self._breaker.record_success()  # an answer: the host is alive
            if status != 200:
                raise RemoteTerminalError("HEAD failed", host=self.host,
                                          status=status, path=self.url)
            return status, hdrs

        return retry_call(once, 0, 0,
                          FaultPolicy(max_retries=2, backoff_s=0.05))

    # ---------------------------------------------------------------- preads
    def _fetch(self, offset: int, size: int, attempt: int) -> bytes:
        """One round trip, classified; exactly ``size`` bytes or a
        :class:`RemoteError`."""
        where = dict(host=self.host, attempt=attempt, offset=offset,
                     size=size, path=self.url)

        def get(ah, override):
            if ah is None and override is None:
                return self._transport.get_range(offset, size)
            return self._transport.get_range(offset, size, extra_headers=ah,
                                             path_override=override)

        try:
            status, hdrs, body = self._request(get)
        except RemoteError:
            raise
        except (HTTPException, TimeoutError, ConnectionError) as e:
            raise RemoteTransientError(f"connection failure: {e}",
                                       **where) from e
        except OSError as e:
            raise RemoteTransientError(f"transport failure: {e}",
                                       **where) from e
        if status == 206:
            cr = hdrs.get("content-range", "")
            m = _CONTENT_RANGE.match(cr)
            if m and int(m.group(1)) != offset:
                # a proxy served the wrong range: retried before any
                # wrong byte reaches a decoder
                raise RemoteTransientError(
                    f"wrong range: asked for {offset}, got {cr!r}",
                    status=status, **where)
            data = body
        elif status == 200:
            data = body[offset:offset + size]  # the server ignored Range
        elif status == 416:
            raise RemoteTerminalError("range not satisfiable",
                                      status=status, **where)
        elif status == 429:
            raise RemoteThrottledError(
                "throttled", retry_after=_retry_after(hdrs), status=status,
                **where)
        elif 500 <= status < 600:
            raise RemoteTransientError("server error", status=status,
                                       **where)
        else:
            raise RemoteTerminalError("request failed", status=status,
                                      **where)
        if len(data) != size:
            raise RemoteTransientError(
                f"truncated body: wanted {size}, got {len(data)}",
                status=status, **where)
        return data

    def _fetch_raced(self, offset: int, size: int) -> bytes:
        """The primary attempt and, after :func:`hedge_delay_s`, a hedged
        one; the first success wins.  A primary that fails raises its
        error at once (the retry policy owns recovery, not the hedge).
        The wait keeps the operation's deadline; an abandoned attempt
        skips its fetch if it has not started, and gives its grant and
        its hedge bytes back when it ends."""
        from .faults import active_deadline

        delay = hedge_delay_s()
        if delay is None:
            return self._fetch(offset, size, 0)
        cv = make_condition("remote.hedge_cv")
        results: Dict[int, tuple] = {}
        state = {"abandoned": False}

        def abandoned() -> bool:
            with cv:
                return state["abandoned"]

        def attempt(idx: int, hedge: bool) -> None:
            out = ("skip", None)
            adm, grant, charged = None, 0, False
            try:
                if hedge and not abandoned():
                    # the hedge's copy is extra bytes in flight: its own
                    # grant, withdrawn from the queue once the primary won
                    adm = read_admission()
                    grant = adm.acquire(size, tier="hedge",
                                        give_up=abandoned)
                    _ACC_HEDGE.add(size)
                    charged = True
                if not abandoned():
                    try:
                        out = ("ok", self._fetch(offset, size, idx))
                    # ptlint: disable=PT005 -- not swallowed: the error
                    # goes into the result slot and the waiter raises it
                    except BaseException as e:
                        out = ("err", e)
            finally:
                if charged:
                    _ACC_HEDGE.sub(size)
                if adm is not None:
                    adm.release(grant, tier="hedge")
                with cv:
                    results[idx] = out
                    cv.notify_all()

        threads = [threading.Thread(target=attempt, args=(0, False),
                                    daemon=True, name="pqt-remote-pread")]
        threads[0].start()
        dl = active_deadline()
        hedge_at = time.monotonic() + delay
        while True:
            with cv:
                win = next((i for i in (0, 1)
                            if results.get(i, ("",))[0] == "ok"), None)
                if win is not None:
                    state["abandoned"] = True
                    if win == 1:
                        _account(_M_HEDGES_WON)
                    return results[win][1]
                r0 = results.get(0)
                if r0 is not None:
                    state["abandoned"] = True
                    if r0[0] == "err":
                        raise r0[1]
                    raise RemoteTransientError(
                        "hedged read produced no result", host=self.host,
                        offset=offset, size=size, path=self.url)
                # sleep until the hedge is due, the deadline, or a notify
                waits = []
                if len(threads) == 1:
                    waits.append(hedge_at - time.monotonic())
                if dl is not None:
                    rem = dl.remaining()
                    if rem is not None:
                        waits.append(rem)
                timeout = max(min(waits), 0.0) if waits else None
                if timeout is None or timeout > 0:
                    cv.wait(timeout=timeout)
            if dl is not None and dl.expired():
                with cv:
                    state["abandoned"] = True
                raise DeadlineError(
                    f"deadline exceeded during hedged remote "
                    f"pread({offset}, {size}) [host={self.host}]",
                    path=self.url)
            if len(threads) == 1 and time.monotonic() >= hedge_at:
                _account(_M_HEDGES)
                threads.append(threading.Thread(
                    target=attempt, args=(1, True), daemon=True,
                    name="pqt-remote-hedge"))
                threads[1].start()

    def pread(self, offset: int, size: int) -> bytes:
        if _locks.LOCKCHECK_ENABLED:
            _locks.note_blocking("remote.pread", detail=self.host)
        _check_read_args(offset, size)
        if self._closed:
            raise ValueError(f"read on closed source {self.url!r}")
        if size == 0:
            return b""
        if not self._breaker.allow():
            raise self._fail_fast(offset=offset, size=size)
        t0 = time.perf_counter()
        try:
            data = self._fetch_raced(offset, size)
        except RemoteThrottledError:
            _account(_M_ERRORS["throttled"])
            self._breaker.record_inconclusive()  # alive, only busy
            raise
        except RemoteTransientError as e:
            _account(_M_ERRORS["retryable"])
            if e.status is not None and e.status < 500:
                # the host answered with a torn or wrong body: retryable,
                # but not a failure of the host
                self._breaker.record_inconclusive()
            else:
                self._breaker.record_failure()
            raise
        except RemoteTerminalError:
            _account(_M_ERRORS["terminal"])
            self._breaker.record_success()  # a 4xx: the host is alive
            raise
        except BaseException:
            self._breaker.record_inconclusive()  # a deadline, a teardown
            raise
        self._breaker.record_success()
        _observe_pread(time.perf_counter() - t0, self.host)
        _account(_M_PREADS)
        _account(_M_BYTES, size)
        _account_bytes(size)  # the terminal source: read.bytes_read
        return data

    def size(self) -> int:
        return self._size

    @property
    def parallel_pread_slots(self) -> int:
        """Range requests worth issuing at once: the host pool's depth
        (for a wrapped transport, ``PARQUET_TPU_TORCH_REMOTE_POOL``)."""
        got = getattr(self._transport, "pool_size", None)
        if got is None:
            got = env_int("PARQUET_TPU_TORCH_REMOTE_POOL")
        return max(int(got or 1), 1)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._transport.close()


class ObjectStoreSource(HttpSource):
    """An object-store object (S3, GCS, R2: presigned, public or behind an
    auth hook): its reads are the HEAD and ranged GETs of
    :class:`HttpSource`; the name states the intent."""


# ---------------------------------------------------------------------------
# Listing
# ---------------------------------------------------------------------------
def classify_status(status: int, hdrs: Dict[str, str], host: str,
                    path: str, what: str = "request") -> None:
    """Raise the :class:`~parquet_tpu_torch.errors.RemoteError` a non-2xx
    ``status`` is (429 throttled with its ``Retry-After``, 5xx transient,
    other 4xx terminal); a 2xx returns."""
    if 200 <= status < 300:
        return
    if status == 429:
        raise RemoteThrottledError(
            f"throttled on {what}", retry_after=_retry_after(hdrs),
            host=host, status=status, path=path)
    if 500 <= status < 600:
        raise RemoteTransientError(f"server error on {what}", host=host,
                                   status=status, path=path)
    raise RemoteTerminalError(f"{what} failed", host=host, status=status,
                              path=path)


def gunzip_body(data: bytes, host: str = "", path: str = "") -> bytes:
    """A ``Content-Encoding: gzip`` body inflated; a torn stream is a
    transient error (fetched again), not corruption."""
    import gzip
    import zlib

    try:
        return gzip.decompress(data)
    except (EOFError, zlib.error, OSError) as e:
        raise RemoteTransientError(f"truncated/torn gzip body: {e}",
                                   host=host, path=path) from e


def _parse_listing(body: bytes, base_url: str) -> List[str]:
    """File URLs of a listing: a JSON array of names, a JSON object with a
    ``files``/``keys``/``entries`` list, or else HTML ``href``s.  Names
    resolve against the listing URL; subdirectories (a trailing ``/``)
    and parent links are dropped: one level, as a glob."""
    import json
    from urllib.parse import urljoin

    names: List[str] = []
    try:
        doc = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        doc = None
    if isinstance(doc, list):
        names = [str(n) for n in doc]
    elif isinstance(doc, dict):
        for key in ("files", "keys", "entries"):
            if isinstance(doc.get(key), list):
                names = [str(n) for n in doc[key]]
                break
    else:
        names = re.findall(r'href="([^"?#]+)"',
                           body.decode("utf-8", "replace"))
    return sorted({urljoin(base_url, n) for n in names
                   if n and not n.endswith("/") and not n.startswith(".")})


def _listing_get(transport: HttpTransport, url: str, what: str,
                 accept: str, path_override: Optional[str] = None) -> bytes:
    """One listing GET through the host's breaker, classified; the body
    inflated where the server gzipped it."""
    host = transport.host
    breaker = breaker_for(host)
    if not breaker.allow():
        _account(_M_FAIL_FAST)
        raise RemoteCircuitOpenError(f"circuit open for {host}", host=host,
                                     path=url)
    try:
        status, hdrs, body = transport._roundtrip(
            "GET", {"Accept": accept}, path_override=path_override)
    except (HTTPException, OSError) as e:
        breaker.record_failure()
        raise RemoteTransientError(f"listing failed: {e}", host=host,
                                   path=url) from e
    if status == 429:
        breaker.record_inconclusive()
    elif 500 <= status < 600:
        breaker.record_failure()
    else:
        breaker.record_success()
    classify_status(status, hdrs, host, url, what=what)
    if hdrs.get("content-encoding", "").lower() == "gzip":
        body = gunzip_body(body, host=host, path=url)
    return body


def list_prefix(url: str, policy=None) -> List[str]:
    """The sorted file URLs under an ``http(s)://.../prefix/`` listing: a
    remote glob.  The GET retries through ``io/faults.py::retry_call``
    (``policy``, or two retries) and the host's breaker.  An empty
    listing raises ``FileNotFoundError``, as an unmatched glob does."""
    from .faults import FaultPolicy, retry_call

    transport = HttpTransport(url)
    try:
        files = retry_call(
            lambda _o, _s: _parse_listing(_listing_get(
                transport, url, "prefix listing", "application/json"), url),
            0, 0, policy if policy is not None
            else FaultPolicy(max_retries=2, backoff_s=0.05))
    finally:
        transport.close()
    if not files:
        raise FileNotFoundError(f"prefix listing {url!r} matched no files")
    return files


def s3_endpoint() -> str:
    """``PARQUET_TPU_TORCH_S3_ENDPOINT``, the endpoint ``s3://`` URLs
    resolve against path-style (empty when unset)."""
    return env_str("PARQUET_TPU_TORCH_S3_ENDPOINT").strip().rstrip("/")


def resolve_s3_url(url: str) -> str:
    """``s3://bucket/key`` as the path-style ``{endpoint}/bucket/key`` URL
    it is read from: object-store reads are ranged HTTP, and auth rides
    an auth hook or a presigned URL."""
    ep = s3_endpoint()
    if not ep:
        raise ValueError(
            f"{url!r} needs PARQUET_TPU_TORCH_S3_ENDPOINT (the HTTP(S) "
            "endpoint serving path-style bucket requests); for presigned "
            "or public objects use the http(s):// URL directly")
    rest = url[len("s3://"):]
    if not rest or rest.startswith("/"):
        raise ValueError(f"bad s3 url {url!r} (want s3://bucket/key)")
    return f"{ep}/{rest}"


def _parse_s3_listing(body: bytes, host: str = "",
                      path: str = "") -> Tuple[List[str], Optional[str]]:
    """``(keys, continuation token or None)`` of one ListObjectsV2 page;
    a torn or non-XML body is transient."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise RemoteTransientError(f"torn ListObjectsV2 body: {e}",
                                   host=host, path=path) from e
    keys: List[str] = []
    token: Optional[str] = None
    truncated = False
    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        if tag == "Key":
            keys.append(el.text or "")
        elif tag == "IsTruncated":
            truncated = (el.text or "").strip().lower() == "true"
        elif tag == "NextContinuationToken":
            token = (el.text or "").strip() or None
    return keys, (token if truncated else None)


def list_prefix_s3(url: str, policy=None) -> List[str]:
    """The sorted ``s3://`` object URLs under ``s3://bucket/prefix/``:
    ListObjectsV2 (``?list-type=2``, ``delimiter=/``: one level) against
    ``PARQUET_TPU_TORCH_S3_ENDPOINT``, following continuation tokens, each
    page retried as :func:`list_prefix` retries.  An empty listing raises
    ``FileNotFoundError``."""
    from urllib.parse import urlencode

    from .faults import FaultPolicy, retry_call

    bucket, _, prefix = url[len("s3://"):].partition("/")
    if not bucket:
        raise ValueError(f"bad s3 url {url!r} (want s3://bucket/prefix/)")
    base = resolve_s3_url(f"s3://{bucket}")
    transport = HttpTransport(base)
    base_path = urlsplit(base).path or "/"
    pol = (policy if policy is not None
           else FaultPolicy(max_retries=2, backoff_s=0.05))
    keys: List[str] = []
    token: Optional[str] = None
    try:
        while True:
            q = {"list-type": "2", "prefix": prefix, "delimiter": "/"}
            if token:
                q["continuation-token"] = token
            page = f"{base_path}?{urlencode(q)}"
            page_keys, token = retry_call(
                lambda _o, _s, page=page: _parse_s3_listing(
                    _listing_get(transport, url, "ListObjectsV2",
                                 "application/xml", path_override=page),
                    host=transport.host, path=url), 0, 0, pol)
            keys.extend(page_keys)
            if not token:
                break
    finally:
        transport.close()
    out = sorted({f"s3://{bucket}/{k}" for k in keys
                  if k and not k.endswith("/")})
    if not out:
        raise FileNotFoundError(f"prefix listing {url!r} matched no files")
    return out


# ---------------------------------------------------------------------------
# Several ranges at once
# ---------------------------------------------------------------------------
def parallel_pread_slots(source) -> int:
    """Range requests the chain under ``source`` can usefully issue at
    once, at most ``PARQUET_TPU_TORCH_REMOTE_PARALLEL`` (0 or 1: 0): the
    ``parallel_pread_slots`` of the first source down the wrapper chain
    that has one.  A local chain answers 0."""
    cap = env_int("PARQUET_TPU_TORCH_REMOTE_PARALLEL")
    if cap <= 1:
        return 0
    s = source
    for _ in range(8):  # a wrapper chain is short
        if s is None:
            break
        got = getattr(s, "parallel_pread_slots", None)
        if got:
            return min(int(got), cap)
        s = getattr(s, "inner", None)
    return 0


def parallel_preads(source, ranges, slots: int):
    """``[(offset, bytes), ...]`` of the disjoint ``(offset, size)``
    ``ranges``, in input order, fetched with at most ``slots`` preads in
    flight on threads that pull from one queue (a slow range holds only
    its own slot).  The preads go through the top of ``source``'s chain,
    so its retries, hedges and breakers apply to each, under the caller's
    deadline (a copy of its context).  Every thread is joined; then a
    ``DeadlineError`` raises first, else the first error.  Counted in
    ``remote.parallel_preads``."""
    import contextvars
    import itertools

    if _locks.LOCKCHECK_ENABLED:
        _locks.note_blocking("remote.parallel_preads")
    ranges = list(ranges)
    results: List = [None] * len(ranges)
    errors: List = [None] * len(ranges)
    ctx = contextvars.copy_context()
    nxt = itertools.count()

    def worker() -> None:
        while True:
            i = next(nxt)
            if i >= len(ranges):
                return
            off, size = ranges[i]
            try:
                results[i] = ctx.copy().run(source.pread, off, size)
            # ptlint: disable=PT005 -- not swallowed: kept in the
            # range's error slot and raised after the join below
            except BaseException as e:
                errors[i] = e

    threads = [threading.Thread(target=worker, daemon=True,
                                name="pqt-parallel-pread")
               for _ in range(min(max(slots, 1), len(ranges)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dl = next((e for e in errors if isinstance(e, DeadlineError)), None)
    if dl is not None:
        raise dl
    first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    _account(_M_PARALLEL_PREADS, len(ranges))
    return [(off, data) for (off, _), data in zip(ranges, results)]


def remote_debug() -> dict:
    """The remote layer now: each host's breaker state and failure
    streak, the hedges' bytes in flight, the hedge delay and each host's
    pread EWMA."""
    with _LAT_LOCK:
        ewmas = {h: round(v, 6) for h, v in sorted(_LAT_EWMA.items())}
    return {
        "breakers": {h: {"state": b.state,
                         "consecutive_failures": b.consecutive_failures}
                     for h, b in sorted(breakers().items())},
        "hedge_in_flight_bytes": hedge_in_flight_bytes(),
        "hedge_delay_s": hedge_delay_s(),
        "pread_ewma_s": ewmas,
    }
