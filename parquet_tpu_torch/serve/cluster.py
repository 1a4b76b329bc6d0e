"""The serving fleet: consistent-hash routing, scatter-gather with peer
hedging, and commit arbitration across daemons.

The port's copy of ``parquet_tpu/serve/cluster.py``.  A fleet is N daemons
over shared storage, each booted with the same ``cluster`` config block
(peer name -> base URL).  Three mechanisms make them one server:

- **Consistent-hash routing**: :class:`HashRing` places
  ``PARQUET_TPU_TORCH_FLEET_VNODES`` virtual nodes a peer on a 64-bit
  ring.  A point lookup routes each key by the splitmix64 finalizer that
  ``dataset_writer._partition_ids`` spreads part files by, so a
  key-partitioned table's keys and its files hash alike; scans and
  aggregates shard by file path.  Adding or removing a peer moves only
  the arcs it owned.
- **Scatter-gather**: :meth:`FleetRouter.gather` sends each shard to its
  owner with a deadline carved from the request's (less
  ``PARQUET_TPU_TORCH_FLEET_MARGIN_S`` for the merge), hedges a slow
  peer with a local run of its shard after
  ``PARQUET_TPU_TORCH_FLEET_HEDGE_S`` (unset: the remote hedge's adaptive
  delay, ``io/remote.py::hedge_delay_s``; storage is shared, so the local
  replica is always a valid hedge), runs the shard locally when the peer
  fails, and, where even that fails, skips the shard with accounting
  (``fleet.peer_skips``, the response's fleet report) or fails fast when
  the caller asked for ``exact``.  Every shard served here, peer leg,
  hedge or fallback, reads on the daemon's device.
- **Commit arbitration**: :meth:`FleetRouter.arbiter_resolver` sends each
  table's conditional manifest write (a compare-and-swap on the manifest
  version) to the table's ring owner's ``/v1/fleet/commit``, so two
  daemons ingesting one table converge through one arbiter.

A peer is reached by :class:`~parquet_tpu_torch.io.remote.HttpTransport`
POSTs under the remote reads' per-host circuit breakers and failure
classes (``breaker_for``, ``classify_status``): a dead peer fails fast
after ``PARQUET_TPU_TORCH_REMOTE_BREAKER`` errors in a row and heals
through the half-open probe.  The chaos hook
(``io/faults.py::peer_chaos``) is consulted before every sub-request.
Every thread a router starts (a shard's gather thread, its peer leg, its
hedge) is joined by :meth:`FleetRouter.close`.
"""

from __future__ import annotations

import bisect
import json
import os
import socket
import threading
import time
from http.client import HTTPException
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from ..errors import (RemoteCircuitOpenError, RemoteError,
                      RemoteTransientError)
from ..io.faults import active_deadline, peer_chaos
from ..io.remote import (HttpTransport, breaker_for, classify_status,
                         gunzip_body, hedge_delay_s)
from ..obs.metrics import counter as _counter
from ..obs.scope import account as _account
from ..utils.env import env_float, env_int, env_opt_float
from .config import ClusterSpec

__all__ = ["splitmix64", "shard_key", "HashRing", "FleetRouter"]

_M_FORWARDS = _counter("fleet.forwards")
_M_GATHERS = _counter("fleet.gathers")
_M_PEER_ERRORS = _counter("fleet.peer_errors")
_M_LOCAL_FALLBACKS = _counter("fleet.local_fallbacks")
_M_HEDGES_ISSUED = _counter("fleet.hedges_issued")
_M_HEDGES_WON = _counter("fleet.hedges_won")
_M_PEER_SKIPS = _counter("fleet.peer_skips")

_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """The splitmix64 finalizer of one value, bit for bit
    ``dataset_writer._partition_ids``' vectorized hash: a key routes to
    the arc the writer's key partitioning spread it by."""
    x &= _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & _MASK64
    return h


def shard_key(value) -> int:
    """The 64-bit ring position of a routing key: an int goes straight
    through :func:`splitmix64` (the writer's partitioner; NULL is 0, as
    in ``_partition_ids``); a string or bytes (a file path, a vnode label)
    folds through FNV-1a first; a float routes by its ``repr`` (NaN
    included), the text a JSON round trip keeps."""
    if value is None:
        value = 0
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        return splitmix64(value)
    if isinstance(value, float):
        value = repr(value)
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, (bytes, bytearray)):
        return splitmix64(_fnv1a64(bytes(value)))
    raise TypeError(f"unroutable shard key {value!r}")


class HashRing:
    """The consistent-hash ring over the fleet's peer names.  Immutable
    once built (membership is config; repointing a peer's URL does not
    move the ring), so a lookup takes no lock."""

    def __init__(self, nodes, vnodes: Optional[int] = None):
        self.nodes: Tuple[str, ...] = tuple(sorted(set(nodes)))
        if not self.nodes:
            raise ValueError("hash ring needs at least one node")
        self.vnodes = (int(vnodes) if vnodes is not None
                       else max(env_int("PARQUET_TPU_TORCH_FLEET_VNODES"), 1))
        points = sorted((shard_key(f"{name}#{v}"), name)
                        for name in self.nodes for v in range(self.vnodes))
        self._points = points
        self._hashes = [h for h, _ in points]

    def owner(self, h: int) -> str:
        """The peer owning ring position ``h`` (the first vnode
        clockwise)."""
        i = bisect.bisect_right(self._hashes, h & _MASK64)
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def owner_of_key(self, key) -> str:
        return self.owner(shard_key(key))

    def owner_of_path(self, path: str) -> str:
        return self.owner(shard_key(str(path)))

    def spread(self, items) -> Dict[str, list]:
        """``items`` (hashed as paths) grouped by owner."""
        out: Dict[str, list] = {}
        for it in items:
            out.setdefault(self.owner_of_path(str(it)), []).append(it)
        return out


class _PeerDeadError(RemoteTransientError):
    """A peer sub-request that gave no result inside its deadline: as
    retryable as a failed connection."""


class FleetRouter:
    """One daemon's view of the fleet: the ring, the peer transports, the
    gather engine and the commit arbiter's resolver.  A
    :class:`~parquet_tpu_torch.serve.Server` whose config has a
    ``cluster`` block owns one."""

    def __init__(self, cluster: ClusterSpec,
                 tokens: Optional[Dict[str, str]] = None):
        self.self_name = cluster.self_name
        self.ring = HashRing(cluster.peers)
        self._lock = threading.Lock()
        self._urls: Dict[str, Optional[str]] = dict(cluster.peers)
        self._transports: Dict[str, HttpTransport] = {}
        self._tokens = dict(tokens or {})
        self._threads: set = set()

    # -- membership -------------------------------------------------------
    def set_peers(self, urls: Dict[str, str]) -> None:
        """Repoint peers' base URLs (daemons bound to ephemeral ports
        first, then each member learns where the others landed).  Only
        URLs move; the ring's members are the config's."""
        with self._lock:
            for name, url in urls.items():
                if name not in self._urls:
                    raise ValueError(f"unknown fleet peer {name!r}")
                old = self._transports.pop(name, None)
                if old is not None:
                    old.close()
                self._urls[name] = url or None

    def peer_url(self, name: str) -> Optional[str]:
        with self._lock:
            return self._urls.get(name)

    def is_self(self, name: str) -> bool:
        return name == self.self_name

    def _transport(self, name: str, url: str) -> HttpTransport:
        with self._lock:
            t = self._transports.get(name)
            if t is None:
                t = self._transports[name] = HttpTransport(url)
            return t

    def _start(self, target, name: str) -> threading.Thread:
        """Start a thread that :meth:`close` joins."""
        t = threading.Thread(target=target, name=name, daemon=True)
        with self._lock:
            self._threads = {x for x in self._threads if x.is_alive()}
            self._threads.add(t)
        t.start()
        return t

    # -- peer protocol ----------------------------------------------------
    def post(self, peer: str, path: str, doc: dict,
             tenant: Optional[str] = None) -> dict:
        """One JSON sub-request to ``peer``: the chaos hook, the breaker,
        the POST with the ``X-Fleet-Internal`` marker (the receiver serves
        locally and meters under the original tenant without charging its
        QPS bucket again), then the remote reads' failure classes.  Raises
        a :class:`~parquet_tpu_torch.errors.RemoteError` on any failure;
        the gather decides what to do about it."""
        url = self.peer_url(peer)
        if url is None:
            raise RemoteTransientError(
                f"fleet peer {peer!r} has no URL yet", host=peer, path=path)
        transport = self._transport(peer, url)
        host = transport.host
        breaker = breaker_for(host)
        if not breaker.allow():
            raise RemoteCircuitOpenError(
                f"circuit open for fleet peer {peer!r}", host=host,
                path=path)
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        headers = {"X-Fleet-Internal": "1"}
        if tenant:
            headers["X-Tenant"] = tenant
            tok = self._tokens.get(tenant)
            if tok:
                headers["Authorization"] = f"Bearer {tok}"
        _account(_M_FORWARDS)
        try:
            # the chaos hook raises ConnectionRefusedError inside the
            # breaker's window: a chaos-killed peer trips the breaker as a
            # real refused connect does
            chaos = peer_chaos()
            if chaos is not None:
                chaos.check(peer)
            status, hdrs, resp = transport.post(path, body, headers)
        except (HTTPException, socket.timeout, TimeoutError, OSError) as e:
            breaker.record_failure()
            raise RemoteTransientError(
                f"fleet peer {peer!r} unreachable: {e}", host=host,
                path=path) from e
        if status == 429:
            breaker.record_inconclusive()
        elif 500 <= status < 600:
            breaker.record_failure()
        else:
            breaker.record_success()
        classify_status(status, hdrs, host, path,
                        what=f"fleet sub-request to {peer!r}")
        if hdrs.get("content-encoding", "").lower() == "gzip":
            resp = gunzip_body(resp, host=host, path=path)
        try:
            return json.loads(resp.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            # a torn or garbled body is the connection's fault: retryable
            raise RemoteTransientError(
                f"fleet peer {peer!r} sent an unparseable body: {e}",
                host=host, path=path) from e

    # -- scatter-gather ---------------------------------------------------
    def _per_peer_budget_s(self) -> float:
        budget = env_float("PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S")
        dl = active_deadline()
        if dl is not None:
            left = dl.remaining()
            if left is not None:
                margin = env_float("PARQUET_TPU_TORCH_FLEET_MARGIN_S")
                budget = min(budget, max(left - margin, 0.05))
        return budget

    def _hedge_delay_s(self, per_peer_s: float) -> Optional[float]:
        pinned = env_opt_float("PARQUET_TPU_TORCH_FLEET_HEDGE_S")
        if pinned is not None:
            return pinned if pinned > 0 else None  # 0 turns it off
        adaptive = hedge_delay_s()  # the remote preads' delay
        if adaptive is not None and adaptive > 0:
            return min(adaptive, per_peer_s * 0.5)
        return per_peer_s * 0.5

    def _run_one(self, peer: str, payload,
                 remote_call: Callable[[str, Any], Any],
                 local_call: Callable[[str, Any], Any],
                 per_peer_s: float) -> Tuple[str, Any, str]:
        """One shard: ``("ok", result, via)`` or ``("err", error, peer)``;
        ``via`` is ``local``, ``peer``, ``hedge`` or ``fallback``."""
        if self.is_self(peer) or self.peer_url(peer) is None:
            try:
                return "ok", local_call(peer, payload), "local"
            except Exception as e:
                return "err", e, peer
        cv = threading.Condition()
        slots: Dict[str, Tuple[str, Any]] = {}  # leg -> (kind, value)

        def leg(name: str, fn) -> Callable[[], None]:
            def run():
                try:
                    got = ("ok", fn(peer, payload))
                except Exception as e:
                    got = ("err", e)
                with cv:
                    slots[name] = got
                    cv.notify_all()
            return run

        def hedge_won() -> bool:
            return slots.get("hedge", ("",))[0] == "ok"

        t0 = time.monotonic()
        self._start(leg("peer", remote_call), f"pqt-fleet-{peer}")
        hedged = False
        hedge_s = self._hedge_delay_s(per_peer_s)
        if hedge_s is not None and hedge_s < per_peer_s:
            with cv:
                cv.wait_for(lambda: "peer" in slots, hedge_s)
                hedged = "peer" not in slots
            if hedged:
                # a slow peer: race a local run of its shard (shared
                # storage: the local replica is authoritative)
                _account(_M_HEDGES_ISSUED)
                self._start(leg("hedge", local_call),
                            f"pqt-fleet-hedge-{peer}")
        with cv:
            cv.wait_for(lambda: "peer" in slots or hedge_won(),
                        max(per_peer_s - (time.monotonic() - t0), 0.0))
            got = slots.get("peer")
            if got is None and hedge_won():
                _account(_M_HEDGES_WON)
                return "ok", slots["hedge"][1], "hedge"
        if got is not None and got[0] == "ok":
            return "ok", got[1], "peer"
        # the peer failed or ran out of time
        _account(_M_PEER_ERRORS)
        if hedged:
            with cv:
                cv.wait_for(lambda: "hedge" in slots,
                            max(per_peer_s - (time.monotonic() - t0), 0.0)
                            + 0.05)
                if hedge_won():
                    _account(_M_HEDGES_WON)
                    return "ok", slots["hedge"][1], "hedge"
        err = (got[1] if got is not None
               else _PeerDeadError(f"fleet peer {peer!r} produced no "
                                   f"result in {per_peer_s:.3f}s",
                                   host=peer))
        try:
            result = local_call(peer, payload)
        except Exception:
            return "err", err, peer
        _account(_M_LOCAL_FALLBACKS)
        return "ok", result, "fallback"

    def gather(self, shards: Dict[str, Any],
               remote_call: Callable[[str, Any], Any],
               local_call: Callable[[str, Any], Any],
               exact: bool = False) -> Tuple[Dict[str, Any], List[dict]]:
        """Scatter ``shards`` (peer -> payload) and gather the results:
        ``(peer -> result, skips)``.  Each shard runs at its peer, raced
        by a local hedge and run locally where the peer fails
        (:meth:`_run_one`); a shard that still gave nothing is skipped with
        accounting, unless ``exact``, where the first such shard raises
        (no partial answer)."""
        _account(_M_GATHERS)
        per_peer_s = self._per_peer_budget_s()
        order = sorted(shards)
        outs: Dict[str, Tuple[str, Any, str]] = {}

        def drive(name: str) -> Callable[[], None]:
            def run():
                outs[name] = self._run_one(name, shards[name], remote_call,
                                           local_call, per_peer_s)
            return run

        threads = [self._start(drive(name), f"pqt-gather-{name}")
                   for name in order]
        for t in threads:
            t.join(per_peer_s + 1.0)
        results: Dict[str, Any] = {}
        skips: List[dict] = []
        for name in order:
            got = outs.get(name)
            if got is None:
                got = ("err", _PeerDeadError(
                    f"gather thread for {name!r} never finished",
                    host=name), name)
            kind, value, _ = got
            if kind == "ok":
                results[name] = value
                continue
            if exact:
                if isinstance(value, RemoteError):
                    raise value
                raise RemoteTransientError(
                    f"fleet shard {name!r} unservable: {value}",
                    host=name) from value
            _account(_M_PEER_SKIPS)
            skips.append({"peer": name, "error": f"{value}"})
        return results, skips

    # -- commit arbitration ----------------------------------------------
    def arbiter_resolver(self) -> Callable:
        """The resolver ``io/manifest.py::set_commit_arbiter`` installs:
        each table directory's conditional manifest write goes to its ring
        owner's ``/v1/fleet/commit``.  A table this daemon owns (and a
        crash-matrix commit carrying a ``sink_wrap``, which cannot cross a
        process) resolves to None: the local ``O_EXCL`` compare-and-swap."""
        def resolver(table_dir) -> Optional[Callable]:
            owner = self.ring.owner_of_path(
                os.path.abspath(os.fspath(table_dir)))
            if self.is_self(owner) or self.peer_url(owner) is None:
                return None

            def arbiter(td, expected_version, manifest, sink_wrap=None):
                from ..io.manifest import cas_commit_local

                if sink_wrap is not None:
                    return cas_commit_local(td, expected_version, manifest,
                                            sink_wrap)
                doc = {"table_dir": os.path.abspath(os.fspath(td)),
                       "expected_version": int(expected_version),
                       "manifest": manifest.serialize().decode("utf-8")}
                try:
                    got = self.post(owner, "/v1/fleet/commit", doc)
                except RemoteError:
                    # the arbiter is dead; the shared storage is not, and
                    # the O_EXCL claim file keeps the conditional write
                    # exclusive across processes
                    return cas_commit_local(td, expected_version, manifest,
                                            None)
                return bool(got.get("committed")), int(
                    got.get("version", 0))

            return arbiter

        return resolver

    # -- observability ----------------------------------------------------
    def debug(self) -> dict:
        """The ``/debugz`` ``fleet`` section: this member, the vnodes, and
        each peer's URL and breaker state."""
        with self._lock:
            urls = dict(self._urls)
        doc = {"self": self.self_name, "vnodes": self.ring.vnodes,
               "peers": {}}
        for name in self.ring.nodes:
            url = urls.get(name)
            entry: Dict[str, Any] = {"url": url, "self": self.is_self(name)}
            if url:
                host = urlsplit(url).netloc
                if host:
                    entry["breaker"] = breaker_for(host).state
            doc["peers"][name] = entry
        return doc

    def close(self) -> None:
        """Close the transports and join every thread the router
        started (a peer leg ends when its POST answers or times out)."""
        with self._lock:
            transports = list(self._transports.values())
            self._transports.clear()
        for t in transports:
            t.close()
        while True:
            with self._lock:
                started, self._threads = self._threads, set()
            if not started:
                return
            for t in started:
                t.join()
