"""Span tracing: Chrome trace-event JSON that Perfetto loads.

The port's copy of ``parquet_tpu/obs/trace.py``.  Every stage that
carries the pipeline (the footer open, prefetch windows and waits, the
host decode of a chunk, the planner, the host scan's two phases, encode
and emit, sink flushes, the host-to-device staging of a plan, pool tasks)
is wrapped in a :func:`trace_span`; each completed span records the thread
it ran on, and the buffer flushes to the Chrome ``traceEvents`` format, so
overlap shows as overlapping bars on different thread tracks.  A span
times the host: around work queued on a CUDA stream it times the enqueue,
and it never synchronizes the device.

Overhead contract — tracing OFF is the production default and must cost
nothing measurable:

- ``TRACE_ENABLED`` is a module-level bool.  The hottest sites read it
  directly (``if trace.TRACE_ENABLED:``) and skip span construction
  entirely.
- :func:`trace_span` called while disabled returns one shared no-op
  singleton — no object allocation, no timestamps, no lock.

Enabling:

- ``PARQUET_TPU_TORCH_TRACE=/path/trace.json`` (env, read at import): tracing
  on for the process, buffer flushed to that path at interpreter exit.
- :func:`enable_tracing`/:func:`disable_tracing`/:func:`flush_trace` —
  the programmatic controls (tests, notebooks).

The event buffer is bounded (:data:`MAX_EVENTS`); overflow drops new
events and counts them in the ``trace.events_dropped`` metric instead of
growing without bound.  While tracing is on, each completed span also
feeds a ``span.<name>_s`` latency histogram in the metrics registry, so
stage p50/p99 come for free with a traced run.

Request scopes (obs/scope.py) route spans through two context variables
here: ``_TRACK`` gives every span of an operation the op's own Perfetto
"process" track (pid = op id, named by a one-time ``process_name``
metadata event), and ``_SINK`` — set for ops head-sampling decided NOT to
trace — diverts completed spans into a per-op :class:`OpRing` that is
promoted to the global buffer only if the op turns out slow (tail
capture) and discarded allocation-cheap otherwise.  Both are
``contextvars``, so pool workers running an op's tasks inherit them via
the context copy of ``utils/pool.submit`` and of the read's own
worker pools.
"""

from __future__ import annotations

import atexit
import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..utils.env import env_str
from . import metrics as _metrics
from .ledger import ledger_account as _ledger_account
from ..utils.locks import make_lock

__all__ = ["TRACE_ENABLED", "trace_span", "span", "enabled",
           "enable_tracing", "disable_tracing", "flush_trace",
           "trace_events", "reset_trace", "MAX_EVENTS", "OpRing",
           "promote_ring", "emit_op_event"]

TRACE_ENABLED = False
MAX_EVENTS = 1_000_000
# per-op ring capacity: bounds the allocation a never-kept op can pin
OP_RING_EVENTS = 4096
# ledger accounting (obs/ledger.py): estimated bytes per buffered event —
# a Chrome "X" dict with name/ts/dur/pid/tid/cat runs ~200 bytes of
# python objects; exact sizing per event would cost more than the buffer
_EVENT_EST_BYTES = 200
_ACC_TRACE = _ledger_account("trace.buffer",
                             capacity=lambda: MAX_EVENTS * _EVENT_EST_BYTES)

_LOCK = make_lock("trace.buffer")
_EVENTS: List[dict] = []
_SEEN_TIDS: set = set()   # (pid, tid) pairs with thread_name metadata out
_SEEN_PIDS: Dict[int, str] = {}  # op pid -> label, process_name emitted
_TRACE_PATH: Optional[str] = None
_ATEXIT_REGISTERED = False
# one epoch per process: span timestamps are µs since this mark, so every
# thread's spans share one Perfetto timeline
_EPOCH = time.perf_counter()

# set by an active op scope (obs/scope.py): (pid, label) giving spans a
# per-request Perfetto track, and the per-op ring for unsampled ops.
# Context variables — pool workers inherit them with the op's context.
_TRACK: "contextvars.ContextVar[Optional[Tuple[int, str]]]" = \
    contextvars.ContextVar("parquet_tpu_torch_trace_track", default=None)
_SINK: "contextvars.ContextVar[Optional[OpRing]]" = \
    contextvars.ContextVar("parquet_tpu_torch_trace_sink", default=None)
# stage-breakdown hook, bound by obs/scope.py at import: called as
# (span_name, duration_s) for every completed span while tracing is on
_ON_SPAN = None


class _NullSpan:
    """The disabled-tracing singleton: a context manager that does nothing
    and allocates nothing.  Identity-stable so tests can assert the
    disabled path never constructs per-call objects."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# span-name -> histogram, resolved once: per-span-exit observation must not
# take the registry's get-or-create lock or rebuild the key string (the
# registry's no-global-lock-on-increment contract; a lost race just
# resolves the same get-or-create metric twice)
_SPAN_HISTS: Dict[str, object] = {}


def _span_hist(name: str):
    h = _SPAN_HISTS.get(name)
    if h is None:
        h = _SPAN_HISTS[name] = _metrics.histogram("span." + name + "_s")
    return h


class _Span:
    """One enabled span: perf_counter timestamps, the worker thread id it
    ran on, and a Chrome complete ("X") event on exit."""

    __slots__ = ("name", "attrs", "_t0", "_tid")

    def __init__(self, name: str, attrs: Optional[Dict] = None):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._tid = threading.get_ident()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if not TRACE_ENABLED:  # disabled mid-span: nothing to record into
            return False
        dur = t1 - self._t0
        _span_hist(self.name).observe(dur)
        cb = _ON_SPAN
        if cb is not None:
            # per-op stage breakdown (obs/scope.py): metrics are never
            # sampled, so the op's stage seconds accumulate even for spans
            # the sampler diverts or discards
            cb(self.name, dur)
        track = _TRACK.get()
        ev = {"name": self.name, "ph": "X",
              "pid": track[0] if track is not None else _PID,
              "tid": self._tid,
              "ts": round((self._t0 - _EPOCH) * 1e6, 3),
              "dur": round(dur * 1e6, 3),
              "cat": self.name.split(".", 1)[0]}
        if self.attrs:
            ev["args"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        sink = _SINK.get()
        if sink is not None:
            # unsampled op: park in the per-op ring — no global lock, no
            # metadata bookkeeping; promote_ring pays those only on keep
            sink.append(ev, threading.current_thread().name)
            return False
        _append_global(ev, track, threading.current_thread().name)
        return False


_PID = os.getpid()


def _append_global(ev: dict, track, thread_name: str) -> None:
    with _LOCK:
        if len(_EVENTS) >= MAX_EVENTS:
            _metrics.counter("trace.events_dropped").inc()
            return
        _ensure_meta_locked(ev["pid"], ev["tid"], track, thread_name)
        _EVENTS.append(ev)
        _ACC_TRACE.set(len(_EVENTS) * _EVENT_EST_BYTES)


def _ensure_meta_locked(pid: int, tid: int, track, thread_name: str) -> None:
    """Emit the one-time Perfetto metadata naming this event's tracks:
    ``process_name`` labels an op's per-request track group (pid = op id),
    ``thread_name`` labels the worker thread inside it."""
    if track is not None and pid not in _SEEN_PIDS:
        _SEEN_PIDS[pid] = track[1]
        _EVENTS.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": track[1]}})
    key = (pid, tid)
    if key not in _SEEN_TIDS:
        # Perfetto names thread tracks from "M" metadata events —
        # emitted once per (track, thread) so pool workers are labeled
        _SEEN_TIDS.add(key)
        _EVENTS.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": thread_name}})


class OpRing:
    """Per-op span buffer for ops head sampling decided not to trace:
    bounded (oldest events drop first — a slow op's recent stages matter
    most), lock-cheap, discarded whole when the op finishes fast, and
    promoted into the global buffer by :func:`promote_ring` when tail
    capture keeps the op."""

    __slots__ = ("events", "dropped", "cap", "_lock")

    def __init__(self, cap: int = OP_RING_EVENTS):
        self.cap = cap
        self.events: deque = deque()
        self.dropped = 0
        self._lock = make_lock("trace.op_ring")

    def append(self, ev: dict, thread_name: str) -> None:
        with self._lock:
            if len(self.events) >= self.cap:
                self.events.popleft()
                self.dropped += 1
            self.events.append((ev, thread_name))


def promote_ring(ring: OpRing, track) -> None:
    """Move a kept op's ring events into the global trace buffer (with the
    metadata naming its track), accounting ring overflow and buffer-cap
    drops in ``trace.events_dropped``."""
    with ring._lock:
        items = list(ring.events)
        dropped = ring.dropped
        ring.events.clear()
        ring.dropped = 0
    with _LOCK:
        for i, (ev, tname) in enumerate(items):
            if len(_EVENTS) >= MAX_EVENTS:
                dropped += len(items) - i
                break
            _ensure_meta_locked(ev["pid"], ev["tid"], track, tname)
            _EVENTS.append(ev)
        _ACC_TRACE.set(len(_EVENTS) * _EVENT_EST_BYTES)
    if dropped:
        _metrics.counter("trace.events_dropped").inc(dropped)


def emit_op_event(name: str, track, t0: float, dur_s: float,
                  attrs: Optional[Dict] = None) -> None:
    """Record one whole-operation "X" span (obs/scope.py emits this at op
    finish, covering the op's first activation to its last)."""
    if not TRACE_ENABLED:
        return
    ev = {"name": name, "ph": "X",
          "pid": track[0] if track is not None else _PID,
          "tid": threading.get_ident(),
          "ts": round((t0 - _EPOCH) * 1e6, 3),
          "dur": round(dur_s * 1e6, 3),
          "cat": name.split(".", 1)[0]}
    if attrs:
        ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
    _append_global(ev, track, threading.current_thread().name)


def enabled() -> bool:
    return TRACE_ENABLED


def trace_span(name: str, **attrs):
    """Context manager for one traced stage: ``with trace_span("decode",
    col="x"): ...``.  With tracing disabled this returns the shared no-op
    singleton — the hottest call sites additionally guard with
    ``if trace.TRACE_ENABLED:`` to skip even the call."""
    if not TRACE_ENABLED:
        return NULL_SPAN
    return _Span(name, attrs or None)


span = trace_span  # the short form instrumentation sites import


def enable_tracing(path: Optional[str] = None) -> None:
    """Turn span collection on.  ``path`` (optional) is where
    :func:`flush_trace` and the interpreter-exit hook write the Chrome
    trace JSON; without one, events stay in memory for
    :func:`trace_events`/an explicit ``flush_trace(path)``."""
    global TRACE_ENABLED, _TRACE_PATH, _ATEXIT_REGISTERED
    with _LOCK:
        _TRACE_PATH = os.fspath(path) if path is not None else _TRACE_PATH
        TRACE_ENABLED = True
        if _TRACE_PATH is not None and not _ATEXIT_REGISTERED:
            _ATEXIT_REGISTERED = True
            atexit.register(_flush_at_exit)


def disable_tracing() -> None:
    global TRACE_ENABLED
    TRACE_ENABLED = False


def reset_trace() -> None:
    """Drop buffered events (tests; does not change the enabled state)."""
    with _LOCK:
        _EVENTS.clear()
        _SEEN_TIDS.clear()
        _SEEN_PIDS.clear()
        _ACC_TRACE.set(0)  # same critical section: no stale-gauge window


def trace_events() -> List[dict]:
    """Copy of the buffered events (tests and programmatic consumers)."""
    with _LOCK:
        return list(_EVENTS)


def flush_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the buffered spans as Chrome trace-event JSON (the object
    form: ``{"traceEvents": [...]}``) — loadable by Perfetto
    (ui.perfetto.dev) and chrome://tracing.  Returns the path written, or
    None when there is no path to write to.  The buffer is kept (a later
    flush rewrites the file with the fuller trace).

    Atomic, same pattern as ``AtomicFileSink``: the JSON lands in a
    unique temp file, is fsynced, then ``os.replace``d over the
    destination — a crash mid-flush leaves the previous trace intact
    (never a truncated file Perfetto rejects), and a failed flush removes
    its temp."""
    p = os.fspath(path) if path is not None else _TRACE_PATH
    if p is None:
        return None
    with _LOCK:
        events = list(_EVENTS)
    body = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = f"{p}.{os.getpid()}.tmp"  # unique per process: concurrent
    # flushers to one path race at the replace, not inside the write
    try:
        with open(tmp, "w") as f:
            json.dump(body, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def _flush_at_exit() -> None:
    try:
        # not gated on TRACE_ENABLED: disabling tracing after a traced
        # workload must not discard the buffer the env var promised to
        # a file
        if _TRACE_PATH is not None and _EVENTS:
            flush_trace()
    except OSError:
        pass  # exit-time flush is best-effort


_env_path = env_str("PARQUET_TPU_TORCH_TRACE")
if _env_path:
    enable_tracing(_env_path)
