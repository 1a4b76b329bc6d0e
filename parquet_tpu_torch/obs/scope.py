"""Request-scoped telemetry: per-operation identities, sampling, and
slow-op capture.

The port's copy of ``parquet_tpu/obs/scope.py``.  ``metrics_delta()``
meters the whole interpreter: two concurrent ``Dataset.scan`` calls smear
into one number.  This module gives every operation its own identity:

- :func:`op_scope(name, **attrs)` — a ``contextvars``-based scope.  Code
  running inside it (including work fanned out on pool workers:
  ``utils/pool.submit`` and the read's own worker pools run each task in a
  copy of the submitter's context) attributes its resources to the
  scope's :meth:`OpScope.report`: bytes read, pool-wait seconds, cache
  hits and misses, retries, rows pruned and decoded, routes chosen.  The
  attribution is exact by construction: :func:`account` increments the
  registry counter and the current scope's mirror in one call, so per-op
  sums equal the global delta for any window whose work all ran under
  scopes.
- The public surfaces (``ParquetFile.read``/``iter_batches``, the scans,
  ``Dataset.read``/``iter_batches``/``scan``/``prune``, the lookups and
  aggregates, the writer's lifetime, ``verify_file``, a table's commit
  and compaction) open a scope themselves when none is active
  (:func:`maybe_op_scope`); a caller's ``with op_scope(...):`` takes
  precedence and the inner surfaces join it.
- **Sampling** — with tracing on, ``PARQUET_TPU_TORCH_TRACE_SAMPLE=N``
  head-samples one op in each block of N at scope entry.  Sampled ops
  trace onto their own Perfetto track (pid = op id, ``process_name``
  metadata).  Unsampled ops divert spans into a per-op ring
  (``trace.OpRing``) that is dropped at finish, unless the op ran slower
  than ``PARQUET_TPU_TORCH_SLOW_OP_S`` (tail capture): then the ring is
  promoted into the global trace and the op is kept.  The decisions are
  metered: ``trace.ops_sampled`` / ``trace.ops_skipped`` /
  ``trace.ops_slow_kept``.
- **Slow-op records** — an op over the threshold appends one JSON line to
  ``PARQUET_TPU_TORCH_SLOW_LOG``: name, duration, attrs, the per-stage
  breakdown (from span exits) and its counters.  This works with tracing
  off too (the stage breakdown is then empty).

The env knobs are read per operation, so tests and long-lived servers
can flip them live; ops are coarse-grained enough that the reads are
free.
"""

from __future__ import annotations

import contextvars
import threading
import itertools
import json
import random
import time
from typing import Dict, Iterator, Optional

from ..utils.env import env_int, env_opt_float, env_str
from . import metrics as _metrics
from . import trace as _trace
from .metrics import _render_key

__all__ = ["OpScope", "op_scope", "maybe_op_scope", "current_op",
           "scoped_iter", "account", "add_to_current", "account_bytes",
           "sample_n", "slow_op_threshold_s", "slow_log_path", "live_ops"]

_CURRENT: "contextvars.ContextVar[Optional[OpScope]]" = \
    contextvars.ContextVar("parquet_tpu_torch_op_scope", default=None)
_IDS = itertools.count(1)
# op "pids" live far above real pid space so an op track never merges
# with the process track in Perfetto
_OP_PID_BASE = 1_000_000

# families declared (with help text) in metrics._CORE_COUNTERS; these
# are resolved handles
_OPS_SAMPLED = _metrics.counter("trace.ops_sampled")
_OPS_SKIPPED = _metrics.counter("trace.ops_skipped")
_OPS_SLOW = _metrics.counter("trace.ops_slow_kept")
_BYTES_READ = _metrics.counter("read.bytes_read")

_SLOW_LOG_LOCK = threading.Lock()

# currently-open operations, op_id → scope: the /debugz op table.  Every
# scope registers at construction and leaves at finish(); an entry that
# lingers IS the signal (a stuck or leaked op is exactly what a live
# introspection endpoint exists to show).
_LIVE_LOCK = threading.Lock()
_LIVE_OPS: "Dict[int, OpScope]" = {}


def live_ops() -> list:
    """The currently-open ops, oldest first: op id, name, attrs, age in
    seconds since first activation (0 for a scope built but never
    entered), and the sampling decision.  Powers ``/debugz``."""
    with _LIVE_LOCK:
        scopes = list(_LIVE_OPS.values())
    now = time.perf_counter()
    out = []
    for s in scopes:
        with s._lock:
            t_first = s._t_first
        out.append({"op": s.op_id, "name": s.name,
                    "attrs": {k: _trace._jsonable(v)
                              for k, v in s.attrs.items()},
                    "age_s": round(now - t_first, 6)
                    if t_first is not None else 0.0,
                    "sampled": s.sampled})
    out.sort(key=lambda r: -r["age_s"])
    return out

# systematic head sampling with a random phase: exactly one sampled op
# per block of N, but WHICH position is drawn fresh each block — a plain
# `op_id % N` stride would lock onto periodic workloads (2 ops per
# request + N=2 means one op class is sampled always, the other never)
_SAMPLE_LOCK = threading.Lock()
_SAMPLE_I = 0
_SAMPLE_N: Optional[int] = None
_SAMPLE_TARGET = 0


def _head_sampled(n: int) -> bool:
    global _SAMPLE_I, _SAMPLE_N, _SAMPLE_TARGET
    with _SAMPLE_LOCK:
        if _SAMPLE_N != n or _SAMPLE_I >= n:  # new block (or N changed)
            _SAMPLE_N = n
            _SAMPLE_I = 0
            _SAMPLE_TARGET = random.randrange(n)
        hit = _SAMPLE_I == _SAMPLE_TARGET
        _SAMPLE_I += 1
        return hit


def sample_n() -> int:
    """``PARQUET_TPU_TORCH_TRACE_SAMPLE`` as an int ≥ 1 (1 = trace every op)."""
    return max(1, env_int("PARQUET_TPU_TORCH_TRACE_SAMPLE"))


def slow_op_threshold_s() -> Optional[float]:
    """``PARQUET_TPU_TORCH_SLOW_OP_S`` as seconds, or None (tail capture off).
    0 keeps every op — the capture-everything debugging mode."""
    return env_opt_float("PARQUET_TPU_TORCH_SLOW_OP_S")


def slow_log_path() -> Optional[str]:
    """``PARQUET_TPU_TORCH_SLOW_LOG``: the JSON-lines slow-op record file."""
    return env_str("PARQUET_TPU_TORCH_SLOW_LOG") or None


def current_op() -> "Optional[OpScope]":
    """The active scope on this thread/context, or None."""
    return _CURRENT.get()


def add_to_current(key: str, n) -> None:
    """Mirror an already-registry-published quantity into the current
    scope (the histogram-observed seconds — pool queue wait, prefetch
    wait — whose registry side is an ``observe``, not a counter inc)."""
    if not n:
        return
    s = _CURRENT.get()
    if s is not None:
        s._add(key, n)


def account(metric, n=1) -> None:
    """Increment a registry counter AND the current scope's mirror of it,
    under the counter's rendered snapshot key — the single call that
    makes per-op sums equal the process-global ``metrics_delta()``."""
    if not n:
        return
    metric.inc(n)
    s = _CURRENT.get()
    if s is not None:
        s._add(_render_key(metric.name, metric.labels), n)


def account_bytes(n: int) -> None:
    """Terminal-source pread accounting (io/source.py): every byte fetched
    from storage lands in ``read.bytes_read`` and the current op."""
    if not n:
        return
    _BYTES_READ.inc(n)
    s = _CURRENT.get()
    if s is not None:
        s._add("read.bytes_read", n)


class _Activation:
    """Re-entrant, non-finishing activation of a scope (generator pulls,
    writer method bodies) — ``with scope.active(): ...``."""

    __slots__ = ("scope",)

    def __init__(self, scope: "OpScope"):
        self.scope = scope

    def __enter__(self) -> "OpScope":
        self.scope._activate()
        return self.scope

    def __exit__(self, *exc) -> bool:
        self.scope._deactivate()
        return False


class OpScope:
    """One operation's identity: a request-scoped accounting sink, trace
    track, sampling decision, and slow-op detector.

    Use as a context manager (``with op_scope("serving.lookup") as op:``,
    finishes on exit) or via :meth:`active` for piecewise activations
    (finish explicitly with :meth:`finish`).  Activations nest on one
    thread; pool workers join through context propagation, never by
    activating.  Counter mirrors are lock-protected — any number of
    workers account concurrently with exact totals."""

    __slots__ = ("name", "attrs", "op_id", "sampled", "duration_s",
                 "_lock", "_counters", "_stages", "_active", "_tokens",
                 "_t0", "_t_first", "_elapsed", "_finished", "_track",
                 "_ring")

    def __init__(self, name: str, attrs: Optional[Dict] = None):
        self.name = name
        self.attrs = dict(attrs or {})
        self.op_id = next(_IDS)
        self.duration_s = None
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._stages: Dict[str, list] = {}
        self._active = 0
        self._tokens: list = []
        self._t0 = None
        self._t_first = None
        self._elapsed = 0.0
        self._finished = False
        self._track = None
        self._ring = None
        self.sampled = None
        if _trace.TRACE_ENABLED:
            # head sampling, decided once at scope entry: the op either
            # traces straight into the global buffer on its own track, or
            # parks spans in a per-op ring for possible tail promotion
            n = sample_n()
            self.sampled = n <= 1 or _head_sampled(n)
            self._track = (_OP_PID_BASE + self.op_id,
                           f"op {self.op_id}: {name}")
            if self.sampled:
                _OPS_SAMPLED.inc()
            else:
                _OPS_SKIPPED.inc()
                self._ring = _trace.OpRing()
        with _LIVE_LOCK:
            _LIVE_OPS[self.op_id] = self

    # ------------------------------------------------------- activation
    def _activate(self) -> None:
        with self._lock:
            if self._active == 0:
                self._t0 = time.perf_counter()
                if self._t_first is None:
                    self._t_first = self._t0
            self._active += 1
        toks = [_CURRENT.set(self)]
        if self._track is not None:
            # set BOTH trace vars (sink may be None): an explicitly
            # nested scope must override an outer op's ring, not inherit
            toks.append(_trace._TRACK.set(self._track))
            toks.append(_trace._SINK.set(self._ring))
        self._tokens.append(toks)

    def _deactivate(self) -> None:
        toks = self._tokens.pop()
        for t in reversed(toks):
            t.var.reset(t)
        with self._lock:
            self._active -= 1
            if self._active == 0 and self._t0 is not None:
                self._elapsed += time.perf_counter() - self._t0
                self._t0 = None

    def active(self) -> _Activation:
        """A non-finishing activation (see class docstring)."""
        return _Activation(self)

    def __enter__(self) -> "OpScope":
        self._activate()
        return self

    def __exit__(self, *exc) -> bool:
        self._deactivate()
        if not self._tokens and self._active == 0:
            self.finish()
        return False

    # ------------------------------------------------------- accounting
    def _add(self, key: str, n) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def _stage(self, name: str, dur: float) -> None:
        with self._lock:
            st = self._stages.get(name)
            if st is None:
                self._stages[name] = [1, dur]
            else:
                st[0] += 1
                st[1] += dur

    # ---------------------------------------------------------- results
    def counters(self) -> Dict[str, float]:
        """Copy of the per-op counter mirrors, keyed exactly like
        ``metrics_snapshot()['counters']`` (labeled counters render as
        ``name{label=value}``)."""
        with self._lock:
            return dict(self._counters)

    def stages(self) -> Dict[str, dict]:
        """Per-stage breakdown from span exits while tracing was on:
        ``{span_name: {"count": n, "seconds": s}}``."""
        with self._lock:
            return {k: {"count": c, "seconds": round(s, 6)}
                    for k, (c, s) in self._stages.items()}

    def metrics_delta(self) -> dict:
        """This operation's counters in the shape of the process-global
        :func:`~parquet_tpu_torch.obs.metrics.metrics_delta` — but attributed
        to this op alone, concurrency-exact (no smearing)."""
        return {"counters": self.counters(), "gauges": {},
                "histograms": {}}

    def report(self) -> dict:
        """The OpReport: headline attribution plus the raw counter
        mirrors and stage breakdown."""
        c = self.counters()
        with self._lock:  # _t0 races _deactivate() on the owning thread
            dur = self.duration_s
            if dur is None and self._t_first is not None:
                dur = self._elapsed + (time.perf_counter() - self._t0
                                       if self._t0 is not None else 0.0)
        routes = {k.split("route=", 1)[1].rstrip("}"): v
                  for k, v in c.items() if k.startswith("route.chosen{")}
        return {
            "name": self.name, "op": self.op_id, "attrs": dict(self.attrs),
            "sampled": self.sampled,
            "duration_s": round(dur, 6) if dur is not None else None,
            "bytes_read": c.get("read.bytes_read", 0),
            "pool_wait_s": round(c.get("pool.queue_wait_s", 0.0)
                                 + c.get("prefetch.wait_s", 0.0), 6),
            "cache_hits": (c.get("cache.footer_hits", 0)
                           + c.get("cache.chunk_hits", 0)
                           + c.get("cache.page_hits", 0)),
            "cache_misses": (c.get("cache.footer_misses", 0)
                             + c.get("cache.chunk_misses", 0)
                             + c.get("cache.page_misses", 0)),
            "retries": c.get("read.retries", 0),
            "rows_pruned": c.get("scan.rows_pruned", 0),
            "rows_decoded": c.get("scan.rows_decoded", 0),
            "routes": routes,
            "counters": c,
            "stages": self.stages(),
        }

    # ----------------------------------------------------------- finish
    def finish(self) -> None:
        """Finalize the op: fix its duration, run the tail-capture
        decision (ring promotion + slow-op record), emit the op-level
        span.  Idempotent; ``with op_scope(...)`` calls it on exit."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            dur = self._elapsed
            if self._t0 is not None:  # finish() inside an activation
                dur += time.perf_counter() - self._t0
            self.duration_s = dur
        thr = slow_op_threshold_s()
        slow = thr is not None and dur >= thr
        if self._track is not None and _trace.TRACE_ENABLED:
            kept = bool(self.sampled)
            if not kept and slow and self._ring is not None:
                _trace.promote_ring(self._ring, self._track)
                kept = True
            if kept:
                _trace.emit_op_event(
                    "op." + self.name, self._track,
                    self._t_first if self._t_first is not None
                    else time.perf_counter(),
                    dur, dict(self.attrs, op=self.op_id))
        if slow:
            _OPS_SLOW.inc()
            self._write_slow_record(dur)
        self._ring = None  # drop the parked spans either way
        with _LIVE_LOCK:
            _LIVE_OPS.pop(self.op_id, None)

    def _write_slow_record(self, dur: float) -> None:
        path = slow_log_path()
        if not path:
            return
        # a wall-clock timestamp, to correlate the record with other logs
        rec = {"ts": round(time.time(), 6), "op": self.op_id,
               "name": self.name,
               "attrs": {k: _trace._jsonable(v)
                         for k, v in self.attrs.items()},
               "duration_s": round(dur, 6),
               "stages": self.stages(),
               "report": {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in self.counters().items()}}
        line = json.dumps(rec, sort_keys=True)
        # appends are serialized in-process; O_APPEND keeps multi-process
        # writers line-atomic for records under PIPE_BUF
        with _SLOW_LOG_LOCK:
            try:
                with open(path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass  # the slow log is best-effort, never a crash

    def __repr__(self) -> str:
        return (f"OpScope({self.name!r}, op={self.op_id}, "
                f"sampled={self.sampled}, finished={self._finished})")


def op_scope(name: str, **attrs) -> OpScope:
    """A new operation scope: ``with op_scope("lookup", user=uid) as op:``
    then ``op.report()`` / ``op.metrics_delta()`` answer for that
    operation alone.  Nesting creates a new identity that takes over
    attribution for its extent (sibling ops stay exact)."""
    return OpScope(name, attrs)


class _Ambient:
    """Pass-through for public surfaces called inside an active scope:
    the operation joins the caller's op instead of opening its own."""

    __slots__ = ()

    def __enter__(self):
        return _CURRENT.get()

    def __exit__(self, *exc):
        return False


_AMBIENT = _Ambient()


def maybe_op_scope(name: str, **attrs):
    """A new finishing scope when none is active, else a no-op that
    yields the ambient one — how the public surfaces thread scopes
    through without stealing attribution from an explicit caller
    ``op_scope``."""
    if _CURRENT.get() is not None:
        return _AMBIENT
    return OpScope(name, attrs)


def scoped_iter(name: str, gen: Iterator, **attrs):
    """Wrap a generator-shaped operation (``iter_batches``) in a scope.

    PEP 567 contexts do not isolate generators — a plain ``with
    op_scope(...)`` inside one would leak the scope to the consumer
    between yields, smearing their other work into this op.  Instead
    each pull activates the scope around ``next()`` only, so the op
    accumulates exactly its own work (consumer time excluded) and
    finishes when the generator is exhausted or closed.  (This is a
    generator itself, so the ambient-scope decision below runs lazily,
    at the first pull.)"""
    scope = OpScope(name, attrs) if _CURRENT.get() is None else None
    try:
        while True:
            if scope is None:
                try:
                    item = next(gen)
                except StopIteration:
                    return
            else:
                with scope.active():
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
            yield item
    finally:
        if scope is not None:
            # close INSIDE the activation: the generator's cleanup (e.g.
            # the drain's prefetcher close publishing its ReadStats) must
            # attribute to this op, not to whatever the consumer's
            # context holds at early termination
            try:
                with scope.active():
                    gen.close()
            finally:
                scope.finish()
        else:
            gen.close()


def _on_span(name: str, dur: float) -> None:
    s = _CURRENT.get()
    if s is not None:
        s._stage(name, dur)


# bind the stage-breakdown hook (trace.py calls it per completed span
# while tracing is on; late binding avoids a circular import)
_trace._ON_SPAN = _on_span
