"""Readahead for the read path: overlap the source's latency with decode.

The port's copy of ``parquet_tpu/io/prefetch.py``.  :class:`PrefetchSource`
wraps a :class:`~parquet_tpu_torch.io.source.Source` for the length of one
operation, with one of two backends:

- **ring** (any source): planned ranges are carved into windows, read
  ``depth`` windows ahead on the shared pool (``utils/pool.py::submit``)
  into segment buffers a few windows long, and ``pread``/``pread_view``
  are served from the completed windows (a zero-copy view where the read
  lies in one segment).  The window reads go through the wrapped chain,
  so a :class:`~parquet_tpu_torch.io.faults.PolicySource` below retries
  transient errors and keeps the operation's deadline inside the worker;
  an error that survives is raised on the consuming thread at the
  ``pread`` that needed the bytes, inside the caller's ``read_context``,
  and a wait on an unfinished window honours the deadline it finds by
  walking down the chain.  :meth:`PrefetchSource.close` discards the
  windows nobody consumed.
- **advise** (a chain that ends at an
  :class:`~parquet_tpu_torch.io.source.MmapSource`): reads are views of
  the page cache, so nothing is staged; planned ranges are hinted to the
  kernel with ``madvise(WILLNEED)`` ``depth`` windows ahead of each plan's
  frontier.  With ``PARQUET_TPU_TORCH_MMAP_DROPBEHIND=1`` it also
  advises sequential access, releases each plan's consumed span behind
  the read frontier (``MmapSource.madvise_dontneed``) and the rest of the
  planned span at :meth:`PrefetchSource.close`, counted in
  ``ReadStats.bytes_dropbehind``.

Knobs (``utils/env.py``): ``PARQUET_TPU_TORCH_PREFETCH`` (``auto``, the
default: advise over a mapped file; ``advise``; ``ring``; ``off``),
``PARQUET_TPU_TORCH_PREFETCH_WINDOW`` and ``_DEPTH`` (pins), and
``PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE`` (``0``: no feedback from one ring's
stalls to the next ring's depth and window).  A chain's latency class is
its innermost source's ``latency_class`` (``io/remote.py``'s sources say
``remote``, or ``remote_far`` past 30 ms a pread; a local chain has none):
it picks the starting depth and window (:data:`_CLASS_DEFAULTS`) and keys
the auto-tuner's state, and a remote chain rings even on one core (a
network pread waits in the socket, off the interpreter lock).  The
ring's windows and segment buffers are the ledger's ``prefetch.ring`` and
``prefetch.segments`` accounts; each wait on a window lands in the
``prefetch.wait_s`` histogram and the op's report (with tracing on, the
``prefetch.window`` and ``prefetch.wait`` spans), and a prefetcher's
:class:`ReadStats` reach the registry once, when it closes.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import DeadlineError
from ..obs import scope as _oscope
from ..obs import trace as _trace
from ..obs.ledger import ledger_account, maybe_check_pressure
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..utils.env import env_int, env_opt_bytes, env_str
from .source import MmapSource, Source, dropbehind_enabled

# the ledger's accounts: window bytes in the ring (issued and not yet
# consumed or dropped), and the segment buffers the windows fill
_ACC_RING = ledger_account("prefetch.ring")
_ACC_SEG = ledger_account("prefetch.segments")
# every wait on an unfinished window, as it ends (obs.metrics.
# pool_wait_seconds sums it for the routed scan)
_WAIT_HIST = _histogram("prefetch.wait_s")

__all__ = ["ReadStats", "PrefetchSource", "prefetch_mode", "make_prefetcher",
           "make_chunk_prefetcher", "autotune_enabled", "prefetch_autotune"]

DEFAULT_WINDOW_BYTES = 8 << 20
DEFAULT_DEPTH = 4
# ring windows fill slices of a per-plan segment buffer this many windows
# long, so a read across a window join inside it is a zero-copy view
_SEG_WINDOWS = 4


def prefetch_mode() -> str:
    """``PARQUET_TPU_TORCH_PREFETCH`` as off | auto | ring | advise."""
    v = env_str("PARQUET_TPU_TORCH_PREFETCH").lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("ring", "pool"):
        return "ring"
    if v in ("mmap", "advise"):
        return "advise"
    return "auto"


def autotune_enabled() -> bool:
    """``PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE`` (on unless ``0``)."""
    return env_int("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE") != 0


# the tuner reacts to the consumer's wait a window: a ring whose average
# wait per issued window passes the raise threshold deepens readahead, one
# under the decay threshold steps back toward the defaults
_TUNE_RAISE_S_PER_WINDOW = 5e-3
_TUNE_DECAY_S_PER_WINDOW = 5e-4
_MAX_DEPTH = 8
_MAX_WINDOW_BYTES = 32 << 20

# each latency class's starting (depth, window): at network round trips
# the local default leaves the pipe idle, so remote chains start deeper
_CLASS_DEFAULTS = {
    "local": (DEFAULT_DEPTH, DEFAULT_WINDOW_BYTES),
    "remote": (4, 4 << 20),
    "remote_far": (6, 8 << 20),
}


class _AutoTuneState:
    """Process-wide feedback from each ring's :class:`ReadStats` to the
    next ring's depth and window, kept per latency class (a remote
    drain's stalls never deepen local readahead): a ring that waited more
    than :data:`_TUNE_RAISE_S_PER_WINDOW` a window deepens readahead
    (depth first, then the window doubles); one under
    :data:`_TUNE_DECAY_S_PER_WINDOW` steps back toward its class's
    defaults.  Explicit arguments, the knobs' pins and
    ``PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE=0`` bypass it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}  # class -> [depth override, window override]

    def _cls(self, cls: str) -> list:
        return self._state.setdefault(cls, [None, None])

    def suggest(self, cls: str = "local"):
        with self._lock:
            return tuple(self._cls(cls))

    def observe(self, stats: "ReadStats", cls: str = "local") -> None:
        if stats.windows_issued <= 0:
            return
        wait_per_window = stats.pool_wait_s / stats.windows_issued
        base_d, base_w = _CLASS_DEFAULTS.get(cls, _CLASS_DEFAULTS["local"])
        with self._lock:
            st = self._cls(cls)
            d = st[0] or base_d
            w = st[1] or base_w
            if wait_per_window > _TUNE_RAISE_S_PER_WINDOW:
                if d < _MAX_DEPTH:
                    st[0] = d + 1
                elif w < _MAX_WINDOW_BYTES:
                    st[1] = w * 2
            elif wait_per_window < _TUNE_DECAY_S_PER_WINDOW:
                if w > base_w:
                    w //= 2
                    st[1] = None if w <= base_w else w
                elif d > base_d:
                    d -= 1
                    st[0] = None if d <= base_d else d

    def reset(self) -> None:
        with self._lock:
            self._state = {}


_AUTOTUNE = _AutoTuneState()


def prefetch_autotune() -> _AutoTuneState:
    """The process-wide auto-tune state (tests reset it between cases)."""
    return _AUTOTUNE


@dataclass
class ReadStats:
    """What a prefetcher did.

    ``prefetch_hits``/``prefetch_misses``: preads served from the
    readahead (ring windows; advise: a planned range already hinted) or
    around it; ``windows_issued`` and ``bytes_prefetched``: windows read
    ahead (ring) or hinted (advise); ``bytes_discarded``: window bytes
    dropped unconsumed; ``pool_wait_s``: time the consumer waited on a
    window still being read (about 0 when readahead hid the source);
    ``bytes_dropbehind``: page-cache bytes the drop-behind mode
    released."""

    backend: str = ""
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    windows_issued: int = 0
    bytes_prefetched: int = 0
    bytes_discarded: int = 0
    pool_wait_s: float = 0.0
    bytes_dropbehind: int = 0

    def publish(self) -> None:
        """Add this prefetcher's totals to the registry and the current
        op, once (:meth:`PrefetchSource.close` calls it; a second call
        adds nothing)."""
        if getattr(self, "_published", False):
            return
        self._published = True
        _oscope.account(_counter("prefetch.hits"), self.prefetch_hits)
        _oscope.account(_counter("prefetch.misses"), self.prefetch_misses)
        _oscope.account(_counter("prefetch.windows_issued"),
                        self.windows_issued)
        _oscope.account(_counter("prefetch.bytes_prefetched"),
                        self.bytes_prefetched)
        _oscope.account(_counter("prefetch.bytes_discarded"),
                        self.bytes_discarded)
        _oscope.account(_counter("prefetch.bytes_dropbehind"),
                        self.bytes_dropbehind)
        _oscope.account(_counter("prefetch.pool_wait_s"), self.pool_wait_s)

    def as_dict(self) -> dict:
        return {"backend": self.backend,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "windows_issued": self.windows_issued,
                "bytes_prefetched": self.bytes_prefetched,
                "bytes_discarded": self.bytes_discarded,
                "pool_wait_s": self.pool_wait_s,
                "bytes_dropbehind": self.bytes_dropbehind}


class _Window:
    """One window read, in flight or done, filling ``seg[offset -
    seg_start:end - seg_start]`` of its plan's segment buffer."""

    __slots__ = ("offset", "end", "future", "plan", "seg", "seg_start")

    def __init__(self, offset: int, end: int, future, plan,
                 seg=None, seg_start: int = 0):
        self.offset = offset
        self.end = end
        self.future = future
        self.plan = plan
        self.seg = seg
        self.seg_start = seg_start


def _as_u8(buf) -> np.ndarray:
    """A window's bytes (an array, a view, or the bytes an injector
    returns) as a uint8 array, zero-copy where it can."""
    if isinstance(buf, np.ndarray):
        return buf
    return np.frombuffer(buf, np.uint8)


class _Plan:
    """One planned sequential range [start, end); bytes below ``issue``
    are issued (ring) or hinted (advise), and below ``dropped`` released
    (advise under drop-behind)."""

    __slots__ = ("start", "issue", "end", "dropped", "seg_buf", "seg_start",
                 "seg_end", "pending", "dead")

    def __init__(self, start: int, end: int):
        self.start = start
        self.issue = start
        self.end = end
        self.dropped = start
        self.seg_buf = None
        self.seg_start = 0
        self.seg_end = 0
        self.pending = 0      # windows claimed but not yet in the ring
        self.dead = False     # unplanned while a claim was in flight


def _innermost(src: Source) -> Source:
    seen = set()
    while hasattr(src, "inner") and id(src) not in seen:
        seen.add(id(src))
        src = src.inner
    return src


class PrefetchSource(Source):
    """Readahead over any :class:`Source` (the module docstring has the
    two backends).  Callers declare upcoming ranges with :meth:`plan` /
    :meth:`plan_many`; reads outside the issued windows read through and
    count as misses.  One is made for one operation and does not own the
    source it wraps: :meth:`close` cancels the outstanding windows and
    drops their buffers, leaving the file open."""

    def __init__(self, inner: Source, backend: str = "ring",
                 window_bytes: Optional[int] = None,
                 depth: Optional[int] = None,
                 max_windows: int = 32):
        if backend not in ("ring", "advise"):
            raise ValueError(f"unknown prefetch backend {backend!r}")
        self.inner = inner
        self.backend = backend
        env_window = env_opt_bytes("PARQUET_TPU_TORCH_PREFETCH_WINDOW")
        env_depth = env_opt_bytes("PARQUET_TPU_TORCH_PREFETCH_DEPTH")
        self.latency_class = getattr(_innermost(inner), "latency_class",
                                     "local")
        base_depth, base_window = _CLASS_DEFAULTS.get(
            self.latency_class, _CLASS_DEFAULTS["local"])
        tuned_depth, tuned_window = ((None, None) if not autotune_enabled()
                                     else _AUTOTUNE.suggest(
                                         self.latency_class))
        self._tunable = (autotune_enabled() and window_bytes is None
                         and depth is None and env_window is None
                         and env_depth is None)
        self.window_bytes = int(window_bytes or env_window or tuned_window
                                or base_window)
        if self.window_bytes <= 0:
            raise ValueError("window_bytes must be positive")
        self.depth = int(depth or env_depth or tuned_depth or base_depth)
        self.max_windows = max(2, int(max_windows))
        self.stats = ReadStats(backend=backend)
        self._lock = threading.Lock()
        self._plans: List[_Plan] = []
        self._ring: List[_Window] = []  # issue order (oldest first)
        self._segs: dict = {}  # id(segment buffer) -> bytes (the ledger)
        self._pending = 0   # windows claimed but not yet in the ring
        self._pump_rr = 0   # round-robin cursor over the plans
        self._mmap = _innermost(inner) if backend == "advise" else None
        if backend == "advise" and not isinstance(self._mmap, MmapSource):
            raise ValueError("advise backend needs an MmapSource-backed chain")
        self._dropbehind = backend == "advise" and dropbehind_enabled()
        self._advised_sequential = False
        self._closed = False

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    # ------------------------------------------------------------- planning
    def plan(self, offset: int, size: int) -> None:
        """Declare an upcoming read of ``[offset, offset + size)``; up to
        ``depth`` windows of each plan are kept ahead of its reads."""
        self.plan_many([(offset, size)])

    def plan_many(self, ranges) -> None:
        """:meth:`plan` each ``(offset, size)`` of ``ranges``, with one
        pump for the batch."""
        batch = [(off, size) for off, size in ranges if size > 0]
        if not batch or self._closed:
            return
        with self._lock:
            for off, size in batch:
                self._plans.append(_Plan(off, off + size))
        # readahead grows the ledger: let it respond before the windows go
        maybe_check_pressure()
        self._pump()

    def unplan(self, offset: int, size: int) -> None:
        """Cancel the plan of ``(offset, size)`` and drop its windows (a
        skipped row group's chunks: their plans would hold ring slots until
        consumed, which never comes)."""
        end = offset + size
        with self._lock:
            dead = [p for p in self._plans
                    if p.start == offset and p.end == end]
            for p in dead:
                p.dead = True
                self._plans.remove(p)
            dropped = [w for w in self._ring if w.plan in dead]
            for w in dropped:
                w.future.cancel()
                self._drop_locked(w)
                self.stats.bytes_discarded += w.end - w.offset
            self._release_segments_locked()
        if dropped:
            self._pump()

    def _claim_one_locked(self):
        """The next window to issue, round-robin over the plans, within
        the ring's capacity and ``depth`` windows a plan (claims in flight
        counted): ``(plan, offset, end, seg, seg_start)`` or None."""
        if self._closed:
            return None
        if len(self._ring) + self._pending >= self.max_windows:
            return None
        plans = list(self._plans)
        if not plans:
            return None
        n = len(plans)
        start = self._pump_rr % n
        for k in range(n):
            plan = plans[(start + k) % n]
            if plan.issue >= plan.end:
                if plan.pending == 0 and plan in self._plans:
                    self._plans.remove(plan)
                continue
            if (sum(1 for w in self._ring if w.plan is plan)
                    + plan.pending >= self.depth):
                continue
            self._pump_rr = (start + k) % n + 1
            end = min(plan.issue + self.window_bytes, plan.end)
            if plan.seg_buf is None or plan.issue >= plan.seg_end:
                seg_len = min(_SEG_WINDOWS * self.window_bytes,
                              plan.end - plan.issue)
                plan.seg_buf = np.empty(seg_len, np.uint8)
                plan.seg_start = plan.issue
                plan.seg_end = plan.issue + seg_len
                self._segs[id(plan.seg_buf)] = seg_len
                _ACC_SEG.add(seg_len)
            end = min(end, plan.seg_end)
            offset = plan.issue
            self.stats.windows_issued += 1
            self.stats.bytes_prefetched += end - offset
            plan.issue = end
            plan.pending += 1
            self._pending += 1
            return plan, offset, end, plan.seg_buf, plan.seg_start
        return None

    def _pump(self) -> None:
        """Keep windows issued ahead (the caller holds no lock: the pool
        submit runs between the claim's and the ring's critical
        sections)."""
        if self.backend == "advise":
            with self._lock:
                self._advise_locked()
            return
        from ..utils.pool import submit

        while True:
            with self._lock:
                spec = self._claim_one_locked()
            if spec is None:
                return
            plan, offset, end, seg, seg_start = spec
            try:
                fut = submit(self._fill_window, seg, offset - seg_start,
                             offset, end - offset)
            except BaseException:
                # the pool is shutting down: the range reads through
                with self._lock:
                    self._pending -= 1
                    plan.pending -= 1
                    self.stats.bytes_discarded += end - offset
                raise
            # retrieve abandoned errors (a window failed after close)
            fut.add_done_callback(
                lambda f: None if f.cancelled() else f.exception())
            win = _Window(offset, end, fut, plan, seg=seg,
                          seg_start=seg_start)
            with self._lock:
                self._pending -= 1
                plan.pending -= 1
                if self._closed or plan.dead:
                    fut.cancel()
                    self.stats.bytes_discarded += end - offset
                    self._release_segments_locked()
                else:
                    self._ring.append(win)
                    _ACC_RING.add(end - offset)

    def _drop_locked(self, w: _Window) -> None:
        """Take a window out of the ring (under the lock) and its bytes
        out of the ledger."""
        if w in self._ring:
            self._ring.remove(w)
            _ACC_RING.sub(w.end - w.offset)

    def _release_segments_locked(self) -> None:
        """Release the ledger's bytes of the segment buffers that neither
        a plan nor a window in the ring holds any more."""
        live = {id(w.seg) for w in self._ring}
        live.update(id(p.seg_buf) for p in self._plans
                    if p.seg_buf is not None
                    and (p.issue < p.end or p.pending))
        for sid in [s for s in self._segs if s not in live]:
            _ACC_SEG.sub(self._segs.pop(sid))

    def _fill_window(self, seg: np.ndarray, rel: int, offset: int,
                     size: int) -> np.ndarray:
        """A window's read into its segment slice, on a pool worker.  A
        short read gives a short slice, which :meth:`_serve` sees, so
        unfilled segment bytes are never served."""
        if _trace.TRACE_ENABLED:
            # on the pool's workers: the span's thread shows the overlap
            with _trace.span("prefetch.window", offset=offset, bytes=size):
                return self._fill_window_impl(seg, rel, offset, size)
        return self._fill_window_impl(seg, rel, offset, size)

    def _fill_window_impl(self, seg: np.ndarray, rel: int, offset: int,
                          size: int) -> np.ndarray:
        src = self.inner
        data = getattr(src, "pread_view", src.pread)(offset, size)
        a = _as_u8(data)
        n = min(len(a), size)
        seg[rel:rel + n] = a[:n]
        return seg[rel:rel + n]

    def _advise_locked(self) -> None:
        """Hint the kernel ``depth`` windows ahead of each plan's
        frontier (and, under drop-behind, sequential access once)."""
        if self._dropbehind and not self._advised_sequential:
            self._advised_sequential = True
            self._mmap.madvise_sequential()
        for plan in self._plans:
            ahead = min(plan.issue + self.depth * self.window_bytes,
                        plan.end)
            if ahead > plan.issue:
                self._mmap.madvise_willneed(plan.issue, ahead - plan.issue)
                self.stats.windows_issued += 1
                self.stats.bytes_prefetched += ahead - plan.issue
                plan.issue = ahead

    def _advance_advise(self, upto: int, drop_upto: int) -> None:
        """The consumer reached ``upto``: keep the hinted horizon ``depth``
        windows ahead of it in the plan that covers it.  Under drop-behind
        the plan's span below ``drop_upto`` is released: the start of the
        read that moved the frontier, whose view the caller has not
        decoded yet."""
        with self._lock:
            for plan in self._plans:
                if plan.start <= upto <= plan.end:
                    ahead = min(upto + (self.depth + 1) * self.window_bytes,
                                plan.end)
                    if ahead > plan.issue:
                        self._mmap.madvise_willneed(plan.issue,
                                                    ahead - plan.issue)
                        self.stats.windows_issued += 1
                        self.stats.bytes_prefetched += ahead - plan.issue
                        plan.issue = ahead
                    if self._dropbehind and drop_upto > plan.dropped:
                        self.stats.bytes_dropbehind += \
                            self._mmap.madvise_dontneed(
                                plan.dropped, drop_upto - plan.dropped)
                        plan.dropped = drop_upto
                    break

    # ------------------------------------------------------------- serving
    def _deadline(self):
        """The active operation deadline of a PolicySource below, if any."""
        src = self.inner
        seen = set()
        while src is not None and id(src) not in seen:
            seen.add(id(src))
            dl = getattr(src, "_deadline", None)
            if dl is not None:
                return dl
            src = getattr(src, "inner", None)
        return None

    def _await(self, win: _Window):
        """A window's bytes, waited for in laps of at most 50 ms, each
        checking the deadline: a window queued behind injected latency
        cannot hold the consumer past ``deadline_s``."""
        fut = win.future
        if fut.done():
            return fut.result()
        t0 = time.perf_counter()
        wait_span = (_trace.span("prefetch.wait", offset=win.offset)
                     if _trace.TRACE_ENABLED else _trace.NULL_SPAN)
        wait_span.__enter__()
        try:
            while True:
                dl = self._deadline()
                rem = dl.remaining() if dl is not None else None
                if rem is not None and rem <= 0:
                    raise DeadlineError(
                        f"deadline exceeded waiting for prefetched window "
                        f"at {win.offset}")
                try:
                    return fut.result(timeout=min(rem, 0.05)
                                      if rem is not None else 0.05)
                except (_FutTimeout, TimeoutError):
                    continue
        finally:
            wait_span.__exit__(None, None, None)
            waited = time.perf_counter() - t0
            _WAIT_HIST.observe(waited)
            # the op's share of the wait, as it ends
            _oscope.add_to_current("prefetch.wait_s", waited)
            with self._lock:
                self.stats.pool_wait_s += waited

    def _serve(self, offset: int, size: int, want_view: bool):
        end = offset + size
        if self.backend == "advise":
            with self._lock:
                covered = any(p.start <= offset and end <= p.end
                              and p.issue >= end for p in self._plans)
                self.stats.prefetch_hits += covered
                self.stats.prefetch_misses += not covered
            inner = self.inner
            out = (getattr(inner, "pread_view", inner.pread)(offset, size)
                   if want_view else inner.pread(offset, size))
            self._advance_advise(end, offset)
            return out
        # ring: the chain of windows that covers the read
        with self._lock:
            chain = sorted((w for w in self._ring
                            if w.offset < end and w.end > offset),
                           key=lambda w: w.offset)
            covered = bool(chain) and chain[0].offset <= offset \
                and chain[-1].end >= end
            pos = offset
            for w in chain:
                if covered and w.offset > pos:
                    covered = False
                pos = w.end
        from ..utils.pool import in_shared_pool

        if covered and in_shared_pool():
            # a window still queued may wait behind this worker's own
            # caller on the shared pool: cancel the ones never started and
            # read their bytes through (a worker waiting on them could
            # wedge the pool)
            cancelled = [w for w in chain if w.future.cancel()]
            if cancelled:
                with self._lock:
                    for w in cancelled:
                        self._drop_locked(w)
                        self.stats.bytes_discarded += w.end - w.offset
                    self._release_segments_locked()
                covered = False
        if not covered:
            with self._lock:
                self.stats.prefetch_misses += 1
            inner = self.inner
            return (getattr(inner, "pread_view", inner.pread)(offset, size)
                    if want_view else inner.pread(offset, size))
        bufs = []
        for w in chain:
            try:
                bufs.append(self._await(w))
            except BaseException:
                # a failed window is never served again; its error raises
                # here, on the consuming thread
                with self._lock:
                    self._drop_locked(w)
                    self._release_segments_locked()
                self._pump()
                raise
        with self._lock:
            self.stats.prefetch_hits += 1
        full = all(len(b) == (w.end - w.offset) for w, b in zip(chain, bufs))
        if len(chain) == 1:
            w = chain[0]
            out = bufs[0][offset - w.offset:end - w.offset]
        elif full and all(w.seg is chain[0].seg for w in chain):
            # the chain lies in one segment: the join is contiguous
            out = chain[0].seg[offset - chain[0].seg_start:
                               end - chain[0].seg_start]
        else:
            out = np.concatenate(
                [_as_u8(b)[max(offset - w.offset, 0):
                           min(end, w.end) - w.offset]
                 for w, b in zip(chain, bufs)])
        # windows the sequential reader has passed are consumed
        with self._lock:
            drop = [w for w in chain if w.end <= end]
            for w in drop:
                self._drop_locked(w)
            self._release_segments_locked()
        if drop:
            self._pump()
        if want_view:
            return out
        return out.tobytes()

    def pread(self, offset: int, size: int) -> bytes:
        return self._serve(offset, size, want_view=False)

    def pread_view(self, offset: int, size: int):
        return self._serve(offset, size, want_view=True)

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        with self._lock:
            first_close = not self._closed
            self._closed = True
            if self._dropbehind and first_close:
                # the one-shot drain is over: release the rest of each plan
                for plan in self._plans:
                    self.stats.bytes_dropbehind += \
                        self._mmap.madvise_dontneed(
                            plan.dropped, plan.end - plan.dropped)
            self._plans.clear()
            for w in self._ring:
                if not w.future.cancel() and w.future.done():
                    try:
                        w.future.result()
                    except BaseException:
                        pass  # an abandoned window's error: nobody wants it
                self.stats.bytes_discarded += w.end - w.offset
                _ACC_RING.sub(w.end - w.offset)
            self._ring.clear()
            self._release_segments_locked()
        if first_close:
            # one publish a prefetcher: its totals reach the registry and
            # the op that closes it
            self.stats.publish()
        if self.backend == "ring" and self._tunable:
            _AUTOTUNE.observe(self.stats, self.latency_class)


def make_prefetcher(source: Source,
                    n_streams: int = 1) -> Optional[PrefetchSource]:
    """The prefetcher the mode picks for ``source``, or None where it is
    off or cannot pay: advise for a chain that ends at an
    :class:`MmapSource`; the ring where ``PARQUET_TPU_TORCH_PREFETCH=ring``,
    or in auto mode outside a pool worker for a remote chain, and for a
    chain ending at a file read by pread with more than one core (on one
    core a pread from a warm page cache is a copy that competes with
    decode; a network pread waits in the socket).  ``n_streams``
    (the column cursors of a drain) sizes the ring, so that interleaved
    cursors do not evict each other's windows."""
    from ..utils import pool
    from .source import FileLikeSource, FileSource

    mode = prefetch_mode()
    if mode == "off":
        return None
    deepest = _innermost(source)
    if mode in ("auto", "advise") and isinstance(deepest, MmapSource):
        return PrefetchSource(source, backend="advise")
    if mode == "advise":
        return None
    real_io = isinstance(deepest, (FileSource, FileLikeSource))
    remote = getattr(deepest, "latency_class", "local") != "local"
    if mode == "ring" or (not pool.in_shared_pool() and (
            remote or (real_io and pool.available_cpus() > 1))):
        return PrefetchSource(source, backend="ring",
                              max_windows=max(8, 2 * n_streams))
    return None


def make_chunk_prefetcher(source: Source) -> Optional[PrefetchSource]:
    """The prefetcher of the whole-chunk preads of the device read and
    the device scan.  A chunk-sized read asked before its windows are read
    is never covered (only ``depth`` windows are ever ahead), so auto mode
    takes only the advise backend: the chunk ranges planned, the kernel's
    readahead running under the prescan and staging of earlier chunks.
    ``PARQUET_TPU_TORCH_PREFETCH=ring`` forces the ring; ``off`` none."""
    mode = prefetch_mode()
    if mode == "off":
        return None
    if mode == "ring":
        return make_prefetcher(source)
    if isinstance(_innermost(source), MmapSource):
        return PrefetchSource(source, backend="advise")
    return None
