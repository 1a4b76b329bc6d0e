"""Reads that survive a faulty source: fault policy, deadline clock,
located errors, and a deterministic fault injector.

The port's copy of the read side of ``parquet_tpu/io/faults.py``:

- :class:`FaultPolicy` — retries with jittered exponential backoff, a
  deadline a top-level operation (``deadline_s``), and ``on_corrupt``:
  ``'raise'``, or ``'skip_row_group'``, which drops a corrupt row group,
  goes on reading, and accounts for the loss in a :class:`ReadReport`.
- :func:`read_context` — wraps a read's failures into the
  :class:`~parquet_tpu_torch.errors.ReadError` hierarchy with the file
  path, row group, column and page offset.  Environment and device errors
  (:data:`NON_DATA_ERRORS`: a missing package, out of memory, a CUDA
  error or any other ``RuntimeError``, the device route's refusal of a
  chunk) are never corruption and pass unwrapped.
- :class:`PolicySource` — applies a policy's retries and deadline to every
  pread of the source it wraps.
- :class:`FaultInjectingSource` — a seedable chaos wrapper (transient
  errors, latency, bit flips, truncation, short reads) whose draws are
  keyed on ``(seed, offset, size, attempt)``, as the JAX package's.

The write side: :class:`FaultInjectingSink` (transient errors, short
writes, a full disk and a hard crash at a byte, drawn from one seeded
RNG in write order, as the JAX package's), :class:`InjectedWriterCrash`,
:class:`SinkFaultStats`, and :func:`crash_consistency_check`, the crash
matrix of one atomic write, whose oracle is ``io/integrity.py``'s
``verify_file``; and at the table level :class:`SharedCrashState`, one
crash byte shared by every sink of a table's commit, and
:func:`table_crash_check`, the crash matrix of a table's commit.

The network side: :class:`FaultInjectingRemoteTransport`, a seeded chaos
wrapper over ``io/remote.py``'s transport (refused and reset connections,
stalls, 5xx and 429 answers, torn bodies, bit flips, wrong ranges), its
:class:`RemoteFaultStats`, and :class:`LocalRangeServer`, a loopback HTTP
range server over in-memory objects (validators, JSON prefix listings,
ListObjectsV2 pages, a bearer token) whose ``close()`` ends and joins
every request thread.

The fleet's side: :class:`PeerChaos`, installed by :func:`set_peer_chaos`
and consulted by ``serve/cluster.py`` before every peer sub-request, makes
a peer unreachable (``partition``) or dead after ``n`` more sub-requests
(``kill_after``), and logs each trip in ``trips``.
"""

from __future__ import annotations

import contextvars
import errno
import random
import socket
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import (DeadlineError, ReadError, ReadIOError, RemoteError,
                      ShortReadError, _Unsupported)
from ..obs.metrics import counter as _counter
from ..obs.scope import account as _account
from .source import Source

_M_RETRIES = _counter("read.retries")
_M_ROWS_DROPPED = _counter("read.rows_dropped")
_M_RG_SKIPPED = _counter("read.row_groups_skipped")
_M_FILES_SKIPPED = _counter("read.files_skipped")

__all__ = ["FaultPolicy", "ReadReport", "Deadline", "PolicySource",
           "FaultInjectingSource", "FaultStats", "read_context",
           "resolve_policy", "retry_call", "active_deadline",
           "NON_DATA_ERRORS", "is_corrupt_oserror", "InjectedWriterCrash",
           "SinkFaultStats", "FaultInjectingSink", "crash_consistency_check",
           "SharedCrashState", "table_crash_check", "RemoteFaultStats",
           "FaultInjectingRemoteTransport", "LocalRangeServer",
           "PeerChaos", "set_peer_chaos", "peer_chaos"]


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultPolicy:
    """How a read survives a hostile byte source.

    ``max_retries`` / ``backoff_s`` / ``backoff_multiplier`` / ``jitter``
    govern the retries of transient ``OSError``\\ s at the source (jitter
    is a uniform +-fraction of each delay).  ``deadline_s`` bounds each
    top-level operation (one ``read()``, one scan, one lookup): checked
    between preads and before every retry's sleep, raising
    :class:`~parquet_tpu_torch.errors.DeadlineError`.  ``on_corrupt``:
    ``'raise'`` (default) raises a located
    :class:`~parquet_tpu_torch.errors.ReadError`; ``'skip_row_group'``
    drops the whole row group, keeps reading, and records the loss in a
    :class:`ReadReport`."""

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_multiplier: float = 2.0
    jitter: float = 0.25
    deadline_s: Optional[float] = None
    on_corrupt: str = "raise"  # or "skip_row_group"

    def __post_init__(self):
        if self.on_corrupt not in ("raise", "skip_row_group"):
            raise ValueError(
                f"on_corrupt must be 'raise' or 'skip_row_group', "
                f"got {self.on_corrupt!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def skip_corrupt(self) -> bool:
        return self.on_corrupt == "skip_row_group"

    def delays(self):
        """The jittered backoff delay before each retry."""
        delay = self.backoff_s
        for _ in range(self.max_retries):
            j = (1.0 + self.jitter * (2.0 * random.random() - 1.0)
                 if self.jitter else 1.0)
            yield max(0.0, delay * j)
            delay *= self.backoff_multiplier


@dataclass
class ReadReport:
    """What a degraded read delivered and lost.

    ``rows_read``: rows delivered; ``rows_dropped``: rows of skipped row
    groups (for scans, the candidate rows of the dropped spans);
    ``row_groups_skipped``: their ordinals, with ``errors`` the message of
    each skip, index-aligned; ``retries``: the transient retries the
    policy made; ``files_skipped``: the dataset layer's whole files that
    could not be opened or read (their candidate rows in
    ``rows_dropped``, 0 when the footer never parsed)."""

    path: Optional[str] = None
    rows_read: int = 0
    rows_dropped: int = 0
    row_groups_skipped: List[int] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    retries: int = 0
    files_skipped: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.row_groups_skipped and not self.files_skipped

    def bind(self, path: Optional[str]) -> "ReadReport":
        """Fill in the file path of a blank report the caller passed."""
        if self.path is None:
            self.path = path
        return self

    # the registry counts at the record sites only (merge folds without
    # recording again).  A routing attempt's scratch report sets this
    # False: its skips are dropped on a fallback (the host scan records
    # them again) or published once by publish_skips where it is kept.
    _publish = True

    def record_skip(self, rg_index: int, rows: int, error) -> None:
        # no dedup: each call site records one skip a row group an
        # operation, and a report reused across files records each file's
        self.row_groups_skipped.append(rg_index)
        self.errors.append(str(error))
        self.rows_dropped += rows
        if self._publish:
            _account(_M_RG_SKIPPED)
            _account(_M_ROWS_DROPPED, rows)

    def record_file_skip(self, path: str, rows: int, error) -> None:
        """One whole file dropped from a dataset-level degraded read."""
        self.files_skipped.append(str(path))
        self.errors.append(str(error))
        self.rows_dropped += rows
        if self._publish:
            _account(_M_FILES_SKIPPED)
            _account(_M_ROWS_DROPPED, rows)

    def publish_skips(self) -> None:
        """Publish the report's skips to the registry at once: the scratch
        report's counterpart of the record sites, called once where the
        attempt that made it is kept."""
        _account(_M_RG_SKIPPED, len(self.row_groups_skipped))
        _account(_M_FILES_SKIPPED, len(self.files_skipped))
        _account(_M_ROWS_DROPPED, self.rows_dropped)

    def merge(self, other: "ReadReport") -> "ReadReport":
        """Fold another report (a file's, a shard's, or a routing
        attempt's scratch report) into this one."""
        if self.path is None:
            self.path = other.path
        self.rows_read += other.rows_read
        self.rows_dropped += other.rows_dropped
        self.row_groups_skipped.extend(other.row_groups_skipped)
        self.errors.extend(other.errors)
        self.retries += other.retries
        self.files_skipped.extend(other.files_skipped)
        return self

    def as_dict(self) -> dict:
        return {"path": self.path, "rows_read": self.rows_read,
                "rows_dropped": self.rows_dropped,
                "row_groups_skipped": list(self.row_groups_skipped),
                "errors": list(self.errors), "retries": self.retries,
                "files_skipped": list(self.files_skipped)}


def resolve_policy(pf, policy: Optional[FaultPolicy],
                   report: Optional[ReadReport]
                   ) -> Tuple[Optional[FaultPolicy], Optional[ReadReport]]:
    """The policy and report of one read entry point: a per-call
    ``policy`` overrides the file's open-time one; a caller's ``report`` is
    bound to the file's path, and a policy read without one gets a fresh
    report, so skips are always accounted."""
    pol = policy if policy is not None else pf.policy
    if report is not None:
        report.bind(pf._path)
    elif pol is not None:
        report = ReadReport(path=pf._path)
    return pol, report


class Deadline:
    """A monotonic-clock budget for one top-level read operation."""

    __slots__ = ("_expires",)

    def __init__(self, seconds: Optional[float]):
        self._expires = None if seconds is None else time.monotonic() + seconds

    def remaining(self) -> Optional[float]:
        return (None if self._expires is None
                else self._expires - time.monotonic())

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def check(self, what: str = "read") -> None:
        if self.expired():
            raise DeadlineError(f"deadline exceeded during {what}")


# ---------------------------------------------------------------------------
# Located errors
# ---------------------------------------------------------------------------
# Failures of the environment, the device or the port's own routing are
# never data corruption: wrapping them would let skip_row_group drop every
# row group over a missing package, an out-of-memory card or a poisoned
# CUDA context, and would hide the device route's refusal of a chunk
# (``_Unsupported``) from the chunk loop that sends it to the host decode.
# ``RuntimeError`` covers torch's device errors (``torch.OutOfMemoryError``,
# ``torch.AcceleratorError``, and the plain "CUDA error" of older torch)
# and a kernel that does not build; the port's decoders raise
# ``CorruptedError`` for malformed bytes.
NON_DATA_ERRORS: Tuple[type, ...] = (
    ImportError, MemoryError, RecursionError, NotImplementedError,
    RuntimeError, _Unsupported)


def is_corrupt_oserror(e: OSError) -> bool:
    """A short or invalid read, or a terminal remote answer, is
    corruption, not transience: the one classifier :func:`retry_call`
    consults.  A :class:`~parquet_tpu_torch.errors.RemoteError` decides by
    its ``retryable``."""
    if isinstance(e, RemoteError):
        return not e.retryable
    if isinstance(e, ShortReadError):
        return True
    s = str(e)
    return "short read" in s or "invalid read" in s


# the deadline of the innermost active PolicySource operation, for layers
# below the policy wrapper (a context variable: pool workers started
# inside the operation inherit it through ``utils/pool.py::submit``)
_ACTIVE_DEADLINE: "contextvars.ContextVar[Optional[Deadline]]" = \
    contextvars.ContextVar("parquet_tpu_torch_active_deadline", default=None)


def active_deadline() -> Optional[Deadline]:
    """The innermost active operation deadline in this context (None when
    no policy operation runs, or its policy has no ``deadline_s``)."""
    dl = _ACTIVE_DEADLINE.get()
    return dl if dl is not None and dl._expires is not None else None


def retry_call(fn, offset: int, size: int, policy: FaultPolicy,
               deadline: Optional[Deadline] = None, on_retry=None):
    """The retry loop: a transient ``OSError`` is tried again after the
    policy's jittered backoff, corruption (:func:`is_corrupt_oserror`)
    raises at once, and the deadline is checked before each attempt and
    each sleep (a sleep the budget cannot cover fails now).  Shared by
    :class:`PolicySource` and ``io/source.py::RetryingSource``."""
    delays = policy.delays()
    while True:
        if deadline is not None:
            deadline.check(f"pread({offset}, {size})")
        try:
            return fn(offset, size)
        except DeadlineError:
            # the operation's own clock (a TimeoutError is an OSError):
            # never retried
            raise
        except OSError as e:
            if is_corrupt_oserror(e):
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            ra = getattr(e, "retry_after", None)
            if ra:
                delay = max(delay, float(ra))
            if deadline is not None:
                rem = deadline.remaining()
                if rem is not None and delay >= rem:
                    raise DeadlineError(
                        "deadline exceeded during retry backoff for "
                        f"pread({offset}, {size})") from e
            if on_retry is not None:
                on_retry()
            if delay > 0:
                time.sleep(delay)


@contextmanager
def read_context(path=None, row_group=None, column=None, page_offset=None,
                 kinds: Tuple[type, ...] = (Exception,)):
    """Wrap the failures escaping the block into the :class:`ReadError`
    hierarchy with their place.  A located ``ReadError`` and a deadline
    pass untouched, as do the :data:`NON_DATA_ERRORS`; an ``OSError``
    becomes a :class:`ReadIOError`, so ``except OSError`` callers keep
    working.  ``kinds`` narrows what is wrapped (the footer parse wraps
    only ``(CorruptedError, OSError)``)."""
    try:
        yield
    except ShortReadError as e:
        # a source knows offsets, not row groups: add the read's place
        if e.path is not None or path is None:
            raise
        raise ShortReadError(str(e), path=path, row_group=row_group,
                             column=column,
                             page_offset=(e.page_offset
                                          if e.page_offset is not None
                                          else page_offset)) from e
    except ReadError:
        raise
    except NON_DATA_ERRORS:
        raise
    except kinds as e:
        cls = ReadIOError if isinstance(e, OSError) else ReadError
        raise cls(str(e) or type(e).__name__, path=path, row_group=row_group,
                  column=column,
                  page_offset=getattr(e, "page_offset", page_offset)) from e


# ---------------------------------------------------------------------------
# Policy-applying source wrapper
# ---------------------------------------------------------------------------
class PolicySource(Source):
    """Applies a :class:`FaultPolicy`'s retries and deadline to every pread
    of the wrapped source.  ``ParquetFile(..., policy=...)`` installs one
    (and a per-call policy one for its call); each top-level operation
    opens an :meth:`operation` scope that starts its deadline clock and
    counts its retries into the caller's :class:`ReadReport`.

    The chunks of one operation decode on several threads (the read's
    staging workers, the dataset's pool), all under the operation's
    deadline: the active :class:`Deadline` lives on the instance, not in a
    thread-local.  Where operations overlap, preads run under the most
    recently started one's clock."""

    def __init__(self, inner: Source, policy: FaultPolicy):
        self.inner = inner
        self.policy = policy
        # a stack: overlapping operations each remove only their own clock
        self._deadline_stack: List[Deadline] = []
        self._op_retries: Dict[int, int] = {}  # id(Deadline) -> retries
        self._lock = threading.Lock()
        self.retries_performed = 0

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    @property
    def _deadline(self) -> Optional[Deadline]:
        st = self._deadline_stack[-1:]  # another thread may pop meanwhile
        return st[0] if st else None

    @contextmanager
    def operation(self, report: Optional[ReadReport] = None,
                  what: str = "read"):
        """One top-level operation: its deadline clock, and its retries
        counted into ``report``."""
        dl = Deadline(self.policy.deadline_s)
        self._deadline_stack.append(dl)
        tok = _ACTIVE_DEADLINE.set(dl)
        with self._lock:
            self._op_retries[id(dl)] = 0
        try:
            yield dl
        finally:
            try:
                _ACTIVE_DEADLINE.reset(tok)
            except ValueError:
                pass  # closed from another context: nothing to restore
            st = self._deadline_stack
            if dl in st:
                st.remove(dl)
            with self._lock:
                mine = self._op_retries.pop(id(dl), 0)
            if report is not None:
                report.retries += mine

    def _call(self, fn, offset: int, size: int):
        dl = self._deadline

        def on_retry():
            with self._lock:
                self.retries_performed += 1
                if dl is not None and id(dl) in self._op_retries:
                    self._op_retries[id(dl)] += 1
            _account(_M_RETRIES)

        return retry_call(fn, offset, size, self.policy, deadline=dl,
                          on_retry=on_retry)

    def pread(self, offset: int, size: int) -> bytes:
        return self._call(self.inner.pread, offset, size)

    def pread_view(self, offset: int, size: int):
        fn = getattr(self.inner, "pread_view", self.inner.pread)
        return self._call(fn, offset, size)

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------
def _mix_rng(seed: int, *parts: int) -> random.Random:
    """A keyed RNG for the injector's draws, splitmix64-style: similar
    ``(offset, size)`` keys land on uncorrelated states.  The JAX
    package's mixing, so one seed draws the same faults for the same
    ``(offset, size, attempt)`` in both."""
    h = 0x9E3779B97F4A7C15
    for p in (seed, *parts):
        h ^= p & 0xFFFFFFFFFFFFFFFF
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return random.Random(h)


@dataclass
class FaultStats:
    """What the injector did."""

    preads: int = 0
    injected_errors: int = 0
    injected_flips: int = 0
    injected_short_reads: int = 0
    delayed_s: float = 0.0


class FaultInjectingSource(Source):
    """A deterministic, seedable chaos wrapper over any Source.

    Draws are keyed on ``(seed, offset, size, attempt)``, not on a shared
    stream, so injection does not depend on call order (thread pools
    included) and each retry of a pread draws again deterministically.
    ``max_consecutive_errors`` bounds how many times in a row one pread
    fails, so a policy with ``max_retries >= max_consecutive_errors``
    always recovers.  It has no ``stat_key``: a file read through it never
    fills the caches nor is served from them.

    Modes (all composable): ``error_rate`` (a transient ``OSError(EIO)``),
    ``latency_s`` (a sleep before every pread), ``flip_offsets`` /
    ``flip_mask`` (the bytes at these file offsets come back XOR'd, every
    time), ``bit_flip_rate`` (one deterministic bit of a read flips,
    persistently), ``truncate_at`` (the file seems to end there: reads
    past it raise :class:`~parquet_tpu_torch.errors.ShortReadError`),
    ``short_read_rate`` (a pread returns fewer bytes than asked)."""

    def __init__(self, inner: Source, seed: int = 0, error_rate: float = 0.0,
                 max_consecutive_errors: Optional[int] = None,
                 latency_s: float = 0.0,
                 flip_offsets=(), flip_mask: int = 0xFF,
                 bit_flip_rate: float = 0.0,
                 truncate_at: Optional[int] = None,
                 short_read_rate: float = 0.0):
        self.inner = inner
        self.seed = seed
        self.error_rate = error_rate
        self.max_consecutive_errors = max_consecutive_errors
        self.latency_s = latency_s
        self.flip_offsets = sorted(set(flip_offsets))
        self.flip_mask = flip_mask
        self.bit_flip_rate = bit_flip_rate
        self.truncate_at = truncate_at
        self.short_read_rate = short_read_rate
        self.stats = FaultStats()
        self._attempts: Dict[Tuple[int, int], int] = {}
        self._consecutive: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    def _rng(self, offset: int, size: int, attempt: int) -> random.Random:
        return _mix_rng(self.seed, offset, size, attempt)

    def _read(self, fn, offset: int, size: int):
        with self._lock:
            self.stats.preads += 1
            key = (offset, size)
            attempt = self._attempts.get(key, 0)
            self._attempts[key] = attempt + 1
            consecutive = self._consecutive.get(key, 0)
        rng = self._rng(offset, size, attempt)
        if self.latency_s:
            time.sleep(self.latency_s)
            with self._lock:
                self.stats.delayed_s += self.latency_s
        if (self.error_rate and rng.random() < self.error_rate
                and (self.max_consecutive_errors is None
                     or consecutive < self.max_consecutive_errors)):
            with self._lock:
                self.stats.injected_errors += 1
                self._consecutive[key] = consecutive + 1
            raise OSError(errno.EIO,
                          f"injected transient I/O error (attempt {attempt})")
        with self._lock:
            self._consecutive[key] = 0
        if self.truncate_at is not None and offset + size > self.truncate_at:
            got = max(0, self.truncate_at - offset)
            raise ShortReadError(
                f"short read at {offset}: wanted {size}, got {got} "
                "(injected truncation)")
        data = fn(offset, size)
        flips = [o for o in self.flip_offsets if offset <= o < offset + size]
        # random flips draw on attempt 0: a re-read sees the same rot
        rng0 = self._rng(offset, size, 0)
        rand_flip = (self.bit_flip_rate and size > 0
                     and rng0.random() < self.bit_flip_rate)
        if flips or rand_flip:
            buf = bytearray(data)
            for o in flips:
                buf[o - offset] ^= self.flip_mask
            if rand_flip:
                buf[rng0.randrange(size)] ^= 1 << rng0.randrange(8)
            with self._lock:
                self.stats.injected_flips += len(flips) + bool(rand_flip)
            data = bytes(buf)
        if (self.short_read_rate and size > 1
                and rng.random() < self.short_read_rate):
            with self._lock:
                self.stats.injected_short_reads += 1
            data = data[:rng.randrange(1, size)]
        return data

    def pread(self, offset: int, size: int) -> bytes:
        out = self._read(self.inner.pread, offset, size)
        return bytes(out) if not isinstance(out, bytes) else out

    def pread_view(self, offset: int, size: int):
        # a byte-changing mode takes the copying path (a view would show
        # the pristine bytes)
        view = getattr(self.inner, "pread_view", None)
        if (view is None or self.flip_offsets or self.bit_flip_rate
                or self.short_read_rate):
            return self._read(self.inner.pread, offset, size)
        return self._read(view, offset, size)

    def size(self) -> int:
        n = self.inner.size()
        return n if self.truncate_at is None else min(n, self.truncate_at)

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# The write side: a deterministic fault injector over a sink
# ---------------------------------------------------------------------------
class InjectedWriterCrash(Exception):
    """A simulated hard crash in the middle of a write: the bytes past the
    crash point were never persisted, and the sink can no longer flush or
    commit, as a killed process or a lost power supply leaves it.  Not an
    ``OSError``, so that "the environment failed" (which the writer may
    report) stays apart from "the machine died" (which it cannot)."""


@dataclass
class SinkFaultStats:
    """What the write-side injector did."""

    writes: int = 0
    bytes_written: int = 0  # bytes that reached the inner sink
    injected_errors: int = 0
    injected_short_writes: int = 0
    crashed: bool = False


class FaultInjectingSink:
    """A seedable chaos wrapper over a write sink (a
    :class:`~parquet_tpu_torch.io.sink.Sink` or a binary file object).

    Its draws come from one ``random.Random(seed)`` in write order, as the
    JAX package's do: the same seed and the same writes give the same
    faults.  The modes compose:

    - ``error_rate``: the chance that a ``write()`` raises a transient
      ``OSError(EIO)`` with nothing persisted;
    - ``short_write_rate``: the chance that a ``write()`` persists a strict
      prefix of its buffer and raises an ``OSError`` naming the short
      write (bytes on disk, fewer than the writer counted);
    - ``enospc_at_byte``: the disk holds this many bytes; the write that
      crosses it persists up to it and raises ``OSError(ENOSPC)``, as does
      every later write;
    - ``crash_at_byte``: bytes up to it persist, the write that crosses it
      raises :class:`InjectedWriterCrash`, and every later ``write``,
      ``flush`` and ``close`` raises too (a dead process cannot commit).
      ``abort()`` still reaches the inner sink, so a harness can sweep the
      temp file, as a restarted process would."""

    def __init__(self, inner, seed: int = 0, error_rate: float = 0.0,
                 short_write_rate: float = 0.0,
                 enospc_at_byte: Optional[int] = None,
                 crash_at_byte: Optional[int] = None):
        self.inner = inner
        self.seed = seed
        self.error_rate = error_rate
        self.short_write_rate = short_write_rate
        self.enospc_at_byte = enospc_at_byte
        self.crash_at_byte = crash_at_byte
        self.stats = SinkFaultStats()
        self._rng = random.Random(seed)
        self._total = 0  # bytes persisted to the inner sink

    def _check_alive(self, what: str) -> None:
        if self.stats.crashed:
            raise InjectedWriterCrash(
                f"{what} after injected crash at byte {self.crash_at_byte}")

    def _persist(self, data) -> None:
        self.inner.write(data)
        n = len(data)
        self._total += n
        self.stats.bytes_written += n

    def write(self, data) -> int:
        self._check_alive("write")
        data = bytes(data) if not isinstance(data, (bytes, bytearray)) \
            else data
        n = len(data)
        self.stats.writes += 1
        if self.crash_at_byte is not None \
                and self._total + n > self.crash_at_byte:
            keep = self.crash_at_byte - self._total
            if keep > 0:
                self._persist(data[:keep])
            self.stats.crashed = True
            raise InjectedWriterCrash(
                f"injected crash at byte {self.crash_at_byte}")
        if self.enospc_at_byte is not None \
                and self._total + n > self.enospc_at_byte:
            keep = self.enospc_at_byte - self._total
            if keep > 0:
                self._persist(data[:keep])
            self.stats.injected_errors += 1
            raise OSError(errno.ENOSPC,
                          f"injected ENOSPC at byte {self.enospc_at_byte}")
        if self.error_rate and self._rng.random() < self.error_rate:
            self.stats.injected_errors += 1
            raise OSError(errno.EIO, "injected transient write error")
        if (self.short_write_rate and n > 1
                and self._rng.random() < self.short_write_rate):
            keep = self._rng.randrange(1, n)
            self._persist(data[:keep])
            self.stats.injected_short_writes += 1
            raise OSError(f"short write at {self._total - keep}: "
                          f"wanted {n}, wrote {keep} (injected)")
        self._persist(data)
        return n

    def writelines(self, parts) -> None:
        for p in parts:
            self.write(p)

    def flush(self) -> None:
        self._check_alive("flush")
        self.inner.flush()

    def close(self) -> None:
        self._check_alive("close/commit")
        if self.crash_at_byte is not None \
                and self._total >= self.crash_at_byte:
            # the crash point was the last byte written: the process died
            # after the bytes and before the commit
            self.stats.crashed = True
            raise InjectedWriterCrash(
                f"injected crash at byte {self.crash_at_byte} (pre-commit)")
        self.inner.close()

    def abort(self) -> None:
        ab = getattr(self.inner, "abort", None)
        if ab is not None:
            ab()
        else:
            try:
                self.inner.close()
            except OSError:
                pass


def crash_consistency_check(build, dest, samples: int = 12, seed: int = 0,
                            offsets=None, buffered: bool = False
                            ) -> List[dict]:
    """The crash matrix of one atomic write.

    ``build(sink)`` makes a whole write to the sink it is given (for
    example ``lambda s: write_table(table, s, options)``) without
    committing it: the harness commits.  A first run without a crash
    gives the write's byte count N; then, for each sampled crash offset in
    [0, N] (``samples`` of them, drawn from ``seed``, 0 and N always among
    them, or ``offsets``), the write runs again into an atomic sink for
    ``dest`` (``io/sink.py::AtomicFileSink``) behind a
    :class:`FaultInjectingSink` that crashes at that byte, and the
    invariant must hold: ``dest`` does not exist, or
    :func:`~parquet_tpu_torch.io.integrity.verify_file` finds it clean.  A
    last run without a crash commits and must verify clean.
    ``buffered=True`` puts a :class:`~parquet_tpu_torch.io.sink.BufferedSink`
    between the writer and the injector, so the crashes land inside its
    coalesced flushes.

    Returns one ``{"offset", "outcome"}`` a run, the outcome ``"absent"``
    or ``"clean"``; raises ``AssertionError`` (with the offset and the
    issues) on a violation."""
    import os

    from .integrity import verify_file
    from .sink import AtomicFileSink, BufferedSink

    if os.path.exists(dest):
        raise FileExistsError(f"crash harness refuses to overwrite {dest!r}")

    def run(crash_at):
        inj = FaultInjectingSink(AtomicFileSink(dest),
                                 crash_at_byte=crash_at)
        sink = BufferedSink(inj) if buffered else inj
        try:
            build(sink)
            sink.close()  # the commit: runs without a crash only
        except InjectedWriterCrash:
            # a dead process leaves its temp file; the restarted one
            # sweeps it, and the destination never needs a recovery
            sink.abort()
        return inj

    total = run(None).stats.bytes_written
    rep = verify_file(dest)
    assert rep.ok, f"uncrashed write failed verification: {rep.summary()}"
    os.unlink(dest)

    if offsets is None:
        rng = random.Random(seed)
        pool = range(1, total)
        picks = rng.sample(pool, min(max(samples - 2, 0), len(pool)))
        offsets = sorted({0, *picks, total})
    results = []
    for off in offsets:
        run(off)
        if os.path.exists(dest):
            rep = verify_file(dest)
            assert rep.ok, (f"crash at byte {off} left a corrupt "
                            f"destination: {rep.summary()}")
            results.append({"offset": off, "outcome": "clean"})
            os.unlink(dest)
        else:
            results.append({"offset": off, "outcome": "absent"})
    run(None)  # the control: the committed file must verify clean
    rep = verify_file(dest)
    assert rep.ok, f"final write failed verification: {rep.summary()}"
    results.append({"offset": None, "outcome": "clean"})
    return results


class SharedCrashState:
    """One crash byte shared by every sink of a multi-file write: the
    table-level form of :class:`FaultInjectingSink`'s ``crash_at_byte``.
    A table's commit writes its parts and then its manifest through
    separate sinks, and a process dies at one byte of that whole sequence.
    ``wrap(sink)`` puts the shared count in front of a sink (the
    ``_sink_wrap`` of ``dataset_writer.DatasetWriter``, ``compact_table``
    and ``io/manifest.py::write_manifest``).  The write that crosses
    ``crash_at_byte`` persists its prefix and raises
    :class:`InjectedWriterCrash`; from then on every write, flush and
    commit of every sink raises, and ``abort()`` only releases the file (a
    dead process cleans nothing up: its temps stay for the sweep)."""

    def __init__(self, crash_at_byte: Optional[int] = None):
        self.crash_at_byte = crash_at_byte
        self.total = 0  # bytes persisted across every wrapped sink
        self.crashed = False
        self._lock = threading.Lock()

    def wrap(self, sink):
        return _SharedCrashSink(self, sink)

    def _admit(self, n: int) -> int:
        """How many of ``n`` bytes persist (-1: all of them); crossing the
        budget marks the process dead, and a dead one raises."""
        with self._lock:
            if self.crashed:
                raise InjectedWriterCrash(
                    f"write after shared crash at byte {self.crash_at_byte}")
            if self.crash_at_byte is not None \
                    and self.total + n > self.crash_at_byte:
                keep = max(self.crash_at_byte - self.total, 0)
                self.total += keep
                self.crashed = True
                return keep
            self.total += n
            return -1

    def _check_alive(self, what: str) -> None:
        with self._lock:
            dead = self.crashed or (self.crash_at_byte is not None
                                    and self.total >= self.crash_at_byte)
            if dead:
                self.crashed = True
        if dead:
            raise InjectedWriterCrash(
                f"{what} after shared crash at byte {self.crash_at_byte}")


class _SharedCrashSink:
    """One sink's view of a :class:`SharedCrashState`."""

    def __init__(self, state: SharedCrashState, inner):
        self.state = state
        self.inner = inner

    def write(self, data) -> int:
        data = bytes(data) if not isinstance(data, (bytes, bytearray)) \
            else data
        n = len(data)
        keep = self.state._admit(n)
        if keep >= 0:
            if keep > 0:
                self.inner.write(data[:keep])
            raise InjectedWriterCrash(
                f"injected shared crash at byte {self.state.crash_at_byte}")
        self.inner.write(data)
        return n

    def writelines(self, parts) -> None:
        for p in parts:
            self.write(p)

    def flush(self) -> None:
        self.state._check_alive("flush")
        self.inner.flush()

    def close(self) -> None:
        # the commit: a process whose budget is spent died before it (the
        # rename boundary, sampled as offset == total)
        self.state._check_alive("close/commit")
        self.inner.close()

    def abort(self) -> None:
        if self.state.crashed:
            # no cleanup in a dead process: the temp file stays where it
            # fell, and only its descriptor is released
            f = getattr(self.inner, "_f", None)
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
                self.inner._f = None
            return
        ab = getattr(self.inner, "abort", None)
        if ab is not None:
            ab()
        else:
            try:
                self.inner.close()
            except OSError:
                pass


def _host_fingerprint(cols) -> tuple:
    """A read's columns as exact host bytes: every array's dtype, shape
    and bytes, a column's validity and list structure included."""
    import numpy as np

    def arr(a):
        if a is None:
            return None
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        return (a.dtype.str, a.shape, a.tobytes())

    def form(x):
        if isinstance(x, dict):
            return tuple((k, form(v)) for k, v in sorted(x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(form(v) for v in x)
        return arr(x)

    return tuple((path, form(c.materialize_host()), arr(c.validity))
                 for path, c in sorted(cols.items()))


def table_crash_check(setup, ingest, workdir, samples: int = 10,
                      seed: int = 0, offsets=None,
                      device="cuda") -> List[dict]:
    """The crash matrix of a table's commit: :func:`crash_consistency_check`
    lifted to the manifest.

    ``setup(table_dir)`` builds the base snapshot (it may commit nothing).
    ``ingest(table_dir, sink_wrap)`` makes one more ingest and commit,
    passing ``sink_wrap`` to every sink it opens
    (``DatasetWriter(..., _sink_wrap=sink_wrap)`` covers the parts and the
    manifest).  A run without a crash gives the byte count N and the new
    snapshot.  Then the ingest runs again from a copy of the base at each
    sampled global byte (``samples`` of them from ``seed``, with 0, N, the
    rename boundary, and N + 1, a process that outlived the rename, or
    ``offsets``), recovery runs, and the invariant must hold:

    - the live snapshot is exactly the base or exactly the new one (the
      manifest's version and every column of the table, read on
      ``device``, compared byte for byte);
    - every part the live manifest names passes
      :func:`~parquet_tpu_torch.io.integrity.verify_file`;
    - no orphan is left: the directory holds the manifest and its parts.

    Returns one ``{"offset", "outcome"}`` a run, the outcome ``"old"`` or
    ``"new"``; raises ``AssertionError`` on a violation."""
    import os
    import shutil

    from ..dataset_writer import open_table, recover_table
    from .integrity import verify_file
    from .manifest import MANIFEST_NAME, read_manifest

    workdir = os.fspath(workdir)
    base_dir = os.path.join(workdir, "base")
    os.makedirs(base_dir, exist_ok=True)
    setup(base_dir)
    base_manifest = read_manifest(base_dir)
    base_version = base_manifest.version if base_manifest is not None else 0

    def fingerprint(d):
        m = read_manifest(d)
        if m is None or not m.files:
            return (0 if m is None else m.version, None)
        ds = open_table(d, pin=False)
        try:
            return m.version, _host_fingerprint(ds.read(device=device))
        finally:
            ds.close()

    base_fp = fingerprint(base_dir)

    def run(tag, crash_at):
        d = os.path.join(workdir, f"run_{tag}")
        shutil.copytree(base_dir, d)
        state = SharedCrashState(crash_at_byte=crash_at)
        try:
            ingest(d, state.wrap)
        except InjectedWriterCrash:
            pass
        return d, state

    # part names are random a run: the new snapshot is known by its
    # version and its contents
    probe_dir, probe_state = run("probe", None)
    total = probe_state.total
    new_fp = fingerprint(probe_dir)
    assert new_fp[0] > base_version, \
        "table_crash_check: ingest() did not commit a new snapshot"
    shutil.rmtree(probe_dir)

    if offsets is None:
        rng = random.Random(seed)
        pool = range(1, total)
        picks = rng.sample(pool, min(max(samples - 2, 0), len(pool)))
        offsets = sorted({0, *picks, total, total + 1})

    results = []
    for off in offsets:
        d, _ = run(f"off{off}", off)
        swept = recover_table(d)
        got = fingerprint(d)
        if got == base_fp:
            outcome = "old"
        else:
            assert got == new_fp, (
                f"crash at byte {off}: recovered snapshot is neither the "
                f"old (v{base_fp[0]}) nor the new (v{new_fp[0]}) one: "
                f"v{got[0]}")
            outcome = "new"
        live = read_manifest(d)
        names = set(live.names()) if live is not None else set()
        for name in sorted(names):
            rep = verify_file(os.path.join(d, name))
            assert rep.ok, (f"crash at byte {off}: live file {name} "
                            f"corrupt: {rep.summary()}")
        leftovers = sorted(set(os.listdir(d)) - names - {MANIFEST_NAME})
        assert not leftovers, (f"crash at byte {off}: recovery left "
                               f"orphans {leftovers} (swept {swept})")
        results.append({"offset": off, "outcome": outcome})
        shutil.rmtree(d)
    outcomes = {r["outcome"] for r in results}
    assert outcomes == {"old", "new"} or len(offsets) < 2, (
        "crash matrix degenerate: every offset recovered to the same "
        f"snapshot ({outcomes}): the sampling missed a phase")
    return results


# ---------------------------------------------------------------------------
# The network side: a fault injector over a remote transport, and a
# loopback range server
# ---------------------------------------------------------------------------
@dataclass
class RemoteFaultStats:
    """What the remote injector did."""

    requests: int = 0
    refused: int = 0
    resets: int = 0
    stalls: int = 0
    statuses: int = 0
    throttles: int = 0
    truncated: int = 0
    flipped: int = 0
    wrong_range: int = 0


class FaultInjectingRemoteTransport:
    """A deterministic, seedable chaos wrapper over a remote transport
    (``io/remote.py::HttpTransport``, or anything with its ``head`` and
    ``get_range``).  Draws are keyed on ``(seed, offset, size, attempt)``
    with :class:`FaultInjectingSource`'s mixing, so injection does not
    depend on call order (hedge threads included) and one seed draws the
    JAX package's faults.  ``max_consecutive`` bounds how many times in a
    row one range fails, so a policy with that many retries recovers.

    Modes (all composable): ``refuse_rate`` / ``reset_rate`` (the
    connection dies before an answer); ``stall_s`` with ``stall_rate`` or
    ``stall_attempts`` (the answer comes ``stall_s`` seconds late; the
    first ``stall_attempts`` attempts of each range stall: a stalled
    primary and a fast hedge), cut short when ``stall_release`` (a
    ``threading.Event``) is set; ``status_rate`` / ``status_code`` (an
    error status, 503 by default); ``throttle_rate`` / ``retry_after``
    (429 with its ``Retry-After``); ``truncate_rate`` (a torn body under
    headers that promise the range); ``flip_rate`` (one bit of a range's
    body flips, on every attempt: rot that a re-read does not cure);
    ``wrong_range_rate`` (the answer claims another start); and
    ``head_refuse`` (HEADs are refused)."""

    def __init__(self, inner, seed: int = 0, refuse_rate: float = 0.0,
                 reset_rate: float = 0.0, stall_s: float = 0.0,
                 stall_rate: float = 0.0,
                 stall_attempts: Optional[int] = None,
                 status_rate: float = 0.0, status_code: int = 503,
                 throttle_rate: float = 0.0,
                 retry_after: Optional[float] = None,
                 truncate_rate: float = 0.0, flip_rate: float = 0.0,
                 wrong_range_rate: float = 0.0,
                 max_consecutive: Optional[int] = None,
                 head_refuse: bool = False,
                 stall_release: Optional[threading.Event] = None):
        self.inner = inner
        self.seed = seed
        self.refuse_rate = refuse_rate
        self.reset_rate = reset_rate
        self.stall_s = stall_s
        self.stall_rate = stall_rate
        self.stall_attempts = stall_attempts
        self.status_rate = status_rate
        self.status_code = status_code
        self.throttle_rate = throttle_rate
        self.retry_after = retry_after
        self.truncate_rate = truncate_rate
        self.flip_rate = flip_rate
        self.wrong_range_rate = wrong_range_rate
        self.max_consecutive = max_consecutive
        self.head_refuse = head_refuse
        self.stall_release = stall_release
        self.stats = RemoteFaultStats()
        self._attempts: Dict[Tuple[int, int], int] = {}
        self._consecutive: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()

    @property
    def url(self):
        return getattr(self.inner, "url", None)

    @property
    def host(self):
        return getattr(self.inner, "host", None)

    def _count(self, what: str, key=None) -> None:
        with self._lock:
            setattr(self.stats, what, getattr(self.stats, what) + 1)
            if key is not None:
                self._consecutive[key] = self._consecutive.get(key, 0) + 1

    def head(self, **kw):
        if self.head_refuse:
            self._count("refused")
            raise ConnectionRefusedError(
                errno.ECONNREFUSED, "injected connect refused (HEAD)")
        return self.inner.head(**kw)

    def get_range(self, offset: int, size: int, **kw):
        key = (offset, size)
        with self._lock:
            self.stats.requests += 1
            attempt = self._attempts.get(key, 0)
            self._attempts[key] = attempt + 1
            consecutive = self._consecutive.get(key, 0)
        rng = _mix_rng(self.seed, offset, size, attempt)
        inject = (self.max_consecutive is None
                  or consecutive < self.max_consecutive)
        if self.stall_s > 0 and (
                attempt < self.stall_attempts
                if self.stall_attempts is not None
                else self.stall_rate and rng.random() < self.stall_rate):
            self._count("stalls")
            if self.stall_release is not None:
                self.stall_release.wait(self.stall_s)
            else:
                time.sleep(self.stall_s)
        if inject and self.refuse_rate and rng.random() < self.refuse_rate:
            self._count("refused", key)
            raise ConnectionRefusedError(
                errno.ECONNREFUSED,
                f"injected connect refused (attempt {attempt})")
        if inject and self.reset_rate and rng.random() < self.reset_rate:
            self._count("resets", key)
            raise ConnectionResetError(
                errno.ECONNRESET,
                f"injected connection reset (attempt {attempt})")
        if inject and self.status_rate and rng.random() < self.status_rate:
            self._count("statuses", key)
            return self.status_code, {"content-length": "0"}, b""
        if (inject and self.throttle_rate
                and rng.random() < self.throttle_rate):
            self._count("throttles", key)
            hdrs = {"content-length": "0"}
            if self.retry_after is not None:
                hdrs["retry-after"] = str(self.retry_after)
            return 429, hdrs, b""
        status, headers, body = self.inner.get_range(offset, size, **kw)
        body_fault = False
        if (inject and self.wrong_range_rate
                and rng.random() < self.wrong_range_rate and status == 206):
            self._count("wrong_range", key)
            body_fault = True
            headers = dict(headers)
            headers["content-range"] = (
                f"bytes {offset + 7}-{offset + 6 + size}/*")
        elif (inject and self.truncate_rate and len(body) > 1
              and rng.random() < self.truncate_rate):
            self._count("truncated", key)
            body_fault = True
            body = body[:rng.randrange(1, len(body))]
        if not body_fault:
            with self._lock:
                self._consecutive[key] = 0
        rng0 = _mix_rng(self.seed, offset, size, 0)  # rot: every attempt
        if self.flip_rate and body and rng0.random() < self.flip_rate:
            buf = bytearray(body)
            buf[rng0.randrange(len(buf))] ^= 1 << rng0.randrange(8)
            body = bytes(buf)
            self._count("flipped")
        return status, headers, body

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class LocalRangeServer:
    """A loopback HTTP/1.1 range server over in-memory ``{name: bytes}``:
    the remote tests' and ``chip_smoke.py``'s server, with no network.

    ``HEAD`` answers ``Content-Length`` with an ``ETag`` and a
    ``Last-Modified`` (``send_validators``); ``GET`` with one ``Range:
    bytes=a-b`` answers 206 and ``Content-Range`` (416 past the end; 200
    and the whole body without a Range, or always with
    ``ignore_range``).  A GET of a name ending in ``/`` (or of the root)
    lists the names one level under it as a JSON array; with
    ``s3_dialect`` a ``?list-type=2`` GET answers ListObjectsV2 XML pages
    of ``s3_max_keys`` keys.  With ``auth_token`` every request needs
    ``Authorization: Bearer <token>`` or gets 401
    (:meth:`set_auth_token` rotates it).  :meth:`put` replaces an object
    and moves its validators; ``requests`` logs ``(method, name, range
    header)``.  :meth:`close` stops the server, shuts the sockets of its
    open keep-alive connections and joins every request thread."""

    def __init__(self, files: Optional[dict] = None,
                 ignore_range: bool = False, send_validators: bool = True,
                 auth_token: Optional[str] = None,
                 s3_dialect: bool = False, s3_max_keys: int = 1000):
        import hashlib
        from email.utils import formatdate
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Lock()
        self._files: Dict[str, bytes] = {}
        self._etag: Dict[str, str] = {}
        self._mtime: Dict[str, float] = {}
        self.ignore_range = ignore_range
        self.send_validators = send_validators
        self.s3_dialect = s3_dialect
        self.s3_max_keys = max(int(s3_max_keys), 1)
        self._auth_token = auth_token
        self.requests: List[Tuple[str, str, Optional[str]]] = []
        self._hash = lambda b: hashlib.md5(b).hexdigest()
        self._fmtdate = formatdate
        for name, data in (files or {}).items():
            self.put(name, data)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive, as in production
            # the headers and the body go out as separate writes: without
            # TCP_NODELAY the body waits out the peer's delayed ACK
            disable_nagle_algorithm = True
            timeout = 60  # an idle keep-alive connection ends by itself

            def log_message(self, fmt, *args):
                pass

            def _lookup(self):
                # a query string (a presigned signature) names the same
                # object, as in an object store
                name = self.path.split("?", 1)[0].lstrip("/")
                with server._lock:
                    data = server._files.get(name)
                    meta = (server._etag.get(name),
                            server._mtime.get(name))
                return name, data, meta

            def _log(self, method: str, name: str, rng) -> None:
                with server._lock:
                    server.requests.append((method, name, rng))

            def _common_headers(self, meta):
                if server.send_validators:
                    self.send_header("ETag", f'"{meta[0]}"')
                    self.send_header("Last-Modified",
                                     server._fmtdate(meta[1], usegmt=True))
                self.send_header("Accept-Ranges",
                                 "none" if server.ignore_range else "bytes")

            def _send(self, status: int, body: bytes = b"",
                      ctype: Optional[str] = None, headers=()) -> None:
                self.send_response(status)
                if ctype:
                    self.send_header("Content-Type", ctype)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body and self.command != "HEAD":
                    self.wfile.write(body)

            def _authorized(self) -> bool:
                with server._lock:
                    tok = server._auth_token
                return (tok is None or self.headers.get("Authorization")
                        == f"Bearer {tok}")

            def do_HEAD(self):  # noqa: N802 (http.server's naming)
                name, data, meta = self._lookup()
                self._log("HEAD", name, None)
                if not self._authorized():
                    self._send(401)
                elif data is None:
                    self.send_error(404, "no such object")
                else:
                    self.send_response(200)
                    self._common_headers(meta)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()

            def _s3_listing(self):
                # ListObjectsV2 of the path-style bucket: keys relative to
                # the bucket, pages of s3_max_keys, an integer offset as
                # the (opaque) continuation token
                from urllib.parse import parse_qs, urlsplit
                from xml.sax.saxutils import escape

                parts = urlsplit(self.path)
                bucket = parts.path.strip("/")
                q = parse_qs(parts.query)
                prefix = (q.get("prefix") or [""])[0]
                token = (q.get("continuation-token") or [None])[0]
                delim = (q.get("delimiter") or [None])[0]
                full = (bucket + "/" if bucket else "") + prefix
                with server._lock:
                    names = sorted(server._files)
                cut = len(bucket) + 1 if bucket else 0
                keys = [n[cut:] for n in names
                        if n.startswith(full) and n != full]
                if delim:
                    keys = [k for k in keys if delim not in k[len(prefix):]]
                try:
                    start = max(int(token), 0) if token else 0
                except ValueError:
                    start = 0
                page = keys[start:start + server.s3_max_keys]
                truncated = start + len(page) < len(keys)
                xml = ['<?xml version="1.0" encoding="UTF-8"?>',
                       '<ListBucketResult xmlns="http://s3.amazonaws.com'
                       '/doc/2006-03-01/">',
                       f"<Prefix>{escape(prefix)}</Prefix>",
                       f"<KeyCount>{len(page)}</KeyCount>",
                       "<IsTruncated>"
                       f"{'true' if truncated else 'false'}</IsTruncated>"]
                if truncated:
                    xml.append("<NextContinuationToken>"
                               f"{start + len(page)}</NextContinuationToken>")
                xml += [f"<Contents><Key>{escape(k)}</Key><Size>0</Size>"
                        "</Contents>" for k in page]
                xml.append("</ListBucketResult>")
                self._send(200, "".join(xml).encode("utf-8"),
                           "application/xml")

            def do_GET(self):  # noqa: N802
                import json

                name, data, meta = self._lookup()
                rng = self.headers.get("Range")
                self._log("GET", name, rng)
                if not self._authorized():
                    self._send(401, b"unauthorized")
                    return
                if server.s3_dialect and "list-type=2" in (
                        self.path.split("?", 1) + [""])[1]:
                    self._s3_listing()
                    return
                if data is None and (name == "" or name.endswith("/")):
                    with server._lock:  # one level, as a glob
                        kids = sorted(n[len(name):] for n in server._files
                                      if n.startswith(name) and n != name
                                      and "/" not in n[len(name):])
                    self._send(200, json.dumps(kids).encode("utf-8"),
                               "application/json")
                    return
                if data is None:
                    self.send_error(404, "no such object")
                    return
                if rng and not server.ignore_range:
                    try:
                        lo_s, hi_s = rng.split("=", 1)[1].split(",")[0] \
                            .split("-", 1)
                        lo = int(lo_s)
                        hi = int(hi_s) if hi_s else len(data) - 1
                    except (IndexError, ValueError):
                        self.send_error(400, "bad Range header")
                        return
                    if lo >= len(data):
                        self._send(416, headers=[
                            ("Content-Range", f"bytes */{len(data)}")])
                        return
                    hi = min(hi, len(data) - 1)
                    body = data[lo:hi + 1]
                    self.send_response(206)
                    self._common_headers(meta)
                    self.send_header("Content-Range",
                                     f"bytes {lo}-{hi}/{len(data)}")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self._common_headers(meta)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        class Server(ThreadingHTTPServer):
            # request threads are joined at close (daemon_threads=False
            # with block_on_close), after their sockets are shut down
            daemon_threads = False
            block_on_close = True

            def process_request(self, request, client_address):
                with server._lock:
                    server._conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with server._lock:
                    server._conns.discard(request)
                super().shutdown_request(request)

            def handle_error(self, request, client_address):
                if not server._closed:  # a socket close() cut is expected
                    super().handle_error(request, client_address)

        self._closed = False
        self._conns: set = set()
        self._httpd = Server(("127.0.0.1", 0), Handler)
        # a short poll: close() waits at most this long for the loop
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        args=(0.02,),
                                        name="pqt-range-server", daemon=True)
        self._thread.start()
        self.host, self.port = self._httpd.server_address[:2]

    def set_auth_token(self, token: Optional[str]) -> None:
        """Rotate (or clear) the bearer token requests must carry."""
        with self._lock:
            self._auth_token = token

    def put(self, name: str, data) -> None:
        """Create or replace an object: new bytes, new ETag, a later
        Last-Modified (by a second at least, so a rewrite within one tick
        still moves it)."""
        data = bytes(data)
        with self._lock:
            self._files[name] = data
            self._etag[name] = self._hash(data)
            self._mtime[name] = max(time.time(),
                                    self._mtime.get(name, 0.0) + 1.0)

    def url(self, name: str) -> str:
        return f"http://{self.host}:{self.port}/{name}"

    def request_count(self, name: Optional[str] = None,
                      method: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for m, n, _ in self.requests
                       if (name is None or n == name)
                       and (method is None or m == method))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._thread.join()
        # a keep-alive handler waits for its client's next request: shut
        # its socket so that it ends now, then join every request thread
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # the client closed it first
        self._httpd.server_close()

    def __enter__(self) -> "LocalRangeServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Fleet peer chaos: deterministic failures on the peer protocol
# ---------------------------------------------------------------------------
class PeerChaos:
    """Deterministic chaos on a fleet's peer sub-requests, installed by
    :func:`set_peer_chaos`.  The peer client calls :meth:`check` with the
    target peer's name before it touches the network, so a test makes a
    peer unreachable (:meth:`partition`) or dead after ``n`` more
    sub-requests (:meth:`kill_after`) without owning the peer's socket.  (A peer's abrupt death at the socket is
    ``serve/server.py::Server.chaos_kill`` on the peer itself; this hook
    is the network between daemons.)"""

    def __init__(self):
        self._lock = threading.Lock()
        self._partitioned: set = set()
        self._kill_after: Dict[str, int] = {}  # name -> requests left
        self.trips: List[Tuple[str, str]] = []  # (peer, action) log

    def partition(self, peer: str) -> None:
        """Every sub-request to ``peer`` fails with a connection error
        (retryable: the breaker sees a dead host)."""
        with self._lock:
            self._partitioned.add(peer)

    def kill_after(self, peer: str, n: int) -> None:
        """Allow ``n`` more sub-requests to ``peer``, then partition it:
        the mid-scan kill."""
        with self._lock:
            self._kill_after[peer] = int(n)

    def check(self, peer: str) -> None:
        """Before each sub-request: raises ``ConnectionRefusedError``
        (transient and counted by the breaker, as a real refused connect)
        where ``peer`` is chaos-dead."""
        with self._lock:
            left = self._kill_after.get(peer)
            if left is not None:
                if left <= 0:
                    self._partitioned.add(peer)
                else:
                    self._kill_after[peer] = left - 1
            dead = peer in self._partitioned
            if dead:
                self.trips.append((peer, "partition"))
        if dead:
            raise ConnectionRefusedError(
                f"peer {peer!r} chaos-partitioned")


_PEER_CHAOS_LOCK = threading.Lock()
_PEER_CHAOS: Optional[PeerChaos] = None


def set_peer_chaos(chaos: Optional[PeerChaos]) -> None:
    """Install (or with None clear) the process's peer-chaos hook."""
    global _PEER_CHAOS
    with _PEER_CHAOS_LOCK:
        _PEER_CHAOS = chaos


def peer_chaos() -> Optional[PeerChaos]:
    with _PEER_CHAOS_LOCK:
        return _PEER_CHAOS
