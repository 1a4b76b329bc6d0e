"""Durable write sinks: the write-side counterpart of ``source.py``.

The port's copy of ``parquet_tpu/io/sink.py``.  A writer that opened its
destination directly leaves a torn file there when it dies mid-write, and
a ``close()`` that never fsyncs leaves a finished file the page cache can
still lose.  So:

- **Atomic commit** (:class:`AtomicFileSink`): bytes go to
  ``<dest>.<rand>.tmp`` in the destination's directory; ``close()``
  flushes and fsyncs the file, renames it over the destination and fsyncs
  the directory.  The destination either does not exist or holds a whole,
  footer-terminated file.
- **Abort** (:meth:`Sink.abort`): discard the write and remove the temp
  (or partial) file.
- **Coalescing** (:class:`BufferedSink`): page-sized writes gather by
  reference and go out as one vectored write (``os.writev`` where the
  inner sink has a raw descriptor) once ``PARQUET_TPU_TORCH_WRITE_BUFFER``
  bytes are pending; the buffer size adapts to the flushes per row group
  that earlier writers saw (:func:`write_autotune`).
- :class:`WriteStats` meters what a pipelined write did
  (``ParquetWriter.write_stats``).

``ParquetWriter`` commits every path it is given through an
:class:`AtomicFileSink`; ``WriterOptions(atomic_commit=False)`` writes the path in place through a
:class:`FileSink`, which still fsyncs and still removes its file on abort.
A :class:`BufferedSink`'s pending bytes are the ledger's ``write.buffer``
account, each flush a ``sink.flush`` span, and a writer's
:class:`WriteStats` reach the registry once (:meth:`WriteStats.publish`).
Not in this port: the JAX package's opt-in memory-mapped sink and the
switch that selects it (``write.mmap_commits`` stays 0).
"""

from __future__ import annotations

import os
import secrets
import threading
from dataclasses import dataclass
from typing import List, Optional

from ..errors import WriteError
from ..obs import trace as _trace
from ..obs.ledger import ledger_account, maybe_check_pressure
from ..obs.metrics import counter as _counter
from ..obs.scope import account as _account
from ..utils.env import env_bool, env_opt_bytes

__all__ = ["Sink", "FileSink", "AtomicFileSink",
           "BufferedSink", "WriteStats", "fsync_dir",
           "write_buffer_bytes", "write_autotune", "write_autotune_enabled"]

# the ledger's account of the bytes coalescing in BufferedSinks: added as
# pages buffer, released as a flush hands them to the file system (or an
# abort drops them); its capacity is the live writeback knob
_ACC_WBUF = ledger_account("write.buffer",
                           capacity=lambda: write_buffer_bytes())

# the writeback buffer's default: page-sized writes coalesce into a few
# flushes a row group, and the buffer stays cache-resident
DEFAULT_WRITE_BUFFER = 4 << 20

_HAS_WRITEV = hasattr(os, "writev")
try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, OSError, ValueError):
    _IOV_MAX = 1024


@dataclass
class WriteStats:
    """What a pipelined write did (``ParquetWriter.write_stats``).

    ``encode_s`` sums the chunks' encode walls (wherever they ran),
    ``emit_s`` the serial offset assignment and sink writes, and
    ``pool_wait_s`` the time emit waited for a background encode that had
    not finished: about 0 when encode hid fully behind the previous
    group's emit.  ``bytes_buffered`` counts bytes gathered in a
    :class:`BufferedSink`, ``bytes_flushed`` the bytes handed on toward
    the OS (a path sink's file size), ``sink_flushes`` the coalesced
    flushes that carried them and ``writev_flushes`` those of them that
    went through ``os.writev``."""

    row_groups: int = 0
    overlapped_groups: int = 0
    encode_s: float = 0.0
    emit_s: float = 0.0
    pool_wait_s: float = 0.0
    bytes_buffered: int = 0
    bytes_flushed: int = 0
    sink_flushes: int = 0
    writev_flushes: int = 0

    def overlap_ratio(self) -> float:
        """The share of background encode time that emit did not wait
        for: 1.0 when encode hid fully behind emit, 0.0 for a serial
        write."""
        if not self.overlapped_groups or self.encode_s <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.pool_wait_s / self.encode_s))

    def publish(self) -> None:
        """Add this writer's totals to the registry and the current op,
        once (the writer's close calls it; a second call adds nothing)."""
        if getattr(self, "_published", False):
            return
        self._published = True
        _account(_counter("write.row_groups"), self.row_groups)
        _account(_counter("write.overlapped_groups"), self.overlapped_groups)
        _account(_counter("write.encode_s"), self.encode_s)
        _account(_counter("write.emit_s"), self.emit_s)
        _account(_counter("write.pool_wait_s"), self.pool_wait_s)
        _account(_counter("write.bytes_buffered"), self.bytes_buffered)
        _account(_counter("write.bytes_flushed"), self.bytes_flushed)
        _account(_counter("write.sink_flushes"), self.sink_flushes)
        _account(_counter("write.writev_flushes"), self.writev_flushes)

    def as_dict(self) -> dict:
        return {"row_groups": self.row_groups,
                "overlapped_groups": self.overlapped_groups,
                "encode_s": round(self.encode_s, 4),
                "emit_s": round(self.emit_s, 4),
                "pool_wait_s": round(self.pool_wait_s, 4),
                "overlap_ratio": round(self.overlap_ratio(), 4),
                "bytes_buffered": self.bytes_buffered,
                "bytes_flushed": self.bytes_flushed,
                "sink_flushes": self.sink_flushes,
                "writev_flushes": self.writev_flushes}


# the write auto-tuner: a writer that still needed many coalesced flushes
# a row group had a buffer too small for its pages, so the next writer's
# buffer doubles; one whose groups fit a flush or two steps back down
_WRITE_TUNE_RAISE_FLUSHES_PER_RG = 8.0
_WRITE_TUNE_DECAY_FLUSHES_PER_RG = 1.5
_WRITE_TUNE_MAX_BUFFER = 64 << 20


def write_autotune_enabled() -> bool:
    """``PARQUET_TPU_TORCH_WRITE_AUTOTUNE`` (default on)."""
    return env_bool("PARQUET_TPU_TORCH_WRITE_AUTOTUNE")


class _WriteAutoTuneState:
    """Process-wide feedback from a closed writer's :class:`WriteStats`
    to the next writer's writeback buffer.  A pinned
    ``PARQUET_TPU_TORCH_WRITE_BUFFER`` or
    ``PARQUET_TPU_TORCH_WRITE_AUTOTUNE=0`` bypasses it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.buffer = None  # None: the default

    def suggest(self):
        with self._lock:
            return self.buffer

    def observe(self, stats: WriteStats) -> None:
        if stats.row_groups <= 0 or stats.bytes_buffered <= 0:
            return  # a pass-through writer says nothing
        per_rg = stats.sink_flushes / stats.row_groups
        with self._lock:
            b = self.buffer or DEFAULT_WRITE_BUFFER
            if per_rg > _WRITE_TUNE_RAISE_FLUSHES_PER_RG \
                    and b < _WRITE_TUNE_MAX_BUFFER:
                self.buffer = b * 2
            elif per_rg < _WRITE_TUNE_DECAY_FLUSHES_PER_RG \
                    and b > DEFAULT_WRITE_BUFFER:
                b //= 2
                self.buffer = None if b <= DEFAULT_WRITE_BUFFER else b

    def reset(self) -> None:
        with self._lock:
            self.buffer = None


_WRITE_AUTOTUNE = _WriteAutoTuneState()


def write_autotune() -> _WriteAutoTuneState:
    """The process-wide write auto-tune state (tests reset it)."""
    return _WRITE_AUTOTUNE


def _env_write_buffer() -> Optional[int]:
    """``PARQUET_TPU_TORCH_WRITE_BUFFER`` as a pin, or None where it is
    unset or does not parse: the one reading both the size and the
    auto-tuner's eligibility use."""
    return env_opt_bytes("PARQUET_TPU_TORCH_WRITE_BUFFER")


def write_buffer_bytes() -> int:
    """The writeback buffer's size: ``PARQUET_TPU_TORCH_WRITE_BUFFER``
    (bytes; ``0`` turns coalescing off) where set, else the auto-tuned
    size, else 4 MiB."""
    pinned = _env_write_buffer()
    if pinned is not None:
        return pinned
    if write_autotune_enabled():
        tuned = _WRITE_AUTOTUNE.suggest()
        if tuned:
            return tuned
    return DEFAULT_WRITE_BUFFER


class Sink:
    """What the writer writes to.  Any binary file object (``write``,
    ``writelines``, ``flush``, ``close``) does too; ``abort`` is what
    makes a sink crash-safe."""

    def write(self, data) -> int:
        raise NotImplementedError

    def writelines(self, parts) -> None:
        for p in parts:
            self.write(p)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        """Commit: every written byte durable at the destination."""
        raise NotImplementedError

    def abort(self) -> None:
        """Discard: release the resources, leave no (partial) file."""
        raise NotImplementedError


def fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``, so that an entry just made
    or renamed there survives a power loss.  Best effort where a
    directory cannot be opened or synced (the rename already happened;
    only its durability is at stake)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, getattr(os, "O_DIRECTORY", os.O_RDONLY))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _invalidate_dest(path) -> None:
    """Drop the caches' footers, pages and memos of a destination just
    written: they key a file by its fstat, which a rewrite in place of the
    same size within one tick of the clock keeps."""
    from .cache import invalidate_path

    invalidate_path(path)


def _flushed_fileno(f):
    """Flush a file object's Python buffer and return its descriptor
    (None when closed)."""
    if f is None:
        return None
    f.flush()
    return f.fileno()


def _temp_path(dest: str) -> str:
    # in the destination's directory: rename(2) is atomic only within one
    # file system
    return f"{dest}.{secrets.token_hex(6)}.tmp"


def _unlink_quietly(path: str) -> None:
    """Best effort: abort runs inside an exception handler, and an unlink
    failure must not mask the error being handled."""
    try:
        os.unlink(path)
    except OSError:
        pass


def _close_quietly(f) -> None:
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


class FileSink(Sink):
    """Writes the destination in place: no atomicity, but an fsync at
    close and an unlink of the partial file on abort.  The writer's
    ``atomic_commit=False`` mode (a directory where siblings cannot be
    made, or a commit another party owns)."""

    def __init__(self, path, fsync: bool = True):
        self.path = os.fspath(path)
        self.fsync = fsync
        self._f = open(self.path, "wb")

    def write(self, data) -> int:
        return self._f.write(data)

    def writelines(self, parts) -> None:
        self._f.writelines(parts)

    def flush(self) -> None:
        self._f.flush()

    def raw_fd(self):
        """The descriptor for :class:`BufferedSink`'s vectored writes,
        after the Python buffer is flushed (so bytes keep their order);
        None when closed."""
        return _flushed_fileno(self._f)

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        try:
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        except BaseException:
            _close_quietly(f)  # a failed flush must not leak the fd
            raise
        f.close()
        _invalidate_dest(self.path)

    def abort(self) -> None:
        f, self._f = self._f, None
        _close_quietly(f)
        _unlink_quietly(self.path)


class AtomicFileSink(Sink):
    """All or nothing: bytes go to ``<dest>.<rand>.tmp`` beside the
    destination, and ``close()`` flushes, fsyncs the file, renames it over
    ``dest`` and fsyncs the directory.  Until then the destination is
    untouched; a crash at any byte leaves at most a stray ``*.tmp``.
    ``abort()`` removes the temp file and is idempotent; a close after an
    abort raises (there is nothing to commit)."""

    def __init__(self, dest, fsync: bool = True):
        self.dest = os.fspath(dest)
        self.fsync = fsync
        self.committed = False
        self.temp_path: Optional[str] = _temp_path(self.dest)
        self._f = open(self.temp_path, "wb")

    def _open(self):
        if self._f is None:
            raise ValueError(f"write on closed sink for {self.dest!r}")
        return self._f

    def write(self, data) -> int:
        return self._open().write(data)

    def writelines(self, parts) -> None:
        self._open().writelines(parts)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def raw_fd(self):
        """The temp file's descriptor (see :meth:`FileSink.raw_fd`); None
        when closed or committed."""
        return _flushed_fileno(self._f)

    def close(self) -> None:
        """Commit.  A failure on the way removes the temp file and raises
        (an ``OSError`` as a :class:`WriteError` naming both paths): the
        destination is never touched by a failed commit."""
        if self.committed:
            return
        if self._f is None:
            raise ValueError(
                f"commit after abort for {self.dest!r} (nothing to commit)")
        tp = self.temp_path
        f, self._f = self._f, None
        try:
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            f.close()
            os.replace(tp, self.dest)
        except BaseException as e:
            _close_quietly(f)
            _unlink_quietly(tp)
            self.temp_path = None
            if isinstance(e, OSError):
                raise WriteError(f"atomic commit failed: {e}",
                                 path=self.dest, temp_path=tp) from e
            raise
        self.temp_path = None
        self.committed = True
        if self.fsync:
            # the rename is durable only once the directory entry is:
            # without this a crash can bring the old destination back
            fsync_dir(self.dest)
        _invalidate_dest(self.dest)

    def abort(self) -> None:
        f, self._f = self._f, None
        _close_quietly(f)
        tp, self.temp_path = self.temp_path, None
        if tp is not None and not self.committed:
            _unlink_quietly(tp)


def _writev_all(fd, parts) -> None:
    """Write every part to ``fd`` with ``os.writev``, one call per
    ``IOV_MAX`` parts, resuming a short write in the middle of a part
    until every byte is down."""
    queue = [memoryview(p) for p in parts if len(p)]
    i = 0
    while i < len(queue):
        batch = queue[i:i + _IOV_MAX]
        written = os.writev(fd, batch)
        if written <= 0:
            raise OSError(f"writev wrote {written} of "
                          f"{sum(len(m) for m in batch)} bytes")
        for mv in batch:
            n = len(mv)
            if written >= n:
                written -= n
                i += 1
            else:
                queue[i] = mv[written:]
                break


class BufferedSink(Sink):
    """Coalescing writeback over any sink: writes gather by reference (no
    join copy) and go to the inner sink as one vectored write once
    ``buffer_bytes`` are pending: ``os.writev`` where the inner sink has
    ``raw_fd()`` (:class:`FileSink`, :class:`AtomicFileSink`), else its
    ``writelines``.

    ``buffer_bytes=0`` passes every write straight through, counted; the
    default is :func:`write_buffer_bytes`.  ``flush()`` and ``close()``
    drain the buffer first, so the inner sink's commit covers every byte
    taken; ``abort()`` drops the buffer and aborts the inner sink.  Parts
    are kept by reference: a caller must not change a buffer after writing
    it (the writer writes only ``bytes``).  ``stats`` (a
    :class:`WriteStats`) counts the bytes buffered and flushed and the
    flushes."""

    def __init__(self, inner: Sink, buffer_bytes: Optional[int] = None,
                 stats: Optional[WriteStats] = None):
        self.inner = inner
        self.buffer_bytes = (write_buffer_bytes() if buffer_bytes is None
                             else max(0, int(buffer_bytes)))
        self.stats = stats
        # the writer feeds this sink's stats to the auto-tuner only where
        # the size came from the tuner's own resolution (no argument, no
        # pinned knob)
        self._tunable = (buffer_bytes is None and write_autotune_enabled()
                         and _env_write_buffer() is None)
        self._parts: List[bytes] = []
        self._buffered = 0

    def write(self, data) -> int:
        n = len(data)
        if self.buffer_bytes <= 0:
            self.inner.write(data)
            if self.stats is not None:
                self.stats.bytes_flushed += n
            return n
        self._parts.append(data)
        self._buffered += n
        _ACC_WBUF.add(n)
        if self.stats is not None:
            self.stats.bytes_buffered += n
        if self._buffered >= self.buffer_bytes:
            self._flush_buffer()
        else:
            # a growth site: the buffer can cross a watermark between
            # flushes
            maybe_check_pressure()
        return n

    def writelines(self, parts) -> None:
        if self.buffer_bytes <= 0:
            parts = list(parts)
            n = sum(len(p) for p in parts)
            self.inner.writelines(parts)
            if self.stats is not None:
                self.stats.bytes_flushed += n
            return
        for p in parts:
            self._parts.append(p)
            self._buffered += len(p)
            _ACC_WBUF.add(len(p))
            if self.stats is not None:
                self.stats.bytes_buffered += len(p)
        if self._buffered >= self.buffer_bytes:
            self._flush_buffer()
        else:
            maybe_check_pressure()

    def _flush_buffer(self) -> None:
        if not self._parts:
            return
        if _trace.TRACE_ENABLED:
            with _trace.span("sink.flush", bytes=self._buffered,
                             parts=len(self._parts)):
                self._flush_buffer_impl()
        else:
            self._flush_buffer_impl()

    def _flush_buffer_impl(self) -> None:
        # hand the parts over before writing: a failed flush is never
        # replayed (a prefix may be down; the writer aborts on any write
        # error, and a retry would write that prefix twice)
        parts, self._parts = self._parts, []
        n, self._buffered = self._buffered, 0
        _ACC_WBUF.sub(n)  # a failed flush's bytes are dropped, not kept
        fd = None
        if _HAS_WRITEV:
            raw = getattr(self.inner, "raw_fd", None)
            if raw is not None:
                fd = raw()
        if fd is not None:
            _writev_all(fd, parts)
            if self.stats is not None:
                self.stats.writev_flushes += 1
        else:
            self.inner.writelines(parts)
        if self.stats is not None:
            self.stats.bytes_flushed += n
            self.stats.sink_flushes += 1

    def flush(self) -> None:
        self._flush_buffer()
        self.inner.flush()

    def close(self) -> None:
        self._flush_buffer()
        self.inner.close()

    def abort(self) -> None:
        self._parts = []
        _ACC_WBUF.sub(self._buffered)
        self._buffered = 0
        ab = getattr(self.inner, "abort", None)
        if ab is not None:
            ab()
        else:
            _close_quietly(self.inner)
