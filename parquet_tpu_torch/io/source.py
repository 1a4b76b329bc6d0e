"""Byte sources the reader preads from: in-memory bytes and local paths.

The port's cut of ``parquet_tpu/io/source.py``: a :class:`Source` answers
``size()`` and ``pread(offset, size)``.  A path opens as a
:class:`MmapSource`, whose ``pread_view`` is a zero-copy view of the page
cache, and falls back to :class:`FileSource` (``os.pread``) where the file
cannot be mapped (an empty file, a FIFO).  Each of the two carries a
``stat_key``, ``(absolute path, inode, mtime_ns, size)`` from the fstat of
the descriptor it opened: the identity ``io/cache.py``'s caches key a file
by (in-memory bytes have none and are never cached).
``PARQUET_TPU_TORCH_MMAP=0`` opens a path as a :class:`FileSource`, and
``PARQUET_TPU_TORCH_MMAP_DROPBEHIND=1`` turns on the drop-behind hints of
a streamed drain (:func:`dropbehind_enabled`).  A
seekable file object opens as a :class:`FileLikeSource`;
:class:`RetryingSource` retries a bare source's transient errors
(``io/faults.py`` holds the policy-wide wrapper).  An ``http(s)://`` URL
opens as ``io/remote.py``'s ``HttpSource`` and an ``s3://`` URL as its
``ObjectStoreSource``; :class:`PreloadedSource` serves ranges fetched
ahead (a remote aggregate's) from memory.
"""

from __future__ import annotations

import io
import mmap as _mmap
import os
import threading

import numpy as np

from ..errors import CorruptedError, ShortReadError
from ..obs.scope import account_bytes as _account_bytes
from ..utils.env import env_bool, env_int


class Source:
    def size(self) -> int:
        raise NotImplementedError

    def pread(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _check_range(what: str, offset: int, size: int, total: int) -> None:
    if offset < 0 or size < 0:
        raise CorruptedError(
            f"{what}: read of [{offset}, {offset + size}): negative offset "
            "or size")
    if offset + size > total:
        raise ShortReadError(
            f"{what}: read of [{offset}, {offset + size}) past the end of a "
            f"{total}-byte source")


def _stat_key(path: str, st: os.stat_result) -> tuple:
    """The bytes' identity for the caches: the inode tells a file renamed
    over this path from the one it replaced, even at the same size within
    one tick of the clock."""
    return (os.path.abspath(path), st.st_ino, st.st_mtime_ns, st.st_size)


class BytesSource(Source):
    def __init__(self, data):
        self._data = bytes(data)

    def size(self) -> int:
        return len(self._data)

    def pread(self, offset: int, size: int) -> bytes:
        _check_range("buffer", offset, size, len(self._data))
        _account_bytes(size)
        return self._data[offset:offset + size]


class FileSource(Source):
    def __init__(self, path):
        self.path = os.fspath(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        st = os.fstat(self._fd)
        self._size = st.st_size
        self.stat_key = _stat_key(self.path, st)

    def size(self) -> int:
        return self._size

    def pread(self, offset: int, size: int) -> bytes:
        if self._fd < 0:
            raise ValueError(f"read on closed source {self.path!r}")
        _check_range(self.path, offset, size, self._size)
        parts = []
        while size:
            b = os.pread(self._fd, size, offset)
            if not b:
                raise ShortReadError(f"{self.path}: short read at {offset}")
            parts.append(b)
            offset += len(b)
            size -= len(b)
        out = b"".join(parts)
        _account_bytes(len(out))
        return out

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class MmapSource(Source):
    """A memory-mapped local file, as the JAX package's ``MmapSource``:
    ``pread_view`` is a read-only zero-copy view of the page cache
    (``pread`` still returns bytes), :meth:`madvise_willneed` starts the
    kernel's readahead of a range without a thread, and
    :meth:`madvise_sequential` and :meth:`madvise_dontneed` are the
    drop-behind mode's hints (:func:`dropbehind_enabled`).  Views keep the
    map alive after :meth:`close`; callers copy what they keep, so no
    decoded column aliases the map.

    Releasing page-cache residency takes ``posix_fadvise(DONTNEED)`` on a
    descriptor: ``madvise(MADV_DONTNEED)`` on a shared file mapping drops
    only this process's page tables.  The descriptor the map was made from
    is kept while the drop-behind mode is on at open, else closed and
    opened again at the first hint that needs one."""

    def __init__(self, path):
        self.path = os.fspath(path)
        fd = os.open(self.path, os.O_RDONLY)
        try:
            st = os.fstat(fd)
            self._size = st.st_size
            self.stat_key = _stat_key(self.path, st)
            if self._size == 0:
                raise ValueError(f"cannot map the empty file {self.path!r}")
            self._mm = _mmap.mmap(fd, self._size, prot=_mmap.PROT_READ)
        except BaseException:
            os.close(fd)
            raise
        if dropbehind_enabled():
            self._fd = fd
        else:
            self._fd = None
            os.close(fd)  # the map holds the file
        self._fd_lock = threading.Lock()
        self._view = memoryview(self._mm)

    def _fadvise_fd(self):
        """The descriptor the drop-behind hints go to, opened at first use
        where the mode was off at open (None once closed or where it
        cannot be opened)."""
        with self._fd_lock:
            if self._fd is None and self._view is not None:
                try:
                    self._fd = os.open(self.path, os.O_RDONLY)
                except OSError:
                    return None
            return self._fd

    def size(self) -> int:
        return self._size

    def _checked(self, offset: int, size: int) -> memoryview:
        if self._view is None:
            raise ValueError(f"read on the closed source {self.path!r}")
        _check_range(self.path, offset, size, self._size)
        return self._view[offset:offset + size]

    def pread(self, offset: int, size: int) -> bytes:
        out = bytes(self._checked(offset, size))
        _account_bytes(size)
        return out

    def pread_view(self, offset: int, size: int) -> np.ndarray:
        out = np.frombuffer(self._checked(offset, size), np.uint8)
        _account_bytes(size)
        return out

    def madvise_willneed(self, offset: int, size: int) -> None:
        """Ask the kernel to read ``[offset, offset + size)`` ahead (best
        effort: errors are ignored)."""
        if self._mm is None or size <= 0:
            return
        lo = offset // _mmap.PAGESIZE * _mmap.PAGESIZE
        hi = min(self._size, offset + size)
        try:
            self._mm.madvise(_mmap.MADV_WILLNEED, lo, hi - lo)
        except (OSError, ValueError, AttributeError):
            pass

    def madvise_sequential(self) -> None:
        """Declare the file read sequentially, to the map (``madvise``)
        and to the descriptor (``posix_fadvise``): the kernel reads
        further ahead and recycles the pages behind the reader sooner.
        Best effort; a closed source ignores it."""
        mm = self._mm
        if mm is None:
            return
        try:
            mm.madvise(_mmap.MADV_SEQUENTIAL)
        except (OSError, ValueError, AttributeError):
            pass
        fd = self._fadvise_fd()
        if fd is not None:
            try:
                os.posix_fadvise(fd, 0, self._size, os.POSIX_FADV_SEQUENTIAL)
            except (OSError, AttributeError):
                pass

    def madvise_dontneed(self, offset: int, size: int) -> int:
        """Release the page cache of the pages wholly inside ``[offset,
        offset + size)`` (rounded inward, so a page read only in part
        stays): the map's page tables first (``madvise``; the kernel keeps
        a page still mapped), then the cache (``posix_fadvise``).  Returns
        the bytes released, 0 where it could not.  Views handed out stay
        valid: their pages fault in again from the file."""
        mm = self._mm
        if mm is None or size <= 0:
            return 0
        page = _mmap.PAGESIZE
        lo = -(-offset // page) * page
        hi = min(self._size, (offset + size) // page * page)
        if hi <= lo:
            return 0
        try:
            mm.madvise(_mmap.MADV_DONTNEED, lo, hi - lo)
        except (OSError, ValueError, AttributeError):
            pass
        fd = self._fadvise_fd()
        if fd is None:
            return 0
        try:
            os.posix_fadvise(fd, lo, hi - lo, os.POSIX_FADV_DONTNEED)
        except (OSError, AttributeError):
            return 0
        return hi - lo

    def close(self) -> None:
        if self._view is None:
            return
        self._view = None
        mm, self._mm = self._mm, None
        with self._fd_lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)
        try:
            mm.close()
        except BufferError:
            pass  # views still alive: unmapped when the last one dies


def dropbehind_enabled() -> bool:
    """``PARQUET_TPU_TORCH_MMAP_DROPBEHIND=1``: a streamed drain over a
    mapped file advises sequential access and releases the page cache it
    has consumed, behind its frontier and at its end, so a one-shot bulk
    drain passes through the cache without evicting what other reads keep
    hot.  Off by default: a workload that reads the file again loses its
    warm cache."""
    return env_bool("PARQUET_TPU_TORCH_MMAP_DROPBEHIND")


class FileLikeSource(Source):
    """A seekable file object; each seek and read pair runs under a lock
    (the prefetcher, the scans and the staging workers pread at once)."""

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()
        f.seek(0, io.SEEK_END)
        self._size = f.tell()

    def size(self) -> int:
        return self._size

    def pread(self, offset: int, size: int) -> bytes:
        with self._lock:
            f = self._f
            if f is None:
                raise ValueError("read on closed source")
            f.seek(offset)
            out = f.read(size)
        if len(out) != size:
            raise ShortReadError(f"short read at {offset}")
        _account_bytes(size)
        return out

    def close(self) -> None:
        with self._lock:  # an in-flight pread ends before the file closes
            f, self._f = self._f, None
            if f is not None:
                f.close()


class PreloadedSource(Source):
    """Preads served from byte ranges fetched before, falling through to
    ``inner`` outside them: the remote aggregate fetches its disjoint
    ranges at once (``io/remote.py::parallel_preads``), then decodes
    through this.  It has no ``stat_key``: never cached."""

    def __init__(self, inner: Source, blocks):
        self.inner = inner
        self._blocks = sorted(blocks, key=lambda b: b[0])  # (offset, bytes)
        self._starts = [b[0] for b in self._blocks]

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    def pread(self, offset: int, size: int) -> bytes:
        from bisect import bisect_right

        if offset < 0 or size < 0:
            raise CorruptedError(f"invalid read: offset={offset} "
                                 f"size={size}")
        i = bisect_right(self._starts, offset) - 1
        if i >= 0:
            b0, data = self._blocks[i]
            if offset + size <= b0 + len(data):
                return bytes(data[offset - b0:offset - b0 + size])
        return self.inner.pread(offset, size)

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        self._blocks = []
        self._starts = []


class RetryingSource(Source):
    """Bounded retries of a bare source's transient ``OSError`` errors, with
    jittered exponential backoff; a short read is corruption and raises at
    once.  The loop is ``io/faults.py::retry_call``, the one
    :class:`~parquet_tpu_torch.io.faults.PolicySource` runs; a read that
    wants a deadline and degraded reads takes a ``FaultPolicy``."""

    def __init__(self, inner: Source, retries: int = 3,
                 backoff_s: float = 0.05, jitter: float = 0.25):
        self.inner = inner
        self.retries = retries
        self.backoff_s = backoff_s
        self.jitter = jitter
        self._policy = None  # built at first use: faults imports us

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    def _retry(self, fn, offset: int, size: int):
        from ..obs.scope import account
        from .faults import _M_RETRIES, FaultPolicy, retry_call

        if self._policy is None:
            self._policy = FaultPolicy(max_retries=self.retries,
                                       backoff_s=self.backoff_s,
                                       jitter=self.jitter)
        # the retries land in read.retries and the op's report, as a
        # PolicySource's do
        return retry_call(fn, offset, size, self._policy,
                          on_retry=lambda: account(_M_RETRIES))

    def pread(self, offset: int, size: int) -> bytes:
        return self._retry(self.inner.pread, offset, size)

    def pread_view(self, offset: int, size: int):
        # the inner zero-copy view, retried
        return self._retry(getattr(self.inner, "pread_view",
                                   self.inner.pread), offset, size)

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        self.inner.close()


def as_source(source) -> Source:
    """``source`` as a :class:`Source`: a Source as it is, in-memory bytes
    as a :class:`BytesSource`, a path mapped (:class:`MmapSource`; a
    :class:`FileSource` where it cannot be mapped or where
    ``PARQUET_TPU_TORCH_MMAP=0``), a seekable file object as a
    :class:`FileLikeSource`, an ``http(s)://`` URL as an ``HttpSource``
    and an ``s3://`` URL as an ``ObjectStoreSource`` (``io/remote.py``)."""
    if isinstance(source, Source):
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        return BytesSource(source)
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if path.startswith(("http://", "https://")):
            from .remote import HttpSource  # deferred: remote imports us

            return HttpSource(path)
        if path.startswith("s3://"):
            from .remote import ObjectStoreSource, resolve_s3_url

            return ObjectStoreSource(resolve_s3_url(path))
        if env_int("PARQUET_TPU_TORCH_MMAP"):
            try:
                return MmapSource(source)
            except (OSError, ValueError):  # an empty file, a FIFO, no mmap
                pass
        return FileSource(source)
    if hasattr(source, "read") and hasattr(source, "seek"):
        return FileLikeSource(source)
    raise TypeError(f"cannot read parquet from {type(source).__name__}: "
                    "pass bytes, a path or a seekable file object")
