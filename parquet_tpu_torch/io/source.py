"""Byte sources the reader preads from: in-memory bytes and local paths.

The port's cut of ``parquet_tpu/io/source.py``: a :class:`Source` answers
``size()`` and ``pread(offset, size)``.  A path opens as a
:class:`MmapSource`, whose ``pread_view`` is a zero-copy view of the page
cache, and falls back to :class:`FileSource` (``os.pread``) where the file
cannot be mapped (an empty file, a FIFO).  Each of the two carries a
``stat_key``, ``(absolute path, inode, mtime_ns, size)`` from the fstat of
the descriptor it opened: the identity ``io/cache.py``'s caches key a file
by (in-memory bytes have none and are never cached).  Remote and
policy-wrapped sources belong to a later slice.
"""

from __future__ import annotations

import mmap as _mmap
import os

import numpy as np

from ..errors import CorruptedError


class Source:
    def size(self) -> int:
        raise NotImplementedError

    def pread(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _check_range(what: str, offset: int, size: int, total: int) -> None:
    if offset < 0 or size < 0 or offset + size > total:
        raise CorruptedError(
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
        _check_range(self.path, offset, size, self._size)
        parts = []
        while size:
            b = os.pread(self._fd, size, offset)
            if not b:
                raise CorruptedError(f"{self.path}: short read at {offset}")
            parts.append(b)
            offset += len(b)
            size -= len(b)
        return b"".join(parts)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class MmapSource(Source):
    """A memory-mapped local file, as the JAX package's ``MmapSource``:
    ``pread_view`` is a read-only zero-copy view of the page cache
    (``pread`` still returns bytes), and :meth:`madvise_willneed` starts
    the kernel's readahead of a range without a thread.  Views keep the
    map alive after :meth:`close`; callers copy what they keep, so no
    decoded column aliases the map."""

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
        finally:
            os.close(fd)  # the map holds the file
        self._view = memoryview(self._mm)

    def size(self) -> int:
        return self._size

    def _checked(self, offset: int, size: int) -> memoryview:
        if self._view is None:
            raise ValueError(f"read on the closed source {self.path!r}")
        _check_range(self.path, offset, size, self._size)
        return self._view[offset:offset + size]

    def pread(self, offset: int, size: int) -> bytes:
        return bytes(self._checked(offset, size))

    def pread_view(self, offset: int, size: int) -> np.ndarray:
        return np.frombuffer(self._checked(offset, size), np.uint8)

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

    def close(self) -> None:
        if self._view is None:
            return
        self._view = None
        mm, self._mm = self._mm, None
        try:
            mm.close()
        except BufferError:
            pass  # views still alive: unmapped when the last one dies


def as_source(source) -> Source:
    if isinstance(source, Source):
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        return BytesSource(source)
    if isinstance(source, (str, os.PathLike)):
        try:
            return MmapSource(source)
        except (OSError, ValueError):  # an empty file, a FIFO, no mmap
            return FileSource(source)
    raise TypeError(f"cannot read parquet from {type(source).__name__}: "
                    "pass bytes or a path")
