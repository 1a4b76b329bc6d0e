"""Chunk readahead for the device read: the port's cut of
``parquet_tpu/io/prefetch.py``.

:func:`make_chunk_prefetcher` wraps a memory-mapped file for the read's
whole-chunk preads with the advise backend alone: the pipeline plans every
chunk's byte range up front, :class:`AdvisePrefetcher` asks the kernel
(``madvise(WILLNEED)``) to read ``depth`` windows ahead of each plan's
frontier, and serves each pread as a zero-copy view of the map, so the
disk's readahead of later chunks runs under the prescan and staging of
earlier ones without a thread.  The ring backend (window preads on a pool)
and the other prefetch modes belong to a later slice.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from .source import MmapSource, Source

DEPTH = 4  # windows kept advised ahead of each plan's frontier
WINDOW_BYTES = 8 << 20


class _Plan:
    __slots__ = ("start", "end", "advised")

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end
        self.advised = start  # advised up to here


class AdvisePrefetcher(Source):
    """Readahead over an :class:`MmapSource` by ``madvise(WILLNEED)``.
    Callers declare upcoming ranges with :meth:`plan`; each read advances
    the horizon of the plan that covers it.  It does not own the inner
    source: :meth:`close` drops the plans and leaves the file open."""

    def __init__(self, inner: MmapSource, depth: int = DEPTH,
                 window_bytes: int = WINDOW_BYTES):
        self.inner = inner
        self.depth = depth
        self.window_bytes = window_bytes
        self._plans: List[_Plan] = []
        self._lock = threading.Lock()  # workers read through one wrapper

    @property
    def path(self):
        return self.inner.path

    def size(self) -> int:
        return self.inner.size()

    def plan(self, offset: int, size: int) -> None:
        """Declare an upcoming read of ``[offset, offset + size)``."""
        if size <= 0:
            return
        with self._lock:
            p = _Plan(offset, offset + size)
            self._plans.append(p)
            self._advise(p, offset)

    def plan_many(self, ranges) -> None:
        """:meth:`plan` each ``(offset, size)`` of ``ranges``."""
        for offset, size in ranges:
            self.plan(offset, size)

    def _advise(self, p: _Plan, frontier: int) -> None:
        ahead = min(frontier + self.depth * self.window_bytes, p.end)
        if ahead > p.advised:
            self.inner.madvise_willneed(p.advised, ahead - p.advised)
            p.advised = ahead

    def _serve(self, offset: int, size: int) -> None:
        end = offset + size
        with self._lock:
            for p in self._plans:
                if p.start <= offset and end <= p.end:
                    self._advise(p, end)
                    break

    def pread(self, offset: int, size: int) -> bytes:
        self._serve(offset, size)
        return self.inner.pread(offset, size)

    def pread_view(self, offset: int, size: int) -> np.ndarray:
        self._serve(offset, size)
        return self.inner.pread_view(offset, size)

    def close(self) -> None:
        with self._lock:
            self._plans.clear()


def make_chunk_prefetcher(source: Source) -> Optional[AdvisePrefetcher]:
    """The advise-backed prefetcher of a memory-mapped ``source``, or None
    for any other source (in-memory bytes have no disk latency to hide).
    The JAX package's ``n_streams`` sizes its ring backend, which this cut
    does not have."""
    if isinstance(source, MmapSource):
        return AdvisePrefetcher(source)
    return None
