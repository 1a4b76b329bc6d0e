"""numpy faces of the host C++ of ``csrc/host_codec.cpp``.

The Snappy raw format both ways, and the byte-array scans of the read and
write paths: PLAIN BYTE_ARRAY pages to ``(values, offsets)`` and back,
unsigned lexicographic min/max, first-seen dictionaries and the common
prefixes of front coding.  The library builds with the system ``c++`` at
first use (``ops/_build.py``).  Sizes and bounds are checked here before
a pointer reaches C++, and the C++ checks what only a scan can see.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from ..errors import CorruptedError
from . import _build


def _lib():
    return _build.load("host_codec")


def as_u8(data) -> np.ndarray:
    """A contiguous uint8 view of a bytes-like buffer (a copy only when it
    is not contiguous)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, np.uint8)


def _ptr(a: np.ndarray) -> Optional[int]:
    return a.ctypes.data if a.size else None


# ---------------------------------------------------------------------------
# Snappy
# ---------------------------------------------------------------------------


def snappy_compress(data) -> bytes:
    src = as_u8(data)
    lib = _lib()
    out = np.empty(lib.pq_snappy_max_compressed_length(len(src)), np.uint8)
    n = lib.pq_snappy_compress(_ptr(src), len(src), out.ctypes.data)
    return out[:n].tobytes()


def snappy_uncompress(data, uncompressed_size: int) -> np.ndarray:
    """Decode a raw Snappy stream that must declare exactly
    ``uncompressed_size`` bytes; a malformed or truncated stream raises
    :class:`CorruptedError`."""
    src = as_u8(data)
    out = np.empty(max(uncompressed_size, 1), np.uint8)
    if uncompressed_size < 0 or _lib().pq_snappy_uncompress(
            _ptr(src), len(src), out.ctypes.data, uncompressed_size):
        raise CorruptedError(
            f"malformed Snappy stream ({len(src)} bytes, expected "
            f"{uncompressed_size} bytes out)")
    return out[:uncompressed_size]


# ---------------------------------------------------------------------------
# the RLE/bit-packed hybrid (writer side)
# ---------------------------------------------------------------------------


def encode_rle(values: np.ndarray, bit_width: int, min_repeat: int) -> bytes:
    """The hybrid stream of ``values`` (no length prefix); see
    ``ops/ref.py::encode_rle``."""
    v = np.ascontiguousarray(values, np.int64)
    if not 0 <= bit_width <= 64:
        raise ValueError(f"bit width {bit_width} outside 0..64")
    out = np.empty(len(v) * (bit_width + 24) // 8 + 64, np.uint8)
    n = _lib().pq_encode_rle(_ptr(v), len(v), bit_width, min_repeat,
                             out.ctypes.data)
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# byte arrays
# ---------------------------------------------------------------------------


def plain_byte_arrays(pages: Sequence[Tuple[np.ndarray, int]]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """PLAIN BYTE_ARRAY page bodies ``[(bytes, count), ...]`` to one
    ``(values uint8, offsets int64[n + 1])`` pair, offsets rebased across
    the pages."""
    bufs = [as_u8(b) for b, _ in pages]
    counts = np.array([c for _, c in pages], np.int64)
    lens = np.array([len(b) for b in bufs], np.int64)
    if (counts < 0).any():
        raise CorruptedError("negative BYTE_ARRAY value count")
    offsets = np.empty(int(counts.sum()) + 1, np.int64)
    values = np.empty(max(int(lens.sum()), 1), np.uint8)
    ptrs = np.array([b.ctypes.data if len(b) else 0 for b in bufs], np.int64)
    got = _lib().pq_plain_ba_batch(_ptr(ptrs), _ptr(lens), _ptr(counts),
                                   len(bufs), offsets.ctypes.data,
                                   values.ctypes.data)
    if got < 0:
        raise CorruptedError(f"PLAIN BYTE_ARRAY page {-got - 1} of "
                             f"{len(bufs)} is truncated")
    return values[:got], offsets


def _check_offsets(values: np.ndarray, offsets: np.ndarray) -> None:
    if len(offsets) < 1 or (len(offsets) > 1 and (
            offsets[0] < 0 or offsets[-1] > len(values)
            or (np.diff(offsets) < 0).any())):
        raise ValueError("byte-array offsets out of order or past the "
                         "values")


def encode_plain_byte_arrays(values: np.ndarray,
                             offsets: np.ndarray) -> bytes:
    values = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    _check_offsets(values, offsets)
    n = len(offsets) - 1
    out = np.empty(int(offsets[-1] - offsets[0]) + 4 * n, np.uint8)
    if n:
        _lib().pq_encode_plain_ba(_ptr(values), offsets.ctypes.data, n,
                                  out.ctypes.data)
    return out.tobytes()


def minmax_byte_arrays(values: np.ndarray, offsets: np.ndarray, v0: int,
                       v1: int) -> Tuple[int, int]:
    """Indexes of the unsigned lexicographic min and max of values
    ``[v0, v1)`` (non-empty)."""
    values = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if not 0 <= v0 < v1 <= len(offsets) - 1:
        raise ValueError(f"value span [{v0}, {v1}) outside the column")
    mi, ma = ctypes.c_longlong(), ctypes.c_longlong()
    _lib().pq_minmax_ba(_ptr(values), offsets.ctypes.data, v0, v1,
                        ctypes.byref(mi), ctypes.byref(ma))
    return mi.value, ma.value


def dictionary_of_byte_arrays(values: np.ndarray, offsets: np.ndarray,
                              max_unique: int):
    """First-seen dictionary: ``(indices int64[n], first_rows int64[k])``,
    or None when there are more than ``max_unique`` distinct values."""
    values = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    _check_offsets(values, offsets)
    n = len(offsets) - 1
    indices = np.empty(max(n, 1), np.int64)
    first = np.empty(max(min(n, max_unique), 1), np.int64)
    k = _lib().pq_dict_build_ba(_ptr(values), offsets.ctypes.data, n,
                                max_unique, indices.ctypes.data,
                                first.ctypes.data)
    if k < 0:
        return None
    return indices[:n], first[:k]


def common_prefix_lengths(values: np.ndarray,
                          offsets: np.ndarray) -> np.ndarray:
    """For each value the length of the prefix it shares with the one
    before it (0 for the first)."""
    values = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    _check_offsets(values, offsets)
    n = len(offsets) - 1
    out = np.zeros(max(n, 1), np.int64)
    if n:
        _lib().pq_common_prefix_lens(_ptr(values), offsets.ctypes.data, n,
                                     out.ctypes.data)
    return out[:n]


def segment_ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated (a segmented iota)."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, np.int64)
    starts = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def gather_byte_arrays(values: np.ndarray, offsets: np.ndarray,
                       indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values ``indices`` of a ``(values, offsets)`` column, as a new
    ``(values, offsets int64)`` pair."""
    offsets = np.asarray(offsets, np.int64)
    indices = np.asarray(indices, np.int64)
    if len(indices) and (indices.min() < 0
                         or indices.max() >= len(offsets) - 1):
        raise ValueError("byte-array index out of range")
    lens = (offsets[1:] - offsets[:-1])[indices]
    out_offs = np.zeros(len(indices) + 1, np.int64)
    np.cumsum(lens, out=out_offs[1:])
    idx = np.repeat(offsets[:-1][indices], lens) + segment_ranges(lens)
    return np.asarray(values)[idx], out_offs

