"""numpy faces of the host C++ of ``csrc/host_codec.cpp`` and
``csrc/host_prescan.cpp``.

``host_codec``: the Snappy raw format both ways, and the byte-array scans
of the read and write paths: PLAIN BYTE_ARRAY pages to ``(values,
offsets)`` and back, unsigned lexicographic min/max, first-seen
dictionaries of byte arrays and of fixed-width values, and the common
prefixes of front coding.

``host_prescan``: the read path's prescan.  Each wrapper returns what the
Python version it replaces returns, and raises its
:class:`~parquet_tpu_torch.errors.CorruptedError`:

- :func:`scan_rle_runs`: ``ops/ref.py::scan_rle_runs``;
- :func:`count_present`: the values of a run table equal to a level;
- :func:`delta_prescan`: ``ops/device.py::delta_prescan``;
- :func:`decode_delta_binary_packed`: ``ops/ref.py``'s, for the length
  streams of the delta byte-array encodings;
- :func:`scan_page_headers`: ``io/reader.py::thrift_page_walk`` as one
  ``int64[npages, PG_NFIELDS]`` table, and :func:`scan_page_headers_partial`
  the same walk over a window of a streamed chunk, stopping at the first
  page the window cuts;
- :func:`decompress_pages`: every data page of a chunk in one call;
- :func:`chunk_plan`: every data page of a chunk decompressed and
  prescanned in one call, into the chunk-level tables of
  ``parallel/device_reader.py``'s plan (its plain version is
  ``device_reader._build_plan_python``);
- :func:`fill_batch`: a staging batch written in one threaded call;
- :func:`byte_array_parts`: a chunk's host byte-array pages compacted;
- :func:`gather_byte_arrays`: byte-array values at given indexes (the
  scans' survivors), whose plain version is
  :func:`gather_byte_arrays_numpy`.

The libraries build with the system ``c++`` at first use
(``ops/_build.py``).  Sizes and bounds are checked here before a pointer
reaches C++, and the C++ checks what only a scan can see.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..errors import MAX_PAGE_SIZE, CorruptedError
from ..format.enums import CompressionCodec
from . import _build


def _lib():
    return _build.load("host_codec")


def _prescan():
    return _build.load("host_prescan")


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


def dictionary_of_fixed(values: np.ndarray, max_unique: int):
    """First-seen dictionary of a 4- or 8-byte column compared by bit
    pattern (float -0.0 and 0.0, or two NaN payloads, stay distinct):
    ``(uniques in values.dtype, indices int64[n])``, or None when there are
    more than ``max_unique`` distinct values.  4-byte values widen through
    their int32 bit pattern."""
    values = np.ascontiguousarray(values).reshape(-1)
    width = values.dtype.itemsize
    if width not in (4, 8):
        raise ValueError(f"no fixed-width dictionary of {values.dtype}")
    keys = np.ascontiguousarray(values.view(f"<i{width}"), np.int64)
    n = len(keys)
    indices = np.empty(max(n, 1), np.int64)
    uniques = np.empty(max(min(n, max_unique), 1), np.int64)
    k = _lib().pq_dict_build_i64(_ptr(keys), n, max_unique,
                                 indices.ctypes.data, uniques.ctypes.data)
    if k < 0:
        return None
    uniq = uniques[:k].astype(f"<i{width}").view(values.dtype)
    return uniq, indices[:n]


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
    ``(uint8 values, int64 offsets)`` pair, in C++ (``pq_gather_ba``: a
    sizing pass, then the copy on up to 8 threads past 4 MiB).  An index
    outside the column raises ``ValueError``, as
    :func:`gather_byte_arrays_numpy`, its plain version, does."""
    vals = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    n = len(indices)
    out_offs = np.empty(n + 1, np.int64)
    lib = _prescan()
    total = lib.pq_gather_ba(_ptr(vals), len(vals), _ptr(offsets),
                             len(offsets), _ptr(indices), n,
                             out_offs.ctypes.data, None, 1)
    if total == -1:
        raise ValueError("byte-array index out of range")
    if total < 0:
        raise ValueError("byte-array offsets out of order or past the "
                         "values")
    out = np.empty(total, np.uint8)
    if total:
        lib.pq_gather_ba(_ptr(vals), len(vals), _ptr(offsets), len(offsets),
                         _ptr(indices), n, out_offs.ctypes.data,
                         out.ctypes.data, fill_threads(total))
    return out, out_offs


def gather_byte_arrays_numpy(values: np.ndarray, offsets: np.ndarray,
                             indices: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`gather_byte_arrays`, in numpy."""
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


def xxh64_batch(values: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """XXH64 (seed 0) of each value of a ``(values, offsets)`` byte-array
    column, the Parquet bloom hash, in C++ (``pq_xxh64_batch``); offsets
    that fall or leave the values raise ``ValueError``.  Its plain version
    is ``io/bloom.py::xxh64_bytes``."""
    vals = as_u8(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    out = np.empty(max(n, 0), np.uint64)
    if n <= 0:
        return out
    if _prescan().pq_xxh64_batch(_ptr(vals), len(vals), _ptr(offsets), n,
                                 out.ctypes.data) != 0:
        raise ValueError("byte-array offsets out of order or past the "
                         "values")
    return out


# ---------------------------------------------------------------------------
# the read path's prescan (csrc/host_prescan.cpp)
# ---------------------------------------------------------------------------

_E_ZERO_RUN, _E_TRUNCATED, _E_HEADER, _E_WIDTH, _E_CAPACITY = (
    -1, -2, -3, -4, -5)


def scan_rle_runs(data, num_values: int, bit_width: int, pos: int = 0):
    """The run table of a hybrid stream at ``pos``: ``(kinds u8 (0 = RLE,
    1 = bit-packed), counts i64, payloads i64, byte offsets i64, end)``;
    offsets and ``end`` index ``data``.  A zero-count run, or a header, RLE
    value or bit-packed payload past the stream, raises."""
    buf = as_u8(data)[pos:]
    if not 0 <= bit_width <= 64:
        raise CorruptedError(f"RLE hybrid bit width {bit_width} outside "
                             "0..64")
    cap = max(min(num_values, len(buf)), 1)  # a run takes >= 1 byte
    kinds = np.empty(cap, np.uint8)
    counts, payloads, offsets = (np.empty(cap, np.int64) for _ in range(3))
    end = np.zeros(1, np.int64)
    k = _prescan().pq_scan_rle_runs(
        _ptr(buf), len(buf), max(num_values, 0), bit_width,
        kinds.ctypes.data, counts.ctypes.data, payloads.ctypes.data,
        offsets.ctypes.data, end.ctypes.data)
    if k == _E_ZERO_RUN:
        raise CorruptedError("malformed RLE hybrid stream: zero-count run")
    if k < 0:
        raise CorruptedError("RLE hybrid stream truncated")
    offsets = offsets[:k]
    offsets += pos
    return kinds[:k], counts[:k], payloads[:k], offsets, int(end[0]) + pos


def count_present(body, kinds, counts, payloads, offsets, width: int,
                  target: int) -> int:
    """How many values of ``body``'s scanned run table (offsets into
    ``body``) equal ``target``: a page's present count, def ==
    max_def."""
    body = as_u8(body)
    kinds = np.ascontiguousarray(kinds, np.uint8)
    counts, payloads, offsets = (np.ascontiguousarray(a, np.int64)
                                 for a in (counts, payloads, offsets))
    if not len(kinds) == len(counts) == len(payloads) == len(offsets):
        raise ValueError("run table columns of different lengths")
    n = _prescan().pq_count_target_in_runs(
        _ptr(body), len(body), _ptr(kinds), _ptr(counts), _ptr(payloads),
        _ptr(offsets), len(kinds), width, target)
    if n < 0:
        raise CorruptedError("RLE hybrid stream truncated")
    return n


def delta_prescan(data, pos: int = 0):
    """The miniblock table of a DELTA_BINARY_PACKED stream at ``pos``:
    ``(first, total, vpm, mb_bit_offsets i64, mb_widths i32, mb_mins i64,
    end)``, offsets into ``data``.  The table is sized from the header's
    total and the bytes left (a header holds untrusted sizes)."""
    buf = as_u8(data)
    header = np.zeros(6, np.int64)

    def scan(cap: int):
        offs = np.empty(cap, np.int64)
        widths = np.empty(cap, np.int32)
        mins = np.empty(cap, np.int64)
        k = _prescan().pq_delta_prescan(
            _ptr(buf), len(buf), pos, cap, header.ctypes.data,
            offs.ctypes.data, widths.ctypes.data, mins.ctypes.data)
        return k, offs, widths, mins

    k, offs, widths, mins = scan(64)
    if k == _E_CAPACITY:
        # one row a counted miniblock, each with a width byte in the stream
        total, vpm = int(header[1]), int(header[2])
        k, offs, widths, mins = scan(
            min(-(-(total - 1) // vpm), len(buf) - pos) + 1)
    if k == _E_HEADER:
        raise CorruptedError(
            f"malformed DELTA_BINARY_PACKED header: block_size="
            f"{int(header[4])}, miniblocks={int(header[5])}")
    if k == _E_WIDTH:
        raise CorruptedError("DELTA_BINARY_PACKED miniblock bit width over "
                             "64")
    if k < 0:
        raise CorruptedError("DELTA_BINARY_PACKED stream truncated")
    return (int(header[0]), int(header[1]), int(header[2]), offs[:k],
            widths[:k], mins[:k], int(header[3]))


def length_count_message(count: int, page_values: int) -> str:
    return (f"delta length stream of {count} values in a page of "
            f"{page_values}")


def decode_delta_binary_packed(data, pos: int = 0,
                               max_values: Optional[int] = None
                               ) -> Tuple[np.ndarray, int]:
    """A DELTA_BINARY_PACKED stream to int64 values (mod-2^64 sums) and its
    end: the length streams of DELTA_LENGTH_BYTE_ARRAY and
    DELTA_BYTE_ARRAY pages, and the host route's delta pages.  A header
    that counts more than ``max_values`` values (a length stream holds
    one entry for each value of its page) raises before anything is
    sized from it."""
    buf = as_u8(data)
    first, total, vpm, offs, widths, mins, end = delta_prescan(buf, pos)
    if max_values is not None and total > max_values:
        raise CorruptedError(length_count_message(total, max_values))
    out = np.empty(max(total, 1), np.int64)
    if _prescan().pq_delta_decode(
            _ptr(buf), len(buf), first, total, vpm, _ptr(offs),
            _ptr(widths), _ptr(mins), len(offs), out.ctypes.data):
        raise CorruptedError("DELTA_BINARY_PACKED stream truncated")
    return out[:total], end


# columns of a page-header table row (csrc/host_prescan.cpp's PG_* enum);
# -1 where the header lacks the field
(PG_HEADER_POS, PG_DATA_POS, PG_TYPE, PG_COMP, PG_UNCOMP, PG_CRC, PG_NVALS,
 PG_ENC, PG_DEF_ENC, PG_REP_ENC, PG_RL_BYTES, PG_DL_BYTES, PG_NNULLS,
 PG_IS_COMPRESSED, PG_DICT_NVALS, PG_NROWS, PG_NFIELDS) = range(17)

_STOP_BAD_HEADER, _STOP_SIZE_RANGE, _STOP_TRUNCATED, _STOP_CAPACITY = (
    1, 2, 3, 4)
_BAD_HEADER = {1: "malformed thrift PageHeader", 2: "no page type",
               3: "a data page without num_values"}


def _header_table(b: np.ndarray, total_values: int,
                  max_pages: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """``pq_scan_page_headers`` over ``b``: the rows it read and its stop
    record ``(why, position, detail)``; without ``max_pages`` the table
    grows until the walk is not stopped by its capacity."""
    cap = max_pages if max_pages is not None else len(b) // 4096 + 16
    err = np.zeros(3, np.int64)
    while True:
        out = np.empty((max(cap, 1), PG_NFIELDS), np.int64)
        k = _prescan().pq_scan_page_headers(
            _ptr(b), len(b), total_values, MAX_PAGE_SIZE, out.ctypes.data,
            cap, err.ctypes.data)
        if err[0] != _STOP_CAPACITY or max_pages is not None:
            return out[:k], err
        cap *= 4


def scan_page_headers(buf, total_values: int = -1,
                      max_pages: Optional[int] = None,
                      base: int = 0) -> np.ndarray:
    """The page-header table of a page stream: one ``int64[PG_NFIELDS]``
    row a page (positions relative to ``buf``), walking while fewer than
    ``total_values`` data values were seen (negative: no limit), bytes
    remain and, with ``max_pages``, fewer rows were read.  A malformed
    header, a compressed size outside ``0..MAX_PAGE_SIZE`` or a payload
    past ``buf`` raises, naming the header's position plus ``base``.
    Page-header statistics are skipped."""
    rows, err = _header_table(as_u8(buf), total_values, max_pages)
    why, at = int(err[0]), base + int(err[1])
    if why == _STOP_BAD_HEADER:
        raise CorruptedError(f"bad page header at {at}: "
                             f"{_BAD_HEADER[int(err[2])]}")
    if why == _STOP_SIZE_RANGE:
        clen = None if err[2] == np.iinfo(np.int64).min else int(err[2])
        raise CorruptedError(f"page at {at}: compressed size {clen} out of "
                             "range")
    if why == _STOP_TRUNCATED:
        raise CorruptedError(f"truncated page payload at {at}")
    return rows


def scan_page_headers_partial(buf, total_values: int
                              ) -> Tuple[np.ndarray, int, int]:
    """The windowed header scan of a streamed chunk: the table of the
    complete pages at the start of ``buf`` (a window of a page stream),
    walking while fewer than ``total_values`` data values were seen.
    Returns ``(rows, consumed_bytes, values_seen)``: it stops, without an
    error, at the first page the window cuts (a header or payload past
    its end) and at a header it cannot take (the caller's Python walk
    raises the precise error there); ``rows`` may be empty."""
    rows, _ = _header_table(as_u8(buf), total_values, None)
    if not len(rows):
        return rows, 0, 0
    data = (rows[:, PG_TYPE] == 0) | (rows[:, PG_TYPE] == 3)
    consumed = int(rows[-1, PG_DATA_POS] + rows[-1, PG_COMP])
    return rows, consumed, int(rows[data, PG_NVALS].sum())


def available_cpus() -> int:
    """The cores this process may run on (its affinity, not the host's
    count)."""
    return len(os.sched_getaffinity(0)) or 1


_thread_cap = threading.local()


@contextlib.contextmanager
def native_thread_cap(n: int):
    """At most ``n`` native threads for each call this thread makes inside
    the block (a staging worker's share of the cores)."""
    prev = getattr(_thread_cap, "n", None)
    _thread_cap.n = n
    try:
        yield
    finally:
        _thread_cap.n = prev


def decompress_threads(nbytes: int) -> int:
    """Threads for a batch of ``nbytes`` of output: one below 8 MiB, else
    one per 4 MiB up to 8, the cores this process may use and the calling
    thread's cap (:func:`native_thread_cap`)."""
    if nbytes < 8 << 20:
        return 1
    cap = getattr(_thread_cap, "n", None) or 8
    return max(1, min(available_cpus(), 8, cap, nbytes >> 22))


# the batched codecs, by the name their per-page errors give them
_CODEC_NAMES = {CompressionCodec.SNAPPY: "Snappy",
                CompressionCodec.ZSTD: "ZSTD"}


def require_zstd() -> None:
    """Raise as ``codecs.get_codec`` does where libzstd did not load."""
    if not _prescan().pq_zstd_available():
        from ..codecs import LIBRARIES, missing_library

        raise missing_library(CompressionCodec.ZSTD,
                              LIBRARIES[CompressionCodec.ZSTD])


def decompress_error(codec_id: int, src_len: int,
                     size: int) -> CorruptedError:
    """The error of a batched page of ``src_len`` bytes that does not
    decompress to ``size``."""
    unit = " bytes out" if codec_id == CompressionCodec.SNAPPY else " out"
    return CorruptedError(f"malformed {_CODEC_NAMES[codec_id]} stream "
                          f"({src_len} bytes, expected {size}{unit})")


def decompress_pages(srcs: Sequence, sizes: Sequence[int], codec_id: int,
                     nthreads: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Decompress SNAPPY or ZSTD page payloads in one call on
    ``nthreads`` threads: ``(buffer, offsets)``, page i at
    ``buffer[offsets[i]:offsets[i + 1]]``, each exactly ``sizes[i]``
    bytes.  A page that does not decode raises the codec's
    ``CorruptedError`` (the first such page); ZSTD without libzstd raises
    as ``codecs.get_codec`` does."""
    if codec_id not in _CODEC_NAMES:
        raise ValueError(f"codec {codec_id} is not batched")
    lib = _prescan()
    if codec_id == CompressionCodec.ZSTD:
        require_zstd()
    bufs = [as_u8(s) for s in srcs]
    sizes = np.asarray(sizes, np.int64).reshape(-1)
    if len(sizes) != len(bufs):
        raise ValueError(f"{len(bufs)} pages but {len(sizes)} sizes")
    bad = np.flatnonzero(sizes < 0)
    offs = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum(np.maximum(sizes, 0), out=offs[1:])
    out = np.empty(max(int(offs[-1]), 1), np.uint8)
    rc = 0
    if len(bad):
        rc = -(int(bad[0]) + 1)
    elif bufs:
        ptrs = np.array([b.ctypes.data if len(b) else 0 for b in bufs],
                        np.int64)
        lens = np.array([len(b) for b in bufs], np.int64)
        rc = lib.pq_decompress_pages(ptrs.ctypes.data, lens.ctypes.data,
                                     len(bufs), codec_id, out.ctypes.data,
                                     offs.ctypes.data, max(int(nthreads), 1))
    if rc:
        i = -rc - 1
        raise decompress_error(codec_id, len(bufs[i]), int(sizes[i]))
    return out[:int(offs[-1])], offs


# ---------------------------------------------------------------------------
# the chunk planner and the staging fill (csrc/host_prescan.cpp)
# ---------------------------------------------------------------------------

# columns of chunk_plan's per-page sources (csrc/host_prescan.cpp's S_*):
# the payload (a v2 page's levels lie there), the body to decompress
# (v1: the payload; v2: what follows the levels), the codec (0: the body
# is used as it lies), the decompressed size and its offset in the
# bodies buffer
(SRC_PAYLOAD, SRC_PAYLOAD_LEN, SRC_BODY, SRC_BODY_LEN, SRC_CODEC, SRC_SIZE,
 SRC_OUT_OFF, SRC_NFIELDS) = range(8)

#: a plan's value kinds, by the planner's code
VALUE_KINDS = ("plain_fixed", "plain_flba", "bool", "dict", "delta", "bss",
               "dba", "host_ba")

# chunk_plan's status (INFO_STATUS), and the slots of its info array:
# PLAN_MEMORY an allocation failed, PLAN_ENUM an encoding the format does
# not define, PLAN_NOT_READ an encoding the read does not decode for the
# column
(PLAN_OK, PLAN_CORRUPT, PLAN_UNSUPPORTED, PLAN_OUTSIDE, PLAN_DECOMPRESS,
 PLAN_MEMORY, PLAN_ENUM, PLAN_NOT_READ) = range(8)
(INFO_STATUS, INFO_PAGE, INFO_CODE, INFO_A0, INFO_A1, INFO_A2, INFO_A3,
 INFO_KIND, INFO_SLOTS, INFO_VALUES, INFO_EXPANDED, INFO_DENSE_OK,
 INFO_DENSE_W, INFO_D_VPM, INFO_HOST_DEF, INFO_LEVELS_LEN, INFO_VALUES_LEN,
 INFO_DENSE_LEN, INFO_DEF_TOTAL, INFO_REP_TOTAL, INFO_V_TOTAL,
 INFO_SIZES) = range(22)

#: the arrays of a plan, in the order pq_plan_export writes them; every
#: one int64 but host_def (int32); segment tables are (pointer, bytes)
#: rows (pointer 0: zeros)
PLAN_ARRAYS = (
    "levels", "values", "dense",
    "def_ends", "def_kinds", "def_payloads", "def_bit_offsets",
    "def_widths",
    "rep_ends", "rep_kinds", "rep_payloads", "rep_bit_offsets",
    "rep_widths",
    "v_ends", "v_kinds", "v_payloads", "v_bit_offsets", "v_widths",
    "dense_pages", "d_firsts", "d_counts", "d_vpms", "d_mb_counts",
    "d_mb_offs", "d_mb_widths", "d_mb_mins", "bss_pages", "dba_plens",
    "dba_soffs", "dba_slens", "hb_parts", "hb_lens", "host_def")
_PAIRS = {"levels": 2, "values": 2, "dense": 2, "dense_pages": 2,
          "bss_pages": 2, "hb_parts": 4}


def plan_threads(nbytes: int) -> int:
    """Threads for planning a chunk whose pages need ``nbytes`` of work
    (bodies to decompress or decode value by value): one below 1 MiB,
    else one per 512 KiB up to 8, the cores this process may use and the
    calling thread's cap (:func:`native_thread_cap`)."""
    if nbytes < 1 << 20:
        return 1
    cap = getattr(_thread_cap, "n", None) or 8
    return max(1, min(available_cpus(), 8, cap, nbytes >> 19))


def chunk_plan(rows: np.ndarray, srcs: np.ndarray, max_def: int,
               max_rep: int, physical: int, type_length: int,
               bodies: np.ndarray, nthreads: int = 1):
    """Plan a chunk's pages in one call (``pq_chunk_plan``, the
    interpreter lock released) on ``nthreads`` threads, and write the plan
    out in another (``pq_plan_export``): ``rows`` its page-header table,
    ``srcs`` its ``int64[n, SRC_NFIELDS]`` sources, ``bodies`` the buffer
    the compressed bodies decompress into.  Returns ``(info, arrays)``:
    ``info`` the status and the plan's scalars (``INFO_*``), ``arrays``
    the plan's arrays by :data:`PLAN_ARRAYS` name, or None unless the
    status is :data:`PLAN_OK`.  The pointers in ``srcs`` and the arrays'
    segment tables must stay valid while the plan is used."""
    rows = np.ascontiguousarray(rows, np.int64)
    srcs = np.ascontiguousarray(srcs, np.int64)
    if rows.shape != (len(srcs), PG_NFIELDS) or srcs.shape[1:] != (
            SRC_NFIELDS,):
        raise ValueError("page rows and sources of different shapes")
    lib = _prescan()
    info = np.zeros(INFO_SIZES + len(PLAN_ARRAYS), np.int64)
    plan = lib.pq_chunk_plan(_ptr(rows), _ptr(srcs), len(rows), max_def,
                             max_rep, physical, type_length,
                             bodies.ctypes.data, len(bodies), nthreads,
                             info.ctypes.data)
    if not plan:
        return info, None
    try:
        sizes = info[INFO_SIZES:]
        # every int64 array a view of one buffer; host_def (int32) apart
        ends = np.cumsum(sizes[:-1])
        buf = np.empty(max(int(ends[-1]), 1), np.int64)
        host_def = np.empty(int(sizes[-1]), np.int32)
        ptrs = np.zeros(len(PLAN_ARRAYS), np.int64)
        ptrs[:-1] = buf.ctypes.data + (ends - sizes[:-1]) * 8
        ptrs[-1] = host_def.ctypes.data
    except BaseException:
        lib.pq_plan_free(plan)
        raise
    # the export's threads pay off only for tables of megabytes
    if lib.pq_plan_export(plan, ptrs.ctypes.data,
                          nthreads if len(buf) >= 1 << 20 else 1):
        raise MemoryError("out of host memory exporting a chunk plan")
    arrays = {name: buf[e - n:e] for name, n, e in zip(
        PLAN_ARRAYS, sizes[:-1].tolist(), ends.tolist())}
    for name, width in _PAIRS.items():
        arrays[name] = arrays[name].reshape(-1, width)
    arrays["host_def"] = host_def
    return info, arrays


def fill_threads(nbytes: int) -> int:
    """Threads for filling ``nbytes`` of a staging batch: one below 4 MiB,
    else one per 2 MiB up to 8, the cores this process may use and the
    calling thread's cap (:func:`native_thread_cap`)."""
    if nbytes < 4 << 20:
        return 1
    cap = getattr(_thread_cap, "n", None) or 8
    return max(1, min(available_cpus(), 8, cap, nbytes >> 21))


def fill_batch(dst: np.ndarray, copies: np.ndarray, gathers: np.ndarray,
               nthreads: int = 1) -> None:
    """Write a staging batch in one call (``pq_fill_batch``, the
    interpreter lock released): ``copies`` rows ``(dst offset, source
    pointer or 0 for zeros, bytes)`` and ``gathers`` rows ``(dst offset,
    source pointer, source bytes, pointer to int64 row starts, rows,
    bytes a row)``, each gathered row the source's bytes from its start,
    those past the source repeating its last byte.  The sources must
    stay alive until the call returns."""
    copies = np.ascontiguousarray(copies, np.int64).reshape(-1, 3)
    gathers = np.ascontiguousarray(gathers, np.int64).reshape(-1, 6)
    rc = _prescan().pq_fill_batch(dst.ctypes.data, dst.nbytes, _ptr(copies),
                                  len(copies), _ptr(gathers), len(gathers),
                                  max(int(nthreads), 1))
    if rc == -2:
        raise MemoryError("out of host memory filling a staging batch")
    if rc:
        raise ValueError("a staging entry lies outside the batch")


def byte_array_parts(parts: np.ndarray, lens: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A chunk's host byte-array pages, ``parts`` rows ``(kind, pointer,
    bytes, values)`` (kind 0: PLAIN, length-prefixed; 1:
    DELTA_LENGTH_BYTE_ARRAY bytes, their ``lens`` in order), as one fresh
    ``(values uint8, offsets int64[n + 1])`` pair."""
    parts = np.ascontiguousarray(parts, np.int64).reshape(-1, 4)
    lens = np.ascontiguousarray(lens, np.int64)
    if (parts[:, 3] < 0).any():
        raise CorruptedError("negative BYTE_ARRAY value count")
    offsets = np.empty(int(parts[:, 3].sum()) + 1, np.int64)
    values = np.empty(max(int(parts[:, 2].sum()), 1), np.uint8)
    got = _prescan().pq_byte_array_parts(_ptr(parts), len(parts), _ptr(lens),
                                         offsets.ctypes.data,
                                         values.ctypes.data)
    if got < 0:
        raise CorruptedError(f"PLAIN BYTE_ARRAY page {-got - 1} of "
                             f"{len(parts)} is truncated")
    return values[:got], offsets
