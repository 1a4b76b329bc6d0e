"""Device decode of column chunks: chunk bytes -> device tensors -> Column.

The port of ``parquet_tpu/parallel/device_reader.py``: columns of every
physical type (BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY and
FIXED_LEN_BYTE_ARRAY) at any nesting depth, in PLAIN,
RLE_DICTIONARY/PLAIN_DICTIONARY, RLE (booleans), DELTA_BINARY_PACKED,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT pages, v1
or v2.  Each chunk runs three phases:

- :func:`build_plan`: host prescan of the pages into a :class:`_Plan`
  (decompression, RLE run headers of levels and values, delta miniblock
  headers, the spans of PLAIN and byte-array values, the length streams
  of front coding: metadata-scale work), of the whole chunk or of a given
  span of its pages with a given dictionary (the point lookup's page
  runs), in one C++ call a chunk (``host.chunk_plan``,
  ``csrc/host_prescan.cpp``) that releases the interpreter lock;
  :func:`_build_plan_python`, the same walk page by page in Python, is
  its plain version and plans the one shape it leaves out, legacy
  BIT_PACKED def levels (:data:`PLAN_ROUTE`);
- :func:`stage_plan`: the concatenated byte streams and the run tables
  are recorded in a :class:`_StagingBatch`, laid out in one host buffer
  (pinned for a card), written there once by one C++ call
  (``host.fill_batch``) and sent in one ``non_blocking`` copy; the staged
  operands are views of one device buffer;
- :func:`decode_staged`: device decode into a :class:`Column`.  The dense
  dictionary-index and delta-miniblock streams unpack through the CUDA
  kernels of ``ops/kernels.py``; run expansion, gathers, the plane
  transpose, the front-coded expansion, the level math and assembly and
  the prefix sums are torch ops (``ops/device.py``).

Levels: a flat optional column expands its def levels on the device into
its validity.  A column under a repeated node expands both level streams
on the device and assembles them there (``dev.assemble_single_list`` for
one repeated level, ``dev.assemble_nested`` for more) into list offsets
and validity per level, on the card and on the CPU alike.  A struct chain
(``max_def > 1``, nothing repeated) expands its def levels once on the
host, keeps them in ``Column.def_levels`` for the nullness of each struct,
and stages its validity, ``def == max_def``.  The collapsed form cannot
carry a null struct between two repeated levels, so the row model and the
merge ask for the level streams themselves (``decode_staged(...,
keep_levels=True)``): a repeated column's expanded ``def``/``rep`` tensors,
or a struct chain's def levels expanded on the device, come to the host in
one copy each.  Nothing else pays for them.

A BYTE_ARRAY dictionary chunk stays encoded: a device ``(values,
offsets)`` dictionary plus int32 indexes, as the JAX package keeps it.  A
chunk the device route cannot decode raises ``errors._Unsupported``, and
:func:`decode_chunks_pipelined` sends it, and only it, to
``io/reader.decode_chunk_host``, counting it in :data:`HOST_ROUTE` by
reason.  64-bit values are native int64 / float64 tensors, not the JAX
package's uint32 pairs.

The read runs the phases as the JAX package does:
:func:`decode_chunks_pipelined` prescans, packs and copies later chunks
on worker threads (:func:`prepare_chunk`, each copy on the worker's own
stream, waited for by :func:`decode_staged`) while it decodes earlier
ones, and pipelines a lone chunk over its page batches
(:func:`decode_chunk_batched`); :func:`prepare_chunks_batched` stages
many chunks in one batch and one copy.  :data:`PIPELINE` keeps the JAX
package's counters of the pipeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import struct as _struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..errors import CorruptedError, _Unsupported, unsupported
from ..format.enums import CompressionCodec, Encoding, PageType, Type
from ..io.column import Column
from ..obs import trace as _otrace
from ..io.reader import (_BATCHED_CODECS, PageTable, data_page_bodies,
                         decode_dictionary_page, page_table_of)
from ..ops import device as dev
from ..ops import encodings, host, kernels, levels, ref
from ..schema.types import (PHYSICAL_TORCH_DTYPE, PHYSICAL_WIDTH,
                            empty_values)
from ..utils.debug import annotate, counters

_M32 = 0xFFFFFFFF

#: chunks the device route sent to the host decode, by reason: pages that
#: mix value kinds (a dictionary that fell back to PLAIN), a chunk mixing
#: RLE and legacy BIT_PACKED def levels, legacy BIT_PACKED levels in a
#: repeated column, INT96 byte-stream split, a front-coded page whose
#: first prefix is nonzero, a staged stream over ``dev.MAX_DEVICE_BUF``,
#: and delta pages of different miniblock sizes; and a page whose encoding
#: a caller's registered decode shadows (``ops/encodings.py``)
HOST_ROUTE = {"mixed_page_kinds": 0, "mixed_level_encodings": 0,
              "bit_packed_repeated_levels": 0, "bss_int96": 0,
              "dba_first_prefix": 0, "stream_bound": 0,
              "mixed_delta_vpm": 0, "registered_encoding": 0}


def reset_host_route() -> None:
    for k in HOST_ROUTE:
        HOST_ROUTE[k] = 0


#: chunks planned by the C++ planner (``build_plan``): ``native``, and
#: ``native:python_codec`` where a codec without a batched C++ decoder
#: (GZIP, LZ4, LZ4_RAW, BROTLI) decompressed the pages page by page
#: first; and by the Python walk (``_build_plan_python``):
#: ``python:bit_packed_levels``, the one shape the C++ leaves out
PLAN_ROUTE = {"native": 0, "native:python_codec": 0,
              "python:bit_packed_levels": 0}
_route_lock = threading.Lock()


def reset_plan_route() -> None:
    for k in PLAN_ROUTE:
        PLAN_ROUTE[k] = 0


def _count_plan(route: str) -> None:
    with _route_lock:  # planned on the pipeline's workers
        PLAN_ROUTE[route] += 1


def _bit_width(max_level: int) -> int:
    return int(max_level).bit_length()


def _ints(*shape) -> np.ndarray:
    return np.zeros(shape or (0,), np.int64)


class _RunTable:
    """Chunk-level merged RLE/bit-packed run table: ``arrays`` (ends,
    kinds, payloads, bit_offsets, widths), the int64 operands of
    ``dev.rle_expand``, over ``total`` values."""

    __slots__ = ("arrays", "total")

    def __init__(self, arrays=None, total: int = 0):
        self.arrays = arrays if arrays is not None else (_ints(),) * 5
        self.total = total

    def run_arrays(self) -> Tuple[np.ndarray, ...]:
        return self.arrays

    def expand(self, dbuf: torch.Tensor, tables) -> torch.Tensor:
        return dev.rle_expand(dbuf, self.total, *tables)


class _RunParts:
    """A :class:`_RunTable` built page by page (the Python walk)."""

    def __init__(self):
        self.parts, self.total = [], 0

    def add_scanned(self, kinds, cnts, payloads, offs, width, base_byte, n):
        cnts = np.asarray(cnts, np.int64)
        self.parts.append((self.total + np.cumsum(cnts),
                           np.asarray(kinds, np.int64),
                           np.asarray(payloads, np.int64),
                           (np.asarray(offs, np.int64) + base_byte) * 8,
                           np.full(len(cnts), width, np.int64)))
        self.total += n

    def add(self, data: np.ndarray, n: int, width: int, base_byte: int):
        """Scan ``n`` values of a hybrid stream (C++,
        ``host.scan_rle_runs``) into the table; returns its run table."""
        kinds, cnts, payloads, offs, _end = host.scan_rle_runs(data, n,
                                                               width)
        self.add_scanned(kinds, cnts, payloads, offs, width, base_byte, n)
        return kinds, cnts, payloads, offs

    def add_bitpacked_span(self, n: int, width: int, base_byte: int):
        """A raw bit-packed span (a PLAIN BOOLEAN page) as one run."""
        self.add_scanned([1], [n], [0], [0], width, base_byte, n)

    def table(self) -> _RunTable:
        if not self.parts:
            return _RunTable(total=self.total)
        return _RunTable(tuple(np.concatenate(c) for c in zip(*self.parts)),
                         self.total)


class _ByteAccum:
    """A byte stream as segments, ``(pointer, bytes)`` rows (pointer 0:
    zeros) into buffers it keeps alive, and the views :meth:`extend`
    appends; written once, at staging time, straight into the staging
    batch's buffer."""

    __slots__ = ("_segs", "_parts", "_n", "_keep")

    def __init__(self, segs: Optional[np.ndarray] = None, n: int = 0,
                 keep=None):
        self._segs = _ints(0, 2) if segs is None else segs
        self._parts, self._n, self._keep = [], n, keep

    def __len__(self) -> int:
        return self._n

    def extend(self, b) -> None:
        b = host.as_u8(b)
        if len(b):
            self._parts.append(b)
            self._n += len(b)

    def segments(self) -> np.ndarray:
        if self._parts:
            rows = np.array([(p.ctypes.data, len(p)) for p in self._parts],
                            np.int64)
            self._segs = np.concatenate([self._segs, rows])
            self._keep, self._parts = (self._keep, self._parts), []
        return self._segs

    def copies(self, off: int) -> np.ndarray:
        """The staging copies that write the stream at ``off``: ``(dst
        offset, pointer, bytes)`` rows."""
        segs = self.segments()
        out = np.empty((len(segs), 3), np.int64)
        out[:, 1:] = segs
        out[:, 0] = off
        out[1:, 0] += np.cumsum(segs[:-1, 1])
        return out

    def array(self) -> np.ndarray:
        if not self._n:
            return np.empty(0, np.uint8)
        out = np.empty(self._n, np.uint8)
        host.fill_batch(out, self.copies(0), ())
        return out


@dataclass
class _Plan:
    """Host-built staging plan for one chunk: every table chunk-level,
    as ``build_plan`` (C++) and ``_build_plan_python`` (the plain
    version) make it alike."""

    levels: _ByteAccum = field(default_factory=_ByteAccum)
    values: _ByteAccum = field(default_factory=_ByteAccum)
    def_runs: _RunTable = field(default_factory=_RunTable)
    rep_runs: _RunTable = field(default_factory=_RunTable)
    # def levels decoded on the host: legacy BIT_PACKED levels, and every
    # page of a struct chain (None: no page's)
    host_def: Optional[np.ndarray] = None
    # 'plain_fixed' | 'plain_flba' | 'bool' | 'dict' | 'delta' | 'bss' |
    # 'dba' | 'host_ba' (host.VALUE_KINDS)
    value_kind: Optional[str] = None
    # dictionary index runs, or boolean runs
    vruns: _RunTable = field(default_factory=_RunTable)
    # dense single-width dict-index stream: bit-packed run payloads
    # compacted into one LSB-first w-bit stream, page-aligned to 32-value
    # groups; (start_value, n_values) per page.  Empty unless dense_ok.
    dense: _ByteAccum = field(default_factory=_ByteAccum)
    dense_w: Optional[int] = None
    dense_pages: np.ndarray = field(default_factory=lambda: _ints(0, 2))
    dense_ok: bool = True
    # delta: per page its first value, value count, values per miniblock
    # and miniblocks; per miniblock its bit offset into values, width and
    # min delta
    d_firsts: np.ndarray = field(default_factory=_ints)
    d_counts: np.ndarray = field(default_factory=_ints)
    d_vpms: np.ndarray = field(default_factory=_ints)
    d_mb_counts: np.ndarray = field(default_factory=_ints)
    d_mb_offs: np.ndarray = field(default_factory=_ints)
    d_mb_widths: np.ndarray = field(default_factory=_ints)
    d_mb_mins: np.ndarray = field(default_factory=_ints)
    d_vpm: int = 32
    d_dense_static: Optional[tuple] = None
    # byte-stream split: (base in values, value count) per page
    bss_pages: np.ndarray = field(default_factory=lambda: _ints(0, 2))
    # front coding: per entry its prefix length, its suffix's start in
    # values and its suffix length
    dba_plens: np.ndarray = field(default_factory=_ints)
    dba_soffs: np.ndarray = field(default_factory=_ints)
    dba_slens: np.ndarray = field(default_factory=_ints)
    # host byte arrays: per page (kind 0 PLAIN | 1 DELTA_LENGTH, pointer,
    # bytes, values), compacted at staging; the DELTA_LENGTH lengths
    hb_parts: np.ndarray = field(default_factory=lambda: _ints(0, 4))
    hb_lens: np.ndarray = field(default_factory=_ints)
    total_slots: int = 0
    total_values: int = 0
    # numpy array, or (values, offsets) for byte arrays
    dictionary_host = None
    # the dictionary already staged for another plan of the chunk (a page
    # batch of ``decode_chunk_batched``): staged once, shared
    dictionary_dev = None
    # True once a page's def levels are not the one all-present RLE run
    # (v1) or its header counts nulls (v2): the pages whose levels the
    # reference's host decode expands, giving the span a validity mask
    defs_expanded: bool = False
    leaf = None
    physical: Optional[Type] = None
    # the buffers the plan's pointers point into
    keep = None


def build_plan(reader, pages=None, dictionary=None) -> _Plan:
    """Host prescan of a chunk's pages into a staging plan: every page of
    the chunk, or ``pages`` (a :class:`PageTable` or :class:`PageInfo`
    objects: data pages of one span) decoded with the chunk's
    already-decoded ``dictionary``.  One C++ call plans every data page
    (``host.chunk_plan``, the interpreter lock released); a chunk with a
    shape outside it takes :func:`_build_plan_python`, counted in
    :data:`PLAN_ROUTE` by reason."""
    table = page_table_of(reader, pages)
    if encodings.any_shadowed():
        _check_builtin_encodings(table)
    plan = _native_plan(reader, table, dictionary)
    return plan if plan is not None else _build_plan_python(
        reader, table, dictionary)


def _check_builtin_encodings(table: PageTable) -> None:
    """Refuse a chunk with a data page whose encoding a registered decode
    shadows: the planner knows only the built-in ones, and the host decode
    dispatches through the registry."""
    rows = table.rows
    data = np.isin(rows[:, host.PG_TYPE], (int(PageType.DATA_PAGE),
                                           int(PageType.DATA_PAGE_V2)))
    for enc in np.unique(rows[data, host.PG_ENC]).tolist():
        if enc >= 0 and not encodings.is_builtin_decode(enc):
            name = encodings.lookup(enc).name
            raise _Unsupported("registered_encoding",
                               f"encoding {enc} decodes through the "
                               f"registered {name!r}")


def _page_sources(reader, table: PageTable) -> tuple:
    """The planner's per-page sources (``host.SRC_*`` columns), the buffer
    the compressed bodies decompress into and the bodies decoded here
    (codecs without a batched C++ decoder), from the bodies
    ``data_page_bodies`` reads (``PageTable.bodies``)."""
    b = table.bodies()
    ptr = table.payloads[:, 0]
    srcs = np.zeros((len(table), host.SRC_NFIELDS), np.int64)
    srcs[:, host.SRC_PAYLOAD] = ptr
    srcs[:, host.SRC_PAYLOAD_LEN] = table.payloads[:, 1]
    srcs[:, host.SRC_BODY] = ptr + b.start
    srcs[:, host.SRC_BODY_LEN] = b.length
    size, compressed = b.size, b.compressed
    srcs[:, host.SRC_SIZE] = size
    codec = reader.codec
    cid = int(codec.codec_id)
    bodies, decoded = np.empty(1, np.uint8), None
    if codec.codec_id in _BATCHED_CODECS and compressed.any():
        bad = np.flatnonzero(compressed & (size < 0))
        if len(bad):
            raise _decompress_error(cid, srcs[bad[0]])
        if codec.codec_id == CompressionCodec.ZSTD:
            host.require_zstd()
        out = np.where(compressed, size, 0)
        srcs[:, host.SRC_OUT_OFF] = np.cumsum(out) - out
        srcs[:, host.SRC_CODEC] = np.where(compressed, cid, 0)
        bodies = np.empty(max(int(out.sum()), 1), np.uint8)
    elif codec.codec_id != CompressionCodec.UNCOMPRESSED and \
            compressed.any():
        decoded = data_page_bodies(reader, table)
        for i in np.flatnonzero(compressed).tolist():
            srcs[i, host.SRC_BODY] = decoded[i].ctypes.data
            srcs[i, host.SRC_BODY_LEN] = len(decoded[i])
    return srcs, bodies, decoded


def _decompress_error(codec_id: int, src) -> CorruptedError:
    """``host.decompress_pages``' error for the page of ``src``."""
    return host.decompress_error(codec_id, int(src[host.SRC_BODY_LEN]),
                                 int(src[host.SRC_SIZE]))


_STREAMS = ("level", "RLE boolean")
_CORRUPT = {
    1: lambda a: "malformed RLE hybrid stream: zero-count run",
    2: lambda a: "RLE hybrid stream truncated",
    3: lambda a: f"RLE hybrid bit width {a[0]} outside 0..64",
    4: lambda a: f"{_STREAMS[a[0]]} stream length truncated",
    5: lambda a: f"{_STREAMS[a[0]]} stream of {a[1]} bytes overruns its "
                 "page",
    6: lambda a: f"{('PLAIN', 'BYTE_STREAM_SPLIT')[a[0]]} page holds {a[1]} "
                 f"bytes, {a[2]} values need {a[3]}",
    7: lambda a: f"DELTA_BINARY_PACKED page in a {Type(a[0]).name} column",
    8: lambda a: f"BYTE_STREAM_SPLIT page in a {Type(a[0]).name} column",
    9: lambda a: f"malformed DELTA_BINARY_PACKED header: block_size={a[0]}, "
                 f"miniblocks={a[1]}",
    10: lambda a: "DELTA_BINARY_PACKED miniblock bit width over 64",
    11: lambda a: "DELTA_BINARY_PACKED stream truncated",
    12: lambda a: f"DELTA_LENGTH_BYTE_ARRAY: {a[0]} lengths of {a[1]} bytes, "
                  f"{a[2]} in the page",
    13: lambda a: f"DELTA_BYTE_ARRAY: {a[0]} prefix lengths for {a[1]} "
                  "suffixes",
    14: lambda a: "DELTA_BYTE_ARRAY prefix longer than the value before it",
    15: lambda a: _level_bytes_message(*a[:3]),
    16: lambda a: _counts_message(*a[:2]),
    17: lambda a: _TYPE_LENGTH,
    18: lambda a: host.length_count_message(*a[:2]),
}
_TYPE_LENGTH = "FIXED_LEN_BYTE_ARRAY column without a type length"


def _level_bytes_message(rl: int, dl: int, size: int) -> str:
    return (f"v2 page levels of {rl} + {dl} bytes do not fit its "
            f"{size}-byte payload")


def _counts_message(n: int, nulls: int) -> str:
    return f"data page of {n} values with {nulls} nulls"


def _plan_error(info: np.ndarray, leaf) -> Exception:
    """The exception of a planner status, of the type and in the words of
    the Python walk's."""
    status = int(info[host.INFO_STATUS])
    code = int(info[host.INFO_CODE])
    args = info[host.INFO_A0:host.INFO_A3 + 1].tolist()
    if status == host.PLAN_CORRUPT:
        return CorruptedError(_CORRUPT[code](args))
    if status == host.PLAN_MEMORY:
        return MemoryError(f"out of host memory planning page "
                           f"{int(info[host.INFO_PAGE])} of a chunk")
    if status == host.PLAN_ENUM:  # the walk's Encoding(value)
        try:
            Encoding(None if args[0] == -1 else args[0])
        except ValueError as e:
            return e
    if status == host.PLAN_NOT_READ:
        return _not_read(Encoding(args[0]), Type(args[1]))
    kinds = host.VALUE_KINDS
    return {
        1: lambda: _Unsupported("mixed_page_kinds", f"chunk mixing "
                                f"{kinds[args[0]]} and {kinds[args[1]]} "
                                "pages"),
        2: lambda: _bit_packed_repeated(leaf),
        3: lambda: _Unsupported("bss_int96", "byte-stream-split INT96 "
                                "values"),
        4: lambda: _dba_first_prefix(),
    }[code]()


def _not_read(encoding: Encoding, physical: Type) -> NotImplementedError:
    return unsupported(f"{encoding.name} pages of a {physical.name} column",
                       "more encodings")


def _bit_packed_repeated(leaf) -> _Unsupported:
    return _Unsupported("bit_packed_repeated_levels",
                        f"legacy BIT_PACKED levels in the repeated column "
                        f"{leaf.name!r}")


def _dba_first_prefix() -> _Unsupported:
    # front coding restarts on every page: a nonzero first prefix would
    # chase a value of another page
    return _Unsupported("dba_first_prefix", "DELTA_BYTE_ARRAY page with a "
                        "nonzero first prefix")


#: the encodings whose pages the planner decodes value by value (delta
#: miniblock tables, the length streams of the delta byte arrays): the
#: codes from DELTA_BINARY_PACKED to DELTA_BYTE_ARRAY
_DECODED_FIRST, _DECODED_LAST = (Encoding.DELTA_BINARY_PACKED,
                                 Encoding.DELTA_BYTE_ARRAY)


def _plan_work(rows: np.ndarray, srcs: np.ndarray) -> int:
    """The bytes a chunk's planning works through, for its thread count:
    the bodies it decompresses and those it decodes value by value (a
    PLAIN or dictionary page is a few run headers, whatever its size)."""
    inflated = srcs[:, host.SRC_CODEC] != 0
    enc = rows[:, host.PG_ENC]
    decoded = (enc >= _DECODED_FIRST) & (enc <= _DECODED_LAST)
    return int(np.where(inflated | decoded, srcs[:, host.SRC_SIZE].clip(0),
                        0).sum())


def _native_plan(reader, table: PageTable, dictionary) -> Optional[_Plan]:
    """The plan of one ``host.chunk_plan`` call, or None for a chunk
    outside the C++ planner; counted in :data:`PLAN_ROUTE`.  Raises what
    the Python walk raises, in the order it raises it (page decompression
    first, then each page's levels and values and each dictionary page in
    page order)."""
    leaf = reader.leaf
    physical = Type(reader.meta.type)
    rows = table.rows
    srcs, bodies, decoded = _page_sources(reader, table)
    info, arrays = host.chunk_plan(
        rows, srcs, leaf.max_definition_level, leaf.max_repetition_level,
        int(physical), -1 if leaf.type_length is None else leaf.type_length,
        bodies, host.plan_threads(_plan_work(rows, srcs)))
    status = int(info[host.INFO_STATUS])
    if status == host.PLAN_OUTSIDE:  # legacy BIT_PACKED def levels
        _count_plan("python:bit_packed_levels")
        return None
    _count_plan("native" if decoded is None else "native:python_codec")
    if status == host.PLAN_DECOMPRESS:
        raise _decompress_error(int(reader.codec.codec_id),
                                srcs[int(info[host.INFO_PAGE])])
    stop = len(rows) if status == host.PLAN_OK else int(info[host.INFO_PAGE])
    for i in np.flatnonzero(rows[:stop, host.PG_TYPE]
                            == PageType.DICTIONARY_PAGE).tolist():
        dictionary = decode_dictionary_page(reader, table.info(i))
    if status != host.PLAN_OK:
        raise _plan_error(info, leaf)
    keep = (table, bodies, decoded)
    kind = int(info[host.INFO_KIND])
    runs = ("ends", "kinds", "payloads", "bit_offsets", "widths")
    plan = _Plan(
        levels=_ByteAccum(arrays["levels"], int(info[host.INFO_LEVELS_LEN]),
                          keep),
        values=_ByteAccum(arrays["values"], int(info[host.INFO_VALUES_LEN]),
                          keep),
        def_runs=_RunTable(tuple(arrays["def_" + r] for r in runs),
                           int(info[host.INFO_DEF_TOTAL])),
        rep_runs=_RunTable(tuple(arrays["rep_" + r] for r in runs),
                           int(info[host.INFO_REP_TOTAL])),
        host_def=arrays["host_def"] if info[host.INFO_HOST_DEF] else None,
        value_kind=host.VALUE_KINDS[kind] if kind >= 0 else None,
        vruns=_RunTable(tuple(arrays["v_" + r] for r in runs),
                        int(info[host.INFO_V_TOTAL])),
        dense=_ByteAccum(arrays["dense"], int(info[host.INFO_DENSE_LEN]),
                         keep),
        dense_w=(int(info[host.INFO_DENSE_W])
                 if info[host.INFO_DENSE_W] >= 0 else None),
        dense_pages=arrays["dense_pages"],
        dense_ok=bool(info[host.INFO_DENSE_OK]),
        d_vpm=int(info[host.INFO_D_VPM]),
        total_slots=int(info[host.INFO_SLOTS]),
        total_values=int(info[host.INFO_VALUES]),
        defs_expanded=bool(info[host.INFO_EXPANDED]),
        **{k: arrays[k] for k in (
            "d_firsts", "d_counts", "d_vpms", "d_mb_counts", "d_mb_offs",
            "d_mb_widths", "d_mb_mins", "bss_pages", "dba_plens",
            "dba_soffs", "dba_slens", "hb_parts", "hb_lens")})
    plan.leaf, plan.physical, plan.keep = leaf, physical, keep
    plan.dictionary_host = dictionary
    return plan


def _len_prefixed(raw: np.ndarray, pos: int, what: str) -> tuple:
    """The hybrid stream behind a 4-byte length at ``pos``: ``(body,
    end)``."""
    if pos + 4 > len(raw):
        raise CorruptedError(f"{what} stream length truncated")
    (length,) = _struct.unpack_from("<I", raw, pos)
    if pos + 4 + length > len(raw):
        raise CorruptedError(f"{what} stream of {length} bytes overruns its "
                             "page")
    return raw[pos + 4:pos + 4 + length], pos + 4 + length


class _Walk:
    """The per-page parts of a plan the Python walk gathers, merged into
    a :class:`_Plan` by :meth:`plan`."""

    def __init__(self):
        self.levels, self.values, self.dense = (_ByteAccum(), _ByteAccum(),
                                                _ByteAccum())
        self.def_runs, self.rep_runs, self.vruns = (
            _RunParts(), _RunParts(), _RunParts())
        self.host_def = []
        self.value_kind = None
        self.dense_w, self.dense_pages, self.dense_ok = None, [], True
        self.delta = []  # (first, count, vpm, offs, widths, mins) a page
        self.bss_pages, self.dba, self.hb_parts, self.hb_lens = [], [], [], []
        self.keep = []

    def set_kind(self, kind: str):
        if self.value_kind is None:
            self.value_kind = kind
        elif self.value_kind != kind:
            raise _Unsupported(
                "mixed_page_kinds",
                f"chunk mixing {self.value_kind} and {kind} pages")

    def plan(self) -> _Plan:
        p = _Plan(levels=self.levels, values=self.values,
                  def_runs=self.def_runs.table(),
                  rep_runs=self.rep_runs.table(), vruns=self.vruns.table(),
                  value_kind=self.value_kind, dense_ok=self.dense_ok)
        if self.host_def:
            p.host_def = np.concatenate(self.host_def)
        if self.dense_ok and self.dense_pages:
            p.dense, p.dense_w = self.dense, self.dense_w
            p.dense_pages = np.array(self.dense_pages, np.int64)
        if self.delta:
            cols = list(zip(*self.delta))
            p.d_firsts, p.d_counts, p.d_vpms = (np.array(c, np.int64)
                                                for c in cols[:3])
            p.d_mb_counts = np.array([len(o) for o in cols[3]], np.int64)
            p.d_mb_offs, p.d_mb_widths, p.d_mb_mins = (
                np.concatenate(c).astype(np.int64) for c in cols[3:])
            p.d_vpm = int(p.d_vpms[-1])
        if self.bss_pages:
            p.bss_pages = np.array(self.bss_pages, np.int64)
        if self.dba:
            p.dba_plens, p.dba_soffs, p.dba_slens = (
                np.concatenate(c).astype(np.int64) for c in zip(*self.dba))
        if self.hb_parts:
            p.hb_parts = np.array([(k, b.ctypes.data, len(b), c)
                                   for k, b, c in self.hb_parts], np.int64)
            self.keep.append(self.hb_parts)
            if self.hb_lens:
                p.hb_lens = np.concatenate(self.hb_lens).astype(np.int64)
        p.keep = self.keep
        return p


def _build_plan_python(reader, pages=None, dictionary=None) -> _Plan:
    """The plain version of :func:`build_plan`: the chunk's pages walked
    one at a time in Python, the C++ scans called page by page.  The
    tests' oracle for the C++ planner, and the planner of the chunks
    outside it."""
    leaf = reader.leaf
    physical = Type(reader.meta.type)
    max_def = leaf.max_definition_level
    max_rep = leaf.max_repetition_level
    dw, rw = _bit_width(max_def), _bit_width(max_rep)
    # a struct chain's def levels expand on the host, once
    struct_chain = max_rep == 0 and max_def > 1
    w = _Walk()
    total_slots = total_values = 0
    expanded = False

    table = page_table_of(reader, pages)
    pages = list(table)
    bodies = data_page_bodies(reader, table)  # threaded C++
    for page, raw in zip(pages, bodies):
        h = page.header
        pt = page.page_type
        if pt == PageType.DICTIONARY_PAGE:
            dictionary = decode_dictionary_page(reader, page)
            continue
        if pt == PageType.DATA_PAGE:
            dph = h.data_page_header
            n = dph.num_values
            if n < 0:
                raise CorruptedError(_counts_message(n, 0))
            pos = 0
            n_present = n
            rle_def = (Encoding(dph.definition_level_encoding)
                       == Encoding.RLE)
            if max_rep > 0:
                rle_rep = (Encoding(dph.repetition_level_encoding)
                           == Encoding.RLE)
                if not rle_rep or not rle_def:
                    raise _bit_packed_repeated(leaf)
                body, end = _len_prefixed(raw, pos, "level")
                w.rep_runs.add(body, n, rw, len(w.levels))
                w.levels.extend(body)
                pos = end
            if max_def > 0:
                if rle_def and struct_chain:
                    lv, pos = ref.decode_rle_len_prefixed(raw, n, dw, pos)
                    w.host_def.append(lv)
                    n_present = int(np.count_nonzero(lv == max_def))
                    expanded |= n_present != n
                elif rle_def:
                    body, end = _len_prefixed(raw, pos, "level")
                    kinds, cnts, payloads, offs = w.def_runs.add(
                        body, n, dw, len(w.levels))
                    w.levels.extend(body)
                    pos = end
                    n_present = host.count_present(body, kinds, cnts,
                                                   payloads, offs, dw,
                                                   max_def)
                    if n and not _all_equal(kinds, payloads, max_def):
                        expanded = True
                else:  # legacy BIT_PACKED levels: decoded on the host
                    lv = ref.decode_bit_packed_levels(raw[pos:], n, dw)
                    w.host_def.append(lv)
                    pos += (n * dw + 7) // 8
                    n_present = int(np.count_nonzero(lv == max_def))
                    expanded = True
            _stage_values(w, raw, pos, n_present, Encoding(dph.encoding),
                          physical, leaf)
        elif pt == PageType.DATA_PAGE_V2:
            dph2 = h.data_page_header_v2
            n = dph2.num_values
            nulls = dph2.num_nulls or 0
            if n < 0 or nulls < 0 or nulls > n:
                raise CorruptedError(_counts_message(n, nulls))
            rl = dph2.repetition_levels_byte_length or 0
            dl = dph2.definition_levels_byte_length or 0
            payload = host.as_u8(page.payload)
            if rl < 0 or dl < 0 or rl + dl > len(payload):
                raise CorruptedError(_level_bytes_message(rl, dl,
                                                          len(payload)))
            if max_rep > 0:
                body = payload[:rl]
                w.rep_runs.add(body, n, rw, len(w.levels))
                w.levels.extend(body)
            if max_def > 0:
                body = payload[rl:rl + dl]
                if struct_chain:
                    w.host_def.append(ref.decode_rle(body, n, dw))
                else:
                    w.def_runs.add(body, n, dw, len(w.levels))
                    w.levels.extend(body)
                expanded |= bool(nulls)
            n_present = n - nulls
            _stage_values(w, raw, 0, n_present, Encoding(dph2.encoding),
                          physical, leaf)
        else:
            continue
        total_slots += n
        total_values += n_present
    if w.host_def and w.def_runs.total:
        raise _Unsupported("mixed_level_encodings",
                           f"column {leaf.name!r} mixing RLE and BIT_PACKED "
                           "definition levels")
    plan = w.plan()
    plan.total_slots, plan.total_values = total_slots, total_values
    plan.defs_expanded = expanded
    plan.leaf, plan.physical = leaf, physical
    plan.dictionary_host = dictionary
    plan.keep.append(pages)
    return plan


def _all_equal(kinds, payloads, level: int) -> bool:
    """A scanned level stream is one RLE run of ``level``."""
    return len(kinds) == 1 and kinds[0] == 0 and payloads[0] == level


def _add_dense_page(w: _Walk, body: np.ndarray, kinds, cnts, offs,
                    width: int, nvals: int) -> None:
    """Compact one dict page's index stream into the chunk's dense w-bit
    stream when every run is bit-packed.  Bit-packed runs hold whole
    8-value groups (8*w bits, byte aligned), so their payloads concatenate
    into one LSB-first stream; pages pad to 32-value boundaries (4*w
    bytes) so unpack groups never straddle pages."""
    if not w.dense_ok or not len(kinds) or not np.all(
            np.asarray(kinds) == 1):
        w.dense_ok = False
        return
    if w.dense_w is None:
        w.dense_w = width
    elif w.dense_w != width:
        w.dense_ok = False
        return
    group_bytes = 4 * width  # 32 values
    pad = -len(w.dense) % group_bytes
    w.dense.extend(np.zeros(pad, np.uint8))
    start_val = len(w.dense) * 8 // width
    bview = np.asarray(body)
    for cnt, off in zip(np.asarray(cnts, np.int64).tolist(),
                        np.asarray(offs, np.int64).tolist()):
        ngroups = (cnt + 7) // 8
        w.dense.extend(bview[off:off + ngroups * width])
    w.dense_pages.append((start_val, nvals))


def _stage_values(w: _Walk, raw: np.ndarray, pos: int, nvals: int,
                  encoding: Encoding, physical: Type, leaf) -> None:
    if encoding in (Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY):
        w.set_kind("dict")
        width = int(raw[pos]) if pos < len(raw) else 0
        body = raw[pos + 1:]
        base = len(w.values)
        w.values.extend(body)
        if width == 0:  # single-entry dictionary
            w.vruns.add_scanned([0], [nvals], [0], [0], 1, base, nvals)
            w.dense_ok = False
        else:
            kinds, cnts, _, offs = w.vruns.add(body, nvals, width, base)
            _add_dense_page(w, body, kinds, cnts, offs, width, nvals)
        return
    if encoding == Encoding.PLAIN:
        if physical == Type.BOOLEAN:
            w.set_kind("bool")
            nbytes = (nvals + 7) // 8
            _check_length(raw, pos, nbytes, nvals, "PLAIN")
            base = len(w.values)
            w.values.extend(raw[pos:pos + nbytes])
            w.vruns.add_bitpacked_span(nvals, 1, base)
            return
        if physical == Type.BYTE_ARRAY:  # offsets scanned at staging
            w.set_kind("host_ba")
            w.hb_parts.append((0, raw[pos:], nvals))
            return
        if physical == Type.FIXED_LEN_BYTE_ARRAY:
            w.set_kind("plain_flba")
            width = leaf.type_length
            if width is None:
                raise CorruptedError(_TYPE_LENGTH)
        else:
            w.set_kind("plain_fixed")
            width = PHYSICAL_WIDTH[physical]
        _check_length(raw, pos, nvals * width, nvals, "PLAIN")
        w.values.extend(raw[pos:pos + nvals * width])
        return
    if encoding == Encoding.DELTA_BINARY_PACKED:
        if physical not in (Type.INT32, Type.INT64):
            raise CorruptedError(
                f"DELTA_BINARY_PACKED page in a {physical.name} column")
        w.set_kind("delta")
        base = len(w.values)
        w.values.extend(raw[pos:])
        first, total, vpm, offs, widths, mins, _ = host.delta_prescan(raw,
                                                                      pos)
        w.delta.append((first, total, vpm, offs + (base - pos) * 8, widths,
                        mins))
        return
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        width = (leaf.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
                 else {Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4,
                       Type.DOUBLE: 8}.get(physical))
        if physical == Type.INT96:
            raise _Unsupported("bss_int96", "byte-stream-split INT96 values")
        if not width or width < 0:
            raise CorruptedError(f"BYTE_STREAM_SPLIT page in a "
                                 f"{physical.name} column")
        w.set_kind("bss")
        _check_length(raw, pos, nvals * width, nvals, "BYTE_STREAM_SPLIT")
        base = len(w.values)
        w.values.extend(raw[pos:pos + nvals * width])
        w.bss_pages.append((base, nvals))
        return
    if encoding == Encoding.RLE and physical == Type.BOOLEAN:
        w.set_kind("bool")
        body, _ = _len_prefixed(raw, pos, "RLE boolean")
        base = len(w.values)
        w.values.extend(body)
        w.vruns.add(body, nvals, 1, base)
        return
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY and \
            physical == Type.BYTE_ARRAY:
        w.set_kind("host_ba")
        v, o, _ = ref.decode_delta_length_byte_array(raw, pos, nvals)
        w.hb_parts.append((1, v, len(o) - 1))
        w.hb_lens.append(np.diff(o))
        return
    if encoding == Encoding.DELTA_BYTE_ARRAY and physical in (
            Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        w.set_kind("dba")
        plens, suffixes, soffs, _ = dev.delta_byte_array_prescan(raw, pos,
                                                                 nvals)
        if len(plens) and int(plens[0]) != 0:
            raise _dba_first_prefix()
        if len(plens) and ((plens < 0).any()
                           or (plens[1:] > np.diff(soffs)[:-1]
                               + plens[:-1]).any()):
            raise CorruptedError("DELTA_BYTE_ARRAY prefix longer than the "
                                 "value before it")
        base = len(w.values)
        w.values.extend(suffixes)
        w.dba.append((plens, soffs[:-1] + base, np.diff(soffs)))
        return
    raise _not_read(encoding, physical)


def _check_length(raw: np.ndarray, pos: int, nbytes: int, nvals: int,
                  what: str) -> None:
    if len(raw) - pos < nbytes:
        raise CorruptedError(f"{what} page holds {len(raw) - pos} bytes, "
                             f"{nvals} values need {nbytes}")


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


_ALIGN = 256  # every staged operand starts at a multiple of this
_ROUND = 16  # and spans a multiple of this, so int32/int64 views hold
COPY_STREAMS = 2  # the staging copy streams of a device, kept for good


class _CopyStreams:
    """Each device's :data:`COPY_STREAMS` staging streams, created once
    and handed to threads in turn, one a thread.  The caching allocator
    keeps a free list a stream, so a read's new worker threads must stage
    on the streams of the reads before them to reuse their device blocks
    (a fresh stream a read would allocate anew every chunk)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams = {}
        self._turn = itertools.count()
        self._mine = threading.local()

    def get(self, device: torch.device):
        key = str(device)
        stream = self._mine.__dict__.get(key)
        if stream is None:
            with self._lock:
                pool = self._streams.get(key)
                if pool is None:
                    pool = self._streams[key] = [torch.cuda.Stream(device)
                                                 for _ in range(COPY_STREAMS)]
                stream = pool[next(self._turn) % len(pool)]
            self._mine.__dict__[key] = stream
        return stream


_copy_streams = _CopyStreams()


class _Slot:
    """One operand's place in a :class:`_StagingBatch`: ``nbytes`` of
    data at byte ``off``, then zeroed slack up to ``span``; staged as a
    ``dtype`` view of ``shape`` (a byte stream: all ``span`` bytes)."""

    __slots__ = ("off", "nbytes", "span", "dtype", "shape")

    def __init__(self, off, nbytes, span, dtype, shape):
        self.off, self.nbytes, self.span = off, nbytes, span
        self.dtype, self.shape = dtype, shape

    def view(self, buf: torch.Tensor) -> torch.Tensor:
        if self.shape is None:
            return buf[self.off:self.off + self.span]
        return buf[self.off:self.off + self.nbytes].view(
            self.dtype).reshape(self.shape)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _StagingBatch:
    """Every transfer of one or more chunks' staging, in one buffer.

    :meth:`put` records an operand (a host array, or a byte stream:
    :class:`_ByteAccum`'s segments, :class:`_MiniblockGather`'s rows) as
    entries of the batch's copy table, its slack as zeros, and returns its
    :class:`_Slot`.  :meth:`pack` lays the slots out in one host buffer
    (pinned for a card) and writes every entry in one C++ call
    (``host.fill_batch``, threaded, the interpreter lock released), the
    slack zeroed (the kernels and gathers read words past a stream's
    end); :meth:`send` copies it to the device in one ``non_blocking``
    copy; :meth:`resolve` swaps each slot of a staged structure for its
    typed view of the device buffer.  On the CPU the host buffer is the
    device buffer."""

    def __init__(self):
        self._slots: List[_Slot] = []
        self.nbytes = 0
        self.host: Optional[torch.Tensor] = None
        self._copies: list = []  # int64[k, 3]: (dst, pointer | 0, bytes)
        self._gathers: list = []  # _MiniblockGather rows
        self._keep: list = []  # the sources, alive until the fill

    def put(self, src, extra: int = 0) -> _Slot:
        off = self.nbytes
        if isinstance(src, np.ndarray):
            src = np.ascontiguousarray(src)
            n, dtype, shape = src.nbytes, _torch_dtype(src.dtype), src.shape
            if n:
                self._copies.append(np.array([[off, src.ctypes.data, n]],
                                             np.int64))
        else:
            n, dtype, shape = len(src), torch.uint8, None
            if isinstance(src, _MiniblockGather):
                self._gathers.append(src.row(off))
            else:
                self._copies.append(src.copies(off))
        span = -(-(n + extra) // _ROUND) * _ROUND
        self._copies.append(np.array([[off + n, 0, span - n]], np.int64))
        self._keep.append(src)
        slot = _Slot(off, n, span, dtype, shape)
        self.nbytes += -(-span // _ALIGN) * _ALIGN
        self._slots.append(slot)
        return slot

    def pack(self, pin: bool) -> torch.Tensor:
        """The host buffer, laid out and filled in one C++ call; each
        operand written once.  ``pin``: page-locked (a failed allocation
        raises)."""
        self.host = torch.empty(self.nbytes, dtype=torch.uint8,
                                pin_memory=pin)
        host.fill_batch(self.host.numpy(), np.concatenate(self._copies),
                        np.array(self._gathers, np.int64).reshape(-1, 6),
                        host.fill_threads(self.nbytes))
        # the host data is not needed past the copy
        self._copies, self._gathers, self._keep = [], [], []
        return self.host

    def send(self, device: torch.device) -> torch.Tensor:
        """The packed buffer on ``device``: one ``non_blocking`` copy on the
        current stream (the host buffer itself on the CPU)."""
        if device.type == "cpu":
            return self.host
        counters.inc("bytes_h2d", self.nbytes)
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        buf.copy_(self.host, non_blocking=True)
        return buf

    def resolve(self, obj, buf: torch.Tensor):
        """``obj`` (tuples, lists, dicts of slots and other values) with
        every slot replaced by its view of ``buf``."""
        if isinstance(obj, _Slot):
            return obj.view(buf)
        if isinstance(obj, tuple):
            return tuple(self.resolve(v, buf) for v in obj)
        if isinstance(obj, list):
            return [self.resolve(v, buf) for v in obj]
        if isinstance(obj, dict):
            return {k: self.resolve(v, buf) for k, v in obj.items()}
        return obj

    def commit(self, staged, device: torch.device,
               side_stream: bool = False) -> tuple:
        """Pack, send and resolve: ``(staged with views, ready)``.  With
        ``side_stream`` a card's copy runs on the calling thread's copy
        stream (one of the device's :data:`COPY_STREAMS`), and ``ready``
        is ``(event, device buffer)``, which :func:`decode_staged` makes
        its stream wait for; else ``ready`` is None and the copy is
        ordered on the current stream."""
        if not self._slots:
            return staged, None
        self.pack(pin=device.type == "cuda")
        if device.type == "cpu" or not side_stream:
            return self.resolve(staged, self.send(device)), None
        stream = _copy_streams.get(device)
        with torch.cuda.stream(stream):
            buf = self.send(device)
            event = torch.cuda.Event()
            event.record(stream)
        return self.resolve(staged, buf), (event, buf)


def _wait_for_copy(meta: dict) -> None:
    """Order the current stream after the staging copy of ``meta``'s chunk
    and tell the allocator that the stream uses its buffer."""
    ready = meta.get("ready")
    if ready is not None:
        event, buf = ready
        stream = torch.cuda.current_stream(buf.device)
        stream.wait_event(event)
        buf.record_stream(stream)


def _nonempty(a: np.ndarray, fill=0) -> np.ndarray:
    """A zero-miniblock chunk (all single-value pages) still gets
    1-element tables, so device gathers have an operand."""
    return a if a.size else np.full(1, fill, np.int64)


def _delta_gather_tables(plan: _Plan) -> tuple:
    """Gather-kernel operands (page_ends, firsts, mb_base, mb_offs,
    mb_widths, mb_mins) as int64 host arrays."""
    page_ends = np.cumsum(plan.d_counts)
    mb_base = np.cumsum(plan.d_mb_counts) - plan.d_mb_counts
    return (page_ends, plan.d_firsts, mb_base, _nonempty(plan.d_mb_offs),
            _nonempty(plan.d_mb_widths, fill=1), _nonempty(plan.d_mb_mins))


class _MiniblockGather:
    """The payloads of one bit width's miniblocks, compacted into one
    stream as the batch writes it: ``nb`` bytes from each byte offset in
    ``starts`` of ``values``, gathered as rows of a sliding window.  The
    writer may truncate the final miniblock's payload: the bytes past the
    stream repeat its last byte (the garbage lands in delta slots past
    the page's value count)."""

    __slots__ = ("values", "starts", "nb")

    def __init__(self, values: np.ndarray, starts: np.ndarray, nb: int):
        self.values = host.as_u8(values)
        self.starts = np.ascontiguousarray(starts, np.int64)
        self.nb = nb

    def __len__(self) -> int:
        return len(self.starts) * self.nb

    def row(self, off: int) -> tuple:
        """Its gather entry of ``host.fill_batch`` at ``off``."""
        return (off, self.values.ctypes.data, len(self.values),
                self.starts.ctypes.data, len(self.starts), self.nb)


def _stage_delta_dense(plan: _Plan, meta: dict, device: torch.device,
                       put=None) -> bool:
    """Host half of the gather-free delta decode: compact all miniblock
    payloads into one contiguous stream per bit width, so the device
    unpacks each with the dense kernel; recorded through ``put``, or
    without it staged on ``device`` in a batch of their own.  Returns
    False for shapes the dense decode doesn't cover (mixed vpm, vpm not a
    multiple of 32, > 512 pages, > 8 distinct widths or a width above 32);
    those use :func:`_delta_decode_multi`."""
    if put is None:
        batch = _StagingBatch()
        if not _stage_delta_dense(plan, meta, device, batch.put):
            return False
        meta["delta_dense"] = batch.commit(meta["delta_dense"], device)[0]
        return True
    if not len(plan.d_counts):
        return False
    vpm = plan.d_vpm
    if len(np.unique(plan.d_vpms)) != 1 or vpm % 32:
        return False
    if len(plan.d_counts) > 512:
        return False
    widths_all = plan.d_mb_widths
    uw = np.unique(widths_all)
    if len(widths_all) == 0 or len(uw) > 8 or int(uw[-1]) > 32:
        return False
    vals_np = plan.values.array()
    boffs = plan.d_mb_offs // 8
    streams, groups = [], []
    for w in uw:
        g = np.flatnonzero(widths_all == w)
        groups.append(g)
        streams.append(put(_MiniblockGather(vals_np, boffs[g],
                                            vpm * int(w) // 8), extra=4))
    perm = None
    if len(uw) > 1:
        # row j of the concatenated unpack holds miniblock order[j]: the
        # inverse permutation restores the original order
        perm = put(np.argsort(np.concatenate(groups)))
    mins = put(plan.d_mb_mins)
    firsts = put(plan.d_firsts)
    meta["delta_dense"] = (tuple(streams), perm, mins, firsts)
    plan.d_dense_static = (vpm, tuple(int(w) for w in uw),
                           tuple(len(g) for g in groups),
                           tuple(int(c) for c in plan.d_counts))
    return True


def stage_levels_on_device(leaf, plan: _Plan) -> bool:
    """Whether the chunk's level streams go to the device: a repeated
    column's always (its offsets assemble there, nulls or not), a flat
    optional column's where a value is null, and never levels the plan
    decoded on the host (a struct chain's, legacy BIT_PACKED ones)."""
    if plan.host_def is not None:
        return False
    return (leaf.max_repetition_level > 0
            or plan.total_values != plan.total_slots)


def _h2d_span(plan: _Plan):
    """The ``device.h2d`` span of one plan's staging (a no-op unless
    tracing is on).  It times the host's packing and the enqueue of the
    copy, and never waits for the device."""
    if not _otrace.TRACE_ENABLED:
        return _otrace.NULL_SPAN
    return _otrace.span("device.h2d", col=plan.leaf.dotted_path
                        if plan.leaf is not None else None,
                        bytes=len(plan.values) + len(plan.levels))


def stage_plan(plan: _Plan, device: torch.device, put=None) -> tuple:
    """H2D: the plan's concatenated level and value byte streams and its
    run tables, dictionary, delta, front-coding and byte-array tables go
    to ``device``.  Returns ``(levels, values, meta)``.

    With ``put`` (a :meth:`_StagingBatch.put`) every transfer is recorded
    in the caller's batch and the result holds its slots until the caller
    commits the batch; without, the plan's own batch is committed here,
    in one copy on the current stream, inside the ``device.h2d`` span."""
    if put is None:
        with _h2d_span(plan):
            batch = _StagingBatch()
            return batch.commit(_stage_plan(plan, device, batch.put),
                                device)[0]
    return _stage_plan(plan, device, put)


def _stage_plan(plan: _Plan, device: torch.device, put) -> tuple:
    kind = plan.value_kind
    stage_levels = stage_levels_on_device(plan.leaf, plan)
    if (stage_levels and len(plan.levels) > dev.MAX_DEVICE_BUF) or \
            len(plan.values) > dev.MAX_DEVICE_BUF:
        raise _Unsupported("stream_bound", f"a chunk stream over "
                           f"{dev.MAX_DEVICE_BUF} bytes")
    if kind == "delta" and len(np.unique(plan.d_vpms)) > 1:
        raise _Unsupported("mixed_delta_vpm", "mixed delta miniblock sizes "
                           "across pages")
    lev_dbuf = None
    if stage_levels and len(plan.levels):
        lev_dbuf = put(plan.levels, extra=12)
    meta = {}
    dense_route = (kind == "dict" and plan.dense_ok
                   and len(plan.dense_pages) > 0)
    delta_dense = kind == "delta" and _stage_delta_dense(plan, meta, device,
                                                         put)
    val_dbuf = None
    if not dense_route and not delta_dense and kind not in (None,
                                                            "host_ba"):
        # staged even when empty (all-null chunks have no value bytes)
        val_dbuf = put(plan.values, extra=12)
    if dense_route:
        meta["dense"] = put(plan.dense, extra=4)
    if kind == "delta" and not delta_dense:
        meta["delta"] = tuple(put(a) for a in _delta_gather_tables(plan))
    if kind == "dict":
        meta["dictionary"] = (
            plan.dictionary_dev if plan.dictionary_dev is not None
            else _stage_dictionary(plan.dictionary_host, put))
    if (kind == "dict" and not dense_route) or kind == "bool":
        meta["vruns"] = tuple(put(a) for a in plan.vruns.run_arrays())
    if kind == "dba":
        tables, total, iters = _dba_tables(plan)
        meta["dba"] = (tuple(put(a) for a in tables), total, iters)
    if kind == "host_ba":
        meta["host_ba"] = tuple(put(a) for a in _host_byte_arrays(plan))
    if plan.host_def is not None and plan.total_values != plan.total_slots:
        meta["host_def"] = put(plan.host_def
                               == plan.leaf.max_definition_level)
    if stage_levels and plan.def_runs.total:
        meta["def_runs"] = tuple(put(a) for a in plan.def_runs.run_arrays())
    if stage_levels and plan.rep_runs.total:
        meta["rep_runs"] = tuple(put(a) for a in plan.rep_runs.run_arrays())
    return lev_dbuf, val_dbuf, meta


def _stage_dictionary(dict_host, put):
    if dict_host is None:
        raise CorruptedError("dictionary-encoded page without a dictionary "
                             "page")
    if isinstance(dict_host, tuple):  # byte arrays: (values, offsets)
        return put(dict_host[0]), put(np.asarray(dict_host[1], np.int64))
    return put(dict_host)


def _dba_tables(plan: _Plan) -> tuple:
    """The front-coding tables of the chunk: ``((prefix_lens,
    suffix_offs, entry_offs), total, iters)`` as int64.  Prefix chains
    never cross pages (every page's first prefix is 0), so the entries
    concatenate freely, suffix offsets rebased by each page's base in the
    staged suffix stream; ``entry_offs`` doubles as the column's
    offsets."""
    entry_offs = np.zeros(len(plan.dba_plens) + 1, np.int64)
    np.cumsum(plan.dba_plens + plan.dba_slens, out=entry_offs[1:])
    return ((plan.dba_plens, plan.dba_soffs, entry_offs),
            int(entry_offs[-1]), dev.delta_byte_array_iters(plan.dba_plens))


def _host_byte_arrays(plan: _Plan) -> tuple:
    """The chunk's PLAIN and DELTA_LENGTH byte-array pages as one fresh
    ``(values, offsets int64)`` pair on the host: one C++ call scans the
    PLAIN pages' offsets and compacts every page's values."""
    return host.byte_array_parts(plan.hb_parts, plan.hb_lens)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _low32_to_int32(x: torch.Tensor) -> torch.Tensor:
    """The int32 with the low 32 bits of each int64 (two's-complement
    wrap)."""
    x = x & _M32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _delta_decode_dense(streams, perm, mins, firsts, vpm: int, gw: tuple,
                        gk: tuple, pcounts: tuple,
                        physical: Type) -> torch.Tensor:
    """Gather-free multi-page delta decode (device half): one dense unpack
    per miniblock width, the miniblock order restored, per-page
    reassembly by slicing (page structure is host metadata) and a
    segmented prefix sum.  Sums run in int64 with two's-complement wrap:
    exactly the encoding's mod-2^64 arithmetic, and for INT32 its low 32
    bits."""
    device = mins.device
    parts = []
    for buf, w, k in zip(streams, gw, gk):
        if w == 0:
            # constant stride: every delta equals its min_delta
            parts.append(torch.zeros((k, vpm), dtype=torch.int64,
                                     device=device))
            continue
        words = buf.view(torch.int32)
        up = kernels.unpack_bits_dense(words, k * vpm, w)
        parts.append((up.to(torch.int64) & _M32).reshape(k, vpm))
    d2 = parts[0] if len(parts) == 1 else torch.cat(parts)
    if perm is not None:
        d2 = d2[perm]
    deltas = (d2 + mins[:, None]).reshape(-1)
    seq_parts = []
    mbb = 0
    for p, cnt in enumerate(pcounts):
        if cnt == 0:  # an all-null page stores no values
            continue
        seq_parts.append(firsts[p:p + 1])
        nd = cnt - 1
        seq_parts.append(deltas[mbb * vpm:mbb * vpm + nd])
        mbb += (nd + vpm - 1) // vpm
    seq = torch.cat(seq_parts) if seq_parts else deltas[:0]
    gcum = _segmented_cumsum(seq, pcounts)
    if physical == Type.INT32:
        return _low32_to_int32(gcum)
    return gcum


def _segmented_cumsum(seq: torch.Tensor, pcounts) -> torch.Tensor:
    """Prefix sums that restart at every page: the global cumsum minus the
    running total before each page."""
    gcum = torch.cumsum(seq, 0)
    if len(pcounts) > 1:
        counts = np.asarray(pcounts, np.int64)
        starts = np.cumsum(counts) - counts
        later = np.flatnonzero((starts > 0) & (counts > 0))
        before = torch.zeros(len(counts), dtype=torch.int64,
                             device=seq.device)
        before[torch.as_tensor(later, device=seq.device)] = gcum[
            torch.as_tensor(starts[later] - 1, device=seq.device)]
        gcum = gcum - torch.repeat_interleave(
            before, torch.as_tensor(counts, device=seq.device))
    return gcum


def _delta_decode_multi(buf: torch.Tensor, n: int, page_ends, firsts,
                        mb_base, mb_offs, mb_widths, mb_mins, vpm: int,
                        physical: Type) -> torch.Tensor:
    """All delta pages of a chunk in one gather-driven pass: each value
    finds its page, miniblock and bit position; seq[i] is the page's first
    value at a page start, else the unpacked delta; the output is the
    segmented prefix sum of seq."""
    device = buf.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    page = torch.searchsorted(page_ends, idx, right=True)
    page = page.clamp_(max=page_ends.shape[0] - 1)
    pcounts = torch.diff(page_ends, prepend=page_ends.new_zeros(1))
    pstart = page_ends[page] - pcounts[page]
    within = idx - pstart
    jc = (within - 1).clamp_(min=0)  # delta ordinal (page starts unused)
    mb = mb_base[page] + jc // vpm
    mb = mb.clamp_(max=mb_widths.shape[0] - 1)
    woff = jc % vpm
    w = mb_widths[mb]
    bit_pos = mb_offs[mb] + woff * w
    if physical == Type.INT32:
        raw = dev.unpack_bits_at32(buf, bit_pos, w)
    else:
        raw = dev.unpack_bits_at64(buf, bit_pos, w)
    delta = raw + mb_mins[mb]
    seq = torch.where(within == 0, firsts[page], delta)
    gcum = torch.cumsum(seq, 0)
    base = gcum[pstart] - seq[pstart]  # exclusive cumsum at page start
    out = gcum - base
    if physical == Type.INT32:
        return _low32_to_int32(out)
    return out


def _fusable(dictionary) -> bool:
    """Whether the fused unpack+gather kernel takes this dictionary: a 1-D
    tensor of 4- or 8-byte values of at most ``kernels.MAX_FUSED_DICT``
    entries (byte-array, fixed-length, INT96 and boolean dictionaries
    unpack their indexes and gather, as in the JAX package)."""
    return (isinstance(dictionary, torch.Tensor) and dictionary.dim() == 1
            and dictionary.element_size() in (4, 8)
            and dictionary.shape[0] <= kernels.MAX_FUSED_DICT)


def _decode_dense_dict(plan: _Plan, dense_buf: torch.Tensor, dictionary,
                       keep_dictionary: bool = False):
    """Dict-index decode from the compacted dense stream.  A fusable
    dictionary takes the fused unpack+gather kernel (no index stream)
    unless ``keep_dictionary`` asks for the indexes; every other one
    unpacks the indexes, and all but a byte-array dictionary (which stays
    encoded) and a kept one gather.  Returns (indices or None, values or
    None)."""
    w = plan.dense_w
    # round UP to whole 32-value groups: the last page's tail group may be
    # partial byte-wise; the unpack kernels zero-pad missing words
    total = -(-(len(plan.dense) * 8 // w) // 32) * 32
    nwords = (len(plan.dense) + 3) // 4
    words = dense_buf[:nwords * 4].view(torch.int32)
    if _fusable(dictionary) and not keep_dictionary:
        allvals = kernels.dict_unpack_gather(words, dictionary, total, w)
        return None, _page_slices(allvals, plan.dense_pages)
    allidx = kernels.unpack_bits_dense(words, total, w)
    indices = _page_slices(allidx, plan.dense_pages)
    if isinstance(dictionary, tuple) or keep_dictionary:
        return indices, None
    return indices, dev.dict_gather(dictionary, indices)


def _page_slices(x: torch.Tensor, pages: np.ndarray) -> torch.Tensor:
    parts = [x[s:s + n] for s, n in pages.tolist()]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _bss_decode(buf: torch.Tensor, pages, width: int,
                physical: Type) -> torch.Tensor:
    """Byte-stream-split pages: plane k of a page is a static slice of the
    staged stream, so each page is one transpose.  Fixed-length byte
    arrays stay (n, width) bytes; the other types take their physical
    dtype (an INT32 column is int32, not float32)."""
    dtype = (None if physical == Type.FIXED_LEN_BYTE_ARRAY
             else PHYSICAL_TORCH_DTYPE[physical])
    pages = pages.tolist()
    if len(pages) == 1 and pages[0][0] == 0:
        return dev.byte_stream_split(buf, pages[0][1], width, dtype)
    parts = [buf[b:b + width * n].reshape(width, n).T for b, n in pages]
    rows = (torch.cat(parts) if parts
            else buf.new_zeros((0, width)))
    return rows if dtype is None else rows.view(dtype).reshape(-1)


def decode_staged(plan: _Plan, staged: tuple, device: torch.device,
                  keep_levels: bool = False,
                  keep_dictionary: bool = False) -> Column:
    """Device decode phase: staged tensors -> :class:`Column`, in the
    profiler region ``pq.decode_staged:<value kind>``.  With
    ``keep_levels`` a repeated column (and a struct chain) also keeps its
    Dremel level streams on the host (``def_levels``, ``rep_levels``).
    With ``keep_dictionary`` a dictionary-encoded chunk of any physical
    type stays ``(dictionary, dict_indices)`` on the device (``values``
    None): its indexes unpack, nothing gathers."""
    with annotate(f"pq.decode_staged:{plan.value_kind}"):
        return _decode_staged(plan, staged, device, keep_levels,
                              keep_dictionary)


def _decode_staged(plan: _Plan, staged: tuple, device: torch.device,
                   keep_levels: bool, keep_dictionary: bool) -> Column:
    leaf, physical = plan.leaf, plan.physical
    lev_dbuf, val_dbuf, meta = staged
    _wait_for_copy(meta)
    max_def = leaf.max_definition_level
    validity = def_host = rep_host = None
    list_offsets, list_validity = [], []
    if leaf.max_repetition_level:
        list_offsets, list_validity, validity, d, r = _assemble(
            plan, lev_dbuf, meta, device)
        if keep_levels:  # one copy a stream
            def_host, rep_host = d.cpu().numpy(), r.cpu().numpy()
    elif plan.total_values != plan.total_slots:
        if plan.def_runs.total:
            def_levels = plan.def_runs.expand(lev_dbuf, meta["def_runs"])
            validity = dev.validity_from_def(def_levels, max_def)
            if keep_levels and max_def > 1:
                def_host = def_levels.cpu().numpy().astype(np.int32)
        elif plan.host_def is not None:
            validity = meta["host_def"]
            if max_def > 1:  # a struct chain keeps its levels
                def_host = plan.host_def.astype(np.int32)

    dictionary = dict_indices = offsets = None
    kind = plan.value_kind
    nvals = plan.total_values
    if kind == "plain_fixed":
        if physical == Type.INT96:
            values = val_dbuf[:nvals * 12].view(torch.int32).reshape(nvals,
                                                                     3)
        elif PHYSICAL_WIDTH[physical] == 8:
            values = dev.bitcast_fixed64(val_dbuf, nvals,
                                         PHYSICAL_TORCH_DTYPE[physical])
        else:
            values = dev.bitcast_fixed32(val_dbuf, nvals,
                                         PHYSICAL_TORCH_DTYPE[physical])
    elif kind == "plain_flba":
        w = leaf.type_length
        values = val_dbuf[:nvals * w].reshape(nvals, w)
    elif kind == "bool":
        values = plan.vruns.expand(val_dbuf, meta["vruns"]) != 0
    elif kind == "dict":
        dictionary = meta["dictionary"]
        if meta.get("dense") is not None:
            dict_indices, values = _decode_dense_dict(
                plan, meta["dense"], dictionary, keep_dictionary)
        else:
            dict_indices = plan.vruns.expand(val_dbuf, meta["vruns"])
            values = (None if isinstance(dictionary, tuple)
                      or keep_dictionary
                      else dev.dict_gather(dictionary, dict_indices))
    elif kind == "delta":
        if meta.get("delta_dense") is not None:
            streams, perm, mins, firsts = meta["delta_dense"]
            vpm, gw, gk, pcounts = plan.d_dense_static
            values = _delta_decode_dense(streams, perm, mins, firsts, vpm,
                                         gw, gk, pcounts, physical)
        else:
            values = _delta_decode_multi(val_dbuf, int(plan.d_counts.sum()),
                                         *meta["delta"], plan.d_vpm,
                                         physical)
    elif kind == "bss":
        w = (leaf.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
             else PHYSICAL_WIDTH[physical])
        values = _bss_decode(val_dbuf, plan.bss_pages, w, physical)
    elif kind == "dba":
        tables, total, iters = meta["dba"]
        values = dev.delta_byte_array_expand(val_dbuf, *tables, total, iters)
        if physical == Type.FIXED_LEN_BYTE_ARRAY:
            values = values.reshape(-1, leaf.type_length)
        else:
            offsets = tables[2]
    elif kind == "host_ba":
        values, offsets = meta["host_ba"]
    else:  # no data pages
        values = empty_values(physical, leaf.type_length, device)
        if physical == Type.BYTE_ARRAY:
            offsets = torch.zeros(1, dtype=torch.int64, device=device)
    col = Column(leaf=leaf, values=values, offsets=offsets,
                 validity=validity, num_slots=plan.total_slots,
                 dictionary=dictionary, dict_indices=dict_indices,
                 list_offsets=list_offsets, list_validity=list_validity,
                 def_levels=def_host, rep_levels=rep_host)
    if col.num_values != nvals:
        raise CorruptedError(
            f"column {leaf.name!r}: decoded {col.num_values} values, the "
            f"pages declare {nvals}")
    return col


def _assemble(plan: _Plan, lev_dbuf, meta: dict,
              device: torch.device) -> tuple:
    """A repeated column's level streams, expanded and assembled on the
    device: ``(list_offsets, list_validity, leaf_validity, def, rep)``."""
    leaf = plan.leaf
    if plan.def_runs.total:
        d = plan.def_runs.expand(lev_dbuf, meta["def_runs"])
        r = plan.rep_runs.expand(lev_dbuf, meta["rep_runs"])
    else:  # no data pages
        d = r = torch.zeros(0, dtype=torch.int32, device=device)
    infos = levels.repeated_ancestors(leaf)
    if len(infos) == 1:
        got = dev.assemble_single_list(d, r, infos[0].def_level,
                                       leaf.max_definition_level)
    else:
        got = dev.assemble_nested(d, r, infos, leaf.max_definition_level)
    return (*got, d, r)


# ---------------------------------------------------------------------------
# The read's pipeline
# ---------------------------------------------------------------------------

#: the device read's pipeline, as the JAX package's counters: the most
#: chunks prescanned and staged at once, and the chunks decoded on the
#: device and on the host route
PIPELINE = {"stage_concurrency_peak": 0, "chunks_device_decoded": 0,
            "chunks_host_fallback": 0}

def reset_pipeline() -> None:
    for k in PIPELINE:
        PIPELINE[k] = 0


def _prepare(reader, device: torch.device, pages=None, dictionary=None,
             dictionary_dev=None) -> tuple:
    """Prescan, staging batch packed, copy enqueued on the calling thread's
    copy stream, in the profiler region ``pq.prepare_chunk``: ``(plan,
    staged)``."""
    with annotate("pq.prepare_chunk"):
        plan = build_plan(reader, pages, dictionary)
        plan.dictionary_dev = dictionary_dev
        with _h2d_span(plan):
            batch = _StagingBatch()
            staged = stage_plan(plan, device, batch.put)
            staged, ready = batch.commit(staged, device, side_stream=True)
    if ready is not None:
        staged[2]["ready"] = ready
    return plan, staged


def decode_chunk_span(reader, device, pages=None,
                      keep_levels: bool = False,
                      keep_dictionary: bool = False) -> Column:
    """One chunk, or the span ``pages`` of it (a dictionary page first, as
    ``io/search.py::pages_and_base`` gives them), decoded on ``device`` in
    one plan, its level streams kept where ``keep_levels`` asks and a
    dictionary chunk left encoded where ``keep_dictionary`` does
    (:func:`decode_staged`); a chunk the device route refuses decodes on
    the host, counted in :data:`HOST_ROUTE`."""
    from ..io.reader import decode_chunk_host

    device = torch.device(device)
    dictionary = None
    if pages is not None:
        data = []
        for page in pages:
            if page.page_type == PageType.DICTIONARY_PAGE:
                dictionary = decode_dictionary_page(reader, page)
            elif page.page_type in (PageType.DATA_PAGE,
                                    PageType.DATA_PAGE_V2):
                data.append(page)
        pages = PageTable.of(data)
    try:
        plan, staged = _prepare(reader, device, pages, dictionary)
        col = decode_staged(plan, staged, device, keep_levels=keep_levels,
                            keep_dictionary=keep_dictionary)
        counters.inc("chunks_device_decoded")
        return col
    except _Unsupported as e:
        HOST_ROUTE[e.reason] += 1
        counters.inc("chunks_host_fallback")
        return decode_chunk_host(reader, device, pages=pages,
                                 dictionary=dictionary,
                                 keep_dictionary=keep_dictionary)


def prepare_chunk(reader, device) -> tuple:
    """Host phase of one chunk's device decode: the prescan, its staging
    batch packed and the batch's one copy enqueued (on a card, on the
    calling thread's copy stream; :func:`decode_staged` waits for it).
    Returns ``(plan, staged)``; safe on worker threads."""
    return _prepare(reader, torch.device(device))


def prepare_chunks_batched(readers, device) -> list:
    """Host phase of many chunks' device decode with one staging batch and
    one copy: each chunk prescans and stages as :func:`prepare_chunk`, its
    transfers recorded in the shared batch.  Returns ``[(reader, (plan,
    staged) | None, error)]`` in input order, a chunk the device route
    refuses carrying its ``_Unsupported`` as the error."""
    device = torch.device(device)
    batch = _StagingBatch()
    entries = []
    with annotate("pq.prepare_chunks_batched"):
        for reader in readers:
            try:
                plan = build_plan(reader)
                with _h2d_span(plan):
                    staged = stage_plan(plan, device, batch.put)
                entries.append((reader, plan, staged, None))
            except _Unsupported as e:
                entries.append((reader, None, None, e))
        staged_all, ready = batch.commit([e[2] for e in entries], device,
                                         side_stream=True)
    out = []
    for (reader, plan, _, err), staged in zip(entries, staged_all):
        if err is None and ready is not None:
            staged[2]["ready"] = ready
        out.append((reader, None if err is not None else (plan, staged),
                    err))
    return out


def _native_threads(workers: int) -> int:
    """Native threads (batched page decompression) a staging worker may
    use: the cores this process may use, shared by the workers."""
    return max(1, host.available_cpus() // workers)


def _concat_batch_columns(leaf, cols: List[Column]) -> Column:
    """The page batches of one flat chunk as one column: values,
    dictionary indexes and validity concatenated, byte-array offsets
    rebased, the shared dictionary kept.  Indexes stay only where every
    batch has them (the fused kernel makes none)."""
    if len(cols) == 1:
        return cols[0]
    from ..io.column import _concat_byte_arrays, _concat_validity

    first = cols[0]
    values = offsets = indices = None
    if all(c.dict_indices is not None for c in cols):
        indices = torch.cat([c.dict_indices for c in cols])
    if first.offsets is not None:
        values, offsets = _concat_byte_arrays([c.values for c in cols],
                                              [c.offsets for c in cols])
    elif first.values is not None:
        values = torch.cat([c.values for c in cols])
    return Column(leaf=leaf, values=values, offsets=offsets,
                  validity=_concat_validity(cols),
                  num_slots=sum(c.num_slots for c in cols),
                  dictionary=first.dictionary, dict_indices=indices)


_MIN_BATCHES = 2  # page batches a chunk must make to be pipelined
_TARGET_BATCHES = 6  # batches of at least 8 pages a chunk is cut into


def decode_chunk_batched(reader, device, workers: int = 2) -> Column:
    """One chunk pipelined over its page batches: batches prescan and
    stage on ``workers`` threads while this thread decodes the batches
    before them, the dictionary decoded and staged once and shared.
    Flat columns only (no repeated level, ``max_def <= 1``); a nested
    column, too few pages for two batches, a dictionary page not
    first, or value kinds that differ between batches (a dictionary that
    falls back to PLAIN) raise ``_Unsupported``, and the caller decodes
    the chunk in one plan.  Any other error raises as the one-plan decode
    raises it."""
    device = torch.device(device)
    leaf = reader.leaf
    if leaf.max_repetition_level > 0 or leaf.max_definition_level > 1:
        raise _Unsupported("batched", "page batches of a nested column")
    pages = page_table_of(reader)
    types = pages.rows[:, host.PG_TYPE]
    data = np.flatnonzero((types == PageType.DATA_PAGE)
                          | (types == PageType.DATA_PAGE_V2))
    per = max(8, -(-len(data) // _TARGET_BATCHES))
    batches = [pages[data[i:i + per]] for i in range(0, len(data), per)]
    if len(batches) < _MIN_BATCHES:
        raise _Unsupported("batched", "too few pages to pipeline")
    dictionary = dictionary_dev = None
    if len(pages) > len(data):
        if types[0] != PageType.DICTIONARY_PAGE or len(pages) \
                != len(data) + 1:
            raise _Unsupported("batched", "a dictionary page not first")
        dictionary = decode_dictionary_page(reader, pages.info(0))
        batch = _StagingBatch()
        dictionary_dev = batch.commit(_stage_dictionary(
            dictionary, batch.put), device)[0]
    threads = _native_threads(workers)

    def prep(subset):
        with host.native_thread_cap(threads):
            return _prepare(reader, device, subset, dictionary,
                            dictionary_dev)

    from ..utils.pool import instrument_task

    cols = []
    pool = ThreadPoolExecutor(max_workers=max(workers, 1),
                              thread_name_prefix="pqt-prepare")
    try:
        # each task runs in a copy of this context: the op scope (the
        # preads' bytes, the spans' track) follows it onto the worker
        futs = [pool.submit(instrument_task(prep, name="prepare_batch"), b)
                for b in batches]
        kind = None
        for i, fut in enumerate(futs):
            plan, staged = fut.result()
            futs[i] = None  # staged memory bounded to the batches in flight
            if i and plan.value_kind != kind:
                raise _Unsupported("batched", "value kinds differ between "
                                   "page batches")
            kind = plan.value_kind
            cols.append(decode_staged(plan, staged, device))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return _concat_batch_columns(leaf, cols)


def decode_chunks_pipelined(chunks: Iterable, device,
                            workers: int = 2) -> Iterator[Column]:
    """Decode column chunks on ``device``, yielded in chunk order.

    ``workers`` threads prescan, pack and copy later chunks
    (:func:`prepare_chunk`, each copy on the worker's copy stream) while
    this thread decodes earlier ones, at most ``workers + 1`` chunks in
    flight; a lone chunk is pipelined over its page batches
    (:func:`decode_chunk_batched`) where this process may use more than
    one core.  Every file's chunk ranges are planned on its readahead
    prefetcher first (``io/prefetch.py``, mapped files only).  A chunk
    the device route refuses (``_Unsupported``, and no other error)
    decodes on the host on this thread and is counted in
    :data:`HOST_ROUTE`; any other error raises at its chunk's turn.
    Closing the generator waits out the chunks in flight and leaves no
    thread.  ``workers=0`` runs plan, stage and decode one chunk after
    another on this thread."""
    from ..io.prefetch import make_chunk_prefetcher

    device = torch.device(device)
    chunks = list(chunks)
    if workers <= 0:
        yield from _decode_serial(chunks, device)
        return
    with contextlib.ExitStack() as stack:
        prefetchers = {}
        for reader in chunks:
            f = reader.file
            if id(f) not in prefetchers:
                pre = prefetchers[id(f)] = make_chunk_prefetcher(f.source)
                if pre is not None:
                    stack.callback(pre.close)
                    stack.enter_context(f._source_override(pre))
            if prefetchers[id(f)] is not None:
                prefetchers[id(f)].plan(*reader.byte_range)
        yield from _decode_pipelined(chunks, device, workers)


def _host_route(reader, err: _Unsupported, device) -> Column:
    from ..io.reader import decode_chunk_host

    HOST_ROUTE[err.reason] += 1
    PIPELINE["chunks_host_fallback"] += 1
    counters.inc("chunks_host_fallback")
    return decode_chunk_host(reader, device)


def _decode_serial(chunks, device) -> Iterator[Column]:
    for reader in chunks:
        try:
            plan = build_plan(reader)
            col = decode_staged(plan, stage_plan(plan, device), device)
        except _Unsupported as e:
            col = _host_route(reader, e, device)
        else:
            PIPELINE["chunks_device_decoded"] += 1
            counters.inc("chunks_device_decoded")
        yield col


def _decode_pipelined(chunks, device, workers: int) -> Iterator[Column]:
    if len(chunks) == 1 and host.available_cpus() > 1:
        try:
            col = decode_chunk_batched(chunks[0], device, workers)
        except _Unsupported:
            pass  # the one-plan path below decides
        else:
            PIPELINE["chunks_device_decoded"] += 1
            counters.inc("chunks_device_decoded")
            yield col
            return
    threads = _native_threads(workers)
    lock = threading.Lock()
    active = [0]

    def prep(reader):
        with lock:
            active[0] += 1
            PIPELINE["stage_concurrency_peak"] = max(
                PIPELINE["stage_concurrency_peak"], active[0])
            counters.high_water("stage_concurrency_peak", active[0])
        try:
            with host.native_thread_cap(threads):
                return prepare_chunk(reader, device), None
        except _Unsupported as e:
            return None, e
        finally:
            with lock:
                active[0] -= 1

    from ..utils.pool import instrument_task

    def submit(reader):
        # in a copy of the consumer's context at this pull: the op scope
        # follows the chunk's preparation onto the worker
        return pool.submit(instrument_task(prep, name="prepare_chunk"),
                           reader)

    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="pqt-prepare")
    pending = collections.deque()
    try:
        it = iter(chunks)
        pending.extend((r, submit(r)) for r in itertools.islice(
            it, workers + 1))
        while pending:
            reader, fut = pending.popleft()
            prepped, err = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, submit(nxt)))
            if err is not None:
                col = _host_route(reader, err, device)
            else:
                col = decode_staged(*prepped, device)
                PIPELINE["chunks_device_decoded"] += 1
                counters.inc("chunks_device_decoded")
            del prepped
            yield col
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        # a failure's traceback keeps this frame: drop the chunks staged
        # ahead now, not when the collector breaks that cycle
        pending.clear()
