"""Parquet writer for columns of every physical type, flat or nested.

The port's cut of ``parquet_tpu/io/writer.py`` (``ParquetWriter``,
``write_table``, ``WriterOptions`` with the same size defaults).  Leaves
are required, optional or under repeated groups (lists, maps, structs at
any depth, through a ``schema`` built with ``schema/schema.py``'s
builders), of BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE,
BYTE_ARRAY (optionally annotated as UTF-8 strings) or FIXED_LEN_BYTE_ARRAY;
each chunk is PLAIN, RLE_DICTIONARY (with its dictionary page),
DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, RLE (booleans),
DELTA_LENGTH_BYTE_ARRAY or DELTA_BYTE_ARRAY, in v1 or v2 data pages,
UNCOMPRESSED, GZIP, SNAPPY, ZSTD, LZ4_RAW, LZ4 or BROTLI.  As the
reference's writer does, it writes chunk and page statistics (byte arrays
in unsigned lexicographic order, page-index bounds truncated to 64
bytes), the page index (column index with its boundary order, and offset
index), split-block bloom filters for the columns named in
``WriterOptions.bloom_filters`` (any physical type but BOOLEAN and INT96)
and the row groups' ``sorting_columns``;
the bloom filters, then the page index, go between the last row group
and the footer.  Dictionaries keep first-seen order, and the
reference's rules choose them: at most ``n / 2 + 16`` entries and
``dictionary_page_limit`` bytes, two sample windows that both predict
more entries than that skip the build of a long chunk, and once
a chunk with values overflows, every later row group of its column is
PLAIN.  Each page header carries the
CRC32 of the page's stored bytes (``WriterOptions.write_crc``, on by
default), which ``ReadOptions(verify_crc=True)`` and ``verify_file``
check.

``write_table`` takes ``{name: array}``: a numpy array is a required
column, a ``numpy.ma.MaskedArray`` an optional one whose masked slots are
null.  bool arrays are BOOLEAN, 1-D object arrays of ``bytes`` (or
``str``, written as UTF-8 strings) BYTE_ARRAY, ``(n, 3)`` int32 arrays
INT96 and ``(n, w)`` uint8 arrays FIXED_LEN_BYTE_ARRAY(w).  A
:class:`ColumnData` (values, offsets for byte arrays, validity, and for a
nested leaf its list offsets and validity per repeated level, or its raw
levels) is taken as it is, keyed by the leaf's dotted path, with the
``schema`` passed beside the table.  Levels come from ``ops/levels.py``
(``levels_for_flat``, ``levels_for_list``, ``levels_for_nested``); a data
page holds whole rows, its ``num_values`` counts level slots, and the
offset index's ``first_row_index`` counts rows.  The arrays may also be
torch tensors, on the CPU or on a card: each is copied to the host once,
on the caller's thread, before its encode starts.

The write is pipelined, as the JAX package's is: a chunk's encode is pure
and knows no file offset (:class:`_EncodedChunk`), and ``_emit_chunk``
assigns the offsets in order, so ``write_row_group`` encodes row group
N+1 on the shared pool (``utils/pool.py``) while row group N's pages go
out.  N+1's encode starts only after N's has finished, so the bytes are
the same with the overlap on or off.  The pages go out on the caller's
thread: the JAX package's background emitter (its write depth of 2 or
more) is not ported.  ``PARQUET_TPU_TORCH_WRITE_OVERLAP`` is ``off``, auto (more than one core
and 8 MiB of input a row group) or ``force``.  A path is written through
``io/sink.py``: to a temp file beside it, fsynced and renamed over the
destination at close (``WriterOptions.atomic_commit``, ``fsync``), behind
a :class:`~parquet_tpu_torch.io.sink.BufferedSink` that coalesces the
page writes into vectored flushes (``PARQUET_TPU_TORCH_WRITE_BUFFER``,
auto-tuned unless pinned); ``abort`` leaves neither the destination nor
the temp file.  ``ParquetWriter.write_stats`` meters the pipeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import struct
import time
import zlib
from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import codecs
from ..format import metadata as md
from ..format import thrift
from ..format.enums import (BoundaryOrder, CompressionCodec, Encoding,
                            PageType, Type)
from ..format.enums import FieldRepetitionType as Rep
from ..errors import MAX_ROW_GROUPS, TooManyRowGroupsError
from ..obs import scope as _oscope
from ..obs import trace as _otrace
from ..ops import host, levels, ref
from ..schema.schema import Leaf, Schema
from ..schema.types import (NUMERIC, PHYSICAL_NP_DTYPE, physical_of_dtype,
                            value_width)
from ..utils.env import env_str
from ..utils.pool import cancel_futures, in_shared_pool
from ..utils.pool import submit as pool_submit
from .sink import (AtomicFileSink, BufferedSink, FileSink, WriteStats,
                   write_autotune)

DEFAULT_CREATED_BY = "parquet_tpu_torch"

# under this much input a row group, the pool's dispatch and the overlap's
# bookkeeping cost more than they hide (the JAX package's crossover)
_PARALLEL_ENCODE_BYTES = 8 << 20

_CODEC_NAMES = {"none": CompressionCodec.UNCOMPRESSED,
                "uncompressed": CompressionCodec.UNCOMPRESSED,
                "gzip": CompressionCodec.GZIP,
                "snappy": CompressionCodec.SNAPPY,
                "zstd": CompressionCodec.ZSTD,
                "lz4_raw": CompressionCodec.LZ4_RAW,
                "lz4": CompressionCodec.LZ4,
                "brotli": CompressionCodec.BROTLI}

# the encodings a column may be forced to, by physical type (dictionary
# encoding writes RLE_DICTIONARY pages after a PLAIN dictionary page)
_ENCODABLE = {
    Encoding.PLAIN: tuple(Type),
    Encoding.RLE_DICTIONARY: tuple(t for t in Type if t != Type.BOOLEAN),
    Encoding.DELTA_BINARY_PACKED: (Type.INT32, Type.INT64),
    Encoding.BYTE_STREAM_SPLIT: NUMERIC + (Type.FIXED_LEN_BYTE_ARRAY,),
    Encoding.RLE: (Type.BOOLEAN,),
    Encoding.DELTA_LENGTH_BYTE_ARRAY: (Type.BYTE_ARRAY,),
    Encoding.DELTA_BYTE_ARRAY: (Type.BYTE_ARRAY,),
}
_WRITE_ENCODINGS = tuple(_ENCODABLE)

# page-index bounds of byte arrays are cut to this many bytes (the
# reference writer's default column_index_truncate_length)
COLUMN_INDEX_TRUNCATE = 64


@dataclass
class WriterOptions:
    """Writer knobs, with the JAX package's size defaults."""

    compression: Union[str, CompressionCodec] = CompressionCodec.SNAPPY
    data_page_version: int = 1
    data_page_size: int = 1 << 20  # bytes of values per page
    row_group_size: int = 1 << 20  # max rows per row group
    # dictionary-encode columns with no forced encoding, while the
    # dictionary fits dictionary_page_limit bytes; PLAIN beyond it
    dictionary: bool = True
    dictionary_page_limit: int = 1 << 20
    # name -> an encoding of _ENCODABLE for the column's type
    column_encoding: Dict[str, Encoding] = dc_field(default_factory=dict)
    created_by: str = DEFAULT_CREATED_BY
    write_statistics: bool = True
    write_page_index: bool = True
    # a CRC32 of each page's stored bytes in its header, which
    # ReadOptions(verify_crc=True) checks
    write_crc: bool = True
    # column name -> bloom filter bits per value
    bloom_filters: Dict[str, float] = dc_field(default_factory=dict)
    # (column name, descending, nulls_first), recorded in every row group
    sorting_columns: List[Tuple[str, bool, bool]] = dc_field(
        default_factory=list)
    # a path is written to <dest>.<rand>.tmp, fsynced and renamed over the
    # destination at close: the destination is absent or whole, never
    # torn (io/sink.py); False writes the path in place
    atomic_commit: bool = True
    fsync: bool = True

    def __post_init__(self):
        if self.row_group_size < 1:
            raise ValueError("row_group_size must be >= 1")
        if self.data_page_size < 1:
            raise ValueError("data_page_size must be >= 1")
        if self.data_page_version not in (1, 2):
            raise ValueError("data_page_version must be 1 or 2")
        for name, enc in self.column_encoding.items():
            if Encoding(enc) not in _WRITE_ENCODINGS:
                raise ValueError(f"column {name!r}: cannot write "
                                 f"{Encoding(enc).name}")

    def codec_id(self) -> CompressionCodec:
        if isinstance(self.compression, str):
            return _CODEC_NAMES[self.compression.lower()]
        return CompressionCodec(self.compression)


@dataclass
class ColumnData:
    """One leaf's input: dense present values (byte arrays: their bytes and
    ``offsets[n + 1]``) and their structure.  ``validity`` is one bool per
    slot of a flat leaf, or per innermost element of a repeated one.  A
    leaf under repeated groups gives ``list_offsets``, one array a
    repeated level, outermost first, and ``list_validity`` (the same, or
    None; a None entry for a level with no null list); a leaf may instead
    give its raw ``def_levels`` and ``rep_levels`` (a struct chain with
    null structs gives its def levels)."""

    values: np.ndarray
    validity: Optional[np.ndarray] = None  # None: no null value
    offsets: Optional[np.ndarray] = None  # BYTE_ARRAY only
    list_offsets: Optional[List[np.ndarray]] = None
    list_validity: Optional[List[Optional[np.ndarray]]] = None
    def_levels: Optional[np.ndarray] = None
    rep_levels: Optional[np.ndarray] = None


@dataclass
class _EncodedChunk:
    """One chunk's pages, encoded and knowing no file offsets: what the
    encode phase hands the emit phase."""

    leaf: Leaf
    dict_page: Optional[tuple]  # (PageHeader, stored bytes)
    pages: List[tuple]  # (PageHeader, stored bytes, first row)
    stats: Optional[md.Statistics]
    column_index: Optional[md.ColumnIndex]
    bloom_blob: Optional[bytes]
    encodings: set
    n_slots: int


def _overlap_mode() -> str:
    """``PARQUET_TPU_TORCH_WRITE_OVERLAP`` as off, auto or force."""
    v = env_str("PARQUET_TPU_TORCH_WRITE_OVERLAP").lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    return "force" if v == "force" else "auto"


class ParquetWriter:
    """Write row groups to a path or a binary file object; the footer goes
    out on :meth:`close`.  :meth:`write` buffers rows and writes each row
    group of ``options.row_group_size`` rows as it fills; the tail waits
    for :meth:`flush` or :meth:`close`.  A path is committed atomically
    (``WriterOptions.atomic_commit``) through a coalescing
    :class:`~parquet_tpu_torch.io.sink.BufferedSink`; :meth:`abort`
    discards the file (a path leaves no destination and no temp file).
    ``write_stats`` (:class:`~parquet_tpu_torch.io.sink.WriteStats`)
    meters the pipeline, and reaches the registry once, at the commit.
    The writer's lifetime is one op (``write.file``), active around each
    public call and finished at close or abort, unless a caller's op
    scope is active at that call."""

    def __init__(self, sink, schema: Schema,
                 options: Optional[WriterOptions] = None):
        self.schema = schema
        self.options = options or WriterOptions()
        self.write_stats = WriteStats()
        self._codec = codecs.get_codec(self.options.codec_id())
        self._own_sink = isinstance(sink, (str, os.PathLike))
        self._op = (_oscope.OpScope(
            "write.file", {"sink": os.fspath(sink) if self._own_sink
                           else type(sink).__name__})
            if _oscope.current_op() is None else None)
        if self._own_sink:
            opts = self.options
            base = (AtomicFileSink(sink, fsync=opts.fsync)
                    if opts.atomic_commit
                    else FileSink(sink, fsync=opts.fsync))
            try:
                # the magic goes through the base sink, so an unwritable
                # sink fails here and not in the first row group's flush
                base.write(md.MAGIC)
            except BaseException:
                base.abort()  # leak neither the file nor its temp file
                raise
            self._f = BufferedSink(base, stats=self.write_stats)
            self.write_stats.bytes_flushed += len(md.MAGIC)
        else:
            self._f = sink
            self._f.write(md.MAGIC)
        self._pos = len(md.MAGIC)
        self._row_groups: List[md.RowGroup] = []
        # per row group, per column: (column index, offset index, bloom blob)
        self._extras: List[List[tuple]] = []
        self._num_rows = 0
        self._closed = False
        self._aborted = False
        # rows handed to write() and not yet in a row group
        self._buffer: Optional[Dict[str, ColumnData]] = None
        self._buffered_rows = 0
        # the row group whose background encode may still run while its
        # predecessor's pages go out: (encode futures in leaf order, rows)
        self._inflight: Optional[Tuple[list, int]] = None
        # columns whose dictionary overflowed in a chunk with values: their
        # later row groups are PLAIN without a build (the reference's
        # sticky fallback)
        self._dict_overflowed: set = set()

    def write(self, columns: Dict[str, ColumnData], num_rows: int) -> None:
        """Buffer ``columns`` (keyed by dotted path); every full row group
        of ``options.row_group_size`` rows is written as it fills, the
        tail stays buffered.  The caller's arrays are shared, never
        mutated; torch tensors are copied to the host here."""
        with self._op_active():
            self._write(columns, num_rows)

    def _op_active(self):
        """The activation of this writer's op around a public call (the
        encode tasks it submits inherit it); a caller's op scope active
        at the call wins."""
        if self._op is None or _oscope.current_op() is not None:
            return contextlib.nullcontext()
        return self._op.active()

    def _finish_op(self) -> None:
        if self._op is not None:
            self._op.finish()

    def _write(self, columns: Dict[str, ColumnData], num_rows: int) -> None:
        self._check_open()
        columns = {k: _host_cd(v) for k, v in columns.items()}
        if self._buffer is None:
            self._buffer = {k: _shallow_cd(v) for k, v in columns.items()}
        else:
            for k, v in columns.items():
                _extend_cd(self._buffer[k], v)
        self._buffered_rows += num_rows
        if self._buffered_rows >= self.options.row_group_size:
            self._drain(final=False)

    def flush(self) -> None:
        """Write every buffered row, the tail included, and the row group
        whose encode is in flight."""
        with self._op_active():
            self._check_open()
            self._drain(final=True)
            self._drain_inflight()

    def _check_open(self) -> None:
        if self._closed or self._aborted:
            raise ValueError("write on a " + ("closed" if self._closed
                                               else "aborted") + " writer")

    def _drain(self, final: bool) -> None:
        """Write the buffer's full row groups (``final``: all of it) and
        keep the rest, copied so that the written part's memory frees."""
        total = self._buffered_rows
        if self._buffer is None or total == 0:
            return
        rgs = self.options.row_group_size
        emit = total if final else (total // rgs) * rgs
        if emit == 0:
            return
        if emit == total and total <= rgs:
            buf, self._buffer, self._buffered_rows = self._buffer, None, 0
            self.write_row_group(buf, total)
            return
        leaf_of = {k: self.schema.leaf(k) for k in self._buffer}
        ctxs = {k: {} for k in self._buffer}  # per-column slice tables
        for start in range(0, emit, rgs):
            end = min(start + rgs, emit)
            self.write_row_group({
                k: _slice_cd(leaf_of[k], cd, start, end, ctxs[k])
                for k, cd in self._buffer.items()}, end - start)
        if emit == total:
            self._buffer, self._buffered_rows = None, 0
        else:
            self._buffer = {k: _copy_cd(_slice_cd(leaf_of[k], cd, emit,
                                                  total, ctxs[k]))
                            for k, cd in self._buffer.items()}
            self._buffered_rows = total - emit

    # -------------------------------------------------------- the pipeline
    def write_row_group(self, columns: Dict[str, ColumnData],
                        num_rows: int) -> None:
        """Encode and emit one row group, pipelined:

        1. wait for the previous row group's background encode (not its
           emit);
        2. submit this row group's encode to the shared pool;
        3. emit the previous row group's pages.

        Step 3's writes overlap step 2's encode.  A row group's encode
        starts only after its predecessor's finished, so the bytes are
        those of the serial write.  The group held back is emitted by the
        next call, :meth:`flush` or :meth:`close`.  Torch tensors among
        the columns are copied to the host here, on the caller's thread;
        the caller's numpy arrays are shared and may still be read by the
        encode after this call returns, so do not change them before the
        writer flushes."""
        with self._op_active():
            self._write_row_group(columns, num_rows)

    def _write_row_group(self, columns: Dict[str, ColumnData],
                         num_rows: int) -> None:
        self._check_open()
        if len(self._row_groups) + (self._inflight is not None) \
                >= MAX_ROW_GROUPS:
            raise TooManyRowGroupsError(
                f"file would exceed {MAX_ROW_GROUPS} row groups "
                "(RowGroup.ordinal is an i16); raise row_group_size")
        leaves = self.schema.leaves
        datas = [_host_cd(columns[leaf.name]) for leaf in leaves]
        ncpu = host.available_cpus()
        work = sum(np.asarray(d.values).nbytes for d in datas)
        mode = _overlap_mode()
        # a worker of the shared pool never waits on the pool's futures
        pooled = (ncpu > 1 and len(leaves) > 1
                  and work >= _PARALLEL_ENCODE_BYTES and not in_shared_pool())
        overlap = mode != "off" and not in_shared_pool() and (
            mode == "force"
            or (ncpu > 1 and work >= _PARALLEL_ENCODE_BYTES))
        prev, self._inflight = self._inflight, None
        if prev is not None:
            prev = (self._collect(prev[0]), prev[1])
        if overlap or pooled:
            encs = [pool_submit(self._timed_encode, leaf, data, num_rows)
                    for leaf, data in zip(leaves, datas)]
        else:
            encs = self._timed_encode_iter(leaves, datas, num_rows)
        if prev is not None:
            try:
                self._emit_group(*prev)
            except BaseException:
                if overlap or pooled:  # abort() cannot reach these
                    cancel_futures(encs)
                raise
        if overlap:
            self._inflight = (encs, num_rows)
            self.write_stats.overlapped_groups += 1
        else:
            self._emit_group(self._collect(encs) if pooled else encs,
                             num_rows)

    def _timed_encode(self, leaf: Leaf, data: ColumnData, num_rows: int):
        # on whichever thread encodes (a pool worker under the overlap,
        # else the caller's): overlap shows as bars on two tracks
        enc_span = (_otrace.span("write.encode", col=leaf.dotted_path,
                                 rows=num_rows)
                    if _otrace.TRACE_ENABLED else _otrace.NULL_SPAN)
        with enc_span:
            t0 = time.perf_counter()
            enc = self._encode_chunk(leaf, data, num_rows)
            return enc, time.perf_counter() - t0

    def _timed_encode_iter(self, leaves, datas, num_rows: int):
        """The serial encode: one chunk at a time, interleaved with its
        emit."""
        for leaf, data in zip(leaves, datas):
            enc, dt = self._timed_encode(leaf, data, num_rows)
            self.write_stats.encode_s += dt
            yield enc

    def _collect(self, futures) -> list:
        """A row group's encode futures resolved in leaf order; the time
        spent blocked is the pipeline's bubble (``pool_wait_s``)."""
        t0 = time.perf_counter()
        out = []
        try:
            for i, f in enumerate(futures):
                enc, dt = f.result()
                self.write_stats.encode_s += dt
                out.append(enc)
        except BaseException:
            cancel_futures(futures[i + 1:])
            raise
        finally:
            self.write_stats.pool_wait_s += time.perf_counter() - t0
        return out

    def _drain_inflight(self) -> None:
        if self._inflight is None:
            return
        encs, num_rows = self._inflight
        self._inflight = None
        self._emit_group(self._collect(encs), num_rows)

    def _emit_group(self, encs, num_rows: int) -> None:
        """Emit one encoded row group: offsets, pages, and its row-group
        metadata.  ``encs`` is a list or the serial encode's generator."""
        chunks, extras = [], []
        rg_start = self._pos
        emit_span = (_otrace.span("write.emit", rg=len(self._row_groups),
                                  rows=num_rows)
                     if _otrace.TRACE_ENABLED else _otrace.NULL_SPAN)
        with emit_span:  # a failed emit still records the span
            for enc in encs:
                t0 = time.perf_counter()
                chunk, extra = self._emit_chunk(enc)
                self.write_stats.emit_s += time.perf_counter() - t0
                chunks.append(chunk)
                extras.append(extra)
        sorting = [
            md.SortingColumn(column_idx=self.schema.leaf(p).column_index,
                             descending=desc, nulls_first=nf)
            for p, desc, nf in self.options.sorting_columns] or None
        self._row_groups.append(md.RowGroup(
            columns=chunks,
            total_byte_size=sum(c.meta_data.total_uncompressed_size
                                for c in chunks),
            num_rows=num_rows, sorting_columns=sorting, file_offset=rg_start,
            total_compressed_size=self._pos - rg_start,
            ordinal=len(self._row_groups)))
        self._extras.append(extras)
        self._num_rows += num_rows
        self.write_stats.row_groups += 1

    # ------------------------------------------------------------ encode
    def _encode_chunk(self, leaf: Leaf, data: ColumnData,
                      num_rows: int) -> _EncodedChunk:
        """One chunk's levels, dictionary, pages (headers with their CRC),
        statistics, column index and bloom filter: no file offsets, so the
        chunks of a row group encode at once."""
        opts = self.options
        physical = leaf.physical_type
        values, offsets = _normalized(leaf, data)
        def_levels, rep_levels = _levels(leaf, data, num_rows)
        row_starts = (None if rep_levels is None
                      else levels.row_slot_starts(rep_levels))
        n_slots = num_rows if def_levels is None else len(def_levels)
        rows = n_slots if row_starts is None else len(row_starts)
        if rows != num_rows or (row_starts is not None and n_slots
                                and row_starts[0] != 0):
            raise ValueError(f"column {leaf.name!r}: {rows} rows in a row "
                             f"group of {num_rows}")
        present = (None if def_levels is None
                   else def_levels == leaf.max_definition_level)
        nvalues = n_slots if present is None else int(present.sum())
        have = len(offsets) - 1 if offsets is not None else len(values)
        if have != nvalues:
            raise ValueError(f"column {leaf.name!r}: {have} values "
                             f"for {nvalues} present slots")
        forced = opts.column_encoding.get(leaf.name)
        encoding = Encoding(forced) if forced is not None else None
        if encoding is not None and physical not in _ENCODABLE[encoding]:
            raise ValueError(f"column {leaf.name!r}: {encoding.name} does "
                             f"not take {physical.name} values")
        tried = (encoding is None and opts.dictionary
                 and leaf.name not in self._dict_overflowed)
        dict_values, dict_offsets, indices = _dictionary(
            leaf, values, offsets, nvalues,
            tried or encoding == Encoding.RLE_DICTIONARY,
            forced=encoding is not None, limit=opts.dictionary_page_limit)
        if tried and indices is None and nvalues:
            # an empty or all-null chunk says nothing of the cardinality
            self._dict_overflowed.add(leaf.name)
        if encoding is None:
            encoding = (Encoding.RLE_DICTIONARY if indices is not None
                        else Encoding.PLAIN)
        stats = None
        if opts.write_statistics:
            # a dictionary holds exactly the chunk's distinct values
            stats = (_statistics(leaf, dict_values, dict_offsets,
                                 n_slots - nvalues)
                     if indices is not None else
                     _statistics(leaf, values, offsets, n_slots - nvalues))
        bloom_blob = None
        if leaf.name in opts.bloom_filters:
            from .bloom import build_split_block_filter

            dictionary = indices is not None
            bloom_blob = build_split_block_filter(
                leaf, values, dict_values if dictionary else None,
                opts.bloom_filters[leaf.name], offsets=offsets,
                dict_offsets=dict_offsets if dictionary else None)

        def crc(header: md.PageHeader, body: bytes) -> tuple:
            if opts.write_crc:  # over the page's bytes as stored
                header.crc = zlib.crc32(body) & 0xFFFFFFFF
            return header, body

        dict_page = None
        encodings = {Encoding.RLE, encoding}
        width = 0
        if indices is not None:
            raw = ref.encode_plain(dict_values, physical, dict_offsets)
            dict_n = (len(dict_offsets) - 1 if dict_offsets is not None
                      else len(dict_values))
            comp = self._codec.encode(raw)
            dict_page = crc(md.PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                uncompressed_page_size=len(raw),
                compressed_page_size=len(comp),
                dictionary_page_header=md.DictionaryPageHeader(
                    num_values=dict_n,
                    encoding=int(Encoding.PLAIN), is_sorted=False)),
                comp)
            encodings.add(Encoding.PLAIN)
            # bit width >= 1: several readers reject zero-width streams
            width = max(int(dict_n - 1).bit_length(), 1)
        pages: List[tuple] = []
        page_stats: List[Tuple[md.Statistics, int]] = []  # (stats, values)

        # pages hold whole rows: a page's row count comes from its slots'
        rows_per_page = max(_rows_per_page(leaf, values, offsets,
                                           opts.data_page_size)
                            * num_rows // max(n_slots, 1), 1)
        pcum = (None if present is None
                else np.concatenate([[0], np.cumsum(present)]))

        def slot(r: int) -> int:
            if row_starts is None:
                return r
            return int(row_starts[r]) if r < num_rows else n_slots

        for r0 in range(0, max(num_rows, 1), rows_per_page):
            r1 = min(r0 + rows_per_page, num_rows)
            s0, s1 = slot(r0), slot(r1)
            v0, v1 = ((s0, s1) if pcum is None
                      else (int(pcum[s0]), int(pcum[s1])))
            sub, sub_offs = _value_span(values, offsets, v0, v1)
            if indices is not None:
                body = ref.encode_rle_dict_indices(indices[v0:v1], width)
            else:
                body = _encode_values(leaf, sub, sub_offs, encoding)
            lv = [None if a is None else ref.encode_rle(
                a[s0:s1].astype(np.int64), int(m).bit_length())
                for a, m in ((rep_levels, leaf.max_repetition_level),
                             (def_levels, leaf.max_definition_level))]
            pstat = None
            if opts.write_statistics:
                pstat = _statistics(leaf, sub, sub_offs,
                                    (s1 - s0) - (v1 - v0))
                page_stats.append((pstat, v1 - v0))
            pages.append((*crc(*self._data_page(
                *lv, body, s1 - s0, v1 - v0, r1 - r0, encoding, pstat)), r0))
        column_index = None
        if opts.write_page_index and page_stats:
            column_index = _column_index(leaf, page_stats)
        return _EncodedChunk(leaf=leaf, dict_page=dict_page, pages=pages,
                             stats=stats, column_index=column_index,
                             bloom_blob=bloom_blob, encodings=encodings,
                             n_slots=n_slots)

    def _emit_chunk(self, enc: _EncodedChunk):
        """Write one encoded chunk at the file's position: returns its
        ``ColumnChunk`` and the (column index, offset index, bloom blob)
        that go out at close.  The pages go to the sink in one
        ``writelines``; ``_pos`` moves only after it."""
        opts = self.options
        chunk_start = pos = self._pos
        parts: List[bytes] = []
        uncompressed = 0

        def emit(header: md.PageHeader, body: bytes) -> None:
            nonlocal uncompressed, pos
            blob = thrift.serialize(header)
            parts.append(blob)
            parts.append(body)
            pos += len(blob) + len(body)
            uncompressed += header.uncompressed_page_size + len(blob)

        dict_page_offset = None
        if enc.dict_page is not None:
            dict_page_offset = pos
            emit(*enc.dict_page)
        data_page_offset = pos
        locations: List[md.PageLocation] = []
        for header, body, first_row in enc.pages:
            page_start = pos
            emit(header, body)
            locations.append(md.PageLocation(
                offset=page_start, compressed_page_size=pos - page_start,
                first_row_index=first_row))
        self._f.writelines(parts)
        self._pos = pos
        meta = md.ColumnMetaData(
            type=int(enc.leaf.physical_type),
            encodings=sorted(int(e) for e in enc.encodings),
            path_in_schema=list(enc.leaf.path),
            codec=int(opts.codec_id()),
            num_values=enc.n_slots,
            total_uncompressed_size=uncompressed,
            total_compressed_size=pos - chunk_start,
            data_page_offset=data_page_offset,
            dictionary_page_offset=dict_page_offset,
            statistics=enc.stats)
        offset_index = (md.OffsetIndex(page_locations=locations)
                        if opts.write_page_index else None)
        return (md.ColumnChunk(file_offset=chunk_start, meta_data=meta),
                (enc.column_index, offset_index, enc.bloom_blob))

    def _data_page(self, rep: Optional[bytes], defs: Optional[bytes],
                   values: bytes, n_slots: int, n_vals: int, n_rows: int,
                   encoding: Encoding, stats: Optional[md.Statistics]):
        """One data page: ``rep`` and ``defs`` are the hybrid level streams
        (None where the leaf has no such levels)."""
        if self.options.data_page_version == 2:
            # levels sit uncompressed in front of the compressed values
            rep, defs = rep or b"", defs or b""
            levels = rep + defs
            comp = self._codec.encode(values)
            return md.PageHeader(
                type=int(PageType.DATA_PAGE_V2),
                uncompressed_page_size=len(levels) + len(values),
                compressed_page_size=len(levels) + len(comp),
                data_page_header_v2=md.DataPageHeaderV2(
                    num_values=n_slots, num_nulls=n_slots - n_vals,
                    num_rows=n_rows, encoding=int(encoding),
                    definition_levels_byte_length=len(defs),
                    repetition_levels_byte_length=len(rep),
                    is_compressed=True, statistics=stats)), levels + comp
        levels = b"".join(struct.pack("<I", len(x)) + x
                          for x in (rep, defs) if x is not None)
        raw = levels + values
        comp = self._codec.encode(raw)
        return md.PageHeader(
            type=int(PageType.DATA_PAGE),
            uncompressed_page_size=len(raw),
            compressed_page_size=len(comp),
            data_page_header=md.DataPageHeader(
                num_values=n_slots, encoding=int(encoding),
                definition_level_encoding=int(Encoding.RLE),
                repetition_level_encoding=int(Encoding.RLE),
                statistics=stats)), comp

    # ------------------------------------------------------------- close
    def close(self) -> None:
        """Write the buffered rows, the bloom filters, the page index and
        the footer, and commit a path (fsync and rename).  ``closed`` is
        set only once all of it succeeded; a failure on the way aborts
        the file (no destination is left) and raises."""
        if self._closed:
            return
        if self._aborted:
            raise ValueError("cannot close an aborted writer")
        try:
            with self._op_active():
                self._close_impl()
        except BaseException:
            self._discard()
            raise
        self._closed = True
        # one publish a writer, when its bytes are committed, into the op
        with self._op_active():
            self.write_stats.publish()
        self._finish_op()
        if getattr(self._f, "_tunable", False):
            # the next writer's buffer grows where this one still flushed
            # many times a row group
            write_autotune().observe(self.write_stats)

    def _close_impl(self) -> None:
        self.flush()
        self._write_blooms_and_page_index()
        fmd = md.FileMetaData(
            version=2,
            schema=self.schema.to_elements(),
            num_rows=self._num_rows,
            row_groups=self._row_groups,
            created_by=self.options.created_by,
            column_orders=[md.ColumnOrder(TYPE_ORDER=md.TypeDefinedOrder())
                           for _ in self.schema.leaves])
        blob = thrift.serialize(fmd)
        # footer, length and magic in one write: a torn tail lacks the
        # closing magic and never parses as a whole file
        self._f.write(blob + struct.pack("<I", len(blob)) + md.MAGIC)
        self._f.flush()
        if self._own_sink:
            self._f.close()  # the commit: fsync (and the rename)

    def abort(self) -> None:
        """Discard the write: no footer; a path this writer opened leaves
        neither its destination nor a temp file, and an encode in flight
        is cancelled (a started one finishes into the void: it touches
        neither the sink nor the writer).  A caller's file object is left
        as it is.  Idempotent, and a no-op after :meth:`close`."""
        if self._closed or self._aborted:
            return
        self._discard()

    def _discard(self) -> None:
        self._aborted = True
        self._buffer, self._buffered_rows = None, 0
        if self._inflight is not None:
            encs, _ = self._inflight
            self._inflight = None
            cancel_futures(encs)
        try:
            if self._own_sink:
                self._f.abort()
        finally:
            # a failed write is the op the slow log exists for
            self._finish_op()

    def _write_blooms_and_page_index(self) -> None:
        """The bloom filters, then every column index, then every offset
        index (the reference's layout), each chunk's metadata pointing at
        its own."""
        def put(blob: bytes) -> int:
            self._f.write(blob)
            self._pos += len(blob)
            return self._pos - len(blob)

        pairs = [(chunk, extra) for rg, extras in zip(self._row_groups,
                                                      self._extras)
                 for chunk, extra in zip(rg.columns, extras)]
        for chunk, (_, _, bloom) in pairs:
            if bloom is not None:
                chunk.meta_data.bloom_filter_offset = put(bloom)
                chunk.meta_data.bloom_filter_length = len(bloom)
        for chunk, (ci, _, _) in pairs:
            if ci is not None:
                blob = thrift.serialize(ci)
                chunk.column_index_offset = put(blob)
                chunk.column_index_length = len(blob)
        for chunk, (_, oi, _) in pairs:
            if oi is not None:
                blob = thrift.serialize(oi)
                chunk.offset_index_offset = put(blob)
                chunk.offset_index_length = len(blob)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # an exception in flight means a torn row group or footer: a
        # footer now would make a valid-looking file of it
        if exc[0] is not None:
            self.abort()
        elif not self._aborted:
            self.close()


def _normalized(leaf: Leaf, data: ColumnData):
    """(values, offsets) of a chunk's input in the form each physical type
    is encoded from: byte arrays as uint8 bytes and int64 offsets, INT96
    as (n, 3) int32, fixed-length byte arrays as (n, w) uint8."""
    physical = leaf.physical_type
    if physical == Type.BYTE_ARRAY:
        if data.offsets is None:
            raise ValueError(f"column {leaf.name!r}: byte arrays need "
                             "offsets")
        return (host.as_u8(np.asarray(data.values)),
                np.asarray(data.offsets, np.int64))
    if physical == Type.INT96:
        return np.ascontiguousarray(data.values, np.int32).reshape(-1, 3), \
            None
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return np.ascontiguousarray(data.values, np.uint8).reshape(
            -1, leaf.type_length), None
    return np.ascontiguousarray(data.values,
                                dtype=PHYSICAL_NP_DTYPE[physical]), None


def _value_span(values: np.ndarray, offsets: Optional[np.ndarray], v0: int,
                v1: int):
    """Values [v0, v1): a slice, and for byte arrays their bytes with
    offsets from 0."""
    if offsets is None:
        return values[v0:v1], None
    sub = offsets[v0:v1 + 1]
    return values[sub[0]:sub[-1]], sub - sub[0]


def _dictionary(leaf: Leaf, values: np.ndarray, offsets, nvalues: int,
                wanted: bool, forced: bool, limit: int):
    """``(dict_values, dict_offsets, indices)`` of a chunk, or three Nones
    where it is not dictionary-encoded.  Entries are in first-seen order;
    numbers are compared by bit pattern (-0.0 and 0.0, or two NaN
    payloads, are distinct entries).  Without a forced encoding a
    dictionary holds at most ``n / 2 + 16`` entries and fits ``limit``
    bytes, a chunk whose two sample windows (16,384 values, byte arrays
    32,768) both predict more entries is refused unbuilt, and
    BOOLEAN, INT96 and fixed-length byte arrays stay PLAIN: the
    reference's rules."""
    physical = leaf.physical_type
    none = None, None, None
    if not wanted or (not forced and (not nvalues or physical in (
            Type.BOOLEAN, Type.INT96, Type.FIXED_LEN_BYTE_ARRAY))):
        return none
    if physical in NUMERIC:
        n = len(values)
        cap = n if forced else n // 2 + 16
        if not forced and _windows_predict_overflow(
                n, cap, 1 << 14, lambda s, w: len(
                    host.dictionary_of_fixed(values[s:s + w], w)[0])):
            return none
        got = host.dictionary_of_fixed(values, cap)
        if got is None:
            return none
        dict_values, indices = got
        if not forced and dict_values.nbytes > limit:
            return none
        return dict_values, None, indices
    rows = offsets is None  # INT96 / FLBA: fixed-width rows of bytes
    if rows:
        w = values.shape[1] * values.itemsize
        flat = host.as_u8(values)
        offsets = np.arange(len(values) + 1, dtype=np.int64) * w
    else:
        flat = values
    n = len(offsets) - 1
    cap = n if forced else n // 2 + 16
    if not forced and _windows_predict_overflow(
            n, cap, 1 << 15, lambda s, w: len(host.dictionary_of_byte_arrays(
                flat, offsets[s:s + w + 1], w)[1])):
        return none
    got = host.dictionary_of_byte_arrays(flat, offsets, cap)
    if got is None:
        return none
    indices, first = got
    dvals, doffs = host.gather_byte_arrays(flat, offsets, first)
    if not forced and int(doffs[-1]) + 4 * len(first) > limit:
        return none
    if rows:
        return dvals.view(values.dtype).reshape(-1, *values.shape[1:]), \
            None, indices
    return dvals, doffs, indices


def _windows_predict_overflow(n: int, max_unique: int, window: int,
                              distinct) -> bool:
    """The reference's sampling bail: above ``4 * window`` values, a prefix
    window and a middle window whose distinct counts (``distinct(start,
    window)``) both estimate more than ``1.25 * max_unique`` distinct
    values predict an overflow.  Values whose first occurrences cluster
    early repeat in the middle window and are still built."""
    if n <= 4 * window or max_unique < window:
        return False
    return all(_window_predicts_overflow(distinct(s, window), window,
                                         max_unique) for s in (0, n // 2))


def _window_predicts_overflow(distinct: int, window: int,
                              max_unique: int) -> bool:
    """Whether ``distinct`` values in a window of ``window`` draws estimate
    a cardinality K over ``1.25 * max_unique``, from E[distinct] = K(1 -
    exp(-window/K)) (uniform draws; skew biases K low, towards a build)."""
    if distinct >= window:  # an all-distinct window: the estimate diverges
        return True
    frac = distinct / window
    if frac <= 0:
        return False
    lo, hi = 1e-9, 60.0  # solve (1 - e^-x) / x = frac for x = window / K
    for _ in range(40):
        mid = (lo + hi) / 2
        if (1 - math.exp(-mid)) / mid > frac:
            lo = mid
        else:
            hi = mid
    return window / ((lo + hi) / 2) > 1.25 * max_unique


def _rows_per_page(leaf: Leaf, values: np.ndarray, offsets,
                   page_bytes: int) -> int:
    """Rows per data page: ``page_bytes`` over the value width (a byte
    array's mean length + 4), as the reference paginates."""
    width = value_width(leaf.physical_type, leaf.type_length)
    if leaf.physical_type == Type.BOOLEAN:
        width = 1
    elif width is None:
        n = len(offsets) - 1
        width = max(int(offsets[-1] - offsets[0]) // max(n, 1), 1) + 4
    return max(page_bytes // max(width, 1), 1)


def _encode_values(leaf: Leaf, values: np.ndarray, offsets,
                   encoding: Encoding) -> bytes:
    """One page's values in ``encoding`` (not dictionary)."""
    physical = leaf.physical_type
    if encoding == Encoding.PLAIN:
        return ref.encode_plain(values, physical, offsets)
    if encoding == Encoding.DELTA_BINARY_PACKED:
        return ref.encode_delta_binary_packed(values)
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        width = values.itemsize * (values.shape[1] if values.ndim == 2
                                   else 1)
        return ref.encode_byte_stream_split(values, len(values), width)
    if encoding == Encoding.RLE:  # booleans: length-prefixed hybrid
        body = ref.encode_rle(values.astype(np.int64), 1)
        return struct.pack("<I", len(body)) + body
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
        return ref.encode_delta_length_byte_array(values, offsets)
    return ref.encode_delta_byte_array(values, offsets)


def _statistics(leaf: Leaf, values: np.ndarray, offsets,
                null_count: int) -> md.Statistics:
    """Statistics of a span of present values: min/max (NaNs skipped; none
    for INT96) in both the current and the deprecated fields, and the
    null count."""
    from ..algebra.compare import encode_order_value, min_max

    mn, mx = min_max(leaf, values, offsets)
    if mn is not None:
        mn, mx = encode_order_value(mn, leaf), encode_order_value(mx, leaf)
    return md.Statistics(null_count=null_count, min_value=mn, max_value=mx,
                         min=mn, max=mx)


def _column_index(leaf: Leaf, page_stats: List[Tuple[md.Statistics, int]]
                  ) -> md.ColumnIndex:
    """A page with no values is a null page; a bound that does not exist
    (no values, or all NaN) is written as empty bytes; byte-array bounds
    longer than ``COLUMN_INDEX_TRUNCATE`` bytes are cut to a prefix that
    still bounds the page."""
    from ..algebra.compare import truncate_stat_max, truncate_stat_min

    nulls = [nvals == 0 for _, nvals in page_stats]
    mins = [st.min_value or b"" for st, _ in page_stats]
    maxs = [st.max_value or b"" for st, _ in page_stats]
    if leaf.physical_type in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        mins = [truncate_stat_min(m, COLUMN_INDEX_TRUNCATE) for m in mins]
        maxs = [truncate_stat_max(m, COLUMN_INDEX_TRUNCATE) or m
                for m in maxs]
    return md.ColumnIndex(
        null_pages=nulls, min_values=mins, max_values=maxs,
        boundary_order=int(_boundary_order(mins, maxs, leaf, nulls)),
        null_counts=[st.null_count or 0 for st, _ in page_stats])


def _boundary_order(mins: List[bytes], maxs: List[bytes], leaf: Leaf,
                    null_pages: List[bool]) -> BoundaryOrder:
    """ASCENDING or DESCENDING when the non-null pages' bounds are, else
    UNORDERED (the reference's rule, over decoded bounds).  Pages without
    bounds (INT96, all NaN) order as equal when no page has one, as the
    reference's empty bounds do, and UNORDERED beside pages that have."""
    from .statistics import decode_stat_value

    mins = [m for m, n in zip(mins, null_pages) if not n]
    maxs = [m for m, n in zip(maxs, null_pages) if not n]
    if len(mins) <= 1:
        return BoundaryOrder.ASCENDING
    dmins = [decode_stat_value(m, leaf) for m in mins]
    dmaxs = [decode_stat_value(m, leaf) for m in maxs]
    if all(v is None for v in dmins + dmaxs):
        return BoundaryOrder.ASCENDING
    if any(v is None for v in dmins) or any(v is None for v in dmaxs):
        return BoundaryOrder.UNORDERED
    asc = all(dmins[i] <= dmins[i + 1] for i in range(len(dmins) - 1)) and \
        all(dmaxs[i] <= dmaxs[i + 1] for i in range(len(dmaxs) - 1))
    if asc:
        return BoundaryOrder.ASCENDING
    desc = all(dmins[i] >= dmins[i + 1] for i in range(len(dmins) - 1)) and \
        all(dmaxs[i] >= dmaxs[i + 1] for i in range(len(dmaxs) - 1))
    return BoundaryOrder.DESCENDING if desc else BoundaryOrder.UNORDERED


def _byte_arrays(items) -> Tuple[np.ndarray, np.ndarray]:
    """A sequence of bytes (or str, as UTF-8) as (values, offsets)."""
    items = [x.encode() if isinstance(x, str) else bytes(x) for x in items]
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offsets[1:])
    return np.frombuffer(b"".join(items), np.uint8), offsets


def _host(a):
    """``a`` with a torch tensor (on the CPU or a card) copied to the host
    as numpy; anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


def _host_cd(cd: ColumnData) -> ColumnData:
    """``cd`` with its torch tensors copied to the host: ``cd`` itself
    where it holds none."""
    lists = (cd.list_offsets or []) + (cd.list_validity or [])
    if not any(isinstance(a, torch.Tensor) for a in (
            cd.values, cd.validity, cd.offsets, cd.def_levels,
            cd.rep_levels, *lists)):
        return cd
    return ColumnData(
        values=_host(cd.values), validity=_host(cd.validity),
        offsets=_host(cd.offsets),
        list_offsets=None if cd.list_offsets is None
        else [_host(a) for a in cd.list_offsets],
        list_validity=None if cd.list_validity is None
        else [_host(a) for a in cd.list_validity],
        def_levels=_host(cd.def_levels), rep_levels=_host(cd.rep_levels))


def _column_data(arr) -> ColumnData:
    if isinstance(arr, ColumnData):
        return arr
    validity = None
    if isinstance(arr, np.ma.MaskedArray):
        validity = ~np.ma.getmaskarray(arr)
        arr = np.asarray(arr.data)[validity]
    arr = np.asarray(arr)
    if arr.dtype.kind in "OSU":
        values, offsets = _byte_arrays(arr.tolist())
        return ColumnData(values=values, validity=validity, offsets=offsets)
    return ColumnData(values=arr, validity=validity)


def _leaf_of(name: str, arr) -> Leaf:
    """The flat leaf an input array is written as."""
    rep = (Rep.OPTIONAL if isinstance(arr, np.ma.MaskedArray)
           else Rep.REQUIRED)
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype == np.uint8:
        return Leaf(-1, name, Type.FIXED_LEN_BYTE_ARRAY, rep, arr.shape[1])
    if arr.ndim == 2 and arr.dtype == np.int32 and arr.shape[1] == 3:
        return Leaf(-1, name, Type.INT96, rep)
    if arr.dtype.kind in "OSU":
        string = arr.dtype.kind == "U" or any(isinstance(x, str)
                                              for x in arr.flat)
        return Leaf(-1, name, Type.BYTE_ARRAY, rep, string=string)
    return Leaf(-1, name, physical_of_dtype(arr.dtype), rep)


def schema_of(table: Dict[str, np.ndarray]) -> Schema:
    """The flat schema of ``{name: array}``: masked arrays are OPTIONAL."""
    return Schema([_leaf_of(name, arr) for name, arr in table.items()])


def _levels(leaf: Leaf, data: ColumnData, num_rows: Optional[int]):
    """``(def_levels, rep_levels)`` of a leaf's input, each None where the
    leaf has no such levels: the raw levels where given, else from its
    validity (a flat leaf) or its list offsets and validity."""
    max_def = leaf.max_definition_level
    max_rep = leaf.max_repetition_level
    if data.def_levels is not None or data.rep_levels is not None:
        d = (None if data.def_levels is None
             else np.asarray(data.def_levels, np.int32))
        r = (None if data.rep_levels is None
             else np.asarray(data.rep_levels, np.int32))
        if (d is None) != (max_def == 0) or (r is None) != (max_rep == 0):
            raise ValueError(f"column {leaf.name!r}: levels given do not "
                             "match the schema")
        return d, r
    if max_rep == 0:
        if num_rows is None:
            num_rows = _flat_rows(data)
        return levels.levels_for_flat(data.validity, num_rows, max_def), \
            None
    offs = data.list_offsets
    if offs is None:
        raise ValueError(f"column {leaf.name!r}: a repeated leaf needs "
                         "list_offsets")
    valid = data.list_validity or [None] * len(offs)
    if len(offs) == 1:
        return levels.levels_for_list(offs[0], valid[0], data.validity,
                                      leaf)
    return levels.levels_for_nested(offs, valid, data.validity, leaf)


def _flat_rows(data: ColumnData) -> int:
    if data.validity is not None:
        return len(data.validity)
    if data.offsets is not None:
        return len(data.offsets) - 1
    return len(data.values)


def _shallow_cd(cd: ColumnData) -> ColumnData:
    """A new ColumnData sharing ``cd``'s arrays (and a copy of its
    per-level lists): the writer's buffer rebinds fields, never the
    caller's."""
    return dataclasses.replace(
        cd, list_offsets=None if cd.list_offsets is None
        else list(cd.list_offsets),
        list_validity=None if cd.list_validity is None
        else list(cd.list_validity))


def _copy_cd(cd: ColumnData) -> ColumnData:
    """A deep copy of ``cd``'s arrays."""
    def cp(a):
        return None if a is None else np.array(a, copy=True)

    return ColumnData(
        values=cp(np.asarray(cd.values)), validity=cp(cd.validity),
        offsets=cp(cd.offsets),
        list_offsets=None if cd.list_offsets is None
        else [cp(o) for o in cd.list_offsets],
        list_validity=None if cd.list_validity is None
        else [cp(v) for v in cd.list_validity],
        def_levels=cp(cd.def_levels), rep_levels=cp(cd.rep_levels))


def _cd_elements(cd: ColumnData) -> int:
    """Entries ``validity`` covers: a repeated leaf's innermost elements,
    a flat leaf's slots (its values where nothing is null)."""
    if cd.list_offsets:
        return int(np.asarray(cd.list_offsets[-1])[-1])
    return _flat_rows(cd)


def _extend_cd(dst: ColumnData, src: ColumnData) -> None:
    """Append ``src``'s rows to ``dst`` (same leaf, same form): values,
    byte-array offsets rebased, validity (all valid where a side has none),
    each repeated level's offsets rebased and validity, raw levels."""
    if (dst.def_levels is None) != (src.def_levels is None) or (
            dst.rep_levels is None) != (src.rep_levels is None):
        raise ValueError(
            "cannot mix raw-level ColumnData (rows path) with vectorized "
            "ColumnData in one buffered chunk; flush between them")
    if (dst.list_offsets is None) != (src.list_offsets is None) or (
            dst.list_offsets is not None
            and len(dst.list_offsets) != len(src.list_offsets)):
        raise ValueError("cannot extend a column with one of another "
                         "nesting depth")
    n_dst, n_src = _cd_elements(dst), _cd_elements(src)
    dst.values = np.concatenate([np.asarray(dst.values),
                                 np.asarray(src.values)])
    if dst.def_levels is not None:
        dst.def_levels = np.concatenate([dst.def_levels, src.def_levels])
    if dst.rep_levels is not None:
        dst.rep_levels = np.concatenate([dst.rep_levels, src.rep_levels])
    if dst.offsets is not None:
        a = np.asarray(dst.offsets, np.int64)
        dst.offsets = np.concatenate(
            [a[:-1], np.asarray(src.offsets, np.int64) + a[-1]])
    if dst.validity is not None or src.validity is not None:
        dst.validity = np.concatenate([
            np.asarray(v, bool) if v is not None else np.ones(n, bool)
            for v, n in ((dst.validity, n_dst), (src.validity, n_src))])
    if dst.list_offsets is not None:
        lo, lv = [], []
        dvs = dst.list_validity or [None] * len(dst.list_offsets)
        svs = src.list_validity or [None] * len(src.list_offsets)
        for a, b, va, vb in zip(dst.list_offsets, src.list_offsets, dvs,
                                svs):
            a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
            lo.append(np.concatenate([a[:-1], b + a[-1]]))
            lv.append(None if va is None and vb is None else np.concatenate(
                [np.asarray(v, bool) if v is not None else np.ones(n, bool)
                 for v, n in ((va, len(a) - 1), (vb, len(b) - 1))]))
        dst.list_offsets = lo
        dst.list_validity = None if all(v is None for v in lv) else lv


def _slice_cd(leaf: Leaf, cd: ColumnData, r0: int, r1: int,
              ctx: Optional[dict] = None) -> ColumnData:
    """Rows ``[r0, r1)`` of a buffered column in its own form (row-group
    splitting).  ``ctx`` (a dict a column) keeps the row-start and
    present-count tables, so that cutting a buffer into P parts is O(N),
    not O(N P)."""
    ctx = ctx if ctx is not None else {}

    def cum(mask) -> np.ndarray:
        if "cum" not in ctx:
            c = np.zeros(len(mask) + 1, np.int64)
            np.cumsum(mask, out=c[1:])
            ctx["cum"] = c
        return ctx["cum"]

    def span(v0: int, v1: int):
        vals = np.asarray(cd.values)
        if cd.offsets is None:
            return vals[v0:v1], None
        offs = np.asarray(cd.offsets, np.int64)
        return vals[offs[v0]:offs[v1]], offs[v0:v1 + 1] - offs[v0]

    if cd.def_levels is not None or cd.rep_levels is not None:
        d, r = cd.def_levels, cd.rep_levels
        n_slots = len(d if d is not None else r)
        s0, s1 = r0, r1
        if r is not None:
            if "starts" not in ctx:
                ctx["starts"] = levels.row_slot_starts(np.asarray(r))
            starts = ctx["starts"]
            s0 = int(starts[r0]) if r0 < len(starts) else n_slots
            s1 = int(starts[r1]) if r1 < len(starts) else n_slots
        v0, v1 = s0, s1
        if d is not None:
            c = cum(np.asarray(d) == leaf.max_definition_level)
            v0, v1 = int(c[s0]), int(c[s1])
        vals, offs = span(v0, v1)
        return ColumnData(values=vals, offsets=offs,
                          def_levels=None if d is None else d[s0:s1],
                          rep_levels=None if r is None else r[s0:s1])
    if cd.list_offsets is not None:
        lo_out, lv_out = [], []
        lo, hi = r0, r1
        lvs = cd.list_validity or [None] * len(cd.list_offsets)
        for o, v in zip(cd.list_offsets, lvs):
            o = np.asarray(o, np.int64)
            lo_out.append(o[lo:hi + 1] - o[lo])
            lv_out.append(None if v is None else np.asarray(v)[lo:hi])
            lo, hi = int(o[lo]), int(o[hi])
        e0, e1 = lo, hi
    else:
        e0, e1 = r0, r1
    validity = None
    v0, v1 = e0, e1
    if cd.validity is not None:
        validity = np.asarray(cd.validity, bool)
        c = cum(validity)
        v0, v1 = int(c[e0]), int(c[e1])
        validity = validity[e0:e1]
    vals, offs = span(v0, v1)
    out = ColumnData(values=vals, offsets=offs, validity=validity)
    if cd.list_offsets is not None:
        out.list_offsets = lo_out
        out.list_validity = (None if all(v is None for v in lv_out)
                             else lv_out)
    return out


def write_table(table, sink, options: Optional[WriterOptions] = None,
                schema: Optional[Schema] = None) -> ParquetWriter:
    """Write ``{name: array or ColumnData}``, or a ``pyarrow.Table``, to
    ``sink`` (a path or a binary file object) in row groups of
    ``options.row_group_size`` rows; returns the closed writer (its
    ``write_stats``).  ``schema`` is needed where the table holds
    ColumnData; an Arrow table's is :func:`schema_from_arrow`'s by
    default, and its columns come in through :func:`columns_from_arrow`
    (a dict imports no pyarrow).  Torch tensors, on the CPU or on a card,
    are copied to the host once, here.  A failure aborts the writer (a
    path leaves no file) and raises."""
    options = options or WriterOptions()
    if not isinstance(table, dict):  # a pyarrow.Table
        schema = schema or schema_from_arrow(table.schema)
        table = columns_from_arrow(table, schema)
    table = {name: _host_cd(v) if isinstance(v, ColumnData) else _host(v)
             for name, v in table.items()}
    schema = schema or schema_of(table)
    columns = {leaf.name: _column_data(table[leaf.name])
               for leaf in schema.leaves}
    lengths = set()
    for leaf in schema.leaves:
        cd = columns[leaf.name]
        if leaf.max_repetition_level or leaf.max_definition_level > 1 or \
                cd.def_levels is not None:
            # nested leaves go in level form, so row groups cut at rows
            d, r = _levels(leaf, cd, None)
            cd = columns[leaf.name] = ColumnData(
                values=cd.values, offsets=cd.offsets, def_levels=d,
                rep_levels=r)
            lengths.add(len(d) if r is None
                        else int(np.count_nonzero(r == 0)))
            continue
        lengths.add(_flat_rows(cd))
    if len(lengths) > 1:
        raise ValueError(f"columns differ in length: {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    ctxs = {leaf.name: {} for leaf in schema.leaves}
    with ParquetWriter(sink, schema, options) as w:
        for start in range(0, n, options.row_group_size):
            end = min(start + options.row_group_size, n)
            w.write_row_group({
                leaf.name: _slice_cd(leaf, columns[leaf.name], start, end,
                                     ctxs[leaf.name])
                for leaf in schema.leaves}, end - start)
    return w


# ---------------------------------------------------------------------------
# Arrow in: the JAX package's schema and column mapping
# ---------------------------------------------------------------------------


def schema_from_arrow(aschema) -> Schema:
    """The Parquet schema tree of a ``pyarrow.Schema``: a nullable field
    OPTIONAL, a list the three-level LIST, a struct a group, a map the
    MAP group, a leaf by :func:`_arrow_leaf_type` (``TypeError`` for a
    type with no mapping)."""
    import pyarrow as pa

    from ..schema import schema as sch

    def field_node(f):
        rep = Rep.OPTIONAL if f.nullable else Rep.REQUIRED
        t = f.type
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            elem = field_node(pa.field("element", t.value_type,
                                       nullable=t.value_field.nullable))
            return sch.list_of(f.name, elem, rep)
        if pa.types.is_struct(t):
            return sch.group(f.name, [field_node(t.field(i))
                                      for i in range(t.num_fields)], rep)
        if pa.types.is_map(t):
            key = field_node(pa.field("key", t.key_type, nullable=False))
            val = field_node(pa.field("value", t.item_type))
            return sch.map_of(f.name, key, val, rep)
        phys, kind, params, tl = _arrow_leaf_type(t)
        return sch.leaf(f.name, phys, rep, kind, type_length=tl, **params)

    return Schema(sch.Node("schema", children=[field_node(f)
                                               for f in aschema]))


def _arrow_leaf_type(t):
    """``(physical type, logical kind, logical parameters, FLBA width)`` of
    an Arrow leaf type, as pyarrow's writer maps it."""
    import pyarrow as pa

    from ..schema.types import LogicalKind as K

    if pa.types.is_null(t):  # the Null logical type over INT32
        return Type.INT32, K.UNKNOWN, {}, None
    if pa.types.is_boolean(t):
        return Type.BOOLEAN, K.NONE, {}, None
    if pa.types.is_int8(t):
        return Type.INT32, K.INT, {"bit_width": 8, "signed": True}, None
    if pa.types.is_int16(t):
        return Type.INT32, K.INT, {"bit_width": 16, "signed": True}, None
    if pa.types.is_int32(t):
        return Type.INT32, K.NONE, {}, None
    if pa.types.is_int64(t):
        return Type.INT64, K.NONE, {}, None
    if pa.types.is_uint8(t):
        return Type.INT32, K.INT, {"bit_width": 8, "signed": False}, None
    if pa.types.is_uint16(t):
        return Type.INT32, K.INT, {"bit_width": 16, "signed": False}, None
    if pa.types.is_uint32(t):
        return Type.INT32, K.INT, {"bit_width": 32, "signed": False}, None
    if pa.types.is_uint64(t):
        return Type.INT64, K.INT, {"bit_width": 64, "signed": False}, None
    if pa.types.is_float16(t):
        return Type.FIXED_LEN_BYTE_ARRAY, K.FLOAT16, {}, 2
    if pa.types.is_float32(t):
        return Type.FLOAT, K.NONE, {}, None
    if pa.types.is_float64(t):
        return Type.DOUBLE, K.NONE, {}, None
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return Type.BYTE_ARRAY, K.STRING, {}, None
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return Type.BYTE_ARRAY, K.NONE, {}, None
    if pa.types.is_fixed_size_binary(t):
        return Type.FIXED_LEN_BYTE_ARRAY, K.NONE, {}, t.byte_width
    if pa.types.is_date32(t):
        return Type.INT32, K.DATE, {}, None
    if pa.types.is_timestamp(t):
        unit = {"ms": K.TIMESTAMP_MILLIS, "us": K.TIMESTAMP_MICROS,
                "ns": K.TIMESTAMP_NANOS}.get(t.unit, K.TIMESTAMP_MICROS)
        return Type.INT64, unit, {"utc": t.tz is not None}, None
    if pa.types.is_time32(t):
        return Type.INT32, K.TIME_MILLIS, {"utc": True}, None
    if pa.types.is_time64(t):
        return Type.INT64, K.TIME_MICROS, {"utc": True}, None
    if pa.types.is_decimal(t):
        params = {"scale": t.scale, "precision": t.precision}
        if t.precision <= 9:
            return Type.INT32, K.DECIMAL, params, None
        if t.precision <= 18:
            return Type.INT64, K.DECIMAL, params, None
        return Type.FIXED_LEN_BYTE_ARRAY, K.DECIMAL, params, 16
    raise TypeError(f"unsupported arrow type {t!r}")


def columns_from_arrow(table, schema: Schema) -> Dict[str, ColumnData]:
    """``{dotted path: ColumnData}`` of an Arrow table (or slice) for
    ``schema``'s leaves: the one way Arrow data comes in (``write_table``
    and the buffers' ``write_arrow``).  A flat leaf under a struct that is
    null somewhere gets its exact def levels, so a null struct and a
    struct of nulls write apart."""
    import pyarrow as pa

    cols: Dict[str, ColumnData] = {}
    for leaf in schema.leaves:
        arr = table[leaf.path[0]]
        if isinstance(arr, pa.ChunkedArray):
            arr = (arr.chunk(0) if arr.num_chunks == 1
                   else arr.combine_chunks())
        cd = _column_from_arrow(arr, leaf)
        if (len(leaf.path) > 1 and leaf.max_repetition_level == 0
                and cd.def_levels is None
                and _struct_chain_has_nulls(arr, leaf)):
            cd.def_levels = _struct_def_levels(arr, schema, leaf)
        cols[leaf.name] = cd
    return cols


def _struct_chain_has_nulls(arr, leaf: Leaf) -> bool:
    """True where a struct layer on the path to ``leaf`` has a null."""
    import pyarrow as pa

    a = arr
    for name in leaf.path[1:]:
        if not pa.types.is_struct(a.type):
            return False
        if a.null_count:
            return True
        a = a.field(name)
    return False


def _struct_def_levels(arr, schema: Schema, leaf: Leaf) -> np.ndarray:
    """The def levels of a flat struct chain, one a row: a level for each
    OPTIONAL node present along ``leaf.path``, stopping at the first null
    ancestor (Arrow leaves the slots under a null parent unspecified)."""
    node = schema.root
    d = np.zeros(len(arr), np.int32)
    alive = np.ones(len(arr), bool)
    a = arr
    for i, name in enumerate(leaf.path):
        node = next(c for c in node.children if c.name == name)
        if node.repetition == Rep.OPTIONAL:
            ok = alive & ~np.asarray(a.is_null()) if a.null_count else alive
            d[ok] += 1
            alive = ok
        if i + 1 < len(leaf.path):
            a = a.field(leaf.path[i + 1])
    return d


def _column_from_arrow(arr, leaf: Leaf, pos: int = 1) -> ColumnData:
    """One leaf's buffers out of ``arr`` (the top-level array, or one
    already descended to ``leaf.path[pos - 1]``): a struct descends by
    field name with its nulls folded into the child; a chain of lists
    (and maps) gives one offsets array a level, outermost first, with
    each level's null lists (their spans of child values dropped); a leaf
    its dense present values and validity.  A null struct under a list
    raises ``NotImplementedError`` (write such data through the row or
    typed writers)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    t = arr.type
    if pa.types.is_struct(t):
        if arr.null_count and leaf.max_repetition_level > 0:
            raise NotImplementedError(
                f"column {leaf.name}: null struct values mixed with "
                "repetition are not supported by the arrow ingestion path "
                "(write via rows/typed API for exact def levels)")
        child = arr.field(leaf.path[pos])
        if arr.null_count:
            child = pc.if_else(pc.is_valid(arr), child,
                               pa.scalar(None, type=child.type))
        return _column_from_arrow(child, leaf, pos + 1)
    if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_map(t):
        offsets_per_level, validity_per_level = [], []
        a = arr
        while True:
            ty = a.type
            if pa.types.is_map(ty):
                child = a.keys if leaf.path[pos + 1] == "key" else a.items
            elif pa.types.is_list(ty) or pa.types.is_large_list(ty):
                child = a.values
            else:
                break
            lv = ~np.asarray(a.is_null()) if a.null_count else None
            raw = np.asarray(a.offsets, dtype=np.int64)
            pos += 2
            if raw[0] != 0 or len(child) != raw[-1]:  # a sliced parent
                child = child.slice(raw[0], raw[-1] - raw[0])
            offs = raw - raw[0]
            if lv is not None:
                # a null list's span may still cover child values, which
                # Parquet has no slot for: drop them, zero its length
                lens = np.diff(offs)
                if lens[~lv].any():
                    child = child.filter(pa.array(np.repeat(lv, lens)))
                    offs = np.zeros(len(offs), np.int64)
                    np.cumsum(np.where(lv, lens, 0), out=offs[1:])
            offsets_per_level.append(offs)
            validity_per_level.append(lv)
            a = child
        inner = _column_from_arrow(a, leaf, pos)
        inner.list_offsets = offsets_per_level
        inner.list_validity = validity_per_level
        return inner
    if pa.types.is_null(t):  # an untyped all-null column
        return ColumnData(values=np.empty(0, np.int32),
                          validity=np.zeros(len(arr), bool))
    validity = ~np.asarray(arr.is_null()) if arr.null_count else None
    if pa.types.is_string(t) or pa.types.is_binary(t) or \
            pa.types.is_large_string(t) or pa.types.is_large_binary(t):
        # the present values straight from the Arrow buffers
        dense = arr.drop_null()
        large = pa.types.is_large_string(t) or pa.types.is_large_binary(t)
        bufs = dense.buffers()
        o0 = dense.offset
        offs = np.frombuffer(bufs[1], np.int64 if large else np.int32)[
            o0:o0 + len(dense) + 1].astype(np.int64)
        data = (np.frombuffer(bufs[2], np.uint8)[offs[0]:offs[-1]]
                if len(dense) else np.empty(0, np.uint8))
        return ColumnData(values=data, offsets=offs - offs[0],
                          validity=validity)
    if pa.types.is_boolean(t):
        return ColumnData(values=np.asarray(arr.drop_null()),
                          validity=validity)
    if pa.types.is_float16(t):
        dense = np.asarray(arr.drop_null()).astype(np.float16)
        return ColumnData(values=dense.view(np.uint8).reshape(-1, 2),
                          validity=validity)
    if pa.types.is_fixed_size_binary(t):
        dense = arr.drop_null()
        w = t.byte_width
        flat = np.frombuffer(dense.buffers()[1], np.uint8)[
            dense.offset * w:(dense.offset + len(dense)) * w]
        return ColumnData(values=flat.reshape(-1, w), validity=validity)
    if pa.types.is_decimal(t):
        dense = arr.drop_null()
        ints = np.asarray([int(x.as_py().scaleb(t.scale)) for x in dense],
                          dtype=np.int64)
        phys = leaf.physical_type
        if phys == Type.INT32:
            return ColumnData(values=ints.astype(np.int32),
                              validity=validity)
        if phys == Type.INT64:
            return ColumnData(values=ints, validity=validity)
        w = leaf.type_length
        be = np.zeros((len(ints), w), np.uint8)
        for k in range(w):
            be[:, w - 1 - k] = (ints >> (8 * k)) & 0xFF
        return ColumnData(values=be, validity=validity)
    # fixed-width numbers, dates, times and timestamps
    dense = arr.drop_null()
    return ColumnData(values=np.asarray(dense.cast(_storage_type(t))),
                      validity=validity)


def _storage_type(t):
    import pyarrow as pa

    if pa.types.is_date32(t):
        return pa.int32()
    if pa.types.is_timestamp(t) or pa.types.is_time64(t):
        return pa.int64()
    if pa.types.is_time32(t):
        return pa.int32()
    return t
