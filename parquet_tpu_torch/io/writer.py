"""Parquet writer for flat INT32/INT64/FLOAT/DOUBLE columns.

The port's cut of ``parquet_tpu/io/writer.py`` (``ParquetWriter``,
``write_table``, ``WriterOptions`` with the same size defaults).  Columns
are required or optional; each chunk is PLAIN, RLE_DICTIONARY (with its
dictionary page) or DELTA_BINARY_PACKED, in v1 or v2 data pages,
UNCOMPRESSED or GZIP.  As the reference's writer does, it writes chunk and
page statistics, the page index (column index with its boundary order, and
offset index), split-block bloom filters for the columns named in
``WriterOptions.bloom_filters`` and the row groups' ``sorting_columns``;
the bloom filters, then the page index, go between the last row group and
the footer.  Page CRCs are not written.

``write_table`` takes ``{name: array}``: a numpy array is a required
column, a ``numpy.ma.MaskedArray`` an optional one whose masked slots are
null.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import codecs
from ..format import metadata as md
from ..format import thrift
from ..format.enums import (BoundaryOrder, CompressionCodec, Encoding,
                            PageType, Type)
from ..format.enums import FieldRepetitionType as Rep
from ..ops import ref
from ..schema.schema import Leaf, Schema
from ..schema.types import PHYSICAL_NP_DTYPE, PHYSICAL_WIDTH, physical_of_dtype

DEFAULT_CREATED_BY = "parquet_tpu_torch"

_CODEC_NAMES = {"none": CompressionCodec.UNCOMPRESSED,
                "uncompressed": CompressionCodec.UNCOMPRESSED,
                "gzip": CompressionCodec.GZIP}

_WRITE_ENCODINGS = (Encoding.PLAIN, Encoding.RLE_DICTIONARY,
                    Encoding.DELTA_BINARY_PACKED)


@dataclass
class WriterOptions:
    """Writer knobs, with the JAX package's size defaults."""

    compression: Union[str, CompressionCodec] = CompressionCodec.UNCOMPRESSED
    data_page_version: int = 1
    data_page_size: int = 1 << 20  # bytes of values per page
    row_group_size: int = 1 << 20  # max rows per row group
    # dictionary-encode columns with no forced encoding, while the
    # dictionary fits dictionary_page_limit bytes; PLAIN beyond it
    dictionary: bool = True
    dictionary_page_limit: int = 1 << 20
    # name -> PLAIN | RLE_DICTIONARY | DELTA_BINARY_PACKED
    column_encoding: Dict[str, Encoding] = dc_field(default_factory=dict)
    created_by: str = DEFAULT_CREATED_BY
    write_statistics: bool = True
    write_page_index: bool = True
    # column name -> bloom filter bits per value
    bloom_filters: Dict[str, float] = dc_field(default_factory=dict)
    # (column name, descending, nulls_first), recorded in every row group
    sorting_columns: List[Tuple[str, bool, bool]] = dc_field(
        default_factory=list)

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
                                 f"{Encoding(enc).name} in this slice")

    def codec_id(self) -> CompressionCodec:
        if isinstance(self.compression, str):
            return _CODEC_NAMES[self.compression.lower()]
        return CompressionCodec(self.compression)


@dataclass
class ColumnData:
    """One leaf's input: dense present values + per-slot validity."""

    values: np.ndarray
    validity: Optional[np.ndarray] = None  # bool per slot; None = required


class ParquetWriter:
    """Write row groups to a path or a binary file object; the footer goes
    out on :meth:`close`."""

    def __init__(self, sink, schema: Schema,
                 options: Optional[WriterOptions] = None):
        self.schema = schema
        self.options = options or WriterOptions()
        self._own_sink = isinstance(sink, (str, os.PathLike))
        self._f = open(sink, "wb") if self._own_sink else sink
        self._codec = codecs.get_codec(self.options.codec_id())
        self._f.write(md.MAGIC)
        self._pos = len(md.MAGIC)
        self._row_groups: List[md.RowGroup] = []
        # per row group, per column: (column index, offset index, bloom blob)
        self._extras: List[List[tuple]] = []
        self._num_rows = 0
        self._closed = False

    def write_row_group(self, columns: Dict[str, ColumnData],
                        num_rows: int) -> None:
        if self._closed:
            raise ValueError("write on a closed writer")
        chunks, extras = [], []
        rg_start = self._pos
        for leaf in self.schema.leaves:
            data = columns[leaf.name]
            if data.validity is not None and len(data.validity) != num_rows:
                raise ValueError(f"column {leaf.name!r}: {len(data.validity)}"
                                 f" slots for {num_rows} rows")
            chunk, extra = self._write_chunk(leaf, data, num_rows)
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

    def _write_chunk(self, leaf: Leaf, data: ColumnData, num_rows: int):
        """Write one chunk's pages; returns its ``ColumnChunk`` and the
        (column index, offset index, bloom blob) that go out at close."""
        opts = self.options
        physical = leaf.physical_type
        values = np.ascontiguousarray(data.values,
                                      dtype=PHYSICAL_NP_DTYPE[physical])
        validity = (None if data.validity is None
                    else np.asarray(data.validity, bool))
        nvalues = num_rows if validity is None else int(validity.sum())
        if len(values) != nvalues:
            raise ValueError(f"column {leaf.name!r}: {len(values)} values "
                             f"for {nvalues} present slots")
        forced = opts.column_encoding.get(leaf.name)
        encoding = Encoding(forced) if forced is not None else None
        if (encoding == Encoding.DELTA_BINARY_PACKED
                and physical not in (Type.INT32, Type.INT64)):
            raise ValueError(f"column {leaf.name!r}: DELTA_BINARY_PACKED "
                             f"takes INT32/INT64, not {physical.name}")
        dict_values = indices = None
        if encoding == Encoding.RLE_DICTIONARY or (
                encoding is None and opts.dictionary):
            # unique bit patterns: -0.0 and 0.0, or two NaN payloads, are
            # distinct entries
            bits = values.view(f"<i{values.itemsize}")
            uniq, indices = np.unique(bits, return_inverse=True)
            dict_values = uniq.view(values.dtype)
            if (encoding is None and (
                    not nvalues
                    or dict_values.nbytes > opts.dictionary_page_limit)):
                dict_values = indices = None
        if encoding is None:
            encoding = (Encoding.RLE_DICTIONARY if indices is not None
                        else Encoding.PLAIN)
        stats = None
        if opts.write_statistics:
            # a dictionary holds exactly the chunk's distinct values
            stats = _statistics(leaf, dict_values if indices is not None
                                else values, num_rows - nvalues)
        bloom_blob = None
        if leaf.name in opts.bloom_filters:
            from .bloom import build_split_block_filter

            bloom_blob = build_split_block_filter(
                leaf, values, dict_values if indices is not None else None,
                opts.bloom_filters[leaf.name])

        chunk_start = self._pos
        parts: List[bytes] = []
        uncompressed = 0
        pos = chunk_start

        def emit(header: md.PageHeader, body: bytes) -> None:
            nonlocal uncompressed, pos
            blob = thrift.serialize(header)
            parts.append(blob)
            parts.append(body)
            pos += len(blob) + len(body)
            uncompressed += header.uncompressed_page_size + len(blob)

        dict_page_offset = None
        encodings = {Encoding.RLE, encoding}
        width = 0
        if indices is not None:
            raw = ref.encode_plain(dict_values, physical)
            comp = self._codec.encode(raw)
            emit(md.PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                uncompressed_page_size=len(raw),
                compressed_page_size=len(comp),
                dictionary_page_header=md.DictionaryPageHeader(
                    num_values=len(dict_values),
                    encoding=int(Encoding.PLAIN), is_sorted=False)),
                comp)
            dict_page_offset = chunk_start
            encodings.add(Encoding.PLAIN)
            # bit width >= 1: several readers reject zero-width streams
            width = max(int(len(dict_values) - 1).bit_length(), 1)
        data_page_offset = pos
        locations: List[md.PageLocation] = []
        page_stats: List[Tuple[md.Statistics, int]] = []  # (stats, values)

        rows_per_page = max(opts.data_page_size // PHYSICAL_WIDTH[physical],
                            1)
        present = (None if validity is None
                   else np.concatenate([[0], np.cumsum(validity)]))
        for r0 in range(0, max(num_rows, 1), rows_per_page):
            r1 = min(r0 + rows_per_page, num_rows)
            v0, v1 = ((r0, r1) if present is None
                      else (int(present[r0]), int(present[r1])))
            if indices is not None:
                body = ref.encode_rle_dict_indices(indices[v0:v1], width)
            elif encoding == Encoding.DELTA_BINARY_PACKED:
                body = ref.encode_delta_binary_packed(values[v0:v1])
            else:
                body = ref.encode_plain(values[v0:v1], physical)
            levels = b""
            if validity is not None:
                levels = ref.encode_rle(validity[r0:r1].astype(np.int64), 1)
            pstat = None
            if opts.write_statistics:
                pstat = _statistics(leaf, values[v0:v1], (r1 - r0) - (v1 - v0))
                page_stats.append((pstat, v1 - v0))
            page_start = pos
            emit(*self._data_page(levels, validity is not None, body,
                                  r1 - r0, v1 - v0, encoding, pstat))
            locations.append(md.PageLocation(
                offset=page_start, compressed_page_size=pos - page_start,
                first_row_index=r0))

        self._f.write(b"".join(parts))
        self._pos = pos
        meta = md.ColumnMetaData(
            type=int(physical),
            encodings=sorted(int(e) for e in encodings),
            path_in_schema=[leaf.name],
            codec=int(opts.codec_id()),
            num_values=num_rows,
            total_uncompressed_size=uncompressed,
            total_compressed_size=self._pos - chunk_start,
            data_page_offset=data_page_offset,
            dictionary_page_offset=dict_page_offset,
            statistics=stats)
        column_index = offset_index = None
        if opts.write_page_index:
            offset_index = md.OffsetIndex(page_locations=locations)
            if page_stats:
                column_index = _column_index(leaf, page_stats)
        return (md.ColumnChunk(file_offset=chunk_start, meta_data=meta),
                (column_index, offset_index, bloom_blob))

    def _data_page(self, levels: bytes, has_levels: bool, values: bytes,
                   n_slots: int, n_vals: int, encoding: Encoding,
                   stats: Optional[md.Statistics]):
        if self.options.data_page_version == 2:
            # levels sit uncompressed in front of the compressed values
            comp = self._codec.encode(values)
            return md.PageHeader(
                type=int(PageType.DATA_PAGE_V2),
                uncompressed_page_size=len(levels) + len(values),
                compressed_page_size=len(levels) + len(comp),
                data_page_header_v2=md.DataPageHeaderV2(
                    num_values=n_slots, num_nulls=n_slots - n_vals,
                    num_rows=n_slots, encoding=int(encoding),
                    definition_levels_byte_length=len(levels),
                    repetition_levels_byte_length=0,
                    is_compressed=True, statistics=stats)), levels + comp
        if has_levels:
            levels = struct.pack("<I", len(levels)) + levels
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

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._write_blooms_and_page_index()
        fmd = md.FileMetaData(
            version=2,
            schema=self.schema.to_elements(),
            num_rows=self._num_rows,
            row_groups=self._row_groups,
            created_by=self.options.created_by)
        blob = thrift.serialize(fmd)
        self._f.write(blob + struct.pack("<I", len(blob)) + md.MAGIC)
        if self._own_sink:
            self._f.close()
        else:
            self._f.flush()

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
        if exc[0] is None:
            self.close()
        elif self._own_sink:
            self._f.close()


def _statistics(leaf: Leaf, values: np.ndarray,
                null_count: int) -> md.Statistics:
    """Statistics of a span of present values: min/max (NaNs skipped) in
    both the current and the deprecated fields, and the null count."""
    from ..algebra.compare import encode_order_value, min_max

    mn, mx = min_max(leaf, values)
    if mn is not None:
        mn, mx = encode_order_value(mn, leaf), encode_order_value(mx, leaf)
    return md.Statistics(null_count=null_count, min_value=mn, max_value=mx,
                         min=mn, max=mx)


def _column_index(leaf: Leaf, page_stats: List[Tuple[md.Statistics, int]]
                  ) -> md.ColumnIndex:
    """A page with no values is a null page; a bound that does not exist
    (no values, or all NaN) is written as empty bytes."""
    nulls = [nvals == 0 for _, nvals in page_stats]
    mins = [st.min_value or b"" for st, _ in page_stats]
    maxs = [st.max_value or b"" for st, _ in page_stats]
    return md.ColumnIndex(
        null_pages=nulls, min_values=mins, max_values=maxs,
        boundary_order=int(_boundary_order(mins, maxs, leaf, nulls)),
        null_counts=[st.null_count or 0 for st, _ in page_stats])


def _boundary_order(mins: List[bytes], maxs: List[bytes], leaf: Leaf,
                    null_pages: List[bool]) -> BoundaryOrder:
    """ASCENDING or DESCENDING when the non-null pages' bounds are, else
    UNORDERED (the reference's rule, over decoded bounds)."""
    from .statistics import decode_stat_value

    mins = [m for m, n in zip(mins, null_pages) if not n]
    maxs = [m for m, n in zip(maxs, null_pages) if not n]
    if len(mins) <= 1:
        return BoundaryOrder.ASCENDING
    dmins = [decode_stat_value(m, leaf) for m in mins]
    dmaxs = [decode_stat_value(m, leaf) for m in maxs]
    if any(v is None for v in dmins) or any(v is None for v in dmaxs):
        return BoundaryOrder.UNORDERED
    asc = all(dmins[i] <= dmins[i + 1] for i in range(len(dmins) - 1)) and \
        all(dmaxs[i] <= dmaxs[i + 1] for i in range(len(dmaxs) - 1))
    if asc:
        return BoundaryOrder.ASCENDING
    desc = all(dmins[i] >= dmins[i + 1] for i in range(len(dmins) - 1)) and \
        all(dmaxs[i] >= dmaxs[i + 1] for i in range(len(dmaxs) - 1))
    return BoundaryOrder.DESCENDING if desc else BoundaryOrder.UNORDERED


def _column_data(arr) -> ColumnData:
    if isinstance(arr, np.ma.MaskedArray):
        validity = ~np.ma.getmaskarray(arr)
        return ColumnData(values=np.asarray(arr.data)[validity],
                          validity=validity)
    return ColumnData(values=np.asarray(arr))


def schema_of(table: Dict[str, np.ndarray]) -> Schema:
    """The flat schema of ``{name: array}``: masked arrays are OPTIONAL."""
    return Schema([
        Leaf(-1, name, physical_of_dtype(np.asarray(arr).dtype),
             Rep.OPTIONAL if isinstance(arr, np.ma.MaskedArray)
             else Rep.REQUIRED)
        for name, arr in table.items()])


def write_table(table: Dict[str, np.ndarray], sink,
                options: Optional[WriterOptions] = None) -> None:
    """Write ``{name: array}`` to ``sink`` (a path or a binary file
    object) in row groups of ``options.row_group_size`` rows."""
    options = options or WriterOptions()
    lengths = {len(a) for a in table.values()}
    if len(lengths) > 1:
        raise ValueError(f"columns differ in length: {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    with ParquetWriter(sink, schema_of(table), options) as w:
        for start in range(0, n, options.row_group_size):
            end = min(start + options.row_group_size, n)
            w.write_row_group({name: _column_data(arr[start:end])
                               for name, arr in table.items()}, end - start)
