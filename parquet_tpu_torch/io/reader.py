"""Parquet file reader: footer, row groups, column-chunk pages, indexes
and bloom filters, the device read of whole files and batched point
lookups.

The port's cut of ``parquet_tpu/io/reader.py`` (``ParquetFile``,
``RowGroupReader``, ``ColumnChunkReader``).  :meth:`ParquetFile.read` sends
every selected (column, row group) chunk through
``parallel/device_reader.py::decode_chunks_pipelined`` and concatenates
each column's row-group parts.  The result is a dict of
:class:`~parquet_tpu_torch.io.column.Column` whose tensors lie on the
requested device: CUDA by default, the CPU only when the caller asks.
:meth:`ParquetFile.find_rows` is the batched point lookup of
:mod:`~parquet_tpu_torch.io.lookup`.

Chunk readers are memoized on the file (the file is immutable once open),
and each memoizes its parsed column index, offset index and bloom filter,
so repeated lookups neither re-read them nor copy a filter to the card
again.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import codecs
from ..errors import MAX_PAGE_SIZE, CorruptedError
from ..format import metadata as md
from ..format import thrift
from ..format.enums import PageType, Type
from ..schema.schema import Leaf, Schema
from .column import Column, concat_columns
from .source import Source, as_source

_UNSET = object()  # memo sentinel: None is a valid parsed value

# an index structure longer than this is corruption, not an index
MAX_INDEX_SIZE = 64 << 20


@dataclass
class PageInfo:
    """One parsed page: header + raw (still compressed) payload."""

    header: md.PageHeader
    payload: bytes
    offset: int  # absolute file offset of the page header

    @property
    def page_type(self) -> PageType:
        return PageType(self.header.type)

    @property
    def num_values(self) -> int:
        h = self.header
        if h.data_page_header is not None:
            return h.data_page_header.num_values
        if h.data_page_header_v2 is not None:
            return h.data_page_header_v2.num_values
        if h.dictionary_page_header is not None:
            return h.dictionary_page_header.num_values
        return 0


class ColumnChunkReader:
    """One column chunk of one row group."""

    def __init__(self, file: "ParquetFile", rg_index: int,
                 chunk: md.ColumnChunk, leaf: Leaf):
        self.file = file
        self.rg_index = rg_index
        self.chunk = chunk
        self.leaf = leaf
        self.meta = chunk.meta_data
        if self.meta is None:
            raise CorruptedError(
                f"column chunk {leaf.name!r} of row group {rg_index} has no "
                "metadata")
        self._st = self._ci = self._oi = self._bf = _UNSET

    @property
    def codec(self) -> codecs.Codec:
        return codecs.get_codec(self.meta.codec)

    @property
    def byte_range(self) -> Tuple[int, int]:
        """(start, size) of this chunk's page bytes in the file."""
        m = self.meta
        start = m.data_page_offset
        if (m.dictionary_page_offset is not None
                and 0 < m.dictionary_page_offset < start):
            start = m.dictionary_page_offset
        return start, m.total_compressed_size

    def pages(self) -> Iterator[PageInfo]:
        """Parse the chunk's page stream from one contiguous read."""
        start, size = self.byte_range
        raw = self.file.source.pread(start, size)
        pos = 0
        values_seen = 0
        total = self.meta.num_values
        while values_seen < total and pos < size:
            try:
                header, data_pos = thrift.deserialize(md.PageHeader, raw, pos)
            except (thrift.ThriftError, IndexError, struct.error) as e:
                raise CorruptedError(
                    f"bad page header at {start + pos}: {e}") from e
            clen = header.compressed_page_size
            if clen is None or not 0 <= clen <= MAX_PAGE_SIZE:
                raise CorruptedError(
                    f"page at {start + pos}: compressed size {clen} out of "
                    "range")
            payload = raw[data_pos:data_pos + clen]
            if len(payload) != clen:
                raise CorruptedError(
                    f"truncated page payload at {start + pos}")
            page = PageInfo(header=header, payload=payload,
                            offset=start + pos)
            if page.page_type in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
                values_seen += page.num_values
            yield page
            pos = data_pos + clen

    def pages_at(self, offset: int, size: int,
                 num_pages: Optional[int] = None) -> Iterator[PageInfo]:
        """Parse the pages of one byte span of the chunk (an offset-index
        seek: one pread covering just the selected pages)."""
        raw = self.file.source.pread(offset, size)
        pos = 0
        yielded = 0
        while pos < size and (num_pages is None or yielded < num_pages):
            try:
                header, data_pos = thrift.deserialize(md.PageHeader, raw, pos)
            except (thrift.ThriftError, IndexError, struct.error) as e:
                raise CorruptedError(
                    f"bad page header at {offset + pos}: {e}") from e
            clen = header.compressed_page_size
            if clen is None or not 0 <= clen <= MAX_PAGE_SIZE:
                raise CorruptedError(
                    f"page at {offset + pos}: compressed size {clen} out of "
                    "range")
            payload = raw[data_pos:data_pos + clen]
            if len(payload) != clen:
                raise CorruptedError(
                    f"truncated page payload at {offset + pos}")
            yield PageInfo(header=header, payload=payload,
                           offset=offset + pos)
            yielded += 1
            pos = data_pos + clen

    def _read_index(self, cls, offset, length, what: str):
        if length is None or not 0 <= length <= MAX_INDEX_SIZE:
            raise CorruptedError(f"{what} of {self.leaf.name!r} at {offset}: "
                                 f"length {length} out of range")
        raw = self.file.source.pread(offset, length)
        try:
            return thrift.deserialize(cls, raw)[0]
        except (thrift.ThriftError, IndexError, struct.error) as e:
            raise CorruptedError(f"bad {what} at {offset}: {e}") from e

    def column_index(self) -> Optional[md.ColumnIndex]:
        if self._ci is _UNSET:
            c = self.chunk
            self._ci = (None if c.column_index_offset is None else
                        self._read_index(md.ColumnIndex,
                                         c.column_index_offset,
                                         c.column_index_length,
                                         "column index"))
        return self._ci

    def offset_index(self) -> Optional[md.OffsetIndex]:
        if self._oi is _UNSET:
            c = self.chunk
            self._oi = (None if c.offset_index_offset is None else
                        self._read_index(md.OffsetIndex,
                                         c.offset_index_offset,
                                         c.offset_index_length,
                                         "offset index"))
        return self._oi

    def bloom_filter(self):
        """The chunk's :class:`~parquet_tpu_torch.io.bloom.SplitBlockFilter`
        or None, read once."""
        if self._bf is _UNSET:
            from .bloom import read_bloom_filter

            self._bf = read_bloom_filter(self)
        return self._bf

    def statistics(self):
        """The chunk's decoded statistics or None, decoded once."""
        if self._st is _UNSET:
            from .statistics import decode_statistics

            self._st = decode_statistics(self.meta.statistics, self.leaf)
        return self._st


def decode_dictionary_page(reader: ColumnChunkReader, page: PageInfo):
    """Decompress and decode one PLAIN dictionary page to host numpy: an
    array, or for byte arrays a ``(values, offsets)`` pair."""
    from ..ops import ref

    h = page.header
    raw = reader.codec.decode(page.payload, h.uncompressed_page_size)
    return ref.decode_plain(raw, h.dictionary_page_header.num_values,
                            Type(reader.meta.type), reader.leaf.type_length)


class RowGroupReader:
    def __init__(self, file: "ParquetFile", index: int, rg: md.RowGroup):
        self.file = file
        self.index = index
        self.rg = rg

    @property
    def num_rows(self) -> int:
        return self.rg.num_rows

    @property
    def sorting_columns(self):
        return self.rg.sorting_columns

    def column(self, i: int) -> ColumnChunkReader:
        key = (self.index, i)
        reader = self.file._chunk_cache.get(key)
        if reader is None:
            reader = self.file._chunk_cache[key] = ColumnChunkReader(
                self.file, self.index, self.rg.columns[i],
                self.file.schema.leaves[i])
        return reader


def resolve_device(device) -> torch.device:
    """The device a read decodes on.  CUDA unless the caller names the CPU;
    a CUDA request without a usable card raises instead of carrying on on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "parquet_tpu_torch: CUDA is not available; pass "
                "device='cpu' to decode on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


class ParquetFile:
    """An open Parquet file: magic check at both ends and the thrift
    footer."""

    def __init__(self, source):
        self._chunk_cache: Dict[Tuple[int, int], ColumnChunkReader] = {}
        self.source: Source = as_source(source)
        try:
            self._open_footer()
        except BaseException:
            self.source.close()
            raise

    def _open_footer(self) -> None:
        size = self.source.size()
        if size < 12:
            raise CorruptedError(
                f"file too small ({size} bytes) to be parquet")
        tail = self.source.pread(size - 8, 8)
        if tail[4:] != md.MAGIC:
            raise CorruptedError("missing PAR1 magic at end of file")
        footer_len = struct.unpack("<I", tail[:4])[0]
        if footer_len + 12 > size:
            raise CorruptedError(
                f"footer length {footer_len} exceeds file size {size}")
        if self.source.pread(0, 4) != md.MAGIC:
            raise CorruptedError("missing PAR1 magic at start of file")
        footer = self.source.pread(size - 8 - footer_len, footer_len)
        try:
            self.metadata, _ = thrift.deserialize(md.FileMetaData, footer)
        except (thrift.ThriftError, IndexError, struct.error) as e:
            raise CorruptedError(f"bad footer: {e}") from e
        if not self.metadata.schema:
            raise CorruptedError("footer has no schema")
        self.schema = Schema.from_elements(self.metadata.schema)

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows or 0

    @property
    def row_groups(self) -> List[RowGroupReader]:
        return [RowGroupReader(self, i, rg)
                for i, rg in enumerate(self.metadata.row_groups or [])]

    def read(self, columns: Optional[Sequence[str]] = None,
             device="cuda") -> Dict[str, Column]:
        """Decode the selected columns (all by default) of every row group
        on ``device``; returns ``{name: Column}`` in schema order."""
        from ..parallel.device_reader import decode_chunks_pipelined

        dev = resolve_device(device)
        if columns is None:
            leaves = list(self.schema.leaves)
        else:
            leaves = [self.schema.leaf(c) for c in columns]
        rgs = self.row_groups
        chunks = [rg.column(leaf.column_index)
                  for leaf in leaves for rg in rgs]
        decoded = decode_chunks_pipelined(chunks, dev)
        out = {}
        for leaf in leaves:
            parts = [next(decoded) for _ in rgs]
            out[leaf.name] = (concat_columns(parts) if parts
                              else _empty_column(leaf, dev))
        return out

    def find_rows(self, path: str, keys, columns: Optional[Sequence[str]] = None,
                  device="cuda"):
        """Batched point lookup: the rows where column ``path`` equals each
        of ``keys``, with the row-aligned values of ``columns``.  The bloom
        stage and the page decodes run on ``device`` (CUDA unless the caller
        names the CPU).  Returns a
        :class:`~parquet_tpu_torch.io.lookup.LookupResult` aligned with
        ``keys``."""
        from .lookup import find_rows

        return find_rows(self, path, keys, columns=columns, device=device)

    def close(self) -> None:
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _empty_column(leaf: Leaf, device: torch.device) -> Column:
    """The zero-row column of a file without row groups."""
    from ..schema.types import empty_values

    offsets = None
    if leaf.physical_type == Type.BYTE_ARRAY:
        offsets = torch.zeros(1, dtype=torch.int64, device=device)
    return Column(leaf=leaf, values=empty_values(
        leaf.physical_type, leaf.type_length, device), offsets=offsets)
