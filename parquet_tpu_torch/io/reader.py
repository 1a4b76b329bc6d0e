"""Parquet file reader: footer, row groups, column-chunk pages, indexes
and bloom filters, the device read of whole files, the host decode of a
chunk, and batched point lookups.

The port's cut of ``parquet_tpu/io/reader.py`` (``ParquetFile``,
``RowGroupReader``, ``ColumnChunkReader``, ``decode_chunk_host``).
:meth:`ParquetFile.read` sends every selected (leaf, row group) chunk
through ``parallel/device_reader.py::decode_chunks_pipelined`` and
concatenates each leaf's row-group parts.  The result is a dict of
:class:`~parquet_tpu_torch.io.column.Column` by dotted path, whose tensors
lie on the requested device: CUDA by default, the CPU only when the caller
asks.  :func:`decode_chunk_host` decodes the chunks the device route
refuses, on the host, and moves the finished column to the device.
:meth:`ParquetFile.find_rows` is the batched point lookup of
:mod:`~parquet_tpu_torch.io.lookup`, and :meth:`ParquetFile.iter_batches`
the streamed read of :mod:`~parquet_tpu_torch.io.stream`, whose cursors
read each chunk in windows (:meth:`ColumnChunkReader.pages_streamed`).
:class:`ReadOptions` are the JAX package's: with ``verify_crc`` every page
read is held to the CRC32 its header carries (:func:`verify_page_crc`).

Chunk readers are memoized on the file (the file is immutable once open),
and each memoizes its parsed column index, offset index and bloom filter,
so repeated lookups neither re-read them nor copy a filter to the card
again.
"""

from __future__ import annotations

import contextlib
import struct
import time
import zlib
from dataclasses import dataclass
from typing import (Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import codecs
from ..errors import (MAX_PAGE_HEADER_SIZE, MAX_PAGE_SIZE, CorruptedError,
                      unsupported)
from ..format import metadata as md
from ..format import thrift
from ..format.enums import CompressionCodec, Encoding, PageType, Type
from ..obs import scope as _oscope
from ..obs import trace as _otrace
from ..obs.metrics import histogram as _ohistogram
from ..ops import host
from ..ops.encodings import (DictIndices, EncodingSpec, is_builtin_decode,
                             register_encoding)
from ..ops.encodings import lookup as lookup_encoding
from ..schema.schema import Leaf, Schema
from ..utils.debug import counters
from .column import Column, concat_columns
from .source import Source, as_source

# resolved once: a read's observation takes no registry lock
_M_READ_FILE_S = _ohistogram("read.file_s")

_UNSET = object()  # memo sentinel: None is a valid parsed value

# an index structure longer than this is corruption, not an index
MAX_INDEX_SIZE = 64 << 20


@dataclass
class ReadOptions:
    """How a file is opened, as the JAX package's ``ReadOptions``.  The
    page index and the bloom filters are read when a lookup or a scan
    first needs them (``skip_page_index`` and ``skip_bloom_filters`` keep
    that default); ``verify_crc`` holds every page read to the CRC32 its
    header carries; ``footer_read_size`` bytes of the file's tail are read
    at open, so a footer that fits costs one read."""

    skip_page_index: bool = True
    skip_bloom_filters: bool = True
    verify_crc: bool = False
    footer_read_size: int = 64 * 1024


def _crc_error(offset: int) -> CorruptedError:
    e = CorruptedError(f"page CRC mismatch at offset {offset}")
    e.page_offset = offset
    return e


def verify_page_crc(reader, page: "PageInfo") -> None:
    """Under ``ReadOptions(verify_crc=True)``, the CRC32 of ``page``'s
    stored bytes against its header's (a page without one passes); a
    mismatch raises :class:`CorruptedError` naming the page's offset."""
    h = page.header
    if reader.file.options.verify_crc and h.crc is not None:
        if zlib.crc32(host.as_u8(page.payload)) != h.crc & 0xFFFFFFFF:
            raise _crc_error(page.offset)


def _verify_table_crcs(reader, raw, start: int, rows: np.ndarray) -> None:
    """:func:`verify_page_crc` of every page of a page-header table over
    ``raw`` (positions relative to it, ``start`` its file offset)."""
    if not reader.file.options.verify_crc:
        return
    buf = host.as_u8(raw)
    for row in rows[rows[:, host.PG_CRC] >= 0].tolist():
        data = row[host.PG_DATA_POS]
        if zlib.crc32(buf[data:data + row[host.PG_COMP]]) != row[host.PG_CRC]:
            raise _crc_error(start + row[host.PG_HEADER_POS])


@dataclass
class PageInfo:
    """One parsed page: header + raw (still compressed) payload."""

    header: md.PageHeader
    payload: np.ndarray  # uint8 (a view of the chunk's bytes)
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


_PAGE_TYPES = frozenset(int(t) for t in PageType)


def _opt(v: int) -> Optional[int]:
    return None if v == -1 else v


def _page_header(row: List[int]) -> md.PageHeader:
    """A page-header table row as the thrift walk's ``PageHeader``
    (statistics are not parsed; the CRC is its unsigned 32-bit value)."""
    t = row[host.PG_TYPE]
    h = md.PageHeader(
        type=t, uncompressed_page_size=_opt(row[host.PG_UNCOMP]),
        compressed_page_size=row[host.PG_COMP], crc=_opt(row[host.PG_CRC]))
    enc = _opt(row[host.PG_ENC])
    if t == PageType.DATA_PAGE:
        h.data_page_header = md.DataPageHeader(
            num_values=row[host.PG_NVALS], encoding=enc,
            definition_level_encoding=_opt(row[host.PG_DEF_ENC]),
            repetition_level_encoding=_opt(row[host.PG_REP_ENC]))
    elif t == PageType.DATA_PAGE_V2:
        comp = row[host.PG_IS_COMPRESSED]
        h.data_page_header_v2 = md.DataPageHeaderV2(
            num_values=row[host.PG_NVALS],
            num_nulls=_opt(row[host.PG_NNULLS]),
            num_rows=_opt(row[host.PG_NROWS]), encoding=enc,
            definition_levels_byte_length=_opt(row[host.PG_DL_BYTES]),
            repetition_levels_byte_length=_opt(row[host.PG_RL_BYTES]),
            is_compressed=None if comp == -1 else bool(comp))
    elif t == PageType.DICTIONARY_PAGE:
        h.dictionary_page_header = md.DictionaryPageHeader(
            num_values=_opt(row[host.PG_DICT_NVALS]), encoding=enc)
    return h


def page_infos(raw, start: int, table: np.ndarray) -> List[PageInfo]:
    """The :class:`PageInfo` of each row of ``raw``'s page-header table
    (``host.scan_page_headers``); payloads are views of ``raw``."""
    buf = host.as_u8(raw)
    out = []
    for row in table.tolist():
        at = row[host.PG_HEADER_POS]
        if row[host.PG_TYPE] not in _PAGE_TYPES:
            raise CorruptedError(f"bad page header at {start + at}: page "
                                 f"type {row[host.PG_TYPE]}")
        data = row[host.PG_DATA_POS]
        out.append(PageInfo(header=_page_header(row),
                            payload=buf[data:data + row[host.PG_COMP]],
                            offset=start + at))
    return out


def _header_row(h: md.PageHeader) -> List[int]:
    """A ``PageHeader`` as a page-header table row (the inverse of
    :func:`_page_header`; -1 where it lacks the field)."""
    row = [-1] * host.PG_NFIELDS

    def put(col, v):
        if v is not None:
            row[col] = int(v)

    put(host.PG_TYPE, h.type)
    put(host.PG_COMP, h.compressed_page_size)
    put(host.PG_UNCOMP, h.uncompressed_page_size)
    put(host.PG_CRC, h.crc)
    d, d2, dp = (h.data_page_header, h.data_page_header_v2,
                 h.dictionary_page_header)
    if d is not None:
        put(host.PG_NVALS, d.num_values)
        put(host.PG_ENC, d.encoding)
        put(host.PG_DEF_ENC, d.definition_level_encoding)
        put(host.PG_REP_ENC, d.repetition_level_encoding)
    if d2 is not None:
        put(host.PG_NVALS, d2.num_values)
        put(host.PG_NNULLS, d2.num_nulls)
        put(host.PG_NROWS, d2.num_rows)
        put(host.PG_ENC, d2.encoding)
        put(host.PG_DL_BYTES, d2.definition_levels_byte_length)
        put(host.PG_RL_BYTES, d2.repetition_levels_byte_length)
        put(host.PG_IS_COMPRESSED, d2.is_compressed)
    if dp is not None:
        put(host.PG_DICT_NVALS, dp.num_values)
        put(host.PG_ENC, dp.encoding)
    return row


class PageBodies(NamedTuple):
    """Where each page's body lies (:meth:`PageTable.bodies`): a data
    page's body is its payload, after a v2 page's levels, from ``start``
    (``length`` bytes), and holds ``size`` bytes decompressed (-1 when
    the header lacks a size) unless ``compressed`` is false."""
    data: np.ndarray
    start: np.ndarray
    length: np.ndarray
    size: np.ndarray
    compressed: np.ndarray


class PageTable:
    """A run of a chunk's pages as arrays: ``rows``, the page-header table
    (``host.scan_page_headers``'s ``PG_*`` columns), and each page's
    payload as a pointer and a length (``payloads``, ``int64[n, 2]``),
    into buffers the table keeps alive.  Made from a chunk's bytes
    (:meth:`ColumnChunkReader.page_table`) or from :class:`PageInfo`
    objects (:meth:`of`); indexing it with a slice or an index array
    gives a table of those pages; :meth:`info` is one page's
    :class:`PageInfo`, and iterating yields them all (the host route's
    and the Python walk's form)."""

    def __init__(self, rows: np.ndarray, payloads: np.ndarray, keep,
                 info_at, all_infos):
        self.rows, self.payloads, self.keep = rows, payloads, keep
        self._info_at, self._all = info_at, all_infos

    @classmethod
    def from_buffer(cls, raw, start: int, rows: np.ndarray) -> "PageTable":
        pt = rows[:, host.PG_TYPE]  # the page types are 0..3
        bad = np.flatnonzero((pt < min(_PAGE_TYPES))
                             | (pt > max(_PAGE_TYPES)))
        if len(bad):
            row = rows[bad[0]]
            raise CorruptedError(
                f"bad page header at {start + int(row[host.PG_HEADER_POS])}"
                f": page type {int(row[host.PG_TYPE])}")
        buf = host.as_u8(raw)
        payloads = np.empty((len(rows), 2), np.int64)
        payloads[:, 0] = rows[:, host.PG_DATA_POS] + buf.ctypes.data
        payloads[:, 1] = rows[:, host.PG_COMP]
        return cls(rows, payloads, buf,
                   lambda i: page_infos(buf, start, rows[i:i + 1])[0],
                   lambda: page_infos(buf, start, rows))

    @classmethod
    def of(cls, pages: Sequence[PageInfo]) -> "PageTable":
        pages = list(pages)
        bufs = [host.as_u8(p.payload) for p in pages]
        rows = np.array([_header_row(p.header) for p in pages],
                        np.int64).reshape(-1, host.PG_NFIELDS)
        payloads = np.array([(b.ctypes.data, len(b)) for b in bufs],
                            np.int64).reshape(-1, 2)
        return cls(rows, payloads, bufs, pages.__getitem__, lambda: pages)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, sel) -> "PageTable":
        sel = np.arange(len(self))[sel] if isinstance(sel, slice) else \
            np.asarray(sel, np.int64)
        return PageTable(self.rows[sel], self.payloads[sel], self.keep,
                         lambda i: self.info(int(sel[i])),
                         lambda: [self.info(i) for i in sel.tolist()])

    def info(self, i: int) -> PageInfo:
        return self._info_at(i)

    def bodies(self) -> PageBodies:
        """Each page's body, as :func:`data_page_bodies` and the chunk
        planner read it (int64 arrays, one entry a page)."""
        rows, plen = self.rows, self.payloads[:, 1]
        pt = rows[:, host.PG_TYPE]
        v2 = pt == PageType.DATA_PAGE_V2
        data = v2 | (pt == PageType.DATA_PAGE)
        levels = (np.where(rows[:, host.PG_RL_BYTES] == -1, 0,
                           rows[:, host.PG_RL_BYTES])
                  + np.where(rows[:, host.PG_DL_BYTES] == -1, 0,
                             rows[:, host.PG_DL_BYTES]))
        skip = np.where(v2, levels, 0)
        # payload[skip:], a negative skip counting from the end
        start = np.where(skip < 0, np.maximum(plen + skip, 0),
                         np.minimum(skip, plen))
        return PageBodies(
            data=data, start=start, length=plen - start,
            size=rows[:, host.PG_UNCOMP] - skip,
            compressed=data & (~v2 | (rows[:, host.PG_IS_COMPRESSED] != 0)))

    def __iter__(self) -> Iterator[PageInfo]:
        return iter(self._all())


def _checked_page_size(header: md.PageHeader, at: int) -> int:
    """A parsed header's compressed size, which must be present and within
    ``0..MAX_PAGE_SIZE``."""
    clen = header.compressed_page_size
    if clen is None or not 0 <= clen <= MAX_PAGE_SIZE:
        raise CorruptedError(
            f"page at {at}: compressed size {clen} out of range")
    return clen


def _parse_page_header(raw, pos: int, at: int, cut: bool = False):
    """The thrift ``PageHeader`` at ``raw[pos]`` (file offset ``at``): the
    header, where its payload starts in ``raw`` and its checked compressed
    size.  A header that does not parse is corrupt, or None where ``cut``
    (``raw`` may end inside it)."""
    try:
        header, data_pos = thrift.deserialize(md.PageHeader, raw, pos)
    except (thrift.ThriftError, IndexError, struct.error) as e:
        if cut:
            return None
        raise CorruptedError(f"bad page header at {at}: {e}") from e
    return header, data_pos, _checked_page_size(header, at)


def _page_info(header: md.PageHeader, payload, clen: int,
               at: int) -> PageInfo:
    """The page at file offset ``at``, its payload of ``clen`` bytes
    whole."""
    if len(payload) != clen:
        raise CorruptedError(f"truncated page payload at {at}")
    return PageInfo(header=header, payload=payload, offset=at)


def thrift_page_walk(raw, start: int,
                     total_values: Optional[int] = None
                     ) -> Iterator[PageInfo]:
    """The pages of a page stream, one thrift ``PageHeader`` deserialized a
    page, while fewer than ``total_values`` data values were seen (None: no
    limit) and bytes remain.  The plain version of the C++ header table
    the reader walks (``host.scan_page_headers``), kept as the tests'
    oracle."""
    pos = 0
    values_seen = 0
    size = len(raw)
    while ((total_values is None or values_seen < total_values)
           and pos < size):
        header, data_pos, clen = _parse_page_header(raw, pos, start + pos)
        page = _page_info(header, raw[data_pos:data_pos + clen], clen,
                          start + pos)
        if page.page_type in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
            values_seen += page.num_values
        yield page
        pos = data_pos + clen


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

    def _read(self, offset: int, size: int):
        """``size`` bytes at ``offset``: a zero-copy view where the source
        gives one (a mapped file), else bytes."""
        src = self.file.source
        view = getattr(src, "pread_view", None)
        return (view or src.pread)(offset, size)

    def page_table(self) -> PageTable:
        """The chunk's pages as a :class:`PageTable`: one contiguous read
        and its C++ page-header table (each page's CRC checked under
        ``verify_crc``)."""
        start, size = self.byte_range
        raw = self._read(start, size)
        total = self.meta.num_values
        rows = host.scan_page_headers(raw, -1 if total is None else total,
                                      base=start)
        table = PageTable.from_buffer(raw, start, rows)
        _verify_table_crcs(self, raw, start, rows)
        return table

    def pages(self) -> Iterator[PageInfo]:
        """The chunk's pages (:meth:`page_table`'s)."""
        return iter(self.page_table())

    def page_table_at(self, offset: int, size: int,
                      num_pages: Optional[int] = None) -> PageTable:
        """The pages of one byte span of the chunk (an offset-index seek:
        one pread covering just the selected pages)."""
        raw = self._read(offset, size)
        rows = host.scan_page_headers(raw, max_pages=num_pages, base=offset)
        table = PageTable.from_buffer(raw, offset, rows)
        _verify_table_crcs(self, raw, offset, rows)
        return table

    def pages_at(self, offset: int, size: int,
                 num_pages: Optional[int] = None) -> Iterator[PageInfo]:
        """The pages of one byte span (:meth:`page_table_at`'s)."""
        return iter(self.page_table_at(offset, size, num_pages))

    def pages_streamed(self, window: int = 1 << 20,
                       source: Optional[Source] = None
                       ) -> Iterator[PageInfo]:
        """The chunk's pages read in windows, never the whole chunk at
        once: each pread is at most ``max(min(window, size // 16), 64
        KiB)`` bytes, except that a page larger than that gets one read of
        exactly itself and its header, and the C++ windowed scan
        (``host.scan_page_headers_partial``) parses each window's whole
        pages.  The Python walk (:meth:`_pages_streamed_python`) takes
        over where the scan refuses a whole page in view, and owns the
        precise errors.  A consumer that stops early reads no more.
        Each payload is a uint8 view of its window, which it keeps alive:
        copy what is kept past the iteration.  ``source`` overrides where
        the preads go (a drain's prefetcher); each page's CRC is checked
        under ``verify_crc``."""
        start, size = self.byte_range
        # at most a sixteenth of the chunk a read (64 KiB at least), so a
        # small chunk keeps page-sized reads
        window = max(min(window, size // 16), 1 << 16)
        src = source if source is not None else self.file.source
        read = getattr(src, "pread_view", src.pread)
        total = self.meta.num_values or 0
        pos = values_seen = 0
        win = window
        while values_seen < total and pos < size:
            view = host.as_u8(read(start + pos, min(win, size - pos)))
            rows, consumed, seen = host.scan_page_headers_partial(
                view, total - values_seen)
            if len(rows) == 0:
                # the first page does not fit: its header, parsed once,
                # gives its size (the next read is exactly that page) or
                # its error
                parsed = _parse_page_header(
                    bytes(view[:MAX_PAGE_HEADER_SIZE]), 0, start + pos,
                    cut=len(view) < min(MAX_PAGE_HEADER_SIZE, size - pos))
                if parsed is None:
                    win = min(win * 4, size - pos)  # a longer header
                    continue
                header, data_pos, clen = parsed
                if pos + data_pos + clen > size:
                    raise CorruptedError(
                        f"truncated page payload at {start + pos}")
                if len(view) >= data_pos + clen:
                    # the whole page was in view and the scan still refused
                    # it: the Python walk decides
                    yield from self._pages_streamed_python(
                        window, pos, values_seen, source)
                    return
                win = data_pos + clen
                continue
            for page in page_infos(view, start + pos, rows):
                verify_page_crc(self, page)
                yield page
            pos += consumed
            values_seen += seen
            win = window

    def _pages_streamed_python(self, window: int, pos: int,
                               values_seen: int,
                               source: Optional[Source] = None
                               ) -> Iterator[PageInfo]:
        """:meth:`pages_streamed` from ``pos`` by the Python thrift walk,
        in windows of ``window`` bytes: the precise errors."""
        start, size = self.byte_range
        src = source if source is not None else self.file.source
        total = self.meta.num_values or 0
        buf = b""
        boff = 0
        while values_seen < total and pos < size:
            if boff >= len(buf):
                buf = bytes(src.pread(start + pos, min(window, size - pos)))
                boff = 0
            parsed = _parse_page_header(
                buf, boff, start + pos,
                cut=len(buf) - boff < min(MAX_PAGE_HEADER_SIZE, size - pos))
            if parsed is None:  # a longer header: read more from it
                buf = bytes(src.pread(
                    start + pos, min(max(window, (len(buf) - boff) * 4),
                                     size - pos)))
                boff = 0
                continue
            header, data_pos, clen = parsed
            hdr_len = data_pos - boff
            if pos + hdr_len + clen > size:
                # past the chunk: the next chunk's bytes
                raise CorruptedError(
                    f"truncated page payload at {start + pos}")
            if data_pos + clen <= len(buf):
                payload = host.as_u8(buf)[data_pos:data_pos + clen]
            else:
                payload = host.as_u8(src.pread(start + pos + hdr_len, clen))
            page = _page_info(header, payload, clen, start + pos)
            verify_page_crc(self, page)
            if page.page_type in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
                values_seen += page.num_values
            yield page
            pos += hdr_len + clen
            boff = data_pos + clen

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


def page_table_of(reader, pages=None) -> PageTable:
    """``pages`` (a :class:`PageTable`, :class:`PageInfo` objects, or None
    for all of the chunk's) as a :class:`PageTable`."""
    if isinstance(pages, PageTable):
        return pages
    if pages is None:
        table = getattr(reader, "page_table", None)
        if table is not None:
            return table()
        pages = reader.pages()
    return PageTable.of(pages)


#: codecs whose data pages decompress in one C++ call a chunk
_BATCHED_CODECS = (CompressionCodec.SNAPPY, CompressionCodec.ZSTD)


def data_page_bodies(reader: ColumnChunkReader, pages
                     ) -> List[Optional[np.ndarray]]:
    """The decompressed bytes of each data page of ``pages`` (a
    :class:`PageTable` or :class:`PageInfo` objects; uint8; a v1 page
    whole, a v2 page after its uncompressed levels), None for the others.
    SNAPPY and ZSTD pages decompress in one C++ call
    (``host.decompress_pages``, threaded only for a batch of 8 MiB or
    more), UNCOMPRESSED ones stay views of the payload, and the other
    codecs decode page by page."""
    infos = list(pages)
    table = pages if isinstance(pages, PageTable) else PageTable.of(infos)
    b = table.bodies()
    out: List[Optional[np.ndarray]] = [None] * len(infos)
    srcs, sizes, where = [], [], []
    for i in np.flatnonzero(b.data).tolist():
        src = host.as_u8(infos[i].payload)[int(b.start[i]):]
        if not b.compressed[i]:
            out[i] = src
            continue
        srcs.append(src)
        sizes.append(int(b.size[i]))
        where.append(i)
    codec = reader.codec
    if codec.codec_id in _BATCHED_CODECS and srcs:
        buf, offs = host.decompress_pages(
            srcs, sizes, int(codec.codec_id),
            host.decompress_threads(sum(max(s, 0) for s in sizes)))
        for j, i in enumerate(where):
            out[i] = buf[offs[j]:offs[j + 1]]
    else:
        for src, size, i in zip(srcs, sizes, where):
            out[i] = host.as_u8(codec.decode(src, size))
    return out


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

    def columns(self) -> List[ColumnChunkReader]:
        """Every chunk's reader, in column order."""
        return [self.column(i) for i in range(len(self.rg.columns))]

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


class ColumnSet(dict):
    """``{dotted path: Column}``, the result of a read or a streamed
    batch, with the JAX package's ``Table`` surface: ``schema`` (the
    file's), ``num_rows``, ``columns`` (the set itself) and
    :meth:`to_arrow`.  ``report`` is the read's
    :class:`~parquet_tpu_torch.io.faults.ReadReport` where it ran under a
    policy or was given one (else None), and a batch's ``read_stats`` its
    drain's prefetcher's :class:`~parquet_tpu_torch.io.prefetch.ReadStats`
    (None without one).

    ``spans`` name the rows the set holds, in order, as ``(ParquetFile,
    row group, first row in it, rows)``: :meth:`to_arrow` decodes again
    from them, with their level streams, the leaves of a field whose
    structure the decoded columns do not carry (a struct or map under a
    list, an optional struct above its leaves), since a read keeps no
    level stream it was not asked for."""

    report = None
    read_stats = None

    def __init__(self, items=(), schema=None, num_rows: int = 0,
                 spans=(), device=None):
        super().__init__(items)
        self.schema = schema
        self.num_rows = num_rows
        self.spans = list(spans)
        self.device = device

    @property
    def columns(self) -> "ColumnSet":
        return self

    def to_arrow(self):
        """The set as a ``pyarrow.Table`` equal to the JAX package's
        ``Table.to_arrow()`` of the same rows, one chunk a column (the JAX
        package's has one a row group): each column copied to the host
        once.  A leaf or a chain of lists converts alone
        (:meth:`Column.to_arrow`); where every selected field is one, a
        field the file's embedded Arrow schema declares dictionary-typed
        stays a ``DictionaryArray`` (re-encoded where it decoded dense).  A
        struct above any list is zipped from its children, its nulls from
        the def levels; a struct or map inside a list is assembled from
        the level streams with vector ops.  A partial selection of a
        group's leaves gives those leaves flat.  Needs pyarrow."""
        from .arrow import table_to_arrow

        return table_to_arrow(self)


class ParquetFile:
    """An open Parquet file: magic check at both ends and the thrift
    footer, or, for a path whose bytes were opened before, the footer
    parsed then (``io/cache.py::FOOTERS``).

    ``options`` (:class:`ReadOptions`) say how the file is opened and
    whether its pages' CRCs are checked.  ``policy`` (a
    :class:`~parquet_tpu_torch.io.faults.FaultPolicy`) applies to every
    operation on the file: each pread retries transient errors under it
    and keeps the operation's deadline, and its ``on_corrupt`` decides
    what a corrupt row group does.  A call's own ``policy=`` overrides it
    for that call."""

    def __init__(self, source, options: Optional[ReadOptions] = None,
                 policy=None):
        from .faults import PolicySource, read_context
        from .remote import HttpSource
        from .source import FileSource, MmapSource

        self.options = options if options is not None else ReadOptions()
        self.policy = policy
        self._chunk_cache: Dict[Tuple[int, int], ColumnChunkReader] = {}
        self.source: Source = as_source(source)
        if policy is not None:
            self.source = PolicySource(self.source, policy)
        self._base_source = self.source  # overrides revert to this
        self._override_stack: List[Source] = []
        # the file's key in io/cache.py's caches, fixed at open: the
        # open-time fstat of a plain path source under the policy, or a
        # remote source's HEAD validators (None without one, or over a
        # chaos transport); None for in-memory bytes and any other wrapper
        # (an injector's bytes must never fill nor be served from the
        # caches)
        inner = (self.source.inner if isinstance(self.source, PolicySource)
                 else self.source)
        self._cache_key = (inner.stat_key
                           if isinstance(inner, HttpSource)
                           or type(inner) in (FileSource, MmapSource)
                           else None)
        try:
            with self._resilient_op(None, None, "open"), \
                    read_context(path=self._path,
                                 kinds=(CorruptedError, OSError)):
                self._open_footer()
        except BaseException:
            self.source.close()
            raise
        counters.inc("files_opened")

    @property
    def _path(self) -> Optional[str]:
        """The file's path for error context (None for in-memory bytes)."""
        return getattr(self.source, "path", None)

    def _open_footer(self) -> None:
        if _otrace.TRACE_ENABLED:
            with _otrace.span("open.footer", file=self._path):
                self._open_footer_impl()
        else:
            self._open_footer_impl()
        self._row_groups = [RowGroupReader(self, i, rg) for i, rg in
                            enumerate(self.metadata.row_groups or [])]

    def _open_footer_impl(self) -> None:
        from .cache import FOOTERS

        key = self._cache_key
        hit = FOOTERS.get(key) if key is not None else None
        if hit is not None:  # these bytes' footer was parsed before
            self.metadata, self.schema = hit
            return
        footer_len = self._parse_footer()
        if key is not None:
            # the serialized footer's length is what the ledger's
            # cache.footer account charges for the parsed entry
            FOOTERS.put(key, (self.metadata, self.schema),
                        nbytes=footer_len)

    def _parse_footer(self) -> int:
        """Read and parse the footer; returns its serialized length."""
        size = self.source.size()
        if size < 12:
            raise CorruptedError(
                f"file too small ({size} bytes) to be parquet")
        # one read of the tail, which holds the footer where it fits
        tail_len = min(max(self.options.footer_read_size, 8), size)
        tail = self.source.pread(size - tail_len, tail_len)
        if tail[-4:] != md.MAGIC:
            raise CorruptedError("missing PAR1 magic at end of file")
        footer_len = struct.unpack("<I", tail[-8:-4])[0]
        if footer_len + 12 > size:
            raise CorruptedError(
                f"footer length {footer_len} exceeds file size {size}")
        if self.source.pread(0, 4) != md.MAGIC:
            raise CorruptedError("missing PAR1 magic at start of file")
        footer = (tail[-8 - footer_len:-8] if footer_len + 8 <= tail_len
                  else self.source.pread(size - 8 - footer_len, footer_len))
        try:
            self.metadata, _ = thrift.deserialize(md.FileMetaData, footer)
        except (thrift.ThriftError, IndexError, struct.error) as e:
            raise CorruptedError(f"bad footer: {e}") from e
        if not self.metadata.schema:
            raise CorruptedError("footer has no schema")
        self.schema = Schema.from_elements(self.metadata.schema)
        return footer_len

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows or 0

    @property
    def created_by(self) -> Optional[str]:
        return self.metadata.created_by

    def key_value_metadata(self) -> Dict[str, str]:
        """The footer's key/value pairs as a dict."""
        return {kv.key: kv.value
                for kv in (self.metadata.key_value_metadata or [])}

    @property
    def arrow_dictionary_fields(self) -> frozenset:
        """The top-level fields the footer's embedded ``ARROW:schema``
        declares dictionary-typed (empty without one, or without
        pyarrow to parse it), parsed once."""
        got = getattr(self, "_arrow_dict_fields", None)
        if got is None:
            got = frozenset()
            blob = self.key_value_metadata().get("ARROW:schema")
            if blob:
                try:
                    import base64

                    import pyarrow as pa

                    schema = pa.ipc.read_schema(
                        pa.BufferReader(base64.b64decode(blob)))
                    got = frozenset(f.name for f in schema
                                    if pa.types.is_dictionary(f.type))
                except Exception:  # no pyarrow, or a schema it refuses
                    got = frozenset()
            self._arrow_dict_fields = got
        return got

    @property
    def row_groups(self) -> List[RowGroupReader]:
        """The row groups' readers, built once a file."""
        return list(self._row_groups)

    def row_group(self, i: int) -> RowGroupReader:
        return self._row_groups[i]

    # ---------------------------------------------------------- resilience
    def _resilient_op(self, policy, report, what: str = "read"):
        """The scope of one top-level operation under the effective policy
        (the call's, else the file's): ``self.source`` applies it inside
        the block (chunk readers read ``file.source`` at each call, so
        every layer sees it), its deadline clock starts, and its retries
        are counted into ``report``.  A call's own policy is installed on
        the override stack, shared with :meth:`_source_override`, so
        overlapping scopes on several threads each remove only their own
        wrapper and ``self.source`` always falls back to a live one."""
        from .faults import PolicySource

        pol = policy if policy is not None else self.policy

        @contextlib.contextmanager
        def scope():
            if pol is None:
                yield None
                return
            base = self._base_source
            if isinstance(base, PolicySource) and base.policy is pol \
                    and self.source is base:
                with base.operation(report, what) as dl:
                    yield dl
                return
            inner = base.inner if isinstance(base, PolicySource) else base
            tmp = PolicySource(inner, pol)
            self._override_stack.append(tmp)
            self.source = tmp
            try:
                with tmp.operation(report, what) as dl:
                    yield dl
            finally:
                self._pop_override(tmp)

        return scope()

    def _pop_override(self, src: Source) -> None:
        st = self._override_stack
        if src in st:
            st.remove(src)
        self.source = st[-1] if st else self._base_source

    @contextlib.contextmanager
    def _source_override(self, src: Source):
        """Route every pread of this file through ``src`` (a wrapper over
        the current source, such as the read's chunk prefetcher) inside
        the block, on the override stack :meth:`_resilient_op` uses; the
        caller owns closing ``src``."""
        self._override_stack.append(src)
        self.source = src
        try:
            yield src
        finally:
            self._pop_override(src)

    # ---------------------------------------------------------------- read
    def read(self, columns: Optional[Sequence[str]] = None,
             device="cuda",
             row_groups: Optional[Sequence[int]] = None,
             policy=None, report=None) -> ColumnSet:
        """Decode the selected columns (all by default) of the selected
        row groups (all by default; else by index, in the order given) on
        ``device``; returns ``{dotted path: Column}`` in schema order.
        A name in ``columns`` selects the leaf at that dotted path, or every
        leaf under that top-level column.  An empty ``row_groups`` gives
        zero-row columns; an index out of range raises ``IndexError``.

        ``policy`` (default: the file's) retries transient preads, runs
        the call under ``deadline_s``, and with
        ``on_corrupt='skip_row_group'`` decodes row group by row group and
        drops a corrupt one whole (:meth:`_read_degraded`); ``report``
        collects the rows read and dropped, the skipped row groups and the
        retries, and is the result's ``report``.  Every chunk decodes
        under ``read_context``: a failure names its file, row group and
        column.  The read is an op of its own (``file.read``) unless the
        caller's op scope is active, and its wall lands in ``read.file_s``.
        """
        from .faults import resolve_policy

        pol, report = resolve_policy(self, policy, report)
        t0 = time.perf_counter()
        with _oscope.maybe_op_scope("file.read", file=self._path):
            try:
                if pol is None and report is None:
                    return self._read_impl(columns, device, row_groups,
                                           None, None)
                with self._resilient_op(policy, report):
                    out, rows = self._read_impl(columns, device, row_groups,
                                                pol, report, with_rows=True)
                report.rows_read += rows
                out.report = report
                return out
            finally:
                # failures count too: a retry storm that dies at its
                # deadline is the tail
                _M_READ_FILE_S.observe(time.perf_counter() - t0)

    def _read_impl(self, columns, device, row_groups, pol, report,
                   with_rows: bool = False):
        from ..parallel.device_reader import decode_chunks_pipelined

        dev = resolve_device(device)
        leaves = _select_leaves(self.schema, columns)
        every = range(len(self._row_groups))
        sel = list(every) if row_groups is None else list(row_groups)
        for i in sel:
            if i not in every:
                raise IndexError(
                    f"row group {i} out of range [0, {len(every)})")
        if pol is not None and pol.skip_corrupt and sel:
            out, rows = self._read_degraded(leaves, sel, dev, report)
        else:
            rgs = [self._row_groups[i] for i in sel]
            chunks = [rg.column(leaf.column_index)
                      for leaf in leaves for rg in rgs]
            out = ColumnSet(schema=self.schema, device=dev,
                            spans=[(self, i, 0, self._row_groups[i].num_rows)
                                   for i in sel])
            with contextlib.closing(decode_chunks_pipelined(
                    chunks, dev)) as decoded:
                it = iter(chunks)
                for leaf in leaves:
                    parts = [self._pull(decoded, next(it)) for _ in rgs]
                    out[leaf.name] = (concat_columns(parts) if parts
                                      else _empty_column(leaf, dev))
            rows = sum(rg.num_rows for rg in rgs)
        out.num_rows = rows
        return (out, rows) if with_rows else out

    def _pull(self, decoded, chunk: ColumnChunkReader) -> Column:
        """The pipeline's next column, ``chunk``'s, its failure located."""
        from .faults import read_context

        with read_context(path=self._path, row_group=chunk.rg_index,
                          column=chunk.leaf.name):
            return next(decoded)

    def _read_degraded(self, leaves, sel, dev, report):
        """The ``on_corrupt='skip_row_group'`` read: row group by row group,
        each group's chunks one batch of ``decode_chunks_pipelined`` on
        ``dev``; a data error in any of them drops the whole group
        (``report.record_skip``) and a deadline still raises.  The columns
        hold exactly the intact groups' rows, in the order selected."""
        from ..errors import DeadlineError
        from ..parallel.device_reader import decode_chunks_pipelined

        uniq = list({leaf.name: leaf for leaf in leaves}.values())
        parts: Dict[str, List[Column]] = {leaf.name: [] for leaf in uniq}
        rows = 0
        kept = []
        for i in sel:
            rg = self._row_groups[i]
            chunks = [rg.column(leaf.column_index) for leaf in uniq]
            try:
                with contextlib.closing(decode_chunks_pipelined(
                        chunks, dev)) as decoded:
                    cols = [self._pull(decoded, c) for c in chunks]
            except DeadlineError:
                raise
            except CorruptedError as e:
                report.record_skip(i, rows=rg.num_rows, error=e)
                continue
            for leaf, col in zip(uniq, cols):
                parts[leaf.name].append(col)
            rows += rg.num_rows
            kept.append((self, i, 0, rg.num_rows))
        out = ColumnSet(schema=self.schema, num_rows=rows, spans=kept,
                        device=dev)
        for leaf in leaves:
            got = parts[leaf.name]
            out[leaf.name] = (concat_columns(got) if got
                              else _empty_column(leaf, dev))
        return out, rows

    def iter_batches(self, columns: Optional[Sequence[str]] = None,
                     batch_rows: int = 65536,
                     strict_batch_rows: bool = False, device="cuda",
                     policy=None, report=None):
        """The streamed read: ``ColumnSet`` batches of at most
        ``batch_rows`` rows on ``device``, each holding only the decoded
        pages that cover it (:func:`~parquet_tpu_torch.io.stream.
        iter_batches`, which says how batches are cut)."""
        from .stream import iter_batches

        return iter_batches(self, columns=columns, batch_rows=batch_rows,
                            strict_batch_rows=strict_batch_rows,
                            device=device, policy=policy, report=report)

    def aggregate(self, aggs, where=None, group_by=None, device="cuda",
                  policy=None, report=None):
        """Answer aggregates (``count()``, ``min_("x")``, ... of
        ``algebra/aggregate.py``) over the rows matching ``where``,
        optionally grouped by a flat column, at the cheapest tier that
        proves each row group's answer: footer statistics, page-index zone
        maps, dictionary pages, then an exact decode of the contended
        pages (:mod:`~parquet_tpu_torch.io.aggregate`).  The dictionary
        and exact tiers decode and fold on ``device`` (CUDA unless the
        caller names the CPU).  Returns an
        :class:`~parquet_tpu_torch.io.aggregate.AggregateResult`."""
        from .aggregate import aggregate_file

        return aggregate_file(self, aggs, where=where, group_by=group_by,
                              device=device, policy=policy, report=report)

    def find_rows(self, path: str, keys, columns: Optional[Sequence[str]] = None,
                  device="cuda", policy=None, report=None):
        """Batched point lookup: the rows where column ``path`` equals each
        of ``keys``, with the row-aligned values of ``columns``.  The bloom
        stage and the page decodes run on ``device`` (CUDA unless the caller
        names the CPU); ``policy``/``report`` as :meth:`read`'s (a corrupt
        row group drops whole under ``skip_row_group``).  Returns a
        :class:`~parquet_tpu_torch.io.lookup.LookupResult` aligned with
        ``keys``."""
        from .lookup import find_rows

        return find_rows(self, path, keys, columns=columns, device=device,
                         policy=policy, report=report)

    def close(self) -> None:
        self.closed = True
        self.source.close()

    closed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _select_leaves(schema: Schema, columns) -> List[Leaf]:
    """The leaves a read selects: all, or for each name the leaf at that
    dotted path, else every leaf under that top-level column."""
    if columns is None:
        return list(schema.leaves)
    out = []
    for c in columns:
        hits = [leaf for leaf in schema.leaves
                if leaf.name == c or leaf.path[0] == c]
        if not hits:
            raise KeyError(f"no column {c!r} in the schema")
        out.extend(hits)
    return out


def _empty_column(leaf: Leaf, device: torch.device) -> Column:
    """The zero-row column of a file without row groups."""
    from ..schema.types import empty_values

    offsets = None
    if leaf.physical_type == Type.BYTE_ARRAY:
        offsets = torch.zeros(1, dtype=torch.int64, device=device)
    nlev = leaf.max_repetition_level
    return Column(leaf=leaf, values=empty_values(
        leaf.physical_type, leaf.type_length, device), offsets=offsets,
        validity=torch.zeros(0, dtype=torch.bool, device=device)
        if nlev else None,
        list_offsets=[torch.zeros(1, dtype=torch.int64, device=device)
                      for _ in range(nlev)],
        list_validity=[torch.zeros(0, dtype=torch.bool, device=device)
                       for _ in range(nlev)])


# ---------------------------------------------------------------------------
# The host decode
# ---------------------------------------------------------------------------

def _decode_values(raw: np.ndarray, pos: int, nvals: int,
                   encoding: Encoding, leaf: Leaf, physical: Type,
                   dictionary):
    """One page's values on the host, dispatched through the encoding
    registry (``ops/encodings.py``; the built-ins below are registered at
    import): ``("idx", int32 indexes)`` for a dictionary page, else
    ``("val", values)`` in the column's form (byte arrays: ``(values,
    offsets)``)."""
    spec = lookup_encoding(encoding)
    if spec is None:
        raise unsupported(f"{encoding.name} pages of a {physical.name} "
                          "column", "more encodings")
    got = spec.decode(raw, pos, nvals, leaf, physical, dictionary)
    if isinstance(got, DictIndices):
        return "idx", np.asarray(got.indices).astype(np.int32, copy=False)
    return "val", got


# -- the built-in encodings: the registry's defaults ------------------------


def _dec_dict(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref

    if dictionary is None:
        raise CorruptedError("dictionary-encoded page without a "
                             "dictionary page")
    body = raw[pos:]
    width = int(body[0]) if len(body) else 0
    return DictIndices(ref.decode_rle(body[1:], nvals, width))


def _dec_plain(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref

    return ref.decode_plain(raw[pos:], nvals, physical, leaf.type_length)


def _dec_rle_bool(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref

    if physical != Type.BOOLEAN:
        raise unsupported(f"RLE pages of a {physical.name} column",
                          "more encodings")
    return ref.decode_rle_len_prefixed(raw[pos:], nvals, 1)[0] != 0


def _dec_delta(raw, pos, nvals, leaf, physical, dictionary):
    from ..schema.types import PHYSICAL_NP_DTYPE

    if physical not in (Type.INT32, Type.INT64):
        raise unsupported(f"DELTA_BINARY_PACKED pages of a {physical.name} "
                          "column", "more encodings")
    v = host.decode_delta_binary_packed(raw[pos:])[0][:nvals]
    return v.astype(PHYSICAL_NP_DTYPE[physical])


def _dec_delta_len_ba(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref

    if physical != Type.BYTE_ARRAY:
        raise unsupported(f"DELTA_LENGTH_BYTE_ARRAY pages of a "
                          f"{physical.name} column", "more encodings")
    v, o, _ = ref.decode_delta_length_byte_array(raw[pos:])
    return v, o


def _dec_delta_ba(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref

    if physical not in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        raise unsupported(f"DELTA_BYTE_ARRAY pages of a {physical.name} "
                          "column", "more encodings")
    v, o, _ = ref.decode_delta_byte_array(raw[pos:])
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return v.reshape(-1, leaf.type_length)
    return v, o


def _dec_bss(raw, pos, nvals, leaf, physical, dictionary):
    from ..ops import ref
    from ..schema.types import PHYSICAL_NP_DTYPE, value_width

    w = value_width(physical, leaf.type_length)
    if not w:
        raise CorruptedError(f"BYTE_STREAM_SPLIT page in a "
                             f"{physical.name} column")
    rows = ref.decode_byte_stream_split(raw[pos:], nvals, w)
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return rows
    if physical == Type.INT96:
        return rows.view(np.int32).reshape(nvals, 3)
    return rows.view(PHYSICAL_NP_DTYPE[physical]).reshape(-1)


# the masked-emit twins the fused page cursor (io/fused.py) calls: the
# same arguments with the sorted ``take`` ordinals after ``nvals``


def _dec_dict_masked(raw, pos, nvals, take, leaf, physical, dictionary):
    from ..ops import ref

    if dictionary is None:
        raise CorruptedError("dictionary-encoded page without a "
                             "dictionary page")
    return DictIndices(ref.decode_rle_dict_indices_masked(raw, nvals, take,
                                                          pos))


def _dec_plain_masked(raw, pos, nvals, take, leaf, physical, dictionary):
    from ..ops import ref

    return ref.decode_plain_masked(raw[pos:], nvals, take, physical,
                                   leaf.type_length)


def _dec_delta_masked(raw, pos, nvals, take, leaf, physical, dictionary):
    from ..ops import ref
    from ..schema.types import PHYSICAL_NP_DTYPE

    if physical not in (Type.INT32, Type.INT64):
        return None
    vals = ref.decode_delta_binary_packed_masked(raw, nvals, take, pos)
    return vals.astype(PHYSICAL_NP_DTYPE[physical])


def _register_builtins() -> None:
    """Register the built-in encodings (at import): idempotent, and never
    over a caller's registered shadow of a built-in id."""
    for spec in (
            EncodingSpec(Encoding.PLAIN, "PLAIN", _dec_plain,
                         _dec_plain_masked),
            EncodingSpec(Encoding.PLAIN_DICTIONARY, "PLAIN_DICTIONARY",
                         _dec_dict, _dec_dict_masked),
            EncodingSpec(Encoding.RLE_DICTIONARY, "RLE_DICTIONARY",
                         _dec_dict, _dec_dict_masked),
            EncodingSpec(Encoding.DELTA_BINARY_PACKED,
                         "DELTA_BINARY_PACKED", _dec_delta,
                         _dec_delta_masked),
            EncodingSpec(Encoding.DELTA_LENGTH_BYTE_ARRAY,
                         "DELTA_LENGTH_BYTE_ARRAY", _dec_delta_len_ba),
            EncodingSpec(Encoding.DELTA_BYTE_ARRAY, "DELTA_BYTE_ARRAY",
                         _dec_delta_ba),
            EncodingSpec(Encoding.BYTE_STREAM_SPLIT, "BYTE_STREAM_SPLIT",
                         _dec_bss),
            EncodingSpec(Encoding.RLE, "RLE", _dec_rle_bool)):
        if lookup_encoding(spec.id) is None or is_builtin_decode(spec.id):
            register_encoding(spec, overwrite=True, _builtin=True)


_register_builtins()


def _page_levels(raw: np.ndarray, pos: int, n: int, encoding: Encoding,
                 max_level: int) -> Tuple[np.ndarray, int]:
    """One v1 page's level stream (RLE behind its length, or legacy
    BIT_PACKED) and the position after it."""
    from ..ops import ref

    w = int(max_level).bit_length()
    if encoding == Encoding.RLE:
        return ref.decode_rle_len_prefixed(raw, n, w, pos)
    lv = ref.decode_bit_packed_levels(raw[pos:], n, w).astype(np.int32)
    return lv, pos + (n * w + 7) // 8


def _combine(parts: List[tuple], dictionary, physical: Type,
             keep_dictionary: bool = False):
    """The chunk's pages as one: ``(values, offsets, dict_indices)`` where
    a chunk whose pages are all dictionary-encoded stays encoded (values
    None) if it is a BYTE_ARRAY one or ``keep_dictionary`` asks, as the
    device route keeps it."""
    from ..ops import host, ref

    if parts and all(k == "idx" for k, _ in parts) and \
            (physical == Type.BYTE_ARRAY or keep_dictionary):
        return None, None, np.concatenate([p for _, p in parts])
    decoded = [ref.gather_dictionary(dictionary, p) if k == "idx" else p
               for k, p in parts]
    if physical == Type.BYTE_ARRAY:
        if not decoded:
            return np.zeros(0, np.uint8), np.zeros(1, np.int64), None
        offs, base = [np.zeros(1, np.int64)], 0
        for v, o in decoded:
            o = np.asarray(o, np.int64)
            offs.append(o[1:] - o[0] + base)
            base += int(o[-1] - o[0])
        values = np.concatenate([host.as_u8(v)[o[0]:o[-1]]
                                 for v, o in decoded])
        return values, np.concatenate(offs), None
    if not decoded:
        return None, None, None
    return np.concatenate(decoded), None, None


def decode_chunk_host(reader: ColumnChunkReader, device,
                      pages=None, dictionary=None,
                      keep_dictionary: bool = False) -> Column:
    """Decode a chunk (or, with ``pages``, a span of its pages with the
    chunk's decoded ``dictionary``) on the host, with the port's own
    ``ops/ref.py`` decoders dispatched through the encoding registry:
    every page's levels and values, the levels assembled by
    ``ops/levels.assemble``, and the finished column moved to ``device`` in
    one copy per tensor.  The device route sends here the chunks it cannot
    decode (``device_reader.HOST_ROUTE``); the column has the device
    route's form (``keep_dictionary`` as ``device_reader.decode_staged``'s)."""
    if _otrace.TRACE_ENABLED and pages is None:  # a whole chunk's decode
        with _otrace.span("decode.chunk", rg=reader.rg_index,
                          col=reader.leaf.dotted_path):
            return _decode_chunk_host(reader, device, pages, dictionary,
                                      keep_dictionary)
    return _decode_chunk_host(reader, device, pages, dictionary,
                              keep_dictionary)


def _decode_chunk_host(reader: ColumnChunkReader, device, pages,
                       dictionary, keep_dictionary: bool) -> Column:
    from ..ops import levels
    from ..schema.types import empty_values

    device = torch.device(device)
    leaf = reader.leaf
    physical = Type(reader.meta.type)
    max_def = leaf.max_definition_level
    max_rep = leaf.max_repetition_level
    defs, reps, parts = [], [], []
    slots = 0
    table = page_table_of(reader, pages)
    pages = list(table)
    for page, raw in zip(pages, data_page_bodies(reader, table)):
        h = page.header
        pt = page.page_type
        if pt == PageType.DICTIONARY_PAGE:
            dictionary = decode_dictionary_page(reader, page)
            counters.inc("dict_pages_decoded")
            continue
        if pt == PageType.DATA_PAGE:
            dph = h.data_page_header
            n = dph.num_values
            pos = 0
            if max_rep:
                rep, pos = _page_levels(raw, pos, n, Encoding(
                    dph.repetition_level_encoding), max_rep)
                reps.append(rep)
            if max_def:
                d, pos = _page_levels(raw, pos, n, Encoding(
                    dph.definition_level_encoding), max_def)
                defs.append(d)
            encoding = Encoding(dph.encoding)
        elif pt == PageType.DATA_PAGE_V2:
            from ..ops import ref

            dph2 = h.data_page_header_v2
            n = dph2.num_values
            rl = dph2.repetition_levels_byte_length or 0
            dl = dph2.definition_levels_byte_length or 0
            payload = host.as_u8(page.payload)
            if max_rep:
                reps.append(ref.decode_rle(payload[:rl], n,
                                           int(max_rep).bit_length()))
            if max_def:
                defs.append(ref.decode_rle(payload[rl:rl + dl], n,
                                           int(max_def).bit_length()))
            pos = 0
            encoding = Encoding(dph2.encoding)
        else:
            continue
        nvals = (int(np.count_nonzero(defs[-1] == max_def)) if max_def
                 else n)
        parts.append(_decode_values(raw, pos, nvals, encoding, leaf,
                                    physical, dictionary))
        counters.inc("data_pages_decoded")
        slots += n
    values, offsets, indices = _combine(parts, dictionary, physical,
                                        keep_dictionary)
    def_levels = np.concatenate(defs) if defs else None
    rep_levels = np.concatenate(reps) if reps else None
    asm = levels.assemble(def_levels, rep_levels, leaf)
    validity = asm.validity
    if max_rep == 0 and validity is not None and validity.all():
        validity = def_levels = None  # no nulls: the device route's form

    def put(a):
        """A fresh tensor on ``device``: page bytes may be views of a
        mapped file, which no column may alias."""
        if a is None:
            return None
        if device.type == "cpu":
            return torch.from_numpy(np.array(a, copy=True, order="C"))
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    col = Column(
        leaf=leaf, values=put(values) if values is not None or indices
        is not None else empty_values(physical, leaf.type_length, device),
        offsets=put(offsets),
        validity=put(validity), num_slots=slots,
        list_offsets=[put(o) for o in asm.list_offsets],
        list_validity=[put(v) for v in asm.list_validity],
        def_levels=def_levels if max_def > 1 else None,
        rep_levels=rep_levels)
    if indices is not None:
        if isinstance(dictionary, tuple):
            dv, do = dictionary
            col.dictionary = (put(dv), put(np.asarray(do, np.int64)))
        else:
            col.dictionary = put(dictionary)
        col.dict_indices = put(indices.astype(np.int32))
    return col
