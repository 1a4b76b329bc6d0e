"""End-to-end file verification: ``verify_file`` -> ``IntegrityReport``.

The port's copy of ``parquet_tpu/io/integrity.py``.  The atomic commit
(``io/sink.py``) promises that a destination is absent or whole; this
module proves a file on disk whole, and is the crash harness's oracle
(``io/faults.py::crash_consistency_check``).

The walk parses every page header again with the Python thrift parser,
not with the read path's C++ prescan: a check that shares the fast path's
parser shares its blind spots.  Its checks, in order:

1. the envelope: PAR1 at both ends, a sane footer length, a footer that
   parses, a schema, and a row count equal to the row groups' sum;
2. each column chunk: page headers that parse, page sizes in bounds,
   pages that fill the chunk's byte range exactly and agree with its
   metadata (dictionary and data page offsets, the values count), and a
   dictionary page wherever a data page is dictionary-encoded;
3. page CRC32s over the stored bytes, wherever a header carries one;
4. the page index: column and offset indexes that parse, page locations
   equal to the pages walked, and index lists as long as the pages;
5. bloom filters: a header that parses and a blob that lies in the file
   and matches ``bloom_filter_length``;
6. with ``decode=True``, every chunk decoded through the port's own read
   stack on ``device`` (the card by default) under
   ``ReadOptions(verify_crc=True)``: dictionary indexes in range, level
   and value counts that agree, codecs that round-trip.

Defects are recorded, not raised: a corrupt file gives a report whose
``issues`` name the kind and the place (row group, column, file offset)
of each.  Only the errors that are never data errors
(``io/faults.py::NON_DATA_ERRORS``: a missing package, out of memory, a
device's ``RuntimeError``) escape.
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

from ..errors import (MAX_COLUMN_INDEX_SIZE, MAX_PAGE_HEADER_SIZE,
                      MAX_PAGE_SIZE, ReadError)
from ..format import metadata as md
from ..format import thrift
from ..format.enums import Encoding, PageType
from ..obs import scope as _oscope
from .faults import NON_DATA_ERRORS
from .source import as_source

__all__ = ["IntegrityIssue", "IntegrityReport", "verify_file"]

_DICT_ENCODINGS = (int(Encoding.RLE_DICTIONARY),
                   int(Encoding.PLAIN_DICTIONARY))
_DATA_PAGES = (int(PageType.DATA_PAGE), int(PageType.DATA_PAGE_V2))


@dataclass
class IntegrityIssue:
    """One located defect: ``kind`` for machines, ``message`` for
    people."""

    # magic | footer | metadata | page | crc | page-index | bloom |
    # decode | io
    kind: str
    message: str
    row_group: Optional[int] = None
    column: Optional[str] = None
    offset: Optional[int] = None  # file offset, where known

    def as_dict(self) -> dict:
        return {"kind": self.kind, "message": self.message,
                "row_group": self.row_group, "column": self.column,
                "offset": self.offset}

    def __str__(self) -> str:
        loc = " ".join(x for x in (
            f"row-group={self.row_group}" if self.row_group is not None
            else "",
            f"column={self.column}" if self.column is not None else "",
            f"offset={self.offset}" if self.offset is not None else "")
            if x)
        return f"[{self.kind}]{' ' + loc if loc else ''}: {self.message}"


@dataclass
class IntegrityReport:
    """What :func:`verify_file` found, machine-readable."""

    path: Optional[str] = None
    file_size: int = 0
    num_rows: Optional[int] = None
    row_groups: int = 0
    columns_checked: int = 0
    pages_checked: int = 0
    crcs_checked: int = 0
    chunks_decoded: int = 0
    issues: List[IntegrityIssue] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.issues

    def add(self, kind: str, message: str, row_group=None, column=None,
            offset=None) -> None:
        self.issues.append(IntegrityIssue(kind, str(message), row_group,
                                          column, offset))

    def as_dict(self) -> dict:
        return {"path": self.path, "ok": self.ok, "file_size": self.file_size,
                "num_rows": self.num_rows, "row_groups": self.row_groups,
                "columns_checked": self.columns_checked,
                "pages_checked": self.pages_checked,
                "crcs_checked": self.crcs_checked,
                "chunks_decoded": self.chunks_decoded,
                "issues": [i.as_dict() for i in self.issues]}

    def summary(self) -> str:
        name = self.path or "<memory>"
        if self.ok:
            return (f"{name}: OK — {self.row_groups} row group(s), "
                    f"{self.columns_checked} chunk(s), "
                    f"{self.pages_checked} page(s), "
                    f"{self.crcs_checked} CRC(s) verified"
                    + (f", {self.chunks_decoded} chunk(s) decoded"
                       if self.chunks_decoded else ""))
        return "\n".join([f"{name}: CORRUPT — {len(self.issues)} issue(s)"]
                         + [f"  {i}" for i in self.issues])


def verify_file(source, crc: bool = True, indexes: bool = True,
                blooms: bool = True, decode: bool = False,
                device="cuda") -> IntegrityReport:
    """Verify a Parquet file end to end (the module's checks); a defect
    goes into the report, never raises.  ``source`` is a path, bytes, a
    seekable file object or a ``Source``.  ``decode=True`` also decodes
    every chunk on ``device`` (``"cuda"``: the card; ``"cpu"`` only where
    asked for).  Only a source this call opened (a path, bytes) is
    closed: a caller's file object or ``Source`` stays open."""
    src = as_source(source)
    own = isinstance(source, (str, os.PathLike, bytes, bytearray,
                              memoryview))
    rep = IntegrityReport(path=getattr(src, "path", None))
    # a verification walk is an op like a read (unless the caller's is)
    with _oscope.maybe_op_scope("verify.file", file=rep.path):
        try:
            meta = _verify_envelope(src, rep)
            if meta is not None:
                _verify_body(src, meta, rep, crc=crc, indexes=indexes,
                             blooms=blooms)
                if decode:
                    _verify_decode(src, rep, device)
        except NON_DATA_ERRORS:
            raise
        except Exception as e:  # a verifier degrades to a report
            rep.add("io", f"verification aborted: {e}")
        finally:
            if own:
                src.close()
    return rep


# ---------------------------------------------------------------------------
# 1. the envelope
# ---------------------------------------------------------------------------
def _verify_envelope(src, rep: IntegrityReport) -> Optional[md.FileMetaData]:
    try:
        size = src.size()
    except OSError as e:
        rep.add("io", f"cannot stat source: {e}")
        return None
    rep.file_size = size
    if size < 12:
        rep.add("magic", f"file too small ({size} bytes) to be parquet")
        return None
    try:
        head = src.pread(0, 4)
        tail = src.pread(size - 8, 8)
    except OSError as e:
        rep.add("io", f"cannot read envelope: {e}")
        return None
    if head != md.MAGIC:
        rep.add("magic", "missing PAR1 magic at start of file", offset=0)
    if tail[4:] != md.MAGIC:
        rep.add("magic", "missing PAR1 magic at end of file", offset=size - 4)
        return None  # without the tail the footer cannot be found
    footer_len = struct.unpack("<I", tail[:4])[0]
    if footer_len + 12 > size:
        rep.add("footer", f"footer length {footer_len} exceeds file size "
                f"{size}", offset=size - 8)
        return None
    at = size - 8 - footer_len
    try:
        raw = src.pread(at, footer_len)
    except OSError as e:
        rep.add("io", f"cannot read footer: {e}", offset=at)
        return None
    try:
        meta, _ = thrift.deserialize(md.FileMetaData, raw)
    except Exception as e:
        rep.add("footer", f"footer does not parse: {e}", offset=at)
        return None
    if meta.schema in (None, []):
        rep.add("footer", "footer has no schema")
        return None
    rgs = meta.row_groups or []
    rep.row_groups = len(rgs)
    rep.num_rows = meta.num_rows
    rg_sum = sum(rg.num_rows or 0 for rg in rgs)
    if meta.num_rows is not None and rg_sum != meta.num_rows:
        rep.add("metadata", f"footer num_rows={meta.num_rows} but row groups "
                f"sum to {rg_sum}")
    return meta


# ---------------------------------------------------------------------------
# 2-5. chunks, pages, CRCs, indexes, blooms
# ---------------------------------------------------------------------------
def _chunk_byte_range(cm: md.ColumnMetaData):
    start = cm.data_page_offset
    d = cm.dictionary_page_offset
    if d is not None and 0 < d < start:
        start = d
    return start, cm.total_compressed_size or 0


def _dotted(cm: md.ColumnMetaData) -> str:
    return ".".join(cm.path_in_schema or ())


def _verify_body(src, meta: md.FileMetaData, rep: IntegrityReport, *,
                 crc: bool, indexes: bool, blooms: bool) -> None:
    data_end = rep.file_size - 8  # past here: the footer length and magic
    for rg_i, rg in enumerate(meta.row_groups or []):
        for chunk in rg.columns or []:
            cm = chunk.meta_data
            if cm is None:
                rep.add("metadata", "column chunk has no metadata",
                        row_group=rg_i)
                continue
            col = _dotted(cm)
            rep.columns_checked += 1
            pages = _verify_chunk_pages(src, cm, rep, rg_i, col, data_end,
                                        check_crc=crc)
            if indexes and pages is not None:
                _verify_page_index(src, chunk, rg, rep, rg_i, col, pages)
            if blooms:
                _verify_bloom(src, cm, rep, rg_i, col)


@dataclass
class _WalkedPage:
    offset: int  # the header's file offset
    span: int  # header and payload bytes
    type: int
    header: md.PageHeader


def _verify_chunk_pages(src, cm: md.ColumnMetaData, rep: IntegrityReport,
                        rg_i: int, col: str, data_end: int, *,
                        check_crc: bool) -> Optional[List[_WalkedPage]]:
    """Walk one chunk's pages; the pages walked, or None where the walk
    could not finish (its issues recorded)."""
    start, size = _chunk_byte_range(cm)
    if start is None:
        rep.add("metadata", "chunk has no data_page_offset", rg_i, col)
        return None
    if not 4 <= start or start + size > data_end:
        rep.add("metadata", f"chunk byte range [{start}, {start + size}) "
                f"outside data region [4, {data_end})", rg_i, col, start)
        return None
    try:
        raw = src.pread(start, size)
    except OSError as e:
        rep.add("io", f"cannot read chunk bytes: {e}", rg_i, col, start)
        return None
    pos = 0
    values_seen = 0
    pages: List[_WalkedPage] = []
    dict_pages = 0
    dict_encoded_data = 0
    # every byte of the chunk's range must belong to a valid page (an
    # empty chunk's one page of 0 values included, and trailing garbage
    # inside total_compressed_size caught)
    while pos < size:
        at = start + pos
        try:
            header, data_pos = thrift.deserialize(md.PageHeader, raw, pos)
        except Exception as e:
            rep.add("page", f"page header does not parse: {e}", rg_i, col, at)
            return None
        if data_pos - pos > MAX_PAGE_HEADER_SIZE:
            rep.add("page", f"page header size {data_pos - pos} exceeds "
                    f"{MAX_PAGE_HEADER_SIZE}", rg_i, col, at)
            return None
        clen = header.compressed_page_size
        if clen is None or not 0 <= clen <= MAX_PAGE_SIZE:
            rep.add("page", f"compressed page size {clen} out of range",
                    rg_i, col, at)
            return None
        if data_pos + clen > size:
            rep.add("page", f"page payload [{data_pos}, {data_pos + clen}) "
                    f"overruns chunk of {size} bytes (truncated?)",
                    rg_i, col, at)
            return None
        rep.pages_checked += 1
        _check_one_page(header, raw[data_pos:data_pos + clen], rep, rg_i,
                        col, at, check_crc=check_crc)
        if header.type == int(PageType.DICTIONARY_PAGE):
            dict_pages += 1
            if pages:
                rep.add("page", "dictionary page is not the first page of "
                        "the chunk", rg_i, col, at)
        elif header.type in _DATA_PAGES:
            values_seen += _page_num_values(header)
            if _page_encoding(header) in _DICT_ENCODINGS:
                dict_encoded_data += 1
        pages.append(_WalkedPage(at, data_pos - pos + clen, header.type,
                                 header))
        pos = data_pos + clen
    total = cm.num_values or 0
    if values_seen != total:
        rep.add("metadata", f"pages carry {values_seen} values, chunk "
                f"metadata says {total}", rg_i, col, start)
    if dict_encoded_data and not dict_pages:
        rep.add("metadata", f"{dict_encoded_data} dictionary-encoded data "
                "page(s) but no dictionary page in chunk", rg_i, col, start)
    d_off = cm.dictionary_page_offset
    if d_off is not None and d_off > 0:
        first = next((p for p in pages if p.offset == d_off), None)
        if first is None or first.type != int(PageType.DICTIONARY_PAGE):
            rep.add("metadata", f"dictionary_page_offset={d_off} does not "
                    "point at a dictionary page", rg_i, col, d_off)
    first_data = next((p.offset for p in pages
                       if p.type != int(PageType.DICTIONARY_PAGE)), None)
    if first_data is not None and cm.data_page_offset != first_data:
        rep.add("metadata", f"data_page_offset={cm.data_page_offset} but "
                f"first data page is at {first_data}", rg_i, col, first_data)
    return pages


def _page_num_values(h: md.PageHeader) -> int:
    if h.data_page_header is not None:
        return h.data_page_header.num_values or 0
    if h.data_page_header_v2 is not None:
        return h.data_page_header_v2.num_values or 0
    return 0


def _page_encoding(h: md.PageHeader) -> Optional[int]:
    if h.data_page_header is not None:
        return h.data_page_header.encoding
    if h.data_page_header_v2 is not None:
        return h.data_page_header_v2.encoding
    return None


def _check_one_page(header: md.PageHeader, payload, rep: IntegrityReport,
                    rg_i: int, col: str, at: int, *, check_crc: bool) -> None:
    ulen = header.uncompressed_page_size
    if ulen is None or not 0 <= ulen <= MAX_PAGE_SIZE:
        rep.add("page", f"uncompressed page size {ulen} out of range",
                rg_i, col, at)
    nv = _page_num_values(header)
    if header.type in _DATA_PAGES and nv < 0:
        rep.add("page", f"negative num_values {nv}", rg_i, col, at)
    v2 = header.data_page_header_v2
    if v2 is not None:
        lvl = (v2.repetition_levels_byte_length or 0) + \
            (v2.definition_levels_byte_length or 0)
        if lvl > len(payload):
            rep.add("page", f"v2 level bytes {lvl} exceed page payload "
                    f"{len(payload)}", rg_i, col, at)
    if check_crc and header.crc is not None:
        rep.crcs_checked += 1
        got = zlib.crc32(payload) & 0xFFFFFFFF
        want = header.crc & 0xFFFFFFFF
        if got != want:
            rep.add("crc", f"page CRC mismatch: stored {want:#010x}, "
                    f"computed {got:#010x}", rg_i, col, at)


def _verify_page_index(src, chunk: md.ColumnChunk, rg: md.RowGroup,
                       rep: IntegrityReport, rg_i: int, col: str,
                       pages: List[_WalkedPage]) -> None:
    data_pages = [p for p in pages
                  if p.type != int(PageType.DICTIONARY_PAGE)]
    oi = _read_index(src, chunk.offset_index_offset,
                     chunk.offset_index_length, md.OffsetIndex,
                     "offset index", rep, rg_i, col)
    if oi is not None:
        locs = oi.page_locations or []
        if len(locs) != len(data_pages):
            rep.add("page-index", f"offset index has {len(locs)} page "
                    f"location(s), chunk has {len(data_pages)} data page(s)",
                    rg_i, col, chunk.offset_index_offset)
        else:
            prev_row = -1
            for loc, page in zip(locs, data_pages):
                if loc.offset != page.offset or \
                        loc.compressed_page_size != page.span:
                    rep.add("page-index", f"page location ({loc.offset}, "
                            f"{loc.compressed_page_size}) does not match "
                            f"actual page ({page.offset}, {page.span})",
                            rg_i, col, page.offset)
                    break
                fr = loc.first_row_index
                if fr is None or fr <= prev_row or (
                        rg.num_rows is not None
                        and fr >= max(rg.num_rows, 1)):
                    rep.add("page-index", f"first_row_index {fr} not "
                            f"monotonic within [0, {rg.num_rows})",
                            rg_i, col, page.offset)
                    break
                prev_row = fr
    ci = _read_index(src, chunk.column_index_offset,
                     chunk.column_index_length, md.ColumnIndex,
                     "column index", rep, rg_i, col)
    if ci is not None:
        n = len(ci.null_pages or [])
        bad = (len(ci.min_values or []) != n
               or len(ci.max_values or []) != n
               or (ci.null_counts is not None and len(ci.null_counts) != n))
        if bad or (data_pages and n != len(data_pages)):
            rep.add("page-index", f"column index arrays of {n} entries do "
                    f"not line up with {len(data_pages)} data page(s)",
                    rg_i, col, chunk.column_index_offset)
        if ci.boundary_order not in (0, 1, 2):
            rep.add("page-index", f"bad boundary_order {ci.boundary_order}",
                    rg_i, col, chunk.column_index_offset)


def _read_index(src, offset, length, cls, what: str, rep: IntegrityReport,
                rg_i: int, col: str):
    if offset is None:
        return None
    if length is None or not 0 <= length <= MAX_COLUMN_INDEX_SIZE or \
            offset + length > rep.file_size:
        rep.add("page-index", f"{what} length {length} out of range",
                rg_i, col, offset)
        return None
    try:
        obj, _ = thrift.deserialize(cls, src.pread(offset, length))
        return obj
    except NON_DATA_ERRORS:
        raise
    except Exception as e:
        rep.add("page-index", f"{what} does not parse: {e}", rg_i, col,
                offset)
        return None


def _verify_bloom(src, cm: md.ColumnMetaData, rep: IntegrityReport,
                  rg_i: int, col: str) -> None:
    off = cm.bloom_filter_offset
    if off is None:
        return
    if not 0 <= off < rep.file_size:
        rep.add("bloom", f"bloom offset {off} outside file", rg_i, col, off)
        return
    try:
        probe = src.pread(off, min(64, rep.file_size - off))
        header, hend = thrift.deserialize(md.BloomFilterHeader, probe)
    except NON_DATA_ERRORS:
        raise
    except Exception as e:
        rep.add("bloom", f"bloom header does not parse: {e}", rg_i, col, off)
        return
    nbytes = header.numBytes
    if nbytes is None or nbytes < 0 or off + hend + nbytes > rep.file_size:
        rep.add("bloom", f"bloom blob of {nbytes} bytes overruns file",
                rg_i, col, off)
        return
    length = cm.bloom_filter_length
    if length is not None and length != hend + nbytes:
        rep.add("bloom", f"bloom_filter_length={length} but header + blob "
                f"is {hend + nbytes} bytes", rg_i, col, off)


# ---------------------------------------------------------------------------
# 6. the decode pass
# ---------------------------------------------------------------------------
def _verify_decode(src, rep: IntegrityReport, device) -> None:
    """Decode every chunk through the port's read stack on ``device``
    (``decode_chunks_pipelined``, as ``ParquetFile.read`` decodes),
    row group by row group and column by column: what the walk cannot see,
    rot in the payload of a page without a CRC, dictionary indexes out of
    range, level and value counts that disagree.  A chunk that fails is
    recorded at its row group and column (and at the page offset a
    located ``ReadError`` names), as the JAX package records it, and the
    pipeline starts again at the next chunk."""
    from ..parallel.device_reader import decode_chunks_pipelined
    from .reader import ParquetFile, ReadOptions, resolve_device

    dev = resolve_device(device)
    try:
        pf = ParquetFile(src, options=ReadOptions(verify_crc=True))
    except NON_DATA_ERRORS:
        raise
    except Exception as e:
        rep.add("decode", f"cannot open for decode: {e}")
        return
    todo = []  # (row group, leaf, chunk reader or the error opening it)
    for rg_i in range(len(pf.row_groups)):
        for leaf in pf.schema.leaves:
            try:
                todo.append((rg_i, leaf,
                             pf.row_group(rg_i).column(leaf.column_index)))
            except NON_DATA_ERRORS:
                raise
            except Exception as e:
                todo.append((rg_i, leaf, e))
    i = 0
    while i < len(todo):
        rg_i, leaf, chunk = todo[i]
        if isinstance(chunk, Exception):
            _decode_issue(rep, chunk, rg_i, leaf)
            i += 1
            continue
        run = []  # the readable chunks from here on, one pipeline
        while i + len(run) < len(todo) and \
                not isinstance(todo[i + len(run)][2], Exception):
            run.append(todo[i + len(run)])
        with contextlib.closing(decode_chunks_pipelined(
                [c for _, _, c in run], dev)) as decoded:
            for rg_i, leaf, _ in run:
                i += 1
                try:
                    next(decoded)
                except NON_DATA_ERRORS:
                    raise
                except Exception as e:
                    _decode_issue(rep, e, rg_i, leaf)
                    break  # start again at the next chunk
                rep.chunks_decoded += 1


def _decode_issue(rep: IntegrityReport, e: Exception, rg_i: int,
                  leaf) -> None:
    if isinstance(e, ReadError):
        rep.add("decode", str(e), rg_i, leaf.name, e.page_offset)
    else:
        rep.add("decode", f"{type(e).__name__}: {e}", rg_i, leaf.name)
