"""Streamed reads: bounded batches, decoded on the device page span by
page span, never a whole chunk at a time.

The port of ``parquet_tpu/io/stream.py``.  :func:`iter_batches` yields
:class:`~parquet_tpu_torch.io.reader.ColumnSet` batches of at most
``batch_rows`` rows, each holding, per column, only the decoded pages
that cover it.  Each (row group, column) chunk has a :class:`_ChunkCursor`
over :meth:`ColumnChunkReader.pages_streamed` (windowed preads).  A cursor
pulls the pages that cover the rows a step needs and decodes them in one
device decode: ``build_plan`` over that page span with the chunk's
dictionary (decoded on the host once a chunk and staged to the device
once), staged in one copy, ``decode_staged`` on the device, so a pull
launches ``unpack_bits_dense`` and ``dict_unpack_gather`` where the whole
read does.  A span the device route refuses (``errors._Unsupported``)
decodes on the host (``decode_chunk_host``) and counts in
``device_reader.HOST_ROUTE``.

Batch boundaries rarely fall on page boundaries, so each decoded span is
a :class:`_PagePiece` sliced by rows.  A device column keeps no level
streams, so a piece's row starts are worked out on the device once, when
the piece is pulled, and read back as one small host array
(:func:`piece_from_column`): for each row boundary the list starts of
every repeated level, the element and value starts (a prefix count of
``validity``), the byte starts of dense byte arrays and the level-stream
slot starts.  Every later slice of the piece is plain indexing with no
synchronization; a required flat column of fixed width needs no readback
at all.  Pages are assumed to hold whole rows, as every mainstream
writer's do and v2 pages must.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..errors import CorruptedError, DeadlineError, _Unsupported
from ..format.enums import PageType
from ..obs import scope as _oscope
from ..obs import trace as _trace
from ..utils.debug import counters
from .column import Column, concat_columns
from .faults import read_context, resolve_policy
from .reader import (ColumnSet, PageTable, _select_leaves, decode_chunk_host,
                     decode_dictionary_page, resolve_device)

__all__ = ["iter_batches", "piece_from_column", "STREAM", "reset_stream"]

_DATA_PAGES = (int(PageType.DATA_PAGE), int(PageType.DATA_PAGE_V2))

#: the streamed reads' counters: page spans decoded on the device
#: (``pulls``) and on the host route (``host_pulls``), batches yielded
STREAM = {"pulls": 0, "host_pulls": 0, "batches": 0}


def reset_stream() -> None:
    for k in STREAM:
        STREAM[k] = 0


@dataclass
class _PagePiece:
    """A decoded page span of one chunk and its row starts.  ``starts`` is
    None where a slice needs none (a required flat column of fixed width
    or encoded), else a host int64 array of ``rows + 1`` columns whose
    rows are, for each row boundary: the list starts of levels 1 to
    ``levels - 1`` and the element starts (for a flat column the row
    itself), the value starts, the byte starts of a dense byte-array
    column, and last the level-stream slot starts."""

    col: Column
    rows: int
    starts: Optional[np.ndarray] = None
    levels: int = 0

    def at(self, what: str, r: int) -> int:
        """``starts``' entry ``what`` (``elements``, ``values``, ``bytes``,
        ``slots``) at row boundary ``r``."""
        e = max(self.levels, 1) - 1
        row = {"elements": e, "values": e + 1, "bytes": e + 2,
               "slots": self.starts.shape[0] - 1}[what]
        return int(self.starts[row, r])


@dataclass
class _Slice:
    """Rows of a piece as a column, with what its concatenation needs
    without reading the device: its element count (``validity``'s
    length) and, for dense byte arrays, its bytes."""

    col: Column
    elements: int
    nbytes: Optional[int] = None


def _dense_bytes(col: Column) -> bool:
    return col.offsets is not None and not col.is_dictionary_encoded()


def piece_from_column(col: Column) -> _PagePiece:
    """A decoded page span as a piece: its rows and its row starts,
    worked out on the column's device and read back in one copy (none for
    a required flat column of fixed width or encoded; a struct chain's
    value starts come from its host def levels)."""
    lev = len(col.list_offsets)
    rows = (col.list_offsets[0].shape[0] - 1) if lev else col.num_slots
    dense = _dense_bytes(col)
    if not lev and col.validity is None and not dense:
        return _PagePiece(col, rows)
    ident = np.arange(rows + 1, dtype=np.int64)
    if not lev and col.def_levels is not None and not dense:
        # a struct chain: its def levels say which slots hold a value
        vstarts = np.zeros(rows + 1, np.int64)
        np.cumsum(col.def_levels == col.leaf.max_definition_level,
                  out=vstarts[1:])
        return _PagePiece(col, rows, np.stack([ident, vstarts, ident]))
    device = (col.list_offsets[0] if lev else col.validity
              if col.validity is not None else col.offsets).device
    rows_idx = idx = torch.arange(rows + 1, dtype=torch.int64,
                                  device=device)
    chain = []  # each level's list starts below level 0, then elements
    for off in col.list_offsets:
        idx = off[idx]
        chain.append(idx)
    if not lev:
        chain.append(idx)  # a flat column's elements are its rows
    if col.validity is not None:
        cum = torch.zeros(col.validity.shape[0] + 1, dtype=torch.int64,
                          device=device)
        torch.cumsum(col.validity, 0, out=cum[1:])
        vstarts = cum[idx]
    else:
        vstarts = idx
    chain.append(vstarts)
    if dense:
        chain.append(col.offsets[vstarts])
    if lev:
        slots = torch.zeros(rows + 1, dtype=torch.int64, device=device)
        torch.cumsum(_slot_weights(col), 0, out=slots[1:])
        chain.append(slots)
    else:
        chain.append(rows_idx)
    starts = torch.stack(chain).cpu().numpy()  # the piece's one readback
    return _PagePiece(col, rows, starts, lev)


def _slot_weights(col: Column) -> torch.Tensor:
    """Level-stream slots of each row of a repeated column, from its list
    offsets: an element is one slot, a list the sum of its children's and
    at least one (an empty or null list is its own slot)."""
    w = None
    for off in reversed(col.list_offsets):
        if w is None:
            per = off[1:] - off[:-1]
        else:
            cs = torch.zeros(w.shape[0] + 1, dtype=torch.int64,
                             device=w.device)
            torch.cumsum(w, 0, out=cs[1:])
            per = cs[off[1:]] - cs[off[:-1]]
        w = torch.clamp(per, min=1)
    return w


def _slice_rows(piece: _PagePiece, r0: int, r1: int) -> _Slice:
    """Rows ``[r0, r1)`` of a piece as a self-contained column: views of
    the piece's tensors at the host starts, offsets rebased on the
    device, host level streams sliced beside them."""
    col = piece.col
    lev = piece.levels
    if piece.starts is None:  # a required flat column: rows are values
        v0, v1 = r0, r1
        e0, e1, s0, s1 = r0, r1, r0, r1
    else:
        e0, e1 = piece.at("elements", r0), piece.at("elements", r1)
        v0, v1 = piece.at("values", r0), piece.at("values", r1)
        s0, s1 = piece.at("slots", r0), piece.at("slots", r1)
    nbytes = None
    if _dense_bytes(col):
        b0, b1 = piece.at("bytes", r0), piece.at("bytes", r1)
        nbytes = b1 - b0
    if r0 == 0 and r1 == piece.rows:
        return _Slice(col, e1 - e0, nbytes)
    list_offsets, list_validity = [], []
    for k in range(lev):
        lo, hi = (r0, r1) if k == 0 else (int(piece.starts[k - 1, r0]),
                                          int(piece.starts[k - 1, r1]))
        first = int(piece.starts[k, r0])  # this level's first child
        list_offsets.append(col.list_offsets[k][lo:hi + 1] - first)
        list_validity.append(col.list_validity[k][lo:hi])
    values, offsets, indices = col.values, None, col.dict_indices
    if col.is_dictionary_encoded():
        indices = indices[v0:v1]
    else:
        if indices is not None:
            indices = indices[v0:v1]
        if nbytes is not None:
            offsets = col.offsets[v0:v1 + 1] - b0
            values = values[b0:b1]
        else:
            values = values[v0:v1]
    return _Slice(Column(
        leaf=col.leaf, values=values, offsets=offsets,
        validity=None if col.validity is None else col.validity[e0:e1],
        num_slots=s1 - s0, dictionary=col.dictionary, dict_indices=indices,
        list_offsets=list_offsets, list_validity=list_validity,
        def_levels=None if col.def_levels is None
        else col.def_levels[s0:s1],
        rep_levels=None if col.rep_levels is None
        else col.rep_levels[s0:s1]), e1 - e0, nbytes)


@dataclass
class _ChunkCursor:
    """The streamed decode of one column chunk: pulls the pages that cover
    the rows asked for, one device decode a pull, and holds only the
    decoded pieces not yet taken.  ``source`` is where the windowed preads
    go (the drain's prefetcher)."""

    chunk: object  # ColumnChunkReader
    device: torch.device
    source: object = None
    keep_levels: bool = False  # the Dremel level streams, on the host
    pages: Iterator = None
    dictionary: object = None
    dictionary_dev: object = None
    pieces: List[_PagePiece] = field(default_factory=list)
    consumed: int = 0  # rows taken from pieces[0]

    def __post_init__(self):
        self.pages = self.chunk.pages_streamed(source=self.source)

    def _pull_pages(self, need_rows: int) -> bool:
        """Pull the pages that cover the next ``need_rows`` rows and
        decode them in one device decode.  Rows are counted from the
        headers as the JAX package counts them (a v2 page's ``num_rows``,
        a v1 page's ``num_values``, which over-counts a repeated column's
        rows: the pull then stops early and :meth:`take` pulls again).
        The dictionary page is decoded once a chunk; pages of other types
        are skipped."""
        batch, est = [], 0
        for page in self.pages:
            t = page.header.type
            if t == PageType.DICTIONARY_PAGE:
                self.dictionary = decode_dictionary_page(self.chunk, page)
                counters.inc("dict_pages_decoded")
                self.dictionary_dev = None
                continue
            if t not in _DATA_PAGES:
                continue
            batch.append(page)
            v2 = page.header.data_page_header_v2
            est += (v2.num_rows if v2 is not None and v2.num_rows is not None
                    else page.num_values)
            if est >= need_rows:
                break
        if not batch:
            return False
        self.pieces.append(piece_from_column(self._decode(batch)))
        return True

    def _decode(self, batch) -> Column:
        """One page span on the device: planned, staged in one copy and
        decoded (``device_reader._prepare`` and ``decode_staged``), the
        chunk's dictionary staged once for all its spans; a span the
        device route refuses decodes on the host."""
        from ..parallel import device_reader as dr

        try:
            if self.dictionary is not None and self.dictionary_dev is None:
                staging = dr._StagingBatch()
                self.dictionary_dev = staging.commit(dr._stage_dictionary(
                    self.dictionary, staging.put), self.device)[0]
            plan, staged = dr._prepare(self.chunk, self.device,
                                       PageTable.of(batch), self.dictionary,
                                       self.dictionary_dev)
            col = dr.decode_staged(plan, staged, self.device,
                                   keep_levels=self.keep_levels)
            STREAM["pulls"] += 1
            return col
        except _Unsupported as e:
            dr.HOST_ROUTE[e.reason] += 1
            STREAM["host_pulls"] += 1
            return decode_chunk_host(self.chunk, self.device, pages=batch,
                                     dictionary=self.dictionary)

    def take(self, n_rows: int):
        """Take up to ``n_rows`` rows: ``(slices, rows taken)``."""
        out: List[_Slice] = []
        need = n_rows
        while need > 0:
            if not self.pieces and not self._pull_pages(need):
                break
            piece = self.pieces[0]
            take = min(piece.rows - self.consumed, need)
            if take > 0:
                out.append(_slice_rows(piece, self.consumed,
                                       self.consumed + take))
                self.consumed += take
                need -= take
            if self.consumed >= piece.rows:
                self.pieces.pop(0)
                self.consumed = 0
        return out, n_rows - need


def iter_batches(pf, columns: Optional[Sequence[str]] = None,
                 batch_rows: int = 65536, strict_batch_rows: bool = False,
                 device="cuda", policy=None, report=None,
                 keep_levels: bool = False) -> Iterator[ColumnSet]:
    """Stream ``pf`` as :class:`ColumnSet` batches of at most
    ``batch_rows`` rows on ``device`` (CUDA unless the caller names the
    CPU), each ``{dotted path: Column}`` of the selected columns (all by
    default, as :meth:`ParquetFile.read` selects them) holding only the
    decoded pages that cover it.  A batch ends at a row-group boundary
    once at least half of ``batch_rows`` is pending, as pyarrow's does;
    only the remainders of small row groups gather across boundaries.
    ``strict_batch_rows=True`` makes every batch but the last exactly
    ``batch_rows`` rows.  The batches' concatenation equals
    :meth:`ParquetFile.read`.

    ``policy`` (default: the file's) retries transient preads, runs the
    whole drain under one ``deadline_s`` clock, started at the first
    pull, and with ``on_corrupt='skip_row_group'`` drops the rows of a
    corrupt row group not yet yielded (batches already yielded from it
    stay valid), accounted in ``report``.  Each batch's ``report`` is that
    report and its ``read_stats`` the drain's prefetcher's
    :class:`~parquet_tpu_torch.io.prefetch.ReadStats` (None without
    one).  ``keep_levels`` keeps each repeated column's (and struct
    chain's) Dremel level streams on the host, sliced with its rows (the
    row model's and the merge's need); nothing else pays for them."""
    if batch_rows <= 0:
        raise ValueError("batch_rows must be positive")
    dev = resolve_device(device)
    gen = _isolated(_iter_batches_gen(pf, columns, batch_rows,
                                      strict_batch_rows, dev, policy,
                                      report, keep_levels))
    # the drain is an op of its own (unless the caller's is active),
    # active around each pull only: the consumer's work between pulls
    # is not the drain's
    return _oscope.scoped_iter("file.iter_batches", gen, file=pf._path)


def _isolated(gen: Iterator) -> Iterator:
    """``gen`` run in a context of its own: a context variable the drain
    sets (its operation's deadline) stays with the drain between pulls,
    and never reaches the consumer's other work."""
    ctx = contextvars.copy_context()
    try:
        while True:
            try:
                item = ctx.run(next, gen)
            except StopIteration:
                return
            yield item
    finally:
        ctx.run(gen.close)


def _iter_batches_gen(pf, columns, batch_rows, strict_batch_rows, device,
                      policy, report, keep_levels) -> Iterator[ColumnSet]:
    pol, report = resolve_policy(pf, policy, report)
    skip = pol is not None and pol.skip_corrupt
    paths = [leaf.name for leaf in _select_leaves(pf.schema, columns)]
    paths = list(dict.fromkeys(paths))
    with pf._resilient_op(policy, report, "iter_batches"):
        yield from _iter_batches_impl(pf, paths, batch_rows,
                                      strict_batch_rows, device, skip,
                                      report, keep_levels)


def _take_contextual(pf, cursor: _ChunkCursor, path: str, rg_index: int,
                     take: int) -> List[_Slice]:
    """One column's take, its failure located, in the ``decode.stream``
    span."""
    dec_span = (_trace.span("decode.stream", rg=rg_index, col=path,
                            rows=take)
                if _trace.TRACE_ENABLED else _trace.NULL_SPAN)
    with dec_span, \
            read_context(path=pf._path, row_group=rg_index, column=path):
        slices, got = cursor.take(take)
        if got != take:
            raise CorruptedError(
                f"streaming cursor yielded {got} of {take} rows (page "
                "stream shorter than row-group metadata)")
        return slices


def _iter_batches_impl(pf, paths, batch_rows, strict_batch_rows, device,
                       skip, report, keep_levels) -> Iterator[ColumnSet]:
    from .prefetch import make_prefetcher

    n_rg = len(pf.row_groups)
    # one prefetcher a drain; row group N + 1's chunks are planned when
    # N's cursors are built, so its readahead runs under N's decode
    pre = make_prefetcher(pf.source, n_streams=len(paths))
    stats = pre.stats if pre is not None else None
    planned = -1

    def plan_rg(pos: int) -> None:
        nonlocal planned
        if pre is None or pos >= n_rg or pos <= planned:
            return
        planned = pos
        for p in paths:
            pre.plan(*pf.row_group(pos).column(_leaf_index(pf, p)).byte_range)

    cursors: Dict[str, _ChunkCursor] = {}
    rg_index = -1
    rg_rows_left = 0
    pending: Dict[str, List[_Slice]] = {p: [] for p in paths}
    pending_rows = 0
    pending_spans = []  # (pf, row group, first row, rows) of the batch

    def flush() -> ColumnSet:
        nonlocal pending, pending_rows, pending_spans
        out = ColumnSet(((p, _concat_pending(pending[p])) for p in paths),
                        schema=pf.schema, num_rows=pending_rows,
                        spans=pending_spans, device=device)
        if report is not None:
            report.rows_read += pending_rows
            out.report = report
        out.read_stats = stats
        STREAM["batches"] += 1
        pending = {p: [] for p in paths}
        pending_rows = 0
        pending_spans = []
        return out

    try:
        pos = 0
        while True:
            if rg_rows_left == 0:
                if pos >= n_rg:
                    break
                rg_index = pos
                rg = pf.row_group(pos)
                plan_rg(pos)
                plan_rg(pos + 1)  # double buffer: N + 1's readahead
                pos += 1
                cursors = {p: _ChunkCursor(
                    chunk=rg.column(_leaf_index(pf, p)), device=device,
                    source=pre, keep_levels=keep_levels) for p in paths}
                rg_rows_left = rg.num_rows
            take = min(batch_rows - pending_rows, rg_rows_left)
            # a step's takes join pending only once every column's
            # succeeded: a step that fails part-way adds nothing
            try:
                taken = {p: _take_contextual(pf, cursors[p], p, rg_index,
                                             take) for p in paths}
            except DeadlineError:
                raise
            except CorruptedError as e:
                if not skip:
                    raise
                # the group's rows already yielded, or aligned in pending
                # from earlier steps, decoded fine and stay
                report.record_skip(rg_index, rows=rg_rows_left, error=e)
                rg_rows_left = 0
                cursors = {}
                if pre is not None:
                    # its plans would keep their windows to the drain's end
                    for p in paths:
                        pre.unplan(*rg.column(_leaf_index(pf, p)).byte_range)
                continue
            for p in paths:
                pending[p].extend(taken[p])
            pending_spans.append((pf, rg_index, rg.num_rows - rg_rows_left,
                                  take))
            pending_rows += take
            rg_rows_left -= take
            if rg_rows_left == 0:
                cursors = {}  # the group's last pieces go with its batch
            # a batch also ends at a row-group boundary once half full: a
            # batch across groups costs a concatenation
            if pending_rows >= batch_rows or (
                    not strict_batch_rows and rg_rows_left == 0
                    and pending_rows * 2 >= batch_rows):
                yield flush()
        if pending_rows:
            yield flush()
    finally:
        cursors = pending = None
        if pre is not None:
            pre.close()  # drops queued windows; the file stays open


def _concat_pending(slices: List[_Slice]) -> Column:
    """A batch's slices of one column as one column, with the sizes the
    slices know (no read of the device for them); slices of one chunk
    share its dictionary, kept once."""
    return concat_columns([s.col for s in slices],
                          elements=[s.elements for s in slices],
                          nbytes=[s.nbytes for s in slices])


def _leaf_index(pf, path: str) -> int:
    return pf.schema.leaf(path).column_index
