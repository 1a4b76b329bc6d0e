"""The fused page cursor: decode, filter and fold one page at a time.

The port of ``parquet_tpu/io/fused.py``.  The aggregation cascade's exact
tier (``io/aggregate.py``) and the host scan's phase 1
(``parallel/host_scan.py``) otherwise decode whole column spans; here a
contended span streams through a :class:`PageCursor` instead, on the
host: at most one decoded page is alive a column (asking for another
page drops it), a filter mask applies inside the decode through the
encodings' registered ``decode_masked`` twins (``ops/encodings.py``; a
page the mask never selects is not decoded), and each page's part folds
into the same accumulators as the materializing tier, so the answers are
the same.

Chosen by ``io/planner.py::choose_fused`` under
``PARQUET_TPU_TORCH_FUSED`` (auto/on/off).  On a CUDA device ``auto``
never chooses it: the card decodes a contended span whole in one plan.
:data:`FUSED` counts the row groups folded, the pages decoded whole and
masked, the fallbacks to the materializing tier and the scan spans
masked.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..format.enums import Encoding, PageType, Type
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.scope import account as _account
from ..ops import ref
from ..ops.encodings import lookup as _lookup_encoding
from ..utils.debug import counters
from ..utils.pool import read_admission

__all__ = ["FusedUnsupported", "PageCursor", "FUSED", "reset_fused",
           "count_fused"]

#: row groups folded through cursors, pages decoded (whole or masked),
#: pages masked-emitted, fallbacks to the materializing tier, host scan
#: spans masked page by page
FUSED = {"rg_folds": 0, "pages_folded": 0, "pages_masked_emit": 0,
         "fallbacks": 0, "scan_spans": 0}

_UNSET = object()


# each FUSED key's registry family (fused.<key>), and the fold's latency
_METRIC = {k: _counter("fused." + k) for k in FUSED}
_H_FOLD_S = _histogram("fused.fold_s")


def count_fused(key: str, n: int = 1) -> None:
    """Count ``n`` in ``FUSED[key]``, in ``fused.<key>`` and in the op."""
    FUSED[key] += n
    _account(_METRIC[key], n)


def reset_fused() -> None:
    for k in FUSED:
        FUSED[k] = 0


class FusedUnsupported(Exception):
    """The chunk cannot stream a page at a time (a nested column, no
    offset index): the caller takes the materializing tier."""


class PageCursor:
    """Row-aligned access to one flat column chunk, a page at a time, on
    the host.  Only the current page's decoded form is kept: asking for
    another page drops it.  Each page decodes under an admission grant of
    its uncompressed bytes."""

    def __init__(self, rg, leaf):
        if leaf.max_repetition_level > 0:
            raise FusedUnsupported(f"nested column {leaf.name!r}")
        self.leaf = leaf
        self.rg = rg
        self.chunk = rg.column(leaf.column_index)
        oi = self.chunk.offset_index()
        if oi is None or not oi.page_locations:
            raise FusedUnsupported(f"no offset index for {leaf.name!r}")
        from .search import page_row_spans

        self.locs = oi.page_locations
        self.spans: List[Tuple[int, int]] = page_row_spans(oi, rg.num_rows)
        self._dict = _UNSET
        self._cur: Tuple[Optional[int], object] = (None, None)
        self._adm = read_admission()
        self.pages_decoded = 0
        self.pages_masked = 0

    # ------------------------------------------------------------------ pages
    def dictionary(self):
        """The chunk's decoded dictionary (once; None without one)."""
        if self._dict is _UNSET:
            from .reader import decode_dictionary_page
            from .search import dictionary_pages

            d = None
            for pg in dictionary_pages(self.chunk, self.locs[0].offset):
                d = decode_dictionary_page(self.chunk, pg)
                counters.inc("dict_pages_decoded")
                break
            self._dict = d
        return self._dict

    def _page_info(self, o: int):
        loc = self.locs[o]
        return next(iter(self.chunk.pages_at(
            loc.offset, loc.compressed_page_size, num_pages=1)))

    def page(self, o: int):
        """Page ``o`` decoded whole on the host (kept while it is the
        current page)."""
        cur_o, col = self._cur
        if cur_o == o:
            return col
        from .reader import decode_chunk_host

        pg = self._page_info(o)  # its CRC checked under verify_crc
        with self._adm.admit(pg.header.uncompressed_page_size or 0,
                             tier="scan"):
            col = decode_chunk_host(self.chunk, "cpu", pages=[pg],
                                    dictionary=self.dictionary())
        self.pages_decoded += 1
        count_fused("pages_folded")
        self._cur = (o, col)
        return col

    # ---------------------------------------------------------------- aligned
    def ordinals(self, s: int, e: int) -> Iterator[int]:
        """The page ordinals overlapping local rows ``[s, e)``."""
        for o, (ps, pe) in enumerate(self.spans):
            if pe <= s:
                continue
            if ps >= e:
                break
            yield o

    def grid(self, s: int, e: int) -> List[int]:
        """The page starts inside ``(s, e)``: cut points that callers join
        across cursors so each block lies in one page of every column."""
        return [ps for ps, _ in self.spans if s < ps < e]

    def blocks(self, s: int, e: int):
        """``(ordinal, bs, be, values, validity)`` row-aligned pieces of
        ``[s, e)``, a page at a time."""
        from .search import _trim_host

        for o in self.ordinals(s, e):
            ps, pe = self.spans[o]
            bs, be = max(ps, s), min(pe, e)
            vals, valid = _trim_host(self.page(o), bs - ps, be - bs, True)
            yield o, bs, be, vals, valid

    def aligned(self, s: int, e: int):
        """``(values, validity)`` of local rows ``[s, e)``: the pieces of
        the pages it spans joined, one decoded page alive at a time."""
        parts = list(self.blocks(s, e))
        if len(parts) == 1:
            return parts[0][3], parts[0][4]
        vals_parts = [p[3] for p in parts]
        if isinstance(vals_parts[0], list):
            vals = [v for part in vals_parts for v in part]
        else:
            vals = np.concatenate(vals_parts)
        if all(p[4] is None for p in parts):
            return vals, None
        valid = np.concatenate(
            [p[4] if p[4] is not None else np.ones(p[2] - p[1], bool)
             for p in parts])
        return vals, valid

    # ----------------------------------------------------------- masked emit
    def masked_values(self, o: int, sel: np.ndarray):
        """Page ``o`` decoded under ``sel`` (a bool mask over its rows):
        ``(values, present)``, the selected present values in row order (an
        array, a ``(values, offsets)`` pair or ``DictIndices``) and their
        count; ``(None, 0)`` where every selected row is null, ``(None,
        -1)`` where the page cannot be decoded so (the caller decodes it
        whole with :meth:`page`)."""
        leaf, chunk = self.leaf, self.chunk
        max_def = leaf.max_definition_level
        bw = int(max_def).bit_length()
        physical = Type(chunk.meta.type)
        pg = self._page_info(o)
        h = pg.header
        with self._adm.admit(h.uncompressed_page_size or 0, tier="scan"):
            codec = chunk.codec
            if pg.page_type == PageType.DATA_PAGE:
                dph = h.data_page_header
                n = dph.num_values
                raw = np.frombuffer(
                    codec.decode(pg.payload, h.uncompressed_page_size),
                    np.uint8)
                pos = 0
                defs = None
                if max_def > 0:
                    if Encoding(dph.definition_level_encoding) != \
                            Encoding.RLE:
                        return None, -1  # legacy BIT_PACKED levels
                    defs, pos = ref.decode_rle_len_prefixed(raw, n, bw, pos)
                nvals = (n if defs is None
                         else int(np.count_nonzero(defs == max_def)))
                encoding = Encoding(dph.encoding)
            elif pg.page_type == PageType.DATA_PAGE_V2:
                dph2 = h.data_page_header_v2
                n = dph2.num_values
                rl = dph2.repetition_levels_byte_length or 0
                dl = dph2.definition_levels_byte_length or 0
                payload = np.frombuffer(pg.payload, np.uint8)
                defs = None
                if max_def > 0:
                    defs = ref.decode_rle(payload[rl:rl + dl], n, bw)
                body = payload[rl + dl:]
                if dph2.is_compressed is not False:
                    body = np.frombuffer(codec.decode(
                        body, h.uncompressed_page_size - rl - dl), np.uint8)
                raw = body
                pos = 0
                nvals = n - (dph2.num_nulls or 0)
                encoding = Encoding(dph2.encoding)
            else:
                return None, -1
            spec = _lookup_encoding(encoding)
            if spec is None or spec.decode_masked is None:
                return None, -1
            sel = np.asarray(sel, bool)
            if defs is None:
                take = np.flatnonzero(sel).astype(np.int64)
            else:
                valid = defs == max_def
                take = (np.cumsum(valid) - 1)[sel & valid].astype(np.int64)
            present = len(take)
            if present == 0:
                self.pages_masked += 1
                count_fused("pages_masked_emit")
                return None, 0
            dec = spec.decode_masked(raw, pos, nvals, take, leaf, physical,
                                     self.dictionary())
        if dec is None:
            return None, -1
        self.pages_masked += 1
        count_fused("pages_masked_emit")
        count_fused("pages_folded")
        return dec, present

    @property
    def touched(self) -> bool:
        """True once a page decoded whole or masked (exact-tier work: the
        tier accounting reads it)."""
        return self.pages_decoded > 0 or self.pages_masked > 0
