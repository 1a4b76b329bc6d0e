"""Page-index search for point lookups.

The port's cut of ``parquet_tpu/io/search.py``: :func:`find` (the
reference's ``parquet.Find``) and :func:`pages_overlapping` over a
``ColumnIndex`` whose bounds :func:`decoded_bounds` decodes once per chunk,
:func:`dictionary_pages` (the dictionary half of a seek), and
:func:`_trim_flat_aligned`, the row-aligned form of a decoded span.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..algebra.compare import normalize
from ..format import metadata as md
from ..format.enums import BoundaryOrder, Encoding, PageType
from ..schema.schema import Leaf
from .statistics import decode_stat_value

_DICT_ENCODINGS = {Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY}


def decoded_bounds(column_index: md.ColumnIndex, leaf: Leaf):
    """Per-page ``(mins, maxs)`` in the leaf's order domain, memoized on
    the parsed index (which the chunk reader memoizes in turn)."""
    got = getattr(column_index, "_decoded_bounds", None)
    if got is None:
        got = ([decode_stat_value(m, leaf)
                for m in (column_index.min_values or [])],
               [decode_stat_value(m, leaf)
                for m in (column_index.max_values or [])])
        column_index._decoded_bounds = got
    return got


def find(column_index: md.ColumnIndex, value, leaf: Leaf) -> int:
    """First page ordinal whose [min, max] may contain ``value`` (the
    number of pages when none can): a binary search where the boundary
    order allows, else a linear scan."""
    value = normalize(leaf, value)
    n = len(column_index.null_pages or [])
    mins, maxs = decoded_bounds(column_index, leaf)
    order = BoundaryOrder(column_index.boundary_order or 0)
    nulls = column_index.null_pages or [False] * n

    def may_contain(i: int) -> bool:
        if nulls[i]:
            return False
        return mins[i] <= value <= maxs[i]

    if order == BoundaryOrder.ASCENDING:
        lo, hi = 0, n  # first page with max >= value
        while lo < hi:
            mid = (lo + hi) // 2
            if nulls[mid] or maxs[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        return lo if lo < n and may_contain(lo) else n
    if order == BoundaryOrder.DESCENDING:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if nulls[mid] or mins[mid] > value:
                lo = mid + 1
            else:
                hi = mid
        return lo if lo < n and may_contain(lo) else n
    for i in range(n):
        if may_contain(i):
            return i
    return n


def pages_overlapping(column_index: md.ColumnIndex, leaf: Leaf,
                      lo=None, hi=None) -> List[int]:
    """Every page ordinal whose [min, max] meets [lo, hi] (None = open)."""
    lo, hi = normalize(leaf, lo), normalize(leaf, hi)
    n = len(column_index.null_pages or [])
    mins, maxs = decoded_bounds(column_index, leaf)
    nulls = column_index.null_pages or [False] * n
    out = []
    for i in range(n):
        if nulls[i]:
            continue
        if mins[i] is None or maxs[i] is None:
            out.append(i)
            continue
        if lo is not None and maxs[i] < lo:
            continue
        if hi is not None and mins[i] > hi:
            continue
        out.append(i)
    return out


def dictionary_pages(chunk, first_data_offset: int):
    """Yield the chunk's dictionary page, if it has one, given the offset
    of its first data page."""
    m = chunk.meta
    dict_off = m.dictionary_page_offset
    if dict_off is not None and 0 < dict_off < first_data_offset:
        yield from chunk.pages_at(dict_off, first_data_offset - dict_off)
    elif dict_off is None and any(Encoding(e) in _DICT_ENCODINGS
                                  for e in (m.encodings or [])):
        # a writer may leave dictionary_page_offset out: walk the headers
        for p in chunk.pages():
            if p.page_type == PageType.DICTIONARY_PAGE:
                yield p
                break


def _trim_flat_aligned(values: np.ndarray, validity: Optional[np.ndarray],
                       offset: int, count: int
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Rows ``[offset, offset + count)`` of a decoded flat span (dense
    present ``values``, per-slot ``validity`` or None) as row-aligned
    ``(values, validity)``: a null slot holds a zero fill."""
    if validity is None:
        return values[offset:offset + count], None
    validity = np.asarray(validity, bool)
    vmask = validity[offset:offset + count]
    vstart = int(np.count_nonzero(validity[:offset]))
    vend = vstart + int(np.count_nonzero(vmask))
    out = np.zeros(int(count), values.dtype)
    out[vmask] = values[vstart:vend]
    return out, vmask
