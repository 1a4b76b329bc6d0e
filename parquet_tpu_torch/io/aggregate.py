"""Aggregation pushdown: answer aggregates at the cheapest tier that proves
them, decoding on the device only what no tier above could answer.

The port of ``parquet_tpu/io/aggregate.py``, with its structure and
names.  Each (row group x aggregate) resolves at the first tier that can
prove its contribution exactly:

1. **Footer statistics** (no IO, no decode): a row group the prepared
   ``where`` tree cannot intersect contributes nothing; one it provably
   covers answers ``count(*)`` from ``num_rows``, ``count(col)`` from the
   value and null counts, and MIN/MAX from exact-type statistics.
2. **Page-index zone maps**: a partly covered row group splits into
   covered and contended row intervals per leaf, folded through the tree;
   covered pages count from their row spans and bound MIN/MAX from their
   page statistics; only contended pages descend.
3. **Dictionary pages**: SUM / COUNT DISTINCT / MIN / MAX over a fully
   dictionary-encoded chunk fold over its index stream.  The chunk
   decodes on ``device`` in dictionary form (``device_reader.
   decode_chunk_span(keep_dictionary=True)``: its indexes unpacked by the
   ``unpack_bits_dense`` kernel, nothing gathered), ``torch.bincount``
   counts each entry on the device, and only the dictionary-sized count
   vector comes back: the folds over dictionary values run on the host,
   exact (Python ints for sums).
4. **Exact decode**: what survives decodes on ``device``
   (``decode_chunk_span`` over the pages of the span), trimmed to the
   rows.  The predicate's mask is the host scan's ``expr_mask`` over the
   filter columns, copied back once per contended interval; the mask goes
   to the device in one copy, and the numeric folds run there
   (:func:`_device_fold`: count, min/max with NaN dropped and unsigned
   columns in their order, exact integer sums, float64 sums, distinct
   values, the top-k candidates).

Metadata tiers run on the host as in the JAX package.  These folds run on
the host, over spans copied back once each, and are counted in
:data:`AGG`: ``sum_sq`` of integers (Python squares), byte-array, FLBA,
decimal and INT96 values (``host_folds_values``), every group-by fold
(``host_folds_group_by``), and the fused page cursor's folds
(``host_folds_fused``; ``io/fused.py``, pinned by
``PARQUET_TPU_TORCH_FUSED=on``).  Results are the JAX package's Python
types (``int``, ``float``, ``bool``, ``bytes``), never tensors.

Over a remote source (``io/remote.py``), a row group's disjoint byte
ranges are fetched at once, one a pooled connection
(``parallel_preads``, at most ``PARQUET_TPU_TORCH_REMOTE_PARALLEL``), and
its resolution reads them from memory (``io/source.py::
PreloadedSource``).

A corrupt row group under ``on_corrupt='skip_row_group'`` drops its
contribution whole (accumulated into a delta, merged only on success),
recorded in the ``ReadReport``; :meth:`AggregateResult.explain` says
which tier answered each row group.  Float sums add per resolution unit
in another order than the JAX package's numpy sums, so they agree to
rounding; every other aggregate is exact.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..algebra.aggregate import DERIVED_KINDS, AggExpr
from ..algebra.expr import TRUE, Const, Expr, prepare
from ..errors import CorruptedError, DeadlineError
from ..format.enums import Encoding, Type
from ..obs import scope as _oscope
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..utils.env import env_bool
from ..utils.pool import read_admission
from .planner import (_collect_preds, _eval_tree, _intersect_intervals,
                      _merge_intervals, _pred_page_ords, _stats_alive,
                      _stats_covers, _tree_covers)

_M_AGG_S = _histogram("agg.aggregate_s")
_M_DS_AGG_S = _histogram("dataset.aggregate_s")
_M_FILES_MANIFEST = _counter("agg.files_answered_manifest")
# each tier's counter of the row groups it answered
_TIER_METRIC = {t: _counter("agg.rg_answered_" + t)
                for t in ("stats", "pages", "dict", "dict_partial",
                          "decoded")}


__all__ = ["AggregateResult", "aggregate_file", "dataset_aggregate",
           "encode_agg_state", "decode_agg_state", "AGG", "reset_agg"]

#: where the folds ran and what crossed between host and device:
#: ``device_folds`` (an aggregate's fold over a span on the device),
#: ``dict_folds`` (the dictionary tier: counts on the device, the values'
#: fold on the host), the host folds by kind, ``spans_decoded`` (exact
#: tier decodes on the device), ``dict_chunks`` (chunks decoded in
#: dictionary form), ``copies_back`` (spans copied to the host),
#: ``dict_copies_back`` (dictionary-sized vectors copied back) and
#: ``mask_copies`` (masks sent to the device)
AGG = {"device_folds": 0, "dict_folds": 0, "host_folds_values": 0,
       "host_folds_sum_sq": 0, "host_folds_group_by": 0,
       "host_folds_fused": 0, "spans_decoded": 0, "dict_chunks": 0,
       "copies_back": 0, "dict_copies_back": 0, "mask_copies": 0}


def reset_agg() -> None:
    for k in AGG:
        AGG[k] = 0


_COUNTER_KEYS = ("rg_answered_stats", "rg_answered_pages",
                 "rg_answered_dict", "rg_answered_dict_partial",
                 "rg_answered_decoded",
                 "rg_skipped_corrupt", "files_answered_manifest",
                 "files_skipped")

# physical types whose statistics are exact (no truncation): only these
# may ANSWER MIN/MAX from stats; byte-array bounds may be truncated and
# serve coverage proofs only
_EXACT_STAT_TYPES = (Type.BOOLEAN, Type.INT32, Type.INT64, Type.FLOAT,
                     Type.DOUBLE)

# the physical types whose values fold on the device
_DEVICE_TYPES = (Type.BOOLEAN, Type.INT32, Type.INT64, Type.FLOAT,
                 Type.DOUBLE)

_Intervals = List[Tuple[int, int]]

# the one NaN group key: every group-key producer canonicalizes through
# _canon_key, so all NaN rows share this object (dict identity
# short-circuits the equality NaN refuses)
_NAN_KEY = float("nan")

_U64_FLIP = -(1 << 63)  # int64 xor that orders uint64 bits as signed


def _canon_key(v):
    if isinstance(v, float) and v != v:
        return _NAN_KEY
    return v


def _subtract_intervals(a: _Intervals, b: _Intervals) -> _Intervals:
    """``a - b`` over half-open merged interval lists."""
    out: _Intervals = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if be >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _iv_rows(iv: _Intervals) -> int:
    return sum(e - s for s, e in iv)


# ---------------------------------------------------------------------------
# accumulators (the partial states that merge across row groups and files)
# ---------------------------------------------------------------------------


class _RevKey:
    """Reversed-order heap key (``top_k(..., largest=False)`` keeps a
    max-heap of the smallest k)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other) -> bool:
        return other.v < self.v


class _Acc:
    """One aggregate's partial state: ``add_*`` fold contributions in,
    ``merge`` joins two partials, ``result`` finalizes."""

    def __init__(self, agg: AggExpr, leaf):
        self.agg = agg
        self.leaf = leaf
        self.n = 0  # count kinds
        self.cur = None  # min/max
        self.total = None  # sum (python int, or float)
        self.distinct = set() if agg.kind == "count_distinct" else None
        self.heap: List = [] if agg.kind == "top_k" else None

    def add_count(self, k: int) -> None:
        self.n += int(k)

    def add_bound(self, v) -> None:
        """Fold one proven min/max bound."""
        if v is None:
            return
        if self.cur is None:
            self.cur = v
        elif self.agg.kind == "min":
            self.cur = min(self.cur, v)
        else:
            self.cur = max(self.cur, v)

    def add_sum(self, v) -> None:
        if v is None:
            return
        self.total = v if self.total is None else self.total + v

    def topk_bound(self):
        """The running k-th value, or None while the heap is not full: a
        page whose max (min, for smallest) cannot beat it is skipped."""
        if self.heap is None or len(self.heap) < self.agg.k:
            return None
        h = self.heap[0]
        return h.v if isinstance(h, _RevKey) else h

    def topk_contends(self, page_bound) -> bool:
        b = self.topk_bound()
        if b is None or page_bound is None:
            return True
        try:
            return page_bound > b if self.agg.largest else page_bound < b
        except TypeError:
            return True

    def _offer(self, v) -> None:
        item = v if self.agg.largest else _RevKey(v)
        if len(self.heap) < self.agg.k:
            heapq.heappush(self.heap, item)
        else:
            heapq.heappushpop(self.heap, item)

    def offer_all(self, vals) -> None:
        """Offer values (in order) that may beat the running bound."""
        b = self.topk_bound()
        for v in vals:
            if b is None or (v > b if self.agg.largest else v < b):
                self._offer(v)
                b = self.topk_bound()

    def add_values(self, vals) -> None:
        """Fold order-domain values on the host (a numpy array of present
        values, or a list that may hold ``None``), as the JAX package's
        ``_Acc.add_values``."""
        kind = self.agg.kind
        isarr = isinstance(vals, np.ndarray)
        if isarr and vals.dtype.kind == "f" \
                and kind not in ("sum", "sum_sq"):
            vals = vals[~np.isnan(vals)]  # NaN skipped (stats convention)
        if not isarr:
            vals = [v for v in vals if v is not None]
        if len(vals) == 0:
            return
        if kind in ("min", "max"):
            if isarr:
                self.add_bound((vals.min() if kind == "min"
                                else vals.max()).item())
            else:
                self.add_bound(min(vals) if kind == "min" else max(vals))
        elif kind == "sum":
            if isarr:
                if vals.dtype.kind == "f":
                    self.add_sum(float(np.sum(vals, dtype=np.float64)))
                elif vals.dtype.kind == "b":
                    self.add_sum(int(np.count_nonzero(vals)))
                elif vals.dtype.itemsize < 8:
                    self.add_sum(int(np.sum(vals, dtype=np.int64)))
                else:
                    self.add_sum(sum(vals.tolist()))
            else:
                self.add_sum(sum(vals))  # decimal unscaled ints
        elif kind == "sum_sq":
            if isarr and vals.dtype.kind == "f":
                v = vals.astype(np.float64, copy=False)
                self.add_sum(float(np.dot(v, v)))
            elif isarr and vals.dtype.kind == "b":
                self.add_sum(int(np.count_nonzero(vals)))
            else:
                vals = vals.tolist() if isarr else vals
                self.add_sum(sum(int(x) * int(x) for x in vals))
        elif kind == "count_distinct":
            if isarr:
                self.distinct.update(np.unique(vals).tolist())
            else:
                self.distinct.update(vals)
        else:
            b = self.topk_bound()
            if isarr and b is not None:
                vals = vals[vals > b] if self.agg.largest else vals[vals < b]
            self.offer_all(vals.tolist() if isarr else vals)

    def merge(self, other: "_Acc") -> None:
        self.n += other.n
        self.add_bound(other.cur)
        self.add_sum(other.total)
        if self.distinct is not None:
            self.distinct |= other.distinct
        if self.heap is not None:
            self.offer_all([item.v if isinstance(item, _RevKey) else item
                            for item in other.heap])

    def result(self):
        kind = self.agg.kind
        if kind == "count":
            return self.n
        if kind in ("min", "max"):
            return self.cur
        if kind in ("sum", "sum_sq"):
            return self.total
        if kind == "count_distinct":
            return len(self.distinct)
        vals = [item.v if isinstance(item, _RevKey) else item
                for item in self.heap]
        return sorted(vals, reverse=self.agg.largest)


# ---------------------------------------------------------------------------
# the folds on the device
# ---------------------------------------------------------------------------


def _device_foldable(leaf, kind: str) -> bool:
    """Whether ``kind`` folds ``leaf``'s values on the device: the numeric
    and boolean physical types outside decimals, but for the integer
    ``sum_sq`` (exact Python squares) and a boolean top-k."""
    from ..schema.types import LogicalKind

    phys = leaf.physical_type
    if phys not in _DEVICE_TYPES or leaf.logical_kind == LogicalKind.DECIMAL:
        return False
    if kind == "sum_sq":
        return phys in (Type.FLOAT, Type.DOUBLE, Type.BOOLEAN)
    return not (kind == "top_k" and phys == Type.BOOLEAN)


class _Order:
    """A tensor of a column's present values in its order domain, and
    the way back to the JAX package's Python values: unsigned 32-bit
    values widen to int64, unsigned 64-bit ones flip their sign bit (so
    signed order is unsigned order)."""

    def __init__(self, leaf, vals: torch.Tensor):
        from ..algebra.compare import is_unsigned

        self.u32 = self.u64 = False
        if is_unsigned(leaf) and vals.dtype == torch.int32:
            vals = vals.to(torch.int64) & 0xFFFFFFFF
            self.u32 = True
        elif is_unsigned(leaf) and vals.dtype == torch.int64:
            vals = vals ^ _U64_FLIP
            self.u64 = True
        self.t = vals

    def py(self, v):
        """A key of :attr:`t` as the Python value."""
        return int(v) + (1 << 63) if self.u64 else v

    def key(self, v):
        """A Python value as a key of :attr:`t`."""
        return int(v) - (1 << 63) if self.u64 else v

    def pylist(self, t: torch.Tensor) -> list:
        return [self.py(v) for v in t.tolist()]


def _first_equal(t: torch.Tensor, m: torch.Tensor):
    """The first element of ``t`` equal to ``m``: Python's min/max keep the
    first of equals, which tells a float ``-0.0`` from ``0.0``."""
    return t[(t == m).to(torch.uint8).argmax()].item()


def _int_sum(t: torch.Tensor, unsigned: bool) -> int:
    """The exact sum of 64-bit integers: their two 32-bit halves summed
    apart in int64 (each under 2^32, so no wrap below 2^31 values) and
    joined as a Python int."""
    lo = int((t & 0xFFFFFFFF).sum())
    hi = t >> 32
    if unsigned:
        hi = hi & 0xFFFFFFFF
    return (int(hi.sum()) << 32) + lo


def _device_fold(acc: _Acc, leaf, vals: torch.Tensor) -> None:
    """Fold the present values ``vals`` (a 1-D tensor in the column's
    stored dtype) into ``acc`` on their device; only scalars, the
    distinct values and at most k top-k candidates come back."""
    kind = acc.agg.kind
    isfloat = vals.dtype in (torch.float32, torch.float64)
    if isfloat and kind not in ("sum", "sum_sq"):
        vals = vals[~torch.isnan(vals)]  # NaN skipped (stats convention)
    if vals.numel() == 0:
        return
    if vals.dtype == torch.bool:
        if kind == "min":
            acc.add_bound(bool(vals.all()))
        elif kind == "max":
            acc.add_bound(bool(vals.any()))
        elif kind in ("sum", "sum_sq"):
            acc.add_sum(int(torch.count_nonzero(vals)))
        else:  # count_distinct
            acc.distinct.update(torch.unique(vals).tolist())
        return
    if kind == "sum":
        if isfloat:
            acc.add_sum(float(vals.to(torch.float64).sum()))
        elif vals.dtype == torch.int64:
            from ..algebra.compare import is_unsigned

            acc.add_sum(_int_sum(vals, is_unsigned(leaf)))
        else:
            o = _Order(leaf, vals)
            acc.add_sum(int(o.t.to(torch.int64).sum()))
        return
    if kind == "sum_sq":  # floats only (integers square on the host)
        v = vals.to(torch.float64)
        acc.add_sum(float(torch.dot(v, v)))
        return
    o = _Order(leaf, vals)
    t = o.t
    if kind in ("min", "max"):
        m = t.amin() if kind == "min" else t.amax()
        acc.add_bound(_first_equal(t, m) if isfloat else o.py(m.item()))
    elif kind == "count_distinct":
        acc.distinct.update(o.pylist(torch.unique(t)))
    else:  # top_k: the candidates that beat the bound, at most k of them
        b = acc.topk_bound()
        if b is not None:
            kb = o.key(b)
            t = t[t > kb] if acc.agg.largest else t[t < kb]
        k = min(acc.agg.k, t.numel())
        if k:
            top = torch.topk(t, k, largest=acc.agg.largest).values
            acc.offer_all(o.pylist(top))


# ---------------------------------------------------------------------------
# decoded spans and masks
# ---------------------------------------------------------------------------


class _Mask:
    """A contended interval's exact row mask: on the host (where
    ``expr_mask`` made it), and sent to the device once, when a device
    fold first needs it."""

    __slots__ = ("host", "count", "_dev")

    def __init__(self, host: np.ndarray):
        self.host = host
        self.count = int(host.sum())
        self._dev = None

    def dev(self, device) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.from_numpy(self.host).to(device)
            AGG["mask_copies"] += 1
        return self._dev


class _Span:
    """Rows ``[off, off + n)`` of a column decoded on the device (``col``:
    a page span or the whole chunk), row-aligned on demand: on the device
    for the folds there, on the host (one copy back) for the rest."""

    __slots__ = ("leaf", "col", "off", "n", "_host", "_vals")

    def __init__(self, leaf, col, off: int, n: int):
        self.leaf = leaf
        self.col = col
        self.off = off
        self.n = n
        self._host = None
        self._vals = None

    def valid(self) -> Optional[torch.Tensor]:
        v = self.col.validity
        return None if v is None else v[self.off:self.off + self.n]

    def values(self) -> torch.Tensor:
        """The span's values, one a row (0 at a null), on the device: a
        fixed-width numeric column only."""
        if self._vals is None:
            col = self.col
            full = col.values
            if col.validity is not None:
                full = torch.zeros(col.num_slots, dtype=full.dtype,
                                   device=full.device).masked_scatter_(
                    col.validity, col.values)
            self._vals = full[self.off:self.off + self.n]
        return self._vals

    def host(self):
        """``(values, validity)`` on the host, as ``read_row_range(...,
        aligned=True)`` gives them."""
        if self._host is None:
            from .search import _trim_host

            AGG["copies_back"] += 1
            self._host = _trim_host(self.col, self.off, self.n, True)
        return self._host


def _fold_span(acc: _Acc, span: _Span, mask: Optional[_Mask] = None) -> None:
    """Fold ``span``'s present rows (those of ``mask`` only, if given) into
    ``acc``: a count and the numeric folds on the device, the rest on the
    host over one copy of the span."""
    agg, leaf = acc.agg, acc.leaf
    if agg.kind == "count":
        valid = span.valid()
        if valid is None:
            acc.add_count(span.n if mask is None else mask.count)
        else:
            keep = valid if mask is None else valid & mask.dev(valid.device)
            acc.add_count(int(keep.sum()))
        AGG["device_folds"] += 1
        return
    if _device_foldable(leaf, agg.kind):
        vals = span.values()
        keep = span.valid()
        if mask is not None:
            m = mask.dev(vals.device)
            keep = m if keep is None else keep & m
        _device_fold(acc, leaf, vals if keep is None else vals[keep])
        AGG["device_folds"] += 1
        return
    AGG["host_folds_sum_sq" if agg.kind == "sum_sq"
        and leaf.physical_type in (Type.INT32, Type.INT64)
        else "host_folds_values"] += 1
    vals, valid = span.host()
    acc.add_values(_present_order_values(
        leaf, vals, valid, None if mask is None else mask.host))


# ---------------------------------------------------------------------------
# order-domain values of host spans (the host folds)
# ---------------------------------------------------------------------------


def _present_order_values(leaf, vals, valid, mask=None):
    """Order-domain values of the present rows of a row-aligned host span,
    those of ``mask`` only if given: a numpy array for fixed-width columns
    (unsigned ints in the unsigned view), a list for BYTE_ARRAY, FLBA and
    decimal byte keys."""
    from ..algebra.compare import decode_order_value, is_unsigned
    from ..schema.types import LogicalKind

    decimal = leaf.logical_kind == LogicalKind.DECIMAL
    if isinstance(vals, list):
        idx = range(len(vals)) if mask is None else np.flatnonzero(mask)
        out = []
        for i in idx:
            v = vals[i]
            if v is None:
                continue
            out.append(decode_order_value(bytes(v), leaf) if decimal
                       else bytes(v))
        return out
    arr = np.asarray(vals)
    if arr.ndim == 2 and arr.dtype == np.uint8:  # FLBA (n, width) rows
        rows = range(len(arr)) if mask is None else np.flatnonzero(mask)
        out = []
        for i in rows:
            if valid is not None and not valid[i]:
                continue
            out.append(decode_order_value(bytes(arr[i]), leaf))
        return out
    if mask is not None:
        arr = arr[mask]
        valid = None if valid is None else np.asarray(valid, bool)[mask]
    if valid is not None:
        arr = arr[np.asarray(valid, bool)]
    if is_unsigned(leaf) and arr.dtype in (np.dtype(np.int32),
                                           np.dtype(np.int64)):
        arr = arr.view(np.uint32 if arr.dtype == np.dtype(np.int32)
                       else np.uint64)
    return arr


def _present_count(vals, valid, mask=None) -> int:
    """The non-null rows of a host span (under ``mask`` if given)."""
    if isinstance(vals, list):
        idx = range(len(vals)) if mask is None else np.flatnonzero(mask)
        return sum(1 for i in idx if vals[i] is not None)
    if valid is None:
        return int(mask.sum()) if mask is not None else len(vals)
    v = np.asarray(valid, bool)
    return int((v & mask).sum() if mask is not None else v.sum())


def _dict_order_entries(leaf, host_dict):
    """Dictionary entries in the order domain: a list for byte forms, a
    numpy array (unsigned view) for fixed width."""
    from ..algebra.compare import decode_order_value, is_unsigned
    from ..schema.types import LogicalKind

    decimal = leaf.logical_kind == LogicalKind.DECIMAL
    if isinstance(host_dict, tuple):  # (uint8 values, offsets)
        hv, ho = np.asarray(host_dict[0]), np.asarray(host_dict[1])
        out = []
        for i in range(len(ho) - 1):
            raw = bytes(hv[ho[i]:ho[i + 1]])
            out.append(decode_order_value(raw, leaf) if decimal else raw)
        return out
    arr = np.asarray(host_dict)
    if arr.ndim == 2 and arr.dtype == np.uint8:  # FLBA entries
        return [decode_order_value(bytes(r), leaf) for r in arr]
    if is_unsigned(leaf) and arr.dtype in (np.dtype(np.int32),
                                           np.dtype(np.int64)):
        arr = arr.view(np.uint32 if arr.dtype == np.dtype(np.int32)
                       else np.uint64)
    return arr


def _host_dictionary(col):
    """A dictionary-form column's dictionary on the host (one copy back
    of a dictionary-sized tensor or pair)."""
    AGG["dict_copies_back"] += 1
    d = col.dictionary
    if isinstance(d, tuple):
        return d[0].cpu().numpy(), d[1].cpu().numpy()
    return d.cpu().numpy()


# ---------------------------------------------------------------------------
# the per-row-group reader
# ---------------------------------------------------------------------------


class _RgReader:
    """Decoded access to one row group on ``device``: spans of the exact
    tier (memoized) and the dictionary-form chunks of the dictionary tier,
    each read admitted through the read gate.  ``decoded``,
    ``dict_used`` and ``dict_partial_used`` feed the tier accounting."""

    def __init__(self, pf, rg, device):
        self.pf = pf
        self.rg = rg
        self.device = device
        self.decoded = False
        self.dict_used = False
        self.dict_partial_used = False
        self._memo: Dict[tuple, _Span] = {}
        self._whole: Dict[int, object] = {}  # column -> whole-chunk column
        self._dictcol: Dict[int, object] = {}  # column -> dict col / None
        self._entries: Dict[int, object] = {}  # column -> order entries
        self._counts: Dict[int, np.ndarray] = {}  # column -> entry counts
        self._admission = read_admission()

    def _span_bytes(self, leaf, count: int) -> int:
        meta = self.pf.metadata.row_groups[self.rg.index]
        tot = meta.columns[leaf.column_index].meta_data \
            .total_uncompressed_size or 0
        return int(tot * count / max(self.rg.num_rows, 1))

    def span(self, leaf, start: int, count: int) -> _Span:
        """Local rows ``[start, start + count)`` of ``leaf``, decoded on
        the device from the pages that cover them."""
        from ..parallel.device_reader import decode_chunk_span
        from .search import pages_and_base

        key = (leaf.column_index, start, count)
        got = self._memo.get(key)
        if got is None:
            self.decoded = True
            whole = self._whole.get(leaf.column_index)
            if whole is not None:
                # a failed dictionary-tier probe decoded the whole chunk:
                # trim it instead of decoding the rows again
                got = _Span(leaf, whole, start, count)
            else:
                chunk = self.rg.column(leaf.column_index)
                with self._admission.admit(self._span_bytes(leaf, count),
                                           tier="scan"):
                    if start == 0 and count == self.rg.num_rows:
                        pages, first = None, 0
                    else:
                        pages, first = pages_and_base(chunk, start,
                                                      start + count)
                    col = decode_chunk_span(chunk, self.device, pages=pages)
                AGG["spans_decoded"] += 1
                got = _Span(leaf, col, start - first, count)
            self._memo[key] = got
        return got

    def aligned(self, leaf, start: int, count: int):
        """``(values, validity)`` on the host for local rows ``[start,
        start + count)``."""
        return self.span(leaf, start, count).host()

    def dict_column(self, leaf):
        """The chunk in dictionary form on the device, or None where it is
        not fully dictionary-encoded (the dictionary tier's gate), checked
        against the footer's encodings first so that a plain chunk costs
        no decode here."""
        from ..parallel.device_reader import decode_chunk_span

        if not env_bool("PARQUET_TPU_TORCH_AGG_DICT"):
            return None
        if leaf.column_index in self._dictcol:
            col = self._dictcol[leaf.column_index]
            if col is not None:
                self.dict_used = True
            return col
        chunk = self.rg.column(leaf.column_index)
        dict_encs = {Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY}
        if not any(Encoding(e) in dict_encs
                   for e in (chunk.meta.encodings or [])):
            self._dictcol[leaf.column_index] = None
            return None
        with self._admission.admit(
                chunk.meta.total_uncompressed_size or 0, tier="scan"):
            col = decode_chunk_span(chunk, self.device, keep_dictionary=True)
        AGG["dict_chunks"] += 1
        if not col.is_dictionary_encoded():
            # a mixed chunk (its dictionary fell back to PLAIN): keep the
            # decode, which the exact tier trims
            self._whole[leaf.column_index] = col
            self._dictcol[leaf.column_index] = None
            return None
        self.dict_used = True
        self._dictcol[leaf.column_index] = col
        return col

    def dict_entries(self, leaf, col):
        """Order-domain dictionary entries, once a column."""
        got = self._entries.get(leaf.column_index)
        if got is None:
            got = _dict_order_entries(leaf, _host_dictionary(col))
            self._entries[leaf.column_index] = got
        return got

    def dict_counts(self, leaf, col, n_entries: int) -> np.ndarray:
        """Each dictionary entry's count over the whole chunk, counted on
        the device (one dictionary-sized copy back a column)."""
        got = self._counts.get(leaf.column_index)
        if got is None:
            got = _entry_counts(col.dict_indices, n_entries)
            self._counts[leaf.column_index] = got
        return got


def _entry_counts(idx: torch.Tensor, n_entries: int) -> np.ndarray:
    AGG["dict_copies_back"] += 1
    return torch.bincount(idx.to(torch.int64),
                          minlength=n_entries).cpu().numpy()


# ---------------------------------------------------------------------------
# page-interval classification (tier 2)
# ---------------------------------------------------------------------------


def _pred_intervals(pf, rg, pred) -> Tuple[Optional[_Intervals], _Intervals]:
    """One leaf's (may, covered) row intervals from its page index: ``may``
    None where no index narrows it; ``covered`` the rows the zone maps
    prove all-match."""
    from .faults import read_context
    from .search import page_row_spans, pred_cover_page_ords

    if _stats_covers(pred, rg):
        return None, [(0, rg.num_rows)]
    chunk = rg.column(pred.leaf.column_index)
    with read_context(path=pf._path, row_group=rg.index,
                      column=pred.path, kinds=(CorruptedError, OSError)):
        ci = chunk.column_index()
        oi = chunk.offset_index()
    if ci is None or oi is None or not oi.page_locations:
        return None, []
    spans = page_row_spans(oi, rg.num_rows)
    may = _merge_intervals([spans[o] for o in _pred_page_ords(pred, ci)])
    cov = _merge_intervals(
        [spans[o] for o in pred_cover_page_ords(pred, ci, pred.leaf, spans)])
    return may, cov


def _tree_intervals2(pf, rg, expr) -> Tuple[Optional[_Intervals],
                                            Optional[_Intervals]]:
    """(may, covered) folded through the tree: And intersects both, Or
    unions both; None is the whole row group (for ``covered``, proven full
    coverage)."""
    if isinstance(expr, Const):
        full = None if expr.value else []
        return full, full
    from ..algebra.expr import And, Pred

    if isinstance(expr, Pred):
        return _pred_intervals(pf, rg, expr)

    def isect(a, b):  # None: the whole row group
        if a is None:
            return b
        if b is None:
            return a
        return _intersect_intervals(a, b)

    if isinstance(expr, And):
        may: Optional[_Intervals] = None
        cov: Optional[_Intervals] = None
        first = True
        for c in expr.children:
            m, v = _tree_intervals2(pf, rg, c)
            may = isect(may, m)
            cov = v if first else isect(cov, v)
            first = False
        return may, cov
    may_acc: _Intervals = []
    cov_acc: _Intervals = []
    may_full = cov_full = False
    for c in expr.children:
        m, v = _tree_intervals2(pf, rg, c)
        if m is None:
            may_full = True
        else:
            may_acc.extend(m)
        if v is None:
            cov_full = True
        else:
            cov_acc.extend(v)
    return (None if may_full else _merge_intervals(may_acc),
            None if cov_full else _merge_intervals(cov_acc))


def _decompose_col(pf, rg, leaf, intervals: _Intervals):
    """Split ``intervals`` along one column's page grid: ``(full page
    ordinals, remainder intervals, spans, column index)``: pages wholly
    inside an interval answer from their zone maps, the boundary rows
    decode."""
    from .faults import read_context
    from .search import page_row_spans

    chunk = rg.column(leaf.column_index)
    with read_context(path=pf._path, row_group=rg.index,
                      column=leaf.name, kinds=(CorruptedError, OSError)):
        ci = chunk.column_index()
        oi = chunk.offset_index()
    if ci is None or oi is None or not oi.page_locations:
        return [], list(intervals), None, None
    spans = page_row_spans(oi, rg.num_rows)
    full: List[int] = []
    rem: _Intervals = []
    for s, e in intervals:
        for o, (ps, pe) in enumerate(spans):
            if pe <= s or ps >= e:
                continue
            if ps >= s and pe <= e:
                full.append(o)
            else:
                rem.append((max(ps, s), min(pe, e)))
    return full, _merge_intervals(rem), spans, ci


# ---------------------------------------------------------------------------
# the per-row-group resolver
# ---------------------------------------------------------------------------


def _exact_stats(leaf) -> bool:
    return leaf.physical_type in _EXACT_STAT_TYPES


def _page_bounds(ci, leaf, ords):
    """(mins, maxs, null counts, null pages) of the given page ordinals."""
    from .search import decoded_bounds

    mins, maxs = decoded_bounds(ci, leaf)
    nulls = list(ci.null_pages or [])
    ncounts = ci.null_counts
    return ([mins[o] if o < len(mins) else None for o in ords],
            [maxs[o] if o < len(maxs) else None for o in ords],
            [None if ncounts is None else ncounts[o] for o in ords],
            [nulls[o] if o < len(nulls) else False for o in ords])


def _resolve_rg(pf, rg, expr, aggs: Sequence[AggExpr], leaves, group_leaf,
                device, pslots: int = 0):
    """Resolve one row group into fresh accumulator deltas: ``(tier, accs,
    groups, note)``, ``accs`` None where the group contributes nothing.
    Raises CorruptedError/DeadlineError for the caller's policy; nothing
    merges on failure, so a skipped group drops whole.  With ``pslots``
    of 2 or more (a remote source's connection slots), the disjoint byte
    ranges the resolution will read are fetched at once first."""
    alive, killer = _eval_tree(expr, lambda p: _stats_alive(p, rg))
    if not alive:
        note = f"pruned by stats ({killer!r})" if killer is not None \
            else "pruned by stats"
        return "stats", None, None, note
    covered = _tree_covers(expr, lambda p: _stats_covers(p, rg))
    reader = _RgReader(pf, rg, device)
    accs = [_Acc(a, leaves[i]) for i, a in enumerate(aggs)]
    groups: Optional[dict] = {} if group_leaf is not None else None
    if covered:
        with _prewarmed(pf, rg, expr, aggs, leaves, group_leaf, pslots,
                        True, None, None, None):
            if group_leaf is not None:
                _group_full(pf, rg, reader, aggs, leaves, group_leaf,
                            groups)
            else:
                for acc in accs:
                    _contrib_full(pf, rg, reader, acc)
        tier = ("decoded" if reader.decoded
                else "dict" if reader.dict_used else "stats")
        return tier, accs, groups, f"covered, answered by {tier}"
    # ---- tier 2: page-interval classification
    may, cov = _tree_intervals2(pf, rg, expr)
    may = may if may is not None else [(0, rg.num_rows)]
    if not may:
        return "pages", None, None, "pruned by pages"
    cov = may if cov is None else _intersect_intervals(cov, may)
    contended = _subtract_intervals(may, cov)
    cursors = None
    with _prewarmed(pf, rg, expr, aggs, leaves, group_leaf, pslots, False,
                    may, cov, contended):
        if group_leaf is None and not any(a.kind == "top_k" for a in aggs):
            cursors = _fused_cursors(rg, reader, expr, accs, cov, contended)
        if cursors is not None:
            from .fused import _H_FOLD_S, count_fused

            t0 = time.perf_counter()
            masks = _contended_masks_fused(expr, cursors, contended)
            for acc in accs:
                _contrib_partial(pf, rg, reader, acc, cov, masks,
                                 cursors=cursors)
            if any(c.touched for c in cursors.values()):
                reader.decoded = True
            count_fused("rg_folds")
            _H_FOLD_S.observe(time.perf_counter() - t0)
        else:
            masks = _contended_masks(expr, reader, contended)
            if group_leaf is not None:
                _group_partial(reader, aggs, leaves, group_leaf, groups,
                               cov, masks)
            else:
                for acc in accs:
                    _contrib_partial(pf, rg, reader, acc, cov, masks)
    tier = ("dict_partial" if reader.dict_partial_used
            else "decoded" if reader.decoded else "pages")
    note = (f"partial: {_iv_rows(cov)} covered + "
            f"{_iv_rows(contended)} contended rows, answered by {tier}"
            + (" (fused)" if cursors is not None else ""))
    return tier, accs, groups, note


def _page_span_ranges(pf, rg, leaf, intervals: _Intervals,
                      out: set) -> None:
    """Add the byte ranges the reads of ``intervals`` of ``leaf`` will
    pread to ``out``: one span of pages an interval (``io/search.py::
    seek_pages``'s arithmetic) and the dictionary page, or the whole
    chunk without an offset index."""
    from bisect import bisect_left, bisect_right

    if not intervals:
        return
    chunk = rg.column(leaf.column_index)
    oi = chunk.offset_index()
    if oi is None or not oi.page_locations:
        out.add(chunk.byte_range)
        return
    locs = oi.page_locations
    firsts = [pl.first_row_index for pl in locs]
    added = False
    for s, e in intervals:
        i0 = max(bisect_right(firsts, s) - 1, 0)
        i1 = min(bisect_left(firsts, e, lo=i0), len(locs))
        if i1 <= i0:
            continue
        start = locs[i0].offset
        end = locs[i1 - 1].offset + locs[i1 - 1].compressed_page_size
        out.add((start, end - start))
        added = True
    dict_off = chunk.meta.dictionary_page_offset
    if added and dict_off is not None and 0 < dict_off < locs[0].offset:
        out.add((dict_off, locs[0].offset - dict_off))


def _prewarm_ranges(pf, rg, expr, aggs, leaves, gleaf, covered: bool,
                    may: Optional[_Intervals], cov: Optional[_Intervals],
                    contended: Optional[_Intervals]) -> list:
    """The disjoint byte ranges the resolution of a row group will read:
    a column's intervals of every role (filter, aggregate, group key)
    merged, then byte spans that touch coalesced, so a page is fetched
    once (the JAX package's rule)."""
    full = [(0, rg.num_rows)]
    per_col: Dict[int, list] = {}

    def want(leaf, iv):
        if leaf is not None and iv:
            per_col.setdefault(leaf.column_index, []).extend(iv)

    if not covered:
        for p in _collect_preds(expr):
            want(p.leaf, contended)
    for a, leaf in zip(aggs, leaves):
        if leaf is None:
            continue
        if covered:
            if a.kind == "count":
                chunk = rg.column(leaf.column_index)
                st = chunk.statistics()
                if (st is not None and st.null_count is not None
                        and chunk.meta.num_values is not None):
                    continue  # the statistics answer it
                want(leaf, full)
            elif a.kind in ("min", "max"):
                st = rg.column(leaf.column_index).statistics()
                v = None if st is None else (
                    st.min_value if a.kind == "min" else st.max_value)
                if _exact_stats(leaf) and v is not None and v == v:
                    continue  # the statistics answer it
                want(leaf, full)
            elif a.kind in ("sum", "sum_sq", "count_distinct"):
                want(leaf, full)
            # top_k visits pages as its heap allows: left to the reads
        elif a.kind in ("sum", "sum_sq", "count_distinct"):
            want(leaf, may)
        elif a.kind in ("count", "min", "max"):
            # covered pages answer from their bounds; the boundary rows
            # and the contended ones decode
            _f, rem, _s, _ci = _decompose_col(pf, rg, leaf, cov or [])
            want(leaf, _merge_intervals(list(rem) + list(contended)))
        elif a.kind == "top_k":
            want(leaf, contended)
    if gleaf is not None:
        want(gleaf, full if covered else may)
    out: set = set()
    for ci, ivs in per_col.items():
        _page_span_ranges(pf, rg, pf.schema.leaves[ci],
                          _merge_intervals(ivs), out)
    merged: List[Tuple[int, int]] = []
    for off, size in sorted(out):
        if merged and off <= merged[-1][0] + merged[-1][1]:
            end = max(merged[-1][0] + merged[-1][1], off + size)
            merged[-1] = (merged[-1][0], end - merged[-1][0])
        else:
            merged.append((off, size))
    return merged


@contextlib.contextmanager
def _prewarmed(pf, rg, expr, aggs, leaves, gleaf, pslots: int, *roles):
    """A scope in which the file's preads are served from the row group's
    ranges (:func:`_prewarm_ranges` of ``roles``), fetched at once
    (``io/remote.py::parallel_preads``) under one grant of the read gate's
    scan tier; a plain scope without two slots or two ranges."""
    from .remote import parallel_preads
    from .source import PreloadedSource

    ranges = (_prewarm_ranges(pf, rg, expr, aggs, leaves, gleaf, *roles)
              if pslots >= 2 else [])
    if len(ranges) < 2:
        yield
        return
    with read_admission().admit(sum(sz for _, sz in ranges), tier="scan"):
        src = PreloadedSource(pf.source,
                              parallel_preads(pf.source, ranges, pslots))
        try:
            with pf._source_override(src):
                yield
        finally:
            src.close()


def _fused_cursors(rg, reader: _RgReader, expr, accs, cov: _Intervals,
                   contended: _Intervals):
    """A host :class:`~parquet_tpu_torch.io.fused.PageCursor` per needed
    leaf where the fused tier applies, else None: contended rows exist,
    every filter and aggregate leaf is flat with an offset index, and
    ``choose_fused`` elects it on the bytes the exact tier would decode
    for this ``device`` (never on a card under ``auto``)."""
    from .fused import FusedUnsupported, PageCursor, count_fused
    from .planner import choose_fused

    if not contended:
        return None
    need = {p.leaf.column_index: p.leaf for p in _collect_preds(expr)}
    crows = _iv_rows(contended)
    est = sum(reader._span_bytes(leaf, crows) for leaf in need.values())
    vrows = crows + _iv_rows(cov)
    for acc in accs:
        leaf = acc.leaf
        if acc.agg.path is None or leaf is None:
            continue
        if leaf.column_index not in need:
            est += reader._span_bytes(leaf, vrows)
            need[leaf.column_index] = leaf
    if not choose_fused(est, reader.device):
        return None
    try:
        return {ci: PageCursor(rg, leaf) for ci, leaf in need.items()}
    except FusedUnsupported:
        count_fused("fallbacks")
        return None


def _contended_masks_fused(expr, cursors, contended: _Intervals
                           ) -> Dict[Tuple[int, int], _Mask]:
    """The exact mask of each contended interval, its filter pages
    evaluated block by block on the union page grid (each block lies in
    one page of each filter column), one decoded page alive a column."""
    from ..parallel.host_scan import expr_mask

    if not contended:
        return {}
    fleaves = {p.path: p.leaf for p in _collect_preds(expr)}
    out = {}
    for s, e in contended:
        mask = np.empty(e - s, bool)
        cuts = sorted({c for leaf in fleaves.values()
                       for c in cursors[leaf.column_index].grid(s, e)})
        bounds = [s] + cuts + [e]
        for bs, be in zip(bounds, bounds[1:]):
            env = {path: cursors[leaf.column_index].aligned(bs, be)
                   for path, leaf in fleaves.items()}
            mask[bs - s:be - s] = expr_mask(expr, env, be - bs)
        out[(s, e)] = _Mask(mask)
    return out


def _contended_masks(expr, reader: _RgReader, contended: _Intervals
                     ) -> Dict[Tuple[int, int], _Mask]:
    """The exact mask of each contended interval: the filter columns
    decode on the device and come back once an interval, and the scan's
    own ``expr_mask`` evaluates them."""
    from ..parallel.host_scan import expr_mask

    if not contended:
        return {}
    fleaves = {p.path: p.leaf for p in _collect_preds(expr)}
    out = {}
    for s, e in contended:
        env = {path: reader.aligned(leaf, s, e - s)
               for path, leaf in fleaves.items()}
        out[(s, e)] = _Mask(expr_mask(expr, env, e - s))
    return out


def _contrib_full(pf, rg, reader: _RgReader, acc: _Acc) -> None:
    """One aggregate over a fully covered row group: statistics first,
    the dictionary tier next, the exact decode last."""
    agg, leaf = acc.agg, acc.leaf
    if agg.kind == "count" and agg.path is None:
        acc.add_count(rg.num_rows)
        return
    chunk = rg.column(leaf.column_index)
    st = chunk.statistics()
    nv = chunk.meta.num_values
    nulls = st.null_count if st is not None else None
    if agg.kind == "count":
        if nv is not None and nulls is not None:
            acc.add_count(nv - nulls)
            return
    elif agg.kind in ("min", "max") and _exact_stats(leaf) \
            and st is not None:
        v = st.min_value if agg.kind == "min" else st.max_value
        if v is not None and v == v:  # a NaN bound descends instead
            acc.add_bound(v)
            return
        if nv is not None and nulls is not None and nulls >= nv:
            return  # an all-null chunk contributes nothing
    # ---- dictionary tier
    if agg.kind in ("min", "max", "sum", "sum_sq", "count_distinct",
                    "count"):
        col = reader.dict_column(leaf)
        if col is not None:
            _dict_contrib(reader, acc, leaf, col)
            return
    # ---- exact decode (top_k with page-bound pruning)
    if agg.kind == "top_k":
        _topk_intervals(pf, rg, reader, acc, [(0, rg.num_rows)])
        return
    _fold_span(acc, reader.span(leaf, 0, rg.num_rows))


def _dict_contrib(reader: _RgReader, acc: _Acc, leaf, col) -> None:
    """An aggregate over a dictionary-form chunk without expanding its
    values: counts per entry on the device, the fold over the entries on
    the host."""
    if acc.agg.kind == "count":
        _dict_fold(acc, None, col.dict_indices)
        return
    entries = reader.dict_entries(leaf, col)
    _fold_entry_counts(acc, entries,
                       reader.dict_counts(leaf, col, len(entries)))


def _dict_fold(acc: _Acc, entries, idx: torch.Tensor) -> None:
    """Fold a slice of a chunk's dictionary indexes (dense over its
    present slots): shared by the whole-chunk and the partial-coverage
    dictionary tiers."""
    if acc.agg.kind == "count":
        acc.add_count(idx.shape[0])  # indexes are dense over present slots
        return
    if idx.shape[0] == 0:
        return
    _fold_entry_counts(acc, entries, _entry_counts(idx, len(entries)))


def _fold_entry_counts(acc: _Acc, entries, counts: np.ndarray) -> None:
    """Fold each dictionary entry ``counts`` times, exactly as the JAX
    package folds its index stream: sums as counts times entries (Python
    ints for integers), the other kinds over the entries used."""
    agg = acc.agg
    AGG["dict_folds"] += 1
    if agg.kind in ("sum", "sum_sq"):
        sq = agg.kind == "sum_sq"
        if isinstance(entries, np.ndarray) and entries.dtype.kind == "f":
            e = np.asarray(entries, np.float64)
            c = counts[:len(e)].astype(np.float64)
            acc.add_sum(float(np.dot(c, e * e if sq else e)))
        else:
            ent = entries.tolist() if isinstance(entries, np.ndarray) \
                else entries
            acc.add_sum(sum(int(c) * (int(v) * int(v) if sq else int(v))
                            for c, v in zip(counts.tolist(), ent) if c))
        return
    used = np.flatnonzero(counts)
    if isinstance(entries, np.ndarray):
        acc.add_values(entries[used])
    else:
        acc.add_values([entries[i] for i in used.tolist()])


def _contrib_partial(pf, rg, reader: _RgReader, acc: _Acc,
                     cov: _Intervals, masks, cursors=None) -> None:
    """One aggregate over a partly covered row group: covered intervals
    answer from page bounds where provable (or from the index stream of a
    dictionary chunk), contended intervals decode under their exact mask.
    With ``cursors`` (the fused tier) every remaining decode streams a page
    at a time through the column's host cursor."""
    agg, leaf = acc.agg, acc.leaf
    if agg.kind == "count" and agg.path is None:
        acc.add_count(_iv_rows(cov))
        for m in masks.values():
            acc.add_count(m.count)
        return
    cur = None if cursors is None or leaf is None \
        else cursors.get(leaf.column_index)
    if agg.kind == "top_k":
        _topk_intervals(pf, rg, reader, acc, cov)
        for (s, e), m in masks.items():
            _fold_span(acc, reader.span(leaf, s, e - s), m)
        return
    # ---- covered intervals
    if cov:
        if agg.kind in ("count", "min", "max"):
            full, rem, spans, ci = _decompose_col(pf, rg, leaf, cov)
            if full:
                mins, maxs, ncounts, nullp = _page_bounds(ci, leaf, full)
                for o, mn, mx, nc, npg in zip(full, mins, maxs, ncounts,
                                              nullp):
                    rows = spans[o][1] - spans[o][0]
                    if agg.kind == "count":
                        if nc is None and not npg:
                            rem.append(spans[o])  # nulls unknown: decode
                        else:
                            acc.add_count(0 if npg else rows - (nc or 0))
                    else:
                        if npg:
                            continue  # an all-null page adds nothing
                        v = mn if agg.kind == "min" else mx
                        if v is None or not _exact_stats(leaf) or v != v:
                            rem.append(spans[o])  # inexact bound: decode
                        else:
                            acc.add_bound(v)
            rem = _merge_intervals(rem)
        else:
            rem = cov  # sum / distinct need the values
        if rem:
            rem = _dict_partial_fold(reader, acc, rem)
        for s, e in rem:
            if cur is not None:
                AGG["host_folds_fused"] += 1
                for _o, _bs, _be, vals, valid in cur.blocks(s, e):
                    if agg.kind == "count":
                        acc.add_count(_present_count(vals, valid))
                    else:
                        acc.add_values(
                            _present_order_values(leaf, vals, valid))
                continue
            _fold_span(acc, reader.span(leaf, s, e - s))
    # ---- contended intervals (exact mask)
    for (s, e), m in masks.items():
        if cur is not None:
            AGG["host_folds_fused"] += 1
            _fold_masked_interval(cur, acc, s, e, m.host)
            continue
        _fold_span(acc, reader.span(leaf, s, e - s), m)


def _dict_partial_fold(reader: _RgReader, acc: _Acc,
                       rem: _Intervals) -> _Intervals:
    """The partial-coverage dictionary tier: covered intervals of a fully
    dictionary-encoded chunk fold off its index stream (validity prefix
    sums map rows to index positions, on the device).  Returns the
    intervals still to decode: none where the dictionary answered."""
    leaf = acc.leaf
    if acc.agg.kind not in ("count", "min", "max", "sum", "sum_sq",
                            "count_distinct"):
        return rem
    col = reader.dict_column(leaf)
    if col is None:
        return rem
    idx = col.dict_indices
    entries = None if acc.agg.kind == "count" \
        else reader.dict_entries(leaf, col)
    if col.validity is None:
        bounds = [(s, e) for s, e in rem]
    else:
        prefix = torch.zeros(col.validity.shape[0] + 1, dtype=torch.int64,
                             device=idx.device)
        torch.cumsum(col.validity.to(torch.int64), 0, out=prefix[1:])
        at = torch.tensor([x for iv in rem for x in iv], dtype=torch.int64,
                          device=idx.device)
        flat = prefix[at].tolist()
        bounds = list(zip(flat[0::2], flat[1::2]))
    for st, en in bounds:
        _dict_fold(acc, entries, idx[st:en])
    reader.dict_partial_used = True
    return []


def _masked_order_values(leaf, dec, cursor):
    """A masked-emit decode result in the order-domain form
    ``_present_order_values`` gives, so that fused folds equal the
    materializing ones (``dec`` is dense over the selected present rows)."""
    from ..ops.encodings import DictIndices

    if isinstance(dec, DictIndices):
        entries = getattr(cursor, "_agg_entries", None)
        if entries is None:
            entries = _dict_order_entries(leaf, cursor.dictionary())
            cursor._agg_entries = entries
        idx = np.asarray(dec.indices)
        if isinstance(entries, np.ndarray):
            return entries[idx]
        return [entries[i] for i in idx.tolist()]
    if isinstance(dec, tuple):  # (uint8 values, offsets) byte arrays
        hv, ho = np.asarray(dec[0]), np.asarray(dec[1])
        out = [bytes(hv[ho[i]:ho[i + 1]]) for i in range(len(ho) - 1)]
        return _present_order_values(leaf, out, None)
    return _present_order_values(leaf, np.asarray(dec), None)


def _fold_masked_interval(cursor, acc: _Acc, s: int, e: int,
                          m: np.ndarray) -> None:
    """Fold the contended interval ``[s, e)`` through the cursor's
    masked-emit decode, a page at a time: a page the mask never selects
    is not decoded, and a page that cannot masked-decode decodes whole."""
    agg, leaf = acc.agg, acc.leaf
    for o in cursor.ordinals(s, e):
        ps, pe = cursor.spans[o]
        bs, be = max(ps, s), min(pe, e)
        sub = m[bs - s:be - s]
        if not sub.any():
            continue  # this page never decodes
        sel = np.zeros(pe - ps, bool)
        sel[bs - ps:be - ps] = sub
        dec, present = cursor.masked_values(o, sel)
        if dec is None and present == 0:
            continue  # every selected row is null
        if dec is None:  # one page decoded whole
            from .search import _trim_host

            vals, valid = _trim_host(cursor.page(o), bs - ps, be - bs, True)
            if agg.kind == "count":
                acc.add_count(_present_count(vals, valid, sub))
            else:
                acc.add_values(
                    _present_order_values(leaf, vals, valid, sub))
            continue
        if agg.kind == "count":
            acc.add_count(present)
        else:
            acc.add_values(_masked_order_values(leaf, dec, cursor))


def _topk_intervals(pf, rg, reader: _RgReader, acc: _Acc,
                    intervals: _Intervals) -> None:
    """Top-k over unfiltered intervals: pages are visited best bound first
    and decode only while they still contend with the running k-th
    value."""
    leaf = acc.leaf
    full, rem, spans, ci = _decompose_col(pf, rg, leaf, intervals)
    for s, e in rem:  # boundary rows always decode
        _fold_span(acc, reader.span(leaf, s, e - s))
    if not full or ci is None:
        return
    mins, maxs, _nc, nullp = _page_bounds(ci, leaf, full)
    order = []
    for o, mn, mx, npg in zip(full, mins, maxs, nullp):
        if npg:
            continue
        order.append((o, mx if acc.agg.largest else mn))
    known = [(o, b) for o, b in order if b is not None]
    unknown = [(o, b) for o, b in order if b is None]
    try:
        known.sort(key=lambda ob: ob[1], reverse=acc.agg.largest)
    except TypeError:
        pass  # incomparable bounds: page order, still exact
    for o, bound in known + unknown:
        if not acc.topk_contends(bound):
            continue  # the page cannot improve the running top-k
        s, e = spans[o]
        _fold_span(acc, reader.span(leaf, s, e - s))


# ---------------------------------------------------------------------------
# group-by (on the host, over spans decoded on the device)
# ---------------------------------------------------------------------------


def _group_accs(aggs, leaves):
    return [_Acc(a, leaves[i]) for i, a in enumerate(aggs)]


def _take_span(vals, valid, idx: np.ndarray):
    """Row-aligned host ``(values, validity)`` gathered at ``idx``."""
    if isinstance(vals, list):
        return [vals[i] for i in idx], None  # lists carry None at nulls
    sub = np.asarray(vals)[idx]
    return sub, (None if valid is None else np.asarray(valid, bool)[idx])


def _fold_group_sel(groups: dict, aggs, leaves, key, sel: np.ndarray,
                    col_spans) -> None:
    """Fold the selected rows of one group into its accumulators."""
    AGG["host_folds_group_by"] += 1
    accs = groups.get(key)
    if accs is None:
        accs = groups[key] = _group_accs(aggs, leaves)
    for ai, (agg, acc) in enumerate(zip(aggs, accs)):
        if agg.kind == "count" and agg.path is None:
            acc.add_count(len(sel))
            continue
        vals, valid = _take_span(*col_spans[ai], sel)
        if agg.kind == "count":
            acc.add_count(_present_count(vals, valid))
        else:
            acc.add_values(_present_order_values(leaves[ai], vals, valid))


def _fold_group_codes(groups: dict, aggs, leaves, codes: np.ndarray,
                      keys: list, sel: np.ndarray, col_spans) -> None:
    """Fold selected rows by group: ``codes[i]`` indexes ``keys`` (the
    canonical group keys, None the null group) for selected row
    ``sel[i]``.  One stable sort, then a run a code, so each group sees its
    rows in row order."""
    if not len(codes):
        return
    order = np.argsort(codes, kind="stable")
    cuts = np.flatnonzero(np.diff(codes[order])) + 1
    for run in np.split(order, cuts):
        _fold_group_sel(groups, aggs, leaves, keys[int(codes[run[0]])],
                        sel[run], col_spans)


def _group_codes(group_leaf, span: _Span, sel: np.ndarray) -> tuple:
    """``(codes, keys)`` of the selected rows of the group column's span:
    a dictionary-form byte-array span by its indexes (copied back, never
    its bytes), a numeric one by ``np.unique`` of its values, anything
    else a key a row as the JAX package makes them."""
    from ..algebra.compare import is_unsigned

    col = span.col
    if col.is_dictionary_encoded():
        AGG["copies_back"] += 1
        rows = torch.full((col.num_slots,), -1, dtype=torch.int32,
                          device=col.dict_indices.device)
        if col.validity is None:
            rows = col.dict_indices.to(torch.int32)
        else:
            rows.masked_scatter_(col.validity, col.dict_indices.to(
                torch.int32))
        idx = rows[span.off:span.off + span.n].cpu().numpy()[sel]
        entries = _dict_order_entries(group_leaf, _host_dictionary(col))
        keys = [_canon_key(v) for v in (entries.tolist()
                                        if isinstance(entries, np.ndarray)
                                        else entries)] + [None]
        codes = np.where(idx < 0, len(keys) - 1, idx).astype(np.int64)
        return codes, keys
    vals, valid = span.host()
    arr = None if isinstance(vals, list) else np.asarray(vals)
    if arr is not None and arr.ndim == 1:
        if is_unsigned(group_leaf) and arr.dtype in (np.dtype(np.int32),
                                                     np.dtype(np.int64)):
            arr = arr.view(np.uint32 if arr.dtype == np.dtype(np.int32)
                           else np.uint64)
        present = (np.ones(len(sel), bool) if valid is None
                   else np.asarray(valid, bool)[sel])
        uniq, inv = np.unique(arr[sel][present], return_inverse=True)
        keys = [_canon_key(v) for v in uniq.tolist()] + [None]
        codes = np.full(len(sel), len(keys) - 1, np.int64)
        codes[present] = inv.reshape(-1)
        return codes, keys
    row_keys = _group_keys_for_rows(group_leaf, vals, valid, sel)
    index: dict = {}
    codes = np.fromiter((index.setdefault(k, len(index)) for k in row_keys),
                        np.int64, len(row_keys))
    return codes, list(index)


def _group_keys_for_rows(group_leaf, vals, valid, rows) -> list:
    """The order-domain group key of each selected row (None: null)."""
    from ..algebra.compare import decode_order_value
    from ..schema.types import LogicalKind

    decimal = group_leaf.logical_kind == LogicalKind.DECIMAL
    out = []
    if isinstance(vals, list):
        for r in rows:
            v = vals[r]
            out.append(None if v is None
                       else (decode_order_value(bytes(v), group_leaf)
                             if decimal else bytes(v)))
        return out
    arr = np.asarray(vals)
    for r in rows:
        if valid is not None and not valid[r]:
            out.append(None)
        elif arr.ndim == 2 and arr.dtype == np.uint8:  # FLBA rows
            out.append(decode_order_value(bytes(arr[r]), group_leaf))
        else:
            out.append(_canon_key(arr[r].tolist()))
    return out


def _agg_spans(reader: _RgReader, aggs, leaves, s: int, n: int) -> list:
    return [None if (a.kind == "count" and a.path is None)
            else reader.aligned(leaves[i], s, n)
            for i, a in enumerate(aggs)]


def _group_full(pf, rg, reader: _RgReader, aggs, leaves, group_leaf,
                groups: dict) -> None:
    """Group-by over a fully covered row group.  A dictionary-encoded
    group column takes the dictionary tier: group ids come from its index
    stream and its rows never materialize."""
    col = reader.dict_column(group_leaf)
    n = rg.num_rows
    col_spans = _agg_spans(reader, aggs, leaves, 0, n)
    if n == 0:
        return
    if col is not None:
        span = _Span(group_leaf, col, 0, n)
    else:
        span = reader.span(group_leaf, 0, n)
    sel = np.arange(n, dtype=np.int64)
    codes, keys = _group_codes(group_leaf, span, sel)
    _fold_group_codes(groups, aggs, leaves, codes, keys, sel, col_spans)


def _group_partial(reader: _RgReader, aggs, leaves, group_leaf,
                   groups: dict, cov: _Intervals, masks) -> None:
    """Group-by over a partly covered row group: each covered interval
    whole, each contended one under its mask."""
    units = [((s, e), None) for s, e in cov] + \
        [((s, e), m.host) for (s, e), m in masks.items()]
    for (s, e), m in units:
        n = e - s
        sel = np.arange(n, dtype=np.int64) if m is None \
            else np.flatnonzero(m)
        if not len(sel):
            continue
        codes, keys = _group_codes(group_leaf,
                                   reader.span(group_leaf, s, n), sel)
        col_spans = _agg_spans(reader, aggs, leaves, s, n)
        _fold_group_codes(groups, aggs, leaves, codes, keys, sel, col_spans)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


class AggregateResult:
    """Mapping from aggregate name (``"sum(v)"``) to its value, or, for a
    group-by, ``res.groups`` (order-domain keys, the null group last) with
    each name mapping to a key-aligned list.  ``counters`` holds the
    per-tier accounting and :meth:`explain` the per-row-group trace."""

    def __init__(self, data: dict, groups_keys, counters: Dict[str, int],
                 lines: List[str]):
        self.data = data
        self.groups = groups_keys  # None for ungrouped results
        self.counters = counters
        self.report = None
        self._lines = lines

    def __getitem__(self, name):
        return self.data[name]

    def __contains__(self, name) -> bool:
        return name in self.data

    def __iter__(self):
        return iter(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def keys(self):
        return self.data.keys()

    def items(self):
        return self.data.items()

    def explain(self) -> str:
        c = self.counters
        tail = (f"  tiers: stats={c['rg_answered_stats']} "
                f"pages={c['rg_answered_pages']} "
                f"dict={c['rg_answered_dict']} "
                f"dict_partial={c['rg_answered_dict_partial']} "
                f"decoded={c['rg_answered_decoded']}"
                + (f"; manifest-answered files="
                   f"{c['files_answered_manifest']}"
                   if c.get("files_answered_manifest") else "")
                + (f"; skipped rgs={c['rg_skipped_corrupt']}"
                   if c.get("rg_skipped_corrupt") else ""))
        return "\n".join(self._lines + [tail])

    def __repr__(self) -> str:
        return f"AggregateResult({self.data!r})"


# ---------------------------------------------------------------------------
# validation and finalization
# ---------------------------------------------------------------------------


def _validate(pf_schema, aggs, group_by) -> Tuple[list, object]:
    from ..schema.types import LogicalKind

    if not aggs:
        raise ValueError("aggregate needs at least one AggExpr "
                         "(parquet_tpu_torch.count/min_/max_/sum_/...)")
    leaves = []
    for a in aggs:
        if not isinstance(a, AggExpr):
            raise TypeError(f"expected an AggExpr, got {type(a).__name__} "
                            "(build with count()/min_()/sum_()/...)")
        if a.path is None:
            leaves.append(None)
            continue
        leaf = pf_schema.leaf(a.path)  # KeyError on unknown
        if leaf.max_repetition_level > 0:
            raise ValueError(f"column {a.path!r} is nested; aggregate "
                             "handles flat columns")
        if a.derived:  # expanded by the entry points before validation
            raise ValueError(
                f"{a.name} is a derived aggregate; evaluate it through "
                "ParquetFile.aggregate/Dataset.aggregate (which expand "
                "it over its base folds)")
        if a.kind in ("sum", "sum_sq"):
            numeric = leaf.physical_type in (
                Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE,
                Type.BOOLEAN)
            if not numeric and leaf.logical_kind != LogicalKind.DECIMAL:
                raise ValueError(
                    f"{a.name} is not defined for "
                    f"{leaf.physical_type.name} (non-decimal)")
        leaves.append(leaf)
    gleaf = None
    if group_by is not None:
        gleaf = pf_schema.leaf(group_by)
        if gleaf.max_repetition_level > 0:
            raise ValueError(f"group_by column {group_by!r} is nested")
        for a in aggs:
            if a.kind in ("count_distinct", "top_k"):
                raise ValueError(f"{a.name} is not supported with "
                                 "group_by")
    return leaves, gleaf


def _sort_group_keys(keys) -> list:
    """Non-null keys ascending, then the NaN group, then the null
    group."""
    nn = [k for k in keys
          if k is not None and not (isinstance(k, float) and k != k)]
    try:
        nn.sort()
    except TypeError:
        nn.sort(key=repr)
    has_nan = any(isinstance(k, float) and k != k for k in keys)
    return nn + ([_NAN_KEY] if has_nan else []) \
        + ([None] if any(k is None for k in keys) else [])


def _expand_derived(aggs):
    """Derived aggregates (avg/variance) expanded into the deduplicated
    base list the cascade evaluates, and the plan mapping each original
    aggregate to its base positions: ``(base_aggs, plan)``, ``plan`` None
    where nothing was derived."""
    aggs = list(aggs)
    if not any(isinstance(a, AggExpr) and a.derived for a in aggs):
        return aggs, None
    base: list = []
    index: dict = {}

    def want(node: AggExpr) -> int:
        got = index.get(node.name)
        if got is None:
            got = index[node.name] = len(base)
            base.append(node)
        return got

    plan = []
    for a in aggs:
        if not a.derived:
            plan.append(("base", want(a), None, a.name))
        else:
            parts = tuple(want(AggExpr(k, a.path))
                          for k in DERIVED_KINDS[a.kind])
            plan.append((a.kind, parts, a.ddof, a.name))
    return base, plan


def _derive_value(kind: str, vals, ddof):
    """``avg`` over (count, sum); ``variance`` over (count, sum,
    sum of squares): ``(sq - s * s / n) / (n - ddof)``.  None over no rows
    (or one, with Bessel's correction); NaN sums propagate."""
    if kind == "avg":
        n, s = vals
        if not n or s is None:
            return None
        return s / n
    n, s, sq = vals
    if not n or n - (ddof or 0) <= 0 or s is None or sq is None:
        return None
    n, s, sq = float(n), float(s), float(sq)
    v = (sq - s * s / n) / (n - (ddof or 0))
    # cancellation can leave a tiny negative on a constant column
    return max(v, 0.0) if v == v else v


def _apply_plan(plan, base_aggs, data: dict, grouped: bool) -> dict:
    """Base results mapped to the original request's keys, with the
    derived folds computed (element-wise over group lists)."""
    if plan is None:
        return data
    out = {}
    for kind, ref, ddof, name in plan:
        if kind == "base":
            out[name] = data[base_aggs[ref].name]
            continue
        cols = [data[base_aggs[i].name] for i in ref]
        if grouped:
            out[name] = [_derive_value(kind, vals, ddof)
                         for vals in zip(*cols)]
        else:
            out[name] = _derive_value(kind, tuple(cols), ddof)
    return out


def _finalize(aggs, accs, groups, counters, lines, report, plan=None):
    if groups is None:
        data = {a.name: acc.result() for a, acc in zip(aggs, accs)}
        out = AggregateResult(_apply_plan(plan, aggs, data, False),
                              None, counters, lines)
    else:
        keys = _sort_group_keys(list(groups))
        data = {a.name: [groups[k][i].result() for k in keys]
                for i, a in enumerate(aggs)}
        out = AggregateResult(_apply_plan(plan, aggs, data, True),
                              keys, counters, lines)
    out.report = report
    return out


# ---------------------------------------------------------------------------
# the partial state's wire codec (the JAX package's)
# ---------------------------------------------------------------------------
# A partial state serializes losslessly to JSON, so one package's state
# merges in the other's exactly like a local file's: ``None`` stays None,
# else ``[tag, payload]`` with b=bool, i=int as a string (exact at any
# magnitude), f=float as repr (NaN and inf round-trip), x=bytes as hex,
# s=str.


def _enc_wire(v):
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return ["b", 1 if v else 0]
    if isinstance(v, (int, np.integer)):
        return ["i", str(int(v))]
    if isinstance(v, (float, np.floating)):
        return ["f", repr(float(v))]
    if isinstance(v, (bytes, bytearray)):
        return ["x", bytes(v).hex()]
    if isinstance(v, str):
        return ["s", v]
    raise TypeError(f"unencodable aggregate-state value {v!r} "
                    f"({type(v).__name__})")


def _dec_wire(d):
    if d is None:
        return None
    try:
        tag, payload = d
        if tag == "b":
            return bool(payload)
        if tag == "i":
            return int(payload)
        if tag == "f":
            return float(payload)
        if tag == "x":
            return bytes.fromhex(payload)
        if tag == "s":
            return str(payload)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad aggregate-state wire value {d!r}: "
                         f"{e}") from e
    raise ValueError(f"bad aggregate-state wire tag {d!r}")


def _enc_acc(acc: _Acc) -> dict:
    doc: dict = {"n": int(acc.n)}
    if acc.cur is not None:
        doc["cur"] = _enc_wire(acc.cur)
    if acc.total is not None:
        doc["total"] = _enc_wire(acc.total)
    if acc.distinct is not None:
        doc["distinct"] = [_enc_wire(v) for v in acc.distinct]
    if acc.heap is not None:
        doc["heap"] = [_enc_wire(it.v if isinstance(it, _RevKey) else it)
                       for it in acc.heap]
    return doc


def _dec_acc(doc: dict, agg: AggExpr, leaf) -> _Acc:
    acc = _Acc(agg, leaf)
    acc.add_count(int(doc.get("n", 0)))
    acc.add_bound(_dec_wire(doc.get("cur")))
    acc.add_sum(_dec_wire(doc.get("total")))
    if acc.distinct is not None:
        acc.distinct.update(_dec_wire(v) for v in doc.get("distinct", []))
    if acc.heap is not None:
        for v in doc.get("heap", []):
            acc._offer(_dec_wire(v))
    return acc


def encode_agg_state(state) -> dict:
    """A JSON-safe document of one ``_state_only`` aggregate state."""
    _aggs_l, accs, groups, counters, _lines = state
    doc: dict = {"counters": {k: int(v) for k, v in counters.items()
                              if v},
                 "accs": [_enc_acc(a) for a in accs]}
    if groups is not None:
        doc["groups"] = [[_enc_wire(k), [_enc_acc(a) for a in gaccs]]
                         for k, gaccs in groups.items()]
    return doc


def decode_agg_state(doc: dict, aggs, leaves):
    """``(accs, groups, counters)`` rebuilt from :func:`encode_agg_state`'s
    document against the caller's own validated ``aggs`` and ``leaves``
    (the document is positional: it carries no schema)."""
    accs_doc = doc.get("accs")
    if not isinstance(accs_doc, list) or len(accs_doc) != len(aggs):
        raise ValueError(
            f"aggregate-state doc has {len(accs_doc or [])} acc(s), "
            f"expected {len(aggs)}")
    accs = [_dec_acc(d, a, leaf)
            for d, a, leaf in zip(accs_doc, aggs, leaves)]
    groups = None
    if "groups" in doc:
        groups = {}
        for key_doc, gdocs in doc["groups"]:
            if len(gdocs) != len(aggs):
                raise ValueError("aggregate-state group arity mismatch")
            groups[_canon_key(_dec_wire(key_doc))] = [
                _dec_acc(d, a, leaf)
                for d, a, leaf in zip(gdocs, aggs, leaves)]
    counters = {k: 0 for k in _COUNTER_KEYS}
    for k, v in (doc.get("counters") or {}).items():
        if k in counters:
            counters[k] = int(v)
    return accs, groups, counters


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _as_where(where) -> Expr:
    if where is None:
        return TRUE
    if not isinstance(where, Expr):
        raise TypeError("where must be an Expr tree (build with col(); "
                        f"got {type(where).__name__})")
    return where


def aggregate_file(pf, aggs: Sequence[AggExpr], where=None, group_by=None,
                   device="cuda", policy=None, report=None, _prepared=None,
                   _state_only: bool = False):
    """Answer ``aggs`` over the rows of ``pf`` matching ``where`` through the
    cascade (module docstring), its decoding tiers on ``device`` (CUDA
    unless the caller names the CPU; without a card a CUDA request
    raises).  ``policy``/``report`` as a read's: preads retry, the call
    runs under the deadline, and under ``on_corrupt='skip_row_group'`` a
    corrupt row group's contribution drops whole, recorded with its rows.
    ``_state_only`` returns the raw partial state (the dataset merges
    accumulators: finalized results lose the distinct sets)."""
    from .faults import resolve_policy
    from .reader import resolve_device

    dev = resolve_device(device)
    aggs, plan = _expand_derived(aggs)
    t0 = time.perf_counter()
    with _oscope.maybe_op_scope("file.aggregate", file=pf._path,
                                aggs=len(aggs)):
        try:
            pol, report = resolve_policy(pf, policy, report)
            with pf._resilient_op(policy, report, "aggregate"):
                state = _aggregate_impl(pf, aggs, where, group_by, dev, pol,
                                        report, _prepared)
        finally:
            _M_AGG_S.observe(time.perf_counter() - t0)
    aggs_l, accs, groups, counters, lines = state
    _publish(counters)
    if _state_only:
        return state
    return _finalize(aggs_l, accs, groups, counters, lines, report,
                     plan=plan)


def _publish(counters: Dict[str, int]) -> None:
    """A file's tier counters into the registry and the op."""
    for tier, metric in _TIER_METRIC.items():
        _oscope.account(metric, counters.get(f"rg_answered_{tier}", 0))
    _oscope.account(_M_FILES_MANIFEST,
                    counters.get("files_answered_manifest", 0))


def _aggregate_impl(pf, aggs, where, group_by, device, pol, report,
                    _prepared):
    from .faults import read_context
    from .remote import parallel_pread_slots

    aggs = list(aggs)
    leaves, gleaf = _validate(pf.schema, aggs, group_by)
    expr = _prepared if _prepared is not None \
        else prepare(_as_where(where), pf.schema)
    for p in _collect_preds(expr):
        if p.leaf.max_repetition_level > 0:
            raise ValueError(f"predicate column {p.path!r} is nested; "
                             "aggregate filters flat columns")
    accs = [_Acc(a, leaves[i]) for i, a in enumerate(aggs)]
    groups: Optional[dict] = {} if gleaf is not None else None
    counters = {k: 0 for k in _COUNTER_KEYS}
    lines = [f"aggregate: {pf._path or '<memory>'}",
             f"  aggs: {', '.join(a.name for a in aggs)}"
             + (f"; group_by: {group_by}" if group_by else ""),
             f"  where: {expr!r}"]
    skip = pol is not None and pol.skip_corrupt
    pslots = parallel_pread_slots(pf.source)
    for rg in pf.row_groups:
        try:
            with read_context(path=pf._path, row_group=rg.index,
                              kinds=(CorruptedError, OSError)):
                tier, delta, gdelta, note = _resolve_rg(
                    pf, rg, expr, aggs, leaves, gleaf, device, pslots)
        except DeadlineError:
            raise
        except CorruptedError as e:
            if not skip:
                raise
            report.record_skip(rg.index, rows=rg.num_rows, error=e)
            counters["rg_skipped_corrupt"] += 1
            lines.append(f"  rg {rg.index} ({rg.num_rows} rows): "
                         f"SKIPPED (corrupt: contribution dropped)")
            continue
        counters[f"rg_answered_{tier}"] += 1
        lines.append(f"  rg {rg.index} ({rg.num_rows} rows): {note}")
        if delta is not None:
            for acc, d in zip(accs, delta):
                acc.merge(d)
        if gdelta:
            for k, dacc in gdelta.items():
                cur = groups.get(k)
                if cur is None:
                    groups[k] = dacc
                else:
                    for acc, d in zip(cur, dacc):
                        acc.merge(d)
    return aggs, accs, groups, counters, lines


def dataset_aggregate(ds, aggs: Sequence[AggExpr], where=None,
                      group_by=None, device="cuda", policy=None,
                      report=None, _state_only: bool = False):
    """Aggregate across a :class:`~parquet_tpu_torch.dataset.Dataset`: the
    predicate prepares once; a table's manifest zone maps drop a part the
    predicate cannot match, or answer one that it covers where every
    aggregate is provable from them, without opening it
    (``files_answered_manifest``); the other files resolve on the shared
    pool, each row group by row group on ``device``, and the partial
    states merge in file order.  Under a degraded ``policy`` an unreadable
    file drops as a unit (``report.files_skipped``).  ``_state_only``
    returns the raw merged state.  The call is an op of its own
    (``dataset.aggregate``) unless the caller's scope is active."""
    aggs = list(aggs)
    t0 = time.perf_counter()
    with _oscope.maybe_op_scope("dataset.aggregate", files=len(ds.paths),
                                aggs=len(aggs)):
        try:
            return _dataset_aggregate_impl(ds, aggs, where, group_by, device,
                                           policy, report, _state_only)
        finally:
            _M_DS_AGG_S.observe(time.perf_counter() - t0)


def _dataset_aggregate_impl(ds, aggs, where, group_by, device, policy,
                            report, _state_only):
    from ..utils.pool import map_in_order
    from .faults import NON_DATA_ERRORS, ReadReport
    from .manifest import manifest_all_match, manifest_may_match
    from .reader import resolve_device

    if not ds.paths:
        raise ValueError("aggregate on an empty dataset shard; check "
                         "num_files first")
    dev = resolve_device(device)
    aggs, plan = _expand_derived(aggs)
    pol, report, skip = ds._resolve(policy, report)
    schema = ds.schema  # opens the first file
    leaves, gleaf = _validate(schema, aggs, group_by)
    expr = prepare(_as_where(where), schema)
    counters = {k: 0 for k in _COUNTER_KEYS}
    lines = [f"aggregate: dataset of {len(ds.paths)} file(s)",
             f"  aggs: {', '.join(a.name for a in aggs)}"
             + (f"; group_by: {group_by}" if group_by else ""),
             f"  where: {expr!r}"]
    accs = [_Acc(a, leaves[i]) for i, a in enumerate(aggs)]
    groups: Optional[dict] = {} if gleaf is not None else None
    stats = ds._file_stats
    idx: List[int] = []
    for i, path in enumerate(ds.paths):
        ent = stats.get(path) if stats is not None else None
        if ent is None:
            idx.append(i)
            continue
        if not manifest_may_match(ent, expr):
            counters["files_answered_manifest"] += 1
            lines.append(f"  file {path}: pruned by manifest zone maps "
                         "(zero IO)")
            continue
        if gleaf is None and manifest_all_match(ent, expr) \
                and _manifest_answer(ent, aggs, leaves, accs):
            counters["files_answered_manifest"] += 1
            lines.append(f"  file {path}: answered from manifest zone "
                         "maps (zero IO)")
            continue
        idx.append(i)

    def one(i):
        sub = None
        try:
            pf = ds.file(i)
            ds._check_schema(pf, ds.paths[i])
            sub = ReadReport() if report is not None else None
            state = aggregate_file(pf, aggs, group_by=group_by, device=dev,
                                   policy=pol, report=sub, _prepared=expr,
                                   _state_only=True)
            return state, sub, pf.num_rows, None
        except DeadlineError:
            raise
        except NON_DATA_ERRORS:
            raise
        except (CorruptedError, OSError) as e:
            if not skip:
                raise
            return None, sub, 0, e

    for i, (state, sub, rows, err) in zip(idx, map_in_order(one, idx)):
        if state is None:
            if sub is not None:
                report.retries += sub.retries
            report.record_file_skip(ds.paths[i], rows=rows, error=err)
            counters["files_skipped"] += 1
            lines.append(f"  file {ds.paths[i]}: SKIPPED ({err})")
            continue
        if report is not None and sub is not None:
            report.merge(sub)
        _, faccs, fgroups, fcounters, _flines = state
        for k in ("rg_answered_stats", "rg_answered_pages",
                  "rg_answered_dict", "rg_answered_dict_partial",
                  "rg_answered_decoded", "rg_skipped_corrupt"):
            counters[k] += fcounters.get(k, 0)
        lines.append(f"  file {ds.paths[i]}: tiers "
                     f"stats={fcounters['rg_answered_stats']} "
                     f"pages={fcounters['rg_answered_pages']} "
                     f"dict={fcounters['rg_answered_dict']} "
                     f"dict_partial={fcounters['rg_answered_dict_partial']} "
                     f"decoded={fcounters['rg_answered_decoded']}")
        for acc, d in zip(accs, faccs):
            acc.merge(d)
        if fgroups:
            for k, daccs in fgroups.items():
                cur = groups.get(k)
                if cur is None:
                    groups[k] = daccs
                else:
                    for acc, d in zip(cur, daccs):
                        acc.merge(d)
    _oscope.account(_M_FILES_MANIFEST, counters["files_answered_manifest"])
    if _state_only:
        return aggs, accs, groups, counters, lines
    return _finalize(aggs, accs, groups, counters, lines, report,
                     plan=plan)


def _manifest_answer(ent, aggs, leaves, accs) -> bool:
    """Answer every aggregate from a part's zone maps alone (only under
    proven coverage).  All or nothing: unless each is provable it folds
    nothing and returns False, and the file resolves as any other."""
    folds = []
    for a, leaf in zip(aggs, leaves):
        if a.kind == "count" and a.path is None:
            folds.append(("count", ent.num_rows))
            continue
        if a.kind not in ("count", "min", "max"):
            return False
        zm = ent.zone_maps.get(a.path)
        if zm is None:
            return False
        mn, mx, nulls, nv = zm
        if a.kind == "count":
            if nulls is None or nv is None:
                return False
            folds.append(("count", nv - nulls))
            continue
        if leaf is None or not _exact_stats(leaf):
            return False
        v = mn if a.kind == "min" else mx
        if v is None:
            if nulls is not None and nv is not None and nulls >= nv:
                folds.append(("skip", None))  # an all-null part
                continue
            return False
        if v != v:  # a NaN bound answers nothing
            return False
        folds.append(("bound", v))
    for (kind, v), acc in zip(folds, accs):
        if kind == "count":
            acc.add_count(v)
        elif kind == "bound":
            acc.add_bound(v)
    return True
