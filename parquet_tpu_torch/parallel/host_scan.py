"""The device pushdown scan, and exact key equality over host spans.

The port's cut of ``parquet_tpu/parallel/host_scan.py``:

- :func:`scan_filtered_device` = :func:`stage_scan` + :func:`decoded_scan`:
  the planner (``io/planner.py``, through ``io/search.plan_scan``) prunes
  row groups and pages by statistics, page index and bloom filters; each
  surviving span's pages of the key and output columns are planned and
  staged (``device_reader.build_plan``/``stage_plan``, one staging batch
  and one copy a span); then, on the device, each span decodes
  (``decode_staged``, whose dictionary and delta streams run the read
  path's CUDA kernels), the key predicate becomes a row mask, and every
  output column's surviving rows are compacted to a prefix by one cumsum
  and one scatter, with the survivor counts read back
  :data:`_SYNC_EVERY` spans at a time;
- :func:`aligned_key_mask`: the point lookup's face of the same
  predicate, on host numpy spans.

The key predicate holds in the key column's order domain: signed or
unsigned integers (an unsigned column's values and bounds compared with
their sign bits flipped), floats as the host scan compares them (``>=`` /
``<=``: NaN never matches and ``-0.0 == 0.0``; the JAX package's device
route orders doubles by their IEEE total order instead, and so disagrees
with its own host scan there), and a dictionary-encoded string key by one
verdict a dictionary entry, gathered onto the index stream.  NULL never
matches.  The JAX package's fused span program (a ``jax.jit`` of the
mask and the compaction) has no counterpart: the eager torch ops run on
every call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..algebra.compare import int_domain, is_unsigned, normalize
from ..errors import _Unsupported, unsupported
from ..format.enums import Encoding, Type
from ..ops import device as dev
from ..schema.types import LogicalKind, empty_values

__all__ = ["stage_scan", "decoded_scan", "scan_filtered_device",
           "aligned_key_mask"]

# spans between survivor-count reads: bounds the device memory held by
# uncompacted spans while one read serves many spans
_SYNC_EVERY = 8

_HOST_RAGGED = "host_ragged"
_DICT_ENCODINGS = (Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY)


def order_view(leaf, values: np.ndarray) -> np.ndarray:
    """Host values in the leaf's order domain: an unsigned column's
    int32/int64 as uint32/uint64 (the same bits)."""
    values = np.asarray(values)
    if is_unsigned(leaf) and values.dtype.kind == "i":
        return values.view(f"u{values.dtype.itemsize}")
    return values


def aligned_key_mask(leaf, key, values: np.ndarray,
                     validity: Optional[np.ndarray]) -> np.ndarray:
    """Rows of a row-aligned span equal to one normalized ``key``: the
    reference's inclusive range ``key <= v <= key`` in numpy, in the
    leaf's order domain, so NaN never matches and ``-0.0 == 0.0``; a NULL
    slot never matches."""
    values = order_view(leaf, values)
    base = (values >= key) & (values <= key)
    if validity is not None:
        base &= np.asarray(validity, bool)
    return base


# ---------------------------------------------------------------------------
# the key predicate
# ---------------------------------------------------------------------------


def _int_bound(v, up: bool):
    """An integer column's bound ``v`` as an int (``up``: a lower bound,
    rounded up), or +-inf / nan as they come."""
    if isinstance(v, float) and math.isfinite(v):
        return math.ceil(v) if up else math.floor(v)
    return v


class _KeyFilter:
    """The scan's key predicate, prepared once a scan in the key column's
    order domain: range bounds clamped to it (so no bound overflows the
    column's dtype), IN probes sorted on the device, and for a dictionary
    string key the raw bounds and probes that :meth:`verdicts` tests each
    entry against."""

    def __init__(self, leaf, lo, hi, probe: Optional[list], device):
        self.leaf = leaf
        self.probe = probe
        self.lo, self.hi = normalize(leaf, lo), normalize(leaf, hi)
        self.empty = False
        self.probes = None
        t = leaf.physical_type
        self.unsigned = is_unsigned(leaf) and t in (Type.INT32, Type.INT64)
        if t == Type.BYTE_ARRAY:
            return
        if probe is not None:
            self.probes = self._probe_tensor(probe, device)
            self.empty = self.probes.shape[0] == 0
        elif t in (Type.INT32, Type.INT64):
            self._int_range()

    def _probe_tensor(self, probe: list, device) -> torch.Tensor:
        t = self.leaf.physical_type
        if t == Type.INT32:
            arr = np.array(probe, np.int64)
            if self.unsigned:
                arr -= 2 ** 31
            arr = arr.astype(np.int32)
        elif t == Type.FLOAT:
            arr = np.array(probe, np.float32)
            arr = arr[~np.isnan(arr)]  # NaN equals nothing
        elif t == Type.BOOLEAN:
            arr = np.array(probe, np.bool_).astype(np.uint8)
        else:
            raise ValueError("device IN-list needs a single-word key; use "
                             "the host scan")
        return torch.from_numpy(np.unique(arr)).to(device)

    def _int_range(self) -> None:
        dlo, dhi = int_domain(self.leaf)  # [dlo, dhi)
        lo, hi = _int_bound(self.lo, True), _int_bound(self.hi, False)
        if lo is not None:
            if lo != lo or lo >= dhi:
                self.empty = True
            lo = None if lo <= dlo else lo
        if hi is not None:
            if hi != hi or hi < dlo:
                self.empty = True
            hi = None if hi >= dhi - 1 else hi
        if self.unsigned:  # to the signed keys of sign_flip
            half = 2 ** (31 if self.leaf.physical_type == Type.INT32
                         else 63)
            lo = None if lo is None else lo - half
            hi = None if hi is None else hi - half
        self.lo, self.hi = lo, hi

    def verdicts(self, dictionary_host) -> np.ndarray:
        """A dictionary string key: whether each entry matches (uint8)."""
        dvals, doffs = dictionary_host
        doffs = np.asarray(doffs, np.int64)
        dvals = np.asarray(dvals)
        entries = [dvals[doffs[i]:doffs[i + 1]].tobytes()
                   for i in range(len(doffs) - 1)]
        if self.probe is not None:
            probe_set = set(self.probe)
            match = [e in probe_set for e in entries]
        else:
            match = [(self.lo is None or e >= self.lo)
                     and (self.hi is None or e <= self.hi) for e in entries]
        return np.array(match, np.uint8)

    def mask(self, vals, table) -> torch.Tensor:
        """The rows of a row-aligned span that match (validity not yet
        applied); ``table`` is a dictionary key's staged verdicts."""
        if isinstance(vals, tuple):  # dictionary string key
            return dev.dict_gather(table, vals[1]) != 0
        n = vals.shape[0]
        if self.empty:
            return torch.zeros(n, dtype=torch.bool, device=vals.device)
        if vals.dtype == torch.bool:
            vals = vals.to(torch.uint8)
        if self.unsigned:
            vals = dev.sign_flip(vals)
        if self.probes is not None:
            return dev.in_mask(vals, self.probes)
        return dev.range_mask(vals, self.lo, self.hi)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def stage_scan(pf, path: str, lo=None, hi=None,
               columns: Optional[Sequence[str]] = None,
               use_bloom: bool = True, values: Optional[Sequence] = None,
               device="cuda", policy=None, report=None) -> dict:
    """The host phase of a device scan: the pushdown plan, each surviving
    span's prescan and its staging on ``device`` (CUDA unless the caller
    names the CPU; a CUDA request without a card raises).  Returns the
    staged state :func:`decoded_scan` consumes, as often as it likes.

    Flat columns only; the key cannot be a fixed-length byte array, INT96,
    a decimal byte array or a PLAIN byte array, an IN-list needs a key of
    one 32-bit word or less, and a chunk the device route refuses cannot
    be scanned: each of these raises ``ValueError`` saying to use the host
    scan.  ``policy`` and ``report`` (fault policies) are not ported."""
    from ..io.prefetch import make_chunk_prefetcher
    from ..io.reader import resolve_device

    if policy is not None or report is not None:
        raise unsupported("fault policies and read reports of the device "
                          "scan", "the fault-policy slice "
                          "(parquet_tpu/io/faults.py)")
    device = resolve_device(device)
    pre = make_chunk_prefetcher(pf.source)
    if pre is None:
        return _stage_scan_impl(pf, path, lo, hi, columns, use_bloom, values,
                                device)
    try:
        with pf._source_override(pre):
            return _stage_scan_impl(pf, path, lo, hi, columns, use_bloom,
                                    values, device, prefetcher=pre)
    finally:
        pre.close()


def _refuse(what: str) -> ValueError:
    return ValueError(f"{what}; use the host scan")


def _check_key(pf, path: str, out_cols: list, values) -> None:
    """The device scan's documented refusals, before any IO."""
    flat = {leaf.name for leaf in pf.schema.leaves
            if leaf.max_repetition_level == 0}
    for c in [path] + out_cols:
        if c not in flat:
            raise _refuse(f"column {c!r} is nested or unknown; the device "
                          "scan handles flat columns")
    key = pf.schema.leaf(path)
    t = key.physical_type
    if t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        raise _refuse(f"device scan key {path!r} has physical type {t.name}")
    if t == Type.BYTE_ARRAY and key.logical_kind == LogicalKind.DECIMAL:
        # a decimal orders by its unscaled value, not by its bytes
        raise _refuse(f"device scan key {path!r} is a decimal byte array")
    if values is not None and t in (Type.INT64, Type.DOUBLE):
        raise _refuse(f"device scan IN-list on 64-bit key {path!r} is not "
                      "supported")


def _stage_scan_impl(pf, path, lo, hi, columns, use_bloom, values, device,
                     prefetcher=None) -> dict:
    from ..algebra.compare import normalize_probe
    from ..io.search import pages_and_base, plan_scan
    from .device_reader import _StagingBatch, build_plan, stage_plan

    if columns is not None:
        out_cols = list(columns)
    else:
        out_cols = sorted(leaf.name for leaf in pf.schema.leaves
                          if leaf.max_repetition_level == 0
                          and leaf.name != path)
    _check_key(pf, path, out_cols, values)
    leaves = {c: pf.schema.leaf(c) for c in [path] + out_cols}
    key_leaf = leaves[path]
    plans = plan_scan(pf, path, lo=lo, hi=hi, use_bloom=use_bloom,
                      values=values, device=device)
    rgs = pf.row_groups
    if prefetcher is not None:
        # only the surviving spans' chunks are read
        seen = set()
        for p in plans:
            for c in leaves:
                br = rgs[p.rg_index].column(leaves[c].column_index).byte_range
                if br not in seen:
                    seen.add(br)
                    prefetcher.plan(*br)
    probe = (sorted({normalize_probe(key_leaf, v) for v in values} - {None})
             if values is not None else None)
    keyf = _KeyFilter(key_leaf, lo, hi, probe, device)
    # each span's pages, and whether each column takes the host-ragged
    # form there, decided from the page headers before anything is planned
    spans_pages = []
    for plan in plans:
        rg = rgs[plan.rg_index]
        row_start, row_end = plan.first_row, plan.first_row + plan.row_count
        cols = {}
        for c, leaf in leaves.items():
            chunk = rg.column(leaf.column_index)
            pages, first = pages_and_base(chunk, row_start, row_end)
            kinds = (_data_page_kinds(pages)
                     if leaf.physical_type == Type.BYTE_ARRAY else {True})
            if True not in kinds and c == path:
                raise _refuse(f"device scan key {c!r}: plain-encoded "
                              "BYTE_ARRAY has no row-aligned device form")
            cols[c] = (chunk, pages, row_start - first, kinds)
        spans_pages.append((plan, cols))
    # a column dictionary-encoded in one span and PLAIN in another takes
    # the host-ragged form in every span, so that its parts share one form
    mixed = {c for c in out_cols
             if len({True in cols[c][3] for _, cols in spans_pages}) == 2}
    spans = []
    for plan, cols in spans_pages:
        batch = _StagingBatch()
        per_col, staged, table = {}, {}, None
        for c, (chunk, pages, trim, kinds) in cols.items():
            # a span mixing both kinds of page is planned, and refused
            if True not in kinds or (c in mixed and kinds == {True}):
                per_col[c] = _host_ragged_span(chunk, pages, trim,
                                               plan.row_count)
                continue
            try:
                dplan = build_plan(chunk, pages=pages)
                staged[c] = stage_plan(dplan, device, batch.put)
            except _Unsupported as e:
                raise _refuse(f"device scan column {c!r}: {e}") from None
            per_col[c] = [dplan, None, trim, chunk, pages]
            if c == path and key_leaf.physical_type == Type.BYTE_ARRAY:
                table = batch.put(keyf.verdicts(dplan.dictionary_host))
        (staged, table), _ = batch.commit((staged, table), device)
        for c, got in staged.items():
            per_col[c][1] = got
        spans.append((plan, per_col, table))
    return {"path": path, "out_cols": out_cols, "key": keyf,
            "spans": spans, "leaves": leaves, "device": device}


def _data_page_kinds(pages) -> set:
    """Whether each data page of ``pages`` (:class:`PageInfo` objects) is
    dictionary-encoded, by its header, as a set: a byte-array span without
    a dictionary page has no device form here, and one with both kinds is
    refused by the planner (``mixed_page_kinds``)."""
    kinds = set()
    for p in pages:
        h = p.header.data_page_header or p.header.data_page_header_v2
        if h is not None:
            kinds.add(h.encoding in _DICT_ENCODINGS)
    return kinds


def _host_ragged_span(chunk, pages, trim: int, n_rows: int) -> tuple:
    """A PLAIN string output column's span on the host, decoded from the
    span's pages: ``("host_ragged", values, offsets, validity)``, the
    offsets over the present values and the validity (None without
    nulls) over the span's rows."""
    from ..io.reader import decode_chunk_host
    from ..io.search import _trim_host

    col = decode_chunk_host(chunk, "cpu", pages=pages)
    (_, vals, offs), valid = _trim_host(col, trim, n_rows, "arrays")
    return (_HOST_RAGGED, np.asarray(vals), np.asarray(offs, np.int64),
            None if valid is None else np.asarray(valid, bool))


# ---------------------------------------------------------------------------
# the device phase
# ---------------------------------------------------------------------------


def _row_aligned_device(col, trim: int, n_rows: int, no_nulls: bool):
    """A decoded flat column as row-aligned ``(values, validity)``, cut to
    the span's rows (its pages may start before them).  A dictionary
    string column gives ``((dictionary, indices), validity)``.  With
    ``no_nulls`` (known on the host from the plan's counts) the validity
    is dropped unread."""
    validity = None if no_nulls else col.validity
    if col.is_dictionary_encoded():
        idx = col.dict_indices
        if validity is not None:
            idx = dev.scatter_valid(idx, validity)
        vals = (col.dictionary, idx[trim:trim + n_rows])
    else:
        vals = col.values
        if validity is not None:
            vals = dev.scatter_valid(vals, validity)
        vals = vals[trim:trim + n_rows]
    return vals, (None if validity is None
                  else validity[trim:trim + n_rows])


class _ScanCarrier:
    """The spans' results between dispatch and assembly: each column's
    compacted parts (a tensor; ``(dictionary, indices, dictionary bytes)``;
    or a host-ragged tuple with the device's survivor rows last), their
    validity, and the survivor counts still on the device."""

    def __init__(self, out_cols):
        self.parts: Dict[str, List] = {c: [] for c in out_cols}
        self.vparts: Dict[str, List] = {c: [] for c in out_cols}
        self.any_valid = {c: False for c in out_cols}
        self.counts: List[torch.Tensor] = []
        self.ks_all: List[int] = []
        self.flushed = 0

    def flush(self, out_cols, upto: int) -> None:
        """Read back the counts of spans ``[flushed, upto)`` in one read,
        then cut each span's parts to its survivors."""
        if upto <= self.flushed:
            return
        ks = torch.stack(self.counts[self.flushed:upto]).tolist()
        self.ks_all.extend(ks)
        for si, k in zip(range(self.flushed, upto), ks):
            for c in out_cols:
                p = self.parts[c][si]
                if isinstance(p, tuple) and p[0] == _HOST_RAGGED:
                    self.parts[c][si] = p[:4] + (p[4][:k],)
                elif isinstance(p, tuple):
                    self.parts[c][si] = (p[0], p[1][:k], p[2])
                else:
                    self.parts[c][si] = p[:k]
                if self.vparts[c][si] is not None:
                    self.vparts[c][si] = self.vparts[c][si][:k]
        self.flushed = upto


def _scan_dispatch(state, carrier: _ScanCarrier) -> None:
    """Every span, decoded and filtered with no read-back but the batched
    counts: the key's mask, its survivors' targets, and each output
    column's rows compacted to a prefix."""
    from .device_reader import decode_staged

    path, out_cols = state["path"], state["out_cols"]
    keyf: _KeyFilter = state["key"]
    device = state["device"]
    for plan, per_col, table in state["spans"]:
        n_rows = plan.row_count
        kplan, kstaged, ktrim, _, _ = per_col[path]
        key = decode_staged(kplan, kstaged, device)
        kvals, kvalid = _row_aligned_device(
            key, ktrim, n_rows, kplan.total_values == kplan.total_slots)
        mask = keyf.mask(kvals, table)
        if kvalid is not None:
            mask &= kvalid  # NULL never matches
        tgt, cnt = dev.compact_targets(mask)
        ragged_idx = None
        for c in out_cols:
            part = per_col[c]
            if part[0] == _HOST_RAGGED:
                if ragged_idx is None:
                    ragged_idx = dev.compact_prefix(
                        torch.arange(n_rows, device=device), tgt)
                carrier.parts[c].append(part + (ragged_idx,))
                carrier.vparts[c].append(None)
                continue
            cplan, cstaged, ctrim, _, _ = part
            col = key if c == path else decode_staged(cplan, cstaged, device)
            vals, valid = _row_aligned_device(
                col, ctrim, n_rows, cplan.total_values == cplan.total_slots)
            if isinstance(vals, tuple):  # dictionary strings: their indexes
                nbytes = int(cplan.dictionary_host[1][-1])
                out = (vals[0], dev.compact_prefix(vals[1], tgt), nbytes)
            else:
                out = dev.compact_prefix(vals, tgt)
            carrier.parts[c].append(out)
            carrier.vparts[c].append(None if valid is None
                                     else dev.compact_prefix(valid, tgt))
            carrier.any_valid[c] |= valid is not None
        carrier.counts.append(cnt)
        if len(carrier.counts) - carrier.flushed >= _SYNC_EVERY:
            carrier.flush(out_cols, len(carrier.counts))


def _empty_device_result(leaf, device):
    """The typed empty of a column's output form."""
    t = leaf.physical_type
    if t == Type.BYTE_ARRAY:
        return ((torch.zeros(0, dtype=torch.uint8, device=device),
                 torch.zeros(1, dtype=torch.int64, device=device)),
                torch.zeros(0, dtype=torch.int32, device=device))
    return empty_values(t, leaf.type_length, device)


def _concat_dictionaries(parts) -> tuple:
    """Each span's ``(dictionary, indices, dictionary bytes)`` as one
    rebased dictionary and its indices: span i's indexes shift by the
    entries of the dictionaries before it, which are concatenated (an
    entry repeated across row groups is kept).  The byte counts come from
    the plans' host dictionaries, so nothing is read back."""
    if len(parts) == 1:
        return parts[0][:2]
    idx_parts, off_parts, base, vbase = [], [], 0, 0
    for (dv, do), idx, nbytes in parts:
        idx_parts.append(idx + base)
        off_parts.append(do[:-1] + vbase)
        base += do.shape[0] - 1
        vbase += nbytes
    (_, last_do), _, last_nbytes = parts[-1]
    off_parts.append(last_do[-1:] + (vbase - last_nbytes))
    return ((torch.cat([p[0][0] for p in parts]), torch.cat(off_parts)),
            torch.cat(idx_parts))


def _assemble_host_ragged(parts, ks: List[int]):
    """A PLAIN string column's survivors, gathered on the host: the spans'
    survivor rows come back in one read, map to present-value ordinals
    through each span's validity, and their bytes form one ``(uint8
    values, int64 offsets)`` pair (a null: an empty entry), wrapped as
    ``(form, validity)`` where a null survives."""
    from ..ops import host

    rows_all = torch.cat([p[4] for p in parts]).cpu().numpy()
    vals_parts, lens_parts, valid_parts = [], [], []
    any_nulls = False
    at = 0
    for (_, hv, ho, hvalid, _), k in zip(parts, ks):
        rows = rows_all[at:at + k].astype(np.int64)
        at += k
        if hvalid is None:
            v = np.ones(k, bool)
            ords = rows
        else:
            v = hvalid[rows]
            ords = (np.cumsum(hvalid, dtype=np.int64) - 1)[rows]
            any_nulls = any_nulls or not bool(v.all())
        sel = ords[v]
        vals_parts.append(host.gather_byte_arrays(hv, ho, sel)[0])
        lens = np.zeros(k, np.int64)
        lens[v] = ho[sel + 1] - ho[sel]
        lens_parts.append(lens)
        valid_parts.append(v)
    offs = np.zeros(at + 1, np.int64)
    np.cumsum(np.concatenate(lens_parts), out=offs[1:])
    form = (np.concatenate(vals_parts).astype(np.uint8, copy=False), offs)
    return (form, np.concatenate(valid_parts)) if any_nulls else form


def _scan_assemble(state, carrier: _ScanCarrier) -> Dict[str, object]:
    """The last counts read back, then each column's parts as one form."""
    out_cols, device = state["out_cols"], state["device"]
    carrier.flush(out_cols, len(carrier.counts))
    out: Dict[str, object] = {}
    for c in out_cols:
        parts = carrier.parts[c]
        if not parts:
            out[c] = _empty_device_result(state["leaves"][c], device)
            continue
        if isinstance(parts[0], tuple) and parts[0][0] == _HOST_RAGGED:
            out[c] = _assemble_host_ragged(parts, carrier.ks_all)
            continue
        if isinstance(parts[0], tuple):
            form = _concat_dictionaries(parts)
            rows = [p[1].shape[0] for p in parts]
        else:
            form = parts[0] if len(parts) == 1 else torch.cat(parts)
            rows = [p.shape[0] for p in parts]
        if carrier.any_valid[c]:
            valid = torch.cat([
                v if v is not None
                else torch.ones(n, dtype=torch.bool, device=device)
                for v, n in zip(carrier.vparts[c], rows)])
            out[c] = (form, valid)
        else:
            out[c] = form
    return out


def decoded_scan(state) -> Dict[str, object]:
    """The device phase of the scan on a :func:`stage_scan` state: decode
    the staged pages, evaluate the key predicate and gather the surviving
    rows, in file order.  Each column's form (a typed empty when nothing
    survives): a fixed-width column is a 1-D tensor (64-bit types native);
    a dictionary-encoded string column ``((values, offsets), indices)``,
    the row groups' dictionaries rebased into one; a PLAIN string column a
    host ``(uint8 values, int64 offsets)`` pair of the survivors; a
    nullable column ``(form, validity)``."""
    carrier = _ScanCarrier(state["out_cols"])
    _scan_dispatch(state, carrier)
    return _scan_assemble(state, carrier)


def scan_filtered_device(pf, path: str, lo=None, hi=None,
                         columns: Optional[Sequence[str]] = None,
                         use_bloom: bool = True,
                         values: Optional[Sequence] = None,
                         device="cuda", policy=None,
                         report=None) -> Dict[str, object]:
    """The rows where ``lo <= pf[path] <= hi`` (or ``pf[path] in values``)
    of ``columns`` (every other flat column by default), pushdown-planned,
    decoded and filtered on ``device``: :func:`stage_scan` then
    :func:`decoded_scan`."""
    return decoded_scan(stage_scan(pf, path, lo=lo, hi=hi, columns=columns,
                                   use_bloom=use_bloom, values=values,
                                   device=device, policy=policy,
                                   report=report))
