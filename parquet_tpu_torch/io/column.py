"""Decoded column: tensors on one device.

The port of ``parquet_tpu/io/column.py::Column``.
``values`` holds the dense present values (nulls are not stored), in the
form ``schema/types.py`` gives each physical type; a byte-array column adds
its ``offsets`` (int64, ``[n + 1]``).  ``validity`` holds one bool per slot
of a flat column, or per innermost element of a repeated one (None when no
value is null); ``num_slots`` is the level-stream length (the row count of
a flat column).  A column under repeated nodes adds, per repeated level
and outermost first, its ``list_offsets`` (int64 ``[lists + 1]``) and
``list_validity`` (bool ``[lists]``).  ``def_levels`` and ``rep_levels``
keep host level streams where the decode expanded them on the host (a
struct chain keeps its def levels for the nullness of each struct).  A dictionary chunk keeps its decoded ``dictionary`` and,
where the decode produced them, its int32 ``dict_indices``; the fused
dictionary kernel never materializes indexes, so they may be None.  A
byte-array dictionary chunk stays encoded: ``values`` is None,
``dictionary`` is a ``(values, offsets)`` pair and ``dict_indices`` says
which entry each value is (the Arrow DictionaryArray form);
:meth:`Column.materialize` gathers it.  :meth:`Column.to_pylist` gives
each row as the Python objects the JAX package's
``to_arrow().to_pylist()`` gives, without pyarrow.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

import torch

from ..errors import unsupported
from ..format.enums import Type
from ..ops import device as dev
from ..schema.schema import Leaf
from ..schema.types import LogicalKind


@dataclass
class Column:
    leaf: Leaf
    values: Optional[torch.Tensor]
    validity: Optional[torch.Tensor] = None
    num_slots: int = 0
    dictionary: object = None  # tensor, or (values, offsets) tensors
    dict_indices: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None  # byte arrays: int64[n + 1]
    list_offsets: List[torch.Tensor] = field(default_factory=list)
    list_validity: List[torch.Tensor] = field(default_factory=list)
    def_levels: Optional[np.ndarray] = None  # host int32, where expanded
    rep_levels: Optional[np.ndarray] = None

    @property
    def num_values(self) -> int:
        if self.values is None and self.dict_indices is not None:
            return self.dict_indices.shape[0]
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.values.shape[0]

    def is_dictionary_encoded(self) -> bool:
        return self.values is None and self.dict_indices is not None

    def to(self, device) -> "Column":
        """A column like this one with every tensor on ``device`` (a
        tensor already there is shared, not copied)."""
        device = torch.device(device)

        def move(t):
            if isinstance(t, tuple):
                return tuple(move(x) for x in t)
            return None if t is None else t.to(device)

        return Column(
            leaf=self.leaf, values=move(self.values),
            validity=move(self.validity), num_slots=self.num_slots,
            dictionary=move(self.dictionary),
            dict_indices=move(self.dict_indices),
            offsets=move(self.offsets),
            list_offsets=[move(o) for o in self.list_offsets],
            list_validity=[move(v) for v in self.list_validity],
            def_levels=self.def_levels, rep_levels=self.rep_levels)

    def materialize(self) -> "Column":
        """Gather an encoded byte-array column into dense ``values`` and
        ``offsets`` on its own device (in place; returns self)."""
        if self.is_dictionary_encoded():
            dv, do = self.dictionary
            self.values, self.offsets = dev.gather_byte_arrays(
                dv, do, self.dict_indices)
        return self

    @property
    def num_elements(self) -> int:
        """Entries ``validity`` covers: the innermost elements of a
        repeated column, the slots of a flat one."""
        if self.list_offsets:
            return int(self.list_offsets[-1][-1])
        return self.num_slots

    def materialize_host(self):
        """The column on the host, as numpy; the column is left as it is.
        A flat column gives its dense present values: an array, or for byte
        arrays a ``(values, offsets)`` pair.  A column with list levels or
        host def levels gives a dict: ``values`` (as a flat column's),
        ``validity``, ``list_offsets`` and ``list_validity`` (one array a
        repeated level, outermost first), ``def_levels`` and
        ``rep_levels``."""
        values, offsets = self.host_dense()
        if offsets is not None:
            values = values, offsets
        if not self.list_offsets and self.def_levels is None:
            return values
        return {"values": values,
                "validity": None if self.validity is None
                else self.validity.cpu().numpy(),
                "list_offsets": [o.cpu().numpy() for o in self.list_offsets],
                "list_validity": [v.cpu().numpy()
                                  for v in self.list_validity],
                "def_levels": self.def_levels,
                "rep_levels": self.rep_levels}

    def host_dense(self) -> tuple:
        """``(values, offsets)`` of the dense present values on the host,
        one copy a tensor (``offsets`` None but for byte arrays); an
        encoded byte-array column copies its dictionary and indexes and
        gathers on the host."""
        if self.is_dictionary_encoded():
            from ..ops import host

            dv, do = self.dictionary
            return host.gather_byte_arrays(dv.cpu().numpy(), do.cpu().numpy(),
                                           self.dict_indices.cpu().numpy())
        return (self.values.cpu().numpy(),
                None if self.offsets is None else self.offsets.cpu().numpy())

    def to_pylist(self) -> list:
        """One Python object a row, built on the host from one copy of
        each tensor: the objects pyarrow's ``to_pylist`` gives for the
        leaf's type (``int``, ``float``, ``bool``, ``str``, ``bytes``,
        ``datetime.date``, ``datetime.datetime`` in UTC for a UTC
        timestamp, ``datetime.time``, ``decimal.Decimal``), ``None`` for a
        null value or a null list, a list a repeated level.  A dictionary
        column converts its entries once and gathers them on the host."""
        leaf = self.leaf
        validity = (None if self.validity is None
                    else self.validity.cpu().numpy())
        if leaf.logical_kind == LogicalKind.UNKNOWN:
            items = [None] * (self.num_elements if validity is None
                              else int(validity.sum()))
        elif self.dictionary is not None and self.dict_indices is not None:
            d = self.dictionary
            entries = (_py_items(leaf, d[0].cpu().numpy(), d[1].cpu().numpy())
                       if isinstance(d, tuple)
                       else _py_items(leaf, d.cpu().numpy(), None))
            table = np.empty(len(entries), dtype=object)
            table[:] = entries
            items = table[self.dict_indices.cpu().numpy()].tolist()
        else:
            items = _py_items(leaf, self.values.cpu().numpy(),
                              None if self.offsets is None
                              else self.offsets.cpu().numpy())
        if validity is not None:
            out = [None] * len(validity)
            for i, v in zip(np.flatnonzero(validity).tolist(), items):
                out[i] = v
            items = out
        for offs, lv in zip(reversed(self.list_offsets),
                            reversed(self.list_validity)):
            o = offs.cpu().numpy().tolist()
            ok = (None if lv is None else lv.cpu().numpy().tolist())
            items = [items[o[i]:o[i + 1]] if ok is None or ok[i] else None
                     for i in range(len(o) - 1)]
        return items


def _utc():
    """The ``tzinfo`` pyarrow gives a UTC timestamp: ``ZoneInfo("UTC")``
    (``datetime.timezone.utc`` where no time-zone database is
    installed)."""
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo("UTC")
    except Exception:
        return datetime.timezone.utc


_TS_UNITS = {LogicalKind.TIMESTAMP_MILLIS: "ms",
             LogicalKind.TIMESTAMP_MICROS: "us"}
_TIME_UNITS = {LogicalKind.TIME_MILLIS: 1000, LogicalKind.TIME_MICROS: 1}


def _py_items(leaf: Leaf, values: np.ndarray, offsets) -> list:
    """Dense present values as the Python objects of the leaf's type."""
    kind, physical = leaf.logical_kind, leaf.physical_type
    params = leaf.logical_params or {}
    if physical == Type.BYTE_ARRAY:
        buf = np.ascontiguousarray(values).view(np.uint8).tobytes()
        o = np.asarray(offsets, np.int64).tolist()
        raw = [buf[o[i]:o[i + 1]] for i in range(len(o) - 1)]
        if kind in (LogicalKind.STRING, LogicalKind.ENUM, LogicalKind.JSON):
            return [b.decode("utf-8") for b in raw]
        if kind == LogicalKind.DECIMAL:
            return [_decimal(int.from_bytes(b, "big", signed=True), params)
                    for b in raw]
        return raw
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        rows = np.ascontiguousarray(values, np.uint8).reshape(
            -1, leaf.type_length)
        if kind == LogicalKind.FLOAT16:
            return rows.reshape(-1).view(np.float16).tolist()
        if kind == LogicalKind.DECIMAL:
            return [_decimal(int.from_bytes(r.tobytes(), "big",
                                            signed=True), params)
                    for r in rows]
        return [r.tobytes() for r in rows]
    if physical == Type.INT96 or kind in (LogicalKind.TIMESTAMP_NANOS,
                                          LogicalKind.TIME_NANOS):
        raise unsupported(f"Column.to_pylist of {leaf.name!r} "
                          "(nanosecond times)", "arrow interop")
    if kind == LogicalKind.INT:
        dt = np.dtype(f"{'i' if params.get('signed', True) else 'u'}"
                      f"{max(params.get('bit_width', 64), 8) // 8}")
        return (values.astype(dt) if physical == Type.INT32
                else values.view(dt)).tolist()
    if kind == LogicalKind.DATE:
        return values.astype(np.int64).astype("datetime64[D]").astype(
            object).tolist()
    if kind in _TS_UNITS:
        out = values.astype(f"datetime64[{_TS_UNITS[kind]}]").astype(
            object).tolist()
        if params.get("utc"):
            tz = _utc()
            out = [v.replace(tzinfo=tz) for v in out]
        return out
    if kind in _TIME_UNITS:
        scale = _TIME_UNITS[kind]
        return [(datetime.datetime.min + datetime.timedelta(
            microseconds=int(v) * scale)).time() for v in values.tolist()]
    if kind == LogicalKind.DECIMAL:
        return [_decimal(int(v), params) for v in values.tolist()]
    return values.tolist()


def _decimal(unscaled: int, params: dict) -> decimal.Decimal:
    return decimal.Decimal(unscaled).scaleb(-params.get("scale", 0))


def _concat_byte_arrays(values_parts, offsets_parts, sizes=None) -> tuple:
    """(values, offsets) pairs as one, offsets rebased (each part's from
    0).  ``sizes`` gives each part's byte count where the caller knows it
    (None: read from its offsets)."""
    offs, vals, base = [offsets_parts[0][:1]], [], 0
    for i, (v, o) in enumerate(zip(values_parts, offsets_parts)):
        n = sizes[i] if sizes is not None and sizes[i] is not None \
            else int(o[-1])
        vals.append(v[:n])
        offs.append(o[1:] + base)
        base += n
    return torch.cat(vals), torch.cat(offs)


def _dict_key(dictionary) -> int:
    """A dictionary's identity: its tensor's (the staging rebuilds the
    tuple of a byte-array dictionary around the same tensors)."""
    return id(dictionary[0] if isinstance(dictionary, tuple) else dictionary)


def _concat_dict_parts(parts: List[Column], structure: dict) -> Column:
    """Encoded byte-array parts stay encoded: each part's indexes rebased by
    the sizes of the distinct dictionaries before its own, the distinct
    dictionaries concatenated (entries repeated across row groups are
    kept), as the JAX package's ``_concat_dict_parts`` does.  Parts that
    share a dictionary (slices of one chunk) share its entries."""
    bases, dicts, base = {}, [], 0
    for p in parts:
        key = _dict_key(p.dictionary)
        if key not in bases:
            bases[key] = base
            base += p.dictionary[1].shape[0] - 1
            dicts.append(p.dictionary)
    indices = torch.cat([
        p.dict_indices + bases[_dict_key(p.dictionary)]
        if bases[_dict_key(p.dictionary)] else p.dict_indices
        for p in parts])
    # a dictionary's values are exactly its entries' bytes
    dictionary = dicts[0] if len(dicts) == 1 else _concat_byte_arrays(
        [d[0] for d in dicts], [d[1] for d in dicts],
        [d[0].shape[0] for d in dicts])
    return Column(leaf=parts[0].leaf, values=None, dictionary=dictionary,
                  dict_indices=indices, **structure)


def _concat_validity(parts: List[Column],
                     elements=None) -> Optional[torch.Tensor]:
    if all(p.validity is None for p in parts):
        return None
    device = next(p.validity.device for p in parts
                  if p.validity is not None)
    return torch.cat([
        p.validity if p.validity is not None
        else torch.ones(p.num_elements if elements is None else elements[i],
                        dtype=torch.bool, device=device)
        for i, p in enumerate(parts)])


def _concat_offsets(parts: List[torch.Tensor]) -> torch.Tensor:
    """List offsets of consecutive parts (each from 0) as one: each part
    rebased by the lengths before it, on the device (no read-back)."""
    lasts = torch.stack([o[-1] for o in parts])
    bases = torch.cumsum(lasts, 0) - lasts
    return torch.cat([parts[0][:1]] + [o[1:] + bases[i]
                                       for i, o in enumerate(parts)])


def _concat_host(arrays) -> Optional[np.ndarray]:
    return (None if any(a is None for a in arrays)
            else np.concatenate(arrays))


def _concat_structure(parts: List[Column], elements=None) -> dict:
    """The validity, list levels, level streams and slot count of
    consecutive parts as one column's, as the JAX package's
    ``_concat_structure``."""
    nlev = len(parts[0].list_offsets)
    return {
        "validity": _concat_validity(parts, elements),
        "list_offsets": [_concat_offsets([p.list_offsets[k] for p in parts])
                         for k in range(nlev)],
        "list_validity": [torch.cat([p.list_validity[k] for p in parts])
                          for k in range(nlev)],
        "def_levels": _concat_host([p.def_levels for p in parts]),
        "rep_levels": _concat_host([p.rep_levels for p in parts]),
        "num_slots": sum(p.num_slots for p in parts)}


def concat_columns(parts: List[Column], elements=None,
                   nbytes=None) -> Column:
    """One column from consecutive parts: its row groups, or a streamed
    batch's slices of page spans.  Encoded byte-array parts merge encoded;
    a mix of encoded and dense parts is gathered dense, each part left as
    it is.  A dictionary that every part shares (slices of one chunk) is
    kept once, with the indexes where every part has them; parts with
    dictionaries of their own (row groups) keep none, except encoded byte
    arrays.  ``elements`` (each
    part's validity length) and ``nbytes`` (each dense byte-array part's
    byte count, None where unknown) spare reading them from the device."""
    if len(parts) == 1:
        return parts[0]
    structure = _concat_structure(parts, elements)
    if all(p.is_dictionary_encoded() for p in parts):
        return _concat_dict_parts(parts, structure)
    leaf = parts[0].leaf
    if any(p.offsets is not None for p in parts):  # byte arrays
        vparts, oparts, sizes = [], [], []
        for i, p in enumerate(parts):
            if p.is_dictionary_encoded():
                p = Column(leaf=leaf, values=None, dictionary=p.dictionary,
                           dict_indices=p.dict_indices).materialize()
                sizes.append(None)
            else:
                sizes.append(None if nbytes is None else nbytes[i])
            vparts.append(p.values)
            oparts.append(p.offsets)
        values, offsets = _concat_byte_arrays(vparts, oparts, sizes)
        return Column(leaf=leaf, values=values, offsets=offsets,
                      **structure)
    values = torch.cat([p.values for p in parts])
    dictionary = indices = None
    if len({_dict_key(p.dictionary) for p in parts}) == 1:
        dictionary = parts[0].dictionary
        if all(p.dict_indices is not None for p in parts):
            indices = torch.cat([p.dict_indices for p in parts])
    return Column(leaf=leaf, values=values, dictionary=dictionary,
                  dict_indices=indices, **structure)
