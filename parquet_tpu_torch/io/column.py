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
``to_arrow().to_pylist()`` gives, without pyarrow (INT96 and nanosecond
times go through pyarrow).  :meth:`Column.to_arrow` gives the column as
the JAX package's pyarrow array; pyarrow is imported only there, so the
rest of the port runs without it.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

import torch

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
        column converts its entries once and gathers them on the host.
        INT96 and nanosecond times are ``to_arrow().to_pylist()`` (pyarrow's
        objects: ``pandas.Timestamp`` where pandas is installed); without
        pyarrow they raise ``ImportError``."""
        leaf = self.leaf
        if leaf.physical_type == Type.INT96 or leaf.logical_kind in (
                LogicalKind.TIMESTAMP_NANOS, LogicalKind.TIME_NANOS):
            return self.to_arrow().to_pylist()
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

    # ------------------------------------------------------------- arrow
    def _dict_arrow(self):
        """An encoded column as a pyarrow ``DictionaryArray`` over its
        entries and indexes, one slot a value (nulls masked)."""
        import pyarrow as pa

        d = self.dictionary
        dv, do = d if isinstance(d, tuple) else (d, None)
        dict_arr = _leaf_to_arrow(self.leaf, dv.cpu().numpy(),
                                  None if do is None else do.cpu().numpy(),
                                  None)
        idx = self.dict_indices.cpu().numpy().astype(np.int32, copy=False)
        if self.validity is not None:
            v = self.validity.cpu().numpy()
            slot = np.zeros(len(v), np.int32)
            slot[v] = idx
            ia = pa.array(slot, mask=~v)
        else:
            ia = pa.array(idx)
        return pa.DictionaryArray.from_arrays(ia, dict_arr)

    def to_arrow(self, prefer_dictionary: bool = False):
        """The column as the JAX package's pyarrow array, from one copy of
        each tensor to the host: the leaf's Arrow type (``arrow_type_of``),
        nulls masked, one list layer a repeated level.  An encoded
        byte-array column is cast dense from its ``DictionaryArray``, or
        with ``prefer_dictionary`` (and no list level) kept one, as pyarrow
        reads a field its embedded schema declares dictionary-typed."""
        import pyarrow as pa

        leaf = self.leaf
        if self.is_dictionary_encoded():
            arr = self._dict_arrow()
            if not (prefer_dictionary and not self.list_offsets):
                arr = arr.cast(arr.type.value_type)
        else:
            arr = _leaf_to_arrow(
                leaf, self.values.cpu().numpy(),
                None if self.offsets is None else self.offsets.cpu().numpy(),
                None if self.validity is None
                else self.validity.cpu().numpy())
        for offs, lv in zip(reversed(self.list_offsets),
                            reversed(self.list_validity)):
            offs = pa.array(offs.cpu().numpy().astype(np.int32))
            lv = None if lv is None else lv.cpu().numpy()
            if lv is not None and not lv.all():
                arr = pa.ListArray.from_arrays(offs, arr, mask=pa.array(~lv))
            else:
                arr = pa.ListArray.from_arrays(offs, arr)
        return arr


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


# ---------------------------------------------------------------------------
# Host arrays -> pyarrow (the JAX package's converters)
# ---------------------------------------------------------------------------

# byte-array offsets past this take Arrow's 64-bit (LARGE) layout
_OFFSET32_LIMIT = int(np.iinfo(np.int32).max)
_STRING_KINDS = (LogicalKind.STRING, LogicalKind.ENUM, LogicalKind.JSON)


def _leaf_to_arrow(leaf: Leaf, values: np.ndarray, offsets, validity):
    """A leaf's dense host values (with a byte array's offsets) and its
    slot validity (None: no null) as a pyarrow array of the leaf's type."""
    import pyarrow as pa

    k = leaf.logical_kind
    pt = leaf.physical_type
    params = leaf.logical_params or {}
    if k == LogicalKind.UNKNOWN:  # the Null logical type
        return pa.nulls(len(validity) if validity is not None
                        else len(values))
    if pt == Type.BYTE_ARRAY:
        wide = _wide_offsets(offsets)
        if k in _STRING_KINDS:  # utf8 from the buffers, unvalidated
            atype = pa.large_utf8() if wide else pa.utf8()
        else:
            atype = pa.large_binary() if wide else pa.binary()
        if validity is not None:
            return _ragged_with_nulls(values, offsets, validity, atype)
        return pa.Array.from_buffers(
            atype, len(offsets) - 1,
            [None, pa.py_buffer(np.ascontiguousarray(
                offsets, dtype=np.int64 if wide else np.int32)),
             pa.py_buffer(np.ascontiguousarray(values).view(np.uint8))])
    if pt == Type.FIXED_LEN_BYTE_ARRAY:
        width = leaf.type_length
        vals = np.asarray(values, dtype=np.uint8).reshape(-1, width)
        if k == LogicalKind.FLOAT16:
            return _fixed_with_nulls(vals.reshape(-1).view(np.float16),
                                     validity, pa.float16())
        if k == LogicalKind.DECIMAL:
            return _decimal_with_nulls(
                _be_bytes_to_int(vals), validity,
                pa.decimal128(params.get("precision", 38),
                              params.get("scale", 0)))
        if validity is None:
            return pa.FixedSizeBinaryArray.from_buffers(
                pa.binary(width), len(vals),
                [None, pa.py_buffer(np.ascontiguousarray(vals))])
        return _fsb_with_nulls(vals, validity, width)
    if pt == Type.INT96:
        # (nanoseconds of the day in two words, the Julian day)
        v = np.asarray(values).reshape(-1, 3)
        nanos = v[:, 0].astype(np.uint32).astype(np.uint64) | (
            v[:, 1].astype(np.uint32).astype(np.uint64) << np.uint64(32))
        days = v[:, 2].astype(np.int64) - 2440588  # Julian -> Unix days
        ts = days * 86400_000_000_000 + nanos.astype(np.int64)
        return _fixed_with_nulls(ts, validity, pa.timestamp("ns"))
    flat = np.asarray(values)
    if k == LogicalKind.INT:
        dt = np.dtype(f"{'i' if params.get('signed', True) else 'u'}"
                      f"{max(params.get('bit_width', 64), 8) // 8}")
        flat = (flat.astype(dt) if pt == Type.INT32
                else flat.view(dt) if flat.dtype.itemsize == dt.itemsize
                else flat.astype(dt))
        return _fixed_with_nulls(flat, validity, pa.from_numpy_dtype(dt))
    tz = "UTC" if params.get("utc") else None
    if k == LogicalKind.DATE:
        return _fixed_with_nulls(flat.astype(np.int32, copy=False),
                                 validity, pa.date32())
    if k == LogicalKind.TIMESTAMP_MILLIS:
        return _fixed_with_nulls(flat, validity, pa.timestamp("ms", tz=tz))
    if k == LogicalKind.TIMESTAMP_MICROS:
        return _fixed_with_nulls(flat, validity, pa.timestamp("us", tz=tz))
    if k == LogicalKind.TIMESTAMP_NANOS:
        return _fixed_with_nulls(flat, validity, pa.timestamp("ns", tz=tz))
    if k == LogicalKind.TIME_MILLIS:
        return _fixed_with_nulls(flat.astype(np.int32, copy=False),
                                 validity, pa.time32("ms"))
    if k == LogicalKind.TIME_MICROS:
        return _fixed_with_nulls(flat, validity, pa.time64("us"))
    if k == LogicalKind.DECIMAL and pt in (Type.INT32, Type.INT64):
        return _decimal_with_nulls(
            flat.astype(np.int64), validity,
            pa.decimal128(params.get("precision", 18),
                          params.get("scale", 0)))
    return _fixed_with_nulls(flat, validity, pa.from_numpy_dtype(flat.dtype))


def _be_bytes_to_int(vals: np.ndarray) -> np.ndarray:
    """Big-endian two's-complement FLBA rows as int64 (decimals of at
    most 8 bytes)."""
    n, width = vals.shape
    out = np.zeros(n, dtype=np.int64)
    for k in range(width):
        out = (out << 8) | vals[:, k].astype(np.int64)
    bits = width * 8
    if bits < 64:  # sign-extend from width * 8 bits
        sign = np.int64(1) << (bits - 1)
        out = (out ^ sign) - sign
    return out


def _spread(values: np.ndarray, validity: np.ndarray, fill=0) -> np.ndarray:
    """Dense present values scattered to their slots."""
    out = np.full(len(validity), fill, dtype=values.dtype)
    out[validity] = values
    return out


def _fixed_with_nulls(values: np.ndarray, validity, pa_type):
    import pyarrow as pa

    if validity is None:
        arr = pa.array(values)
    else:
        arr = pa.array(_spread(values, validity), mask=~np.asarray(validity))
    if arr.type != pa_type:
        arr = arr.cast(pa_type)
    return arr


def _decimal_with_nulls(ints: np.ndarray, validity, pa_type):
    import pyarrow as pa

    vals = ints if validity is None else _spread(ints, validity)
    raw = np.empty((len(vals), 2), dtype=np.uint64)
    raw[:, 0] = vals.astype(np.uint64)
    raw[:, 1] = (vals >> 63).astype(np.int64).astype(np.uint64)
    bufs = [None, pa.py_buffer(raw)]
    if validity is not None:
        bufs[0] = pa.py_buffer(np.packbits(validity, bitorder="little"))
    return pa.Array.from_buffers(pa_type, len(vals), bufs)


def _fsb_with_nulls(vals: np.ndarray, validity: np.ndarray, width: int):
    import pyarrow as pa

    out = np.zeros((len(validity), width), dtype=np.uint8)
    out[validity] = vals
    mask = pa.py_buffer(np.packbits(validity, bitorder="little"))
    return pa.Array.from_buffers(pa.binary(width), len(validity),
                                 [mask, pa.py_buffer(out)])


def _wide_offsets(offsets) -> bool:
    """True where byte-array offsets address more bytes than int32 can:
    Arrow's LARGE layout."""
    return (offsets is not None and len(offsets) > 1
            and int(offsets[-1]) > _OFFSET32_LIMIT)


def _ragged_with_nulls(values: np.ndarray, offsets: np.ndarray,
                       validity: np.ndarray, atype):
    import pyarrow as pa

    n = len(validity)
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    slot_lens = np.zeros(n, dtype=np.int64)
    slot_lens[validity] = lens
    slot_offs = np.concatenate([[0], np.cumsum(slot_lens)])
    slot_offs = slot_offs.astype(np.int64 if _wide_offsets(offsets)
                                 else np.int32)
    mask = pa.py_buffer(np.packbits(validity, bitorder="little"))
    return pa.Array.from_buffers(
        atype, n,
        [mask, pa.py_buffer(slot_offs),
         pa.py_buffer(np.ascontiguousarray(values).view(np.uint8))])


def arrow_type_of(node):
    """The pyarrow type of a schema node (a leaf or a group), as
    :func:`_leaf_to_arrow` and ``ColumnSet.to_arrow`` build its arrays: a
    LIST a ``list_``, a MAP a ``map_``, another group a ``struct``, a
    repeated node a list of its type."""
    import pyarrow as pa

    from ..format.enums import FieldRepetitionType as Rep

    def base(n):
        if n.is_leaf:
            return _leaf_arrow_type(n)
        k = n.logical_kind
        if k == LogicalKind.LIST and len(n.children) == 1:
            mid = n.children[0]
            if mid.children is not None and len(mid.children) == 1:
                return pa.list_(arrow_type_of(mid.children[0]))  # 3-level
            return pa.list_(base(mid))  # 2-level: the repeated element
        if k == LogicalKind.MAP and len(n.children) == 1:
            kv = n.children[0]
            if kv.children is not None and len(kv.children) == 2:
                return pa.map_(base(kv.children[0]),
                               arrow_type_of(kv.children[1]))
        return pa.struct([(c.name, arrow_type_of(c)) for c in n.children])

    t = base(node)
    if node.repetition == Rep.REPEATED:  # a legacy repeated field
        t = pa.list_(t)
    return t


def _leaf_arrow_type(n):
    import pyarrow as pa

    k = n.logical_kind
    pt = n.physical_type
    p = n.logical_params or {}
    if k == LogicalKind.UNKNOWN:
        return pa.null()
    if pt == Type.BOOLEAN:
        return pa.bool_()
    if pt == Type.BYTE_ARRAY:
        return pa.string() if k in _STRING_KINDS else pa.binary()
    if pt == Type.FIXED_LEN_BYTE_ARRAY:
        if k == LogicalKind.FLOAT16:
            return pa.float16()
        if k == LogicalKind.DECIMAL:
            return pa.decimal128(p.get("precision", 38), p.get("scale", 0))
        return pa.binary(n.type_length)
    if pt == Type.INT96:
        return pa.timestamp("ns")
    if pt == Type.FLOAT:
        return pa.float32()
    if pt == Type.DOUBLE:
        return pa.float64()
    if k == LogicalKind.INT:
        bw = max(p.get("bit_width", 64), 8)
        return pa.from_numpy_dtype(
            np.dtype(f"{'i' if p.get('signed', True) else 'u'}{bw // 8}"))
    if k == LogicalKind.DATE:
        return pa.date32()
    if k == LogicalKind.DECIMAL:
        return pa.decimal128(p.get("precision", 38), p.get("scale", 0))
    tz = "UTC" if p.get("utc") else None
    if k == LogicalKind.TIMESTAMP_MILLIS:
        return pa.timestamp("ms", tz=tz)
    if k == LogicalKind.TIMESTAMP_MICROS:
        return pa.timestamp("us", tz=tz)
    if k == LogicalKind.TIMESTAMP_NANOS:
        return pa.timestamp("ns", tz=tz)
    if k == LogicalKind.TIME_MILLIS:
        return pa.time32("ms")
    if k == LogicalKind.TIME_MICROS:
        return pa.time64("us")
    if k == LogicalKind.TIME_NANOS:
        return pa.time64("ns")
    return pa.int32() if pt == Type.INT32 else pa.int64()


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
