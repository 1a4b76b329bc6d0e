"""Schema conversion: decoded columns as another schema's writable columns.

The port of ``parquet_tpu/algebra/convert.py``: each target leaf maps to
the source leaf at the same dotted path, widened (int32 -> int64 or
double, int64 -> double, float -> double; unsigned columns zero-extend;
time and timestamp units coarse to fine, rescaled exactly), or, absent
from the source, becomes all nulls.  Narrowing and changes of nesting
raise ``TypeError``.

A chunk decodes through the port's device read on ``device`` (a repeated
column of more than one level with its Dremel level streams) and comes to
the host once, one copy a tensor, as the writer's :class:`ColumnData`: a
flat column with its validity, a one-level list with its offsets and
validity (``list_offsets=[offsets]``), a deeper one in the raw-level form
(``def_levels``, ``rep_levels``), which alone carries a null struct
between two repeated levels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..format.enums import FieldRepetitionType as Rep
from ..format.enums import Type
from ..io.column import Column
from ..io.writer import ColumnData
from ..schema.schema import Leaf, Schema
from ..schema.types import LogicalKind as LK
from .compare import is_unsigned

# the physical widenings the JAX package allows
_WIDEN_OK = {
    (Type.INT32, Type.INT64),
    (Type.FLOAT, Type.DOUBLE),
    (Type.INT32, Type.DOUBLE),
    (Type.INT64, Type.DOUBLE),
}

# time-like logical kinds: (family, ticks a second)
_TIME_UNITS = {
    LK.TIME_MILLIS: ("time", 10**3),
    LK.TIME_MICROS: ("time", 10**6),
    LK.TIME_NANOS: ("time", 10**9),
    LK.TIMESTAMP_MILLIS: ("timestamp", 10**3),
    LK.TIMESTAMP_MICROS: ("timestamp", 10**6),
    LK.TIMESTAMP_NANOS: ("timestamp", 10**9),
}


def _time_rescale(src: Leaf, dst: Leaf) -> Optional[int]:
    """The integer factor of a coarse-to-fine time unit widening; None
    where neither side is time-like or the units match, and -1 (refused)
    for a narrowing or a change of family (TIME and TIMESTAMP, or a
    time-like and a plain int)."""
    s = _TIME_UNITS.get(src.logical_kind)
    d = _TIME_UNITS.get(dst.logical_kind)
    if s is None and d is None:
        return None
    if s is None or d is None or s[0] != d[0]:
        return -1
    if s[1] == d[1]:
        return None
    if d[1] % s[1] != 0:
        return -1
    return d[1] // s[1]


def can_convert(src: Leaf, dst: Leaf) -> bool:
    scale = _time_rescale(src, dst)
    if scale is not None:
        return scale > 0 and (src.physical_type == dst.physical_type or
                              (src.physical_type, dst.physical_type)
                              in _WIDEN_OK)
    if src.physical_type == dst.physical_type:
        return True
    return (src.physical_type, dst.physical_type) in _WIDEN_OK


def convert_values(values: np.ndarray, src: Leaf, dst: Leaf) -> np.ndarray:
    """Dense values of ``src``'s type widened to ``dst``'s: unsigned
    columns zero-extend, time units rescale exactly; a narrowing or a
    change of family raises ``TypeError``."""
    pair = (src.physical_type, dst.physical_type)
    scale = _time_rescale(src, dst)
    if scale is not None and scale <= 0:
        raise TypeError(
            f"cannot convert {src.logical_kind} → {dst.logical_kind}: "
            "narrowing time unit is lossy")
    if src.physical_type != dst.physical_type and pair not in _WIDEN_OK:
        raise TypeError(f"cannot convert {src.physical_type.name} → "
                        f"{dst.physical_type.name}")
    v = np.asarray(values)
    if src.physical_type != dst.physical_type:
        if is_unsigned(src) and np.issubdtype(v.dtype, np.signedinteger):
            v = v.view(np.uint32 if v.dtype == np.dtype(np.int32)
                       else np.uint64)
        v = v.astype({Type.INT64: np.int64,
                      Type.DOUBLE: np.float64}[dst.physical_type])
    if scale is not None and scale > 1:
        v = v * np.asarray(scale, dtype=v.dtype)
    return v


def convert_column_data(rg, dst_leaf: Leaf, src_schema: Schema,
                        device="cuda") -> ColumnData:
    """One chunk of a source row group as the target leaf's
    :class:`ColumnData`, decoded on ``device``; a leaf the source lacks
    becomes all nulls (it must be nullable)."""
    from ..io.reader import resolve_device
    from ..parallel.device_reader import decode_chunk_span

    try:
        src_leaf = src_schema.leaf(dst_leaf.path)
    except KeyError:
        src_leaf = None
    if (src_leaf is not None
            and src_leaf.max_repetition_level != dst_leaf.max_repetition_level):
        raise TypeError(
            f"cannot convert {dst_leaf.dotted_path!r}: source is nested "
            f"depth {src_leaf.max_repetition_level}, target depth "
            f"{dst_leaf.max_repetition_level}")
    if src_leaf is None:
        if structural_conflict(src_schema, dst_leaf):
            raise TypeError(
                f"cannot convert {dst_leaf.dotted_path!r}: source stores a "
                "column of different nesting structure under the same name")
        return null_fill_column(dst_leaf, rg.num_rows)
    col = decode_chunk_span(rg.column(src_leaf.column_index),
                            resolve_device(device),
                            keep_levels=src_leaf.max_repetition_level > 1)
    return column_to_data(col, src_leaf, dst_leaf)


def structural_conflict(src_schema: Schema, dst_leaf: Leaf) -> bool:
    """True where the source has a leaf whose path is a strict prefix of
    the target leaf's, or has it as one: the same name holds another
    nesting structure (not a missing column, which null-fills)."""
    d = tuple(dst_leaf.path)
    for leaf in src_schema.leaves:
        s = tuple(leaf.path)
        if s == d:
            return False
        if s[:len(d)] == d or d[:len(s)] == s:
            return True
    return False


def null_fill_column(leaf: Leaf, n: int) -> ColumnData:
    """``n`` rows of nulls for a (nullable) target leaf the source lacks,
    in the form a decoded batch of it takes: byte arrays with empty
    offsets, FLBA and INT96 as ``(0, width)`` blocks, a one-level list as
    ``n`` null lists, a deeper one as ``n`` rows null at the outermost
    level (def 0)."""
    if leaf.max_definition_level == 0:
        raise TypeError(f"source lacks required column {leaf.dotted_path!r}")
    t = leaf.physical_type
    offsets = None
    if t == Type.BYTE_ARRAY:
        empty = np.empty(0, np.uint8)
        offsets = np.zeros(1, np.int64)
    elif t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        empty = np.empty((0, leaf.type_length or 12), np.uint8)
    else:
        empty = np.empty(0, dtype=leaf.np_dtype() or np.uint8)
    if leaf.max_repetition_level > 1:
        if not leaf.ancestors or leaf.ancestors[0].repetition == Rep.REQUIRED:
            # def 0 would say a REQUIRED outer field is absent
            raise NotImplementedError(
                f"cannot null-fill required nested column "
                f"{leaf.dotted_path!r}")
        return ColumnData(values=empty, offsets=offsets,
                          def_levels=np.zeros(n, np.int32),
                          rep_levels=np.zeros(n, np.int32))
    if leaf.max_repetition_level:
        return ColumnData(values=empty, offsets=offsets,
                          list_offsets=[np.zeros(n + 1, np.int64)],
                          list_validity=[np.zeros(n, dtype=bool)])
    return ColumnData(values=empty, offsets=offsets,
                      validity=np.zeros(n, dtype=bool))


def _host(t):
    return None if t is None else t.cpu().numpy()


def column_to_data(col: Column, src: Leaf,
                   dst: Optional[Leaf] = None) -> ColumnData:
    """A decoded :class:`Column` (on any device) as writable
    :class:`ColumnData` on the host, widened to ``dst``'s type: one copy
    a tensor (:meth:`Column.host_dense`)."""
    dst = dst or src
    values, offsets = col.host_dense()
    validity = _host(col.validity)
    if src.physical_type != dst.physical_type \
            or _time_rescale(src, dst) is not None:
        values = convert_values(values, src, dst)
    cd = ColumnData(values=values, offsets=offsets, validity=validity)
    if len(col.list_offsets) > 1:
        # the raw-level form: a null struct between two repeated levels
        # survives; widening never changes the structure
        if (src.max_definition_level != dst.max_definition_level
                or src.max_repetition_level != dst.max_repetition_level):
            raise TypeError(
                f"cannot convert {src.dotted_path!r}: nesting structure "
                "differs")
        if col.def_levels is None or col.rep_levels is None:
            raise ValueError("multi-level list conversion needs raw "
                             "def/rep levels on the Column")
        cd.validity = None
        cd.def_levels = np.asarray(col.def_levels, np.int32)
        cd.rep_levels = np.asarray(col.rep_levels, np.int32)
    elif col.list_offsets:
        cd.list_offsets = [_host(col.list_offsets[0]).astype(np.int64)]
        lv = _host(col.list_validity[0]) if col.list_validity else None
        cd.list_validity = (None if lv is None or bool(np.all(lv))
                            else [lv])
    return cd


def convert_table(pf_or_rg, target: Schema, device="cuda"):
    """Every row group of a file (or one row group) as ``(columns,
    num_rows)`` of the target schema, decoded on ``device``."""
    from ..io.reader import ParquetFile

    if isinstance(pf_or_rg, ParquetFile):
        rgs = pf_or_rg.row_groups
        src_schema = pf_or_rg.schema
    else:
        rgs = [pf_or_rg]
        src_schema = pf_or_rg.file.schema
    out = []
    for rg in rgs:
        cols = {leaf.dotted_path: convert_column_data(rg, leaf, src_schema,
                                                      device)
                for leaf in target.leaves}
        out.append((cols, rg.num_rows))
    return out
