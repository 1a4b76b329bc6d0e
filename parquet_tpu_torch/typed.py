"""Typed front end: dataclasses to Parquet and back.

The port of ``parquet_tpu/typed.py``.  :func:`schema_of` derives a schema
from a dataclass's type hints (:data:`_SCALAR_MAP` for the scalars,
``Optional`` for nullable fields, ``List``/``Dict`` for lists and maps,
nested dataclasses for groups); :class:`TypedWriter` and
:func:`write_objects` shred instances into the writer's columns, a field
at a time; :class:`TypedReader` and :func:`read_objects` build instances
from decoded columns, whose per-row Python values come from
:meth:`Column.to_pylist` (the objects pyarrow gives in the JAX package).
``TypedReader.read(n)`` drains the streamed read (``iter_batches`` on
``device``), a batch at a time; :func:`read_pytree` returns the columns
as tensors on the device.
"""

from __future__ import annotations

import dataclasses
import datetime
import types
import typing
from typing import Any, Dict, List, Optional, Sequence, Type as PyType

import numpy as np

from .format.enums import FieldRepetitionType as Rep, Type
from .io.reader import ParquetFile
from .io.writer import ColumnData, ParquetWriter, WriterOptions
from .schema import schema as sch
from .schema.schema import Schema
from .schema.types import LogicalKind

# Python type -> (physical, logical kind, parameters)
_SCALAR_MAP = {
    bool: (Type.BOOLEAN, LogicalKind.NONE, {}),
    int: (Type.INT64, LogicalKind.NONE, {}),
    float: (Type.DOUBLE, LogicalKind.NONE, {}),
    str: (Type.BYTE_ARRAY, LogicalKind.STRING, {}),
    bytes: (Type.BYTE_ARRAY, LogicalKind.NONE, {}),
    np.int8: (Type.INT32, LogicalKind.INT, {"bit_width": 8, "signed": True}),
    np.int16: (Type.INT32, LogicalKind.INT, {"bit_width": 16, "signed": True}),
    np.int32: (Type.INT32, LogicalKind.NONE, {}),
    np.int64: (Type.INT64, LogicalKind.NONE, {}),
    np.uint8: (Type.INT32, LogicalKind.INT, {"bit_width": 8, "signed": False}),
    np.uint16: (Type.INT32, LogicalKind.INT,
                {"bit_width": 16, "signed": False}),
    np.uint32: (Type.INT32, LogicalKind.INT,
                {"bit_width": 32, "signed": False}),
    np.uint64: (Type.INT64, LogicalKind.INT,
                {"bit_width": 64, "signed": False}),
    np.float32: (Type.FLOAT, LogicalKind.NONE, {}),
    np.float64: (Type.DOUBLE, LogicalKind.NONE, {}),
    datetime.date: (Type.INT32, LogicalKind.DATE, {}),
    datetime.datetime: (Type.INT64, LogicalKind.TIMESTAMP_MICROS,
                        {"utc": True}),
}


def _unwrap_optional(hint):
    origin = typing.get_origin(hint)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1 and type(None) in typing.get_args(hint):
            return args[0], True
    return hint, False


def schema_of(cls: PyType) -> Schema:
    """A dataclass's schema: a field a column or group."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    hints = typing.get_type_hints(cls)
    return sch.message(cls.__name__, [_field_node(f.name, hints[f.name])
                                      for f in dataclasses.fields(cls)])


def _scalar_leaf(name: str, hint, rep: Rep) -> sch.Node:
    phys, kind, params = _SCALAR_MAP[hint]
    return sch.leaf(name, phys, rep, kind, **params)


def _repeated_group(name: str, cls, rep: Rep = Rep.REQUIRED) -> sch.Node:
    """The element or value group under a repeated wrapper: scalar fields
    only (deeper nesting goes through the row model)."""
    hints = typing.get_type_hints(cls)
    kids = []
    for f in dataclasses.fields(cls):
        h, opt = _unwrap_optional(hints[f.name])
        if h not in _SCALAR_MAP:
            raise TypeError(
                f"field {f.name!r} of repeated group {cls.__name__}: only "
                "scalar fields are supported inside lists/maps of dataclasses")
        kids.append(_scalar_leaf(f.name, h,
                                 Rep.OPTIONAL if opt else Rep.REQUIRED))
    return sch.group(name, kids, rep)


def _field_node(name: str, hint) -> sch.Node:
    hint, is_opt = _unwrap_optional(hint)
    rep = Rep.OPTIONAL if is_opt else Rep.REQUIRED
    origin = typing.get_origin(hint)
    if origin in (list, typing.List):
        (elem_hint,) = typing.get_args(hint)
        elem_hint, elem_opt = _unwrap_optional(elem_hint)
        if dataclasses.is_dataclass(elem_hint):
            if elem_opt:  # a list holds values, never None structs
                raise TypeError("Optional list elements of dataclass type "
                                "are not supported (Go []T parity: values, "
                                "not nil)")
            return sch.list_of(name, _repeated_group("element", elem_hint),
                               rep)
        elem = _scalar_leaf("element", elem_hint,
                            Rep.OPTIONAL if elem_opt else Rep.REQUIRED)
        return sch.list_of(name, elem, rep)
    if origin in (dict, typing.Dict):
        key_hint, val_hint = typing.get_args(hint)
        if key_hint not in _SCALAR_MAP:
            raise TypeError(f"map key type {key_hint!r} for {name!r} must be "
                            "a scalar")
        key = _scalar_leaf("key", key_hint, Rep.REQUIRED)
        val_hint, val_opt = _unwrap_optional(val_hint)
        if dataclasses.is_dataclass(val_hint):
            if val_opt:
                raise TypeError("Optional map values of dataclass type are "
                                "not supported (map[K]V parity: values)")
            value = _repeated_group("value", val_hint)
        elif val_hint in _SCALAR_MAP:
            value = _scalar_leaf("value", val_hint,
                                 Rep.OPTIONAL if val_opt else Rep.REQUIRED)
        else:
            raise TypeError(f"unsupported map value type {val_hint!r} for "
                            f"{name!r}")
        return sch.map_of(name, key, value, rep)
    if dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        return sch.group(name, [_field_node(f.name, hints[f.name])
                                for f in dataclasses.fields(hint)], rep)
    if hint in _SCALAR_MAP:
        return _scalar_leaf(name, hint, rep)
    raise TypeError(f"unsupported field type {hint!r} for {name!r}")


# ---------------------------------------------------------------------------
# shredding: instances -> ColumnData, a field at a time
# ---------------------------------------------------------------------------


def _shred(objs: Sequence[Any], schema: Schema) -> Dict[str, ColumnData]:
    return {leaf.dotted_path: _shred_leaf(objs, leaf)
            for leaf in schema.leaves}


def _getter(path):
    """The leaf path's walk over an instance.  ``list`` takes a Python
    list (the rest of the path applies to each element), ``key_value`` a
    dict (``key``/``value`` pick the stream); by the value met, so that a
    field named ``list`` or ``key_value`` still resolves by getattr."""

    def walk(o, path):
        for i, p in enumerate(path):
            if o is None:
                return None
            if p == "list" and isinstance(o, (list, tuple, np.ndarray)):
                rest = path[i + 2:]  # past the "element" wrapper
                if not rest:
                    return o
                return [None if e is None else walk(e, rest) for e in o]
            if p == "key_value" and isinstance(o, dict):
                sel, rest = path[i + 1], path[i + 2:]
                items = list(o.keys() if sel == "key" else o.values())
                if not rest:
                    return items
                return [None if e is None else walk(e, rest) for e in items]
            o = getattr(o, p)
        return o

    return lambda o: walk(o, path)


def _shred_leaf(objs: Sequence[Any], leaf) -> ColumnData:
    get = _getter(leaf.path)
    raw = [get(o) for o in objs]
    if leaf.max_repetition_level:
        lens = [0 if v is None else len(v) for v in raw]
        lo = np.zeros(len(raw) + 1, np.int64)
        np.cumsum(lens, out=lo[1:])
        lv = (np.array([v is not None for v in raw])
              if any(v is None for v in raw) else None)
        flat = [e for v in raw if v is not None for e in v]
        ev = (np.array([e is not None for e in flat])
              if any(e is None for e in flat) else None)
        cd = _scalars_to_cd([e for e in flat if e is not None], leaf)
        cd.validity = ev
        cd.list_offsets = [lo]
        cd.list_validity = None if lv is None else [lv]
        return cd
    validity = None
    dense = raw
    if any(v is None for v in raw):
        validity = np.array([v is not None for v in raw])
        dense = [v for v in raw if v is not None]
    cd = _scalars_to_cd(dense, leaf)
    cd.validity = validity
    return cd


def _scalars_to_cd(dense: list, leaf) -> ColumnData:
    t = leaf.physical_type
    if t == Type.BYTE_ARRAY:
        bs = [v.encode() if isinstance(v, str) else bytes(v) for v in dense]
        offs = np.zeros(len(bs) + 1, np.int64)
        np.cumsum([len(b) for b in bs], out=offs[1:])
        return ColumnData(values=np.frombuffer(b"".join(bs), np.uint8),
                          offsets=offs)
    if leaf.logical_kind == LogicalKind.DATE:
        epoch = datetime.date(1970, 1, 1)
        return ColumnData(values=np.array(
            [(v - epoch).days if isinstance(v, datetime.date) else int(v)
             for v in dense], dtype=np.int32))
    if leaf.logical_kind == LogicalKind.TIMESTAMP_MICROS:
        def to_us(v):
            if isinstance(v, datetime.datetime):
                if v.tzinfo is None:
                    v = v.replace(tzinfo=datetime.timezone.utc)
                return int(v.timestamp() * 1_000_000)
            return int(v)

        return ColumnData(values=np.array([to_us(v) for v in dense],
                                          dtype=np.int64))
    dtype = {Type.BOOLEAN: np.bool_, Type.INT32: np.int32,
             Type.INT64: np.int64, Type.FLOAT: np.float32,
             Type.DOUBLE: np.float64}[t]
    return ColumnData(values=np.asarray(dense, dtype=dtype))


# ---------------------------------------------------------------------------
# assembly: decoded columns -> instances
# ---------------------------------------------------------------------------


def _assemble(cls, schema: Schema, tab) -> list:
    return _assemble_rows(cls, schema, tab, ())


def _assemble_rows(cls, schema: Schema, tab, prefix) -> list:
    hints = typing.get_type_hints(cls)
    field_values = {f.name: _field_pylist(hints[f.name], f.name, schema,
                                          tab, prefix)
                    for f in dataclasses.fields(cls)}
    n = max((len(v) for v in field_values.values()), default=0)
    names = list(field_values)
    return [cls(**{k: field_values[k][i] for k in names}) for i in range(n)]


def _zip_structs_ragged(cls, tab, base_path) -> list:
    """Per-row lists of ``cls`` instances from the scalar leaves under a
    repeated group: each leaf shares the group's offsets, so its rows line
    up."""
    names = [f.name for f in dataclasses.fields(cls)]
    per_field = [tab[".".join(base_path + (fname,))].to_pylist()
                 for fname in names]
    out = []
    for row_lists in zip(*per_field):
        if row_lists[0] is None:
            out.append(None)
            continue
        out.append([cls(**dict(zip(names, elem)))
                    for elem in zip(*row_lists)])
    return out


def _field_pylist(hint, name: str, schema: Schema, tab, prefix) -> list:
    hint, _ = _unwrap_optional(hint)
    origin = typing.get_origin(hint)
    path = prefix + (name,)
    if origin in (dict, typing.Dict):
        _, val_hint = typing.get_args(hint)
        val_hint, _ = _unwrap_optional(val_hint)
        keys = tab[".".join(path + ("key_value", "key"))].to_pylist()
        if dataclasses.is_dataclass(val_hint):
            vals = _zip_structs_ragged(val_hint, tab,
                                       path + ("key_value", "value"))
        else:
            vals = tab[".".join(path + ("key_value", "value"))].to_pylist()
        return [None if k is None else dict(zip(k, v))
                for k, v in zip(keys, vals)]
    if origin in (list, typing.List):
        (elem_hint,) = typing.get_args(hint)
        elem_hint, _ = _unwrap_optional(elem_hint)
        if dataclasses.is_dataclass(elem_hint):
            return _zip_structs_ragged(elem_hint, tab,
                                       path + ("list", "element"))
    if dataclasses.is_dataclass(hint):
        return _assemble_rows(hint, schema, tab, path)
    dotted = ".".join(path)
    leaf_path = next(p for p in tab.keys()
                     if p == dotted or p.startswith(dotted + "."))
    return tab[leaf_path].to_pylist()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class TypedWriter:
    """Buffered typed writes: instances gather until a row group's worth,
    then shred into the writer's buffered :meth:`ParquetWriter.write`."""

    def __init__(self, sink, cls: PyType,
                 options: Optional[WriterOptions] = None):
        self.cls = cls
        self.schema = schema_of(cls)
        self.writer = ParquetWriter(sink, self.schema, options)
        self._pending: List[Any] = []

    def write(self, objs: Sequence[Any]) -> None:
        self._pending.extend(objs)
        if len(self._pending) >= self.writer.options.row_group_size:
            self.flush()

    def flush(self) -> None:
        """Hand the pending instances to the writer, which writes full
        row groups and keeps the tail (written at :meth:`close`)."""
        if not self._pending:
            return
        cols = _shred(self._pending, self.schema)
        self.writer.write(cols, len(self._pending))
        self._pending = []

    def close(self) -> None:
        try:
            self.flush()
            self.writer.close()
        except BaseException:
            self.writer.abort()  # a path the writer opened is removed
            raise

    def abort(self) -> None:
        """Drop the pending instances and abort the writer (no footer; a
        path the writer opened is removed)."""
        self._pending = []
        self.writer.abort()

    @property
    def write_stats(self):
        """The underlying writer's
        :class:`~parquet_tpu_torch.io.sink.WriteStats`."""
        return self.writer.write_stats

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        elif not self.writer._aborted:
            self.close()


class TypedReader:
    """Batched typed reads.  ``read(n)`` drains the streamed read on
    ``device`` (``iter_batches``) and builds instances a batch at a time,
    so memory stays a batch's, not the file's; ``read_all`` takes the whole
    read."""

    def __init__(self, source, cls: PyType, batch_rows: int = 65536,
                 device="cuda"):
        self.cls = cls
        self.file = (source if isinstance(source, ParquetFile)
                     else ParquetFile(source))
        self.device = device
        self._batch_rows = batch_rows
        self._it = None
        self._buf: list = []
        self._bpos = 0

    def read_all(self) -> list:
        return _assemble(self.cls, self.file.schema,
                         self.file.read(device=self.device))

    def read(self, n: int) -> list:
        out: list = []
        while len(out) < n:
            avail = len(self._buf) - self._bpos
            if avail > 0:
                take = min(avail, n - len(out))
                out.extend(self._buf[self._bpos:self._bpos + take])
                self._bpos += take
                continue
            if self._it is None:
                self._it = iter(self.file.iter_batches(
                    batch_rows=self._batch_rows, device=self.device))
            batch = next(self._it, None)
            if batch is None:
                break
            self._buf = _assemble(self.cls, self.file.schema, batch)
            self._bpos = 0
        return out


def write_objects(objs: Sequence[Any], sink, cls: Optional[PyType] = None,
                  options: Optional[WriterOptions] = None) -> None:
    """Write instances of a dataclass (``cls``, else the first object's
    type) to ``sink``."""
    if cls is None:
        if not objs:
            raise ValueError("cannot infer type from zero objects")
        cls = type(objs[0])
    w = TypedWriter(sink, cls, options)
    try:
        w.write(list(objs))
        w.close()
    except BaseException:
        w.abort()
        raise


def read_objects(source, cls: PyType, device="cuda") -> list:
    """Every row of ``source`` as an instance of ``cls``."""
    return TypedReader(source, cls, device=device).read_all()


def read_pytree(source, columns=None, device="cuda"):
    """The selected columns as a dict of tensors on ``device``: a flat
    column its values, a byte-array column ``{"values", "offsets"}``, a
    dictionary column ``{"dictionary", "indices"}``."""
    pf = source if isinstance(source, ParquetFile) else ParquetFile(source)
    tab = pf.read(columns=columns, device=device)
    out = {}
    for path, col in tab.items():
        if col.is_dictionary_encoded():
            out[path] = {"dictionary": col.dictionary,
                         "indices": col.dict_indices}
        elif col.offsets is not None:
            out[path] = {"values": col.values, "offsets": col.offsets}
        else:
            out[path] = col.values
    return out
