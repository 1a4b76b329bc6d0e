"""Physical types of the flat columns the port decodes, and the form each
takes in a :class:`~parquet_tpu_torch.io.column.Column`.

The port's cut of ``parquet_tpu/schema/types.py``:

- INT32, INT64, FLOAT, DOUBLE: 1-D ``int32``/``int64``/``float32``/
  ``float64`` tensors (64-bit columns are native, not the JAX package's
  uint32 pairs);
- BOOLEAN: a 1-D ``bool`` tensor;
- INT96: ``(n, 3)`` ``int32``, as the JAX package's reference decode;
- FIXED_LEN_BYTE_ARRAY: ``(n, type_length)`` ``uint8``;
- BYTE_ARRAY: ``uint8`` value bytes plus ``int64`` offsets ``[n + 1]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..format.enums import ConvertedType, Type


class LogicalKind:
    """A leaf's or group's logical annotation, as the JAX package names
    it: the new LogicalType and the legacy ConvertedType collapse into one
    of these, with their parameters in ``logical_params`` (INT:
    ``bit_width``, ``signed``; DECIMAL: ``precision``, ``scale``; TIME and
    TIMESTAMP: ``utc``).  INT and DECIMAL set a column's order; the
    others only type it.  The writer writes every one, as the JAX
    package's does."""

    NONE = "none"
    STRING = "string"
    ENUM = "enum"
    JSON = "json"
    BSON = "bson"
    UUID = "uuid"
    DECIMAL = "decimal"
    DATE = "date"
    TIME_MILLIS = "time_millis"
    TIME_MICROS = "time_micros"
    TIME_NANOS = "time_nanos"
    TIMESTAMP_MILLIS = "timestamp_millis"
    TIMESTAMP_MICROS = "timestamp_micros"
    TIMESTAMP_NANOS = "timestamp_nanos"
    INT = "int"
    FLOAT16 = "float16"
    INTERVAL = "interval"
    LIST = "list"
    MAP = "map"
    UNKNOWN = "unknown"  # the Null logical type (an always-null column)


PHYSICAL_NP_DTYPE = {
    Type.BOOLEAN: np.dtype(np.bool_),
    Type.INT32: np.dtype(np.int32),
    Type.INT64: np.dtype(np.int64),
    Type.INT96: np.dtype(np.int32),
    Type.FLOAT: np.dtype(np.float32),
    Type.DOUBLE: np.dtype(np.float64),
    Type.BYTE_ARRAY: np.dtype(np.uint8),
    Type.FIXED_LEN_BYTE_ARRAY: np.dtype(np.uint8),
}

PHYSICAL_TORCH_DTYPE = {
    Type.BOOLEAN: torch.bool,
    Type.INT32: torch.int32,
    Type.INT64: torch.int64,
    Type.INT96: torch.int32,
    Type.FLOAT: torch.float32,
    Type.DOUBLE: torch.float64,
    Type.BYTE_ARRAY: torch.uint8,
    Type.FIXED_LEN_BYTE_ARRAY: torch.uint8,
}

#: the numeric types: one value per element of a 1-D array
NUMERIC = (Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE)

# byte width of one PLAIN value of a fixed-width type (FLBA: type_length)
PHYSICAL_WIDTH = {Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4, Type.DOUBLE: 8,
                  Type.INT96: 12}


def logical_np_dtype(physical: Type, kind: str, params: dict):
    """The numpy dtype the JAX package presents a leaf's values in (its
    ``logical_np_dtype``): an INT annotation's width and sign, FLOAT16,
    else the physical dtype; None for byte arrays, FLBA and INT96."""
    if physical == Type.INT32 and kind == LogicalKind.INT:
        bw, signed = params["bit_width"], params["signed"]
        return np.dtype(f"{'i' if signed else 'u'}{max(bw, 8) // 8}")
    if physical == Type.INT64 and kind == LogicalKind.INT:
        return np.dtype("i8" if params["signed"] else "u8")
    if kind == LogicalKind.FLOAT16:
        return np.dtype(np.float16)
    if physical in NUMERIC or physical == Type.BOOLEAN:
        return PHYSICAL_NP_DTYPE[physical]
    return None


def value_width(physical: Type, type_length=None):
    """Bytes per value of a fixed-width type; None for BOOLEAN (bits) and
    BYTE_ARRAY (variable)."""
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return type_length
    return PHYSICAL_WIDTH.get(physical)


def physical_of_dtype(dtype) -> Type:
    """The physical type a 1-D numeric or bool numpy array of ``dtype`` is
    written as."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return Type.BOOLEAN
    for t in NUMERIC:
        if PHYSICAL_NP_DTYPE[t] == dtype:
            return t
    raise TypeError(f"no flat physical type for numpy dtype {dtype}; "
                    "the port writes bool, int32, int64, float32, float64, "
                    "(n, 3) int32 (INT96), (n, w) uint8 (fixed-length byte "
                    "arrays) and bytes or str objects (byte arrays)")


def empty_values(physical: Type, type_length, device) -> torch.Tensor:
    """The zero-value tensor of a column (byte arrays: their value bytes)."""
    if physical == Type.INT96:
        return torch.zeros((0, 3), dtype=torch.int32, device=device)
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return torch.zeros((0, type_length or 0), dtype=torch.uint8,
                           device=device)
    return torch.zeros(0, dtype=PHYSICAL_TORCH_DTYPE[physical],
                       device=device)


def _logical_from_element(el) -> Tuple[str, dict]:
    """A schema element's annotation and its parameters, as the JAX
    package's ``_logical_from_element`` reads them: the LogicalType union
    first, else the legacy ConvertedType."""
    K = LogicalKind
    lt = el.logicalType
    if lt is not None:
        for kind, attr in ((K.STRING, "STRING"), (K.ENUM, "ENUM"),
                           (K.JSON, "JSON"), (K.BSON, "BSON"),
                           (K.UUID, "UUID"), (K.FLOAT16, "FLOAT16")):
            if getattr(lt, attr) is not None:
                return kind, {}
        if lt.DECIMAL is not None:
            return K.DECIMAL, {"scale": lt.DECIMAL.scale or 0,
                               "precision": lt.DECIMAL.precision or 0}
        if lt.DATE is not None:
            return K.DATE, {}
        for attr in ("TIME", "TIMESTAMP"):
            t = getattr(lt, attr)
            if t is not None:
                u = t.unit
                unit = ("millis" if u.MILLIS is not None else
                        "micros" if u.MICROS is not None else "nanos")
                return (f"{attr.lower()}_{unit}",
                        {"utc": bool(t.isAdjustedToUTC)})
        if lt.INTEGER is not None:
            return K.INT, {"bit_width": lt.INTEGER.bitWidth or 64,
                           "signed": bool(lt.INTEGER.isSigned)}
        if lt.LIST is not None:
            return K.LIST, {}
        if lt.MAP is not None:
            return K.MAP, {}
        if lt.UNKNOWN is not None:
            return K.UNKNOWN, {}
    ct = el.converted_type
    if ct is None:
        return K.NONE, {}
    C = ConvertedType
    if ct == C.DECIMAL:
        return K.DECIMAL, {"scale": el.scale or 0,
                           "precision": el.precision or 0}
    if C.UINT_8 <= ct <= C.INT_64:
        return K.INT, {"bit_width": 8 << ((ct - C.UINT_8) % 4),
                       "signed": ct >= C.INT_8}
    utc = {C.TIME_MILLIS: K.TIME_MILLIS, C.TIME_MICROS: K.TIME_MICROS,
           C.TIMESTAMP_MILLIS: K.TIMESTAMP_MILLIS,
           C.TIMESTAMP_MICROS: K.TIMESTAMP_MICROS}
    if ct in utc:
        return utc[ct], {"utc": True}
    return {C.UTF8: K.STRING, C.ENUM: K.ENUM, C.JSON: K.JSON,
            C.BSON: K.BSON, C.DATE: K.DATE, C.INTERVAL: K.INTERVAL,
            C.LIST: K.LIST, C.MAP: K.MAP}.get(ct, K.NONE), {}


def node(el) -> Tuple[str, dict]:
    """A schema element's logical ``(kind, params)``, the JAX package's
    ``node``."""
    return _logical_from_element(el)
