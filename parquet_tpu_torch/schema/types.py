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

import numpy as np
import torch

from ..format.enums import Type


class LogicalKind:
    """The logical annotations the port reads: the STRING annotation of a
    byte array, the LIST and MAP annotations of a group, and the INT
    (``bit_width``, ``signed``) and DECIMAL (``precision``, ``scale``)
    annotations that set a column's order (the new LogicalType and the
    legacy ConvertedType collapse into one of these, with those parameters
    in ``logical_params``, as in the JAX package).  The writer writes the
    first three."""

    NONE = "none"
    STRING = "string"
    LIST = "list"
    MAP = "map"
    INT = "int"
    DECIMAL = "decimal"

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
