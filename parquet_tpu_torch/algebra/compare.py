"""Order-domain values: statistics bytes <-> python scalars, and probe
normalization.

The port's cut of ``parquet_tpu/algebra/compare.py``.  The port's schema
carries no logical types but STRING, so every integer orders signed (the
reference's ``is_unsigned`` is always False here) and there are no
decimals.  Numbers decode to python ``int``/``float``, BOOLEAN to
``bool``, and BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY and INT96 to ``bytes`` in
unsigned lexicographic order, so statistics, page-index bounds and
normalized probes compare with each other exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..format.enums import Type
from ..ops import host
from ..schema.schema import Leaf

_DECODE = {Type.INT32: np.int32, Type.INT64: np.int64,
           Type.FLOAT: np.float32, Type.DOUBLE: np.float64}


def decode_order_value(raw: Optional[bytes], leaf: Leaf):
    """Statistics bytes -> python int/float/bool/bytes; None when missing,
    or empty for a type whose values are never empty (the empty bound a
    writer gives an all-NaN page), so that every consumer treats it as an
    unknown bound.  The reference keeps ``b""`` there, which its page
    search and boundary order cannot compare.  An empty BYTE_ARRAY bound
    is the empty string."""
    if raw is None:
        return None
    if leaf.physical_type == Type.BYTE_ARRAY:
        return bytes(raw)
    if not raw:
        return None
    if leaf.physical_type == Type.BOOLEAN:
        return bool(raw[0])
    dt = _DECODE.get(leaf.physical_type)
    if dt is None:
        return bytes(raw)
    width = np.dtype(dt).itemsize
    return np.frombuffer(bytes(raw[:width]), dt)[0].item()


def encode_order_value(value, leaf: Leaf) -> bytes:
    """A python value of the order domain -> statistics bytes."""
    if value is None:
        return b""
    if leaf.physical_type == Type.BOOLEAN:
        return bytes([1 if value else 0])
    dt = _DECODE.get(leaf.physical_type)
    return bytes(value) if dt is None else dt(value).tobytes()


def normalize(leaf: Leaf, value):
    """A user's probe value in the order domain: numpy scalars become
    python scalars; anything else passes through."""
    if isinstance(value, np.generic):
        return value.item()
    return value


def normalize_probe(leaf: Leaf, value):
    """The canonical form of an equality probe, or None when the value can
    never equal a value of the leaf's type: a non-integral float or an
    out-of-range int on an integer column, a non-number on an integer
    column."""
    value = normalize(leaf, value)
    if value is None:
        return None
    t = leaf.physical_type
    if t in (Type.INT32, Type.INT64):
        if isinstance(value, float):
            if not value.is_integer():
                return None
            value = int(value)
        if not isinstance(value, (int, np.integer)):
            return None
        value = int(value)
        bits = 31 if t == Type.INT32 else 63
        return value if -(2 ** bits) <= value < 2 ** bits else None
    return value


def min_max(leaf: Leaf, values: np.ndarray,
            offsets: Optional[np.ndarray] = None):
    """(min, max) of a span of present values in the order domain, NaNs
    skipped; (None, None) when the span is empty or all NaN, and for INT96
    (no order).  Byte arrays pass their ``offsets``; fixed-length byte
    arrays are (n, w) rows."""
    t = leaf.physical_type
    n = len(offsets) - 1 if offsets is not None else len(values)
    if n == 0 or t == Type.INT96:
        return None, None
    if t in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        if offsets is None:  # (n, w) rows
            w = values.shape[1]
            values = np.ascontiguousarray(values).reshape(-1)
            offsets = np.arange(n + 1, dtype=np.int64) * w
        mi, ma = host.minmax_byte_arrays(values, offsets, 0, n)
        vals = host.as_u8(values)
        return (vals[offsets[mi]:offsets[mi + 1]].tobytes(),
                vals[offsets[ma]:offsets[ma + 1]].tobytes())
    if leaf.physical_type in (Type.FLOAT, Type.DOUBLE):
        mn = values.min()
        if not np.isnan(mn):
            return mn.item(), values.max().item()
        if bool(np.isnan(values).all()):
            return None, None
        return np.nanmin(values).item(), np.nanmax(values).item()
    return values.min().item(), values.max().item()


def truncate_stat_min(raw: bytes, limit: int) -> bytes:
    """A bytewise-ordered min cut to ``limit`` bytes: any prefix is <= the
    value in unsigned byte order (the page index's size limit)."""
    return raw if len(raw) <= limit else raw[:limit]


def truncate_stat_max(raw: bytes, limit: int) -> Optional[bytes]:
    """The shortest prefix, last byte incremented, that is >= the value in
    unsigned byte order; None when there is none (all 0xFF: the caller
    keeps the value whole)."""
    if len(raw) <= limit:
        return raw
    b = bytearray(raw[:limit])
    for i in reversed(range(len(b))):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[:i + 1])
    return None
