"""Order-domain values: statistics bytes <-> python scalars, and probe
normalization.

The port's cut of ``parquet_tpu/algebra/compare.py``, with its ordering
rules:

- INT32/INT64: signed, or unsigned where the leaf's INT annotation says so
  (:func:`is_unsigned`: pyarrow's ``uint32``/``uint64``,
  ``INTEGER(signed=false)`` and the legacy ``UINT_*``), so that an unsigned
  column's statistics, page-index bounds and probes compare in unsigned
  order;
- DECIMAL: the unscaled integer (INT32/INT64 storage as it is, FLBA and
  BYTE_ARRAY storage big-endian two's complement), and a ``Decimal`` probe
  scaled into it;
- FLOAT/DOUBLE: numeric, BOOLEAN as ``bool``;
- BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY and INT96 (not decimal): ``bytes`` in
  unsigned lexicographic order (a ``str`` probe is its UTF-8 bytes).

The sort's side (:func:`compare_func_of`, :func:`sort_key`): nulls go
first or last whatever the direction, NaN after every number, and equal
values take equal ranks, so that ties fall through to the next key.
"""

from __future__ import annotations

import decimal
from typing import Any, Callable, Optional

import numpy as np

from ..format.enums import Type
from ..ops import host
from ..schema.schema import Leaf
from ..schema.types import LogicalKind

_DECODE = {Type.INT32: np.int32, Type.INT64: np.int64,
           Type.FLOAT: np.float32, Type.DOUBLE: np.float64}
_UNSIGNED = {Type.INT32: np.uint32, Type.INT64: np.uint64}


def is_unsigned(leaf: Leaf) -> bool:
    """True when the leaf's logical type orders as an unsigned integer."""
    if leaf.logical_kind == LogicalKind.INT:
        return not (leaf.logical_params or {}).get("signed", True)
    return False


def _is_decimal(leaf: Leaf) -> bool:
    return leaf.logical_kind == LogicalKind.DECIMAL


def int_to_be_bytes(value: int, length: Optional[int] = None) -> bytes:
    """An unscaled decimal as big-endian two's complement: ``length`` bytes
    (an FLBA column's width), or the fewest that hold it (BYTE_ARRAY)."""
    if length is None:
        length = max(1, (value.bit_length() + 8) // 8)
    return int(value).to_bytes(length, "big", signed=True)


def decode_order_value(raw: Optional[bytes], leaf: Leaf):
    """Statistics bytes -> python int/float/bool/bytes; None when missing,
    or empty for a type whose values are never empty (the empty bound a
    writer gives an all-NaN page), so that every consumer treats it as an
    unknown bound.  The reference keeps ``b""`` there, which its page
    search and boundary order cannot compare.  An empty BYTE_ARRAY bound
    is the empty string (a decimal one, 0 as the reference reads it)."""
    if raw is None:
        return None
    t = leaf.physical_type
    if t != Type.BYTE_ARRAY and not raw:
        return None
    if t == Type.BOOLEAN:
        return bool(raw[0])
    dt = (_UNSIGNED.get(t) if is_unsigned(leaf) else None) or _DECODE.get(t)
    if dt is not None:
        width = np.dtype(dt).itemsize
        return np.frombuffer(bytes(raw[:width]), dt)[0].item()
    if _is_decimal(leaf):  # FLBA / BYTE_ARRAY: big-endian two's complement
        return int.from_bytes(bytes(raw), "big", signed=True)
    return bytes(raw)


def encode_order_value(value, leaf: Leaf) -> bytes:
    """A python value of the order domain -> statistics bytes."""
    if value is None:
        return b""
    if leaf.physical_type == Type.BOOLEAN:
        return bytes([1 if value else 0])
    t = leaf.physical_type
    dt = (_UNSIGNED.get(t) if is_unsigned(leaf) else None) or _DECODE.get(t)
    if dt is not None:
        return dt(value).tobytes()
    if _is_decimal(leaf) and isinstance(value, int):
        # the unscaled int as storage bytes: an FLBA's width, a byte
        # array's fewest
        width = leaf.type_length if t == Type.FIXED_LEN_BYTE_ARRAY else None
        return int_to_be_bytes(value, width)
    return bytes(value)


def normalize(leaf: Leaf, value):
    """A user's probe value in the leaf's order domain (the domain
    :func:`decode_order_value` returns): ``str`` -> UTF-8 bytes,
    ``Decimal`` -> its unscaled integer at the leaf's scale, numpy scalars
    -> python scalars; anything else passes through."""
    if value is None:
        return None
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, decimal.Decimal):
        scale = (leaf.logical_params or {}).get("scale", 0)
        return int(value.scaleb(scale).to_integral_value())
    if isinstance(value, np.generic):
        return value.item()
    return value


def normalize_probe(leaf: Leaf, value):
    """The canonical form of an equality probe, or None when the value can
    never equal a value of the leaf's type: a non-integral float, a
    non-number, or an int outside the (signed or unsigned) range of an
    integer column."""
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
        lo, hi = int_domain(leaf)
        return value if lo <= value < hi else None
    return value


def int_domain(leaf: Leaf):
    """``[lo, hi)`` of an INT32/INT64 leaf's order domain."""
    bits = 32 if leaf.physical_type == Type.INT32 else 64
    if is_unsigned(leaf):
        return 0, 2 ** bits
    return -(2 ** (bits - 1)), 2 ** (bits - 1)


def min_max(leaf: Leaf, values: np.ndarray,
            offsets: Optional[np.ndarray] = None):
    """(min, max) of a span of present values in the order domain
    (unsigned ints in unsigned order, byte-array and FLBA decimals as their
    unscaled ints), NaNs skipped; (None, None) when the span is empty or
    all NaN, and for INT96 (no order).  Byte arrays pass their
    ``offsets``; fixed-length byte arrays are (n, w) rows."""
    t = leaf.physical_type
    n = len(offsets) - 1 if offsets is not None else len(values)
    if n == 0 or t == Type.INT96:
        return None, None
    if t in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        if offsets is None:  # (n, w) rows
            w = values.shape[1]
            values = np.ascontiguousarray(values).reshape(-1)
            offsets = np.arange(n + 1, dtype=np.int64) * w
        vals = host.as_u8(values)
        if _is_decimal(leaf):  # two's complement order, not bytewise
            ints = [int.from_bytes(vals[offsets[i]:offsets[i + 1]].tobytes(),
                                   "big", signed=True) for i in range(n)]
            return min(ints), max(ints)
        mi, ma = host.minmax_byte_arrays(values, offsets, 0, n)
        return (vals[offsets[mi]:offsets[mi + 1]].tobytes(),
                vals[offsets[ma]:offsets[ma + 1]].tobytes())
    if is_unsigned(leaf) and values.dtype in (np.dtype(np.int32),
                                              np.dtype(np.int64)):
        values = values.view(np.uint32 if values.dtype == np.int32
                             else np.uint64)
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


def _twos_complement_be(raw: bytes) -> int:
    return int.from_bytes(raw, "big", signed=True)


def compare_func_of(leaf: Leaf, descending: bool = False,
                    nulls_first: bool = False) -> Callable[[Any, Any], int]:
    """``cmp(a, b)`` -> -1/0/1 over order-domain values (None is null):
    nulls first or last whatever ``descending`` says, NaN after every
    number."""
    null_rank = -1 if nulls_first else 1

    def cmp(a, b) -> int:
        if a is None or b is None:
            if a is None and b is None:
                return 0
            return null_rank if a is None else -null_rank
        if a != a or b != b:  # NaN: after every number
            if a != a and b != b:
                return 0
            base = 1 if a != a else -1
        else:
            base = -1 if a < b else (1 if a > b else 0)
        return -base if descending else base

    return cmp


def _dense_order_values(leaf: Leaf, cd, v0: int = 0,
                        v1: Optional[int] = None) -> np.ndarray:
    """Present values ``[v0, v1)`` of a :class:`ColumnData` in the order
    domain: an object array of ``bytes`` (or decimal ints) for byte
    arrays, FLBA and INT96, else the numeric array (unsigned columns
    viewed unsigned)."""
    t = leaf.physical_type
    vals = np.asarray(cd.values)
    if t == Type.BYTE_ARRAY:
        offs = np.asarray(cd.offsets, np.int64)
        if v1 is None:
            v1 = len(offs) - 1
        u8 = host.as_u8(vals)
        items = [u8[offs[i]:offs[i + 1]].tobytes() for i in range(v0, v1)]
    elif t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        rows = host.as_u8(np.ascontiguousarray(vals)).reshape(
            -1, leaf.type_length if t == Type.FIXED_LEN_BYTE_ARRAY else 12)
        if v1 is None:
            v1 = len(rows)
        items = [r.tobytes() for r in rows[v0:v1]]
    else:
        if v1 is None:
            v1 = len(vals)
        vals = vals[v0:v1]
        if is_unsigned(leaf) and vals.dtype in (np.dtype(np.int32),
                                                np.dtype(np.int64)):
            return vals.view(_UNSIGNED[t])
        return vals
    if _is_decimal(leaf):
        items = [_twos_complement_be(x) for x in items]
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def sort_key(leaf: Leaf, cd, n: int, descending: bool = False,
             nulls_first: bool = False) -> np.ndarray:
    """A per-row sort key of one flat leaf for ``np.lexsort``: the values
    themselves where nothing is null and the order is ascending and
    numeric, else ranks (equal values equal ranks; nulls before or after
    every value by ``nulls_first``, whatever the direction)."""
    dense = _dense_order_values(leaf, cd)
    validity = cd.validity
    if validity is None and not descending and dense.dtype != object:
        return dense
    uniq, inv = np.unique(dense, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64) + 1  # present ranks 1..k
    k = len(uniq)
    if validity is None:
        ranks = inv
    else:
        validity = np.asarray(validity, bool)
        ranks = np.empty(n, np.int64)
        ranks[validity] = inv
        ranks[~validity] = 0 if nulls_first else k + 1
    if descending:  # flip the present ranks; nulls keep their place
        flipped = (k + 1) - ranks
        if validity is not None:
            flipped[~validity] = ranks[~validity]
        ranks = flipped
    return ranks
