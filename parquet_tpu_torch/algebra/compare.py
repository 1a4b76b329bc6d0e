"""Order-domain values: statistics bytes <-> python scalars, and probe
normalization.

The port's cut of ``parquet_tpu/algebra/compare.py`` for the signed
INT32/INT64 and the FLOAT/DOUBLE physical types.  The port's schema carries
no logical types, so every integer orders signed (the reference's
``is_unsigned`` is always False here) and there are no decimals.  Values
decode to python ``int``/``float``, so statistics, page-index bounds and
normalized probes compare with each other exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..format.enums import Type
from ..schema.schema import Leaf

_DECODE = {Type.INT32: np.int32, Type.INT64: np.int64,
           Type.FLOAT: np.float32, Type.DOUBLE: np.float64}


def decode_order_value(raw: Optional[bytes], leaf: Leaf):
    """Statistics bytes -> python int/float; None when missing or empty
    (the empty bound a writer gives an all-NaN page), so that every
    consumer treats it as an unknown bound.  The reference keeps ``b""``
    there, which its page search and boundary order cannot compare."""
    if not raw:
        return None
    dt = _DECODE.get(leaf.physical_type)
    if dt is None:
        return bytes(raw)
    width = np.dtype(dt).itemsize
    return np.frombuffer(bytes(raw[:width]), dt)[0].item()


def encode_order_value(value, leaf: Leaf) -> bytes:
    """A python value of the order domain -> statistics bytes."""
    if value is None:
        return b""
    return _DECODE[leaf.physical_type](value).tobytes()


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


def min_max(leaf: Leaf, values: np.ndarray):
    """(min, max) of a span of present values as python scalars, NaNs
    skipped; (None, None) when the span is empty or all NaN."""
    if len(values) == 0:
        return None, None
    if leaf.physical_type in (Type.FLOAT, Type.DOUBLE):
        mn = values.min()
        if not np.isnan(mn):
            return mn.item(), values.max().item()
        if bool(np.isnan(values).all()):
            return None, None
        return np.nanmin(values).item(), np.nanmax(values).item()
    return values.min().item(), values.max().item()
