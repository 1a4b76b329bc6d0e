"""Typed column statistics (zone maps).

The port's copy of ``parquet_tpu/io/statistics.py``: min/max bytes decode
into the leaf's order domain (:mod:`..algebra.compare`), and
:func:`may_contain_range` is the one conservative interval rule the
lookup's statistics stage applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..format import metadata as md
from ..format.enums import Type
from ..schema.schema import Leaf


@dataclass
class TypedStatistics:
    min_value: Any = None
    max_value: Any = None
    null_count: Optional[int] = None
    distinct_count: Optional[int] = None


def decode_stat_value(raw: Optional[bytes], leaf: Leaf):
    """Statistics bytes in the leaf's order domain."""
    from ..algebra.compare import decode_order_value

    return decode_order_value(raw, leaf)


def encode_stat_value(value, physical: Type) -> bytes:
    if value is None:
        return b""
    if physical == Type.BOOLEAN:
        return bytes([1 if value else 0])
    if physical == Type.INT32:
        return np.int32(value).tobytes()
    if physical == Type.INT64:
        return np.int64(value).tobytes()
    if physical == Type.FLOAT:
        return np.float32(value).tobytes()
    if physical == Type.DOUBLE:
        return np.float64(value).tobytes()
    return bytes(value)


def may_contain_range(st: Optional[TypedStatistics], lo=None,
                      hi=None) -> bool:
    """False only when the statistics PROVE no value in ``[lo, hi]``
    exists.  Missing statistics, and probes that do not compare with the
    decoded bounds, are inconclusive and answer True."""
    if st is None or st.min_value is None or st.max_value is None:
        return True
    try:
        if lo is not None and st.max_value < lo:
            return False
        if hi is not None and st.min_value > hi:
            return False
    except TypeError:
        return True
    return True


def decode_statistics(stats: Optional[md.Statistics], leaf: Leaf
                      ) -> Optional[TypedStatistics]:
    if stats is None:
        return None
    mn = stats.min_value if stats.min_value is not None else stats.min
    mx = stats.max_value if stats.max_value is not None else stats.max
    return TypedStatistics(
        min_value=decode_stat_value(mn, leaf),
        max_value=decode_stat_value(mx, leaf),
        null_count=stats.null_count,
        distinct_count=stats.distinct_count,
    )
