"""Exact key equality over row-aligned host spans.

The port's cut of ``parquet_tpu/parallel/host_scan.py``: the point-lookup
face of the scan's predicate mask, for the port's INT32/INT64/FLOAT/DOUBLE
columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def aligned_key_mask(leaf, key, values: np.ndarray,
                     validity: Optional[np.ndarray]) -> np.ndarray:
    """Rows of a row-aligned span equal to one normalized ``key``: the
    reference's inclusive range ``key <= v <= key`` in numpy, so NaN never
    matches and ``-0.0 == 0.0``; a NULL slot never matches."""
    values = np.asarray(values)
    base = (values >= key) & (values <= key)
    if validity is not None:
        base &= np.asarray(validity, bool)
    return base
