"""Aggregate expression nodes: what ``Dataset.aggregate`` evaluates.

The port's copy of ``parquet_tpu/algebra/aggregate.py``.  The predicate
algebra (algebra/expr.py) describes which rows a query wants; this module describes what it wants to KNOW about them.  Each
node is pure data — one aggregate function over zero or one column —
and the answer cascade (io/aggregate.py) resolves each (row group ×
node) pair at the cheapest tier that can prove the result exactly:
footer statistics, page-index zone maps, dictionary pages, or a decoded
fallback.

Semantics (the order-domain conventions the whole engine compares in —
algebra/compare.py — so aggregation and pruning can never disagree):

- ``count()`` counts matching rows; ``count(col)`` counts matching rows
  whose ``col`` is non-null (SQL COUNT semantics).
- ``min_``/``max_``/``top_k`` rank in the column's ORDER domain
  (strings as utf-8 bytes, decimals as unscaled ints, unsigned logical
  ints as non-negative ints) and skip NULLs; float NaN ranks with the
  statistics convention — writers drop NaN from zone maps — so NaN is
  skipped too, keeping every tier's answer identical.
- ``sum_`` adds the order-domain numeric values (integers exactly, in
  python ints — no 64-bit overflow; floats in float64); NULLs
  are skipped.  Non-decimal BYTE_ARRAY columns cannot sum.
- ``count_distinct`` counts distinct non-null (non-NaN) order-domain
  values.  It is exact — per-part value SETS merge across row groups
  and files — so memory is O(distinct values).
- ``top_k`` returns the k largest (``largest=False``: smallest) values,
  sorted best-first, decoding only pages still contending with the
  running k-th bound.
- ``sum_sq`` sums the SQUARES of the order-domain values (integers in
  exact python-int arithmetic, floats in float64) — the third moment
  base the variance fold needs; it rides every tier ``sum_`` rides
  (dictionary pages aggregate squared entries against index counts).
- ``avg`` and ``variance`` are **derived folds**: they never touch the
  cascade themselves, but expand into their base pairs —
  ``avg(x) = sum(x) / count(x)`` over ``(count, sum)``, and
  ``variance(x) = (sum_sq(x) - sum(x)²/n) / (n - ddof)`` over ``(count,
  sum, sum_sq)`` (``sample=True`` → ddof 1, Bessel's correction) — so
  both inherit the cascade's pushdown: a dictionary-tier SUM gives a
  dictionary-tier AVG for free.  Results are floats (``None`` over zero
  matching non-null rows; decimals fold their unscaled ints); float
  NaN propagates through sums into both, matching the naive fold.

Build with the module-level constructors (``count``, ``min_``, ``max_``,
``sum_``, ``sum_sq``, ``avg``, ``variance``, ``count_distinct``,
``top_k``); the trailing underscores dodge the python builtins without
renaming the concepts.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AggExpr", "count", "min_", "max_", "sum_", "sum_sq", "avg",
           "variance", "count_distinct", "top_k", "DERIVED_KINDS"]

_KINDS = ("count", "min", "max", "sum", "sum_sq", "count_distinct",
          "top_k", "avg", "variance")

# derived kind -> the base kinds its fold consumes, in fold-argument
# order; the answer cascade (io/aggregate.py) expands these into base
# aggregates and computes the fold at finalize
DERIVED_KINDS = {"avg": ("count", "sum"),
                 "variance": ("count", "sum", "sum_sq")}


class AggExpr:
    """One aggregate function over zero (``count()``) or one column.
    Pure data; ``name`` is the stable result key (``"sum(v)"``)."""

    __slots__ = ("kind", "path", "k", "largest", "ddof")

    def __init__(self, kind: str, path: Optional[str] = None,
                 k: Optional[int] = None, largest: bool = True,
                 ddof: int = 0):
        if kind not in _KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        if kind != "count" and path is None:
            raise ValueError(f"{kind} needs a column")
        if kind == "top_k":
            if k is None or k < 1:
                raise ValueError("top_k needs k >= 1")
        if ddof not in (0, 1):
            raise ValueError("ddof must be 0 (population) or 1 (sample)")
        self.kind = kind
        self.path = path
        self.k = k
        self.largest = largest
        self.ddof = ddof

    @property
    def derived(self) -> bool:
        """True for the fold-over-base kinds (``avg``/``variance``) the
        cascade answers by expansion, never directly."""
        return self.kind in DERIVED_KINDS

    @property
    def name(self) -> str:
        """Stable result key: ``count(*)``, ``min(x)``, ``top_k(x,5)``…"""
        if self.kind == "count":
            return f"count({self.path})" if self.path else "count(*)"
        if self.kind == "top_k":
            tail = "" if self.largest else ",smallest"
            return f"top_k({self.path},{self.k}{tail})"
        if self.kind == "variance" and self.ddof:
            return f"variance({self.path},sample)"
        return f"{self.kind}({self.path})"

    def __repr__(self) -> str:
        return self.name


def count(path: Optional[str] = None) -> AggExpr:
    """``count()`` = matching rows; ``count(col)`` = matching non-null."""
    return AggExpr("count", path)


def min_(path: str) -> AggExpr:
    """Smallest non-null value of ``path`` over the matching rows."""
    return AggExpr("min", path)


def max_(path: str) -> AggExpr:
    """Largest non-null value of ``path`` over the matching rows."""
    return AggExpr("max", path)


def sum_(path: str) -> AggExpr:
    """Sum of ``path`` over the matching rows (ints exact, floats f64)."""
    return AggExpr("sum", path)


def sum_sq(path: str) -> AggExpr:
    """Sum of squared values of ``path`` (ints exact, floats f64) — the
    base the variance fold consumes; useful standalone for moments."""
    return AggExpr("sum_sq", path)


def avg(path: str) -> AggExpr:
    """Arithmetic mean of the matching non-null values of ``path`` — a
    derived fold over ``(count(col), sum(col))``, so it answers at
    whatever tier those answer (float result; None over zero rows)."""
    return AggExpr("avg", path)


def variance(path: str, sample: bool = False) -> AggExpr:
    """Variance of the matching non-null values of ``path`` — a derived
    fold over ``(count, sum, sum-of-squares)``.  ``sample=True`` applies
    Bessel's correction (ddof 1; None when fewer than 2 rows)."""
    return AggExpr("variance", path, ddof=1 if sample else 0)


def count_distinct(path: str) -> AggExpr:
    """Exact distinct non-null value count of ``path``."""
    return AggExpr("count_distinct", path)


def top_k(path: str, k: int, largest: bool = True) -> AggExpr:
    """The ``k`` largest (or smallest) values of ``path``, best-first."""
    return AggExpr("top_k", path, k=k, largest=largest)
