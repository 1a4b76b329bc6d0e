"""Predicate trees: the boolean algebra the scan planner evaluates.

The port's copy of ``parquet_tpu/algebra/expr.py``.  Trees of
``And``/``Or``/``Not`` over per-column leaves: range, IN-list, equality (a
one-point range, which the bloom stage probes) and null-ness.  The tree is
pure data: no IO happens in this module.  :func:`prepare` normalizes a tree
against a file schema once, and the planner (``io/planner.py``) evaluates
the prepared form per row group, cheapest probe first.

Normalization (one pass, with :mod:`parquet_tpu_torch.algebra.compare`):

- **NNF**: ``Not`` pushed to the leaves (De Morgan; double negation
  cancels).  Null-ness negates exactly (``NOT IS NULL == NOT NULL``);
  range/IN leaves keep a ``negated`` flag with SQL three-valued semantics
  (a NULL row matches neither a predicate nor its negation).
- **Value normalization**: range bounds through ``normalize`` (str ->
  UTF-8 bytes, Decimal -> unscaled int), IN probes through
  ``normalize_probe`` (probes no value can equal drop), probe sets sorted
  once.
- **Per-column merging**: inside an ``And``, positive ranges on one column
  intersect and IN-lists intersect (an IN-list meeting a range is
  filtered by it); inside an ``Or``, positive ranges merge and IN-lists
  union.  Contradictions fold to ``FALSE``, so the planner prunes a whole
  file without probing anything.

SQL comparison semantics throughout: a NULL value never matches a
range/IN/equality leaf, negated or not; only ``is_null`` matches it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

__all__ = ["Expr", "Pred", "And", "Or", "Not", "Const", "TRUE", "FALSE",
           "Col", "col", "prepare"]


class Expr:
    """Base predicate-tree node.  Combine with ``&``, ``|``, ``~``."""

    prepared: bool = False

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __bool__(self):
        # "col('x') == 5 and ..." silently evaluates the Pred's truthiness
        # and DROPS the left side — force the bitwise operators instead
        raise TypeError("Expr is not a python boolean; combine predicates "
                        "with & | ~ (not and/or/not)")

    def columns(self) -> Set[str]:
        """Dotted paths of every column the tree references."""
        out: Set[str] = set()
        self._collect_columns(out)
        return out

    def _collect_columns(self, out: Set[str]) -> None:
        raise NotImplementedError


def _as_expr(x) -> "Expr":
    if not isinstance(x, Expr):
        raise TypeError(f"expected an Expr, got {type(x).__name__} "
                        "(build leaves with col('name'))")
    return x


class Const(Expr):
    """A constant verdict — what contradictions and tautologies fold to."""

    __slots__ = ("value",)

    def __init__(self, value: bool):
        self.value = bool(value)
        self.prepared = True

    def _collect_columns(self, out: Set[str]) -> None:
        pass

    def __repr__(self) -> str:
        return "TRUE" if self.value else "FALSE"


TRUE = Const(True)
FALSE = Const(False)


class Pred(Expr):
    """One-column leaf predicate.

    ``kind`` is one of:

    - ``"range"`` — ``lo <= x <= hi`` (inclusive; ``None`` bound = open;
      ``lo == hi`` is the equality form the bloom cascade probes),
    - ``"in"`` — ``x ∈ values``,
    - ``"null"`` — ``x IS NULL``,
    - ``"notnull"`` — ``x IS NOT NULL``.

    ``negated`` (range/in only, produced by NNF) means "x is NOT NULL and
    fails the base predicate".  After :func:`prepare`, ``leaf`` holds the
    schema Leaf and ``values`` is the sorted normalized probe list.
    """

    __slots__ = ("path", "kind", "lo", "hi", "values", "negated", "leaf",
                 "prepared", "_hashes")

    def __init__(self, path: str, kind: str, lo=None, hi=None,
                 values: Optional[Sequence] = None, negated: bool = False,
                 leaf=None, prepared: bool = False):
        if kind not in ("range", "in", "null", "notnull"):
            raise ValueError(f"unknown predicate kind {kind!r}")
        self.path = path
        self.kind = kind
        self.lo = lo
        self.hi = hi
        self.values = values
        self.negated = negated
        self.leaf = leaf
        self.prepared = prepared
        self._hashes = None  # planner-memoized bloom probe hashes

    @property
    def is_equality(self) -> bool:
        """True for the shapes the bloom filter can refute: a one-point
        range or an IN-list (both positive)."""
        if self.negated:
            return False
        if self.kind == "in":
            return True
        return (self.kind == "range" and self.lo is not None
                and self.lo == self.hi)

    def _collect_columns(self, out: Set[str]) -> None:
        out.add(self.path)

    def __repr__(self) -> str:
        neg = "NOT " if self.negated else ""
        if self.kind == "range":
            if self.lo is not None and self.lo == self.hi:
                body = f"{self.path} == {self.lo!r}"
            else:
                body = f"{self.path} in [{self.lo!r}, {self.hi!r}]"
        elif self.kind == "in":
            vs = list(self.values or [])
            shown = ", ".join(repr(v) for v in vs[:4])
            if len(vs) > 4:
                shown += f", …({len(vs)})"
            body = f"{self.path} IN {{{shown}}}"
        elif self.kind == "null":
            body = f"{self.path} IS NULL"
        else:
            body = f"{self.path} IS NOT NULL"
        return f"{neg}{body}"


class _Nary(Expr):
    __slots__ = ("children",)
    _op = ""

    def __init__(self, *children: Expr):
        flat: List[Expr] = []
        for c in children:
            c = _as_expr(c)
            flat.extend(c.children if type(c) is type(self) else [c])
        if not flat:
            raise ValueError(f"{type(self).__name__} needs at least one child")
        self.children = flat

    def _collect_columns(self, out: Set[str]) -> None:
        for c in self.children:
            c._collect_columns(out)

    def __repr__(self) -> str:
        return "(" + f" {self._op} ".join(repr(c) for c in self.children) + ")"


class And(_Nary):
    """Every child matches (short-circuits cheapest-first in the planner)."""
    _op = "AND"


class Or(_Nary):
    """Any child matches."""
    _op = "OR"


class Not(Expr):
    """Negation — normalized away into leaf flags by :func:`prepare`."""

    __slots__ = ("child",)

    def __init__(self, child: Expr):
        self.child = _as_expr(child)

    def _collect_columns(self, out: Set[str]) -> None:
        self.child._collect_columns(out)

    def __repr__(self) -> str:
        return f"NOT {self.child!r}"


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


class Col:
    """Leaf-predicate builder: ``col("x").between(3, 7)``,
    ``col("s") == "hit"``, ``col("k").isin([2, 5, 9])``,
    ``col("v").is_null()``.  ``>=``/``<=`` build open-ended ranges (bounds
    are inclusive, matching the engine's zone-map semantics; strict
    ``<``/``>`` are deliberately not offered)."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def between(self, lo=None, hi=None) -> Pred:
        return Pred(self.path, "range", lo=lo, hi=hi)

    def __ge__(self, v) -> Pred:
        return Pred(self.path, "range", lo=v)

    def __le__(self, v) -> Pred:
        return Pred(self.path, "range", hi=v)

    def __eq__(self, v) -> Pred:  # type: ignore[override]
        return Pred(self.path, "range", lo=v, hi=v)

    def __ne__(self, v) -> Expr:  # type: ignore[override]
        return Not(Pred(self.path, "range", lo=v, hi=v))

    __hash__ = None  # type: ignore[assignment]  # == builds a Pred

    def isin(self, values: Sequence) -> Pred:
        return Pred(self.path, "in", values=list(values))

    def is_null(self) -> Pred:
        return Pred(self.path, "null")

    def not_null(self) -> Pred:
        return Pred(self.path, "notnull")


def col(path: str) -> Col:
    """Start a leaf predicate on column ``path`` (dotted for nested)."""
    return Col(path)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def schema_signature(schema):
    """Full per-leaf type identity of ``schema``: a prepared tree's leaf
    bindings and normalized values are only valid against a
    layout-identical schema."""
    return tuple((l.name, int(l.physical_type), l.type_length,
                  l.logical_kind,
                  tuple(sorted((l.logical_params or {}).items())),
                  l.max_definition_level, l.max_repetition_level)
                 for l in schema.leaves)


def prepare(expr: Expr, schema) -> Expr:
    """Normalize ``expr`` against ``schema`` once: NNF, leaf-value
    normalization into each column's order domain, per-column merging, and
    constant folding.  Returns a prepared tree (``.prepared`` is True on
    every node); preparing an already-prepared tree against the same
    schema layout is a no-op, against a different one raises
    ``ValueError`` (the bound leaves would silently point at the wrong
    columns).  Unknown columns raise ``KeyError``."""
    if not isinstance(expr, Expr):
        raise TypeError("predicate must be an Expr tree (build with col(); "
                        f"got {type(expr).__name__})")
    if expr.prepared:
        bound = getattr(expr, "schema_sig", None)
        if bound is not None and bound != schema_signature(schema):
            raise ValueError(
                "prepared tree was prepared against a different schema "
                "(leaf paths/types differ); re-prepare the original "
                "unprepared Expr for this file")
        return expr
    out = _fold(_nnf(expr, False), schema)
    if not isinstance(out, Const):  # constants are schema-independent
        out.schema_sig = schema_signature(schema)
    return out


def _nnf(expr: Expr, neg: bool) -> Expr:
    """Push negation to the leaves."""
    if isinstance(expr, Not):
        return _nnf(expr.child, not neg)
    if isinstance(expr, Const):
        return Const(expr.value != neg)
    if isinstance(expr, (And, Or)):
        kids = [_nnf(c, neg) for c in expr.children]
        flipped = (Or if isinstance(expr, And) else And) if neg \
            else type(expr)
        return flipped(*kids)
    if isinstance(expr, Pred):
        if not neg:
            return Pred(expr.path, expr.kind, expr.lo, expr.hi, expr.values,
                        expr.negated)
        if expr.kind == "null":
            return Pred(expr.path, "notnull", negated=expr.negated)
        if expr.kind == "notnull":
            return Pred(expr.path, "null", negated=expr.negated)
        return Pred(expr.path, expr.kind, expr.lo, expr.hi, expr.values,
                    not expr.negated)
    raise TypeError(f"not an Expr node: {type(expr).__name__}")


def _prepare_pred(p: Pred, schema) -> Expr:
    from .compare import normalize, normalize_probe

    leaf = schema.leaf(p.path)
    if p.kind in ("null", "notnull"):
        return Pred(p.path, p.kind, leaf=leaf, prepared=True)
    if p.kind == "range":
        lo, hi = normalize(leaf, p.lo), normalize(leaf, p.hi)
        if lo is not None and hi is not None:
            try:
                empty = lo > hi
            except TypeError:
                empty = False  # incomparable bounds: leave the leaf exact
            if empty:
                # x BETWEEN lo..hi with lo > hi matches nothing; its
                # negation matches every NON-NULL row
                return Pred(p.path, "notnull", leaf=leaf, prepared=True) \
                    if p.negated else FALSE
        return Pred(p.path, "range", lo=lo, hi=hi, negated=p.negated,
                    leaf=leaf, prepared=True)
    # IN-list: canonical probes, sorted once (unmatchable probes drop —
    # they can neither match nor, negated, exclude anything)
    probes = {normalize_probe(leaf, v) for v in (p.values or [])} - {None}
    try:
        vals = sorted(probes)
    except TypeError:
        vals = sorted(probes, key=repr)  # mixed domains: stable, still exact
    if not vals:
        # x IN () matches nothing; x NOT IN () matches every non-null row
        return Pred(p.path, "notnull", leaf=leaf, prepared=True) \
            if p.negated else FALSE
    return Pred(p.path, "in", values=vals, negated=p.negated, leaf=leaf,
                prepared=True)


def _fold(expr: Expr, schema) -> Expr:
    if isinstance(expr, Const):
        return expr
    if isinstance(expr, Pred):
        return _prepare_pred(expr, schema)
    assert isinstance(expr, (And, Or)), expr
    is_and = isinstance(expr, And)
    kids: List[Expr] = []
    for c in expr.children:
        got = _fold(c, schema)
        if isinstance(got, Const):
            if got.value == is_and:
                continue  # identity element
            return got  # absorbing element (FALSE in And, TRUE in Or)
        kids.extend(got.children if type(got) is type(expr) else [got])
    kids = _merge_same_column(kids, is_and)
    for k in kids:
        if isinstance(k, Const) and k.value != is_and:
            return k
    kids = [k for k in kids if not isinstance(k, Const)]
    if not kids:
        return TRUE if is_and else FALSE
    if len(kids) == 1:
        return kids[0]
    out = And(*kids) if is_and else Or(*kids)
    out.prepared = True
    return out


def _merge_same_column(kids: List[Expr], is_and: bool) -> List[Expr]:
    """Merge positive same-column leaves: in an And, ranges intersect and
    IN-lists intersect (and filter through ranges); in an Or, IN-lists
    union.  Anything else passes through untouched."""
    out: List[Expr] = []
    by_col = {}
    for k in kids:
        if isinstance(k, Pred) and not k.negated and k.kind in ("range", "in"):
            by_col.setdefault(k.path, []).append(k)
        else:
            out.append(k)
    for path, preds in by_col.items():
        if len(preds) == 1:
            out.append(preds[0])
            continue
        leaf = preds[0].leaf
        if is_and:
            merged = _intersect_preds(path, leaf, preds)
        else:
            merged = _union_preds(path, leaf, preds)
        if isinstance(merged, list):
            out.extend(merged)
        else:
            out.append(merged)
    return out


def _cmp_ok(a, b) -> bool:
    try:
        a < b  # noqa: B015 — probing comparability only
        return True
    except TypeError:
        return False


def _intersect_preds(path, leaf, preds: List[Pred]):
    """AND of positive same-column range/in leaves → one leaf (or FALSE).
    Bounds that don't compare within the column's order domain (possible
    only for pathological mixed probes) skip the merge — correctness over
    minimality; each leaf still evaluates exactly."""
    bounds = [b for p in preds if p.kind == "range"
              for b in (p.lo, p.hi) if b is not None]
    probes = [v for p in preds if p.kind == "in" for v in p.values]
    for a in bounds + probes[:1]:
        for b in bounds:
            if a is not b and not _cmp_ok(a, b):
                return preds
    lo = hi = None
    ins: Optional[List] = None
    for p in preds:
        if p.kind == "range":
            if p.lo is not None:
                lo = p.lo if lo is None else max(lo, p.lo)
            if p.hi is not None:
                hi = p.hi if hi is None else min(hi, p.hi)
        else:
            ins = list(p.values) if ins is None else \
                [v for v in ins if v in set(p.values)]
    if ins is not None:
        try:
            if lo is not None:
                ins = [v for v in ins if v >= lo]
            if hi is not None:
                ins = [v for v in ins if v <= hi]
        except TypeError:
            return preds
        if not ins:
            return FALSE
        return [Pred(path, "in", values=ins, leaf=leaf, prepared=True)]
    if lo is not None and hi is not None and lo > hi:
        return FALSE
    return [Pred(path, "range", lo=lo, hi=hi, leaf=leaf, prepared=True)]


def _union_preds(path, leaf, preds: List[Pred]):
    """OR of positive same-column leaves → the minimal equivalent leaf
    set: overlapping ranges MERGE into one interval (inclusive bounds, so
    a shared endpoint overlaps; the union is exact in every order
    domain), IN probes covered by a merged range are absorbed, leftover
    probes union into one sorted IN leaf, and a union that covers the
    whole domain folds to IS NOT NULL (a ``[-inf, +inf]`` range matches
    exactly the non-null rows).  ``(x <= 5) | (x >= 3)`` becomes one
    leaf the planner probes once; ``(x <= 5) | (x >= 100)`` stays two
    DISJOINT ranges whose page intervals prune instead of degrading to
    full-column candidates.  Bounds that don't compare within the
    column's order domain skip the merge — correctness over minimality."""
    ranges = [p for p in preds if p.kind == "range"]
    ins: List = []
    for p in preds:
        if p.kind == "in":
            ins.extend(p.values)
    # comparability guard: every bound/probe must order against the others
    bounds = [b for p in ranges for b in (p.lo, p.hi) if b is not None]
    for a in bounds + ins[:1]:
        for b in bounds:
            if a is not b and not _cmp_ok(a, b):
                return preds
    # merge overlapping intervals (None = open end); sort finite-lo
    # intervals by lo, with open-lo intervals folded into one seed first
    open_lo = [p for p in ranges if p.lo is None]
    finite = [p for p in ranges if p.lo is not None]
    merged: List[list] = []  # [lo, hi] with None = open
    if open_lo:
        if any(p.hi is None for p in open_lo):
            merged.append([None, None])
        else:
            merged.append([None, max(p.hi for p in open_lo)])
    for p in sorted(finite, key=lambda q: q.lo):
        if merged and (merged[-1][1] is None or p.lo <= merged[-1][1]):
            if merged[-1][1] is not None:
                merged[-1][1] = (None if p.hi is None
                                 else max(merged[-1][1], p.hi))
        else:
            merged.append([p.lo, p.hi])
    if merged and merged[0] == [None, None]:
        # the union admits every non-null value: IS NOT NULL, exactly
        return [Pred(path, "notnull", leaf=leaf, prepared=True)]

    def covered(v) -> bool:
        try:
            return any((lo is None or lo <= v) and (hi is None or v <= hi)
                       for lo, hi in merged)
        except TypeError:
            return False  # incomparable probe: keep it, stays exact

    seen = set()
    uniq = [v for v in ins
            if not (v in seen or seen.add(v)) and not covered(v)]
    out: List[Pred] = [Pred(path, "range", lo=lo, hi=hi, leaf=leaf,
                            prepared=True) for lo, hi in merged]
    if uniq:
        try:
            uniq = sorted(uniq)
        except TypeError:
            uniq = sorted(uniq, key=repr)
        out.append(Pred(path, "in", values=uniq, leaf=leaf, prepared=True))
    return out


def single_pred(path: str, lo=None, hi=None,
                values: Optional[Sequence] = None) -> Expr:
    """The one-leaf tree the legacy single-predicate signatures build —
    ``values`` wins (IN-list), else an inclusive range.  Passing both is
    the same error it always was."""
    if values is not None:
        if lo is not None or hi is not None:
            raise ValueError("pass either a range (lo/hi) or values, not both")
        return Pred(path, "in", values=list(values))
    return Pred(path, "range", lo=lo, hi=hi)
