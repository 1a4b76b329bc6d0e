"""The serving daemon's wire codecs: JSON predicate trees to ``Expr``,
aggregate specs to ``AggExpr``, and results to JSON values and Arrow IPC
streams.

The port's copy of ``parquet_tpu/serve/codecs.py``.  Predicate trees, one
JSON object a node::

    {"and": [node, ...]}            {"or": [node, ...]}
    {"not": node}
    {"col": "x", "ge": 1, "le": 5}  # inclusive range (either side open)
    {"col": "x", "eq": 7}           {"col": "s", "in": ["a", "b"]}
    {"col": "x", "null": true}      # is null (false: is not null)

Values are JSON scalars; strings compare as their UTF-8 bytes.  Aggregate
specs: ``count``, ``count:COL``, ``min:COL``, ``max:COL``, ``sum:COL``,
``sum_sq:COL``, ``avg:COL``, ``var:COL[:sample]``, ``distinct:COL``,
``top:COL:K``.

Results reach the host once a column: a CUDA tensor is copied whole and
then listed, and a :class:`~parquet_tpu_torch.io.column.Column` builds its
objects from one copy of each of its tensors (``Column.to_pylist``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..algebra.aggregate import (AggExpr, avg, count, count_distinct,
                                 max_, min_, sum_, sum_sq, top_k,
                                 variance)
from ..algebra.expr import Expr, col
from ..io.column import Column

__all__ = ["expr_from_wire", "parse_agg_spec", "parse_aggs", "jsonable",
           "columns_to_jsonable", "lookup_to_jsonable",
           "columns_to_arrow_batch", "columns_to_arrow_ipc"]

_AGG_USAGE = ("count, count:COL, min:COL, max:COL, sum:COL, sum_sq:COL, "
              "avg:COL, var:COL, var:COL:sample, distinct:COL, top:COL:K")


def parse_agg_spec(spec: str) -> AggExpr:
    """One aggregate from its wire spelling (``sum:v``, ``count``,
    ``avg:v``, ``var:v[:sample]``, ``top:v:5``); a malformed spec raises
    ``ValueError``."""
    parts = str(spec).split(":")
    kind = parts[0]
    if kind == "count":
        return count(parts[1] if len(parts) > 1 and parts[1] else None)
    if kind in ("min", "max", "sum", "sum_sq", "distinct", "avg", "var",
                "variance"):
        if len(parts) < 2 or not parts[1]:
            raise ValueError(f"--agg {spec!r} needs a column "
                             f"({_AGG_USAGE})")
        if kind in ("var", "variance"):
            sample = len(parts) > 2 and parts[2] == "sample"
            return variance(parts[1], sample=sample)
        fn = {"min": min_, "max": max_, "sum": sum_, "sum_sq": sum_sq,
              "distinct": count_distinct, "avg": avg}[kind]
        return fn(parts[1])
    if kind == "top":
        if len(parts) < 3 or not parts[1]:
            raise ValueError(f"--agg {spec!r} needs top:COL:K "
                             f"({_AGG_USAGE})")
        try:
            k = int(parts[2])
        except ValueError:
            raise ValueError(f"--agg {spec!r}: K must be an integer "
                             f"({_AGG_USAGE})") from None
        return top_k(parts[1], k)
    raise ValueError(f"unknown --agg spec {spec!r} ({_AGG_USAGE})")


def parse_aggs(specs: Sequence) -> List[AggExpr]:
    """A request's aggregates: spec strings, or ``AggExpr`` nodes."""
    out = [s if isinstance(s, AggExpr) else parse_agg_spec(s)
           for s in specs]
    if not out:
        raise ValueError("aggs must name at least one aggregate "
                         f"({_AGG_USAGE})")
    return out


def expr_from_wire(node) -> Optional[Expr]:
    """A predicate tree from its JSON form (the module docstring); None
    stays None (no predicate)."""
    if node is None:
        return None
    if not isinstance(node, dict):
        raise ValueError(f"where node must be an object, got "
                         f"{type(node).__name__}")
    if "and" in node or "or" in node:
        key = "and" if "and" in node else "or"
        kids = node[key]
        if not isinstance(kids, list) or not kids:
            raise ValueError(f"'{key}' needs a non-empty list")
        exprs = [expr_from_wire(k) for k in kids]
        out = exprs[0]
        for e in exprs[1:]:
            out = (out & e) if key == "and" else (out | e)
        return out
    if "not" in node:
        return ~expr_from_wire(node["not"])
    path = node.get("col")
    if not path:
        raise ValueError(f"leaf node needs 'col': {node!r}")
    ops = set(node) - {"col"}
    if "null" in node:
        if ops != {"null"}:
            raise ValueError("'null' cannot combine with other ops")
        leaf = col(path).is_null()
        return leaf if node["null"] else ~leaf
    if "in" in node:
        if ops != {"in"}:
            raise ValueError("'in' cannot combine with other ops")
        vals = node["in"]
        if not isinstance(vals, list) or not vals:
            raise ValueError("'in' needs a non-empty value list")
        return col(path).isin(vals)
    if "eq" in node:
        if ops != {"eq"}:
            raise ValueError("'eq' cannot combine with other ops")
        return col(path) == node["eq"]
    if ops <= {"ge", "le"} and ops:
        return col(path).between(node.get("ge"), node.get("le"))
    raise ValueError(f"unknown predicate ops {sorted(ops)} on "
                     f"{path!r} (ge/le, eq, in, null)")


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


def jsonable(v):
    """One value as JSON: numpy scalars unwrap, bytes decode as UTF-8 with
    replacement (the Arrow format carries exact bytes), NaN and infinities
    stay Python floats."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v).decode("utf-8", "replace")
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if item is not None:
        return jsonable(item())
    return str(v)


def _host(vals):
    """``vals`` on the host: a tensor copied once, whole."""
    if isinstance(vals, torch.Tensor):
        return vals.detach().cpu().numpy()
    return vals


def _column_to_list(vals) -> list:
    if isinstance(vals, Column):
        return [jsonable(x) for x in vals.to_pylist()]
    vals = _host(vals)
    if isinstance(vals, np.ma.MaskedArray):
        data = vals.filled(0).tolist()
        mask = np.ma.getmaskarray(vals)
        return [None if m else jsonable(d)
                for d, m in zip(data, mask.tolist())]
    if isinstance(vals, np.ndarray):
        return [jsonable(x) for x in vals.tolist()]
    return [jsonable(x) for x in vals]


def columns_to_jsonable(cols: Dict[str, object]) -> Dict[str, list]:
    """A scan result or a read (``{column: values}``: numpy, masked numpy,
    lists, tensors or ``Column``s) as JSON lists, nulls as ``null``."""
    return {name: _column_to_list(vals) for name, vals in cols.items()}


def lookup_to_jsonable(res, keys) -> List[dict]:
    """A :class:`~parquet_tpu_torch.io.lookup.LookupResult` as one object a
    key: ``{"key", "rows", "values": {column: [...]}}``, the values aligned
    with ``rows`` and nulls as ``null``."""
    out = []
    for key, h in zip(keys, res.hits):
        values = {}
        for name, vals in h.values.items():
            valid = h.validity.get(name)
            lst = _column_to_list(vals)
            if valid is not None:
                lst = [None if not ok else v
                       for v, ok in zip(lst, np.asarray(_host(valid), bool))]
            values[name] = lst
        out.append({"key": jsonable(key),
                    "rows": np.asarray(_host(h.rows)).tolist(),
                    "values": values})
    return out


def columns_to_arrow_batch(cols: Dict[str, object]):
    """One Arrow record batch of a scan result: masked numpy keeps its
    nulls, and a list column (the scan's byte-array form) is nullable
    binary even when empty or all null, so every file of a multi-file
    stream has one schema."""
    import pyarrow as pa

    arrays, names = [], []
    for name, vals in cols.items():
        names.append(name)
        vals = _host(vals)
        if isinstance(vals, np.ma.MaskedArray):
            arrays.append(pa.array(vals.filled(0),
                                   mask=np.ma.getmaskarray(vals)))
        elif isinstance(vals, np.ndarray):
            arrays.append(pa.array(vals))
        else:
            arrays.append(pa.array(list(vals), type=pa.binary()))
    return pa.record_batch(arrays, names=names)


def columns_to_arrow_ipc(cols: Dict[str, object], sink) -> int:
    """Write one Arrow IPC stream of a single record batch of ``cols`` to
    the file-like ``sink``; returns its rows."""
    import pyarrow as pa
    import pyarrow.ipc

    batch = columns_to_arrow_batch(cols)
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return batch.num_rows
