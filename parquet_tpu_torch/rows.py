"""Row model: Value and Row transport, Dremel shredding and assembly.

The port of ``parquet_tpu/rows.py``: a :class:`Value` is one leaf slot
(its payload, definition and repetition levels and column ordinal), a
:class:`Row` one record's slots; :func:`deconstruct` shreds a record (dicts
for groups, lists for repeated fields, ``None`` for nulls; a LIST or MAP
field as a Python list or dict) and :func:`reconstruct` assembles it back,
at any depth.  :func:`columns_from_rows` gives the writer raw level
streams, the write path of schemas deeper than one repeated level.

:class:`FileRows` decodes a row group (or, after :meth:`FileRows.seek_to_row`,
the pages that cover the row to the end of its row group) on ``device``
with each column's level streams kept (``device_reader.decode_chunk_span``)
and brings each column to the host once; the collapsed validity and
offsets cannot tell a null struct between two repeated levels from an
empty one, the levels can.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .format.enums import FieldRepetitionType as Rep, Type
from .schema.schema import Leaf, Node, Schema
from .schema.types import LogicalKind


# ---------------------------------------------------------------------------
# Value / Row
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Value:
    """One leaf slot: scalar payload + Dremel levels + column ordinal.

    ``value is None`` for null/absent slots; ``definition_level`` then records
    how deep the path was defined (which ancestor went null)."""

    column: int
    value: Any
    definition_level: int = 0
    repetition_level: int = 0

    @property
    def is_null(self) -> bool:
        return self.value is None

    def __repr__(self):
        return (f"Value(col={self.column}, {self.value!r}, "
                f"d={self.definition_level}, r={self.repetition_level})")


class Row(list):
    """A list of :class:`Value` slots, ordered by column then slot order."""

    def for_column(self, column: int) -> List[Value]:
        return [v for v in self if v.column == column]


# ---------------------------------------------------------------------------
# Chain math (per-leaf ancestor metadata)
# ---------------------------------------------------------------------------


@dataclass
class _Chain:
    leaf: Leaf
    nodes: Tuple[Node, ...]  # top-level field ... leaf (inclusive)
    cum_def: Tuple[int, ...]  # def level after *entering* nodes[i]
    cum_rep: Tuple[int, ...]  # rep level after entering nodes[i]
    rep_positions: Tuple[int, ...]  # chain indexes of REPEATED nodes
    rep_defs: Tuple[int, ...]  # cum_def at each repeated node (D_k)

    @property
    def max_def(self) -> int:
        return self.leaf.max_definition_level

    @property
    def max_rep(self) -> int:
        return self.leaf.max_repetition_level


def _chain_of(leaf: Leaf) -> _Chain:
    cd: List[int] = []
    cr: List[int] = []
    d = r = 0
    reps: List[int] = []
    rep_defs: List[int] = []
    for i, n in enumerate(leaf.ancestors):
        if n.repetition == Rep.OPTIONAL:
            d += 1
        elif n.repetition == Rep.REPEATED:
            d += 1
            r += 1
            reps.append(i)
            rep_defs.append(d)
        cd.append(d)
        cr.append(r)
    return _Chain(leaf, leaf.ancestors, tuple(cd), tuple(cr), tuple(reps),
                  tuple(rep_defs))


def _chains(schema: Schema) -> List[_Chain]:
    return [_chain_of(leaf) for leaf in schema.leaves]


# ---------------------------------------------------------------------------
# Deconstruct: record → per-leaf slot streams (Dremel shredding)
# ---------------------------------------------------------------------------


def _leaves_under(node: Node, schema: Schema) -> List[int]:
    """Column ordinals of all leaves in node's subtree (by identity walk)."""
    out: List[int] = []

    def walk(n: Node):
        if n.is_leaf:
            for leaf in schema.leaves:
                if leaf.node is n:
                    out.append(leaf.column_index)
                    return
        else:
            for c in n.children:
                walk(c)

    walk(node)
    return out


class _Shredder:
    def __init__(self, schema: Schema):
        self.schema = schema
        self.leaf_of_node: Dict[int, int] = {
            id(leaf.node): leaf.column_index for leaf in schema.leaves
        }
        self.subtree_leaves: Dict[int, List[int]] = {}
        # rep level of each REPEATED node (for non-first elements)
        self.rep_level_of: Dict[int, int] = {}
        for leaf in schema.leaves:
            chain = _chain_of(leaf)
            for i, n in enumerate(chain.nodes):
                if n.repetition == Rep.REPEATED:
                    self.rep_level_of[id(n)] = chain.cum_rep[i]

    def _subtree(self, node: Node) -> List[int]:
        key = id(node)
        if key not in self.subtree_leaves:
            self.subtree_leaves[key] = _leaves_under(node, self.schema)
        return self.subtree_leaves[key]

    def shred(self, record: Any) -> List[List[Tuple[Any, int, int]]]:
        out: List[List[Tuple[Any, int, int]]] = [[] for _ in self.schema.leaves]
        self._walk_children(self.schema.root, record, 0, 0, out)
        return out

    # -- helpers ------------------------------------------------------------
    def _emit_nulls(self, node: Node, d: int, r: int, out) -> None:
        for col in self._subtree(node):
            out[col].append((None, d, r))

    def _strict(self, node: Node, value: Any) -> Any:
        """Convert LIST/MAP Python sugar into the strict tree shape."""
        if value is None or node.is_leaf:
            return value
        if node.logical_kind == LogicalKind.LIST and not isinstance(value, dict):
            if not isinstance(value, (list, tuple)):
                raise TypeError(
                    f"LIST field {node.name!r} expects a list, "
                    f"got {type(value).__name__}")
            inner = node.children[0]  # repeated group "list" (or legacy)
            if inner.repetition == Rep.REPEATED:
                if inner.is_leaf or len(inner.children or ()) != 1:
                    return {inner.name: list(value)}
                elem = inner.children[0]
                return {inner.name: [{elem.name: v} for v in value]}
        if node.logical_kind == LogicalKind.MAP and isinstance(value, dict):
            inner = node.children[0]  # repeated group key_value
            if inner.repetition == Rep.REPEATED and not inner.is_leaf:
                kname = inner.children[0].name
                vname = inner.children[1].name if len(inner.children) > 1 else "value"
                if set(value.keys()) == {inner.name} and isinstance(
                        value[inner.name], (list, tuple)) and all(
                        isinstance(e, dict) and kname in e
                        for e in value[inner.name]):
                    return value  # already the strict 3-level shape
                return {inner.name: [{kname: k, vname: v} for k, v in value.items()]}
        return value

    def _walk_children(self, node: Node, value: Any, d: int, r: int, out):
        value = self._strict(node, value)
        if not isinstance(value, dict):
            raise TypeError(
                f"group {node.name!r} expects a dict record, got {type(value).__name__}")
        for child in node.children:
            cv = value.get(child.name)
            if child.repetition == Rep.REPEATED:
                self._shred_repeated(child, cv, d, r, out)
            else:
                self._shred_node(child, cv, d, r, out)

    def _shred_node(self, node: Node, value: Any, d: int, r: int, out):
        if node.repetition == Rep.OPTIONAL:
            if value is None:
                self._emit_nulls(node, d, r, out)
                return
            d += 1
        elif value is None and node.is_leaf:
            raise ValueError(f"required leaf {node.name!r} is None")
        if node.is_leaf:
            out[self.leaf_of_node[id(node)]].append((value, d, r))
        else:
            self._walk_children(node, value, d, r, out)

    def _shred_repeated(self, node: Node, elems: Any, d: int, r: int, out):
        if elems is None:
            elems = []
        if not isinstance(elems, (list, tuple)):
            raise TypeError(
                f"repeated field {node.name!r} expects a list, got {type(elems).__name__}")
        if len(elems) == 0:
            self._emit_nulls(node, d, r, out)
            return
        own_rep = self.rep_level_of[id(node)]
        for i, e in enumerate(elems):
            ri = r if i == 0 else own_rep
            if node.is_leaf:
                if e is None:
                    raise ValueError(
                        f"repeated leaf {node.name!r} cannot hold null elements")
                out[self.leaf_of_node[id(node)]].append((e, d + 1, ri))
            else:
                self._walk_children(node, e, d + 1, ri, out)

def _shredder_of(schema: Schema) -> _Shredder:
    """Per-schema cached shredder (rebuilding caches per record is pure
    overhead in the write hot path)."""
    s = getattr(schema, "_row_shredder", None)
    if s is None or s.schema is not schema:
        s = _Shredder(schema)
        schema._row_shredder = s
    return s


def deconstruct(schema: Schema, record: Any) -> Row:
    """Shred one record into a :class:`Row` of leaf slots (Dremel encode)."""
    slots = _shredder_of(schema).shred(record)
    row = Row()
    for col, lst in enumerate(slots):
        for (v, d, r) in lst:
            row.append(Value(column=col, value=v, definition_level=d,
                             repetition_level=r))
    return row


# ---------------------------------------------------------------------------
# Reconstruct: per-leaf slot streams → record (Dremel assembly)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Null:
    """Skeleton marker: path defined down to def level ``depth`` only."""

    depth: int


def _skeleton(chain: _Chain, slots: Sequence[Tuple[Any, int, int]]) -> Any:
    """Assemble ONE row's slots of ONE leaf into a nested-list skeleton.

    Lists appear only at REPEATED chain nodes; groups/optionals are collapsed
    (their nullness is preserved in :class:`_Null` payload depths)."""
    R = len(chain.rep_positions)
    D = chain.rep_defs  # 1-based via D[k-1]
    max_def = chain.max_def
    holder: List[Any] = []
    lists: List[Any] = [holder] + [None] * R
    for (v, d, r) in slots:
        k = r + 1
        while True:
            if k > R:
                lists[R].append(v if d == max_def else _Null(d))
                break
            parent = lists[k - 1]
            if d >= D[k - 1] - 1:
                new: List[Any] = []
                parent.append(new)
                lists[k] = new
                if d >= D[k - 1]:
                    k += 1
                    continue
                break  # empty list
            parent.append(_Null(d))
            break
    return holder[0] if holder else _Null(0)


class _Assembler:
    def __init__(self, schema: Schema):
        self.schema = schema
        self.chains = _chains(schema)
        self._sub: Dict[int, List[int]] = {}

    def _subtree(self, node: Node) -> List[int]:
        key = id(node)
        if key not in self._sub:
            self._sub[key] = _leaves_under(node, self.schema)
        return self._sub[key]

    def assemble(self, row: Row) -> Dict[str, Any]:
        by_col: List[List[Tuple[Any, int, int]]] = [[] for _ in self.chains]
        for v in row:  # single pass, not a rescan per column
            by_col[v.column].append(
                (v.value, v.definition_level, v.repetition_level))
        parts = {chain.leaf.column_index: _skeleton(chain, by_col[i])
                 for i, chain in enumerate(self.chains)}
        return self._merge_children(self.schema.root, parts, 0)

    # -- merge --------------------------------------------------------------
    def _merge_children(self, node: Node, parts: Dict[int, Any], d: int):
        out: Dict[str, Any] = {}
        for child in node.children:
            cols = self._subtree(child)
            cp = {c: parts[c] for c in cols}
            if child.repetition == Rep.REPEATED:
                out[child.name] = self._merge_repeated(child, cp, d)
            elif child.is_leaf:
                out[child.name] = _payload(cp[cols[0]], child)
            else:
                dc = d + (1 if child.repetition == Rep.OPTIONAL else 0)
                if child.repetition == Rep.OPTIONAL and all(
                        isinstance(s, _Null) and s.depth < dc
                        for s in cp.values()):
                    out[child.name] = None
                else:
                    out[child.name] = self._merge_children(child, cp, dc)
        return self._sugar(node, out)

    def _merge_repeated(self, child: Node, cp: Dict[int, Any], d: int):
        skels = list(cp.values())
        n = len(skels[0])
        if any(len(s) != n for s in skels):
            raise ValueError(
                f"misaligned repetition under {child.name!r}: "
                f"{[len(s) for s in skels]}")
        cols = list(cp.keys())
        if child.is_leaf:
            return [_payload(e, child) for e in cp[cols[0]]]
        dk = d + 1
        out = []
        for i in range(n):
            ep = {c: cp[c][i] for c in cols}
            if all(isinstance(s, _Null) for s in ep.values()):
                # element exists but its content subtree is absent (an optional
                # group directly under the repeated node went null)
                out.append(self._null_element(child, ep, dk))
            else:
                out.append(self._merge_children(child, ep, dk))
        return out

    def _null_element(self, child: Node, ep: Dict[int, Any], dk: int):
        # distinguish "element is an all-null group" from deeper nulls
        if all(s.depth < dk for s in ep.values()):
            return None
        return self._merge_children(child, ep, dk)

    def _sugar(self, node: Node, out: Dict[str, Any]):
        if node.logical_kind == LogicalKind.LIST and len(out) == 1:
            inner_node = node.children[0]
            inner = next(iter(out.values()))
            if inner_node.repetition == Rep.REPEATED and isinstance(inner, list):
                if (not inner_node.is_leaf and inner_node.children is not None
                        and len(inner_node.children) == 1):
                    ename = inner_node.children[0].name
                    return [None if e is None else e[ename] for e in inner]
                return inner
        if node.logical_kind == LogicalKind.MAP and len(out) == 1:
            inner_node = node.children[0]
            inner = next(iter(out.values()))
            if (inner_node.repetition == Rep.REPEATED and isinstance(inner, list)
                    and not inner_node.is_leaf and len(inner_node.children) >= 2):
                kname = inner_node.children[0].name
                vname = inner_node.children[1].name
                return {e[kname]: e[vname] for e in inner if e is not None}
        return out


def _payload(skel: Any, node: Node):
    if isinstance(skel, _Null):
        return None
    if isinstance(skel, (bytes, bytearray, np.bytes_)):
        if node.logical_kind in (LogicalKind.STRING, LogicalKind.ENUM,
                                 LogicalKind.JSON):
            return bytes(skel).decode("utf-8")
        return bytes(skel)
    if isinstance(skel, np.generic):
        return skel.item()
    return skel


def _assembler_of(schema: Schema) -> "_Assembler":
    """Per-schema cached assembler (mirror of :func:`_shredder_of` on the
    read side — rebuilding the chains/subtree cache per record is overhead)."""
    a = getattr(schema, "_row_assembler", None)
    if a is None or a.schema is not schema:
        a = _Assembler(schema)
        schema._row_assembler = a
    return a


def reconstruct(schema: Schema, row: Row) -> Dict[str, Any]:
    """Assemble one :class:`Row` of leaf slots back into a record (Dremel
    decode) — the inverse of :func:`deconstruct`."""
    return _assembler_of(schema).assemble(row)


# ---------------------------------------------------------------------------
# RowBuilder
# ---------------------------------------------------------------------------


class RowBuilder:
    """Build rows field-by-field (reference: ``row_builder.go — RowBuilder``).

    ``set`` accepts dotted paths for nested fields; ``row()`` shreds the
    accumulated record and resets the builder."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._record: Dict[str, Any] = {}

    def set(self, path: str, value: Any) -> "RowBuilder":
        parts = path.split(".")
        cur = self._record
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
        return self

    def update(self, record: Dict[str, Any]) -> "RowBuilder":
        self._record.update(record)
        return self

    def row(self) -> Row:
        r = deconstruct(self.schema, self._record)
        self._record = {}
        return r


# ---------------------------------------------------------------------------
# Rows <-> columns (the bridge to the writer and the reader)
# ---------------------------------------------------------------------------


def columns_from_rows(schema: Schema, rows: Iterable[Row]):
    """Rows as ``({dotted path: ColumnData}, num_rows)``, each leaf with
    its raw def/rep level streams (any nesting depth)."""
    from .io.writer import ColumnData

    chains = _chains(schema)
    per_leaf: List[List[Tuple[Any, int, int]]] = [[] for _ in schema.leaves]
    num_rows = 0
    for row in rows:
        num_rows += 1
        for v in row:
            per_leaf[v.column].append(
                (v.value, v.definition_level, v.repetition_level))
    columns: Dict[str, ColumnData] = {}
    for chain, slots in zip(chains, per_leaf):
        leaf = chain.leaf
        max_def, max_rep = chain.max_def, chain.max_rep
        defs = np.fromiter((d for (_, d, _) in slots), np.int32, len(slots))
        reps = np.fromiter((r for (_, _, r) in slots), np.int32, len(slots))
        present = [v for (v, d, _) in slots if d == max_def]
        values, offsets = _dense_values(leaf, present)
        cd = ColumnData(values=values, offsets=offsets)
        if max_def > 0:
            cd.def_levels = defs
        if max_rep > 0:
            cd.rep_levels = reps
        if max_def > 0 and max_rep == 0:
            cd.validity = defs == max_def
        columns[leaf.dotted_path] = cd
    return columns, num_rows


def _dense_values(leaf: Leaf, present: List[Any]):
    phys = leaf.physical_type
    if phys == Type.BYTE_ARRAY:
        enc = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
               for v in present]
        offsets = np.zeros(len(enc) + 1, np.int64)
        if enc:
            np.cumsum([len(b) for b in enc], out=offsets[1:])
        return np.frombuffer(b"".join(enc), np.uint8).copy(), offsets
    if phys == Type.FIXED_LEN_BYTE_ARRAY:
        w = leaf.type_length or 0
        parts = []
        for v in present:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            if len(b) > w:
                raise ValueError(
                    f"field {leaf.dotted_path!r}: FIXED_LEN_BYTE_ARRAY({w}) "
                    f"value has {len(b)} bytes")
            parts.append(b.ljust(w, b"\0"))
        return np.frombuffer(b"".join(parts), np.uint8).reshape(-1, w).copy(), \
            None
    if phys == Type.INT96:
        arr = np.zeros((len(present), 3), np.uint32)
        for i, v in enumerate(present):
            iv = int(v)
            arr[i] = (iv & 0xFFFFFFFF, (iv >> 32) & 0xFFFFFFFF,
                      (iv >> 64) & 0xFFFFFFFF)
        return arr.view(np.int32), None
    np_dt = {Type.BOOLEAN: np.bool_, Type.INT32: np.int32, Type.INT64: np.int64,
             Type.FLOAT: np.float32, Type.DOUBLE: np.float64}[phys]
    if leaf.logical_kind == LogicalKind.INT and not leaf.logical_params.get(
            "signed", True):
        np_dt = {Type.INT32: np.uint32, Type.INT64: np.uint64}.get(phys, np_dt)
    return np.asarray(present, dtype=np_dt), None


def rows_from_columns(schema: Schema, columns: Dict[str, "object"],
                      num_rows: int) -> Iterator[Row]:
    """Rows out of decoded :class:`~parquet_tpu_torch.io.column.Column`s
    (any device; each comes to the host once).  A repeated leaf (or a
    struct chain) needs its level streams (``def_levels``,
    ``rep_levels``); a flat leaf's validity stands for them."""
    chains = _chains(schema)
    per_leaf_slots = [_column_slots(chain, columns[chain.leaf.dotted_path])
                      for chain in chains]
    cursors = [0] * len(chains)
    for _ in range(num_rows):
        row = Row()
        for ci, (chain, slots) in enumerate(zip(chains, per_leaf_slots)):
            i = cursors[ci]
            n = len(slots)
            j = i + 1
            if chain.max_rep > 0:  # a row runs to the next rep-0 slot
                while j < n and slots[j][2] != 0:
                    j += 1
            for (v, d, r) in slots[i:j]:
                row.append(Value(column=chain.leaf.column_index, value=v,
                                 definition_level=d, repetition_level=r))
            cursors[ci] = j
        yield row


def _column_slots(chain: _Chain, col) -> List[Tuple[Any, int, int]]:
    leaf = chain.leaf
    defs, reps = col.def_levels, col.rep_levels
    values = _host_values(col, leaf)
    max_def = chain.max_def
    if defs is None:
        if col.validity is None:
            return [(v, max_def, 0) for v in values]
        validity = col.validity.cpu().numpy().tolist()
        it = iter(values)
        return [(next(it), max_def, 0) if ok else (None, max_def - 1, 0)
                for ok in validity]
    defs = np.asarray(defs).tolist()
    reps = (np.asarray(reps).tolist() if reps is not None
            else [0] * len(defs))
    it = iter(values)
    return [(next(it), d, r) if d == max_def else (None, d, r)
            for d, r in zip(defs, reps)]


def _host_values(col, leaf: Leaf) -> List[Any]:
    """The column's dense values on the host as Python objects: ``bytes``
    for byte arrays and FLBA, an int for INT96, unsigned columns
    unsigned; one copy a tensor (:meth:`Column.host_dense`)."""
    values, offsets = col.host_dense()
    if offsets is not None:
        buf = values.tobytes()
        o = offsets.tolist()
        return [buf[o[i]:o[i + 1]] for i in range(len(o) - 1)]
    if leaf.physical_type == Type.FIXED_LEN_BYTE_ARRAY:
        return [r.tobytes() for r in values]
    if leaf.physical_type == Type.INT96:
        w = values.view(np.uint32).astype(object)
        return [int(a) | (int(b) << 32) | (int(c) << 64) for a, b, c in w]
    if (leaf.logical_kind == LogicalKind.INT
            and not leaf.logical_params.get("signed", True)
            and values.dtype in (np.int32, np.int64)):
        values = values.view({np.dtype(np.int32): np.uint32,
                              np.dtype(np.int64): np.uint64}[values.dtype])
    return values.tolist()


# ---------------------------------------------------------------------------
# RowReader / RowWriter transport
# ---------------------------------------------------------------------------


class RowReader:
    """Anything with ``read_rows(n) -> List[Row]`` (empty: the end)."""

    def read_rows(self, n: int) -> List[Row]:  # pragma: no cover
        raise NotImplementedError


class RowWriter:
    """Anything with ``write_rows(rows) -> int``."""

    def write_rows(self, rows: List[Row]) -> int:  # pragma: no cover
        raise NotImplementedError


class FileRows(RowReader):
    """A row cursor over a :class:`ParquetFile`: each row group's columns
    decoded on ``device`` with their level streams and brought to the host
    once."""

    def __init__(self, pf, device="cuda"):
        from .io.reader import resolve_device

        self.pf = pf
        self.schema = pf.schema
        self.device = resolve_device(device)
        self._rg = 0
        self._iter: Optional[Iterator[Row]] = None

    def _next_group(self) -> bool:
        from .parallel.device_reader import decode_chunk_span

        if self._rg >= len(self.pf.row_groups):
            return False
        rg = self.pf.row_group(self._rg)
        self._rg += 1
        cols = {leaf.dotted_path: decode_chunk_span(
            rg.column(i), self.device, keep_levels=True)
            for i, leaf in enumerate(self.schema.leaves)}
        self._iter = rows_from_columns(self.schema, cols, rg.num_rows)
        return True

    def seek_to_row(self, row: int) -> None:
        """Put the cursor at global row ``row``: the pages that cover
        ``[row, end of its row group)`` of each column decode on the
        device (with a page index only those; without one the whole
        group's), their level streams cut at the exact row.  At or past
        the end the cursor is at EOF."""
        from .io.search import pages_and_base
        from .io.stream import _slice_rows, piece_from_column
        from .parallel.device_reader import decode_chunk_span

        if row < 0:
            raise ValueError("row must be >= 0")
        base = 0
        for i in range(len(self.pf.row_groups)):
            rg = self.pf.row_group(i)
            nr = rg.num_rows
            if row < base + nr:
                offset = row - base
                if offset == 0:
                    self._rg = i  # decoded at the next read_rows
                    self._iter = None
                    return
                self._rg = i + 1  # read_rows goes on at the next group
                cols = {}
                for j, leaf in enumerate(self.schema.leaves):
                    chunk = rg.column(j)
                    pages, first = pages_and_base(chunk, offset, nr)
                    piece = piece_from_column(decode_chunk_span(
                        chunk, self.device, pages=pages, keep_levels=True))
                    cols[leaf.dotted_path] = _slice_rows(
                        piece, offset - first, piece.rows).col
                self._iter = rows_from_columns(self.schema, cols,
                                               nr - offset)
                return
            base += nr
        self._rg = len(self.pf.row_groups)
        self._iter = None

    def read_rows(self, n: int) -> List[Row]:
        out: List[Row] = []
        while len(out) < n:
            if self._iter is None and not self._next_group():
                break
            got = False
            for row in self._iter:
                out.append(row)
                got = True
                if len(out) >= n:
                    break
            if len(out) < n or not got:
                self._iter = None
        return out

    def __iter__(self) -> Iterator[Row]:
        while True:
            batch = self.read_rows(1024)
            if not batch:
                return
            yield from batch


class BufferRows(RowReader):
    """A RowReader over a list of rows in memory."""

    def __init__(self, rows: Sequence[Row]):
        self._rows = list(rows)
        self._pos = 0

    def read_rows(self, n: int) -> List[Row]:
        out = self._rows[self._pos:self._pos + n]
        self._pos += len(out)
        return list(out)


class WriterRows(RowWriter):
    """A RowWriter over a :class:`ParquetWriter`: rows buffer and go out a
    row group of ``row_group_size`` at a time."""

    def __init__(self, writer, schema: Optional[Schema] = None):
        self.writer = writer
        self.schema = schema or writer.schema
        self._rows: List[Row] = []

    def write_rows(self, rows: List[Row]) -> int:
        self._rows.extend(rows)
        limit = self.writer.options.row_group_size
        while len(self._rows) >= limit:
            self._flush(self._rows[:limit])
            self._rows = self._rows[limit:]
        return len(rows)

    def _flush(self, rows: List[Row]) -> None:
        if not rows:
            return
        columns, n = columns_from_rows(self.schema, rows)
        self.writer.write_row_group(columns, n)

    def flush(self) -> None:
        self._flush(self._rows)
        self._rows = []

    def close(self) -> None:
        self.flush()
        self.writer.close()


def copy_rows(dst: RowWriter, src: RowReader, batch: int = 4096) -> int:
    """Move every row of ``src`` to ``dst``; returns how many."""
    total = 0
    while True:
        rows = src.read_rows(batch)
        if not rows:
            break
        total += dst.write_rows(rows)
    if hasattr(dst, "flush"):
        dst.flush()
    return total


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------


def write_rows(sink, schema: Schema, records: Iterable[Dict[str, Any]],
               options=None):
    """Write Python records through the row path (any nesting); returns
    the closed writer."""
    from .io.writer import ParquetWriter, WriterOptions

    w = ParquetWriter(sink, schema, options or WriterOptions())
    try:
        rw = WriterRows(w, schema)
        for rec in records:
            rw.write_rows([deconstruct(schema, rec)])
        rw.close()
    except BaseException:
        w.abort()  # a path the writer opened is removed
        raise
    return w


def read_rows(source, device="cuda") -> Iterator[Dict[str, Any]]:
    """The records of a file through the row path, decoded on
    ``device``."""
    from .io.reader import ParquetFile

    pf = source if hasattr(source, "row_group") else ParquetFile(source)
    asm = _Assembler(pf.schema)
    for row in FileRows(pf, device=device):
        yield asm.assemble(row)
