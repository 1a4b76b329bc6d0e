"""A read's columns as a ``pyarrow.Table``: the port of the JAX package's
``Table.to_arrow`` (``parquet_tpu/io/reader.py``).

:func:`table_to_arrow` converts a
:class:`~parquet_tpu_torch.io.reader.ColumnSet` field by field, in three
tiers, as the JAX package does: a leaf or a chain of lists by
:meth:`Column.to_arrow`; a struct above any list zipped from its children,
its nulls from the def levels; a struct or map inside a list assembled
from the Dremel level streams with vector ops (:meth:`_Assembly.nested`;
the row-by-row tier of ``rows.py``, :meth:`_Assembly.via_rows`, is what
the tests hold it to).  The device read keeps no level stream of a
repeated column unless asked, so the leaves under a field of the last two
tiers are decoded again from the set's ``spans`` with their levels
(:func:`_levels_of`), the only work the conversion adds on the device.
pyarrow is imported only inside a call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..format.enums import FieldRepetitionType as Rep
from ..schema.types import LogicalKind
from .column import Column, _leaf_to_arrow, arrow_type_of

__all__ = ["table_to_arrow"]


def _needs_row_assembly(node, under_rep: bool = False) -> bool:
    """True where a plain group sits under repetition (a struct inside a
    list, a map): there are no row-aligned child arrays to zip."""
    if node.is_leaf:
        return False
    rep_here = under_rep or node.repetition == Rep.REPEATED
    if node.logical_kind == LogicalKind.LIST and len(node.children) == 1:
        mid = node.children[0]
        inner = (mid.children[0] if mid.children is not None
                 and len(mid.children) == 1 else mid)
        return (False if inner.is_leaf
                else _needs_row_assembly(inner, under_rep=True))
    if node.logical_kind == LogicalKind.MAP:
        return True  # its key_value group is always repeated
    if rep_here:
        return True
    return any(_needs_row_assembly(c) for c in node.children
               if not c.is_leaf)


def _leaf_or_list_chain(node) -> bool:
    """A field :meth:`Column.to_arrow` converts alone."""
    return ((node.is_leaf or node.logical_kind == LogicalKind.LIST)
            and not _needs_row_assembly(node))


def table_to_arrow(cs):
    """``cs`` (a ``ColumnSet``) as a ``pyarrow.Table`` in schema order."""
    import pyarrow as pa

    schema = cs.schema
    fields = []  # (top-level node, its leaves, those present)
    for child in schema.root.children:
        leaves = [leaf for leaf in schema.leaves if leaf.path[0] == child.name]
        present = [leaf for leaf in leaves if leaf.name in cs]
        if present:
            fields.append((child, leaves, present))
    if all(len(present) == 1 and _leaf_or_list_chain(child)
           for child, _, present in fields):
        # the JAX package's per-row-group tier: a field the embedded Arrow
        # schema declares dictionary-typed keeps that type
        dict_fields = (cs.spans[0][0].arrow_dictionary_fields
                       if cs.spans else frozenset())
        names, arrays = [], []
        for child, _, present in fields:
            prefer = child.name in dict_fields
            arr = cs[present[0].name].to_arrow(prefer_dictionary=prefer)
            if prefer and not pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_encode()  # a chunk decoded dense
            names.append(child.name)
            arrays.append(arr)
        return pa.Table.from_arrays(arrays, names=names)
    need = [leaf for child, leaves, present in fields
            if len(present) == len(leaves) and not _leaf_or_list_chain(child)
            for leaf in leaves]
    asm = _Assembly(cs.schema, _with_levels(cs, need), cs.num_rows)
    names, arrays = [], []
    for child, leaves, present in fields:
        if len(present) != len(leaves):  # a partial selection: flat leaves
            for leaf in present:
                col = cs[leaf.name]
                names.append(child.name if len(leaf.path) == 1
                             or col.list_offsets else leaf.name)
                arrays.append(col.to_arrow())
            continue
        names.append(child.name)
        arrays.append(asm.field(child))
    return pa.Table.from_arrays(arrays, names=names)


# ---------------------------------------------------------------------------
# Level streams for the assembly tiers
# ---------------------------------------------------------------------------


def _has_levels(leaf, col: Column) -> bool:
    return col.def_levels is not None and (
        not leaf.max_repetition_level or col.rep_levels is not None)


def _synth_def(leaf, col: Column) -> Optional[np.ndarray]:
    """Def levels that the decoded structure alone determines, or None: a
    flat leaf without a null (``max_def`` everywhere) or with one def
    level (its validity), or a repeated leaf whose only def level is its
    list's (1 on every slot but an empty list's row start)."""
    max_def = leaf.max_definition_level
    if not leaf.max_repetition_level:
        if col.validity is None:
            return np.full(col.num_slots, max_def, np.int32)
        if max_def == 1:
            return col.validity.cpu().numpy().astype(np.int32)
        return None
    if max_def > 1 or col.rep_levels is None:
        return None
    d = np.ones(len(col.rep_levels), np.int32)
    lens = np.diff(col.list_offsets[0].cpu().numpy())
    starts = np.flatnonzero(np.asarray(col.rep_levels) == 0)
    d[starts[lens == 0]] = 0
    return d


def _with_levels(cs, need) -> Dict[str, Column]:
    """The set's columns, those of ``need`` with their def levels (and rep
    levels where repeated): kept by the decode, implied by the structure
    (:func:`_synth_def`), or decoded again from the spans."""
    cols = dict(cs)
    fetch = []
    for leaf in need:
        col = cols[leaf.name]
        if _has_levels(leaf, col):
            continue
        d = _synth_def(leaf, col)
        if d is not None:
            cols[leaf.name] = dataclasses.replace(col, def_levels=d)
        else:
            fetch.append(leaf)
    for leaf in fetch:
        d, r = _levels_of(cs, leaf)
        cols[leaf.name] = dataclasses.replace(
            cols[leaf.name], def_levels=d,
            rep_levels=r if leaf.max_repetition_level else None)
    return cols


def _levels_of(cs, leaf) -> Tuple[np.ndarray, np.ndarray]:
    """``leaf``'s def and rep levels over the set's spans: each span's
    pages decoded again on the set's device with their level streams and
    cut at the span's rows."""
    defs, reps = [], []
    for pf, g, start, count in cs.spans:
        with _open(pf) as f:
            d, r = _span_levels(f, g, leaf, start, count, cs.device)
        defs.append(d)
        reps.append(r)
    if not defs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(defs), np.concatenate(reps)


@contextlib.contextmanager
def _open(pf):
    """``pf`` itself, or where it was closed (``read_table`` closes its
    file) the same path opened again for the block."""
    if not pf.closed:
        yield pf
        return
    if pf._path is None:
        raise ValueError("to_arrow needs the level streams of a file that "
                         "was closed and has no path to open again")
    from .reader import ParquetFile

    with ParquetFile(pf._path) as f:
        yield f


def _span_levels(pf, g: int, leaf, start: int, count: int, device):
    from ..parallel.device_reader import decode_chunk_span
    from .search import pages_and_base

    rg = pf.row_group(g)
    chunk = rg.column(leaf.column_index)
    if start == 0 and count == rg.num_rows:
        col, base = decode_chunk_span(chunk, device, keep_levels=True), 0
    else:
        pages, base = pages_and_base(chunk, start, start + count)
        col = decode_chunk_span(chunk, device, pages=pages,
                                keep_levels=True)
    d = col.def_levels
    r = col.rep_levels
    if d is None:
        d = _synth_def(leaf, col)
    n = len(d)
    if r is None:
        r = np.zeros(n, np.int32)
    if leaf.max_repetition_level:
        starts = np.flatnonzero(np.asarray(r) == 0)
        a = start - base
        s0 = int(starts[a]) if a < len(starts) else n
        s1 = int(starts[a + count]) if a + count < len(starts) else n
    else:
        s0, s1 = start - base, start - base + count
    return (np.asarray(d, np.int32)[s0:s1], np.asarray(r, np.int32)[s0:s1])


# ---------------------------------------------------------------------------
# The assembly tiers
# ---------------------------------------------------------------------------


class _Assembly:
    """The JAX package's ``Table`` tiers over a set's columns (those of a
    struct or map field with their level streams)."""

    def __init__(self, schema, columns: Dict[str, Column], num_rows: int):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows

    def field(self, node):
        if _needs_row_assembly(node):
            return self.nested(node)
        return self.vectorized(node, (node.name,), 0)

    def _leaves_under(self, prefix) -> list:
        return [leaf for leaf in self.schema.leaves
                if leaf.path[:len(prefix)] == prefix]

    def nested(self, node):
        """A struct or map inside repetition from whole-column vector ops
        over the level streams, zipped bottom-up: at granularity ``(k,
        d_elem)`` the elements of the k-th repeated ancestor are the slots
        with ``rep <= k`` and ``def >= d_elem`` (k = 0: the rows), the same
        set for every leaf under a node (each with its level streams:
        :func:`_with_levels`)."""
        import pyarrow as pa

        sub = self._leaves_under((node.name,))

        def levels_of(leaf):
            col = self.columns[leaf.name]
            d = np.asarray(col.def_levels)
            r = (np.asarray(col.rep_levels) if col.rep_levels is not None
                 else np.zeros(len(d), np.int32))
            return d, r

        def any_leaf(pfx):
            return next(leaf for leaf in sub
                        if leaf.path[:len(pfx)] == pfx)

        def elem_mask(d, r, k, d_elem):
            return (r <= k) & (d >= d_elem)

        def list_layer(pfx, k, d_elem, d_list, d_mid, nullable_list):
            """The offsets (null lists masked) of one repetition layer."""
            d, r = levels_of(any_leaf(pfx))
            inst = elem_mask(d, r, k, d_elem)
            elem2 = elem_mask(d, r, k + 1, d_mid)
            cum = np.cumsum(elem2, dtype=np.int64)
            inst_idx = np.flatnonzero(inst)
            starts = (cum[inst_idx] - elem2[inst_idx]).astype(np.int32)
            total = np.int32(cum[-1] if len(cum) else 0)
            offs = np.concatenate([starts, [total]]).astype(np.int32)
            if nullable_list:
                valid = d[inst_idx] >= d_list
                if not valid.all():
                    return pa.array(offs, mask=np.concatenate(
                        [~valid, [False]]))
            return pa.array(offs)

        def build(n, pfx, k, d_elem, d_par):
            own_def = d_par + (1 if n.repetition != Rep.REQUIRED else 0)
            if n.is_leaf:
                leaf = any_leaf(pfx)
                col = self.columns[leaf.name]
                d, r = levels_of(leaf)
                d_sub = d[elem_mask(d, r, k, d_elem)]
                validity = (d_sub == leaf.max_definition_level
                            if leaf.max_definition_level > d_elem else None)
                if validity is not None and bool(validity.all()):
                    validity = None
                values, offsets = col.host_dense()
                return _leaf_to_arrow(leaf, values, offsets, validity)
            kind = n.logical_kind
            if kind == LogicalKind.LIST and len(n.children) == 1 \
                    and n.children[0].repetition == Rep.REPEATED:
                mid = n.children[0]
                d_mid = own_def + 1
                if mid.children is not None and len(mid.children) == 1:
                    inner = mid.children[0]
                    inner_arr = build(inner, pfx + (mid.name, inner.name),
                                      k + 1, d_mid, d_mid)
                else:  # the 2-level form: the repeated element itself
                    inner_arr = build_repeated_elem(mid, pfx + (mid.name,),
                                                    k + 1, d_mid)
                offs = list_layer(pfx, k, d_elem, own_def, d_mid,
                                  n.repetition != Rep.REQUIRED)
                return pa.ListArray.from_arrays(offs, inner_arr)
            if kind == LogicalKind.MAP and len(n.children) == 1:
                mid = n.children[0]  # the repeated key_value group
                d_mid = own_def + 1
                kv = pfx + (mid.name,)
                keys = build(mid.children[0], kv + (mid.children[0].name,),
                             k + 1, d_mid, d_mid)
                items = build(mid.children[1], kv + (mid.children[1].name,),
                              k + 1, d_mid, d_mid)
                offs = list_layer(pfx, k, d_elem, own_def, d_mid,
                                  n.repetition != Rep.REQUIRED)
                return pa.MapArray.from_arrays(offs, keys, items)
            if n.repetition == Rep.REPEATED:  # a legacy repeated group
                d_mid = d_par + 1
                inner_arr = build_repeated_elem(n, pfx, k + 1, d_mid)
                offs = list_layer(pfx, k, d_elem, d_mid, d_mid, False)
                return pa.ListArray.from_arrays(offs, inner_arr)
            kids = [(c.name, build(c, pfx + (c.name,), k, d_elem, own_def))
                    for c in n.children]
            arrs = [a for _, a in kids]
            names = [nm for nm, _ in kids]
            if n.repetition == Rep.REQUIRED or own_def == d_elem:
                return pa.StructArray.from_arrays(arrs, names)
            d, r = levels_of(any_leaf(pfx))
            valid = d[elem_mask(d, r, k, d_elem)] >= own_def
            if bool(valid.all()):
                return pa.StructArray.from_arrays(arrs, names)
            return pa.StructArray.from_arrays(arrs, names,
                                              mask=pa.array(~valid))

        def build_repeated_elem(n, pfx, k, d_elem):
            """A repeated group's element: a struct of its children (or a
            repeated leaf's own value) at the deeper granularity."""
            if n.is_leaf:
                return build(n, pfx, k, d_elem, d_elem)
            kids = [(c.name, build(c, pfx + (c.name,), k, d_elem, d_elem))
                    for c in n.children]
            return pa.StructArray.from_arrays([a for _, a in kids],
                                              [nm for nm, _ in kids])

        return build(node, (node.name,), 0, 0, 0)

    def vectorized(self, node, prefix, def_above: int):
        """A leaf or list chain by :meth:`Column.to_arrow`; a struct
        zipped from its children, null where the def level of its
        shallowest leaf (at row starts) stops above its own."""
        import pyarrow as pa

        if node.is_leaf or node.logical_kind == LogicalKind.LIST:
            return self.columns[self._leaves_under(prefix)[0].name] \
                .to_arrow()
        own_def = def_above + (1 if node.repetition != Rep.REQUIRED else 0)
        children = [(c.name, self.vectorized(c, prefix + (c.name,), own_def))
                    for c in node.children]
        arrs = [a for _, a in children]
        names = [n for n, _ in children]
        if node.repetition == Rep.REQUIRED:
            return pa.StructArray.from_arrays(arrs, names)
        rep_leaf = min(self._leaves_under(prefix),
                       key=lambda leaf: leaf.max_repetition_level)
        col = self.columns[rep_leaf.name]
        d = np.asarray(col.def_levels)
        if rep_leaf.max_repetition_level > 0:
            d = d[np.asarray(col.rep_levels) == 0]
        valid = d >= own_def
        if bool(np.all(valid)):
            return pa.StructArray.from_arrays(arrs, names)
        return pa.StructArray.from_arrays(arrs, names, mask=pa.array(~valid))

    def via_rows(self, node):
        """The row tier: the field's Python objects assembled record by
        record (``rows.py``), then one pyarrow array of the node's type.
        The JAX package falls back to it where a leaf has no level
        streams; here every leaf has them, and the tests hold
        :meth:`nested` to it."""
        import pyarrow as pa

        from ..rows import _Assembler, rows_from_columns
        from ..schema.schema import message

        sub_schema = message("root", [node])
        cols = {leaf.name: self.columns[leaf.name]
                for leaf in sub_schema.leaves}
        asm = _Assembler(sub_schema)
        objs = [asm.assemble(row)[node.name] for row in
                rows_from_columns(sub_schema, cols, self.num_rows)]
        return pa.array(objs, type=arrow_type_of(node))
