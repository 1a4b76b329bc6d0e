"""Dremel definition and repetition levels, as whole-column numpy math.

The port's copy of ``parquet_tpu/ops/levels.py``: the host assembler
(levels to list offsets, list validity and leaf validity per repeated
level), the row-to-slot map, and the writer's inverse (offsets and
validity to levels).  ``ops/device.py::assemble_single_list`` and
``assemble_nested`` are the same assembly as torch ops on the device.

Level semantics (the Parquet format):

- each OPTIONAL node on a leaf's path adds one definition level, each
  REPEATED node one definition and one repetition level;
- a leaf slot's ``def == max_def`` iff its value is present;
- ``rep == k`` continues the list of the level-k repeated node, ``rep < k``
  starts a new one; ``rep == 0`` starts a row.

List offsets are int64 here and on the device (the JAX package's are
int32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..format.enums import FieldRepetitionType as Rep
from ..schema.schema import Leaf


@dataclass
class LevelInfo:
    """One repeated node on a leaf's path."""

    rep_level: int  # its repetition level (1-based)
    def_level: int  # its definition level


def repeated_ancestors(leaf: Leaf) -> List[LevelInfo]:
    """The repeated nodes on the leaf's path (the leaf included), outermost
    first."""
    out = []
    d = r = 0
    for node in leaf.ancestors:
        if node.repetition == Rep.OPTIONAL:
            d += 1
        elif node.repetition == Rep.REPEATED:
            d += 1
            r += 1
            out.append(LevelInfo(rep_level=r, def_level=d))
    return out


@dataclass
class Assembled:
    """One leaf column's structure.  ``validity`` masks the innermost
    elements (a flat column: its slots), None where no value can be null;
    ``list_offsets[k]`` (int64) and ``list_validity[k]`` describe the k-th
    repeated level, outermost first (both empty for a flat column)."""

    validity: Optional[np.ndarray]
    list_offsets: List[np.ndarray]
    list_validity: List[np.ndarray]


def assemble(def_levels: Optional[np.ndarray],
             rep_levels: Optional[np.ndarray], leaf: Leaf) -> Assembled:
    """Level streams to offsets and validity, level by level.  For the
    level-k repeated node (rep level k, def level d_k):

    - its instances (the entries of the level above) are the slots with
      ``rep < k`` and, below the outermost level, ``def >= d_{k-1}``;
    - an instance is a non-null list iff ``def >= d_k - 1`` at its first
      slot (an empty list has ``def == d_k - 1``);
    - its elements are the instances of level k + 1, or for the innermost
      level the slots with ``def >= d_k``;
    - the leaf validity (over the innermost elements) is
      ``def == max_def``.

    Struct layers between repeated levels collapse into the nearest list
    validity; a struct's own nullness is a table-level concern that reads
    ``Column.def_levels``."""
    max_def = leaf.max_definition_level
    max_rep = leaf.max_repetition_level
    if max_def == 0 or (def_levels is None and max_rep == 0):
        return Assembled(validity=None, list_offsets=[], list_validity=[])
    d = np.asarray(def_levels if def_levels is not None
                   else np.zeros(0, np.int32))
    if max_rep == 0:
        return Assembled(validity=d == max_def, list_offsets=[],
                         list_validity=[])
    r = np.asarray(rep_levels if rep_levels is not None
                   else np.zeros(0, np.int32))
    infos = repeated_ancestors(leaf)
    offsets, validities = [], []
    for i, info in enumerate(infos):
        k, dk = info.rep_level, info.def_level
        inst = r < k
        if i:
            inst &= d >= infos[i - 1].def_level
        inst_idx = np.flatnonzero(inst)
        elem = d >= dk
        if i + 1 < len(infos):
            elem &= r < infos[i + 1].rep_level
        cum = np.cumsum(elem, dtype=np.int64)
        offs = np.zeros(len(inst_idx) + 1, np.int64)
        if len(inst_idx) > 1:
            offs[1:-1] = cum[inst_idx[1:] - 1]
        offs[-1] = cum[-1] if len(cum) else 0
        offsets.append(offs)
        validities.append(d[inst_idx] >= dk - 1)
    inner = d >= infos[-1].def_level
    return Assembled(validity=(d == max_def)[inner], list_offsets=offsets,
                     list_validity=validities)


def row_slot_starts(rep_levels: np.ndarray) -> np.ndarray:
    """The slot where each row begins (rows start at ``rep == 0``): the
    writer's page split and a batch slicer map rows to slots with it."""
    return np.flatnonzero(np.asarray(rep_levels) == 0)


# ---------------------------------------------------------------------------
# Write direction: offsets and validity to level streams
# ---------------------------------------------------------------------------


def levels_for_flat(validity: Optional[np.ndarray], num_values: int,
                    max_def: int) -> Optional[np.ndarray]:
    """Def levels of a column with no repeated node (None where
    ``max_def == 0``); a null slot gets ``max_def - 1``: a null in a struct
    chain is the leaf's own."""
    if max_def == 0:
        return None
    d = np.full(num_values, max_def, dtype=np.int32)
    if validity is not None:
        d[~np.asarray(validity, bool)] = max_def - 1
    return d


def _ranges(lengths: np.ndarray) -> np.ndarray:
    """``[0..l0), [0..l1), ...`` concatenated."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def levels_for_list(list_offsets: np.ndarray,
                    list_validity: Optional[np.ndarray],
                    elem_validity: Optional[np.ndarray],
                    leaf: Leaf) -> Tuple[np.ndarray, np.ndarray]:
    """``(def, rep)`` of a column with one repeated node: one slot per
    element, and one per null or empty list.  ``list_offsets`` is
    ``int[rows + 1]``, ``list_validity`` ``bool[rows]`` or None,
    ``elem_validity`` ``bool[elements]`` or None."""
    infos = repeated_ancestors(leaf)
    if len(infos) != 1:
        raise ValueError(f"column {leaf.name!r}: levels_for_list takes one "
                         f"repeated level, the column has {len(infos)}")
    dk = infos[0].def_level
    max_def = leaf.max_definition_level
    offs = np.asarray(list_offsets, np.int64)
    n_rows = len(offs) - 1
    lens = offs[1:] - offs[:-1]
    if list_validity is not None:
        lens = np.where(list_validity, lens, 0)
    slots = np.maximum(lens, 1)  # a null or empty list holds one slot
    total = int(slots.sum())
    rep = np.ones(total, dtype=np.int32)
    row_starts = np.zeros(n_rows, dtype=np.int64)
    np.cumsum(slots[:-1], out=row_starts[1:])
    rep[row_starts] = 0
    d = np.full(total, max_def, dtype=np.int32)
    empty = lens == 0
    if list_validity is not None:
        null = ~np.asarray(list_validity, bool)
        d[row_starts[null]] = dk - 2
        d[row_starts[empty & ~null]] = dk - 1
    else:
        d[row_starts[empty]] = dk - 1
    if elem_validity is not None and max_def > dk:
        elem_slots = np.repeat(row_starts, lens) + _ranges(lens)
        d[elem_slots[~np.asarray(elem_validity, bool)]] = max_def - 1
    return d, rep


def levels_for_nested(list_offsets: List[np.ndarray],
                      list_validity: List[Optional[np.ndarray]],
                      elem_validity: Optional[np.ndarray],
                      leaf: Leaf) -> Tuple[np.ndarray, np.ndarray]:
    """``(def, rep)`` of a chain of repeated levels of any depth.

    ``list_offsets[k]`` and ``list_validity[k]`` describe repeated level k,
    outermost first (the form :func:`assemble` gives); ``elem_validity``
    masks the innermost elements.  Built from the inside out: one slot per
    innermost element, then at each level the elements' slot spans are
    joined into lists, with one slot made for each empty (``def = d_k -
    1``) or null (``def = d_k - 2``) list, and the first slot of every
    element that continues a list marked ``rep = r_k``.  A null list's
    offsets span no elements.  Optional structs between the repeated
    levels are taken as present."""
    infos = repeated_ancestors(leaf)
    nlev = len(infos)
    if not nlev == len(list_offsets) == len(list_validity):
        raise ValueError(f"column {leaf.name!r}: {nlev} repeated levels, "
                         f"{len(list_offsets)} offsets and "
                         f"{len(list_validity)} validity arrays")
    max_def = leaf.max_definition_level
    inner_offs = np.asarray(list_offsets[-1], np.int64)
    n_inner = int(inner_offs[-1]) if len(inner_offs) else 0
    d = np.full(n_inner, max_def, dtype=np.int32)
    if elem_validity is not None and max_def > infos[-1].def_level:
        d[~np.asarray(elem_validity, bool)] = max_def - 1
    r = np.full(n_inner, infos[-1].rep_level, dtype=np.int32)
    counts = np.ones(n_inner, dtype=np.int64)  # slots of each element
    for k in range(nlev - 1, -1, -1):
        rk, dk = infos[k].rep_level, infos[k].def_level
        offs = np.asarray(list_offsets[k], np.int64)
        lv = list_validity[k]
        n_inst = len(offs) - 1
        elem_starts = np.zeros(len(counts), dtype=np.int64)
        if len(counts) > 1:
            np.cumsum(counts[:-1], out=elem_starts[1:])
        # an element's first slot continues its list; the first element of
        # each list is re-marked by the level above
        r[elem_starts] = rk
        nonempty = offs[1:] > offs[:-1]
        if lv is not None:
            nonempty &= np.asarray(lv, dtype=bool)
        starts_ext = np.concatenate([elem_starts, [len(d)]])
        inst_start = starts_ext[offs[:-1]]
        inst_counts = starts_ext[offs[1:]] - inst_start
        synth = ~nonempty
        if synth.any():
            pos = inst_start[synth]
            sdef = np.full(int(synth.sum()), dk - 1, dtype=np.int32)
            if lv is not None:
                sdef[~np.asarray(lv, dtype=bool)[synth]] = dk - 2
            d = np.insert(d, pos, sdef)
            r = np.insert(r, pos, np.int32(rk))
            inst_counts = np.where(synth, 1, inst_counts)
        counts = inst_counts
        if k == 0:
            firsts = np.zeros(n_inst, dtype=np.int64)
            if n_inst > 1:
                np.cumsum(counts[:-1], out=firsts[1:])
            r[firsts] = 0
    return d, r
