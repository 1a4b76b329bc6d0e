"""Decoded column: tensors on one device.

The port of ``parquet_tpu/io/column.py::Column``.
``values`` holds the dense present values (nulls are not stored), in the
form ``schema/types.py`` gives each physical type; a byte-array column adds
its ``offsets`` (int64, ``[n + 1]``).  ``validity`` holds one bool per slot
of a flat column, or per innermost element of a repeated one (None when no
value is null); ``num_slots`` is the level-stream length (the row count of
a flat column).  A column under repeated nodes adds, per repeated level
and outermost first, its ``list_offsets`` (int64 ``[lists + 1]``) and
``list_validity`` (bool ``[lists]``).  ``def_levels`` and ``rep_levels``
keep host level streams where the decode expanded them on the host (a
struct chain keeps its def levels for the nullness of each struct).  A dictionary chunk keeps its decoded ``dictionary`` and,
where the decode produced them, its int32 ``dict_indices``; the fused
dictionary kernel never materializes indexes, so they may be None.  A
byte-array dictionary chunk stays encoded: ``values`` is None,
``dictionary`` is a ``(values, offsets)`` pair and ``dict_indices`` says
which entry each value is (the Arrow DictionaryArray form);
:meth:`Column.materialize` gathers it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

import torch

from ..ops import device as dev
from ..schema.schema import Leaf


@dataclass
class Column:
    leaf: Leaf
    values: Optional[torch.Tensor]
    validity: Optional[torch.Tensor] = None
    num_slots: int = 0
    dictionary: object = None  # tensor, or (values, offsets) tensors
    dict_indices: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None  # byte arrays: int64[n + 1]
    list_offsets: List[torch.Tensor] = field(default_factory=list)
    list_validity: List[torch.Tensor] = field(default_factory=list)
    def_levels: Optional[np.ndarray] = None  # host int32, where expanded
    rep_levels: Optional[np.ndarray] = None

    @property
    def num_values(self) -> int:
        if self.values is None and self.dict_indices is not None:
            return self.dict_indices.shape[0]
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.values.shape[0]

    def is_dictionary_encoded(self) -> bool:
        return self.values is None and self.dict_indices is not None

    def to(self, device) -> "Column":
        """A column like this one with every tensor on ``device`` (a
        tensor already there is shared, not copied)."""
        device = torch.device(device)

        def move(t):
            if isinstance(t, tuple):
                return tuple(move(x) for x in t)
            return None if t is None else t.to(device)

        return Column(
            leaf=self.leaf, values=move(self.values),
            validity=move(self.validity), num_slots=self.num_slots,
            dictionary=move(self.dictionary),
            dict_indices=move(self.dict_indices),
            offsets=move(self.offsets),
            list_offsets=[move(o) for o in self.list_offsets],
            list_validity=[move(v) for v in self.list_validity],
            def_levels=self.def_levels, rep_levels=self.rep_levels)

    def materialize(self) -> "Column":
        """Gather an encoded byte-array column into dense ``values`` and
        ``offsets`` on its own device (in place; returns self)."""
        if self.is_dictionary_encoded():
            dv, do = self.dictionary
            self.values, self.offsets = dev.gather_byte_arrays(
                dv, do, self.dict_indices)
        return self

    @property
    def num_elements(self) -> int:
        """Entries ``validity`` covers: the innermost elements of a
        repeated column, the slots of a flat one."""
        if self.list_offsets:
            return int(self.list_offsets[-1][-1])
        return self.num_slots

    def materialize_host(self):
        """The column on the host, as numpy; the column is left as it is.
        A flat column gives its dense present values: an array, or for byte
        arrays a ``(values, offsets)`` pair.  A column with list levels or
        host def levels gives a dict: ``values`` (as a flat column's),
        ``validity``, ``list_offsets`` and ``list_validity`` (one array a
        repeated level, outermost first), ``def_levels`` and
        ``rep_levels``."""
        if self.is_dictionary_encoded():
            dv, do = self.dictionary
            values, offsets = dev.gather_byte_arrays(dv, do,
                                                     self.dict_indices)
            values = values.cpu().numpy(), offsets.cpu().numpy()
        elif self.offsets is not None:
            values = self.values.cpu().numpy(), self.offsets.cpu().numpy()
        else:
            values = self.values.cpu().numpy()
        if not self.list_offsets and self.def_levels is None:
            return values
        return {"values": values,
                "validity": None if self.validity is None
                else self.validity.cpu().numpy(),
                "list_offsets": [o.cpu().numpy() for o in self.list_offsets],
                "list_validity": [v.cpu().numpy()
                                  for v in self.list_validity],
                "def_levels": self.def_levels,
                "rep_levels": self.rep_levels}


def _concat_byte_arrays(values_parts, offsets_parts, sizes=None) -> tuple:
    """(values, offsets) pairs as one, offsets rebased (each part's from
    0).  ``sizes`` gives each part's byte count where the caller knows it
    (None: read from its offsets)."""
    offs, vals, base = [offsets_parts[0][:1]], [], 0
    for i, (v, o) in enumerate(zip(values_parts, offsets_parts)):
        n = sizes[i] if sizes is not None and sizes[i] is not None \
            else int(o[-1])
        vals.append(v[:n])
        offs.append(o[1:] + base)
        base += n
    return torch.cat(vals), torch.cat(offs)


def _dict_key(dictionary) -> int:
    """A dictionary's identity: its tensor's (the staging rebuilds the
    tuple of a byte-array dictionary around the same tensors)."""
    return id(dictionary[0] if isinstance(dictionary, tuple) else dictionary)


def _concat_dict_parts(parts: List[Column], structure: dict) -> Column:
    """Encoded byte-array parts stay encoded: each part's indexes rebased by
    the sizes of the distinct dictionaries before its own, the distinct
    dictionaries concatenated (entries repeated across row groups are
    kept), as the JAX package's ``_concat_dict_parts`` does.  Parts that
    share a dictionary (slices of one chunk) share its entries."""
    bases, dicts, base = {}, [], 0
    for p in parts:
        key = _dict_key(p.dictionary)
        if key not in bases:
            bases[key] = base
            base += p.dictionary[1].shape[0] - 1
            dicts.append(p.dictionary)
    indices = torch.cat([
        p.dict_indices + bases[_dict_key(p.dictionary)]
        if bases[_dict_key(p.dictionary)] else p.dict_indices
        for p in parts])
    # a dictionary's values are exactly its entries' bytes
    dictionary = dicts[0] if len(dicts) == 1 else _concat_byte_arrays(
        [d[0] for d in dicts], [d[1] for d in dicts],
        [d[0].shape[0] for d in dicts])
    return Column(leaf=parts[0].leaf, values=None, dictionary=dictionary,
                  dict_indices=indices, **structure)


def _concat_validity(parts: List[Column],
                     elements=None) -> Optional[torch.Tensor]:
    if all(p.validity is None for p in parts):
        return None
    device = next(p.validity.device for p in parts
                  if p.validity is not None)
    return torch.cat([
        p.validity if p.validity is not None
        else torch.ones(p.num_elements if elements is None else elements[i],
                        dtype=torch.bool, device=device)
        for i, p in enumerate(parts)])


def _concat_offsets(parts: List[torch.Tensor]) -> torch.Tensor:
    """List offsets of consecutive parts (each from 0) as one: each part
    rebased by the lengths before it, on the device (no read-back)."""
    lasts = torch.stack([o[-1] for o in parts])
    bases = torch.cumsum(lasts, 0) - lasts
    return torch.cat([parts[0][:1]] + [o[1:] + bases[i]
                                       for i, o in enumerate(parts)])


def _concat_host(arrays) -> Optional[np.ndarray]:
    return (None if any(a is None for a in arrays)
            else np.concatenate(arrays))


def _concat_structure(parts: List[Column], elements=None) -> dict:
    """The validity, list levels, level streams and slot count of
    consecutive parts as one column's, as the JAX package's
    ``_concat_structure``."""
    nlev = len(parts[0].list_offsets)
    return {
        "validity": _concat_validity(parts, elements),
        "list_offsets": [_concat_offsets([p.list_offsets[k] for p in parts])
                         for k in range(nlev)],
        "list_validity": [torch.cat([p.list_validity[k] for p in parts])
                          for k in range(nlev)],
        "def_levels": _concat_host([p.def_levels for p in parts]),
        "rep_levels": _concat_host([p.rep_levels for p in parts]),
        "num_slots": sum(p.num_slots for p in parts)}


def concat_columns(parts: List[Column], elements=None,
                   nbytes=None) -> Column:
    """One column from consecutive parts: its row groups, or a streamed
    batch's slices of page spans.  Encoded byte-array parts merge encoded;
    a mix of encoded and dense parts is gathered dense, each part left as
    it is.  A dictionary that every part shares (slices of one chunk) is
    kept once, with the indexes where every part has them; parts with
    dictionaries of their own (row groups) keep none, except encoded byte
    arrays.  ``elements`` (each
    part's validity length) and ``nbytes`` (each dense byte-array part's
    byte count, None where unknown) spare reading them from the device."""
    if len(parts) == 1:
        return parts[0]
    structure = _concat_structure(parts, elements)
    if all(p.is_dictionary_encoded() for p in parts):
        return _concat_dict_parts(parts, structure)
    leaf = parts[0].leaf
    if any(p.offsets is not None for p in parts):  # byte arrays
        vparts, oparts, sizes = [], [], []
        for i, p in enumerate(parts):
            if p.is_dictionary_encoded():
                p = Column(leaf=leaf, values=None, dictionary=p.dictionary,
                           dict_indices=p.dict_indices).materialize()
                sizes.append(None)
            else:
                sizes.append(None if nbytes is None else nbytes[i])
            vparts.append(p.values)
            oparts.append(p.offsets)
        values, offsets = _concat_byte_arrays(vparts, oparts, sizes)
        return Column(leaf=leaf, values=values, offsets=offsets,
                      **structure)
    values = torch.cat([p.values for p in parts])
    dictionary = indices = None
    if len({_dict_key(p.dictionary) for p in parts}) == 1:
        dictionary = parts[0].dictionary
        if all(p.dict_indices is not None for p in parts):
            indices = torch.cat([p.dict_indices for p in parts])
    return Column(leaf=leaf, values=values, dictionary=dictionary,
                  dict_indices=indices, **structure)
