"""Decoded column: tensors on one device.

The port of ``parquet_tpu/io/column.py::Column`` for flat columns.
``values`` holds the dense present values (nulls are not stored), in the
form ``schema/types.py`` gives each physical type; a byte-array column adds
its ``offsets`` (int64, ``[n + 1]``).  ``validity`` holds one bool per slot
(None when no slot is null), ``num_slots`` the slot count (the row count of
a flat column).  A dictionary chunk keeps its decoded ``dictionary`` and,
where the decode produced them, its int32 ``dict_indices``; the fused
dictionary kernel never materializes indexes, so they may be None.  A
byte-array dictionary chunk stays encoded: ``values`` is None,
``dictionary`` is a ``(values, offsets)`` pair and ``dict_indices`` says
which entry each value is (the Arrow DictionaryArray form);
:meth:`Column.materialize` gathers it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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

    @property
    def num_values(self) -> int:
        if self.values is None and self.dict_indices is not None:
            return self.dict_indices.shape[0]
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.values.shape[0]

    def is_dictionary_encoded(self) -> bool:
        return self.values is None and self.dict_indices is not None

    def materialize(self) -> "Column":
        """Gather an encoded byte-array column into dense ``values`` and
        ``offsets`` on its own device (in place; returns self)."""
        if self.is_dictionary_encoded():
            dv, do = self.dictionary
            self.values, self.offsets = dev.gather_byte_arrays(
                dv, do, self.dict_indices)
        return self

    def materialize_host(self):
        """The dense present values as host numpy: an array, or for byte
        arrays a ``(values, offsets)`` pair.  The column is left as it
        is."""
        if self.is_dictionary_encoded():
            dv, do = self.dictionary
            values, offsets = dev.gather_byte_arrays(dv, do,
                                                     self.dict_indices)
            return values.cpu().numpy(), offsets.cpu().numpy()
        if self.offsets is not None:
            return self.values.cpu().numpy(), self.offsets.cpu().numpy()
        return self.values.cpu().numpy()


def _concat_byte_arrays(values_parts, offsets_parts) -> tuple:
    """(values, offsets) pairs as one, offsets rebased (each part's from
    0)."""
    offs, base = [offsets_parts[0][:1]], 0
    for o in offsets_parts:
        offs.append(o[1:] + base)
        base += int(o[-1])
    return torch.cat(values_parts), torch.cat(offs)


def _concat_dict_parts(parts: List[Column]) -> Column:
    """Encoded byte-array parts stay encoded: each part's indexes rebased by
    the sizes of the dictionaries before it, the dictionaries concatenated
    (entries repeated across row groups are kept), as the JAX package's
    ``_concat_dict_parts`` does."""
    idx_parts, base = [], 0
    for p in parts:
        idx_parts.append(p.dict_indices + base)
        base += p.dictionary[1].shape[0] - 1
    dictionary = _concat_byte_arrays([p.dictionary[0] for p in parts],
                                     [p.dictionary[1] for p in parts])
    return Column(leaf=parts[0].leaf, values=None,
                  validity=_concat_validity(parts),
                  num_slots=sum(p.num_slots for p in parts),
                  dictionary=dictionary, dict_indices=torch.cat(idx_parts))


def _concat_validity(parts: List[Column]) -> Optional[torch.Tensor]:
    if all(p.validity is None for p in parts):
        return None
    device = next(p.validity.device for p in parts
                  if p.validity is not None)
    return torch.cat([
        p.validity if p.validity is not None
        else torch.ones(p.num_slots, dtype=torch.bool, device=device)
        for p in parts])


def concat_columns(parts: List[Column]) -> Column:
    """One column from its per-row-group parts.  Encoded byte-array parts
    merge encoded; a mix of encoded and dense parts is gathered first.
    Other dictionaries and indexes are kept only for a single part: row
    groups carry their own dictionaries."""
    if len(parts) == 1:
        return parts[0]
    if all(p.is_dictionary_encoded() for p in parts):
        return _concat_dict_parts(parts)
    for p in parts:
        p.materialize()
    offsets = None
    if parts[0].offsets is not None:
        values, offsets = _concat_byte_arrays([p.values for p in parts],
                                              [p.offsets for p in parts])
    else:
        values = torch.cat([p.values for p in parts])
    return Column(leaf=parts[0].leaf, values=values, offsets=offsets,
                  validity=_concat_validity(parts),
                  num_slots=sum(p.num_slots for p in parts))

