"""Flat schema: the root message and its leaf columns with their Dremel levels.

The port's cut of ``parquet_tpu/schema/schema.py``.  The flat, depth-first
``FileMetaData.schema`` element list parses into one :class:`Leaf` per
column, with ``max_definition_level``/``max_repetition_level``, its ``type_length``
(fixed-length byte arrays) and whether it is annotated as a UTF-8 string
(the STRING logical type or the UTF8 converted type).  The port reads
flat columns only (``max_rep == 0``, ``max_def <= 1``): a nested or
repeated schema raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..errors import CorruptedError, unsupported
from ..format import metadata as md
from ..format.enums import ConvertedType, Type
from ..format.enums import FieldRepetitionType as Rep


@dataclass
class Leaf:
    """One flat column: everything the column decoder needs."""

    column_index: int
    name: str
    physical_type: Type
    repetition: Rep = Rep.REQUIRED
    type_length: Optional[int] = None  # FIXED_LEN_BYTE_ARRAY only
    string: bool = False  # BYTE_ARRAY annotated as UTF-8

    @property
    def max_definition_level(self) -> int:
        return 1 if self.repetition == Rep.OPTIONAL else 0

    @property
    def max_repetition_level(self) -> int:
        return 0


class Schema:
    """A root message of flat leaves, by ordinal and by name."""

    def __init__(self, leaves: List[Leaf], name: str = "schema"):
        self.name = name
        self.leaves = leaves
        self._by_name: Dict[str, Leaf] = {}
        for i, leaf in enumerate(leaves):
            leaf.column_index = i
            if leaf.name in self._by_name:
                raise ValueError(f"duplicate column name {leaf.name!r}")
            self._by_name[leaf.name] = leaf

    def leaf(self, name: str) -> Leaf:
        return self._by_name[name]

    @classmethod
    def from_elements(cls, elements: List[md.SchemaElement]) -> "Schema":
        """Parse the footer's element list: a root with leaf children only."""
        root = elements[0]
        n = root.num_children or 0
        if len(elements) != n + 1:
            raise unsupported("nested schema (group columns)",
                              "nested assembly")
        leaves = []
        for el in elements[1:]:
            if el.num_children:
                raise unsupported(f"group column {el.name!r}",
                                  "nested assembly")
            rep = Rep(el.repetition_type if el.repetition_type is not None
                      else Rep.REQUIRED)
            if rep == Rep.REPEATED:
                raise unsupported(f"repeated column {el.name!r}",
                                  "nested assembly")
            if el.type is None:
                raise CorruptedError(f"leaf {el.name!r} has no physical type")
            physical = Type(el.type)
            if physical == Type.FIXED_LEN_BYTE_ARRAY and not (
                    el.type_length and el.type_length > 0):
                raise CorruptedError(f"fixed-length column {el.name!r} has "
                                     f"type_length {el.type_length}")
            string = (el.converted_type == ConvertedType.UTF8 or (
                el.logicalType is not None
                and el.logicalType.STRING is not None))
            leaves.append(Leaf(
                -1, el.name or "", physical, rep,
                el.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
                else None, string and physical == Type.BYTE_ARRAY))
        return cls(leaves, root.name or "schema")

    def to_elements(self) -> List[md.SchemaElement]:
        out = [md.SchemaElement(name=self.name, num_children=len(self.leaves))]
        for leaf in self.leaves:
            out.append(md.SchemaElement(
                name=leaf.name, type=int(leaf.physical_type),
                type_length=leaf.type_length,
                repetition_type=int(leaf.repetition),
                converted_type=int(ConvertedType.UTF8) if leaf.string
                else None,
                logicalType=md.LogicalType(STRING=md.StringType())
                if leaf.string else None))
        return out
