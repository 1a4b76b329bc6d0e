"""Schema tree: groups and leaf columns with their Dremel levels.

The port of ``parquet_tpu/schema/schema.py``.  The flat, depth-first
``FileMetaData.schema`` element list parses into a tree of :class:`Node`;
each leaf becomes a :class:`Leaf` with its column ordinal, its path, its
max definition and repetition levels and the nodes above it (the inputs of
the level assembly in ``ops/levels.py`` and ``ops/device.py``).  Groups
may be OPTIONAL or REPEATED at any depth, and carry the LIST and MAP
annotations.  A leaf's :attr:`Leaf.name` is its dotted path
(``ts.list.element``); a flat leaf's is its column name.  The builders at
the end (``leaf``, ``group``, ``list_of``, ``map_of``, ``message``) make
schemas to write.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..errors import (MAX_COLUMN_DEPTH, ColumnTooDeepError, CorruptedError,
                      MissingRootColumnError)
from ..format import metadata as md
from ..format.enums import ConvertedType, Type
from ..format.enums import FieldRepetitionType as Rep
from .types import LogicalKind
from .types import _logical_from_element as _logical_kind


@dataclass(eq=False)
class Node:
    """One element of the schema tree: a leaf (``children`` is None) or a
    group."""

    name: str
    repetition: Rep = Rep.REQUIRED
    # leaf fields
    physical_type: Optional[Type] = None
    type_length: Optional[int] = None  # FIXED_LEN_BYTE_ARRAY width
    logical_kind: str = LogicalKind.NONE
    # group fields
    children: Optional[List["Node"]] = None
    # INT: bit_width, signed; DECIMAL: precision, scale
    logical_params: dict = field(default_factory=dict)

    @property
    def is_leaf(self) -> bool:
        return self.children is None


class Leaf:
    """One leaf column: everything its decoder needs.

    ``Leaf(column_index, name, physical_type, repetition, type_length,
    string)`` makes a flat column directly under the root (the form the
    flat writer and the tests build); :class:`Schema` makes the leaves of a
    tree with :meth:`at`."""

    def __init__(self, column_index: int, name: str, physical_type: Type,
                 repetition: Rep = Rep.REQUIRED,
                 type_length: Optional[int] = None, string: bool = False):
        physical = Type(physical_type)
        node = Node(name, Rep(repetition), physical,
                    type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
                    else None,
                    LogicalKind.STRING if string else LogicalKind.NONE)
        rep = Rep(repetition)
        self._set(column_index, (name,), node,
                  int(rep != Rep.REQUIRED), int(rep == Rep.REPEATED),
                  (node,))

    @classmethod
    def at(cls, column_index: int, path: Tuple[str, ...], node: Node,
           max_definition_level: int, max_repetition_level: int,
           ancestors: Tuple[Node, ...]) -> "Leaf":
        """The leaf of ``node`` at ``path`` in a tree; ``ancestors`` are the
        nodes from below the root down to ``node`` itself."""
        leaf = cls.__new__(cls)
        leaf._set(column_index, path, node, max_definition_level,
                  max_repetition_level, ancestors)
        return leaf

    def _set(self, column_index, path, node, max_def, max_rep, ancestors):
        self.column_index = column_index
        self.path = tuple(path)
        self.node = node
        self.max_definition_level = max_def
        self.max_repetition_level = max_rep
        self.ancestors = tuple(ancestors)

    @property
    def name(self) -> str:
        """The dotted path (a flat leaf: its column name)."""
        return ".".join(self.path)

    @property
    def dotted_path(self) -> str:
        """The JAX package's name for :attr:`name`."""
        return self.name

    def np_dtype(self):
        """The numpy dtype of the leaf's values (``types.logical_np_dtype``;
        None for byte arrays, FLBA and INT96)."""
        from .types import logical_np_dtype

        return logical_np_dtype(self.physical_type, self.logical_kind,
                                self.logical_params)

    @property
    def physical_type(self) -> Type:
        return self.node.physical_type

    @property
    def type_length(self) -> Optional[int]:
        return self.node.type_length

    @property
    def repetition(self) -> Rep:
        return self.node.repetition

    @property
    def logical_kind(self) -> str:
        return self.node.logical_kind

    @property
    def logical_params(self) -> dict:
        return self.node.logical_params

    @property
    def string(self) -> bool:
        """A BYTE_ARRAY annotated as UTF-8."""
        return (self.node.logical_kind == LogicalKind.STRING
                and self.node.physical_type == Type.BYTE_ARRAY)

    def __repr__(self):
        return (f"Leaf({self.name!r}, {Type(self.physical_type).name}, "
                f"def={self.max_definition_level}, "
                f"rep={self.max_repetition_level})")


class Schema:
    """A schema tree with its leaves in column order, by dotted path.

    ``Schema(root)`` takes the root :class:`Node`; ``Schema(leaves, name)``
    a list of flat leaves, which become the root's children (the flat
    writer's form)."""

    def __init__(self, root: Union[Node, Sequence[Leaf]],
                 name: str = "schema"):
        given = None
        if not isinstance(root, Node):
            given = list(root)
            if any(len(leaf.path) != 1 for leaf in given):
                raise ValueError("Schema(leaves) takes flat leaves only")
            root = Node(name, children=[leaf.node for leaf in given])
        self.root = root
        self.name = root.name
        self.leaves: List[Leaf] = []
        self._walk(root, (), 0, 0, ())
        if given is not None:
            self.leaves = given
        self._by_path: Dict[Tuple[str, ...], Leaf] = {}
        self._by_name: Dict[str, Leaf] = {}
        for i, leaf in enumerate(self.leaves):
            leaf.column_index = i
            if leaf.name in self._by_name:
                raise ValueError(f"duplicate column name {leaf.name!r}")
            self._by_name[leaf.name] = leaf
            self._by_path[leaf.path] = leaf

    def _walk(self, n: Node, path, def_level, rep_level, ancestors):
        if n is not self.root:
            if n.repetition == Rep.OPTIONAL:
                def_level += 1
            elif n.repetition == Rep.REPEATED:
                def_level += 1
                rep_level += 1
            path = path + (n.name,)
            ancestors = ancestors + (n,)
        if n.is_leaf:
            if n is self.root:
                raise CorruptedError("the schema root is a leaf")
            if len(path) > MAX_COLUMN_DEPTH:
                raise ColumnTooDeepError(
                    f"column {'.'.join(path)!r} is {len(path)} levels deep "
                    f"(limit {MAX_COLUMN_DEPTH})")
            self.leaves.append(Leaf.at(-1, path, n, def_level, rep_level,
                                       ancestors))
            return
        for c in n.children:
            self._walk(c, path, def_level, rep_level, ancestors)

    def leaf(self, path) -> Leaf:
        """The leaf at a dotted path or a tuple of names; a group's path
        resolves where exactly one leaf lies beneath it."""
        if isinstance(path, str):
            hit = self._by_name.get(path)
            if hit is not None:
                return hit
            path = tuple(path.split("."))
        path = tuple(path)
        hit = self._by_path.get(path)
        if hit is not None:
            return hit
        under = [leaf for leaf in self.leaves
                 if leaf.path[:len(path)] == path]
        if len(under) == 1:
            return under[0]
        raise KeyError(path)

    def __len__(self):
        return len(self.leaves)

    # ------------------------------------------------------------------ read
    @classmethod
    def from_elements(cls, elements: List[md.SchemaElement]) -> "Schema":
        """Parse the footer's flat, depth-first element list into a
        tree."""
        pos = 0

        def build(depth: int) -> Node:
            nonlocal pos
            if pos >= len(elements):
                raise CorruptedError("schema element list ends inside a "
                                     "group")
            if depth > MAX_COLUMN_DEPTH:
                raise CorruptedError(f"schema deeper than "
                                     f"{MAX_COLUMN_DEPTH} levels")
            el = elements[pos]
            pos += 1
            rep = Rep(el.repetition_type if el.repetition_type is not None
                      else Rep.REQUIRED)
            kind, params = _logical_kind(el)
            if el.num_children or depth == 0:
                return Node(el.name or "", rep, logical_kind=kind,
                            children=[build(depth + 1)
                                      for _ in range(el.num_children or 0)])
            if el.type is None:
                raise CorruptedError(f"leaf {el.name!r} has no physical type")
            physical = Type(el.type)
            if physical == Type.FIXED_LEN_BYTE_ARRAY and not (
                    el.type_length and el.type_length > 0):
                raise CorruptedError(f"fixed-length column {el.name!r} has "
                                     f"type_length {el.type_length}")
            if kind == LogicalKind.STRING and physical != Type.BYTE_ARRAY:
                kind = LogicalKind.NONE
            return Node(el.name or "", rep, physical,
                        el.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
                        else None, kind, logical_params=params)

        if not elements:
            raise MissingRootColumnError("the schema has no root element")
        root = build(0)
        if pos != len(elements):
            raise CorruptedError(f"schema element list malformed: the tree "
                                 f"holds {pos} of {len(elements)}")
        return cls(root)

    # ----------------------------------------------------------------- write
    def to_elements(self) -> List[md.SchemaElement]:
        out: List[md.SchemaElement] = []

        def emit(n: Node, is_root: bool):
            el = md.SchemaElement(name=n.name)
            if not is_root:
                el.repetition_type = int(n.repetition)
            if n.is_leaf:
                el.type = int(n.physical_type)
                if n.physical_type == Type.FIXED_LEN_BYTE_ARRAY:
                    el.type_length = n.type_length
            else:
                el.num_children = len(n.children)
            el.logicalType, el.converted_type, extra = _logical_to_thrift(
                n.logical_kind, n.logical_params or {})
            if extra:
                el.scale, el.precision = extra["scale"], extra["precision"]
            out.append(el)
            for c in n.children or ():
                emit(c, False)

        emit(self.root, True)
        return out

    def __repr__(self):
        lines = []

        def p(n, indent, is_root):
            pad = "  " * indent
            rep = "" if is_root else Rep(n.repetition).name.lower() + " "
            if n.is_leaf:
                lt = (f" ({n.logical_kind})"
                      if n.logical_kind != LogicalKind.NONE else "")
                lines.append(f"{pad}{rep}{Type(n.physical_type).name} "
                             f"{n.name}{lt};")
            else:
                kw = "message" if is_root else "group"
                lines.append(f"{pad}{rep}{kw} {n.name} {{")
                for c in n.children:
                    p(c, indent + 1, False)
                lines.append(f"{pad}}}")

        p(self.root, 0, True)
        return "\n".join(lines)


def _logical_to_thrift(kind: str, params: dict):
    """A logical kind and its parameters as ``(LogicalType,
    converted_type, {scale, precision} or None)``, as the JAX package's
    ``_logical_to_thrift`` writes them."""
    L, C, K = md.LogicalType, ConvertedType, LogicalKind
    simple = {K.STRING: (L(STRING=md.StringType()), C.UTF8),
              K.ENUM: (L(ENUM=md.EnumType()), C.ENUM),
              K.JSON: (L(JSON=md.JsonType()), C.JSON),
              K.BSON: (L(BSON=md.BsonType()), C.BSON),
              K.UUID: (L(UUID=md.UUIDType()), None),
              K.FLOAT16: (L(FLOAT16=md.Float16Type()), None),
              K.DATE: (L(DATE=md.DateType()), C.DATE),
              K.INTERVAL: (None, C.INTERVAL),
              K.LIST: (L(LIST=md.ListType()), C.LIST),
              K.MAP: (L(MAP=md.MapType()), C.MAP),
              K.UNKNOWN: (L(UNKNOWN=md.NullType()), None)}
    if kind == K.NONE:
        return None, None, None
    if kind in simple:
        lt, ct = simple[kind]
        return lt, None if ct is None else int(ct), None
    if kind == K.DECIMAL:
        scale, precision = params.get("scale", 0), params.get("precision", 0)
        return (L(DECIMAL=md.DecimalType(scale=scale, precision=precision)),
                int(C.DECIMAL), {"scale": scale, "precision": precision})
    if kind.startswith(("time_", "timestamp_")):
        family, unit = kind.split("_", 1)
        name, struct = {"millis": ("MILLIS", md.MilliSeconds),
                        "micros": ("MICROS", md.MicroSeconds),
                        "nanos": ("NANOS", md.NanoSeconds)}[unit]
        tu = md.TimeUnit(**{name: struct()})
        utc = params.get("utc", True)
        if family == "time":
            ct = {"millis": C.TIME_MILLIS, "micros": C.TIME_MICROS}.get(unit)
            lt = L(TIME=md.TimeType(isAdjustedToUTC=utc, unit=tu))
        else:
            ct = {"millis": C.TIMESTAMP_MILLIS,
                  "micros": C.TIMESTAMP_MICROS}.get(unit)
            lt = L(TIMESTAMP=md.TimestampType(isAdjustedToUTC=utc, unit=tu))
        return lt, None if ct is None else int(ct), None
    if kind == K.INT:
        bw, signed = params.get("bit_width", 64), params.get("signed", True)
        ct = {(8, True): C.INT_8, (16, True): C.INT_16, (32, True): C.INT_32,
              (64, True): C.INT_64, (8, False): C.UINT_8,
              (16, False): C.UINT_16, (32, False): C.UINT_32,
              (64, False): C.UINT_64}.get((bw, signed))
        return (L(INTEGER=md.IntType(bitWidth=bw, isSigned=signed)),
                None if ct is None else int(ct), None)
    return None, None, None


# ---------------------------------------------------------------------------
# Builders, as the JAX package's
# ---------------------------------------------------------------------------


def leaf(name: str, physical: Type, repetition: Rep = Rep.REQUIRED,
         logical: str = LogicalKind.NONE, type_length=None,
         **params) -> Node:
    """A leaf node; ``params`` are its logical parameters (INT:
    ``bit_width``, ``signed``; DECIMAL: ``precision``, ``scale``; TIME and
    TIMESTAMP: ``utc``)."""
    return Node(name, Rep(repetition), Type(physical), type_length, logical,
                logical_params=params)


def group(name: str, children: List[Node], repetition: Rep = Rep.REQUIRED,
          logical: str = LogicalKind.NONE) -> Node:
    return Node(name, Rep(repetition), logical_kind=logical,
                children=children)


def optional(n: Node) -> Node:
    n.repetition = Rep.OPTIONAL
    return n


def repeated(n: Node) -> Node:
    n.repetition = Rep.REPEATED
    return n


def list_of(name: str, element: Node, repetition: Rep = Rep.OPTIONAL) -> Node:
    """The standard three-level LIST:
    ``<name> (LIST) { repeated group list { element } }``."""
    element.name = "element"
    inner = Node("list", Rep.REPEATED, children=[element])
    return Node(name, Rep(repetition), logical_kind=LogicalKind.LIST,
                children=[inner])


def map_of(name: str, key: Node, value: Node,
           repetition: Rep = Rep.OPTIONAL) -> Node:
    """The standard MAP:
    ``<name> (MAP) { repeated group key_value { required key; value } }``."""
    key.name = "key"
    key.repetition = Rep.REQUIRED
    value.name = "value"
    inner = Node("key_value", Rep.REPEATED, children=[key, value])
    return Node(name, Rep(repetition), logical_kind=LogicalKind.MAP,
                children=[inner])


def message(name: str, children: List[Node]) -> Schema:
    return Schema(Node(name, children=children))
