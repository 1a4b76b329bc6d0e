"""The encoding registry: every page encoding is looked up by its id.

The port of ``parquet_tpu/ops/encodings.py``.  The host decode
(``io/reader.py::decode_chunk_host``) dispatches every data page's values
through :func:`lookup`; the built-in encodings register themselves when
``io/reader.py`` is imported, and :func:`register_encoding` adds an
encoding or, with ``overwrite=True``, shadows a built-in one.

A ``decode`` callable takes ``(raw, pos, nvals, leaf, physical,
dictionary)``: the page's uncompressed bytes (uint8 numpy), the offset of
its values, how many values to produce, the schema leaf, the physical
type and the chunk's decoded dictionary (or None).  It returns a typed
numpy array, a ``(values, offsets)`` pair for byte arrays, or
:class:`DictIndices` for a dictionary index stream.

An encoding may also carry ``decode_masked``, the masked-emit twin the
fused page cursor (``io/fused.py``) calls: the same arguments with
``take``, a sorted int64 array of the value ordinals to emit, after
``nvals``.  It returns only those values (in the forms above), or None
where the page cannot be decoded so (the caller decodes it whole).

The device route plans only the built-in encodings: a chunk with a page
whose encoding is shadowed (:func:`is_builtin_decode` false) takes the
host decode, counted in ``parallel/device_reader.py::HOST_ROUTE``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["EncodingSpec", "DictIndices", "register_encoding", "lookup",
           "is_builtin_decode", "registered_encodings"]


class DictIndices:
    """A decode's result that holds dictionary indexes, not values."""

    __slots__ = ("indices",)

    def __init__(self, indices):
        self.indices = indices


@dataclass(frozen=True)
class EncodingSpec:
    """One registered encoding: its wire id, a name for messages, the
    ``decode`` callable and, optionally, its masked-emit ``decode_masked``
    twin (the module docstring gives both signatures)."""

    id: int
    name: str
    decode: Callable[..., Any]
    decode_masked: Optional[Callable[..., Any]] = None


_REGISTRY: Dict[int, EncodingSpec] = {}
_BUILTIN: Dict[int, EncodingSpec] = {}


def register_encoding(spec: EncodingSpec, overwrite: bool = False,
                      _builtin: bool = False) -> None:
    """Add an encoding to the decode dispatch; ``overwrite=True`` replaces
    one already registered (a built-in one too)."""
    key = int(spec.id)
    if not overwrite and key in _REGISTRY:
        raise ValueError(
            f"encoding id {key} ({_REGISTRY[key].name}) is already "
            "registered; pass overwrite=True to replace it")
    _REGISTRY[key] = spec
    if _builtin:
        _BUILTIN[key] = spec


def is_builtin_decode(encoding_id) -> bool:
    """True where the active decode of this id is the built-in one (an id
    no one registered counts as built-in: its pages fail on both
    routes alike)."""
    key = int(encoding_id)
    return _REGISTRY.get(key) is _BUILTIN.get(key)


def any_shadowed() -> bool:
    """True where some registered decode is not the built-in one of its
    id: the device planner checks pages only then."""
    return any(spec is not _BUILTIN.get(key)
               for key, spec in _REGISTRY.items())


def lookup(encoding_id) -> Optional[EncodingSpec]:
    return _REGISTRY.get(int(encoding_id))


def registered_encodings() -> Dict[int, str]:
    """``{id: name}`` of every registered encoding, built-ins included."""
    return {k: v.name for k, v in sorted(_REGISTRY.items())}
