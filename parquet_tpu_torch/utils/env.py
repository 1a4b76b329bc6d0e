"""The port's environment knobs, read through one accessor.

The port's copy of ``parquet_tpu/utils/env.py``: every knob is declared
once, with its name (``PARQUET_TPU_TORCH_*``), type, default and what it
does, by :func:`declare` in ``parquet_tpu_torch/analysis/knobs.py`` (pure
data, loaded at the first accessor call, so this module stays cheap for
the lowest layers: locks, metrics, sources).  Each knob is read at each
call through the accessor of its type, so a test can set one with
``monkeypatch.setenv``:

- ``bool`` (:func:`env_bool`): unset or empty is the default;
  ``0``/``off``/``false``/``no`` (any case) is off; anything else on.
- ``int`` / ``float`` (:func:`env_int`, :func:`env_float`): unset, empty
  or a value that does not parse is the default.
- ``bytes`` (:func:`env_bytes`): as ``int``, and at least 0.
- ``opt_int`` / ``opt_float`` / ``opt_bytes`` (:func:`env_opt_int`,
  :func:`env_opt_float`, :func:`env_opt_bytes`): unset, empty or a value
  that does not parse is None (no pin), so a site tells "pinned to 0"
  from "not set".
- ``str`` (:func:`env_str`): unset is the default, else the stripped
  value.

An accessor refuses an undeclared ``PARQUET_TPU_*`` name (``KeyError``:
the port declares only ``PARQUET_TPU_TORCH_*`` knobs, so the name of one
of the JAX package's raises too) and a knob declared with another type
(``TypeError``); a name outside that prefix reads undeclared (a test's
scratch variable).
The linter's rule PT002 (``analysis/lint.py``) holds every literal call
to the same table.  :func:`knobs_markdown` renders the README's table of
the port's knobs (``python -m parquet_tpu_torch analyze --knobs-md``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

__all__ = ["Knob", "declare", "knobs", "knob", "knobs_markdown",
           "env_str", "env_bool", "env_int", "env_float", "env_bytes",
           "env_opt_int", "env_opt_float", "env_opt_bytes"]

#: a name with this prefix must be declared to be read
PREFIX = "PARQUET_TPU_"

_FALSEY = ("0", "off", "false", "no")

#: accessor name -> the knob types it reads (rule PT002 checks literal
#: calls against it)
ACCESSOR_TYPES = {
    "env_str": ("str",),
    "env_bool": ("bool",),
    "env_int": ("int",),
    "env_float": ("float",),
    "env_bytes": ("bytes",),
    "env_opt_int": ("opt_int",),
    "env_opt_float": ("opt_float",),
    "env_opt_bytes": ("opt_bytes",),
}

_VALID_TYPES = frozenset(t for types in ACCESSOR_TYPES.values()
                         for t in types)


class Knob:
    """One declared knob: ``name`` (the variable), ``type`` (one of the
    accessor types), ``default`` (what an unset or unparsable value reads
    as; None for the ``opt_*`` types) and ``doc`` (one line of the README
    table)."""

    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type: str, default, doc: str):
        if type not in _VALID_TYPES:
            raise ValueError(f"knob {name}: unknown type {type!r}")
        if not doc:
            raise ValueError(f"knob {name}: doc is required")
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc

    def __repr__(self) -> str:
        return (f"Knob({self.name!r}, {self.type!r}, "
                f"default={self.default!r})")


_KNOBS: "Dict[str, Knob]" = {}
_LOADED = False


def declare(name: str, type: str, default, doc: str) -> Knob:
    """Register one knob (``analysis/knobs.py`` calls it as it loads); a
    second declaration of a name raises."""
    if name in _KNOBS:
        raise ValueError(f"knob {name} declared twice")
    k = Knob(name, type, default, doc)
    _KNOBS[name] = k
    return k


def _ensure_loaded() -> None:
    global _LOADED
    if not _LOADED:
        _LOADED = True
        from ..analysis import knobs as _knobs  # noqa: F401


def knobs() -> "Tuple[Knob, ...]":
    """Every declared knob, sorted by name (the README table's order)."""
    _ensure_loaded()
    return tuple(_KNOBS[n] for n in sorted(_KNOBS))


def knob(name: str) -> Optional[Knob]:
    """The declaration of ``name``, or None."""
    _ensure_loaded()
    return _KNOBS.get(name)


def _resolve(name: str, want: str):
    """The declared default of ``name`` once its type matches the
    accessor ``want``; None for an undeclared name outside the prefix."""
    k = knob(name)
    if k is None:
        if name.startswith(PREFIX):
            raise KeyError(
                f"{name} is not a declared knob of parquet_tpu_torch: "
                f"declare it in parquet_tpu_torch/analysis/knobs.py")
        return None
    if k.type not in ACCESSOR_TYPES.get(want, ()):
        raise TypeError(f"knob {name} is declared {k.type!r}: read it "
                        f"with its own accessor, not {want}")
    return k.default


def _raw(name: str) -> str:
    return os.environ.get(name, "").strip()


def env_str(name: str) -> str:
    """The knob's stripped value, or its default when unset or empty."""
    default = _resolve(name, "env_str")
    v = _raw(name)
    return v if v else (default or "")


def env_bool(name: str) -> bool:
    """The knob as a switch: off where its value is one of
    ``0``/``off``/``false``/``no`` (any case), its default where unset."""
    default = _resolve(name, "env_bool")
    v = _raw(name)
    if not v:
        return bool(default)
    return v.lower() not in _FALSEY


def env_int(name: str) -> int:
    """The knob as an int (its default where it does not parse)."""
    default = _resolve(name, "env_int")
    v = _raw(name)
    if v:
        try:
            return int(v)
        except ValueError:
            pass
    return int(default or 0)


def env_float(name: str) -> float:
    """The knob as a float (its default where it does not parse)."""
    default = _resolve(name, "env_float")
    v = _raw(name)
    if v:
        try:
            return float(v)
        except ValueError:
            pass
    return float(default or 0.0)


def env_bytes(name: str) -> int:
    """The knob as a byte count, at least 0 (its default where it does
    not parse)."""
    default = _resolve(name, "env_bytes")
    v = _raw(name)
    if v:
        try:
            return max(0, int(v))
        except ValueError:
            pass
    return int(default or 0)


def _opt(name: str, want: str, parse):
    _resolve(name, want)
    v = _raw(name)
    if not v:
        return None
    try:
        return parse(v)
    except ValueError:
        return None


def env_opt_int(name: str) -> Optional[int]:
    """The knob as an int, or None where it is unset or does not parse."""
    return _opt(name, "env_opt_int", int)


def env_opt_float(name: str) -> Optional[float]:
    """The knob as a float, or None where it is unset or does not parse."""
    return _opt(name, "env_opt_float", float)


def env_opt_bytes(name: str) -> Optional[int]:
    """The knob as a byte count at least 0, or None where it is unset or
    does not parse."""
    return _opt(name, "env_opt_bytes", lambda v: max(0, int(v)))


def _default_md(k: Knob) -> str:
    if k.default is None or k.default == "":
        return "unset"
    if k.type == "bool":
        return "on" if k.default else "off"
    if k.type in ("bytes", "opt_bytes") and isinstance(k.default, int) \
            and k.default and k.default % (1 << 20) == 0:
        return f"{k.default >> 20} MiB"
    return str(k.default)


def knobs_markdown() -> str:
    """The README table of the port's knobs, generated from the registry
    (``python -m parquet_tpu_torch analyze --knobs-md``); ``analyze`` and
    a test hold the committed table to it."""
    lines = ["| Knob | Type | Default | What it does |",
             "| --- | --- | --- | --- |"]
    for k in knobs():
        doc = k.doc.replace("|", "\\|")  # a literal pipe breaks the table
        lines.append(f"| `{k.name}` | {k.type} | {_default_md(k)} "
                     f"| {doc} |")
    return "\n".join(lines) + "\n"
