"""The port's environment knobs, read through one accessor.

The port's cut of ``parquet_tpu/utils/env.py``: every knob is declared in
:data:`KNOBS` with its default and what it does, named
``PARQUET_TPU_TORCH_*``, and read through :func:`env_str`, which refuses
an undeclared name.  Knobs are read at each call, so a test can set one
with ``monkeypatch.setenv``.
"""

from __future__ import annotations

import os

__all__ = ["KNOBS", "env_str"]

#: name -> (default, what it does)
KNOBS = {
    "PARQUET_TPU_TORCH_ROUTE": (
        "", "pins the routed scan's route: host|cpu the host scan, "
        "device|cuda the device scan (a shape the device scan refuses "
        "still takes the host scan); anything else leaves the cost model "
        "to choose (io/planner.py::route_scan)"),
}


def env_str(name: str) -> str:
    """The knob's value, or its default when unset or empty."""
    if name not in KNOBS:
        raise KeyError(f"{name} is not a declared knob of parquet_tpu_torch")
    return os.environ.get(name) or KNOBS[name][0]
