"""The serving daemon's configuration: the datasets it hosts, the tenants
that may query them, and each tenant's QoS contract.

The port's copy of ``parquet_tpu/serve/config.py``.  One JSON document
(or the same dict, or a :class:`ServeConfig`, handed to
:class:`~parquet_tpu_torch.serve.Server`)::

    {
      "host": "127.0.0.1",
      "port": 8818,
      "datasets": {
        "events":  {"paths": ["/data/events/*.parquet"]},
        "users":   {"table": "/data/users", "writable": true}
      },
      "tenants": {
        "online":  {"class": "latency", "weight": 2.0,
                    "budget_bytes": "64MiB", "pin_bytes": "8MiB"},
        "batch":   {"class": "bulk", "budget_bytes": "32MiB"}
      }
    }

- ``datasets``: name -> ``paths`` (files and globs served as a read-only
  :class:`~parquet_tpu_torch.dataset.Dataset`) or ``table`` (a
  ``DatasetWriter`` table directory, opened at its snapshot;
  ``writable: true`` also takes ``/v1/write`` ingest, one manifest commit
  a request).
- ``tenants``: name -> QoS contract: the priority ``class`` (``latency``
  | ``default`` | ``bulk``), the weighted-fair ``weight``, the tenant's
  own ``budget_bytes`` at the admission gate, ``pin_bytes`` of pinned
  pages, a bearer ``token``, and a request rate (``qps``, ``burst``).  A
  request names its tenant in the ``X-Tenant`` header; an unknown tenant
  runs as ``default``.
- ``cluster`` (a fleet's membership) parses and validates here; the
  port's server refuses it until the fleet's slice.

Byte sizes take ints or suffixed strings (``"64MiB"``, ``"1GB"``).  The
three knob-backed settings (:func:`drain_timeout_s`,
:func:`shed_retry_after_s`, :func:`max_body_bytes`) read their
``PARQUET_TPU_TORCH_SERVE_*`` knobs at each call.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.env import env_bytes, env_float
from ..utils.pool import TenantSpec

__all__ = ["DatasetSpec", "ServeConfig", "ClusterSpec", "load_config",
           "parse_bytes", "drain_timeout_s", "shed_retry_after_s",
           "max_body_bytes"]

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgt]?i?b?)\s*$", re.I)
_MULT = {"": 1, "b": 1,
         "k": 1000, "kb": 1000, "ki": 1024, "kib": 1024,
         "m": 1000 ** 2, "mb": 1000 ** 2, "mi": 1 << 20, "mib": 1 << 20,
         "g": 1000 ** 3, "gb": 1000 ** 3, "gi": 1 << 30, "gib": 1 << 30,
         "t": 1000 ** 4, "tb": 1000 ** 4, "ti": 1 << 40, "tib": 1 << 40}


def parse_bytes(v) -> Optional[int]:
    """``64 << 20`` from ``"64MiB"`` / ``"64MB"`` / ``67108864``; None
    stays None."""
    if v is None:
        return None
    if isinstance(v, bool):
        raise ValueError(f"byte size must be a number or string, got {v!r}")
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v))
    if not m:
        raise ValueError(f"unparseable byte size {v!r}")
    return int(float(m.group(1)) * _MULT[m.group(2).lower()])


def drain_timeout_s() -> float:
    """``PARQUET_TPU_TORCH_SERVE_DRAIN_S``: the seconds a graceful close
    waits for the requests in flight (10 by default)."""
    return env_float("PARQUET_TPU_TORCH_SERVE_DRAIN_S")


def shed_retry_after_s() -> float:
    """``PARQUET_TPU_TORCH_SERVE_RETRY_AFTER_S``: the ``Retry-After`` of a
    shed 429 (1.0 by default)."""
    return env_float("PARQUET_TPU_TORCH_SERVE_RETRY_AFTER_S")


def max_body_bytes() -> int:
    """``PARQUET_TPU_TORCH_SERVE_MAX_BODY``: the cap on a request body (64
    MiB by default; a longer body is refused 413 before it is read)."""
    return env_bytes("PARQUET_TPU_TORCH_SERVE_MAX_BODY")


@dataclass
class DatasetSpec:
    """One hosted dataset: ``paths`` (a read-only file set) or ``table``
    (a table directory opened at its snapshot; ``writable`` takes
    ``/v1/write``), exactly one of the two."""

    name: str
    paths: Optional[List[str]] = None
    table: Optional[str] = None
    writable: bool = False
    sorting: Optional[str] = None  # the sort key of /v1/write's parts
    rows_per_file: int = 100_000

    def __post_init__(self):
        if (self.paths is None) == (self.table is None):
            raise ValueError(f"dataset {self.name!r} needs exactly one "
                             "of 'paths' or 'table'")
        if self.writable and self.table is None:
            raise ValueError(f"dataset {self.name!r}: only table-backed "
                             "datasets are writable")


@dataclass
class ClusterSpec:
    """A fleet's membership: ``self_name`` (this daemon's entry in
    ``peers``) and ``peers`` (name -> base URL; None is a placeholder set
    after an ephemeral-port boot)."""

    self_name: str
    peers: Dict[str, Optional[str]] = field(default_factory=dict)

    def __post_init__(self):
        if self.self_name not in self.peers:
            raise ValueError(f"cluster 'self' {self.self_name!r} is not "
                             f"in peers {sorted(self.peers)}")
        if len(self.peers) < 1:
            raise ValueError("cluster needs at least one peer")

    @classmethod
    def from_dict(cls, doc: dict) -> "ClusterSpec":
        if not isinstance(doc, dict):
            raise ValueError("'cluster' must be an object")
        bad = set(doc) - {"self", "peers"}
        if bad:
            raise ValueError(f"cluster: unknown keys {sorted(bad)} "
                             f"(self, peers)")
        peers = doc.get("peers")
        if not isinstance(peers, dict) or not peers:
            raise ValueError("cluster 'peers' must be a non-empty "
                             "object of name -> base URL")
        for name, url in peers.items():
            if url is not None and not isinstance(url, str):
                raise ValueError(f"cluster peer {name!r}: URL must be a "
                                 f"string or null, got {url!r}")
        return cls(self_name=str(doc.get("self", "")),
                   peers={str(n): (u or None) for n, u in peers.items()})


# endpoint -> the class of a tenant without a contract: lookups and
# aggregates are the latency-sensitive surface, scans and writes the bulk
DEFAULT_ENDPOINT_CLASS = {"lookup": "latency", "aggregate": "latency",
                          "scan": "bulk", "write": "bulk"}

_TENANT_KEYS = ("class", "weight", "budget_bytes", "pin_bytes", "token",
                "qps", "burst")


@dataclass
class ServeConfig:
    """The parsed configuration (the module docstring)."""

    host: str = "127.0.0.1"
    port: int = 8818
    datasets: Dict[str, DatasetSpec] = field(default_factory=dict)
    tenants: Dict[str, TenantSpec] = field(default_factory=dict)
    pin_bytes: Dict[str, int] = field(default_factory=dict)
    tokens: Dict[str, str] = field(default_factory=dict)
    compact_interval_s: Optional[float] = None
    cluster: Optional[ClusterSpec] = None

    @classmethod
    def from_dict(cls, doc: dict) -> "ServeConfig":
        if not isinstance(doc, dict):
            raise ValueError("serve config must be a JSON object")
        unknown = set(doc) - {"host", "port", "datasets", "tenants",
                              "compact_interval_s", "cluster"}
        if unknown:
            raise ValueError(f"unknown serve config keys: "
                             f"{sorted(unknown)}")
        datasets: Dict[str, DatasetSpec] = {}
        for name, d in (doc.get("datasets") or {}).items():
            if not isinstance(d, dict):
                raise ValueError(f"dataset {name!r} must be an object")
            bad = set(d) - {"paths", "table", "writable", "sorting",
                            "rows_per_file"}
            if bad:
                raise ValueError(f"dataset {name!r}: unknown keys "
                                 f"{sorted(bad)}")
            paths = d.get("paths")
            if isinstance(paths, str):
                paths = [paths]
            datasets[name] = DatasetSpec(
                name=name, paths=paths, table=d.get("table"),
                writable=bool(d.get("writable", False)),
                sorting=d.get("sorting"),
                rows_per_file=int(d.get("rows_per_file", 100_000)))
        tenants: Dict[str, TenantSpec] = {}
        pins: Dict[str, int] = {}
        tokens: Dict[str, str] = {}
        for name, t in (doc.get("tenants") or {}).items():
            if not isinstance(t, dict):
                raise ValueError(f"tenant {name!r} must be an object")
            bad = set(t) - set(_TENANT_KEYS)
            if bad:
                # a mistyped key must not drop a contract in silence
                raise ValueError(f"tenant {name!r}: unknown keys "
                                 f"{sorted(bad)} ({', '.join(_TENANT_KEYS)})")
            klass = t.get("class", "default")
            if klass not in ("latency", "default", "bulk"):
                raise ValueError(f"tenant {name!r}: unknown class "
                                 f"{klass!r} (latency|default|bulk)")
            qps = t.get("qps")
            burst = t.get("burst")
            tenants[name] = TenantSpec(
                name=name,
                budget_bytes=parse_bytes(t.get("budget_bytes")),
                weight=float(t.get("weight", 1.0)),
                klass=klass,
                qps=float(qps) if qps is not None else None,
                burst=float(burst) if burst is not None else None)
            pin = parse_bytes(t.get("pin_bytes"))
            if pin:
                pins[name] = pin
            tok = t.get("token")
            if tok is not None:
                if not isinstance(tok, str) or not tok:
                    raise ValueError(f"tenant {name!r}: token must be a "
                                     f"non-empty string")
                tokens[name] = tok
        if not datasets:
            raise ValueError("serve config hosts no datasets")
        ci = doc.get("compact_interval_s")
        cluster = doc.get("cluster")
        return cls(host=str(doc.get("host", "127.0.0.1")),
                   port=int(doc.get("port", 8818)),
                   datasets=datasets, tenants=tenants, pin_bytes=pins,
                   tokens=tokens,
                   compact_interval_s=float(ci) if ci else None,
                   cluster=(ClusterSpec.from_dict(cluster)
                            if cluster is not None else None))

    def tenant(self, name: str) -> Optional[TenantSpec]:
        return self.tenants.get(name)

    def klass_for(self, tenant: Optional[str], endpoint: str) -> str:
        """The class a request runs as: its tenant's where the tenant has
        a contract, else its endpoint's (lookup and aggregate latency,
        scan and write bulk)."""
        spec = self.tenants.get(tenant) if tenant else None
        if spec is not None:
            return spec.klass
        return DEFAULT_ENDPOINT_CLASS.get(endpoint, "default")


def load_config(path: str) -> ServeConfig:
    """A ``serve.json`` parsed into a :class:`ServeConfig`; a malformed
    document raises a one-line ``ValueError``."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as e:
            raise ValueError(f"{path}: not valid JSON ({e})") from e
    return ServeConfig.from_dict(doc)
