"""The serving daemon: the programmatic :class:`Server`, multi-tenant QoS
over lookups, scans, aggregates and writes that run on the card (the
whole story in serve/server.py).  A ``cluster`` config makes N daemons
one shard-aware fleet (consistent-hash routing, scatter-gather, commit
arbitration; serve/cluster.py).
"""

from .cluster import FleetRouter, HashRing, shard_key, splitmix64
from .config import ClusterSpec, DatasetSpec, ServeConfig, load_config
from .server import Server

__all__ = ["Server", "ServeConfig", "DatasetSpec", "ClusterSpec",
           "load_config", "FleetRouter", "HashRing", "shard_key",
           "splitmix64"]
