"""The serving daemon: the programmatic :class:`Server`, multi-tenant QoS
over lookups, scans, aggregates and writes that run on the card (the
whole story in serve/server.py).  The port's single-node
``parquet_tpu/serve``: a ``cluster`` config (a fleet) is refused until the
fleet's slice.
"""

from .config import ClusterSpec, DatasetSpec, ServeConfig, load_config
from .server import Server

__all__ = ["Server", "ServeConfig", "DatasetSpec", "ClusterSpec",
           "load_config"]
