"""The report over the lock checker of ``utils/locks.py`` (the observed
lock-order graph, its cycles with both acquisition stacks, the
blocking-under-lock findings) and the hammer that ``analyze`` runs under
it to show the port's lock graph has no cycle.

The port's copy of ``parquet_tpu/analysis/lockcheck.py``.
``python -m parquet_tpu_torch.analysis.lockcheck [--device cuda|cpu]``
(run by ``python -m parquet_tpu_torch analyze`` in a subprocess with
``PARQUET_TPU_TORCH_LOCKCHECK=1``, so the locks a module builds at import
are checked too) runs a mixed workload on the device (writes, budgeted
parallel reads, scans and lookups, a table's ingest and compaction, a
two-tenant serving daemon and a three-member fleet under concurrent
clients), prints the JSON report, and exits 1 on any finding.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..utils import locks as _locks

__all__ = ["lockcheck_report", "find_cycles", "format_stack",
           "hammer_main"]


def format_stack(stack) -> List[str]:
    """Render a raw (filename, lineno, funcname) frame walk (innermost
    first) as ``file:line in func`` lines, source looked up lazily."""
    import linecache

    out = []
    for filename, lineno, func in stack:
        line = linecache.getline(filename, lineno).strip()
        loc = f"{filename}:{lineno} in {func}"
        out.append(f"{loc}\n    {line}" if line else loc)
    return out


def find_cycles(edges) -> List[List[str]]:
    """Elementary cycles in the lock-order graph (names), smallest
    first.  The graph is lock-class-sized; simple DFS per node with a
    canonical-rotation dedup is plenty."""
    adj: Dict[str, list] = {}
    for e in edges:
        adj.setdefault(e["from"], []).append(e["to"])
    seen = set()
    cycles: List[List[str]] = []
    for start in sorted(adj):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    # canonical rotation: start at the min node
                    i = path.index(min(path))
                    canon = tuple(path[i:] + path[:i])
                    if canon not in seen:
                        seen.add(canon)
                        cycles.append(list(canon))
                elif nxt not in path and nxt > start:
                    # only explore nodes > start: each cycle is found
                    # exactly once, from its smallest member
                    stack.append((nxt, path + [nxt]))
    cycles.sort(key=len)
    return cycles


def _format_finding(f: dict) -> dict:
    out = {k: v for k, v in f.items() if not k.startswith("_")}
    for key in ("stack", "first_stack"):
        if key in out:
            out[key] = format_stack(out[key])
    if "edges" in out:
        out["edges"] = [dict(e, from_stack=format_stack(e["from_stack"]),
                             to_stack=format_stack(e["to_stack"]))
                        for e in out["edges"]]
    return out


def lockcheck_report() -> dict:
    """The full sanitizer report: every observed edge (with both
    acquisition stacks formatted), the cycle set recomputed over the
    final graph, and every finding.  ``ok`` is True iff no findings and
    no cycles."""
    snap = _locks.lockcheck_state().snapshot()
    edges = [dict(e, from_stack=format_stack(e["from_stack"]),
                  to_stack=format_stack(e["to_stack"]))
             for e in snap["edges"]]
    cycles = find_cycles(snap["edges"])
    findings = [_format_finding(f) for f in snap["findings"]]
    return {
        "enabled": _locks.LOCKCHECK_ENABLED,
        "acquisitions": snap["acquisitions"],
        "locks": sorted({e["from"] for e in snap["edges"]}
                        | {e["to"] for e in snap["edges"]}),
        "edges": sorted(edges, key=lambda e: (e["from"], e["to"])),
        "cycles": cycles,
        "findings": findings,
        "ok": not findings and not cycles,
    }


HAMMER_ROWS = 20_000


def _post(url: str, doc: dict, tenant: str) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"X-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _run_clients(n: int, client, meanwhile=None) -> None:
    """``client(i)`` for ``i < n`` on threads of their own, and
    ``meanwhile()`` on this thread as they run; all joined, then the first
    error raises."""
    import threading

    errors: list = []

    def run(i: int) -> None:
        try:
            client(i)
        # ptlint: disable=PT005 -- not swallowed: collected into the
        # errors list and raised after the join below
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"pqt-hammer-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        for t in threads:
            t.join(60)
    if errors:
        raise errors[0]


def _hammer_workload(tmpdir: str, device: str) -> None:
    """A mixed, concurrent workload on ``device`` over every family of
    locks: the writer, the footer, chunk and page caches, the prefetch
    ring, the admission gate (budgeted), the ledger, the meters, the op
    scopes, batched lookups (sharded ones among them), a table's ingest
    and compaction, and the serving
    daemon and a fleet under concurrent clients (lookup, scan, aggregate,
    write and compaction through the HTTP handler threads)."""
    import os

    import numpy as np
    import pyarrow as pa

    import parquet_tpu_torch as pq
    from parquet_tpu_torch.utils.pool import map_in_order

    path = os.path.join(tmpdir, "hammer.parquet")
    rng = np.random.default_rng(7)
    tab = pa.table({"k": np.arange(HAMMER_ROWS, dtype=np.int64),
                    "v": rng.integers(0, 1 << 30, HAMMER_ROWS)
                    .astype(np.int64)})
    opts = pq.WriterOptions(row_group_size=2_000)
    pq.write_table(tab, path, options=opts)

    os.environ["PARQUET_TPU_TORCH_READ_BUDGET"] = str(4 << 20)
    os.environ["PARQUET_TPU_TORCH_PREFETCH"] = "ring"
    try:
        def one(i: int):
            pf = pq.ParquetFile(path)
            try:
                if i % 3 == 0:
                    pf.read(device=device)
                elif i % 3 == 1:
                    pq.scan_expr(pf, pq.col("v") >= (1 << 29),
                                 device=device)
                else:
                    keys = np.arange(i * 7, i * 7 + 64, dtype=np.int64)
                    pq.find_rows(pf, "k", keys, columns=["v"],
                                 device=device)
            finally:
                pf.close()
            return None

        map_in_order(one, range(12))

        # a sharded lookup (its shards' shared page fetchers) and the
        # whole-chunk cache (a file without a page index), twice each: a
        # cold run and a warm one, from the calling thread (a pool worker
        # does not shard)
        bare = os.path.join(tmpdir, "hammer-no-index.parquet")
        pq.write_table(tab, bare, options=pq.WriterOptions(
            row_group_size=2_000, write_page_index=False))
        os.environ["PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD"] = "16"
        keys = np.arange(0, HAMMER_ROWS, 7, dtype=np.int64)[:512]
        for p in (path, bare) * 2:
            with pq.ParquetFile(p) as pf:
                pq.find_rows(pf, "k", keys, columns=["v"], device=device)
        os.environ.pop("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD")

        tdir = os.path.join(tmpdir, "table")
        w = pq.DatasetWriter(tdir, pq.schema_from_arrow(tab.schema),
                             sorting=[pq.SortingColumn("k")],
                             options=opts, rows_per_file=5_000)
        try:
            w.write_arrow(tab)
            w.commit()
        finally:
            w.close()
        pq.compact_table(tdir, device=device)
        ds = pq.open_table(tdir)
        try:
            ds.read(device=device)
        finally:
            ds.close()
        _serve_hammer(path, tdir, device)
        _fleet_hammer(path, tdir, device)
    finally:
        os.environ.pop("PARQUET_TPU_TORCH_READ_BUDGET", None)
        os.environ.pop("PARQUET_TPU_TORCH_PREFETCH", None)
        os.environ.pop("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", None)


def _serve_hammer(file_path: str, table_dir: str, device: str) -> None:
    """The daemon in this process with two tenants, under a mixed
    lookup, scan, aggregate and write load from concurrent clients while
    a compaction runs, then drained: the handler threads, pool workers,
    the QoS gate and the pins must keep the lock graph free of cycles."""
    import parquet_tpu_torch as pq

    cfg = {"datasets": {"events": {"paths": [file_path]},
                        "tbl": {"table": table_dir, "writable": True,
                                "sorting": "k"}},
           "tenants": {"online": {"class": "latency", "weight": 2.0,
                                  "budget_bytes": 4 << 20,
                                  "pin_bytes": 1 << 20},
                       "batch": {"class": "bulk",
                                 "budget_bytes": 2 << 20}}}

    with pq.Server(cfg, port=0, device=device) as srv:
        u = srv.url

        def client(i: int) -> None:
            if i % 4 == 0:
                _post(u + "/v1/lookup",
                      {"dataset": "events", "column": "k",
                       "keys": list(range(i * 5, i * 5 + 32)),
                       "columns": ["v"]}, "online")
            elif i % 4 == 1:
                _post(u + "/v1/scan",
                      {"dataset": "events",
                       "where": {"col": "v", "ge": 1 << 29}}, "batch")
            elif i % 4 == 2:
                _post(u + "/v1/aggregate",
                      {"dataset": "events", "aggs": ["count", "avg:v"]},
                      "online")
            else:
                _post(u + "/v1/write",
                      {"dataset": "tbl",
                       "rows": {"k": [100_000 + i], "v": [i]}}, "batch")

        # a compaction racing the serving traffic
        _run_clients(8, client, meanwhile=lambda: pq.compact_table(
            table_dir, device=device))


def _fleet_hammer(file_path: str, table_dir: str, device: str) -> None:
    """Three fleet members in this process (one tenant table, ephemeral
    ports set with ``set_peers``) under scatter-gather scans and
    aggregates, routed lookups and writes to one table from every member:
    the commit arbitration (``manifest.arbiter``, the peer transport,
    ``serve.fleet``) racing the gathers must keep the lock graph free of
    cycles."""
    import parquet_tpu_torch as pq

    names = ["n1", "n2", "n3"]
    base = {"datasets": {"events": {"paths": [file_path]},
                         "tbl": {"table": table_dir, "writable": True,
                                 "sorting": "k"}},
            "tenants": {"online": {"class": "latency", "weight": 2.0,
                                   "budget_bytes": 4 << 20},
                        "batch": {"class": "bulk",
                                  "budget_bytes": 2 << 20}}}
    servers = []
    try:
        for name in names:
            cfg = dict(base, cluster={"self": name,
                                      "peers": {n: None for n in names}})
            servers.append(pq.Server(cfg, port=0, device=device))
        urls = {n: s.url for n, s in zip(names, servers)}
        for s in servers:
            s.set_peers(urls)

        def client(i: int) -> None:
            u = servers[i % 3].url
            if i % 4 == 0:
                _post(u + "/v1/scan",
                      {"dataset": "tbl",
                       "where": {"col": "v", "ge": 1 << 29}}, "batch")
            elif i % 4 == 1:
                _post(u + "/v1/aggregate",
                      {"dataset": "tbl", "aggs": ["count", "avg:v"]},
                      "online")
            elif i % 4 == 2:
                _post(u + "/v1/lookup",
                      {"dataset": "tbl", "column": "k",
                       "keys": list(range(i * 5, i * 5 + 32)),
                       "columns": ["v"]}, "online")
            else:
                _post(u + "/v1/write",
                      {"dataset": "tbl",
                       "rows": {"k": [200_000 + i], "v": [i]}}, "batch")

        _run_clients(9, client)
    finally:
        for s in reversed(servers):
            s.close()


def hammer_main(argv: Optional[list] = None) -> int:
    """``python -m parquet_tpu_torch.analysis.lockcheck [--device D]``:
    the hammer under whatever lock-checker state the environment set
    (``analyze`` runs it with ``PARQUET_TPU_TORCH_LOCKCHECK=1``), its
    JSON report printed as the last line; 1 on a finding or a cycle."""
    import tempfile

    ap = argparse.ArgumentParser(
        prog="python -m parquet_tpu_torch.analysis.lockcheck")
    ap.add_argument("--device", default="cuda",
                    help="where the hammer's reads, scans, lookups, "
                         "aggregates and servers run (default cuda)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="pqt_lockcheck_") as td:
        _hammer_workload(td, args.device)
    rep = lockcheck_report()
    json.dump(rep, sys.stdout, sort_keys=True)
    sys.stdout.write("\n")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(hammer_main(sys.argv[1:]))
