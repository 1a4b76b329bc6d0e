"""The command line: ``python -m parquet_tpu_torch COMMAND``.

The port's copy of ``parquet_tpu/__main__.py``, with its nine commands,
flags and exit codes:

- ``meta``, ``schema``, ``pages``: a file's footer, schema tree and one
  chunk's pages as text (``utils/printer.py``); they decode nothing.
- ``head``: the first ``-n`` rows as JSON lines, decoded on ``--device``.
- ``verify``: the integrity walk of ``io/integrity.py`` over paths and
  globs, in parallel on the shared pool; ``--decode`` also decodes every
  chunk on ``--device``.  Exit 0 only where every file is clean.
- ``stats``: the process's meters as text, ``--json``, ``--prom`` or
  ``--debugz`` (``--serve PORT`` serves them); given files, each is read
  on ``--device`` first, so the meters show that work.
- ``aggregate``: ``--agg`` specs over files (``io/aggregate.py``), with
  ``--where COL:LO:HI`` and ``--group-by``, decoded on ``--device``.
- ``serve``: the serving daemon (``serve/``) on ``--device`` until
  SIGTERM or SIGINT, then a drain; exit 0 where it drained.
- ``analyze``: the linter (``analysis/lint.py``), the README table of the
  port's knobs against the registry, and the lock checker's hammer in a
  subprocess under ``PARQUET_TPU_TORCH_LOCKCHECK=1`` on ``--device``;
  exit 0 only where all three are clean.

``--device`` is ``cuda`` unless the caller names ``cpu``: a command that
decodes never falls back to the CPU when no card is found, it fails.
"""

import argparse
import sys

PROG = "parquet_tpu_torch"
HAMMER_TIMEOUT_S = 600
README_BEGIN = "<!-- torch-knobs:begin -->"
README_END = "<!-- torch-knobs:end -->"


def _fail(msg) -> int:
    msg = str(msg)
    print(msg if msg.startswith(f"{PROG}:") else f"{PROG}: {msg}",
          file=sys.stderr)
    return 1


def _device(args):
    """The ``--device`` a decoding command runs on, or None (after the
    error is printed) where it cannot: CUDA without a card raises."""
    from .io.reader import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        _fail(e)
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog=PROG)
    p.add_argument("command",
                   choices=["meta", "schema", "pages", "head", "verify",
                            "stats", "analyze", "aggregate", "serve"],
                   help="meta: file summary; schema: schema tree; pages: "
                        "page-level dump; head: first rows as JSON lines; "
                        "verify: end-to-end integrity check (exit 0 = every "
                        "file clean, 1 = any corrupt); stats: dump the "
                        "process-wide metrics registry (reads any given "
                        "files first so the counters meter that work); "
                        "analyze: invariant lint, the knob table and the "
                        "lock checker's hammer over the package (exit 0 = "
                        "clean, 1 = findings); aggregate: answer "
                        "COUNT/MIN/MAX/SUM/AVG/VAR/DISTINCT/top-k from "
                        "metadata without decoding where provable "
                        "(io/aggregate.py); serve: run the long-lived "
                        "serving daemon (parquet_tpu_torch/serve) hosting "
                        "configured datasets behind /v1/lookup|scan|"
                        "aggregate|write + /metrics /healthz /debugz "
                        "with multi-tenant QoS")
    p.add_argument("file", nargs="*",
                   help="parquet file path(s); verify accepts several and "
                        "shell-style globs, checked in parallel; stats "
                        "accepts zero or more (globs ok) to read first")
    p.add_argument("--device", default="cuda",
                   help="head, verify --decode, stats FILE, aggregate, "
                        "serve and analyze's hammer: where to decode "
                        "(cuda, the default, or cpu)")
    p.add_argument("--row-group", type=int, default=0,
                   help="pages: which row group")
    p.add_argument("--column", type=int, default=0,
                   help="pages: which leaf column (schema order)")
    p.add_argument("-n", type=int, default=10, help="head: rows to print")
    p.add_argument("--decode", action="store_true",
                   help="verify: additionally decode every column chunk "
                        "(slowest, strongest check)")
    p.add_argument("--json", action="store_true",
                   help="verify: emit one IntegrityReport JSON per line; "
                        "stats: emit the metrics_snapshot() dict as JSON")
    p.add_argument("--prom", action="store_true",
                   help="stats: emit Prometheus exposition text format")
    p.add_argument("--debugz", action="store_true",
                   help="stats: emit the live /debugz introspection JSON "
                        "(resource-ledger accounts, per-cache top entries, "
                        "admission gate, pool, open-op table)")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="stats: serve the registry over HTTP instead of "
                        "dumping once — /metrics (Prometheus 0.0.4) and "
                        "/metrics.json; 0 binds an ephemeral port; runs "
                        "until interrupted")
    p.add_argument("--host", default=None, metavar="ADDR",
                   help="stats --serve / serve: bind address (default "
                        "loopback for stats, the config's host for "
                        "serve; 0.0.0.0 to let a fleet Prometheus "
                        "scrape it)")
    p.add_argument("--agg", action="append", default=[], metavar="SPEC",
                   help="aggregate: one aggregate per flag — count, "
                        "count:COL, min:COL, max:COL, sum:COL, "
                        "sum_sq:COL, avg:COL, var:COL[:sample], "
                        "distinct:COL, top:COL:K (repeatable)")
    p.add_argument("--where", default=None, metavar="COL:LO:HI",
                   help="aggregate: inclusive range predicate (empty "
                        "LO/HI = open bound; values parse as int, float, "
                        "then string)")
    p.add_argument("--group-by", default=None, metavar="COL",
                   help="aggregate: group results by this flat column")
    p.add_argument("--explain", action="store_true",
                   help="aggregate: print the per-row-group tier trace")
    p.add_argument("--knobs-md", action="store_true",
                   help="analyze: print the generated README table of "
                        "the port's knobs and exit")
    p.add_argument("--no-hammer", action="store_true",
                   help="analyze: skip the lock checker's hammer "
                        "subprocess (lint + knob-table sync only)")
    p.add_argument("--config", default=None, metavar="PATH",
                   help="serve: the serve.json configuration (datasets "
                        "to host + tenant QoS contracts)")
    p.add_argument("--port", type=int, default=None, metavar="PORT",
                   help="serve: override the config's port (0 binds an "
                        "ephemeral port, printed at startup)")
    # intermixed: `verify --json a b` and `stats --prom` both parse with
    # the optional positional (plain parse_args cannot place positionals
    # after an optional once nargs="*" matched zero)
    args = p.parse_intermixed_args(argv)

    if args.command == "analyze":
        return _analyze(args)
    if args.command == "aggregate":
        return _aggregate_cmd(args)
    if args.command == "serve":
        return _serve_cmd(args)
    if args.command == "stats":
        return _stats_cmd(args)
    if not args.file:
        return _fail(f"{args.command} requires a file")
    if args.command == "verify":
        return _verify_cmd(args)
    return _file_cmd(args)


def _stats_cmd(args) -> int:
    import json

    from .obs import metrics_snapshot, render_prometheus

    if args.file:
        from .dataset import expand_paths
        from .errors import CorruptedError
        from .io.reader import ParquetFile
        from .utils.pool import map_in_order

        missing: list = []
        files = expand_paths(args.file, missing=missing)
        for item in missing:
            _fail(f"{item}: no files match")
        if missing:
            return 1
        dev = _device(args)
        if dev is None:
            return 1

        def meter(path):
            # only the meters are wanted: a returned table would hold
            # every decoded file at once
            pf = ParquetFile(path)
            try:
                pf.read(device=dev)
            finally:
                pf.close()

        try:
            map_in_order(meter, files)
        except (OSError, ValueError, KeyError, CorruptedError) as e:
            return _fail(e)
    if args.serve is not None:
        from .obs.export import start_metrics_server

        srv = start_metrics_server(args.serve,
                                   host=args.host or "127.0.0.1")
        # line-buffered: a script reads the port from this line
        print(f"serving metrics on {srv.url} "
              f"(and {srv.url}.json); Ctrl-C to stop", flush=True)
        try:
            srv.join()
        except KeyboardInterrupt:
            srv.close()
        return 0
    if args.debugz:
        from .obs import debugz_snapshot

        print(json.dumps(debugz_snapshot(), sort_keys=True))
    elif args.prom:
        sys.stdout.write(render_prometheus())
    elif args.json:
        print(json.dumps(metrics_snapshot(), sort_keys=True))
    else:
        snap = metrics_snapshot()
        for kind in ("counters", "gauges"):
            for k, v in sorted(snap[kind].items()):
                print(f"{k} {v}")
        for k, h in sorted(snap["histograms"].items()):
            print(f"{k} count={h['count']} sum={h['sum']} "
                  f"p50={h['p50']} p95={h['p95']} p99={h['p99']}")
    return 0


def _verify_cmd(args) -> int:
    """Never opens a ParquetFile first: a corrupt footer gives a report
    and an exit code, not a traceback."""
    import json

    from .dataset import expand_paths
    from .io.integrity import verify_file
    from .utils.pool import map_in_order

    missing: list = []
    files = expand_paths(args.file, missing=missing)
    for item in missing:
        _fail(f"{item}: no files match")
    if not files:
        return 1
    dev = "cpu"  # unused without --decode
    if args.decode:
        dev = _device(args)
        if dev is None:
            return 1

    def one(path):
        try:
            return verify_file(path, decode=args.decode, device=dev)
        except OSError as e:  # an unreadable file fails, it does not crash
            return e

    bad = len(missing)
    for path, rep in zip(files, map_in_order(one, files)):
        if isinstance(rep, Exception):
            _fail(f"{path}: {rep}")
            bad += 1
            continue
        print(json.dumps(rep.as_dict()) if args.json else rep.summary())
        if not rep.ok:
            bad += 1
    return 1 if bad else 0


def _file_cmd(args) -> int:
    """``meta``, ``schema``, ``pages`` and ``head`` of one file."""
    from .io.reader import ParquetFile
    from .utils.printer import print_file, print_pages, print_schema

    if len(args.file) != 1:
        return _fail(f"{args.command} takes exactly one file")
    try:
        if args.n < 1:
            raise ValueError("-n must be >= 1")
        dev = None
        if args.command == "head":
            dev = _device(args)
            if dev is None:
                return 1
        pf = ParquetFile(args.file[0])
        try:
            if args.command == "meta":
                print_file(pf, file=sys.stdout)
            elif args.command == "schema":
                print_schema(pf.schema, file=sys.stdout)
            elif args.command == "pages":
                if not 0 <= args.row_group < len(pf.row_groups):
                    raise ValueError(
                        f"row group {args.row_group} out of range "
                        f"(file has {len(pf.row_groups)})")
                if not 0 <= args.column < len(pf.schema.leaves):
                    raise ValueError(
                        f"column {args.column} out of range "
                        f"(schema has {len(pf.schema.leaves)} leaves)")
                print_pages(pf, args.row_group, args.column, file=sys.stdout)
            else:
                _head(pf, args.n, dev)
        finally:
            pf.close()
    except (OSError, ValueError, KeyError) as e:
        return _fail(e)
    return 0


def _head(pf, n: int, device) -> None:
    """The first ``n`` rows as JSON lines, from the first streamed batch
    (at most ``n`` rows, decoded on ``device``) through Arrow's rows."""
    import json

    batches = pf.iter_batches(batch_rows=n, device=device)
    try:
        batch = next(batches, None)
    finally:
        batches.close()
    if batch is not None:
        for r in batch.to_arrow().to_pylist()[:n]:
            print(json.dumps(r, default=repr))


def _serve_cmd(args) -> int:
    """``serve --config serve.json [--port N] [--host ADDR]``: the daemon
    in the foreground until SIGTERM or SIGINT, then a drain of the
    requests in flight (``PARQUET_TPU_TORCH_SERVE_DRAIN_S``); exit 0
    where it drained."""
    import signal
    import threading

    from .serve import Server, load_config

    if not args.config:
        return _fail("serve requires --config serve.json")
    dev = _device(args)
    if dev is None:
        return 1
    try:
        config = load_config(args.config)
        # None (not passed) leaves the config's host; an explicit --host,
        # loopback too, overrides it
        srv = Server(config, host=args.host, port=args.port, device=dev)
    except (OSError, ValueError, KeyError) as e:
        return _fail(e)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    # line-buffered: a script reads the URL from this line
    print(f"serving {len(config.datasets)} dataset(s) on {srv.url} "
          f"(tenants: {', '.join(sorted(config.tenants)) or 'default'}); "
          f"SIGTERM drains and exits", flush=True)
    stop.wait()
    drained = srv.close(drain=True)
    print("drained and stopped" if drained
          else "stopped with requests still in flight", flush=True)
    return 0 if drained else 1


def _parse_value(tok: str):
    """A ``--where`` bound: int, then float, then the string (which the
    predicate compares as UTF-8 bytes); empty is an open bound."""
    if tok == "":
        return None
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            continue
    return tok


def _aggregate_cmd(args) -> int:
    """``aggregate FILE... --agg SPEC [--where COL:LO:HI] [--group-by
    COL] [--explain]``: one JSON object of the aggregates, the tiers that
    answered and the groups."""
    import json

    from .algebra.expr import col
    from .dataset import Dataset
    from .errors import CorruptedError
    from .serve.codecs import jsonable, parse_agg_spec

    if not args.file:
        return _fail("aggregate requires a file")
    dev = _device(args)
    if dev is None:
        return 1
    try:
        # the daemon's /v1/aggregate parses the same specs
        aggs = [parse_agg_spec(spec) for spec in (args.agg or ["count"])]
        where = None
        if args.where is not None:
            path, lo, hi = (args.where.split(":", 2) + ["", ""])[:3]
            where = col(path).between(_parse_value(lo), _parse_value(hi))
        ds = Dataset(args.file)
        try:
            res = ds.aggregate(aggs, where=where, group_by=args.group_by,
                               device=dev)
        finally:
            ds.close()
        doc = {"aggregates": {k: jsonable(v) for k, v in res.items()},
               "tiers": {k: v for k, v in res.counters.items() if v}}
        if res.groups is not None:
            doc["groups"] = [jsonable(k) for k in res.groups]
        print(json.dumps(doc, sort_keys=True))
        if args.explain:
            print(res.explain(), file=sys.stderr)
    except (OSError, ValueError, KeyError, CorruptedError) as e:
        return _fail(e)
    return 0


def _repo_root() -> str:
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _knobs_readme_stale():
    """The README's table of the port's knobs (between the
    ``torch-knobs`` markers) against the registry's: ``(stale, detail)``;
    without a README (an installed package) nothing is stale."""
    import os

    from .utils.env import knobs_markdown

    readme = os.path.join(_repo_root(), "README.md")
    if not os.path.exists(readme):
        return False, "no README.md (installed package?)"
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    if README_BEGIN not in text or README_END not in text:
        return True, ("README.md has no torch-knobs:begin/torch-knobs:end "
                      "markers")
    committed = text.split(README_BEGIN, 1)[1].split(README_END, 1)[0]
    if committed.strip() != knobs_markdown().strip():
        return True, ("README knob table is stale — regenerate with "
                      "`python -m parquet_tpu_torch analyze --knobs-md`")
    return False, "README knob table matches the registry"


def _run_hammer(device: str) -> dict:
    """The lock checker's hammer in a subprocess with
    ``PARQUET_TPU_TORCH_LOCKCHECK=1`` set before import, so the locks a
    module builds at import are checked too; its report, or a failed one
    where it timed out or printed none."""
    import json
    import os
    import subprocess

    # ptlint: disable=PT002 -- the whole environment copied for the
    # hammer's subprocess, not a knob read
    env = dict(os.environ)
    env["PARQUET_TPU_TORCH_LOCKCHECK"] = "1"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "parquet_tpu_torch.analysis.lockcheck",
             "--device", device],
            capture_output=True, text=True, env=env, cwd=_repo_root(),
            timeout=HAMMER_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        # a hammer that never returns is the strongest finding (an
        # interleaving deadlocked): a failure of the gate, not a crash
        return {"ok": False,
                "error": f"lockcheck hammer timed out after "
                         f"{HAMMER_TIMEOUT_S}s (likely a real deadlock)",
                "stdout": _tail(e.stdout), "stderr": _tail(e.stderr)}
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"ok": False, "error": "hammer produced no report",
                "stdout": _tail(proc.stdout), "stderr": _tail(proc.stderr)}


def _tail(out) -> str:
    if isinstance(out, bytes):
        out = out.decode("utf-8", "replace")
    return (out or "")[-2000:]


def _analyze(args) -> int:
    """``analyze [--json] [--knobs-md] [--no-hammer] [--device D]``: the
    gate before a merge: the lint (PT000-PT006), the README knob table
    against the registry, and the lock checker's hammer."""
    import json

    from .analysis.lint import run_lint
    from .utils.env import knobs_markdown

    if args.knobs_md:
        sys.stdout.write(knobs_markdown())
        return 0

    findings = run_lint()
    stale, knob_detail = _knobs_readme_stale()
    hammer = {"skipped": True} if args.no_hammer \
        else _run_hammer(args.device)
    hammer_ok = bool(hammer.get("ok", True))
    ok = not findings and not stale and hammer_ok

    if args.json:
        print(json.dumps({
            "ok": ok,
            "lint": [f.as_dict() for f in findings],
            "knobs_md": {"stale": stale, "detail": knob_detail},
            "lockcheck": hammer,
        }, sort_keys=True))
        return 0 if ok else 1

    for f in findings:
        print(f.render())
    print(f"lint: {len(findings)} finding(s)")
    print(f"knobs: {knob_detail}")
    if hammer.get("skipped"):
        print("lockcheck: skipped (--no-hammer)")
    else:
        cyc = hammer.get("cycles", [])
        blk = [x for x in hammer.get("findings", [])
               if x.get("kind") != "lock_order_cycle"]
        print(f"lockcheck: {hammer.get('acquisitions', 0)} acquisitions, "
              f"{len(hammer.get('edges', []))} lock-order edges, "
              f"{len(cyc)} cycle(s), {len(blk)} other finding(s)")
        for c in cyc:
            print(f"  cycle: {' -> '.join(c + [c[0]])}")
        for x in blk:
            print(f"  {x.get('kind')}: {x.get('blocking', x.get('lock'))} "
                  f"held={x.get('held')}")
        if not hammer_ok and "error" in hammer:
            print(f"  error: {hammer['error']}")
            if hammer.get("stderr"):
                print(hammer["stderr"])
    print("analyze: " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
