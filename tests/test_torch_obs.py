"""parquet_tpu_torch's ``obs/`` (metrics, trace, export) against
parquet_tpu's, on the CPU.

The registries declare the same families with the same help, and render
the same Prometheus text for the same registry operations; ``/debugz``
has the same sections.  The same operation on the same file moves the
same counters by the same amounts in both packages: the port with
``device="cpu"``, the reference through the call that takes the same
route (for a whole read, its ``read(device=True)``).  Under tracing both
record the same span names.  Where a family or a span differs by design,
the test pins both sides and says why.  No test asserts a wall-clock
bound, and every test leaves no thread running.
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.request
from collections import Counter as Multiset

import numpy as np
import pyarrow as pa
import pytest

import parquet_tpu
import parquet_tpu.format.enums  # noqa: F401 (each package's Type)
import parquet_tpu_torch.format.enums  # noqa: F401
from parquet_tpu import obs as jobs
from parquet_tpu.io import source as jsource
from parquet_tpu.obs import export as jexport
from parquet_tpu.obs import metrics as jmetrics

import parquet_tpu_torch as pqt
from parquet_tpu_torch import obs as tobs
from parquet_tpu_torch.io import source as tsource
from parquet_tpu_torch.obs import export as texport
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.obs import trace as ttrace
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = "cpu"
N_ROWS = 60_000
ROW_GROUP = 20_000

# the reference's families that the port does not declare: none since the
# fleet's slice declared ``fleet.forwards`` ... (serve/cluster.py); the
# serving daemon's own (``serve.*``) and the page pins' came with the daemon
FLEET_ONLY = {"counters": set(), "gauges": set(), "histograms": set()}
SERVE_FAMILIES = {
    "counters": {
        "serve.errors", "serve.writes_committed", "serve.rows_served",
        "serve.qps_rejections", "serve.auth_failures", "cache.page_pins",
        "cache.page_pin_refusals",
        "serve.requests{class=latency}", "serve.requests{class=default}",
        "serve.requests{class=bulk}", "serve.shed{class=latency}",
        "serve.shed{class=default}", "serve.shed{class=bulk}"},
    "gauges": {"cache.page_pinned_bytes"},
    "histograms": {"serve.request_s{class=latency}",
                   "serve.request_s{class=default}",
                   "serve.request_s{class=bulk}"},
}


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean():
    """Tracing is process-wide: each test starts and ends with it off and
    both buffers empty, and with both packages' caches cleared."""
    before = threads_now()
    for o in (tobs, jobs):
        o.disable_tracing()
        o.reset_trace()
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    yield
    for o in (tobs, jobs):
        o.disable_tracing()
        o.reset_trace()
    assert_no_thread_started(before)


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    cols = {"a": np.arange(N_ROWS, dtype=np.int64), "b": rng.random(N_ROWS),
            "c": rng.integers(0, 10, N_ROWS).astype(np.int32)}
    path = str(tmp_path_factory.mktemp("obs") / "t.parquet")
    pqt.write_table(cols, path, pqt.WriterOptions(row_group_size=ROW_GROUP))
    return path


# ------------------------------------------------------------- families

def _registered(registry):
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    kind = {tmetrics.Counter: "counters", tmetrics.Gauge: "gauges",
            tmetrics.Histogram: "histograms", jmetrics.Counter: "counters",
            jmetrics.Gauge: "gauges", jmetrics.Histogram: "histograms"}
    for m in registry.collect():
        out[kind[type(m)]][tmetrics._render_key(m.name, m.labels)] = m.help
    return out


def _core_of(registry):
    """The families declared at import: not the span histograms, the
    labelled series minted at run time, or a test's own."""
    got = _registered(registry)
    for k in got:
        got[k] = {n: h for n, h in got[k].items()
                  if not n.startswith(("span.", "t.", "test."))
                  and "@" not in n}
    return got


def test_same_families_with_the_same_help():
    port, ref = _core_of(tmetrics.REGISTRY), _core_of(jmetrics.REGISTRY)
    for kind in ("counters", "gauges", "histograms"):
        missing = set(ref[kind]) - set(port[kind])
        assert missing == FLEET_ONLY[kind] - set(port[kind]), kind
        assert not FLEET_ONLY[kind] & set(port[kind]), kind
        assert SERVE_FAMILIES[kind] <= set(port[kind]), kind
        for name in set(port[kind]) & set(ref[kind]):
            assert port[kind][name] == ref[kind][name], name


@pytest.mark.parametrize("family", [
    "cache.footer_hits", "cache.page_hits", "cache.chunk_hits",
    "prefetch.hits", "planner.rg_pruned_stats", "read.retries",
    "read.bytes_read", "write.row_groups", "write.pool_wait_s",
    "write.mmap_commits", "pool.tasks", "trace.events_dropped",
    "lookup.keys", "remote.preads", "table.commits",
    "table.compaction_errors", "agg.rg_answered_stats",
    "fused.rg_folds", "route.chosen{route=host}",
    "device.route_refusals{reason=other}", "fleet.cas_commits",
    "ledger.pressure_evictions"])
def test_core_counters_exist_before_any_operation(family):
    assert family in pqt.metrics_snapshot()["counters"]
    assert family in jobs.metrics_snapshot()["counters"]


def test_pool_wait_seconds_sums_both_histograms():
    for m in (tmetrics, jmetrics):
        before = m.pool_wait_seconds()
        m.histogram("pool.queue_wait_s").observe(0.25)
        m.histogram("prefetch.wait_s").observe(0.5)
        assert m.pool_wait_seconds() - before == pytest.approx(0.75)


# ----------------------------------------------------------- prometheus

_OPS = {
    "counters": [("c", {}, 3), ("c", {"k": "x"}, 1.5), ("d.e", {}, 7)],
    "gauges": [("g", {}, 4), ("g", {"a": 'q"u\\o\nte'}, -2.5)],
    "histograms": [("h", {}, [1e-6, 0.003, 0.2, 2.0, 100.0]),
                   ("h2", {"r": "1"}, [0.5])],
}


def _fill(m, which):
    reg = m.MetricsRegistry()
    for name, labels, v in _OPS["counters"] if "c" in which else ():
        reg.counter(name, labels, help=f"help of {name}").inc(v)
    for name, labels, v in _OPS["gauges"] if "g" in which else ():
        reg.gauge(name, labels).set(v)
    for name, labels, vs in _OPS["histograms"] if "h" in which else ():
        h = reg.histogram(name, labels, help="seconds")
        for v in vs:
            h.observe(v)
    return reg


@pytest.mark.parametrize("which", ["c", "g", "h", "cgh"])
def test_render_prometheus_equals_the_reference(which):
    port = texport.render_prometheus(_fill(tmetrics, which))
    ref = jexport.render_prometheus(_fill(jmetrics, which))
    assert port == ref
    assert port.endswith("\n")


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$')


def test_the_process_registry_renders_valid_exposition_text():
    text = pqt.render_prometheus()
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
            continue
        if line.startswith("# HELP "):
            continue
        assert _SAMPLE.match(line), line
    assert "parquet_tpu_read_bytes_read_total" in families
    assert "parquet_tpu_pool_queue_wait_s" in families
    assert "parquet_tpu_ledger_resident_bytes" in families


# --------------------------------------------------------------- trace

def test_disabled_tracer_allocates_nothing():
    assert not tobs.enabled() and ttrace.TRACE_ENABLED is False
    assert {id(tobs.trace_span("x")) for _ in range(50)} == \
        {id(tobs.NULL_SPAN)}
    with tobs.trace_span("decode.chunk"):
        pass
    assert tobs.trace_events() == []


def test_a_span_records_its_thread_args_and_histogram():
    tobs.enable_tracing()
    got = {}

    def worker():
        with tobs.trace_span("t.work", rg=3, col="a.b"):
            got["tid"] = threading.get_ident()

    th = threading.Thread(target=worker, name="obs-worker")
    th.start()
    th.join()
    with tobs.trace_span("t.main"):
        pass
    tobs.disable_tracing()
    evs = tobs.trace_events()
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert xs["t.work"]["tid"] == got["tid"] != xs["t.main"]["tid"]
    assert xs["t.work"]["args"] == {"rg": 3, "col": "a.b"}
    names = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert "obs-worker" in names
    assert tmetrics.REGISTRY.histogram("span.t.work_s").count >= 1


def test_the_buffer_is_capped_and_drops_are_counted(monkeypatch):
    monkeypatch.setattr(ttrace, "MAX_EVENTS", 8)
    before = tmetrics.counter("trace.events_dropped").value
    tobs.enable_tracing()
    for _ in range(32):
        with tobs.trace_span("t.flood"):
            pass
    tobs.disable_tracing()
    assert len(tobs.trace_events()) <= 8
    assert tmetrics.counter("trace.events_dropped").value - before >= 24


def test_the_trace_buffer_is_a_ledger_account():
    acc = tobs.LEDGER.accounts()["trace.buffer"]
    tobs.enable_tracing()
    for _ in range(5):
        with tobs.trace_span("t.acc"):
            pass
    tobs.disable_tracing()
    assert acc.resident == len(tobs.trace_events()) * ttrace._EVENT_EST_BYTES
    tobs.reset_trace()
    assert acc.resident == 0


def test_the_flushed_file_loads_as_chrome_trace_json(tmp_path):
    path = tmp_path / "trace.json"
    tobs.enable_tracing(path)
    with tobs.trace_span("open.footer", file="f.parquet"):
        with tobs.trace_span("decode.chunk", rg=0, col="a"):
            pass
    tobs.disable_tracing()
    assert tobs.flush_trace() == str(path)
    body = json.loads(path.read_text())
    for ev in body["traceEvents"]:
        assert ev["ph"] in ("X", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert ev["cat"] == ev["name"].split(".", 1)[0]
    assert {"open.footer", "decode.chunk"} <= {
        e["name"] for e in body["traceEvents"]}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_a_failed_flush_leaves_the_old_trace_and_no_temp(tmp_path,
                                                         monkeypatch):
    path = tmp_path / "trace.json"
    tobs.enable_tracing()
    with tobs.trace_span("t.first"):
        pass
    tobs.flush_trace(path)
    old = path.read_text()

    def boom(*a, **k):
        raise OSError("disk full")

    with tobs.trace_span("t.second"):
        pass
    monkeypatch.setattr(ttrace.json, "dump", boom)
    with pytest.raises(OSError):
        tobs.flush_trace(path)
    assert path.read_text() == old
    assert os.listdir(tmp_path) == ["trace.json"]


def test_the_trace_knob_is_read_at_import_and_flushed_at_exit(tmp_path):
    path = tmp_path / "env.json"
    env = dict(os.environ, PARQUET_TPU_TORCH_TRACE=str(path))
    code = ("from parquet_tpu_torch import obs\n"
            "assert obs.trace.TRACE_ENABLED\n"
            "with obs.trace_span('t.env'):\n"
            "    pass\n")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert "t.env" in names


# ----------------------------------------------- the same operation, moved

def _delta(m, fn):
    before = m.metrics_snapshot()
    fn()
    got = m.metrics_delta(before, m.metrics_snapshot())["counters"]
    # pool tasks, prefetch counters and span latencies follow each
    # package's own threading, not the operation
    return {k: v for k, v in got.items()
            if not k.startswith(("pool.", "prefetch.", "span."))}


def _pair(port_fn, ref_fn):
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    port = _delta(tmetrics, port_fn)
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    ref = _delta(jmetrics, ref_fn)
    return port, ref


def test_a_read_moves_the_same_counters(table_path):
    def port():
        with pqt.ParquetFile(table_path) as pf:
            pf.read(device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            pf.read(device=True)

    p, r = _pair(port, ref)
    assert p == r
    assert p["read.bytes_read"] > 0 and p["cache.footer_misses"] == 1


def test_a_warm_reopen_hits_the_footer_cache_in_both(table_path):
    def twice(pkg, **kw):
        def run():
            for _ in range(2):
                with pkg.ParquetFile(table_path) as pf:
                    pf.read(**kw)
        return run

    p, r = _pair(twice(pqt, device=CPU), twice(parquet_tpu, device=True))
    assert p == r
    assert p["cache.footer_hits"] == 1


@pytest.mark.parametrize("lo,hi", [(1000, 30000), (45000, None), (-5, -1)])
def test_a_scan_moves_the_same_planner_and_row_counters(table_path, lo, hi):
    def port():
        with pqt.ParquetFile(table_path) as pf:
            pqt.scan_filtered(pf, "a", lo=lo, hi=hi, columns=["b"],
                              device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            parquet_tpu.scan_filtered(pf, "a", lo=lo, hi=hi, columns=["b"])

    p, r = _pair(port, ref)
    assert p == r
    assert p["planner.rg_considered"] == N_ROWS // ROW_GROUP
    assert "scan.rows_pruned" in p


@pytest.mark.parametrize("keys", [[5, 100, 25000, 999999], [7] * 20, []])
def test_a_lookup_moves_the_same_lookup_counters(table_path, keys,
                                                 monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")

    def port():
        with pqt.ParquetFile(table_path) as pf:
            pf.find_rows("a", keys, columns=["b"], device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            pf.find_rows("a", keys, columns=["b"])

    p, r = _pair(port, ref)
    assert p == r
    assert p.get("lookup.keys", 0) == len(keys)


def _ranges(monkeypatch, log):
    """Log each package's preads, by package, as (offset, size)."""
    for key, mod in (("port", tsource), ("ref", jsource)):
        for meth in ("pread", "pread_view"):
            orig = getattr(mod.MmapSource, meth)

            def logged(self, offset, size, _orig=orig, _key=key):
                log[_key].append((offset, size))
                return _orig(self, offset, size)

            monkeypatch.setattr(mod.MmapSource, meth, logged)


def test_an_aggregate_moves_the_same_tier_counters(table_path, monkeypatch):
    """Every counter moves alike but ``read.bytes_read``: the reference
    reads the offset index of every row group it plans, the port only
    where a tier reads pages.  Pinned on both sides: every range the port
    reads the reference reads too, and the reference's extra bytes are
    exactly its extra preads, all inside the file's page-index region
    (after the last column chunk, before the footer)."""
    log = {"port": [], "ref": []}
    _ranges(monkeypatch, log)

    def port():
        with pqt.ParquetFile(table_path) as pf:
            pf.aggregate([pqt.sum_("b"), pqt.count()],
                         where=pqt.col("a").between(0, 30000), device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            pf.aggregate([parquet_tpu.sum_("b"), parquet_tpu.count()],
                         where=parquet_tpu.col("a").between(0, 30000))

    p, r = _pair(port, ref)
    pb, rb = p.pop("read.bytes_read"), r.pop("read.bytes_read")
    assert p == r
    assert p["agg.rg_answered_stats"] == 1
    assert p["agg.rg_answered_decoded"] == 2
    extra = Multiset(log["ref"]) - Multiset(log["port"])
    assert not Multiset(log["port"]) - Multiset(log["ref"])
    assert rb - pb == sum(size for _, size in extra.elements()) > 0
    with pqt.ParquetFile(table_path) as pf:
        data_end = max(c.meta_data.data_page_offset
                       + c.meta_data.total_compressed_size
                       for rg in pf.metadata.row_groups for c in rg.columns)
        size = pf.source.size()
        footer = int.from_bytes(pf.source.pread(size - 8, 4), "little")
    for off, n in extra.elements():
        assert data_end <= off and off + n <= size - 8 - footer


def test_a_write_moves_the_same_row_group_and_flush_counters(tmp_path):
    """``write.row_groups`` and the flush counts match; the byte counters
    follow each writer's own bytes (``created_by`` and the encoders'
    choices make the files differ in length)."""
    rng = np.random.default_rng(1)
    cols = {"a": np.arange(N_ROWS, dtype=np.int64), "b": rng.random(N_ROWS)}

    def port():
        pqt.write_table(cols, str(tmp_path / "p.parquet"),
                        pqt.WriterOptions(row_group_size=ROW_GROUP))

    def ref():
        parquet_tpu.write_table(pa.table(cols), str(tmp_path / "r.parquet"),
                                parquet_tpu.WriterOptions(
                                    row_group_size=ROW_GROUP))

    p, r = _pair(port, ref)
    for k in ("write.row_groups", "write.sink_flushes",
              "write.writev_flushes"):
        assert p[k] == r[k], k
    assert p["write.row_groups"] == N_ROWS // ROW_GROUP
    assert p["write.bytes_flushed"] == os.path.getsize(tmp_path / "p.parquet")
    assert r["write.bytes_flushed"] == os.path.getsize(tmp_path / "r.parquet")
    # the port has no background emitter and no mapped sink (by design)
    assert "write.pended" not in p and "write.mmap_commits" not in p
    assert "write.mmap_commits" not in r


def test_a_table_commit_moves_the_same_table_counters(tmp_path):
    rng = np.random.default_rng(2)
    cols = {"k": np.arange(5000, dtype=np.int64), "v": rng.random(5000)}

    def ingest(pkg, d):
        types = sys.modules[pkg.__name__ + ".format.enums"].Type
        schema = pkg.message("t", [pkg.leaf("k", types.INT64),
                                   pkg.leaf("v", types.DOUBLE)])

        data = {k: pkg.ColumnData(values=v) for k, v in cols.items()}

        def run():
            with pkg.DatasetWriter(str(d), schema) as w:
                w.write(data, 5000)
                w.commit()
                w.write(data, 5000)
                w.commit()
        return run

    p, r = _pair(ingest(pqt, tmp_path / "p"),
                 ingest(parquet_tpu, tmp_path / "r"))
    for k in ("table.commits", "table.files_written", "table.rows_ingested",
              "fleet.cas_commits", "write.row_groups"):
        assert p[k] == r[k], k
    assert p["table.commits"] == 2 and p["table.rows_ingested"] == 10000
    assert p["table.bytes_ingested"] == sum(
        os.path.getsize(tmp_path / "p" / f) for f in os.listdir(
            tmp_path / "p") if f.endswith(".parquet"))


# ------------------------------------------------------------- span names

def _spans(o, fn):
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    o.reset_trace()
    o.enable_tracing()
    try:
        fn()
    finally:
        o.disable_tracing()
    names = {e["name"] for e in o.trace_events() if e["ph"] == "X"}
    o.reset_trace()
    return names


def test_a_read_records_the_same_spans(table_path):
    def port():
        with pqt.ParquetFile(table_path) as pf:
            pf.read(device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            pf.read(device=True)

    p, r = _spans(tobs, port), _spans(jobs, ref)
    assert p == r
    assert {"open.footer", "device.h2d", "op.file.read"} <= p


def test_a_scan_records_the_same_spans(table_path):
    def port():
        with pqt.ParquetFile(table_path) as pf:
            pqt.scan_filtered(pf, "a", lo=1000, hi=30000, columns=["b"],
                              device=CPU)

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            parquet_tpu.scan_filtered(pf, "a", lo=1000, hi=30000,
                                      columns=["b"])

    p, r = _spans(tobs, port), _spans(jobs, ref)
    assert p == r
    assert {"planner.plan", "scan.phase1", "scan.phase2"} <= p


def test_a_drain_records_the_same_spans_and_the_device_staging(table_path):
    """The port's drain decodes each pull on the read's device, so its
    trace has the ``device.h2d`` span of each pull's staging; the
    reference's drain decodes on the host and has none (by design)."""
    def port():
        with pqt.ParquetFile(table_path) as pf:
            for _ in pf.iter_batches(batch_rows=10_000, device=CPU):
                pass

    def ref():
        with parquet_tpu.ParquetFile(table_path) as pf:
            for _ in pf.iter_batches(batch_rows=10_000):
                pass

    p, r = _spans(tobs, port), _spans(jobs, ref)
    assert "device.h2d" in p and "device.h2d" not in r
    assert p - {"device.h2d"} == r
    assert {"decode.stream", "op.file.iter_batches"} <= r


def test_a_write_records_the_same_spans(tmp_path):
    rng = np.random.default_rng(3)
    cols = {"a": np.arange(N_ROWS, dtype=np.int64), "b": rng.random(N_ROWS)}
    p = _spans(tobs, lambda: pqt.write_table(
        cols, str(tmp_path / "p.parquet"),
        pqt.WriterOptions(row_group_size=ROW_GROUP)))
    r = _spans(jobs, lambda: parquet_tpu.write_table(
        pa.table(cols), str(tmp_path / "r.parquet"),
        parquet_tpu.WriterOptions(row_group_size=ROW_GROUP)))
    assert p == r
    assert {"write.encode", "write.emit", "sink.flush", "op.write.file"} <= p


def test_a_whole_chunk_host_decode_records_decode_chunk(table_path):
    from parquet_tpu_torch.io.reader import decode_chunk_host

    with pqt.ParquetFile(table_path) as pf:
        chunk = pf.row_group(0).column(0)
        p = _spans(tobs, lambda: decode_chunk_host(chunk, CPU))
    assert p == {"decode.chunk"}


# --------------------------------------------------- debugz and endpoints

def _shape(d, depth):
    if depth == 0 or not isinstance(d, dict):
        return type(d).__name__
    return {k: _shape(v, depth - 1) for k, v in d.items()}


def test_debugz_has_the_reference_sections():
    port, ref = texport.debugz_snapshot(), jexport.debugz_snapshot()
    assert set(port) == set(ref)
    for section in ("ledger", "admission", "pool", "caches", "tables"):
        assert set(port[section]) == set(ref[section]), section
    for tier in ("chunk", "page", "footer", "neg_lookup"):
        assert set(port["caches"][tier]) == set(ref["caches"][tier]), tier
    assert set(port["ledger"]["accounts"]) == set(ref["ledger"]["accounts"])
    assert set(port["routes"]) == set(ref["routes"])


def test_debugz_providers_come_and_go():
    texport.register_debugz_provider("t_extra", lambda: {"n": 1})
    texport.register_debugz_provider("t_broken", lambda: 1 / 0)
    try:
        got = texport.debugz_snapshot()
        assert got["t_extra"] == {"n": 1}
        assert "error" in got["t_broken"]
    finally:
        texport.unregister_debugz_provider("t_extra")
        texport.unregister_debugz_provider("t_broken")
    assert "t_extra" not in texport.debugz_snapshot()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def test_the_scrape_endpoints_answer_and_close_joins_the_server():
    before = threads_now()
    srv = pqt.start_metrics_server(0)
    try:
        st, ctype, body = _get(srv.url)
        assert st == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert b"parquet_tpu_read_bytes_read_total" in body
        st, ctype, body = _get(srv.url + ".json")
        assert "read.bytes_read" in json.loads(body)["counters"]
        with pqt.op_scope("t.live", who="scraper"):
            st, _, body = _get(f"http://{srv.host}:{srv.port}/debugz")
        dz = json.loads(body)
        assert [o["name"] for o in dz["ops"]] == ["t.live"]
        assert "page" in dz["caches"] and "accounts" in dz["ledger"]
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://{srv.host}:{srv.port}/nowhere")
    finally:
        srv.close()
    assert_no_thread_started(before)


def test_a_scrape_sees_live_updates():
    with pqt.start_metrics_server(0) as srv:
        tmetrics.counter("test.live_updates").inc(41)
        _, _, body = _get(srv.url)
        assert b"parquet_tpu_test_live_updates_total 41" in body
        tmetrics.counter("test.live_updates").inc()
        _, _, body = _get(srv.url)
        assert b"parquet_tpu_test_live_updates_total 42" in body


def test_the_package_exports_the_reference_obs_names():
    names = ("obs", "OpScope", "current_op", "debugz_snapshot",
             "disable_tracing", "enable_tracing", "flush_trace",
             "ledger_snapshot", "metrics_delta", "metrics_snapshot",
             "op_scope", "pool_wait_seconds", "render_prometheus",
             "reset_metrics", "start_metrics_server", "trace_span")
    for n in names:
        assert hasattr(pqt, n) and hasattr(parquet_tpu, n), n
    assert set(tobs.__all__) == set(jobs.__all__)
