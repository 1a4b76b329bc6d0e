"""parquet_tpu_torch's resource ledger (``obs/ledger.py``) and the tiers
that keep its accounts, against parquet_tpu's, on the CPU.

The port declares the reference's accounts.  Every tier keeps its
account equal to its own residency, under 8 threads of churn too, and
each transient account (the prefetcher's ring and segments, the writer's
buffer, a table writer's pending rows, the read gate's grants, the mesh
read's staged bytes) returns to 0 when its work ends.  The soft
watermark shrinks the caches and leaves a lookup's answers unchanged;
the hard watermark holds a read admission until the ledger's bytes drop.
No test asserts a wall-clock bound: a blocked admission is seen in the
gate's queue, and released by the test.
"""

import os
import threading
import time

import numpy as np
import pytest

import parquet_tpu
import parquet_tpu.io.cache  # noqa: F401 (the reference's page cache)
from parquet_tpu.obs import ledger as jledger

import parquet_tpu_torch as pqt
from parquet_tpu_torch import obs as tobs
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.io import remote as tremote
from parquet_tpu_torch.obs import ledger as tledger
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = "cpu"
N_ROWS = 60_000
ROW_GROUP = 15_000
LEDGER = tledger.LEDGER


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    before = threads_now()
    for knob in ("MEM_SOFT", "MEM_HARD"):
        monkeypatch.delenv("PARQUET_TPU_TORCH_" + knob, raising=False)
        monkeypatch.delenv("PARQUET_TPU_" + knob, raising=False)
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    yield
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    assert_no_thread_started(before)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    rng = np.random.default_rng(0)
    cols = {"k": np.arange(N_ROWS, dtype=np.int64) * 3,
            "v": rng.random(N_ROWS),
            "s": [b"s%06d" % i for i in range(N_ROWS)]}
    p = str(tmp_path_factory.mktemp("ledger") / "t.parquet")
    pqt.write_table(cols, p, pqt.WriterOptions(row_group_size=ROW_GROUP,
                                               data_page_size=8192))
    return p


def _resident(name):
    return LEDGER.accounts()[name].resident


def _tiers():
    """Each cache tier's own byte count."""
    return {"cache.page": tcache.PAGES._bytes,
            "cache.footer": tcache.FOOTERS._bytes,
            "cache.neg_lookup": tcache.NEGS.resident_bytes}


# ------------------------------------------------------------ accounts

def test_the_accounts_are_the_references():
    assert tledger.CORE_ACCOUNTS == jledger.CORE_ACCOUNTS
    assert set(LEDGER.accounts()) >= {n for n, _ in tledger.CORE_ACCOUNTS}
    g = tobs.metrics_snapshot()["gauges"]
    for name, _ in tledger.CORE_ACCOUNTS:
        assert f"ledger.resident_bytes{{account={name}}}" in g
    assert "ledger.total_bytes" in g


def test_the_snapshot_has_the_references_shape():
    port, ref = tobs.ledger_snapshot(), jledger.ledger_snapshot()
    assert set(port) == set(ref)

    def library(snap):
        # a test's own accounts (``test.*``) are no account of the library:
        # another file on the same worker may have left one in a ledger
        return {n for n in snap["accounts"] if not n.startswith("test.")}

    assert library(port) == library(ref)
    for name in library(port):
        assert set(port["accounts"][name]) == set(ref["accounts"][name])
    assert port["total_bytes"] == sum(
        a["resident_bytes"] for a in port["accounts"].values())


@pytest.mark.parametrize("name", ["cache.chunk", "cache.page_pinned",
                                  "write.pended"])
def test_the_tiers_the_port_lacks_stay_at_zero(path, name):
    with pqt.ParquetFile(path) as pf:
        pf.read(device=CPU)
        pf.find_rows("k", [3, 4, 9], device=CPU)
    assert _resident(name) == 0


def test_the_cache_accounts_equal_their_tiers(path):
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", [3, 4, 9, 30_000, 10**9], columns=["v", "s"],
                     device=CPU)
    for name, want in _tiers().items():
        assert _resident(name) == want, name
    assert _resident("cache.page") > 0 and _resident("cache.footer") > 0
    assert _resident("cache.neg_lookup") > 0
    pqt.clear_caches()
    for name in _tiers():
        assert _resident(name) == 0, name


def test_a_lookup_leaves_the_references_cache_residency(path, monkeypatch):
    """The same lookup from cleared caches holds the same footer and
    absent-key bytes in both packages' ledgers, and the same page bytes
    but for one difference of form, pinned: a byte-array page's rows are
    one buffer and its int64 row offsets in the port (``ByteRows``), and
    a tuple of ``bytes`` whose payload alone the reference weighs."""
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "0")
    keys = [3, 4, 9, 30_000, 10**9, 6 * ROW_GROUP]
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", keys, columns=["v", "s"], device=CPU)
    with parquet_tpu.ParquetFile(path) as pf:
        pf.find_rows("k", keys, columns=["v", "s"])
    port = tobs.ledger_snapshot()["accounts"]
    ref = jledger.ledger_snapshot()["accounts"]
    for name in ("cache.footer", "cache.neg_lookup"):
        assert port[name]["resident_bytes"] == ref[name]["resident_bytes"], \
            name
    offsets = sum(e.values.offsets.nbytes
                  for e, _ in tcache.PAGES._entries.values()
                  if isinstance(e.values, tcache.ByteRows))
    assert offsets > 0
    assert port["cache.page"]["resident_bytes"] == \
        ref["cache.page"]["resident_bytes"] + offsets
    assert len(tcache.PAGES._entries) == len(
        parquet_tpu.io.cache.PAGES._entries)


def test_eight_threads_of_churn_keep_every_account_exact(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_PAGE_CACHE", str(256 << 10))
    monkeypatch.setenv("PARQUET_TPU_TORCH_NEG_LOOKUP", str(64 << 10))
    monkeypatch.setenv("PARQUET_TPU_TORCH_FOOTER_CACHE", "16")
    start = threading.Barrier(8)
    errors = []

    def worker(w):
        rng = np.random.default_rng(w)
        try:
            start.wait(timeout=60)
            for i in range(300):
                k = int(rng.integers(0, 64))
                ap = f"/f{k % 8}"
                tcache.PAGES.put(((ap, 0, 0, 0), 0, "c", k),
                                 np.zeros(int(rng.integers(1, 2048)),
                                          np.uint8), None, 0, 1)
                tcache.NEGS.add(((ap, 0, 0, 0), k % 4, "c"),
                                [int(x) for x in rng.integers(0, 500, 8)])
                tcache.FOOTERS.put((ap, 0, 0, k), object(),
                                   nbytes=int(rng.integers(100, 900)))
                if i % 50 == 0:
                    tcache.invalidate_path(ap)
                tcache.PAGES.get(((ap, 0, 0, 0), 0, "c", k))
        except Exception as e:  # raised in the test below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    for name, want in _tiers().items():
        assert _resident(name) == want, name
    hw = tobs.ledger_snapshot()["accounts"]["cache.page"]["high_water_bytes"]
    assert hw >= _resident("cache.page") and hw > 0


# ------------------------------------------------ transient accounts drain

def test_the_ring_prefetcher_accounts_drain_to_zero(path, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH", "ring")
    ring, seg = (LEDGER.accounts()[n] for n in ("prefetch.ring",
                                                  "prefetch.segments"))
    ring._reset()
    seg._reset()
    with pqt.ParquetFile(path) as pf:
        for _ in pf.iter_batches(batch_rows=7_000, device=CPU):
            pass
        pf.read(device=CPU)
    assert ring.resident == 0 and seg.resident == 0
    assert ring.high_water > 0 and seg.high_water > 0


def test_the_write_buffer_drains_to_zero(tmp_path):
    acc = LEDGER.accounts()["write.buffer"]
    acc._reset()
    rng = np.random.default_rng(1)
    w = pqt.ParquetWriter(str(tmp_path / "w.parquet"),
                          pqt.message("t", [pqt.leaf("x", _t().DOUBLE)]),
                          pqt.WriterOptions(row_group_size=10_000))
    w.write({"x": pqt.ColumnData(values=rng.random(30_000))}, 30_000)
    w.flush()
    assert acc.resident > 0
    w.close()
    assert acc.resident == 0 and acc.high_water > 0


def test_an_aborted_write_releases_its_buffer(tmp_path):
    acc = LEDGER.accounts()["write.buffer"]
    w = pqt.ParquetWriter(str(tmp_path / "a.parquet"),
                          pqt.message("t", [pqt.leaf("x", _t().DOUBLE)]))
    w.write({"x": pqt.ColumnData(values=np.ones(50_000))}, 50_000)
    w.flush()
    assert acc.resident > 0
    w.abort()
    assert acc.resident == 0
    assert not os.listdir(tmp_path)


def _t():
    from parquet_tpu_torch.format.enums import Type

    return Type


def test_a_table_writers_pending_rows_are_an_account(tmp_path):
    acc = LEDGER.accounts()["table.pending"]
    schema = pqt.message("t", [pqt.leaf("k", _t().INT64)])
    with pqt.DatasetWriter(str(tmp_path / "a"), schema) as w:
        w.write({"k": pqt.ColumnData(values=np.arange(1000))}, 1000)
        assert acc.resident == 8000 == w.pending_bytes()
        w.commit()
        assert acc.resident == 0
        w.write({"k": pqt.ColumnData(values=np.arange(10))}, 10)
        assert acc.resident == 80
        w.abort()
    assert acc.resident == 0


def test_a_read_grant_is_an_account(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_SCAN_BUDGET", str(1 << 20))
    acc = LEDGER.accounts()["admission.in_flight"]
    gate = tpool.read_admission()
    with gate.admit(4096, tier="scan") as grant:
        assert grant == 4096 and acc.resident == 4096
        assert tobs.metrics_snapshot()["gauges"]["lookup.admitted_bytes"] \
            == 4096
    assert acc.resident == 0


def test_the_hedges_bytes_are_a_view_of_their_account():
    acc = LEDGER.accounts()["remote.hedge_in_flight"]
    assert tremote.hedge_in_flight_bytes() == acc.resident == 0
    acc.add(123)
    try:
        assert tremote.hedge_in_flight_bytes() == 123
        assert tremote.remote_debug()["hedge_in_flight_bytes"] == 123
    finally:
        acc.sub(123)
    assert tremote.hedge_in_flight_bytes() == 0


def test_the_mesh_reads_staged_bytes_drain_to_zero(tmp_path, path):
    import shutil

    acc = LEDGER.accounts()["device.staging"]
    acc._reset()
    other = str(tmp_path / "copy.parquet")
    shutil.copyfile(path, other)
    with pqt.Dataset([path, other]) as ds:
        got = ds.read(device=[CPU] * 2)
    assert got["k"].values.shape[0] == 2 * N_ROWS
    assert acc.resident == 0 and acc.high_water > 0


# -------------------------------------------------------------- pressure

def _counter(name, **labels):
    return tmetrics.counter(name, labels or None).value


def test_no_watermark_no_check():
    t0 = {s: _counter("ledger.pressure_transitions", state=s)
          for s in ("ok", "soft", "hard")}
    tledger.maybe_check_pressure()
    assert t0 == {s: _counter("ledger.pressure_transitions", state=s)
                  for s in ("ok", "soft", "hard")}
    assert LEDGER.state() == "ok"


def test_the_soft_watermark_shrinks_the_caches(path, monkeypatch):
    keys = list(range(0, N_ROWS * 3, 997))
    with pqt.ParquetFile(path) as pf:
        first = pf.find_rows("k", keys, columns=["v", "s"], device=CPU)
        total = LEDGER.total()
        pages = _resident("cache.page")
        assert pages > 0
        ev0 = _counter("ledger.pressure_evictions")
        soft0 = _counter("ledger.pressure_transitions", state="soft")
        monkeypatch.setenv("PARQUET_TPU_TORCH_MEM_SOFT", str(total // 2))
        tobs.enable_tracing()
        LEDGER.check_pressure()
        tobs.disable_tracing()
        assert LEDGER.total() < total // 2
        assert _resident("cache.page") < pages
        assert _counter("ledger.pressure_evictions") > ev0
        assert _counter("ledger.pressure_transitions", state="soft") > soft0
        assert "ledger.pressure" in {e["name"] for e in tobs.trace_events()}
        monkeypatch.delenv("PARQUET_TPU_TORCH_MEM_SOFT")
        again = pf.find_rows("k", keys, columns=["v", "s"], device=CPU)
    tobs.reset_trace()
    assert [h.rows.tolist() for h in again.hits] == \
        [h.rows.tolist() for h in first.hits]
    for h1, h2 in zip(first.hits, again.hits):
        for c in ("v", "s"):
            assert _plain(h1.values[c]) == _plain(h2.values[c])


def _plain(v):
    if isinstance(v, tuple):
        return [None if p is None else _plain(p) for p in v]
    return np.asarray(v).tolist() if not isinstance(v, list) else v


def test_a_growth_site_runs_the_reclaim(path, monkeypatch):
    """A cache put is a growth site: past the soft watermark its own put
    shrinks the tier, with no caller asking."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_MEM_SOFT", str(64 << 10))
    ev0 = _counter("ledger.pressure_evictions")
    for i in range(64):
        tcache.PAGES.put((("/g", 0, 0, 0), 0, "c", i),
                         np.zeros(8192, np.uint8), None, 0, 1)
    assert _resident("cache.page") < 64 << 10
    assert _counter("ledger.pressure_evictions") > ev0


def test_the_reclaim_order_and_fraction_are_the_references():
    assert tledger.PRESSURE_EVICT_FRACTION == jledger.PRESSURE_EVICT_FRACTION
    assert tledger._MAX_RECLAIM_PASSES == jledger._MAX_RECLAIM_PASSES
    names = [f.__name__ for f in LEDGER._reclaimers]
    assert names[:4] == ["_reclaim_chunks", "_reclaim_pages",
                         "_reclaim_negs", "_reclaim_footers"]
    assert names[:4] == [f.__name__
                         for f in jledger.LEDGER._reclaimers][:4]


def test_the_hard_watermark_holds_an_admission_until_bytes_drop(
        monkeypatch):
    """Over the hard watermark every tier's admission waits, even with no
    budget set; it proceeds once the ledger's bytes fall under it, and
    the wait is the waiting op's."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_MEM_HARD", str(1 << 20))
    ballast = LEDGER.account("test.ballast")
    ballast.add(2 << 20)  # nothing can reclaim it
    gate = tpool.read_admission()
    done = threading.Event()
    got = {}

    def admit():
        with tobs.op_scope("t.admit") as op:
            with gate.admit(1024, tier="scan"):
                done.set()
        got["op"] = op

    t = threading.Thread(target=admit)
    try:
        assert LEDGER.state() == "hard"
        t.start()
        while gate.queue_depth() == 0 and t.is_alive():
            time.sleep(0.001)
        assert not done.is_set() and gate.queue_depth() == 1
    finally:
        ballast.sub(2 << 20)
        t.join(timeout=60)
    assert not t.is_alive() and done.is_set()
    assert LEDGER.state() == "ok"
    assert got["op"].counters()["read.admission_waits"] == 1


@pytest.mark.parametrize("state", ["ok", "hard", "soft"])
def test_healthz_reports_pressure_state(monkeypatch, state):
    """The port's ``/healthz`` answers what the reference's does under the
    same watermarks: ``ok``, then ``hard``, then ``soft``."""
    import http.server
    import urllib.request

    from parquet_tpu.obs import export as jexport

    before = threads_now()
    ballast = {"PARQUET_TPU_": jledger.LEDGER.account("test.ballast"),
               "PARQUET_TPU_TORCH_": LEDGER.account("test.ballast")}
    marks = {"ok": {}, "hard": {"MEM_HARD": 1 << 20},
             "soft": {"MEM_HARD": 1 << 40, "MEM_SOFT": 1 << 20}}[state]
    servers = {"PARQUET_TPU_": jexport.start_metrics_server(0),
               "PARQUET_TPU_TORCH_": tobs.start_metrics_server(0)}
    got = {}
    try:
        for prefix, acct in ballast.items():
            if state != "ok":
                acct.add(4 << 20)
            for knob, v in marks.items():
                monkeypatch.setenv(prefix + knob, str(v))
        for prefix, srv in servers.items():
            with urllib.request.urlopen(
                    f"http://{srv.host}:{srv.port}/healthz",
                    timeout=30) as r:
                got[prefix] = (r.status, r.headers["Content-Type"],
                               r.read())
    finally:
        for acct in ballast.values():
            if state != "ok":
                acct.sub(4 << 20)
        for srv in servers.values():
            srv.close()
        # the reference's request threads are daemon threads its close
        # does not join
        for t in threading.enumerate():
            owner = getattr(getattr(t, "_target", None), "__self__", None)
            if t not in before and \
                    type(owner) is http.server.ThreadingHTTPServer:
                t.join(30)
    assert got["PARQUET_TPU_TORCH_"] == got["PARQUET_TPU_"]
    assert got["PARQUET_TPU_TORCH_"] == (
        200, "text/plain; charset=utf-8", (state + "\n").encode())


# ------------------------------------------------- compaction errors

def test_a_failed_compaction_is_counted_beside_its_error(tmp_path,
                                                        monkeypatch):
    from parquet_tpu_torch import dataset_writer as tdw

    schema = pqt.message("t", [pqt.leaf("k", _t().INT64)])
    with pqt.DatasetWriter(str(tmp_path / "c"), schema) as w:
        for i in range(4):
            w.write({"k": pqt.ColumnData(values=np.arange(10) + i)}, 10)
            w.flush()
            w.commit()
    tried = threading.Event()

    def boom(*a, **k):
        tried.set()
        raise OSError("merge failed")

    monkeypatch.setattr(tdw, "compact_table", boom)
    before = _counter("table.compaction_errors")
    c = tdw.BackgroundCompactor(str(tmp_path / "c"), interval_s=0.001,
                                min_files=2, device=CPU)
    try:
        assert tried.wait(timeout=60)
    finally:
        c.close()
    assert _counter("table.compaction_errors") > before
    assert isinstance(c.last_error, OSError)
