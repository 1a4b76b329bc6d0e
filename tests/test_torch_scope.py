"""parquet_tpu_torch's per-operation scopes (``obs/scope.py``), against
parquet_tpu's where the two share a rule, on the CPU.

An op's report counts exactly its own work: the per-op sums equal the
global delta under 8 threads, and through every worker pool the read runs
on (the shared pool, the pipelined read's prepare workers, a lone chunk's
page-batch workers, the sharded read's workers and the host scan's
private pool), each of which runs its tasks in a copy of the caller's
context.  Head sampling keeps one op in each block of N, tail capture
keeps the slow ones, and the slow log writes one line an op.  The routed
scan hands the pool's measured wait to the route history.  No test
asserts a wall-clock bound; a test that needs a thread to block waits on
an event or on the pool's queue, and every test leaves no thread
running.
"""

import json
import random
import threading
import time

import numpy as np
import pytest

import parquet_tpu
from parquet_tpu import obs as jobs
from parquet_tpu.obs import scope as jscope

import parquet_tpu_torch as pqt
from parquet_tpu_torch import obs as tobs
from parquet_tpu_torch.io import planner as tplanner
from parquet_tpu_torch.io.prefetch import PrefetchSource, ReadStats
from parquet_tpu_torch.io.sink import WriteStats
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.obs import scope as tscope
from parquet_tpu_torch.parallel import device_reader, host_scan, mesh
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = "cpu"
N_ROWS = 80_000
ROW_GROUP = 20_000


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    before = threads_now()
    for o in (tobs, jobs):
        o.disable_tracing()
        o.reset_trace()
    for knob in ("TRACE_SAMPLE", "SLOW_OP_S", "SLOW_LOG"):
        monkeypatch.delenv("PARQUET_TPU_TORCH_" + knob, raising=False)
    pqt.clear_caches()
    yield
    tobs.disable_tracing()
    tobs.reset_trace()
    assert_no_thread_started(before)


def _write(path, n=N_ROWS, row_group=ROW_GROUP, seed=0, **opts):
    rng = np.random.default_rng(seed)
    cols = {"a": np.arange(n, dtype=np.int64), "b": rng.random(n),
            "c": rng.integers(0, 50, n).astype(np.int32)}
    pqt.write_table(cols, str(path), pqt.WriterOptions(
        row_group_size=row_group, **opts))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scope")
    return {"main": _write(d / "main.parquet"),
            # one row group of many small pages: a lone chunk's read is
            # pipelined over its page batches
            "paged": _write(d / "paged.parquet", n=40_000, row_group=40_000,
                            data_page_size=4096),
            "parts": [_write(d / f"part{i}.parquet", n=20_000,
                             row_group=5_000, seed=i) for i in range(4)]}


def _global(fn):
    before = tobs.metrics_snapshot()
    out = fn()
    delta = tobs.metrics_delta(before, tobs.metrics_snapshot())["counters"]
    return out, delta


# ------------------------------------------------------------ the scope

def test_the_report_has_the_reference_keys():
    with tobs.op_scope("t.shape", user="u") as op:
        tscope.account(tmetrics.counter("read.bytes_read"), 10)
        tscope.add_to_current("pool.queue_wait_s", 0.5)
    with jobs.op_scope("t.shape", user="u") as jop:
        jscope.account(jobs.metrics.counter("read.bytes_read"), 10)
        jscope.add_to_current("pool.queue_wait_s", 0.5)
    rep, jrep = op.report(), jop.report()
    assert set(rep) == set(jrep)
    for k in ("bytes_read", "pool_wait_s", "attrs", "sampled", "routes"):
        assert rep[k] == jrep[k], k
    assert rep["duration_s"] is not None and op.duration_s is not None
    assert set(op.metrics_delta()) == {"counters", "gauges", "histograms"}


def test_maybe_op_scope_joins_the_ambient_op():
    with tobs.op_scope("t.outer") as outer:
        with tscope.maybe_op_scope("t.inner") as got:
            assert got is outer
            assert tobs.current_op() is outer
    assert tobs.current_op() is None
    with tscope.maybe_op_scope("t.own") as own:
        assert isinstance(own, tobs.OpScope) and own.name == "t.own"


def test_a_nested_op_takes_over_for_its_extent():
    c = tmetrics.counter("test.nested")
    with tobs.op_scope("t.outer") as outer:
        tscope.account(c, 1)
        with tobs.op_scope("t.inner") as inner:
            tscope.account(c, 5)
        tscope.account(c, 2)
    assert outer.counters()["test.nested"] == 3
    assert inner.counters()["test.nested"] == 5


def test_live_ops_shows_the_open_op_until_it_finishes():
    with tobs.op_scope("t.live", who="me") as op:
        got = [o for o in tscope.live_ops() if o["op"] == op.op_id]
        assert got and got[0]["attrs"] == {"who": "me"}
    assert not [o for o in tscope.live_ops() if o["op"] == op.op_id]


@pytest.mark.parametrize("surface", ["read", "scan", "lookup", "aggregate",
                                     "drain", "verify"])
def test_each_public_surface_attributes_to_the_callers_op(files, surface):
    path = files["main"]

    def run():
        with pqt.ParquetFile(path) as pf:
            if surface == "read":
                pf.read(device=CPU)
            elif surface == "scan":
                pqt.scan_filtered(pf, "a", lo=100, hi=50_000, columns=["b"],
                                  device=CPU)
            elif surface == "lookup":
                pf.find_rows("a", [3, 40_000, 10**9], columns=["c"],
                             device=CPU)
            elif surface == "aggregate":
                pf.aggregate([pqt.sum_("b")],
                             where=pqt.col("a").between(0, 30_000),
                             device=CPU)
            else:
                for _ in pf.iter_batches(batch_rows=15_000, device=CPU):
                    pass
        if surface == "verify":
            pqt.verify_file(path, decode=True, device=CPU)

    with tobs.op_scope("t.caller") as op:
        _, delta = _global(run)
    mine = op.counters()
    assert delta["read.bytes_read"] > 0
    assert mine["read.bytes_read"] == delta["read.bytes_read"]
    for k, v in delta.items():
        if not k.startswith(("span.", "trace.", "ledger.")):
            assert mine.get(k) == v, k


def test_each_surface_opens_an_op_of_its_own(files):
    names = []
    orig = tscope.OpScope.__init__

    def spy(self, name, attrs=None):
        names.append(name)
        orig(self, name, attrs)

    pqt.clear_caches()
    path = files["main"]
    try:
        tscope.OpScope.__init__ = spy
        with pqt.ParquetFile(path) as pf:
            pf.read(device=CPU)
            pqt.scan_filtered(pf, "a", lo=1, hi=2, device=CPU)
            pqt.scan(pf, "a", lo=1, hi=2, device=CPU)
            pf.find_rows("a", [1], device=CPU)
            pf.aggregate([pqt.count()], device=CPU)
            list(pf.iter_batches(device=CPU))
        with pqt.Dataset(files["parts"]) as ds:
            ds.read(device=CPU)
            ds.scan("a", lo=1, hi=2, device=CPU)
            ds.prune("a", lo=1, hi=2)
            ds.find_rows("a", [1], device=CPU)
            ds.aggregate([pqt.count()], device=CPU)
            list(ds.iter_batches(device=CPU))
        pqt.verify_file(path)
    finally:
        tscope.OpScope.__init__ = orig
    assert names == [
        "file.read", "file.scan", "file.scan", "lookup.find_rows",
        "file.aggregate", "file.iter_batches", "dataset.read",
        "dataset.scan", "dataset.prune", "dataset.find_rows",
        "dataset.aggregate", "dataset.iter_batches", "verify.file"]


# ------------------------------------------------- concurrency, exactly

def test_two_concurrent_ops_sum_to_the_global_delta(files):
    reports = {}

    def lookup():
        with tobs.op_scope("t.lookup") as op:
            with pqt.ParquetFile(files["main"]) as pf:
                pf.find_rows("a", np.arange(0, N_ROWS, 7), device=CPU)
        reports["lookup"] = op.report()

    def scan():
        with tobs.op_scope("t.scan") as op:
            with pqt.Dataset(files["parts"]) as ds:
                ds.scan("a", lo=10, hi=15_000, device=CPU)
        reports["scan"] = op.report()

    def both():
        ts = [threading.Thread(target=lookup), threading.Thread(target=scan)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    _, delta = _global(both)
    assert reports["lookup"]["bytes_read"] > 0
    assert reports["scan"]["bytes_read"] > 0
    assert (reports["lookup"]["bytes_read"] + reports["scan"]["bytes_read"]
            == delta["read.bytes_read"])


def test_eight_threads_of_ops_sum_to_the_global_delta(files):
    ops = []
    lock = threading.Lock()
    start = threading.Barrier(8)

    def worker(i):
        start.wait(timeout=60)
        with tobs.op_scope("t.worker", i=i) as op:
            with pqt.ParquetFile(files["parts"][i % 4]) as pf:
                if i % 2:
                    pf.read(device=CPU)
                else:
                    pqt.scan_filtered(pf, "a", lo=0, hi=9_000, device=CPU)
        with lock:
            ops.append(op)

    def run():
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    pqt.clear_caches()
    _, delta = _global(run)
    for key in ("read.bytes_read", "cache.footer_misses", "planner.rg_considered",
                "scan.rows_decoded"):
        assert sum(op.counters().get(key, 0) for op in ops) == delta[key], key


def _op_track(op_events, op):
    return {e["pid"] for e in op_events if e.get("name") == "op." + op.name}


@pytest.mark.parametrize("route", ["pipelined", "page_batches", "sharded",
                                   "scan_private_pool", "dataset"])
def test_every_worker_pool_runs_its_tasks_in_the_callers_op(files, route,
                                                            monkeypatch):
    """The read's own worker pools copy the caller's context into each
    task: the bytes their preads read, the tasks they ran and the spans
    they recorded belong to the caller's op.  Without the copy a worker's
    pread counts in the global total only, and its spans land on no op's
    track."""
    monkeypatch.setattr(device_reader.host, "available_cpus", lambda: 8)
    tobs.enable_tracing()

    def run():
        if route == "pipelined":
            with pqt.ParquetFile(files["main"]) as pf:
                pf.read(device=CPU)
        elif route == "page_batches":
            with pqt.ParquetFile(files["paged"]) as pf:
                pf.read(columns=["b"], device=CPU)
        elif route == "sharded":
            mesh.read_table_sharded(files["main"], mesh=[CPU] * 2)
        elif route == "scan_private_pool":
            with pqt.ParquetFile(files["main"]) as pf:
                pqt.scan_filtered(pf, "a", lo=0, hi=70_000, device=CPU,
                                  num_threads=4)
        else:
            with pqt.Dataset(files["parts"]) as ds:
                ds.read(device=[CPU] * 2)

    with tobs.op_scope("t.route") as op:
        _, delta = _global(run)
    tobs.disable_tracing()
    mine = op.counters()
    assert delta["read.bytes_read"] > 0
    assert mine["read.bytes_read"] == delta["read.bytes_read"]
    assert mine.get("pool.tasks", 0) == delta["pool.tasks"] > 0
    evs = tobs.trace_events()
    track = _op_track(evs, op)
    tasks = [e for e in evs if e.get("name") == "pool.task"]
    assert tasks and {e["pid"] for e in tasks} == track
    main = threading.get_ident()
    assert any(e["tid"] != main for e in tasks)


def test_the_pool_wait_of_a_task_is_its_ops(files):
    with tobs.op_scope("t.wait") as op:
        tpool.submit(lambda: None).result(timeout=60)
    assert op.report()["pool_wait_s"] > 0
    assert op.counters()["pool.tasks"] == 1


def test_a_drain_counts_only_its_own_pulls(files):
    with pqt.ParquetFile(files["main"]) as pf:
        it = pf.iter_batches(batch_rows=ROW_GROUP, device=CPU)
        next(it)
        drain = tobs.current_op()
        assert drain is None  # the drain's op is active only in a pull
        with tobs.op_scope("t.between") as between:
            with pqt.ParquetFile(files["parts"][0]) as other:
                other.read(device=CPU)
        for _ in it:
            pass
    assert between.counters()["read.bytes_read"] > 0


def test_an_early_closed_drain_publishes_into_its_own_op(files, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH", "ring")
    seen = []
    orig = ReadStats.publish

    def spy(self):
        seen.append(tobs.current_op())
        orig(self)

    monkeypatch.setattr(ReadStats, "publish", spy)
    with pqt.ParquetFile(files["main"]) as pf:
        it = pf.iter_batches(batch_rows=ROW_GROUP, device=CPU)
        next(it)
        with tobs.op_scope("t.consumer") as consumer:
            it.close()
    assert seen and seen[0] is not None and seen[0] is not consumer
    assert seen[0].name == "file.iter_batches"


# ------------------------------------------------------------- sampling

def test_head_sampling_keeps_one_op_in_each_block(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_TRACE_SAMPLE", "8")
    c = tobs.metrics_snapshot()
    tobs.enable_tracing()
    ops = []
    for i in range(16):
        with tobs.op_scope("t.sampled", i=i) as op:
            with tobs.trace_span("t.stage"):
                pass
        ops.append(op)
    tobs.disable_tracing()
    d = tobs.metrics_delta(c, tobs.metrics_snapshot())["counters"]
    assert d["trace.ops_sampled"] == 2 and d["trace.ops_skipped"] == 14
    kept = [op for op in ops if op.sampled]
    assert [sum(op.sampled for op in ops[:8]),
            sum(op.sampled for op in ops[8:])] == [1, 1]
    evs = tobs.trace_events()
    stage_pids = {e["pid"] for e in evs if e.get("name") == "t.stage"}
    assert stage_pids == {tscope._OP_PID_BASE + op.op_id for op in kept}


def test_the_sampler_is_the_references(monkeypatch):
    """The same random draws give the same decisions in both packages."""
    for mod in (tscope, jscope):
        mod._SAMPLE_N = None
    state = random.getstate()
    port = [tscope._head_sampled(4) for _ in range(12)]
    random.setstate(state)
    ref = [jscope._head_sampled(4) for _ in range(12)]
    assert port == ref and sum(port) == 3


def test_tail_capture_promotes_a_slow_unsampled_op(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_TRACE_SAMPLE", "1000")
    monkeypatch.setenv("PARQUET_TPU_TORCH_SLOW_OP_S", "0")
    monkeypatch.setattr(tscope, "_head_sampled", lambda n: False)
    tobs.enable_tracing()
    with tobs.op_scope("t.slow") as op:
        with tobs.trace_span("t.stage"):
            pass
    tobs.disable_tracing()
    assert op.sampled is False
    names = {e["name"] for e in tobs.trace_events()}
    assert {"t.stage", "op.t.slow"} <= names


def test_a_fast_unsampled_op_leaves_no_spans(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_TRACE_SAMPLE", "1000")
    monkeypatch.setattr(tscope, "_head_sampled", lambda n: False)
    tobs.enable_tracing()
    with tobs.op_scope("t.fast"):
        with tobs.trace_span("t.stage"):
            pass
    tobs.disable_tracing()
    assert tobs.trace_events() == []


def test_the_slow_log_writes_one_line_an_op(tmp_path, monkeypatch, files):
    log = tmp_path / "slow.jsonl"
    monkeypatch.setenv("PARQUET_TPU_TORCH_SLOW_OP_S", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_SLOW_LOG", str(log))
    with pqt.ParquetFile(files["main"]) as pf:
        pf.read(device=CPU)
        pf.find_rows("a", [5], device=CPU)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["name"] for r in recs] == ["file.read", "lookup.find_rows"]
    assert recs[0]["report"]["read.bytes_read"] > 0
    assert recs[1]["report"]["lookup.keys"] == 1
    assert set(recs[0]) == {"ts", "op", "name", "attrs", "duration_s",
                            "stages", "report"}


# ------------------------------------------------- publish exactly once

def test_read_and_write_stats_publish_once():
    rs = ReadStats(prefetch_hits=3)
    ws = WriteStats(row_groups=2)
    before = tobs.metrics_snapshot()["counters"]
    for _ in range(2):
        rs.publish()
        ws.publish()
    after = tobs.metrics_snapshot()["counters"]
    assert after["prefetch.hits"] - before["prefetch.hits"] == 3
    assert after["write.row_groups"] - before["write.row_groups"] == 2


def test_a_prefetcher_closed_twice_publishes_once(files, monkeypatch):
    from parquet_tpu_torch.io.source import as_source

    calls = []
    monkeypatch.setattr(ReadStats, "publish",
                        lambda self: calls.append(self))
    src = as_source(files["main"])
    pre = PrefetchSource(src, backend="ring")
    pre.plan(0, 4096)
    pre.pread(0, 4096)
    pre.close()
    pre.close()
    src.close()
    assert len(calls) == 1


def test_a_writer_is_one_op_and_publishes_once(tmp_path):
    cols = {"a": np.arange(10_000, dtype=np.int64)}
    tobs.enable_tracing()
    before = tobs.metrics_snapshot()["counters"]
    w = pqt.ParquetWriter(str(tmp_path / "w.parquet"), _schema(),
                          pqt.WriterOptions(row_group_size=2_500))
    w.write({"a": pqt.ColumnData(values=cols["a"])}, 10_000)
    w.flush()
    w.close()
    w.close()
    tobs.disable_tracing()
    after = tobs.metrics_snapshot()["counters"]
    assert after["write.row_groups"] - before["write.row_groups"] == 4
    ops = [e for e in tobs.trace_events() if e["name"] == "op.write.file"]
    assert len(ops) == 1
    assert ops[0]["args"]["op"] == w._op.op_id
    assert w._op.counters()["write.row_groups"] == 4


def _schema():
    from parquet_tpu_torch.format.enums import Type

    return pqt.message("t", [pqt.leaf("a", Type.INT64)])


def test_a_failed_writer_close_finishes_its_op(tmp_path, monkeypatch):
    from parquet_tpu_torch.io import writer as twriter

    w = pqt.ParquetWriter(str(tmp_path / "f.parquet"), _schema())
    w.write({"a": pqt.ColumnData(values=np.arange(10, dtype=np.int64))}, 10)
    op = w._op

    def boom(self):
        raise OSError("disk gone")

    monkeypatch.setattr(twriter.ParquetWriter, "_write_blooms_and_page_index",
                        boom)
    with pytest.raises(OSError):
        w.close()
    assert op._finished
    assert not [o for o in tscope.live_ops() if o["op"] == op.op_id]


# ------------------------------------------- admission, and the routed scan

def test_an_admission_wait_is_the_waiting_ops(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "1000")
    gate = tpool.lookup_admission()
    held = gate.acquire(1000)
    got = {}

    def waiter():
        with tobs.op_scope("t.waiter") as op:
            g = gate.acquire(500)
            gate.release(g)
        got["op"] = op

    t = threading.Thread(target=waiter)
    t.start()
    while gate.queue_depth() == 0:
        time.sleep(0.001)
    gate.release(held)
    t.join(timeout=60)
    assert not t.is_alive()
    c = got["op"].counters()
    assert c["lookup.admission_waits"] == 1
    assert c["lookup.admission_wait_s"] > 0


def test_the_routed_scan_feeds_the_pools_wait_to_the_history(files,
                                                            monkeypatch):
    """Under a loaded shared pool, the host scan's tasks queue; the
    routed scan hands that wait (``pool_wait_seconds`` over the scan) to
    ``RouteHistory.observe``."""
    monkeypatch.setattr(host_scan, "_POOL_MIN_CELLS", 0)
    monkeypatch.setattr(tpool, "available_cpus", lambda: 8)
    seen = []
    monkeypatch.setattr(tplanner._HISTORY, "observe",
                        lambda route, nbytes, seconds, pool_wait_s=0.0,
                        mesh_size=1: seen.append((route, pool_wait_s)))
    release = threading.Event()
    blockers = [tpool.shared_pool().submit(release.wait, 60)
                for _ in range(tpool.pool_width())]
    result = {}

    def scan():
        with pqt.ParquetFile(files["main"]) as pf:
            result["got"] = pqt.scan(pf, "a", lo=0, hi=70_000,
                                     columns=["b", "c"], device=CPU)

    t = threading.Thread(target=scan)
    t.start()
    try:
        pool = tpool.shared_pool()
        while pool._work_queue.qsize() == 0 and t.is_alive():
            time.sleep(0.001)
    finally:
        release.set()
        for b in blockers:
            b.result(timeout=60)
        t.join(timeout=120)
    assert not t.is_alive() and len(result["got"]["b"]) == 70_001
    assert seen and seen[0][0] == "host" and seen[0][1] > 0
