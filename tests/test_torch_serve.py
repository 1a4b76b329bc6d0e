"""parquet_tpu_torch's serving daemon (``serve/``), its tenants on the
admission gate (``utils/pool.py``) and its page pins (``io/cache.py``)
against parquet_tpu's, on the CPU.

Each test is the counterpart of one test of ``tests/test_serve.py``: the
same config, codec and scheduler calls go to both packages, and the same
requests to both daemons over loopback HTTP, on the same files (the
port's with ``device="cpu"``; each daemon is the only one of its package
in the process).  JSON bodies compare as parsed JSON (float aggregates to
``rel=1e-9``), JSON scan lines byte for byte, Arrow streams as tables,
and status codes and the ``Retry-After``, ``WWW-Authenticate`` and
``X-Next-Page-Token`` headers exactly.  The scheduler's tests drive the
same acquire/release script through both packages' ``AdmissionController``
and compare the order of the grants: a waiter is seen queued through
``queue_depth()``, never a sleep, and the QPS gate runs on a clock the
test holds still.  No test asserts a wall-clock bound, and none leaves a
thread running.  The fleet's tests (``cluster.py``, the peer chaos hook)
are in ``tests/test_torch_fleet.py``.
"""

import gzip
import http.client
import http.server
import io
import json
import math
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pyarrow as pa
import pytest

import parquet_tpu as jpq
from parquet_tpu.errors import RemoteTransientError as JRemoteTransient
from parquet_tpu.io import cache as jcache
from parquet_tpu.io.remote import gunzip_body as jgunzip
from parquet_tpu.obs import ledger as jledger
from parquet_tpu.obs import metrics as jmetrics
from parquet_tpu.serve import codecs as jcodecs
from parquet_tpu.serve import config as jconfig
from parquet_tpu.serve import server as jserver
from parquet_tpu.utils import pool as jpool

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import RemoteTransientError as TRemoteTransient
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.io.remote import gunzip_body as tgunzip
from parquet_tpu_torch.obs import ledger as tledger
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.serve import codecs as tcodecs
from parquet_tpu_torch.serve import config as tconfig
from parquet_tpu_torch.serve import server as tserver
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started, new_threads,
                                    start_shared_pools, threads_now)

CPU = "cpu"
JOIN_S = 30.0  # a liveness bound for joins and polls, never asserted on
PKGS = ("ref", "port")
POOL = {"ref": jpool, "port": tpool}
CACHE = {"ref": jcache, "port": tcache}
LEDGERS = {"ref": jledger.LEDGER, "port": tledger.LEDGER}
METRICS = {"ref": jmetrics, "port": tmetrics}
CONFIG = {"ref": jconfig, "port": tconfig}
CODECS = {"ref": jcodecs, "port": tcodecs}
KNOB = {"ref": "PARQUET_TPU_", "port": "PARQUET_TPU_TORCH_"}


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


def _reset_state():
    for name in PKGS:
        CACHE[name].clear_caches(reset_stats=True)
        adm = POOL[name].read_admission()
        adm.clear_tenants()
        adm._reset()


def _join_reference_threads(before) -> None:
    """The reference daemon's connection threads are daemon threads that
    its ``close`` does not join; wait for them to end.  The port's are
    joined by its ``close`` and are left to the thread check."""
    for t in new_threads(before):
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if type(owner) is http.server.ThreadingHTTPServer:
            t.join(JOIN_S)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    before = threads_now()
    for name in PKGS:
        for knob in ("MEM_SOFT", "MEM_HARD", "READ_BUDGET",
                     "LOOKUP_BUDGET", "SCAN_BUDGET"):
            monkeypatch.delenv(KNOB[name] + knob, raising=False)
    _reset_state()
    yield
    _reset_state()
    _join_reference_threads(before)
    assert_no_thread_started(before)


def _wait_until(pred, what: str) -> None:
    pause = threading.Event()
    for _ in range(int(JOIN_S * 1000)):
        if pred():
            return
        pause.wait(0.001)
    raise AssertionError(f"not reached: {what}")


# ---------------------------------------------------------------------------
# the corpus: two read files, a writable table (one copy a daemon)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("serve_corpus")
    rng = np.random.default_rng(7)
    paths = []
    for fi in range(2):
        n = 4000
        base = fi * 100_000
        p = str(td / f"f{fi}.parquet")
        v = (np.arange(n, dtype=np.int64) * 3) % 1000
        jpq.write_table(
            pa.table({"k": np.arange(base, base + n, dtype=np.int64),
                      "v": v,
                      "s": [f"s{i % 97}" for i in range(n)],
                      "f": pa.array(rng.random(n),
                                    mask=rng.random(n) < 0.05)}),
            p, options=jpq.WriterOptions(row_group_size=800))
        paths.append(p)
    tdir = str(td / "tbl")
    seed = pa.table({"k": np.arange(10, dtype=np.int64),
                     "v": np.arange(10, dtype=np.int64)})
    w = jpq.DatasetWriter(tdir, jpq.schema_from_arrow(seed.schema),
                          sorting=[jpq.SortingColumn("k")])
    w.write_arrow(seed)
    w.commit()
    w.close()
    return {"paths": paths, "table": tdir}


@pytest.fixture
def tables(corpus, tmp_path):
    """A copy of the seeded table for each daemon: their writes must not
    meet."""
    out = {}
    for name in PKGS:
        dst = str(tmp_path / f"tbl_{name}")
        shutil.copytree(corpus["table"], dst)
        out[name] = dst
    return out


def _config(corpus, table=None, **tenants) -> dict:
    return {"datasets": {"events": {"paths": corpus["paths"]},
                         "tbl": {"table": table or corpus["table"],
                                 "writable": True, "sorting": "k"}},
            "tenants": tenants}


def _start(name, cfg, **kw):
    if name == "ref":
        return jserver.Server(cfg, port=0, **kw)
    return tserver.Server(cfg, port=0, device=CPU, **kw)


@contextmanager
def both(corpus, tables=None, **tenants):
    """Both daemons over the same files (each its own table copy)."""
    srv = {}
    try:
        for name in PKGS:
            srv[name] = _start(name, _config(
                corpus, tables[name] if tables else None, **tenants))
        yield srv
    finally:
        for name in reversed(PKGS):
            if name in srv:
                srv[name].close()


def _call(srv, path, doc=None, tenant="default", headers=None, raw=None):
    """``(status, body, headers)`` of a POST (``doc``/``raw``) or a GET."""
    hdrs = {"X-Tenant": tenant}
    hdrs.update(headers or {})
    data = raw if raw is not None else (
        json.dumps(doc).encode() if doc is not None else None)
    req = urllib.request.Request(srv.url + path, data=data, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=JOIN_S) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read(), dict(e.headers)


_HEADERS = ("Retry-After", "WWW-Authenticate", "X-Next-Page-Token",
            "Content-Encoding", "Content-Type", "Connection")


def _approx(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == pytest.approx(b, rel=1e-9, abs=0.0)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_approx(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_approx(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def same(got: dict, kind: str = "json"):
    """The port's response equals the reference's: status, the headers
    that carry meaning, and the body (``json`` parsed, ``aggregate``
    parsed with float aggregates to 1e-9, ``lines``/``raw`` byte for byte,
    ``arrow`` as tables).  Returns the reference's parsed body."""
    (js, jb, jh), (ts, tb, th) = got["ref"], got["port"]
    assert ts == js, (ts, js, tb, jb)
    for h in _HEADERS:
        assert th.get(h) == jh.get(h), (h, th.get(h), jh.get(h))
    if kind in ("lines", "raw"):
        assert tb == jb
        return jb
    if kind == "arrow":
        tt = pa.ipc.open_stream(io.BytesIO(tb)).read_all().combine_chunks()
        jt = pa.ipc.open_stream(io.BytesIO(jb)).read_all().combine_chunks()
        assert tt.equals(jt), (tt.schema, jt.schema)
        return jt
    jd, td = json.loads(jb), json.loads(tb)
    if kind == "aggregate" and js == 200:
        assert td.keys() == jd.keys()
        assert _approx(td["aggregates"], jd["aggregates"]), (td, jd)
        assert {k: v for k, v in td.items() if k != "aggregates"} == \
            {k: v for k, v in jd.items() if k != "aggregates"}
    else:
        assert td == jd, (td, jd)
    return jd


def call_both(srv, path, doc=None, **kw) -> dict:
    return {name: _call(srv[name], path, doc, **kw) for name in PKGS}


# ---------------------------------------------------------------------------
# config and codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, 123, 2.5, "64MiB", "1kb", "2GiB",
                                   " 3 MB ", "7", "lots", True, "1.5x"])
def test_parse_bytes(value):
    got = {}
    for name in PKGS:
        try:
            got[name] = CONFIG[name].parse_bytes(value)
        except ValueError as e:
            got[name] = ("ValueError", type(e).__name__)
    assert got["port"] == got["ref"]


def _config_outcome(name, doc):
    """The parsed config's meaningful fields, or its error's class."""
    try:
        cfg = CONFIG[name].ServeConfig.from_dict(doc)
    except ValueError as e:
        return ("ValueError", str(e))
    tenants = {n: (t.name, t.budget_bytes, t.weight, t.klass, t.qps, t.burst)
               for n, t in cfg.tenants.items()}
    datasets = {n: (d.paths, d.table, d.writable, d.sorting,
                    d.rows_per_file) for n, d in cfg.datasets.items()}
    cluster = None if cfg.cluster is None else (cfg.cluster.self_name,
                                                cfg.cluster.peers)
    return (cfg.host, cfg.port, datasets, tenants, cfg.pin_bytes,
            cfg.tokens, cfg.compact_interval_s, cluster,
            [cfg.klass_for(t, e) for t in ("online", "anon", None)
             for e in ("lookup", "scan", "aggregate", "write", "other")])


def test_config_validation(corpus):
    docs = [
        _config(corpus, online={"class": "latency", "budget_bytes": "1MiB",
                                "weight": 2.0, "pin_bytes": 4096}),
        {"datasets": {}},
        {"datasets": {"x": {"paths": ["p"], "table": "t"}}},
        {"datasets": {"x": {"paths": ["p"]}},
         "tenants": {"t": {"class": "vip"}}},
        {"datasets": {"x": {"paths": ["p"]}}, "nope": 1},
        {"datasets": {"x": {"paths": "p", "writable": True}}},
        {"datasets": {"x": {"table": "t", "writable": True}},
         "host": "0.0.0.0", "port": 9, "compact_interval_s": 2},
        [1, 2],
    ]
    for doc in docs:
        assert _config_outcome("port", doc) == _config_outcome("ref", doc)
    cfg = tconfig.ServeConfig.from_dict(docs[0])
    assert cfg.klass_for("online", "scan") == "latency"
    assert cfg.klass_for("anon", "scan") == "bulk"
    assert cfg.klass_for("anon", "lookup") == "latency"


def test_load_config_file(corpus, tmp_path):
    p = tmp_path / "serve.json"
    p.write_text(json.dumps(_config(corpus, online={"class": "latency"})))
    got = {name: CONFIG[name].load_config(str(p)) for name in PKGS}
    assert set(got["port"].datasets) == set(got["ref"].datasets) \
        == {"events", "tbl"}
    assert got["port"].tenants["online"].klass == "latency"
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    for name in PKGS:
        with pytest.raises(ValueError, match="not valid JSON"):
            CONFIG[name].load_config(str(bad))


WIRE_TREES = [
    None,
    {"and": [{"col": "v", "ge": 1, "le": 5},
             {"not": {"col": "s", "in": ["a"]}},
             {"or": [{"col": "k", "eq": 7}, {"col": "k", "null": False}]}]},
    {"col": "v", "ge": 10},
    {"col": "v", "le": 10},
    {"col": "s", "null": True},
    {"or": [{"col": "s", "eq": "s1"}, {"col": "s", "in": ["s2", "s3"]}]},
    {"col": "v", "eq": 1, "le": 5},
    {"ge": 1},
    {"col": "v", "gt": 1},
    {"and": []},
    {"col": "s", "in": []},
    {"col": "s", "null": True, "eq": 1},
    [1],
]


def _wire_outcome(name, node):
    try:
        e = CODECS[name].expr_from_wire(node)
    except ValueError as err:
        return ("ValueError", str(err))
    return repr(e)


@pytest.mark.parametrize("node", WIRE_TREES, ids=range(len(WIRE_TREES)))
def test_expr_from_wire_forms(corpus, node):
    got = {name: _wire_outcome(name, node) for name in PKGS}
    assert got["port"] == got["ref"]
    if isinstance(got["ref"], str) and node is not None:
        # the same rows match the same tree in both packages
        with jpq.ParquetFile(corpus["paths"][0]) as jf, \
                pqt.ParquetFile(corpus["paths"][0]) as tf:
            want = jpq.scan_expr(jf, jcodecs.expr_from_wire(node),
                                 columns=["k"])["k"]
            have = pqt.scan_expr(tf, tcodecs.expr_from_wire(node),
                                 columns=["k"], device=CPU)["k"]
        assert np.array_equal(np.asarray(have), np.asarray(want))


AGG_SPECS = ["count", "count:v", "min:v", "max:v", "sum:v", "sum_sq:v",
             "avg:v", "var:v", "var:v:sample", "variance:v", "distinct:v",
             "top:v:3", "avg", "sum:", "top:v", "top:v:x", "median:v", ""]


@pytest.mark.parametrize("spec", AGG_SPECS)
def test_parse_agg_spec(spec):
    got = {}
    for name in PKGS:
        try:
            got[name] = CODECS[name].parse_agg_spec(spec).name
        except ValueError as e:
            got[name] = ("ValueError", str(e))
    assert got["port"] == got["ref"]


def test_parse_aggs_refuses_an_empty_list():
    for name in PKGS:
        with pytest.raises(ValueError, match="at least one"):
            CODECS[name].parse_aggs([])
    assert [a.name for a in tcodecs.parse_aggs(["count", "sum:v"])] == \
        [a.name for a in jcodecs.parse_aggs(["count", "sum:v"])]


# ---------------------------------------------------------------------------
# the scheduler: one script, both packages' gates, the same grant order
# ---------------------------------------------------------------------------


class _Gate:
    """One package's ``AdmissionController`` under a script: ``hold`` takes
    a grant on the test's thread (it must not block), ``wait`` starts a
    waiter thread and returns once its ticket is queued (or granted),
    ``release`` and ``let_go`` hand a grant back, and ``granted`` lists
    the grants in the order the gate decided them (recorded under its
    lock, on the thread whose ticket it granted)."""

    def __init__(self, name: str):
        self.pool = POOL[name]
        self.adm = self.pool.AdmissionController()
        self.order = []
        self.grants = {}
        self._names = {}  # thread -> the name of its ticket
        self._go = {}
        self._threads = {}
        real = self.adm._may_grant_locked

        def spy(ticket, *a):
            ok = real(ticket, *a)
            if ok:
                self.order.append(self._names[threading.current_thread()])
            return ok

        self.adm._may_grant_locked = spy

    def _acquire(self, tenant, klass, nbytes, tier):
        if tenant is None:
            return self.adm.acquire(nbytes, tier=tier)
        with self.pool.tenant_context(tenant, klass):
            return self.adm.acquire(nbytes, tier=tier)

    def hold(self, name, tenant, klass, nbytes, tier="scan"):
        self._names[threading.current_thread()] = name
        n = len(self.order)
        g = self._acquire(tenant, klass, nbytes, tier)
        if name not in self.order[n:]:  # granted without a walk
            self.order.append(name)
        self.grants[name] = (g, tier, tenant)

    def wait(self, name, tenant, klass, nbytes, tier="scan"):
        go = self._go[name] = threading.Event()
        queued = self.adm.queue_depth()

        def run():
            self.grants[name] = (self._acquire(tenant, klass, nbytes, tier),
                                 tier, tenant)
            go.wait(JOIN_S)
            self.release(name)

        t = self._threads[name] = threading.Thread(target=run)
        self._names[t] = name
        t.start()
        _wait_until(lambda: self.adm.queue_depth() > queued
                    or name in self.grants, f"{name} queued")

    def release(self, name):
        g, tier, tenant = self.grants.pop(name)
        self.adm.release(g, tier=tier, tenant=tenant)

    def let_go(self, name):
        self._go[name].set()
        self._threads[name].join(JOIN_S)

    def granted(self, expect: int) -> list:
        _wait_until(lambda: len(self.order) >= expect, f"{expect} grants")
        return list(self.order)

    def finish(self):
        for go in self._go.values():
            go.set()
        for t in self._threads.values():
            t.join(JOIN_S)


def _run(script, tenants=(), env=None, monkeypatch=None) -> dict:
    """Drive ``script`` (a function of one ``_Gate``) on both packages;
    returns each package's snapshots (whatever the script returns)."""
    out = {}
    for name in PKGS:
        if env:
            for k, v in env.items():
                monkeypatch.setenv(KNOB[name] + k, v)
        gate = _Gate(name)
        if tenants:
            gate.adm.configure_tenants(
                {t[0]: POOL[name].TenantSpec(*t[:1], **t[1])
                 for t in tenants})
        try:
            out[name] = script(gate)
        finally:
            gate.finish()
    return out


def test_tenant_budget_isolated_lanes():
    """A tenant blocked by its own budget never blocks another lane."""
    def script(g):
        g.hold("b0", "b", "bulk", 100)
        g.wait("b1", "b", "bulk", 50)
        steps = [g.adm.queue_depth()]
        # the latency lane passes the bulk lane's queued ticket
        g.hold("l0", "l", "latency", 80, tier="lookup")
        steps.append(dict(g.grants)["l0"][0])
        g.release("l0")
        steps.append(list(g.order))
        g.release("b0")
        steps.append(g.granted(3))
        g.let_go("b1")
        steps.append(dict(g.adm.tenant_high_water))
        return steps

    got = _run(script, tenants=[("b", {"budget_bytes": 100,
                                       "klass": "bulk"}),
                                ("l", {"budget_bytes": 100,
                                       "klass": "latency"})])
    assert got["port"] == got["ref"]
    assert got["port"][1] == 80
    assert got["port"][3] == ["b0", "l0", "b1"]
    assert got["port"][4] == {"b": 100, "l": 80}


def test_untagged_fifo_preserved(monkeypatch):
    """Untagged waiters keep strict FIFO: a small later arrival that would
    fit waits behind a large earlier one."""
    def script(g):
        g.hold("g0", None, None, 50, tier="lookup")
        g.wait("big", None, None, 96, tier="lookup")
        # 50 + 5 <= 100, yet it waits behind the earlier ticket
        g.wait("small", None, None, 5, tier="lookup")
        steps = [g.granted(1), g.adm.queue_depth()]
        g.release("g0")
        steps.append(g.granted(2))
        g.let_go("big")
        steps.append(g.granted(3))
        g.let_go("small")
        return steps

    got = _run(script, env={"LOOKUP_BUDGET": "100"},
               monkeypatch=monkeypatch)
    assert got["port"] == got["ref"]
    assert got["port"] == [["g0"], 2, ["g0", "big"],
                           ["g0", "big", "small"]]


def test_latency_class_scheduled_before_bulk(monkeypatch):
    """Under a shared budget a later latency ticket goes before an earlier
    bulk one."""
    def script(g):
        g.hold("b0", "b", "bulk", 100)
        g.wait("b1", "b", "bulk", 60)
        g.wait("l1", "l", "latency", 60, tier="lookup")
        g.release("b0")
        steps = [g.granted(2), g.adm.queue_depth()]
        g.let_go("l1")
        steps.append(g.granted(3))
        g.let_go("b1")
        return steps

    got = _run(script, tenants=[("b", {"klass": "bulk"}),
                                ("l", {"klass": "latency"})],
               env={"READ_BUDGET": "100"}, monkeypatch=monkeypatch)
    assert got["port"] == got["ref"]
    assert got["port"] == [["b0", "l1"], 1, ["b0", "l1", "b1"]]


def test_weighted_fairness_vtime():
    """Within a class the heavier tenant's virtual time grows slower."""
    def script(g):
        for i in range(4):
            g.hold(f"h{i}", "heavy", "default", 1000)
            g.release(f"h{i}")
            g.hold(f"l{i}", "light", "default", 1000)
            g.release(f"l{i}")
        return dict(g.adm._vtime), g.adm._vfloor

    got = _run(script, tenants=[
        ("heavy", {"weight": 4.0, "budget_bytes": 1 << 20}),
        ("light", {"weight": 1.0, "budget_bytes": 1 << 20})])
    assert got["port"] == got["ref"]
    vt, _ = got["port"]
    assert vt["heavy"] < vt["light"]


def test_tenant_debug_shape():
    for name in PKGS:
        adm = POOL[name].AdmissionController()
        adm.configure_tenants([POOL[name].TenantSpec(
            "a", budget_bytes=10, weight=2.0, klass="latency")])
        with pytest.raises(ValueError):
            adm.configure_tenants([POOL[name].TenantSpec("w", weight=0.0)])
        with pytest.raises(ValueError):
            adm.configure_tenants([POOL[name].TenantSpec("q", qps=-1.0)])
        with pytest.raises(ValueError):
            adm.configure_tenants([POOL[name].TenantSpec("u", burst=0.5)])
        with pytest.raises(TypeError):
            adm.configure_tenants(["nope"])
    dbg = {}
    for name in PKGS:
        adm = POOL[name].AdmissionController()
        adm.configure_tenants([POOL[name].TenantSpec(
            "a", budget_bytes=10, weight=2.0, klass="latency")])
        with POOL[name].tenant_context("a", "latency"):
            g = adm.acquire(8, tier="scan")
        with POOL[name].tenant_context("z", "bogus"):
            assert POOL[name].current_tenant() == ("z", "default")
            g2 = adm.acquire(3, tier="lookup")
        dbg[name] = adm.tenant_debug()
        adm.release(g, tier="scan", tenant="a")
        adm.release(g2, tier="lookup", tenant="z")
        assert adm.tenant_spec("a").klass == "latency"
        adm.clear_tenants()
        assert adm.tenant_debug() == {} and adm.tenant_spec("a") is None
    assert dbg["port"] == dbg["ref"]
    assert dbg["port"]["a"]["in_flight_bytes"] == 8
    assert dbg["port"]["a"]["budget_bytes"] == 10


# the starvation matrix: a bulk tenant saturating its lane, the shared
# budget or both, while latency tickets arrive behind its queued ones;
# every latency ticket is granted before every queued bulk ticket
STARVATION = [
    # (name, env, bulk budget, holds (tenant, bytes), queued bulk, latency)
    ("lane_full", {}, 256, [("bulk", 256)], [128, 128], [64, 64]),
    ("shared_full", {"READ_BUDGET": "300"}, None, [("bulk", 300)],
     [100, 100], [100, 50]),
    ("both_full", {"READ_BUDGET": "300"}, 200, [("bulk", 200), (None, 100)],
     [150], [100, 100, 100]),
]


@pytest.mark.parametrize("case", STARVATION, ids=[c[0] for c in STARVATION])
def test_starvation_matrix(monkeypatch, case):
    """Checked by the order of the grants, never by wall time (the
    reference's own test bounds a p99 and fails under load).  Every
    latency grant is in before the first is let go, so the latency
    tenant's high-water mark is the script's, not the threads' wake
    order's (the whole latency batch fits once the holds are released)."""
    _, env, bulk_budget, holds, queued, lat = case

    def script(g):
        for i, (tenant, nb) in enumerate(holds):
            g.hold(f"h{i}", tenant, "bulk", nb)
        for i, nb in enumerate(queued):
            g.wait(f"b{i}", "bulk", "bulk", nb)
        for i, nb in enumerate(lat):
            g.wait(f"l{i}", "lat", "latency", nb, tier="lookup")
        for i in range(len(holds)):
            g.release(f"h{i}")
        g.granted(len(holds) + len(lat))
        for i in range(len(lat)):
            g.let_go(f"l{i}")
        for i in range(len(queued)):
            g.granted(len(holds) + len(lat) + i + 1)
            g.let_go(f"b{i}")
        return g.order[len(holds):], dict(g.adm.tenant_high_water)

    tenants = [("lat", {"klass": "latency", "budget_bytes": 8 << 20}),
               ("bulk", {"klass": "bulk", "budget_bytes": bulk_budget})]
    got = _run(script, tenants=tenants, env=env, monkeypatch=monkeypatch)
    assert got["port"] == got["ref"]
    order, hw = got["port"]
    assert order == [f"l{i}" for i in range(len(lat))] + \
        [f"b{i}" for i in range(len(queued))]
    assert hw["lat"] == sum(lat)
    if bulk_budget:
        assert hw["bulk"] <= bulk_budget


def test_intra_lane_fifo_no_leapfrog():
    """A ticket blocked by its own tenant's budget holds back its lane: a
    later small lane-mate that would fit waits behind it."""
    def script(g):
        g.hold("g0", "t", "bulk", 60)
        g.wait("big", "t", "bulk", 80)
        g.wait("small", "t", "bulk", 30)  # 60 + 30 <= 100, yet it waits
        steps = [g.granted(1), g.adm.queue_depth()]
        g.release("g0")
        steps.append(g.granted(2))
        g.let_go("big")
        steps.append(g.granted(3))
        g.let_go("small")
        return steps

    got = _run(script, tenants=[("t", {"budget_bytes": 100,
                                       "klass": "bulk"})])
    assert got["port"] == got["ref"]
    assert got["port"] == [["g0"], 2, ["g0", "big"],
                           ["g0", "big", "small"]]


def test_vtime_floor_no_idle_priority_banking():
    """A new (or idle) tenant joins the fairness clock at now."""
    def script(g):
        for i in range(5):
            g.hold(f"v{i}", "vet", "default", 100_000)
            g.release(f"v{i}")
        g.hold("n0", "new", "default", 1000)
        g.release("n0")
        return dict(g.adm._vtime), g.adm._vfloor

    got = _run(script, tenants=[
        ("vet", {"weight": 1.0, "budget_bytes": 1 << 20}),
        ("new", {"weight": 1.0, "budget_bytes": 1 << 20})])
    assert got["port"] == got["ref"]
    vt, _ = got["port"]
    assert vt["new"] >= vt["vet"] - 100_000


def test_untagged_traffic_joins_fairness_floor():
    """Untagged tickets key at the fairness floor, not at 0: the floor
    moves with the tenants' grants."""
    def script(g):
        for i in range(2):
            g.hold(f"t{i}", "t", "default", 500_000)
            g.release(f"t{i}")
        floor = g.adm._vfloor
        g.hold("u", None, None, 10, tier="lookup")
        g.release("u")
        return dict(g.adm._vtime), floor, g.adm._vfloor

    got = _run(script, tenants=[("t", {"weight": 1.0,
                                       "budget_bytes": 1 << 20})])
    assert got["port"] == got["ref"]
    assert got["port"][1] > 0


# ---------------------------------------------------------------------------
# page pins
# ---------------------------------------------------------------------------


def _pin_script(name):
    c = CACHE[name]
    arr = np.arange(128, dtype=np.int64)  # 1 KiB
    with c.page_pin_scope("tA", 3000):
        assert c.current_pin() == ("tA", 3000)
        for i in range(5):  # the cap takes 2 pages and refuses 3
            c.PAGES.put((("f", 1, 2), 0, "c", i), arr, None, 0, 128)
    assert c.current_pin() is None
    st = c.cache_stats()
    out = [st.page_pins, st.page_pin_refusals, st.page_pinned_bytes,
           c.PAGES.pinned_bytes("tA"), c.PAGES.pinned_bytes()]
    # pins survive a full shrink; the LRU's entries do not
    c.PAGES.shrink_to(0)
    out += [c.PAGES.pinned_bytes("tA"),
            c.PAGES.get((("f", 1, 2), 0, "c", 0)) is not None,
            c.PAGES.get((("f", 1, 2), 0, "c", 4)) is not None,
            LEDGERS[name].account("cache.page_pinned").resident,
            len(c.PAGES.top_entries(10))]
    out += [c.PAGES.unpin_tenant("tA"), c.PAGES.pinned_bytes(),
            LEDGERS[name].account("cache.page_pinned").resident,
            c.PAGES.get((("f", 1, 2), 0, "c", 0)) is not None,
            c.cache_stats().page_pinned_bytes]
    return out


def test_pin_cap_eviction_refusal():
    got = {name: _pin_script(name) for name in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == [2, 3, 2048, 2048, 2048, 2048, True, False,
                           2048, 2, 2, 0, 0, True, 0]


def test_pin_scope_zero_cap_noop():
    for name in PKGS:
        c = CACHE[name]
        with c.page_pin_scope("t", 0):
            assert c.current_pin() is None
            c.PAGES.put((("f", 1, 2), 0, "c", 0), np.arange(4), None, 0, 4)
        assert c.PAGES.pinned_bytes() == 0
        assert c.cache_stats().page_pins == 0


def test_pins_of_a_rewritten_file_drop_and_clear_empties_them():
    got = {}
    for name in PKGS:
        c = CACHE[name]
        ap = os.path.abspath("pinned.parquet")
        with c.page_pin_scope("t", 1 << 20):
            c.PAGES.put(((ap, 1, 2), 0, "c", 0), np.arange(64), None, 0, 64)
            c.PAGES.put((("other", 1, 2), 0, "c", 0), np.arange(64), None,
                        0, 64)
        before = c.PAGES.pinned_bytes("t")
        c.invalidate_path(ap)
        after = c.PAGES.pinned_bytes("t")
        c.clear_caches()
        got[name] = (before, after, c.PAGES.pinned_bytes(),
                     LEDGERS[name].account("cache.page_pinned").resident)
    assert got["port"] == got["ref"] == (1024, 512, 0, 0)


# ---------------------------------------------------------------------------
# the daemons over HTTP
# ---------------------------------------------------------------------------


def test_endpoints_end_to_end(corpus, tables):
    with both(corpus, tables,
              online={"class": "latency", "pin_bytes": "2MiB",
                      "budget_bytes": "16MiB"},
              batch={"class": "bulk", "budget_bytes": "8MiB"}) as srv:
        doc = same(call_both(srv, "/v1/lookup", {
            "dataset": "events", "column": "k",
            "keys": [5, 100005, 42424242, 7, 7],
            "columns": ["v", "s", "f"]}, tenant="online"))
        assert doc["rows_total"] == 4
        assert doc["hits"][0]["values"]["v"] == [15]
        assert doc["hits"][2]["rows"] == []
        # pinned on both sides (a byte-array page weighs its bytes and
        # offsets in the port, its values' lengths in the reference)
        assert tcache.PAGES.pinned_bytes("online") > 0
        assert jcache.PAGES.pinned_bytes("online") > 0
        assert tcache.cache_stats().page_pins == \
            jcache.cache_stats().page_pins
        for scan in ({"where": {"col": "v", "le": 8}, "columns": ["k", "v"]},
                     {"where": {"col": "s", "in": ["s3", "s4"]}},
                     {"where": {"col": "f", "null": True},
                      "columns": ["k", "s"]},
                     {"columns": ["k", "s", "f"]}, {}):
            body = same(call_both(srv, "/v1/scan", {"dataset": "events",
                                                    **scan},
                                  tenant="batch"), "lines")
            assert json.loads(body.splitlines()[-1])["done"]
            same(call_both(srv, "/v1/scan", {"dataset": "events",
                                             "format": "arrow", **scan},
                           tenant="batch"), "arrow")
        for agg in ({"aggs": ["count", "avg:v", "var:v", "sum:f",
                              "min:s", "max:k", "distinct:v"]},
                    {"aggs": ["count"], "group_by": "s",
                     "where": {"col": "s", "in": ["s0", "s1"]}},
                    {"aggs": ["count", "sum:v", "top:v:3"],
                     "where": {"col": "k", "ge": 100_500}}):
            same(call_both(srv, "/v1/aggregate", {"dataset": "events",
                                                  **agg},
                           tenant="online"), "aggregate")
        doc = same(call_both(srv, "/v1/write", {
            "dataset": "tbl", "rows": {"k": [500, 3, 501], "v": [1, 2, 3]}},
            tenant="batch"))
        assert doc == {"rows": 3, "version": 2}
        doc = same(call_both(srv, "/v1/lookup", {
            "dataset": "tbl", "column": "k", "keys": [500, 3],
            "columns": ["v"]}, tenant="online"))
        assert doc["hits"][0]["values"]["v"] == [1]
        same(call_both(srv, "/v1/scan", {"dataset": "tbl"}), "lines")


def test_endpoint_errors(corpus):
    with both(corpus) as srv:
        for doc, path in [
                ({"dataset": "nope", "column": "k", "keys": [1]},
                 "/v1/lookup"),
                ({"dataset": "events", "column": "k", "keys": []},
                 "/v1/lookup"),
                ({"dataset": "events", "column": "k"}, "/v1/lookup"),
                ({"dataset": "events", "column": "nope", "keys": [1]},
                 "/v1/lookup"),
                ({"dataset": "events", "aggs": ["median:v"]},
                 "/v1/aggregate"),
                ({"dataset": "events", "aggs": []}, "/v1/aggregate"),
                ({"dataset": "events", "format": "csv"}, "/v1/scan"),
                ({"dataset": "events", "where": {"col": "v", "gt": 1}},
                 "/v1/scan"),
                ({"dataset": "events", "_files": [[0, "x"]]}, "/v1/scan"),
                ({"dataset": "events", "aggs": ["count"],
                  "_files": [[0, "x"]]}, "/v1/aggregate"),
                ({"dataset": "events", "rows": {"k": [1]}}, "/v1/write"),
                ({"dataset": "nope", "rows": {"k": [1]}}, "/v1/write"),
                ({"dataset": "tbl", "rows": {"k": [1], "v": [1, 2]}},
                 "/v1/write"),
                ({"dataset": "tbl", "rows": []}, "/v1/write"),
                ({}, "/v1/nope")]:
            got = call_both(srv, path, doc)
            assert got["port"][0] == got["ref"][0], (path, doc, got)
            assert got["port"][0] >= 400
            same(got)
        got = call_both(srv, "/v1/lookup", raw=b"{nope")
        assert got["port"][0] == got["ref"][0] == 400
        got = call_both(srv, "/v1/lookup", raw=b"[1, 2]")
        same(got)
        for path in ("/healthz", "/nope"):
            same(call_both(srv, path), "raw" if path == "/healthz"
                 else "json")
        for name in PKGS:
            assert b"parquet_tpu_serve_requests_total" in \
                _call(srv[name], "/metrics")[1]
            dz = json.loads(_call(srv[name], "/debugz")[1])
            assert "tenants" in dz and "admission" in dz
            assert json.loads(_call(srv[name], "/metrics.json")[1])[
                "counters"]
        assert set(json.loads(_call(srv["port"], "/debugz")[1])) == \
            set(json.loads(_call(srv["ref"], "/debugz")[1]))


def test_request_body_over_the_cap_is_413(corpus, monkeypatch):
    for name in PKGS:
        monkeypatch.setenv(KNOB[name] + "SERVE_MAX_BODY", "64")
    with both(corpus) as srv:
        got = call_both(srv, "/v1/lookup", {"dataset": "events",
                                            "column": "k",
                                            "keys": list(range(100))})
        assert got["port"][0] == got["ref"][0] == 413
        assert got["port"][2].get("Connection") == "close"
        assert b"PARQUET_TPU_TORCH_SERVE_MAX_BODY" in got["port"][1]


def _prom(name):
    return METRICS[name].REGISTRY


def test_per_tenant_metric_families(corpus):
    for name in PKGS:
        METRICS[name].reset_metrics()
    with both(corpus, online={"class": "latency"},
              batch={"class": "bulk"}) as srv:
        same(call_both(srv, "/v1/lookup", {"dataset": "events",
                                           "column": "k", "keys": [1]},
                       tenant="online"))
        same(call_both(srv, "/v1/scan", {"dataset": "events",
                                         "where": {"col": "v", "le": 0}},
                       tenant="batch"), "lines")
        prom = {name: _call(srv[name], "/metrics")[1].decode()
                for name in PKGS}
    for name in PKGS:
        assert ('parquet_tpu_serve_requests_total{class="latency",'
                'tenant="online"} 1') in prom[name]
        assert ('parquet_tpu_serve_requests_total{class="bulk",'
                'tenant="batch"} 1') in prom[name]
        assert 'parquet_tpu_serve_shed_total{class="default"} 0' \
            in prom[name]
        assert "parquet_tpu_serve_request_s_bucket" in prom[name]
    lines = {name: sorted(line for line in prom[name].splitlines()
                          if line.startswith(("parquet_tpu_serve_requests",
                                              "parquet_tpu_serve_shed",
                                              "# HELP parquet_tpu_serve")))
             for name in PKGS}
    assert lines["port"] == lines["ref"]


def test_per_tenant_accounting_exactness(corpus):
    """Every byte read inside the requests is one tenant's: the folded
    reports add up to the global ``read.bytes_read`` delta."""
    got = {}
    with both(corpus, a={"class": "latency"}, b={"class": "bulk"}) as srv:
        for name in PKGS:
            s = srv[name]
            CACHE[name].clear_caches()
            before = METRICS[name].metrics_snapshot()
            for i in range(3):
                assert _call(s, "/v1/lookup", {
                    "dataset": "events", "column": "k",
                    "keys": [i * 7, i * 7 + 1], "columns": ["v"]},
                    tenant="a")[0] == 200
            assert _call(s, "/v1/scan", {"dataset": "events",
                                         "where": {"col": "v", "le": 50}},
                         tenant="b")[0] == 200
            after = METRICS[name].metrics_snapshot()
            stats = s.tenant_stats.snapshot()
            delta = (after["counters"].get("read.bytes_read", 0)
                     - before["counters"].get("read.bytes_read", 0))
            assert sum(r["bytes_read"] for r in stats.values()) == delta
            assert stats["a"]["bytes_read"] > 0
            got[name] = {t: (r["requests"], r["rows"], r["shed"],
                             r["errors"]) for t, r in stats.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["a"][0] == 3 and got["port"]["b"][0] == 1


def test_hard_pressure_sheds_bulk_first(corpus, monkeypatch):
    look = {"dataset": "events", "column": "k", "keys": [1, 2, 3],
            "columns": ["v"]}
    with both(corpus, lat={"class": "latency", "pin_bytes": "4MiB"},
              bulk={"class": "bulk"}) as srv:
        # the latency tenant's lookup warm and pinned before the pressure:
        # a pinned warm lookup takes no admission grant
        for _ in range(2):
            same(call_both(srv, "/v1/lookup", look, tenant="lat"))
        ballast = {name: LEDGERS[name].account("test.ballast")
                   for name in PKGS}
        try:
            for name in PKGS:
                ballast[name].set(1 << 30)
                monkeypatch.setenv(KNOB[name] + "MEM_HARD", str(1 << 20))
            assert same(call_both(srv, "/healthz"), "raw") == b"hard\n"
            got = call_both(srv, "/v1/scan", {"dataset": "events"},
                            tenant="bulk")
            doc = same(got)
            assert got["port"][0] == 429 and doc["retry_after_s"] == 1.0
            assert got["port"][2]["Retry-After"] == "1"
            # an unknown tenant's scan is bulk too
            assert call_both(srv, "/v1/scan", {"dataset": "events"},
                             tenant="nobody")["port"][0] == 429
            doc = same(call_both(srv, "/v1/lookup", look, tenant="lat"))
            assert doc["rows_total"] == 3
            for name in PKGS:
                snap = METRICS[name].metrics_snapshot()["counters"]
                assert snap["serve.shed{class=bulk}"] >= 2
                assert snap["serve.shed{class=bulk,tenant=bulk}"] == 1
                dz = json.loads(_call(srv[name], "/debugz")[1])
                assert dz["tenants"]["bulk"]["shed"] == 1
        finally:
            for name in PKGS:
                ballast[name].set(0)
                monkeypatch.delenv(KNOB[name] + "MEM_HARD")
        assert same(call_both(srv, "/healthz"), "raw") == b"ok\n"


def _block_aggregate(srv):
    """Hold the daemon's next aggregate at its start until ``go``."""
    ds = srv._datasets["events"]
    entered, go = threading.Event(), threading.Event()
    real = ds.aggregate

    def held(*a, **kw):
        entered.set()
        go.wait(JOIN_S)
        return real(*a, **kw)

    ds.aggregate = held
    return entered, go


def test_graceful_drain(corpus):
    got = {}
    for name in PKGS:
        srv = _start(name, _config(corpus))
        entered, go = _block_aggregate(srv)
        results = []

        def inflight():
            results.append(_call(srv, "/v1/aggregate", {
                "dataset": "events", "aggs": ["count", "distinct:v"]}))

        t = threading.Thread(target=inflight)
        t.start()
        entered.wait(JOIN_S)
        closed = []
        closer = threading.Thread(target=lambda: closed.append(
            srv.close(drain=True)))
        closer.start()
        _wait_until(lambda: srv._closed, "close began")
        # a request after close began is refused (its connection is not
        # accepted, or it is answered 503)
        go.set()
        closer.join(JOIN_S)
        t.join(JOIN_S)
        assert closed == [True]
        got[name] = results[0]
        assert POOL[name].read_admission().tenant_debug() == {}
    same(got, "aggregate")
    assert json.loads(got["port"][1])["aggregates"]["count(*)"] == 8000


def test_close_clears_pins_and_tenants(corpus):
    for name in PKGS:
        srv = _start(name, _config(corpus, lat={
            "class": "latency", "pin_bytes": "4MiB", "budget_bytes": "1MiB"}))
        assert _call(srv, "/v1/lookup", {"dataset": "events", "column": "k",
                                         "keys": [9]}, tenant="lat")[0] \
            == 200
        assert CACHE[name].PAGES.pinned_bytes("lat") > 0
        assert srv.close() is True
        assert CACHE[name].PAGES.pinned_bytes("lat") == 0
        assert POOL[name].read_admission().tenant_spec("lat") is None
        assert srv.close() is True  # idempotent


def test_arrow_stream_empty_byte_array_schema(corpus):
    """A file matching no row of a byte-array column still streams a
    binary column, so a multi-file Arrow stream keeps one schema."""
    for name in PKGS:
        enc = CODECS[name].columns_to_arrow_batch
        empty = enc({"s": [], "k": np.array([], np.int64)})
        full = enc({"s": [b"x", None], "k": np.array([1, 2], np.int64)})
        assert empty.schema.equals(full.schema)
    with both(corpus) as srv:
        tab = same(call_both(srv, "/v1/scan", {
            "dataset": "events", "format": "arrow", "columns": ["k", "s"],
            "where": {"col": "k", "ge": 100_000}}), "arrow")
        assert tab.num_rows == 4000
    sink = io.BytesIO()
    assert tcodecs.columns_to_arrow_ipc(
        {"k": np.arange(3), "f": np.ma.masked_array([1.0, 2.0, 3.0],
                                                    [0, 1, 0])}, sink) == 3
    back = pa.ipc.open_stream(io.BytesIO(sink.getvalue())).read_all()
    assert back.column("f").null_count == 1


def test_columns_to_jsonable_over_a_read_and_tensors(corpus):
    """The codec takes the port's ``ColumnSet`` (each ``Column`` listed
    from one copy of its tensors) and tensors, and lists them as the
    reference lists its read's Arrow columns."""
    import torch

    with pqt.ParquetFile(corpus["paths"][0]) as f:
        got = tcodecs.columns_to_jsonable(f.read(device=CPU))
    with jpq.ParquetFile(corpus["paths"][0]) as f:
        want = {k: [jcodecs.jsonable(x) for x in v]
                for k, v in f.read().to_arrow().to_pydict().items()}
    assert got == want
    t = torch.arange(5, dtype=torch.int32)
    assert tcodecs.columns_to_jsonable({"t": t}) == {"t": [0, 1, 2, 3, 4]}
    batch = tcodecs.columns_to_arrow_batch({"t": t})
    assert batch.column(0).to_pylist() == [0, 1, 2, 3, 4]


def test_config_rejects_unknown_qos_keys():
    for name in PKGS:
        with pytest.raises(ValueError, match="unknown keys") as e:
            CONFIG[name].ServeConfig.from_dict(
                {"datasets": {"x": {"paths": ["p"]}},
                 "tenants": {"t": {"budget": "64MiB"}}})
        with pytest.raises(ValueError, match="unknown keys") as e2:
            CONFIG[name].ServeConfig.from_dict(
                {"datasets": {"x": {"paths": ["p"], "sort": "k"}}})
        if name == "ref":
            want = (str(e.value), str(e2.value))
    assert (str(e.value), str(e2.value)) == want


def test_unknown_tenant_collapses_to_default(corpus):
    with both(corpus, online={"class": "latency"}) as srv:
        for i in range(5):
            same(call_both(srv, "/v1/lookup", {"dataset": "events",
                                               "column": "k", "keys": [i]},
                           tenant=f"scanner-{i}"))
        for name in PKGS:
            stats = srv[name].tenant_stats.snapshot()
            assert set(stats) == {"default"}
            assert stats["default"]["requests"] == 5
            prom = _call(srv[name], "/metrics")[1].decode()
            assert 'tenant="scanner-0"' not in prom
            assert 'tenant="default"' in prom


def test_error_responses_close_connection(corpus):
    with both(corpus) as srv:
        got = {}
        for name in PKGS:
            conn = http.client.HTTPConnection(srv[name].host,
                                              srv[name].port, timeout=JOIN_S)
            try:
                conn.request("POST", "/v1/lookup", body=b"{nope",
                             headers={"Content-Length": "5"})
                resp = conn.getresponse()
                got[name] = (resp.status, resp.getheader("Connection"))
                resp.read()
            finally:
                conn.close()
        assert got["port"] == got["ref"] == (400, "close")


def test_keep_alive_connections_end_at_close(corpus):
    """A client that keeps its connection open does not keep the port's
    daemon from closing: the idle connection's thread ends and is
    joined."""
    srv = _start("port", _config(corpus))
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=JOIN_S)
    try:
        conn.request("POST", "/v1/lookup", body=json.dumps(
            {"dataset": "events", "column": "k", "keys": [1]}))
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Connection") is None
        resp.read()
        assert srv.close() is True
    finally:
        conn.close()


def test_second_server_refused(corpus):
    for name in PKGS:
        with _start(name, _config(corpus)):
            with pytest.raises(RuntimeError, match="already running"):
                _start(name, _config(corpus))
        # a failed bind leaves nothing behind: the next one boots
        with pytest.raises(OSError):
            _start(name, _config(corpus), host="999.invalid.host.name")
        with _start(name, _config(corpus)):
            pass


def test_arrow_scan_zero_row_dataset(tmp_path):
    p = str(tmp_path / "empty.parquet")
    jpq.write_table(pa.table({"k": pa.array([], pa.int64()),
                              "s": pa.array([], pa.string())}), p)
    srv = {}
    try:
        for name in PKGS:
            srv[name] = _start(name, {"datasets": {"e": {"paths": [p]}}})
        tab = same(call_both(srv, "/v1/scan", {"dataset": "e",
                                               "format": "arrow"}), "arrow")
        assert tab.num_rows == 0 and set(tab.schema.names) == {"k", "s"}
        same(call_both(srv, "/v1/scan", {"dataset": "e"}), "lines")
    finally:
        for s in srv.values():
            s.close()


LOOK = {"dataset": "events", "column": "k", "keys": [5]}


def test_bearer_token_auth(corpus):
    with both(corpus, secure={"class": "latency", "token": "s3cret"},
              open_={"class": "bulk"}) as srv:
        for name in PKGS:
            METRICS[name].REGISTRY.counter("serve.auth_failures")
        before = {name: METRICS[name].REGISTRY.counter(
            "serve.auth_failures").value for name in PKGS}
        same(call_both(srv, "/v1/lookup", LOOK, tenant="secure"))
        got = call_both(srv, "/v1/lookup", LOOK, tenant="secure",
                        headers={"Authorization": "Bearer nope"})
        same(got)
        assert got["port"][0] == 401
        assert "Bearer" in got["port"][2]["WWW-Authenticate"]
        doc = same(call_both(srv, "/v1/lookup", LOOK, tenant="secure",
                             headers={"Authorization": "Bearer s3cret"}))
        assert doc["rows_total"] == 1
        assert call_both(srv, "/v1/lookup", LOOK,
                         tenant="open_")["port"][0] == 200
        for name in PKGS:
            assert METRICS[name].REGISTRY.counter(
                "serve.auth_failures").value - before[name] == 2
            assert METRICS[name].REGISTRY.counter(
                "serve.auth_failures", labels={"tenant": "secure"}).value \
                >= 2


def test_token_rotation(corpus):
    """Rotation takes effect on the next request: the old token dies, the
    new one works, clearing it opens the tenant.  (The reference's version
    also arms the fleet's peer chaos hook, which comes with the fleet.)"""
    with both(corpus, secure={"token": "old"}) as srv:
        hdr = {"old": {"Authorization": "Bearer old"},
               "new": {"Authorization": "Bearer new"}}
        assert same(call_both(srv, "/v1/lookup", LOOK, tenant="secure",
                              headers=hdr["old"]))["rows_total"] == 1
        for name in PKGS:
            srv[name].rotate_token("secure", "new")
        got = call_both(srv, "/v1/lookup", LOOK, tenant="secure",
                        headers=hdr["old"])
        same(got)
        assert got["port"][0] == 401
        same(call_both(srv, "/v1/lookup", LOOK, tenant="secure",
                       headers=hdr["new"]))
        for name in PKGS:
            srv[name].rotate_token("secure", None)
        assert call_both(srv, "/v1/lookup", LOOK,
                         tenant="secure")["port"][0] == 200


class _StillTime:
    """The ``time`` module as the reference's ``utils/pool.py`` sees it,
    its monotonic clock held where the test puts it."""

    def __init__(self, now: float):
        self.now = now

    def monotonic(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_qps_limit_429_retry_after(corpus, monkeypatch):
    clock = _StillTime(1000.0)
    monkeypatch.setattr(jpool, "time", clock)
    monkeypatch.setattr(tpool, "_qps_clock", lambda: clock.now)
    with both(corpus, limited={"qps": 0.5, "burst": 1},
              free={"class": "latency"}) as srv:
        before = {name: METRICS[name].REGISTRY.counter(
            "serve.qps_rejections").value for name in PKGS}
        same(call_both(srv, "/v1/lookup", LOOK, tenant="limited"))
        got = call_both(srv, "/v1/lookup", LOOK, tenant="limited")
        doc = same(got)
        assert got["port"][0] == 429
        assert got["port"][2]["Retry-After"] == "2"
        assert doc["retry_after_s"] == 2.0
        clock.now += 1.5  # three quarters of a token
        got = call_both(srv, "/v1/lookup", LOOK, tenant="limited")
        doc = same(got)
        assert got["port"][2]["Retry-After"] == "1"
        assert doc["retry_after_s"] == pytest.approx(0.5)
        clock.now += 0.5
        same(call_both(srv, "/v1/lookup", LOOK, tenant="limited"))
        for name in PKGS:
            assert METRICS[name].REGISTRY.counter(
                "serve.qps_rejections").value - before[name] == 2
            assert srv[name].tenant_stats.snapshot()["limited"]["shed"] == 2
        for _ in range(3):  # other tenants pay nothing
            same(call_both(srv, "/v1/lookup", LOOK, tenant="free"))
        for name in PKGS:
            assert "parquet_tpu_serve_qps_rejections_total" in \
                _call(srv[name], "/metrics")[1].decode()


def test_scan_pagination_concatenates_byte_identically(corpus, tables):
    scan = {"dataset": "events", "where": {"col": "v", "le": 500},
            "columns": ["k", "v"]}
    with both(corpus, tables) as srv:
        # two more parts in the table: a three-file dataset to page over
        for rows in ({"k": [20, 21], "v": [1, 2]}, {"k": [30], "v": [3]}):
            same(call_both(srv, "/v1/write", {"dataset": "tbl",
                                              "rows": rows}))
        for base, limit in ((scan, 700), ({"dataset": "tbl"}, 1),
                            ({"dataset": "tbl", "where": {
                                "col": "k", "ge": 5}}, 2)):
            unbounded = same(call_both(srv, "/v1/scan", base), "lines")
            pages, token = [], None
            for _ in range(50):
                doc = dict(base, limit=limit)
                if token:
                    doc["page_token"] = token
                got = call_both(srv, "/v1/scan", doc)
                pages.append(same(got, "lines"))
                token = got["port"][2].get("X-Next-Page-Token")
                if not token:
                    break
            assert len(pages) > 1
            assert b"".join(pages) == unbounded
        for doc in [dict(scan, limit=0), dict(scan, limit="x"),
                    dict(scan, page_token="@@@"),
                    dict(scan, page_token="eyJmIjogOSwgIm4iOiAwfQ=="),
                    dict(scan, limit=10, format="arrow")]:
            got = call_both(srv, "/v1/scan", doc)
            assert got["port"][0] == got["ref"][0] == 400


def test_gzip_scan_and_aggregate_identity(corpus):
    scan = {"dataset": "events", "where": {"col": "v", "le": 200}}
    agg = {"dataset": "events", "aggs": ["count", "sum:v"]}
    gz = {"Accept-Encoding": "gzip"}
    with both(corpus) as srv:
        plain_scan = same(call_both(srv, "/v1/scan", scan), "lines")
        got = call_both(srv, "/v1/scan", scan, headers=gz)
        assert got["port"][2].get("Content-Encoding") == "gzip"
        assert gzip.decompress(got["port"][1]) == plain_scan
        same(got, "raw")
        plain_agg = same(call_both(srv, "/v1/aggregate", agg), "raw")
        got = call_both(srv, "/v1/aggregate", agg, headers=gz)
        assert gzip.decompress(got["port"][1]) == plain_agg
        same(got, "raw")
        page = call_both(srv, "/v1/scan", dict(scan, limit=1), headers=gz)
        same(page, "raw")
        got = call_both(srv, "/v1/lookup", LOOK, headers=gz)
        same(got)
        assert "Content-Encoding" not in got["port"][2]


def test_truncated_gzip_is_retryable():
    whole = gzip.compress(b"x" * 4096)
    for fn, err in ((jgunzip, JRemoteTransient), (tgunzip, TRemoteTransient)):
        assert fn(whole, host="h", path="/p") == b"x" * 4096
        with pytest.raises(err):
            fn(whole[:-6], host="h", path="/p")


def test_cluster_config_validation(corpus):
    good = _config(corpus)
    good["cluster"] = {"self": "a", "peers": {"a": None,
                                              "b": "http://h:1"}}
    docs = [good]
    for cluster in [{"peers": {"a": None}}, {"self": "x", "peers": {"a": None}},
                    {"self": "a", "peers": {}},
                    {"self": "a", "peers": {"a": None}, "ring": 3},
                    {"self": "a", "peers": {"a": 5}}, "nope"]:
        bad = _config(corpus)
        bad["cluster"] = cluster
        docs.append(bad)
    docs.append(_config(corpus, t={"token": "x", "qps": 2, "burst": 4}))
    docs.append(_config(corpus, t={"token": 42}))
    docs.append(_config(corpus, t={"token": ""}))
    for doc in docs:
        assert _config_outcome("port", doc) == _config_outcome("ref", doc)
    cfg = tconfig.ServeConfig.from_dict(good)
    assert cfg.cluster.peers == {"a": None, "b": "http://h:1"}


def test_the_daemon_runs_on_the_card_unless_told_otherwise(corpus):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver.Server(_config(corpus), port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pqt.Server(_config(corpus), port=0, device="cuda")
    with tserver.Server(_config(corpus), port=0, device=CPU) as srv:
        assert srv.device.type == "cpu"


def test_the_package_exports_the_daemon():
    for n in ("ServeConfig", "Server", "TenantSpec", "tenant_context"):
        assert n in pqt.__all__ and getattr(pqt, n) is not None
    assert pqt.Server is tserver.Server
    assert pqt.TenantSpec is tpool.TenantSpec
