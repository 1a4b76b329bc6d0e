"""parquet_tpu_torch's serving fleet (``serve/cluster.py``, the fleet half
of ``serve/server.py``, ``io/faults.py``'s peer chaos) against
parquet_tpu's, on the CPU.

Each test is the counterpart of one test of ``tests/test_fleet.py``, or of
a rule that file leaves implicit.  The ring's hash and owners equal the
reference's for the same names; the gather engine answers the same
scripts as the reference's; a three-member in-process fleet of the port's
daemons (``device="cpu"``) answers a scan, an aggregate and a lookup as
the port's single node and the reference's single node do on the same
key-partitioned table: JSON scan bytes byte for byte, Arrow scans by
``pa.Table.equals``, lookups and integer aggregates exactly, float sums,
means and variances to ``rel=1e-9`` (the shards' partial states add in
another order).  No test holds a wall-clock bound: the hedge is pinned
off (``PARQUET_TPU_TORCH_FLEET_HEDGE_S=0``) where it is not the subject,
the per-peer budget is far past any leg, the hedge test holds its peer's
leg on an ``Event`` until the hedge has won, and outcomes are read from
counters and answers.  Every test leaves no thread running and resets the
process-wide state (peer chaos, commit arbiter, tenants, breakers).
"""

import contextlib
import http.server
import json
import math
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

import parquet_tpu as jpq
from parquet_tpu import dataset_writer as jdw
from parquet_tpu.errors import RemoteTransientError as JRemoteTransient
from parquet_tpu.io import cache as jcache
from parquet_tpu.io import faults as jfaults
from parquet_tpu.io import manifest as jmanifest
from parquet_tpu.io import remote as jremote
from parquet_tpu.io.writer import ColumnData as JCD
from parquet_tpu.obs import metrics as jmetrics
from parquet_tpu.serve import cluster as jcluster
from parquet_tpu.serve import server as jserver
from parquet_tpu.utils import env as jenv
from parquet_tpu.utils import pool as jpool

import parquet_tpu_torch as pqt
from parquet_tpu_torch import dataset_writer as tdw
from parquet_tpu_torch.errors import RemoteError
from parquet_tpu_torch.errors import RemoteTransientError as TRemoteTransient
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io import manifest as tmanifest
from parquet_tpu_torch.io import remote as tremote
from parquet_tpu_torch.io.writer import ColumnData as TCD
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.serve import ClusterSpec, Server
from parquet_tpu_torch.serve import cluster as tcluster
from parquet_tpu_torch.utils import env as tenv
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started, new_threads,
                                    start_shared_pools, threads_now)

CPU = "cpu"
JOIN_S = 120.0  # a liveness bound of a request or a join, never asserted
NAMES = ("n1", "n2", "n3")
RTOL = 1e-9  # float aggregates merged from the shards' partial states
# the fleet knobs the reference names PARQUET_TPU_FLEET_*
FLEET_KNOBS = ("VNODES", "PEER_TIMEOUT_S", "MARGIN_S", "HEDGE_S",
               "CAS_TTL_S", "CAS_RETRIES")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


def _reset_state() -> None:
    for cache, faults, manifest, remote, pool in (
            (tcache, tfaults, tmanifest, tremote, tpool),
            (jcache, jfaults, jmanifest, jremote, jpool)):
        cache.clear_caches(reset_stats=True)
        faults.set_peer_chaos(None)
        manifest.set_commit_arbiter(None)
        # a peer is a host 127.0.0.1:<port>: an open circuit of a killed
        # member must not reach the next test's member on a reused port
        remote.reset_breakers()
        adm = pool.read_admission()
        adm.clear_tenants()
        adm._reset()
    tremote.drain_connection_pools()


def _join_reference_threads(before) -> None:
    """The reference daemon's connection threads and its fleet's legs are
    daemon threads that nothing joins; wait for them to end.  The port's
    are joined by its ``close`` and are left to the thread check."""
    for t in new_threads(before):
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if type(owner) is http.server.ThreadingHTTPServer \
                or t.name.startswith(("pq-fleet", "pq-gather")):
            t.join(JOIN_S)


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    before = threads_now()
    for knob in FLEET_KNOBS:
        monkeypatch.delenv("PARQUET_TPU_TORCH_FLEET_" + knob, raising=False)
        monkeypatch.delenv("PARQUET_TPU_FLEET_" + knob, raising=False)
    # no leg of a test runs against a clock: nothing times out, and the
    # hedge runs only where a test turns it on
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S", "600")
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_HEDGE_S", "0")
    _reset_state()
    yield
    _reset_state()
    _join_reference_threads(before)
    assert_no_thread_started(before)


def _counters() -> dict:
    return tmetrics.metrics_snapshot()["counters"]


def _moved(before: dict, name: str) -> int:
    return _counters().get(name, 0) - before.get(name, 0)


# ---------------------------------------------------------------------------
# the corpus: a key-partitioned table the port's writer wrote
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """splitmix64 over ``k`` spreads the rows over 4 partition buffers,
    each flushing its own part files: the hash the ring routes keys by."""
    td = tmp_path_factory.mktemp("fleet_corpus")
    n = 6000
    rng = np.random.default_rng(11)
    tab = pa.table({"k": np.arange(n, dtype=np.int64),
                    "v": (np.arange(n, dtype=np.int64) * 7) % 1000,
                    "s": [f"s{i % 13}" for i in range(n)],
                    "f": rng.random(n) * 100.0})
    ring = tcluster.HashRing(NAMES)
    # the part names are random: the same rows are written again until
    # the ring gives every member a part, so each peer serves a shard
    for attempt in range(50):
        tdir = str(td / f"tbl{attempt}")
        w = pqt.DatasetWriter(tdir, pqt.schema_from_arrow(tab.schema),
                              partition_on="k", num_partitions=4,
                              rows_per_file=1000)
        w.write_arrow(tab)
        w.commit()
        w.close()
        with pqt.open_table(tdir) as ds:
            paths = list(ds.paths)
        if set(ring.spread(paths)) == set(NAMES):
            break
    assert set(ring.spread(paths)) == set(NAMES) and len(paths) >= 4
    return {"table": tdir, "n": n}


def _cfg(corpus, name=None, names=NAMES, **tenants) -> dict:
    doc = {"datasets": {"tbl": {"table": corpus["table"],
                                "writable": True}},
           "tenants": tenants}
    if name is not None:
        doc["cluster"] = {"self": name, "peers": {n: None for n in names}}
    return doc


@contextlib.contextmanager
def _fleet(corpus, names=NAMES, **tenants):
    servers = {}
    try:
        for nm in names:
            servers[nm] = Server(_cfg(corpus, nm, names, **tenants), port=0,
                                 device=CPU)
        urls = {nm: s.url for nm, s in servers.items()}
        for s in servers.values():
            s.set_peers(urls)
        yield servers
    finally:
        for s in reversed(list(servers.values())):
            s.close()


def _post(url, doc, tenant="default", headers=None):
    hdrs = {"X-Tenant": tenant, "Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers=hdrs)
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        return r.status, r.read()


def _status(url, doc, **kw) -> int:
    try:
        return _post(url, doc, **kw)[0]
    except urllib.error.HTTPError as e:
        with e:
            return e.code


SCAN = {"dataset": "tbl", "where": {"col": "v", "le": 500},
        "columns": ["k", "v"]}
AGG = {"dataset": "tbl",
       "aggs": ["count", "sum:v", "min:k", "max:k", "avg:v", "distinct:s",
                "sum:f", "avg:f", "var:f", "min:f", "max:f"]}
GRP = {"dataset": "tbl", "aggs": ["count", "sum:v", "avg:f"],
       "group_by": "s", "where": {"col": "s", "in": ["s0", "s1", "s2"]}}
LOOK = {"dataset": "tbl", "column": "k",
        "keys": [0, 17, 4242, 5999, 777777, 3, 1000, 2048],
        "columns": ["v", "s", "f"]}


@pytest.fixture(scope="module")
def solo(corpus):
    """The port's and the reference's single node's answers to the
    requests the fleet tests send, each daemon alone in its package."""
    before = threads_now()
    out = {}
    for name, start in (
            ("port", lambda: Server(_cfg(corpus), port=0, device=CPU)),
            ("ref", lambda: jserver.Server(_cfg(corpus), port=0))):
        with start() as srv:
            u = srv.url
            out[name] = {
                "json": _post(u + "/v1/scan", SCAN)[1],
                "arrow": pa.ipc.open_stream(_post(
                    u + "/v1/scan", dict(SCAN, format="arrow"))[1])
                .read_all(),
                "agg": json.loads(_post(u + "/v1/aggregate", AGG)[1]),
                "grp": json.loads(_post(u + "/v1/aggregate", GRP)[1]),
                "look": json.loads(_post(u + "/v1/lookup", LOOK)[1])}
    _join_reference_threads(before)
    # the two single nodes agree before either is held against a fleet
    assert out["port"]["json"] == out["ref"]["json"]
    assert out["port"]["arrow"].equals(out["ref"]["arrow"])
    assert out["port"]["look"] == out["ref"]["look"]
    return out


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == pytest.approx(b, rel=RTOL, abs=0.0)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _same_aggregates(got: dict, want: dict) -> None:
    """Integers exactly, floats to ``RTOL``, the groups exactly."""
    assert got.keys() == want.keys()
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])


# ---------------------------------------------------------------------------
# ring and shard key
# ---------------------------------------------------------------------------


def test_shard_key_matches_writer_partitioner():
    """The scalar hash is both packages' vectorized ``_partition_ids``
    finalizer bit for bit, and the reference's scalar hash."""
    vals = np.array([0, 1, -5, 2**62, 12345, -2**63, 2**63 - 1, 77],
                    dtype=np.int64)
    tab = pa.table({"k": vals})
    for pq, dw, cd in ((pqt, tdw, TCD), (jpq, jdw, JCD)):
        leaf = pq.schema_from_arrow(tab.schema).leaf("k")
        for parts in (7, 4, 64):
            ids = dw._partition_ids(leaf, cd(values=vals), len(vals), parts)
            for v, pid in zip(vals.tolist(), ids.tolist()):
                assert tcluster.splitmix64(v) % parts == pid
    for v in vals.tolist() + [2**64 - 1, 2**70 + 3]:
        assert tcluster.splitmix64(v) == jcluster.splitmix64(v)
    # a NULL key routes to partition 0, as the writer sends it
    assert tcluster.shard_key(None) == tcluster.splitmix64(0)


@pytest.mark.parametrize("value", [None, True, False, 0, -1, 3.5,
                                   float("nan"), -0.0, "abc", b"abc", "",
                                   "/data/part-3.parquet", "n1#63",
                                   "ünïcode", 2**63])
def test_shard_key_forms(value):
    assert tcluster.shard_key(value) == jcluster.shard_key(value)
    if isinstance(value, float):
        assert tcluster.shard_key(value) == tcluster.shard_key(repr(value))
    if isinstance(value, bool):
        assert tcluster.shard_key(value) == tcluster.splitmix64(int(value))


def test_shard_key_refuses_an_unroutable_value():
    assert tcluster.shard_key("abc") == tcluster.shard_key(b"abc")
    for pkg in (tcluster, jcluster):
        with pytest.raises(TypeError):
            pkg.shard_key([1, 2])


@pytest.mark.parametrize("vnodes", [1, 8, 64])
def test_ring_deterministic_and_minimal_motion(vnodes):
    ring = tcluster.HashRing(NAMES, vnodes=vnodes)
    again = tcluster.HashRing(reversed(NAMES), vnodes=vnodes)
    ref = jcluster.HashRing(NAMES, vnodes=vnodes)
    keys = list(range(500))
    owners = {k: ring.owner_of_key(k) for k in keys}
    assert owners == {k: again.owner_of_key(k) for k in keys}
    assert owners == {k: ref.owner_of_key(k) for k in keys}
    if vnodes >= 8:
        assert set(owners.values()) == set(NAMES)  # everyone owns an arc
    # removing one node moves only its keys
    sub = tcluster.HashRing(("n1", "n3"), vnodes=vnodes)
    for k, owner in owners.items():
        if owner != "n2":
            assert sub.owner_of_key(k) == owner
    files = [f"/data/part-{i}.parquet" for i in range(64)]
    assert ring.spread(files) == ref.spread(files)
    if vnodes >= 8:
        assert set(ring.spread(files)) == set(NAMES)


def test_ring_vnodes_knob(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_VNODES", "5")
    monkeypatch.setenv("PARQUET_TPU_FLEET_VNODES", "5")
    ring, ref = tcluster.HashRing(NAMES), jcluster.HashRing(NAMES)
    assert ring.vnodes == ref.vnodes == 5
    assert [ring.owner(h) for h in range(0, 2**64, 2**58)] == \
        [ref.owner(h) for h in range(0, 2**64, 2**58)]
    with pytest.raises(ValueError):
        tcluster.HashRing([])


def test_fleet_knobs_have_the_reference_defaults():
    for knob in FLEET_KNOBS:
        mine = tenv.KNOBS["PARQUET_TPU_TORCH_FLEET_" + knob][0]
        theirs = jenv.knob("PARQUET_TPU_FLEET_" + knob).default
        assert (float(mine) if mine else None) == \
            (float(theirs) if theirs is not None else None), knob
    assert tenv.env_opt_float("PARQUET_TPU_TORCH_FLEET_HEDGE_S") == 0.0


# ---------------------------------------------------------------------------
# the gather engine
# ---------------------------------------------------------------------------


def _routers(peer_url="http://peer.invalid:9"):
    peers = {"n1": None, "n2": peer_url}
    return {"port": tcluster.FleetRouter(ClusterSpec(self_name="n1",
                                                     peers=peers)),
            "ref": jcluster.FleetRouter(jpq.serve.ClusterSpec(
                self_name="n1", peers=peers))}


def _ref_counters() -> dict:
    return jmetrics.metrics_snapshot()["counters"]


def test_gather_local_fallback_when_peer_fails(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_FLEET_HEDGE_S", "0")
    out = {}
    for name, router in _routers().items():
        err = TRemoteTransient if name == "port" else JRemoteTransient
        counters = _counters if name == "port" else _ref_counters
        before = counters()

        def remote(peer, payload, err=err):
            raise err("boom", host=peer)

        def local(peer, payload):
            return {"peer": peer, "n": payload}

        try:
            out[name] = router.gather({"n1": 1, "n2": 2}, remote, local)
        finally:
            router.close()
        after = counters()
        for c in ("fleet.local_fallbacks", "fleet.peer_errors",
                  "fleet.gathers"):
            assert after[c] - before.get(c, 0) == 1, (name, c)
    assert out["port"] == out["ref"]
    assert out["port"] == ({"n1": {"peer": "n1", "n": 1},
                            "n2": {"peer": "n2", "n": 2}}, [])


def test_gather_skip_accounting_vs_exact(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_FLEET_HEDGE_S", "0")
    for name, router in _routers().items():
        err = TRemoteTransient if name == "port" else JRemoteTransient
        counters = _counters if name == "port" else _ref_counters

        def remote(peer, payload, err=err):
            raise err("peer down", host=peer)

        def local(peer, payload):
            if peer == "n2":
                raise OSError("shard files gone")
            return "ok"

        try:
            before = counters()
            results, skips = router.gather({"n1": 0, "n2": 0}, remote, local)
            assert results == {"n1": "ok"}
            assert [s["peer"] for s in skips] == ["n2"]
            assert "peer down" in skips[0]["error"]
            assert counters()["fleet.peer_skips"] - \
                before.get("fleet.peer_skips", 0) == 1
            # exact fails fast: the peer's RemoteError surfaces
            with pytest.raises(err, match="peer down"):
                router.gather({"n1": 0, "n2": 0}, remote, local, exact=True)
        finally:
            router.close()


def test_gather_exact_wraps_a_local_error():
    """A self-owned shard that fails is unservable: ``exact`` raises it as
    a transient remote error naming the shard."""
    router = _routers()["port"]
    try:
        def local(peer, payload):
            raise OSError("disk gone")

        with pytest.raises(TRemoteTransient, match="'n1' unservable"):
            router.gather({"n1": 0}, None, local, exact=True)
        assert router.gather({"n1": 0}, None, local)[1][0]["peer"] == "n1"
    finally:
        router.close()


def test_gather_hedge_wins_over_stalled_peer(monkeypatch):
    """A peer held on an Event: the local hedge starts after the pinned
    delay and wins; the held leg is released only after the gather
    returned, and ``close`` joins it."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_HEDGE_S", "0.02")
    router = _routers()["port"]
    before = _counters()
    hold = threading.Event()
    entered = threading.Event()

    def remote(peer, payload):
        entered.set()
        hold.wait(JOIN_S)
        return "slow"

    def local(peer, payload):
        return "hedged"

    try:
        results, skips = router.gather({"n2": 0}, remote, local)
        assert entered.is_set()
    finally:
        hold.set()
        router.close()
    assert results == {"n2": "hedged"} and not skips
    assert _moved(before, "fleet.hedges_issued") == 1
    assert _moved(before, "fleet.hedges_won") == 1
    assert _moved(before, "fleet.peer_errors") == 0


def test_gather_peer_answer_beats_a_failed_hedge(monkeypatch):
    """A hedge that fails leaves the peer's answer to win: the result does
    not depend on which leg finished first."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_HEDGE_S", "0.001")
    router = _routers()["port"]
    hedged = threading.Event()

    def remote(peer, payload):
        hedged.wait(JOIN_S)
        return "peer"

    def local(peer, payload):
        hedged.set()
        raise OSError("hedge failed")

    before = _counters()
    try:
        results, _ = router.gather({"n2": 0}, remote, local)
    finally:
        router.close()
    assert results == {"n2": "peer"}
    assert _moved(before, "fleet.hedges_issued") == 1
    assert _moved(before, "fleet.hedges_won") == 0


def test_peer_chaos_matches_the_reference():
    trips = {}
    for name, faults in (("port", tfaults), ("ref", jfaults)):
        chaos = faults.PeerChaos()
        chaos.kill_after("a", 2)
        chaos.partition("b")
        got = []
        for peer in ("a", "a", "a", "b", "c", "a"):
            try:
                chaos.check(peer)
                got.append("ok")
            except ConnectionRefusedError:
                got.append("refused")
        trips[name] = (got, list(chaos.trips))
        faults.set_peer_chaos(chaos)
        assert faults.peer_chaos() is chaos
        faults.set_peer_chaos(None)
    assert trips["port"] == trips["ref"]
    assert trips["port"][0] == ["ok", "ok", "refused", "refused", "ok",
                                "refused"]


# ---------------------------------------------------------------------------
# the fleet end to end
# ---------------------------------------------------------------------------


def test_fleet_scan_byte_identical_to_single_node(corpus, solo):
    with _fleet(corpus) as servers:
        before = _counters()
        _, fleet_json = _post(servers["n1"].url + "/v1/scan", SCAN)
        assert fleet_json == solo["port"]["json"]  # byte for byte
        assert fleet_json == solo["ref"]["json"]
        assert _moved(before, "fleet.gathers") == 1
        assert _moved(before, "fleet.forwards") == 2  # the two peers
        assert _moved(before, "fleet.local_fallbacks") == 0
        _, fleet_arrow = _post(servers["n2"].url + "/v1/scan",
                               dict(SCAN, format="arrow"))
        fleet_tab = pa.ipc.open_stream(fleet_arrow).read_all()
        assert fleet_tab.equals(solo["port"]["arrow"])
        assert fleet_tab.equals(solo["ref"]["arrow"])


def test_fleet_scan_gzip_and_no_predicate(corpus):
    """A whole-table scan (no ``where``) and a gzip-encoded one: the same
    bytes as the single node's."""
    doc = {"dataset": "tbl", "columns": ["k", "s"]}
    with Server(_cfg(corpus), port=0, device=CPU) as srv:
        want = _post(srv.url + "/v1/scan", doc)[1]
    with _fleet(corpus) as servers:
        assert _post(servers["n3"].url + "/v1/scan", doc)[1] == want
        _, gz = _post(servers["n1"].url + "/v1/scan", doc,
                      headers={"Accept-Encoding": "gzip"})
        import gzip

        assert gzip.decompress(gz) == want


def test_fleet_chaos_kill_mid_scan_byte_identical(corpus, solo):
    """One member dies mid-scan (the chaos hook partitions it after one
    more sub-request, and its daemon closes at once with no drain): the
    gather runs its shard locally over the shared storage and the answer
    stays byte-identical, on the first scan and on the next."""
    with _fleet(corpus) as servers:
        ring = servers["n1"].fleet.ring
        owners = ring.spread(list(servers["n1"].dataset("tbl").paths))
        victim = next(nm for nm in NAMES if nm != "n1" and owners.get(nm))
        chaos = tfaults.PeerChaos()
        tfaults.set_peer_chaos(chaos)
        # one more sub-request allowed, then the hook partitions the peer;
        # the daemon dies now, so that allowed one meets a dead socket
        chaos.kill_after(victim, 1)
        servers[victim].chaos_kill()
        before = _counters()
        _, fleet_bytes = _post(servers["n1"].url + "/v1/scan", SCAN)
        assert fleet_bytes == solo["port"]["json"]  # no skip either
        assert _moved(before, "fleet.local_fallbacks") == 1
        assert _moved(before, "fleet.peer_errors") == 1
        assert _moved(before, "fleet.peer_skips") == 0
        # the allowance spent, the hook itself refuses the sub-request
        _, again = _post(servers["n1"].url + "/v1/scan", SCAN)
        assert again == solo["ref"]["json"]
        assert chaos.trips == [(victim, "partition")]
        # the survivors took over the process-wide state
        assert tmanifest._ARBITER_RESOLVER is not None


def test_fleet_aggregate_and_lookup_match_single_node(corpus, solo):
    with _fleet(corpus) as servers:
        u = servers["n3"].url
        fleet_agg = json.loads(_post(u + "/v1/aggregate", AGG)[1])
        for want in (solo["port"]["agg"], solo["ref"]["agg"]):
            _same_aggregates(fleet_agg["aggregates"], want["aggregates"])
        assert fleet_agg["aggregates"]["count(*)"] == corpus["n"]
        assert fleet_agg["aggregates"]["sum(v)"] == \
            solo["port"]["agg"]["aggregates"]["sum(v)"]  # exact
        fleet_grp = json.loads(_post(u + "/v1/aggregate", GRP)[1])
        for want in (solo["port"]["grp"], solo["ref"]["grp"]):
            _same_aggregates(fleet_grp["aggregates"], want["aggregates"])
            assert fleet_grp["groups"] == want["groups"]
        fleet_look = json.loads(_post(u + "/v1/lookup", LOOK)[1])
        # global row ordinals: each owner answers its keys over the whole
        # table
        assert fleet_look == solo["port"]["look"] == solo["ref"]["look"]


def test_fleet_lookup_float_and_null_keys(corpus):
    """Keys of every routable form merge back in the request's order; a
    float key keeps its hit through the merge (its identity is its
    repr)."""
    doc = dict(LOOK, keys=[5, 5.0, 7, 6000, 0, 5])
    with Server(_cfg(corpus), port=0, device=CPU) as srv:
        want = json.loads(_post(srv.url + "/v1/lookup", doc)[1])
    with _fleet(corpus) as servers:
        got = json.loads(_post(servers["n2"].url + "/v1/lookup", doc)[1])
    assert got == want


def test_fleet_exact_failfast_when_shard_unservable(corpus, monkeypatch):
    """``"exact": true`` and an unservable shard (its peer partitioned and
    its files hidden, so the local run fails too) give a 5xx, not a
    partial answer; without ``exact`` the answer degrades to the served
    files with the skip accounted."""
    with _fleet(corpus) as servers:
        coord = servers["n1"]
        ds = coord.dataset("tbl")
        owners = coord.fleet.ring.spread(list(ds.paths))
        victim = next(nm for nm in NAMES if nm != "n1" and owners.get(nm))
        chaos = tfaults.PeerChaos()
        tfaults.set_peer_chaos(chaos)
        chaos.partition(victim)
        moved = []
        try:
            for p in owners[victim]:
                os.rename(p, p + ".hidden")
                moved.append(p)
            tcache.clear_caches()
            before = _counters()
            assert _status(coord.url + "/v1/scan",
                           dict(SCAN, exact=True)) >= 500
            assert _status(coord.url + "/v1/aggregate",
                           dict(AGG, exact=True)) >= 500
            assert _moved(before, "fleet.peer_skips") == 0
            before = _counters()
            req = urllib.request.Request(
                coord.url + "/v1/scan", data=json.dumps(SCAN).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=JOIN_S) as r:
                skipped = json.loads(r.headers["X-Fleet-Skipped"])
                body = r.read()
            lines = [json.loads(x) for x in body.decode().splitlines()]
            assert lines[-1]["done"]
            assert skipped == [victim]
            assert _moved(before, "fleet.peer_skips") == 1
            assert _moved(before, "read.files_skipped") == \
                len(owners[victim])
            served = sum(x["num_rows"] for x in lines[:-1])
            assert lines[-1]["num_rows"] == served
            look = json.loads(_post(coord.url + "/v1/aggregate",
                                    {"dataset": "tbl",
                                     "aggs": ["count"]})[1])
            assert look["fleet"]["skipped"][0]["peer"] == victim
            assert look["aggregates"]["count(*)"] < corpus["n"]
        finally:
            for p in moved:
                os.rename(p + ".hidden", p)


def test_fleet_debugz_and_internal_guard(corpus):
    with _fleet(corpus) as servers:
        with urllib.request.urlopen(servers["n1"].url + "/debugz",
                                    timeout=JOIN_S) as r:
            dz = json.loads(r.read())
        assert dz["fleet"]["self"] == "n1"  # the first member owns it
        assert set(dz["fleet"]["peers"]) == set(NAMES)
        for name, ent in dz["fleet"]["peers"].items():
            assert ent["url"] == servers[name].url
            assert ent["self"] == (name == "n1")
            assert ent["breaker"] == "closed"
        # '_files' and the commit arbiter are the fleet's own: the public
        # surface refuses them
        u = servers["n1"].url
        assert _status(u + "/v1/scan",
                       {"dataset": "tbl", "_files": [[0, "x"]]}) == 400
        assert _status(u + "/v1/aggregate",
                       {"dataset": "tbl", "aggs": ["count"],
                        "_files": [[0, "x"]]}) == 400
        assert _status(u + "/v1/fleet/commit", {"table_dir": "x"}) == 400
        internal = {"X-Fleet-Internal": "1"}
        assert _status(u + "/v1/fleet/commit",
                       {"table_dir": "/nowhere", "expected_version": 0,
                        "manifest": "{}"}, headers=internal) == 403
        assert _status(u + "/v1/scan", {"dataset": "tbl", "_files": []},
                       headers=internal) == 400
        assert _status(u + "/v1/scan", {"dataset": "tbl",
                                        "_files": [["0", 3]]},
                       headers=internal) == 400
    with Server(_cfg(corpus), port=0, device=CPU) as srv:
        assert _status(srv.url + "/v1/fleet/commit", {"table_dir": "x"},
                       headers={"X-Fleet-Internal": "1"}) == 404
        with pytest.raises(RuntimeError, match="no cluster config"):
            srv.set_peers({"n1": "http://x"})


def test_fleet_internal_legs_skip_the_qps_bucket(corpus):
    """A metered tenant's scatter charges its bucket once: the legs carry
    ``X-Fleet-Internal`` and the tenant, and no member refuses them."""
    tenants = {"m": {"qps": 1, "burst": 1}}
    with _fleet(corpus, **tenants) as servers:
        u = servers["n1"].url
        before = _counters()
        assert _status(u + "/v1/scan", SCAN, tenant="m") == 200
        assert _moved(before, "fleet.forwards") == 2
        assert _moved(before, "serve.qps_rejections") == 0
        assert _status(u + "/v1/scan", SCAN, tenant="m") == 429
        assert _status(u + "/v1/scan", SCAN, tenant="m",
                       headers={"X-Fleet-Internal": "1"}) == 200


def test_fleet_members_share_one_tenant_table(corpus):
    """Fleet members may share a process only with the same tenants; a
    single node may not join them.  The first member's close hands the
    tenant table, the ``/debugz`` sections and the commit arbiter to a
    survivor; the last close releases them."""
    tenants = {"t": {"class": "latency", "budget_bytes": 1 << 20}}
    servers = {}
    try:
        for nm in NAMES:
            servers[nm] = Server(_cfg(corpus, nm, **tenants), port=0,
                                 device=CPU)
        with pytest.raises(RuntimeError, match="one tenant QoS table"):
            Server(_cfg(corpus, "n1"), port=0, device=CPU)
        with pytest.raises(RuntimeError, match="already running"):
            Server(_cfg(corpus, **tenants), port=0, device=CPU)
        servers.pop("n1").close()
        dz = pqt.debugz_snapshot()
        assert dz["fleet"]["self"] in ("n2", "n3")
        assert "t" in dz["tenants"]
        assert tpool.read_admission().tenant_spec("t") is not None
        assert tmanifest._ARBITER_RESOLVER is not None
        servers.pop("n2").close()
        assert pqt.debugz_snapshot()["fleet"]["self"] == "n3"
        servers.pop("n3").close()
        dz = pqt.debugz_snapshot()
        assert "fleet" not in dz and "tenants" not in dz
        assert tpool.read_admission().tenant_spec("t") is None
        assert tmanifest._ARBITER_RESOLVER is None
    finally:
        for s in servers.values():
            s.close()
    with Server(_cfg(corpus), port=0, device=CPU):
        pass  # nothing was left installed


def test_transport_post_round_trip(corpus):
    """``HttpTransport.post`` on the pooled connections: a body out, the
    status, the headers and the body back, the connection kept."""
    with Server(_cfg(corpus), port=0, device=CPU) as srv:
        t = tremote.HttpTransport(srv.url)
        body = json.dumps(LOOK).encode()
        for _ in range(2):
            status, hdrs, got = t.post("/v1/lookup", body)
            assert status == 200
            assert hdrs["content-type"] == "application/json"
            assert json.loads(got)["rows_total"] == 7
        assert t.idle_connections() >= 1
        status, _, got = t.post("/v1/lookup", b"{")
        assert status == 400
        t.close()
        with pytest.raises(ValueError, match="closed transport"):
            t.post("/v1/lookup", body)


# ---------------------------------------------------------------------------
# commit arbitration (compare-and-swap)
# ---------------------------------------------------------------------------


def _seed_table(pq, d, n=100):
    tab = pa.table({"k": np.arange(n, dtype=np.int64),
                    "v": np.arange(n, dtype=np.int64)})
    w = pq.DatasetWriter(d, pq.schema_from_arrow(tab.schema))
    w.write_arrow(tab)
    w.commit()
    w.close()


PKG = {"port": (pqt, tmanifest, "PARQUET_TPU_TORCH_FLEET_"),
       "ref": (jpq, jmanifest, "PARQUET_TPU_FLEET_")}


def test_cas_commit_local_semantics(tmp_path):
    got = {}
    for name, (pq, manifest, _) in PKG.items():
        d = str(tmp_path / name)
        _seed_table(pq, d)
        live = manifest.read_manifest(d)
        new = manifest.Manifest.deserialize(live.serialize())
        new.version = live.version + 1
        # a stale expectation is a conflict that reports the live version
        stale = manifest.cas_commit_local(d, live.version + 5, new)
        ok = manifest.cas_commit_local(d, live.version, new)
        got[name] = (stale, ok, manifest.read_manifest(d).version,
                     live.version)
    assert got["port"] == got["ref"]
    stale, ok, after, v0 = got["port"]
    assert stale == (False, v0) and ok == (True, v0 + 1) and after == v0 + 1


def test_cas_claim_conflict_and_ttl_takeover(tmp_path, monkeypatch):
    for name, (pq, manifest, knob) in PKG.items():
        d = str(tmp_path / name)
        _seed_table(pq, d)
        live = manifest.read_manifest(d)
        new = manifest.Manifest.deserialize(live.serialize())
        new.version = live.version + 1
        claim = os.path.join(d, manifest.CLAIM_NAME)
        open(claim, "w").close()
        # a fresh rival claim: a conflict, no takeover
        assert manifest.cas_commit_local(d, live.version, new) == \
            (False, live.version)
        # an expired claim belongs to a committer that died between its
        # part rename and its manifest commit: broken and taken over
        monkeypatch.setenv(knob + "CAS_TTL_S", "0.01")
        past = os.path.getmtime(claim) - 60
        os.utime(claim, (past, past))
        ok, _ = manifest.cas_commit_local(d, live.version, new)
        assert ok and manifest.read_manifest(d).version == new.version
        assert not os.path.exists(claim), name


def test_commit_manifest_retries_cas_conflicts(tmp_path, monkeypatch):
    """A rival advancing the version between the read and the swap makes
    the commit read and mutate again until it lands; running out of
    retries raises ``OSError``."""
    for name, (pq, manifest, knob) in PKG.items():
        d = str(tmp_path / name)
        _seed_table(pq, d)
        conflicts = [2]
        real = manifest.cas_commit_local

        def flaky(table_dir, expected, man, sink_wrap=None, real=real,
                  conflicts=conflicts):
            if conflicts[0] > 0:
                conflicts[0] -= 1
                return False, expected  # a rival won this round
            return real(table_dir, expected, man, sink_wrap)

        counters = _counters if name == "port" else _ref_counters
        manifest.set_commit_arbiter(lambda table_dir, f=flaky: f)
        before = counters()
        v0 = manifest.read_manifest(d).version
        got = manifest.commit_manifest(d, lambda live: live)
        assert got is not None and got.version == v0 + 1
        after = counters()
        assert after["fleet.cas_conflicts"] - \
            before.get("fleet.cas_conflicts", 0) == 2
        assert after["fleet.cas_commits"] - \
            before.get("fleet.cas_commits", 0) == 1
        monkeypatch.setenv(knob + "CAS_RETRIES", "1")
        manifest.set_commit_arbiter(
            lambda table_dir: lambda td, e, m, s=None: (False, e))
        with pytest.raises(OSError):
            manifest.commit_manifest(d, lambda live: live)
        manifest.set_commit_arbiter(None)


def test_crash_matrix_with_fleet_arbiter(tmp_path):
    """The crash matrix with the fleet's arbiter installed and the table's
    ring owner a remote peer that is not there: a commit that dies at any
    byte (the part writes, the boundary between the part rename and the
    manifest commit, the manifest) recovers to exactly the old or the new
    snapshot."""
    base = str(tmp_path / "m")
    probe = os.path.join(base, "base")
    ring = tcluster.HashRing(("a", "b"))
    owner = ring.owner_of_path(os.path.abspath(probe))
    me = "a" if owner == "b" else "b"  # the owner is always remote
    spec = ClusterSpec(self_name=me, peers={"a": "http://127.0.0.1:1",
                                            "b": "http://127.0.0.1:1"})
    router = tcluster.FleetRouter(spec)
    tmanifest.set_commit_arbiter(router.arbiter_resolver())

    def setup(d):
        tab = pa.table({"k": np.arange(600, dtype=np.int64),
                        "v": np.arange(600, dtype=np.int64)})
        w = pqt.DatasetWriter(d, pqt.schema_from_arrow(tab.schema))
        w.write_arrow(tab)
        w.commit()
        w.close()

    def ingest(d, wrap):
        tab = pa.table({"k": np.arange(600, 1200, dtype=np.int64),
                        "v": np.arange(600, 1200, dtype=np.int64)})
        w = pqt.DatasetWriter(d, pqt.schema_from_arrow(tab.schema),
                              rows_per_file=300, _sink_wrap=wrap)
        w.write_arrow(tab)
        w.commit()

    try:
        res = tfaults.table_crash_check(setup, ingest, base, samples=10,
                                        seed=7, device=CPU)
    finally:
        router.close()
    assert {r["outcome"] for r in res} == {"old", "new"}
    offs = [r["offset"] for r in res]
    assert max(offs) - 1 in offs  # the rename boundary was sampled


def test_arbiter_routes_to_the_owner_and_falls_back(tmp_path):
    """The resolver: a self-owned table and a peer with no URL resolve to
    the local compare-and-swap; a remote owner's arbiter that cannot reach
    it commits locally all the same."""
    d = str(tmp_path / "t")
    _seed_table(pqt, d)
    owner = tcluster.HashRing(("a", "b")).owner_of_path(os.path.abspath(d))
    other = "a" if owner == "b" else "b"
    mine = tcluster.FleetRouter(ClusterSpec(self_name=owner,
                                            peers={"a": None, "b": None}))
    theirs = tcluster.FleetRouter(ClusterSpec(
        self_name=other, peers={"a": "http://127.0.0.1:1",
                                "b": "http://127.0.0.1:1"}))
    try:
        assert mine.arbiter_resolver()(d) is None
        arbiter = theirs.arbiter_resolver()(d)
        assert arbiter is not None
        live = tmanifest.read_manifest(d)
        new = tmanifest.Manifest.deserialize(live.serialize())
        new.version = live.version + 1
        before = _counters()
        assert arbiter(d, live.version, new) == (True, new.version)
        assert _moved(before, "fleet.forwards") == 1
        assert tmanifest.read_manifest(d).version == new.version
    finally:
        mine.close()
        theirs.close()


def test_cross_daemon_writes_converge(tmp_path):
    """Daemons ingesting one table through the fleet: every commit goes
    through the arbiter, the versions advance one by one and every row
    lands; with every peer partitioned the local fallback still commits."""
    tdir = str(tmp_path / "wtbl")
    _seed_table(pqt, tdir, n=10)
    cfgs = {nm: {"datasets": {"wtbl": {"table": tdir, "writable": True}},
                 "tenants": {},
                 "cluster": {"self": nm, "peers": {n: None for n in NAMES}}}
            for nm in NAMES}
    servers = {}
    try:
        for nm in NAMES:
            servers[nm] = Server(cfgs[nm], port=0, device=CPU)
        urls = {nm: s.url for nm, s in servers.items()}
        for s in servers.values():
            s.set_peers(urls)
        v0 = tmanifest.read_manifest(tdir).version
        before = _counters()
        errors = []

        def write(i, nm):
            try:
                _post(servers[nm].url + "/v1/write",
                      {"dataset": "wtbl",
                       "rows": {"k": [1000 + i], "v": [i]}})
            except Exception as e:  # collected, raised below
                errors.append(e)

        threads = [threading.Thread(target=write, args=(i, NAMES[i % 3]))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not errors
        man = tmanifest.read_manifest(tdir)
        assert man.version == v0 + 6  # one linear history
        assert _moved(before, "fleet.cas_commits") == 6
        with pqt.open_table(tdir) as ds:
            got = ds.read(columns=["k"], device=CPU).to_arrow()["k"] \
                .to_pylist()
        assert set(range(1000, 1006)) <= set(got) and len(got) == 16
        # the arbiter dead mid-commit: the local compare-and-swap fallback
        # still commits (shared storage and the O_EXCL claim)
        chaos = tfaults.PeerChaos()
        tfaults.set_peer_chaos(chaos)
        for nm in NAMES:
            chaos.partition(nm)
        _post(servers["n2"].url + "/v1/write",
              {"dataset": "wtbl", "rows": {"k": [2000], "v": [1]}})
        assert tmanifest.read_manifest(tdir).version == v0 + 7
        # the reference reads the history the fleet wrote
        assert jmanifest.read_manifest(tdir).version == v0 + 7
    finally:
        for s in reversed(list(servers.values())):
            s.close()


def test_package_exports_the_fleet():
    from parquet_tpu_torch import serve

    for n in ("FleetRouter", "HashRing", "shard_key", "splitmix64",
              "ClusterSpec", "Server"):
        assert n in serve.__all__ and getattr(serve, n) is not None
    for n in ("PeerChaos", "set_peer_chaos", "peer_chaos"):
        assert n in tfaults.__all__
    assert serve.HashRing is tcluster.HashRing
    assert sorted(serve.__all__) == sorted(jpq.serve.__all__)
    assert hasattr(tremote.HttpTransport, "post")
    assert isinstance(RemoteError("x"), OSError)
