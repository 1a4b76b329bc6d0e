"""parquet_tpu_torch's remote sources (``io/remote.py``), their chaos tools
(``io/faults.py``: ``FaultInjectingRemoteTransport``, ``LocalRangeServer``)
and ``obs/metrics.py``, against parquet_tpu's, on the CPU.

Each package reads the same bytes (a seeded pyarrow file, 10,000 rows in
four row groups) from a ``LocalRangeServer`` of its own on loopback; the
port reads with ``device="cpu"``.  The cases are the port's side of
``tests/test_remote.py``: reads, streams, lookups, scans, aggregates and
datasets over URLs equal the JAX package's; each injected fault raises
the same error class; the breaker walks the same states; a hedge wins
where the reference's wins, its grant and bytes drain to 0 and an
abandoned one withdraws from the admission queue; auth hooks, listings,
latency classes and ``parallel_preads``.  No case asserts a wall-clock
bound: a hedge is held to who won (the transport's stats and
``remote.hedges_won``), a stall that must end is released by an event
the test sets, and the breaker's cooldown runs on a fake clock.  Every
test joins the threads it started (hedges, request threads) and drains
both packages' connection pools before its thread check.
"""

import io
import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu import errors as jerrors
from parquet_tpu.io import faults as jfaults
from parquet_tpu.io import remote as jremote
from parquet_tpu.obs import metrics as jmetrics

import parquet_tpu_torch as pqt
from parquet_tpu_torch import errors as terrors
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io import prefetch as tprefetch
from parquet_tpu_torch.io import remote as tremote
from parquet_tpu_torch.io.source import BytesSource, PreloadedSource
from parquet_tpu_torch.obs import metrics as tmetrics
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

N_ROWS = 10_000
ROW_GROUP = 2_500
CPU = "cpu"

PORT = SimpleNamespace(name="port", pq=pqt, remote=tremote, faults=tfaults,
                       errors=terrors, metrics=tmetrics,
                       env="PARQUET_TPU_TORCH_")
JAX = SimpleNamespace(name="jax", pq=parquet_tpu, remote=jremote,
                      faults=jfaults, errors=jerrors, metrics=jmetrics,
                      env="PARQUET_TPU_")
BOTH = [PORT, JAX]

FAST = pqt.FaultPolicy(max_retries=4, backoff_s=0.0)
SKIP = pqt.FaultPolicy(max_retries=4, backoff_s=0.0,
                       on_corrupt="skip_row_group")

# events a test's stalls wait on: set at teardown, so that no stalled
# attempt outlives its test
_RELEASE: list = []


def _make_raw(offset: int = 0, page_index: bool = False) -> bytes:
    t = pa.table({
        "x": pa.array(np.arange(offset, offset + N_ROWS, dtype=np.int64)),
        "s": pa.array([f"v{i % 17}" for i in range(N_ROWS)]),
    })
    buf = io.BytesIO()
    # gzip: a flipped payload bit fails zlib's check, a loud corruption
    papq.write_table(t, buf, row_group_size=ROW_GROUP, compression="gzip",
                     write_page_index=page_index)
    return buf.getvalue()


@pytest.fixture(scope="module")
def raw() -> bytes:
    return _make_raw()


@pytest.fixture(scope="module")
def clean(raw):
    return parquet_tpu.ParquetFile(raw).read()


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()  # they live for the process: not a test's threads


def _reset_remote_state():
    for pkg in BOTH:
        pkg.remote.reset_breakers()
        pkg.remote._reset_latency()
        pkg.remote._reset_validators()
        pkg.remote._reset_auth_hooks()
    parquet_tpu.clear_caches()
    pqt.clear_caches()


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """Hedging off unless a test pins it, fresh breakers, latencies,
    validators and caches; at the end every stall released, both pools
    drained, every thread the test started joined and none left."""
    for pkg in BOTH:
        monkeypatch.setenv(pkg.env + "REMOTE_HEDGE", "0")
    _reset_remote_state()
    tprefetch.prefetch_autotune().reset()
    before = threads_now()
    yield
    for ev in _RELEASE:
        ev.set()
    _RELEASE.clear()
    for pkg in BOTH:
        pkg.remote.drain_connection_pools()
    for t in threads_now() - before:
        t.join(timeout=10)
    _reset_remote_state()
    tprefetch.prefetch_autotune().reset()
    assert_no_thread_started(before)


def _release() -> threading.Event:
    ev = threading.Event()
    _RELEASE.append(ev)
    return ev


@pytest.fixture(scope="module")
def _jax_server(raw):
    """The JAX package's server, shared by the file (no case changes its
    objects): its close waits out a half-second poll."""
    with parquet_tpu.LocalRangeServer({"a.parquet": raw}) as jsrv:
        yield jsrv


@pytest.fixture()
def servers(raw, _jax_server):
    """One loopback server of each package over the same bytes."""
    with pqt.LocalRangeServer({"a.parquet": raw}) as srv:
        yield srv, _jax_server


def _chaos(pkg, url, **inject):
    tr = pkg.faults.FaultInjectingRemoteTransport(
        pkg.remote.HttpTransport(url), **inject)
    return pkg.remote.HttpSource(url, transport=tr), tr


def _counters(pkg) -> dict:
    return pkg.metrics.metrics_snapshot()["counters"]


def _delta(before: dict, after: dict, key: str):
    return after.get(key, 0) - before.get(key, 0)


def _same_read(got, want) -> None:
    from tests.test_torch_faults import _same_read as same

    same(got, want)


# ---------------------------------------------------------------------------
# the source, its opens, and what reads over it
# ---------------------------------------------------------------------------


def test_source_preads_and_closes(servers, raw):
    srv, _ = servers
    url = srv.url("a.parquet")
    src = pqt.HttpSource(url)
    assert src.size() == len(raw) and src.path == url
    assert src.pread(0, 4) == raw[:4]
    assert src.pread(100, 999) == raw[100:1099]
    assert src.pread(7, 0) == b""
    with pytest.raises(terrors.CorruptedError, match="invalid read"):
        src.pread(-1, 4)
    got_url, etag, last_modified, size = src.stat_key
    assert got_url == url and etag and last_modified and size == len(raw)
    src.close()
    with pytest.raises(ValueError, match="closed"):
        src.pread(0, 1)
    for cls in (pqt.HttpSource, pqt.ObjectStoreSource):
        s = cls(url)
        assert isinstance(s, pqt.HttpSource) and s.pread(0, 8) == raw[:8]
        s.close()
    s = pqt.io.source.as_source(url)
    assert type(s) is pqt.HttpSource
    s.close()


@pytest.mark.parametrize("case", ["missing", "unsatisfiable", "anonymous"])
def test_open_errors_match_jax(raw, case):
    """The same request fails with the same class and status in both."""
    got = []
    for pkg in BOTH:
        with pkg.pq.LocalRangeServer(
                {"a.parquet": raw},
                auth_token="sekrit" if case == "anonymous" else None) as srv:
            with pytest.raises(pkg.errors.RemoteError) as ei:
                if case == "unsatisfiable":
                    src = pkg.remote.HttpSource(srv.url("a.parquet"))
                    src.pread(len(raw) + 10, 4)
                else:
                    pkg.remote.HttpSource(srv.url(
                        "nope.parquet" if case == "missing" else "a.parquet"))
            got.append((type(ei.value).__name__, ei.value.status,
                        ei.value.retryable))
    assert got[0] == got[1]
    assert got[0] == ("RemoteTerminalError",
                      {"missing": 404, "unsatisfiable": 416,
                       "anonymous": 401}[case], False)


@pytest.mark.parametrize("ignore_range", [False, True])
def test_read_matches_jax(raw, ignore_range):
    """A server that ignores Range answers the whole body: the source
    slices it."""
    with pqt.LocalRangeServer({"a.parquet": raw},
                              ignore_range=ignore_range) as srv, \
            parquet_tpu.LocalRangeServer({"a.parquet": raw},
                                         ignore_range=ignore_range) as jsrv:
        got = pqt.ParquetFile(srv.url("a.parquet")).read(device=CPU)
        want = parquet_tpu.ParquetFile(jsrv.url("a.parquet")).read()
        _same_read(got, want)
        assert srv.request_count(method="HEAD") == 1


@pytest.mark.parametrize("prefetch", ["auto", "ring"])
def test_iter_batches_matches_jax(servers, monkeypatch, prefetch):
    from tests.test_torch_stream import _same_batches

    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH", prefetch)
    monkeypatch.setenv("PARQUET_TPU_PREFETCH", prefetch)
    srv, jsrv = servers
    got = list(pqt.ParquetFile(srv.url("a.parquet")).iter_batches(
        batch_rows=1700, device=CPU))
    want = list(parquet_tpu.ParquetFile(jsrv.url("a.parquet")).iter_batches(
        batch_rows=1700))
    _same_batches(got, want)


@pytest.mark.parametrize("how", ["list", "http_prefix", "s3_prefix"])
def test_dataset_matches_jax(raw, monkeypatch, how):
    """Two files named by URL, by a listed http prefix (nested names and
    other prefixes left out) and by a listed s3 prefix."""
    from tests.test_torch_dataset import _same_table

    files = {"bkt/tbl/a.parquet": raw, "bkt/tbl/b.parquet":
             _make_raw(N_ROWS), "bkt/tbl/nested/c.parquet": raw,
             "bkt/other.parquet": raw}
    s3 = how == "s3_prefix"
    with pqt.LocalRangeServer(files, s3_dialect=s3) as srv, \
            parquet_tpu.LocalRangeServer(files, s3_dialect=s3) as jsrv:
        def arg(server, pkg):
            if how == "list":
                return [server.url("bkt/tbl/a.parquet"),
                        server.url("bkt/tbl/b.parquet")]
            if how == "http_prefix":
                return server.url("bkt/tbl/")
            monkeypatch.setenv(pkg.env + "S3_ENDPOINT",
                               f"http://{server.host}:{server.port}")
            return "s3://bkt/tbl/"

        ds = pqt.Dataset(arg(srv, PORT))
        jds = parquet_tpu.Dataset(arg(jsrv, JAX))
        assert [p.rsplit("/", 1)[1] for p in ds.paths] == \
            [p.rsplit("/", 1)[1] for p in jds.paths] == \
            ["a.parquet", "b.parquet"]
        assert ds.num_rows == jds.num_rows == 2 * N_ROWS
        _same_table(ds.read(device=CPU), jds.read(), how)
        ds.close()
        jds.close()


def test_expand_paths_takes_urls_literally():
    url = "http://example.invalid/data/part-*.parquet"
    assert pqt.expand_paths([url, url, "s3://b/k.parquet"]) == \
        parquet_tpu.dataset.expand_paths([url, url, "s3://b/k.parquet"]) == \
        [url, "s3://b/k.parquet"]


@pytest.mark.parametrize("case", ["no_validators", "chaos_transport"])
def test_source_without_identity_is_never_cached(raw, case):
    with pqt.LocalRangeServer({"a.parquet": raw},
                              send_validators=case != "no_validators") as srv:
        url = srv.url("a.parquet")
        src = (pqt.HttpSource(url) if case == "no_validators"
               else _chaos(PORT, url)[0])
        assert src.stat_key is None
        pf = pqt.ParquetFile(src)
        assert pf._cache_key is None
        pf.read(device=CPU)
        gets = srv.request_count(method="GET")
        pqt.ParquetFile(src).close()  # the footer is read again
        assert srv.request_count(method="GET") > gets


def test_warm_reopen_is_one_head_and_no_get(servers, clean):
    srv, _ = servers
    url = srv.url("a.parquet")
    _same_read(pqt.ParquetFile(url).read(device=CPU), clean)
    heads = srv.request_count(method="HEAD")
    gets = srv.request_count(method="GET")
    st0 = pqt.cache_stats()
    pf = pqt.ParquetFile(url)
    assert srv.request_count(method="HEAD") == heads + 1
    assert srv.request_count(method="GET") == gets
    assert pqt.cache_stats().footer_hits == st0.footer_hits + 1
    _same_read(pf.read(device=CPU), clean)


def test_changed_validator_invalidates(servers):
    srv, _ = servers
    url = srv.url("a.parquet")
    x1 = int(pqt.ParquetFile(url).read(device=CPU)["x"].values[0])
    before = _counters(PORT)
    srv.put("a.parquet", _make_raw(offset=777))  # new bytes, new ETag
    x2 = int(pqt.ParquetFile(url).read(device=CPU)["x"].values[0])
    assert (x1, x2) == (0, 777)
    assert _delta(before, _counters(PORT), "remote.validator_changes") == 1


def test_validator_memo_is_bounded(monkeypatch):
    monkeypatch.setattr(tremote, "_VALIDATOR_CAP", 8)
    for i in range(40):
        tremote._note_validator(f"http://h/{i}", ("e", "m", i))
    assert list(tremote._VALIDATORS) == [f"http://h/{i}"
                                         for i in range(32, 40)]


def test_lookup_and_scan_match_jax(raw):
    from tests.test_torch_host_scan import _same
    from tests.test_torch_lookup import _assert_same

    data = _make_raw(page_index=True)
    with pqt.LocalRangeServer({"a.parquet": data}) as srv, \
            parquet_tpu.LocalRangeServer({"a.parquet": data}) as jsrv:
        keys = [0, 4242, 9999, 123456]
        got = pqt.ParquetFile(srv.url("a.parquet")).find_rows(
            "x", keys, columns=["s"], device=CPU)
        want = parquet_tpu.ParquetFile(jsrv.url("a.parquet")).find_rows(
            "x", keys, columns=["s"])
        _assert_same(got, want, [])
        assert [h.rows.tolist() for h in got] == [[0], [4242], [9999], []]
        expr_t = (pqt.col("x") >= 100) & (pqt.col("x") <= 110)
        expr_j = (parquet_tpu.col("x") >= 100) & (parquet_tpu.col("x") <= 110)
        _same(pqt.scan_expr(pqt.ParquetFile(srv.url("a.parquet")), expr_t,
                            device=CPU),
              parquet_tpu.scan_expr(parquet_tpu.ParquetFile(
                  jsrv.url("a.parquet")), expr_j), "scan_expr")


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

FAULTS = [
    (dict(refuse_rate=1.0), "RemoteTransientError"),
    (dict(reset_rate=1.0), "RemoteTransientError"),
    (dict(status_rate=1.0, status_code=503), "RemoteTransientError"),
    (dict(status_rate=1.0, status_code=500), "RemoteTransientError"),
    (dict(status_rate=1.0, status_code=403), "RemoteTerminalError"),
    (dict(status_rate=1.0, status_code=404), "RemoteTerminalError"),
    (dict(throttle_rate=1.0, retry_after=0.5), "RemoteThrottledError"),
    (dict(truncate_rate=1.0), "RemoteTransientError"),
    (dict(wrong_range_rate=1.0), "RemoteTransientError"),
]


@pytest.mark.parametrize("inject,cls", FAULTS)
def test_fault_to_error_class_matches_jax(servers, inject, cls):
    srv, jsrv = servers
    got = []
    for pkg, server in ((PORT, srv), (JAX, jsrv)):
        before = _counters(pkg)
        src, _ = _chaos(pkg, server.url("a.parquet"), **inject)
        with pytest.raises(pkg.errors.RemoteError) as ei:
            src.pread(128, 64)
        e = ei.value
        assert isinstance(e, OSError)
        assert e.host == f"{server.host}:{server.port}"
        assert pkg.faults.is_corrupt_oserror(e) == (not e.retryable)
        assert "range=128+64" in str(e) and "host=" in str(e)
        after = _counters(pkg)
        got.append((type(e).__name__, e.status, e.retryable, e.attempt,
                    e.offset, e.size, getattr(e, "retry_after", None),
                    {k: _delta(before, after, f"remote.errors{{class={k}}}")
                     for k in ("retryable", "terminal", "throttled")}))
    assert got[0] == got[1]
    assert got[0][0] == cls


@pytest.mark.parametrize("inject,stat", [
    (dict(refuse_rate=0.3, max_consecutive=2), "refused"),
    (dict(reset_rate=0.3, max_consecutive=2), "resets"),
    (dict(status_rate=0.3, status_code=503, max_consecutive=2), "statuses"),
    (dict(throttle_rate=0.3, retry_after=0.0, max_consecutive=2),
     "throttles"),
    (dict(truncate_rate=0.3, max_consecutive=2), "truncated"),
    (dict(wrong_range_rate=0.3, max_consecutive=2), "wrong_range"),
    (dict(stall_s=0.01, stall_rate=0.3), "stalls"),
])
def test_transient_faults_recover_to_the_jax_read(servers, clean, inject,
                                                  stat):
    srv, _ = servers
    src, tr = _chaos(PORT, srv.url("a.parquet"), seed=11, **inject)
    rep = pqt.ReadReport()
    _same_read(pqt.ParquetFile(src, policy=FAST).read(device=CPU,
                                                      report=rep), clean)
    assert getattr(tr.stats, stat) > 0
    if stat != "stalls":  # a stall is slow, not failed
        assert rep.retries > 0


def test_flipped_bodies_degrade_per_on_corrupt(servers, clean):
    """A flipped bit comes back on every attempt: 'raise' raises, and
    'skip_row_group' drops whole row groups, the rest equal to the JAX
    package's read of those row groups."""
    srv, _ = servers
    src, _ = _chaos(PORT, srv.url("a.parquet"), seed=0, flip_rate=0.5)
    with pytest.raises(Exception):
        pqt.ParquetFile(src, policy=FAST).read(device=CPU)
    src, tr = _chaos(PORT, srv.url("a.parquet"), seed=0, flip_rate=0.5)
    rep = pqt.ReadReport()
    got = pqt.ParquetFile(src, policy=SKIP).read(device=CPU, report=rep)
    assert tr.stats.flipped > 0 and rep.row_groups_skipped
    assert rep.rows_dropped == ROW_GROUP * len(rep.row_groups_skipped)
    kept = [i for i in range(N_ROWS // ROW_GROUP)
            if i not in rep.row_groups_skipped]
    want = np.concatenate([np.arange(i * ROW_GROUP, (i + 1) * ROW_GROUP)
                           for i in kept])
    np.testing.assert_array_equal(got["x"].values.numpy(), want)


def test_retry_after_stretches_the_backoff(servers, monkeypatch):
    slept = []
    monkeypatch.setattr(tfaults.time, "sleep", slept.append)
    srv, _ = servers
    src, tr = _chaos(PORT, srv.url("a.parquet"), throttle_rate=1.0,
                     retry_after=0.15, max_consecutive=1)
    pqt.ParquetFile(src, policy=pqt.FaultPolicy(max_retries=2,
                                                backoff_s=0.0)).close()
    assert tr.stats.throttles > 0 and slept and min(slept) >= 0.15


def test_seed_soak_matches_the_jax_read(servers, clean):
    srv, _ = servers
    injected = 0
    for seed in range(4):
        src, tr = _chaos(PORT, srv.url("a.parquet"), seed=seed,
                         refuse_rate=0.15, reset_rate=0.1, status_rate=0.1,
                         truncate_rate=0.1, max_consecutive=2)
        _same_read(pqt.ParquetFile(src, policy=FAST).read(device=CPU),
                   clean)
        injected += (tr.stats.refused + tr.stats.resets + tr.stats.statuses
                     + tr.stats.truncated)
    assert injected > 0


# ---------------------------------------------------------------------------
# hedged preads
# ---------------------------------------------------------------------------


def test_hedge_outcome_matches_jax(servers, raw, monkeypatch):
    """The first attempt of the range stalls: in both packages the hedge
    is issued and wins, with the same bytes and the same transport
    stats."""
    srv, jsrv = servers
    got = []
    for pkg, server in ((PORT, srv), (JAX, jsrv)):
        monkeypatch.setenv(pkg.env + "REMOTE_HEDGE", "0.01")
        # the port's stall ends when released; the reference's sleeps
        inject = (dict(stall_release=_release(), stall_s=60.0)
                  if pkg is PORT else dict(stall_s=0.5))
        src, tr = _chaos(pkg, server.url("a.parquet"), stall_attempts=1,
                         **inject)
        before = _counters(pkg)
        assert src.pread(0, 4096) == raw[:4096]
        after = _counters(pkg)
        for ev in _RELEASE:
            ev.set()
        for t in threading.enumerate():
            if t.name.endswith(("remote-pread", "remote-hedge")):
                t.join(timeout=10)
        got.append((_delta(before, after, "remote.hedges_issued"),
                    _delta(before, after, "remote.hedges_won"),
                    tr.stats.requests, tr.stats.stalls))
    assert got[0] == got[1] == (1, 1, 2, 1)
    assert tremote.hedge_in_flight_bytes() == 0


def test_hedged_read_matches_the_jax_read(servers, clean, monkeypatch):
    """Every range's first attempt stalls (until the test ends): the
    whole read comes from the hedges and equals the reference's read."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", "0.001")
    srv, _ = servers
    src, tr = _chaos(PORT, srv.url("a.parquet"), stall_s=60.0,
                     stall_attempts=1, stall_release=_release())
    before = _counters(PORT)
    _same_read(pqt.ParquetFile(src).read(device=CPU), clean)
    won = _delta(before, _counters(PORT), "remote.hedges_won")
    assert won == tr.stats.stalls > 0


def test_hedge_delay_matches_jax(monkeypatch):
    for pkg in BOTH:
        monkeypatch.setenv(pkg.env + "REMOTE_HEDGE", "auto")
        pkg.remote._H_PREAD_S._reset()
    delays = [(tremote.hedge_delay_s(), jremote.hedge_delay_s())]
    for v in np.random.default_rng(5).exponential(0.05, 64):
        tremote._H_PREAD_S.observe(float(v))
        jremote._H_PREAD_S.observe(float(v))
        delays.append((tremote.hedge_delay_s(), jremote.hedge_delay_s()))
    assert all(a == b for a, b in delays)
    assert delays[0][0] == tremote.DEFAULT_HEDGE_DELAY_S
    assert delays[-1][0] != tremote.DEFAULT_HEDGE_DELAY_S
    for mode, want in (("0.123", 0.123), ("off", None), ("0", None)):
        monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", mode)
        assert tremote.hedge_delay_s() == want
    for pkg in BOTH:
        pkg.remote._H_PREAD_S._reset()


def test_hedge_budget_drains_to_zero(servers, raw, monkeypatch):
    """Eight threads of hedged preads under a 1 MiB read budget: every
    grant and every hedge byte comes back."""
    budget = 1 << 20
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", "0.001")
    monkeypatch.setenv("PARQUET_TPU_TORCH_READ_BUDGET", str(budget))
    adm = tpool.read_admission()
    adm._reset()
    srv, _ = servers
    src, tr = _chaos(PORT, srv.url("a.parquet"), stall_s=0.02,
                     stall_rate=0.5, seed=3)
    before = _counters(PORT)
    errs = []
    span = 4096

    def worker(w):
        try:
            for j in range(6):
                off = ((w * 6 + j) * 7919) % (len(raw) - span)
                assert src.pread(off, span) == raw[off:off + span]
        except Exception as e:  # raised below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for t in threading.enumerate():
        if t.name.endswith(("remote-pread", "remote-hedge")):
            t.join(timeout=10)
    assert not errs
    assert tr.stats.stalls > 0
    assert _delta(before, _counters(PORT), "remote.hedges_issued") > 0
    assert tremote.hedge_in_flight_bytes() == 0
    assert adm.in_flight_bytes() == 0 and adm.high_water <= budget


def test_abandoned_hedge_withdraws_from_the_admission_queue(servers, raw,
                                                            monkeypatch):
    """The budget is held, so the hedge queues; the primary wins; the
    hedge's ticket must leave the queue though the budget never frees."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", "0.01")
    monkeypatch.setenv("PARQUET_TPU_TORCH_READ_BUDGET", str(1 << 20))
    adm = tpool.read_admission()
    held = adm.acquire(1 << 20, tier="scan")
    try:
        srv, _ = servers
        queued = threading.Event()

        class Primary:
            """The primary's fetch waits until the hedge is queued."""

            def __init__(self, inner):
                self.inner, self.host = inner, inner.host

            def head(self, **kw):
                return self.inner.head(**kw)

            def get_range(self, offset, size, **kw):
                queued.wait(10)
                return self.inner.get_range(offset, size, **kw)

            def close(self):
                self.inner.close()

        url = srv.url("a.parquet")
        src = pqt.HttpSource(url,
                             transport=Primary(pqt.HttpTransport(url)))

        def watch():
            while adm.queue_depth() == 0 and not queued.is_set():
                time.sleep(0.001)
            queued.set()

        w = threading.Thread(target=watch)
        w.start()
        assert src.pread(0, 4096) == raw[:4096]  # the primary won
        w.join()
        for t in threading.enumerate():
            if t.name.endswith("remote-hedge"):
                t.join(timeout=10)
        assert adm.queue_depth() == 0
        assert tremote.hedge_in_flight_bytes() == 0
    finally:
        adm.release(held, tier="scan")


def test_failed_primary_raises_while_the_hedge_stalls(servers, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", "0.001")
    srv, _ = servers
    url = srv.url("a.parquet")
    hedge_started, release = threading.Event(), _release()

    class Split:
        """Attempt 0 fails once the hedge is running; the hedge stalls."""

        def __init__(self, inner):
            self.inner, self.host = inner, inner.host
            self.n = 0
            self.lock = threading.Lock()

        def head(self, **kw):
            return self.inner.head(**kw)

        def get_range(self, offset, size, **kw):
            with self.lock:
                a, self.n = self.n, self.n + 1
            if a == 0:
                hedge_started.wait(10)
                raise ConnectionResetError("primary dies")
            hedge_started.set()
            release.wait(60)
            return self.inner.get_range(offset, size, **kw)

        def close(self):
            self.inner.close()

    src = pqt.HttpSource(url, transport=Split(pqt.HttpTransport(url)))
    with pytest.raises(terrors.RemoteTransientError, match="primary dies"):
        src.pread(0, 256)
    assert not release.is_set()  # the hedge was still stalled


def test_deadline_ends_a_stalled_hedged_read(servers, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", "0.01")
    srv, _ = servers
    pqt.ParquetFile(srv.url("a.parquet")).close()  # the footer, cached
    src, tr = _chaos(PORT, srv.url("a.parquet"), stall_s=60.0,
                     stall_attempts=4, stall_release=_release())
    with pytest.raises(terrors.DeadlineError) as ei:
        pqt.ParquetFile(src, policy=pqt.FaultPolicy(
            deadline_s=0.2, backoff_s=0.0)).read(device=CPU)
    assert "hedged" in str(ei.value) or "deadline" in str(ei.value)
    assert tr.stats.stalls > 0
    for ev in _RELEASE:
        ev.set()
    for t in threading.enumerate():
        if t.name.endswith(("remote-pread", "remote-hedge")):
            t.join(timeout=10)
    assert tremote.hedge_in_flight_bytes() == 0


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


class _Clock:
    """A monotonic clock the test moves: the breaker's cooldown without
    a sleep."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _breaker_trace(pkg, url, monkeypatch) -> list:
    clock = _Clock()
    monkeypatch.setattr(pkg.remote, "time", clock)
    monkeypatch.setenv(pkg.env + "REMOTE_BREAKER", "3")
    monkeypatch.setenv(pkg.env + "REMOTE_BREAKER_COOLDOWN", "1.0")
    src, tr = _chaos(pkg, url, refuse_rate=1.0)
    b = pkg.remote.breaker_for(src.host)
    before = _counters(pkg)
    trace = []

    def step(what):
        try:
            src.pread(0, 64)
            out = "ok"
        except Exception as e:
            out = type(e).__name__
        trace.append((what, out, b.state, b.consecutive_failures,
                      tr.stats.requests))

    for i in range(3):
        step(f"refused {i}")
    step("fails fast")
    clock.t += 0.5
    step("still cooling")
    clock.t += 0.6
    step("probe refused")
    clock.t += 1.1
    tr.refuse_rate, tr.throttle_rate = 0.0, 1.0
    step("probe throttled")
    step("next probe throttled")
    tr.throttle_rate = 0.0
    step("probe answers")
    after = _counters(pkg)
    trace.append({k: _delta(before, after, k) for k in after
                  if k.startswith(("remote.breaker", "remote.errors"))})
    return trace


def test_breaker_cycle_matches_jax(servers, monkeypatch):
    """open after three failures, fail fast, half-open probe fails and
    reopens, a throttled probe frees its slot, an answering probe
    closes."""
    srv, jsrv = servers
    got = _breaker_trace(PORT, srv.url("a.parquet"), monkeypatch)
    want = _breaker_trace(JAX, jsrv.url("a.parquet"), monkeypatch)
    assert got == want
    assert [s[2] for s in got[:-1]] == [
        "closed", "closed", "open", "open", "open", "open", "half_open",
        "half_open", "closed"]
    assert got[3][4] == got[2][4]  # the open circuit sent nothing


@pytest.mark.parametrize("inject", [dict(truncate_rate=1.0),
                                    dict(wrong_range_rate=1.0),
                                    dict(status_rate=1.0, status_code=404)])
def test_answers_do_not_trip_the_breaker(servers, monkeypatch, inject):
    """A torn body, a wrong range or a 404 came from a host that
    answered: the streak stays 0 in both packages."""
    srv, jsrv = servers
    for pkg, server in ((PORT, srv), (JAX, jsrv)):
        monkeypatch.setenv(pkg.env + "REMOTE_BREAKER", "2")
        src, _ = _chaos(pkg, server.url("a.parquet"), **inject)
        for _ in range(4):
            with pytest.raises(pkg.errors.RemoteError):
                src.pread(0, 4096)
        b = pkg.remote.breaker_for(src.host)
        assert (b.state, b.consecutive_failures) == ("closed", 0)


def test_open_circuit_never_blocks_a_healthy_host(raw, clean, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_BREAKER", "1")
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_BREAKER_COOLDOWN", "30")
    with pqt.LocalRangeServer({"a.parquet": raw}) as healthy, \
            pqt.LocalRangeServer({"a.parquet": raw}) as doomed:
        bad = doomed.url("a.parquet")
        with pytest.raises(terrors.RemoteTransientError):
            _chaos(PORT, bad, refuse_rate=1.0)[0].pread(0, 64)
        assert tremote.breaker_for(bad.split("/")[2]).state == "open"
        heads = doomed.request_count()
        rep = pqt.ReadReport()
        got = pqt.Dataset([healthy.url("a.parquet"), bad],
                          policy=SKIP).read(device=CPU, report=rep)
        assert rep.files_skipped == [bad]
        assert doomed.request_count() == heads  # refused unsent
        _same_read(got, clean)
        assert tremote.breaker_for(
            healthy.url("a.parquet").split("/")[2]).state == "closed"


def test_stale_pooled_connection_is_retried(raw):
    with pqt.LocalRangeServer({"a.parquet": raw}) as srv:
        tr = pqt.HttpTransport(srv.url("a.parquet"))
        assert tr.get_range(0, 16)[2] == raw[:16]
        assert tr.idle_connections() == 1
        dead = tr._pool.get()
        dead.sock.close()  # as if the server idled it out
        tr._pool.put(dead)
        status, _, body = tr.get_range(16, 16)
        assert (status, body) == (206, raw[16:32])


def test_connection_pool_is_shared_per_host(servers, raw):
    srv, _ = servers
    srv.put("c.parquet", raw)
    t1 = pqt.HttpTransport(srv.url("a.parquet"))
    t2 = pqt.HttpTransport(srv.url("c.parquet"))
    t1.get_range(0, 8)
    assert t2.idle_connections() == 1
    assert t2.get_range(0, 8)[2] == raw[:8]
    assert t2.idle_connections() == 1  # the same socket, back in the pool
    assert tremote.drain_connection_pools() >= 1
    assert t1.idle_connections() == 0


# ---------------------------------------------------------------------------
# latency classes and the prefetcher
# ---------------------------------------------------------------------------


def test_remote_chain_rings_on_one_core(servers, monkeypatch):
    srv, _ = servers
    src = pqt.HttpSource(srv.url("a.parquet"))
    monkeypatch.setattr(tpool, "available_cpus", lambda: 1)
    pre = tprefetch.make_prefetcher(src)
    try:
        assert pre is not None and pre.backend == "ring"
        assert pre.latency_class == "remote"
        assert (pre.depth, pre.window_bytes) == \
            tprefetch._CLASS_DEFAULTS["remote"]
    finally:
        pre.close()
        src.close()
    local = tprefetch.make_prefetcher(
        pqt.io.source.FileLikeSource(io.BytesIO(b"x" * 64)))
    assert local is None  # a local file on one core: no ring


def test_latency_class_follows_the_host_ewma(servers):
    srv, _ = servers
    src = pqt.HttpSource(srv.url("a.parquet"))
    assert src.latency_class == "remote"
    for _ in range(50):
        tremote._observe_pread(0.2, src.host)
    assert src.latency_class == "remote_far"
    assert tremote.observed_pread_ewma("elsewhere:80") is None
    assert tremote.remote_debug()["pread_ewma_s"][src.host] == \
        pytest.approx(0.2)
    src.close()


def test_autotune_state_is_per_class_as_jax():
    from parquet_tpu.io import prefetch as jprefetch

    got = []
    for mod in (tprefetch, jprefetch):
        tuner = mod.prefetch_autotune()
        tuner.reset()
        tuner.observe(mod.ReadStats(windows_issued=4, pool_wait_s=1.0),
                      "remote")
        got.append((tuner.suggest("remote"), tuner.suggest(),
                    tuner.suggest("local"), mod._CLASS_DEFAULTS["remote"],
                    mod._CLASS_DEFAULTS["remote_far"]))
        tuner.reset()
    assert got[0] == got[1]
    assert got[0][:3] == ((5, None), (None, None), (None, None))


def test_active_deadline_is_visible_below_the_policy(raw):
    seen = []

    class Spy(BytesSource):
        def pread(self, offset, size):
            seen.append(tfaults.active_deadline())
            return super().pread(offset, size)

    ps = tfaults.PolicySource(Spy(raw), pqt.FaultPolicy(deadline_s=5.0))
    with ps.operation():
        ps.pread(0, 4)
    assert seen and seen[0] is not None and seen[0].remaining() > 0
    assert tfaults.active_deadline() is None


# ---------------------------------------------------------------------------
# auth hooks
# ---------------------------------------------------------------------------


def _auth_trace(pkg, raw, case, monkeypatch) -> tuple:
    monkeypatch.setenv(pkg.env + "REMOTE_AUTH_RETRY", "1")
    state = {"token": "old", "calls": []}

    def hook(url, refresh):
        state["calls"].append(refresh)
        if case == "exhausted":
            return {"Authorization": "Bearer wrong-forever"}
        if case == "bad_return":
            return "Bearer x"
        if refresh:
            state["token"] = "new"
        out = {"Authorization": f"Bearer {state['token']}"}
        if case == "presigned":
            out["url"] = url + "?sig=abc123"
        return out

    with pkg.pq.LocalRangeServer({"a.parquet": raw},
                                 auth_token="old") as srv:
        url = srv.url("a.parquet")
        before = _counters(pkg)
        try:
            if case == "registry":
                pkg.remote.register_auth_hook(url.rsplit("/", 1)[0], hook)
                src = pkg.remote.HttpSource(url)
            else:
                src = pkg.remote.HttpSource(
                    url, auth=None if case == "anonymous" else hook)
            if case == "refresh":
                srv.set_auth_token("new")  # the source's token is stale
            rows = sum(len(src.pread(o, 512)) for o in (0, 4096, 8192))
            out = ("ok", rows)
        except Exception as e:
            out = (type(e).__name__, getattr(e, "status", None))
        presigned = any(m == "GET" for m, _n, _r in srv.requests)
        return (out, state["calls"],
                _delta(before, _counters(pkg), "remote.auth_refreshes"),
                presigned)


@pytest.mark.parametrize("case", ["anonymous", "header", "refresh",
                                  "exhausted", "registry", "presigned",
                                  "bad_return"])
def test_auth_hooks_match_jax(raw, monkeypatch, case):
    got = _auth_trace(PORT, raw, case, monkeypatch)
    want = _auth_trace(JAX, raw, case, monkeypatch)
    assert got == want
    assert got[0][0] == {"anonymous": "RemoteTerminalError",
                         "exhausted": "RemoteTerminalError",
                         "bad_return": "RemoteTerminalError"}.get(case, "ok")
    assert got[2] == (1 if case in ("refresh", "exhausted") else 0)


def test_auth_hook_must_be_callable():
    with pytest.raises(TypeError):
        tremote.register_auth_hook("http://x/", "not-callable")


def test_auth_composes_with_chaos(raw):
    def hook(url, refresh):
        return {"Authorization": "Bearer sekrit"}

    with pqt.LocalRangeServer({"a.parquet": raw},
                              auth_token="sekrit") as srv:
        url = srv.url("a.parquet")
        want = pqt.ParquetFile(pqt.HttpSource(url, auth=hook)).read(
            device=CPU)
        tr = pqt.FaultInjectingRemoteTransport(
            pqt.HttpTransport(url), seed=3, reset_rate=0.25,
            status_rate=0.2, max_consecutive=2)
        got = pqt.ParquetFile(pqt.HttpSource(url, transport=tr, auth=hook),
                              policy=pqt.FaultPolicy(max_retries=8,
                                                     backoff_s=0.0)).read(
            device=CPU)
        assert tr.stats.resets + tr.stats.statuses > 0
        from tests.test_torch_faults import _host

        for name in want:
            assert list(got) == list(want)
            np.testing.assert_array_equal(_host(got[name]),
                                          _host(want[name]))


# ---------------------------------------------------------------------------
# listings
# ---------------------------------------------------------------------------


def _listing(pkg, raw, monkeypatch, case):
    files = {"data/b.parquet": raw, "data/a.parquet": raw,
             "data/nested/c.parquet": raw, "other.parquet": raw}
    if case.startswith("s3"):
        files = {f"bkt/tbl/part-{i}.parquet": raw for i in range(5)}
        files["bkt/tbl/nested/deep.parquet"] = raw
        files["bkt/other/x.parquet"] = raw
    with pkg.pq.LocalRangeServer(
            files, s3_dialect=case.startswith("s3"), s3_max_keys=2,
            auth_token="sekrit" if case == "private" else None) as srv:
        monkeypatch.setenv(pkg.env + "S3_ENDPOINT",
                           f"http://{srv.host}:{srv.port}")
        try:
            if case == "s3":
                got = pkg.remote.list_prefix_s3("s3://bkt/tbl/")
            elif case == "s3_empty":
                got = pkg.remote.list_prefix_s3("s3://bkt/void/")
            else:
                got = pkg.remote.list_prefix(srv.url(
                    "void/" if case == "empty" else "data/"))
            got = [u.split(f"{srv.port}/")[-1] for u in got]
        except Exception as e:
            got = type(e).__name__
        pages = sum(1 for m, n, _r in srv.requests if m == "GET")
    return got, pages


@pytest.mark.parametrize("case", ["http", "empty", "private", "s3",
                                  "s3_empty"])
def test_listings_match_jax(raw, monkeypatch, case):
    got = _listing(PORT, raw, monkeypatch, case)
    want = _listing(JAX, raw, monkeypatch, case)
    assert got == want
    assert got[0] == {
        "http": ["data/a.parquet", "data/b.parquet"],
        "empty": "FileNotFoundError", "private": "RemoteTerminalError",
        "s3": [f"s3://bkt/tbl/part-{i}.parquet" for i in range(5)],
        "s3_empty": "FileNotFoundError"}[case]
    if case == "s3":
        assert got[1] == 3  # five keys, two to a page


def test_s3_urls_resolve_path_style(raw, clean, monkeypatch):
    monkeypatch.delenv("PARQUET_TPU_TORCH_S3_ENDPOINT", raising=False)
    with pytest.raises(ValueError, match="PARQUET_TPU_TORCH_S3_ENDPOINT"):
        tremote.resolve_s3_url("s3://bkt/key.parquet")
    monkeypatch.setenv("PARQUET_TPU_TORCH_S3_ENDPOINT", "http://ep:9000/")
    assert tremote.resolve_s3_url("s3://bkt/a/b.parquet") == \
        "http://ep:9000/bkt/a/b.parquet"
    with pytest.raises(ValueError):
        tremote.resolve_s3_url("s3://")
    with pqt.LocalRangeServer({"bkt/data.parquet": raw},
                              s3_dialect=True) as srv:
        monkeypatch.setenv("PARQUET_TPU_TORCH_S3_ENDPOINT",
                           f"http://{srv.host}:{srv.port}")
        src = pqt.io.source.as_source("s3://bkt/data.parquet")
        assert type(src) is pqt.ObjectStoreSource
        src.close()
        _same_read(pqt.ParquetFile("s3://bkt/data.parquet").read(
            device=CPU), clean)


def test_listing_helpers_match_jax():
    body = b'<a href="x.parquet">x</a><a href="../">up</a><a href="d/">d</a>'
    for doc in (b'["b.parquet", "a.parquet", "d/"]',
                b'{"files": ["z.parquet"]}', body, b"<nothing/>"):
        assert tremote._parse_listing(doc, "http://h/p/") == \
            jremote._parse_listing(doc, "http://h/p/")
    with pytest.raises(terrors.RemoteTransientError):
        tremote._parse_s3_listing(b"<torn")
    with pytest.raises(terrors.RemoteTransientError):
        tremote.gunzip_body(b"\x1f\x8b\x08torn")
    import gzip

    assert tremote.gunzip_body(gzip.compress(b"abc")) == b"abc"
    for status in (200, 206, 404, 416, 429, 500, 503):
        got = want = None
        try:
            tremote.classify_status(status, {"retry-after": "2"}, "h", "p")
        except terrors.RemoteError as e:
            got = (type(e).__name__, getattr(e, "retry_after", None))
        try:
            jremote.classify_status(status, {"retry-after": "2"}, "h", "p")
        except jerrors.RemoteError as e:
            want = (type(e).__name__, getattr(e, "retry_after", None))
        assert got == want


# ---------------------------------------------------------------------------
# several ranges at once, and the remote aggregate
# ---------------------------------------------------------------------------


def test_parallel_preads_in_order_and_counted(servers, raw, monkeypatch):
    srv, _ = servers
    src = pqt.HttpSource(srv.url("a.parquet"))
    assert tremote.parallel_pread_slots(src) == 4
    assert tremote.parallel_pread_slots(
        tfaults.PolicySource(src, FAST)) == 4
    assert tremote.parallel_pread_slots(BytesSource(raw)) == 0
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_PARALLEL", "1")
    assert tremote.parallel_pread_slots(src) == 0
    ranges = [(0, 128), (4096, 64), (len(raw) - 256, 256), (900, 7)]
    before = _counters(PORT)
    blocks = tremote.parallel_preads(src, ranges, 3)
    assert _delta(before, _counters(PORT), "remote.parallel_preads") == 4
    assert blocks == [(o, raw[o:o + s]) for o, s in ranges]
    pre = PreloadedSource(src, blocks)
    assert pre.pread(4100, 8) == raw[4100:4108]
    gets = srv.request_count(method="GET")
    assert pre.pread(0, 4096) == raw[:4096]  # outside: read through
    assert srv.request_count(method="GET") == gets + 1
    with pytest.raises(terrors.RemoteTerminalError):
        tremote.parallel_preads(src, [(0, 8), (len(raw) + 5, 8)], 2)


def _agg_file() -> bytes:
    rng = np.random.default_rng(0)
    n = 30_000
    t = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                  "v": pa.array(rng.integers(-1000, 1000, n)),
                  "c": pa.array(rng.integers(0, 12, n).astype(np.int32))})
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=10_000, data_page_size=4096,
                     write_page_index=True, use_dictionary=["c"])
    return buf.getvalue()


@pytest.mark.parametrize("inject", [None, dict(refuse_rate=0.3),
                                    dict(status_rate=0.3, status_code=503),
                                    dict(truncate_rate=0.3),
                                    dict(wrong_range_rate=0.3)])
def test_aggregate_over_a_url_matches_jax(inject):
    from tests.test_torch_aggregate import _same_result

    raw = _agg_file()
    aggs = lambda pq: [pq.count(), pq.sum_("v"), pq.min_("v"),  # noqa: E731
                       pq.max_("v"), pq.count_distinct("c"),
                       pq.sum_("c")]
    where = lambda pq: pq.col("k").between(500, 21_000)  # noqa: E731
    want = parquet_tpu.ParquetFile(raw).aggregate(aggs(parquet_tpu),
                                                  where=where(parquet_tpu))
    with pqt.LocalRangeServer({"f.parquet": raw}) as srv:
        url = srv.url("f.parquet")
        src = (pqt.HttpSource(url) if inject is None else
               _chaos(PORT, url, seed=7, max_consecutive=2, **inject)[0])
        before = _counters(PORT)
        got = pqt.ParquetFile(src, policy=pqt.FaultPolicy(
            max_retries=5, backoff_s=0.0)).aggregate(
                aggs(pqt), where=where(pqt), device=CPU)
        _same_result(got, want)
        assert _delta(before, _counters(PORT),
                      "remote.parallel_preads") > 0


# ---------------------------------------------------------------------------
# the metrics registry and the server
# ---------------------------------------------------------------------------


def test_histogram_and_snapshots_match_jax():
    vals = np.random.default_rng(1).exponential(0.01, 500)
    th = tmetrics.Histogram("t")
    jh = jmetrics.Histogram("t")
    assert th.percentile(0.5) is None and th.buckets == jh.buckets
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    assert th.summary() == jh.summary()
    assert th.bucket_counts() == jh.bucket_counts()
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("a", labels={"k": "v"})
    c.inc(3)
    reg.gauge("g").set(7)
    reg.histogram("h").observe(0.5)
    with pytest.raises(TypeError):
        reg.gauge("a", labels={"k": "v"})
    with pytest.raises(ValueError):
        c.inc(-1)
    before = reg.snapshot()
    c.inc(2)
    d = tmetrics.metrics_delta(before, reg.snapshot())
    assert d["counters"] == {"a{k=v}": 2} and d["gauges"] == {"g": 7}
    reg.reset()
    assert reg.snapshot()["counters"] == {"a{k=v}": 0}
    snap = pqt.metrics_snapshot()
    for key in ("remote.preads", "remote.bytes", "remote.hedges_won",
                "remote.errors{class=throttled}",
                "remote.breaker_transitions{state=half_open}",
                "remote.parallel_preads", "remote.auth_refreshes"):
        assert key in snap["counters"], key
    assert "remote.pread_s" in snap["histograms"]


def test_server_close_ends_its_keepalive_threads(raw):
    before = threads_now()
    srv = pqt.LocalRangeServer({"a.parquet": raw})
    tr = pqt.HttpTransport(srv.url("a.parquet"))
    assert tr.get_range(0, 8)[2] == raw[:8]
    assert tr.idle_connections() == 1  # its request thread waits on it
    assert len(threads_now() - before) == 2
    srv.close()
    assert threads_now() - before == set()
    srv.close()  # twice is harmless
