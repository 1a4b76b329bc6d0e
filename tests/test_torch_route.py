"""The routed scan of parquet_tpu_torch (``io/planner.py``'s route half:
``CostInputs``, ``choose_route``, ``device_route_supported``,
``route_scan``, ``RouteHistory``; ``parallel/host_scan.py::scan``) on
the CPU against parquet_tpu's, and against the port's own device scan.

``choose_route`` is a pure function: each branch is compared on stubbed
inputs, with the port's priors set to the reference's by ``monkeypatch``
(the port's are the H100's own).  ``device_route_supported`` is compared
on every refusal shape, and held to the port's ``stage_scan``: it refuses
exactly what the device scan refuses from the footer.  The scans compare
results: on the CPU the host scan runs, as the reference's does; pinned to
the device route (``PARQUET_TPU_TORCH_ROUTE``) the port's scan equals its
``scan_filtered_device``, and a refusal seen only in the pages (a
dictionary key chunk that falls back to PLAIN mid-chunk) falls back to
the host scan.  Files are small; no thread is left after any test."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from parquet_tpu.io import planner as jplanner
from parquet_tpu.io.reader import ParquetFile as JParquetFile
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table
from parquet_tpu.parallel import host_scan as jhs

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import planner as tplanner
from parquet_tpu_torch.parallel import host_scan as ths
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")
PIN = "PARQUET_TPU_TORCH_ROUTE"
PRIORS = ("_HOST_PRIOR_GBPS", "_DEVICE_PRIOR_GBPS", "_DEVICE_FIXED_S",
          "_DEVICE_MIN_BYTES", "_POOL_MIN_CELLS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(PIN, raising=False)
    monkeypatch.delenv("PARQUET_TPU_ROUTE", raising=False)
    pqt.route_history().reset()
    jplanner.route_history().reset()
    before = threads_now()
    yield
    pqt.route_history().reset()
    jplanner.route_history().reset()
    assert_no_thread_started(before)


@pytest.fixture
def ref_priors(monkeypatch):
    """The port's cost model on the reference's priors."""
    for name in PRIORS:
        monkeypatch.setattr(tplanner, name, getattr(jplanner, name))


def _write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    jwrite_table(table, buf, JWriterOptions(**kw))
    return buf.getvalue()


def _main_file() -> bytes:
    rng = np.random.default_rng(5)
    n = 4000
    d = rng.random(n) * 2 - 1
    d[::50], d[::61], d[::67] = np.nan, 0.0, -0.0
    return _write(pa.table({
        "k": pa.array(np.sort(rng.integers(0, 10_000, n)).astype(np.int32)),
        "d": pa.array(d),
        "s": pa.array([f"c{i % 30:02d}" for i in range(n)]),
        "v": pa.array(np.arange(n, dtype=np.int64)),
        "p": pa.array([f"plain{i}" for i in range(n)])}),
        row_group_size=1000, data_page_size=1 << 11, dictionary=["s"],
        bloom_filters={"k": 10})


# ---------------------------------------------------------------------------
# choose_route
# ---------------------------------------------------------------------------

BASE = dict(supported=True, est_bytes=64 << 20, est_rows=1 << 20,
            total_rows=1 << 22, n_columns=4)
STUBS = [
    dict(backend="cpu", **BASE),
    dict(backend="gpu", **BASE),
    dict(backend="gpu", **dict(BASE, supported=False),
         reason="key is a decimal byte array"),
    dict(backend="gpu", **dict(BASE, est_bytes=1 << 10)),
    dict(backend="gpu", host_gbps=50.0, device_gbps=0.01, **BASE),
    dict(backend="gpu", host_gbps=0.5, device_gbps=40.0, **BASE),
    dict(backend="gpu", host_gbps=2.0, **dict(BASE, reuse=8)),
    dict(backend="gpu", **dict(BASE, est_rows=10, n_columns=2)),
    dict(backend="gpu", pin="host", **BASE),
    dict(backend="gpu", pin="device", **BASE),
    dict(backend="cpu", pin="device", **BASE),
    dict(backend="gpu", pin="device", **dict(BASE, supported=False),
         reason="key 'x' has physical type INT96"),
    dict(backend="gpu", **dict(BASE, est_bytes=5 << 20, est_rows=3_000_000,
                               n_columns=1)),
]


@pytest.mark.parametrize("stub", range(len(STUBS)))
def test_choose_route_matches_jax(ref_priors, stub):
    kw = STUBS[stub]
    got = pqt.choose_route(pqt.CostInputs(**kw))
    want = jplanner.choose_route(jplanner.CostInputs(**kw))
    assert (got.route, got.pool_width, got.est_host_s, got.est_device_s) \
        == (want.route, want.pool_width, want.est_host_s, want.est_device_s)
    if kw["backend"] != "cpu" or kw.get("pin"):
        assert got.reason == want.reason.replace("PARQUET_TPU_ROUTE", PIN)


def test_choose_route_on_the_cards_priors():
    """The port's own priors: a large plan of a supported shape goes to
    the card, a small one or an unsupported one stays on the host."""
    big = pqt.choose_route(pqt.CostInputs(
        backend="gpu", **dict(BASE, est_bytes=1 << 30)))
    assert big.route == "device" and big.pool_width is None
    small = pqt.choose_route(pqt.CostInputs(
        backend="gpu", **dict(BASE, est_bytes=tplanner._DEVICE_MIN_BYTES - 1)))
    assert small.route == "host" and "amortize" in small.reason


# ---------------------------------------------------------------------------
# device_route_supported against the reference and the device scan
# ---------------------------------------------------------------------------


def _shapes():
    """(file, key, columns, values) for every refusal shape and a few
    supported ones."""
    n = 600
    rng = np.random.default_rng(1)
    fl = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    typed = _write(pa.table({
        "i32": pa.array(np.arange(n, dtype=np.int32)),
        "i64": pa.array(np.arange(n, dtype=np.int64)),
        "dbl": pa.array(rng.random(n)),
        "f": pa.array(rng.random(n).astype(np.float32)),
        "fl": pa.array([bytes(r) for r in fl], type=pa.binary(4)),
        "sd": pa.array([f"s{i % 9}" for i in range(n)]),
        "sp": pa.array([f"p{i}" for i in range(n)]),
        "xs": pa.array([[i] for i in range(n)])}),
        row_group_size=200, dictionary=["sd"])
    buf = io.BytesIO()
    papq.write_table(pa.table({
        "ts": pa.array(np.arange(n).astype("datetime64[s]").astype(
            "datetime64[ns]")),
        "v": pa.array(np.arange(n, dtype=np.int64))}), buf,
        use_deprecated_int96_timestamps=True)
    int96 = buf.getvalue()
    from tests.test_torch_host_scan import byte_array_decimal

    return [
        (typed, "i32", None, None), (typed, "i32", ["i64", "sd"], [1, 2]),
        (typed, "sd", ["i32", "sp"], ["s1"]), (typed, "f", ["dbl"], [0.5]),
        (typed, "i64", ["i32"], None),
        (typed, "i32", ["fl"], None),  # the port's device scan takes FLBA
        (typed, "i64", ["i32"], [1, 2]), (typed, "dbl", ["i32"], [0.5]),
        (typed, "fl", ["i32"], None), (int96, "ts", ["v"], None),
        (byte_array_decimal(), "bd", ["v"], None),
        (typed, "sp", ["i32"], ["p1"]), (typed, "i32", ["xs.list.element"],
                                         None),
        (typed, "xs.list.element", ["i32"], None),
        (typed, "i32", ["nope"], None)]


def test_device_route_supported_matches_jax_and_stage_scan():
    for raw, key, cols, values in _shapes():
        pf, jpf = pqt.ParquetFile(raw), JParquetFile(raw)
        ok, why = pqt.device_route_supported(pf, key, cols, values)
        try:
            jok, _ = jplanner.device_route_supported(jpf, key, cols, values)
        except KeyError:
            jok = False
        what = f"{key} {cols} {values}"
        flat = {leaf.name for leaf in pf.schema.leaves
                if leaf.max_repetition_level == 0}
        outs = cols if cols is not None else sorted(flat - {key})
        if "fl" in outs and ok:
            # the reference's device scan refuses FLBA output columns; the
            # port's compacts their (n, width) rows on the device
            assert ok and not jok, what
        else:
            assert ok == jok, what
        kw = {"values": values} if values is not None else {"lo": 1}
        if ok:
            state = pqt.stage_scan(pf, key, columns=cols, device=CPU, **kw)
            assert state["spans"], what
        else:
            with pytest.raises(ValueError, match="use the host scan"):
                pqt.stage_scan(pf, key, columns=cols, device=CPU, **kw)
            assert why


def test_route_scan_matches_jax(ref_priors):
    raw = _main_file()
    pf, jpf = pqt.ParquetFile(raw), JParquetFile(raw)
    for key, kw, cols in (("k", {"lo": 0, "hi": 10_000}, ["v"]),
                          ("k", {"lo": 0, "hi": 10}, None),
                          ("s", {"values": ["c01"]}, ["v", "d"]),
                          ("p", {"values": ["plain3"]}, ["v"]),
                          ("v", {"values": [3]}, None),
                          ("nope", {"lo": 1}, None)):
        got = pqt.route_scan(pf, key, columns=cols, backend="gpu", **kw)
        want = jplanner.route_scan(jpf, key, columns=cols, backend="gpu",
                                   **kw)
        assert (got.route, got.pool_width, got.est_bytes,
                got.est_host_s, got.est_device_s) == (
            want.route, want.pool_width, want.est_bytes, want.est_host_s,
            want.est_device_s), (key, kw)
        assert ("unsupported" in got.reason) == (
            "unsupported" in want.reason), (key, kw)
    assert pqt.route_scan(pf, "k", lo=1, device=CPU).route == "host"


def test_route_scan_estimates_big_plans_for_the_device(ref_priors,
                                                       monkeypatch):
    """With the floor lowered, the stats-only plan's estimate sends a
    large scan to the device on both packages."""
    monkeypatch.setattr(tplanner, "_DEVICE_MIN_BYTES", 1)
    monkeypatch.setattr(jplanner, "_DEVICE_MIN_BYTES", 1)
    raw = _main_file()
    got = pqt.route_scan(pqt.ParquetFile(raw), "k", lo=0, columns=["v"],
                         backend="gpu", reuse=10 ** 6)
    want = jplanner.route_scan(JParquetFile(raw), "k", lo=0, columns=["v"],
                               backend="gpu", reuse=10 ** 6)
    assert got.route == want.route == "device"
    assert got.est_bytes == want.est_bytes > 0


@pytest.mark.parametrize("stages", [("stats",), ("stats", "pages"),
                                    ("stats", "pages", "bloom")])
def test_plan_stages_match_jax(stages):
    """The statistics-only plan the router prices (and each deeper
    prefix of the cascade) decides as the reference's."""
    from parquet_tpu.algebra.expr import col as jcol
    from parquet_tpu.io.planner import ScanPlanner as JScanPlanner

    from parquet_tpu_torch.algebra.expr import col
    from parquet_tpu_torch.io.planner import ScanPlanner

    raw = _main_file()
    for tree in (lambda c: c("k").between(100, 2000),
                 lambda c: c("k").isin([5, 7000]) | (c("v") <= 10)):
        got = ScanPlanner(pqt.ParquetFile(raw), device=CPU).plan(
            tree(col), stages=stages)
        want = JScanPlanner(JParquetFile(raw)).plan(tree(jcol),
                                                   stages=stages)
        assert [(d.rg_index, d.pruned_by, d.ranges) for d in got.decisions
                ] == [(d.rg_index, d.pruned_by, d.ranges)
                      for d in want.decisions]
        assert got.est_bytes(["d"]) == want.est_bytes(["d"])
    with pytest.raises(ValueError, match="prefix"):
        ScanPlanner(pqt.ParquetFile(raw), device=CPU).plan(
            col("k") >= 1, stages=("pages",))


@pytest.mark.parametrize("value,route", [("host", "host"), ("cpu", "host"),
                                         ("HOST", "host"),
                                         ("device", "device"),
                                         ("cuda", "device"),
                                         ("tpu", None), ("", None)])
def test_route_pin(monkeypatch, value, route):
    monkeypatch.setenv(PIN, value)
    pf = pqt.ParquetFile(_main_file())
    d = pqt.route_scan(pf, "k", lo=0, hi=10, backend="gpu")
    if route is None:  # unpinned: the cost model (a tiny plan stays home)
        assert d.route == "host" and PIN not in d.reason
    else:
        assert d.route == route and f"{PIN}={route} pin" in d.reason
    # a pinned device on a shape the device scan refuses stays home
    d = pqt.route_scan(pf, "p", values=["plain1"], backend="gpu")
    assert d.route == "host"


def test_route_history_feedback(ref_priors):
    h, j = pqt.RouteHistory(), jplanner.RouteHistory()
    assert h.gbps("host") is None
    obs = [("host", 1 << 30, 1.0, 0.0, 1), ("host", 1 << 30, 2.0, 0.5, 1),
           ("device", 8 << 20, 0.01, 0.0, 1), ("device", 1 << 20, 0.001,
                                               0.0, 1),
           ("device", 1 << 31, 0.5, 0.0, 4), ("host", 1 << 28, 0.0, 0.0, 1),
           ("host", 1 << 29, 0.25, 0.3, 4)]
    for route, nbytes, s, wait, mesh in obs:
        h.observe(route, nbytes, s, pool_wait_s=wait, mesh_size=mesh)
        j.observe(route, nbytes, s, pool_wait_s=wait, mesh_size=mesh)
    for route in ("host", "device"):
        for mesh in (1, 4, 8):
            assert h.gbps(route, mesh) == j.gbps(route, mesh)
            assert h.observations(route, mesh) == j.observations(route,
                                                                 mesh)
    assert h.observations("device") == 1  # the 1 MiB scan was left out
    assert h.gbps("host") < (1 << 30) / 1e9  # the EWMA and the wait share
    h.reset()
    assert h.gbps("host") is None and h.observations("host") == 0


# ---------------------------------------------------------------------------
# the routed scan
# ---------------------------------------------------------------------------


def _same_host(got: dict, want: dict) -> None:
    from tests.test_torch_host_scan import _same

    _same(got, want, "routed scan")


def _device_to_host(out: dict) -> dict:
    """The device scan's forms as the host scan's, for numbers: the values
    (masked at nulls) on the host."""
    res = {}
    for c, form in out.items():
        if isinstance(form, tuple):
            vals, valid = form
            res[c] = np.ma.MaskedArray(vals.numpy(), mask=~valid.numpy())
        else:
            res[c] = form.numpy()
    return res


@pytest.mark.parametrize("key,kw,cols", [
    ("k", {"lo": 500, "hi": 700}, None),
    ("k", {"values": [5, 5000, 9999]}, ["v", "s"]),
    ("s", {"values": ["c07", "c11"]}, ["v", "p"]),
    ("p", {"values": ["plain9", "plain3999"]}, ["v"]),
    ("d", {"lo": -0.0, "hi": 0.25}, ["v"])])
def test_scan_on_the_cpu_matches_jax(key, kw, cols):
    raw = _main_file()
    pf, jpf = pqt.ParquetFile(raw), JParquetFile(raw)
    got = pqt.scan(pf, key, columns=cols, device=CPU, **kw)
    _same_host(got, jhs.scan(jpf, key, columns=cols, **kw))
    assert pqt.route_history().observations("host") == 0  # under 4 MiB


def test_scan_pinned_to_the_device_equals_the_device_scan(monkeypatch):
    monkeypatch.setenv(PIN, "device")
    pf = pqt.ParquetFile(_main_file())
    for key, kw, cols in (("k", {"lo": 500, "hi": 700}, ["v", "d"]),
                          ("s", {"values": ["c03"]}, ["v", "k"])):
        got = pqt.scan(pf, key, columns=cols, device=CPU, **kw)
        want = pqt.scan_filtered_device(pf, key, columns=cols, device=CPU,
                                        **kw)
        assert list(got) == list(want)
        for c in want:  # bit for bit: NaNs compare equal
            assert np.array_equal(got[c].numpy().view(np.uint8),
                                  want[c].numpy().view(np.uint8))


def test_double_key_routes_agree(monkeypatch):
    """A DOUBLE key's NaNs and signed zeros: the port's host and device
    routes give the same rows (the reference's device route orders by the
    IEEE bits; ``tests/test_torch_scan.py`` pins that)."""
    pf = pqt.ParquetFile(_main_file())
    for kw in ({"lo": 0.0, "hi": 0.0}, {"lo": -0.0}, {"hi": 0.0},
               {"lo": -0.5, "hi": 0.5}):
        monkeypatch.setenv(PIN, "host")
        host = pqt.scan(pf, "d", columns=["v", "d"], device=CPU, **kw)
        monkeypatch.setenv(PIN, "device")
        card = _device_to_host(pqt.scan(pf, "d", columns=["v", "d"],
                                        device=CPU, **kw))
        for c in ("v", "d"):
            assert np.array_equal(np.asarray(host[c]).view(np.uint8),
                                  card[c].view(np.uint8)), kw


def _fallback_file() -> bytes:
    """A dictionary string key whose dictionary outgrows its page limit,
    so each chunk falls back to PLAIN mid-chunk: the footer lists a
    dictionary encoding, the pages mix both kinds."""
    n = 3000
    buf = io.BytesIO()
    papq.write_table(pa.table({
        "s": pa.array([f"key-{(i * 7) % 2000:05d}-{'x' * 20}"
                       for i in range(n)]),
        "v": pa.array(np.arange(n, dtype=np.int64))}), buf,
        row_group_size=1500, use_dictionary=["s"],
        dictionary_pagesize_limit=2000, data_page_size=1000)
    return buf.getvalue()


def test_page_level_refusal_falls_back_to_the_host_scan(monkeypatch):
    raw = _fallback_file()
    pf, jpf = pqt.ParquetFile(raw), JParquetFile(raw)
    kw = {"values": ["key-00007-" + "x" * 20, "key-01999-" + "x" * 20]}
    ok, _ = pqt.device_route_supported(pf, "s", ["v"], kw["values"])
    assert ok  # the footer passes it
    with pytest.raises(ValueError, match="use the host scan"):
        pqt.stage_scan(pf, "s", columns=["v"], device=CPU, **kw)
    monkeypatch.setenv(PIN, "device")
    monkeypatch.setenv("PARQUET_TPU_ROUTE", "device")
    got = pqt.scan(pf, "s", columns=["v"], device=CPU, **kw)
    _same_host(got, jhs.scan(jpf, "s", columns=["v"], **kw))
    assert len(got["v"]) > 0


def test_other_errors_of_the_device_route_raise(monkeypatch):
    monkeypatch.setenv(PIN, "device")
    pf = pqt.ParquetFile(_main_file())

    def broken(*a, **k):
        raise ValueError("a fault of the device scan")

    monkeypatch.setattr(ths, "scan_filtered_device", broken)
    with pytest.raises(ValueError, match="a fault of the device scan"):
        pqt.scan(pf, "k", lo=1, device=CPU)
    with pytest.raises(ValueError, match="a fault of the device scan"):
        pqt.scan(pf, "k", lo=1, device=CPU,
                 policy=pqt.FaultPolicy(on_corrupt="skip_row_group"),
                 report=pqt.ReadReport())
