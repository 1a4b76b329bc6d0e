"""The port's writable tables (``parquet_tpu_torch/dataset_writer.py``,
the manifest-backed ``Dataset`` and the table crash tools) against the
JAX package's, on the CPU: the same seeded rows go into a table through
each package's ``DatasetWriter``, and the tables read back, prune, scan,
look up, aggregate and compact to the same answers, compared exactly (the
aggregate's float sums at ``rel=1e-9``).  A table written by either
package opens in the other.  The port reads with ``device="cpu"``.

Part names are random, so manifests are compared by their entries (rows,
zone maps, order), never by file names.  Every test leaves no thread
running (``tests/torch_fixtures/threads.py``)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import parquet_tpu
from parquet_tpu import dataset_writer as jdw
from parquet_tpu.algebra.buffer import SortingColumn as JSort
from parquet_tpu.format.enums import Type as JType
from parquet_tpu.io.writer import ColumnData as JCD
from parquet_tpu.schema import schema as JS
from parquet_tpu.schema.types import LogicalKind as JK

import parquet_tpu_torch as pqt
from parquet_tpu_torch import dataset_writer as tdw
from parquet_tpu_torch.algebra.buffer import SortingColumn
from parquet_tpu_torch.format.enums import BoundaryOrder, Type
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io.manifest import (MANIFEST_NAME, ManifestEntry,
                                           commit_manifest, read_manifest)
from parquet_tpu_torch.io.writer import ColumnData as TCD
from parquet_tpu_torch.schema import schema as TS
from parquet_tpu_torch.schema.types import LogicalKind as TK
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


# ---------------------------------------------------------------------------
# both packages' tables of the same rows
# ---------------------------------------------------------------------------

TSCHEMA = TS.message("t", [TS.leaf("k", Type.INT64),
                           TS.leaf("v", Type.DOUBLE),
                           TS.leaf("s", Type.BYTE_ARRAY, logical=TK.STRING)])
JSCHEMA = JS.message("t", [JS.leaf("k", JType.INT64),
                           JS.leaf("v", JType.DOUBLE),
                           JS.leaf("s", JType.BYTE_ARRAY,
                                   logical=JK.STRING)])


def _rows(n, start=0, seed=0):
    """``n`` keys from ``start`` in a seeded shuffled order (ingest must
    sort), their values and strings."""
    rng = np.random.default_rng(seed)
    k = np.arange(start, start + n, dtype=np.int64)
    rng.shuffle(k)
    s = [f"s{int(x) % 97:04d}".encode() for x in k]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in s], out=offs[1:])
    data = np.frombuffer(b"".join(s), np.uint8).copy()
    return k, k.astype(np.float64) * 0.5, data, offs


def _cols(pkg, n, start=0, seed=0) -> dict:
    k, v, data, offs = _rows(n, start, seed)
    cd = TCD if pkg == "port" else JCD
    return {"k": cd(values=k), "v": cd(values=v),
            "s": cd(values=data, offsets=offs)}


def _opts(pkg):
    mod = pqt if pkg == "port" else parquet_tpu
    return mod.WriterOptions(compression="snappy", data_page_size=4096,
                             row_group_size=1 << 16)


def _writer(pkg, d, sort=True, **kw):
    kw.setdefault("options", _opts(pkg))
    kw.setdefault("rows_per_file", 1 << 20)
    if pkg == "port":
        return tdw.DatasetWriter(d, TSCHEMA, sorting=[SortingColumn("k")]
                                 if sort else None, **kw)
    return jdw.DatasetWriter(d, JSCHEMA, sorting=[JSort("k")]
                             if sort else None, **kw)


def _ingest(pkg, d, batches, **kw):
    """One commit a ``(n, start, seed)`` batch; the manifests."""
    w = _writer(pkg, d, **kw)
    out = []
    for n, start, seed in batches:
        w.write(_cols(pkg, n, start, seed), n)
        out.append(w.commit())
    w.close()
    return out


def _tread(d) -> dict:
    with tdw.open_table(d) as ds:
        return {p: c.to_pylist() for p, c in ds.read(device=CPU).items()}


def _jread(d) -> dict:
    ds = jdw.open_table(d)
    try:
        return ds.read().to_arrow().to_pydict()
    finally:
        ds.close()


def _same_entries(mine, theirs):
    """Two manifests' snapshots: their versions, sorting, and entries in
    order (rows and zone maps; names and sizes are each writer's own)."""
    assert mine.version == theirs.version
    assert mine.sorting == theirs.sorting
    assert [(e.num_rows, e.zone_maps) for e in mine.files] == \
        [(e.num_rows, e.zone_maps) for e in theirs.files]


def _both(tmp_path, batches, **kw):
    """The same batches into a port table and a JAX one."""
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    _ingest("port", td, batches, **kw)
    _ingest("jax", jd, batches, **kw)
    return td, jd


# ---------------------------------------------------------------------------
# ingest and commit
# ---------------------------------------------------------------------------


def test_open_table_without_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdw.open_table(tmp_path)


def test_ingest_commit_read_parity(tmp_path):
    td, jd = _both(tmp_path, [(5000, 0, 0)])
    mine, theirs = read_manifest(td), parquet_tpu.read_manifest(jd)
    assert mine.version == 1 and len(mine.files) == 1
    assert mine.num_rows == 5000
    _same_entries(mine, theirs)
    got = _tread(td)
    assert got == _jread(jd)
    assert got["k"] == list(range(5000))  # sorted by the table's spec
    assert got == _tread(jd)  # the JAX package's table through the port


def test_commits_are_additive_and_versioned(tmp_path):
    d = str(tmp_path / "t")
    w = _writer("port", d)
    w.write(_cols("port", 1000, 0), 1000)
    m1 = w.commit()
    w.write(_cols("port", 1000, 1000), 1000)
    m2 = w.commit()
    w.close()
    assert (m1.version, m2.version) == (1, 2) and len(m2.files) == 2
    assert m2.names()[0] == m1.names()[0]  # earlier parts keep their place
    assert len(_tread(d)["k"]) == 2000
    w2 = _writer("port", d)
    assert w2.commit().version == 2  # an empty commit moves nothing
    w2.close()
    assert read_manifest(d).version == 2 and w2.version == 2
    jd = str(tmp_path / "j")
    _ingest("jax", jd, [(1000, 0, 0), (1000, 1000, 0)])
    _same_entries(read_manifest(d), parquet_tpu.read_manifest(jd))


def test_rows_per_file_shards_parts(tmp_path):
    batches = [(200, i, 0) for i in range(0, 1200, 200)]
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for pkg, d in (("port", td), ("jax", jd)):
        with _writer(pkg, d, rows_per_file=300) as w:
            for n, start, seed in batches:
                w.write(_cols(pkg, n, start, seed), n)
    mine = read_manifest(td)
    assert len(mine.files) == 3 and mine.num_rows == 1200
    _same_entries(mine, parquet_tpu.read_manifest(jd))
    assert _tread(td) == _jread(jd)


def test_committed_parts_are_sorted_with_declared_order(tmp_path):
    d = str(tmp_path / "t")
    with _writer("port", d) as w:
        w.write(_cols("port", 4000, 0, 5), 4000)
    m = read_manifest(d)
    with pqt.ParquetFile(os.path.join(d, m.files[0].name)) as pf:
        ks = pf.read(columns=["k"], device=CPU)["k"].values.numpy()
        assert np.array_equal(ks, np.arange(4000))
        rg = pf.row_groups[0]
        sc = rg.sorting_columns
        assert sc and sc[0].column_idx == pf.schema.leaf("k").column_index
        ci = rg.column(pf.schema.leaf("k").column_index).column_index()
        assert BoundaryOrder(ci.boundary_order) == BoundaryOrder.ASCENDING
    assert m.sorting == [("k", False, False)]


def test_partition_ids_equal_jax():
    rng = np.random.default_rng(1)
    n = 5000
    keys = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    keys[:50] = np.arange(50)
    valid = rng.random(n) > 0.1
    tleaf, jleaf = TSCHEMA.leaf("k"), JSCHEMA.leaf("k")
    for k in (3, 4, 8, 13):
        for validity in (None, valid):
            vals = keys if validity is None else keys[validity]
            got = tdw._partition_ids(tleaf, TCD(values=vals,
                                                validity=validity), n, k)
            want = jdw._partition_ids(jleaf, JCD(values=vals,
                                                 validity=validity), n, k)
            assert np.array_equal(got, want) and got.min() >= 0
    i32 = TS.message("m", [TS.leaf("x", Type.INT32)]).leaf("x")
    j32 = JS.message("m", [JS.leaf("x", JType.INT32)]).leaf("x")
    x = rng.integers(-2**31, 2**31, n).astype(np.int32)
    assert np.array_equal(tdw._partition_ids(i32, TCD(values=x), n, 8),
                          jdw._partition_ids(j32, JCD(values=x), n, 8))


def test_key_partitioned_ingest(tmp_path):
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for pkg, d in (("port", td), ("jax", jd)):
        with _writer(pkg, d, partition_on="k", num_partitions=4,
                     rows_per_file=100_000) as w:
            w.write(_cols(pkg, 4000), 4000)
            w.flush()
            assert 2 <= len(w._flushed) <= 4
    mine = read_manifest(td)
    _same_entries(mine, parquet_tpu.read_manifest(jd))
    # each part holds the keys of its partition ordinal, as in the JAX
    # package's table
    want = jdw._partition_ids(JSCHEMA.leaf("k"),
                              JCD(values=np.arange(4000, dtype=np.int64)),
                              4000, 4)
    with tdw.open_table(td) as ds:
        parts = [set(pf.read(columns=["k"], device=CPU)["k"].values.tolist())
                 for pf in ds.files]
    assert sorted(map(min, parts)) == sorted(
        int(np.flatnonzero(want == p)[0]) for p in np.unique(want))
    for keys in parts:
        assert len(set(want[sorted(keys)].tolist())) == 1
    assert _tread(td) == _jread(jd)


def test_partition_on_rejects_unsupported_columns(tmp_path):
    w = _writer("port", str(tmp_path / "t"), partition_on="s")
    with pytest.raises(ValueError, match="INT32/INT64"):
        w.write(_cols("port", 10), 10)
    w.abort()
    with pytest.raises(ValueError, match="flat"):
        tdw._partition_ids(TSCHEMA.leaf("k"), TCD(
            values=np.arange(3), list_offsets=[np.array([0, 3])]), 1, 4)


def test_abort_removes_uncommitted_parts(tmp_path):
    d = str(tmp_path / "t")
    w = _writer("port", d, rows_per_file=100)
    w.write(_cols("port", 150), 150)  # flushes one part
    w.write(_cols("port", 100, 150), 100)  # flushes the second
    w.write(_cols("port", 50, 250), 50)  # stays buffered
    assert len(w._flushed) == 2 and w.pending_rows() == 50
    assert w.pending_bytes() == tdw._cols_nbytes(_cols("port", 50, 250))
    w.abort()
    assert w.pending_rows() == 0 and w.pending_bytes() == 0
    assert not [f for f in os.listdir(d) if f.endswith(".parquet")]
    assert read_manifest(d) is None
    with pytest.raises(ValueError):
        w.write(_cols("port", 1), 1)


def test_exception_in_with_aborts(tmp_path):
    d = str(tmp_path / "t")
    with pytest.raises(KeyError):
        with _writer("port", d, rows_per_file=100) as w:
            w.write(_cols("port", 150), 150)
            raise KeyError("boom")
    assert os.listdir(d) == []


# ---------------------------------------------------------------------------
# pruning from the manifest
# ---------------------------------------------------------------------------


def test_prune_uses_manifest_zone_maps_zero_opens(tmp_path):
    batches = [(1000, i * 1000, i) for i in range(4)]
    td, jd = _both(tmp_path, batches)
    ds = tdw.open_table(td, pin=False)
    jds = jdw.open_table(jd, pin=False)
    assert ds.snapshot_version == jds.snapshot_version == 4
    where = pqt.col("k").between(3200, 3600)
    keep = ds.prune(where=where)
    names = read_manifest(td).names()
    assert keep == [os.path.join(td, names[3])]
    jkeep = jds.prune(where=parquet_tpu.col("k").between(3200, 3600))
    assert [os.path.basename(p) for p in jkeep] == \
        [parquet_tpu.read_manifest(jd).names()[3]]
    # parts 1 and 2 were dropped by the manifest alone: never opened (part
    # 0 opens to prepare the tree)
    assert set(ds._files) <= {0, 3}
    got = ds.scan(where=where, columns=["v"], device=CPU)
    want = jds.scan(where=parquet_tpu.col("k").between(3200, 3600),
                    columns=["v"])
    assert np.array_equal(np.sort(np.asarray(got["v"])),
                          np.sort(np.asarray(want["v"])))
    assert len(got["v"]) == 401 and set(ds._files) <= {0, 3}
    plans = ds.plan(where=where, device=CPU)
    assert list(plans) == keep and set(ds._files) <= {0, 3}
    ds.close()
    jds.close()


def test_manifest_prune_is_conservative_on_unknown(tmp_path):
    d = str(tmp_path / "t")
    _ingest("port", d, [(1000, 0, 0), (1000, 1000, 1)])
    ds = tdw.open_table(d, pin=False)
    # unknown and missing zone maps keep both parts: their footers decide
    first, second = ds.paths
    ds._file_stats = {first: ManifestEntry("a", 1000, 1, {}),
                      second: ManifestEntry("b", 1000, 1, {
                          "k": (None, None, None, None)})}
    assert ds.prune(where=pqt.col("k") == 1500) == [second]
    assert set(ds._files) == {0, 1}
    ds.close()


def test_scan_and_lookup_parity_on_table(tmp_path, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "0")
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for pkg, d in (("port", td), ("jax", jd)):
        with _writer(pkg, d, rows_per_file=2000) as w:
            w.write(_cols(pkg, 6000), 6000)
    ds, jds = tdw.open_table(td), jdw.open_table(jd)
    where = (pqt.col("k") >= 100) & (pqt.col("k") <= 300)
    jwhere = (parquet_tpu.col("k") >= 100) & (parquet_tpu.col("k") <= 300)
    got = ds.scan(where=where, columns=["v", "s"], device=CPU)
    want = jds.scan(where=jwhere, columns=["v", "s"])
    assert np.array_equal(np.asarray(got["v"]), np.asarray(want["v"]))
    assert np.array_equal(np.sort(np.asarray(got["v"])),
                          np.arange(100, 301) * 0.5)
    # the lookups run on one table (the port's), from cleared caches:
    # preads count its layout
    keys = [5, 4321, 10**9, 5999, -1]
    ds.close()
    jds.close()
    ds, jds = tdw.open_table(td), jdw.open_table(td)
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    res = ds.find_rows("k", keys, columns=["v"], device=CPU)
    jres = jds.find_rows("k", keys, columns=["v"])
    for h, j in zip(res, jres):
        assert np.array_equal(h.rows, j.rows)
        assert np.array_equal(np.asarray(h.values["v"]),
                              np.asarray(j.values["v"]))
    assert res[0].values["v"][0] == 2.5 and res[2].num_rows == 0
    assert res.counters == jres.counters
    assert res.counters["binary_search_hits"] > 0
    ds.close()
    jds.close()


def test_sorted_fast_path_uint64_keys_above_2_53(tmp_path):
    d = str(tmp_path / "t")
    base = 1 << 60
    schema = TS.message("u", [TS.leaf("k", Type.INT64, logical=TK.INT,
                                      bit_width=64, signed=False),
                              TS.leaf("v", Type.DOUBLE)])
    keys = np.arange(base, base + 2000, dtype=np.uint64)[::-1].copy()
    with tdw.DatasetWriter(d, schema, sorting=[SortingColumn("k")],
                           options=_opts("port")) as w:
        w.write({"k": TCD(values=keys),
                 "v": TCD(values=(keys - np.uint64(base)).astype(
                     np.float64))}, 2000)
    entry = read_manifest(d).files[0]
    assert entry.zone_maps["k"][:2] == (base, base + 1999)
    with tdw.open_table(d) as ds:
        res = ds.find_rows("k", [base + 3, base + 1999, base + 5000],
                           columns=["v"], device=CPU)
        assert res[0].num_rows == 1 and res[0].values["v"][0] == 3.0
        assert res[1].num_rows == 1 and res[1].values["v"][0] == 1999.0
        assert res[2].num_rows == 0
        assert res.counters["binary_search_hits"] > 0
        assert ds.prune(where=pqt.col("k") >= base + 2000) == []


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def test_compaction_equals_a_one_shot_sorted_write(tmp_path):
    batches = [(1000, i, 3 + i) for i in range(0, 5000, 1000)]
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for pkg, d in (("port", td), ("jax", jd)):
        _ingest(pkg, d, batches, rows_per_file=1000)
    assert len(read_manifest(td).files) == 5
    m = tdw.compact_table(td, device=CPU)
    jm = jdw.compact_table(jd)
    assert m is not None and len(m.files) == 1 and m.version == 6
    _same_entries(m, jm)
    # one SortingWriter write of the same rows, same options
    one = str(tmp_path / "oneshot.parquet")
    sw = pqt.SortingWriter(one, TSCHEMA, [SortingColumn("k")], _opts("port"),
                           device=CPU)
    for n, start, seed in batches:
        sw.write(_cols("port", n, start, seed), n)
    sw.close()
    got = _tread(td)
    with pqt.ParquetFile(one) as pf:
        want = {p: c.to_pylist() for p, c in pf.read(device=CPU).items()}
    assert got == want == _jread(jd)
    assert [f for f in os.listdir(td) if f.endswith(".parquet")] == \
        [m.files[0].name]


def test_compaction_max_files_folds_smallest(tmp_path):
    batches = [(100, 0, 100), (2000, 0, 2000), (150, 0, 150)]
    td, jd = _both(tmp_path, batches)
    m = tdw.compact_table(td, max_files=2, device=CPU)
    jm = jdw.compact_table(jd, max_files=2)
    assert sorted(e.num_rows for e in m.files) == [250, 2000]
    _same_entries(m, jm)
    assert _tread(td) == _jread(jd)
    assert tdw.compact_table(td, max_files=1, device=CPU) is None


def test_compaction_conflict_aborts_cleanly(tmp_path, monkeypatch):
    """A rival compaction commits while this one merges: this one's commit
    finds an input gone, removes its merged part and leaves the rival's
    manifest as it is."""
    from parquet_tpu_torch.algebra import merge as tmerge

    d = str(tmp_path / "t")
    _ingest("port", d, [(500, i * 500, i) for i in range(3)])
    real = tmerge.merge_files
    rival = {}

    def merge_then_lose(*a, **kw):
        got = real(*a, **kw)
        if not rival:  # the rival merges the same parts and commits first
            rival["manifest"] = None  # its own merge comes through here
            rival["manifest"] = tdw.compact_table(d, device=CPU)
        return got

    monkeypatch.setattr(tmerge, "merge_files", merge_then_lose)
    assert tdw.compact_table(d, device=CPU) is None
    live = read_manifest(d)
    assert live.version == rival["manifest"].version == 4
    assert sorted(os.listdir(d)) == sorted([MANIFEST_NAME] + live.names())
    assert _tread(d)["k"] == list(range(1500))
    # a stale mutation aborts the same way, and one part compacts to none
    assert commit_manifest(d, lambda cur: None) is None
    assert tdw.compact_table(d, device=CPU) is None
    assert read_manifest(d).version == 4


def test_compaction_commit_invalidates_caches(tmp_path):
    d = str(tmp_path / "t")
    _ingest("port", d, [(1000, 0, 0), (1000, 1000, 1)])
    pqt.clear_caches()
    with tdw.open_table(d) as ds:
        ds.read(device=CPU)
        ds.find_rows("k", [5, 1500, 10**6], columns=["v"], device=CPU)
        old = [os.path.abspath(p) for p in ds.paths]
        assert [k for k in tcache.FOOTERS._entries if k[0] in old]
        assert [k for k in tcache.PAGES._entries if k[0][0] in old]
        assert [k for k in tcache.NEGS._entries if k[0][0] in old]
        tdw.compact_table(d, device=CPU)
        for ap in old:
            assert not [k for k in tcache.FOOTERS._entries if k[0] == ap]
            assert not [k for k in tcache.PAGES._entries if k[0][0] == ap]
            assert not [k for k in tcache.NEGS._entries if k[0][0] == ap]
        with tdw.open_table(d) as ds2:
            assert ds2.snapshot_version == ds.snapshot_version + 1
            assert ds2.num_rows == 2000


def test_compaction_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = str(tmp_path / "t")
    _ingest("port", d, [(10, 0, 0), (10, 10, 0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdw.compact_table(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdw.BackgroundCompactor(d)
    assert len(read_manifest(d).files) == 2


def test_background_compactor_closes_its_thread(tmp_path):
    d = str(tmp_path / "t")
    _ingest("port", d, [(200, i * 200, i) for i in range(5)])
    with tdw.BackgroundCompactor(d, interval_s=0.01, min_files=2,
                                 device=CPU) as bc:
        deadline = time.monotonic() + 20
        while len(read_manifest(d).files) > 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
    assert not bc._thread.is_alive()
    assert len(read_manifest(d).files) == 1
    assert bc.passes >= 1 and bc.last_error is None
    assert _tread(d)["k"] == list(range(1000))


def test_snapshot_pinned_reader_survives_compaction(tmp_path):
    d = str(tmp_path / "t")
    w = _writer("port", d)
    for i in range(3):
        w.write(_cols("port", 800, i * 800, i), 800)
        w.commit()
    with tdw.open_table(d) as ds:  # every part open
        before = {p: c.to_pylist() for p, c in ds.read(device=CPU).items()}
        w.write(_cols("port", 800, 2400, 9), 800)
        w.commit()
        tdw.compact_table(d, device=CPU)
        w.close()
        assert len(read_manifest(d).files) == 1
        assert not any(os.path.exists(p) for p in ds.paths)
        again = {p: c.to_pylist() for p, c in ds.read(device=CPU).items()}
        assert again == before and len(again["k"]) == 2400
        res = ds.find_rows("k", [100], columns=["v"], device=CPU)
        assert res[0].num_rows == 1
        agg = ds.aggregate([pqt.count(), pqt.sum_("k")], device=CPU)
        assert agg["count(*)"] == 2400
        with tdw.open_table(d) as ds2:
            assert ds2.num_rows == 3200
            assert ds2.snapshot_version > ds.snapshot_version


def test_open_table_retries_a_raced_unlink(tmp_path, monkeypatch):
    """The manifest read before a compaction's commit names parts that are
    gone by the open: the open reads the new manifest."""
    d = str(tmp_path / "t")
    _ingest("port", d, [(100, 0, 0), (100, 100, 1)])
    stale = read_manifest(d)
    tdw.compact_table(d, device=CPU)
    calls = []
    real = tdw.read_manifest

    def first_stale(table_dir):
        calls.append(1)
        return stale if len(calls) == 1 else real(table_dir)

    monkeypatch.setattr(tdw, "read_manifest", first_stale)
    with tdw.open_table(d) as ds:
        assert len(calls) == 2 and ds.snapshot_version == 3
        assert ds.num_rows == 200


def test_concurrent_ingest_scan_lookup_compact_hammer(tmp_path):
    """Readers, scanners and lookups beside an ingest and a compactor see
    only whole commits (a prefix of the batches), never a torn part."""
    d = str(tmp_path / "t")
    B, NB = 200, 6
    errors: list = []
    stop = threading.Event()
    committed = threading.Event()

    def ingester():
        try:
            w = _writer("port", d, rows_per_file=B)
            for j in range(NB):
                w.write(_cols("port", B, j * B, j), B)
                w.commit()
                committed.set()
            w.close()
        except Exception as e:  # pragma: no cover - the failure's report
            errors.append(("ingest", e))
        finally:
            stop.set()

    def loop(name, body):
        def run():
            try:
                committed.wait(30)
                while not stop.is_set():
                    body()
            except Exception as e:  # pragma: no cover
                errors.append((name, e))
        return run

    def read():
        with tdw.open_table(d) as ds:
            ks = ds.read(columns=["k"], device=CPU)["k"].values.numpy()
        assert len(ks) % B == 0 and len(ks) > 0
        assert np.array_equal(np.sort(ks), np.arange(len(ks)))

    def scan():
        with tdw.open_table(d) as ds:
            got = ds.scan(where=pqt.col("k").between(0, B - 1),
                          columns=["v"], device=CPU)
        assert np.array_equal(np.sort(np.asarray(got["v"])),
                              np.arange(B) * 0.5)

    def look():
        with tdw.open_table(d) as ds:
            res = ds.find_rows("k", [7, B - 1], columns=["v"], device=CPU)
        assert res[0].num_rows == 1 and res[0].values["v"][0] == 3.5

    def compact():
        tdw.compact_table(d, device=CPU)

    threads = [threading.Thread(target=f) for f in (
        ingester, loop("compact", compact), loop("read", read),
        loop("scan", scan), loop("lookup", look))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert time.monotonic() - t0 < 30
    tdw.compact_table(d, device=CPU)
    assert _tread(d)["k"] == list(range(B * NB))
    assert tdw.recover_table(d) == []
    assert sorted(os.listdir(d)) == sorted([MANIFEST_NAME]
                                           + read_manifest(d).names())


# ---------------------------------------------------------------------------
# crash safety and recovery
# ---------------------------------------------------------------------------


def _setup_base(d):
    with _writer("port", d) as w:
        w.write(_cols("port", 600), 600)


def test_manifest_crash_matrix_ingest(tmp_path):
    def ingest(d, wrap):
        w = _writer("port", d, rows_per_file=300, _sink_wrap=wrap)
        w.write(_cols("port", 600, 600, 1), 600)
        w.commit()

    res = tfaults.table_crash_check(_setup_base, ingest, str(tmp_path),
                                    samples=10, seed=7, device=CPU)
    assert {r["outcome"] for r in res} == {"old", "new"}
    offs = [r["offset"] for r in res]
    assert 0 in offs and max(offs) - 1 in offs  # the rename boundary
    assert os.listdir(tmp_path) == ["base"]


def test_manifest_crash_matrix_compaction(tmp_path):
    def setup(d):
        w = _writer("port", d, rows_per_file=200)
        for i in range(3):
            w.write(_cols("port", 200, i * 200, i), 200)
        w.commit()
        w.close()
        assert len(read_manifest(d).files) == 3

    def ingest(d, wrap):
        if tdw.compact_table(d, device=CPU, _sink_wrap=wrap) is None:
            raise AssertionError("compaction did not commit")

    res = tfaults.table_crash_check(setup, ingest, str(tmp_path), samples=8,
                                    seed=11, device=CPU)
    assert {r["outcome"] for r in res} == {"old", "new"}


def test_crash_matrix_rejects_an_ingest_that_commits_nothing(tmp_path):
    with pytest.raises(AssertionError, match="did not commit"):
        tfaults.table_crash_check(_setup_base, lambda d, wrap: None,
                                  str(tmp_path), device=CPU)


def test_shared_crash_state_covers_multiple_sinks(tmp_path):
    state = pqt.SharedCrashState(crash_at_byte=10)
    s1 = state.wrap(pqt.AtomicFileSink(str(tmp_path / "a")))
    s2 = state.wrap(pqt.AtomicFileSink(str(tmp_path / "b")))
    s3 = state.wrap(pqt.AtomicFileSink(str(tmp_path / "c")))
    assert s1.write(b"123456") == 6
    with pytest.raises(pqt.InjectedWriterCrash):
        s2.write(b"789abcdef")  # crosses the shared budget at byte 10
    assert state.crashed and state.total == 10
    for op in (lambda: s1.write(b"x"), s1.close, s1.flush, s3.close,
               lambda: s3.writelines([b"y"])):
        with pytest.raises(pqt.InjectedWriterCrash):
            op()
    for s in (s1, s2, s3):
        s.abort()  # a dead process: descriptors released, temps left
    temps = sorted(f for f in os.listdir(tmp_path) if f.endswith(".tmp"))
    assert len(temps) == 3
    sizes = sorted(os.path.getsize(tmp_path / f) for f in temps)
    assert sizes == [0, 4, 6]
    live = pqt.SharedCrashState()  # no crash: sinks commit
    s = live.wrap(pqt.AtomicFileSink(str(tmp_path / "d")))
    s.write(b"abc")
    s.close()
    assert (tmp_path / "d").read_bytes() == b"abc" and live.total == 3
    j = parquet_tpu.io.faults.SharedCrashState(crash_at_byte=10)
    assert (j.crash_at_byte, j.total, j.crashed) == (10, 0, False)


def test_sweep_spares_inflight_uncommitted_parts(tmp_path):
    d = str(tmp_path / "t")
    w = _writer("port", d, rows_per_file=100)
    w.write(_cols("port", 100), 100)  # flushed, not committed
    assert len(w._flushed) == 1
    assert tdw.recover_table(d) == []  # the live writer shields its part
    assert w.commit().num_rows == 100
    w.close()
    assert len(_tread(d)["k"]) == 100
    w2 = _writer("port", d, rows_per_file=100)
    w2.write(_cols("port", 100, 100), 100)
    stranded = list(w2._flushed)
    w2._closed = True  # a writer that died without cleaning up
    assert stranded and set(stranded) <= set(tdw.recover_table(d))


def test_recover_sweeps_orphans_only(tmp_path):
    d = tmp_path / "t"
    _ingest("port", str(d), [(500, 0, 0)])
    live = read_manifest(d).names()
    (d / "part-deadbeef00000000.parquet").write_bytes(b"torn")
    (d / f"{live[0]}.123abc.tmp").write_bytes(b"half")
    (d / "other.bin").write_bytes(b"keep")
    swept = tdw.recover_table(d)
    assert sorted(swept) == sorted(["part-deadbeef00000000.parquet",
                                    f"{live[0]}.123abc.tmp"])
    assert sorted(os.listdir(d)) == sorted([MANIFEST_NAME, "other.bin"]
                                           + live)
    assert len(_tread(str(d))["k"]) == 500


def test_table_debug(tmp_path):
    d = str(tmp_path / "t")
    w = _writer("port", d, rows_per_file=600)
    w.write(_cols("port", 1000), 1000)  # one part of 1000 rows
    w.write(_cols("port", 400, 1000), 400)
    mine = [t for t in tdw.table_debug()["writers"] if t["dir"] == d]
    assert mine == [{"dir": d, "pending_rows": 400,
                     "pending_bytes": w.pending_bytes(),
                     "uncommitted_parts": 1, "commits": 0,
                     "version": None}]
    assert w.pending_bytes() > 0
    w.commit()
    mine = [t for t in tdw.table_debug()["writers"] if t["dir"] == d]
    assert mine[0]["pending_rows"] == 0 and mine[0]["commits"] == 1
    assert mine[0]["version"] == 1 and mine[0]["uncommitted_parts"] == 0
    w.close()
    assert not [t for t in tdw.table_debug()["writers"] if t["dir"] == d]
    assert "0 pending row(s)" in repr(w)


# ---------------------------------------------------------------------------
# tables across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_opens_the_others_table(tmp_path, writer):
    d = str(tmp_path / "t")
    _ingest(writer, d, [(700, 0, 0), (700, 700, 1), (700, 1400, 2)],
            rows_per_file=500)
    ds, jds = tdw.open_table(d), jdw.open_table(d)
    assert ds.snapshot_version == jds.snapshot_version == 3
    assert ds.paths == jds.paths
    assert ds._file_stats[ds.paths[0]].as_dict() == \
        jds._file_stats[jds.paths[0]].as_dict()
    where = pqt.col("k").between(650, 760)
    keep = ds.prune(where=where)
    assert keep == jds.prune(where=parquet_tpu.col("k").between(650, 760))
    assert len(keep) == 2
    ds.close()
    jds.close()
    assert _tread(d) == _jread(d)
    # the other package compacts the table, and both read it
    if writer == "port":
        jdw.compact_table(d)
    else:
        tdw.compact_table(d, device=CPU)
    assert _tread(d) == _jread(d)
    assert _tread(d)["k"] == list(range(2100))


AGG_CASES = {
    "covered": (lambda m: [m.count(), m.count("v"), m.min_("k"),
                           m.max_("k")],
                lambda c: c("k").between(0, 3999)),
    "partly": (lambda m: [m.count(), m.sum_("v"), m.max_("v")],
               lambda c: c("k").between(1500, 3200)),
    "pruned": (lambda m: [m.count(), m.min_("s")],
               lambda c: c("k") >= 10**6),
    "no_where": (lambda m: [m.count(), m.min_("v"), m.max_("s")],
                 lambda c: None),
    "avg": (lambda m: [m.avg("v")], lambda c: c("k") <= 2500),
    "group_by": (lambda m: [m.count()], lambda c: c("k") <= 1200),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_manifest_tier_matches_jax(tmp_path, case, writer):
    """Both packages aggregate one table (each writer's): the same
    answers, tiers and manifest-answered files."""
    d = str(tmp_path / "t")
    _ingest(writer, d, [(1000, i * 1000, i) for i in range(4)])
    aggs, where = AGG_CASES[case]
    kw = {"group_by": "s"} if case == "group_by" else {}
    with tdw.open_table(d, pin=False) as ds:
        got = ds.aggregate(aggs(pqt), where=where(pqt.col), device=CPU, **kw)
        opened = set(ds._files)
    jds = jdw.open_table(d, pin=False)
    try:
        want = jds.aggregate(aggs(parquet_tpu), where=where(parquet_tpu.col),
                             **kw)
    finally:
        jds.close()
    assert list(got.keys()) == list(want.keys())
    for name in want.keys():
        if isinstance(want[name], float):
            assert got[name] == pytest.approx(want[name], rel=1e-9)
        else:
            assert got[name] == want[name], name
    assert got.counters == want.counters
    n = got.counters["files_answered_manifest"]
    mine = [ln.split(":")[-1] for ln in got.explain().splitlines()
            if "manifest" in ln]
    theirs = [ln.split(":")[-1] for ln in want.explain().splitlines()
              if "manifest" in ln]
    assert mine == theirs
    expect = {"covered": 4, "partly": 1, "pruned": 4, "no_where": 0,
              "avg": 1, "group_by": 2}[case]
    assert n == expect
    # a part the manifest answered was never opened (part 0 opens for
    # the schema)
    assert len(opened - {0}) <= 4 - n
