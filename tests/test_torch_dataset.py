"""The multi-file read of parquet_tpu_torch (``Dataset``,
``parallel/mesh.py::read_dataset_device``) and ``ParquetFile.read(
row_groups=...)`` against parquet_tpu, on the CPU.

The port reads on ``"cpu"`` and on ``["cpu"] * 8`` (eight shards, eight
files in a window of four), the JAX package on its host read and on its
device read over the 8-device CPU mesh the test configuration makes.
``Dataset.scan`` (the host scan of every file the footers keep) is held
to ``parquet_tpu.Dataset.scan``, and the schema check to the JAX
package's on every logical annotation (TIMESTAMP units and UTC
adjustment among them).
Files are small and made from a seed with numpy; every equality is exact.
Every test ends with the threads it started with (the shared pool is
filled once, before the first).
"""

import io
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.dataset import expand_paths as jexpand_paths

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.io.column import concat_columns
from parquet_tpu_torch.io import planner as tplanner
from parquet_tpu_torch.parallel import mesh as tmesh
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")
EIGHT = [CPU] * 8
N_FILES = 3
ROWS = 1500
RG = 500  # 3 row groups a file


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
    """Every worker of the port's shared pool and of the JAX package's
    started, so that the per-test thread count sees only what a test
    leaves behind."""
    from parquet_tpu.utils import pool as jpool

    for pool, width in ((tpool.shared_pool(), tpool.pool_width()),
                        (jpool.shared_pool(), jpool.pool_width())):
        barrier = threading.Barrier(width + 1)
        futs = [pool.submit(barrier.wait) for _ in range(width)]
        barrier.wait(timeout=30)
        for f in futs:
            f.result(timeout=30)


@pytest.fixture(autouse=True)
def _fresh():
    pqt.reset_mesh()
    pqt.reset_route_refusals()
    pqt.reset_host_route()
    before = threads_now()
    yield
    assert pqt.MESH["staging_bytes"] == 0
    assert_no_thread_started(before)


def _mixed_corpus(root, n_files=N_FILES, rows=ROWS, seed=0):
    """The encodings x nulls matrix of the JAX package's device dataset
    tests: dictionary strings, PLAIN fixed width, DELTA_BINARY_PACKED,
    DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT, and a nullable float and string
    column, ``n_files`` part files of three row groups."""
    paths = []
    for i in range(n_files):
        rng = np.random.default_rng(seed + i)
        base = i * rows
        null_f = rng.random(rows) < 0.15
        null_s = rng.random(rows) < 0.1
        t = pa.table({
            "plain_i64": pa.array(np.arange(base, base + rows,
                                            dtype=np.int64)),
            "plain_f32": pa.array(rng.random(rows).astype(np.float32)),
            "dict_s": pa.array([f"f{i}_tag{j}" for j in
                                rng.integers(0, 41, rows)]),
            "delta_i": pa.array(np.cumsum(rng.integers(0, 9, rows))),
            "dba_s": pa.array([f"prefix/shared/f{i}/{j:06d}" for j in
                               rng.integers(0, 173, rows)]),
            "bss_f": pa.array(rng.random(rows)),
            "nul_f": pa.array(rng.random(rows) * 100, mask=null_f),
            "nul_s": pa.array([f"n{j}" for j in rng.integers(0, 53, rows)],
                              mask=null_s),
        })
        p = os.path.join(root, f"part-{i:02d}.parquet")
        papq.write_table(
            t, p, row_group_size=RG, use_dictionary=["dict_s", "nul_s"],
            column_encoding={"delta_i": "DELTA_BINARY_PACKED",
                             "dba_s": "DELTA_BYTE_ARRAY",
                             "bss_f": "BYTE_STREAM_SPLIT",
                             "plain_i64": "PLAIN", "plain_f32": "PLAIN",
                             "nul_f": "PLAIN"})
        paths.append(p)
    return paths


def _keyed_corpus(root, n_files=4, rows=2000):
    """Files with disjoint ascending keys (file i: x in [i*rows, (i+1)*rows))
    and a page index, so footer and page pruning are decidable."""
    paths = []
    for i in range(n_files):
        t = pa.table({
            "x": pa.array(np.arange(i * rows, (i + 1) * rows,
                                    dtype=np.int64)),
            "f": pa.array(np.linspace(0.0, 1.0, rows) + i),
        })
        p = os.path.join(root, f"part-{i:02d}.parquet")
        papq.write_table(t, p, row_group_size=RG, write_page_index=True,
                         data_page_size=1024)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The mixed corpus and the JAX package's reads of it: its host read
    and its device read over the 8-device CPU mesh."""
    root = str(tmp_path_factory.mktemp("mixed"))
    paths = _mixed_corpus(root)
    ds = parquet_tpu.Dataset(paths)
    return {"paths": paths, "host": ds.read(device=False),
            "device": ds.read(device=True)}


def _port_host(col) -> tuple:
    """A flat port column on the host: (values, offsets or None, validity
    or None)."""
    got = col.materialize_host()
    validity = None if col.validity is None else col.validity.numpy()
    if isinstance(got, tuple):
        return got[0], got[1].astype(np.int64), validity
    return got, None, validity


def _jax_host(col, leaf) -> tuple:
    """The same of a JAX package column; 64-bit uint32 pairs as int64 or
    float64."""
    if col.is_dictionary_encoded():
        col.materialize_host()
    values = np.asarray(col.values)
    offsets = (None if col.offsets is None
               else np.asarray(col.offsets).astype(np.int64))
    if values.ndim == 2 and values.dtype == np.uint32:
        values = np.ascontiguousarray(values).view(
            np.float64 if leaf.physical_type == 5 else np.int64).reshape(-1)
    validity = None if col.validity is None else np.asarray(col.validity)
    return values, offsets, validity


def _same_column(port_col, jax_col, what: str) -> None:
    pv, po, pm = _port_host(port_col)
    jv, jo, jm = _jax_host(jax_col, port_col.leaf)
    assert (po is None) == (jo is None), what
    if po is not None:
        np.testing.assert_array_equal(po, jo, err_msg=what)
    assert pv.dtype == jv.dtype and pv.shape == jv.shape, (
        what, pv.dtype, jv.dtype, pv.shape, jv.shape)
    np.testing.assert_array_equal(pv.view(np.uint8), jv.view(np.uint8),
                                  err_msg=what)
    if jm is None or jm.all():
        assert pm is None or pm.all(), what
    else:
        np.testing.assert_array_equal(pm, jm, err_msg=what)


def _same_table(got: dict, want, what: str) -> None:
    assert list(got) == list(want.keys()), what
    for path, col in got.items():
        assert col.values is None or col.values.device.type == "cpu"
        _same_column(col, want[path], f"{what}: {path}")


# ---------------------------------------------------------------------------
# paths, rows, schema, shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["glob", "list", "recursive", "literal",
                                  "missing"])
def test_expand_paths_matches_jax(tmp_path, case):
    root = str(tmp_path)
    for name in ("part-00.parquet", "part-01.parquet", "sub/part-02.parquet",
                 "sub/deeper/part-03.parquet", "odd[1].parquet"):
        os.makedirs(os.path.dirname(os.path.join(root, name)),
                    exist_ok=True)
        open(os.path.join(root, name), "wb").close()
    arg = {"glob": os.path.join(root, "part-*.parquet"),
           "list": [os.path.join(root, "part-01.parquet"),
                    os.path.join(root, "part-*.parquet"),
                    os.path.join(root, "part-01.parquet")],
           "recursive": os.path.join(root, "**", "*.parquet"),
           "literal": os.path.join(root, "odd[1].parquet"),
           "missing": os.path.join(root, "nope-*.parquet")}[case]
    if case == "missing":
        for fn in (pqt.expand_paths, jexpand_paths):
            with pytest.raises(FileNotFoundError):
                fn(arg)
        with pytest.raises(ValueError):
            pqt.Dataset([])
        return
    got = pqt.expand_paths(arg)
    assert got == jexpand_paths(arg)
    assert len(got) == {"glob": 2, "list": 2, "recursive": 5,
                        "literal": 1}[case]


def test_rows_offsets_and_shards(tmp_path):
    paths = _keyed_corpus(str(tmp_path))
    want = parquet_tpu.Dataset(paths)
    with pqt.Dataset(paths) as ds:
        assert ds.num_files == want.num_files == 4
        assert ds.num_rows == want.num_rows
        np.testing.assert_array_equal(ds.row_offsets(), want.row_offsets())
        assert ds.schema.leaves[0].name == "x"
        for count in (1, 2, 3):
            for i in range(count):
                assert ds.shard(i, count).paths == want.shard(i, count).paths
        with pytest.raises(ValueError):
            ds.shard(3, 3)
        empty = ds.shard(4, 5)
        assert empty.num_files == 0 and "empty shard" in repr(empty)
        with pytest.raises(ValueError, match="empty dataset shard"):
            empty.schema
        with pytest.raises(ValueError):
            empty.read(device="cpu")
        # no process group: this process is shard 0 of 1
        assert pqt.dataset_process_shard(ds).paths == paths
        assert pqt.dataset_process_shard(ds, 1, 2).paths == paths[1::2]
        parts = [ds.shard(i, 2).read(device="cpu")["x"].values.numpy()
                 for i in range(2)]
        np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                      np.arange(ds.num_rows))


@pytest.mark.parametrize("drift", ["extra_column", "decimal_scale"])
def test_schema_mismatch_raises(tmp_path, drift):
    a = os.path.join(str(tmp_path), "a.parquet")
    b = os.path.join(str(tmp_path), "b.parquet")
    x = np.arange(10, dtype=np.int64)
    if drift == "extra_column":
        papq.write_table(pa.table({"x": x}), a)
        papq.write_table(pa.table({"x": x, "y": x}), b)
    else:  # one physical type, two decimal scales
        for p, scale in ((a, 2), (b, 4)):
            papq.write_table(pa.table({"x": pa.array(
                [1, 2, 3], type=pa.decimal128(10, scale))}), p)
    for make, kw in ((pqt.Dataset, {"device": "cpu"}),
                     (parquet_tpu.Dataset, {})):
        with pytest.raises(ValueError, match="schema mismatch"):
            make([a, b]).read(**kw)


def test_prune_and_plan_match_jax(tmp_path):
    from parquet_tpu_torch.algebra.expr import col

    paths = _keyed_corpus(str(tmp_path))
    want = parquet_tpu.Dataset(paths)
    ds = pqt.Dataset(paths)
    for kw in ({"path": "x", "lo": 2500, "hi": 4100},
               {"path": "x", "values": [5, 6001, 10 ** 9]},
               {"path": "x", "lo": 10 ** 9}):
        assert ds.prune(**kw) == want.prune(**kw), kw
    assert ds.prune(where=(col("x") >= 7000) | (col("x") <= 10)) == \
        [paths[0], paths[3]]
    with pytest.raises(ValueError):
        ds.prune("x", lo=1, values=[2])
    lo = 2 * 2000 + RG  # the second row group of file 2, onward
    got = ds.plan("x", lo=lo, hi=lo + 10, device="cpu")
    exp = want.plan("x", lo=lo, hi=lo + 10)
    assert set(got) == set(exp) == {paths[2]}
    assert [(p.rg_index, p.page_ordinals, p.first_row, p.row_count)
            for p in got[paths[2]]] == [
        (p.rg_index, p.page_ordinals, p.first_row, p.row_count)
        for p in exp[paths[2]]]
    got = ds.plan(where=col("x").between(lo, lo + 10), device="cpu")
    assert [(d.rg_index, d.ranges) for d in got[paths[2]].survivors] == [
        (d.rg_index, d.ranges) for d in parquet_tpu.Dataset(paths).plan(
            where=parquet_tpu.col("x").between(lo, lo + 10))[
                paths[2]].survivors]


@pytest.mark.parametrize("lo,hi", [(700, 1300), (5000, None), (None, -1)])
def test_any_match_stats_matches_jax(tmp_path, lo, hi):
    """``any_match_stats``, the file-level prune, answers as the
    reference's and as its statistics-only plan (a file with a survivor),
    whichever row group decides."""
    from parquet_tpu.io.planner import ScanPlanner as JScanPlanner

    from parquet_tpu_torch.algebra.expr import col
    from parquet_tpu_torch.io.planner import ScanPlanner

    path = _keyed_corpus(str(tmp_path), n_files=1)[0]
    port = ScanPlanner(pqt.ParquetFile(path), device="cpu")
    ref = JScanPlanner(parquet_tpu.ParquetFile(path))
    for lo_, hi_ in ((lo, hi), (hi, lo)):
        expr = col("x").between(lo_, hi_)
        jexpr = parquet_tpu.col("x").between(lo_, hi_)
        want = ref.plan(jexpr, stages=("stats",))
        assert port.any_match_stats(expr) == ref.any_match_stats(jexpr) \
            == bool(want.survivors), (lo_, hi_)


# ---------------------------------------------------------------------------
# reads against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("devices", ["cpu", "cpu8"])
def test_read_matches_jax(mixed, devices):
    dev = CPU if devices == "cpu" else EIGHT
    got = pqt.Dataset(mixed["paths"]).read(device=dev)
    _same_table(got, mixed["host"], f"{devices} vs host")
    _same_table(got, mixed["device"], f"{devices} vs device")
    assert pqt.MESH["files_sharded"] == N_FILES
    assert sum(pqt.ROUTE_REFUSALS.values()) == 0
    assert sum(pqt.HOST_ROUTE.values()) == 0
    # a window of four on eight shards; one file at a time on one device
    assert pqt.MESH["stage_overlapped"] == (N_FILES - 1 if devices == "cpu8"
                                            else 0)
    assert pqt.MESH["staging_bytes_peak"] > 0


def test_read_columns_matches_jax(mixed):
    cols = ["dict_s", "nul_f", "bss_f"]
    want = parquet_tpu.Dataset(mixed["paths"][:1]).read(columns=cols)
    got = pqt.Dataset(mixed["paths"][:1]).read(columns=cols, device=EIGHT)
    _same_table(got, want, "columns")


@pytest.mark.parametrize("entries", [1, 2, 4, 8])
def test_window_follows_the_mesh(mixed, entries):
    """``min(len(mesh), 4)`` files in flight: one entry reads one file at
    a time, more run every later file ahead; the result is the same."""
    got = pqt.Dataset(mixed["paths"]).read(device=[CPU] * entries)
    _same_table(got, mixed["host"], f"{entries} entries")
    assert pqt.MESH["stage_overlapped"] == (0 if entries == 1
                                            else N_FILES - 1)
    assert pqt.MESH["files_sharded"] == N_FILES


def test_refused_files_take_the_host_read(mixed, monkeypatch):
    """A file the footer check refuses reads on the host decode, counted;
    the result is the same."""
    paths = mixed["paths"]
    real = tplanner.device_encoding_supported

    def deny_even(pf, columns=None):
        if paths.index(pf.source.path) % 2 == 0:
            return False, "test: encoding denied"
        return real(pf, columns)

    monkeypatch.setattr(tplanner, "device_encoding_supported", deny_even)
    got = pqt.Dataset(paths).read(device=EIGHT)
    _same_table(got, mixed["host"], "refused files")
    assert pqt.ROUTE_REFUSALS == {"unsupported": 2, "error": 0}
    assert pqt.MESH["files_sharded"] == N_FILES - 2


def test_unsupported_encoding_is_refused_from_the_footer(tmp_path):
    """A file whose footer lists an encoding the card does not decode
    (legacy BIT_PACKED levels) is refused before any byte is staged."""
    src = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "host_route.parquet")
    pf = pqt.ParquetFile(src)
    ok, _ = tplanner.device_encoding_supported(pf)
    assert ok  # PLAIN and dictionary pages: refused chunk by chunk
    md = pf.metadata.row_groups[0].columns[0].meta_data
    saved = list(md.encodings)
    md.encodings = saved + [4]  # BIT_PACKED
    try:
        ok, why = tplanner.device_encoding_supported(pf)
    finally:
        md.encodings = saved
    assert not ok and "BIT_PACKED" in why
    pf.close()


def test_chunks_the_plan_refuses_take_the_host_route(tmp_path):
    """Chunks whose dictionary falls back to PLAIN pages mid-chunk: the
    footer allows the file, the plan refuses those chunks, which decode on
    the host route, each counted; the rest stays on the device route."""
    paths = []
    for i in range(2):
        rng = np.random.default_rng(10 + i)
        items = [bytes(rng.integers(0, 256, 20, dtype=np.uint8))
                 for _ in range(3000)]
        p = os.path.join(str(tmp_path), f"p{i}.parquet")
        papq.write_table(pa.table({"s": pa.array(items),
                                   "x": pa.array(np.arange(3000))}), p,
                         use_dictionary=["s"], dictionary_pagesize_limit=2000,
                         data_page_size=1000)
        paths.append(p)
    got = pqt.Dataset(paths).read(device=EIGHT)
    _same_table(got, parquet_tpu.Dataset(paths).read(), "host route")
    assert pqt.HOST_ROUTE["mixed_page_kinds"] == 2
    assert pqt.ROUTE_REFUSALS["unsupported"] == 2
    assert pqt.MESH["chunks_host_fallback"] == 2
    assert pqt.MESH["files_sharded"] == 2


def test_corrupt_file_raises_and_staging_drains(tmp_path, mixed):
    paths = _mixed_corpus(str(tmp_path), n_files=2)
    meta = papq.ParquetFile(paths[1]).metadata
    off = meta.row_group(1).column(0).data_page_offset
    raw = bytearray(open(paths[1], "rb").read())
    for o in (off, off + 1, off + 2):
        raw[o] ^= 0xFF
    open(paths[1], "wb").write(bytes(raw))
    for devices in (CPU, EIGHT):
        with pytest.raises(CorruptedError):
            pqt.Dataset(paths).read(device=devices)
        assert pqt.MESH["staging_bytes"] == 0
    assert pqt.ROUTE_REFUSALS["error"] == 2  # then the host read raised


def test_early_close_releases_staging(mixed):
    ds = pqt.Dataset(mixed["paths"])
    gen = tmesh.read_dataset_device(ds, None, None, EIGHT)
    first = next(gen)
    assert set(first) == set(mixed["host"].keys())
    assert pqt.MESH["staging_bytes"] > 0  # the files running ahead
    gen.close()
    assert pqt.MESH["staging_bytes"] == 0


def test_read_inside_a_pool_worker_runs_inline(mixed):
    """Inside a shared-pool worker the files stage and decode on that
    worker, one after another (no nested wait on the pool)."""
    ds = pqt.Dataset(mixed["paths"])
    got = tpool.submit(ds.read, None, EIGHT).result(timeout=120)
    _same_table(got, mixed["host"], "nested")


def test_empty_files_and_zero_rows(tmp_path):
    a = os.path.join(str(tmp_path), "a.parquet")
    b = os.path.join(str(tmp_path), "b.parquet")
    papq.write_table(pa.table({"x": pa.array(np.zeros(0, np.int64)),
                               "s": pa.array([], pa.string())}), a)
    papq.write_table(pa.table({"x": pa.array(np.arange(5)),
                               "s": pa.array(list("abcde"))}), b)
    got = pqt.Dataset([a, b, a]).read(device=EIGHT)
    np.testing.assert_array_equal(got["x"].values.numpy(), np.arange(5))
    got = pqt.Dataset([a]).read(device="cpu")
    assert got["x"].values.shape == (0,)
    assert got["s"].offsets.tolist() == [0]


# ---------------------------------------------------------------------------
# read(row_groups=), row_group(i), read_table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sel", [[2, 0], [1], [], [0, 0]])
def test_read_row_groups_matches_jax(mixed, sel):
    path = mixed["paths"][1]
    got = pqt.ParquetFile(path).read(device="cpu", row_groups=sel)
    want = parquet_tpu.ParquetFile(path).read(row_groups=sel)
    if not sel:
        assert all(c.num_slots == 0 and c.num_values == 0
                   for c in got.values())
        assert want.num_rows == 0
        return
    _same_table(got, want, f"row_groups={sel}")


@pytest.mark.parametrize("bad", [3, -1])
def test_read_row_group_out_of_range(mixed, bad):
    path = mixed["paths"][0]
    with pytest.raises(IndexError) as got:
        pqt.ParquetFile(path).read(device="cpu", row_groups=[0, bad])
    with pytest.raises(IndexError) as want:
        parquet_tpu.ParquetFile(path).read(row_groups=[0, bad])
    assert str(got.value) == str(want.value)


def test_row_group_readers_built_once(mixed):
    f = pqt.ParquetFile(mixed["paths"][0])
    first = f.row_groups
    assert [id(r) for r in first] == [id(r) for r in f.row_groups]
    assert f.row_groups is not first  # a new list each access
    assert [f.row_group(i) for i in range(3)] == first
    assert [r.index for r in first] == [0, 1, 2]
    with pytest.raises(IndexError):
        f.row_group(3)
    got = pqt.read_table(mixed["paths"][0], columns=["plain_i64"],
                         device="cpu")
    np.testing.assert_array_equal(got["plain_i64"].values.numpy(),
                                  np.arange(ROWS))


# ---------------------------------------------------------------------------
# the CUDA default, the refused methods, the pool
# ---------------------------------------------------------------------------


def test_cuda_by_default(mixed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = pqt.Dataset(mixed["paths"])
    for call in (ds.read, lambda: ds.read(device=["cuda:0"]),
                 lambda: pqt.read_table(mixed["paths"][0]),
                 pqt.default_mesh,
                 lambda: pqt.read_table_sharded(mixed["paths"][0]),
                 lambda: pqt.decode_step_sharded(None, 8),
                 lambda: ds.plan("plain_i64", lo=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("call", ["write_arrow", "DatasetWriter.write_arrow",
                                  "SortingWriter.write_arrow", "to_arrow"])
def test_arrow_methods_where_they_were_refused(mixed, call, tmp_path):
    """The four methods that refused until the Arrow slice, each against
    the JAX package's on the mixed corpus: the rows each writer takes from
    a ``pyarrow.Table`` read back as the JAX package's do, and the sharded
    read's ``to_arrow`` equals the JAX package's."""
    from parquet_tpu.algebra.buffer import SortingColumn as JSort
    from parquet_tpu.algebra.buffer import TableBuffer as JTableBuffer
    from parquet_tpu.algebra.sorting import SortingWriter as JSortingWriter
    from parquet_tpu.parallel import mesh as jmesh

    path = mixed["paths"][0]
    table = papq.read_table(path)
    schema = pqt.ParquetFile(path).schema
    jschema = parquet_tpu.ParquetFile(path).schema
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    if call == "write_arrow":
        buf, jbuf = pqt.TableBuffer(schema), JTableBuffer(jschema)
        buf.write_arrow(table)
        jbuf.write_arrow(table)
        with pqt.ParquetWriter(got, schema) as w:
            buf.flush_to(w)
        with parquet_tpu.ParquetWriter(want, jschema) as w:
            jbuf.flush_to(w)
    elif call == "SortingWriter.write_arrow":
        w = pqt.SortingWriter(got, schema, [pqt.SortingColumn("dict_s")],
                              buffer_rows=700, device=CPU)
        jw = JSortingWriter(want, jschema, [JSort("dict_s")],
                            buffer_rows=700)
        for s in range(0, table.num_rows, 500):
            w.write_arrow(table.slice(s, 500))
            jw.write_arrow(table.slice(s, 500))
        w.close()
        jw.close()
    elif call == "DatasetWriter.write_arrow":
        w = pqt.DatasetWriter(got, schema, rows_per_file=600)
        jw = parquet_tpu.DatasetWriter(want, jschema, rows_per_file=600)
        w.write_arrow(table)
        jw.write_arrow(table)
        w.commit()
        jw.commit()
        got_t = pqt.open_table(got).read(device=CPU).to_arrow()
        want_t = parquet_tpu.open_table(want).read().to_arrow()
        assert got_t.equals(want_t) and got_t.equals(table)
        return
    else:
        got_t = pqt.read_table_sharded(path, mesh=[CPU] * 2).to_arrow()
        want_t = jmesh.read_table_sharded(
            path, mesh=jmesh.default_mesh(2)).to_arrow()
        assert got_t.equals(want_t)
        assert got_t.num_rows == table.num_rows
        return
    assert papq.read_table(got).equals(papq.read_table(want))
    assert pqt.ParquetFile(got).read(device=CPU).to_arrow().equals(
        parquet_tpu.ParquetFile(want).read().to_arrow())


@pytest.mark.parametrize("field", ["snapshot_version", "_file_stats"])
def test_manifest_fields_where_they_were_refused(mixed, field):
    """A dataset of paths carries no manifest: both fields are None, as
    the JAX package's, and a shard keeps them."""
    ds = pqt.Dataset(mixed["paths"][:2])
    jds = parquet_tpu.Dataset(mixed["paths"][:2])
    assert getattr(ds, field) is None and getattr(jds, field) is None
    ds._file_stats, ds.snapshot_version = {}, 7
    assert getattr(ds.shard(1, 2), field) == getattr(ds, field)


def test_writer_write_stats_where_it_was_refused():
    """``ParquetWriter.write_stats``, refused until the write pipeline
    came, meters a write to a file object: its row groups, encode and
    emit seconds (nothing flushed through a path sink)."""
    table = {"a": np.arange(3000, dtype=np.int64),
             "b": np.arange(3000) % 7 == 0}
    w = pqt.ParquetWriter(io.BytesIO(), pqt.io.writer.schema_of(table),
                          pqt.WriterOptions(row_group_size=1000))
    assert isinstance(w.write_stats, pqt.WriteStats)
    assert w.write_stats.as_dict()["row_groups"] == 0
    w.write({k: pqt.ColumnData(values=v) for k, v in table.items()}, 3000)
    w.close()
    st = w.write_stats
    assert st.row_groups == 3 and st.encode_s > 0 and st.emit_s > 0
    assert st.bytes_flushed == 0 and st.overlapped_groups == 0


@pytest.mark.parametrize("call", ["scan_policy", "find_rows_policy",
                                  "policy", "report", "init_policy"])
def test_lifted_policy_calls_match_jax(mixed, call):
    """The calls that raised ``NotImplementedError`` before the fault
    layer was ported: on clean files each gives the JAX package's result
    under the same policy or report, and the report records no loss."""
    paths = mixed["paths"]
    pol = pqt.FaultPolicy(backoff_s=0, on_corrupt="skip_row_group")
    jpol = parquet_tpu.FaultPolicy(backoff_s=0, on_corrupt="skip_row_group")
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    port, ref = pqt.Dataset(paths), parquet_tpu.Dataset(paths)
    if call == "scan_policy":
        from tests.test_torch_host_scan import _same

        _same(port.scan("plain_i64", lo=100, device="cpu", policy=pol,
                        report=rep),
              ref.scan("plain_i64", lo=100, policy=jpol, report=jrep),
              call)
    elif call == "find_rows_policy":
        keys = [5, 1700, 4000, -3]
        got = port.find_rows("plain_i64", keys, columns=["nul_f"],
                             device="cpu", policy=pol, report=rep)
        want = ref.find_rows("plain_i64", keys, columns=["nul_f"],
                             policy=jpol, report=jrep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.rows, w.rows)
            np.testing.assert_array_equal(g.values["nul_f"],
                                          w.values["nul_f"])
        assert got.report is rep
    elif call == "policy":
        got = port.read(device=EIGHT, policy=pol, report=rep)
        _same_table(got, ref.read(policy=jpol, report=jrep), call)
        assert got.report is rep
    elif call == "report":
        assert port.prune("plain_i64", lo=1600, report=rep) == \
            ref.prune("plain_i64", lo=1600, report=jrep)
    else:
        got = pqt.Dataset(paths, policy=pol).read(device="cpu")
        want = parquet_tpu.Dataset(paths, policy=jpol).read()
        _same_table(got, want, call)
        rep, jrep = got.report, want.report
    for r in (rep, jrep):
        assert r.ok and r.rows_dropped == 0
    assert rep.rows_read == jrep.rows_read


def test_map_in_order():
    assert tpool.map_in_order(lambda x: x * x, range(20)) == [
        x * x for x in range(20)]

    def fail(x):
        if x in (3, 7):
            raise KeyError(x)
        return x

    with pytest.raises(KeyError) as e:
        tpool.map_in_order(fail, range(10))
    assert e.value.args == (3,)  # the first failing item's error

    def nested(_):
        # inside a pool worker: serial, on this worker
        assert tpool.in_shared_pool()
        names = tpool.map_in_order(
            lambda _: threading.current_thread().name, range(4))
        return set(names) == {threading.current_thread().name}

    assert all(tpool.map_in_order(nested, range(4)))
    assert not tpool.in_shared_pool()


@pytest.mark.parametrize("devices", ["cpu", "cpu8"])
def test_a_library_that_fails_to_load_raises(mixed, monkeypatch, devices):
    """A native library of the port that cannot load (the loader's
    ``OSError``) raises from ``Dataset.read``: no file is sent to the host
    read in its place."""
    import ctypes

    from parquet_tpu_torch.ops import _build

    def refuse(path, *a, **k):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="cannot build or load"):
        pqt.Dataset(mixed["paths"]).read(
            device=CPU if devices == "cpu" else EIGHT)
    assert sum(pqt.ROUTE_REFUSALS.values()) == 0


@pytest.mark.parametrize("error", [OSError, CorruptedError])
def test_an_error_of_the_decode_raises(mixed, monkeypatch, error):
    """Only the footer and the staging may send a file to the host read:
    an ``OSError`` or ``CorruptedError`` raised while a staged file
    decodes raises from ``Dataset.read``, uncounted."""
    def fail(*a, **k):
        raise error("raised by the decode")

    monkeypatch.setattr(tmesh, "_decode_prepped", fail)
    with pytest.raises(error, match="raised by the decode"):
        pqt.Dataset(mixed["paths"]).read(device=EIGHT)
    assert sum(pqt.ROUTE_REFUSALS.values()) == 0


def test_reads_from_many_threads_drain_staging(mixed):
    """Four reads at once on one dataset, a short switch interval: every
    result equal, the staged bytes back at 0."""
    import sys

    ds = pqt.Dataset(mixed["paths"])
    got, errors = [], []

    def one():
        try:
            got.append(ds.read(device=EIGHT))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=one) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for out in got:
        _same_table(out, mixed["host"], "concurrent")
    assert pqt.MESH["files_sharded"] == 4 * N_FILES
    assert pqt.MESH["staging_bytes"] == 0


# ---------------------------------------------------------------------------
# logical annotations: the schema check sees every one the JAX package sees
# ---------------------------------------------------------------------------


def _annotated_file() -> bytes:
    """A footer (no row group) whose leaves carry every logical annotation
    the JAX package's writer writes, LIST and MAP groups among them."""
    import io

    from parquet_tpu.format.enums import FieldRepetitionType as JRep
    from parquet_tpu.format.enums import Type as JT
    from parquet_tpu.io.writer import ParquetWriter, WriterOptions
    from parquet_tpu.schema import schema as S
    from parquet_tpu.schema.types import LogicalKind as K

    leaves = [
        S.leaf("str", JT.BYTE_ARRAY, logical=K.STRING),
        S.leaf("enum", JT.BYTE_ARRAY, logical=K.ENUM),
        S.leaf("json", JT.BYTE_ARRAY, logical=K.JSON),
        S.leaf("bson", JT.BYTE_ARRAY, logical=K.BSON),
        S.leaf("uuid", JT.FIXED_LEN_BYTE_ARRAY, logical=K.UUID,
               type_length=16),
        S.leaf("f16", JT.FIXED_LEN_BYTE_ARRAY, logical=K.FLOAT16,
               type_length=2),
        S.leaf("dec32", JT.INT32, logical=K.DECIMAL, precision=9, scale=2),
        S.leaf("dec64", JT.INT64, logical=K.DECIMAL, precision=18, scale=4),
        S.leaf("decfl", JT.FIXED_LEN_BYTE_ARRAY, logical=K.DECIMAL,
               precision=30, scale=3, type_length=13),
        S.leaf("decba", JT.BYTE_ARRAY, logical=K.DECIMAL, precision=40,
               scale=0),
        S.leaf("date", JT.INT32, logical=K.DATE),
        S.leaf("interval", JT.FIXED_LEN_BYTE_ARRAY, logical=K.INTERVAL,
               type_length=12),
        S.leaf("unknown", JT.INT32, JRep.OPTIONAL, logical=K.UNKNOWN)]
    for unit, phys in (("millis", JT.INT32), ("micros", JT.INT64),
                       ("nanos", JT.INT64)):
        for utc in (True, False):
            leaves.append(S.leaf(f"time_{unit}_{utc}", phys,
                                 logical=f"time_{unit}", utc=utc))
            leaves.append(S.leaf(f"ts_{unit}_{utc}", JT.INT64,
                                 logical=f"timestamp_{unit}", utc=utc))
    for bw in (8, 16, 32, 64):
        for signed in (True, False):
            leaves.append(S.leaf(f"int{bw}_{signed}",
                                 JT.INT64 if bw == 64 else JT.INT32,
                                 logical=K.INT, bit_width=bw,
                                 signed=signed))
    leaves.append(S.list_of("xs", S.leaf("e", JT.INT32, JRep.OPTIONAL)))
    leaves.append(S.map_of("m", S.leaf("k", JT.BYTE_ARRAY,
                                       logical=K.STRING),
                           S.leaf("v", JT.DOUBLE, JRep.OPTIONAL)))
    buf = io.BytesIO()
    ParquetWriter(buf, S.message("m", leaves), WriterOptions()).close()
    return buf.getvalue()


def test_every_logical_annotation_reads_as_jax():
    raw = _annotated_file()
    got = [(leaf.name, leaf.logical_kind, leaf.logical_params)
           for leaf in pqt.ParquetFile(raw).schema.leaves]
    want = [(leaf.dotted_path, leaf.logical_kind, leaf.logical_params)
            for leaf in parquet_tpu.ParquetFile(raw).schema.leaves]
    assert got == want
    assert len({k for _, k, _ in got}) == 18  # the leaf kinds, NONE too
    groups = {n.name: n.logical_kind
              for n in pqt.ParquetFile(raw).schema.root.children}
    assert (groups["xs"], groups["m"]) == ("list", "map")


def test_legacy_converted_types_read_as_jax():
    """Elements with only a ConvertedType (every value, and one no
    version names), with and without decimal parameters."""
    from parquet_tpu.format import metadata as jmd
    from parquet_tpu.schema.types import _logical_from_element

    from parquet_tpu_torch.format import metadata as tmd
    from parquet_tpu_torch.schema.schema import _logical_kind

    for ct in list(range(22)) + [None, 40]:
        kw = dict(name="x", converted_type=ct, scale=3, precision=11)
        assert _logical_kind(tmd.SchemaElement(**kw)) == \
            _logical_from_element(jmd.SchemaElement(**kw)), ct


@pytest.mark.parametrize("drift", ["timestamp_unit", "utc"])
def test_timestamp_drift_raises_as_jax(tmp_path, drift):
    """Files that differ only in a TIMESTAMP unit, or only in
    ``isAdjustedToUTC``: each package's read, prune and scan refuse them
    as one dataset."""
    a = os.path.join(str(tmp_path), "a.parquet")
    b = os.path.join(str(tmp_path), "b.parquet")
    ts = np.arange(10, dtype=np.int64) * 1000
    if drift == "timestamp_unit":
        types = (pa.timestamp("ms"), pa.timestamp("us"))
    else:
        types = (pa.timestamp("ms", tz="UTC"), pa.timestamp("ms"))
    for p, t in zip((a, b), types):
        papq.write_table(pa.table({"ts": pa.array(ts, type=t),
                                   "v": pa.array(ts)}), p)
    assert pqt.ParquetFile(a).schema.leaf("ts").physical_type == \
        pqt.ParquetFile(b).schema.leaf("ts").physical_type
    port, ref = pqt.Dataset([a, b]), parquet_tpu.Dataset([a, b])
    for call in (lambda ds, kw: ds.read(**kw),
                 lambda ds, kw: ds.prune("v", lo=0),
                 lambda ds, kw: ds.scan("v", lo=0, **kw)):
        for ds, kw in ((port, {"device": "cpu"}), (ref, {})):
            with pytest.raises(ValueError, match="schema mismatch"):
                call(ds, kw)


# ---------------------------------------------------------------------------
# Dataset.scan
# ---------------------------------------------------------------------------


def _scan_corpus(root, n_files=4, rows=2000):
    """Files with disjoint ascending keys ``x`` (file i: [i*rows,
    (i+1)*rows)), a string ``s``, a nullable float ``f`` (nulls only from
    file 2 on) and a FIXED_LEN_BYTE_ARRAY ``fl``, a page index."""
    paths = []
    for i in range(n_files):
        x = np.arange(i * rows, (i + 1) * rows, dtype=np.int64)
        m = (x % 7 == 0) & (i >= 2)
        t = pa.table({
            "x": pa.array(x),
            "s": pa.array([f"s{v % 13}" for v in x]),
            "f": pa.array(np.where(m, 0.0, x * 0.5), mask=m),
            "fl": pa.array([int(v % 251).to_bytes(2, "little") for v in x],
                           type=pa.binary(2))})
        p = os.path.join(root, f"part-{i:02d}.parquet")
        papq.write_table(t, p, row_group_size=RG, write_page_index=True,
                         data_page_size=1024)
        paths.append(p)
    return paths


@pytest.mark.parametrize("mesh", [[CPU], [CPU] * 4], ids=["x1", "x4"])
def test_dataset_scan_matches_jax(tmp_path, mesh):
    from parquet_tpu.algebra.expr import col as jcol
    from tests.test_torch_host_scan import _same

    from parquet_tpu_torch.algebra.expr import col

    paths = _scan_corpus(str(tmp_path))
    port, ref = pqt.Dataset(paths), parquet_tpu.Dataset(paths)
    cases = [({"path": "x", "lo": 3500, "hi": 6200}, {}),
             ({"path": "x", "values": [7, 2001, 10 ** 9]}, {}),
             ({"path": "s", "values": ["s3"]}, {"columns": ["x", "f"]}),
             ({"path": "x", "lo": 10 ** 9}, {}),
             ({"path": "x", "lo": 10 ** 9}, {"columns": ["fl", "s"]})]
    for pred, kw in cases:
        got = port.scan(device=mesh, **pred, **kw)
        _same(got, ref.scan(**pred, **kw), f"{pred} {kw}")
    for tree, kw in ((lambda c: (c("x") <= 100) | (c("x") >= 7900), {}),
                     (lambda c: c("f").is_null() & (c("s") == "s1"),
                      {"columns": ["x", "fl"]}),
                     (lambda c: c("x") >= 10 ** 9, {})):
        got = port.scan(where=tree(col), device=mesh, **kw)
        _same(got, ref.scan(where=tree(jcol), **kw), f"tree {kw}")
    # one survivor: a single file's result, unmerged
    got = port.scan("x", lo=10, hi=20, device=mesh)
    _same(got, ref.scan("x", lo=10, hi=20), "one file")


def test_dataset_scan_equals_per_file_scans(tmp_path):
    paths = _scan_corpus(str(tmp_path))
    got = pqt.Dataset(paths).scan("x", lo=1500, hi=5200, device=[CPU] * 2)
    want_s, want_f = [], []
    for p in paths:
        one = pqt.scan_filtered(pqt.ParquetFile(p), "x", lo=1500, hi=5200,
                                device=CPU)
        want_s.extend(one["s"])
        want_f.append(one["f"])
    assert got["s"] == want_s and len(want_s) == 5200 - 1500 + 1
    f = np.ma.concatenate([w for w in want_f if len(w)])
    assert np.array_equal(np.ma.getmaskarray(got["f"]),
                          np.ma.getmaskarray(f))
    assert np.array_equal(np.ma.getdata(got["f"]), np.ma.getdata(f))


def test_dataset_scan_empty_fallback_validates_columns(tmp_path):
    p = os.path.join(str(tmp_path), "nested.parquet")
    papq.write_table(pa.table({
        "x": pa.array(np.arange(10, dtype=np.int64)),
        "lst": pa.array([[i, i] for i in range(10)])}), p)
    for ds, kw in ((pqt.Dataset([p]), {"device": "cpu"}),
                   (parquet_tpu.Dataset([p]), {})):
        with pytest.raises(ValueError, match="nested"):
            ds.scan("x", lo=10 ** 12, columns=["lst.list.element"], **kw)
        with pytest.raises(KeyError):
            ds.scan("x", lo=10 ** 12, columns=["nope"], **kw)
    empty = pqt.Dataset([p]).shard(1, 2)
    with pytest.raises(ValueError, match="empty dataset shard"):
        empty.scan("x", lo=1, device="cpu")


# ---------------------------------------------------------------------------
# the streamed read
# ---------------------------------------------------------------------------


def _port_drain(batches) -> dict:
    batches = list(batches)
    return {p: concat_columns([b[p] for b in batches]) for p in batches[0]}


@pytest.mark.parametrize("batch_rows", [1700, 100_000])
def test_iter_batches_matches_jax_and_read(mixed, batch_rows):
    paths = mixed["paths"]
    got = list(pqt.Dataset(paths).iter_batches(batch_rows=batch_rows,
                                               device=CPU))
    want = list(parquet_tpu.Dataset(paths).iter_batches(
        batch_rows=batch_rows))
    assert [b["plain_i64"].num_slots for b in got] == [b.num_rows
                                                       for b in want]
    for k, (g, w) in enumerate(zip(got, want)):
        _same_table(g, w.columns, f"batch {k}")
    whole = pqt.Dataset(paths).read(device=CPU)
    drained = _port_drain(got)
    for path, col in whole.items():
        _same_column(drained[path], mixed["host"][path], path)
        np.testing.assert_array_equal(
            _port_host(drained[path])[0], _port_host(col)[0], err_msg=path)


def test_degraded_iter_batches_skips_bad_file(tmp_path):
    paths = _keyed_corpus(str(tmp_path))
    with open(paths[0], "wb") as f:
        f.write(b"PAR1 not really a parquet file")
    skip = pqt.FaultPolicy(backoff_s=0.0, on_corrupt="skip_row_group")
    jskip = parquet_tpu.FaultPolicy(backoff_s=0.0,
                                    on_corrupt="skip_row_group")
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = _port_drain(pqt.Dataset(paths, policy=skip).iter_batches(
        batch_rows=1500, device=CPU, report=rep))
    want = parquet_tpu.Dataset(paths, policy=jskip)
    want = [b for b in want.iter_batches(batch_rows=1500, report=jrep)]
    np.testing.assert_array_equal(
        got["x"].values.numpy(),
        np.concatenate([np.asarray(b.columns["x"].values) for b in want]))
    assert got["x"].num_slots == 3 * 2000
    assert rep.files_skipped == jrep.files_skipped == [paths[0]]
    assert rep.rows_read == jrep.rows_read


def test_degraded_iter_batches_accounting_never_double_counts(
        tmp_path, monkeypatch):
    """A file that dies mid-drain after one batch and one row-group skip:
    its file skip counts only the rows neither delivered nor dropped, so
    every row of the dataset is read or dropped exactly once."""
    paths = _keyed_corpus(str(tmp_path), n_files=2)
    skip = pqt.FaultPolicy(backoff_s=0.0, on_corrupt="skip_row_group")

    class _DiesMidDrain:
        def __init__(self, pf):
            self._pf = pf

        def __getattr__(self, name):
            return getattr(self._pf, name)

        def iter_batches(self, **kw):
            it = self._pf.iter_batches(**kw)
            yield next(it)
            kw["report"].record_skip(1, rows=RG, error="a row group")
            raise OSError("the mount died mid-drain")

    real = pqt.Dataset.file

    def file(self, i):
        pf = real(self, i)
        return _DiesMidDrain(pf) if i == 0 else pf

    monkeypatch.setattr(pqt.Dataset, "file", file)
    rep = pqt.ReadReport()
    got = list(pqt.Dataset(paths, policy=skip).iter_batches(
        batch_rows=RG, device=CPU, report=rep))
    rows = sum(b["x"].num_slots for b in got)
    assert rows == RG + 2000
    assert rep.files_skipped == [paths[0]]
    assert rep.row_groups_skipped == [1]
    assert rep.rows_read == rows
    assert rep.rows_read + rep.rows_dropped == 2 * 2000


def test_dataset_options_reach_every_file(mixed):
    opts = pqt.ReadOptions(verify_crc=True)
    ds = pqt.Dataset(mixed["paths"], options=opts)
    assert all(pf.options is opts for pf in ds.files)
    assert all(pf.options is opts for pf in ds.shard(1, 2).files)
