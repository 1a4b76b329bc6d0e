"""parquet_tpu_torch's host scan (``scan_expr``, ``scan_filtered``,
``scan_files``, ``merge_scan_results``) on the CPU against parquet_tpu's
host scan, and the C++ byte-array gather against its numpy version and
the JAX package's native gather.

The matrix follows ``tests/test_search.py`` and ``tests/test_algebra.py``:
keys of every order domain (int32, int64, uint32, uint64, float and
double with NaN and signed zeros, INT64 decimals, dictionary and PLAIN
strings, FLBA decimals with nulls, byte-array decimals), nulls on and
off, several row groups, page index on and off, bloom filters on and
off, and ``And``/``Or``/``Not``/null/notnull/IN trees, with
``num_threads`` 1, None and 3 taking turns.  Every result is equal to
the reference's: the same columns, the same forms (numpy,
``MaskedArray``, lists of bytes), dtypes, bits and masks.  Files are
small (2,000 rows) and made once each; no thread is left after any test."""

import decimal
import functools
import io
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from parquet_tpu import native as jnative
from parquet_tpu.algebra.expr import col as jcol
from parquet_tpu.io.reader import ParquetFile as JParquetFile
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table
from parquet_tpu.parallel import host_scan as jhs

import parquet_tpu_torch as pqt
from parquet_tpu_torch.algebra.expr import col
from parquet_tpu_torch.io import search as tsearch
from parquet_tpu_torch.ops import host
from parquet_tpu_torch.parallel import host_scan as ths
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")
N = 2000
RG = 500  # four row groups


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
    """Both packages' shared pools started whole, so that the per-test
    thread count sees only what a test leaves behind."""
    from parquet_tpu.utils import pool as jpool

    for pool, width in ((tpool.shared_pool(), tpool.pool_width()),
                        (jpool.shared_pool(), jpool.pool_width())):
        barrier = threading.Barrier(width + 1)
        futs = [pool.submit(barrier.wait) for _ in range(width)]
        barrier.wait(timeout=30)
        for f in futs:
            f.result(timeout=30)


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


# ---------------------------------------------------------------------------
# the files, each made once by the JAX package's writer
# ---------------------------------------------------------------------------

VARIANTS = {  # name: (nulls, page index, bloom filters)
    "plain": (False, True, True),
    "nulls": (True, True, False),
    "nulls_no_index": (True, False, True),
    "no_index_no_bloom": (False, False, False),
}


@functools.lru_cache(None)
def typed(variant: str) -> bytes:
    nulls, index, bloom = VARIANTS[variant]
    rng = np.random.default_rng(7)
    d = rng.random(N) * 4 - 2
    d[::97], d[::89], d[::83] = np.nan, 0.0, -0.0
    regions = np.array([f"r{i:02d}" for i in range(40)])

    def nullable(arr, share=0.08):
        if not nulls:
            return pa.array(arr)
        m = rng.random(N) < share
        return pa.array(np.where(m, np.zeros_like(arr), arr), mask=m)

    t = pa.table({
        "i32": nullable(np.sort(rng.integers(-1000, 1000, N)).astype(
            np.int32)),
        "u32": nullable(rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(
            np.uint32)),
        "u64": nullable(rng.integers(0, 2 ** 64 - 1, N, dtype=np.uint64)),
        "f": nullable(d.astype(np.float32)),
        "d": nullable(d),
        "dec": pa.array([None if nulls and i % 13 == 0 else
                         decimal.Decimal(f"{i - 3000}.25") for i in range(N)],
                        type=pa.decimal128(12, 2)),
        "sd": pa.array([None if nulls and i % 17 == 0 else
                        regions[(i * 7) % 40] for i in range(N)]),
        "sp": pa.array([None if nulls and i % 19 == 0 else f"w{i % 500:03d}"
                        for i in range(N)]),
        "fd": pa.array([None if i % 11 == 0 else
                        decimal.Decimal(f"{(i * 37) % 5000 - 2500}.50")
                        for i in range(N)], type=pa.decimal128(25, 2)),
        "v": pa.array(np.arange(N, dtype=np.int64)),
    })
    buf = io.BytesIO()
    jwrite_table(t, buf, JWriterOptions(
        row_group_size=RG, data_page_size=1 << 11, dictionary=["sd"],
        write_page_index=index,
        bloom_filters=({"i32": 10, "u64": 10, "sd": 10, "d": 10}
                       if bloom else {})))
    return buf.getvalue()


@functools.lru_cache(None)
def byte_array_decimal() -> bytes:
    """A decimal annotated over BYTE_ARRAY (minimal-length big-endian
    two's complement, negatives among them), which pyarrow never writes."""
    from parquet_tpu.format.enums import Type as JType
    from parquet_tpu.io.writer import ColumnData, ParquetWriter
    from parquet_tpu.schema import schema as jsch
    from parquet_tpu.schema.types import LogicalKind

    root = jsch.message("m", [
        jsch.leaf("bd", JType.BYTE_ARRAY, logical=LogicalKind.DECIMAL,
                  precision=20, scale=2),
        jsch.leaf("v", JType.INT64)])
    unscaled = [(i * 7919) % 2001 - 1000 for i in range(2000)]
    raws = [u.to_bytes(max(1, (u.bit_length() + 8) // 8), "big",
                       signed=True) for u in unscaled]
    offs = np.zeros(len(raws) + 1, np.int64)
    np.cumsum([len(r) for r in raws], out=offs[1:])
    buf = io.BytesIO()
    w = ParquetWriter(buf, root, JWriterOptions(dictionary=False,
                                                row_group_size=500,
                                                data_page_size=1 << 10))
    for a in range(0, 2000, 500):
        w.write_row_group({
            "bd": ColumnData(values=np.frombuffer(
                b"".join(raws[a:a + 500]), np.uint8),
                offsets=offs[a:a + 501] - offs[a]),
            "v": ColumnData(values=np.arange(a, a + 500, dtype=np.int64))},
            500)
    w.close()
    return buf.getvalue()


def _same(got: dict, want: dict, what: str) -> None:
    """The same columns in the same forms: lists of bytes, or numpy and
    MaskedArrays of one type, dtype and shape, bit for bit, mask for
    mask."""
    assert list(got) == list(want), what
    for c in want:
        g, w = got[c], want[c]
        if isinstance(w, list):
            assert g == w, f"{what}: {c}"
            continue
        assert type(g) is type(w), f"{what}: {c} {type(g)} {type(w)}"
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {c}"
        assert np.array_equal(np.ma.getmaskarray(g),
                              np.ma.getmaskarray(w)), f"{what}: {c} mask"
        gd, wd = np.ascontiguousarray(np.ma.getdata(g)), \
            np.ascontiguousarray(np.ma.getdata(w))
        assert np.array_equal(gd.view(np.uint8), wd.view(np.uint8)), \
            f"{what}: {c} values"


def _both(raw: bytes):
    return pqt.ParquetFile(raw), JParquetFile(raw)


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

D = decimal.Decimal
# key column -> predicate trees over it (built with either package's col)
TREES = {
    "i32": [lambda c: c("i32").between(-200, 300),
            lambda c: c("i32").isin([-999, 0, 5, 17, 998, 5000]),
            lambda c: ~c("i32").between(-500, 500),
            lambda c: (c("i32") == 0) | c("i32").is_null()],
    "v": [lambda c: c("v").between(700, 2300),
          lambda c: ~c("v").isin([0, 5, 2999, 10 ** 12])],
    "u32": [lambda c: c("u32").between(2 ** 31, 2 ** 32 - 1),
            lambda c: ~(c("u32") <= 2 ** 31),
            lambda c: c("u32").not_null() & (c("u32") >= 2 ** 30)],
    "u64": [lambda c: c("u64") >= 2 ** 63 + 2 ** 62,
            lambda c: c("u64").isin([0, 2 ** 63, 2 ** 64 - 1]),
            lambda c: ~c("u64").between(2 ** 60, 2 ** 63)],
    "f": [lambda c: c("f").between(-0.0, 0.5),
          lambda c: c("f").isin([0.0, float("nan"), 1.5]),
          lambda c: ~(c("f") >= 0.0)],
    "d": [lambda c: c("d").between(0.0, 0.0),
          lambda c: c("d") >= -0.0,
          lambda c: ~c("d").between(-1.0, 1.0) | c("d").is_null(),
          lambda c: c("d").isin([0.0, -0.0, float("nan")])],
    "dec": [lambda c: c("dec").between(D("-10.00"), D("200.25")),
            lambda c: c("dec").isin([D("7.25"), D("-2999.75")]),
            lambda c: ~(c("dec") <= D("0"))],
    "sd": [lambda c: c("sd").isin(["r03", "r17", "zz"]),
           lambda c: c("sd").between("r10", "r20"),
           lambda c: ~(c("sd") == "r05")],
    "sp": [lambda c: c("sp").isin(["w001", "w250", "w100x"]),
           lambda c: c("sp").between("w100", "w120"),
           lambda c: ~c("sp").between("w000", "w400") & c("sp").not_null()],
    "fd": [lambda c: c("fd").between(D("-100.00"), D("100.00")),
           lambda c: c("fd").isin([D("-2499.50"), D("0.50")]),
           lambda c: ~(c("fd") >= D("0")) | c("fd").is_null()],
    "tree": [lambda c: (c("i32").between(-100, 100) & ~c("sd").isin(
                 ["r01", "r02"])) | (c("d") >= 1.5),
             lambda c: c("sp").is_null() | (c("u32") <= 2 ** 20),
             lambda c: ~(c("i32").between(0, 900) | (c("f") <= 0.0))],
}
COLUMNS = [None, ["v", "i32", "sp", "fd"]]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("key", list(TREES))
def test_scan_expr_matches_jax(variant, key):
    pf, jpf = _both(typed(variant))
    for ti, tree in enumerate(TREES[key]):
        # the selections and thread counts take turns over the trees
        cols = COLUMNS[ti % len(COLUMNS)]
        nt = (1, None, 3)[(ti + len(key)) % 3]
        what = f"{variant} {key}[{ti}] {cols} threads={nt}"
        want = jhs.scan_expr(jpf, tree(jcol), columns=cols, num_threads=nt)
        got = pqt.scan_expr(pf, tree(col), columns=cols, num_threads=nt,
                            device=CPU)
        _same(got, want, what)


@pytest.mark.parametrize("variant", ["plain", "nulls_no_index"])
def test_scan_filtered_matches_jax(variant):
    """The single-column face, ranges and IN-lists, bloom on and off."""
    pf, jpf = _both(typed(variant))
    cases = [("i32", {"lo": -50, "hi": 50}), ("i32", {"values": [3, -7]}),
             ("u64", {"lo": 2 ** 63}), ("d", {"hi": -1.5}),
             ("sd", {"values": ["r11", "r12"]}), ("sp", {"lo": "w490"}),
             ("dec", {"values": [D("12.25")]}), ("v", {"lo": 10 ** 9})]
    for path, kw in cases:
        for bloom in (True, False):
            want = jhs.scan_filtered(jpf, path, use_bloom=bloom, **kw)
            got = pqt.scan_filtered(pf, path, use_bloom=bloom, device=CPU,
                                    **kw)
            _same(got, want, f"{variant} {path} {kw} bloom={bloom}")


def test_byte_array_decimal_key_matches_jax():
    pf, jpf = _both(byte_array_decimal())
    assert pf.schema.leaf("bd").logical_kind == "decimal"
    for kw in ({"lo": D("-3.00"), "hi": D("2.50")}, {"hi": D("-9.99")},
               {"values": [D("0.00"), D("-10.00"), D("1.01")]}):
        _same(pqt.scan_filtered(pf, "bd", device=CPU, **kw),
              jhs.scan_filtered(jpf, "bd", **kw), f"bd {kw}")
    for tree in (lambda c: ~c("bd").between(D("-1"), D("1")),
                 lambda c: (c("bd") == D("0.07")) | (c("v") <= 3)):
        _same(pqt.scan_expr(pf, tree(col), device=CPU),
              jhs.scan_expr(jpf, tree(jcol)), "bd tree")


def test_shared_pool_path_matches(monkeypatch):
    """The spans fanned out on the shared pool (the cell floor set to 0)
    give the serial result, and a scan run inside a pool worker stays
    serial there."""
    pf, jpf = _both(typed("nulls"))
    tree = (col("i32") >= 0) | col("sd").is_null()
    want = jhs.scan_expr(jpf, (jcol("i32") >= 0) | jcol("sd").is_null())
    monkeypatch.setattr(ths, "_POOL_MIN_CELLS", 0)
    _same(pqt.scan_expr(pf, tree, device=CPU), want, "pooled")
    got = tpool.submit(pqt.scan_expr, pf, tree, device=CPU).result(60)
    _same(got, want, "inside a pool worker")


def test_validation_and_refusals():
    pf, jpf = _both(typed("plain"))
    with pytest.raises(KeyError, match="unknown predicate column"):
        pqt.scan_expr(pf, col("nope") >= 1, device=CPU)
    with pytest.raises(KeyError, match="unknown column"):
        pqt.scan_expr(pf, col("v") >= 1, columns=["nope"], device=CPU)
    with pytest.raises(TypeError, match="Expr tree"):
        pqt.scan_expr(pf, "v >= 1", device=CPU)
    # a policy and a report are taken (io/faults.py), and change nothing
    # on clean bytes; skip_files without a report is refused, as in jax
    plain = pqt.scan_filtered(pf, "v", lo=1, device=CPU)
    for kw in ({"policy": pqt.FaultPolicy(backoff_s=0)},
               {"report": pqt.ReadReport()}):
        _same(pqt.scan_filtered(pf, "v", lo=1, device=CPU, **kw), plain,
              str(kw))
    with pytest.raises(ValueError, match="requires a report"):
        pqt.scan_files([pf], "v", lo=1, devices=[CPU], skip_files=True)
    with pytest.raises(ValueError, match="requires a report"):
        jhs.scan_files([jpf], "v", lo=1, skip_files=True)
    with pytest.raises(ValueError, match="exactly one"):
        pqt.scan_files([pf], devices=[CPU])


def test_nested_columns_refused_as_jax(tmp_path):
    """A nested predicate or output column raises the reference's
    ``ValueError``; the default selection leaves nested columns out."""
    t = pa.table({"k": pa.array(np.arange(50, dtype=np.int64)),
                  "xs": pa.array([[i, i + 1] for i in range(50)]),
                  "v": pa.array(np.arange(50, dtype=np.float64))})
    buf = io.BytesIO()
    jwrite_table(t, buf, JWriterOptions())
    pf, jpf = _both(buf.getvalue())
    for tree, cols in ((lambda c: c("xs.list.element") >= 1, None),
                       (lambda c: c("k") >= 1, ["xs.list.element"])):
        with pytest.raises(ValueError, match="nested") as je:
            jhs.scan_expr(jpf, tree(jcol), columns=cols)
        with pytest.raises(ValueError, match="nested") as te:
            pqt.scan_expr(pf, tree(col), columns=cols, device=CPU)
        assert str(te.value).split(";")[0] == str(je.value).split(";")[0]
    _same(pqt.scan_expr(pf, col("k") >= 40, device=CPU),
          jhs.scan_expr(jpf, jcol("k") >= 40), "default selection")


def test_cuda_by_default(monkeypatch):
    pf, _ = _both(typed("plain"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pqt.scan_expr(pf, col("v") >= 1),
                 lambda: pqt.scan_filtered(pf, "v", lo=1),
                 lambda: pqt.scan_files([pf], "v", lo=1),
                 lambda: pqt.scan(pf, "v", lo=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_bloom_probe_launches_once_a_plan(monkeypatch):
    """The planner's bloom stage probes every surviving row group in one
    batch on the scan's device; a plan without a filter, or with
    ``use_bloom=False``, probes nothing."""
    from parquet_tpu_torch.io import bloom

    calls = []
    real = bloom.check_hashes_multi

    def spy(filters, batches, device="cuda"):
        calls.append((len(filters), torch.device(device)))
        return real(filters, batches, device)

    monkeypatch.setattr(bloom, "check_hashes_multi", spy)
    pf, _ = _both(typed("plain"))
    pqt.scan_filtered(pf, "i32", values=[5, 6], device=CPU)
    assert calls == [(1, CPU)]  # the one row group the index keeps
    calls.clear()
    pqt.scan_filtered(pf, "u64", values=[5, 2 ** 63], device=CPU)
    assert calls == [(4, CPU)]
    calls.clear()
    pqt.scan_filtered(pf, "i32", values=[5, 6], device=CPU, use_bloom=False)
    pqt.scan_filtered(pf, "f", values=[0.5], device=CPU)  # no filter
    assert all(n == 0 for n, _ in calls)


def test_late_materialization_reads_only_survivor_pages(monkeypatch):
    """Phase 2 reads an output column only where a span has survivors,
    trimmed to [first survivor, last survivor]; a span without survivors
    is never read (``tests/test_planner.py``'s count of source reads)."""
    pf, jpf = _both(typed("plain"))
    reads = []
    real = tsearch.read_row_range

    def spy(pf_, path, start, count, aligned=False):
        reads.append((path, start, count))
        return real(pf_, path, start, count, aligned=aligned)

    monkeypatch.setattr(tsearch, "read_row_range", spy)
    # i32 is sorted: one page span survives the index, few rows the mask
    got = pqt.scan_expr(pf, col("i32").between(10, 12), columns=["sp"],
                        device=CPU)
    want = jhs.scan_expr(jpf, jcol("i32").between(10, 12), columns=["sp"])
    _same(got, want, "late materialization")
    k = [r for r in reads if r[0] == "i32"]
    s = [r for r in reads if r[0] == "sp"]
    assert len(k) >= 1 and len(s) == len(k)
    assert sum(c for _, _, c in s) == len(got["sp"])
    assert sum(c for _, _, c in s) < sum(c for _, _, c in k)
    reads.clear()
    # a tree whose candidate spans hold no survivor (a string between the
    # chunk's bounds that no row holds): no output read at all
    tree = col("i32").between(10, 12) & col("sp").isin(["w100x"])
    got = pqt.scan_expr(pf, tree, columns=["v"], device=CPU)
    assert len(got["v"]) == 0 and reads
    assert all(r[0] != "v" for r in reads)


def test_forms_keep_validity_aligned():
    """An output column whose early spans have no nulls and whose later
    spans do: the MaskedArray's mask stays aligned (both phases: a filter
    column reused as output, and a phase-2 column)."""
    n = 4000
    x = np.arange(n, dtype=np.int64)
    m = np.zeros(n, bool)
    m[2500::7] = True
    fl = np.zeros((n, 4), np.uint8)
    fl[:, 0] = np.arange(n) % 251
    t = pa.table({"k": pa.array(x),
                  "y": pa.array(np.where(m, 0, x * 3), mask=m),
                  "fl": pa.array([None if mm else bytes(r)
                                  for r, mm in zip(fl, m)],
                                 type=pa.binary(4))})
    buf = io.BytesIO()
    jwrite_table(t, buf, JWriterOptions(row_group_size=1000,
                                        dictionary=False))
    pf, jpf = _both(buf.getvalue())
    for tree in (lambda c: c("k") >= 10, lambda c: c("y").not_null()
                 | (c("k") <= 3000)):
        for cols in (["y", "fl", "k"], ["fl"]):
            got = pqt.scan_expr(pf, tree(col), columns=cols, device=CPU)
            _same(got, jhs.scan_expr(jpf, tree(jcol), columns=cols),
                  f"forms {cols}")
            assert isinstance(got["fl"], np.ma.MaskedArray)
            assert got["fl"].shape[1] == 4


# ---------------------------------------------------------------------------
# many files
# ---------------------------------------------------------------------------


def test_merge_scan_results_mixed_empty_shapes():
    """Zero-row parts drop before concatenating: an FLBA ``(n, w)`` part
    beside the 1-D typed empty, MaskedArrays, byte lists."""
    parts = [
        {"fl": np.empty(0, np.uint8), "x": np.empty(0, np.int64), "s": []},
        {"fl": np.arange(8, dtype=np.uint8).reshape(2, 4),
         "x": np.ma.MaskedArray([1, 2], mask=[False, True]), "s": [b"a"]},
        {"fl": np.empty(0, np.uint8), "x": np.array([3], np.int64),
         "s": [None, b"b"]},
        {"fl": np.ones((1, 4), np.uint8), "x": np.empty(0, np.int64),
         "s": []}]
    cols = ["fl", "x", "s"]
    got = pqt.merge_scan_results(parts, cols)
    want = jhs.merge_scan_results(parts, cols)
    _same(got, want, "merge")
    assert got["fl"].shape == (3, 4)
    empty = pqt.merge_scan_results([parts[0], parts[0]], cols)
    _same(empty, jhs.merge_scan_results([parts[0], parts[0]], cols), "empty")


def test_scan_files_matches_jax():
    """Three files on ``[cpu] * 3``, in file order, against the
    reference's ``scan_files``; a prepared tree and the single-column
    form; file order kept when the middle file gives no row."""
    from parquet_tpu.algebra.expr import prepare as jprepare

    from parquet_tpu_torch.algebra.expr import prepare

    raws = [typed("plain"), typed("nulls"), typed("no_index_no_bloom")]
    pfs = [pqt.ParquetFile(r) for r in raws]
    jpfs = [JParquetFile(r) for r in raws]
    for tree, cols in ((lambda c: c("i32").between(-20, 20), ["v", "sp"]),
                       (lambda c: (c("d") >= 1.0) | c("fd").is_null(),
                        None)):
        got = pqt.scan_files(pfs, where=prepare(tree(col), pfs[0].schema),
                             columns=cols, devices=[CPU] * 3)
        want = jhs.scan_files(jpfs, where=jprepare(tree(jcol),
                                                   jpfs[0].schema),
                              columns=cols)
        _same(got, want, f"scan_files {cols}")
    got = pqt.scan_files(pfs, "sd", values=["r04"], columns=["v"],
                         devices=[CPU] * 3)
    _same(got, jhs.scan_files(jpfs, "sd", values=["r04"], columns=["v"]),
          "scan_files values")
    assert pqt.scan_files([], "v", lo=1, devices=[CPU]) == {}
    got = pqt.scan_files(pfs, "v", lo=10 ** 9, columns=["v", "sp", "fd"],
                         devices=[CPU] * 3)
    _same(got, jhs.scan_files(jpfs, "v", lo=10 ** 9,
                              columns=["v", "sp", "fd"]), "nothing survives")


def test_scan_files_plans_each_file_on_its_device(monkeypatch):
    seen = []
    real = ths.scan_filtered

    def spy(pf, path, device="cuda", **kw):
        seen.append((id(pf), torch.device(device)))
        return real(pf, path, device=device, **kw)

    monkeypatch.setattr(ths, "scan_filtered", spy)
    pfs = [pqt.ParquetFile(typed("plain")) for _ in range(3)]
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    pqt.scan_files(pfs, "v", lo=5990, devices=devs)
    assert sorted(seen, key=lambda s: [id(p) for p in pfs].index(s[0])) == [
        (id(pfs[0]), devs[0]), (id(pfs[1]), devs[1]), (id(pfs[2]), devs[0])]


# ---------------------------------------------------------------------------
# the C++ byte-array gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,count", [(0, 0), (1, 5), (300, 1000),
                                     (200_000, 900_000)])
def test_gather_byte_arrays_matches_numpy_and_jax(n, count):
    rng = np.random.default_rng(n + count)
    lens = rng.integers(0, 40, n)
    lens[::5] = 0
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = rng.integers(0, 256, int(offs[-1])).astype(np.uint8)
    idx = (rng.integers(0, n, count) if n else np.zeros(0, np.int64))
    got = host.gather_byte_arrays(vals, offs, idx)
    want = host.gather_byte_arrays_numpy(vals, offs, idx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    jv, jo = jnative.gather_ba(vals, offs, idx)
    assert np.array_equal(got[0], jv) and np.array_equal(got[1], jo)


def test_gather_byte_arrays_refuses_bad_indexes():
    offs = np.array([0, 2, 2, 5], np.int64)
    vals = np.arange(5, dtype=np.uint8)
    for bad in ([3], [-1], [0, 1, 7]):
        for fn in (host.gather_byte_arrays, host.gather_byte_arrays_numpy):
            with pytest.raises(ValueError, match="out of range"):
                fn(vals, offs, np.array(bad, np.int64))
        with pytest.raises(ValueError, match="out of range"):
            jnative.gather_ba(vals, offs, np.array(bad, np.int64))
    with pytest.raises(ValueError, match="offsets"):
        host.gather_byte_arrays(vals, np.array([0, 4, 9], np.int64), [1])
    with pytest.raises(ValueError, match="offsets"):
        host.gather_byte_arrays(vals, np.array([0, 3, 1], np.int64), [1])
