"""The aggregation cascade of parquet_tpu_torch (``ParquetFile.aggregate``,
``Dataset.aggregate``, ``io/aggregate.py``) against parquet_tpu's, on the
CPU.

The same seeded files, written by each package's writer, go through both
packages: the port on ``device="cpu"`` (its dictionary and exact tiers
decode through the device route's code with the kernels' plain versions,
and its folds run in torch), the JAX package on its host decode.  Every
aggregate is exact but float ``sum``/``sum_sq`` and the ``avg``/
``variance`` derived from them, which add in another order and are held
at ``rtol=1e-9``.  The per-tier counters (``rg_answered_*``) are equal:
tiers are chosen from metadata alone.
"""

import decimal
import io
import math
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.algebra import aggregate as JA
from parquet_tpu.algebra.expr import col as jcol
from parquet_tpu.io import aggregate as jagg
from parquet_tpu.io.faults import FaultInjectingSource as JFaultInjecting
from parquet_tpu.io.source import BytesSource as JBytesSource

import parquet_tpu_torch as pqt
from parquet_tpu_torch.algebra.expr import col as tcol
from parquet_tpu_torch.io import aggregate as tagg
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io.source import BytesSource
from parquet_tpu_torch.ops import kernels
from parquet_tpu_torch.utils import pool as tpool

CPU = "cpu"
N = 12_000
RG = 3_000  # four row groups
PAGE = 2_048  # bytes of values a page: several pages a row group
FLOAT_KINDS = ("sum(", "sum_sq(", "avg(", "variance(")
WORDS = ["ant", "bee", "cat", "dog", "eel", "fox"]


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
    """Both shared pools started before the first thread count."""
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
    parquet_tpu.clear_caches()
    pqt.clear_caches()
    before = threading.active_count()
    yield
    assert threading.active_count() <= before


def _columns(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(N)
    f[rng.random(N) < 0.02] = np.nan
    f[rng.random(N) < 0.02] = 0.0
    f[rng.random(N) < 0.02] = -0.0
    return {
        "k": np.sort(rng.integers(0, 4_000, N)).astype(np.int32),
        "x": rng.integers(-2**40, 2**40, N),
        "x_null": rng.random(N) < 0.1,
        "f": f, "f_null": rng.random(N) < 0.05,
        "fl": rng.standard_normal(N).astype(np.float32),
        "q": rng.integers(1, 51, N).astype(np.int64),
        "s": rng.integers(0, len(WORDS), N),
        "s_null": rng.random(N) < 0.05,
        "b": rng.random(N) < 0.3,
        "u32": rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        "u64": rng.integers(0, 2**64 - 1, N, dtype=np.uint64),
        "dec": rng.integers(-10**9, 10**9, N),
        "i16": rng.integers(-30_000, 30_000, N).astype(np.int16),
    }


def _ref_bytes(seed: int = 0) -> bytes:
    """The JAX package's writer, from a pyarrow table of every type."""
    c = _columns(seed)
    t = pa.table({
        "k": pa.array(c["k"]),
        "x": pa.array(c["x"], mask=c["x_null"]),
        "f": pa.array(c["f"], mask=c["f_null"]),
        "fl": pa.array(c["fl"]),
        "q": pa.array(c["q"]),
        "s": pa.array([None if m else WORDS[i]
                       for i, m in zip(c["s"], c["s_null"])]),
        "b": pa.array(c["b"]),
        "u32": pa.array(c["u32"], pa.uint32()),
        "u64": pa.array(c["u64"], pa.uint64()),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                         for v in c["dec"]], pa.decimal128(12, 2)),
        "i16": pa.array(c["i16"]),
    })
    buf = io.BytesIO()
    parquet_tpu.write_table(t, buf, parquet_tpu.WriterOptions(
        row_group_size=RG, data_page_size=PAGE, compression="snappy"))
    return buf.getvalue()


def _port_bytes(seed: int = 1) -> bytes:
    """The port's writer, from numpy (masked arrays are nullable)."""
    c = _columns(seed)
    s = np.array([WORDS[i].encode() for i in c["s"]], dtype=object)
    table = {"k": c["k"], "x": np.ma.MaskedArray(c["x"], mask=c["x_null"]),
             "f": np.ma.MaskedArray(c["f"], mask=c["f_null"]),
             "fl": c["fl"], "q": c["q"],
             "s": np.ma.MaskedArray(s, mask=c["s_null"]), "b": c["b"],
             "i32": c["i16"].astype(np.int32)}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=RG, data_page_size=PAGE, compression="snappy"))
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg")
    out = {}
    for name, raw in (("ref", _ref_bytes()), ("port", _port_bytes())):
        path = str(d / f"{name}.parquet")
        with open(path, "wb") as fh:
            fh.write(raw)
        out[name] = path
    return out


def _both(spec):
    """The port's and the JAX package's nodes of one aggregate spec."""
    kind, *args = spec
    fn = {"count": "count", "min": "min_", "max": "max_", "sum": "sum_",
          "sum_sq": "sum_sq", "avg": "avg", "variance": "variance",
          "count_distinct": "count_distinct", "top_k": "top_k"}[kind]
    kw = {}
    if kind == "top_k" and len(args) == 3:
        kw["largest"] = args.pop()
    if kind == "variance" and len(args) == 2:
        kw["sample"] = args.pop()
    return getattr(pqt, fn)(*args, **kw), getattr(JA, fn)(*args, **kw)


def _same_value(got, want, name: str) -> None:
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (name, got,
                                                                 want)
        for g, w in zip(got, want):
            _same_value(g, w, name)
        return
    if isinstance(want, float) and name.startswith(FLOAT_KINDS):
        assert isinstance(got, float), (name, got)
        if math.isnan(want):
            assert math.isnan(got), (name, got)
        else:
            assert got == pytest.approx(want, rel=1e-9, abs=1e-12), (
                name, got, want)
        return
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), (name, got)
        return
    assert got == want and type(got) is type(want), (name, got, want)


def _same_result(got, want) -> None:
    assert list(got.keys()) == list(want.keys())
    if want.groups is None:
        assert got.groups is None
    else:
        assert len(got.groups) == len(want.groups)
        for g, w in zip(got.groups, want.groups):
            _same_value(g, w, "group key")
    for name in want.keys():
        _same_value(got[name], want[name], name)
    assert got.counters == want.counters


def _run(path, specs, where=None, group_by=None, **kw):
    taggs, jaggs = zip(*[_both(s) for s in specs])
    twhere, jwhere = where if where is not None else (None, None)
    got = pqt.ParquetFile(path).aggregate(list(taggs), where=twhere,
                                          group_by=group_by, device=CPU,
                                          **kw)
    want = parquet_tpu.ParquetFile(path).aggregate(
        list(jaggs), where=jwhere, group_by=group_by)
    return got, want


COMMON = [("count",), ("count", "x"), ("count", "f"), ("min", "x"),
          ("max", "x"), ("min", "f"), ("max", "f"), ("min", "fl"),
          ("max", "fl"), ("sum", "x"), ("sum", "f"), ("sum", "fl"),
          ("sum", "q"), ("sum_sq", "q"), ("sum_sq", "f"), ("sum_sq", "x"),
          ("avg", "q"), ("avg", "f"), ("variance", "q"),
          ("variance", "f", True), ("count_distinct", "s"),
          ("count_distinct", "q"), ("count_distinct", "f"),
          ("min", "s"), ("max", "s"), ("top_k", "f", 5),
          ("top_k", "x", 4, False), ("top_k", "k", 3), ("min", "b"),
          ("max", "b"), ("sum", "b"), ("count_distinct", "b"),
          ("min", "k"), ("max", "k"), ("sum", "k")]
REF_ONLY = [("min", "u32"), ("max", "u32"), ("sum", "u32"),
            ("min", "u64"), ("max", "u64"), ("sum", "u64"),
            ("sum_sq", "u32"), ("count_distinct", "u64"),
            ("top_k", "u64", 3), ("top_k", "u32", 3, False),
            ("min", "dec"), ("max", "dec"), ("sum", "dec"),
            ("avg", "dec"), ("top_k", "dec", 2), ("min", "i16"),
            ("sum", "i16"), ("sum_sq", "i16")]

WHERES = {
    "none": None,
    "range": (tcol("k").between(900, 2_400), jcol("k").between(900, 2_400)),
    "tree": (((tcol("k") >= 500) & (tcol("q") <= 20))
             | tcol("s").isin(["eel"]),
             ((jcol("k") >= 500) & (jcol("q") <= 20))
             | jcol("s").isin(["eel"])),
    "nulls": (tcol("x").is_null() | (tcol("f") >= 0.5),
              jcol("x").is_null() | (jcol("f") >= 0.5)),
    "negated": (tcol("k") != 1_000, jcol("k") != 1_000),
}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("where", list(WHERES))
def test_every_kind_matches_jax(files, writer, where):
    specs = COMMON + (REF_ONLY if writer == "ref" else [("sum", "i32")])
    got, want = _run(files[writer], specs, WHERES[where])
    _same_result(got, want)


@pytest.mark.parametrize("writer,group_by", [
    ("ref", "s"), ("ref", "b"), ("ref", "u32"), ("ref", "dec"),
    ("ref", "f"), ("port", "s"), ("port", "q"), ("port", "f")])
@pytest.mark.parametrize("where", ["none", "range", "tree"])
def test_group_by_matches_jax(files, writer, group_by, where):
    specs = [("count",), ("count", "x"), ("sum", "x"), ("min", "f"),
             ("max", "f"), ("sum", "f"), ("avg", "q"), ("min", "s"),
             ("variance", "q")]
    got, want = _run(files[writer], specs, WHERES[where], group_by=group_by)
    _same_result(got, want)


@pytest.mark.parametrize("where", list(WHERES))
def test_explain_names_the_same_tiers(files, where):
    got, want = _run(files["ref"], [("count",), ("min", "k"), ("sum", "q"),
                                    ("count_distinct", "s")],
                     WHERES[where])
    assert got.counters == want.counters
    assert got.explain().splitlines()[-1] == want.explain().splitlines()[-1]
    # each row group's line names the same tier
    mine = [ln.split(":")[-1] for ln in got.explain().splitlines()
            if ln.startswith("  rg ")]
    theirs = [ln.split(":")[-1] for ln in want.explain().splitlines()
              if ln.startswith("  rg ")]
    assert mine == theirs


def test_sorted_key_reaches_the_metadata_tiers(files):
    """A range on the sorted key: some row groups pruned by statistics,
    the others answered from page zone maps (count and the key's own
    bounds need no decode), as in the JAX package."""
    where = WHERES["range"]
    got, want = _run(files["ref"], [("count",), ("count", "k"),
                                    ("min", "k"), ("max", "k")], where)
    _same_result(got, want)
    assert got.counters["rg_answered_stats"] > 0
    assert got.counters["rg_answered_pages"] + \
        got.counters["rg_answered_decoded"] > 0


def test_signed_zero_and_nan(tmp_path):
    """min/max of {0.0, -0.0} and NaN: equal to the JAX package's, and
    each the first of its equals in row order, as Python's ``min``/``max``
    over the values; NaN never wins.  No statistics and no dictionary, so
    the values fold on the device."""
    rng = np.random.default_rng(5)
    n = 4_000
    z = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.5]), n)
    z[:3] = [np.nan, -0.0, 0.0]
    path = str(tmp_path / "z.parquet")
    pqt.write_table({"z": z, "k": np.arange(n, dtype=np.int64)}, path,
                    pqt.WriterOptions(row_group_size=1_000,
                                      write_statistics=False,
                                      write_page_index=False,
                                      dictionary=False))
    for lo, hi in ((0, n), (1_000, 2_500)):
        sel = z[lo:hi + 1] if hi < n else z[lo:]
        where = ((tcol("k").between(lo, hi), jcol("k").between(lo, hi))
                 if hi < n else None)
        specs = [("min", "z"), ("max", "z"), ("count_distinct", "z"),
                 ("top_k", "z", 3), ("sum", "z")]
        got, want = _run(path, specs, where)
        _same_result(got, want)
        vals = [v for v in sel.tolist() if v == v]
        zeros = [v for v in vals if v == 0.0]
        if min(vals) == 0.0:
            assert math.copysign(1, got["min(z)"]) == \
                math.copysign(1, zeros[0])
    # an all-zero span: the first zero's sign, as Python's min over it
    allz = np.array([-0.0, 0.0, 0.0, -0.0])
    path2 = str(tmp_path / "z2.parquet")
    pqt.write_table({"z": allz}, path2,
                    pqt.WriterOptions(write_statistics=False,
                                      dictionary=False))
    got = pqt.ParquetFile(path2).aggregate([pqt.min_("z"), pqt.max_("z")],
                                           device=CPU)
    assert math.copysign(1, got["min(z)"]) == math.copysign(1, min(
        allz.tolist()))
    assert math.copysign(1, got["max(z)"]) == math.copysign(1, max(
        allz.tolist()))


def _flips(raw: bytes, rg: int, column: int):
    meta = papq.ParquetFile(io.BytesIO(raw)).metadata
    off = meta.row_group(rg).column(column).data_page_offset
    return [off, off + 1, off + 2]


@pytest.mark.parametrize("group_by", [None, "s"])
def test_corrupt_row_group_drops_whole(group_by):
    """Under ``skip_row_group`` a corrupt row group's contribution drops
    atomically, recorded in the report, as in the JAX package; without
    the policy the error raises, located."""
    raw = _ref_bytes()
    flips = _flips(raw, 2, 1)  # row group 2's ``x`` chunk
    specs = [("count",), ("sum", "x"), ("max", "f"), ("count", "s")]
    taggs, jaggs = zip(*[_both(s) for s in specs])
    src = tfaults.FaultInjectingSource(BytesSource(raw), flip_offsets=flips)
    jsrc = JFaultInjecting(JBytesSource(raw), flip_offsets=flips)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    skip = pqt.FaultPolicy(backoff_s=0, on_corrupt="skip_row_group")
    jskip = parquet_tpu.FaultPolicy(backoff_s=0,
                                    on_corrupt="skip_row_group")
    got = pqt.ParquetFile(src).aggregate(list(taggs), group_by=group_by,
                                         device=CPU, policy=skip,
                                         report=rep)
    want = parquet_tpu.ParquetFile(jsrc).aggregate(
        list(jaggs), group_by=group_by, policy=jskip, report=jrep)
    _same_result(got, want)
    assert got.counters["rg_skipped_corrupt"] == 1
    assert rep.row_groups_skipped == jrep.row_groups_skipped == [2]
    assert rep.rows_dropped == jrep.rows_dropped == RG
    assert "SKIPPED" in got.explain()
    src = tfaults.FaultInjectingSource(BytesSource(raw), flip_offsets=flips)
    with pytest.raises(pqt.CorruptedError, match="row-group=2"):
        pqt.ParquetFile(src).aggregate(list(taggs), group_by=group_by,
                                       device=CPU)


@pytest.fixture(scope="module")
def all_parts(tmp_path_factory):
    """Three part files from each package's writer."""
    d = tmp_path_factory.mktemp("agg_parts")
    out = {}
    for writer, make in (("ref", _ref_bytes), ("port", _port_bytes)):
        out[writer] = []
        for i in range(3):
            path = str(d / f"{writer}{i}.parquet")
            with open(path, "wb") as fh:
                fh.write(make(seed=10 + i))
            out[writer].append(path)
    return out


@pytest.fixture(params=["ref", "port"])
def parts(request, all_parts):
    return all_parts[request.param]


DS_SPECS = [("count",), ("count", "x"), ("sum", "x"), ("min", "f"),
            ("max", "f"), ("sum", "f"), ("avg", "q"),
            ("count_distinct", "s"), ("top_k", "f", 4), ("variance", "q")]


@pytest.mark.parametrize("where", ["none", "range", "tree"])
def test_dataset_aggregate_matches_jax(parts, where):
    taggs, jaggs = zip(*[_both(s) for s in DS_SPECS])
    twhere, jwhere = WHERES[where] if WHERES[where] else (None, None)
    got = pqt.Dataset(parts).aggregate(list(taggs), where=twhere,
                                       device=CPU)
    want = parquet_tpu.Dataset(parts).aggregate(list(jaggs), where=jwhere)
    _same_result(got, want)


def test_dataset_aggregate_is_the_merge_of_its_files(parts):
    specs = [("count",), ("sum", "x"), ("min", "f"), ("max", "q"),
             ("count", "s")]
    taggs = [_both(s)[0] for s in specs]
    got = pqt.Dataset(parts).aggregate(taggs, device=CPU)
    per = [pqt.ParquetFile(p).aggregate(taggs, device=CPU) for p in parts]
    assert got["count(*)"] == sum(r["count(*)"] for r in per)
    assert got["sum(x)"] == sum(r["sum(x)"] for r in per)
    assert got["min(f)"] == min(r["min(f)"] for r in per)
    assert got["max(q)"] == max(r["max(q)"] for r in per)
    assert got["count(s)"] == sum(r["count(s)"] for r in per)
    for k in got.counters:
        if k.startswith("rg_"):
            assert got.counters[k] == sum(r.counters[k] for r in per)


def test_dataset_group_by_and_unreadable_file(parts, tmp_path):
    """Group-by across files, and under a degraded policy a truncated
    file drops as a unit, as in the JAX package."""
    bad = str(tmp_path / "bad.parquet")
    with open(parts[1], "rb") as fh:
        data = fh.read()
    with open(bad, "wb") as fh:
        fh.write(data[:len(data) // 2])
    paths = [parts[0], bad, parts[2]]
    specs = [("count",), ("sum", "x"), ("max", "f")]
    taggs, jaggs = zip(*[_both(s) for s in specs])
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.Dataset(paths).aggregate(
        list(taggs), group_by="s", device=CPU, report=rep,
        policy=pqt.FaultPolicy(backoff_s=0, on_corrupt="skip_row_group"))
    want = parquet_tpu.Dataset(paths).aggregate(
        list(jaggs), group_by="s", report=jrep,
        policy=parquet_tpu.FaultPolicy(backoff_s=0,
                                       on_corrupt="skip_row_group"))
    _same_result(got, want)
    assert got.counters["files_skipped"] == 1
    assert [p for p, *_ in rep.files_skipped] == \
        [p for p, *_ in jrep.files_skipped]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("group_by", [None, "s"])
def test_state_crosses_packages(files, direction, group_by):
    """A partial state encoded by one package decodes in the other, and
    the merged state finalizes to the whole file's answer."""
    specs = [("count",), ("sum", "x"), ("min", "f"), ("max", "s"),
             ("sum", "f")]
    if group_by is None:
        specs += [("count_distinct", "q"), ("top_k", "f", 3)]
    taggs, jaggs = zip(*[_both(s) for s in specs])
    path = files["ref"]
    tstate = tagg.aggregate_file(pqt.ParquetFile(path), list(taggs),
                                 group_by=group_by, device=CPU,
                                 _state_only=True)
    jstate = jagg.aggregate_file(parquet_tpu.ParquetFile(path), list(jaggs),
                                 group_by=group_by, _state_only=True)
    if direction == "port_to_jax":
        doc = tagg.encode_agg_state(tstate)
        schema = parquet_tpu.ParquetFile(path).schema
        leaves, _ = jagg._validate(schema, list(jaggs), group_by)
        accs, groups, counters = jagg.decode_agg_state(doc, list(jaggs),
                                                       leaves)
        got = jagg._finalize(list(jaggs), accs, groups, counters, [], None)
        want = jagg._finalize(*jstate, None)
    else:
        doc = jagg.encode_agg_state(jstate)
        schema = pqt.ParquetFile(path).schema
        leaves, _ = tagg._validate(schema, list(taggs), group_by)
        accs, groups, counters = tagg.decode_agg_state(doc, list(taggs),
                                                       leaves)
        got = tagg._finalize(list(taggs), accs, groups, counters, [], None)
        want = tagg._finalize(*tstate, None)
    _same_result(got, want)


def test_cuda_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pf = pqt.ParquetFile(files["port"])
    for call in (lambda: pf.aggregate([pqt.count()]),
                 lambda: pqt.Dataset([files["port"]]).aggregate(
                     [pqt.count()])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("case", ["empty", "not_agg", "sum_bytes",
                                  "distinct_grouped", "unknown", "derived"])
def test_refusals_match_jax(files, case):
    path = files["ref"]
    tpf, jpf = pqt.ParquetFile(path), parquet_tpu.ParquetFile(path)
    run = {
        "empty": (lambda: tpf.aggregate([], device=CPU),
                  lambda: jpf.aggregate([])),
        "not_agg": (lambda: tpf.aggregate(["x"], device=CPU),
                    lambda: jpf.aggregate(["x"])),
        "sum_bytes": (lambda: tpf.aggregate([pqt.sum_("s")], device=CPU),
                      lambda: jpf.aggregate([JA.sum_("s")])),
        "distinct_grouped": (
            lambda: tpf.aggregate([pqt.count_distinct("x")], group_by="s",
                                  device=CPU),
            lambda: jpf.aggregate([JA.count_distinct("x")], group_by="s")),
        "unknown": (lambda: tpf.aggregate([pqt.max_("nope")], device=CPU),
                    lambda: jpf.aggregate([JA.max_("nope")])),
        "derived": (lambda: tagg._validate(tpf.schema, [pqt.avg("q")],
                                           None),
                    lambda: jagg._validate(jpf.schema, [JA.avg("q")], None)),
    }[case]
    with pytest.raises(Exception) as mine:
        run[0]()
    with pytest.raises(Exception) as theirs:
        run[1]()
    assert type(mine.value) is not Exception
    assert type(mine.value).__name__ == type(theirs.value).__name__


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the two unpack kernels' wrappers (on the CPU they run the
    plain versions)."""
    calls = {"unpack_bits_dense": 0, "dict_unpack_gather": 0}
    for name in calls:
        real = getattr(kernels, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, name, wrapped)
    return calls


def _dict_file(tmp_path) -> str:
    """A numeric column dictionary-encoded with every index run
    bit-packed (50 random values), the device route's dense kernels'
    shape."""
    rng = np.random.default_rng(3)
    n = 8_000
    path = str(tmp_path / "d.parquet")
    pqt.write_table({"q": rng.integers(1, 51, n).astype(np.int64),
                     "k": np.arange(n, dtype=np.int64)}, path,
                    pqt.WriterOptions(row_group_size=4_000,
                                      data_page_size=8_192))
    return path


def test_dictionary_tier_unpacks_without_a_gather(tmp_path, kernel_calls):
    path = _dict_file(tmp_path)
    tagg.reset_agg()
    got, want = _run(path, [("sum", "q"), ("count_distinct", "q"),
                            ("sum_sq", "q"), ("min", "q")])
    _same_result(got, want)
    assert got.counters["rg_answered_dict"] == 2
    assert kernel_calls["unpack_bits_dense"] > 0
    assert kernel_calls["dict_unpack_gather"] == 0
    assert pqt.AGG["dict_chunks"] == 2 and pqt.AGG["dict_folds"] > 0
    assert pqt.AGG["spans_decoded"] == 0 and pqt.AGG["copies_back"] == 0


def test_exact_tier_gathers_on_the_device(tmp_path, kernel_calls):
    path = _dict_file(tmp_path)
    tagg.reset_agg()
    where = (tcol("k").between(1_000, 6_500), jcol("k").between(1_000, 6_500))
    got, want = _run(path, [("sum", "q"), ("max", "q"), ("count", "q")],
                     where, )
    _same_result(got, want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PARQUET_TPU_TORCH_AGG_DICT", "0")
        mp.setenv("PARQUET_TPU_AGG_DICT", "0")
        kernel_calls["dict_unpack_gather"] = 0
        got, want = _run(path, [("sum", "q"), ("max", "q")])
        _same_result(got, want)
        assert got.counters["rg_answered_decoded"] == 2
    assert kernel_calls["dict_unpack_gather"] > 0
    assert pqt.AGG["device_folds"] > 0 and pqt.AGG["spans_decoded"] > 0


def test_host_folds_are_counted(files):
    """The folds the device does not run are the listed ones, counted:
    integer sums of squares, byte-array values, and group-by."""
    path = files["ref"]
    for specs, group_by, key in (
            ([("sum_sq", "x")], None, "host_folds_sum_sq"),
            ([("max", "s")], None, "host_folds_values"),
            ([("max", "dec")], None, "host_folds_values"),
            ([("sum", "x")], "s", "host_folds_group_by")):
        tagg.reset_agg()
        where = (tcol("q") <= 30, jcol("q") <= 30)
        got, want = _run(path, specs, where, group_by=group_by)
        _same_result(got, want)
        assert pqt.AGG[key] > 0, key
    tagg.reset_agg()
    got, want = _run(path, [("sum", "x"), ("max", "f"), ("top_k", "u64", 2)],
                     (tcol("q") <= 30, jcol("q") <= 30))
    _same_result(got, want)
    assert pqt.AGG["device_folds"] > 0
    assert pqt.AGG["host_folds_values"] == pqt.AGG["host_folds_sum_sq"] == \
        pqt.AGG["host_folds_group_by"] == 0
    assert pqt.AGG["mask_copies"] > 0


def test_mixed_dictionary_chunk_keeps_its_decode():
    """A dictionary that falls back to PLAIN mid-chunk (the host-route
    fixture): the dictionary tier refuses it, the exact tier trims the
    decode it kept, and the answers equal the JAX package's."""
    import os

    from parquet_tpu_torch.parallel import device_reader as tdr

    path = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                        "host_route.parquet")
    names = [leaf.name for leaf in pqt.ParquetFile(path).schema.leaves
             if leaf.max_repetition_level == 0]
    specs = []
    for name in names:
        specs += [("count", name), ("count_distinct", name),
                  ("min", name), ("max", name)]
    tdr.reset_host_route()
    got, want = _run(path, specs)
    _same_result(got, want)
    assert sum(tdr.HOST_ROUTE.values()) > 0


def test_empty_and_all_null(tmp_path):
    path = str(tmp_path / "n.parquet")
    v = np.ma.MaskedArray(np.zeros(100), mask=np.ones(100, bool))
    pqt.write_table({"v": v, "k": np.arange(100, dtype=np.int64)}, path)
    specs = [("count",), ("count", "v"), ("min", "v"), ("sum", "v"),
             ("avg", "v"), ("variance", "v"), ("top_k", "v", 2),
             ("count_distinct", "v")]
    for where in (None, (tcol("k") >= 1_000, jcol("k") >= 1_000),
                  (tcol("k") >= 50, jcol("k") >= 50)):
        got, want = _run(path, specs, where)
        _same_result(got, want)
