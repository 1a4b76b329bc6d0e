"""parquet_tpu_torch's scan planner on the CPU against parquet_tpu's:
``plan_scan``'s page plans (row group, page ordinals, first row, row
count), the cascade's decisions, counters and ``explain()`` for predicate
trees, ``prepare`` (compared by the trees they print), the coverage proof
``_bounds_cover``, and ``read_row_range`` in its three forms."""

import decimal
import functools
import io
import itertools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from parquet_tpu.algebra import expr as jexpr
from parquet_tpu.io import planner as jplanner
from parquet_tpu.io.reader import ParquetFile as JParquetFile
from parquet_tpu.io.search import plan_scan as jplan_scan
from parquet_tpu.io.search import read_row_range as jread_row_range

import parquet_tpu_torch as pqt
from parquet_tpu_torch.algebra import expr as texpr
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.io import planner as tplanner
from parquet_tpu_torch.io.search import read_row_range

CPU = "cpu"


@functools.lru_cache(None)
def keyed(page_index: bool = True) -> bytes:
    """Six row groups of 5,000 rows: ``k`` sorted INT32 with a bloom filter
    (the port's writer, PLAIN), ``g`` unsorted INT64, ``s`` dictionary
    strings, ``x`` a nullable double."""
    n = 30_000
    rng = np.random.default_rng(7)
    k = np.sort(rng.integers(0, 20_000, n)).astype(np.int32) * 2
    x = np.ma.masked_array(rng.random(n), mask=rng.random(n) < 0.1)
    s = np.array([f"s{i:03d}" for i in range(300)], object)[
        rng.integers(0, 300, n)]
    buf = io.BytesIO()
    pqt.write_table({"k": k, "g": rng.integers(-50, 50, n), "s": s, "x": x},
                    buf, pqt.WriterOptions(
                        row_group_size=n // 6, data_page_size=2048,
                        column_encoding={"k": Encoding.PLAIN,
                                         "g": Encoding.PLAIN},
                        bloom_filters={"k": 10},
                        write_page_index=page_index))
    return buf.getvalue()


def _plans(data, **kw):
    got = pqt.plan_scan(pqt.ParquetFile(data), "k", device=CPU, **kw)
    want = jplan_scan(JParquetFile(data), "k", **kw)
    return ([(p.rg_index, p.page_ordinals, p.first_row, p.row_count)
             for p in got],
            [(p.rg_index, p.page_ordinals, p.first_row, p.row_count)
             for p in want])


@pytest.mark.parametrize("page_index", [True, False])
@pytest.mark.parametrize("use_bloom", [True, False])
@pytest.mark.parametrize("kw", [
    dict(lo=9000, hi=9400), dict(lo=1234, hi=1234), dict(lo=1235, hi=1235),
    dict(lo=None, hi=300), dict(lo=39_000, hi=None), dict(lo=None, hi=None),
    dict(lo=-5, hi=-1), dict(values=[8, 16_002, 30_000, 5, 7]),
    dict(values=[3, 99_999]), dict(values=[2.0, 2.5, "x", 10**30])],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())[:40])
def test_plan_scan_matches_jax(kw, use_bloom, page_index):
    got, want = _plans(keyed(page_index), use_bloom=use_bloom, **kw)
    assert got == want


def _trees():
    c = texpr.col
    j = jexpr.col
    yield (c("k").between(100, 900) & c("g").isin([3, 4, 5]),
           j("k").between(100, 900) & j("g").isin([3, 4, 5]))
    yield ((c("k") >= 100) & (c("k") <= 90) | c("x").is_null(),
           (j("k") >= 100) & (j("k") <= 90) | j("x").is_null())
    yield (~((c("k") == 4000) | (c("s") == "s017")),
           ~((j("k") == 4000) | (j("s") == "s017")))
    yield (c("k").isin([2, 4, 6, 8]) & c("k").between(3, 100),
           j("k").isin([2, 4, 6, 8]) & j("k").between(3, 100))
    yield ((c("k") <= 500) | (c("k") >= 300) | c("k").isin([9, 10**6]),
           (j("k") <= 500) | (j("k") >= 300) | j("k").isin([9, 10**6]))
    yield ((c("g") <= 5) | (c("g") >= 100) | c("g").isin([50, 2]),
           (j("g") <= 5) | (j("g") >= 100) | j("g").isin([50, 2]))
    yield (c("s").between("s100", "s120") & ~c("x").not_null(),
           j("s").between("s100", "s120") & ~j("x").not_null())
    yield (c("k").isin([]) | (c("g") != 3), j("k").isin([]) | (j("g") != 3))
    yield (~~(c("k") == 2.0) & c("k").isin([2.5, 4.0]),
           ~~(j("k") == 2.0) & j("k").isin([2.5, 4.0]))


@pytest.mark.parametrize("i", range(9))
def test_prepare_and_plan_trees_match_jax(i):
    mine, theirs = list(_trees())[i]
    pf, jpf = pqt.ParquetFile(keyed()), JParquetFile(keyed())
    pm = texpr.prepare(mine, pf.schema)
    pj = jexpr.prepare(theirs, jpf.schema)
    assert repr(pm) == repr(pj)
    got = tplanner.ScanPlanner(pf, device=CPU).plan(mine)
    want = jplanner.ScanPlanner(jpf).plan(theirs)
    assert [(d.rg_index, d.pruned_by, d.killer, d.ranges, d.page_sel)
            for d in got.decisions] == \
        [(d.rg_index, d.pruned_by, d.killer, d.ranges, d.page_sel)
         for d in want.decisions]
    assert got.counters == {k: want.counters[k] for k in got.counters}
    assert got.explain() == want.explain()
    assert got.est_bytes(["x"]) == want.est_bytes(["x"])


def test_prepare_refuses_a_tree_of_another_schema():
    pf = pqt.ParquetFile(keyed())
    prepared = texpr.prepare(texpr.col("k") >= 5, pf.schema)
    other = pqt.ParquetFile(keyed(False))
    assert texpr.prepare(prepared, other.schema) is prepared
    n = 100
    buf = io.BytesIO()
    pqt.write_table({"k": np.arange(n)}, buf)
    with pytest.raises(ValueError, match="different schema"):
        texpr.prepare(prepared, pqt.ParquetFile(buf.getvalue()).schema)
    with pytest.raises(TypeError, match="not a python boolean"):
        bool(texpr.col("k") == 1)


def test_decimal_and_unsigned_probes_normalize_as_jax():
    n = 1000
    t = pa.table({"d": pa.array([decimal.Decimal(f"{i}.25")
                                 for i in range(n)], pa.decimal128(9, 2)),
                  "u": pa.array(np.arange(n, dtype=np.uint64) + 2**63)})
    buf = io.BytesIO()
    papq.write_table(t, buf, store_decimal_as_integer=True,
                     write_page_index=True, data_page_size=512)
    data = buf.getvalue()
    pf, jpf = pqt.ParquetFile(data), JParquetFile(data)
    for mine, theirs in (
            (texpr.col("d").between(decimal.Decimal("10.25"),
                                    decimal.Decimal("99.5")),
             jexpr.col("d").between(decimal.Decimal("10.25"),
                                    decimal.Decimal("99.5"))),
            (texpr.col("u").isin([2**63 + 5, -1, 2**64, 7.5]),
             jexpr.col("u").isin([2**63 + 5, -1, 2**64, 7.5])),
            (texpr.col("u") >= 2**63 + 900, jexpr.col("u") >= 2**63 + 900)):
        assert repr(texpr.prepare(mine, pf.schema)) == \
            repr(jexpr.prepare(theirs, jpf.schema))
        got = tplanner.ScanPlanner(pf, device=CPU).plan(mine)
        want = jplanner.ScanPlanner(jpf).plan(theirs)
        assert got.explain() == want.explain()


_BOUNDS = [None, -3, 0, 5, 7, 2.5, float("nan")]


@pytest.mark.parametrize("kind,negated", [("range", False), ("range", True),
                                          ("in", False), ("in", True),
                                          ("null", False),
                                          ("notnull", False)])
def test_bounds_cover_matches_jax(kind, negated):
    for lo, hi, mn, mx, nulls in itertools.product(
            [None, 0, 5], [None, 5, 9], [None, 0, 1, 5.0], [None, 5, 9],
            [None, 0, 3]):
        values = sorted({v for v in (lo, hi, 1, 2, 3, 4) if v is not None})
        args = dict(lo=lo, hi=hi) if kind == "range" else (
            dict(values=values) if kind == "in" else {})
        p = texpr.Pred("k", kind, negated=negated, prepared=True, **args)
        q = jexpr.Pred("k", kind, negated=negated, prepared=True, **args)
        for page_rows in (None, 3):
            assert tplanner._bounds_cover(p, mn, mx, nulls, 10, page_rows) \
                == jplanner._bounds_cover(q, mn, mx, nulls, 10, page_rows)


@pytest.mark.parametrize("aligned", [False, True, "arrays"])
@pytest.mark.parametrize("column", ["k", "x", "s"])
def test_read_row_range_matches_jax(column, aligned):
    data = keyed()
    for start, count in ((0, 10), (4990, 30), (7777, 9000), (29_990, 10),
                         (29_999, 5)):
        got = read_row_range(pqt.ParquetFile(data), column, start, count,
                             aligned=aligned)
        want = jread_row_range(JParquetFile(data), column, start, count,
                               aligned=aligned)
        if not aligned:
            _same(got, want)
            continue
        (gv, gval), (wv, wval) = got, want
        if gval is None or wval is None:  # None: no null in the span
            assert (gval is None or gval.all()) and \
                (wval is None or wval.all())
        else:
            np.testing.assert_array_equal(gval, wval)
        if aligned == "arrays" and column == "s":
            assert gv[0] == wv[0] == "ba_arrays"
            np.testing.assert_array_equal(gv[1], wv[1])
            np.testing.assert_array_equal(gv[2], np.asarray(wv[2], np.int64))
        else:
            _same(gv, wv)


def _same(got, want):
    if isinstance(want, list):
        assert got == [None if v is None else bytes(v) for v in want]
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
