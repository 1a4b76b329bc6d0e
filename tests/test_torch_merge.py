"""The port's row-group algebra against the JAX package's, on the CPU:
the sorting buffer (``TableBuffer``, ``permute_column``), ``sort_key``
and ``compare_func_of``, schema conversion (``convert_table``), the
in-memory and streaming merges (``merge_row_groups``, ``iter_merged``,
``merge_files``) at list depths 1, 2 and 3, and ``SortingWriter`` with
its spills.  Both packages take the same seeded inputs; their outputs
compare exactly (files through pyarrow, row group by row group)."""

import io
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import parquet_tpu
from parquet_tpu import algebra as JA
from parquet_tpu.algebra import compare as jcompare
from parquet_tpu.algebra.merge import iter_merged as jiter_merged
from parquet_tpu.io.writer import ColumnData as JCD
from parquet_tpu.io.writer import schema_from_arrow
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch import algebra as TA
from parquet_tpu_torch.algebra import compare as tcompare
from parquet_tpu_torch.io.writer import ColumnData as TCD

CPU = "cpu"


def _jwrite(table, **opts) -> bytes:
    buf = io.BytesIO()
    jwrite_table(table, buf, parquet_tpu.WriterOptions(dictionary=False,
                                                       **opts))
    return buf.getvalue()


def _port_schema(raw: bytes):
    return pqt.ParquetFile(raw).schema


def _rows(raw: bytes):
    """A file's rows through pyarrow, and its row groups' sizes."""
    f = papq.ParquetFile(io.BytesIO(raw))
    return (repr(f.read().to_pylist()),
            [f.metadata.row_group(i).num_rows
             for i in range(f.metadata.num_row_groups)])


def _same_file(mine: bytes, theirs: bytes):
    assert _rows(mine) == _rows(theirs)


def _cd_fields(cd, port: bool) -> dict:
    """A ColumnData's arrays, the port's per-level list offsets as the
    JAX package's single level."""
    def arr(a):
        return None if a is None else np.asarray(a)

    lo, lv = cd.list_offsets, cd.list_validity
    if port:
        assert lo is None or len(lo) == 1
        lo = None if lo is None else lo[0]
        lv = None if lv is None else lv[0]
    return {"values": arr(cd.values), "offsets": arr(cd.offsets),
            "validity": arr(cd.validity), "list_offsets": arr(lo),
            "list_validity": arr(lv), "def_levels": arr(cd.def_levels),
            "rep_levels": arr(cd.rep_levels)}


def _same_cd(mine, theirs, raw_levels_validity=False):
    a, b = _cd_fields(mine, True), _cd_fields(theirs, False)
    if raw_levels_validity:  # the raw-level form carries no validity
        b["validity"] = a["validity"]
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k].astype(b[k].dtype), b[k],
                                          err_msg=k)


# ---------------------------------------------------------------------------
# sort keys and the sorting buffer
# ---------------------------------------------------------------------------


def _key_table(kind: str, n: int, rng):
    """A flat column of ``kind`` with nulls, as both packages' ColumnData,
    and its schemas."""
    valid = rng.random(n) > 0.2
    if kind == "int64":
        vals = rng.integers(-2**62, 2**62, n)
        vals[::7] = 2**53 + 1  # past float64's exact integers
        at = pa.int64()
    elif kind == "uint32":
        vals = rng.integers(0, 2**32, n).astype(np.uint32)
        at = pa.uint32()
    elif kind == "double":
        vals = rng.integers(0, 9, n).astype(np.float64)
        vals[rng.random(n) < 0.2] = np.nan
        at = pa.float64()
    elif kind == "string":
        vals = np.array([f"w{int(x):03d}" for x in rng.integers(0, 30, n)],
                        object)
        at = pa.string()
    else:  # decimal in FLBA
        import decimal
        vals = np.array([decimal.Decimal(int(x)) / 100
                         for x in rng.integers(-999, 999, n)], object)
        at = pa.decimal128(9, 2)
    arr = pa.array([v if ok else None for v, ok in zip(vals.tolist(), valid)],
                   type=at)
    raw = _jwrite(pa.table({"k": arr}))
    jcol = parquet_tpu.ParquetFile(raw).read()["k"]
    jschema = parquet_tpu.ParquetFile(raw).schema
    from parquet_tpu.algebra.convert import column_to_data as jc2d

    jcd = jc2d(jcol, jschema.leaf("k"))
    tcol = pqt.ParquetFile(raw).read(device=CPU)["k"]
    tcd = TA.column_to_data(tcol, pqt.ParquetFile(raw).schema.leaf("k"))
    return raw, jschema, jcd, tcd


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
@pytest.mark.parametrize("kind", ["int64", "uint32", "double", "string",
                                  "decimal"])
def test_sort_key_matches_jax(kind, descending, nulls_first):
    rng = np.random.default_rng(7)
    raw, jschema, jcd, tcd = _key_table(kind, 300, rng)
    want = jcompare.sort_key(jschema.leaf("k"), jcd, 300,
                             descending=descending, nulls_first=nulls_first)
    got = tcompare.sort_key(_port_schema(raw).leaf("k"), tcd, 300,
                            descending=descending, nulls_first=nulls_first)
    np.testing.assert_array_equal(got, want)
    # equal values take equal ranks; nulls first or last whatever the way
    if jcd.validity is not None:
        null = ~np.asarray(jcd.validity)
        ranks = np.asarray(got)
        if nulls_first:
            assert (ranks[null] <= ranks[~null].min()).all()
        else:
            assert (ranks[null] >= ranks[~null].max()).all()


def test_compare_func_of_matches_jax():
    grid = [None, -1.5, 0.0, 2.0, math.nan, 7]
    raw, jschema, _, _ = _key_table("double", 10, np.random.default_rng(1))
    leaf, jleaf = _port_schema(raw).leaf("k"), jschema.leaf("k")
    for desc in (False, True):
        for nf in (False, True):
            mine = tcompare.compare_func_of(leaf, desc, nf)
            theirs = jcompare.compare_func_of(jleaf, desc, nf)
            assert [mine(a, b) for a in grid for b in grid] == [
                theirs(a, b) for a in grid for b in grid]


def _buffer_input(rng, n):
    """Two packages' ColumnData of one table: a key with ties, a payload,
    nullable strings and a nullable list."""
    k = rng.integers(0, 40, n)
    s_valid = rng.random(n) > 0.3
    words = [f"s{int(x)}" for x in rng.integers(0, 9, n)]
    lens = rng.integers(0, 4, n)
    lvalid = rng.random(n) > 0.1
    lens[~lvalid] = 0
    lo = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=lo[1:])
    elems = rng.integers(-5, 5, int(lo[-1]))
    present = [w.encode() for w, ok in zip(words, s_valid) if ok]
    offs = np.zeros(len(present) + 1, np.int64)
    np.cumsum([len(x) for x in present], out=offs[1:])
    sbytes = np.frombuffer(b"".join(present), np.uint8)

    def cols(CD, port):
        lst = CD(values=elems)
        lst.list_offsets = [lo] if port else lo
        lst.list_validity = [lvalid] if port else lvalid
        return {"k": CD(values=k), "v": CD(values=np.arange(n) * 1.5),
                "s": CD(values=sbytes, offsets=offs, validity=s_valid),
                "l.list.element": lst}

    table = pa.table({
        "k": pa.array(k), "v": pa.array(np.arange(n) * 1.5),
        "s": pa.array([w if ok else None for w, ok in zip(words, s_valid)]),
        "l": pa.array([elems[lo[i]:lo[i + 1]].tolist() if lvalid[i] else None
                       for i in range(n)], pa.list_(pa.int64()))})
    return table, cols(TCD, True), cols(JCD, False)


@pytest.mark.parametrize("sorting", [
    [("k", False, False)], [("k", True, True), ("s", False, False)],
    [("s", True, False), ("k", False, False)], []])
def test_table_buffer_sorts_as_jax(sorting):
    rng = np.random.default_rng(3)
    table, tcols, jcols = _buffer_input(rng, 500)
    raw = _jwrite(table)
    tbuf = TA.TableBuffer(_port_schema(raw),
                          [TA.SortingColumn(*s) for s in sorting])
    jbuf = JA.TableBuffer(parquet_tpu.ParquetFile(raw).schema,
                          [JA.SortingColumn(*s) for s in sorting])
    from parquet_tpu.io.writer import _slice_cd as jslice
    from parquet_tpu_torch.io.writer import _slice_cd as tslice

    tschema, jschema = tbuf.schema, jbuf.schema
    for r0, r1 in ((0, 250), (250, 500)):  # two writes: the buffer extends
        tbuf.write({k: tslice(tschema.leaf(k), v, r0, r1)
                    for k, v in tcols.items()}, r1 - r0)
        jbuf.write({k: jslice(jschema.leaf(k), v, r0, r1)
                    for k, v in jcols.items()}, r1 - r0)
    assert tbuf.num_rows == jbuf.num_rows == 500
    np.testing.assert_array_equal(tbuf.sort_indices(), jbuf.sort_indices())
    tbuf.sort()
    jbuf.sort()
    for k in tcols:
        _same_cd(tbuf.columns[k], jbuf.columns[k])
    out, jout = io.BytesIO(), io.BytesIO()
    w = pqt.ParquetWriter(out, tschema)
    tbuf.flush_to(w)
    w.close()
    jw = parquet_tpu.ParquetWriter(jout, jschema)
    jbuf.flush_to(jw)
    jw.close()
    _same_file(out.getvalue(), jout.getvalue())
    # the same rows as a pyarrow.Table, as the JAX package's buffer takes
    # them (``write_arrow`` refused until the Arrow slice)
    tbuf = TA.TableBuffer(tschema, [TA.SortingColumn(*s) for s in sorting])
    jbuf = JA.TableBuffer(jschema, [JA.SortingColumn(*s) for s in sorting])
    tbuf.write_arrow(table)
    jbuf.write_arrow(table)
    np.testing.assert_array_equal(tbuf.sort_indices(), jbuf.sort_indices())
    out, jout = io.BytesIO(), io.BytesIO()
    w = pqt.ParquetWriter(out, tschema)
    tbuf.flush_to(w)
    w.close()
    jw = parquet_tpu.ParquetWriter(jout, jschema)
    jbuf.flush_to(jw)
    jw.close()
    _same_file(out.getvalue(), jout.getvalue())


# ---------------------------------------------------------------------------
# schema conversion
# ---------------------------------------------------------------------------


def _nested_rows(rng, n, depth):
    def val(d):
        if d == 0:
            return int(rng.integers(0, 50))
        if rng.random() < 0.1:
            return None
        return [val(d - 1) for _ in range(int(rng.integers(0, 3)))]

    return [val(depth) for _ in range(n)]


CONVERSIONS = {
    "widen_and_missing": (
        lambda rng: pa.table({
            "a": pa.array(rng.integers(0, 100, 300).astype(np.int32)),
            "b": pa.array(rng.random(300, dtype=np.float32))}),
        pa.schema([("a", pa.int64()), ("b", pa.float64()),
                   ("new", pa.int32()), ("gone", pa.list_(pa.int32()))])),
    "unsigned_zero_extend": (
        lambda rng: pa.table({"u": pa.array(
            np.array([1, 3_000_000_000, 5], np.uint32))}),
        pa.schema([("u", pa.uint64())])),
    "multilevel_list_widen": (
        lambda rng: pa.table({"m": pa.array(
            _nested_rows(rng, 200, 2), pa.list_(pa.list_(pa.int32())))}),
        pa.schema([("m", pa.list_(pa.list_(pa.int64())))])),
    "list_and_strings": (
        lambda rng: pa.table({
            "l": pa.array(_nested_rows(rng, 200, 1), pa.list_(pa.int32())),
            "s": pa.array([None if i % 3 else f"x{i}" for i in range(200)])}),
        pa.schema([("l", pa.list_(pa.int64())), ("s", pa.string())])),
}


@pytest.mark.parametrize("case", sorted(CONVERSIONS))
def test_convert_table_matches_jax(case):
    make, target = CONVERSIONS[case]
    raw = _jwrite(make(np.random.default_rng(2)), row_group_size=128)
    jtarget = schema_from_arrow(target)
    ttarget = pqt.ParquetFile(_jwrite(target.empty_table())).schema
    mine = TA.convert_table(pqt.ParquetFile(raw), ttarget, device=CPU)
    theirs = JA.convert_table(parquet_tpu.ParquetFile(raw), jtarget)
    assert [n for _, n in mine] == [n for _, n in theirs]
    for (tcols, _), (jcols, _) in zip(mine, theirs):
        assert list(tcols) == list(jcols)
        for k in tcols:
            _same_cd(tcols[k], jcols[k], raw_levels_validity=True)
    out, jout = io.BytesIO(), io.BytesIO()
    w = pqt.ParquetWriter(out, ttarget, pqt.WriterOptions())
    jw = parquet_tpu.ParquetWriter(jout, jtarget, parquet_tpu.WriterOptions())
    for (tcols, n), (jcols, _) in zip(mine, theirs):
        w.write_row_group(tcols, n)
        jw.write_row_group(jcols, n)
    w.close()
    jw.close()
    _same_file(out.getvalue(), jout.getvalue())
    rg = pqt.ParquetFile(raw).row_group(0)
    assert [n for _, n in TA.convert_table(rg, ttarget, device=CPU)] == [
        rg.num_rows]


def test_conversions_refused_as_jax():
    raw = _jwrite(pa.table({"a": pa.array([[1, 2], [3]],
                                          pa.list_(pa.int64())),
                            "ts": pa.array([1, 2], pa.timestamp("us"))}))
    for target in (pa.schema([("a", pa.int64())]),
                   pa.schema([("a", pa.list_(pa.int64())),
                              ("ts", pa.timestamp("ms"))])):
        with pytest.raises(TypeError):
            JA.convert_table(parquet_tpu.ParquetFile(raw),
                             schema_from_arrow(target))
        with pytest.raises(TypeError):
            TA.convert_table(pqt.ParquetFile(raw), pqt.ParquetFile(_jwrite(
                target.empty_table())).schema, device=CPU)


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def _sorted_run(rng, n, extras=(), descending=False, depth=0):
    k = np.sort(rng.integers(0, 10**6, n))
    if descending:
        k = k[::-1].copy()
    cols = {"k": pa.array(k)}
    if "s" in extras:
        cols["s"] = pa.array([None if rng.random() < 0.2 else
                              f"s{int(v):07d}" for v in k])
    if "l" in extras:
        cols["l"] = pa.array([None if i % 11 == 3 else
                              [int(x) for x in rng.integers(0, 99, i % 4)]
                              for i in range(n)], pa.list_(pa.int64()))
    if depth > 1:
        ty = pa.int64()
        for _ in range(depth):
            ty = pa.list_(ty)
        cols["vv"] = pa.array(_nested_rows(rng, n, depth), ty)
    return _jwrite(pa.table(cols))


def _merged(runs, sorting, schema_of=None, **kw):
    """Both packages' ``merge_files`` of ``runs``; ``schema_of`` (a file)
    gives the target schema."""
    out, jout = io.BytesIO(), io.BytesIO()
    tkw, jkw = dict(kw), dict(kw)
    if schema_of is not None:
        tkw["schema"] = _port_schema(schema_of)
        jkw["schema"] = parquet_tpu.ParquetFile(schema_of).schema
    TA.merge_files(runs, [TA.SortingColumn(*s) for s in sorting], out,
                   device=CPU, **tkw)
    JA.merge_files(runs, [JA.SortingColumn(*s) for s in sorting], jout,
                   **jkw)
    return out.getvalue(), jout.getvalue()


MERGES = {
    "ints": (lambda rng: [_sorted_run(rng, n) for n in (3000, 4000, 1000)],
             [("k",)], {}),
    "strings_lists": (lambda rng: [_sorted_run(rng, n, ("s", "l"))
                                   for n in (900, 500, 1300, 10)],
                      [("k",)], {"batch_rows": 256}),
    "descending_rg": (lambda rng: [_sorted_run(rng, n, descending=True)
                                   for n in (700, 900)],
                      [("k", True)], {"batch_rows": 128,
                                      "row_group_rows": 300}),
    "depth2": (lambda rng: [_sorted_run(rng, 400, depth=2)
                            for _ in range(3)], [("k",)],
               {"batch_rows": 128}),
    "depth3": (lambda rng: [_sorted_run(rng, 300, depth=3)
                            for _ in range(3)], [("k",)],
               {"batch_rows": 100}),
    "unordered": (lambda rng: [_sorted_run(rng, n, ("s",))
                               for n in (300, 200)], [], {"batch_rows": 64}),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_files_matches_jax(case):
    make, sorting, kw = MERGES[case]
    runs = make(np.random.default_rng(4))
    mine, theirs = _merged(runs, sorting, **kw)
    _same_file(mine, theirs)
    meta = parquet_tpu.ParquetFile(mine).row_group(0).sorting_columns
    assert [(m.column_idx, m.descending) for m in meta or []] == [
        (0, bool(s[1:] and s[1])) for s in sorting]


def test_merge_multikey_nan_descending():
    rng = np.random.default_rng(8)
    runs = []
    for n in (900, 1300, 400):
        k = np.sort(rng.integers(0, 40, n))[::-1].copy()
        f = rng.random(n)
        f[rng.random(n) < 0.15] = np.nan
        order = np.lexsort((np.where(np.isnan(f), np.inf, f), np.isnan(f),
                            -k))
        runs.append(_jwrite(pa.table({"k": pa.array(k[order]),
                                      "f": pa.array(f[order])})))
    mine, theirs = _merged(runs, [("k", True), ("f",)], batch_rows=128,
                           row_group_rows=700)
    _same_file(mine, theirs)
    assert len(parquet_tpu.ParquetFile(mine).row_groups) >= 3


def test_iter_merged_chunks_match_jax():
    rng = np.random.default_rng(5)
    runs = [_sorted_run(rng, n, ("s", "l")) for n in (3000, 1700, 4200, 10)]
    mine = list(TA.iter_merged([pqt.ParquetFile(r) for r in runs],
                               [TA.SortingColumn("k")], batch_rows=512,
                               device=CPU))
    theirs = list(jiter_merged([parquet_tpu.ParquetFile(r) for r in runs],
                               [JA.SortingColumn("k")], batch_rows=512))
    assert [n for _, n in mine] == [n for _, n in theirs]
    assert sum(n for _, n in mine) == 8910
    for (tcols, _), (jcols, _) in zip(mine, theirs):
        for k in tcols:
            _same_cd(tcols[k], jcols[k])
        assert (np.diff(tcols["k"].values) >= 0).all()


@pytest.mark.parametrize("missing", ["list", "decimal"])
def test_merge_null_fills_a_missing_column(missing):
    import decimal

    rng = np.random.default_rng(6)
    a_k = np.sort(rng.integers(0, 1000, 300))
    extra = (pa.array([[int(x) for x in rng.integers(0, 9, i % 4)]
                       for i in range(300)], pa.list_(pa.int64()))
             if missing == "list" else
             pa.array([decimal.Decimal(int(v)) / 100 for v in a_k],
                      pa.decimal128(20, 2)))
    a = _jwrite(pa.table({"k": pa.array(a_k), "x": extra}))
    b = _jwrite(pa.table({"k": pa.array(np.sort(rng.integers(0, 1000,
                                                             200)))}))
    for order in ((a, b), (b, a)):
        mine, theirs = _merged(list(order), [("k",)], batch_rows=64,
                               schema_of=a)
        _same_file(mine, theirs)
        assert papq.read_table(io.BytesIO(mine))["x"].null_count == 200


def test_merge_refusals_match_jax():
    rng = np.random.default_rng(9)
    k = np.sort(rng.integers(0, 100, 50))
    lst = _jwrite(pa.table({"k": pa.array(k), "l": pa.array(
        [[1, 2]] * 50, pa.list_(pa.int64()))}))
    flat = _jwrite(pa.table({"k": pa.array(k), "l": pa.array(np.arange(50))}))
    with pytest.raises(TypeError, match="nesting structure"):
        _merged([lst, flat], [("k",)], batch_rows=16, schema_of=lst)
    with pytest.raises(TypeError, match="nesting structure"):
        _merged([flat, lst], [("k",)], batch_rows=16, schema_of=lst)
    unsorted = _jwrite(pa.table({"k": pa.array(rng.integers(0, 10**6,
                                                            2000))}))
    for merge, SC in ((TA.merge_files, TA.SortingColumn),
                      (JA.merge_files, JA.SortingColumn)):
        kw = {"device": CPU} if merge is TA.merge_files else {}
        with pytest.raises(ValueError, match="run 0 is not sorted"):
            merge([unsorted], [SC("k")], io.BytesIO(), batch_rows=256, **kw)
        with pytest.raises(ValueError, match="repeated"):
            merge([lst], [SC("l.list.element")], io.BytesIO(), **kw)


def test_merge_row_groups_matches_jax():
    rng = np.random.default_rng(10)
    runs = [_sorted_run(rng, n, ("s", "l")) for n in (300, 200)]
    tbuf = TA.merge_row_groups([pqt.ParquetFile(r).row_group(0)
                                for r in runs], [TA.SortingColumn("k")],
                               device=CPU)
    jbuf = JA.merge_row_groups([parquet_tpu.ParquetFile(r).row_group(0)
                                for r in runs], [JA.SortingColumn("k")])
    assert tbuf.num_rows == jbuf.num_rows == 500
    for k in tbuf.columns:
        _same_cd(tbuf.columns[k], jbuf.columns[k])
    with pytest.raises(ValueError):
        TA.merge_row_groups([], [TA.SortingColumn("k")], device=CPU)


@settings(max_examples=8, deadline=None)
@given(st.lists(st.lists(st.integers(-5, 5), max_size=30), min_size=1,
                max_size=4), st.integers(2, 16))
def test_merge_of_sorted_runs_is_a_stable_sort(runs, batch_rows):
    """Property: merging sorted runs gives the keys of a stable sort of
    their concatenation, each group of equal keys holding the same rows
    (the payload says which run and row each came from), and equals the
    JAX package's merge row for row."""
    raws, rows = [], []
    for i, run in enumerate(runs):
        k = np.sort(np.asarray(run, np.int64))
        tag = np.array([i * 1000 + j for j in range(len(k))], np.int64)
        raws.append(_jwrite(pa.table({"k": pa.array(k, pa.int64()),
                                      "t": pa.array(tag, pa.int64())})))
        rows += list(zip(k.tolist(), tag.tolist()))
    mine, theirs = _merged(raws, [("k",)], batch_rows=batch_rows)
    _same_file(mine, theirs)
    got = papq.read_table(io.BytesIO(mine))
    pairs = list(zip(got["k"].to_pylist(), got["t"].to_pylist()))
    want = sorted(rows, key=lambda r: r[0])  # stable
    assert [k for k, _ in pairs] == [k for k, _ in want]
    for key in {k for k, _ in want}:
        assert sorted(t for k, t in pairs if k == key) == sorted(
            t for k, t in want if k == key)


# ---------------------------------------------------------------------------
# the sorting writer
# ---------------------------------------------------------------------------


def _batches(rng, count, n, depth=False):
    out = []
    for _ in range(count):
        t = {"k": pa.array(rng.integers(0, 10**9, n)),
             "v": pa.array(rng.random(n))}
        if depth:
            t["vv"] = pa.array(_nested_rows(rng, n, 2),
                               pa.list_(pa.list_(pa.int64())))
        out.append(pa.table(t))
    return out


def _sorting_writes(tables, buffer_rows, tmp_path):
    """Both packages' SortingWriter over the same batches (each batch
    converted to its ColumnData through its own reader); the outputs and
    the port's spill directory."""
    raw0 = _jwrite(tables[0])
    tschema, jschema = _port_schema(raw0), parquet_tpu.ParquetFile(
        raw0).schema
    out, jout = io.BytesIO(), io.BytesIO()
    w = TA.SortingWriter(out, tschema, [TA.SortingColumn("k")],
                         buffer_rows=buffer_rows, device=CPU)
    jw = JA.SortingWriter(jout, jschema, [JA.SortingColumn("k")],
                          buffer_rows=buffer_rows)
    for t in tables:
        raw = _jwrite(t)
        for cols, n in TA.convert_table(pqt.ParquetFile(raw), tschema,
                                        device=CPU):
            w.write(cols, n)
        for cols, n in JA.convert_table(parquet_tpu.ParquetFile(raw),
                                        jschema):
            jw.write(cols, n)
    spills = w.spills
    tmpdir = w._tmpdir
    assert spills and all(os.path.exists(p) for p in spills)
    w.close()
    jw.close()
    assert not os.path.exists(tmpdir)
    return out.getvalue(), jout.getvalue()


@pytest.mark.parametrize("case", ["spill", "hierarchical", "depth2"])
def test_sorting_writer_matches_jax(case, tmp_path):
    rng = np.random.default_rng(12)
    count, n, buffer_rows, depth = {"spill": (7, 700, 1000, False),
                                    "hierarchical": (8, 900, 1500, False),
                                    "depth2": (4, 600, 1000, True)}[case]
    mine, theirs = _sorting_writes(_batches(rng, count, n, depth),
                                   buffer_rows, tmp_path)
    _same_file(mine, theirs)
    k = papq.read_table(io.BytesIO(mine))["k"].to_numpy()
    assert (np.diff(k) >= 0).all() and len(k) == count * n


def test_sorting_writer_leaves_no_spill(tmp_path):
    rng = np.random.default_rng(13)
    tables = _batches(rng, 3, 500)
    raw = _jwrite(tables[0])
    schema = _port_schema(raw)
    cols = TA.convert_table(pqt.ParquetFile(raw), schema, device=CPU)[0][0]

    def writer(sink):
        w = TA.SortingWriter(sink, schema, [TA.SortingColumn("k")],
                             buffer_rows=300, device=CPU)
        w.write(cols, 500)
        assert w.spills
        return w

    w = writer(str(tmp_path / "a.parquet"))  # abort
    w.abort()
    w.abort()
    assert not os.path.exists(w._tmpdir)
    assert not (tmp_path / "a.parquet").exists()
    sink = tmp_path / "b.parquet"
    with pytest.raises(RuntimeError):  # an error in the block
        with writer(str(sink)) as w:
            raise RuntimeError("boom")
    assert not os.path.exists(w._tmpdir) and not sink.exists()
    w = writer(str(tmp_path / "missing_dir" / "c.parquet"))  # a failing close
    with pytest.raises(OSError):
        w.close()
    assert not os.path.exists(w._tmpdir)
    # rows given as a pyarrow.Table spill and go the same way
    w = TA.SortingWriter(str(tmp_path / "d.parquet"), schema,
                         [TA.SortingColumn("k")], buffer_rows=300,
                         device=CPU)
    w.write_arrow(tables[0])
    assert w.spills
    w.abort()
    assert not os.path.exists(w._tmpdir)
    assert not (tmp_path / "d.parquet").exists()


def test_merge_paths_are_cuda_by_default(monkeypatch):
    import torch

    raw = _sorted_run(np.random.default_rng(1), 10)
    schema = _port_schema(raw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: TA.merge_files([raw], [TA.SortingColumn("k")],
                                   io.BytesIO()),
            lambda: next(TA.iter_merged([raw], [TA.SortingColumn("k")])),
            lambda: TA.convert_table(pqt.ParquetFile(raw), schema),
            lambda: TA.merge_row_groups([pqt.ParquetFile(raw).row_group(0)],
                                        [TA.SortingColumn("k")]),
            lambda: TA.SortingWriter(io.BytesIO(), schema, []),
            lambda: pqt.read_objects(raw, object)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
