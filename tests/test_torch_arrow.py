"""The port's Arrow interop against the JAX package's and pyarrow, on the
CPU (the card's machine has no pyarrow).

A read's ``to_arrow`` (``ColumnSet``, the port's ``Table``) is held to the
JAX package's ``read().to_arrow()`` with ``pa.Table.equals`` and to
``pyarrow.parquet.read_table`` value for value, over the codec x page
version x nullability x nesting matrix of ``tests/test_interop_matrix.py``,
every logical type, structs, maps, lists of structs (the level tiers) and a
field the embedded ``ARROW:schema`` declares dictionary-typed.
``schema_from_arrow`` builds the JAX package's tree and raises its errors,
``write_table`` of a ``pyarrow.Table`` writes what both readers read back
equal to the input, and the buffers' ``write_arrow`` and
``ShardedTable.to_arrow`` give the JAX package's results.  The port gives
one chunk a column where the JAX package gives one a row group (a pinned
divergence).  A subprocess with ``import pyarrow`` blocked reads and
writes.  Files are small, made from a seed; every test leaves no thread
running (``tests/torch_fixtures/threads.py``)."""

import datetime
import decimal
import io
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.algebra.buffer import TableBuffer as JTableBuffer
from parquet_tpu.algebra.sorting import SortingWriter as JSortingWriter
from parquet_tpu.algebra.buffer import SortingColumn as JSort
from parquet_tpu.io import search as jsearch
from parquet_tpu.io.writer import schema_from_arrow as jschema_from_arrow
from parquet_tpu.parallel import mesh as jmesh

import parquet_tpu_torch as pqt
from parquet_tpu_torch.algebra.buffer import SortingColumn
from parquet_tpu_torch.io import search as tsearch
from parquet_tpu_torch.io.column import arrow_type_of
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


def _raw(table, **kw) -> bytes:
    buf = io.BytesIO()
    papq.write_table(table, buf, **kw)
    return buf.getvalue()


def _same_as_jax(raw: bytes, **read) -> pa.Table:
    """The port's ``to_arrow`` of ``raw`` equal to the JAX package's
    (``pa.Table.equals``: values, types, nulls)."""
    got = pqt.ParquetFile(raw).read(device=CPU, **read).to_arrow()
    want = parquet_tpu.ParquetFile(raw).read(**read).to_arrow()
    assert got.schema == want.schema
    assert got.equals(want)
    return got


def _same_as_jax_and_pyarrow(raw: bytes, **read) -> pa.Table:
    """:func:`_same_as_jax`, and every column's values pyarrow's (but a
    TIME(NANOS) column's: the JAX package gives its int64s)."""
    got = _same_as_jax(raw, **read)
    pya = papq.read_table(io.BytesIO(raw), columns=read.get("columns"))
    assert sorted(got.column_names) == sorted(pya.column_names)
    for c in pya.column_names:
        if pa.types.is_time64(pya[c].type) and pya[c].type.unit == "ns":
            assert got[c].type == pa.int64()
            assert got[c].to_pylist() == pya[c].cast(pa.int64()).to_pylist()
            continue
        assert got[c].to_pylist() == pya[c].to_pylist(), c
    return got


# ---------------------------------------------------------------------------
# the interop matrix
# ---------------------------------------------------------------------------


def _matrix_data(rng, nested: bool, nullable: bool, n: int = 3000):
    """``tests/test_interop_matrix.py``'s table."""
    ints = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    floats = rng.random(n)
    strs = np.array([f"v{i % 37:02d}" for i in range(n)])
    if nullable:
        m = rng.random(n) < 0.1
        ints_a = pa.array([None if b else int(v) for b, v in zip(m, ints)],
                          pa.int64())
        floats_a = pa.array([None if b else float(v)
                             for b, v in zip(m, floats)], pa.float64())
        strs_a = pa.array([None if b else s for b, s in zip(m, strs)])
    else:
        ints_a, floats_a, strs_a = (pa.array(ints), pa.array(floats),
                                    pa.array(strs))
    cols = {"i": ints_a, "f": floats_a, "s": strs_a}
    if nested:
        lens = rng.integers(0, 5, n)
        offs = np.zeros(n + 1, np.int32)
        np.cumsum(lens, out=offs[1:])
        vals = rng.integers(0, 1 << 30, int(lens.sum())).astype(np.int64)
        mask = rng.random(n) < 0.05 if nullable else np.zeros(n, bool)
        cols["xs"] = pa.ListArray.from_arrays(pa.array(offs),
                                              pa.array(vals),
                                              mask=pa.array(mask))
    return pa.table(cols)


@pytest.mark.parametrize("codec", ["none", "snappy", "zstd", "gzip", "lz4",
                                   "brotli"])
@pytest.mark.parametrize("dpv", [1, 2])
@pytest.mark.parametrize("nested,nullable", [(False, False), (False, True),
                                             (True, True)])
def test_to_arrow_matrix(codec, dpv, nested, nullable):
    rng = np.random.default_rng(0)
    t = _matrix_data(rng, nested, nullable)
    raw = _raw(t, compression=codec if codec != "none" else "NONE",
               use_dictionary=True, data_page_version=f"{dpv}.0",
               data_page_size=1 << 13, row_group_size=1000)
    got = _same_as_jax_and_pyarrow(raw)
    for c in t.column_names:
        assert got[c].to_pylist() == t[c].to_pylist()


# ---------------------------------------------------------------------------
# every logical type, and nesting at every tier
# ---------------------------------------------------------------------------


def _nulls(values, every=5):
    return [None if i % every == 3 else v for i, v in enumerate(values)]


N = 240


def _logical_table() -> pa.Table:
    i = np.arange(N)
    utc = datetime.timezone.utc
    return pa.table({
        "i8": pa.array(_nulls((i % 250 - 125).tolist()), pa.int8()),
        "i16": pa.array(_nulls((i * 250 - 30000).tolist()), pa.int16()),
        "i32": pa.array(_nulls((i * 7).tolist()), pa.int32()),
        "i64": pa.array(_nulls((i * (1 << 35)).tolist()), pa.int64()),
        "u8": pa.array(_nulls((i % 256).tolist()), pa.uint8()),
        "u16": pa.array(_nulls((i * 250).tolist()), pa.uint16()),
        "u32": pa.array(_nulls((i * 17_000_000).tolist()), pa.uint32()),
        "u64": pa.array(_nulls([(1 << 63) + int(v) for v in i]),
                        pa.uint64()),
        "f16": pa.array(_nulls(np.float16(i / 8).tolist()), pa.float16()),
        "f32": pa.array(_nulls((i / 3).tolist()), pa.float32()),
        "f64": pa.array(_nulls((i / 7).tolist()), pa.float64()),
        "b": pa.array(_nulls((i % 3 == 0).tolist()), pa.bool_()),
        "s": pa.array(_nulls([f"s{v % 11}" for v in i]), pa.string()),
        "bin": pa.array(_nulls([bytes([v % 256]) * (v % 4) for v in i]),
                        pa.binary()),
        "fsb": pa.array(_nulls([bytes([v % 256]) * 3 for v in i]),
                        pa.binary(3)),
        "date": pa.array(_nulls((i * 3).tolist()), pa.date32()),
        "ts_ms": pa.array(_nulls((i * 1000).tolist()), pa.timestamp("ms")),
        "ts_us_utc": pa.array(_nulls((i * 10**6).tolist()),
                              pa.timestamp("us", tz="UTC")),
        "ts_ns": pa.array(_nulls((i * 10**9 + 7).tolist()),
                          pa.timestamp("ns")),
        "ts_ns_utc": pa.array(_nulls((i * 10**9 + 3).tolist()),
                              pa.timestamp("ns", tz=utc)),
        "t32": pa.array(_nulls((i * 1000).tolist()), pa.time32("ms")),
        "t64": pa.array(_nulls((i * 10**6).tolist()), pa.time64("us")),
        "dec9": pa.array(_nulls([decimal.Decimal(int(v) - 100).scaleb(-2)
                                 for v in i]), pa.decimal128(9, 2)),
        "dec18": pa.array(_nulls([decimal.Decimal(int(v) * 10**12)
                                  .scaleb(-4) for v in i]),
                          pa.decimal128(18, 4)),
        "dec38": pa.array(_nulls([decimal.Decimal(int(v) * 10**15 - 7)
                                  .scaleb(-3) for v in i]),
                          pa.decimal128(38, 3)),
        "null": pa.nulls(N),
    })


@pytest.mark.parametrize("dpv", [1, 2])
def test_every_logical_type(dpv):
    t = _logical_table()
    raw = _raw(t, data_page_version=f"{dpv}.0", row_group_size=100,
               store_schema=False)
    got = _same_as_jax_and_pyarrow(raw)
    # and by column name, as a selection
    _same_as_jax_and_pyarrow(raw, columns=["dec38", "s", "ts_ns"])
    assert got.num_rows == N


def test_int96_and_nanosecond_to_pylist():
    """INT96 and nanosecond times are exact through Arrow, and
    ``to_pylist`` of them is ``to_arrow().to_pylist()``: the JAX
    package's objects."""
    ts = pa.array(_nulls((np.arange(N) * 10**9 + 11).tolist()),
                  pa.timestamp("ns"))
    t = pa.table({"legacy": ts, "ns": ts,
                  "tns": pa.array(_nulls((np.arange(N) * 1001).tolist()),
                                  pa.time64("ns"))})
    raw = _raw(t, use_deprecated_int96_timestamps=False, store_schema=False)
    raw96 = _raw(pa.table({"legacy": ts}),
                 use_deprecated_int96_timestamps=True, store_schema=False)
    for r in (raw, raw96):
        _same_as_jax_and_pyarrow(r)
        got = pqt.ParquetFile(r).read(device=CPU)
        want = parquet_tpu.ParquetFile(r).read()
        for name in got:
            assert got[name].to_pylist() == \
                want[name].to_arrow().to_pylist()
    leaf = pqt.ParquetFile(raw96).schema.leaves[0]
    assert leaf.physical_type == pqt.format.enums.Type.INT96


def _nested_table() -> pa.Table:
    elem = pa.struct([("a", pa.int32()), ("b", pa.string())])
    inner = pa.struct([("x", pa.float64()), ("ys", pa.list_(pa.int64()))])
    rows = range(N)
    return pa.table({
        "st": pa.array([None if r % 7 == 1 else
                        {"a": None if r % 5 == 2 else r, "b": f"b{r % 3}"}
                        for r in rows], elem),
        "deep": pa.array([None if r % 6 == 0 else
                          {"in": None if r % 4 == 1 else
                           {"x": r / 2, "ys": None if r % 9 == 0
                            else list(range(r % 3))}}
                          for r in rows], pa.struct([("in", inner)])),
        "ls": pa.array([None if r % 8 == 0 else
                        [None if (r + k) % 5 == 0 else
                         {"a": k, "b": None if k % 2 else f"e{k}"}
                         for k in range(r % 4)] for r in rows],
                       pa.list_(elem)),
        "mp": pa.array([None if r % 9 == 4 else
                        [(f"k{k}", None if (r + k) % 4 == 0 else r * k)
                         for k in range(r % 3)] for r in rows],
                       pa.map_(pa.string(), pa.int64())),
        "mps": pa.array([[(k, {"a": r, "b": None})
                          for k in range(r % 2)] for r in rows],
                        pa.map_(pa.int32(), elem)),
        "ll": pa.array([None if r % 10 == 3 else
                        [None if k == 1 else list(range(k + r % 2))
                         for k in range(r % 3)] for r in rows],
                       pa.list_(pa.list_(pa.int64()))),
        "lls": pa.array([[{"a": r, "b": "z"}] * (r % 3) if r % 2
                         else [] for r in rows], pa.list_(elem)),
        "id": pa.array(list(rows), pa.int64()),
    })


@pytest.mark.parametrize("row_group_size", [N, 64])
def test_nested_tiers(row_group_size):
    """Structs above lists (zipped), structs and maps inside lists
    (assembled from the level streams the conversion decodes again) and
    list chains, on one row group and on several."""
    t = _nested_table()
    raw = _raw(t, row_group_size=row_group_size, data_page_size=512)
    got = _same_as_jax_and_pyarrow(raw)
    for c in t.column_names:
        assert got[c].to_pylist() == t[c].to_pylist(), c


def test_vectorized_tier_equals_the_row_tier():
    """The level-stream tier of every struct and map inside a list equals
    the row tier's (``rows.py`` record by record) on the same columns."""
    from parquet_tpu_torch.io import arrow as tarrow

    t = _nested_table()
    raw = _raw(t, row_group_size=64, data_page_size=256)
    cs = pqt.ParquetFile(raw).read(device=CPU)
    fields = [c for c in cs.schema.root.children
              if tarrow._needs_row_assembly(c)]
    assert {c.name for c in fields} == {"ls", "mp", "mps", "lls"}
    need = [leaf for leaf in cs.schema.leaves
            if leaf.path[0] in {c.name for c in fields}]
    asm = tarrow._Assembly(cs.schema, tarrow._with_levels(cs, need),
                           cs.num_rows)
    for node in fields:
        assert asm.nested(node).equals(asm.via_rows(node)), node.name


def test_batches_and_datasets_convert(tmp_path):
    """Every result the JAX package returns as a ``Table`` has its surface
    in the port: the batches of ``iter_batches`` (cut inside row groups,
    their level streams decoded again for just their rows), ``Dataset.read``
    and the closed file of ``read_table``."""
    t = _nested_table()
    raw = _raw(t, row_group_size=64, data_page_size=256)
    pf = pqt.ParquetFile(raw)
    whole = pf.read(device=CPU)
    assert whole.schema is pf.schema and whole.num_rows == N
    assert whole.columns is whole and pqt.Table is pqt.ColumnSet
    batches = list(pf.iter_batches(batch_rows=50, strict_batch_rows=True,
                                   device=CPU))
    jbatches = list(parquet_tpu.ParquetFile(raw).iter_batches(
        batch_rows=50, strict_batch_rows=True))
    assert [b.num_rows for b in batches] == [b.num_rows for b in jbatches]
    for b, jb in zip(batches, jbatches):
        assert b.schema is pf.schema
        assert b.to_arrow().equals(jb.to_arrow())
    assert pa.concat_tables([b.to_arrow() for b in batches]).equals(
        whole.to_arrow())
    paths = []
    for k in range(3):
        p = str(tmp_path / f"part{k}.parquet")
        papq.write_table(t.slice(k * 80, 80), p, row_group_size=40)
        paths.append(p)
    got = pqt.Dataset(paths).read(device=CPU)
    want = parquet_tpu.Dataset(paths).read()
    assert got.num_rows == want.num_rows == N
    assert got.to_arrow().equals(want.to_arrow())
    closed = pqt.read_table(paths[1], device=CPU)  # closes its file
    assert closed.to_arrow().equals(
        parquet_tpu.ParquetFile(paths[1]).read().to_arrow())


def test_read_row_range_converts():
    """A nested ``read_row_range`` gives a column whose ``to_arrow`` holds
    exactly the rows asked for, as the JAX package's."""
    t = _nested_table()
    raw = _raw(t, row_group_size=64, data_page_size=256,
               write_page_index=True)
    pf, jpf = pqt.ParquetFile(raw), parquet_tpu.ParquetFile(raw)
    for path in ("ll.list.element.list.element", "mp.key_value.value"):
        for start, count in ((0, 10), (37, 90), (200, 40)):
            got = tsearch.read_row_range(pf, path, start, count)
            want = jsearch.read_row_range(jpf, path, start, count)
            assert got.to_arrow().equals(want.to_arrow())


def test_partial_selection_gives_flat_leaves():
    t = _nested_table()
    raw = _raw(t)
    got = _same_as_jax(raw, columns=["st.a", "ls.list.element.b", "id"])
    assert got.column_names == ["st.a", "ls", "id"]


def test_arrow_type_of_matches_jax():
    raw = _raw(_nested_table())
    schema = pqt.ParquetFile(raw).schema
    jschema = parquet_tpu.ParquetFile(raw).schema
    from parquet_tpu.io.column import arrow_type_of as jarrow_type_of

    for node, jnode in zip(schema.root.children, jschema.root.children):
        assert arrow_type_of(node) == jarrow_type_of(jnode)


# ---------------------------------------------------------------------------
# dictionary fields and the one-chunk divergence
# ---------------------------------------------------------------------------


def _dict_table(n=400) -> pa.Table:
    return pa.table({
        "cat": pa.array([f"c{i % 5}" for i in range(n)]).dictionary_encode(),
        "num": pa.array(np.arange(n) % 7).dictionary_encode(),
        "x": pa.array(np.arange(n))})


def test_dictionary_field_stays_a_dictionary():
    """A field the embedded ``ARROW:schema`` declares dictionary-typed
    reads as a ``DictionaryArray``, as both the JAX package and pyarrow
    read it: in one row group equal to the JAX package's."""
    raw = _raw(_dict_table())
    got = _same_as_jax_and_pyarrow(raw)
    pya = papq.read_table(io.BytesIO(raw))
    for c in ("cat", "num"):
        assert pa.types.is_dictionary(got[c].type)
    assert got["cat"].type == pya["cat"].type  # pyarrow reads num dense


def test_one_chunk_a_column_where_jax_has_one_a_row_group():
    """The pinned divergence: the port's read concatenates each leaf's row
    groups on the device, so its ``to_arrow`` has one chunk a column where
    the JAX package's has one a row group.  Plain columns are equal
    (``pa.Table.equals`` ignores chunking); a dictionary field holds the
    row groups' dictionaries in one ``DictionaryArray`` where the JAX
    package keeps one a chunk, so the two agree in type and values."""
    raw = _raw(_dict_table(), row_group_size=100)
    got = pqt.ParquetFile(raw).read(device=CPU).to_arrow()
    want = parquet_tpu.ParquetFile(raw).read().to_arrow()
    assert [got[c].num_chunks for c in got.column_names] == [1, 1, 1]
    assert [want[c].num_chunks for c in want.column_names] == [4, 4, 4]
    assert got.schema == want.schema
    assert got.select(["x"]).equals(want.select(["x"]))
    for c in got.column_names:
        assert got[c].to_pylist() == want[c].to_pylist()


# ---------------------------------------------------------------------------
# Arrow in: schema_from_arrow and write_table of a pyarrow.Table
# ---------------------------------------------------------------------------

MAPPED = [pa.null(), pa.bool_(), pa.int8(), pa.int16(), pa.int32(),
          pa.int64(), pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64(),
          pa.float16(), pa.float32(), pa.float64(), pa.string(),
          pa.large_string(), pa.binary(), pa.large_binary(), pa.binary(7),
          pa.date32(), pa.timestamp("ms"), pa.timestamp("us", tz="UTC"),
          pa.timestamp("ns"), pa.timestamp("s"), pa.time32("ms"),
          pa.time64("us"), pa.time64("ns"), pa.decimal128(5, 1),
          pa.decimal128(15, 3), pa.decimal128(30, 4),
          pa.decimal256(50, 2),
          pa.list_(pa.int32()), pa.large_list(pa.string()),
          pa.list_(pa.field("item", pa.int64(), nullable=False)),
          pa.struct([("a", pa.int32()),
                     pa.field("b", pa.string(), nullable=False)]),
          pa.map_(pa.string(), pa.float64()),
          pa.list_(pa.struct([("s", pa.list_(pa.int8()))]))]


@pytest.mark.parametrize("nullable", [True, False])
@pytest.mark.parametrize("t", MAPPED, ids=str)
def test_schema_from_arrow_matches_jax(t, nullable):
    if pa.types.is_null(t) and not nullable:
        t = pa.list_(t)  # a null-typed field is nullable by definition
    aschema = pa.schema([pa.field("f", t, nullable=nullable),
                         pa.field("k", pa.int64())])
    got = pqt.schema_from_arrow(aschema)
    want = jschema_from_arrow(aschema)
    assert repr(got) == repr(want)
    for a, b in zip(got.leaves, want.leaves):
        assert (a.name, int(a.physical_type), a.type_length,
                a.max_definition_level, a.max_repetition_level,
                str(a.logical_kind), a.logical_params) == \
            (b.dotted_path, int(b.physical_type), b.type_length,
             b.max_definition_level, b.max_repetition_level,
             str(b.logical_kind), b.logical_params)


@pytest.mark.parametrize("t", [pa.date64(), pa.duration("s"),
                               pa.month_day_nano_interval(),
                               pa.dictionary(pa.int32(), pa.string())],
                         ids=str)
def test_schema_from_arrow_refuses_as_jax(t):
    aschema = pa.schema([pa.field("f", t)])
    with pytest.raises(TypeError) as got:
        pqt.schema_from_arrow(aschema)
    with pytest.raises(TypeError) as want:
        jschema_from_arrow(aschema)
    assert str(got.value) == str(want.value)


def _write_input() -> pa.Table:
    """Nested and logical columns the Arrow writers take (no null struct
    under a list)."""
    elem = pa.struct([("a", pa.int32()), ("b", pa.string())])
    t = _nested_table().select(["st", "mp", "ll", "lls", "id"])
    ls = pa.array([None if r % 8 == 0 else
                   [{"a": k, "b": None if k % 2 else f"e{k}"}
                    for k in range(r % 4)] for r in range(N)],
                  pa.list_(elem))
    lt = _logical_table().drop_columns(["null", "ts_ns_utc", "t32", "t64"])
    return pa.table({**{c: t[c] for c in t.column_names}, "ls": ls,
                     **{c: lt[c] for c in lt.column_names}})


@pytest.mark.parametrize("row_group_size", [1 << 20, 50])
def test_write_table_of_arrow(row_group_size, tmp_path):
    """The port's writer given a ``pyarrow.Table``: pyarrow and the JAX
    package read the file back equal to the input, and the port's read
    equals theirs."""
    t = _write_input()
    path = str(tmp_path / "w.parquet")
    w = pqt.write_table(t, path, pqt.WriterOptions(
        row_group_size=row_group_size, data_page_size=1024))
    assert w.write_stats is not None
    back = papq.read_table(path)
    jback = parquet_tpu.ParquetFile(path).read().to_arrow()
    for c in t.column_names:
        assert back[c].to_pylist() == t[c].to_pylist(), c
        assert jback[c].to_pylist() == t[c].to_pylist(), c
    _same_as_jax_and_pyarrow(open(path, "rb").read())
    if row_group_size == 50:
        assert pqt.ParquetFile(path).metadata.num_rows == N
        assert len(pqt.ParquetFile(path).row_groups) == -(-N // 50)


def test_write_table_of_arrow_equals_jax_writer(tmp_path):
    """The same Arrow table through each package's writer reads back the
    same in both packages."""
    t = _write_input()
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pqt.write_table(t, a, pqt.WriterOptions(row_group_size=100))
    parquet_tpu.write_table(t, b, parquet_tpu.WriterOptions(
        row_group_size=100))
    ta = parquet_tpu.ParquetFile(a).read().to_arrow()
    tb = parquet_tpu.ParquetFile(b).read().to_arrow()
    assert ta.equals(tb)
    assert pqt.ParquetFile(b).read(device=CPU).to_arrow().equals(tb)


def test_write_table_of_a_null_struct_in_a_list_refuses_as_jax(tmp_path):
    t = pa.table({"ls": pa.array([[None, {"a": 1}]],
                                 pa.list_(pa.struct([("a", pa.int32())])))})
    with pytest.raises(NotImplementedError, match="null struct"):
        pqt.write_table(t, str(tmp_path / "x.parquet"))
    with pytest.raises(NotImplementedError, match="null struct"):
        parquet_tpu.write_table(t, str(tmp_path / "y.parquet"))
    assert not os.path.exists(tmp_path / "x.parquet")


# ---------------------------------------------------------------------------
# the methods that refused and now follow the JAX package
# ---------------------------------------------------------------------------


def test_table_buffer_and_sorting_writer_take_arrow(tmp_path):
    t = _write_input()
    schema = pqt.schema_from_arrow(t.schema)
    jschema = jschema_from_arrow(t.schema)
    buf, jbuf = pqt.TableBuffer(schema), JTableBuffer(jschema)
    for s in (0, 100, 200):
        buf.write_arrow(t.slice(s, 100))
        jbuf.write_arrow(t.slice(s, 100))
    assert buf.num_rows == jbuf.num_rows == N
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    with pqt.ParquetWriter(a, schema) as w:
        buf.flush_to(w)
    with parquet_tpu.ParquetWriter(b, jschema) as w:
        jbuf.flush_to(w)
    assert papq.read_table(a).equals(papq.read_table(b))
    keys = [SortingColumn("i32", descending=True), SortingColumn("id")]
    jkeys = [JSort("i32", descending=True), JSort("id")]
    a, b = str(tmp_path / "sa.parquet"), str(tmp_path / "sb.parquet")
    sw = pqt.SortingWriter(a, schema, keys, buffer_rows=64, device=CPU)
    jsw = JSortingWriter(b, jschema, jkeys, buffer_rows=64)
    for s in range(0, N, 60):
        sw.write_arrow(t.slice(s, 60))
        jsw.write_arrow(t.slice(s, 60))
    assert len(sw.spills) > 1
    sw.close()
    jsw.close()
    assert papq.read_table(a).equals(papq.read_table(b))


def test_dataset_writer_takes_arrow(tmp_path):
    t = _write_input()
    got_dir, want_dir = str(tmp_path / "t"), str(tmp_path / "j")
    w = pqt.DatasetWriter(got_dir, pqt.schema_from_arrow(t.schema),
                          rows_per_file=100)
    jw = parquet_tpu.DatasetWriter(want_dir, jschema_from_arrow(t.schema),
                                   rows_per_file=100)
    for s in (0, 120):
        w.write_arrow(t.slice(s, 120))
        jw.write_arrow(t.slice(s, 120))
    w.commit()
    jw.commit()
    got = pqt.open_table(got_dir).read(device=CPU).to_arrow()
    want = parquet_tpu.open_table(want_dir).read().to_arrow()
    assert got.num_rows == want.num_rows == N
    for c in t.column_names:
        assert got[c].to_pylist() == want[c].to_pylist() \
            == t[c].to_pylist(), c


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_table_to_arrow(shards):
    rng = np.random.default_rng(1)
    n = 1200
    t = pa.table({
        "k": pa.array(rng.integers(-50, 50, n), pa.int64()),
        "d": pa.array(_nulls((np.arange(n) * 3).tolist()), pa.date32()),
        "s": pa.array(_nulls([f"s{v % 9}" for v in range(n)])),
        "p": pa.array([f"plain{v}" for v in range(n)]),
        "dec": pa.array([decimal.Decimal(v).scaleb(-2) for v in range(n)],
                        pa.decimal128(12, 2))})
    raw = _raw(t, row_group_size=200, use_dictionary=["s"])
    got = pqt.read_table_sharded(raw, mesh=[CPU] * shards).to_arrow()
    want = jmesh.read_table_sharded(
        raw, mesh=jmesh.default_mesh(shards)).to_arrow()
    assert got.column_names == want.column_names
    assert got.equals(want)


# ---------------------------------------------------------------------------
# the port without pyarrow
# ---------------------------------------------------------------------------

_BLOCKED = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError("pyarrow is blocked")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import parquet_tpu_torch as pq

assert "pyarrow" not in sys.modules
path = sys.argv[1]
pq.write_table({"a": np.arange(100), "b": np.arange(100) * 0.5}, path,
               pq.WriterOptions(row_group_size=30))
cols = pq.ParquetFile(path).read(device="cpu")
assert cols["a"].values.tolist() == list(range(100))
assert cols.num_rows == 100 and cols.columns["b"].to_pylist()[3] == 1.5
assert "pyarrow" not in sys.modules
try:
    cols.to_arrow()
except ImportError as e:
    assert "pyarrow" in str(e)
else:
    raise AssertionError("to_arrow ran without pyarrow")
print("ok")
"""


def test_the_port_runs_without_pyarrow(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path / "x.parquet")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
