"""The port's footer and schema repairs against parquet_tpu, on the CPU.

The port's writer writes one ``TYPE_ORDER`` column order a leaf, as the
JAX package's does, and reads the ones others write; it reads a chunk's
page encoding stats and size statistics; its writer stops at
``MAX_ROW_GROUPS`` row groups and its schema at ``MAX_COLUMN_DEPTH``
nodes, each with the JAX package's error; its schema prints and reads
logical annotations as the JAX package's; and ``ParquetFile`` has the
JAX package's metadata accessors.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu import errors as jerrors
from parquet_tpu.format import metadata as jmd
from parquet_tpu.format import thrift as jthrift
from parquet_tpu.io import writer as jwriter
from parquet_tpu.schema import schema as jschema
from parquet_tpu.schema import types as jtypes

import parquet_tpu_torch as pqt
from parquet_tpu_torch import errors as terrors
from parquet_tpu_torch.format import metadata as tmd
from parquet_tpu_torch.format import thrift as tthrift
from parquet_tpu_torch.format.enums import ConvertedType, Type
from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
from parquet_tpu_torch.io import writer as twriter
from parquet_tpu_torch.schema import schema as tschema
from parquet_tpu_torch.schema import types as ttypes


def _table():
    rng = np.random.default_rng(0)
    return {"a": rng.integers(0, 100, 500).astype(np.int64),
            "b": rng.standard_normal(500),
            "c": np.array([b"x", b"yy"] * 250, dtype=object)}


def _port_bytes() -> bytes:
    buf = io.BytesIO()
    pqt.write_table(_table(), buf, pqt.WriterOptions(row_group_size=200))
    return buf.getvalue()


def _ref_bytes() -> bytes:
    t = _table()
    buf = io.BytesIO()
    parquet_tpu.write_table(
        pa.table({"a": t["a"], "b": t["b"],
                  "c": pa.array(list(t["c"]), pa.binary())}), buf,
        parquet_tpu.WriterOptions(row_group_size=200))
    return buf.getvalue()


def _footer(raw: bytes) -> bytes:
    n = int.from_bytes(raw[-8:-4], "little")
    return raw[-8 - n:-8]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_column_orders_parse_equal_in_both_packages(writer):
    raw = _port_bytes() if writer == "port" else _ref_bytes()
    mine, _ = tthrift.deserialize(tmd.FileMetaData, _footer(raw))
    theirs, _ = jthrift.deserialize(jmd.FileMetaData, _footer(raw))
    assert len(mine.column_orders) == len(theirs.column_orders) == 3
    for m, t in zip(mine.column_orders, theirs.column_orders):
        assert m.TYPE_ORDER is not None and t.TYPE_ORDER is not None
    # and the port's footer round-trips the field
    again, _ = tthrift.deserialize(tmd.FileMetaData,
                                   tthrift.serialize(mine))
    assert len(again.column_orders) == 3


def test_both_writers_write_the_same_column_orders():
    mine = pqt.ParquetFile(_port_bytes()).metadata.column_orders
    theirs = parquet_tpu.ParquetFile(_ref_bytes()).metadata.column_orders
    assert [o.TYPE_ORDER is not None for o in mine] == \
        [o.TYPE_ORDER is not None for o in theirs] == [True] * 3


def test_encoding_stats_and_size_statistics_read_back():
    """pyarrow's file: each chunk's page encoding stats and size
    statistics as the JAX package reads them."""
    t = pa.table({"a": pa.array(np.arange(1_000) % 7),
                  "s": pa.array([f"w{i % 5}" for i in range(1_000)])})
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=400, write_page_index=True)
    raw = buf.getvalue()
    mine = pqt.ParquetFile(raw).metadata
    theirs = parquet_tpu.ParquetFile(raw).metadata
    seen = 0
    for rg_m, rg_t in zip(mine.row_groups, theirs.row_groups):
        for c_m, c_t in zip(rg_m.columns, rg_t.columns):
            m, t = c_m.meta_data, c_t.meta_data
            assert [(e.page_type, e.encoding, e.count)
                    for e in m.encoding_stats or []] == \
                [(e.page_type, e.encoding, e.count)
                 for e in t.encoding_stats or []]
            if t.size_statistics is not None:
                seen += 1
                for f in ("unencoded_byte_array_data_bytes",
                          "repetition_level_histogram",
                          "definition_level_histogram"):
                    assert getattr(m.size_statistics, f) == \
                        getattr(t.size_statistics, f), f
    assert seen > 0


@pytest.mark.parametrize("limit", [1, 3])
def test_row_group_limit_as_jax(monkeypatch, limit):
    """Both writers raise ``TooManyRowGroupsError`` at the same row group
    (the limit lowered for the test only)."""
    monkeypatch.setattr(twriter, "MAX_ROW_GROUPS", limit)
    monkeypatch.setattr(jwriter, "MAX_ROW_GROUPS", limit)
    t = _table()
    with pytest.raises(terrors.TooManyRowGroupsError) as mine:
        pqt.write_table(t, io.BytesIO(), pqt.WriterOptions(
            row_group_size=100))
    with pytest.raises(jerrors.TooManyRowGroupsError) as theirs:
        parquet_tpu.write_table(
            pa.table({"a": t["a"], "b": t["b"]}), io.BytesIO(),
            parquet_tpu.WriterOptions(row_group_size=100))
    assert str(mine.value) == str(theirs.value)
    assert issubclass(terrors.TooManyRowGroupsError, ValueError)
    # the same rows at the limit's row groups write, and read back
    buf = io.BytesIO()
    pqt.write_table({"a": t["a"][:100 * limit]}, buf,
                    pqt.WriterOptions(row_group_size=100))
    assert len(pqt.ParquetFile(buf.getvalue()).row_groups) == limit


def _chain(mod, depth: int):
    node = mod.leaf("v", Type.INT64)
    for i in range(depth - 1):
        node = mod.group(f"g{i}", [node])
    return mod.message("m", [node])


@pytest.mark.parametrize("depth", [16, 17, 20])
def test_column_depth_limit_as_jax(depth):
    if depth <= 16:
        assert len(_chain(tschema, depth).leaves[0].path) == depth
        assert len(_chain(jschema, depth).leaves[0].path) == depth
        return
    with pytest.raises(terrors.ColumnTooDeepError) as mine:
        _chain(tschema, depth)
    with pytest.raises(jerrors.ColumnTooDeepError) as theirs:
        _chain(jschema, depth)
    assert str(mine.value) == str(theirs.value)
    assert isinstance(mine.value, ValueError)


def test_missing_root_and_write_error():
    with pytest.raises(terrors.MissingRootColumnError):
        tschema.Schema.from_elements([])
    assert issubclass(terrors.MissingRootColumnError, terrors.CorruptedError)
    for kw in ({}, {"path": "/a/b"}, {"path": "/a", "temp_path": "/a.tmp"}):
        mine = terrors.WriteError("commit failed", **kw)
        theirs = jerrors.WriteError("commit failed", **kw)
        assert str(mine) == str(theirs) and isinstance(mine, OSError)
        assert (mine.path, mine.temp_path) == (theirs.path, theirs.temp_path)


def _elements():
    """Schema elements with every annotation form both packages read."""
    L, C = tmd.LogicalType, ConvertedType
    out = [tmd.SchemaElement(name="s", type=int(Type.BYTE_ARRAY),
                             converted_type=int(C.UTF8)),
           tmd.SchemaElement(name="d", type=int(Type.INT64),
                             converted_type=int(C.DECIMAL), scale=2,
                             precision=12),
           tmd.SchemaElement(name="u", type=int(Type.INT32),
                             logicalType=L(INTEGER=tmd.IntType(
                                 bitWidth=16, isSigned=False))),
           tmd.SchemaElement(name="t", type=int(Type.INT64),
                             logicalType=L(TIMESTAMP=tmd.TimestampType(
                                 isAdjustedToUTC=False,
                                 unit=tmd.TimeUnit(NANOS=tmd.NanoSeconds())))),
           tmd.SchemaElement(name="ts", type=int(Type.INT64),
                             converted_type=int(C.TIMESTAMP_MICROS)),
           tmd.SchemaElement(name="i8", type=int(Type.INT32),
                             converted_type=int(C.INT_8)),
           tmd.SchemaElement(name="n", type=int(Type.INT32))]
    return out


def test_logical_from_element_as_jax():
    for el in _elements():
        jel, _ = jthrift.deserialize(jmd.SchemaElement,
                                     tthrift.serialize(el))
        assert ttypes._logical_from_element(el) == \
            jtypes._logical_from_element(jel), el.name
        assert ttypes.node(el) == jtypes.node(jel)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_schema_repr_and_accessors_as_jax(writer):
    raw = _port_bytes() if writer == "port" else _ref_bytes()
    mine, theirs = pqt.ParquetFile(raw), parquet_tpu.ParquetFile(raw)
    assert repr(mine.schema) == repr(theirs.schema)
    assert mine.created_by == theirs.created_by
    assert mine.key_value_metadata() == theirs.key_value_metadata()
    rg, jrg = mine.row_group(1), theirs.row_groups[1]
    assert [c.leaf.name for c in rg.columns()] == \
        [c.leaf.dotted_path for c in jrg.columns()]
    assert [c.meta.num_values for c in rg.columns()] == \
        [c.meta.num_values for c in jrg.columns()]
    got = mine.read(device="cpu")
    assert list(got.keys()) == ["a", "b", "c"]


def test_nested_schema_repr_as_jax():
    def build(mod):
        return mod.message("doc", [
            mod.leaf("id", Type.INT64),
            mod.list_of("tags", mod.leaf("element", Type.BYTE_ARRAY,
                                         logical="string")),
            mod.optional(mod.group("pt", [mod.leaf("x", Type.DOUBLE),
                                          mod.optional(mod.leaf(
                                              "y", Type.INT32))]))])
    assert repr(build(tschema)) == repr(build(jschema))
    assert Rep.OPTIONAL == jschema.Rep.OPTIONAL
