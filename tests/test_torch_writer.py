"""parquet_tpu_torch's writer, read back by parquet_tpu and by pyarrow, and
its thrift structs against parquet_tpu's thrift module."""

import io

import numpy as np
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu.format import metadata as jmd
from parquet_tpu.format import thrift as jthrift

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format import metadata as tmd
from parquet_tpu_torch.format import thrift as tthrift
from parquet_tpu_torch.format.enums import Encoding

ROWS = 5000


def _table(rng, enc: str) -> dict:
    table = {}
    types = (np.int32, np.int64) if enc == "delta" else (
        np.int32, np.int64, np.float32, np.float64)
    for dt in types:
        v = rng.integers(-1000, 1000, ROWS).astype(dt)
        if enc == "delta":
            v = np.cumsum(v, dtype=dt)
        if dt in (np.float32, np.float64):
            v = v / 4
        name = np.dtype(dt).name
        table[f"{name}_req"] = v
        mask = rng.random(ROWS) < 0.25
        mask[1500:3000] = True  # whole pages of nulls
        table[f"{name}_opt"] = np.ma.masked_array(v[::-1].copy(), mask=mask)
    return table


def _expected(arr):
    """(present values, validity or None) of an input column."""
    if isinstance(arr, np.ma.MaskedArray):
        valid = ~np.ma.getmaskarray(arr)
        return np.asarray(arr.data)[valid], valid
    return np.asarray(arr), None


@pytest.mark.parametrize("codec", ["uncompressed", "gzip"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("enc", ["plain", "dict", "delta"])
def test_written_file_reads_back(enc, version, codec, rng):
    table = _table(rng, enc)
    encoding = {"plain": Encoding.PLAIN, "dict": Encoding.RLE_DICTIONARY,
                "delta": Encoding.DELTA_BINARY_PACKED}[enc]
    opts = pqt.WriterOptions(
        compression=codec, data_page_version=version, row_group_size=2000,
        data_page_size=1024,
        column_encoding={name: encoding for name in table})
    buf = io.BytesIO()
    pqt.write_table(table, buf, opts)
    data = buf.getvalue()

    jax_host = parquet_tpu.ParquetFile(data).read(device=False)
    arrow = papq.read_table(io.BytesIO(data))
    port = pqt.ParquetFile(data).read(device="cpu")
    assert arrow.num_rows == ROWS
    for name, arr in table.items():
        want, valid = _expected(arr)
        col = jax_host[name]
        np.testing.assert_array_equal(np.asarray(col.values), want,
                                      err_msg=name)
        if valid is not None:
            np.testing.assert_array_equal(np.asarray(col.validity), valid)
        a = arrow.column(name).combine_chunks()
        assert arrow.schema.field(name).nullable == (valid is not None)
        np.testing.assert_array_equal(
            a.is_valid().to_numpy(zero_copy_only=False),
            np.ones(ROWS, bool) if valid is None else valid)
        np.testing.assert_array_equal(
            a.drop_null().to_numpy(zero_copy_only=False), want)
        np.testing.assert_array_equal(port[name].values.numpy(), want)
    # every chunk carries the requested encoding
    meta = papq.ParquetFile(io.BytesIO(data)).metadata
    want_enc = {"plain": "PLAIN", "dict": "RLE_DICTIONARY",
                "delta": "DELTA_BINARY_PACKED"}[enc]
    for rg in range(meta.num_row_groups):
        for c in range(meta.num_columns):
            assert want_enc in meta.row_group(rg).column(c).encodings


def test_default_encoding_is_dictionary_within_the_limit(rng):
    """Without a forced encoding, a column is dictionary-encoded while its
    dictionary fits ``dictionary_page_limit`` bytes, else PLAIN."""
    table = {"few": rng.integers(0, 10, 4000).astype(np.int64),
             "many": np.arange(4000, dtype=np.int64)}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(dictionary_page_limit=800))
    meta = papq.ParquetFile(io.BytesIO(buf.getvalue())).metadata
    assert "RLE_DICTIONARY" in meta.row_group(0).column(0).encodings
    assert "RLE_DICTIONARY" not in meta.row_group(0).column(1).encodings
    out = pqt.ParquetFile(buf.getvalue()).read(device="cpu")
    for name, arr in table.items():
        np.testing.assert_array_equal(out[name].values.numpy(), arr)


def test_dictionary_keeps_float_bit_patterns():
    """-0.0 and 0.0 (and two NaN payloads) are distinct dictionary
    entries."""
    v = np.array([0.0, -0.0, np.nan, 1.0, -0.0] * 20)
    v[3::5] = np.frombuffer(np.uint64(0x7FF8000000000123).tobytes(),
                            np.float64)[0]
    buf = io.BytesIO()
    pqt.write_table({"x": v}, buf, pqt.WriterOptions(
        column_encoding={"x": Encoding.RLE_DICTIONARY}))
    got = pqt.ParquetFile(buf.getvalue()).read(device="cpu")["x"].values
    np.testing.assert_array_equal(got.numpy().view(np.int64), v.view(np.int64))


def test_writer_rejects_what_the_slice_does_not_write():
    with pytest.raises(ValueError):
        pqt.WriterOptions(column_encoding={"x": Encoding.BIT_PACKED})
    with pytest.raises(ValueError):
        pqt.write_table({"x": np.ones(4)}, io.BytesIO(), pqt.WriterOptions(
            column_encoding={"x": Encoding.DELTA_BINARY_PACKED}))
    with pytest.raises(ValueError):
        pqt.write_table({"x": np.ones(4, bool)}, io.BytesIO(),
                        pqt.WriterOptions(column_encoding={
                            "x": Encoding.BYTE_STREAM_SPLIT}))
    with pytest.raises(TypeError):
        pqt.write_table({"x": np.ones(4, np.int16)}, io.BytesIO())


def _footer(data: bytes) -> bytes:
    n = int.from_bytes(data[-8:-4], "little")
    return data[-8 - n:-8]


def test_footer_parses_with_parquet_tpu_thrift(rng):
    table = _table(rng, "dict")
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(row_group_size=3000))
    footer = _footer(buf.getvalue())
    tmeta, tend = tthrift.deserialize(tmd.FileMetaData, footer)
    jmeta, jend = jthrift.deserialize(jmd.FileMetaData, footer)
    assert tend == jend == len(footer)
    assert tmeta.num_rows == jmeta.num_rows == ROWS
    assert [s.name for s in tmeta.schema] == [s.name for s in jmeta.schema]
    for trg, jrg in zip(tmeta.row_groups, jmeta.row_groups):
        for tc, jc in zip(trg.columns, jrg.columns):
            for f in ("type", "encodings", "path_in_schema", "codec",
                      "num_values", "total_compressed_size",
                      "data_page_offset", "dictionary_page_offset"):
                assert getattr(tc.meta_data, f) == getattr(jc.meta_data, f)
    # and back: the port's serialization of what it parsed is the same
    # bytes parquet_tpu writes for the same struct
    assert tthrift.serialize(tmeta) == jthrift.serialize(jmeta)


def test_page_headers_round_trip_between_the_two_thrift_modules():
    theader = tmd.PageHeader(
        type=3, uncompressed_page_size=1 << 20, compressed_page_size=12345,
        crc=-7, data_page_header_v2=tmd.DataPageHeaderV2(
            num_values=70000, num_nulls=123, num_rows=70000, encoding=8,
            definition_levels_byte_length=99,
            repetition_levels_byte_length=0, is_compressed=False))
    blob = tthrift.serialize(theader)
    jheader, _ = jthrift.deserialize(jmd.PageHeader, blob)
    assert jthrift.serialize(jheader) == blob
    jdph = jmd.DataPageHeader(num_values=5, encoding=0,
                              definition_level_encoding=3,
                              repetition_level_encoding=3)
    jblob = jthrift.serialize(jmd.PageHeader(
        type=0, uncompressed_page_size=40, compressed_page_size=40,
        data_page_header=jdph))
    back, end = tthrift.deserialize(tmd.PageHeader, jblob)
    assert end == len(jblob)
    assert back.data_page_header.num_values == 5
    assert back.data_page_header.definition_level_encoding == 3
    assert tthrift.serialize(back) == jblob


def test_indexes_filters_and_sorting_match_the_jax_writer(rng):
    """The JAX reader parses the port-written chunk statistics, column and
    offset indexes, bloom filters and ``sorting_columns``, and each equals
    what the JAX writer writes for the same table.  Page offsets differ
    (the two writers' page headers do), so each offset-index location is
    checked to frame exactly one page header and its body."""
    import pyarrow as pa

    from parquet_tpu.format.enums import Encoding as JEncoding
    from parquet_tpu.io.writer import WriterOptions as JWriterOptions
    from parquet_tpu.io.writer import write_table as jwrite_table

    n = 5000
    table = {
        "a": np.sort(rng.integers(-1000, 1000, n)).astype(np.int64),
        "b": np.ma.masked_array(rng.random(n), mask=rng.random(n) < 0.2),
        "c": np.ma.masked_array(rng.integers(0, 50, n).astype(np.int32),
                                mask=rng.random(n) < 0.1),
        "d": (rng.random(n) - 0.5).astype(np.float32),
    }
    table["b"].mask[1000:2500] = True  # null pages
    blooms = {"a": 10, "b": 10, "c": 8}
    sorting = [("a", False, False)]
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=2000, data_page_size=1024, column_encoding={
            "a": Encoding.DELTA_BINARY_PACKED, "b": Encoding.PLAIN,
            "c": Encoding.RLE_DICTIONARY, "d": Encoding.PLAIN},
        bloom_filters=blooms, sorting_columns=sorting))
    arrow = pa.table({
        k: (pa.array(np.asarray(v.data), mask=np.ma.getmaskarray(v))
            if isinstance(v, np.ma.MaskedArray) else pa.array(v))
        for k, v in table.items()})
    jbuf = io.BytesIO()
    jwrite_table(arrow, jbuf, JWriterOptions(
        row_group_size=2000, data_page_size=1024, compression="uncompressed",
        dictionary=["c"], column_encoding={"a": JEncoding.DELTA_BINARY_PACKED},
        bloom_filters=blooms, sorting_columns=sorting))
    data = buf.getvalue()
    port = parquet_tpu.ParquetFile(data)
    ref = parquet_tpu.ParquetFile(jbuf.getvalue())
    orders = set()
    for prg, jrg in zip(port.row_groups, ref.row_groups, strict=True):
        assert prg.sorting_columns == jrg.sorting_columns
        assert prg.sorting_columns[0].column_idx == 0
        for i, name in enumerate(table):
            pc, jc = prg.column(i), jrg.column(i)
            assert pc.meta.statistics == jc.meta.statistics, name
            assert pc.statistics() == jc.statistics(), name
            assert pc.column_index() == jc.column_index(), name
            orders.add(pc.column_index().boundary_order)
            plocs = pc.offset_index().page_locations
            jlocs = jc.offset_index().page_locations
            assert ([p.first_row_index for p in plocs]
                    == [p.first_row_index for p in jlocs]), name
            for loc in plocs:
                header, end = jthrift.deserialize(jmd.PageHeader, data,
                                                  loc.offset)
                assert (end - loc.offset + header.compressed_page_size
                        == loc.compressed_page_size)
            pb, jb = pc.bloom_filter(), jc.bloom_filter()
            if name in blooms:
                np.testing.assert_array_equal(pb.blocks, jb.blocks)
            else:
                assert pb is None and jb is None
    assert orders == {0, 1}  # UNORDERED and ASCENDING both occur
    # and the port reads back what it wrote
    f = pqt.ParquetFile(data)
    assert f.row_groups[0].sorting_columns == [tmd.SortingColumn(
        column_idx=0, descending=False, nulls_first=False)]
    assert tthrift.serialize(f.row_groups[1].column(2).column_index()) == \
        jthrift.serialize(ref.row_groups[1].column(2).column_index())


@pytest.mark.parametrize("value,physical", [
    (-7, 1), (2**40, 2), (1.5, 4), (-0.0, 5), (float("inf"), 5)])
def test_stat_values_encode_and_decode_as_jax(value, physical):
    """Statistics bytes of each numeric type: the port's encoding equals
    the JAX package's, and both decode them to the same order value."""
    from parquet_tpu.format.enums import Type as JType
    from parquet_tpu.io import statistics as jstats
    from parquet_tpu.schema.schema import Leaf as JLeaf
    from parquet_tpu.schema.schema import Node as JNode

    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.io import statistics as tstats
    from parquet_tpu_torch.schema.schema import Leaf

    raw = tstats.encode_stat_value(value, Type(physical))
    assert raw == jstats.encode_stat_value(value, JType(physical))
    jleaf = JLeaf(0, ("x",), JNode("x", physical_type=JType(physical)), 0, 0)
    got = tstats.decode_stat_value(raw, Leaf(0, "x", Type(physical)))
    want = jstats.decode_stat_value(raw, jleaf)
    assert type(got) is type(want) and repr(got) == repr(want)
    assert tstats.encode_stat_value(None, Type(physical)) == b""


def _ba_table(rng, n: int) -> dict:
    """Byte-array, fixed-length and boolean columns with nulls: random
    bytes (some longer than the page index's 64-byte bound, some empty),
    a string category, sorted URLs, 16-byte rows and booleans."""
    import pyarrow as pa

    lens = rng.integers(0, 90, n)
    blobs = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
             for k in lens]
    blobs[::50] = [b"\xff" * 70] * len(blobs[::50])  # a max that cannot
    # be cut shorter
    cats = [f"cat-{i}" for i in rng.integers(0, 37, n)]
    urls = sorted(f"https://h{i % 3}.example.com/{'x' * (i % 80)}/{i}"
                  for i in rng.integers(0, 10_000, n))
    rows = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    mask = rng.random(n) < 0.1
    mask[700:1300] = True  # null pages
    return {
        "blob": pa.array(blobs, pa.binary(), mask=mask),
        "cat": pa.array(cats, pa.string(), mask=mask),
        "url": pa.array(urls, pa.string()),
        "fixed": pa.array([r.tobytes() for r in rows], pa.binary(16),
                          mask=mask),
        "flag": pa.array(rng.random(n) < 0.3, mask=mask),
    }


def _port_columns(table: dict):
    """The same table as the port's ColumnData and schema."""
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.io.writer import ColumnData
    from parquet_tpu_torch.schema.schema import Leaf, Schema

    leaves, cols = [], {}
    for name, arr in table.items():
        valid = np.asarray(arr.is_valid())
        present = arr.filter(arr.is_valid())
        rep = 1 if arr.null_count else 0
        if name == "fixed":
            leaves.append(Leaf(-1, name, Type.FIXED_LEN_BYTE_ARRAY, rep, 16))
            vals = np.frombuffer(b"".join(present.to_pylist()),
                                 np.uint8).reshape(-1, 16)
            cols[name] = ColumnData(vals, valid if rep else None)
        elif name == "flag":
            leaves.append(Leaf(-1, name, Type.BOOLEAN, rep))
            cols[name] = ColumnData(np.asarray(present), valid if rep
                                    else None)
        else:
            items = [x.encode() if isinstance(x, str) else x
                     for x in present.to_pylist()]
            offs = np.zeros(len(items) + 1, np.int64)
            np.cumsum([len(x) for x in items], out=offs[1:])
            leaves.append(Leaf(-1, name, Type.BYTE_ARRAY, rep,
                               string=name != "blob"))
            cols[name] = ColumnData(np.frombuffer(b"".join(items), np.uint8),
                                    valid if rep else None, offs)
    return cols, Schema(leaves)


@pytest.mark.parametrize("encoding", ["PLAIN", "RLE_DICTIONARY",
                                      "DELTA_LENGTH_BYTE_ARRAY",
                                      "DELTA_BYTE_ARRAY"])
def test_byte_array_statistics_index_and_dictionaries_match_jax(encoding,
                                                                rng):
    """Chunk and page statistics (unsigned lexicographic, page-index bounds
    cut to 64 bytes), boundary orders, page boundaries and dictionaries of
    byte-array, fixed-length and boolean columns equal the JAX writer's for
    the same table, and parquet_tpu and pyarrow read the port's file
    back."""
    import pyarrow as pa

    from parquet_tpu.format.enums import Encoding as JEncoding
    from parquet_tpu.io.writer import WriterOptions as JWriterOptions
    from parquet_tpu.io.writer import write_table as jwrite_table

    n = 3000
    table = _ba_table(rng, n)
    ba = ("blob", "cat", "url")
    dict_cols = list(ba) if encoding == "RLE_DICTIONARY" else []
    forced = {} if dict_cols else {c: encoding for c in ba}
    cols, schema = _port_columns(table)
    buf = io.BytesIO()
    pqt.write_table(cols, buf, pqt.WriterOptions(
        row_group_size=1200, data_page_size=2048, compression="snappy",
        dictionary=bool(dict_cols),
        column_encoding={c: Encoding[e] for c, e in forced.items()}),
        schema=schema)
    jbuf = io.BytesIO()
    jwrite_table(pa.table(table), jbuf, JWriterOptions(
        row_group_size=1200, data_page_size=2048, compression="snappy",
        dictionary=dict_cols,
        column_encoding={c: JEncoding[e] for c, e in forced.items()}))
    data = buf.getvalue()
    port = parquet_tpu.ParquetFile(data)
    ref = parquet_tpu.ParquetFile(jbuf.getvalue())
    tport = pqt.ParquetFile(data)
    tref = pqt.ParquetFile(jbuf.getvalue())
    dict_seen = False
    for prg, jrg, trg, trrg in zip(port.row_groups, ref.row_groups,
                                   tport.row_groups, tref.row_groups,
                                   strict=True):
        for i, name in enumerate(table):
            pc, jc = prg.column(i), jrg.column(i)
            assert pc.meta.statistics == jc.meta.statistics, name
            assert pc.statistics() == jc.statistics(), name
            assert pc.column_index() == jc.column_index(), name
            assert trg.column(i).statistics() == trrg.column(i).statistics()
            assert ([p.first_row_index for p in
                     pc.offset_index().page_locations]
                    == [p.first_row_index for p in
                        jc.offset_index().page_locations]), name
            assert pc.meta.encodings == jc.meta.encodings, name
            if pc.meta.dictionary_page_offset is not None:
                # the same entries in the same (first-seen) order
                chunks = (trg.column(i), trrg.column(i))
                got, want = (pqt.io.reader.decode_dictionary_page(
                    c, next(c.pages())) for c in chunks)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                dict_seen = True
    # both readers read the port's file back
    assert dict_seen == bool(dict_cols)
    jax_host = port.read(device=False)
    arrow = papq.read_table(io.BytesIO(data))
    for name, arr in table.items():
        assert arrow[name].combine_chunks().equals(arr), name
        want = arr.to_pylist()
        got = jax_host[name].to_arrow().to_pylist()
        assert got == want, name


def test_schema_of_every_input_kind(rng):
    """``write_table`` takes bool arrays (BOOLEAN), object arrays of str
    (UTF-8 strings) and of bytes (BYTE_ARRAY), ``(n, 3)`` int32 (INT96) and
    ``(n, w)`` uint8 (FIXED_LEN_BYTE_ARRAY); the port, parquet_tpu and
    pyarrow read each back."""
    n = 500
    strs = [f"s{i % 37}" for i in range(n)]
    table = {
        "b": rng.random(n) < 0.5,
        "s": np.ma.masked_array(np.array(strs, dtype=object),
                                mask=rng.random(n) < 0.2),
        "y": np.array([bytes([i % 256]) * (i % 5) for i in range(n)],
                      dtype=object),
        "t": rng.integers(0, 2**31, (n, 3)).astype(np.int32),
        "f": rng.integers(0, 256, (n, 6), dtype=np.uint8),
    }
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(compression="snappy",
                                                  row_group_size=200))
    data = buf.getvalue()
    schema = pqt.ParquetFile(data).schema
    assert [leaf.physical_type.name for leaf in schema.leaves] == [
        "BOOLEAN", "BYTE_ARRAY", "BYTE_ARRAY", "INT96",
        "FIXED_LEN_BYTE_ARRAY"]
    assert [leaf.string for leaf in schema.leaves] == [False, True, False,
                                                       False, False]
    assert schema.leaf("f").type_length == 6
    port = pqt.ParquetFile(data).read(device="cpu")
    jax_host = parquet_tpu.ParquetFile(data).read(device=False)
    arrow = papq.read_table(io.BytesIO(data))
    np.testing.assert_array_equal(port["b"].values.numpy(), table["b"])
    np.testing.assert_array_equal(port["t"].values.numpy(), table["t"])
    np.testing.assert_array_equal(port["f"].values.numpy(), table["f"])
    np.testing.assert_array_equal(np.asarray(jax_host["f"].values),
                                  table["f"])
    valid = ~table["s"].mask
    v, o = port["s"].materialize_host()
    assert [bytes(v[o[i]:o[i + 1]]).decode() for i in range(len(o) - 1)] \
        == [x for x, ok in zip(strs, valid) if ok]
    np.testing.assert_array_equal(port["s"].validity.numpy(), valid)
    assert arrow["s"].to_pylist() == [x if ok else None
                                      for x, ok in zip(strs, valid)]
    assert arrow["y"].to_pylist() == list(table["y"])
    assert arrow["b"].to_pylist() == table["b"].tolist()


def _buffered_columns(rng, n: int, port: bool):
    """A flat key, nullable strings, a nullable list (one offsets array
    a level in the port's form) and a two-level list in the raw-level
    form, as one package's ColumnData, and its schema."""
    from parquet_tpu.format.enums import FieldRepetitionType as JRep
    from parquet_tpu.format.enums import Type as JType
    from parquet_tpu.io.writer import ColumnData as JCD
    from parquet_tpu.schema import schema as JS
    from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.schema import schema as S
    from parquet_tpu_torch.schema.types import LogicalKind as K

    S_, R_, T_, CD = (S, Rep, Type, pqt.ColumnData) if port else \
        (JS, JRep, JType, JCD)
    schema = S_.message("m", [
        S_.leaf("k", T_.INT64),
        S_.leaf("s", T_.BYTE_ARRAY, R_.OPTIONAL, K.STRING),
        S_.list_of("l", S_.leaf("element", T_.INT32, R_.OPTIONAL)),
        S_.list_of("ll", S_.list_of("element", S_.leaf("element",
                                                       T_.INT64)))])
    valid = rng.random(n) > 0.25
    words = [f"w{i % 13}".encode() for i in range(n) if valid[i]]
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=offs[1:])
    lens = rng.integers(0, 4, n)
    lvalid = rng.random(n) > 0.1
    lens[~lvalid] = 0
    lo = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=lo[1:])
    evalid = rng.random(int(lo[-1])) > 0.2
    ll_schema = JS.message("x", [JS.list_of("ll", JS.list_of(
        "element", JS.leaf("element", JType.INT64)))])
    max_def = ll_schema.leaves[0].max_definition_level
    slots = [v for i in range(n) for v in parquet_tpu.rows.deconstruct(
        ll_schema, {"ll": None if i % 9 == 4 else
                    [[i] * (j % 3) for j in range(i % 3)]})]
    defs = np.array([v.definition_level for v in slots], np.int32)
    reps = np.array([v.repetition_level for v in slots], np.int32)
    llv = np.array([v.value for v in slots
                    if v.definition_level == max_def], np.int64)
    lst = CD(values=rng.integers(-9, 9, int(evalid.sum())).astype(np.int32),
             validity=evalid)
    lst.list_offsets = [lo] if port else lo
    lst.list_validity = [lvalid] if port else lvalid
    cols = {"k": CD(values=np.arange(n, dtype=np.int64)),
            "s": CD(values=np.frombuffer(b"".join(words), np.uint8),
                    offsets=offs, validity=valid),
            "l.list.element": lst,
            "ll.list.element.list.element": CD(values=llv, def_levels=defs,
                                               rep_levels=reps)}
    return schema, cols


@pytest.mark.parametrize("cuts", [(0, 130, 700, 1750, 2600, 3000),
                                  (0, 3000), (0, 999, 1000, 1001, 3000)])
def test_buffered_write_matches_jax(cuts):
    """``write`` in pieces: full row groups go out as they fill, the tail
    waits for ``flush`` (here, at 1750) or ``close``, as the JAX
    package's writer does; both files hold the same rows."""
    from parquet_tpu.io.writer import _slice_cd as jslice
    from parquet_tpu_torch.io.writer import _slice_cd as tslice

    rng = np.random.default_rng(21)
    tschema, tcols = _buffered_columns(rng, 3000, True)
    rng = np.random.default_rng(21)
    jschema, jcols = _buffered_columns(rng, 3000, False)
    out, jout = io.BytesIO(), io.BytesIO()
    w = pqt.ParquetWriter(out, tschema, pqt.WriterOptions(
        row_group_size=1000))
    jw = parquet_tpu.ParquetWriter(jout, jschema, parquet_tpu.WriterOptions(
        row_group_size=1000))
    for r0, r1 in zip(cuts, cuts[1:]):
        w.write({k: tslice(tschema.leaf(k), v, r0, r1)
                 for k, v in tcols.items()}, r1 - r0)
        jw.write({k: jslice(jschema.leaf(k), v, r0, r1)
                  for k, v in jcols.items()}, r1 - r0)
        if r1 == 1750:
            w.flush()
            jw.flush()
    w.close()
    jw.close()
    got = papq.ParquetFile(io.BytesIO(out.getvalue()))
    want = papq.ParquetFile(io.BytesIO(jout.getvalue()))
    sizes = [got.metadata.row_group(i).num_rows
             for i in range(got.metadata.num_row_groups)]
    assert sizes == [want.metadata.row_group(i).num_rows
                     for i in range(want.metadata.num_row_groups)]
    assert sum(sizes) == 3000 and max(sizes) <= 1000
    assert repr(got.read().to_pylist()) == repr(want.read().to_pylist())


def test_abort_removes_only_its_own_file(tmp_path):
    path = tmp_path / "a.parquet"
    w = pqt.ParquetWriter(str(path), pqt.ParquetFile(
        _write({"x": np.arange(5)})).schema)
    w.write({"x": pqt.ColumnData(values=np.arange(5))}, 5)
    # the atomic commit: a temp file beside the path until close
    assert not path.exists() and len(list(tmp_path.iterdir())) == 1
    w.abort()
    w.abort()  # idempotent
    assert not path.exists() and not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="aborted"):
        w.write({"x": pqt.ColumnData(values=np.arange(5))}, 5)
    with pytest.raises(ValueError, match="aborted"):
        w.close()
    buf = io.BytesIO()
    w = pqt.ParquetWriter(buf, pqt.ParquetFile(
        _write({"x": np.arange(5)})).schema)
    w.write_row_group({"x": pqt.ColumnData(values=np.arange(5))}, 5)
    w.abort()
    assert buf.getvalue().startswith(b"PAR1") and not buf.closed
    with pytest.raises(RuntimeError):
        with pqt.ParquetWriter(str(path), w.schema) as w2:
            w2.write({"x": pqt.ColumnData(values=np.arange(5))}, 5)
            raise RuntimeError("boom")
    assert not path.exists()
    w = pqt.ParquetWriter(str(path), w.schema)
    w.close()
    w.abort()  # a no-op after close
    assert path.exists()
    # the write pipeline's meter: every byte of the committed file
    assert w.write_stats.row_groups == 0
    assert w.write_stats.bytes_flushed == path.stat().st_size


def _write(table, options=None) -> bytes:
    buf = io.BytesIO()
    pqt.write_table(table, buf, options)
    return buf.getvalue()


def test_default_codec_is_snappy_as_jax():
    """Default options give SNAPPY in every chunk, in both packages."""
    table = {"a": np.arange(3000, dtype=np.int64),
             "b": np.ma.masked_array(np.arange(3000) / 3,
                                     mask=np.arange(3000) % 4 == 0)}
    assert pqt.WriterOptions().codec_id() == \
        parquet_tpu.WriterOptions().codec_id()
    jbuf = io.BytesIO()
    parquet_tpu.write_table(
        __import__("pyarrow").table({"a": table["a"], "b": table["b"]}),
        jbuf)
    for raw in (_write(table), jbuf.getvalue()):
        meta = papq.ParquetFile(io.BytesIO(raw)).metadata
        assert {meta.row_group(i).column(j).compression
                for i in range(meta.num_row_groups)
                for j in range(meta.num_columns)} == {"SNAPPY"}


def _first_seen(values: np.ndarray) -> np.ndarray:
    """The distinct values of ``values`` (by bit pattern) in the order they
    first occur: the numpy oracle of a first-seen dictionary."""
    bits = values.view(f"i{values.itemsize}")
    _, first = np.unique(bits, return_index=True)
    return values[np.sort(first)]


def _c4_table(case: str, dtype: str):
    """``(columns of the port, pyarrow table of the JAX writer, row group
    size, what each row group must hold under the default rule)`` of one
    dictionary-choice case."""
    import pyarrow as pa

    rng = np.random.default_rng(sum(map(ord, case + dtype)))
    n = 1000
    cap = n // 2 + 16
    mask = None
    if case in ("under", "over", "forced_under", "forced_over"):
        under = case.endswith("under")
        k = cap - 6 if under else cap + 4
        pool = rng.permutation(1 << 20)[:k] - (1 << 19)
        idx = np.concatenate([np.arange(k), rng.integers(0, k, n - k)])
        values = pool[rng.permutation(idx)]
        rgs, want = n, ["dict" if under else "plain"]
    elif case == "order":
        values = np.array([5, 3, 9, 3, 5, 1] * 100)
        rgs, want = n, ["dict"]
    elif case == "bail":
        # distinct values under the cap (n / 2), but both sample windows
        # (16,384 values; byte arrays 32,768) are all distinct: refused
        # unbuilt
        values = np.tile(rng.permutation(
            70_000 if dtype == "bytes" else 35_000), 2)
        rgs, want = len(values), ["plain"]
    elif case == "clustered":
        # first occurrences all early: the middle window repeats, so the
        # chunk is built and fits
        values = np.concatenate([rng.permutation(30_000),
                                 np.zeros(40_000, np.int64)])
        rgs, want = len(values), ["dict"]
    elif case == "sticky":
        values = np.concatenate([np.arange(n), np.arange(n) % 7])
        rgs, want = n, ["plain", "plain"]
    else:  # "null_first": an all-null chunk says nothing of cardinality
        values = np.concatenate([np.zeros(n, np.int64), np.arange(n) % 7])
        mask = np.arange(2 * n) < n
        rgs, want = n, ["none", "dict"]
    if dtype == "bytes":
        items = np.array([b"k%d" % v for v in values], dtype=object)
        port_col = (items if mask is None
                    else np.ma.masked_array(items, mask=mask))
        arrow = pa.array(list(items), type=pa.binary(), mask=mask)
        return port_col, arrow, rgs, want
    values = values.astype(dtype)
    if dtype in ("float32", "float64"):
        values = values / 4  # exact, and 0 becomes -0.0 where negative
    port_col = values if mask is None else np.ma.masked_array(values,
                                                              mask=mask)
    return port_col, pa.array(values, mask=mask), rgs, want


_C4_CASES = ([(c, d) for c in ("under", "over", "order")
              for d in ("int32", "int64", "float32", "float64")]
             + [("bail", "int64"), ("bail", "float32"), ("bail", "bytes"),
                ("clustered", "int64"), ("clustered", "float64"),
                ("sticky", "int64"), ("sticky", "float32"),
                ("sticky", "bytes"), ("null_first", "int64"),
                ("null_first", "bytes"), ("forced_under", "int64"),
                ("forced_over", "int64"), ("forced_over", "float64")])


@pytest.mark.parametrize("case,dtype", _C4_CASES)
def test_dictionary_choice_matches_jax(case, dtype):
    """Each row group's encodings equal the JAX writer's with default
    options: at most n / 2 + 16 entries, the two-window bail of a long
    chunk, and a column that overflowed in a chunk with values staying
    PLAIN in its later row groups (an all-null chunk does not count).
    Entries are in first-seen order (numpy's oracle), and where the JAX
    package's native dictionary build loads, the same as its entries.  A
    forced RLE_DICTIONARY, which the JAX writer refuses, writes every
    chunk as a dictionary without the cap."""
    import pyarrow as pa

    from parquet_tpu import native
    from parquet_tpu.format.enums import Encoding as JEncoding

    port_col, arrow, rgs, want = _c4_table(case, dtype)
    forced = case.startswith("forced")
    data = _write({"a": port_col}, pqt.WriterOptions(
        row_group_size=rgs, column_encoding={"a": Encoding.RLE_DICTIONARY}
        if forced else {}))
    jbuf = io.BytesIO()
    parquet_tpu.write_table(pa.table({"a": arrow}), jbuf,
                            parquet_tpu.WriterOptions(row_group_size=rgs))
    jdata = jbuf.getvalue()
    if forced:
        with pytest.raises(ValueError):
            parquet_tpu.write_table(
                pa.table({"a": arrow}), io.BytesIO(),
                parquet_tpu.WriterOptions(column_encoding={
                    "a": JEncoding.RLE_DICTIONARY}))
    encs = [[papq.ParquetFile(io.BytesIO(d)).metadata.row_group(r)
             .column(0).encodings for r in range(len(want))]
            for d in (data, jdata)]
    kinds = [["dict" if "RLE_DICTIONARY" in e else "plain" for e in x]
             for x in encs]
    assert kinds[1] == [w if w != "none" else "plain" for w in want]
    if forced:
        assert kinds[0] == ["dict"] * len(want)
    else:
        assert encs[0] == encs[1]
    for r, rg in enumerate(pqt.ParquetFile(data).row_groups):
        chunk = rg.column(0)
        if chunk.meta.dictionary_page_offset is None:
            continue
        got = pqt.io.reader.decode_dictionary_page(chunk,
                                                   next(chunk.pages()))
        lo, hi = r * rgs, (r + 1) * rgs
        part = np.asarray(np.ma.getdata(port_col))[lo:hi][
            ~np.ma.getmaskarray(port_col)[lo:hi]]
        if dtype == "bytes":
            vals, offs = got
            assert [vals[offs[i]:offs[i + 1]].tobytes()
                    for i in range(len(offs) - 1)] == \
                list(dict.fromkeys(part.tolist()))
        else:
            np.testing.assert_array_equal(
                got.view(f"i{got.itemsize}"),
                _first_seen(part).view(f"i{got.itemsize}"))
        jchunk = pqt.ParquetFile(jdata).row_groups[r].column(0)
        if native.get_lib() is not None \
                and jchunk.meta.dictionary_page_offset is not None:
            want_entries = pqt.io.reader.decode_dictionary_page(
                jchunk, next(jchunk.pages()))
            for a, b in zip(*((x if dtype == "bytes" else (x,))
                              for x in (got, want_entries))):
                np.testing.assert_array_equal(a, b)
    back = pqt.ParquetFile(data).read(device="cpu")["a"]
    keep = ~np.ma.getmaskarray(port_col)
    if not isinstance(port_col, np.ma.MaskedArray):
        assert back.validity is None or back.validity.numpy().all()
    else:
        np.testing.assert_array_equal(back.validity.numpy(), keep)
    if dtype != "bytes":
        values = np.ma.getdata(port_col)[keep]
        np.testing.assert_array_equal(
            back.values.numpy().view(f"i{values.itemsize}"),
            values.view(f"i{values.itemsize}"))
