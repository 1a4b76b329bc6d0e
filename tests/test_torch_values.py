"""parquet_tpu_torch's read of every flat value type and encoding against
the JAX package's.

Files over the matrix {BOOLEAN PLAIN/RLE, INT96, FIXED_LEN_BYTE_ARRAY
PLAIN/BYTE_STREAM_SPLIT/dictionary/DELTA_BYTE_ARRAY, the numeric types in
BYTE_STREAM_SPLIT, BYTE_ARRAY PLAIN/DELTA_LENGTH_BYTE_ARRAY/
DELTA_BYTE_ARRAY/dictionary} x {required, optional with nulls and a null
page} x {page v1, v2} x {UNCOMPRESSED, SNAPPY, ZSTD}, three row groups
each, written by pyarrow, by the JAX package's writer and by the port's,
are read by the port on the CPU and compared, exactly, with the generated
values, with ``parquet_tpu``'s host read and with its device read on JAX's
CPU backend through both of its routes: the host routes it takes off the
TPU, and the device routes forced through the environment (both Pallas
kernels in interpret mode).  A pyarrow-written mini-lineitem (the
``bench.py`` lineitem schema, Snappy) is read the same way, and the chunks
the device route refuses take the host decode.
"""

import io
import zlib
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding, Type
from parquet_tpu_torch.io.writer import ColumnData
from parquet_tpu_torch.ops import device as tdev
from parquet_tpu_torch.ops import ref as tref
from parquet_tpu_torch.parallel import device_reader as tdr
from parquet_tpu_torch.schema.schema import Leaf, Schema

ROWS = 3000
ROW_GROUP = 1100
PAGE = 1024

# name -> (physical, type_length, encoding, writers that write it)
ALL = ("pyarrow", "jax", "port")
COLUMNS = {
    "bool_plain": (Type.BOOLEAN, None, "PLAIN", ALL),
    "bool_rle": (Type.BOOLEAN, None, "RLE", ALL),
    "i96_plain": (Type.INT96, None, "PLAIN", ("pyarrow", "port")),
    "flba16_plain": (Type.FIXED_LEN_BYTE_ARRAY, 16, "PLAIN", ALL),
    "flba2_bss": (Type.FIXED_LEN_BYTE_ARRAY, 2, "BYTE_STREAM_SPLIT", ALL),
    "flba4_bss": (Type.FIXED_LEN_BYTE_ARRAY, 4, "BYTE_STREAM_SPLIT", ALL),
    "flba16_dict": (Type.FIXED_LEN_BYTE_ARRAY, 16, "DICT",
                    ("pyarrow", "port")),
    "flba8_dba": (Type.FIXED_LEN_BYTE_ARRAY, 8, "DELTA_BYTE_ARRAY",
                  ("pyarrow",)),
    "f32_bss": (Type.FLOAT, None, "BYTE_STREAM_SPLIT", ALL),
    "f64_bss": (Type.DOUBLE, None, "BYTE_STREAM_SPLIT", ALL),
    "i32_bss": (Type.INT32, None, "BYTE_STREAM_SPLIT", ALL),
    "i64_bss": (Type.INT64, None, "BYTE_STREAM_SPLIT", ALL),
    "ba_plain": (Type.BYTE_ARRAY, None, "PLAIN", ALL),
    "ba_dlba": (Type.BYTE_ARRAY, None, "DELTA_LENGTH_BYTE_ARRAY", ALL),
    "ba_dba": (Type.BYTE_ARRAY, None, "DELTA_BYTE_ARRAY", ALL),
    "ba_dict": (Type.BYTE_ARRAY, None, "DICT", ALL),
    "str_dict": (Type.BYTE_ARRAY, None, "DICT", ALL),
}
_NP = {Type.FLOAT: np.float32, Type.DOUBLE: np.float64, Type.INT32: np.int32,
       Type.INT64: np.int64}


def _strings(rng, n: int, kind: str) -> list:
    if kind == "dba":  # sorted URL-like: long shared prefixes
        hosts = [f"https://www.{w}.example.com/" for w in
                 ("alpha", "beta", "gamma", "delta")]
        out = sorted(
            (hosts[int(h)] + "/".join(f"p{int(x)}" for x in
                                      rng.integers(0, 30, int(d)))).encode()
            for h, d in zip(rng.integers(0, 4, n), rng.integers(0, 6, n)))
        out[::97] = [b""] * len(out[::97])
        return out
    if kind in ("dict", "str"):
        names = [f"city-{i}-{'x' * (i % 7)}" for i in range(60)]
        if kind == "str":
            names = [f"straße-{i}-ü" for i in range(40)]
        return [names[int(i)].encode() for i in rng.integers(0, len(names),
                                                             n)]
    lens = rng.integers(0, 24, n)
    return [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in lens]


def _generate(nulls: str, seed: int) -> dict:
    """name -> (present values as a python list or numpy array, validity
    or None)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (physical, tl, enc, _) in COLUMNS.items():
        if physical == Type.BOOLEAN:
            v = rng.random(ROWS) < 0.4
            v[200:400] = True  # an RLE run
        elif physical == Type.INT96:
            # nanosecond timestamps, as pyarrow writes them to INT96
            ns = rng.integers(0, 2**50, ROWS)
            days, nanos = ns // 86_400_000_000_000 + 2_440_588, \
                ns % 86_400_000_000_000
            v = np.zeros((ROWS, 3), np.int32)
            v[:, :2] = nanos.astype(np.int64).view(np.int32).reshape(-1, 2)
            v[:, 2] = days
            out[name + "_ns"] = ns
        elif physical == Type.FIXED_LEN_BYTE_ARRAY:
            if enc == "DICT":
                pool = rng.integers(0, 256, (40, tl), dtype=np.uint8)
                v = pool[rng.integers(0, 40, ROWS)]
            elif enc == "DELTA_BYTE_ARRAY":
                v = np.sort(rng.integers(0, 256, (ROWS, tl), dtype=np.uint8)
                            .view(f"S{tl}").reshape(-1)).view(np.uint8
                                                               ).reshape(-1, tl)
                v[:, 0] = 7  # shared prefixes
            else:
                v = rng.integers(0, 256, (ROWS, tl), dtype=np.uint8)
        elif physical == Type.BYTE_ARRAY:
            v = _strings(rng, ROWS, {"DELTA_BYTE_ARRAY": "dba",
                                     "DICT": "dict"}.get(enc, "rand")
                         if name != "str_dict" else "str")
        else:
            v = (rng.standard_normal(ROWS) * 100).astype(_NP[physical])
        validity = None
        if nulls == "optional":
            validity = rng.random(ROWS) >= 0.1
            validity[1200:1800] = False  # whole null pages
        if validity is not None:
            if isinstance(v, list):
                v = [x for x, ok in zip(v, validity) if ok]
            else:
                v = v[validity]
        out[name] = (v, validity)
    return out


def _arrow_array(name: str, values, validity, ns=None):
    """``ns``: an INT96 column's present values as nanosecond
    timestamps."""
    physical, tl, enc, _ = COLUMNS[name]
    if validity is None:
        validity = np.ones(len(values), bool)
    it = iter(values)
    if physical == Type.INT96:
        ns = iter(ns)
        return pa.array([np.datetime64(int(next(ns)), "ns") if ok else None
                         for ok in validity], pa.timestamp("ns"))
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return pa.array([bytes(next(it)) if ok else None for ok in validity],
                        pa.binary(tl))
    if name == "str_dict":
        return pa.array([next(it).decode() if ok else None
                         for ok in validity], pa.string())
    if physical == Type.BYTE_ARRAY:
        return pa.array([next(it) if ok else None for ok in validity],
                        pa.binary())
    full = np.zeros(len(validity), np.asarray(values).dtype)
    full[validity] = values
    return pa.array(full, mask=~validity)


def _arrow_table(data: dict, names) -> pa.Table:
    cols = {}
    for name in names:
        values, validity = data[name]
        ns = data.get(name + "_ns")
        if ns is not None and validity is not None:
            ns = ns[validity]
        cols[name] = _arrow_array(name, values, validity, ns)
    return pa.table(cols)


def _offsets(items) -> tuple:
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offs[1:])
    return np.frombuffer(b"".join(items), np.uint8), offs


def _write(writer: str, data: dict, version: int, codec: str) -> tuple:
    names = [n for n, spec in COLUMNS.items() if writer in spec[3]]
    dict_cols = [n for n in names if COLUMNS[n][2] == "DICT"]
    forced = {n: COLUMNS[n][2] for n in names if n not in dict_cols}
    buf = io.BytesIO()
    if writer == "pyarrow":
        papq.write_table(
            _arrow_table(data, names), buf, compression=codec,
            data_page_version=f"{version}.0", row_group_size=ROW_GROUP,
            data_page_size=PAGE, use_dictionary=dict_cols,
            column_encoding=forced, use_deprecated_int96_timestamps=True,
            write_statistics=False)
    elif writer == "jax":
        from parquet_tpu.format.enums import Encoding as JEncoding

        jwrite_table(_arrow_table(data, names), buf, JWriterOptions(
            compression=codec, data_page_version=version,
            row_group_size=ROW_GROUP, data_page_size=PAGE,
            dictionary=dict_cols, write_statistics=False,
            write_page_index=False,
            column_encoding={n: JEncoding[e] for n, e in forced.items()}))
    else:
        leaves, table = [], {}
        for n in names:
            physical, tl, enc, _ = COLUMNS[n]
            values, validity = data[n]
            rep = 0 if validity is None else 1
            leaves.append(Leaf(-1, n, physical, rep, tl,
                               string=n == "str_dict"))
            if physical == Type.BYTE_ARRAY:
                v, o = _offsets(values)
                table[n] = ColumnData(v, validity, o)
            else:
                table[n] = ColumnData(np.asarray(values), validity)
        pqt.write_table(table, buf, pqt.WriterOptions(
            compression=codec, data_page_version=version,
            row_group_size=ROW_GROUP, data_page_size=PAGE,
            write_statistics=False, write_page_index=False,
            column_encoding={n: Encoding[COLUMNS[n][2].replace(
                "DICT", "RLE_DICTIONARY")] for n in names}),
            schema=Schema(leaves))
    return buf.getvalue(), names


def _port_host(col) -> tuple:
    got = col.materialize_host()
    if isinstance(got, tuple):
        return got[0], got[1].astype(np.int64)
    return got, None


def _jax_host(col, physical) -> tuple:
    if col.is_dictionary_encoded():
        col.materialize_host()
    values = np.asarray(col.values)
    if col.offsets is not None:
        return values, np.asarray(col.offsets).astype(np.int64)
    if values.ndim == 2 and values.dtype == np.uint32:  # uint32 pairs/INT96
        values = values.view(np.int32 if physical == Type.INT96
                             else _NP[physical])
        if physical != Type.INT96:
            values = values.reshape(-1)
    return values, None


def _expected(name: str, values) -> tuple:
    physical = COLUMNS[name][0]
    if physical == Type.BYTE_ARRAY:
        return _offsets(values)
    return np.asarray(values), None


def _same(got: tuple, want: tuple, what: str) -> None:
    gv, go = got
    wv, wo = want
    assert (go is None) == (wo is None), what
    if go is not None:
        np.testing.assert_array_equal(go, wo, err_msg=what)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape, (
        what, gv.dtype, wv.dtype, gv.shape, wv.shape)
    np.testing.assert_array_equal(gv.view(np.uint8), wv.view(np.uint8),
                                  err_msg=what)


def _same_validity(port_col, validity, what: str) -> None:
    if validity is None or validity.all():
        assert port_col.validity is None or bool(port_col.validity.all())
    else:
        np.testing.assert_array_equal(port_col.validity.numpy(), validity,
                                      err_msg=what)


DEVICE_ROUTES = ("PARQUET_TPU_PLAIN_RUNS", "PARQUET_TPU_DICT_RUNS",
                 "PARQUET_TPU_DELTA_RUNS", "PARQUET_TPU_BSS_RUNS",
                 "PARQUET_TPU_DBA_RUNS")


def _jax_reads(data: bytes, monkeypatch) -> dict:
    """parquet_tpu's host read and its device read through its host and
    through its device routes."""
    f = parquet_tpu.ParquetFile(data)
    reads = {"host": f.read(device=False),
             "device/host-routes": f.read(device=True)}
    with monkeypatch.context() as m:
        for var in DEVICE_ROUTES:
            m.setenv(var, "device")
        m.setenv("PARQUET_TPU_PALLAS", "pallas")
        reads["device/device-routes"] = f.read(device=True)
    return reads


@pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("nulls", ["required", "optional"])
@pytest.mark.parametrize("writer", ["pyarrow", "jax", "port"])
def test_read_matches_jax(writer, nulls, version, codec, monkeypatch):
    seed = zlib.crc32(f"{nulls}".encode())
    data = _generate(nulls, seed)
    raw, names = _write(writer, data, version, codec)
    port = pqt.ParquetFile(raw).read(device="cpu")
    assert list(port) == names
    reads = _jax_reads(raw, monkeypatch)
    for name in names:
        physical = COLUMNS[name][0]
        values, validity = data[name]
        got = _port_host(port[name])
        _same(got, _expected(name, values), f"{name}: generated")
        _same_validity(port[name], validity, name)
        assert port[name].values is None or \
            port[name].values.device.type == "cpu"
        for route, cols in reads.items():
            _same(got, _jax_host(cols[name], physical), f"{name}: {route}")
            jvalid = cols[name].validity
            _same_validity(port[name], None if jvalid is None
                           else np.asarray(jvalid), f"{name}: {route}")


@pytest.mark.parametrize("codec", ["gzip", "lz4_raw", "lz4", "brotli"])
def test_every_codec_reads_as_jax(codec):
    """The remaining codecs on one file of every column (the JAX writer,
    whose LZ4 is LZ4_RAW; the port's writer for the Hadoop framing)."""
    data = _generate("optional", 11)
    writer = "port" if codec == "lz4" else "jax"
    raw, names = _write(writer, data, 1, codec)
    port = pqt.ParquetFile(raw).read(device="cpu")
    host = parquet_tpu.ParquetFile(raw).read(device=False)
    for name in names:
        _same(_port_host(port[name]), _jax_host(host[name],
                                                COLUMNS[name][0]), name)


def test_byte_array_dictionaries_stay_encoded_across_row_groups():
    """A BYTE_ARRAY dictionary column of several row groups reads as one
    encoded column (dictionaries concatenated, indexes rebased), equal to
    the JAX device route's; a chunk of every other kind is dense."""
    data = _generate("required", 3)
    raw, _ = _write("pyarrow", data, 1, "snappy")
    col = pqt.ParquetFile(raw).read(device="cpu")["ba_dict"]
    assert col.is_dictionary_encoded() and col.dict_indices.dtype == \
        torch.int32
    jcol = parquet_tpu.ParquetFile(raw).read(device=True)["ba_dict"]
    assert jcol.is_dictionary_encoded()
    np.testing.assert_array_equal(col.dict_indices.numpy(),
                                  np.asarray(jcol.dict_indices))
    dv, do = col.dictionary
    jv, jo = jcol._host_dictionary()
    np.testing.assert_array_equal(dv.numpy(), jv)
    np.testing.assert_array_equal(do.numpy(), jo)
    assert col.num_values == ROWS


def test_dense_dictionary_routes():
    """High-cardinality BYTE_ARRAY and FLBA dictionaries (every index run
    bit-packed) take ``unpack_bits_dense`` and, for FLBA, a gather; a
    BYTE_ARRAY chunk keeps its indexes encoded."""
    rng = np.random.default_rng(8)
    n = 20_000
    names = np.array([f"name-{i:04d}".encode() for i in range(1000)],
                     dtype=object)
    pool = rng.integers(0, 256, (500, 16), dtype=np.uint8)
    table = {"s": names[rng.integers(0, 1000, n)],
             "f": pool[rng.integers(0, 500, n)]}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        compression="snappy", column_encoding={
            "s": Encoding.RLE_DICTIONARY, "f": Encoding.RLE_DICTIONARY}))
    f = pqt.ParquetFile(buf.getvalue())
    pqt.reset_launches()
    for i, name in enumerate(table):
        plan = tdr.build_plan(f.row_groups[0].column(i))
        assert plan.dense_ok and plan.dense_w == (10 if name == "s" else 9)
        staged = tdr.stage_plan(plan, torch.device("cpu"))
        col = tdr.decode_staged(plan, staged, torch.device("cpu"))
        got = col.materialize_host()
        if name == "s":
            v, o = got
            assert [bytes(v[o[i]:o[i + 1]]) for i in range(n)] == list(
                table["s"])
        else:
            np.testing.assert_array_equal(got, table["f"])
    # the CPU runs the plain versions, which count no launches
    assert pqt.LAUNCHES["unpack_bits_dense"] == 0


def test_mini_lineitem_matches_jax():
    """``bench.py``'s lineitem schema, 20,000 rows in 8,192-row row groups,
    written by pyarrow with Snappy and the four categoricals
    dictionary-encoded."""
    n = 20_000
    rng = np.random.default_rng(42)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    comments = letters[rng.integers(0, 27, n * 27)].reshape(n, 27)
    flags = np.array(["A", "N", "R"])
    status = np.array(["F", "O"])
    instr = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                      "TAKE BACK RETURN"])
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"])
    ship = rng.integers(8000, 12000, n).astype(np.int32)
    t = pa.table({
        "l_orderkey": np.sort(rng.integers(1, n, n)).astype(np.int64),
        "l_partkey": rng.integers(1, 200_000, n).astype(np.int64),
        "l_suppkey": rng.integers(1, 10_000, n).astype(np.int64),
        "l_linenumber": rng.integers(1, 8, n).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
        "l_extendedprice": rng.random(n) * 1e5,
        "l_discount": np.round(rng.random(n) * 0.1, 2),
        "l_tax": np.round(rng.random(n) * 0.08, 2),
        "l_returnflag": pa.array(flags[rng.integers(0, 3, n)]),
        "l_linestatus": pa.array(status[rng.integers(0, 2, n)]),
        "l_shipdate": ship,
        "l_commitdate": ship + rng.integers(-30, 30, n).astype(np.int32),
        "l_receiptdate": ship + rng.integers(1, 30, n).astype(np.int32),
        "l_shipinstruct": pa.array(instr[rng.integers(0, 4, n)]),
        "l_shipmode": pa.array(modes[rng.integers(0, 7, n)]),
        "l_comment": pa.array([r.tobytes().decode() for r in comments]),
    })
    buf = io.BytesIO()
    papq.write_table(t, buf, compression="snappy", row_group_size=8192,
                     data_page_size=1 << 20, write_page_index=True,
                     use_dictionary=["l_returnflag", "l_linestatus",
                                     "l_shipinstruct", "l_shipmode"])
    raw = buf.getvalue()
    port = pqt.ParquetFile(raw).read(device="cpu")
    jax_dev = parquet_tpu.ParquetFile(raw).read(device=True)
    host = parquet_tpu.ParquetFile(raw).read(device=False)
    for name in t.column_names:
        got = _port_host(port[name])
        physical = port[name].leaf.physical_type
        for cols in (jax_dev, host):
            _same(got, _jax_host(cols[name], physical), name)
        if physical == Type.BYTE_ARRAY:
            v, o = got
            want = [x.encode() for x in t[name].to_pylist()]
            assert [bytes(v[o[i]:o[i + 1]]) for i in range(n)] == want
            assert port[name].leaf.string
        else:
            np.testing.assert_array_equal(got[0], t[name].to_numpy())


def test_later_slices_raise():
    """What earlier slices refused now reads: a nested column, and a chunk
    that falls back from dictionary to PLAIN pages mid-chunk, which takes
    the host decode and is counted; and the point lookup over that
    byte-array column, whose hits equal a numpy oracle's rows."""
    buf = io.BytesIO()
    papq.write_table(pa.table({"l": pa.array([[1, 2], None, [3]])}), buf)
    col = pqt.ParquetFile(buf.getvalue()).read(device="cpu")[
        "l.list.element"]
    np.testing.assert_array_equal(col.values.numpy(), [1, 2, 3])
    np.testing.assert_array_equal(col.list_offsets[0].numpy(), [0, 2, 2, 3])
    np.testing.assert_array_equal(col.list_validity[0].numpy(),
                                  [True, False, True])
    rng = np.random.default_rng(1)
    items = [bytes(rng.integers(0, 256, 20, dtype=np.uint8))
             for _ in range(5000)]
    buf = io.BytesIO()
    papq.write_table(pa.table({"s": pa.array(items)}), buf,
                     dictionary_pagesize_limit=2000, data_page_size=1000)
    meta = papq.ParquetFile(io.BytesIO(buf.getvalue())).metadata
    assert {"PLAIN", "RLE_DICTIONARY"} <= set(
        meta.row_group(0).column(0).encodings)
    pqt.reset_host_route()
    v, o = pqt.ParquetFile(buf.getvalue()).read(device="cpu")[
        "s"].materialize_host()
    assert pqt.HOST_ROUTE["mixed_page_kinds"] == 1
    assert sum(pqt.HOST_ROUTE.values()) == 1
    assert [bytes(v[o[i]:o[i + 1]]) for i in range(len(items))] == items
    keys = [items[7], b"x", items[4999]]
    res = pqt.ParquetFile(buf.getvalue()).find_rows("s", keys, columns=["s"],
                                                    device="cpu")
    for h, key in zip(res, keys):
        rows = [i for i, v in enumerate(items) if v == key]
        np.testing.assert_array_equal(h.rows, rows)
        assert h.values["s"] == [key] * len(rows)


@pytest.mark.parametrize("case", ["bit_packed_levels", "v2_raw_values",
                                  "bss_int96", "dba_nonzero_first_prefix"])
def test_page_shapes_at_the_edge(case):
    """Legacy BIT_PACKED definition levels decode (validity on the host); a
    v2 page whose values are not compressed (``is_compressed=false``)
    decodes raw under a real codec; the device route refuses byte-stream
    split over INT96 and a front-coded page whose first prefix is nonzero,
    as the JAX package's does: the host decode reads the first and finds
    the second corrupt (its first value's prefix reaches into a value
    before the page)."""
    from parquet_tpu_torch.codecs import get_codec
    from parquet_tpu_torch.format import metadata as md
    from parquet_tpu_torch.io.reader import PageInfo

    n = 100
    rng = np.random.default_rng(2)
    if case == "bit_packed_levels":
        levels = (rng.random(n) < 0.7).astype(np.int64)
        values = rng.integers(0, 1000, int(levels.sum())).astype(np.int32)
        body = tref.encode_bit_packed_levels(levels, 1) + values.tobytes()
        leaf = Leaf(0, "x", Type.INT32, 1)
        enc, def_enc = Encoding.PLAIN, Encoding.BIT_PACKED
    elif case == "v2_raw_values":
        levels = (rng.random(n) < 0.7).astype(np.int64)
        values = rng.integers(0, 1000, int(levels.sum())).astype(np.int32)
        rle = tref.encode_rle(levels, 1)
        body = rle + values.tobytes()
        header = md.PageHeader(
            type=3, uncompressed_page_size=len(body),
            compressed_page_size=len(body),
            data_page_header_v2=md.DataPageHeaderV2(
                num_values=n, num_nulls=n - len(values), num_rows=n,
                encoding=int(Encoding.PLAIN),
                definition_levels_byte_length=len(rle),
                repetition_levels_byte_length=0, is_compressed=False))
        chunk = SimpleNamespace(
            leaf=Leaf(0, "x", Type.INT32, 1), codec=get_codec(1),  # SNAPPY
            meta=md.ColumnMetaData(type=int(Type.INT32)))
        plan = tdr.build_plan(chunk, pages=[PageInfo(header, body, 0)])
        col = tdr.decode_staged(plan, tdr.stage_plan(
            plan, torch.device("cpu")), torch.device("cpu"))
        np.testing.assert_array_equal(col.validity.numpy(), levels == 1)
        np.testing.assert_array_equal(col.values.numpy(), values)
        return
    elif case == "bss_int96":
        body = rng.integers(0, 256, 12 * n, dtype=np.uint8).tobytes()
        leaf = Leaf(0, "x", Type.INT96, 0)
        enc, def_enc = Encoding.BYTE_STREAM_SPLIT, Encoding.RLE
    else:
        body = (tref.encode_delta_binary_packed(np.full(n, 2)) +
                tref.encode_delta_length_byte_array(
                    np.zeros(n, np.uint8), np.arange(n + 1)))
        leaf = Leaf(0, "x", Type.BYTE_ARRAY, 0)
        enc, def_enc = Encoding.DELTA_BYTE_ARRAY, Encoding.RLE
    header = md.PageHeader(
        type=0, uncompressed_page_size=len(body),
        compressed_page_size=len(body), data_page_header=md.DataPageHeader(
            num_values=n, encoding=int(enc),
            definition_level_encoding=int(def_enc),
            repetition_level_encoding=int(Encoding.RLE)))
    page = PageInfo(header=header, payload=body, offset=0)
    chunk = SimpleNamespace(
        leaf=leaf, codec=get_codec(0),
        meta=md.ColumnMetaData(type=int(leaf.physical_type)))
    if case != "bit_packed_levels":
        from parquet_tpu_torch.errors import CorruptedError, _Unsupported
        from parquet_tpu_torch.io.reader import decode_chunk_host

        with pytest.raises(_Unsupported) as refused:
            tdr.build_plan(chunk, pages=[page])
        assert refused.value.reason == {"bss_int96": "bss_int96"}.get(
            case, "dba_first_prefix")
        if case == "bss_int96":
            col = decode_chunk_host(chunk, "cpu", pages=[page])
            np.testing.assert_array_equal(
                col.values.numpy().view(np.uint8).reshape(n, 12),
                np.frombuffer(body, np.uint8).reshape(12, n).T)
        else:
            with pytest.raises(CorruptedError, match="prefix longer"):
                decode_chunk_host(chunk, "cpu", pages=[page])
        return
    plan = tdr.build_plan(chunk, pages=[page])
    col = tdr.decode_staged(plan, tdr.stage_plan(plan, torch.device("cpu")),
                            torch.device("cpu"))
    np.testing.assert_array_equal(col.validity.numpy(), levels == 1)
    np.testing.assert_array_equal(col.values.numpy(), values)


def test_torch_ops_match_jax(rng):
    """byte_stream_split, the front-coded expansion with its rounds, the
    boolean run expansion and cumsum_offsets against their JAX
    counterparts on the same bytes."""
    from parquet_tpu.ops import device as jdev

    n = 777
    raw = rng.integers(0, 256, 8 * n, dtype=np.uint8)
    for width, dt, jdt in ((4, torch.float32, "float32"),
                           (4, torch.int32, "int32"), (8, None, None),
                           (2, None, None)):
        want = np.asarray(jdev.byte_stream_split(raw, n, width, jdt))
        got = tdev.byte_stream_split(torch.from_numpy(raw), n, width, dt)
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8))
    # a chain of thousands of nonzero prefixes
    items = [b"https://example.com/" + b"a" * (i % 50) + str(i).encode()
             for i in range(3000)]
    items.sort()
    vals = np.frombuffer(b"".join(items), np.uint8)
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offs[1:])
    enc = np.frombuffer(tref.encode_delta_byte_array(vals, offs), np.uint8)
    plens, suffixes, soffs, _ = tdev.delta_byte_array_prescan(enc, 0)
    iters = tdev.delta_byte_array_iters(plens)
    assert iters == jdev.delta_byte_array_iters(plens) >= 11
    eoffs = np.zeros(len(items) + 1, np.int64)
    np.cumsum(plens + np.diff(soffs), out=eoffs[1:])
    want = np.asarray(jdev.delta_byte_array_expand(
        suffixes, plens.astype(np.int32), soffs[:-1].astype(np.int32),
        eoffs.astype(np.int32), int(eoffs[-1]), iters))
    got = tdev.delta_byte_array_expand(
        torch.from_numpy(suffixes.copy()), torch.from_numpy(plens),
        torch.from_numpy(soffs[:-1].copy()), torch.from_numpy(eoffs),
        int(eoffs[-1]), iters)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), vals)
    lengths = rng.integers(0, 9, 50)
    np.testing.assert_array_equal(
        tdev.cumsum_offsets(torch.from_numpy(lengths)).numpy(),
        np.asarray(jdev.cumsum_offsets(lengths)))
