"""The host-decode route: every chunk kind the port's device route refuses.

For each reason in ``device_reader.HOST_ROUTE`` a small file makes the
device route raise ``_Unsupported``; the read sends the chunk to
``io/reader.decode_chunk_host``, counts it under that reason, and gives
the data that made the file, and where the JAX package reads the file,
its host read's result, exactly.  No other exception takes the route.  The
files come from pyarrow, from the port's writer (delta pages of two
miniblock sizes), or are put together page by page here (levels and page
encodings no writer at hand makes); the stream bound is lowered with
``monkeypatch``.  The committed fixture that ``chip_smoke.py`` reads on the
card reads here too.
"""

import io
import os
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.format import metadata as md
from parquet_tpu_torch.format import thrift
from parquet_tpu_torch.format.enums import Encoding, PageType, Type
from parquet_tpu_torch.ops import device as tdev
from parquet_tpu_torch.ops import levels as tlevels
from parquet_tpu_torch.ops import ref as tref
from parquet_tpu_torch.parallel import device_reader as tdr
from parquet_tpu_torch.schema import schema as S

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")


@pytest.fixture(autouse=True)
def _fresh_counter():
    pqt.reset_host_route()
    yield
    pqt.reset_host_route()


def _only(reason: str, count: int) -> None:
    assert pqt.HOST_ROUTE[reason] == count, pqt.HOST_ROUTE
    assert sum(pqt.HOST_ROUTE.values()) == count, pqt.HOST_ROUTE


def _file_of(schema, pages, num_rows: int) -> bytes:
    """A one-chunk, one-row-group UNCOMPRESSED file of ``pages``
    (``(PageHeader, body)`` pairs) for ``schema``'s single leaf."""
    leaf = schema.leaves[0]
    out = bytearray(md.MAGIC)
    start = len(out)
    slots = 0
    for header, body in pages:
        out += thrift.serialize(header) + body
        slots += (header.data_page_header
                  or header.data_page_header_v2).num_values
    size = len(out) - start
    meta = md.ColumnMetaData(
        type=int(leaf.physical_type), encodings=[0, 3],
        path_in_schema=list(leaf.path), codec=0, num_values=slots,
        total_uncompressed_size=size, total_compressed_size=size,
        data_page_offset=start)
    rg = md.RowGroup(columns=[md.ColumnChunk(file_offset=start,
                                             meta_data=meta)],
                     total_byte_size=size, num_rows=num_rows)
    blob = thrift.serialize(md.FileMetaData(
        version=1, schema=schema.to_elements(), num_rows=num_rows,
        row_groups=[rg]))
    out += blob + struct.pack("<I", len(blob)) + md.MAGIC
    return bytes(out)


def _v1(n: int, body: bytes, encoding: Encoding,
        def_encoding: Encoding = Encoding.RLE,
        rep_encoding: Encoding = Encoding.RLE):
    return md.PageHeader(
        type=int(PageType.DATA_PAGE), uncompressed_page_size=len(body),
        compressed_page_size=len(body), data_page_header=md.DataPageHeader(
            num_values=n, encoding=int(encoding),
            definition_level_encoding=int(def_encoding),
            repetition_level_encoding=int(rep_encoding))), body


def _prefixed(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _same_as_jax_host(raw: bytes, port: dict) -> None:
    """Each leaf of the port's read against the JAX package's host read:
    values, validity, list offsets and list validity."""
    ref = parquet_tpu.ParquetFile(raw).read(device=False)
    for name, col in port.items():
        r = ref[name]
        if r.is_dictionary_encoded():
            r.materialize_host()
        got = col.materialize_host()
        values = got["values"] if isinstance(got, dict) else got
        if isinstance(values, tuple):
            np.testing.assert_array_equal(values[0], np.asarray(r.values))
            np.testing.assert_array_equal(values[1],
                                          np.asarray(r.offsets, np.int64))
        else:
            want = np.asarray(r.values)
            if want.ndim == 2 and want.dtype == np.uint32:
                want = want.view(values.dtype).reshape(values.shape)
            np.testing.assert_array_equal(values, want, err_msg=name)
        if r.validity is None or col.validity is None:
            for v in (r.validity, col.validity):
                assert v is None or bool(np.asarray(v).all()), name
        else:
            np.testing.assert_array_equal(col.validity.numpy(),
                                          np.asarray(r.validity))
        for k, o in enumerate(col.list_offsets):
            np.testing.assert_array_equal(
                o.numpy(), np.asarray(r.list_offsets[k], np.int64))
            np.testing.assert_array_equal(col.list_validity[k].numpy(),
                                          np.asarray(r.list_validity[k]))


def _mixed_kind_chunks(f) -> int:
    """Chunks whose data pages mix dictionary and other encodings, read
    from the page headers."""
    count = 0
    dict_encs = {Encoding.RLE_DICTIONARY, Encoding.PLAIN_DICTIONARY}
    for rg in f.row_groups:
        for i in range(len(f.schema.leaves)):
            kinds = set()
            for p in rg.column(i).pages():
                h = p.header.data_page_header or p.header.data_page_header_v2
                if h is not None:
                    kinds.add(Encoding(h.encoding) in dict_encs)
            count += kinds == {True, False}
    return count


def test_mixed_page_kinds():
    """Dictionaries that overflow into PLAIN pages mid-chunk, flat and in a
    list, in two row groups."""
    rng = np.random.default_rng(3)
    n = 3000
    lists = [None if rng.random() < 0.05 else
             [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(0, 1 << 40, int(rng.integers(0, 4)))]
             for _ in range(n)]
    t = pa.table({"k": rng.integers(0, 1 << 40, n),
                  "l": pa.array(lists, pa.list_(pa.int64())),
                  "s": pa.array([bytes(rng.integers(97, 123, 12,
                                                    dtype=np.uint8))
                                 for _ in range(n)])})
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=1500, data_page_size=2048,
                     dictionary_pagesize_limit=2048)
    raw = buf.getvalue()
    f = pqt.ParquetFile(raw)
    expected = _mixed_kind_chunks(f)
    assert expected == 6
    port = f.read(device="cpu")
    _only("mixed_page_kinds", expected)
    _same_as_jax_host(raw, port)
    assert port["k"].values.numpy().tolist() == t.column("k").to_pylist()


def test_mixed_level_encodings():
    """One page of RLE and one of legacy BIT_PACKED def levels."""
    rng = np.random.default_rng(4)
    n = 200
    valid = rng.random(2 * n) > 0.3
    values = rng.integers(-1000, 1000, int(valid.sum())).astype(np.int32)
    v0 = int(valid[:n].sum())
    p1 = _prefixed(tref.encode_rle(valid[:n].astype(np.int64), 1)) + \
        values[:v0].tobytes()
    p2 = tref.encode_bit_packed_levels(valid[n:].astype(np.int64), 1) + \
        values[v0:].tobytes()
    schema = S.message("m", [S.optional(S.leaf("x", Type.INT32))])
    raw = _file_of(schema, [_v1(n, p1, Encoding.PLAIN),
                            _v1(n, p2, Encoding.PLAIN, Encoding.BIT_PACKED)],
                   2 * n)
    port = pqt.ParquetFile(raw).read(device="cpu")
    _only("mixed_level_encodings", 1)
    np.testing.assert_array_equal(port["x"].values.numpy(), values)
    np.testing.assert_array_equal(port["x"].validity.numpy(), valid)
    _same_as_jax_host(raw, port)


def test_bit_packed_repeated_levels():
    """A list column whose v1 pages carry RLE repetition levels and legacy
    BIT_PACKED definition levels."""
    rng = np.random.default_rng(5)
    schema = S.message("m", [S.list_of("l", S.optional(S.leaf(
        "e", Type.INT64)))])
    leaf = schema.leaves[0]
    rows = 300
    lv = rng.random(rows) > 0.1
    lens = np.where(lv, rng.integers(0, 4, rows), 0)
    offs = np.zeros(rows + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    ev = rng.random(int(offs[-1])) > 0.2
    values = rng.integers(0, 1 << 50, int(ev.sum()))
    d, r = tlevels.levels_for_list(offs, lv, ev, leaf)
    body = _prefixed(tref.encode_rle(r.astype(np.int64), 1)) + \
        tref.encode_bit_packed_levels(d.astype(np.int64), 2) + \
        values.tobytes()
    raw = _file_of(schema, [_v1(len(d), body, Encoding.PLAIN,
                                Encoding.BIT_PACKED)], rows)
    col = pqt.ParquetFile(raw).read(device="cpu")["l.list.element"]
    _only("bit_packed_repeated_levels", 1)
    np.testing.assert_array_equal(col.values.numpy(), values)
    np.testing.assert_array_equal(col.validity.numpy(), ev)
    np.testing.assert_array_equal(col.list_offsets[0].numpy(), offs)
    np.testing.assert_array_equal(col.list_validity[0].numpy(), lv)
    _same_as_jax_host(raw, {"l.list.element": col})


def test_bss_int96():
    """Byte-stream-split INT96 values: the host decode reads them; the JAX
    package's host read raises (ROADMAP queue C)."""
    rng = np.random.default_rng(6)
    n = 150
    values = rng.integers(-2**31, 2**31, (n, 3)).astype(np.int32)
    body = tref.encode_byte_stream_split(values.view(np.uint8), n, 12)
    schema = S.message("m", [S.leaf("x", Type.INT96)])
    raw = _file_of(schema, [_v1(n, body, Encoding.BYTE_STREAM_SPLIT)], n)
    col = pqt.ParquetFile(raw).read(device="cpu")["x"]
    _only("bss_int96", 1)
    np.testing.assert_array_equal(col.values.numpy(), values)
    with pytest.raises(Exception, match="NoneType"):
        parquet_tpu.ParquetFile(raw).read(device=False)


def test_dba_first_prefix():
    """A front-coded page whose first value claims a prefix: the device
    route refuses it and the host decode finds it corrupt (the value
    before the page's first is empty).  The JAX package's host read
    returns bytes it never wrote there (ROADMAP queue C)."""
    n = 100
    body = (tref.encode_delta_binary_packed(np.full(n, 2)) +
            tref.encode_delta_length_byte_array(
                np.zeros(n, np.uint8), np.arange(n + 1)))
    schema = S.message("m", [S.leaf("x", Type.BYTE_ARRAY)])
    raw = _file_of(schema, [_v1(n, body, Encoding.DELTA_BYTE_ARRAY)], n)
    with pytest.raises(CorruptedError, match="prefix longer"):
        pqt.ParquetFile(raw).read(device="cpu")
    _only("dba_first_prefix", 1)
    ref = parquet_tpu.ParquetFile(raw).read(device=False)["x"]
    assert np.asarray(ref.offsets).tolist() == list(range(0, 3 * n + 1, 3))


def test_stream_bound(monkeypatch):
    """Every chunk whose staged stream is over ``MAX_DEVICE_BUF`` (lowered
    to 0 bytes here) decodes on the host: flat, dictionary, delta and
    nested columns."""
    rng = np.random.default_rng(7)
    n = 1200
    t = pa.table({
        "a": rng.integers(0, 50, n),
        "b": pa.array(rng.random(n), mask=rng.random(n) < 0.1),
        "l": pa.array([[int(v) for v in rng.integers(0, 9, int(k))]
                       for k in rng.integers(0, 4, n)],
                      pa.list_(pa.int32()))})
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=600, data_page_size=1024,
                     use_dictionary=["a"],
                     column_encoding={"l.list.element":
                                      "DELTA_BINARY_PACKED"})
    raw = buf.getvalue()
    monkeypatch.setattr(tdev, "MAX_DEVICE_BUF", 0)
    port = pqt.ParquetFile(raw).read(device="cpu")
    _only("stream_bound", 6)
    _same_as_jax_host(raw, port)


def test_mixed_delta_vpm(monkeypatch):
    """Delta pages of 32- and 64-value miniblocks in one chunk (the port's
    writer, its encoder alternating block layouts page by page)."""
    from parquet_tpu_torch.io import writer as twriter

    real = tref.encode_delta_binary_packed
    calls = []

    def alternating(values, block_size=128, n_miniblocks=4):
        calls.append(1)
        if len(calls) % 2:
            return real(values, 256, 4)
        return real(values, block_size, n_miniblocks)

    monkeypatch.setattr(twriter.ref, "encode_delta_binary_packed",
                        alternating)
    rng = np.random.default_rng(8)
    n = 3000
    ts = np.cumsum(rng.integers(0, 1000, n)).astype(np.int64)
    buf = io.BytesIO()
    pqt.write_table({"ts": ts}, buf, pqt.WriterOptions(
        row_group_size=1500, data_page_size=4096,
        column_encoding={"ts": Encoding.DELTA_BINARY_PACKED}))
    monkeypatch.setattr(twriter.ref, "encode_delta_binary_packed", real)
    raw = buf.getvalue()
    col = pqt.ParquetFile(raw).read(device="cpu")["ts"]
    _only("mixed_delta_vpm", 2)
    np.testing.assert_array_equal(col.values.numpy(), ts)
    _same_as_jax_host(raw, {"ts": col})


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: launch "
                                                "failed"),
                                   CorruptedError("bad page"),
                                   NotImplementedError("later slice")])
def test_only_unsupported_takes_the_route(error, monkeypatch):
    """A kernel or CUDA failure, a corrupt chunk or a plain refusal raise
    out of the read; none is sent to the host decode."""
    buf = io.BytesIO()
    pqt.write_table({"x": np.arange(100)}, buf)

    def fail(*args, **kwargs):
        raise error

    monkeypatch.setattr(tdr, "stage_plan", fail)
    with pytest.raises(type(error)):
        pqt.ParquetFile(buf.getvalue()).read(device="cpu")
    assert sum(pqt.HOST_ROUTE.values()) == 0


def test_committed_fixture():
    """``torch_fixtures/host_route.parquet`` (``make_host_route.py``, the
    file ``chip_smoke.py`` reads on the card) equals the arrays beside it
    and the JAX package's host read; each of its chunks takes the host
    decode, once."""
    raw = open(os.path.join(FIXTURES, "host_route.parquet"), "rb").read()
    want = np.load(os.path.join(FIXTURES, "host_route.npz"))
    port = pqt.ParquetFile(raw).read(device="cpu")
    _only("mixed_page_kinds", int(want["host_route_chunks"]))
    _same_as_jax_host(raw, port)
    np.testing.assert_array_equal(port["k"].values.numpy(), want["k"])
    v, o = port["s"].materialize_host()
    np.testing.assert_array_equal(v, want["s_values"])
    np.testing.assert_array_equal(o, want["s_offsets"])
    col = port["l.list.element"]
    for got, key in ((col.values, "l_values"), (col.validity, "l_validity"),
                     (col.list_offsets[0], "l_offsets"),
                     (col.list_validity[0], "l_list_validity")):
        np.testing.assert_array_equal(got.numpy(), want[key])


def test_committed_fixture_is_what_the_script_writes(tmp_path):
    """The script behind the fixture makes the committed arrays, and its
    pyarrow file reads as the committed one does."""
    import sys

    sys.path.insert(0, FIXTURES)
    try:
        import make_host_route
    finally:
        sys.path.remove(FIXTURES)
    arrays = make_host_route.make()
    want = np.load(os.path.join(FIXTURES, "host_route.npz"))
    for key, a in arrays.items():
        np.testing.assert_array_equal(a, want[key])
    path = str(tmp_path / "again.parquet")
    make_host_route.write(path, arrays)
    again = pqt.ParquetFile(path).read(device="cpu")
    committed = pqt.ParquetFile(os.path.join(
        FIXTURES, "host_route.parquet")).read(device="cpu")
    for name in again:
        a, b = again[name].materialize_host(), committed[name].materialize_host()
        a = a["values"] if isinstance(a, dict) else a
        b = b["values"] if isinstance(b, dict) else b
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


def test_lookup_span_takes_the_route():
    """A point lookup whose key column's dictionary overflows into PLAIN
    pages decodes those page spans on the host, counted, with the same
    rows as a numpy oracle."""
    rng = np.random.default_rng(9)
    n = 4000
    k = np.sort(rng.integers(0, 1 << 40, n))
    v = rng.integers(0, 100, n).astype(np.int32)
    buf = io.BytesIO()
    papq.write_table(pa.table({"k": k, "v": v}), buf, row_group_size=2000,
                     data_page_size=1024, dictionary_pagesize_limit=2048,
                     write_page_index=True)
    keys = np.concatenate([k[::97], [-5]])
    res = pqt.ParquetFile(buf.getvalue()).find_rows("k", keys, columns=["v"],
                                                    device="cpu")
    assert pqt.HOST_ROUTE["mixed_page_kinds"] > 0
    assert sum(pqt.HOST_ROUTE.values()) == pqt.HOST_ROUTE["mixed_page_kinds"]
    for key, hit in zip(keys, res.hits):
        rows = np.flatnonzero(k == key)
        np.testing.assert_array_equal(hit.rows, rows)
        np.testing.assert_array_equal(hit.values["v"], v[rows])
