"""The read path's C++ chunk planner and staging fill in parquet_tpu_torch.

``device_reader.build_plan`` plans a chunk's pages in one C++ call
(``host.chunk_plan``); ``device_reader._build_plan_python`` walks them one
at a time in Python.  Both must give the same ``_Plan``, field by field,
over a matrix of encodings x nulls x page versions x codecs x a flat, a
struct-chain and a repeated leaf, on spans of pages, on the chunks the
device route refuses (the same ``_Unsupported``, counted in ``HOST_ROUTE``)
and on the one shape the C++ leaves to the Python walk (counted in
``PLAN_ROUTE``), and must raise the same ``CorruptedError`` on every cut
of a page and on a length stream that claims more values than its page.
The staging fill (``host.fill_batch``) must write what the numpy loop it
replaced wrote, and the pipelined read must equal the serial read and the
JAX package's reads.  Files stay small (tens of rows a
page), pools at two workers; every test ends with the threads it started
with.
"""

import io
import struct
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu

import parquet_tpu_torch as pqt
from parquet_tpu_torch.codecs import get_codec
from parquet_tpu_torch.errors import CorruptedError, _Unsupported
from parquet_tpu_torch.format import metadata as md
from parquet_tpu_torch.format.enums import Encoding, PageType, Type
from parquet_tpu_torch.io.column import concat_columns
from parquet_tpu_torch.io.reader import PageInfo
from parquet_tpu_torch.ops import host
from parquet_tpu_torch.ops import ref as tref
from parquet_tpu_torch.parallel import device_reader as tdr
from parquet_tpu_torch.schema.schema import Leaf
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_counters():
    before = threads_now()
    pqt.reset_host_route()
    pqt.reset_plan_route()
    yield
    assert_no_thread_started(before)


def _python_routes() -> int:
    return sum(v for k, v in pqt.PLAN_ROUTE.items()
               if k.startswith("python:"))


# ---------------------------------------------------------------------------
# plan equality
# ---------------------------------------------------------------------------

_ARRAYS = ("dense_pages", "d_firsts", "d_counts", "d_vpms", "d_mb_counts",
           "d_mb_offs", "d_mb_widths", "d_mb_mins", "bss_pages", "dba_plens",
           "dba_soffs", "dba_slens", "hb_lens")
_SCALARS = ("value_kind", "dense_w", "dense_ok", "d_vpm", "total_slots",
            "total_values", "defs_expanded")


def _same_dictionary(a, b) -> None:
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(a, b)


def _assert_plans_equal(got: tdr._Plan, want: tdr._Plan, what="") -> None:
    """Every field of two plans equal: the byte streams by content, the
    host byte-array parts by their columns and their compacted bytes."""
    for name in _SCALARS:
        assert getattr(got, name) == getattr(want, name), (what, name)
    for name in ("levels", "values", "dense"):
        a, b = getattr(got, name), getattr(want, name)
        assert len(a) == len(b), (what, name)
        np.testing.assert_array_equal(a.array(), b.array(),
                                      err_msg=f"{what} {name}")
    for name in ("def_runs", "rep_runs", "vruns"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.total == b.total, (what, name)
        for x, y in zip(a.run_arrays(), b.run_arrays()):
            assert x.dtype == y.dtype == np.int64, (what, name)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")
    for name in _ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int64, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    if want.host_def is None:
        assert got.host_def is None, what
    else:
        np.testing.assert_array_equal(got.host_def, want.host_def,
                                      err_msg=what)
    np.testing.assert_array_equal(got.hb_parts[:, [0, 2, 3]],
                                  want.hb_parts[:, [0, 2, 3]], err_msg=what)
    for x, y in zip(tdr._host_byte_arrays(got), tdr._host_byte_arrays(want)):
        np.testing.assert_array_equal(x, y, err_msg=what)
    _same_dictionary(got.dictionary_host, want.dictionary_host)


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

ROWS = 240
# name -> (encoding, or "DICT")
COLUMNS = {"i32": "PLAIN", "i64_delta": "DELTA_BINARY_PACKED",
           "i64_dict": "DICT", "f64_bss": "BYTE_STREAM_SPLIT",
           "fixed": "PLAIN", "b_plain": "PLAIN", "b_rle": "RLE",
           "s_dict": "DICT", "s_plain": "PLAIN",
           "s_dlba": "DELTA_LENGTH_BYTE_ARRAY",
           "s_dba": "DELTA_BYTE_ARRAY"}


def _column(rng, name: str, n: int):
    if name == "i32":
        return pa.array(rng.integers(-1000, 1000, n).astype(np.int32))
    if name == "i64_delta":
        return pa.array(np.cumsum(rng.integers(-50, 900, n)))
    if name == "i64_dict":
        return pa.array(rng.integers(0, 30, n) * 10**9)
    if name == "f64_bss":
        return pa.array(rng.standard_normal(n))
    if name == "fixed":
        return pa.array([bytes(r) for r in rng.integers(0, 256, (n, 6),
                                                        dtype=np.uint8)],
                        pa.binary(6))
    if name.startswith("b_"):
        v = rng.random(n) < 0.3
        v[n // 3:n // 2] = True  # a run
        return pa.array(v)
    if name == "s_dba":
        return pa.array(sorted(f"https://h{int(h)}.example/p/{int(p)}"
                               for h, p in zip(rng.integers(0, 3, n),
                                               rng.integers(0, 500, n))))
    words = [f"w{i}-{'z' * (i % 5)}" for i in range(25)]
    return pa.array([words[int(i)] for i in rng.integers(0, 25, n)])


def _matrix_table(shape: str, nulls: bool, seed: int) -> tuple:
    """Each column of :data:`COLUMNS` as a flat, a struct-chain
    (``name.v``) or a repeated (``name.list.element``) leaf; returns the
    table and each leaf's forced encoding."""
    rng = np.random.default_rng(seed)
    cols, forced = {}, {}
    for name, enc in COLUMNS.items():
        n = ROWS * 2 if shape == "list" else ROWS
        arr = _column(rng, name, n)
        if nulls:
            mask = rng.random(n) < 0.15
            mask[:3] = True
            arr = pa.array(arr.to_pylist(), arr.type, mask=mask)
        if shape == "struct":
            mask = pa.array(rng.random(n) < 0.1) if nulls else None
            arr = pa.StructArray.from_arrays([arr], names=["v"], mask=mask)
            path = f"{name}.v"
        elif shape == "list":
            offs = np.concatenate([[0], np.sort(rng.integers(0, n, ROWS - 1)),
                                   [n]]).astype(np.int32)
            mask = pa.array(rng.random(ROWS) < 0.1) if nulls else None
            arr = pa.ListArray.from_arrays(offs, arr, mask=mask)
            path = f"{name}.list.element"
        else:
            path = name
        cols[name] = arr
        if enc != "DICT":
            forced[path] = enc
    return pa.table(cols), forced


def _matrix_file(shape, nulls, version, codec, seed=0) -> bytes:
    table, forced = _matrix_table(shape, nulls, seed)
    dict_cols = [p for p in table.column_names if COLUMNS[p] == "DICT"]
    buf = io.BytesIO()
    papq.write_table(table, buf, compression=codec,
                     data_page_version=f"{version}.0", data_page_size=200,
                     write_batch_size=20, use_dictionary=dict_cols,
                     column_encoding=forced, write_statistics=False)
    return buf.getvalue()


@pytest.mark.parametrize("shape", ["flat", "struct", "list"])
@pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("nulls", [False, True])
def test_native_plan_equals_python_plan(nulls, version, codec, shape):
    f = pqt.ParquetFile(_matrix_file(shape, nulls, version, codec))
    pages = 0
    for leaf in f.schema.leaves:
        reader = f.row_groups[0].column(leaf.column_index)
        pages += len(reader.page_table())
        got = tdr.build_plan(reader)
        want = tdr._build_plan_python(reader)
        _assert_plans_equal(got, want, leaf.name)
        if shape == "struct":
            assert got.host_def is not None and leaf.max_definition_level > 1
    assert pages >= 3 * len(f.schema.leaves)  # tens of rows a page
    assert pqt.PLAN_ROUTE["native"] == len(f.schema.leaves)
    assert _python_routes() == 0


def test_plan_threads_and_nothing_left_to_python(monkeypatch):
    """A chunk of many pages on several native threads plans as on one,
    and a read takes no Python walk (``_build_plan_python`` refuses)."""
    raw = _matrix_file("flat", True, 1, "snappy")
    f = pqt.ParquetFile(raw)
    reader = f.row_groups[0].column(f.schema.leaf("s_dba").column_index)
    one = tdr.build_plan(reader)
    monkeypatch.setattr(host, "plan_threads", lambda nbytes: 4)
    _assert_plans_equal(tdr.build_plan(reader), one)

    def refuse(*a, **k):
        raise AssertionError("the Python walk planned a chunk")

    monkeypatch.setattr(tdr, "_build_plan_python", refuse)
    out = pqt.ParquetFile(raw).read(device="cpu")
    assert set(out) == {leaf.name for leaf in f.schema.leaves}
    assert _python_routes() == 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_reads_plan_alike():
    """A span of a chunk's data pages with the chunk's dictionary, as a
    slice of its page table and as PageInfo objects, plans as the Python
    walk plans the same pages."""
    f = pqt.ParquetFile(_matrix_file("flat", True, 1, "snappy"))
    for name in ("s_dict", "i64_delta", "s_dba", "b_rle"):
        reader = f.row_groups[0].column(f.schema.leaf(name).column_index)
        table = reader.page_table()
        kinds = table.rows[:, host.PG_TYPE]
        data = np.flatnonzero(kinds != PageType.DICTIONARY_PAGE)
        dictionary = None
        if len(data) < len(table):
            dictionary = tdr.decode_dictionary_page(reader, table.info(0))
        span = data[2:7]
        want = tdr._build_plan_python(reader, list(table[span]), dictionary)
        for pages in (table[span], list(table[span])):
            got = tdr.build_plan(reader, pages, dictionary)
            _assert_plans_equal(got, want, name)
            assert got.total_slots == sum(
                int(table.rows[i, host.PG_NVALS]) for i in span)
    assert _python_routes() == 0


# ---------------------------------------------------------------------------
# bail-outs: the device route's refusals and the shapes left to Python
# ---------------------------------------------------------------------------


def _prefixed(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _v1(n, body, enc, def_enc=Encoding.RLE, rep_enc=Encoding.RLE):
    return PageInfo(md.PageHeader(
        type=int(PageType.DATA_PAGE), uncompressed_page_size=len(body),
        compressed_page_size=len(body), data_page_header=md.DataPageHeader(
            num_values=n, encoding=int(enc),
            definition_level_encoding=int(def_enc),
            repetition_level_encoding=int(rep_enc))), body, 0)


def _dict_page(values: np.ndarray):
    body = values.tobytes()
    return PageInfo(md.PageHeader(
        type=int(PageType.DICTIONARY_PAGE), uncompressed_page_size=len(body),
        compressed_page_size=len(body),
        dictionary_page_header=md.DictionaryPageHeader(
            num_values=len(values), encoding=int(Encoding.PLAIN))), body, 0)


def _chunk(leaf):
    return SimpleNamespace(leaf=leaf, codec=get_codec(0),
                           meta=md.ColumnMetaData(type=int(
                               leaf.physical_type)))


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # the error compared, by type and words
        return e


def _bail_cases():
    n = 16
    vals = np.arange(n, dtype=np.int32)
    rle_def = _prefixed(tref.encode_rle(np.ones(n, np.int64), 1))
    packed_def = tref.encode_bit_packed_levels(np.ones(n, np.int64), 1)
    opt = Leaf(0, "x", Type.INT32, 1)
    lst = SimpleNamespace(name="l.list.element", max_definition_level=2,
                          max_repetition_level=1, type_length=None,
                          physical_type=Type.INT32)
    dba = (tref.encode_delta_binary_packed(np.full(n, 2)) +
           tref.encode_delta_length_byte_array(
               np.zeros(n, np.uint8), np.arange(n + 1)))
    idx = tref.encode_rle_dict_indices(np.arange(n) % 4, 2)
    return {
        # (leaf, pages, the route counted, the host route's reason or None)
        "bit_packed_levels": (opt, [_v1(n, packed_def + vals.tobytes(),
                                        Encoding.PLAIN, Encoding.BIT_PACKED)],
                              "python:bit_packed_levels", None),
        "mixed_level_encodings": (
            opt, [_v1(n, rle_def + vals.tobytes(), Encoding.PLAIN),
                  _v1(n, packed_def + vals.tobytes(), Encoding.PLAIN,
                      Encoding.BIT_PACKED)],
            "python:bit_packed_levels", "mixed_level_encodings"),
        "bit_packed_repeated_levels": (
            lst, [_v1(n, b"", Encoding.PLAIN, Encoding.RLE,
                      Encoding.BIT_PACKED)],
            "native", "bit_packed_repeated_levels"),
        "bss_int96": (Leaf(0, "x", Type.INT96, 0),
                      [_v1(n, bytes(12 * n), Encoding.BYTE_STREAM_SPLIT)],
                      "native", "bss_int96"),
        "dba_first_prefix": (Leaf(0, "x", Type.BYTE_ARRAY, 0),
                             [_v1(n, dba, Encoding.DELTA_BYTE_ARRAY)],
                             "native", "dba_first_prefix"),
        "mixed_page_kinds": (Leaf(0, "x", Type.INT32, 0),
                             [_dict_page(vals[:4]),
                              _v1(n, idx, Encoding.RLE_DICTIONARY),
                              _v1(n, vals.tobytes(), Encoding.PLAIN)],
                             "native", "mixed_page_kinds"),
        # errors the C++ reports as the walk raises them
        "encoding": (Leaf(0, "x", Type.INT32, 0),
                     [_v1(n, _prefixed(b"\x20\x01"), Encoding.RLE)],
                     "native", None),
        "level_encoding": (opt, [_v1(n, rle_def + vals.tobytes(),
                                     Encoding.PLAIN, 1)],
                           "native", None),
        "type_length": (Leaf(0, "x", Type.FIXED_LEN_BYTE_ARRAY, 0),
                        [_v1(n, bytes(4 * n), Encoding.PLAIN)],
                        "native", None),
    }


@pytest.mark.parametrize("case", sorted(_bail_cases()))
def test_bail_outs_land_where_the_python_walk_puts_them(case):
    leaf, pages, route, reason = _bail_cases()[case]
    chunk = _chunk(leaf)
    want = _outcome(lambda: tdr._build_plan_python(chunk, pages))
    got = _outcome(lambda: tdr.build_plan(chunk, pages))
    assert pqt.PLAN_ROUTE[route] == 1 and sum(pqt.PLAN_ROUTE.values()) == 1
    if isinstance(want, tdr._Plan):
        _assert_plans_equal(got, want, case)
    else:
        assert type(got) is type(want) and str(got) == str(want), (got, want)
    if reason is not None:
        assert isinstance(got, _Unsupported) and got.reason == reason
    elif route != "python:bit_packed_levels":
        assert not isinstance(got, (tdr._Plan, _Unsupported))


def _one_chunk_file(leaf, pages, num_rows) -> bytes:
    """A one-chunk UNCOMPRESSED file of ``pages`` for a flat ``leaf``."""
    from parquet_tpu_torch.format import thrift
    from parquet_tpu_torch.schema.schema import Schema

    out = bytearray(md.MAGIC)
    start = len(out)
    for p in pages:
        out += thrift.serialize(p.header) + bytes(p.payload)
    size = len(out) - start
    slots = sum(p.num_values for p in pages
                if p.page_type != PageType.DICTIONARY_PAGE)
    meta = md.ColumnMetaData(
        type=int(leaf.physical_type), encodings=[0, 3], path_in_schema=["x"],
        codec=0, num_values=slots, total_uncompressed_size=size,
        total_compressed_size=size, data_page_offset=start)
    rg = md.RowGroup(columns=[md.ColumnChunk(file_offset=start,
                                             meta_data=meta)],
                     total_byte_size=size, num_rows=num_rows)
    blob = thrift.serialize(md.FileMetaData(
        version=1, schema=Schema([leaf]).to_elements(), num_rows=num_rows,
        row_groups=[rg]))
    out += blob + struct.pack("<I", len(blob)) + md.MAGIC
    return bytes(out)


@pytest.mark.parametrize("case", ["bit_packed_levels",
                                  "mixed_level_encodings", "bss_int96",
                                  "dba_first_prefix", "mixed_page_kinds"])
def test_bail_outs_are_counted_by_the_read(case):
    """Read as files: ``HOST_ROUTE`` counts the refused chunk, and
    ``PLAN_ROUTE`` the planner that planned it, each once a read."""
    leaf, pages, route, reason = _bail_cases()[case]
    raw = _one_chunk_file(leaf, pages, sum(
        p.num_values for p in pages
        if p.page_type != PageType.DICTIONARY_PAGE))
    for workers in (0, 2):
        pqt.reset_host_route()
        pqt.reset_plan_route()
        f = pqt.ParquetFile(raw)
        gen = tdr.decode_chunks_pipelined([f.row_groups[0].column(0)], CPU,
                                          workers)
        if case == "dba_first_prefix":  # the host decode finds it corrupt
            with pytest.raises(CorruptedError, match="prefix longer"):
                next(gen)
        else:
            assert next(gen).num_slots == f.row_groups[0].num_rows
        gen.close()
        assert pqt.PLAN_ROUTE[route] == 1
        assert sum(pqt.PLAN_ROUTE.values()) == 1
        assert sum(pqt.HOST_ROUTE.values()) == (reason is not None)
        if reason is not None:
            assert pqt.HOST_ROUTE[reason] == 1


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------


def _cut_pages():
    rng = np.random.default_rng(5)
    n = 40
    levels = (rng.random(n) < 0.8).astype(np.int64)
    k = int(levels.sum())
    rle_def = _prefixed(tref.encode_rle(levels, 1))
    vals = rng.integers(-99, 99, k).astype(np.int32)
    strings = sorted(f"p/{int(x)}".encode() for x in rng.integers(0, 99, k))
    offs = np.cumsum([0] + [len(s) for s in strings])
    dba = tref.encode_delta_byte_array(
        np.frombuffer(b"".join(strings), np.uint8), offs)
    return {
        "plain": (Leaf(0, "x", Type.INT32, 1),
                  rle_def + vals.tobytes(), Encoding.PLAIN),
        "dict": (Leaf(0, "x", Type.INT32, 1),
                 rle_def + tref.encode_rle_dict_indices(
                     rng.integers(0, 5, k), 3), Encoding.RLE_DICTIONARY),
        "dba": (Leaf(0, "x", Type.BYTE_ARRAY, 1), rle_def + dba,
                Encoding.DELTA_BYTE_ARRAY),
        "delta": (Leaf(0, "x", Type.INT64, 1),
                  rle_def + tref.encode_delta_binary_packed(
                      np.cumsum(rng.integers(0, 1000, k))),
                  Encoding.DELTA_BINARY_PACKED),
        "bool_rle": (Leaf(0, "x", Type.BOOLEAN, 1),
                     rle_def + _prefixed(tref.encode_rle(
                         (rng.random(k) < 0.5).astype(np.int64), 1)),
                     Encoding.RLE),
    }


@pytest.mark.parametrize("kind", ["plain", "dict", "dba", "delta",
                                  "bool_rle"])
def test_every_cut_raises_alike(kind):
    """The page cut at every byte: both planners raise the same
    ``CorruptedError`` (or, where a cut loses only the padding of a
    stream, plan alike); a cut PLAIN page always raises."""
    leaf, body, enc = _cut_pages()[kind]
    n = 40
    chunk = _chunk(leaf)
    if kind == "dict":
        chunk.meta = md.ColumnMetaData(type=int(leaf.physical_type))
    pre = [_dict_page(np.arange(5, dtype=np.int32))] if kind == "dict" else []
    full = tdr.build_plan(chunk, pre + [_v1(n, body, enc)])
    assert full.total_slots == n
    raised = 0
    for cut in range(len(body)):
        pages = pre + [_v1(n, body[:cut], enc)]
        want = _outcome(lambda: tdr._build_plan_python(chunk, pages))
        got = _outcome(lambda: tdr.build_plan(chunk, pages))
        if isinstance(want, tdr._Plan):
            _assert_plans_equal(got, want, f"{kind} cut {cut}")
            continue
        assert isinstance(want, CorruptedError), (cut, want)
        assert type(got) is CorruptedError and str(got) == str(want), (
            cut, got, want)
        raised += 1
    if kind == "plain":
        assert raised == len(body)
    assert raised > len(body) // 2
    assert _python_routes() == 0


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes([v]))


def _claiming_length_stream(count: int) -> bytes:
    """A DELTA_BINARY_PACKED stream that claims ``count`` values in a few
    KiB: blocks of 2^30 values in one miniblock, each block a zero min
    delta and a width-0 miniblock (two bytes)."""
    blocks = -(-(count - 1) // (1 << 30))
    return (_uvarint(1 << 30) + _uvarint(1) + _uvarint(count) + _uvarint(0)
            + b"\x00\x00" * blocks)


@pytest.mark.parametrize("stream", ["dlba", "dba_prefixes", "dba_suffixes"])
def test_length_stream_claiming_more_values_than_its_page_raises(stream):
    """A length stream whose header claims 2^40 values in a page of 16:
    both planners raise the same ``CorruptedError`` before anything is
    sized from the count."""
    n, claim = 16, _claiming_length_stream(1 << 40)
    assert len(claim) < 4096
    body, enc = {
        "dlba": (claim, Encoding.DELTA_LENGTH_BYTE_ARRAY),
        "dba_prefixes": (claim, Encoding.DELTA_BYTE_ARRAY),
        "dba_suffixes": (tref.encode_delta_binary_packed(np.zeros(n))
                         + claim, Encoding.DELTA_BYTE_ARRAY),
    }[stream]
    chunk = _chunk(Leaf(0, "x", Type.BYTE_ARRAY, 0))
    pages = [_v1(n, body, enc)]
    want = _outcome(lambda: tdr._build_plan_python(chunk, pages))
    got = _outcome(lambda: tdr.build_plan(chunk, pages))
    assert type(want) is CorruptedError, want
    assert type(got) is CorruptedError and str(got) == str(want), (got, want)
    assert str(got) == host.length_count_message(1 << 40, n)
    assert pqt.PLAN_ROUTE["native"] == 1


def test_planner_statuses_raise_the_walks_exception_types():
    """A planner status the tests cannot provoke safely (an allocation
    that fails) raises MemoryError; an encoding outside the format raises
    the walk's ValueError."""
    info = np.zeros(host.INFO_SIZES + len(host.PLAN_ARRAYS), np.int64)
    info[host.INFO_STATUS], info[host.INFO_PAGE] = host.PLAN_MEMORY, 3
    assert isinstance(tdr._plan_error(info, None), MemoryError)
    info[host.INFO_STATUS], info[host.INFO_A0] = host.PLAN_ENUM, 1
    err = tdr._plan_error(info, None)
    assert type(err) is ValueError and "1 is not a valid Encoding" in str(err)


def test_codec_without_a_batched_decoder_is_counted():
    """GZIP pages decompress page by page before the C++ planner: the
    plan equals the Python walk's, counted as ``native:python_codec``."""
    raw = _matrix_file("flat", True, 1, "gzip")
    f = pqt.ParquetFile(raw)
    for leaf in f.schema.leaves:
        reader = f.row_groups[0].column(leaf.column_index)
        _assert_plans_equal(tdr.build_plan(reader),
                            tdr._build_plan_python(reader), leaf.name)
    assert pqt.PLAN_ROUTE["native:python_codec"] == len(f.schema.leaves)
    assert pqt.PLAN_ROUTE["native"] == 0 and _python_routes() == 0


# ---------------------------------------------------------------------------
# the staging fill
# ---------------------------------------------------------------------------


def _old_fill(slots, nbytes: int) -> np.ndarray:
    """The numpy loop ``_StagingBatch.pack`` ran before the fill was C++:
    each array, stream part and miniblock row written into its slot, the
    slack zeroed."""
    h = np.full(nbytes, 0xAB, np.uint8)
    for src, off, n, span in slots:
        if isinstance(src, np.ndarray):
            h[off:off + n] = src.reshape(-1).view(np.uint8)
        elif isinstance(src, list):  # a byte stream's parts
            for p in src:
                h[off:off + len(p)] = p
                off += len(p)
            off -= n
        elif src.nb:  # a miniblock gather
            vals = src.values
            short = int(src.starts.max()) + src.nb - len(vals)
            if short > 0:
                vals = np.concatenate([vals, np.full(short, vals[-1],
                                                     np.uint8)])
            rows = np.lib.stride_tricks.sliding_window_view(vals, src.nb)
            h[off:off + n].reshape(-1, src.nb)[...] = rows[src.starts]
        h[off + n:off + span] = 0
    return h


@pytest.mark.parametrize("threads", [1, 3])
def test_fill_writes_what_the_loop_wrote(monkeypatch, threads):
    rng = np.random.default_rng(9)
    monkeypatch.setattr(host, "fill_threads", lambda nbytes: threads)
    big = rng.integers(0, 256, 5 << 20, dtype=np.uint8)
    parts = [rng.integers(0, 256, m, dtype=np.uint8) for m in (7, 0, 300)]
    accum = tdr._ByteAccum()
    for p in parts:
        accum.extend(p)
    values = rng.integers(0, 256, 20_000, dtype=np.uint8)
    starts = np.sort(rng.integers(0, 20_000, 3000))
    starts[-1] = 19_990  # the final miniblock runs past the stream
    sources = [
        (rng.integers(-9, 9, 37).astype(np.int64), 0),
        (big, 12),
        (accum, 12),
        (tdr._MiniblockGather(values, starts, 24), 4),
        (tdr._MiniblockGather(values, starts[:5], 0), 4),  # width 0
        (rng.random((7, 3)).astype(np.float32), 0),
        (np.zeros(0, np.int64), 0),
    ]
    batch = tdr._StagingBatch()
    slots = [(src, batch.put(src, extra)) for src, extra in sources]
    got = batch.pack(pin=False).numpy()
    want = _old_fill([(parts if s is accum else s, sl.off, sl.nbytes,
                       sl.span) for s, sl in slots], batch.nbytes)
    for _, sl in slots:
        np.testing.assert_array_equal(got[sl.off:sl.off + sl.span],
                                      want[sl.off:sl.off + sl.span])
    # a native plan's streams: segments of its buffers, zeros as pointer 0
    seg = tdr._ByteAccum(np.array([[big.ctypes.data + 5, 9], [0, 4],
                                   [values.ctypes.data, 3]], np.int64), 16,
                         (big, values))
    np.testing.assert_array_equal(
        seg.array(), np.concatenate([big[5:14], np.zeros(4, np.uint8),
                                     values[:3]]))
    with pytest.raises(ValueError, match="outside"):
        host.fill_batch(np.zeros(8, np.uint8),
                        np.array([[4, big.ctypes.data, 5]]), [])


def test_pack_has_no_python_loop_over_slots(monkeypatch):
    """The fill is one ``host.fill_batch`` call whatever the slots."""
    calls = []
    real = host.fill_batch
    monkeypatch.setattr(host, "fill_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = tdr._StagingBatch()
    for i in range(50):
        batch.put(np.arange(i, dtype=np.int32))
    batch.pack(pin=False)
    assert calls == [1]


# ---------------------------------------------------------------------------
# whole reads
# ---------------------------------------------------------------------------


def _multi_rg_file(path, n=40000, rgs=6):
    """``tests/test_pipeline_mesh.py``'s file with nulls: four columns,
    Snappy, no dictionaries, an uneven last row group."""
    rng = np.random.default_rng(7)
    cols = {"x": pa.array(rng.integers(0, 10**12, n)),
            "f": pa.array(rng.random(n, dtype=np.float32)),
            "i": pa.array(rng.integers(-100, 100, n).astype(np.int32))}
    m = rng.random(n) < 0.05
    cols["o"] = pa.array(np.where(m, 0, rng.integers(0, 50, n)), mask=m)
    papq.write_table(pa.table(cols), path, row_group_size=n // rgs + 13,
                     use_dictionary=False, compression="snappy")


def test_pipelined_read_equals_serial_and_jax(tmp_path):
    path = str(tmp_path / "multi.parquet")
    _multi_rg_file(path)
    f = pqt.ParquetFile(path)
    chunks = [rg.column(leaf.column_index)
              for leaf in f.schema.leaves for rg in f.row_groups]
    gen = tdr.decode_chunks_pipelined(chunks, CPU, 0)
    serial = {leaf.name: concat_columns([next(gen) for _ in f.row_groups])
              for leaf in f.schema.leaves}
    gen.close()
    pipelined = f.read(device="cpu")
    assert pqt.PLAN_ROUTE["native"] == 2 * len(chunks)
    assert _python_routes() == 0 and not any(pqt.HOST_ROUTE.values())
    jfile = parquet_tpu.ParquetFile(path)
    jdev, jhost = jfile.read(device=True), jfile.read()
    for name in ("x", "f", "i", "o"):
        got = pipelined[name]
        np.testing.assert_array_equal(got.values.numpy(),
                                      serial[name].values.numpy())
        for ref in (jdev[name].to_arrow(), jhost[name].to_arrow()):
            valid = ref.is_valid().to_numpy(zero_copy_only=False)
            want = ref.drop_null().to_numpy(zero_copy_only=False)
            assert got.values.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(got.values.numpy(), want)
            if got.validity is None:
                assert valid.all(), name
            else:
                np.testing.assert_array_equal(got.validity.numpy(), valid)
                np.testing.assert_array_equal(
                    serial[name].validity.numpy(), valid)
