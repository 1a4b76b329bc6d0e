"""parquet_tpu_torch's streamed read (``io/stream.py``,
``ParquetFile.iter_batches``, ``ColumnChunkReader.pages_streamed``, the
windowed header scan ``host.scan_page_headers_partial``) and the page
CRCs of its writer, against parquet_tpu's, on the CPU.

Each case runs the JAX package's ``iter_batches`` and the port's
(``device="cpu"``) on the same bytes, made from a seed with numpy and
pyarrow (a few thousand rows, small pages), and holds them batch by batch:
the same row counts, and each column's host values, validity, offsets,
list offsets and list validity equal exactly; the concatenation of the
port's batches equals its whole read.  The cases are the port's side of
``tests/test_stream.py``: batch sizes, a column subset, structs, lists and
maps, bounded preads, one dictionary decode a chunk, empty and one-row
files, unknown page types, ``strict_batch_rows``, corrupt page streams,
the host-route fixture and one hypothesis property.
"""

import io
import os
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import parquet_tpu
from parquet_tpu.io.reader import ReadOptions as JReadOptions

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.format import metadata as md
from parquet_tpu_torch.format.enums import PageType
from parquet_tpu_torch.io import reader as treader
from parquet_tpu_torch.io import stream as tstream
from parquet_tpu_torch.io.column import concat_columns
from parquet_tpu_torch.ops import host
from parquet_tpu_torch.parallel import device_reader as tdr
from tests.test_torch_nested import _same_column

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")


def _write(t: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    papq.write_table(t, buf, **kw)
    return buf.getvalue()


def _mixed_table(n: int, seed: int = 1234) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": pa.array(rng.integers(-(2**50), 2**50, n)),
        "oi": pa.array([None if i % 7 == 0 else i * 3 for i in range(n)],
                       type=pa.int64()),
        "f": pa.array(rng.random(n, dtype=np.float32)),
        "s": pa.array([f"s{i % 113}" for i in range(n)]),
        "lst": pa.array([None if i % 11 == 0 else
                         [int(x) for x in range(i % 5)] for i in range(n)],
                        type=pa.list_(pa.int64())),
    })


def _jax_batches(raw: bytes, **kw) -> list:
    return list(parquet_tpu.iter_batches(parquet_tpu.ParquetFile(raw), **kw))


def _port_batches(raw: bytes, **kw) -> list:
    return list(pqt.ParquetFile(raw).iter_batches(device=CPU, **kw))


def _same_batches(got: list, want: list, what: str = "") -> None:
    """Batch by batch: the row counts, the columns and every column's host
    values, validity, offsets and list structure."""
    assert [_rows(b) for b in got] == [b.num_rows for b in want], what
    for k, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w.columns), what
        for path, col in g.items():
            assert col.values is None or col.values.device.type == CPU
            _same_column(col, w.columns[path], f"{what} batch {k}: {path}")


def _rows(batch) -> int:
    col = next(iter(batch.values()))
    return (col.list_offsets[0].shape[0] - 1 if col.list_offsets
            else col.num_slots)


def _same_as_read(batches: list, whole: dict) -> None:
    """The batches' concatenation equals the whole read, bit for bit."""
    for path, want in whole.items():
        got = concat_columns([b[path] for b in batches])
        _same_host(got.materialize_host(), want.materialize_host(), path)


def _same_host(a, b, what) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            if k in ("def_levels", "rep_levels") and (a[k] is None
                                                      or b[k] is None):
                # kept only by a host decode, which a chunk and a page
                # span of it may not share
                continue
            _same_host(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same_host(x, y, what)
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def mixed_raw() -> bytes:
    return _write(_mixed_table(3000), row_group_size=1000,
                  data_page_size=2048)


# ---------------------------------------------------------------------------
# batches against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_rows", [1, 7, 1000, 4096, 100000])
def test_batches_match_jax(batch_rows, mixed_raw):
    got = _port_batches(mixed_raw, batch_rows=batch_rows)
    _same_batches(got, _jax_batches(mixed_raw, batch_rows=batch_rows),
                  f"batch_rows={batch_rows}")
    _same_as_read(got, pqt.ParquetFile(mixed_raw).read(device=CPU))


def test_batch_sizes_and_column_subset():
    raw = _write(_mixed_table(5000, seed=7), row_group_size=1700,
                 data_page_size=4096)
    got = _port_batches(raw, columns=["i", "oi"], batch_rows=999)
    want = _jax_batches(raw, columns=["i", "oi"], batch_rows=999)
    _same_batches(got, want, "subset")
    sizes = [_rows(b) for b in got]
    assert sum(sizes) == 5000 and max(sizes) <= 999
    assert all(list(b) == ["i", "oi"] for b in got)


def _struct_table(n: int) -> pa.Table:
    rng = np.random.default_rng(5)
    return pa.table({
        "pt": pa.array([None if i % 9 == 0 else {
            "x": float(rng.random()),
            "label": None if i % 4 == 0 else f"l{i % 13}"}
            for i in range(n)],
            type=pa.struct([("x", pa.float64()), ("label", pa.string())])),
        "k": pa.array(np.arange(n, dtype=np.int64)),
    })


@pytest.mark.parametrize("batch_rows", [333, 4000])
def test_struct_columns_match_jax(batch_rows):
    raw = _write(_struct_table(3000), row_group_size=1100,
                 data_page_size=1024)
    got = _port_batches(raw, batch_rows=batch_rows)
    _same_batches(got, _jax_batches(raw, batch_rows=batch_rows), "struct")
    # a struct chain keeps its host def levels, sliced with the batch
    assert all(b["pt.label"].def_levels is not None for b in got)
    _same_as_read(got, pqt.ParquetFile(raw).read(device=CPU))


@pytest.fixture(scope="module")
def nested_raw() -> dict:
    from tests.test_torch_nested import _table, _write_jax, _write_pyarrow

    t = _table()
    return {"pyarrow_v1": _write_pyarrow(t, 1),
            "pyarrow_v2": _write_pyarrow(t, 2),
            # the JAX writer takes no null struct above a list
            "jax_v2": _write_jax(_table(null_structs=False), 2)}


@pytest.mark.parametrize("batch_rows", [97, 1000])
@pytest.mark.parametrize("writer", ["pyarrow_v1", "pyarrow_v2", "jax_v2"])
def test_nested_columns_match_jax(writer, batch_rows, nested_raw):
    """Lists (to three levels), lists under a struct, a struct chain and a
    map, nulls and empty lists at every level."""
    raw = nested_raw[writer]
    got = _port_batches(raw, batch_rows=batch_rows)
    _same_batches(got, _jax_batches(raw, batch_rows=batch_rows), writer)
    _same_as_read(got, pqt.ParquetFile(raw).read(device=CPU))
    whole = pqt.ParquetFile(raw).read(device=CPU)
    for path, col in whole.items():
        assert sum(b[path].num_slots for b in got) == col.num_slots, path


@pytest.mark.parametrize("version", [1, 2])
def test_port_writer_files_stream_as_the_read(version):
    """The port's own writer: v1 and v2 pages, dictionaries, nulls."""
    rng = np.random.default_rng(3)
    n = 4000
    valid = rng.random(n) > 0.1
    data = {"a": rng.integers(0, 50, n).astype(np.int64),
            "b": np.ma.masked_array(rng.random(n), mask=~valid)}
    buf = io.BytesIO()
    pqt.write_table(data, buf, pqt.WriterOptions(
        data_page_version=version, row_group_size=1500,
        data_page_size=1024, compression="snappy"))
    raw = buf.getvalue()
    got = _port_batches(raw, batch_rows=640)
    _same_batches(got, _jax_batches(raw, batch_rows=640), "port writer")
    _same_as_read(got, pqt.ParquetFile(raw).read(device=CPU))


def test_host_route_fixture_streams_as_jax():
    """Dictionaries that fall back to PLAIN mid-chunk: a batch mixes an
    encoded piece and a dense one and is gathered; spans of one kind take
    the device route."""
    with open(os.path.join(FIXTURES, "host_route.parquet"), "rb") as f:
        raw = f.read()
    tdr.reset_host_route()
    got = _port_batches(raw, batch_rows=3000)
    _same_batches(got, _jax_batches(raw, batch_rows=3000), "fixture")
    _same_as_read(got, pqt.ParquetFile(raw).read(device=CPU))


@pytest.mark.parametrize("path", ["s", "oi", "lst"])
def test_slices_concatenate_with_the_sizes_they_know(mixed_raw, path):
    """A chunk taken in 300-row steps: its slices, concatenated with the
    element and byte counts they carry, equal the same concatenation
    with every size read back, and the chunk's whole read; slices of the
    chunk keep its dictionary once."""
    pf = pqt.ParquetFile(mixed_raw)
    leaf = next(x for x in pf.schema.leaves if x.name.split(".")[0] == path)
    chunk = pf.row_group(1).column(leaf.column_index)
    cursor = tstream._ChunkCursor(chunk=chunk, device=torch.device(CPU))
    slices = []
    while True:
        got, rows = cursor.take(300)
        if not rows:
            break
        slices += got
    assert len(slices) > 3
    known = tstream._concat_pending(slices)
    read = concat_columns([s.col for s in slices])
    whole = pf.read(row_groups=[1], columns=[path], device=CPU)[leaf.name]
    _same_host(known.materialize_host(), read.materialize_host(), path)
    _same_host(known.materialize_host(), whole.materialize_host(), path)
    if known.is_dictionary_encoded():
        assert known.dictionary[0] is slices[0].col.dictionary[0]


# ---------------------------------------------------------------------------
# bounded reads, the dictionary, odd files
# ---------------------------------------------------------------------------


def test_stream_is_io_bounded():
    """No pread covers a whole chunk: the largest stays under a tenth of
    the chunk, and the first batch reads under a tenth of the file."""
    rng = np.random.default_rng(11)
    n = 200_000
    t = pa.table({"x": pa.array(rng.integers(0, 1 << 40, n)),
                  "y": pa.array(rng.random(n))})
    raw = _write(t, row_group_size=n, data_page_size=8192,
                 use_dictionary=False, compression="none")
    pf = pqt.ParquetFile(raw)
    reads = []
    orig = pf.source.pread

    def spy(offset, size):
        reads.append(size)
        return orig(offset, size)

    pf.source.pread = spy
    it = pf.iter_batches(batch_rows=4096, device=CPU)
    first = next(it)
    assert _rows(first) == 4096
    chunk = pf.row_group(0).column(0).meta.total_compressed_size
    assert max(reads) < chunk / 10, (max(reads), chunk)
    assert sum(reads) < len(raw) / 10, (sum(reads), len(raw))
    total = _rows(first) + sum(_rows(b) for b in it)
    assert total == n
    assert max(reads) <= max(min(1 << 20, chunk // 16), 1 << 16)


def test_dictionary_decoded_once_a_chunk(monkeypatch):
    n = 30000
    raw = _write(pa.table({"s": pa.array([f"cat{i % 40}" for i in range(n)])}),
                 data_page_size=2048, row_group_size=10000)
    calls = []
    real = tstream.decode_dictionary_page

    def spy(chunk, page):
        calls.append(chunk.rg_index)
        return real(chunk, page)

    monkeypatch.setattr(tstream, "decode_dictionary_page", spy)
    got = _port_batches(raw, batch_rows=1234)
    assert sorted(calls) == [0, 1, 2]
    _same_batches(got, _jax_batches(raw, batch_rows=1234), "dictionary")
    # a batch keeps one copy of each chunk's dictionary, not one a piece
    ends = np.cumsum([_rows(b) for b in got])
    for b, end in zip(got, ends):
        chunks = (end - 1) // 10000 - (end - _rows(b)) // 10000 + 1
        assert b["s"].dictionary[1].shape[0] == 40 * chunks + 1


def test_empty_and_single_row_files():
    one = _write(pa.table({"x": pa.array(np.arange(1, dtype=np.int64))}))
    got = _port_batches(one, batch_rows=10)
    assert len(got) == 1 and _rows(got[0]) == 1
    _same_batches(got, _jax_batches(one, batch_rows=10))
    empty = _write(pa.table({"x": pa.array(np.zeros(0, np.int64))}))
    assert _port_batches(empty, batch_rows=10) == []
    assert _jax_batches(empty, batch_rows=10) == []
    with pytest.raises(ValueError):
        pqt.ParquetFile(one).iter_batches(batch_rows=0, device=CPU)
    with pytest.raises(ValueError):
        pqt.iter_batches(pqt.ParquetFile(one), batch_rows=-1, device=CPU)


def test_unknown_page_types_are_skipped(monkeypatch):
    n = 4000
    raw = _write(pa.table({"x": pa.array(np.arange(n, dtype=np.int64))}),
                 row_group_size=1 << 30, data_page_size=2048)
    fake = treader.PageInfo(
        header=md.PageHeader(type=int(PageType.INDEX_PAGE),
                             uncompressed_page_size=0,
                             compressed_page_size=0),
        payload=np.zeros(0, np.uint8), offset=0)
    orig = treader.ColumnChunkReader.pages_streamed

    def with_fake(self, *a, **kw):
        yield fake
        yield from orig(self, *a, **kw)

    monkeypatch.setattr(treader.ColumnChunkReader, "pages_streamed",
                        with_fake)
    got = _port_batches(raw, batch_rows=1500)
    assert [_rows(b) for b in got] == [1500, 1500, 1000]
    np.testing.assert_array_equal(
        np.concatenate([b["x"].values.numpy() for b in got]), np.arange(n))


@pytest.mark.parametrize("strict", [True, False])
def test_strict_batch_rows(strict):
    n, rg = 10_000, 1500
    raw = _write(pa.table({"x": pa.array(np.arange(n, dtype=np.int64))}),
                 row_group_size=rg)
    got = _port_batches(raw, batch_rows=1000, strict_batch_rows=strict)
    want = _jax_batches(raw, batch_rows=1000, strict_batch_rows=strict)
    _same_batches(got, want, "strict")
    if strict:
        assert [_rows(b) for b in got] == [1000] * 10
    np.testing.assert_array_equal(
        np.concatenate([b["x"].values.numpy() for b in got]), np.arange(n))


def test_short_page_stream_raises():
    """A chunk whose pages hold fewer rows than its row group says."""
    raw = _write(pa.table({"x": pa.array(np.arange(3000, dtype=np.int64))}),
                 row_group_size=3000, data_page_size=2048)
    pf = pqt.ParquetFile(raw)
    pf.row_group(0).rg.num_rows = 3500
    with pytest.raises(CorruptedError, match="streaming cursor yielded"):
        list(pf.iter_batches(batch_rows=1000, device=CPU))


def test_corrupt_page_streams_raise_cleanly():
    """Flipped, zeroed and garbled bytes in a chunk: ``pages_streamed``
    raises ``CorruptedError`` or yields pages, never anything else, and
    never loops; the drain raises or decodes."""
    rng = np.random.default_rng(33)
    n = 20000
    raw = _write(pa.table({"x": pa.array(rng.integers(0, 1 << 40, n))}),
                 data_page_size=2048, use_dictionary=False,
                 compression="snappy")
    chunk = pqt.ParquetFile(raw).row_group(0).column(0)
    start, size = chunk.byte_range
    base = [p.offset for p in chunk.pages_streamed(window=1 << 16)]
    assert base == [p.offset for p in chunk.pages()] and len(base) > 10
    for trial in range(45):
        bad = bytearray(raw)
        mode = trial % 3
        if mode == 0:
            off = start + int(rng.integers(0, size))
            bad[off] ^= 1 << int(rng.integers(0, 8))
        elif mode == 1:
            off = start + int(rng.integers(0, max(size - 16, 1)))
            bad[off:off + 8] = b"\x00" * 8
        else:
            off = start + int(rng.integers(0, max(size - 32, 1)))
            bad[off:off + 16] = bytes(rng.integers(0, 256, 16,
                                                   dtype=np.uint8))
        pf = pqt.ParquetFile(bytes(bad))
        try:
            for _ in pf.row_group(0).column(0).pages_streamed(
                    window=1 << 16):
                pass
        except CorruptedError:
            pass
        try:
            for _ in pf.iter_batches(batch_rows=5000, device=CPU):
                pass
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the windowed page-header scan and pages_streamed
# ---------------------------------------------------------------------------


def _chunk_bytes(raw: bytes, rg: int = 0, col: int = 0):
    chunk = pqt.ParquetFile(raw).row_group(rg).column(col)
    start, size = chunk.byte_range
    return chunk, np.frombuffer(raw, np.uint8)[start:start + size], start


@pytest.mark.parametrize("codec", ["none", "snappy"])
def test_partial_scan_matches_the_python_walk_at_every_cut(codec):
    """Windows cut at every byte of a chunk's first pages: the windowed
    scan returns exactly the pages the Python walk parses whole inside
    the window, and stops without an error at the one it cuts."""
    raw = _write(pa.table({"s": pa.array([f"v{i % 31}" for i in range(900)]),
                           "x": pa.array(np.arange(900, dtype=np.int64))}),
                 data_page_size=256, compression=codec,
                 data_page_version="2.0")
    for col in (0, 1):
        chunk, buf, start = _chunk_bytes(raw, col=col)
        pages = list(treader.thrift_page_walk(buf.tobytes(), start))
        ends = [pages[i + 1].offset - start for i in range(len(pages) - 1)]
        ends.append(len(buf))
        total = chunk.meta.num_values
        for cut in range(0, min(len(buf), ends[min(3, len(ends) - 1)]) + 1):
            rows, consumed, seen = host.scan_page_headers_partial(
                buf[:cut], total)
            whole = [i for i, e in enumerate(ends) if e <= cut]
            assert len(rows) == len(whole), cut
            assert consumed == (ends[whole[-1]] if whole else 0), cut
            assert seen == sum(pages[i].num_values for i in whole
                               if pages[i].header.type in (0, 3)), cut
            for r, i in zip(rows.tolist(), whole):
                assert r[host.PG_HEADER_POS] == pages[i].offset - start
                assert r[host.PG_COMP] == \
                    pages[i].header.compressed_page_size


@pytest.mark.parametrize("window", [1, 300, 4096, 1 << 20])
def test_pages_streamed_matches_the_page_table(window):
    raw = _write(_mixed_table(3000), row_group_size=3000,
                 data_page_size=2048, compression="snappy")
    pf = pqt.ParquetFile(raw)
    for c in range(len(pf.schema.leaves)):
        chunk = pf.row_group(0).column(c)
        want = list(chunk.pages())
        got = list(chunk.pages_streamed(window=window))
        assert [p.offset for p in got] == [p.offset for p in want]
        for a, b in zip(got, want):
            assert a.header == b.header
            np.testing.assert_array_equal(host.as_u8(a.payload),
                                          host.as_u8(b.payload))
        # the Python walk from the start gives the same pages
        py = list(chunk._pages_streamed_python(1 << 16, 0, 0))
        assert [p.offset for p in py] == [p.offset for p in want]


def test_pages_streamed_reads_a_large_page_exactly():
    """A page larger than the window gets one read of exactly itself."""
    n = 200_000
    raw = _write(pa.table({"x": pa.array(np.arange(n, dtype=np.int64))}),
                 data_page_size=1 << 22, use_dictionary=False,
                 compression="none")
    pf = pqt.ParquetFile(raw)
    chunk = pf.row_group(0).column(0)
    reads = []
    orig = pf.source.pread

    def spy(offset, size):
        reads.append(size)
        return orig(offset, size)

    pf.source.pread = spy
    pages = list(chunk.pages_streamed(window=1 << 16))
    big = max(len(p.payload) for p in pages)
    assert big > 1 << 16
    assert max(reads) < big + 256


# ---------------------------------------------------------------------------
# the writer's page CRCs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("codec", ["uncompressed", "snappy", "zstd", "gzip"])
def test_writer_page_crcs_equal_the_jax_writers(codec, version):
    """Every page header of a port-written file (dictionary, v1 and v2
    data pages) carries the CRC32 the JAX writer computes over the same
    stored bytes, and the JAX package reads the file with
    ``verify_crc``."""
    rng = np.random.default_rng(2)
    n = 3000
    valid = rng.random(n) > 0.2
    data = {"d": rng.integers(0, 30, n).astype(np.int64),
            "p": np.ma.masked_array(rng.random(n), mask=~valid)}
    buf = io.BytesIO()
    pqt.write_table(data, buf, pqt.WriterOptions(
        compression=codec, data_page_version=version, data_page_size=1024,
        row_group_size=1000))
    raw = buf.getvalue()
    jf = parquet_tpu.ParquetFile(raw)
    kinds = set()
    for rg in jf.row_groups:
        for chunk in rg.columns():
            for page in chunk.pages():
                kinds.add(page.page_type)
                assert page.header.crc == zlib.crc32(
                    bytes(page.payload)) & 0xFFFFFFFF
    assert PageType.DICTIONARY_PAGE in kinds
    assert (PageType.DATA_PAGE_V2 if version == 2 else PageType.DATA_PAGE) \
        in kinds
    got = parquet_tpu.ParquetFile(
        raw, options=JReadOptions(verify_crc=True)).read(device=False)
    np.testing.assert_array_equal(np.asarray(got["d"].values), data["d"])
    off = pqt.WriterOptions(write_crc=False)
    buf = io.BytesIO()
    pqt.write_table(data, buf, off)
    for rg in parquet_tpu.ParquetFile(buf.getvalue()).row_groups:
        assert all(p.header.crc is None for p in rg.columns()[0].pages())


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(st.integers(0, 300), st.integers(1, 97), st.sampled_from([512, 4096]),
       st.booleans(), st.integers(0, 2**31))
def test_stream_property_matches_jax(n, batch_rows, page_size, nullable,
                                     seed):
    """Any batch size over any page layout: the port's batches equal the
    JAX package's, and their concatenation the whole read."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1000, 1000, n)
    mask = rng.random(n) < 0.2 if nullable else np.zeros(n, bool)
    t = pa.table({
        "x": pa.array(vals, mask=mask),
        "s": pa.array([f"k{v % 17}" for v in vals], mask=mask),
        "l": pa.array([None if m else [int(v)] * int(v % 3)
                       for v, m in zip(vals, mask)],
                      type=pa.list_(pa.int64()))})
    raw = _write(t, data_page_size=page_size,
                 row_group_size=max(n // 3, 1))
    got = _port_batches(raw, batch_rows=batch_rows)
    _same_batches(got, _jax_batches(raw, batch_rows=batch_rows), "property")
    if got:
        _same_as_read(got, pqt.ParquetFile(raw).read(device=CPU))
    else:
        assert n == 0
