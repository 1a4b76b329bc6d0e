"""The C++ host prescan of parquet_tpu_torch (``csrc/host_prescan.cpp``
through ``ops/host.py``) against the port's Python versions and the JAX
package's, on the same bytes, made from a numpy seed.

- run scans at widths 0..32 (all RLE, all bit-packed, mixed, a last run
  longer than the values left) and the present count over them;
- delta miniblock tables and decodes (w = 0 miniblocks, negative minimum
  deltas, fewer values than a miniblock, other block shapes);
- page-header tables against the thrift walk and the JAX package's table
  (v1 and v2 pages, dictionary pages, CRCs, page-header statistics);
- batched page decompression against per-page ``codec.decode`` under
  SNAPPY and ZSTD at 1 and 2 threads;
- malformed streams raise ``CorruptedError``;
- the read path reaches none of the Python versions;
- three processes building one library compile it once.

Streams stay under 64 KiB and each test under 200 examples.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from parquet_tpu import native as jnative
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table
from parquet_tpu.ops import device as jdev
from parquet_tpu.ops import ref as jref

import parquet_tpu_torch as pqt
from parquet_tpu_torch import codecs as tcodecs
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.format import metadata as md
from parquet_tpu_torch.format import thrift
from parquet_tpu_torch.format.enums import (CompressionCodec, Encoding,
                                            PageType, Type)
from parquet_tpu_torch.io import reader as treader
from parquet_tpu_torch.io.writer import ColumnData, WriterOptions, write_table
from parquet_tpu_torch.ops import device as tdev
from parquet_tpu_torch.ops import host
from parquet_tpu_torch.ops import ref as tref
from parquet_tpu_torch.parallel import device_reader as tdr
from parquet_tpu_torch.schema import schema as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "host_route.parquet")


# ---------------------------------------------------------------------------
# run scans
# ---------------------------------------------------------------------------


def _pack(values: np.ndarray, w: int) -> bytes:
    """LSB-first w-bit packing (the hybrid's bit-packed runs)."""
    if w == 0:
        return b""
    bits = (np.asarray(values, np.uint64)[:, None]
            >> np.arange(w, dtype=np.uint64)) & np.uint64(1)
    return np.packbits(bits.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


def _hybrid(rng, w: int, shape: str, runs: int = 12):
    """A hybrid stream of ``runs`` runs (RLE, bit-packed or mixed), then one
    last run that overshoots: ``(bytes, n, values[n])``."""
    out, vals = bytearray(), []
    hi = 1 << w
    for r in range(runs + 1):
        rle = shape == "rle" or (shape == "mixed" and r % 2 == 0)
        if rle:
            count = int(rng.integers(1, 40)) if r < runs else 12
            v = int(rng.integers(0, hi))
            tref.write_uvarint(out, count << 1)
            out += v.to_bytes((w + 7) // 8, "little")
            vals += [v] * count
        else:
            groups = int(rng.integers(1, 5)) if r < runs else 2
            vs = rng.integers(0, hi, 8 * groups, dtype=np.uint64)
            tref.write_uvarint(out, groups << 1 | 1)
            out += _pack(vs, w)
            vals += vs.tolist()
    n = len(vals) - 5  # the last run holds 5 values past the stream's n
    return bytes(out), n, np.array(vals[:n], np.int64)


@pytest.mark.parametrize("shape", ["rle", "packed", "mixed"])
@pytest.mark.parametrize("w", range(33))
def test_scan_rle_runs(w, shape):
    rng = np.random.default_rng(100 + w)
    stream, n, values = _hybrid(rng, w, shape)
    assert len(stream) < 64 << 10
    prefix = b"\x07\x07\x07"  # the stream at a nonzero position
    got = host.scan_rle_runs(prefix + stream, n, w, len(prefix))
    want = tref.scan_rle_runs(prefix + stream, n, w, len(prefix))
    for g, p in zip(got, want):
        np.testing.assert_array_equal(g, p)
        assert np.asarray(g).dtype == np.asarray(p).dtype
    assert got[4] == want[4] == len(prefix) + len(stream)
    kinds, counts, payloads, offs, _ = jref.scan_rle_runs(
        np.frombuffer(stream, np.uint8), n, w)
    for g, r in zip(got[:3], (kinds, counts, payloads)):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[3] - len(prefix), offs)
    assert int(got[1].sum()) == n
    # the values the table expands to
    np.testing.assert_array_equal(
        tref.decode_rle(stream, n, w).view(np.uint32), values)


@pytest.mark.parametrize("shape", ["rle", "packed", "mixed"])
@pytest.mark.parametrize("w", [0, 1, 2, 3, 5, 8, 13, 32])
def test_count_present(w, shape):
    rng = np.random.default_rng(200 + w)
    stream, n, values = _hybrid(rng, w, shape)
    kinds, counts, payloads, offs, _ = host.scan_rle_runs(stream, n, w)
    for target in sorted({0, 1, int(values[0]), int(values[-1])}):
        got = host.count_present(stream, kinds, counts, payloads, offs, w,
                                 target)
        assert got == int(np.count_nonzero(values == target))
        if w <= 24:  # the plain version reads a 32-bit window
            assert got == tref.count_in_runs(stream, kinds, counts,
                                             payloads, offs, w, target)
        if w:
            assert got == jnative.count_target_in_runs(
                np.frombuffer(stream, np.uint8), kinds, counts, payloads,
                offs, w, target)


def test_run_scan_rejects_malformed_streams():
    """A zero-count run (RLE or bit-packed) raises as the Python scan does;
    the stream cut at any byte raises."""
    for zero in (b"\x00\x01", b"\x01", b"\x04\x01\x00"):
        for scan in (tref.scan_rle_runs, host.scan_rle_runs):
            with pytest.raises(CorruptedError, match="zero-count run"):
                scan(zero, 4, 1)
    rng = np.random.default_rng(3)
    for w in (1, 3, 9):
        stream, n, _ = _hybrid(rng, w, "mixed", runs=4)
        for cut in range(len(stream)):
            for scan in (host.scan_rle_runs, tref.scan_rle_runs):
                with pytest.raises(CorruptedError, match="truncated"):
                    scan(stream[:cut], n, w)
    with pytest.raises(CorruptedError, match="truncated"):
        host.count_present(b"\x00", [1], [8], [0], [0], 3, 1)


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED
# ---------------------------------------------------------------------------

DELTA_CASES = {
    "w0": lambda rng: np.full(700, 42, np.int64),  # every miniblock w = 0
    "arith": lambda rng: np.arange(500, dtype=np.int64) * -3,
    "negative_min": lambda rng: np.cumsum(rng.integers(-900, 50, 900)),
    "short": lambda rng: np.array([5, -7, 1_000_000, 3], np.int64),
    "single": lambda rng: np.array([-(2 ** 62)], np.int64),
    "empty": lambda rng: np.zeros(0, np.int64),
    "wide": lambda rng: rng.integers(-2 ** 63, 2 ** 63 - 1, 600,
                                     dtype=np.int64),
    "cumsum": lambda rng: np.cumsum(rng.integers(0, 1000, 2000)),
}


@pytest.mark.parametrize("blocks", [(128, 4), (256, 8), (64, 1)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_prescan_and_decode(case, blocks):
    rng = np.random.default_rng(len(case))
    values = DELTA_CASES[case](rng)
    body = tref.encode_delta_binary_packed(values, *blocks)
    stream = np.frombuffer(b"\x09\x09" + body + b"\x05" * 5, np.uint8)
    got = host.delta_prescan(stream, 2)
    want = tdev.delta_prescan(stream, 2)
    ref_table = jdev.delta_prescan(stream, 2)
    assert got[:3] == want[:3] == tuple(int(x) for x in ref_table[:3])
    for g, p, r in zip(got[3:6], want[3:6], ref_table[3:6]):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)
        assert g.dtype == p.dtype
    assert got[6] == want[6] == ref_table[6] == 2 + len(body)
    vals, end = host.decode_delta_binary_packed(stream, 2)
    pvals, pend = tref.decode_delta_binary_packed(stream, 2)
    jvals, jend = jref.decode_delta_binary_packed(stream, 2, _native=False)
    np.testing.assert_array_equal(vals, values)
    np.testing.assert_array_equal(vals, pvals)
    np.testing.assert_array_equal(vals, jvals)
    assert end == pend == jend


def test_delta_rejects_malformed_streams():
    for bs, nmb in ((0, 4), (128, 0), (100, 3)):
        head = bytearray()
        for v in (bs, nmb, 10, 0):
            tref.write_uvarint(head, v)
        msg = (f"malformed DELTA_BINARY_PACKED header: block_size={bs}, "
               f"miniblocks={nmb}")
        for fn in (tdev.delta_prescan, host.delta_prescan):
            with pytest.raises(CorruptedError, match=msg):
                fn(np.frombuffer(bytes(head), np.uint8), 0)
    # every byte of a stream whose miniblocks are all full and all wide
    rng = np.random.default_rng(5)
    body = tref.encode_delta_binary_packed(
        rng.integers(0, 2 ** 40, 257, dtype=np.int64), 128, 4)
    for cut in range(len(body)):
        with pytest.raises(CorruptedError,
                           match="DELTA_BINARY_PACKED stream truncated"):
            host.decode_delta_binary_packed(body[:cut])
    wide = bytearray()
    for v in (8, 1, 3, 0, 0):
        tref.write_uvarint(wide, v)
    wide.append(65)  # a miniblock width over 64
    with pytest.raises(CorruptedError, match="over 64"):
        host.delta_prescan(bytes(wide) + b"\x00" * 64)


@pytest.mark.parametrize("kind", ["dlba", "dba"])
def test_delta_length_streams_match_the_reference(kind):
    """The length streams of DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY
    pages decode through the C++ delta decode as the JAX package's do."""
    rng = np.random.default_rng(9)
    n = 150
    lens = rng.integers(0, 30, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.sort(rng.integers(97, 100, int(offsets[-1]))).astype(np.uint8)
    if kind == "dlba":
        page = tref.encode_delta_length_byte_array(data, offsets)
        got = tref.decode_delta_length_byte_array(page)
        want = jref.decode_delta_length_byte_array(page)
    else:
        page = jref.encode_delta_byte_array(data, offsets)
        got = tref.decode_delta_byte_array(page)
        want = jref.decode_delta_byte_array(page)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], offsets)
    assert got[2] == want[2] == len(page)


# ---------------------------------------------------------------------------
# page-header tables
# ---------------------------------------------------------------------------


def _port_file(version: int, codec: str) -> bytes:
    rng = np.random.default_rng(version)
    n = 3000
    table = {"i": rng.integers(-50, 50, n).astype(np.int64),
             "f": np.ma.masked_array(rng.random(n),
                                     mask=rng.random(n) < 0.2),
             "cat": rng.integers(0, 7, n).astype(np.int32)}
    buf = io.BytesIO()
    write_table(table, buf, WriterOptions(
        data_page_version=version, data_page_size=4096, compression=codec,
        row_group_size=2000, column_encoding={"i": Encoding.PLAIN}))
    return buf.getvalue()


def _reference_file(version: int) -> bytes:
    """The JAX package's writer: CRCs on every page."""
    import pyarrow as pa

    rng = np.random.default_rng(10 + version)
    n = 3000
    t = pa.table({"a": rng.integers(0, 9, n),
                  "b": pa.array(rng.random(n), mask=rng.random(n) < 0.1)})
    buf = io.BytesIO()
    jwrite_table(t, buf, JWriterOptions(data_page_version=version,
                                        data_page_size=4096))
    return buf.getvalue()


def _hand_stream() -> tuple:
    """Page headers no writer here makes together: negative and large
    CRCs, statistics in v1 and v2 headers, an index page, a v2 page
    stored raw, a sorted dictionary page."""
    stats = md.Statistics(max=b"\xff" * 9, min=b"", null_count=3,
                          distinct_count=2, max_value=b"zz",
                          min_value=b"a", is_max_value_exact=True)
    headers = [
        md.PageHeader(type=2, uncompressed_page_size=5,
                      compressed_page_size=5, crc=-12345,
                      dictionary_page_header=md.DictionaryPageHeader(
                          num_values=1, encoding=0, is_sorted=True)),
        md.PageHeader(type=0, uncompressed_page_size=7,
                      compressed_page_size=7, crc=2 ** 32 - 1,
                      data_page_header=md.DataPageHeader(
                          num_values=4, encoding=8,
                          definition_level_encoding=3,
                          repetition_level_encoding=3, statistics=stats)),
        md.PageHeader(type=1, uncompressed_page_size=3,
                      compressed_page_size=3),
        md.PageHeader(type=3, uncompressed_page_size=9,
                      compressed_page_size=9,
                      data_page_header_v2=md.DataPageHeaderV2(
                          num_values=6, num_nulls=1, num_rows=2, encoding=0,
                          definition_levels_byte_length=2,
                          repetition_levels_byte_length=1,
                          is_compressed=False, statistics=stats)),
        md.PageHeader(type=3, uncompressed_page_size=0,
                      compressed_page_size=0,
                      data_page_header_v2=md.DataPageHeaderV2(
                          num_values=0, num_nulls=0, num_rows=0,
                          encoding=0, definition_levels_byte_length=0,
                          repetition_levels_byte_length=0)),
    ]
    raw = b"".join(thrift.serialize(h) + bytes(range(h.compressed_page_size))
                   for h in headers)
    return raw, 10


def _chunks():
    """(name, chunk bytes, chunk start, total values) of every chunk of the
    port writer's files (v1, v2; dictionaries; page statistics), the JAX
    writer's (CRCs) and the pyarrow fixture, and the hand-made stream."""
    files = {f"port_v{v}_{c}": _port_file(v, c)
             for v in (1, 2) for c in ("uncompressed", "snappy")}
    files.update({f"jax_v{v}": _reference_file(v) for v in (1, 2)})
    with open(FIXTURE, "rb") as f:
        files["fixture"] = f.read()
    out = []
    for name, data in files.items():
        f = pqt.ParquetFile(data)
        for rg in f.row_groups:
            for i in range(len(f.schema.leaves)):
                c = rg.column(i)
                start, size = c.byte_range
                out.append((f"{name}/{rg.index}/{i}", data[start:start + size],
                            start, c.meta.num_values))
    raw, total = _hand_stream()
    out.append(("hand", raw, 0, total))
    return out


def _plain(h):
    """A header without its statistics (the table skips them), the CRC as
    its unsigned 32-bit value."""
    for sub in (h.data_page_header, h.data_page_header_v2):
        if sub is not None:
            sub.statistics = None
    if h.dictionary_page_header is not None:
        h.dictionary_page_header.is_sorted = None
    if h.crc is not None:
        h.crc &= 0xFFFFFFFF
    return h


def test_page_header_tables():
    chunks = _chunks()
    assert len(chunks) < 200
    for name, raw, start, total in chunks:
        table = host.scan_page_headers(raw, total, base=start)
        want = list(treader.thrift_page_walk(raw, start, total))
        got = treader.page_infos(raw, start, table)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert g.offset == w.offset, name
            assert bytes(g.payload) == bytes(w.payload), name
            assert g.header == _plain(w.header), name
        np.testing.assert_array_equal(
            table, jnative.scan_page_headers(raw, total), err_msg=name)
        # a span of the chunk's pages, as the lookup reads it
        span = host.scan_page_headers(raw, max_pages=2, base=start)
        np.testing.assert_array_equal(span, table[:2], err_msg=name)


def test_page_header_walk_rejects_what_the_thrift_walk_rejects():
    """A cut payload, a cut header and a negative compressed size raise the
    thrift walk's errors, at the header's position in the file."""
    head = md.PageHeader(type=0, uncompressed_page_size=4,
                         compressed_page_size=4,
                         data_page_header=md.DataPageHeader(num_values=1,
                                                            encoding=0))
    raw = thrift.serialize(head)
    neg = md.PageHeader(type=0, uncompressed_page_size=1,
                        compressed_page_size=-1,
                        data_page_header=md.DataPageHeader(num_values=1,
                                                           encoding=0))
    cases = {"truncated page payload at 7$": raw + b"abc",
             "bad page header at 7: ": raw[:3],
             "page at 7: compressed size -1 out of range":
                 thrift.serialize(neg) + b"\x00"}
    for msg, stream in cases.items():
        with pytest.raises(CorruptedError, match=msg):
            list(treader.thrift_page_walk(stream, 7))
        with pytest.raises(CorruptedError, match=msg):
            host.scan_page_headers(stream, base=7)


# ---------------------------------------------------------------------------
# batched page decompression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("codec", ["snappy", "zstd"])
def test_decompress_pages(codec, threads):
    data = _port_file(1, codec)
    f = pqt.ParquetFile(data)
    c = f.row_groups[0].column(1)
    pages = [p for p in c.pages() if p.page_type == PageType.DATA_PAGE]
    assert len(pages) > 2
    sizes = [p.header.uncompressed_page_size for p in pages]
    buf, offs = host.decompress_pages([p.payload for p in pages], sizes,
                                      int(c.codec.codec_id), threads)
    for i, p in enumerate(pages):
        want = host.as_u8(c.codec.decode(p.payload, sizes[i]))
        np.testing.assert_array_equal(buf[offs[i]:offs[i + 1]], want)
    # a page that does not decode raises the codec's own error
    bad = [bytes(p.payload) for p in pages]
    bad[1] = bad[1][:len(bad[1]) // 2]
    with pytest.raises(CorruptedError) as per_page:
        c.codec.decode(bad[1], sizes[1])
    with pytest.raises(CorruptedError) as batched:
        host.decompress_pages(bad, sizes, int(c.codec.codec_id), threads)
    assert str(batched.value) == str(per_page.value)
    bodies = treader.data_page_bodies(c, pages)
    for i, body in enumerate(bodies):
        np.testing.assert_array_equal(body, buf[offs[i]:offs[i + 1]])


def test_decompress_threads():
    assert host.decompress_threads(0) == 1
    assert host.decompress_threads((8 << 20) - 1) == 1
    cores = len(os.sched_getaffinity(0))
    assert host.decompress_threads(8 << 20) == min(cores, 2)
    assert host.decompress_threads(1 << 30) == min(cores, 8)


# ---------------------------------------------------------------------------
# the read path
# ---------------------------------------------------------------------------


def test_read_path_reaches_no_python_prescan(monkeypatch):
    """With the Python scans made to raise, a nullable, a nested, a delta
    and a DELTA_LENGTH_BYTE_ARRAY column still read on the CPU (ZSTD
    pages, so the batched decompression runs too) and equal their
    arrays."""
    rng = np.random.default_rng(11)
    n = 4000
    lens = rng.integers(0, 5, n)
    loffs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=loffs[1:])
    elems = np.cumsum(rng.integers(0, 99, int(loffs[-1]))).astype(np.int64)
    nul_valid = rng.random(n) >= 0.15
    nul = rng.integers(0, 40, int(nul_valid.sum())).astype(np.int32)
    dlt = np.cumsum(rng.integers(-5, 50, n)).astype(np.int64)
    slens = rng.integers(0, 12, n)
    soffs = np.zeros(n + 1, np.int64)
    np.cumsum(slens, out=soffs[1:])
    sbytes = rng.integers(97, 123, int(soffs[-1])).astype(np.uint8)
    schema = S.message("schema", [
        S.optional(S.leaf("nul", Type.INT32)),
        S.list_of("lst", S.optional(S.leaf("element", Type.INT64))),
        S.leaf("dlt", Type.INT64),
        S.leaf("s", Type.BYTE_ARRAY)])
    buf = io.BytesIO()
    write_table({"nul": ColumnData(nul, validity=nul_valid),
                 "lst.list.element": ColumnData(elems, list_offsets=[loffs]),
                 "dlt": ColumnData(dlt),
                 "s": ColumnData(sbytes, offsets=soffs)}, buf,
                WriterOptions(compression="zstd", data_page_size=4096,
                              row_group_size=2500, column_encoding={
                                  "lst.list.element":
                                      Encoding.DELTA_BINARY_PACKED,
                                  "dlt": Encoding.DELTA_BINARY_PACKED,
                                  "s": Encoding.DELTA_LENGTH_BYTE_ARRAY}),
                schema=schema)

    def refuse(*a, **k):
        raise AssertionError("a Python prescan ran on the read path")

    for mod, name in ((tref, "scan_rle_runs"),
                      (tref, "decode_delta_binary_packed"),
                      (tdev, "delta_prescan"),
                      (treader, "thrift_page_walk")):
        monkeypatch.setattr(mod, name, refuse)
    tdr.reset_host_route()
    out = pqt.ParquetFile(buf.getvalue()).read(device="cpu")
    assert not any(tdr.HOST_ROUTE.values())
    np.testing.assert_array_equal(out["nul"].validity.numpy(), nul_valid)
    np.testing.assert_array_equal(out["nul"].values.numpy(), nul)
    lst = out["lst.list.element"]
    np.testing.assert_array_equal(lst.list_offsets[0].numpy(), loffs)
    np.testing.assert_array_equal(lst.values.numpy(), elems)
    np.testing.assert_array_equal(out["dlt"].values.numpy(), dlt)
    np.testing.assert_array_equal(out["s"].offsets.numpy(), soffs)
    np.testing.assert_array_equal(out["s"].values.numpy(), sbytes)


def test_host_route_uses_the_cpp_scans(monkeypatch):
    """The host decode of the fixture's refused chunks runs on the C++
    scans and page table too."""
    def refuse(*a, **k):
        raise AssertionError("a Python prescan ran on the host route")

    for mod, name in ((tref, "scan_rle_runs"),
                      (tref, "decode_delta_binary_packed"),
                      (treader, "thrift_page_walk")):
        monkeypatch.setattr(mod, name, refuse)
    tdr.reset_host_route()
    with open(FIXTURE, "rb") as f:
        pqt.ParquetFile(f.read()).read(device="cpu")
    assert tdr.HOST_ROUTE["mixed_page_kinds"] == 6


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

_BUILDER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("_build", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
b.BUILD_DIR = sys.argv[2]
built = b.build_all(["host_prescan"])
lib = b.load("host_prescan")
assert lib.pq_zstd_available() in (0, 1)
print(json.dumps({"built": built, "path": b.lib_path("host_prescan")}))
"""


def test_build_lock_compiles_once(tmp_path):
    """Three processes building ``host_prescan`` into one empty directory at
    once: one compiles, all three load the same library."""
    src = os.path.join(ROOT, "parquet_tpu_torch", "ops", "_build.py")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, src,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(len(o["built"]) for o in outs) == [0, 0, 1]
    assert len({o["path"] for o in outs}) == 1
    assert os.path.exists(outs[0]["path"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its log; nothing falls back."""
    spec = importlib.util.spec_from_file_location(
        "_build_copy", os.path.join(ROOT, "parquet_tpu_torch", "ops",
                                    "_build.py"))
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    b.BUILD_DIR = str(tmp_path)
    monkeypatch.setattr(b, "cxx_path", lambda: "false")
    with pytest.raises(RuntimeError, match="the compiler failed building "
                       "host_prescan.cpp"):
        b.load("host_prescan")


def test_codec_ids():
    for cid in (CompressionCodec.UNCOMPRESSED, CompressionCodec.SNAPPY,
                CompressionCodec.GZIP, CompressionCodec.ZSTD):
        assert tcodecs.get_codec(cid).codec_id == cid
