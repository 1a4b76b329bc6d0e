"""The device read's staging and pipeline in parquet_tpu_torch, on the CPU.

One staging batch a chunk (``device_reader._StagingBatch``: one buffer,
256-byte-aligned operands, zeroed slack), ``prepare_chunks_batched`` over
many chunks, the pipelined read against its serial form
(``workers=0``) and the JAX package's device and host reads, error order
and teardown of the pipeline, the page-batch decode of a lone chunk, and
the memory-mapped source.  Files stay small and pools at two workers;
every test ends with the threads it started with.
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

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import CorruptedError, _Unsupported
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.io.column import concat_columns
from parquet_tpu_torch.io.prefetch import make_chunk_prefetcher
from parquet_tpu_torch.io.reader import PageInfo, decode_chunk_host
from parquet_tpu_torch.io.source import (BytesSource, FileSource,
                                        MmapSource, as_source)
from parquet_tpu_torch.parallel import device_reader as tdr
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    pqt.reset_host_route()
    pqt.reset_pipeline()
    yield
    assert_no_thread_started(before)


def _chunks(f):
    return [rg.column(leaf.column_index)
            for leaf in f.schema.leaves for rg in f.row_groups]


def _read(f, workers: int) -> dict:
    """``ParquetFile.read`` with the pipeline's ``workers`` set."""
    gen = tdr.decode_chunks_pipelined(_chunks(f), CPU, workers)
    out = {leaf.name: concat_columns([next(gen) for _ in f.row_groups])
           for leaf in f.schema.leaves}
    gen.close()
    return out


def _dense(col) -> tuple:
    """A flat column as host numpy: (values, validity or None)."""
    got = col.materialize_host()
    validity = None if col.validity is None else col.validity.numpy()
    return got, validity


def _assert_same(a, b, name):
    (va, ma), (vb, mb) = _dense(a), _dense(b)
    if isinstance(va, tuple):
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(x, y, err_msg=name)
    else:
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va.view(np.uint8), vb.view(np.uint8),
                                      err_msg=name)
    np.testing.assert_array_equal(ma, mb, err_msg=name)
    assert a.num_slots == b.num_slots, name


# (a) ------------------------------------------------------------------------


def test_batch_layout():
    """Every operand at a 256-byte-aligned offset, equal to its array,
    its slack zeroed, streams spanning a multiple of 16 bytes, so the
    dense streams view as int32."""
    rng = np.random.default_rng(1)
    arrays = [rng.integers(-9, 9, 37).astype(np.int64),
              rng.random(5).astype(np.float32),
              rng.random(11) < 0.5,
              rng.integers(0, 255, (7, 3), dtype=np.uint8),
              np.zeros(0, np.int64)]
    accum = tdr._ByteAccum()
    parts = [rng.integers(0, 256, n, dtype=np.uint8) for n in (5, 0, 17)]
    for p in parts:
        accum.extend(p)
    values = rng.integers(0, 256, 1000, dtype=np.uint8)
    starts = np.array([0, 100, 990])  # the last miniblock truncated
    gather = tdr._MiniblockGather(values, starts, 16)
    batch = tdr._StagingBatch()
    slots = [batch.put(a) for a in arrays]
    acc_slot = batch.put(accum, extra=12)
    dense_slot = batch.put(gather, extra=4)
    host = batch.pack(pin=False)
    staged = batch.resolve({"a": slots, "acc": acc_slot,
                            "dense": (dense_slot,)}, host)
    for slot in slots + [acc_slot, dense_slot]:
        assert slot.off % 256 == 0 and slot.span % 16 == 0
    laid = sorted((s.off, s.span) for s in slots + [acc_slot, dense_slot])
    assert all(a + n <= b for (a, n), (b, _) in zip(laid, laid[1:]))
    for a, t in zip(arrays, staged["a"]):
        assert t.numpy().dtype == a.dtype and t.shape == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    acc = staged["acc"].numpy()
    assert len(acc) == acc_slot.span >= len(accum) + 12
    np.testing.assert_array_equal(acc[:len(accum)], np.concatenate(parts))
    assert not acc[len(accum):].any()
    dense = staged["dense"][0]
    want = np.concatenate([values[s:s + 16] if s + 16 <= len(values) else
                           np.concatenate([values[s:], np.full(
                               s + 16 - len(values), values[-1])])
                           for s in starts])
    np.testing.assert_array_equal(dense.numpy()[:48], want)
    assert not dense.numpy()[48:].any() and dense.numel() >= 52
    words = dense.view(torch.int32)
    np.testing.assert_array_equal(words.numpy()[:12], want.view(np.int32))
    assert batch.nbytes == host.numel() and host.numel() % 256 == 0


def test_commit_without_operands_is_a_no_op():
    staged = (None, None, {"x": 1})
    assert tdr._StagingBatch().commit(staged, CPU) == (staged, None)


# (b) ------------------------------------------------------------------------

ROWS = 7000
ENCODINGS = {
    "plain": ("i32", "i64", "f32", "f64"),
    "dict": ("i32", "i64", "f32", "f64"),
    "delta": ("i32", "i64"),
}
TYPES = {"i32": np.int32, "i64": np.int64, "f32": np.float32,
         "f64": np.float64}
PORT_ENCODING = {"plain": Encoding.PLAIN, "dict": Encoding.RLE_DICTIONARY,
                 "delta": Encoding.DELTA_BINARY_PACKED}


def _matrix_file(enc: str, nulls: str) -> bytes:
    """The encoding x nulls case of ``test_torch_device_reader.py``'s
    matrix, written by the port's writer: v1 pages, UNCOMPRESSED."""
    rng = np.random.default_rng(zlib.crc32(f"{enc}/{nulls}".encode()))
    mask = None
    if nulls != "required":
        mask = rng.random(ROWS) < 0.2
        if nulls == "null_page":
            mask[1000:2700] = True  # at least one whole page
    table, encodings = {}, {}
    for name in ENCODINGS[enc]:
        dt = TYPES[name]
        v = (rng.integers(-500, 500, ROWS) / 8).astype(dt) if dt in (
            np.float32, np.float64) else rng.integers(-300, 300,
                                                      ROWS).astype(dt)
        if enc == "delta":
            v = np.cumsum(v, dtype=v.dtype)
        col = f"{enc}_{name}"
        table[col] = v if mask is None else np.ma.masked_array(v, mask=mask)
        encodings[col] = PORT_ENCODING[enc]
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=3000, data_page_size=2048,
        column_encoding=encodings))
    return buf.getvalue()


@pytest.mark.parametrize("nulls", ["required", "optional", "null_page"])
@pytest.mark.parametrize("enc", sorted(ENCODINGS))
def test_stage_plan_with_and_without_a_batch(enc, nulls):
    """Each chunk staged in a batch of its own (``stage_plan(plan,
    device)``) and recorded into one batch shared by every chunk of the
    file decode to the same columns."""
    f = pqt.ParquetFile(_matrix_file(enc, nulls))
    chunks = _chunks(f)
    alone = []
    for reader in chunks:
        plan = tdr.build_plan(reader)
        alone.append(tdr.decode_staged(plan, tdr.stage_plan(plan, CPU), CPU))
    batch = tdr._StagingBatch()
    plans, staged = [], []
    for reader in chunks:
        plans.append(tdr.build_plan(reader))
        staged.append(tdr.stage_plan(plans[-1], CPU, batch.put))
    staged, ready = batch.commit(staged, CPU)
    assert ready is None
    for reader, plan, s, want in zip(chunks, plans, staged, alone):
        _assert_same(tdr.decode_staged(plan, s, CPU), want, reader.leaf.name)


# (c) ------------------------------------------------------------------------


def test_prepare_chunks_batched_keeps_order_and_refusals():
    """The host-route fixture: every chunk in input order, the chunks the
    device route refuses carried as ``_Unsupported`` errors (none raised),
    the others decoding as the read decodes them."""
    import os

    path = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                        "host_route.parquet")
    want_refused = int(np.load(path[:-len(".parquet")] + ".npz")[
        "host_route_chunks"])
    f = pqt.ParquetFile(path)
    chunks = _chunks(f)[::-1]  # any order is kept
    got = tdr.prepare_chunks_batched(chunks, "cpu")
    assert [r for r, _, _ in got] == chunks
    refused = [(r, e) for r, p, e in got if e is not None]
    assert len(refused) == want_refused
    assert all(isinstance(e, _Unsupported) and e.reason ==
               "mixed_page_kinds" for _, e in refused)
    assert all(p is None for _, p, e in got if e is not None)
    assert sum(pqt.HOST_ROUTE.values()) == 0  # counted by the read only
    for reader, prepped, err in got:
        if err is None:
            plan = tdr.build_plan(reader)
            want = tdr.decode_staged(plan, tdr.stage_plan(plan, CPU), CPU)
            _assert_same(tdr.decode_staged(*prepped, CPU), want,
                         reader.leaf.name)


# (d) ------------------------------------------------------------------------


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
    assert isinstance(f.source, MmapSource)
    serial = _read(f, 0)
    serial_route = dict(pqt.HOST_ROUTE)
    assert pqt.PIPELINE["stage_concurrency_peak"] == 0
    pqt.reset_pipeline()
    pipelined = f.read(device="cpu")
    assert pqt.PIPELINE["stage_concurrency_peak"] >= 2
    assert pqt.PIPELINE["chunks_device_decoded"] == 4 * len(f.row_groups)
    assert pqt.HOST_ROUTE == {k: 2 * v for k, v in serial_route.items()}
    assert f.source.__class__ is MmapSource  # the prefetcher is gone
    jfile = parquet_tpu.ParquetFile(path)
    jdev = jfile.read(device=True)
    jhost = jfile.read()
    for name in ("x", "f", "i", "o"):
        _assert_same(pipelined[name], serial[name], name)
        got = pipelined[name]
        values = got.values.numpy()
        for ref in (jdev[name].to_arrow(), jhost[name].to_arrow()):
            valid = ref.is_valid().to_numpy(zero_copy_only=False)
            want = ref.drop_null().to_numpy(zero_copy_only=False)
            assert values.dtype == want.dtype, name
            np.testing.assert_array_equal(values, want, err_msg=name)
            if got.validity is None:
                assert valid.all(), name
            else:
                np.testing.assert_array_equal(got.validity.numpy(), valid)


# (e) ------------------------------------------------------------------------


def _corrupt_file(path, chunk: int) -> list:
    """A 4-row-group file of one column whose chunk ``chunk`` starts with
    garbage where its first page header is."""
    pqt.write_table({"x": np.arange(4000, dtype=np.int64)}, path,
                    pqt.WriterOptions(row_group_size=1000))
    f = pqt.ParquetFile(path)
    start, _ = _chunks(f)[chunk].byte_range
    f.close()
    with open(path, "r+b") as fh:
        fh.seek(start)
        fh.write(b"\xff" * 16)
    return np.arange(4000).reshape(4, 1000)


@pytest.mark.parametrize("workers", [0, 2])
def test_corrupt_chunk_raises_at_its_turn(tmp_path, workers):
    path = str(tmp_path / "bad.parquet")
    want = _corrupt_file(path, 2)
    f = pqt.ParquetFile(path)
    gen = tdr.decode_chunks_pipelined(_chunks(f), CPU, workers)
    for k in range(2):
        np.testing.assert_array_equal(next(gen).values.numpy(), want[k])
    with pytest.raises(CorruptedError, match="page header"):
        next(gen)
    with pytest.raises(StopIteration):
        next(gen)
    assert sum(pqt.HOST_ROUTE.values()) == 0


def test_early_close_leaves_no_thread(tmp_path):
    path = str(tmp_path / "ok.parquet")
    pqt.write_table({"x": np.arange(4000, dtype=np.int64)}, path,
                    pqt.WriterOptions(row_group_size=500))
    f = pqt.ParquetFile(path)
    gen = tdr.decode_chunks_pipelined(_chunks(f), CPU, 2)
    np.testing.assert_array_equal(next(gen).values.numpy(), np.arange(500))
    gen.close()
    assert f.source.__class__ is MmapSource


# (f) ------------------------------------------------------------------------


def _one_chunk(table, **kw) -> pqt.ParquetFile:
    buf = io.BytesIO()
    papq.write_table(pa.table(table), buf, **kw)
    return pqt.ParquetFile(buf.getvalue())


def test_decode_chunk_batched_equals_one_plan():
    """A flat 16-page chunk of each value kind (PLAIN with nulls, a
    dictionary, byte arrays) decodes in page batches exactly as in one
    plan, its dictionary staged once."""
    rng = np.random.default_rng(3)
    n = 16 * 512
    m = rng.random(n) < 0.1
    words = np.array([f"w{i}" * (i % 5) for i in range(300)], dtype=object)
    f = _one_chunk({"p": pa.array(rng.integers(0, 10**9, n), mask=m),
                    "d": pa.array(rng.integers(0, 90, n).astype(np.int32)),
                    "s": pa.array(words[rng.integers(0, 300, n)])},
                   row_group_size=n, data_page_size=1, write_batch_size=512,
                   use_dictionary=["d"], compression="none")
    for i, leaf in enumerate(f.schema.leaves):
        reader = f.row_groups[0].column(i)
        assert sum(1 for p in reader.pages() if p.num_values and
                   p.header.dictionary_page_header is None) == 16
        plan = tdr.build_plan(reader)
        want = tdr.decode_staged(plan, tdr.stage_plan(plan, CPU), CPU)
        got = tdr.decode_chunk_batched(reader, CPU)
        _assert_same(got, want, leaf.name)
        if leaf.name == "d":
            assert got.dictionary is not None
            assert torch.equal(got.dictionary, want.dictionary)


def test_decode_chunk_batched_refuses():
    rng = np.random.default_rng(4)
    n = 16 * 512
    nested = _one_chunk({"l": pa.array([[1, 2]] * n)}, data_page_size=1,
                        write_batch_size=512)
    with pytest.raises(_Unsupported, match="nested"):
        tdr.decode_chunk_batched(nested.row_groups[0].column(0), CPU)
    # a dictionary that overflows into PLAIN pages part way
    fallback = _one_chunk({"k": rng.integers(0, 1 << 40, n)},
                          data_page_size=1, write_batch_size=512,
                          dictionary_pagesize_limit=4096)
    reader = fallback.row_groups[0].column(0)
    kinds = {p.header.data_page_header.encoding for p in reader.pages()
             if p.header.data_page_header is not None}
    assert len(kinds) == 2
    with pytest.raises(_Unsupported):
        tdr.decode_chunk_batched(reader, CPU)
    few = _one_chunk({"x": np.arange(100)})
    with pytest.raises(_Unsupported, match="too few pages"):
        tdr.decode_chunk_batched(few.row_groups[0].column(0), CPU)


def test_decode_chunk_batched_raises_the_one_plan_error():
    """A truncated PLAIN page in the second batch raises the
    ``CorruptedError`` the one-plan decode raises, and nothing else."""
    n = 16 * 512
    f = _one_chunk({"x": np.arange(n)}, data_page_size=1,
                   write_batch_size=512, use_dictionary=False,
                   compression="none")
    reader = f.row_groups[0].column(0)
    pages = list(reader.pages())
    bad = pages[12]
    pages[12] = PageInfo(bad.header, bad.payload[:-8], bad.offset)
    chunk = SimpleNamespace(leaf=reader.leaf, meta=reader.meta,
                            codec=reader.codec, pages=lambda: iter(pages))
    with pytest.raises(CorruptedError) as one_plan:
        tdr.build_plan(chunk)
    with pytest.raises(CorruptedError) as batched:
        tdr.decode_chunk_batched(chunk, CPU)
    assert str(batched.value) == str(one_plan.value)


# (g) ------------------------------------------------------------------------


def test_mmap_source_reads(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 10_000,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "blob"
    path.write_bytes(data)
    m, fs, bs = MmapSource(path), FileSource(path), BytesSource(data)
    for off, size in ((0, 10_000), (1, 0), (4095, 3000), (9_999, 1)):
        want = data[off:off + size]
        assert m.pread(off, size) == fs.pread(off, size) == \
            bs.pread(off, size) == want
        view = m.pread_view(off, size)
        assert bytes(view) == want and not view.flags.writeable
    for src in (m, fs, bs):
        with pytest.raises(CorruptedError, match="past the end"):
            src.pread(9_000, 1_001)
    with pytest.raises(CorruptedError):
        m.pread_view(-1, 4)
    pre = make_chunk_prefetcher(m)  # reads through, advised ahead
    assert make_chunk_prefetcher(fs) is None
    assert make_chunk_prefetcher(bs) is None
    pre.plan(4096, 5_000)
    assert bytes(pre.pread_view(4096, 5_000)) == data[4096:9096]
    assert pre.pread(0, 8) == data[:8] and pre.size() == 10_000
    pre.close()
    m.madvise_willneed(0, 10_000)
    view = m.pread_view(0, 16)
    m.close()
    assert bytes(view) == data[:16]  # a live view keeps the map
    with pytest.raises(ValueError, match="closed"):
        m.pread(0, 1)
    fs.close()
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    src = as_source(str(empty))
    assert type(src) is FileSource and src.size() == 0
    src.close()
    with pytest.raises(CorruptedError, match="too small"):
        pqt.ParquetFile(str(empty))


def _tensors(col):
    yield from (col.values, col.offsets, col.validity, col.dict_indices)
    if isinstance(col.dictionary, tuple):
        yield from col.dictionary
    else:
        yield col.dictionary
    yield from col.list_offsets
    yield from col.list_validity


def test_no_column_aliases_the_map(tmp_path):
    """PLAIN, dictionary and byte-array columns, UNCOMPRESSED (page
    bodies are views of the map), read by the device route on the CPU and
    by the host route: no tensor shares memory with the map.  ``q`` is a
    dictionary by the default rule, ``d`` and ``s`` by a forced one."""
    rng = np.random.default_rng(6)
    n = 5000
    path = str(tmp_path / "plain.parquet")
    pqt.write_table({
        "p": np.ma.masked_array(rng.integers(0, 10**9, n),
                                mask=rng.random(n) < 0.1),
        "q": rng.integers(0, 50, n),
        "d": rng.integers(0, 40, n).astype(np.int32),
        "s": np.array([b"v%d" % (i % 97) for i in range(n)], dtype=object),
        "f": rng.integers(0, 256, (n, 4), dtype=np.uint8)},
        path, pqt.WriterOptions(column_encoding={
            "d": Encoding.RLE_DICTIONARY, "s": Encoding.RLE_DICTIONARY}))
    f = pqt.ParquetFile(path)
    whole = f.source.pread_view(0, f.source.size())
    cols = list(f.read(device="cpu").values())
    cols += [decode_chunk_host(r, "cpu") for r in _chunks(f)]
    checked = 0
    for col in cols:
        for t in _tensors(col):
            if t is not None and t.numel():
                assert not np.shares_memory(t.numpy(), whole), col.leaf.name
                checked += 1
    assert checked >= 16
