"""parquet_tpu_torch's ``verify_file`` against the JAX package's: the same
corrupted bytes go to both, and the issues (kind, row group, column,
offset, in order) and the ``*_checked`` counters must be equal, for files
written by the port's writer, by the JAX package's and by pyarrow.  Every
clean file verifies clean in both.  The decode pass (``decode=True``)
runs the port's read stack on the CPU here (``device="cpu"``) and the
JAX package's host decode; their messages may differ, their places may
not.  No test leaves a thread behind."""

import io
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu.format import metadata as jmd
from parquet_tpu.format import thrift as jthrift

import parquet_tpu_torch as pqt
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

N_ROWS = 6000
RG = 2000  # 3 row groups
COUNTERS = ("file_size", "num_rows", "row_groups", "columns_checked",
            "pages_checked", "crcs_checked", "chunks_decoded")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


def _table() -> dict:
    rng = np.random.default_rng(11)
    f = rng.random(N_ROWS)
    return {"x": np.arange(N_ROWS, dtype=np.int64),
            "s": np.array([f"v{i % 23}" for i in range(N_ROWS)],
                          dtype=object),
            "f": np.ma.masked_array(f, mask=f < 0.1)}


def _port_bytes() -> bytes:
    buf = io.BytesIO()
    pqt.write_table(_table(), buf, pqt.WriterOptions(
        row_group_size=RG, data_page_size=8192, bloom_filters={"s": 10}))
    return buf.getvalue()


def _jax_bytes() -> bytes:
    t = _table()
    buf = io.BytesIO()
    parquet_tpu.write_table(
        pa.table({"x": t["x"], "s": list(t["s"]),
                  "f": pa.array(t["f"].data, mask=t["f"].mask)}), buf,
        parquet_tpu.WriterOptions(row_group_size=RG, data_page_size=8192,
                                  bloom_filters={"s": 10}))
    return buf.getvalue()


def _pyarrow_bytes() -> bytes:
    t = _table()
    buf = io.BytesIO()
    papq.write_table(pa.table({"x": t["x"], "s": list(t["s"]),
                               "f": pa.array(t["f"].data, mask=t["f"].mask)}),
                     buf, row_group_size=RG, data_page_size=8192,
                     write_page_index=True, write_page_checksum=True)
    return buf.getvalue()


WRITERS = {"port": _port_bytes, "jax": _jax_bytes, "pyarrow": _pyarrow_bytes}


@pytest.fixture(scope="module")
def files():
    return {name: make() for name, make in WRITERS.items()}


# ---------------------------------------------------------------------------
# the corruptions
# ---------------------------------------------------------------------------
def _meta(raw: bytes):
    n = struct.unpack("<I", raw[-8:-4])[0]
    return jthrift.deserialize(jmd.FileMetaData, raw[-8 - n:-8])[0]


def _with_footer(raw: bytes, edit) -> bytes:
    """``raw`` with its footer parsed, edited and written back."""
    n = struct.unpack("<I", raw[-8:-4])[0]
    meta = _meta(raw)
    edit(meta)
    blob = jthrift.serialize(meta)
    return raw[:-8 - n] + blob + struct.pack("<I", len(blob)) + b"PAR1"


def _cm(meta, rg, col):
    return meta.row_groups[rg].columns[col].meta_data


def _flip(raw: bytes, at: int, mask: int = 0x01) -> bytes:
    b = bytearray(raw)
    b[at] ^= mask
    return bytes(b)


def _mid_page(raw: bytes, rg: int, col: int) -> int:
    cm = _cm(_meta(raw), rg, col)
    return cm.data_page_offset + (cm.total_compressed_size
                                  - (cm.data_page_offset
                                     - (cm.dictionary_page_offset
                                        or cm.data_page_offset))) // 2


def _dict_page_byte(raw: bytes) -> bytes:
    cm = _cm(_meta(raw), 0, 1)
    if cm.dictionary_page_offset is None:
        return raw
    return _flip(raw, cm.data_page_offset - 2)  # the dictionary's payload


def _smash_header(raw: bytes, rg: int, col: int) -> bytes:
    cm = _cm(_meta(raw), rg, col)
    off = cm.dictionary_page_offset or cm.data_page_offset
    return raw[:off] + b"\xff\xff\xff\xff" + raw[off + 4:]


def _edit(fn):
    return lambda raw: _with_footer(raw, fn)


def _set(rg, col, field, value=None, delta=None, chunk=False):
    def fn(meta):
        c = meta.row_groups[rg].columns[col]
        target = c if chunk else c.meta_data
        old = getattr(target, field)
        if old is None:
            return
        setattr(target, field, value if delta is None else old + delta)
    return fn


CORRUPTIONS = {
    "clean": lambda raw: raw,
    "crc_rg0_x": lambda raw: _flip(raw, _mid_page(raw, 0, 0)),
    "crc_rg1_f": lambda raw: _flip(raw, _mid_page(raw, 1, 2), 0xFF),
    "crc_dictionary": _dict_page_byte,
    "truncated": lambda raw: raw[:-500],
    "tiny": lambda raw: raw[:11],
    "no_tail_magic": lambda raw: raw[:-1] + b"X",
    "no_head_magic": lambda raw: b"PAR0" + raw[4:],
    "footer_length": lambda raw: raw[:-8] + struct.pack(
        "<I", len(raw) * 2) + raw[-4:],
    "footer_garbage": lambda raw: raw[:-30] + b"\xee" * 22 + raw[-8:],
    "smashed_header": lambda raw: _smash_header(raw, 1, 0),
    "num_rows": _edit(lambda m: setattr(m, "num_rows", m.num_rows + 1)),
    "num_values": _edit(_set(1, 0, "num_values", delta=1)),
    "data_page_offset": _edit(_set(1, 0, "data_page_offset", delta=1)),
    "chunk_past_end": _edit(_set(2, 2, "total_compressed_size",
                                 value=1 << 30)),
    "chunk_trailing": _edit(_set(0, 0, "total_compressed_size", delta=7)),
    "offset_index_length": _edit(_set(0, 0, "offset_index_length",
                                      value=1 << 30, chunk=True)),
    "offset_index_shifted": _edit(_set(2, 0, "offset_index_offset",
                                       delta=1, chunk=True)),
    "column_index_shifted": _edit(_set(1, 1, "column_index_offset",
                                       delta=3, chunk=True)),
    "bloom_outside": _edit(_set(0, 1, "bloom_filter_offset",
                                value=1 << 40)),
    "bloom_length": _edit(_set(2, 1, "bloom_filter_length", delta=1)),
    "bloom_header": _edit(_set(1, 1, "bloom_filter_offset", delta=-5)),
    "no_metadata": _edit(lambda m: setattr(
        m.row_groups[1].columns[1], "meta_data", None)),
}


def _key(rep) -> list:
    return [(i.kind, i.row_group, i.column, i.offset) for i in rep.issues]


def _counters(rep) -> dict:
    return {k: getattr(rep, k) for k in COUNTERS}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_same_issues_as_jax(files, writer, corruption):
    raw = CORRUPTIONS[corruption](files[writer])
    got = pqt.verify_file(raw)
    want = parquet_tpu.verify_file(raw)
    assert _key(got) == _key(want), (got.summary(), want.summary())
    # the thrift parser's messages name the package's own classes
    assert [i.message.replace("parquet_tpu_torch.", "parquet_tpu.")
            for i in got.issues] == [i.message for i in want.issues]
    assert _counters(got) == _counters(want)
    assert got.ok == (corruption == "clean" or (
        writer == "pyarrow" and corruption.startswith("bloom"))), \
        got.summary()
    d = got.as_dict()
    assert set(d) == set(want.as_dict())
    assert all(set(i) == {"kind", "message", "row_group", "column",
                          "offset"} for i in d["issues"])


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_same_places_with_decode(files, corruption):
    """``decode=True`` on the port's writer's file: the same issues in
    the same places as the JAX package's host decode (the messages of
    the decode issues are the two read stacks' own), and the same count
    of chunks decoded."""
    raw = CORRUPTIONS[corruption](files["port"])
    got = pqt.verify_file(raw, decode=True, device="cpu")
    want = parquet_tpu.verify_file(raw, decode=True)
    assert _key(got) == _key(want), (got.summary(), want.summary())
    assert _counters(got) == _counters(want)
    if corruption == "clean":
        assert got.ok and got.chunks_decoded == 9


def test_one_crc_issue_located_at_its_page(files):
    """One flipped byte in the middle of a page of row group 1: exactly
    one issue, a CRC issue at that row group, column and page offset."""
    raw = files["port"]
    at = _mid_page(raw, 1, 0)
    rep = pqt.verify_file(_flip(raw, at))
    assert len(rep.issues) == 1, rep.summary()
    issue = rep.issues[0]
    assert (issue.kind, issue.row_group, issue.column) == ("crc", 1, "x")
    pages = pqt.ParquetFile(raw).row_group(1).column(0).pages()
    starts = [p.offset for p in pages]
    assert issue.offset == max(s for s in starts if s <= at)
    assert "row-group=1" in str(issue) and "CORRUPT" in rep.summary()


def test_checks_can_be_turned_off(files):
    raw = CORRUPTIONS["crc_rg0_x"](files["port"])
    rep = pqt.verify_file(raw, crc=False)
    assert rep.ok and rep.crcs_checked == 0
    raw = CORRUPTIONS["offset_index_length"](files["port"])
    assert not pqt.verify_file(raw).ok
    assert pqt.verify_file(raw, indexes=False).ok
    raw = CORRUPTIONS["bloom_outside"](files["port"])
    assert pqt.verify_file(raw, blooms=False).ok


def test_sources_and_their_ownership(files, tmp_path):
    """A path, bytes, a file object and a ``Source`` verify alike; only
    what ``verify_file`` opened is closed."""
    path = tmp_path / "v.parquet"
    path.write_bytes(files["port"])
    want = _counters(pqt.verify_file(files["port"]))
    assert _counters(pqt.verify_file(str(path))) == want
    assert pqt.verify_file(str(path)).path == str(path)
    with open(path, "rb") as f:
        assert _counters(pqt.verify_file(f)) == want
        assert not f.closed
    src = pqt.MmapSource(str(path))
    try:
        assert _counters(pqt.verify_file(src)) == want
        assert src.pread(0, 4) == b"PAR1"  # still open
    finally:
        src.close()
    for verify in (pqt.verify_file, parquet_tpu.verify_file):
        with pytest.raises(FileNotFoundError):  # as the JAX package's
            verify(str(tmp_path / "missing.parquet"))


def test_a_device_error_is_not_corruption(files, monkeypatch):
    """A ``RuntimeError`` of the decode (a card's error) propagates; it
    is never recorded as a defect of the file."""
    from parquet_tpu_torch.parallel import device_reader

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(device_reader, "decode_chunks_pipelined", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pqt.verify_file(files["port"], decode=True, device="cpu")
