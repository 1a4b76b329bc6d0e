"""parquet_tpu_torch's codecs against the JAX package's.

Snappy is the port's own C++ (``csrc/host_codec.cpp``) in both directions:
it decodes what ``libsnappy`` (the JAX package's codec) and pyarrow
compress, the JAX package decodes what it compresses, edge cases of the
format decode exactly, and truncated or corrupt streams raise
``CorruptedError``.  ZSTD, LZ4_RAW, LZ4 (Hadoop framing) and BROTLI go
through the system libraries and agree with the JAX package's codecs both
ways.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu import codecs as jcodecs

import parquet_tpu_torch as pqt
from parquet_tpu_torch import codecs as tcodecs
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.format.enums import CompressionCodec as C
from parquet_tpu_torch.ops import host


def _payloads(rng) -> dict:
    return {
        "empty": b"",
        "one": b"x",
        "runs": np.repeat(rng.integers(0, 5, 20_000), 9).astype(
            np.uint8).tobytes(),
        "random": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        "text": b"the quick brown fox jumps over the lazy dog " * 3000,
        "ints": np.cumsum(rng.integers(0, 3, 50_000)).astype(
            np.int64).tobytes(),
    }


def _literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    nb = (n.bit_length() + 7) // 8
    return bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little") + data


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _copy(off: int, length: int, kind: int) -> bytes:
    if kind == 1:
        return bytes([1 | (length - 4) << 2 | (off >> 8) << 5, off & 0xFF])
    if kind == 2:
        return bytes([2 | (length - 1) << 2]) + off.to_bytes(2, "little")
    return bytes([3 | (length - 1) << 2]) + off.to_bytes(4, "little")


def _hand_made() -> dict:
    """Streams built tag by tag: overlapping copies at offsets 1-4, a
    literal longer than 64 KiB, copy-4 tags (32-bit offsets)."""
    out = {}
    for off in (1, 2, 3, 4):
        head = bytes(range(10, 10 + off))
        want = (head * (64 // off + 2))[:off + 60]
        out[f"overlap{off}"] = (_varint(len(want)) + _literal(head)
                                + _copy(off, 60, 2), want)
        short = (head * 20)[:off + 9]
        out[f"overlap{off}_copy1"] = (_varint(len(short)) + _literal(head)
                                      + _copy(off, 9, 1), short)
    big = bytes(np.random.default_rng(0).integers(0, 256, 70_000,
                                                  dtype=np.uint8))
    out["literal_70k"] = (_varint(len(big)) + _literal(big), big)
    want = big[:100] + big[:100][-40:] + big[:100][:64]
    out["copy4"] = (_varint(len(want)) + _literal(big[:100])
                    + _copy(40, 40, 4) + _copy(140, 64, 4), want)
    return out


def test_snappy_matches_libsnappy_both_ways(rng):
    ref = jcodecs.get_codec(C.SNAPPY)  # libsnappy
    mine = tcodecs.get_codec(C.SNAPPY)
    for name, data in _payloads(rng).items():
        enc = mine.encode(data)
        assert bytes(ref.decode(enc, len(data))) == data, name
        assert bytes(mine.decode(ref.encode(data), len(data))) == data, name
        assert bytes(mine.decode(enc, len(data))) == data, name


@pytest.mark.parametrize("case", sorted(_hand_made()))
def test_snappy_edge_cases(case):
    stream, want = _hand_made()[case]
    assert bytes(host.snappy_uncompress(stream, len(want))) == want
    assert bytes(jcodecs.get_codec(C.SNAPPY).decode(stream,
                                                    len(want))) == want


def test_snappy_rejects_bad_streams(rng):
    data = _payloads(rng)["text"]
    enc = host.snappy_compress(data)
    n = len(data)
    bad = {  # name -> (stream, expected size)
        "truncated": (enc[:len(enc) // 2], n),
        "no_length": (b"", 8),
        "long_length": (_varint(n + 1) + enc[len(_varint(n)):], n + 1),
        "offset_past_start": (_varint(8) + _literal(b"ab") + _copy(9, 6, 2),
                              8),
        "zero_offset": (_varint(8) + _literal(b"ab") + _copy(0, 6, 2), 8),
        "copy_past_end": (_varint(5) + _literal(b"ab") + _copy(1, 8, 2), 5),
        "literal_past_input": (_varint(30) + bytes([29 << 2]) + b"abc", 30),
        "bad_varint": (b"\xff\xff\xff\xff\xff\xff", 8),
        "size_mismatch": (enc, n - 1),
    }
    for name, (stream, size) in bad.items():
        with pytest.raises(CorruptedError):
            host.snappy_uncompress(stream, size)
    # every prefix of a valid stream is refused or exact, never more
    for cut in range(0, len(enc), 97):
        try:
            got = host.snappy_uncompress(enc[:cut], len(data))
        except CorruptedError:
            continue
        assert bytes(got) == data


def test_snappy_pages_from_pyarrow_and_the_jax_writer(rng):
    """The port reads pyarrow's Snappy pages, and parquet_tpu and pyarrow
    read the port's."""
    n = 20_000
    table = {"x": rng.integers(0, 50, n).astype(np.int64),
             "s": np.array([f"v{i % 300}" for i in range(n)], dtype=object)}
    buf = io.BytesIO()
    papq.write_table(pa.table(table), buf, compression="snappy",
                     use_dictionary=False)
    got = pqt.ParquetFile(buf.getvalue()).read(device="cpu")
    np.testing.assert_array_equal(got["x"].values.numpy(), table["x"])
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(compression="snappy"))
    data = buf.getvalue()
    np.testing.assert_array_equal(
        np.asarray(parquet_tpu.ParquetFile(data).read(device=False)["x"]
                   .values), table["x"])
    back = papq.read_table(io.BytesIO(data))
    assert back["s"].to_pylist() == list(table["s"])


@pytest.mark.parametrize("codec", [C.GZIP, C.ZSTD, C.LZ4_RAW, C.LZ4,
                                   C.BROTLI])
def test_library_codecs_match_jax_both_ways(codec, rng):
    mine = tcodecs.get_codec(codec)
    ref = jcodecs.get_codec(codec)
    for name, data in _payloads(rng).items():
        assert bytes(ref.decode(mine.encode(data), len(data))) == data, name
        assert bytes(mine.decode(ref.encode(data), len(data))) == data, name
    with pytest.raises(CorruptedError):
        mine.decode(b"\x01\x02\x03\x04\x05\x06\x07\x08", 100)


def test_missing_library_raises_on_first_use(monkeypatch):
    """No other decoder stands in for a codec whose library is missing;
    LZO is not carried at all."""
    monkeypatch.setattr(tcodecs, "system_library", lambda *names: None)
    monkeypatch.setattr(tcodecs, "_codecs", {})
    with pytest.raises(NotImplementedError, match="libzstd"):
        tcodecs.get_codec(C.ZSTD)
    with pytest.raises(NotImplementedError, match="LZO"):
        tcodecs.get_codec(C.LZO)
    assert tcodecs.get_codec(C.SNAPPY).decode(
        tcodecs.get_codec(C.SNAPPY).encode(b"abc" * 9), 27).tobytes() == \
        b"abc" * 9
