"""The encoding registry of parquet_tpu_torch (``ops/encodings.py``)
against parquet_tpu's, on the CPU.

A caller's decode registered over a built-in id is read by both packages
the same way; the port's device route refuses a chunk with such a page
(``HOST_ROUTE["registered_encoding"]``) and its host decode dispatches
through the registry.  Each test restores both packages' built-ins.
"""

import io

import numpy as np
import pytest

import parquet_tpu
from parquet_tpu.algebra import aggregate as JA
from parquet_tpu.ops import encodings as jenc

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.ops import encodings as tenc
from parquet_tpu_torch.parallel import device_reader as tdr

CPU = "cpu"
N = 2_000


@pytest.fixture
def restore():
    """Both packages' registries (and built-in tables) put back after the
    test."""
    mods = (tenc, jenc)
    saved = [(dict(m._REGISTRY), dict(m._BUILTIN)) for m in mods]
    yield
    for m, (reg, builtin) in zip(mods, saved):
        m._REGISTRY.clear()
        m._REGISTRY.update(reg)
        m._BUILTIN.clear()
        m._BUILTIN.update(builtin)
    assert not tenc.any_shadowed()


def _bss_file(vals: np.ndarray) -> bytes:
    buf = io.BytesIO()
    pqt.write_table({"x": vals, "k": np.arange(len(vals), dtype=np.int64)},
                    buf, pqt.WriterOptions(
                        dictionary=False, row_group_size=500,
                        column_encoding={"x": Encoding.BYTE_STREAM_SPLIT}))
    return buf.getvalue()


def _xor(builtin, calls):
    def decode(raw, pos, nvals, leaf, physical, dictionary):
        calls.append(nvals)
        out = builtin.decode(raw, pos, nvals, leaf, physical, dictionary)
        return out ^ np.int32(0xFF) if out.dtype == np.int32 else out
    return decode


def test_builtins_match_jax():
    import parquet_tpu_torch.io.reader  # noqa: F401  (registers them)

    assert pqt.registered_encodings() == parquet_tpu.registered_encodings()
    for key in pqt.registered_encodings():
        assert tenc.is_builtin_decode(key)
        assert (tenc.lookup(key).decode_masked is None) == \
            (jenc.lookup(key).decode_masked is None)
    assert not tenc.any_shadowed()


def test_registered_decode_read_by_both_packages(restore):
    vals = np.random.default_rng(0).integers(0, 1_000, N).astype(np.int32)
    raw = _bss_file(vals)
    tcalls, jcalls = [], []
    key = int(Encoding.BYTE_STREAM_SPLIT)
    pqt.register_encoding(pqt.EncodingSpec(
        key, "BSS_XOR", _xor(tenc.lookup(key), tcalls)), overwrite=True)
    parquet_tpu.register_encoding(parquet_tpu.EncodingSpec(
        key, "BSS_XOR", _xor(jenc.lookup(key), jcalls)), overwrite=True)
    assert tenc.any_shadowed() and not tenc.is_builtin_decode(key)
    tdr.reset_host_route()
    got = pqt.ParquetFile(raw).read(device=CPU)["x"].values.numpy()
    want = parquet_tpu.ParquetFile(raw).read()["x"].to_numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals ^ np.int32(0xFF))
    assert tcalls and jcalls
    # the device route refused every chunk of ``x``, and only those
    assert tdr.HOST_ROUTE["registered_encoding"] == 4
    assert sum(tdr.HOST_ROUTE.values()) == 4


def test_registered_decode_reaches_every_reader(restore):
    """The streamed read, the row-range read and the aggregate each see
    the registered decode, as the whole read does."""
    vals = np.random.default_rng(1).integers(0, 1_000, N).astype(np.int32)
    raw = _bss_file(vals)
    key = int(Encoding.BYTE_STREAM_SPLIT)
    pqt.register_encoding(pqt.EncodingSpec(
        key, "BSS_XOR", _xor(tenc.lookup(key), [])), overwrite=True)
    parquet_tpu.register_encoding(parquet_tpu.EncodingSpec(
        key, "BSS_XOR", _xor(jenc.lookup(key), [])), overwrite=True)
    xored = vals ^ np.int32(0xFF)
    pf = pqt.ParquetFile(raw)
    batches = [b["x"].values.numpy()
               for b in pf.iter_batches(batch_rows=300, device=CPU)]
    np.testing.assert_array_equal(np.concatenate(batches), xored)
    np.testing.assert_array_equal(pqt.read_row_range(pf, "x", 123, 900),
                                  xored[123:1023])
    got = pf.aggregate([pqt.sum_("x"), pqt.max_("x"), pqt.count()],
                       where=pqt.col("k").between(100, 1_700), device=CPU)
    want = parquet_tpu.ParquetFile(raw).aggregate(
        [JA.sum_("x"), JA.max_("x"), JA.count()],
        where=parquet_tpu.col("k").between(100, 1_700))
    assert dict(got.items()) == dict(want.items())
    assert got["sum(x)"] == int(xored[100:1701].astype(np.int64).sum())


def test_duplicate_registration_is_loud(restore):
    spec = tenc.lookup(int(Encoding.PLAIN))
    with pytest.raises(ValueError, match="already registered"):
        pqt.register_encoding(spec)
    with pytest.raises(ValueError, match="already registered"):
        parquet_tpu.register_encoding(jenc.lookup(int(Encoding.PLAIN)))
    pqt.register_encoding(spec, overwrite=True)  # the same spec back
    assert tenc.is_builtin_decode(int(Encoding.PLAIN))


def test_a_new_id_is_registered_not_builtin(restore):
    spec = pqt.EncodingSpec(77, "MY_ENC", lambda *a: None)
    pqt.register_encoding(spec)
    assert pqt.registered_encodings()[77] == "MY_ENC"
    assert not tenc.is_builtin_decode(77)
    assert tenc.lookup(77) is spec


def test_registering_again_keeps_a_callers_shadow(restore):
    """The built-ins' registration runs again (as on a reload of the
    reader) without clobbering a caller's decode of a built-in id."""
    from parquet_tpu_torch.io import reader as treader

    key = int(Encoding.BYTE_STREAM_SPLIT)
    mine = pqt.EncodingSpec(key, "MINE", tenc.lookup(key).decode)
    pqt.register_encoding(mine, overwrite=True)
    plain = tenc.lookup(int(Encoding.PLAIN))
    treader._register_builtins()
    assert tenc.lookup(key) is mine
    assert tenc.lookup(int(Encoding.PLAIN)) is not plain  # re-registered
    assert tenc.is_builtin_decode(int(Encoding.PLAIN))
