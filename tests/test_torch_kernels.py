"""parquet_tpu_torch's kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode.  Equality is exact: decode is bit movement.
The CUDA kernels themselves run in ``test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest
import torch

from parquet_tpu.ops import pallas_kernels as pk
from parquet_tpu.ops import ref as jref
from parquet_tpu_torch import ParquetFile, write_table
from parquet_tpu_torch.io.reader import resolve_device
from parquet_tpu_torch.ops import kernels


def _pack_words(v: np.ndarray, w: int) -> np.ndarray:
    raw = jref.pack_bits(v, w)
    return np.frombuffer(raw + b"\0" * (-len(raw) % 4), dtype="<u4").copy()


def _as_torch_words(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("w", range(1, 33))
def test_unpack_bits_dense_matches_pallas(w, rng):
    n = 4099  # ragged: the last 32-value group is partial
    v = rng.integers(0, 1 << w, size=n, dtype=np.uint64)
    words = _pack_words(v, w)
    want = np.asarray(pk.unpack_bits_dense(words, n, w, interpret=True))
    got = kernels.unpack_bits_dense_ref(_as_torch_words(words), n, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, v.astype(np.uint32))
    # the wrapper runs the plain version on a CPU tensor and counts nothing
    before = dict(kernels.LAUNCHES)
    wrapped = kernels.unpack_bits_dense(_as_torch_words(words), n, w)
    assert torch.equal(wrapped, got)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("w", [17, 20, 24, 31])
def test_unpack_straddle_lanes(w):
    """Lanes whose value starts at bit 16 of a word and straddles into the
    next (the lanes the Pallas kernel's multiply-straddle exists for):
    all-ones values there, zeros elsewhere.  The Pallas kernel agrees at
    these widths in test_unpack_bits_dense_matches_pallas."""
    n = 64
    lanes = [j for j in range(32) if (j * w) & 31 == 16]
    assert lanes
    v = np.zeros(n, np.uint64)
    for j in lanes:
        v[j::32] = (1 << w) - 1
    words = _pack_words(v, w)
    got = kernels.unpack_bits_dense_ref(_as_torch_words(words), n, w)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  v.astype(np.uint32))


@pytest.mark.parametrize("w,d,dtype", [(1, 2, np.int32), (5, 32, np.float32),
                                       (8, 200, np.int32),
                                       (10, 1024, np.float32)])
def test_dict_unpack_gather_matches_pallas(w, d, dtype, rng):
    n = 1000 + w  # ragged
    if dtype == np.int32:
        dictionary = rng.integers(-2**31, 2**31, d).astype(np.int32)
    else:
        dictionary = rng.standard_normal(d).astype(np.float32)
    idx = rng.integers(0, min(d, 1 << w), size=n, dtype=np.uint64)
    words = _pack_words(idx, w)
    want = np.asarray(pk.dict_unpack_gather(words, dictionary, n, w,
                                            interpret=True))
    got = kernels.dict_unpack_gather(_as_torch_words(words),
                                     torch.from_numpy(dictionary), n, w)
    assert got.dtype == torch.from_numpy(dictionary).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, dictionary[idx.astype(np.int64)])


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_dict_unpack_gather_8_byte_dictionary(dtype, rng):
    n, w, d = 3001, 10, 1000
    dictionary = (rng.integers(-2**62, 2**62, d) if dtype == np.int64
                  else rng.standard_normal(d)).astype(dtype)
    idx = rng.integers(0, d, size=n, dtype=np.uint64)
    words = _pack_words(idx, w)
    got = kernels.dict_unpack_gather(_as_torch_words(words),
                                     torch.from_numpy(dictionary), n, w)
    np.testing.assert_array_equal(got.numpy(), dictionary[idx.astype(np.int64)])


def test_dict_unpack_gather_index_past_dictionary_is_zero():
    """An index past the dictionary yields 0, as the TPU kernel's one-hot
    product does."""
    w, d = 4, 3
    idx = np.array([0, 1, 2, 3, 15, 2] * 6, np.uint64)
    dictionary = np.array([7, 8, 9], np.int32)
    words = _pack_words(idx, w)
    want = np.asarray(pk.dict_unpack_gather(words, dictionary, len(idx), w,
                                            interpret=True))
    got = kernels.dict_unpack_gather(_as_torch_words(words),
                                     torch.from_numpy(dictionary),
                                     len(idx), w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == 0 and got[4] == 0


@pytest.mark.parametrize("w", [3, 8, 15, 31])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_wrappers_short_stream_and_offset_view(w, offset, rng):
    """A stream shorter than ceil(n/32)*w words reads zeros past its end,
    and a view that starts ``offset`` words into its storage (4- but not
    16-byte aligned on a card) reads from its own first word: both
    wrappers against the Pallas kernels in interpret mode, which zero-pad
    the same stream."""
    n = 1000
    v = rng.integers(0, 1 << w, size=n, dtype=np.uint64)
    words = _pack_words(v, w)[:(n * w) // 32 - 2]  # last words cut off
    assert len(words) < (n + 31) // 32 * w
    storage = np.concatenate([rng.integers(0, 2**32, offset,
                                           dtype=np.uint32), words])
    view = _as_torch_words(storage)[offset:]
    assert view.storage_offset() == offset
    want = np.asarray(pk.unpack_bits_dense(words, n, w, interpret=True))
    got = kernels.unpack_bits_dense(view, n, w)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    cut = (len(words) * 32) // w  # values wholly inside the short stream
    np.testing.assert_array_equal(want[:cut], v[:cut].astype(np.uint32))
    dictionary = rng.integers(-2**31, 2**31, 1 << min(w, 10)).astype(np.int32)
    want = np.asarray(pk.dict_unpack_gather(words, dictionary, n, w,
                                            interpret=True))
    got = kernels.dict_unpack_gather(view, torch.from_numpy(dictionary), n, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_bad_operands():
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.unpack_bits_dense(words, 8, 33)
    with pytest.raises(TypeError):
        kernels.unpack_bits_dense(words.to(torch.int64), 8, 4)
    with pytest.raises(ValueError):
        kernels.dict_unpack_gather(words, torch.zeros(1025), 8, 4)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        kernels.unpack_bits_dense(torch.zeros(8, dtype=torch.int32,
                                              device="meta"), 8, 4)


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    """A read that asks for CUDA on a machine without it raises instead of
    decoding on the CPU; the CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "x.parquet"
    write_table({"x": np.arange(10, dtype=np.int64)}, str(path))
    f = ParquetFile(str(path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        f.read()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        f.read(device="cuda")
    assert resolve_device("cpu").type == "cpu"
    np.testing.assert_array_equal(f.read(device="cpu")["x"].values.numpy(),
                                  np.arange(10))

