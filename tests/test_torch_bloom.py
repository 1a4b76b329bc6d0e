"""parquet_tpu_torch's bloom filters and its ``bloom_check`` and
``bloom_check_segments`` plain versions against the JAX package's: xxhash,
filter sizes and bitset bytes, the host probe, the jnp device probe and the
Pallas ``bloom_check_blocks`` kernel in interpret mode, all exact."""

import numpy as np
import pytest
import torch

from parquet_tpu.io import bloom as jbloom
from parquet_tpu.ops import pallas_kernels as pk
from parquet_tpu.schema.schema import Leaf as JLeaf
from parquet_tpu.schema.schema import Node as JNode

from parquet_tpu_torch.format.enums import Type
from parquet_tpu_torch.io import bloom as tbloom
from parquet_tpu_torch.ops import kernels
from parquet_tpu_torch.schema.schema import Leaf

M32 = np.uint64(0xFFFFFFFF)


def _hashes(n: int, seed: int) -> np.ndarray:
    """Random 64-bit hashes, every 7th with all high bits set (the filter's
    last block)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    h[::7] |= np.uint64(0xFFFFFFFF00000000)
    return h


def _filter(z: int, seed: int, hashes: np.ndarray) -> tbloom.SplitBlockFilter:
    """A z-block filter holding half of ``hashes`` plus random bits."""
    rng = np.random.default_rng(seed)
    blocks = (rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
              & rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
              & rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
              ).astype(np.uint32)
    f = tbloom.SplitBlockFilter(blocks)
    f.insert_hashes(hashes[::2])
    return f


def _pallas_probe(blocks: np.ndarray, h: np.ndarray) -> np.ndarray:
    """The Pallas ``bloom_check_blocks`` in interpret mode on the blocks
    that ``h`` picks, gathered as the reference's ``jnp.take`` gathers
    them."""
    import jax.numpy as jnp

    z = blocks.shape[0]
    block = (((h >> np.uint64(32)) * np.uint64(z)) >> np.uint64(32)
             ).astype(np.int64)
    gathered = jnp.asarray(blocks[block])
    low = jnp.asarray((h & M32).astype(np.uint32))
    return np.asarray(pk.bloom_check_blocks(gathered, low, interpret=True))


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32,
                                   np.float32])
def test_xxhash_matches_jax(dtype, rng):
    vals = rng.integers(-2**31, 2**31 - 1, 5000).astype(dtype)
    if dtype in (np.int64, np.float64):
        want = jbloom.xxh64_u64(vals.view(np.uint64))
        got = tbloom.xxh64_u64(vals.view(np.uint64))
    else:
        want = jbloom.xxh64_u32(vals.view(np.uint32))
        got = tbloom.xxh64_u32(vals.view(np.uint32))
    np.testing.assert_array_equal(got, want)
    # and against the generic byte-wise xxhash of the PLAIN bytes
    for v in vals[:5]:
        assert int(got[list(vals).index(v)]) == jbloom.xxh64_bytes(
            np.asarray(v).tobytes())


@pytest.mark.parametrize("ndv", [1, 8, 1000, 1 << 20])
@pytest.mark.parametrize("bits", [5, 10, 16])
def test_filter_sizes_match_jax(ndv, bits):
    assert (tbloom.SplitBlockFilter.for_ndv(ndv, bits).blocks.shape
            == jbloom.SplitBlockFilter.for_ndv(ndv, bits).blocks.shape)


@pytest.mark.parametrize("physical", [Type.INT32, Type.INT64, Type.FLOAT,
                                      Type.DOUBLE])
def test_writer_bitset_bytes_match_jax(physical, rng):
    dt = {Type.INT32: np.int32, Type.INT64: np.int64, Type.FLOAT: np.float32,
          Type.DOUBLE: np.float64}[physical]
    vals = rng.integers(-10**6, 10**6, 20_000).astype(dt)
    leaf = Leaf(0, "x", physical)
    jleaf = JLeaf(0, ("x",), JNode("x", physical_type=physical), 0, 0)
    got = tbloom.build_split_block_filter(leaf, vals, None, 10)
    want = jbloom.build_split_block_filter(
        jleaf, type("D", (), {"values": vals, "offsets": None})(), None,
        None, 10)
    assert got == want
    # probes hash as the reference's do, and the filter holds every value
    probes = [v.item() for v in vals[:50]]
    np.testing.assert_array_equal(tbloom.hash_probe_values(leaf, probes),
                                  jbloom.hash_probe_values(jleaf, probes))
    f = tbloom.SplitBlockFilter.from_bytes(got)
    assert f.check_hashes(tbloom.hash_probe_values(leaf, probes)).all()


@pytest.mark.parametrize("z", [1, 1024, 65_536])
@pytest.mark.parametrize("n", [1000, 32_768])
def test_device_probe_matches_jax_three_ways(z, n):
    """``check_hashes_batch(prefer_device=True, device="cpu")`` runs
    ``bloom_check_ref``; it equals the reference's host probe, its jnp
    device probe and the Pallas kernel in interpret mode."""
    h = _hashes(n, seed=z + n)
    f = _filter(z, seed=z, hashes=h)
    got = f.check_hashes_batch(h, prefer_device=True, device="cpu")
    jf = jbloom.SplitBlockFilter(f.blocks.copy())
    np.testing.assert_array_equal(got, jf.check_hashes(h))
    np.testing.assert_array_equal(got, np.asarray(jf.check_hashes_device(h)))
    np.testing.assert_array_equal(got, _pallas_probe(f.blocks, h))
    assert 0 < got.sum() < n or z == 1


# (blocks, hashes) per segment: one segment; eight equal ones; uneven ones
# with empty ones among them; z = 1 beside z = 65,536; batch sizes that are
# not multiples of 4
SEGMENT_LAYOUTS = {
    "one": [(1024, 6_000)],
    "eight_equal": [(65_536, 4_096)] * 8,
    "uneven_with_empty": [(64, 0), (1024, 3_003), (1, 0), (4096, 17),
                          (65_536, 9_001), (256, 0)],
    "z1_beside_z65536": [(1, 2_999), (65_536, 3_001), (1, 7), (65_536, 2)],
    "ragged": [(512, 4_097), (2048, 3), (512, 1)],
}


@pytest.mark.parametrize("layout", sorted(SEGMENT_LAYOUTS))
def test_segments_ref_matches_jax_three_ways(layout):
    """``bloom_check_segments_ref`` (and the CPU wrapper, and
    ``check_hashes_multi``) equals, segment by segment, the reference's
    numpy probe, the Pallas kernel in interpret mode and the port's
    one-filter ``bloom_check_ref``."""
    filters, batches = [], []
    for j, (z, n) in enumerate(SEGMENT_LAYOUTS[layout]):
        h = _hashes(n, seed=len(layout) + j)
        filters.append(_filter(z, seed=z + j, hashes=h))
        batches.append(h)
    starts = np.zeros(len(batches) + 1, np.int64)
    np.cumsum([len(h) for h in batches], out=starts[1:])
    blocks = [f.device_blocks("cpu") for f in filters]
    hashes = torch.from_numpy(np.concatenate(batches).view(np.int64))
    got = kernels.bloom_check_segments_ref(blocks, hashes,
                                           torch.from_numpy(starts))
    assert torch.equal(kernels.bloom_check_segments(
        blocks, hashes, torch.from_numpy(starts)), got)
    got = got.numpy()
    multi = tbloom.check_hashes_multi(filters, batches, device="cpu")
    for f, h, blk, a, b, m in zip(filters, batches, blocks, starts[:-1],
                                  starts[1:], multi):
        np.testing.assert_array_equal(m, got[a:b])
        if not len(h):
            continue
        jf = jbloom.SplitBlockFilter(f.blocks.copy())
        np.testing.assert_array_equal(got[a:b], jf.check_hashes(h))
        np.testing.assert_array_equal(got[a:b], _pallas_probe(f.blocks, h))
        np.testing.assert_array_equal(
            got[a:b], kernels.bloom_check_ref(blk, hashes[a:b]).numpy())
    assert 0 < got.sum() < len(got)


def test_batch_routes_by_size_only(monkeypatch):
    """At least ``_DEVICE_PROBE_MIN`` hashes take the device probe (here
    ``bloom_check_ref``, the tensors being on the CPU); fewer take numpy."""
    calls = []
    real = kernels.bloom_check_ref
    monkeypatch.setattr(kernels, "bloom_check_ref",
                        lambda *a: calls.append(1) or real(*a))
    f = _filter(1024, seed=1, hashes=_hashes(100, 1))
    small = _hashes(tbloom.SplitBlockFilter._DEVICE_PROBE_MIN - 1, 2)
    big = _hashes(tbloom.SplitBlockFilter._DEVICE_PROBE_MIN, 3)
    np.testing.assert_array_equal(f.check_hashes_batch(small, device="cpu"),
                                  f.check_hashes(small))
    assert calls == []
    np.testing.assert_array_equal(f.check_hashes_batch(big, device="cpu"),
                                  f.check_hashes(big))
    assert calls == [1]


def test_device_copy_cached_and_dropped_by_insert():
    f = _filter(64, seed=3, hashes=_hashes(10, 3))
    a = f.device_blocks("cpu")
    assert f.device_blocks("cpu") is a
    f.insert_hashes(_hashes(10, 4))
    b = f.device_blocks("cpu")
    assert b is not a
    np.testing.assert_array_equal(b.numpy().view(np.uint32), f.blocks)


def test_cuda_probe_without_card_raises():
    f = _filter(64, seed=3, hashes=_hashes(10, 3))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        f.check_hashes_batch(_hashes(40_000, 5), device="cuda")


def test_bloom_check_rejects_bad_operands():
    f = torch.zeros((4, 8), dtype=torch.int32)
    h = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        kernels.bloom_check(torch.zeros((4, 4), dtype=torch.int32), h)
    with pytest.raises(TypeError):
        kernels.bloom_check(f, h.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.bloom_check(torch.zeros((0, 8), dtype=torch.int32), h)
    assert kernels.bloom_check(f, h).dtype == torch.bool


_F = torch.zeros((4, 8), dtype=torch.int32)
BAD_SEGMENT_OPERANDS = {
    "starts_not_ascending": ([_F, _F, _F], [0, 6, 4, 10], ValueError),
    "starts_not_from_zero": ([_F], [2, 10], ValueError),
    "length_mismatch": ([_F, _F], [0, 4, 12], ValueError),
    "starts_count": ([_F, _F], [0, 10], ValueError),
    "starts_int32": ([_F], torch.tensor([0, 10], dtype=torch.int32),
                     TypeError),
    "filter_not_z_by_8": ([_F, torch.zeros((4, 4), dtype=torch.int32)],
                          [0, 4, 10], TypeError),
    "no_filter": ([], [0], ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_SEGMENT_OPERANDS))
def test_bloom_check_segments_rejects_bad_operands(case):
    """The CPU wrapper and the plain version refuse what the kernel would
    refuse: starts that do not ascend from 0 to n, one per segment and a
    last; a filter not of shape (z, 8); no filter at all."""
    filters, starts, err = BAD_SEGMENT_OPERANDS[case]
    if not isinstance(starts, torch.Tensor):
        starts = torch.tensor(starts, dtype=torch.int64)
    h = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(err):
        kernels.bloom_check_segments(filters, h, starts)
    with pytest.raises(err):
        kernels.bloom_check_segments_ref(filters, h, starts)
