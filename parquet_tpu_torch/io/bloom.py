"""Split-block bloom filters (SBBF) and xxhash64 for fixed-width values.

The port's cut of ``parquet_tpu/io/bloom.py`` for INT32/INT64/FLOAT/DOUBLE.
Format (Parquet ``bloom_filter.md``): a filter is ``z`` 32-byte blocks of 8
little-endian uint32 words; a value's xxh64 ``h`` picks block
``((h >> 32) * z) >> 32`` and sets, in word ``i``, bit
``(low32(h) * SALT[i] mod 2^32) >> 27``.  It is stored as a thrift
``BloomFilterHeader`` and the raw bitset at
``ColumnMetaData.bloom_filter_offset``.

:meth:`SplitBlockFilter.check_hashes_batch` routes as the reference does,
by batch size only: a batch of at least ``_DEVICE_PROBE_MIN`` hashes goes to
the device probe, a smaller one to the numpy probe on the host.  The device
probe, :func:`check_hashes_multi`, tests the batches of many filters in one
:func:`~parquet_tpu_torch.ops.kernels.bloom_check_segments` call on the
caller's device: the CUDA kernel for a card, its plain version for the
CPU.  A failed build or launch of the kernel raises; nothing falls back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..format import metadata as md
from ..format import thrift
from ..format.enums import Type
from ..schema.schema import Leaf

_SALT = np.array([
    0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
    0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31,
], dtype=np.uint64)

_P1 = np.uint64(11400714785074694791)
_P2 = np.uint64(14029467366897019727)
_P3 = np.uint64(1609587929392839161)
_P4 = np.uint64(9650029242287828579)
_P5 = np.uint64(2870177450012600261)
_M = np.uint64(0xFFFFFFFFFFFFFFFF)


@np.errstate(over="ignore")
def _rotl(x, r: int):
    r = np.uint64(r)
    return ((x << r) | (x >> (np.uint64(64) - r))) & _M


@np.errstate(over="ignore")
def _avalanche(h):
    h = h ^ (h >> np.uint64(33))
    h = (h * _P2) & _M
    h = h ^ (h >> np.uint64(29))
    h = (h * _P3) & _M
    h = h ^ (h >> np.uint64(32))
    return h


@np.errstate(over="ignore")
def xxh64_u64(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """xxhash64 of each 8-byte little-endian value: ``XXH64(&v, 8, seed)``,
    the hash Parquet defines for INT64 and DOUBLE."""
    v = values.astype(np.uint64)
    acc = (np.uint64(seed) + _P5 + np.uint64(8)) & _M
    k1 = (_rotl((v * _P2) & _M, 31) * _P1) & _M
    acc = acc ^ k1
    acc = ((_rotl(acc, 27) * _P1) + _P4) & _M
    return _avalanche(acc)


@np.errstate(over="ignore")
def xxh64_u32(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """xxhash64 of each 4-byte little-endian value (INT32 and FLOAT)."""
    v = values.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    acc = (np.uint64(seed) + _P5 + np.uint64(4)) & _M
    acc = acc ^ ((v * _P1) & _M)
    acc = ((_rotl(acc, 23) * _P2) + _P3) & _M
    return _avalanche(acc)


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class SplitBlockFilter:
    """The SBBF bitset: ``blocks`` is uint32[z, 8]."""

    # batches of at least this many hashes take the device probe
    _DEVICE_PROBE_MIN = 32_768

    def __init__(self, blocks: np.ndarray):
        self.blocks = blocks
        # device copies of ``blocks``, one per device, made at the first
        # device probe and dropped by insert_hashes
        self._blocks_dev: Dict[str, torch.Tensor] = {}

    @classmethod
    def for_ndv(cls, ndv: int,
                bits_per_value: float = 10.0) -> "SplitBlockFilter":
        nbytes = int(ndv * bits_per_value / 8) + 32
        z = 1 << max(int(nbytes // 32).bit_length(), 0)
        return cls(np.zeros((max(z, 1), 8), dtype=np.uint32))

    @property
    def num_bytes(self) -> int:
        return self.blocks.size * 4

    @np.errstate(over="ignore")
    def _masks(self, hashes: np.ndarray):
        z = np.uint64(self.blocks.shape[0])
        block_idx = ((hashes >> np.uint64(32)) * z) >> np.uint64(32)
        low = hashes & np.uint64(0xFFFFFFFF)
        bit = (((low[:, None] * _SALT[None, :]) & np.uint64(0xFFFFFFFF))
               >> np.uint64(27))
        masks = np.uint32(1) << bit.astype(np.uint32)
        return block_idx.astype(np.int64), masks

    def insert_hashes(self, hashes: np.ndarray) -> None:
        block_idx, masks = self._masks(hashes)
        np.bitwise_or.at(self.blocks, block_idx, masks)
        self._blocks_dev = {}  # the device copies are stale

    def check_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """The numpy probe on the host: bool[n]."""
        block_idx, masks = self._masks(hashes)
        got = self.blocks[block_idx]
        return ((got & masks) == masks).all(axis=1)

    def device_blocks(self, device) -> torch.Tensor:
        """``blocks`` as an int32[z, 8] tensor on ``device``, copied there
        once and kept until the filter changes."""
        key = _device_key(device)
        got = self._blocks_dev.get(key)
        if got is None:
            host = torch.from_numpy(
                np.ascontiguousarray(self.blocks).view(np.int32).copy())
            got = self._blocks_dev[key] = host.to(key)
        return got

    def check_hashes_batch(self, hashes: np.ndarray,
                           prefer_device: Optional[bool] = None,
                           device="cuda") -> np.ndarray:
        """Probe many hashes; returns host bool numpy.  A batch of at least
        ``_DEVICE_PROBE_MIN`` hashes (or any batch with
        ``prefer_device=True``) takes the device probe on ``device``
        (:func:`check_hashes_multi` with this one filter); the rest the
        numpy probe."""
        use_dev = prefer_device
        if use_dev is None:
            use_dev = len(hashes) >= self._DEVICE_PROBE_MIN
        if use_dev:
            return check_hashes_multi([self], [hashes], device)[0]
        return self.check_hashes(hashes)

    def to_bytes(self) -> bytes:
        header = md.BloomFilterHeader(
            numBytes=self.num_bytes,
            algorithm=md.BloomFilterAlgorithm(BLOCK=md.SplitBlockAlgorithm()),
            hash=md.BloomFilterHash(XXHASH=md.XxHash()),
            compression=md.BloomFilterCompression(
                UNCOMPRESSED=md.BloomUncompressed()))
        return thrift.serialize(header) + self.blocks.astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes, pos: int = 0) -> "SplitBlockFilter":
        header, pos = thrift.deserialize(md.BloomFilterHeader, raw, pos)
        n = header.numBytes
        blocks = np.frombuffer(raw[pos:pos + n],
                               dtype="<u4").reshape(-1, 8).copy()
        return cls(blocks)


def check_hashes_multi(filters: Sequence[SplitBlockFilter],
                       hash_batches: Sequence[np.ndarray],
                       device="cuda") -> List[np.ndarray]:
    """Probe ``hash_batches[j]`` (uint64 numpy) against ``filters[j]``, all
    of them in one pass on ``device``: the batches go into one (pinned, on a
    card) host buffer and reach the device in one copy, one
    :func:`~parquet_tpu_torch.ops.kernels.bloom_check_segments` call tests
    them against the filters' cached device copies, and one copy brings the
    results back.  Returns one host bool array per batch."""
    from ..ops import kernels

    if not filters:
        return []
    blocks = [f.device_blocks(device) for f in filters]
    dev = blocks[0].device
    lens = [len(h) for h in hash_batches]
    starts = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    host = torch.empty(int(starts[-1]), dtype=torch.int64,
                       pin_memory=dev.type == "cuda")
    flat = host.numpy()
    for h, a, b in zip(hash_batches, starts[:-1], starts[1:]):
        flat[a:b] = np.asarray(h, dtype=np.uint64).view(np.int64)
    hit = kernels.bloom_check_segments(
        blocks, host.to(dev, non_blocking=True), torch.from_numpy(starts))
    hit = hit.cpu().numpy()
    return [hit[a:b] for a, b in zip(starts[:-1], starts[1:])]


def hash_values(leaf: Leaf, values) -> np.ndarray:
    """xxh64 of each value's PLAIN bytes (the Parquet bloom hash)."""
    t = leaf.physical_type
    vals = np.asarray(values)
    if t in (Type.INT64, Type.DOUBLE):
        return xxh64_u64(vals.view(np.uint64))
    if t in (Type.INT32, Type.FLOAT):
        return xxh64_u32(vals.view(np.uint32))
    raise ValueError(f"unsupported bloom type {t}")


_PROBE_DTYPE = {Type.INT64: np.int64, Type.DOUBLE: np.float64,
                Type.INT32: np.int32, Type.FLOAT: np.float32}
_UNSIGNED_PROBE_DTYPE = {Type.INT64: np.uint64, Type.INT32: np.uint32}


def hash_probe_values(leaf: Leaf, values) -> np.ndarray:
    """xxh64 of order-domain probe values, each encoded as the writer
    encodes the column's values (an unsigned column's as unsigned)."""
    from ..algebra.compare import is_unsigned, normalize

    dt = ((_UNSIGNED_PROBE_DTYPE.get(leaf.physical_type)
           if is_unsigned(leaf) else None)
          or _PROBE_DTYPE.get(leaf.physical_type))
    if dt is None:
        raise ValueError(f"unsupported bloom type {leaf.physical_type}")
    vals = np.array([normalize(leaf, v) for v in values], dtype=dt)
    return hash_values(leaf, vals)


def probe_hashes(leaf: Leaf, values) -> Optional[np.ndarray]:
    """:func:`hash_probe_values`, or None ("inconclusive: skip the bloom
    stage") when a probe does not encode in the column's type."""
    try:
        return hash_probe_values(leaf, values)
    except (TypeError, ValueError, OverflowError):
        return None


def build_split_block_filter(leaf: Leaf, values: np.ndarray,
                             dict_values: Optional[np.ndarray],
                             bits_per_value: float) -> bytes:
    """Writer side: a filter sized for the chunk's values (its dictionary
    when it has one) holding the hash of each."""
    vals = dict_values if dict_values is not None else values
    filt = SplitBlockFilter.for_ndv(max(len(vals), 8), bits_per_value)
    filt.insert_hashes(hash_values(leaf, vals))
    return filt.to_bytes()


def read_bloom_filter(reader) -> Optional[SplitBlockFilter]:
    """Reader side: the chunk's filter, or None when it has none."""
    meta = reader.meta
    off = meta.bloom_filter_offset
    if off is None:
        return None
    length = meta.bloom_filter_length
    if length is None:
        src = reader.file.source
        probe = src.pread(off, min(64, src.size() - off))
        header, hend = thrift.deserialize(md.BloomFilterHeader, probe)
        length = hend + header.numBytes
    raw = reader.file.source.pread(off, length)
    return SplitBlockFilter.from_bytes(raw)
