"""Split-block bloom filters (SBBF) and their xxhash64.

The port of ``parquet_tpu/io/bloom.py``.  Format (Parquet
``bloom_filter.md``): a filter is ``z`` 32-byte blocks of 8 little-endian
uint32 words; a value's xxh64 ``h`` picks block ``((h >> 32) * z) >> 32``
and sets, in word ``i``, bit ``(low32(h) * SALT[i] mod 2^32) >> 27``.  It
is stored as a thrift ``BloomFilterHeader`` and the raw bitset at
``ColumnMetaData.bloom_filter_offset``.  A value's hash is XXH64 (seed 0)
of its PLAIN bytes without a length prefix: :func:`xxh64_u32` and
:func:`xxh64_u64` in numpy for the fixed-width types, the C++
``pq_xxh64_batch`` (``ops/host.py::xxh64_batch``) for byte arrays and
fixed-length byte arrays, with :func:`xxh64_bytes` its plain Python
version; BOOLEAN and INT96 values have no bloom hash.

:meth:`SplitBlockFilter.check_hashes_batch` routes as the reference does,
by batch size only: a batch of at least ``_DEVICE_PROBE_MIN`` hashes goes to
the device probe, a smaller one to the numpy probe on the host.  The device
probe, :func:`check_hashes_multi`, tests the batches of many filters in one
:func:`~parquet_tpu_torch.ops.kernels.bloom_check_segments` call on the
caller's device: the CUDA kernel for a card, its plain version for the
CPU.  A failed build or launch of the kernel raises; nothing falls back.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..errors import CorruptedError
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


_M64 = (1 << 64) - 1
_IP1, _IP2, _IP3, _IP4, _IP5 = (int(_P1), int(_P2), int(_P3), int(_P4),
                                int(_P5))


def _irotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _iround(acc: int, lane: int) -> int:
    return _irotl((acc + lane * _IP2) & _M64, 31) * _IP1 & _M64


def xxh64_bytes(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` in plain Python: the plain version of the C++
    ``pq_xxh64_batch``, over the 32-byte stripes, then the 8-byte, 4-byte
    and 1-byte lanes of the tail."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _IP1 + _IP2) & _M64, (seed + _IP2) & _M64, seed,
             (seed - _IP1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                lane = int.from_bytes(data[p + 8 * i:p + 8 * i + 8],
                                      "little")
                v[i] = _iround(v[i], lane)
            p += 32
        h = (_irotl(v[0], 1) + _irotl(v[1], 7) + _irotl(v[2], 12)
             + _irotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _iround(0, x)) * _IP1 + _IP4) & _M64
    else:
        h = (seed + _IP5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        lane = int.from_bytes(data[p:p + 8], "little")
        h = (_irotl(h ^ _iround(0, lane), 27) * _IP1 + _IP4) & _M64
        p += 8
    if p + 4 <= n:
        lane = int.from_bytes(data[p:p + 4], "little")
        h = (_irotl(h ^ (lane * _IP1 & _M64), 23) * _IP2 + _IP3) & _M64
        p += 4
    while p < n:
        h = _irotl(h ^ (data[p] * _IP5 & _M64), 11) * _IP1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _IP2 & _M64
    h ^= h >> 29
    h = h * _IP3 & _M64
    return h ^ (h >> 32)


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


def hash_values(leaf: Leaf, values, offsets=None) -> np.ndarray:
    """xxh64 of each value's PLAIN bytes (the Parquet bloom hash): byte
    arrays pass their ``offsets``, fixed-length byte arrays are ``(n, w)``
    rows."""
    from ..ops import host

    t = leaf.physical_type
    vals = np.asarray(values)
    if t in (Type.INT64, Type.DOUBLE):
        return xxh64_u64(vals.view(np.uint64))
    if t in (Type.INT32, Type.FLOAT):
        return xxh64_u32(vals.view(np.uint32))
    if t == Type.BYTE_ARRAY:
        return host.xxh64_batch(vals, offsets)
    if t == Type.FIXED_LEN_BYTE_ARRAY:
        rows = vals.reshape(-1, leaf.type_length or 0)
        return host.xxh64_batch(
            rows.reshape(-1),
            np.arange(len(rows) + 1, dtype=np.int64) * rows.shape[1])
    raise ValueError(f"unsupported bloom type {t}")


_PROBE_DTYPE = {Type.INT64: np.int64, Type.DOUBLE: np.float64,
                Type.INT32: np.int32, Type.FLOAT: np.float32}
_UNSIGNED_PROBE_DTYPE = {Type.INT64: np.uint64, Type.INT32: np.uint32}


def hash_probe_values(leaf: Leaf, values) -> np.ndarray:
    """xxh64 of order-domain probe values, each encoded as the writer
    encodes the column's values: an unsigned column's as unsigned, a
    decimal of byte storage as its big-endian two's complement (FLBA at
    the column's width), a byte array's and a fixed-length byte array's as
    their bytes (a probe of another width than the column's hashes its own
    bytes: at worst a false positive)."""
    from ..algebra.compare import int_to_be_bytes, is_unsigned, normalize
    from ..ops import host
    from ..schema.types import LogicalKind

    t = leaf.physical_type
    dt = ((_UNSIGNED_PROBE_DTYPE.get(t) if is_unsigned(leaf) else None)
          or _PROBE_DTYPE.get(t))
    if dt is not None:
        vals = np.array([normalize(leaf, v) for v in values], dtype=dt)
        return hash_values(leaf, vals)
    if t not in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        raise ValueError(f"unsupported bloom type {t}")
    vals = [normalize(leaf, v) for v in values]
    if leaf.logical_kind == LogicalKind.DECIMAL:
        width = leaf.type_length if t == Type.FIXED_LEN_BYTE_ARRAY else None
        vals = [int_to_be_bytes(v, width) if isinstance(v, int) else v
                for v in vals]
    bs = [bytes(v) for v in vals]
    offs = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return host.xxh64_batch(np.frombuffer(b"".join(bs), np.uint8), offs)


def probe_hashes(leaf: Leaf, values) -> Optional[np.ndarray]:
    """:func:`hash_probe_values`, or None ("inconclusive: skip the bloom
    stage") when a probe does not encode in the column's type."""
    try:
        return hash_probe_values(leaf, values)
    except (TypeError, ValueError, OverflowError):
        return None


def build_split_block_filter(leaf: Leaf, values: np.ndarray,
                             dict_values: Optional[np.ndarray],
                             bits_per_value: float, offsets=None,
                             dict_offsets=None) -> bytes:
    """Writer side: a filter sized for the chunk's distinct values (its
    dictionary when it has one) holding the hash of each; byte arrays
    pass their offsets."""
    if dict_values is not None:
        vals, offs = dict_values, dict_offsets
    else:
        vals, offs = values, offsets
    ndv = len(offs) - 1 if offs is not None else len(vals)
    filt = SplitBlockFilter.for_ndv(max(ndv, 8), bits_per_value)
    filt.insert_hashes(hash_values(leaf, vals, offs))
    return filt.to_bytes()


def read_bloom_filter(reader) -> Optional[SplitBlockFilter]:
    """Reader side: the chunk's filter, or None when it has none.  A
    filter whose header or length does not parse raises
    ``CorruptedError`` (the JAX package lets the thrift error through), so
    ``skip_row_group`` drops its row group."""
    meta = reader.meta
    off = meta.bloom_filter_offset
    if off is None:
        return None
    try:
        length = meta.bloom_filter_length
        if length is None:
            src = reader.file.source
            probe = src.pread(off, min(64, src.size() - off))
            header, hend = thrift.deserialize(md.BloomFilterHeader, probe)
            length = hend + header.numBytes
        raw = reader.file.source.pread(off, length)
        return SplitBlockFilter.from_bytes(raw)
    except (thrift.ThriftError, ValueError, IndexError, struct.error) as e:
        raise CorruptedError(f"bad bloom filter at {off}: {e}") from e
