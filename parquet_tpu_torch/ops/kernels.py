"""The hand-written CUDA kernels of the read and lookup paths, their
wrappers and their plain PyTorch versions.

The port of ``parquet_tpu/ops/pallas_kernels.py``:

- :func:`unpack_bits_dense` (``csrc/unpack_bits.cu``) replaces the Pallas
  ``unpack_bits_dense``: n LSB-first w-bit integers from a dense uint32
  stream whose groups of 32 values occupy w words each;
- :func:`dict_unpack_gather` (``csrc/dict_unpack_gather.cu``) replaces the
  Pallas ``dict_unpack_gather``: the same unpack fused with a gather from a
  dictionary of at most 1024 entries, so the indexes never reach memory;
- :func:`bloom_check_segments` (``csrc/bloom_check.cu``) replaces the
  Pallas ``bloom_check_blocks`` and the XLA block gather before it: the
  split-block bloom filter probe of 64-bit hashes against filters resident
  on the device, block index, gather and salted bit tests in one pass, many
  filters' probes in one launch; :func:`bloom_check` is its one-filter
  call.

A wrapper given a CPU tensor runs the plain version beside it
(:func:`unpack_bits_dense_ref`, :func:`dict_unpack_gather_ref`,
:func:`bloom_check_ref`, :func:`bloom_check_segments_ref`); given a
CUDA tensor it launches its kernel on the current stream or raises.  Each
wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches, and nowhere
else.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np
import torch

from . import _build

LAUNCHES = {"unpack_bits_dense": 0, "dict_unpack_gather": 0,
            "bloom_check": 0}
_launch_lock = threading.Lock()

MAX_FUSED_DICT = 1024  # entries the fused kernel stages in shared memory

_M32 = 0xFFFFFFFF


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype not in (torch.int32, torch.uint32) or words.dim() != 1:
        raise TypeError(f"packed words must be a 1-D int32/uint32 tensor, "
                        f"got {words.dtype} of shape {tuple(words.shape)}")
    return words.view(torch.int32)


def _check_width(w: int) -> None:
    if not 1 <= w <= 32:
        raise ValueError(f"bit width {w} outside 1..32")


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _padded(words: torch.Tensor, need: int) -> torch.Tensor:
    """``words`` holding at least ``need`` entries: the ragged last group
    reads zero-padded words."""
    if words.shape[0] >= need:
        return words[:need]
    return torch.cat([words, words.new_zeros(need - words.shape[0])])


# ---------------------------------------------------------------------------
# unpack_bits_dense
# ---------------------------------------------------------------------------


def unpack_bits_dense_ref(words: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_bits_dense`: per group of 32
    values, lane j reads word (j*w)>>5 at shift (j*w)&31 and ORs in the next
    word when the value straddles.  Bit math on int64-widened words."""
    words = _as_int32_words(words)
    _check_width(w)
    groups = (n + 31) // 32
    x = _padded(words, groups * w)
    if w == 32:
        return x[:n].clone()
    x = (x.to(torch.int64) & _M32).reshape(groups, w)
    cols = []
    for j in range(32):
        bit = j * w
        k, sh = bit >> 5, bit & 31
        v = x[:, k] >> sh
        if sh + w > 32:
            v = v | (x[:, k + 1] << (32 - sh))
        cols.append(v)
    out = torch.stack(cols, dim=1).reshape(-1)[:n] & ((1 << w) - 1)
    return _to_int32(out)


def unpack_bits_dense(words: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """Unpack ``n`` LSB-first ``w``-bit integers (w in 1..32) from a dense
    uint32 stream of ceil(n/32)*w words (words past a shorter stream's end
    read as zero).  Returns int32[n] holding the uint32 bit patterns."""
    words = _as_int32_words(words)
    _check_width(w)
    if words.device.type == "cpu":
        return unpack_bits_dense_ref(words, n, w)
    if words.device.type != "cuda":
        raise ValueError(f"unpack_bits_dense runs on cuda or cpu tensors, "
                         f"not {words.device}")
    words = words.contiguous()  # the kernel reads words past the end as 0
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    lib = _build.load("unpack_bits")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pq_unpack_bits_dense(words.data_ptr(), words.shape[0],
                                      out.data_ptr(), n, w, stream)
    _raise_on_error(rc, "unpack_bits_dense")
    _count_launch("unpack_bits_dense")
    return out


# ---------------------------------------------------------------------------
# dict_unpack_gather
# ---------------------------------------------------------------------------


def _check_dictionary(dictionary: torch.Tensor) -> None:
    if dictionary.dim() != 1 or dictionary.element_size() not in (4, 8):
        raise TypeError("dictionary must be a 1-D tensor of 4- or 8-byte "
                        f"elements, got {dictionary.dtype} of shape "
                        f"{tuple(dictionary.shape)}")
    if not 1 <= dictionary.shape[0] <= MAX_FUSED_DICT:
        raise ValueError(f"dictionary of {dictionary.shape[0]} entries: the "
                         f"fused kernel takes 1..{MAX_FUSED_DICT}")


def dict_unpack_gather_ref(words: torch.Tensor, dictionary: torch.Tensor,
                           n: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`dict_unpack_gather`: unpack, then
    gather; an index past the dictionary's end yields 0."""
    _check_dictionary(dictionary)
    idx = unpack_bits_dense_ref(words, n, w).to(torch.int64) & _M32
    d = dictionary.shape[0]
    vals = dictionary[idx.clamp(max=d - 1)]
    return torch.where(idx < d, vals, torch.zeros_like(vals))


def dict_unpack_gather(words: torch.Tensor, dictionary: torch.Tensor, n: int,
                       w: int) -> torch.Tensor:
    """Unpack ``n`` ``w``-bit dictionary indexes from a dense uint32 stream
    and return ``dictionary[index]`` for each (dictionary.dtype[n]).  The
    dictionary holds 1..1024 entries of 4 or 8 bytes; an index past its end
    yields 0."""
    words = _as_int32_words(words)
    _check_width(w)
    _check_dictionary(dictionary)
    if words.device.type == "cpu":
        return dict_unpack_gather_ref(words, dictionary, n, w)
    if words.device.type != "cuda" or dictionary.device != words.device:
        raise ValueError(f"dict_unpack_gather runs on cuda or cpu tensors of "
                         f"one device, not {words.device}/{dictionary.device}")
    words = words.contiguous()  # the kernel reads words past the end as 0
    dictionary = dictionary.contiguous()
    out = torch.empty(n, dtype=dictionary.dtype, device=words.device)
    if n == 0:
        return out
    lib = _build.load("dict_unpack_gather")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pq_dict_unpack_gather(
            words.data_ptr(), words.shape[0], dictionary.data_ptr(),
            dictionary.shape[0], dictionary.element_size(), out.data_ptr(), n,
            w, stream)
    _raise_on_error(rc, "dict_unpack_gather")
    _count_launch("dict_unpack_gather")
    return out


# ---------------------------------------------------------------------------
# bloom_check
# ---------------------------------------------------------------------------

# the split-block bloom filter's 8 salts (Parquet bloom_filter.md)
BLOOM_SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
              0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)


def _check_filter(filter_blocks: torch.Tensor) -> None:
    if (filter_blocks.dim() != 2 or filter_blocks.shape[1] != 8
            or filter_blocks.dtype not in (torch.int32, torch.uint32)):
        raise TypeError("bloom filter must be an int32/uint32 tensor of shape "
                        f"(z, 8), got {filter_blocks.dtype} of shape "
                        f"{tuple(filter_blocks.shape)}")
    if not 1 <= filter_blocks.shape[0] <= 1 << 31:
        raise ValueError(f"bloom filter of {filter_blocks.shape[0]} blocks: "
                         "1..2^31 are supported")


def _check_hashes(hashes: torch.Tensor) -> None:
    if hashes.dim() != 1 or hashes.dtype not in (torch.int64, torch.uint64):
        raise TypeError("hashes must be a 1-D int64/uint64 tensor (the uint64 "
                        f"bit patterns), got {hashes.dtype} of shape "
                        f"{tuple(hashes.shape)}")


def _check_bloom_operands(filter_blocks: torch.Tensor,
                          hashes: torch.Tensor) -> None:
    _check_filter(filter_blocks)
    _check_hashes(hashes)


def _check_card_operands(filters, hashes: torch.Tensor) -> None:
    """The kernel reads every filter and the hashes as 16-byte vectors in
    place: each must lie on the hashes' card, contiguous and 16-byte
    aligned (a view such as ``hashes[1:]`` is not)."""
    if hashes.device.type != "cuda" or any(f.device != hashes.device
                                           for f in filters):
        raise ValueError("bloom_check runs on cuda or cpu tensors of one "
                         f"device, not {[str(f.device) for f in filters]}/"
                         f"{hashes.device}")
    for what, t in [("hashes", hashes)] + [("bloom filter", f)
                                           for f in filters]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} must be contiguous and 16-byte aligned "
                             "for the kernel's vector loads")


def bloom_check_ref(filter_blocks: torch.Tensor,
                    hashes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_check`, on int64 words (torch
    has no ``>>`` for uint32/uint64 on the CPU).  ``low * SALT`` is taken as
    the sum of two products of at most 48 bits, so nothing overflows int64
    before the mask to 32 bits."""
    _check_bloom_operands(filter_blocks, hashes)
    z = filter_blocks.shape[0]
    h = hashes.view(torch.int64)
    hi = (h >> 32) & _M32
    block = (hi * z) >> 32  # exact: hi < 2^32, z <= 2^31
    low = h & _M32
    words = filter_blocks.view(torch.int32)[block].to(torch.int64) & _M32
    lo16, hi16 = low & 0xFFFF, low >> 16
    hit = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
    for i, salt in enumerate(BLOOM_SALT):
        prod = (lo16 * salt + (((hi16 * salt) & 0xFFFF) << 16)) & _M32
        hit &= ((words[:, i] >> (prod >> 27)) & 1) == 1
    return hit


def bloom_check(filter_blocks: torch.Tensor,
                hashes: torch.Tensor) -> torch.Tensor:
    """Probe a split-block bloom filter (``filter_blocks``: z blocks of 8
    32-bit words) with 64-bit xxhashes (``hashes``, int64 holding the
    uint64 bit patterns).  Returns bool[n]: False where the filter proves
    the value absent.  On the card, the one-segment launch of the kernel
    that :func:`bloom_check_segments` launches."""
    _check_bloom_operands(filter_blocks, hashes)
    if hashes.device.type == "cpu" and filter_blocks.device.type == "cpu":
        return bloom_check_ref(filter_blocks, hashes)
    _check_card_operands([filter_blocks], hashes)
    n = hashes.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=hashes.device)
    if n == 0:
        return out
    lib = _build.load("bloom_check")
    with torch.cuda.device(hashes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pq_bloom_check(filter_blocks.data_ptr(),
                                filter_blocks.shape[0], hashes.data_ptr(),
                                out.data_ptr(), n, stream)
    _raise_on_error(rc, "bloom_check")
    _count_launch("bloom_check")
    return out


def _check_segment_operands(filters: Sequence[torch.Tensor],
                            hashes: torch.Tensor,
                            starts: torch.Tensor) -> List[int]:
    """Check the segmented probe's operands; returns ``starts`` as a
    list."""
    if not isinstance(filters, (list, tuple)) or not filters:
        raise ValueError("bloom_check_segments needs a list of at least one "
                         "filter")
    for f in filters:
        _check_filter(f)
    _check_hashes(hashes)
    if (not isinstance(starts, torch.Tensor) or starts.dtype != torch.int64
            or starts.dim() != 1 or starts.device.type != "cpu"):
        raise TypeError("starts must be a 1-D int64 tensor on the CPU")
    if starts.shape[0] != len(filters) + 1:
        raise ValueError(f"{len(filters)} filter(s) need {len(filters) + 1} "
                         f"starts, got {starts.shape[0]}")
    st = starts.tolist()
    if st[0] != 0 or st[-1] != hashes.shape[0]:
        raise ValueError(f"starts must run from 0 to the {hashes.shape[0]} "
                         f"hashes, not from {st[0]} to {st[-1]}")
    if any(b < a for a, b in zip(st, st[1:])):
        raise ValueError(f"starts must ascend: {st}")
    return st


def bloom_check_segments_ref(filters: Sequence[torch.Tensor],
                             hashes: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_check_segments`:
    :func:`bloom_check_ref` per segment."""
    st = _check_segment_operands(filters, hashes, starts)
    out = torch.empty(hashes.shape[0], dtype=torch.bool, device=hashes.device)
    for f, a, b in zip(filters, st, st[1:]):
        if b > a:
            out[a:b] = bloom_check_ref(f, hashes[a:b])
    return out


def _segment_table(filters: Sequence[torch.Tensor],
                   starts: List[int]) -> torch.Tensor:
    """The kernel's segment table (``Tables`` in ``csrc/bloom_check.cu``)
    in one pinned host tensor: the filters' base addresses, the nseg + 1
    starts, then the block counts as uint32."""
    nseg = len(filters)
    host = torch.zeros(2 * nseg + 1 + (nseg + 1) // 2, dtype=torch.int64,
                       pin_memory=True)
    words = host.numpy()
    words[:nseg] = [f.data_ptr() for f in filters]
    words[nseg:2 * nseg + 1] = starts
    words[2 * nseg + 1:].view(np.uint32)[:nseg] = [f.shape[0]
                                                   for f in filters]
    return host


def bloom_check_segments(filters: Sequence[torch.Tensor],
                         hashes: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
    """Probe many split-block bloom filters in one pass: hash ``i`` is
    tested against ``filters[s]`` (int32/uint32 ``(z_s, 8)``) where
    ``starts[s] <= i < starts[s + 1]``.  ``hashes`` is int64[n] (the uint64
    bit patterns); ``starts`` int64[len(filters) + 1] on the CPU, ascending
    from 0 to n.  Returns bool[n].  On the card: one launch, whatever the
    number of filters."""
    st = _check_segment_operands(filters, hashes, starts)
    if hashes.device.type == "cpu" and all(f.device.type == "cpu"
                                           for f in filters):
        return bloom_check_segments_ref(filters, hashes, starts)
    _check_card_operands(filters, hashes)
    n = hashes.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=hashes.device)
    if n == 0:
        return out
    lib = _build.load("bloom_check")
    with torch.cuda.device(hashes.device):
        # ``host`` and ``table`` stay referenced until the launch is
        # ordered on the stream; the caching allocators keep their storage
        # until the stream has used it
        host = _segment_table(filters, st)
        table = host.to(hashes.device, non_blocking=True)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pq_bloom_check_segments(table.data_ptr(), host.data_ptr(),
                                         len(filters), hashes.data_ptr(),
                                         out.data_ptr(), n, stream)
    _raise_on_error(rc, "bloom_check")
    _count_launch("bloom_check")
    return out


def _raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def _count_launch(kernel: str) -> None:
    with _launch_lock:  # kernels launch on the multi-file read's workers
        LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
