"""numpy host helpers: varints, PLAIN, the RLE/bit-packed hybrid run scan
and expansion, the legacy BIT_PACKED levels, the delta encodings,
byte-stream split, the dictionary gather, and the encoders the writer
uses.

The port's copy of the parts of ``parquet_tpu/ops/ref.py`` it needs, in
numpy; where the JAX package calls its C++ shim, this module calls the
port's own (``ops/host.py``).  On the device route, decoding here is
metadata-scale: run headers, dictionary pages, the offsets of byte arrays
and the lengths of front coding, while data-scale decode runs on the
device (``ops/device.py``, ``ops/kernels.py``).  The host route
(``io/reader.decode_chunk_host``) decodes whole pages with the expanding
decoders here: :func:`decode_rle`, :func:`decode_delta_byte_array` and
:func:`decode_byte_stream_split`.  Their run scans and delta length
streams go through the C++ prescan (``ops/host.py``); :func:`scan_rle_runs`
and :func:`decode_delta_binary_packed` here are its plain versions, which
only the tests call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..errors import CorruptedError
from ..format.enums import Type
from ..schema.types import PHYSICAL_NP_DTYPE
from . import host

# ---------------------------------------------------------------------------
# varint / zigzag (ULEB128, shared by delta and RLE headers)
# ---------------------------------------------------------------------------


def read_uvarint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = int(buf[pos])
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def write_uvarint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


# ---------------------------------------------------------------------------
# Bit packing (LSB-first, the parquet hybrid bit order)
# ---------------------------------------------------------------------------


def _pack_rows(values: np.ndarray, bit_width: int) -> np.ndarray:
    """Pack each row of a 2-D integer array LSB-first at ``bit_width`` bits;
    rows are zero-padded to whole bytes.  Returns uint8[rows, bytes]."""
    mask = (np.uint64(0xFFFFFFFFFFFFFFFF) if bit_width >= 64
            else np.uint64((1 << bit_width) - 1))
    v = values.astype(np.uint64) & mask
    bits = ((v[:, :, None] >> np.arange(bit_width, dtype=np.uint64)) & 1
            ).astype(np.uint8).reshape(len(v), -1)
    return np.packbits(bits, axis=1, bitorder="little")


# ---------------------------------------------------------------------------
# PLAIN
# ---------------------------------------------------------------------------


def decode_plain(data, num_values: int, physical: Type,
                 type_length: Optional[int] = None):
    """Decode PLAIN values: a numeric type to its 1-D array, BOOLEAN to
    bool[n], INT96 to (n, 3) int32, FIXED_LEN_BYTE_ARRAY to
    (n, type_length) uint8, BYTE_ARRAY to ``(values uint8, offsets
    int64[n + 1])``."""
    buf = host.as_u8(data)
    if physical == Type.BYTE_ARRAY:
        return host.plain_byte_arrays([(buf, num_values)])
    if physical == Type.BOOLEAN:
        nbytes = (num_values + 7) // 8
    elif physical == Type.FIXED_LEN_BYTE_ARRAY:
        nbytes = type_length * num_values
    else:
        nbytes = {Type.INT96: 12}.get(
            physical, PHYSICAL_NP_DTYPE[physical].itemsize) * num_values
    if len(buf) < nbytes:
        raise CorruptedError(f"PLAIN page holds {len(buf)} bytes, "
                             f"{num_values} values need {nbytes}")
    if physical == Type.BOOLEAN:
        bits = np.unpackbits(buf[:nbytes], bitorder="little")
        return bits[:num_values].astype(np.bool_)
    if physical == Type.INT96:
        return buf[:nbytes].view(np.int32).reshape(num_values, 3).copy()
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return buf[:nbytes].reshape(num_values, type_length).copy()
    return buf[:nbytes].view(PHYSICAL_NP_DTYPE[physical]).copy()


def encode_plain(values, physical: Type,
                 offsets: Optional[np.ndarray] = None) -> bytes:
    """PLAIN bytes of ``values`` (BYTE_ARRAY: value bytes with their
    ``offsets``)."""
    if physical == Type.BOOLEAN:
        return np.packbits(np.asarray(values, np.uint8),
                           bitorder="little").tobytes()
    if physical == Type.BYTE_ARRAY:
        return host.encode_plain_byte_arrays(values, offsets)
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return np.ascontiguousarray(values, np.uint8).tobytes()
    return np.ascontiguousarray(values,
                                dtype=PHYSICAL_NP_DTYPE[physical]).tobytes()


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid
# ---------------------------------------------------------------------------


def scan_rle_runs(data, num_values: int, bit_width: int, pos: int = 0):
    """Parse hybrid run headers into a run table: the plain version of the
    C++ scan the read path runs (``host.scan_rle_runs``), kept as the
    tests' oracle.

    Returns (kinds u8[k] (0=RLE, 1=bit-packed), counts i64[k], payloads
    i64[k], byte_offsets i64[k], end_pos).  The payload is the repeated value
    of an RLE run; a bit-packed run's bits start at its byte offset."""
    buf = bytes(data)
    kinds, counts, payloads, offsets = [], [], [], []
    vbytes = (bit_width + 7) // 8
    vmask = (1 << bit_width) - 1
    remaining = num_values
    try:
        while remaining > 0:
            b = buf[pos]
            pos += 1
            header = b & 0x7F
            shift = 7
            while b & 0x80:
                b = buf[pos]
                pos += 1
                header |= (b & 0x7F) << shift
                shift += 7
            count = header >> 1
            if count == 0:
                # a zero-count run covers no values: a stream of them would
                # loop forever
                raise CorruptedError(
                    "malformed RLE hybrid stream: zero-count run")
            if header & 1:
                kinds.append(1)
                payloads.append(0)
                offsets.append(pos)
                pos += count * bit_width
                count *= 8
            else:
                kinds.append(0)
                payloads.append(
                    int.from_bytes(buf[pos:pos + vbytes], "little") & vmask)
                pos += vbytes
                offsets.append(pos)
            if pos > len(buf):  # a value or payload past the stream
                raise IndexError
            counts.append(min(count, remaining))
            remaining -= count
    except IndexError:
        raise CorruptedError("RLE hybrid stream truncated") from None
    return (np.array(kinds, dtype=np.uint8),
            np.array(counts, dtype=np.int64),
            np.array(payloads, dtype=np.int64),
            np.array(offsets, dtype=np.int64),
            pos)


def count_in_runs(body, kinds, counts, payloads, offsets, width: int,
                  target: int) -> int:
    """How many values of ``body``'s scanned run table equal ``target``
    (vectorized over the bit-packed runs): the plain version of
    ``host.count_present``, kept as the tests' oracle."""
    kinds = np.asarray(kinds)
    counts = np.asarray(counts, np.int64)
    payloads = np.asarray(payloads, np.int64)
    total = int(counts[(kinds == 0) & (payloads == target)].sum())
    packed = np.flatnonzero(kinds != 0)
    if not len(packed):
        return total
    pc = counts[packed]
    bitpos = (np.repeat(np.asarray(offsets, np.int64)[packed], pc) * 8
              + host.segment_ranges(pc) * width)
    buf = np.concatenate([host.as_u8(body), np.zeros(8, np.uint8)])
    b0 = bitpos >> 3
    w32 = (buf[b0].astype(np.uint32)
           | (buf[b0 + 1].astype(np.uint32) << 8)
           | (buf[b0 + 2].astype(np.uint32) << 16)
           | (buf[b0 + 3].astype(np.uint32) << 24))
    vals = (w32 >> (bitpos & 7).astype(np.uint32)) & np.uint32(
        (1 << width) - 1)
    return total + int(np.count_nonzero(vals == target))


def decode_rle(data, num_values: int, bit_width: int,
               pos: int = 0) -> np.ndarray:
    """Expand a hybrid stream to ``num_values`` int32 values: the run scan
    (in C++, ``host.scan_rle_runs``), then every value at once (an RLE
    run's payload, or a packed value read from an 8-byte little-endian
    window at its bit position)."""
    kinds, counts, payloads, offs, _ = host.scan_rle_runs(data, num_values,
                                                          bit_width, pos)
    out = np.repeat(payloads, counts)
    if len(out) < num_values:
        raise CorruptedError(f"RLE hybrid stream holds {len(out)} of "
                             f"{num_values} values")
    packed = np.flatnonzero(kinds != 0)
    if len(packed) and bit_width:
        starts = np.cumsum(counts) - counts
        pc = counts[packed]
        slot = np.repeat(starts[packed], pc) + host.segment_ranges(pc)
        within = slot - np.repeat(starts[packed], pc)
        bitpos = np.repeat(offs[packed], pc) * 8 + within * bit_width
        buf = np.concatenate([host.as_u8(data), np.zeros(8, np.uint8)])
        b0 = bitpos >> 3
        if len(b0) and int(b0.max()) + 8 > len(buf):
            raise CorruptedError("RLE hybrid stream truncated")
        window = np.zeros(len(b0), np.uint64)
        for k in range(8):
            window |= buf[b0 + k].astype(np.uint64) << np.uint64(8 * k)
        vals = (window >> (bitpos & 7).astype(np.uint64)) & np.uint64(
            (1 << bit_width) - 1)
        out[slot] = vals.astype(np.int64)
    return out[:num_values].astype(np.int32)


def gather_bits(data, starts_bits: np.ndarray, bit_width: int) -> np.ndarray:
    """One LSB-first ``bit_width``-bit integer at each bit offset of
    ``starts_bits`` (int64, in any order), as uint64."""
    n = len(starts_bits)
    if bit_width == 0 or n == 0:
        return np.zeros(n, dtype=np.uint64)
    buf = host.as_u8(data)
    starts = np.asarray(starts_bits, dtype=np.int64)
    byte0 = starts >> 3
    shift = (starts & 7).astype(np.uint64)
    nbytes = min((bit_width + 7 + 7) // 8, 9)
    end = int(byte0.max()) + nbytes
    if end > len(buf):
        buf = np.concatenate([buf, np.zeros(end - len(buf), np.uint8)])
    acc = np.zeros(n, dtype=np.uint64)
    for k in range(min(nbytes, 8)):
        acc |= buf[byte0 + k].astype(np.uint64) << np.uint64(8 * k)
    vals = acc >> shift
    if bit_width + 7 > 64 and nbytes == 9:
        hi = buf[byte0 + 8].astype(np.uint64)
        vals |= np.where(shift > 0, hi << (np.uint64(64) - shift), 0)
    if bit_width < 64:
        vals &= (np.uint64(1) << np.uint64(bit_width)) - np.uint64(1)
    return vals


def select_rle(data, num_values: int, bit_width: int, take: np.ndarray,
               pos: int = 0) -> np.ndarray:
    """The hybrid stream's value at each ordinal of ``take`` (sorted
    int64), without expanding the stream: an RLE run answers from its
    payload, a bit-packed one by :func:`gather_bits` at the value's bit
    position.  Returns int64[len(take)]."""
    take = np.asarray(take, dtype=np.int64)
    if bit_width == 0 or len(take) == 0:
        return np.zeros(len(take), dtype=np.int64)
    kinds, counts, payloads, offsets, _ = host.scan_rle_runs(
        data, num_values, bit_width, pos)
    ends = np.cumsum(counts)
    if len(take) and int(take[-1]) >= (int(ends[-1]) if len(ends) else 0):
        raise CorruptedError("RLE hybrid stream holds fewer values than "
                             "its page declares")
    run = np.searchsorted(ends, take, side="right")
    starts = ends - counts
    out = payloads[run].astype(np.int64)
    bp = kinds[run] == 1
    if bp.any():
        r = run[bp]
        bits = offsets[r] * 8 + (take[bp] - starts[r]) * bit_width
        out[bp] = gather_bits(data, bits, bit_width).astype(np.int64)
    return out


def decode_rle_dict_indices_masked(data, num_values: int, take: np.ndarray,
                                   pos: int = 0) -> np.ndarray:
    """The dictionary indexes at the ``take`` ordinals of a page's index
    stream (its bit-width byte at ``pos``), by :func:`select_rle`."""
    buf = host.as_u8(data)
    if pos >= len(buf):
        raise CorruptedError("dictionary index stream without its bit "
                             "width")
    bit_width = int(buf[pos])
    if bit_width == 0:
        return np.zeros(len(take), dtype=np.int64)
    return select_rle(buf, num_values, bit_width, take, pos + 1)


def decode_plain_masked(data, num_values: int, take: np.ndarray,
                        physical: Type, type_length: Optional[int] = None):
    """The PLAIN values at the ``take`` ordinals of a fixed-width page,
    gathered from a view of its bytes; None for BYTE_ARRAY (its length
    prefixes need a sequential scan: the caller decodes the page whole)."""
    take = np.asarray(take, dtype=np.int64)
    buf = host.as_u8(data)
    if physical == Type.BYTE_ARRAY:
        return None
    if physical == Type.BOOLEAN:
        nbytes = (num_values + 7) // 8
    elif physical == Type.FIXED_LEN_BYTE_ARRAY:
        nbytes = type_length * num_values
    else:
        nbytes = {Type.INT96: 12}.get(
            physical, PHYSICAL_NP_DTYPE[physical].itemsize) * num_values
    if len(buf) < nbytes:
        raise CorruptedError(f"PLAIN page holds {len(buf)} bytes, "
                             f"{num_values} values need {nbytes}")
    if physical == Type.BOOLEAN:
        bits = np.unpackbits(buf[:nbytes], bitorder="little")
        return bits[:num_values][take].astype(np.bool_)
    if physical == Type.INT96:
        return buf[:nbytes].view(np.int32).reshape(num_values, 3)[take]
    if physical == Type.FIXED_LEN_BYTE_ARRAY:
        return buf[:nbytes].reshape(num_values, type_length)[take]
    return buf[:nbytes].view(PHYSICAL_NP_DTYPE[physical])[take]


def decode_delta_binary_packed_masked(data, num_values: int,
                                      take: np.ndarray,
                                      pos: int = 0) -> np.ndarray:
    """The DELTA_BINARY_PACKED values at the ``take`` ordinals: every delta
    feeds the running sum, so the page decodes whole (in C++) and the
    selection is what is saved downstream."""
    vals = host.decode_delta_binary_packed(host.as_u8(data)[pos:])[0]
    return vals[:num_values][np.asarray(take, dtype=np.int64)]


def decode_rle_len_prefixed(data, num_values: int, bit_width: int,
                            pos: int = 0) -> Tuple[np.ndarray, int]:
    """A hybrid stream behind its 4-byte length (v1 page levels, RLE
    booleans): ``(values int32, end)``."""
    buf = host.as_u8(data)
    if pos + 4 > len(buf):
        raise CorruptedError("level stream length truncated")
    length = int(buf[pos:pos + 4].view("<u4")[0])
    if pos + 4 + length > len(buf):
        raise CorruptedError(f"level stream of {length} bytes overruns its "
                             "page")
    body = buf[pos + 4:pos + 4 + length]
    return decode_rle(body, num_values, bit_width), pos + 4 + length


def encode_rle(values: np.ndarray, bit_width: int, min_repeat: int = 8) -> bytes:
    """Encode the hybrid stream (no prefix), in C++ (``ops/host.py``).

    A bit-packed run encodes exactly ``ngroups * 8`` values, so mid-stream
    bit-packed spans are whole groups of 8; only the final group may be
    zero-padded.  Runs of >= ``min_repeat`` identical values become RLE
    runs, the common writer heuristic: each RLE-eligible run first gives
    the packed span before it values enough to end on a whole group, and
    stays a run if ``min_repeat`` values are left."""
    return host.encode_rle(values, bit_width, min_repeat)


def encode_rle_dict_indices(values: np.ndarray, bit_width: int) -> bytes:
    """RLE_DICTIONARY data page payload: 1-byte bit width, then the stream."""
    return bytes([bit_width]) + encode_rle(values, bit_width)


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED
# ---------------------------------------------------------------------------


def _bit_lengths(x: np.ndarray) -> np.ndarray:
    """Bit length of each uint64 in ``x`` (0 for 0), by binary search."""
    x = np.array(x, np.uint64)
    w = np.zeros(len(x), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= np.uint64(1 << s)
        w[big] += s
        x[big] >>= np.uint64(s)
    return w + (x > 0)


def encode_delta_binary_packed(values: np.ndarray, block_size: int = 128,
                               n_miniblocks: int = 4) -> bytes:
    """Encode int32/int64 values: blocks of ``block_size`` deltas, each with
    its min delta and ``n_miniblocks`` bit widths (the common layout is 128
    values in 4 miniblocks of 32).  Deltas wrap mod 2^64.  The miniblock
    math is vectorized over the whole page; the per-block headers are
    written in one Python loop."""
    v = np.asarray(values, dtype=np.int64)
    total = len(v)
    out = bytearray()
    write_uvarint(out, block_size)
    write_uvarint(out, n_miniblocks)
    write_uvarint(out, total)
    if total == 0:
        write_uvarint(out, 0)
        return bytes(out)
    write_uvarint(out, zigzag(int(v[0])))
    if total == 1:
        return bytes(out)
    deltas = (v[1:].astype(np.uint64) - v[:-1].astype(np.uint64)).astype(np.int64)
    vpm = block_size // n_miniblocks
    nd = len(deltas)
    nblocks = -(-nd // block_size)
    real = np.zeros(nblocks * block_size, bool)
    real[:nd] = True
    padded = np.full(nblocks * block_size, np.iinfo(np.int64).max, np.int64)
    padded[:nd] = deltas
    mins = padded.reshape(nblocks, block_size).min(axis=1)
    adj = padded.astype(np.uint64) - np.repeat(mins, block_size).astype(np.uint64)
    adj[~real] = 0  # padding slots pack as zeros
    mb = adj.reshape(nblocks * n_miniblocks, vpm)
    widths = _bit_lengths(mb.max(axis=1))
    payloads = [b""] * len(mb)
    for w in np.unique(widths):
        if w == 0:
            continue
        rows = np.flatnonzero(widths == w)
        for r, packed in zip(rows, _pack_rows(mb[rows], int(w))):
            payloads[r] = packed.tobytes()
    wbytes = widths.astype(np.uint8).reshape(nblocks, n_miniblocks)
    for b in range(nblocks):
        write_uvarint(out, zigzag(int(mins[b])))
        out += wbytes[b].tobytes()
        # trailing miniblocks past the last delta are not written
        n_written = -(-min(block_size, nd - b * block_size) // vpm)
        for m in range(n_written):
            out += payloads[b * n_miniblocks + m]
    return bytes(out)


def decode_delta_binary_packed(data, pos: int = 0) -> Tuple[np.ndarray, int]:
    """Decode a DELTA_BINARY_PACKED stream to int64 values (mod-2^64
    arithmetic) and its end position: the miniblock prescan, then one
    vectorized unpack per bit width.  The plain version of
    ``host.decode_delta_binary_packed``, which the read path runs, kept as
    the tests' oracle."""
    from .device import delta_prescan

    buf = host.as_u8(data)
    first, total, vpm, offs, widths, mins, end = delta_prescan(buf, pos)
    out = np.empty(total, np.int64)
    if total == 0:
        return out, end
    deltas = np.zeros((len(widths), vpm), np.uint64)
    byte_offs = np.asarray(offs, np.int64) // 8
    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        rows = np.flatnonzero(widths == w)
        nb = vpm * w // 8
        # a writer may cut the last miniblock short: clipped reads land in
        # slots past the page's value count
        idx = np.minimum(byte_offs[rows][:, None] + np.arange(nb),
                         len(buf) - 1)
        bits = np.unpackbits(buf[idx], axis=1, bitorder="little")
        wide = np.zeros((len(rows), vpm, 64), np.uint8)
        wide[:, :, :w] = bits.reshape(len(rows), vpm, w)
        deltas[rows] = np.packbits(wide, axis=2, bitorder="little").view(
            "<u8")[:, :, 0]
    deltas += np.asarray(mins, np.int64).view(np.uint64)[:, None]
    out[0] = first
    out[1:] = deltas.reshape(-1)[:total - 1].view(np.int64)
    return np.cumsum(out, out=out), end


# ---------------------------------------------------------------------------
# BIT_PACKED levels (deprecated; MSB-first bit order)
# ---------------------------------------------------------------------------


def decode_bit_packed_levels(data, num_values: int,
                             bit_width: int) -> np.ndarray:
    if bit_width == 0:
        return np.zeros(num_values, np.int64)
    buf = host.as_u8(data)
    need = num_values * bit_width
    if len(buf) * 8 < need:
        raise CorruptedError(f"BIT_PACKED levels: {len(buf)} bytes for "
                             f"{num_values} {bit_width}-bit values")
    bits = np.unpackbits(buf, bitorder="big")[:need]
    weights = (1 << np.arange(bit_width - 1, -1, -1)).astype(np.int64)
    return bits.reshape(num_values, bit_width).astype(np.int64) @ weights


def encode_bit_packed_levels(values: np.ndarray, bit_width: int) -> bytes:
    if bit_width == 0 or len(values) == 0:
        return b""
    v = np.asarray(values, np.int64)
    bits = ((v[:, None] >> np.arange(bit_width - 1, -1, -1)) & 1).astype(
        np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="big").tobytes()


# ---------------------------------------------------------------------------
# DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY (front coding)
# ---------------------------------------------------------------------------


def decode_delta_length_byte_array(data, pos: int = 0,
                                   max_values: Optional[int] = None):
    """``(values uint8, offsets int64[n + 1], end)``; the values are a view
    of ``data``.  ``max_values``: the most lengths the page may hold."""
    lengths, pos = host.decode_delta_binary_packed(data, pos, max_values)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    buf = host.as_u8(data)
    total = int(offsets[-1])
    if (lengths < 0).any() or pos + total > len(buf):
        raise CorruptedError(f"DELTA_LENGTH_BYTE_ARRAY: {len(lengths)} "
                             f"lengths of {total} bytes, {len(buf) - pos} "
                             "in the page")
    return buf[pos:pos + total], offsets, pos + total


def decode_delta_byte_array_parts(data, pos: int = 0,
                                  max_values: Optional[int] = None):
    """The two length streams of a DELTA_BYTE_ARRAY page, no prefix
    expanded: ``(prefix_lens int64, suffix bytes, suffix offsets int64,
    end)``; the device expands the prefixes.  ``max_values``: the most
    values the page may hold."""
    prefix_lens, pos = host.decode_delta_binary_packed(data, pos, max_values)
    suffixes, soffs, pos = decode_delta_length_byte_array(data, pos,
                                                          max_values)
    if len(prefix_lens) != len(soffs) - 1:
        raise CorruptedError(f"DELTA_BYTE_ARRAY: {len(prefix_lens)} prefix "
                             f"lengths for {len(soffs) - 1} suffixes")
    return prefix_lens, suffixes, soffs, pos


def decode_delta_byte_array(data, pos: int = 0):
    """Front coding expanded on the host: ``(values uint8, offsets
    int64[n + 1], end)``.  Every output byte first points at its source (a
    suffix byte, or the same byte of the value before), and the prefix
    chains resolve by pointer jumping, as ``ops/device.py`` does on the
    device.  A prefix longer than the value before it (the first value's
    before it is empty) is corrupt."""
    plens, suffixes, soffs, end = decode_delta_byte_array_parts(data, pos)
    slens = np.diff(soffs)
    lens = plens + slens
    prev = np.concatenate([[0], lens[:-1]])
    if len(plens) and ((plens < 0).any() or (plens > prev).any()):
        raise CorruptedError("DELTA_BYTE_ARRAY prefix longer than the "
                             "value before it")
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    vid = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(total, dtype=np.int64) - offsets[:-1][vid]
    in_prefix = within < plens[vid]
    # a prefix byte points at the same byte of the value before, a suffix
    # byte at itself; chains end at suffix bytes
    ptr = np.arange(total, dtype=np.int64)
    ptr[in_prefix] = (offsets[:-1][vid[in_prefix] - 1]
                      + within[in_prefix])
    while True:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        ptr = nxt
    sv = vid[ptr]
    sidx = soffs[:-1][sv] + (ptr - offsets[:-1][sv]) - plens[sv]
    return host.as_u8(suffixes)[sidx], offsets, end


def decode_byte_stream_split(data, num_values: int,
                             width: int) -> np.ndarray:
    """The ``(num_values, width)`` little-endian bytes of a byte-stream-split
    page: plane k holds byte k of every value."""
    buf = host.as_u8(data)
    if len(buf) < num_values * width:
        raise CorruptedError(f"BYTE_STREAM_SPLIT page holds {len(buf)} "
                             f"bytes, {num_values} values need "
                             f"{num_values * width}")
    return np.ascontiguousarray(
        buf[:num_values * width].reshape(width, num_values).T)


def encode_delta_length_byte_array(values: np.ndarray,
                                   offsets: np.ndarray) -> bytes:
    offs = np.asarray(offsets, np.int64)
    lengths = offs[1:] - offs[:-1]
    return encode_delta_binary_packed(lengths) + host.as_u8(
        values)[offs[0]:offs[-1]].tobytes()


def encode_delta_byte_array(values: np.ndarray, offsets: np.ndarray) -> bytes:
    """Front coding: each value's common prefix with the one before (C++),
    then the suffixes as DELTA_LENGTH_BYTE_ARRAY; byte for byte the JAX
    package's encoding."""
    offs = np.asarray(offsets, np.int64)
    vals = host.as_u8(values)
    prefix_lens = host.common_prefix_lengths(vals, offs)
    lens = offs[1:] - offs[:-1]
    suffix_lens = lens - prefix_lens
    idx = np.repeat(offs[:-1] + prefix_lens, suffix_lens) + \
        host.segment_ranges(suffix_lens)
    soffs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(suffix_lens, out=soffs[1:])
    return encode_delta_binary_packed(prefix_lens) + \
        encode_delta_length_byte_array(vals[idx], soffs)


# ---------------------------------------------------------------------------
# BYTE_STREAM_SPLIT and the dictionary gather
# ---------------------------------------------------------------------------


def encode_byte_stream_split(raw_le_bytes: np.ndarray, num_values: int,
                             width: int) -> bytes:
    b = host.as_u8(raw_le_bytes).reshape(num_values, width)
    return np.ascontiguousarray(b.T).tobytes()


def gather_dictionary(dictionary, indices: np.ndarray):
    """``dictionary[indices]``; a ``(values, offsets)`` byte-array
    dictionary gives a ``(values, offsets)`` pair."""
    if isinstance(dictionary, tuple):
        return host.gather_byte_arrays_numpy(dictionary[0], dictionary[1],
                                             indices)
    return np.asarray(dictionary)[np.asarray(indices, np.int64)]
