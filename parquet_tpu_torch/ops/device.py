"""Device decode ops of the slice, as plain torch functions.

The port of the XLA (not Pallas) kernels of ``parquet_tpu/ops/device.py``
that the flat read path runs: PLAIN bitcasts, the word-gather bit unpack at
arbitrary bit positions, the RLE/bit-packed run expansion (dictionary
indexes, levels and booleans), the BYTE_STREAM_SPLIT plane transpose, the
front-coded (DELTA_BYTE_ARRAY) expansion by pointer jumping, the
dictionary and byte-array gathers and the level math, plus the host
prescans of DELTA_BINARY_PACKED miniblocks and of front coding.  The JAX package keeps 64-bit columns as uint32 pairs because of
the TPU's 32-bit lanes; here 64-bit values are native ``int64``/``float64``
tensors and all index math runs in ``int64``.

Every function takes tensors on one device and returns tensors on it.  On
the CPU, torch has no ``>>``/``<<`` for ``uint32``, so bit math widens 32-bit
words to ``int64`` first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import CorruptedError
from . import ref

_M32 = 0xFFFFFFFF

#: chunks whose staged byte stream is larger than this are not decoded on
#: the device in this slice (the JAX package's bound, where bit offsets had
#: to fit 32-bit lanes)
MAX_DEVICE_BUF = 1 << 27


def pad_to_bucket(arr: np.ndarray, extra: int = 12) -> np.ndarray:
    """Pad a host buffer to a power-of-two bucket with at least ``extra``
    zero bytes of slack, so word gathers past the last value stay inside
    the staged buffer."""
    n = len(arr) + extra
    bucket = 1 << max(int(n - 1).bit_length(), 6)
    if bucket == len(arr):
        return arr
    out = np.zeros(bucket, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


# ---------------------------------------------------------------------------
# PLAIN fixed-width: decode == reinterpret
# ---------------------------------------------------------------------------


def bitcast_fixed32(buf: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """uint8 staged bytes -> {int32, float32}[n] (PLAIN 4-byte types), a view."""
    return buf[: n * 4].view(dtype)


def bitcast_fixed64(buf: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """uint8 staged bytes -> {int64, float64}[n] (PLAIN 8-byte types), a view."""
    return buf[: n * 8].view(dtype)


# ---------------------------------------------------------------------------
# Bit unpack at arbitrary bit positions (mixed-width streams)
# ---------------------------------------------------------------------------


def _word_pair(words32: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """64-bit window ``words[wi] | words[wi + 1] << 32`` per element, with the
    word indices clamped to the stream (garbage past the end only lands in
    slots the caller discards)."""
    last = words32.shape[0] - 1
    lo = words32[wi.clamp(max=last)].to(torch.int64) & _M32
    hi = words32[(wi + 1).clamp(max=last)].to(torch.int64)
    return lo | (hi << 32)


def _low_mask(widths: torch.Tensor) -> torch.Tensor:
    """(1 << w) - 1 per element for w in 0..64."""
    w = widths.to(torch.int64)
    return torch.where(w >= 64, torch.full_like(w, -1),
                       (torch.ones_like(w) << w.clamp(max=63)) - 1)


def unpack_bits_at32(buf: torch.Tensor, bit_starts: torch.Tensor,
                     widths) -> torch.Tensor:
    """One <= 32-bit LSB-first integer per element at absolute bit positions
    of the uint8 stream ``buf`` (whose length is a multiple of 4); ``widths``
    is an int or one width per element, and widths above 32 keep the low 32
    bits (the mod-2^32 arithmetic of INT32 delta streams).  int64 out, in
    [0, 2^32)."""
    words32 = buf.view(torch.int32)
    bit_starts = bit_starts.to(torch.int64)
    window = _word_pair(words32, bit_starts >> 5)
    val = window >> (bit_starts & 31)
    w = torch.as_tensor(widths, device=buf.device).to(torch.int64)
    return val & _low_mask(w.clamp(max=32))


def unpack_bits_at64(buf: torch.Tensor, bit_starts: torch.Tensor,
                     widths) -> torch.Tensor:
    """Like :func:`unpack_bits_at32` for widths <= 64: the full 64-bit
    pattern as int64 (three word gathers per element)."""
    words32 = buf.view(torch.int32)
    bit_starts = bit_starts.to(torch.int64)
    wi = bit_starts >> 5
    sh = bit_starts & 31
    lo = (_word_pair(words32, wi) >> sh) & _M32
    hi = (_word_pair(words32, wi + 1) >> sh) & _M32
    w = torch.as_tensor(widths, device=buf.device).to(torch.int64)
    return (lo | (hi << 32)) & _low_mask(w)


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid expansion (device half of the two-pass split)
# ---------------------------------------------------------------------------


def rle_expand(buf: torch.Tensor, n: int, run_ends: torch.Tensor,
               run_kinds: torch.Tensor, run_payloads: torch.Tensor,
               run_bit_offsets: torch.Tensor,
               run_widths: torch.Tensor) -> torch.Tensor:
    """Expand a host-scanned hybrid stream (levels, dictionary indexes) to
    ``n`` int32 values in one gather-driven pass.  ``run_ends`` holds the
    cumulative value count after each run (int64), ``run_kinds`` 0 for RLE
    and 1 for bit-packed runs, ``run_payloads`` the value of each RLE run,
    ``run_bit_offsets`` the absolute bit offset of each packed run in
    ``buf`` and ``run_widths`` each run's bit width (pages may differ)."""
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=buf.device)
    idx = torch.arange(n, dtype=torch.int64, device=buf.device)
    run_id = torch.searchsorted(run_ends, idx, right=True)
    run_id = run_id.clamp_(max=run_ends.shape[0] - 1)
    counts = torch.diff(run_ends, prepend=run_ends.new_zeros(1))
    within = idx - (run_ends - counts)[run_id]
    w = run_widths[run_id]
    packed_run = run_kinds[run_id] != 0
    # RLE runs take their payload: their gather position must not walk past
    # the stream
    bit_pos = torch.where(packed_run, run_bit_offsets[run_id] + within * w, 0)
    packed = unpack_bits_at32(buf, bit_pos, w)
    return torch.where(packed_run, packed, run_payloads[run_id]).to(torch.int32)


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED host prescan
# ---------------------------------------------------------------------------


def delta_prescan(data, pos: int = 0):
    """Host pre-scan of a DELTA_BINARY_PACKED stream into device metadata.

    Returns (first_value, total, vpm, mb_bit_offsets, mb_widths,
    mb_min_deltas, end_pos).  O(miniblocks), not O(values).  The plain
    version of the C++ table the read path builds
    (``host.delta_prescan``), kept as the tests' oracle."""
    block_size, pos = ref.read_uvarint(data, pos)
    n_miniblocks, pos = ref.read_uvarint(data, pos)
    total, pos = ref.read_uvarint(data, pos)
    first_raw, pos = ref.read_uvarint(data, pos)
    first = ref.unzigzag(first_raw)
    if n_miniblocks == 0 or block_size == 0 or block_size % n_miniblocks:
        raise CorruptedError(
            f"malformed DELTA_BINARY_PACKED header: block_size={block_size}, "
            f"miniblocks={n_miniblocks}")
    vpm = block_size // n_miniblocks
    offsets, widths, mins = [], [], []
    got = 1
    while got < total:
        md_raw, pos = ref.read_uvarint(data, pos)
        min_delta = ref.unzigzag(md_raw)
        wbytes = data[pos : pos + n_miniblocks]
        pos += n_miniblocks
        for m in range(n_miniblocks):
            if got >= total:
                break
            w = int(wbytes[m])
            offsets.append(pos * 8)
            widths.append(w)
            mins.append(min_delta)
            pos += vpm * w // 8
            got += min(vpm, total - got)
    return (
        first, total, vpm,
        np.asarray(offsets, dtype=np.int64),
        np.asarray(widths, dtype=np.int32),
        np.asarray(mins, dtype=np.int64),
        pos,
    )


# ---------------------------------------------------------------------------
# BYTE_STREAM_SPLIT (plane transpose)
# ---------------------------------------------------------------------------


def byte_stream_split(buf: torch.Tensor, n: int, width: int,
                      out_dtype=None) -> torch.Tensor:
    """One page of ``n`` byte-stream-split values: byte plane k is
    ``buf[k * n:(k + 1) * n]``.  Returns the (n, width) uint8 rows, or
    with ``out_dtype`` (a 4- or 8-byte dtype) the 1-D values."""
    rows = buf[:width * n].reshape(width, n).T.contiguous()
    if out_dtype is None:
        return rows
    return rows.view(out_dtype).reshape(n)


# ---------------------------------------------------------------------------
# DELTA_BYTE_ARRAY: host prefix-length prescan, suffix gather and prefix
# resolution by pointer jumping on the device
# ---------------------------------------------------------------------------


def delta_byte_array_prescan(data, pos: int = 0,
                             max_values: Optional[int] = None):
    """Host prescan of one DELTA_BYTE_ARRAY page of at most
    ``max_values`` values: ``(prefix_lens int64, suffix bytes, suffix
    offsets int64, end)``; no output byte is expanded on the host."""
    return ref.decode_delta_byte_array_parts(data, pos, max_values)


def delta_byte_array_iters(prefix_lens: np.ndarray) -> int:
    """Pointer-jumping rounds :func:`delta_byte_array_expand` needs: a
    prefix byte chases its parents through at most the longest run of
    consecutive entries with a nonzero prefix, and each round doubles the
    distance resolved."""
    nz = np.asarray(prefix_lens) > 0
    if not nz.size or not nz.any():
        return 0
    edges = np.flatnonzero(np.diff(
        np.concatenate(([False], nz, [False])).astype(np.int8)))
    depth = int((edges[1::2] - edges[0::2]).max())
    return max(int(np.ceil(np.log2(depth + 1))), 1)


def delta_byte_array_expand(suffix_buf: torch.Tensor,
                            prefix_lens: torch.Tensor,
                            suffix_offs: torch.Tensor,
                            entry_offs: torch.Tensor, total: int,
                            iters: int) -> torch.Tensor:
    """Expand front-coded byte arrays on the device.  Each output byte
    either lies in its entry's suffix (a direct gather) or repeats the
    byte at the same position of the previous entry; prefix bytes start as
    pointers into the previous entry and resolve by ``ptr = ptr[ptr]``
    (``iters`` rounds), suffix bytes are fixed points.  Positions are
    int64: about 8 bytes of scratch per output byte."""
    if total == 0:
        return torch.zeros(0, dtype=torch.uint8, device=suffix_buf.device)
    pos = torch.arange(total, dtype=torch.int64, device=suffix_buf.device)
    e = torch.searchsorted(entry_offs, pos, right=True) - 1
    j = pos - entry_offs[e]
    plen = prefix_lens[e]
    in_suffix = j >= plen
    direct = suffix_offs[e] + torch.where(in_suffix, j - plen, 0)
    prev_start = entry_offs[(e - 1).clamp_(min=0)]
    ptr = torch.where(in_suffix, pos, prev_start + j)
    for _ in range(iters):
        ptr = ptr[ptr]
    return suffix_buf[direct[ptr]]


def cumsum_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """int64 offsets ``[0, l0, l0 + l1, ...]`` of a length array."""
    out = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                      device=lengths.device)
    torch.cumsum(lengths.to(torch.int64), 0, out=out[1:])
    return out


def gather_byte_arrays(values: torch.Tensor, offsets: torch.Tensor,
                       indices: torch.Tensor) -> tuple:
    """Entries ``indices`` of a ``(values, offsets)`` byte-array column, as
    a new ``(values, offsets int64)`` pair; indexes are clamped to the
    dictionary, as :func:`dict_gather` clamps."""
    idx = indices.to(torch.int64).clamp(0, max(offsets.shape[0] - 2, 0))
    starts = offsets[:-1][idx]
    lens = offsets[1:][idx] - starts
    out_offs = cumsum_offsets(lens)
    total = int(out_offs[-1])
    if total == 0:
        return values[:0], out_offs
    within = torch.arange(total, dtype=torch.int64, device=values.device)
    within -= torch.repeat_interleave(out_offs[:-1], lens,
                                      output_size=total)
    src = torch.repeat_interleave(starts, lens, output_size=total) + within
    return values[src], out_offs


# ---------------------------------------------------------------------------
# Dictionary gather and level math
# ---------------------------------------------------------------------------


def dict_gather(dictionary: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``dictionary[indices]``; an index past the end is clamped, so a
    corrupt stream cannot fault the device."""
    idx = indices.to(torch.int64).clamp(0, dictionary.shape[0] - 1)
    return dictionary[idx]


def validity_from_def(def_levels: torch.Tensor, max_def: int) -> torch.Tensor:
    return def_levels == max_def


def scatter_valid(values: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Dense present values -> slot-aligned array (nulls get 0); rows of
    a 2-D ``values`` (INT96, fixed-length byte arrays) move whole."""
    if not values.shape[0]:
        return values.new_zeros((validity.shape[0],) + values.shape[1:])
    slot_of_value = torch.cumsum(validity.to(torch.int64), 0) - 1
    gathered = values[slot_of_value.clamp(0, values.shape[0] - 1)]
    keep = validity.reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(keep, gathered, torch.zeros_like(gathered))


# ---------------------------------------------------------------------------
# The device scan's filter: predicate masks and prefix compaction
# ---------------------------------------------------------------------------


def sign_flip(values: torch.Tensor) -> torch.Tensor:
    """int32/int64 holding unsigned bits -> signed keys of the same order
    (the sign bit flipped), so that an unsigned column compares with the
    signed comparisons every device has."""
    return values ^ torch.iinfo(values.dtype).min


def range_mask(values: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``lo <= values <= hi`` (None: open), each bound a python number
    the values' dtype holds (a float bound on a float column compares in
    the column's precision, as numpy compares it)."""
    if lo is None and hi is None:
        return torch.ones(values.shape[0], dtype=torch.bool,
                          device=values.device)
    mask = values >= lo if lo is not None else values <= hi
    if lo is not None and hi is not None:
        mask &= values <= hi
    return mask


def in_mask(values: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """``values in probes`` for sorted, non-empty ``probes`` of the values'
    dtype: one binary search a value, O(n log k)."""
    idx = torch.searchsorted(probes, values).clamp_(max=probes.shape[0] - 1)
    return probes[idx] == values


def compact_targets(mask: torch.Tensor) -> tuple:
    """``(targets, count)`` of a row mask, both on its device: a kept row
    goes to its rank among the kept, a dropped row to ``n`` (past the
    end).  Nothing is read back."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask, pos, torch.full_like(pos, n))
    return tgt, pos[-1] + 1 if n else pos.new_zeros(())


def compact_prefix(values: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """The kept rows of ``values`` moved to the front in order (a stable
    prefix compaction by one scatter); the rows past the kept count are
    zero.  ``tgt`` is :func:`compact_targets`'."""
    n = values.shape[0]
    out = values.new_zeros((n + 1,) + values.shape[1:])
    out[tgt] = values
    return out[:n]


# ---------------------------------------------------------------------------
# Level assembly: def/rep levels -> list offsets and validity
# ---------------------------------------------------------------------------


def _compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The int64 positions of ``mask``'s True entries, for a ``count`` the
    caller read back already: :func:`compact_prefix` of the row numbers,
    so no call here waits on the device (``torch.nonzero`` reads its size
    back itself)."""
    rows = torch.arange(mask.shape[0], dtype=torch.int64, device=mask.device)
    return compact_prefix(rows, compact_targets(mask)[0])[:count]


def assemble_single_list(def_levels: torch.Tensor, rep_levels: torch.Tensor,
                         dk: int, max_def: int) -> tuple:
    """``ops/levels.assemble`` for ONE repeated level, whose def level is
    ``dk``: ``(list_offsets int64[rows + 1], list_validity bool[rows],
    leaf_validity bool[elements])``.  Rows are the slots with ``rep == 0``,
    elements the slots with ``def >= dk``; a row's list is non-null iff its
    first slot has ``def >= dk - 1``; a value is present iff ``def ==
    max_def``.  The two data-dependent sizes (rows, elements) are read back
    in one copy; the rest is cumsum, scatter and gather on the levels'
    device."""
    d, r = def_levels, rep_levels
    inst = r == 0
    elem = d >= dk
    n_rows, n_elem = (int(x) for x in torch.stack(
        [inst.sum(), elem.sum()]).tolist())
    cum = torch.cumsum(elem, 0)
    inst_idx = _compact(inst, n_rows)
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=d.device)
    if n_rows:
        offsets[:-1] = cum[inst_idx] - elem[inst_idx].to(torch.int64)
        offsets[-1] = cum[-1]
    list_validity = d[inst_idx] >= dk - 1
    leaf_validity = (d == max_def)[_compact(elem, n_elem)]
    return [offsets], [list_validity], leaf_validity


def assemble_nested(def_levels: torch.Tensor, rep_levels: torch.Tensor,
                    infos, max_def: int) -> tuple:
    """``ops/levels.assemble`` at any repetition depth, level by level:
    instances of level k are the slots with ``rep < k`` (below the
    outermost level also ``def >= d_{k-1}``), its elements those with
    ``rep < k_next`` and ``def >= d_k`` (the innermost: ``def >= d_k``); a
    list is non-null iff its first slot has ``def >= d_k - 1``.  ``infos``
    is ``levels.repeated_ancestors(leaf)``.  Returns ``(list_offsets,
    list_validity, leaf_validity)``, the first two lists with one tensor a
    repeated level, outermost first; offsets are int64.  Every level's size
    is read back in one copy."""
    d, r = def_levels, rep_levels
    reps = [int(i.rep_level) for i in infos]
    defs = [int(i.def_level) for i in infos]
    insts, elems = [], []
    for i, (k, dk) in enumerate(zip(reps, defs)):
        inst = r < k
        if i:
            inst &= d >= defs[i - 1]
        elem = d >= dk
        if i + 1 < len(reps):
            elem &= r < reps[i + 1]
        insts.append(inst)
        elems.append(elem)
    inner = d >= defs[-1]
    sizes = [int(x) for x in torch.stack(
        [m.sum() for m in insts] + [inner.sum()]).tolist()]
    offsets, validities = [], []
    for inst, elem, size, dk in zip(insts, elems, sizes, defs):
        inst_idx = _compact(inst, size)
        cum = torch.cumsum(elem, 0)
        offs = torch.zeros(size + 1, dtype=torch.int64, device=d.device)
        if size:
            offs[1:-1] = cum[inst_idx[1:] - 1]
            offs[-1] = cum[-1]
        offsets.append(offs)
        validities.append(d[inst_idx] >= dk - 1)
    leaf_validity = (d == max_def)[_compact(inner, sizes[-1])]
    return offsets, validities, leaf_validity
