"""Device decode of column chunks: chunk bytes -> device tensors -> Column.

The port of ``parquet_tpu/parallel/device_reader.py``: columns of every
physical type (BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY and
FIXED_LEN_BYTE_ARRAY) at any nesting depth, in PLAIN,
RLE_DICTIONARY/PLAIN_DICTIONARY, RLE (booleans), DELTA_BINARY_PACKED,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT pages, v1
or v2.  Each chunk runs three phases:

- :func:`build_plan`: host prescan of the pages into a :class:`_Plan`
  (decompression, RLE run headers of levels and values, delta miniblock
  headers, the offsets of PLAIN and DELTA_LENGTH byte arrays, the length
  streams of front coding: metadata-scale work), of the whole chunk or of
  a given span of its pages with a given dictionary (the point lookup's
  page runs).  The page walk, the batched decompression, the run scans,
  the present counts, the delta tables and the length streams are C++
  (``csrc/host_prescan.cpp`` through ``ops/host.py``); the rest of the
  walk over a chunk's pages is Python;
- :func:`stage_plan`: the concatenated byte streams and the run tables go
  to the device;
- :func:`decode_staged`: device decode into a :class:`Column`.  The dense
  dictionary-index and delta-miniblock streams unpack through the CUDA
  kernels of ``ops/kernels.py``; run expansion, gathers, the plane
  transpose, the front-coded expansion, the level math and assembly and
  the prefix sums are torch ops (``ops/device.py``).

Levels: a flat optional column expands its def levels on the device into
its validity.  A column under a repeated node expands both level streams
on the device and assembles them there (``dev.assemble_single_list`` for
one repeated level, ``dev.assemble_nested`` for more) into list offsets
and validity per level, on the card and on the CPU alike.  A struct chain
(``max_def > 1``, nothing repeated) expands its def levels once on the
host, keeps them in ``Column.def_levels`` for the nullness of each struct,
and stages its validity, ``def == max_def``.

A BYTE_ARRAY dictionary chunk stays encoded: a device ``(values,
offsets)`` dictionary plus int32 indexes, as the JAX package keeps it.  A
chunk the device route cannot decode raises ``errors._Unsupported``, and
:func:`decode_chunks_pipelined` sends it, and only it, to
``io/reader.decode_chunk_host``, counting it in :data:`HOST_ROUTE` by
reason.  64-bit values are native int64 / float64 tensors, not the JAX
package's uint32 pairs.
"""

from __future__ import annotations

import struct as _struct
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..errors import CorruptedError, _Unsupported, unsupported
from ..format.enums import Encoding, PageType, Type
from ..io.column import Column
from ..io.reader import data_page_bodies, decode_dictionary_page
from ..ops import device as dev
from ..ops import host, kernels, levels, ref
from ..schema.types import (PHYSICAL_TORCH_DTYPE, PHYSICAL_WIDTH,
                            empty_values)

_M32 = 0xFFFFFFFF

#: chunks the device route sent to the host decode, by reason: pages that
#: mix value kinds (a dictionary that fell back to PLAIN), a chunk mixing
#: RLE and legacy BIT_PACKED def levels, legacy BIT_PACKED levels in a
#: repeated column, INT96 byte-stream split, a front-coded page whose
#: first prefix is nonzero, a staged stream over ``dev.MAX_DEVICE_BUF``,
#: and delta pages of different miniblock sizes
HOST_ROUTE = {"mixed_page_kinds": 0, "mixed_level_encodings": 0,
              "bit_packed_repeated_levels": 0, "bss_int96": 0,
              "dba_first_prefix": 0, "stream_bound": 0,
              "mixed_delta_vpm": 0}


def reset_host_route() -> None:
    for k in HOST_ROUTE:
        HOST_ROUTE[k] = 0


def _bit_width(max_level: int) -> int:
    return int(max_level).bit_length()


@dataclass
class _RunTable:
    """Chunk-level merged RLE/bit-packed run table (host-scanned)."""

    ends: List[np.ndarray] = field(default_factory=list)
    kinds: List[np.ndarray] = field(default_factory=list)
    payloads: List[np.ndarray] = field(default_factory=list)
    bit_offsets: List[np.ndarray] = field(default_factory=list)
    widths: List[np.ndarray] = field(default_factory=list)
    total: int = 0

    def add_scanned(self, kinds, cnts, payloads, offs, width, base_byte, n):
        self.kinds.append(np.asarray(kinds))
        self.payloads.append(np.asarray(payloads))
        self.bit_offsets.append((np.asarray(offs) + base_byte) * 8)
        self.widths.append(np.full(len(kinds), width, dtype=np.int64))
        self.ends.append(self.total + np.cumsum(cnts))
        self.total += n

    def add(self, data: np.ndarray, n: int, width: int, base_byte: int):
        """Scan ``n`` values of a hybrid stream (C++,
        ``host.scan_rle_runs``) into the table; returns its run table."""
        kinds, cnts, payloads, offs, _end = host.scan_rle_runs(data, n,
                                                               width)
        self.add_scanned(kinds, cnts, payloads, offs, width, base_byte, n)
        return kinds, cnts, payloads, offs

    def add_bitpacked_span(self, n: int, width: int, base_byte: int):
        """A raw bit-packed span (a PLAIN BOOLEAN page) as one run."""
        self.add_scanned(np.ones(1, np.uint8), np.array([n], np.int64),
                         np.zeros(1, np.int64), np.zeros(1, np.int64), width,
                         base_byte, n)

    def run_arrays(self) -> Tuple[np.ndarray, ...]:
        """(ends, kinds, payloads, bit_offsets, widths), the operands of
        ``dev.rle_expand``, as flat int64 host arrays."""
        return tuple(np.concatenate(p).astype(np.int64) for p in
                     (self.ends, self.kinds, self.payloads, self.bit_offsets,
                      self.widths))

    def expand(self, dbuf: torch.Tensor, tables) -> torch.Tensor:
        return dev.rle_expand(dbuf, self.total, *tables)


class _ByteAccum:
    """Byte-stream accumulator holding zero-copy views, concatenated once
    at staging time, straight into the bucket-padded staging buffer."""

    __slots__ = ("_parts", "_n")

    def __init__(self):
        self._parts = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def extend(self, b) -> None:
        if not isinstance(b, np.ndarray):
            b = np.frombuffer(b, np.uint8)
        if len(b):
            self._parts.append(b)
            self._n += len(b)

    def array(self) -> np.ndarray:
        if not self._parts:
            return np.empty(0, np.uint8)
        if len(self._parts) == 1:
            return self._parts[0]
        return np.concatenate(self._parts)

    def padded_array(self, extra: int = 12) -> np.ndarray:
        """Like ``dev.pad_to_bucket(self.array(), extra)`` without the
        intermediate concatenation.  Always a fresh, writable buffer."""
        n = self._n + extra
        bucket = 1 << max(int(n - 1).bit_length(), 6)
        out = np.zeros(bucket, dtype=np.uint8)
        pos = 0
        for p in self._parts:
            out[pos:pos + len(p)] = p
            pos += len(p)
        return out


@dataclass
class _Plan:
    """Host-built staging plan for one chunk."""

    levels: _ByteAccum = field(default_factory=_ByteAccum)
    values: _ByteAccum = field(default_factory=_ByteAccum)
    def_runs: _RunTable = field(default_factory=_RunTable)
    rep_runs: _RunTable = field(default_factory=_RunTable)
    # def levels decoded on the host per page: legacy BIT_PACKED levels,
    # and every page of a struct chain
    host_def: List[np.ndarray] = field(default_factory=list)
    # 'plain_fixed' | 'plain_flba' | 'bool' | 'dict' | 'delta' | 'bss' |
    # 'dba' | 'host_ba'
    value_kind: Optional[str] = None
    plain_total: int = 0
    # dictionary index runs, or boolean runs
    vruns: _RunTable = field(default_factory=_RunTable)
    # dense single-width dict-index stream: bit-packed run payloads
    # compacted into one LSB-first w-bit stream, page-aligned to 32-value
    # groups; (start_value, n_values) per page
    dense: _ByteAccum = field(default_factory=_ByteAccum)
    dense_w: Optional[int] = None
    dense_pages: List[Tuple[int, int]] = field(default_factory=list)
    dense_ok: bool = True
    # delta
    d_firsts: List[int] = field(default_factory=list)
    d_counts: List[int] = field(default_factory=list)
    d_vpms: List[int] = field(default_factory=list)
    d_dense_static: Optional[tuple] = None
    d_mb_offs: List[np.ndarray] = field(default_factory=list)
    d_mb_widths: List[np.ndarray] = field(default_factory=list)
    d_mb_mins: List[np.ndarray] = field(default_factory=list)
    d_vpm: int = 32
    # byte-stream split: (base in values, value count) per page
    bss_pages: List[Tuple[int, int]] = field(default_factory=list)
    # front coding: per page the prefix lengths and suffix offsets (host),
    # and (base in values, entry count); the suffix bytes are in values
    dba_plens: List[np.ndarray] = field(default_factory=list)
    dba_soffs: List[np.ndarray] = field(default_factory=list)
    dba_pages: List[Tuple[int, int]] = field(default_factory=list)
    # host byte arrays: ('plain', page bytes, count) or ('dlba', value
    # bytes, offsets) per page, compacted at staging
    host_parts: List[tuple] = field(default_factory=list)
    total_slots: int = 0
    total_values: int = 0
    # numpy array, or (values, offsets) for byte arrays
    dictionary_host = None
    # True once a page's def levels are not the one all-present RLE run
    # (v1) or its header counts nulls (v2): the pages whose levels the
    # reference's host decode expands, giving the span a validity mask
    defs_expanded: bool = False
    leaf = None
    physical: Optional[Type] = None

    def set_kind(self, kind: str):
        if self.value_kind is None:
            self.value_kind = kind
        elif self.value_kind != kind:
            raise _Unsupported(
                "mixed_page_kinds",
                f"chunk mixing {self.value_kind} and {kind} pages")


def _all_equal(kinds, payloads, level: int) -> bool:
    """A scanned level stream is one RLE run of ``level``."""
    return len(kinds) == 1 and kinds[0] == 0 and payloads[0] == level


def build_plan(reader, pages: Optional[Iterable] = None,
               dictionary=None) -> _Plan:
    """Host prescan of a chunk's pages into a staging plan: every page of
    the chunk, or ``pages`` (data pages of one span) decoded with the
    chunk's already-decoded ``dictionary``."""
    leaf = reader.leaf
    physical = Type(reader.meta.type)
    max_def = leaf.max_definition_level
    max_rep = leaf.max_repetition_level
    dw, rw = _bit_width(max_def), _bit_width(max_rep)
    # a struct chain's def levels expand on the host, once
    struct_chain = max_rep == 0 and max_def > 1
    plan = _Plan()
    plan.leaf = leaf
    plan.physical = physical
    plan.dictionary_host = dictionary

    pages = list(reader.pages() if pages is None else pages)
    for page, raw in zip(pages, data_page_bodies(reader, pages)):
        h = page.header
        pt = page.page_type
        if pt == PageType.DICTIONARY_PAGE:
            plan.dictionary_host = decode_dictionary_page(reader, page)
            continue
        if pt == PageType.DATA_PAGE:
            dph = h.data_page_header
            n = dph.num_values
            pos = 0
            n_present = n
            rle_def = (Encoding(dph.definition_level_encoding)
                       == Encoding.RLE)
            if max_rep > 0:
                if Encoding(dph.repetition_level_encoding) != Encoding.RLE \
                        or not rle_def:
                    raise _Unsupported(
                        "bit_packed_repeated_levels",
                        f"legacy BIT_PACKED levels in the repeated column "
                        f"{leaf.name!r}")
                (length,) = _struct.unpack_from("<I", raw, pos)
                body = raw[pos + 4:pos + 4 + length]
                plan.rep_runs.add(body, n, rw, len(plan.levels))
                plan.levels.extend(body)
                pos += 4 + length
            if max_def > 0:
                if rle_def and struct_chain:
                    lv, pos = ref.decode_rle_len_prefixed(raw, n, dw, pos)
                    plan.host_def.append(lv)
                    n_present = int(np.count_nonzero(lv == max_def))
                    plan.defs_expanded |= n_present != n
                elif rle_def:
                    (length,) = _struct.unpack_from("<I", raw, pos)
                    body = raw[pos + 4:pos + 4 + length]
                    kinds, cnts, payloads, offs = plan.def_runs.add(
                        body, n, dw, len(plan.levels))
                    plan.levels.extend(body)
                    pos += 4 + length
                    n_present = host.count_present(body, kinds, cnts,
                                                   payloads, offs, dw,
                                                   max_def)
                    if n and not _all_equal(kinds, payloads, max_def):
                        plan.defs_expanded = True
                else:  # legacy BIT_PACKED levels: decoded on the host
                    lv = ref.decode_bit_packed_levels(raw[pos:], n, dw)
                    plan.host_def.append(lv)
                    pos += (n * dw + 7) // 8
                    n_present = int(np.count_nonzero(lv == max_def))
                    plan.defs_expanded = True
            _stage_values(plan, raw, pos, n_present, Encoding(dph.encoding),
                          physical, leaf)
            plan.total_slots += n
            plan.total_values += n_present
        elif pt == PageType.DATA_PAGE_V2:
            dph2 = h.data_page_header_v2
            n = dph2.num_values
            rl = dph2.repetition_levels_byte_length or 0
            dl = dph2.definition_levels_byte_length or 0
            payload = host.as_u8(page.payload)
            if max_rep > 0:
                body = payload[:rl]
                plan.rep_runs.add(body, n, rw, len(plan.levels))
                plan.levels.extend(body)
            if max_def > 0:
                body = payload[rl:rl + dl]
                if struct_chain:
                    plan.host_def.append(ref.decode_rle(body, n, dw))
                else:
                    plan.def_runs.add(body, n, dw, len(plan.levels))
                    plan.levels.extend(body)
                plan.defs_expanded |= bool(dph2.num_nulls)
            n_present = n - (dph2.num_nulls or 0)
            _stage_values(plan, raw, 0, n_present, Encoding(dph2.encoding),
                          physical, leaf)
            plan.total_slots += n
            plan.total_values += n_present
    if plan.host_def and plan.def_runs.total:
        raise _Unsupported("mixed_level_encodings",
                           f"column {leaf.name!r} mixing RLE and BIT_PACKED "
                           "definition levels")
    return plan


def _add_dense_page(plan: _Plan, body: np.ndarray, kinds, cnts, offs,
                    width: int, nvals: int) -> None:
    """Compact one dict page's index stream into the chunk's dense w-bit
    stream when every run is bit-packed.  Bit-packed runs hold whole
    8-value groups (8*w bits, byte aligned), so their payloads concatenate
    into one LSB-first stream; pages pad to 32-value boundaries (4*w
    bytes) so unpack groups never straddle pages."""
    if not plan.dense_ok or not len(kinds) or not np.all(
            np.asarray(kinds) == 1):
        plan.dense_ok = False
        return
    if plan.dense_w is None:
        plan.dense_w = width
    elif plan.dense_w != width:
        plan.dense_ok = False
        return
    group_bytes = 4 * width  # 32 values
    pad = -len(plan.dense) % group_bytes
    plan.dense.extend(np.zeros(pad, np.uint8))
    start_val = len(plan.dense) * 8 // width
    bview = np.asarray(body)
    for cnt, off in zip(np.asarray(cnts, np.int64),
                        np.asarray(offs, np.int64)):
        ngroups = (int(cnt) + 7) // 8
        plan.dense.extend(bview[int(off):int(off) + ngroups * width])
    plan.dense_pages.append((start_val, nvals))


def _stage_values(plan: _Plan, raw: np.ndarray, pos: int, nvals: int,
                  encoding: Encoding, physical: Type, leaf) -> None:
    if encoding in (Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY):
        plan.set_kind("dict")
        width = int(raw[pos]) if pos < len(raw) else 0
        body = raw[pos + 1:]
        base = len(plan.values)
        plan.values.extend(body)
        if width == 0:  # single-entry dictionary
            plan.vruns.add_scanned(np.zeros(1, np.uint8),
                                   np.array([nvals]), np.zeros(1, np.int64),
                                   np.zeros(1, np.int64), 1, base, nvals)
            plan.dense_ok = False
        else:
            kinds, cnts, _, offs = plan.vruns.add(body, nvals, width, base)
            _add_dense_page(plan, body, kinds, cnts, offs, width, nvals)
        return
    if encoding == Encoding.PLAIN:
        if physical == Type.BOOLEAN:
            plan.set_kind("bool")
            nbytes = (nvals + 7) // 8
            _check_length(raw, pos, nbytes, nvals, "PLAIN")
            base = len(plan.values)
            plan.values.extend(raw[pos:pos + nbytes])
            plan.vruns.add_bitpacked_span(nvals, 1, base)
            return
        if physical == Type.BYTE_ARRAY:  # offsets scanned at staging
            plan.set_kind("host_ba")
            plan.host_parts.append(("plain", raw[pos:], nvals))
            return
        if physical == Type.FIXED_LEN_BYTE_ARRAY:
            plan.set_kind("plain_flba")
            w = leaf.type_length
        else:
            plan.set_kind("plain_fixed")
            w = PHYSICAL_WIDTH[physical]
        _check_length(raw, pos, nvals * w, nvals, "PLAIN")
        plan.values.extend(raw[pos:pos + nvals * w])
        plan.plain_total += nvals
        return
    if encoding == Encoding.DELTA_BINARY_PACKED:
        if physical not in (Type.INT32, Type.INT64):
            raise CorruptedError(
                f"DELTA_BINARY_PACKED page in a {physical.name} column")
        plan.set_kind("delta")
        base = len(plan.values)
        plan.values.extend(raw[pos:])
        first, total, vpm, offs, widths, mins, _ = host.delta_prescan(raw,
                                                                      pos)
        plan.d_firsts.append(first)
        plan.d_counts.append(total)
        plan.d_mb_offs.append(offs + (base - pos) * 8)
        plan.d_mb_widths.append(widths)
        plan.d_mb_mins.append(mins)
        plan.d_vpm = vpm
        plan.d_vpms.append(vpm)
        return
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        w = (leaf.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
             else {Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4,
                   Type.DOUBLE: 8}.get(physical))
        if physical == Type.INT96:
            raise _Unsupported("bss_int96", "byte-stream-split INT96 values")
        if not w:
            raise CorruptedError(f"BYTE_STREAM_SPLIT page in a "
                                 f"{physical.name} column")
        plan.set_kind("bss")
        _check_length(raw, pos, nvals * w, nvals, "BYTE_STREAM_SPLIT")
        base = len(plan.values)
        plan.values.extend(raw[pos:pos + nvals * w])
        plan.bss_pages.append((base, nvals))
        return
    if encoding == Encoding.RLE and physical == Type.BOOLEAN:
        plan.set_kind("bool")
        (length,) = _struct.unpack_from("<I", raw, pos)
        body = raw[pos + 4:pos + 4 + length]
        base = len(plan.values)
        plan.values.extend(body)
        plan.vruns.add(body, nvals, 1, base)
        return
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY and \
            physical == Type.BYTE_ARRAY:
        plan.set_kind("host_ba")
        v, o, _ = ref.decode_delta_length_byte_array(raw, pos)
        plan.host_parts.append(("dlba", v, o))
        return
    if encoding == Encoding.DELTA_BYTE_ARRAY and physical in (
            Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        plan.set_kind("dba")
        plens, suffixes, soffs, _ = dev.delta_byte_array_prescan(raw, pos)
        if len(plens) and int(plens[0]) != 0:
            # front coding restarts on every page: a nonzero first prefix
            # would chase a value of another page
            raise _Unsupported("dba_first_prefix", "DELTA_BYTE_ARRAY page "
                               "with a nonzero first prefix")
        if len(plens) and ((plens < 0).any()
                           or (plens[1:] > np.diff(soffs)[:-1]
                               + plens[:-1]).any()):
            raise CorruptedError("DELTA_BYTE_ARRAY prefix longer than the "
                                 "value before it")
        base = len(plan.values)
        plan.values.extend(suffixes)
        plan.dba_plens.append(plens)
        plan.dba_soffs.append(soffs)
        plan.dba_pages.append((base, len(plens)))
        return
    raise unsupported(f"{encoding.name} pages of a {physical.name} column",
                      "more encodings")


def _check_length(raw: np.ndarray, pos: int, nbytes: int, nvals: int,
                  what: str) -> None:
    if len(raw) - pos < nbytes:
        raise CorruptedError(f"{what} page holds {len(raw) - pos} bytes, "
                             f"{nvals} values need {nbytes}")


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


def _put(arr: np.ndarray, device: torch.device,
         fresh: bool = False) -> torch.Tensor:
    """A host array as a tensor on ``device``.  Staged tensors never alias
    page buffers: an array that is not ``fresh`` (allocated for this
    staging) is copied first."""
    if not fresh:
        arr = np.array(arr, copy=True)
    t = torch.from_numpy(arr)
    return t.to(device) if device.type != "cpu" else t


def _nonempty(parts, dtype, fill=0) -> np.ndarray:
    """Concatenate per-page metadata; a zero-miniblock chunk (all
    single-value pages) still gets 1-element tables, so device gathers
    have an operand."""
    out = (np.concatenate(parts).astype(dtype) if parts
           else np.empty(0, dtype))
    return out if out.size else np.full(1, fill, dtype)


def _delta_gather_tables(plan: _Plan) -> tuple:
    """Gather-kernel operands (page_ends, firsts, mb_base, mb_offs,
    mb_widths, mb_mins) as int64 host arrays."""
    page_ends = np.cumsum(plan.d_counts).astype(np.int64)
    mb_base = np.zeros(len(plan.d_counts), np.int64)
    np.cumsum([len(w) for w in plan.d_mb_widths[:-1]], out=mb_base[1:])
    mb_offs = _nonempty(plan.d_mb_offs, np.int64)
    mb_widths = _nonempty(plan.d_mb_widths, np.int64, fill=1)
    mb_mins = _nonempty(plan.d_mb_mins, np.int64)
    firsts = np.asarray(plan.d_firsts, np.int64)
    return page_ends, firsts, mb_base, mb_offs, mb_widths, mb_mins


def _stage_delta_dense(plan: _Plan, meta: dict,
                       device: torch.device) -> bool:
    """Host half of the gather-free delta decode: compact all miniblock
    payloads into one contiguous stream per bit width, so the device
    unpacks each with the dense kernel.  Returns False for shapes the
    dense decode doesn't cover (mixed vpm, vpm not a multiple of 32, > 512
    pages, > 8 distinct widths or a width above 32); those use
    :func:`_delta_decode_multi`."""
    if not plan.d_counts:
        return False
    vpm = plan.d_vpm
    if len(set(plan.d_vpms)) != 1 or vpm % 32:
        return False
    if len(plan.d_counts) > 512:
        return False
    widths_all = np.concatenate(plan.d_mb_widths)
    uw = np.unique(widths_all)
    if len(widths_all) == 0 or len(uw) > 8 or int(uw[-1]) > 32:
        return False
    vals_np = plan.values.array()
    boffs = np.concatenate(plan.d_mb_offs) // 8
    streams, groups = [], []
    for w in uw:
        g = np.flatnonzero(widths_all == w)
        groups.append(g)
        nb = vpm * int(w) // 8
        idx = boffs[g][:, None] + np.arange(nb, dtype=np.int64)
        # the writer may truncate the final miniblock's payload: clip (the
        # garbage lands in delta slots past the page's value count)
        np.minimum(idx, len(vals_np) - 1, out=idx)
        streams.append(_put(dev.pad_to_bucket(vals_np[idx].reshape(-1),
                                              extra=4), device))
    perm = None
    if len(uw) > 1:
        # row j of the concatenated unpack holds miniblock order[j]: the
        # inverse permutation restores the original order
        perm = _put(np.argsort(np.concatenate(groups)), device)
    mins = _put(np.concatenate(plan.d_mb_mins).astype(np.int64), device)
    firsts = _put(np.asarray(plan.d_firsts, np.int64), device)
    meta["delta_dense"] = (tuple(streams), perm, mins, firsts)
    plan.d_dense_static = (vpm, tuple(int(w) for w in uw),
                           tuple(len(g) for g in groups),
                           tuple(int(c) for c in plan.d_counts))
    return True


def stage_levels_on_device(leaf, plan: _Plan) -> bool:
    """Whether the chunk's level streams go to the device: a repeated
    column's always (its offsets assemble there, nulls or not), a flat
    optional column's where a value is null, and never levels the plan
    decoded on the host (a struct chain's, legacy BIT_PACKED ones)."""
    if plan.host_def:
        return False
    return (leaf.max_repetition_level > 0
            or plan.total_values != plan.total_slots)


def stage_plan(plan: _Plan, device: torch.device) -> tuple:
    """H2D: the plan's concatenated level and value byte streams and its
    run tables, dictionary, delta, front-coding and byte-array tables go
    to ``device``.  Returns ``(levels, values, meta)``."""
    kind = plan.value_kind
    stage_levels = stage_levels_on_device(plan.leaf, plan)
    if (stage_levels and len(plan.levels) > dev.MAX_DEVICE_BUF) or \
            len(plan.values) > dev.MAX_DEVICE_BUF:
        raise _Unsupported("stream_bound", f"a chunk stream over "
                           f"{dev.MAX_DEVICE_BUF} bytes")
    lev_dbuf = None
    if stage_levels and len(plan.levels):
        lev_dbuf = _put(plan.levels.padded_array(), device, fresh=True)
    meta = {}
    dense_route = (kind == "dict" and plan.dense_ok
                   and bool(plan.dense_pages))
    delta_dense = (kind == "delta"
                   and _stage_delta_dense(plan, meta, device))
    val_dbuf = None
    if not dense_route and not delta_dense and kind not in (None,
                                                            "host_ba"):
        # staged even when empty (all-null chunks have no value bytes)
        val_dbuf = _put(plan.values.padded_array(), device, fresh=True)
    if dense_route:
        meta["dense"] = _put(plan.dense.padded_array(extra=4), device,
                             fresh=True)
    if kind == "delta" and not delta_dense:
        if len(set(plan.d_vpms)) > 1:
            raise _Unsupported("mixed_delta_vpm", "mixed delta miniblock "
                               "sizes across pages")
        meta["delta"] = tuple(_put(a, device, fresh=True)
                              for a in _delta_gather_tables(plan))
    if kind == "dict":
        meta["dictionary"] = _stage_dictionary(plan.dictionary_host, device)
    if (kind == "dict" and not dense_route) or kind == "bool":
        meta["vruns"] = tuple(_put(a, device, fresh=True)
                              for a in plan.vruns.run_arrays())
    if kind == "dba":
        tables, total, iters = _dba_tables(plan)
        meta["dba"] = (tuple(_put(a, device, fresh=True) for a in tables),
                       total, iters)
    if kind == "host_ba":
        values, offsets = _host_byte_arrays(plan.host_parts)
        meta["host_ba"] = (_put(values, device, fresh=True),
                           _put(offsets, device, fresh=True))
    if plan.host_def and plan.total_values != plan.total_slots:
        levels = np.concatenate(plan.host_def)
        meta["host_def"] = _put(levels == plan.leaf.max_definition_level,
                                device, fresh=True)
    if stage_levels and plan.def_runs.total:
        meta["def_runs"] = tuple(_put(a, device, fresh=True)
                                 for a in plan.def_runs.run_arrays())
    if stage_levels and plan.rep_runs.total:
        meta["rep_runs"] = tuple(_put(a, device, fresh=True)
                                 for a in plan.rep_runs.run_arrays())
    return lev_dbuf, val_dbuf, meta


def _stage_dictionary(dict_host, device: torch.device):
    if dict_host is None:
        raise CorruptedError("dictionary-encoded page without a dictionary "
                             "page")
    if isinstance(dict_host, tuple):  # byte arrays: (values, offsets)
        return (_put(dict_host[0], device),
                _put(np.asarray(dict_host[1], np.int64), device))
    return _put(np.ascontiguousarray(dict_host), device)


def _dba_tables(plan: _Plan) -> tuple:
    """The per-page front-coding tables concatenated for the chunk:
    ``((prefix_lens, suffix_offs, entry_offs), total, iters)`` as int64.
    Prefix chains never cross pages (every page's first prefix is 0), so
    the entries concatenate freely, suffix offsets rebased by each page's
    base in the staged suffix stream; ``entry_offs`` doubles as the
    column's offsets."""
    if not plan.dba_pages:
        empty = np.zeros(0, np.int64)
        return (empty, empty, np.zeros(1, np.int64)), 0, 0
    plens = np.concatenate(plan.dba_plens).astype(np.int64)
    soffs = np.concatenate([so[:-1] + base for (base, _), so in
                            zip(plan.dba_pages, plan.dba_soffs)])
    slens = np.concatenate([np.diff(so) for so in plan.dba_soffs])
    entry_offs = np.zeros(len(plens) + 1, np.int64)
    np.cumsum(plens + slens, out=entry_offs[1:])
    return ((plens, soffs.astype(np.int64), entry_offs),
            int(entry_offs[-1]), dev.delta_byte_array_iters(plens))


def _host_byte_arrays(parts) -> tuple:
    """The chunk's PLAIN and DELTA_LENGTH byte-array pages as one
    ``(values, offsets int64)`` pair on the host: each run of PLAIN pages
    is one C++ offset scan that compacts its values, DELTA_LENGTH pages
    already have theirs.  Fresh arrays: one copy of the bytes, or two
    where page kinds alternate."""
    groups, plain = [], []
    for part in parts:
        if part[0] == "plain":
            plain.append((part[1], part[2]))
            continue
        if plain:
            groups.append(host.plain_byte_arrays(plain))
            plain = []
        groups.append((part[1], part[2]))
    if plain:
        groups.append(host.plain_byte_arrays(plain))
    if len(groups) == 1 and parts[0][0] == "plain":
        return groups[0]
    if not groups:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    values = np.concatenate([g[0] for g in groups])
    offs, base = [np.zeros(1, np.int64)], 0
    for _, o in groups:
        offs.append(np.asarray(o[1:], np.int64) - o[0] + base)
        base += int(o[-1] - o[0])
    return values, np.concatenate(offs)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _low32_to_int32(x: torch.Tensor) -> torch.Tensor:
    """The int32 with the low 32 bits of each int64 (two's-complement
    wrap)."""
    x = x & _M32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _delta_decode_dense(streams, perm, mins, firsts, vpm: int, gw: tuple,
                        gk: tuple, pcounts: tuple,
                        physical: Type) -> torch.Tensor:
    """Gather-free multi-page delta decode (device half): one dense unpack
    per miniblock width, the miniblock order restored, per-page
    reassembly by slicing (page structure is host metadata) and a
    segmented prefix sum.  Sums run in int64 with two's-complement wrap:
    exactly the encoding's mod-2^64 arithmetic, and for INT32 its low 32
    bits."""
    device = mins.device
    parts = []
    for buf, w, k in zip(streams, gw, gk):
        if w == 0:
            # constant stride: every delta equals its min_delta
            parts.append(torch.zeros((k, vpm), dtype=torch.int64,
                                     device=device))
            continue
        words = buf.view(torch.int32)
        up = kernels.unpack_bits_dense(words, k * vpm, w)
        parts.append((up.to(torch.int64) & _M32).reshape(k, vpm))
    d2 = parts[0] if len(parts) == 1 else torch.cat(parts)
    if perm is not None:
        d2 = d2[perm]
    deltas = (d2 + mins[:, None]).reshape(-1)
    seq_parts = []
    mbb = 0
    for p, cnt in enumerate(pcounts):
        if cnt == 0:  # an all-null page stores no values
            continue
        seq_parts.append(firsts[p:p + 1])
        nd = cnt - 1
        seq_parts.append(deltas[mbb * vpm:mbb * vpm + nd])
        mbb += (nd + vpm - 1) // vpm
    seq = torch.cat(seq_parts) if seq_parts else deltas[:0]
    gcum = _segmented_cumsum(seq, pcounts)
    if physical == Type.INT32:
        return _low32_to_int32(gcum)
    return gcum


def _segmented_cumsum(seq: torch.Tensor, pcounts) -> torch.Tensor:
    """Prefix sums that restart at every page: the global cumsum minus the
    running total before each page."""
    gcum = torch.cumsum(seq, 0)
    if len(pcounts) > 1:
        counts = np.asarray(pcounts, np.int64)
        starts = np.cumsum(counts) - counts
        later = np.flatnonzero((starts > 0) & (counts > 0))
        before = torch.zeros(len(counts), dtype=torch.int64,
                             device=seq.device)
        before[torch.as_tensor(later, device=seq.device)] = gcum[
            torch.as_tensor(starts[later] - 1, device=seq.device)]
        gcum = gcum - torch.repeat_interleave(
            before, torch.as_tensor(counts, device=seq.device))
    return gcum


def _delta_decode_multi(buf: torch.Tensor, n: int, page_ends, firsts,
                        mb_base, mb_offs, mb_widths, mb_mins, vpm: int,
                        physical: Type) -> torch.Tensor:
    """All delta pages of a chunk in one gather-driven pass: each value
    finds its page, miniblock and bit position; seq[i] is the page's first
    value at a page start, else the unpacked delta; the output is the
    segmented prefix sum of seq."""
    device = buf.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    page = torch.searchsorted(page_ends, idx, right=True)
    page = page.clamp_(max=page_ends.shape[0] - 1)
    pcounts = torch.diff(page_ends, prepend=page_ends.new_zeros(1))
    pstart = page_ends[page] - pcounts[page]
    within = idx - pstart
    jc = (within - 1).clamp_(min=0)  # delta ordinal (page starts unused)
    mb = mb_base[page] + jc // vpm
    mb = mb.clamp_(max=mb_widths.shape[0] - 1)
    woff = jc % vpm
    w = mb_widths[mb]
    bit_pos = mb_offs[mb] + woff * w
    if physical == Type.INT32:
        raw = dev.unpack_bits_at32(buf, bit_pos, w)
    else:
        raw = dev.unpack_bits_at64(buf, bit_pos, w)
    delta = raw + mb_mins[mb]
    seq = torch.where(within == 0, firsts[page], delta)
    gcum = torch.cumsum(seq, 0)
    base = gcum[pstart] - seq[pstart]  # exclusive cumsum at page start
    out = gcum - base
    if physical == Type.INT32:
        return _low32_to_int32(out)
    return out


def _fusable(dictionary) -> bool:
    """Whether the fused unpack+gather kernel takes this dictionary: a 1-D
    tensor of 4- or 8-byte values of at most ``kernels.MAX_FUSED_DICT``
    entries (byte-array, fixed-length, INT96 and boolean dictionaries
    unpack their indexes and gather, as in the JAX package)."""
    return (isinstance(dictionary, torch.Tensor) and dictionary.dim() == 1
            and dictionary.element_size() in (4, 8)
            and dictionary.shape[0] <= kernels.MAX_FUSED_DICT)


def _decode_dense_dict(plan: _Plan, dense_buf: torch.Tensor, dictionary):
    """Dict-index decode from the compacted dense stream.  A fusable
    dictionary takes the fused unpack+gather kernel (no index stream);
    every other one unpacks the indexes, and all but a byte-array
    dictionary (which stays encoded) gather.  Returns (indices or None,
    values or None)."""
    w = plan.dense_w
    # round UP to whole 32-value groups: the last page's tail group may be
    # partial byte-wise; the unpack kernels zero-pad missing words
    total = -(-(len(plan.dense) * 8 // w) // 32) * 32
    nwords = (len(plan.dense) + 3) // 4
    words = dense_buf[:nwords * 4].view(torch.int32)
    if _fusable(dictionary):
        allvals = kernels.dict_unpack_gather(words, dictionary, total, w)
        return None, _page_slices(allvals, plan.dense_pages)
    allidx = kernels.unpack_bits_dense(words, total, w)
    indices = _page_slices(allidx, plan.dense_pages)
    if isinstance(dictionary, tuple):
        return indices, None
    return indices, dev.dict_gather(dictionary, indices)


def _page_slices(x: torch.Tensor, pages) -> torch.Tensor:
    parts = [x[s:s + n] for s, n in pages]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _bss_decode(buf: torch.Tensor, pages, width: int,
                physical: Type) -> torch.Tensor:
    """Byte-stream-split pages: plane k of a page is a static slice of the
    staged stream, so each page is one transpose.  Fixed-length byte
    arrays stay (n, width) bytes; the other types take their physical
    dtype (an INT32 column is int32, not float32)."""
    dtype = (None if physical == Type.FIXED_LEN_BYTE_ARRAY
             else PHYSICAL_TORCH_DTYPE[physical])
    if len(pages) == 1 and pages[0][0] == 0:
        return dev.byte_stream_split(buf, pages[0][1], width, dtype)
    parts = [buf[b:b + width * n].reshape(width, n).T for b, n in pages]
    rows = (torch.cat(parts) if parts
            else buf.new_zeros((0, width)))
    return rows if dtype is None else rows.view(dtype).reshape(-1)


def decode_staged(plan: _Plan, staged: tuple,
                  device: torch.device) -> Column:
    """Device decode phase: staged tensors -> :class:`Column`."""
    leaf, physical = plan.leaf, plan.physical
    lev_dbuf, val_dbuf, meta = staged
    max_def = leaf.max_definition_level
    validity = def_host = None
    list_offsets, list_validity = [], []
    if leaf.max_repetition_level:
        list_offsets, list_validity, validity = _assemble(plan, lev_dbuf,
                                                          meta, device)
    elif plan.total_values != plan.total_slots:
        if plan.def_runs.total:
            def_levels = plan.def_runs.expand(lev_dbuf, meta["def_runs"])
            validity = dev.validity_from_def(def_levels, max_def)
        elif plan.host_def:
            validity = meta["host_def"]
            if max_def > 1:  # a struct chain keeps its levels
                def_host = np.concatenate(plan.host_def).astype(np.int32)

    dictionary = dict_indices = offsets = None
    kind = plan.value_kind
    nvals = plan.total_values
    if kind == "plain_fixed":
        if physical == Type.INT96:
            values = val_dbuf[:nvals * 12].view(torch.int32).reshape(nvals,
                                                                     3)
        elif PHYSICAL_WIDTH[physical] == 8:
            values = dev.bitcast_fixed64(val_dbuf, nvals,
                                         PHYSICAL_TORCH_DTYPE[physical])
        else:
            values = dev.bitcast_fixed32(val_dbuf, nvals,
                                         PHYSICAL_TORCH_DTYPE[physical])
    elif kind == "plain_flba":
        w = leaf.type_length
        values = val_dbuf[:nvals * w].reshape(nvals, w)
    elif kind == "bool":
        values = plan.vruns.expand(val_dbuf, meta["vruns"]) != 0
    elif kind == "dict":
        dictionary = meta["dictionary"]
        if meta.get("dense") is not None:
            dict_indices, values = _decode_dense_dict(plan, meta["dense"],
                                                      dictionary)
        else:
            dict_indices = plan.vruns.expand(val_dbuf, meta["vruns"])
            values = (None if isinstance(dictionary, tuple)
                      else dev.dict_gather(dictionary, dict_indices))
    elif kind == "delta":
        if meta.get("delta_dense") is not None:
            streams, perm, mins, firsts = meta["delta_dense"]
            vpm, gw, gk, pcounts = plan.d_dense_static
            values = _delta_decode_dense(streams, perm, mins, firsts, vpm,
                                         gw, gk, pcounts, physical)
        else:
            values = _delta_decode_multi(val_dbuf, int(sum(plan.d_counts)),
                                         *meta["delta"], plan.d_vpm,
                                         physical)
    elif kind == "bss":
        w = (leaf.type_length if physical == Type.FIXED_LEN_BYTE_ARRAY
             else PHYSICAL_WIDTH[physical])
        values = _bss_decode(val_dbuf, plan.bss_pages, w, physical)
    elif kind == "dba":
        tables, total, iters = meta["dba"]
        values = dev.delta_byte_array_expand(val_dbuf, *tables, total, iters)
        if physical == Type.FIXED_LEN_BYTE_ARRAY:
            values = values.reshape(-1, leaf.type_length)
        else:
            offsets = tables[2]
    elif kind == "host_ba":
        values, offsets = meta["host_ba"]
    else:  # no data pages
        values = empty_values(physical, leaf.type_length, device)
        if physical == Type.BYTE_ARRAY:
            offsets = torch.zeros(1, dtype=torch.int64, device=device)
    col = Column(leaf=leaf, values=values, offsets=offsets,
                 validity=validity, num_slots=plan.total_slots,
                 dictionary=dictionary, dict_indices=dict_indices,
                 list_offsets=list_offsets, list_validity=list_validity,
                 def_levels=def_host)
    if col.num_values != nvals:
        raise CorruptedError(
            f"column {leaf.name!r}: decoded {col.num_values} values, the "
            f"pages declare {nvals}")
    return col


def _assemble(plan: _Plan, lev_dbuf, meta: dict,
              device: torch.device) -> tuple:
    """A repeated column's level streams, expanded and assembled on the
    device: ``(list_offsets, list_validity, leaf_validity)``."""
    leaf = plan.leaf
    if plan.def_runs.total:
        d = plan.def_runs.expand(lev_dbuf, meta["def_runs"])
        r = plan.rep_runs.expand(lev_dbuf, meta["rep_runs"])
    else:  # no data pages
        d = r = torch.zeros(0, dtype=torch.int32, device=device)
    infos = levels.repeated_ancestors(leaf)
    if len(infos) == 1:
        return dev.assemble_single_list(d, r, infos[0].def_level,
                                        leaf.max_definition_level)
    return dev.assemble_nested(d, r, infos, leaf.max_definition_level)


def decode_chunks_pipelined(chunks: Iterable,
                            device: torch.device) -> Iterator[Column]:
    """Decode column chunks on ``device``, in order: plan, stage and decode
    one chunk after another.  Kernels launch asynchronously on the current
    stream, so a chunk's device work overlaps the next chunk's host
    prescan; stream/event double buffering is a later slice.  A chunk the
    device route refuses (``_Unsupported``, and no other error) decodes on
    the host and is counted in :data:`HOST_ROUTE`."""
    from ..io.reader import decode_chunk_host

    for reader in chunks:
        try:
            plan = build_plan(reader)
            col = decode_staged(plan, stage_plan(plan, device), device)
        except _Unsupported as e:
            HOST_ROUTE[e.reason] += 1
            col = decode_chunk_host(reader, device)
        yield col
