"""Row-group-sharded and multi-file reads over a list of devices.

The port of ``parquet_tpu/parallel/mesh.py``.  The JAX package's mesh is
a ``jax.sharding.Mesh``; here a mesh is a list of ``torch.device``, one
entry a shard (:func:`default_mesh`: every visible card).  An entry may
repeat: ``[cuda:0] * 4`` is four shards on one card, and four files in
flight in :func:`read_dataset_device`.

- :func:`read_table_sharded` reads a file's flat columns as a
  :class:`ShardedTable`: row groups round-robin over the mesh, every
  chunk prescanned, staged and copied to its shard's device on a thread
  pool, then decoded on that device.  A shard of a column is one tensor
  padded to the longest shard (the JAX package's global array split by
  shard; there is no torch counterpart of
  ``make_array_from_single_device_arrays``).  Dictionary-encoded string
  columns shard their index stream over one dictionary unified across
  row groups; PLAIN string columns shard as ragged ``(bytes,
  slot offsets)`` pairs.
- :func:`decode_step_sharded` is the batched decode step, one shard a
  device, its row count summed over the shards (and over the processes
  of a ``torch.distributed`` group where one is initialized).
- :func:`read_dataset_device` reads a dataset's files round-robin over
  the mesh: each file's chunks staged in one pinned batch and one copy
  (``device_reader.prepare_chunks_batched``) and decoded on its device,
  both on a shared-pool worker, with up to ``min(len(mesh), 4)`` files
  in flight (a mesh of one entry reads one file at a time).  A file the
  footer shows the device route cannot decode
  (``io/planner.py::device_encoding_supported``), or whose footer or
  staging raises ``CorruptedError`` or ``OSError``, takes the caller's
  per-file host read, counted in ``ROUTE_REFUSALS``; an error of its
  decode raises.

64-bit columns are native int64/float64 tensors, not the JAX package's
uint32 pairs.  :data:`MESH` holds the counters of both routes.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..errors import CorruptedError, _Unsupported
from ..format.enums import Type
from ..io.reader import ParquetFile, _select_leaves, resolve_device
from ..obs.ledger import ledger_account
from ..obs.metrics import counter as _ocounter
from ..obs.metrics import histogram as _ohistogram
from ..obs.scope import account as _oaccount
from ..ops import device as dev
from ..ops import host, ref
from ..utils import pool as _pool
from ..utils.debug import counters
from . import device_reader
from ..utils.locks import make_lock

#: the mesh routes' counters: files decoded on the device route, files
#: that ran ahead of the one being consumed, the staged bytes of files in
#: flight (a level, with its peak) and the chunks sent to the host decode
MESH = {"files_sharded": 0, "stage_overlapped": 0, "staging_bytes": 0,
        "staging_bytes_peak": 0, "chunks_host_fallback": 0}
_mesh_lock = make_lock("mesh.counters")


# the registry's view of MESH, and the staged bytes' ledger account
_M_H2D_S = _ohistogram("device.h2d_s")
_M_DECODE_S = _ohistogram("device.decode_s")
_METRIC = {"files_sharded": _ocounter("device.files_sharded"),
           "stage_overlapped": _ocounter("device.stage_overlapped")}
_ACC_STAGING = ledger_account("device.staging")


def _count(key: str, n: int = 1) -> None:
    with _mesh_lock:  # counted on the pool's workers
        MESH[key] += n
        if key == "staging_bytes":
            MESH["staging_bytes_peak"] = max(MESH["staging_bytes_peak"],
                                             MESH["staging_bytes"])
            if n >= 0:
                _ACC_STAGING.add(n)
            else:
                _ACC_STAGING.sub(-n)
    if key in _METRIC:
        _oaccount(_METRIC[key], n)


def reset_mesh() -> None:
    """Zero the counts; the staged bytes in flight stay, and their peak
    restarts from them."""
    with _mesh_lock:
        for k in ("files_sharded", "stage_overlapped",
                  "chunks_host_fallback"):
            MESH[k] = 0
        MESH["staging_bytes_peak"] = MESH["staging_bytes"]


def default_mesh(n: Optional[int] = None) -> List[torch.device]:
    """``cuda:0`` .. ``cuda:n-1`` (every visible card by default); raises
    without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "parquet_tpu_torch: CUDA is not available; pass a list of "
            "devices such as [torch.device('cpu')] * 8")
    count = torch.cuda.device_count()
    n = n or count
    if not 0 < n <= count:
        raise ValueError(f"default_mesh({n}): {count} CUDA device(s) "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_mesh(mesh) -> List[torch.device]:
    """The devices of ``mesh``: None or ``"cuda"`` is :func:`default_mesh`,
    another single device a mesh of one, and a list its entries (each
    checked as ``resolve_device`` checks it)."""
    if mesh is None:
        return default_mesh()
    if isinstance(mesh, (str, torch.device)):
        d = torch.device(mesh)
        if d.type == "cuda" and d.index is None:
            return default_mesh()
        mesh = [d]
    devs = []
    for d in mesh:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def _on(device: torch.device):
    """Make ``device`` the thread's current card (nothing for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def dataset_process_shard(dataset, process_index: Optional[int] = None,
                          process_count: Optional[int] = None):
    """This process's file shard of a dataset read by several processes
    (``Dataset.shard(i, n)``: files round-robin, disjoint, their union the
    corpus).  The defaults are the ``torch.distributed`` rank and world
    size where a process group is initialized, else 0 and 1."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    i = process_index if process_index is not None else (
        dist.get_rank() if up else 0)
    n = process_count if process_count is not None else (
        dist.get_world_size() if up else 1)
    return dataset.shard(i, n)


@dataclass(frozen=True)
class ShardedTable:
    """A file's flat columns sharded by row group over a mesh.

    ``arrays[path][d]`` is shard ``d``'s tensor on ``mesh[d]``: its row
    groups (those ``g`` with ``g % len(mesh) == d``, in order), padded
    with zeros to :attr:`shard_rows`; ``row_counts[d]`` is its real row
    count.  ``validity[path][d]`` (only for a column with nulls) marks the
    present slots; null and padding slots hold zeros.  A
    dictionary-encoded string column shards its int32 indexes into
    ``dictionaries[path]``, one host ``(uint8 values, int64 offsets)``
    dictionary unified across row groups (first occurrence first, so equal
    ids are equal strings on every shard).  A PLAIN string column (or one
    mixing dictionary and PLAIN chunks) shards as ``ragged[path] =
    (bytes, offsets)``, a list each: a shard's bytes padded to the widest
    shard's, its int64 slot offsets (null slots empty) padded to
    ``shard_rows + 1`` entries."""

    arrays: Dict[str, List[torch.Tensor]]
    validity: Dict[str, List[torch.Tensor]]
    row_counts: tuple
    mesh: tuple
    dictionaries: Dict[str, tuple] = field(default_factory=dict)
    ragged: Dict[str, tuple] = field(default_factory=dict)
    leaves: Dict[str, object] = field(default_factory=dict)

    def lookup_strings(self, path: str, ids) -> list:
        """The dictionary entries of ``path`` that ``ids`` name."""
        dvals, doffs = self.dictionaries[path]
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
        return [bytes(dvals[doffs[i]:doffs[i + 1]]) for i in np.asarray(ids)]

    def to_arrow(self):
        """Every shard brought to the host as one ``pyarrow.Table``, shard
        after shard, the padding dropped: a dictionary-index column as a
        ``DictionaryArray`` over its unified dictionary, a ragged column
        as one chunk a shard, the others by the leaf's type
        (``io/column.py::_leaf_to_arrow``, as ``ColumnSet.to_arrow``);
        the columns in the file's schema order.  Needs pyarrow."""
        import pyarrow as pa

        from ..io.column import _leaf_to_arrow

        masks = [m.cpu().numpy() for m in self.row_mask()]

        def rows(shards):
            return np.concatenate([s.cpu().numpy()[m]
                                   for s, m in zip(shards, masks)])

        cols = {}
        for path, shards in self.arrays.items():
            leaf = self.leaves.get(path)
            host_rows = rows(shards)
            valid = rows(self.validity[path]) if path in self.validity \
                else None
            if path in self.dictionaries:
                dvals, doffs = self.dictionaries[path]
                entries = _leaf_to_arrow(leaf, np.asarray(dvals),
                                         np.asarray(doffs, np.int64), None)
                ids = host_rows.astype(np.int32)
                ia = (pa.array(ids, mask=~valid) if valid is not None
                      else pa.array(ids))
                cols[path] = pa.DictionaryArray.from_arrays(ia, entries)
            elif leaf is None:  # a table built by hand: numpy's types
                cols[path] = (pa.array(host_rows, mask=~valid)
                              if valid is not None else pa.array(host_rows))
            elif valid is not None:
                cols[path] = _leaf_to_arrow(leaf, host_rows[valid], None,
                                            valid)
            else:
                cols[path] = _leaf_to_arrow(leaf, host_rows, None, None)
        for path, (bshards, oshards) in self.ragged.items():
            leaf = self.leaves.get(path)
            chunks = []
            for d, rc in enumerate(self.row_counts):
                o = oshards[d].cpu().numpy()[:rc + 1]
                seg = bshards[d].cpu().numpy()[:int(o[-1]) if rc else 0]
                if path in self.validity:
                    v = self.validity[path][d].cpu().numpy()[:rc]
                    # null slots are empty: the dense offsets are the slot
                    # offsets without the null entries
                    chunks.append(_leaf_to_arrow(
                        leaf, seg, np.concatenate([o[:-1][v], o[-1:]]), v))
                else:
                    chunks.append(_leaf_to_arrow(leaf, seg, o, None))
            cols[path] = pa.chunked_array(chunks)
        order = [p for p in self.leaves if p in cols]
        order += [p for p in cols if p not in self.leaves]
        return pa.table({p: cols[p] for p in order})

    @property
    def shard_rows(self) -> int:
        return max(self.row_counts) if self.row_counts else 0

    @property
    def num_rows(self) -> int:
        return int(sum(self.row_counts))

    def row_mask(self) -> List[torch.Tensor]:
        """Per shard, on its device: True on the real rows, False on the
        padding."""
        return [torch.arange(self.shard_rows, device=d) < c
                for d, c in zip(self.mesh, self.row_counts)]


def _decode_prepped(reader, prepped, err, device: torch.device) -> tuple:
    """One prepared chunk decoded on ``device``, or a chunk the device
    route refused (``err``) on the host route: ``(Column, null count, host
    dictionary or None)``."""
    if err is None:
        plan, staged = prepped
        col = device_reader.decode_staged(plan, staged, device)
        counters.inc("chunks_device_decoded")
        return col, plan.total_slots - plan.total_values, \
            plan.dictionary_host
    _count("chunks_host_fallback")
    col = device_reader._host_route(reader, err, device)
    n_nulls = 0 if col.validity is None else int(
        (~col.validity).sum())
    dictionary = None
    if col.is_dictionary_encoded():
        dictionary = tuple(t.cpu().numpy() for t in col.dictionary)
    return col, n_nulls, dictionary


def _concat_byte_arrays(values: List[np.ndarray],
                        offsets: List[np.ndarray]) -> tuple:
    """Host ``(values, offsets)`` pairs as one, offsets rebased."""
    offs, base = [np.zeros(1, np.int64)], 0
    for v, o in zip(values, offsets):
        o = np.asarray(o, np.int64)
        offs.append(o[1:] - o[0] + base)
        base += int(o[-1] - o[0])
    cat = [host.as_u8(v)[o[0]:o[-1]] for v, o in zip(values, offsets)]
    return (np.concatenate(cat) if cat else np.zeros(0, np.uint8),
            np.concatenate(offs))


def _unify_dictionaries(dv_parts: List[np.ndarray],
                        do_parts: List[np.ndarray]) -> tuple:
    """The row groups' dictionaries deduplicated into one: ``(values,
    offsets, remap)``, ``remap[i]`` the unified id of entry ``i`` of the
    dictionaries concatenated in order; ids in order of first
    occurrence."""
    cat_vals, cat_offs = _concat_byte_arrays(dv_parts, do_parts)
    n = len(cat_offs) - 1
    remap, first = host.dictionary_of_byte_arrays(cat_vals, cat_offs, n + 1)
    uvals, uoffs = ref.gather_dictionary((cat_vals, cat_offs), first)
    return uvals, np.asarray(uoffs, np.int64), remap


def _slot_ragged(values: torch.Tensor, offsets: torch.Tensor,
                 validity: Optional[torch.Tensor]) -> tuple:
    """Dense ``(values, offsets)`` with slot-aligned offsets, a null slot
    an empty entry; values untouched."""
    if validity is None:
        return values, offsets
    lens = dev.scatter_valid(offsets[1:] - offsets[:-1], validity)
    return values, dev.cumsum_offsets(lens)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def read_table_sharded(source, mesh=None,
                       columns: Optional[Sequence[str]] = None
                       ) -> ShardedTable:
    """A file's flat columns (all by default) as a :class:`ShardedTable`
    over ``mesh`` (a list of devices; :func:`default_mesh` by default).

    Row group ``g`` goes to shard ``g % len(mesh)``.  Every chunk is
    prescanned, staged and copied to its shard's device on
    ``2 * len(mesh)`` workers (at most 16), then decoded there; a
    chunk the device route refuses decodes on the host route
    (``HOST_ROUTE``, ``MESH["chunks_host_fallback"]``).  A nested column
    raises ``ValueError``."""
    devs = resolve_mesh(mesh)
    pf = source if isinstance(source, ParquetFile) else ParquetFile(source)
    leaves = (pf.schema.leaves if columns is None
              else [pf.schema.leaf(c) for c in columns])
    for leaf in leaves:
        if leaf.max_repetition_level > 0:
            raise ValueError(
                f"read_table_sharded: column {leaf.name!r} is nested; use "
                "ParquetFile.read")
    n_rg = len(pf.row_groups)
    nd = len(devs)
    if n_rg == 0:
        return ShardedTable(arrays={}, validity={}, row_counts=(0,) * nd,
                            mesh=tuple(devs))
    tasks = [(leaf, g) for leaf in leaves for g in range(n_rg)]
    workers = min(nd * 2, 16)
    threads = max(1, host.available_cpus() // workers)

    def prep(task):
        leaf, g = task
        reader = pf.row_group(g).column(leaf.column_index)
        device = devs[g % nd]
        with _on(device), host.native_thread_cap(threads):
            try:
                return reader, device_reader.prepare_chunk(reader, device), \
                    None
            except _Unsupported as e:
                return reader, None, e

    # each task in a copy of this context: the op scope follows it
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="pqt-shard") as pool:
        prepped = list(pool.map(
            _pool.instrument_task(prep, name="prepare_shard"), tasks))

    rg_rows = [rg.num_rows for rg in pf.row_groups]
    counts = [sum(rg_rows[d::nd]) for d in range(nd)]
    maxlen = max(counts)
    arrays, validities, dictionaries, ragged = {}, {}, {}, {}
    for leaf in leaves:
        got = [(g, p) for (lf, g), p in zip(tasks, prepped) if lf is leaf]
        path = leaf.name
        if leaf.physical_type == Type.BYTE_ARRAY:
            _shard_strings(leaf, got, devs, maxlen, arrays, validities,
                           dictionaries, ragged)
            continue
        per_dev, has_nulls = {}, False
        for g, (reader, prepped_chunk, err) in got:
            device = devs[g % nd]
            with _on(device):
                col, n_nulls, _ = _decode_prepped(reader, prepped_chunk,
                                                  err, device)
                vals, valid = col.values, None
                if n_nulls:
                    valid = col.validity
                    vals = dev.scatter_valid(vals, valid)
                    has_nulls = True
            per_dev.setdefault(g % nd, []).append((vals, valid))
        arrays[path], v = _shards(per_dev, devs, maxlen, has_nulls)
        if has_nulls:
            validities[path] = v
    return ShardedTable(arrays=arrays, validity=validities,
                        row_counts=tuple(counts), mesh=tuple(devs),
                        dictionaries=dictionaries, ragged=ragged,
                        leaves={leaf.name: leaf for leaf in leaves})


def _shards(per_dev: dict, devs, maxlen: int, has_nulls: bool) -> tuple:
    """Each device's parts ``(values, validity or None)`` concatenated and
    padded to ``maxlen`` rows: ``(values shards, validity shards or
    None)``."""
    template = next(p[0][0] for p in per_dev.values() if p)
    values, validity = [], []
    for d, device in enumerate(devs):
        parts = per_dev.get(d, [])
        if parts:
            arr = torch.cat([v for v, _ in parts]) if len(parts) > 1 \
                else parts[0][0]
        else:  # more shards than row groups: an empty shard
            arr = torch.zeros((0,) + tuple(template.shape[1:]),
                              dtype=template.dtype, device=device)
        values.append(_pad_rows(arr, maxlen))
        if has_nulls:
            va = [m if m is not None else
                  torch.ones(v.shape[0], dtype=torch.bool, device=device)
                  for v, m in parts]
            va = torch.cat(va) if va else torch.zeros(0, dtype=torch.bool,
                                                      device=device)
            validity.append(_pad_rows(va, maxlen))
    return values, (validity if has_nulls else None)


def _shard_strings(leaf, got, devs, maxlen, arrays, validities,
                   dictionaries, ragged) -> None:
    """A BYTE_ARRAY column's shards: its indexes over one unified
    dictionary where every chunk is dictionary-encoded, else the ragged
    pairs (dictionary chunks gathered first)."""
    nd = len(devs)
    path = leaf.name
    dict_parts, ragged_parts = [], []
    for g, (reader, prepped, err) in got:
        device = devs[g % nd]
        with _on(device):
            col, n_nulls, dictionary = _decode_prepped(reader, prepped, err,
                                                       device)
        valid = col.validity if n_nulls else None
        if col.is_dictionary_encoded():
            dict_parts.append((g, col, valid, dictionary))
        else:
            ragged_parts.append((g, col, valid))
    if ragged_parts:
        for g, col, valid, _ in dict_parts:
            with _on(devs[g % nd]):
                ragged_parts.append((g, col.materialize(), valid))
        _shard_ragged(path, sorted(ragged_parts, key=lambda p: p[0]), devs,
                      maxlen, ragged, validities)
        return
    uvals, uoffs, remap = _unify_dictionaries(
        [dv for *_, (dv, _) in dict_parts], [do for *_, (_, do) in dict_parts])
    dictionaries[path] = (uvals, uoffs)
    per_dev, has_nulls, base = {}, False, 0
    for g, col, valid, (_, do) in dict_parts:
        device = devs[g % nd]
        n_i = len(do) - 1
        sub = torch.from_numpy(remap[base:base + n_i].astype(np.int32))
        base += n_i
        with _on(device):
            vals = dev.dict_gather(sub.to(device), col.dict_indices)
            if valid is not None:
                vals = dev.scatter_valid(vals, valid)
                has_nulls = True
        per_dev.setdefault(g % nd, []).append((vals, valid))
    arrays[path], v = _shards(per_dev, devs, maxlen, has_nulls)
    if has_nulls:
        validities[path] = v


def _shard_ragged(path, parts, devs, maxlen, ragged, validities) -> None:
    """Ragged shards of ``parts`` (``(row group, Column, validity or
    None)`` in row-group order)."""
    nd = len(devs)
    has_nulls = any(v is not None for *_, v in parts)
    shard_bytes, shard_offs, shard_valid = [], [], []
    for d, device in enumerate(devs):
        mine = [_slot_ragged(col.values, col.offsets, v) + (v,)
                for g, col, v in parts if g % nd == d]
        ends = [int(o[-1]) for _, o, _ in mine]
        b = [vb[:e] for (vb, _, _), e in zip(mine, ends)]
        offs, base = [torch.zeros(1, dtype=torch.int64, device=device)], 0
        for (_, o, _), e in zip(mine, ends):
            offs.append(o[1:] + base)
            base += e
        o = torch.cat(offs)
        if o.shape[0] < maxlen + 1:  # padding rows are empty entries
            o = torch.cat([o, o.new_full((maxlen + 1 - o.shape[0],), base)])
        shard_bytes.append(torch.cat(b) if b else torch.zeros(
            0, dtype=torch.uint8, device=device))
        shard_offs.append(o)
        if has_nulls:
            va = [v if v is not None else
                  torch.ones(o2.shape[0] - 1, dtype=torch.bool,
                             device=device) for _, o2, v in mine]
            va = torch.cat(va) if va else torch.zeros(0, dtype=torch.bool,
                                                      device=device)
            shard_valid.append(_pad_rows(va, maxlen))
    widest = max(b.shape[0] for b in shard_bytes) or 1
    ragged[path] = ([_pad_rows(b, widest) for b in shard_bytes], shard_offs)
    if has_nulls:
        validities[path] = shard_valid


# ---------------------------------------------------------------------------
# The sharded decode step
# ---------------------------------------------------------------------------


def decode_step_sharded(mesh, n_per_shard: int):
    """The batched decode step over ``mesh``, one shard a device: a
    function of ``(vbuf, lbuf, run_ends, run_kinds, run_payloads,
    run_offs, run_widths)``, each one tensor a shard (a list, or a tensor
    whose first axis is the shard): a shard's PLAIN INT64 page bytes, its
    def-level stream and that stream's run table.  Each shard reinterprets
    ``n_per_shard`` values (``bitcast_fixed64``), expands its def levels
    (``rle_expand``), and zeroes its null slots; it returns ``(values,
    validity, rows)``: per-shard int64 values and bool validity on each
    shard's device, and the present values of every shard as an int64
    scalar on ``mesh[0]``, summed over the processes of the
    ``torch.distributed`` group too where one is initialized."""
    import torch.distributed as dist

    devs = resolve_mesh(mesh)

    def step(*inputs):
        if len(inputs) != 7:
            raise TypeError(f"decode step takes 7 inputs, got {len(inputs)}")
        values, validity, counts = [], [], []
        for d, device in enumerate(devs):
            vb, lb, ends, kinds, payloads, offs, widths = (
                x[d].to(device) for x in inputs)
            vals = dev.bitcast_fixed64(vb, n_per_shard, torch.int64)
            defs = dev.rle_expand(lb, n_per_shard, ends, kinds, payloads,
                                  offs, widths)
            valid = defs == 1
            values.append(torch.where(valid, vals, 0))
            validity.append(valid)
            counts.append(valid.sum().to(devs[0]))
        rows = torch.stack(counts).sum()
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(rows)
        return values, validity, rows

    return step


# ---------------------------------------------------------------------------
# Multi-file reads: files round-robin over the mesh
# ---------------------------------------------------------------------------


class _HostRoute(Exception):
    """The stage's verdict: this file takes the host read, for ``reason``
    (``"unsupported"``: the footer refuses it; ``"error"``: its footer or
    staging raised ``CorruptedError`` or ``OSError``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class _FileStage:
    """One file's staged state: every (leaf, row group) chunk prepared on
    ``device``, its bytes counted in ``MESH["staging_bytes"]`` until
    :meth:`release`; ``done`` marks the end of its decode on a card."""

    pf: ParquetFile
    leaves: list
    device: torch.device
    est_bytes: int
    grant: int = 0  # the file's read admission, held until its decode ends
    tenant: Optional[str] = None  # the tenant the grant is charged to
    preps: list = field(default_factory=list)
    done: Optional[torch.cuda.Event] = None
    _released: bool = False

    def release_grant(self) -> None:
        """Hand the file's scan-tier grant back: its staged bytes are
        consumed once its decode ends.  A grant held until the consumer
        takes the file would deadlock a window whose later file took the
        budget first."""
        grant, self.grant = self.grant, 0
        _pool.read_admission().release(grant, tier="scan",
                                       tenant=self.tenant)

    def release(self) -> None:
        self.release_grant()
        if not self._released:
            self._released = True
            _count("staging_bytes", -self.est_bytes)


def _stage_dataset_file(dataset, i: int, columns, device: torch.device,
                        threads: int, policy=None, report=None
                        ) -> _FileStage:
    """The host phase of file ``i``: the schema check, the footer's
    verdict, the chunks' byte ranges planned on the readahead prefetcher,
    and every chunk prescanned and staged in one batch with one copy to
    ``device`` (``prepare_chunks_batched``, at most ``threads`` native
    threads a call).  Raises ``_HostRoute`` where the footer refuses the
    file or where reading the footer or staging the chunks raises
    ``CorruptedError`` or ``OSError`` (a library of the port that fails to
    build or load raises ``RuntimeError``, not caught).  A chunk the plan
    refuses carries its error and decodes on the host route.  The
    staging's preads run under ``policy`` (retries and its deadline), its
    retries counted into ``report``."""
    from ..io.planner import device_encoding_supported
    from ..io.prefetch import make_chunk_prefetcher

    from ..errors import DeadlineError

    try:
        pf = dataset.file(i)
    except DeadlineError:
        raise
    except (CorruptedError, OSError) as e:
        raise _HostRoute("error") from e
    dataset._check_schema(pf, dataset.paths[i])
    ok, _ = device_encoding_supported(pf, columns)
    if not ok:
        raise _HostRoute("unsupported")
    leaves = _select_leaves(pf.schema, columns)
    chunks = [rg.column(leaf.column_index)
              for leaf in leaves for rg in pf.row_groups]
    est = sum(r.byte_range[1] for r in chunks)
    # the file's chunk bytes queue under the read budget's scan tier until
    # its decode has consumed them (:meth:`_FileStage.release_grant`)
    grant = _pool.read_admission().acquire(est, tier="scan")
    tenant = _pool.current_tenant()
    st = _FileStage(pf=pf, leaves=leaves, device=device, est_bytes=est,
                    grant=grant, tenant=tenant[0] if tenant else None)
    _count("staging_bytes", st.est_bytes)
    try:
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            pre = make_chunk_prefetcher(pf.source)
            if pre is not None:
                stack.callback(pre.close)
                stack.enter_context(pf._source_override(pre))
                pre.plan_many(r.byte_range for r in chunks)
            stack.enter_context(pf._resilient_op(policy, report))
            with host.native_thread_cap(threads):
                st.preps = device_reader.prepare_chunks_batched(chunks,
                                                                device)
        _M_H2D_S.observe(time.perf_counter() - t0)
    except DeadlineError:
        st.release()
        raise
    except (CorruptedError, OSError) as e:
        st.release()
        raise _HostRoute("error") from e
    except BaseException:
        st.release()
        raise
    return st


def _decode_dataset_file(st: _FileStage) -> Dict[str, list]:
    """The device phase of one file: each staged chunk decoded (a refused
    one on the host route, counted), ``{path: [Column a row group]}``."""
    from ..io.planner import count_device_refusal

    t0 = time.perf_counter()
    it = iter(st.preps)
    n_rg = len(st.pf.row_groups)
    parts = {}
    for leaf in st.leaves:
        cols = []
        for _ in range(n_rg):
            reader, prepped, err = next(it)
            if err is not None:
                count_device_refusal("unsupported")
            cols.append(_decode_prepped(reader, prepped, err,
                                        st.device)[0])
        parts[leaf.name] = cols
    if st.device.type == "cuda":
        st.done = torch.cuda.Event()
        st.done.record()
    _M_DECODE_S.observe(time.perf_counter() - t0)  # the host's enqueue
    return parts


def read_dataset_device(dataset, columns, host_read, mesh=None,
                        with_reports: bool = False, policy=None):
    """Each file of ``dataset`` as ``{path: [Column a row group]}``,
    yielded in file order; file ``i`` decodes on ``mesh[i % len(mesh)]``.
    With ``with_reports`` each is the tuple ``(parts, report, rows,
    error)`` of ``Dataset.read``'s per-file read instead: a file read here
    yields a fresh :class:`~parquet_tpu_torch.io.faults.ReadReport` of its
    retries and rows, and ``host_read`` returns the tuple itself.

    A file's stage and decode run as one shared-pool task on its device,
    with up to ``min(len(mesh), 4)`` files in flight, later ones running
    ahead of the one being consumed (a mesh of one entry reads one file
    at a time; a caller who wants no overlap passes one device).  Inside a
    shared-pool worker the files stage and decode inline.  A file the
    footer refuses, or whose footer or staging raises ``CorruptedError``
    or ``OSError`` (:func:`_stage_dataset_file`), is read by
    ``host_read(i, device)`` and counted in ``ROUTE_REFUSALS``; any other
    error, and every error of a decode, raises at its file's turn.
    Closing the generator early waits out the files in flight and
    releases their staged bytes.

    Under a ``policy`` the staging's preads retry under it, and a data
    error of a file's decode also sends the file to ``host_read`` (the
    caller's read under the policy, which skips a corrupt row group or
    file as the policy says); deadlines and the environment's errors
    always raise."""
    from ..errors import DeadlineError
    from ..io.faults import NON_DATA_ERRORS, ReadReport
    from ..io.planner import count_device_refusal

    devs = resolve_mesh(mesh)
    n = len(dataset.paths)
    window = max(1, min(len(devs), 4, n))
    threads = max(1, host.available_cpus() // window)
    inline = _pool.in_shared_pool()

    def stage_decode(i, device):
        sub = ReadReport() if with_reports else None
        with _on(device):
            st = _stage_dataset_file(dataset, i, columns, device, threads,
                                     policy, sub)
            try:
                with st.pf._resilient_op(policy, sub):
                    return st, _decode_dataset_file(st), sub
            except BaseException:
                st.release()
                raise
            finally:
                st.release_grant()

    def submit(i):
        device = devs[i % len(devs)]
        if not inline:
            return _pool.submit(stage_decode, i, device)
        f = Future()
        try:  # the error raises at the file's turn, as from the pool
            f.set_result(stage_decode(i, device))
        except Exception as e:
            f.set_exception(e)
        return f

    futs: Dict[int, Future] = {}
    try:
        for i in range(n):
            for j in range(i, min(i + window, n)):
                if j not in futs:
                    futs[j] = submit(j)
                    if j > i:
                        _count("stage_overlapped")
            reason = None
            try:
                st, parts, sub = futs.pop(i).result()
            except _HostRoute as e:
                reason = e.reason
            except (DeadlineError, *NON_DATA_ERRORS):
                raise
            except (CorruptedError, OSError):
                if policy is None:
                    raise
                reason = "error"
            if reason is not None:
                count_device_refusal(reason)
                yield host_read(i, devs[i % len(devs)])
                continue
            st.release()
            _count("files_sharded")
            if st.done is not None:  # the caller's stream after the decode
                torch.cuda.current_stream(st.device).wait_event(st.done)
            if with_reports:
                sub.rows_read += st.pf.num_rows
                yield parts, sub, st.pf.num_rows, None
            else:
                yield parts
    finally:
        for f in futs.values():  # files abandoned in flight
            try:
                f.result()[0].release()
            except Exception:  # its error was never going to be read
                pass
