"""parquet_tpu_torch's pipelined writer against the JAX package's
``tests/test_writer_pipeline.py`` matrix: every pipeline setting (overlap
off, auto or forced, writeback buffers, pool widths, the ``write`` and
``write_row_group`` front ends, writers on many threads) gives the same
bytes; the JAX package's host read of each file equals the port's CPU
read; the overlap is shown by the order of encodes and emits, never by a
wall-clock ratio; ``write_stats`` meters the pipeline on all three
writers; and every write fault under the overlap leaves the destination
absent or clean.  No test leaves a thread behind."""

import dataclasses
import errno
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import parquet_tpu

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
from parquet_tpu_torch.format.enums import Type
from parquet_tpu_torch.io import writer as twriter
from parquet_tpu_torch.schema import schema as S
from parquet_tpu_torch.schema.types import LogicalKind as K
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

N_ROWS = 6000
RG = 1000  # 6 row groups
KNOBS = ("PARQUET_TPU_TORCH_WRITE_OVERLAP", "PARQUET_TPU_TORCH_WRITE_BUFFER",
         "PARQUET_TPU_TORCH_WRITE_AUTOTUNE")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    from parquet_tpu_torch.io.sink import write_autotune

    write_autotune().reset()
    before = threads_now()
    yield
    write_autotune().reset()
    assert_no_thread_started(before)


def _mixed(n=N_ROWS, seed=5):
    """A schema and its columns: a required int64, a double, a
    dictionary string, an optional int64, an optional string and a list
    of optional int32."""
    rng = np.random.default_rng(seed)
    schema = S.message("m", [
        S.leaf("x", Type.INT64),
        S.leaf("f", Type.DOUBLE),
        S.leaf("s", Type.BYTE_ARRAY, Rep.REQUIRED, K.STRING),
        S.leaf("ox", Type.INT64, Rep.OPTIONAL),
        S.leaf("os", Type.BYTE_ARRAY, Rep.OPTIONAL, K.STRING),
        S.list_of("l", S.leaf("element", Type.INT32, Rep.OPTIONAL))])

    def strings(words):
        offs = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=offs[1:])
        return np.frombuffer(b"".join(words), np.uint8), offs

    x = np.arange(n, dtype=np.int64)
    sv, so = strings([f"v{i % 37}".encode() for i in range(n)])
    ovalid = x % 5 != 0
    osv, oso = strings([f"u{i % 1013}".encode() for i in range(n)
                        if ovalid[i]])
    lens = rng.integers(0, 4, n)
    lvalid = rng.random(n) > 0.1
    lens[~lvalid] = 0
    lo = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=lo[1:])
    ev = rng.random(int(lo[-1])) > 0.2
    cols = {
        "x": pqt.ColumnData(values=x),
        "f": pqt.ColumnData(values=rng.random(n)),
        "s": pqt.ColumnData(values=sv, offsets=so),
        "ox": pqt.ColumnData(values=x[ovalid], validity=ovalid),
        "os": pqt.ColumnData(values=osv, offsets=oso, validity=ovalid),
        "l.list.element": pqt.ColumnData(
            values=rng.integers(-9, 9, int(ev.sum())).astype(np.int32),
            validity=ev, list_offsets=[lo], list_validity=[lvalid])}
    return schema, cols


@pytest.fixture(scope="module")
def mixed():
    return _mixed()


def _slice(schema, cols, r0, r1, ctxs):
    return {k: twriter._slice_cd(schema.leaf(k), cd, r0, r1, ctxs[k])
            for k, cd in cols.items()}


def _write(mixed, sink, opts=None, via_write=False, n=N_ROWS):
    """Write the mixed columns to ``sink``: a row group at a time, or by
    ``write`` in slabs that straddle the row groups' bounds."""
    schema, cols = mixed
    opts = opts or pqt.WriterOptions(row_group_size=RG)
    ctxs = {k: {} for k in cols}
    w = pqt.ParquetWriter(sink, schema, opts)
    step = RG // 3 + 17 if via_write else RG
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        part = _slice(schema, cols, r0, r1, ctxs)
        if via_write:
            w.write(part, r1 - r0)
        else:
            w.write_row_group(part, r1 - r0)
    w.close()
    return w


def _bytes(mixed, monkeypatch, overlap="0", via_write=False, opts=None):
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", overlap)
    buf = io.BytesIO()
    w = _write(mixed, buf, opts, via_write)
    return buf.getvalue(), w.write_stats


def _same_reads(raw: bytes) -> None:
    """The JAX package's host read of a port file equals the port's CPU
    read, row by row, leaf by leaf."""
    want = parquet_tpu.ParquetFile(raw).read(device=False).to_arrow()
    got = pqt.ParquetFile(raw).read(device="cpu")
    assert len(got) == want.num_columns
    for (name, col), top in zip(got.items(), want.column_names):
        assert name.split(".")[0] == top
        assert repr(col.to_pylist()) == repr(want.column(top).to_pylist()), \
            name


def _no_temps(d) -> bool:
    return not [f for f in os.listdir(d) if f.endswith(".tmp")]


# ---------------------------------------------------------------------------
# the same bytes under every pipeline setting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("via_write", [False, True],
                         ids=["write_row_group", "write"])
@pytest.mark.parametrize("overlap", ["force", "auto"])
def test_bytes_identical_across_overlap(mixed, monkeypatch, overlap,
                                        via_write):
    base, st0 = _bytes(mixed, monkeypatch, "0", via_write)
    got, st = _bytes(mixed, monkeypatch, overlap, via_write)
    assert got == base
    assert st0.overlapped_groups == 0 and st0.row_groups == 6
    assert st.row_groups == 6
    if overlap == "force":
        assert st.overlapped_groups == 6


@pytest.mark.parametrize("version,codec", [(1, "snappy"), (2, "zstd"),
                                           (1, "uncompressed")])
def test_the_jax_read_of_each_file_equals_the_port_read(mixed, monkeypatch,
                                                        version, codec):
    opts = pqt.WriterOptions(row_group_size=RG, data_page_version=version,
                             compression=codec, data_page_size=4096,
                             bloom_filters={"x": 10})
    base, _ = _bytes(mixed, monkeypatch, "0", opts=opts)
    forced, _ = _bytes(mixed, monkeypatch, "force", opts=opts)
    assert forced == base
    _same_reads(forced)
    assert parquet_tpu.verify_file(forced, decode=True).ok
    assert pqt.verify_file(forced, decode=True, device="cpu").ok


@pytest.mark.parametrize("width", [1, 2, 8])
def test_pool_width_does_not_change_the_bytes(mixed, monkeypatch, width):
    base, _ = _bytes(mixed, monkeypatch, "0")
    pool = ThreadPoolExecutor(max_workers=width,
                              thread_name_prefix="pqt-width")
    monkeypatch.setattr(tpool, "_POOL", pool)
    try:
        got, st = _bytes(mixed, monkeypatch, "force")
    finally:
        monkeypatch.undo()
        pool.shutdown(wait=True)
    assert got == base and st.overlapped_groups == 6


@pytest.mark.parametrize("buffer", ["0", "1", "4096", "65536", None])
def test_path_writes_identical_at_every_buffer(mixed, monkeypatch, tmp_path,
                                               buffer):
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_BUFFER", "0")
    p0 = tmp_path / "plain.parquet"
    _write(mixed, str(p0))
    if buffer is None:
        monkeypatch.delenv("PARQUET_TPU_TORCH_WRITE_BUFFER")
    else:
        monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_BUFFER", buffer)
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")
    p1 = tmp_path / "buffered.parquet"
    st = _write(mixed, str(p1)).write_stats
    assert p0.read_bytes() == p1.read_bytes()
    assert st.bytes_flushed == os.path.getsize(p1)
    if buffer == "0":
        assert st.sink_flushes == 0 and st.bytes_buffered == 0
    else:
        assert st.sink_flushes > 0
        assert st.bytes_buffered == st.bytes_flushed - 4  # the magic
        if hasattr(os, "writev"):
            assert st.writev_flushes == st.sink_flushes
    assert _no_temps(tmp_path)


def test_torch_tensors_write_as_their_arrays(mixed, monkeypatch):
    """Columns of torch tensors (here on the CPU) give the bytes of their
    numpy arrays, through ``write_row_group``, ``write`` and
    ``write_table``."""
    schema, cols = mixed

    def tensors(cd):
        t = lambda a: None if a is None else torch.from_numpy(np.array(a))
        return pqt.ColumnData(
            values=t(cd.values), validity=t(cd.validity),
            offsets=t(cd.offsets),
            list_offsets=None if cd.list_offsets is None
            else [t(a) for a in cd.list_offsets],
            list_validity=None if cd.list_validity is None
            else [t(a) for a in cd.list_validity])

    as_tensors = (schema, {k: tensors(cd) for k, cd in cols.items()})
    for via_write in (False, True):
        base, _ = _bytes(mixed, monkeypatch, "force", via_write)
        got, _ = _bytes(as_tensors, monkeypatch, "force", via_write)
        assert got == base
    table = {"a": np.arange(3000, dtype=np.int64),
             "b": np.arange(3000, dtype=np.float32) / 7}
    want, got = io.BytesIO(), io.BytesIO()
    pqt.write_table(table, want)
    pqt.write_table({k: torch.from_numpy(v) for k, v in table.items()}, got)
    assert got.getvalue() == want.getvalue()


# ---------------------------------------------------------------------------
# the overlap, by order
# ---------------------------------------------------------------------------
class _GateSink(io.BytesIO):
    """A sink whose first write after the magic (row group 0's pages)
    waits until ``gate`` is set: it can only go on if row group 1's
    encode runs while row group 0 emits."""

    def __init__(self, gate: threading.Event):
        super().__init__()
        self.gate = gate
        self.opened = False
        self.waited = None

    def writelines(self, parts):
        if not self.opened:
            self.opened = True
            self.waited = self.gate.wait(timeout=30)
        super().writelines(parts)


def _encode_log(monkeypatch):
    """Record each encode's start and end with its row group, from the
    order of the calls: a row group's encodes all start after the
    previous group's ended, so call k belongs to group k // leaves."""
    log, lock, calls = [], threading.Lock(), [0]
    real = pqt.ParquetWriter._encode_chunk
    started = {}

    def spy(self, leaf, data, num_rows):
        with lock:
            group = calls[0] // len(self.schema.leaves)
            calls[0] += 1
            log.append(("start", group))
            started.setdefault(group, threading.Event()).set()
        out = real(self, leaf, data, num_rows)
        with lock:
            log.append(("end", group))
        return out

    monkeypatch.setattr(pqt.ParquetWriter, "_encode_chunk", spy)
    return log, started


@pytest.mark.parametrize("via_write", [False, True],
                         ids=["write_row_group", "write"])
def test_the_next_group_encodes_while_a_group_emits(mixed, monkeypatch,
                                                    via_write):
    """Forced overlap: row group 1 encodes while row group 0's pages are
    held in the sink (the sink lets them through only once that encode
    has started), and no group's encode starts before its predecessor's
    all ended."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")
    log, started = _encode_log(monkeypatch)
    started[1] = threading.Event()
    sink = _GateSink(started[1])
    _write(mixed, sink, via_write=via_write)
    assert sink.waited is True
    leaves = len(mixed[0].leaves)
    for g in range(1, 6):
        first_start = log.index(("start", g))
        ends = [i for i, e in enumerate(log) if e == ("end", g - 1)]
        assert len(ends) == leaves and max(ends) < first_start
    base, _ = _bytes(mixed, monkeypatch, "0")
    assert sink.getvalue() == base


def test_serial_mode_holds_nothing_back(mixed, monkeypatch):
    """Overlap off: ``write_row_group`` returns with its row group
    emitted, nothing in flight."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "0")
    w = pqt.ParquetWriter(io.BytesIO(), mixed[0],
                          pqt.WriterOptions(row_group_size=RG))
    _rows(w, mixed, range(1))
    assert len(w._row_groups) == 1 and w._inflight is None
    w.close()
    assert w.write_stats.overlapped_groups == 0


# ---------------------------------------------------------------------------
# write_stats
# ---------------------------------------------------------------------------
def test_write_stats_meter_the_pipeline(mixed, monkeypatch, tmp_path):
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")
    dest = tmp_path / "stats.parquet"
    st = _write(mixed, str(dest)).write_stats
    assert st.row_groups == 6 and st.overlapped_groups == 6
    assert st.encode_s > 0 and st.emit_s > 0 and st.pool_wait_s >= 0
    assert st.bytes_flushed == os.path.getsize(dest)
    assert 0.0 <= st.overlap_ratio() <= 1.0
    assert set(st.as_dict()) == set(parquet_tpu.WriteStats().as_dict())


def test_write_stats_of_a_serial_write(mixed, monkeypatch):
    _, st = _bytes(mixed, monkeypatch, "0")
    assert st.overlapped_groups == 0 and st.pool_wait_s == 0.0
    assert st.overlap_ratio() == 0.0 and st.encode_s > 0
    assert st.bytes_flushed == 0  # a caller's file object is not metered


def test_typed_and_row_writers_surface_write_stats(tmp_path):
    @dataclasses.dataclass
    class Rec:
        x: int

    with pqt.TypedWriter(str(tmp_path / "t.parquet"), Rec) as tw:
        tw.write([Rec(x=i) for i in range(100)])
    assert isinstance(tw.write_stats, pqt.WriteStats)
    assert tw.write_stats.row_groups == 1
    assert tw.write_stats.bytes_flushed == os.path.getsize(
        tmp_path / "t.parquet")
    schema = S.message("rec", [S.leaf("a", Type.INT64)])
    w = pqt.write_rows(str(tmp_path / "r.parquet"), schema,
                       [{"a": i} for i in range(500)],
                       pqt.WriterOptions(row_group_size=100))
    assert w.write_stats.row_groups == 5


@pytest.mark.parametrize("buffer_rows", [10_000, 1_500],
                         ids=["in_memory", "spilled"])
def test_sorting_writer_surfaces_write_stats(tmp_path, buffer_rows):
    n = 6000
    rng = np.random.default_rng(3)
    x = rng.permutation(n).astype(np.int64)
    schema = S.message("m", [S.leaf("x", Type.INT64)])
    dest = tmp_path / "sorted.parquet"
    sw = pqt.SortingWriter(str(dest), schema,
                           [pqt.SortingColumn("x", descending=True)],
                           buffer_rows=buffer_rows, device="cpu")
    assert sw.write_stats is None
    sw.write({"x": pqt.ColumnData(values=x)}, n)
    sw.close()
    assert sw.write_stats is not None and sw.write_stats.row_groups > 0
    assert sw.write_stats.bytes_flushed == os.path.getsize(dest)
    assert pqt.verify_file(str(dest)).ok
    got = pqt.ParquetFile(str(dest)).read(device="cpu")["x"].values.numpy()
    assert (got == np.arange(n)[::-1]).all()
    assert _no_temps(tmp_path)


# ---------------------------------------------------------------------------
# faults under the overlap: no torn destination
# ---------------------------------------------------------------------------
@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")


def _rows(w, mixed, groups=range(6)):
    schema, cols = mixed
    ctxs = {k: {} for k in cols}
    for g in groups:
        w.write_row_group(_slice(schema, cols, g * RG, (g + 1) * RG, ctxs),
                          RG)


def test_enospc_under_overlap_aborts_clean(tmp_path, mixed, forced):
    dest = tmp_path / "enospc.parquet"
    sink = pqt.FaultInjectingSink(pqt.AtomicFileSink(str(dest)),
                                  enospc_at_byte=8192)
    with pytest.raises(OSError) as ei:
        with pqt.ParquetWriter(sink, mixed[0],
                               pqt.WriterOptions(row_group_size=RG)) as w:
            _rows(w, mixed)
    assert ei.value.errno == errno.ENOSPC
    assert w._inflight is None
    sink.abort()
    assert not dest.exists() and _no_temps(tmp_path)


def test_crash_under_overlap_leaves_dest_absent(tmp_path, mixed, forced):
    dest = tmp_path / "crash.parquet"
    sink = pqt.FaultInjectingSink(pqt.AtomicFileSink(str(dest)),
                                  crash_at_byte=3000)
    with pytest.raises(pqt.InjectedWriterCrash):
        with pqt.ParquetWriter(sink, mixed[0],
                               pqt.WriterOptions(row_group_size=RG)) as w:
            _rows(w, mixed)
    assert w._inflight is None
    assert not dest.exists()
    sink.abort()
    assert _no_temps(tmp_path)


def test_short_write_under_overlap_and_buffer_surfaces(mixed, forced):
    inj = pqt.FaultInjectingSink(io.BytesIO(), seed=3, short_write_rate=0.3)
    sink = pqt.BufferedSink(inj, buffer_bytes=1 << 12)
    with pytest.raises(OSError, match="short write"):
        with pqt.ParquetWriter(sink, mixed[0],
                               pqt.WriterOptions(row_group_size=RG)) as w:
            _rows(w, mixed)
    assert inj.stats.injected_short_writes >= 1


def test_a_sink_failure_cancels_the_encode_in_flight(mixed, forced):
    """A failed emit raises on the call that emits, and that call's own
    row group, whose encode it had just submitted, is cancelled: nothing
    is left in flight, and abort ends the writer."""
    inj = pqt.FaultInjectingSink(io.BytesIO(), enospc_at_byte=100)
    w = pqt.ParquetWriter(inj, mixed[0], pqt.WriterOptions(row_group_size=RG))
    with pytest.raises(OSError) as ei:
        _rows(w, mixed)
    assert ei.value.errno == errno.ENOSPC
    assert w._inflight is None and len(w._row_groups) == 0
    w.abort()
    with pytest.raises(ValueError, match="aborted"):
        w.flush()


def test_crash_matrix_under_overlap_and_buffered_sink(tmp_path, mixed,
                                                      forced):
    dest = str(tmp_path / "matrix.parquet")
    schema, cols = mixed

    def build(sink):
        pqt.write_table(cols, sink, pqt.WriterOptions(row_group_size=RG),
                        schema=schema)

    results = pqt.crash_consistency_check(build, dest, samples=8, seed=7,
                                          buffered=True)
    assert [r["outcome"] for r in results[:-1]] == ["absent"] * (
        len(results) - 1)
    assert results[-1] == {"offset": None, "outcome": "clean"}
    assert _no_temps(tmp_path)
    assert parquet_tpu.verify_file(dest).ok
    _same_reads(open(dest, "rb").read())


def test_abort_mid_stream_cancels_the_encode_in_flight(tmp_path, mixed,
                                                       forced):
    dest = tmp_path / "aborted.parquet"
    w = pqt.ParquetWriter(str(dest), mixed[0],
                          pqt.WriterOptions(row_group_size=RG))
    _rows(w, mixed, range(3))
    assert w._inflight is not None  # the last group is held back
    w.abort()
    assert w._inflight is None
    assert not dest.exists() and _no_temps(tmp_path)
    with pytest.raises(ValueError, match="aborted"):
        _rows(w, mixed, range(1))


def test_flush_emits_the_held_group(mixed, forced):
    buf = io.BytesIO()
    w = pqt.ParquetWriter(buf, mixed[0], pqt.WriterOptions(row_group_size=RG))
    _rows(w, mixed, range(1))
    assert len(w._row_groups) == 0  # still in flight
    w.flush()
    assert len(w._row_groups) == 1 and w._inflight is None
    w.close()
    got = pqt.ParquetFile(buf.getvalue()).read(device="cpu")
    assert (got["x"].values.numpy() == np.arange(RG)).all()


def test_a_failed_encode_raises_where_it_is_collected(mixed, monkeypatch):
    """Forced overlap: a row group whose encode fails raises on the call
    that collects it, with the groups before it written; the writer goes
    on for the groups after it."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")
    schema, cols = mixed
    buf = io.BytesIO()
    w = pqt.ParquetWriter(buf, schema, pqt.WriterOptions(row_group_size=RG))
    _rows(w, mixed, range(2))
    bad = dict(_slice(schema, cols, 2 * RG, 3 * RG, {k: {} for k in cols}))
    bad["x"] = pqt.ColumnData(values=cols["x"].values[:RG - 1])
    w.write_row_group(bad, RG)  # its encode fails on a pool worker
    with pytest.raises(ValueError, match="values"):
        w.flush()
    assert len(w._row_groups) == 2 and w._inflight is None
    _rows(w, mixed, range(2, 6))
    w.close()
    base, _ = _bytes(mixed, monkeypatch, "0")
    assert buf.getvalue() == base


def test_writers_on_many_threads_share_the_pool(mixed, monkeypatch):
    """Twelve writers under forced overlap on as many threads, with a
    short switch interval, encode on the one shared pool: every file is
    the serial write's."""
    import sys

    base, _ = _bytes(mixed, monkeypatch, "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", "force")
    out, errors = [None] * 12, []

    def one(i):
        try:
            buf = io.BytesIO()
            _write(mixed, buf)
            out[i] = buf.getvalue()
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(o == base for o in out)
