"""The readahead layer of parquet_tpu_torch (``io/prefetch.py``: the ring
and advise backends of ``PrefetchSource``, ``ReadStats``, the auto-tuner,
``make_prefetcher``/``make_chunk_prefetcher`` and the prefetch knobs) and
the sources beside it (``MmapSource``, ``FileLikeSource``, the
``PARQUET_TPU_TORCH_MMAP`` opt-out), on the CPU, after
``tests/test_prefetch.py``; and the read under every prefetch mode,
composed with the fault layer, against parquet_tpu's host read.

Files are pyarrow's, small and made from a seed with numpy.  No test
waits on a clock bound tighter than seconds; every test ends with the
threads it started with (the shared pools are filled once, first).
"""

import io
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import DeadlineError
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io import prefetch as pre_mod
from parquet_tpu_torch.io.prefetch import (PrefetchSource, ReadStats,
                                           make_chunk_prefetcher,
                                           make_prefetcher, prefetch_mode)
from parquet_tpu_torch.io.source import (BytesSource, FileLikeSource,
                                         FileSource, MmapSource, as_source)
from parquet_tpu_torch.utils import pool as pool_mod
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = "cpu"
MODE = "PARQUET_TPU_TORCH_PREFETCH"


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
    from parquet_tpu.utils import pool as jpool

    for pool, width in ((pool_mod.shared_pool(), pool_mod.pool_width()),
                        (jpool.shared_pool(), jpool.pool_width())):
        barrier = threading.Barrier(width + 1)
        futs = [pool.submit(barrier.wait) for _ in range(width)]
        barrier.wait(timeout=30)
        for f in futs:
            f.result(timeout=30)


@pytest.fixture(autouse=True)
def _fresh():
    pre_mod.prefetch_autotune().reset()
    before = threads_now()
    yield
    pre_mod.prefetch_autotune().reset()
    assert_no_thread_started(before)


def _file(n=20_000, row_groups=5) -> bytes:
    rng = np.random.default_rng(7)
    t = pa.table({"x": pa.array(np.arange(n, dtype=np.int64)),
                  "f": pa.array(rng.random(n)),
                  "s": pa.array([f"v{i % 97}" for i in range(n)])})
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=n // row_groups,
                     compression="snappy", data_page_size=4096)
    return buf.getvalue()


@pytest.fixture(scope="module")
def raw() -> bytes:
    return _file()


def _values(got) -> dict:
    out = {}
    for name, col in got.items():
        v = col.materialize_host()
        out[name] = (v if not isinstance(v, tuple)
                     else (v[0].tobytes(), v[1].tolist()))
    return out


def _same(a, b) -> None:
    va, vb = _values(a), _values(b)
    assert list(va) == list(vb)
    for k in va:
        if isinstance(va[k], tuple):
            assert va[k] == vb[k], k
        else:
            np.testing.assert_array_equal(va[k], vb[k], err_msg=k)


def _settle(pre: PrefetchSource) -> None:
    """Every window issued so far read (waited on, no clock)."""
    for w in list(pre._ring):
        w.future.result(timeout=30)


# ---------------------------------------------------------------------------
# the ring and the advise backend
# ---------------------------------------------------------------------------


def test_ring_serves_planned_windows_and_accounts():
    data = bytes(range(256)) * 4096  # 1 MiB
    src = BytesSource(data)
    pre = PrefetchSource(src, backend="ring", window_bytes=4096, depth=2,
                         max_windows=8)
    pre.plan(0, len(data))
    assert pre.pread(0, 4096) == data[:4096]
    assert pre.pread(4096, 2048) == data[4096:6144]
    assert pre.pread(6144, 4096) == data[6144:10240]  # spans two windows
    assert bytes(pre.pread_view(10240, 2048)) == data[10240:12288]
    st = pre.stats
    assert st.backend == "ring" and st.prefetch_hits >= 3
    assert st.windows_issued >= 2 and st.bytes_prefetched > 0
    assert pre.pread(len(data) - 10, 10) == data[-10:]  # read through
    assert st.prefetch_misses >= 1
    pre.close()
    assert src.pread(0, 4) == data[:4]  # the source stays open
    d = st.as_dict()
    assert d["backend"] == "ring" and set(d) >= {"pool_wait_s",
                                                 "bytes_discarded"}


def test_ring_spanning_read_over_bytes_windows():
    """An injector's window comes back as ``bytes``: a read across two of
    them joins correctly."""
    data = bytes(range(256)) * 256
    src = tfaults.FaultInjectingSource(BytesSource(data), flip_offsets=[7],
                                       flip_mask=0xFF)
    pre = PrefetchSource(src, backend="ring", window_bytes=4096, depth=3)
    pre.plan(0, len(data))
    want = bytearray(data)
    want[7] ^= 0xFF
    assert pre.pread(0, 4096) == bytes(want[:4096])
    assert pre.pread(4096, 8192) == bytes(want[4096:12288])
    pre.close()


def test_unplan_releases_ring_capacity():
    data = bytes(range(256)) * 4096
    pre = PrefetchSource(BytesSource(data), backend="ring",
                         window_bytes=4096, depth=2, max_windows=2)
    pre.plan(0, 65536)  # fills both ring slots
    pre.unplan(0, 65536)
    assert pre.stats.bytes_discarded > 0
    pre.plan(100_000, 65536)  # freed capacity: the new plan's windows issue
    _settle(pre)
    assert pre.pread(100_000, 4096) == data[100_000:104_096]
    assert pre.stats.prefetch_hits >= 1
    pre.close()


def test_ring_close_discards_unconsumed_windows():
    pre = PrefetchSource(BytesSource(b"ab" * (1 << 20)), backend="ring",
                         window_bytes=8192, depth=4, max_windows=16)
    pre.plan(0, 1 << 21)
    _settle(pre)
    pre.close()
    assert pre.stats.bytes_discarded > 0 and not pre._ring
    pre.plan(0, 4096)  # a closed prefetcher plans nothing
    assert not pre._plans


def test_ring_error_surfaces_on_consuming_thread():
    class Boom(BytesSource):
        def pread(self, offset, size):
            raise OSError(5, "boom")

    pre = PrefetchSource(Boom(b"x" * 65536), backend="ring",
                         window_bytes=4096, depth=2)
    pre.plan(0, 65536)
    with pytest.raises(OSError, match="boom"):
        pre.pread(0, 4096)
    pre.close()


def test_ring_segment_carving_zero_copy_join():
    data = bytes(range(256)) * 256
    pre = PrefetchSource(BytesSource(data), backend="ring",
                         window_bytes=4096, depth=4, max_windows=16)
    pre.plan(0, len(data))
    _settle(pre)
    w0, w1 = pre._ring[0], pre._ring[1]
    assert w0.seg is w1.seg  # carved from one segment
    out = pre.pread_view(2048, 4096)  # across the window join
    assert bytes(out) == data[2048:6144] and out.base is not None
    pre.close()


def test_ring_segment_boundary_reads_still_correct():
    data = np.random.default_rng(3).integers(
        0, 256, 64 * 1024, dtype=np.uint8).tobytes()
    seg_bytes = pre_mod._SEG_WINDOWS * 1024
    pre = PrefetchSource(BytesSource(data), backend="ring",
                         window_bytes=1024, depth=pre_mod._SEG_WINDOWS + 2,
                         max_windows=32)
    pre.plan(0, len(data))
    pos = 0
    sizes = [700, 1500, seg_bytes - 100, 3000, 1024, 997]
    while pos < len(data):
        take = min(sizes[pos % len(sizes)], len(data) - pos)
        assert pre.pread(pos, take) == data[pos:pos + take], pos
        pos += take
    pre.close()


def test_ring_wait_honours_the_deadline_below():
    """A window still being read is waited for in laps that check the
    deadline of the PolicySource below: a spent budget raises."""
    gate = threading.Event()

    class Slow(BytesSource):
        def pread(self, offset, size):
            gate.wait(30)
            return super().pread(offset, size)

    pol = pqt.PolicySource(Slow(b"y" * 65536),
                           pqt.FaultPolicy(deadline_s=0.05, backoff_s=0.0))
    pre = PrefetchSource(pol, backend="ring", window_bytes=4096, depth=2)
    with pol.operation():
        pre.plan(0, 8192)
        with pytest.raises(DeadlineError):
            pre.pread(0, 4096)
    gate.set()
    pre.close()


def test_advise_backend_zero_copy(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(256)) * 1024)
    src = as_source(str(p))
    assert isinstance(src, MmapSource)
    pre = make_prefetcher(src)
    assert pre is not None and pre.backend == "advise"
    pre.plan(0, src.size())
    v = pre.pread_view(1000, 4096)
    assert isinstance(v, np.ndarray)
    assert bytes(v[:8]) == bytes(range(256))[1000 % 256:][:8]
    assert pre.stats.prefetch_hits == 1
    assert pre.pread(0, 4) == bytes(range(4))
    pre.close()
    src.close()
    with pytest.raises(ValueError, match="MmapSource"):
        PrefetchSource(BytesSource(b"abc"), backend="advise")
    with pytest.raises(ValueError, match="backend"):
        PrefetchSource(BytesSource(b"abc"), backend="nope")


def test_make_prefetcher_gates(monkeypatch, tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 4096)
    fsrc = FileSource(str(p))
    monkeypatch.setenv(MODE, "0")
    assert make_prefetcher(fsrc) is None and prefetch_mode() == "off"
    monkeypatch.setenv(MODE, "ring")
    ring = make_prefetcher(BytesSource(b"abc"))
    assert ring.backend == "ring"
    ring.close()
    monkeypatch.setenv(MODE, "auto")
    monkeypatch.setattr(pool_mod, "available_cpus", lambda: 1)
    assert make_prefetcher(fsrc) is None  # one core: no ring
    monkeypatch.setattr(pool_mod, "available_cpus", lambda: 4)
    got = make_prefetcher(fsrc)
    assert got is not None and got.backend == "ring"
    got.close()
    assert make_prefetcher(BytesSource(b"abc")) is None  # nothing to hide
    monkeypatch.setenv(MODE, "advise")
    assert make_prefetcher(fsrc) is None and prefetch_mode() == "advise"
    monkeypatch.delenv(MODE)
    assert prefetch_mode() == "auto"
    fsrc.close()


def test_chunk_prefetcher_gates(monkeypatch, tmp_path, raw):
    p = tmp_path / "c.parquet"
    p.write_bytes(raw)
    monkeypatch.setenv(MODE, "0")
    assert make_chunk_prefetcher(as_source(str(p))) is None
    monkeypatch.setenv(MODE, "auto")
    assert make_chunk_prefetcher(BytesSource(raw)) is None
    src = as_source(str(p))
    pre = make_chunk_prefetcher(src)
    assert pre.backend == "advise"
    pre.close()
    src.close()
    monkeypatch.setenv(MODE, "ring")
    pre = make_chunk_prefetcher(BytesSource(raw))
    assert pre is not None and pre.backend == "ring"
    pre.close()


# ---------------------------------------------------------------------------
# the auto-tuner
# ---------------------------------------------------------------------------


def test_autotune_deepens_on_bubble_and_decays():
    tuner = pre_mod.prefetch_autotune()
    st = ReadStats(windows_issued=4, pool_wait_s=0.5)
    tuner.observe(st)
    assert tuner.suggest() == (pre_mod.DEFAULT_DEPTH + 1, None)
    for _ in range(16):  # depth saturates, then the window doubles
        tuner.observe(st)
    assert tuner.suggest() == (pre_mod._MAX_DEPTH, pre_mod._MAX_WINDOW_BYTES)
    calm = ReadStats(windows_issued=4, pool_wait_s=0.0)
    for _ in range(32):
        tuner.observe(calm)
    assert tuner.suggest() == (None, None)
    tuner.observe(ReadStats())  # no window issued: nothing learned
    assert tuner.suggest() == (None, None)


def test_autotune_feeds_the_next_ring(monkeypatch):
    tuner = pre_mod.prefetch_autotune()
    tuner.observe(ReadStats(windows_issued=4, pool_wait_s=0.5))
    pre = PrefetchSource(BytesSource(b"x" * 4096), backend="ring")
    assert pre.depth == pre_mod.DEFAULT_DEPTH + 1 and pre._tunable
    pre.stats.windows_issued, pre.stats.pool_wait_s = 4, 0.5
    pre.close()  # its stall feeds the state once more
    assert tuner.suggest()[0] == pre_mod.DEFAULT_DEPTH + 2


def test_autotune_opt_out_and_pins(monkeypatch):
    tuner = pre_mod.prefetch_autotune()
    tuner.observe(ReadStats(windows_issued=4, pool_wait_s=0.5))
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE", "0")
    pre = PrefetchSource(BytesSource(b"x" * 4096), backend="ring")
    assert pre.depth == pre_mod.DEFAULT_DEPTH and not pre._tunable
    pre.close()
    monkeypatch.delenv("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE")
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_DEPTH", "5")
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_WINDOW", "65536")
    pre = PrefetchSource(BytesSource(b"x" * 4096), backend="ring")
    assert pre.depth == 5 and pre.window_bytes == 65536 \
        and not pre._tunable
    pre.close()


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------


def test_mmap_source_matches_file_source(tmp_path):
    p = tmp_path / "f.bin"
    data = os.urandom(100_000)
    p.write_bytes(data)
    ms, fs = MmapSource(str(p)), FileSource(str(p))
    for off, size in [(0, 10), (99_990, 10), (12345, 54321), (0, 100_000)]:
        assert ms.pread(off, size) == fs.pread(off, size)
        assert bytes(ms.pread_view(off, size)) == fs.pread(off, size)
    for src in (ms, fs):
        with pytest.raises(pqt.ShortReadError):
            src.pread(99_999, 100)  # past the end: a short read, loud
    with pytest.raises(pqt.CorruptedError):
        ms.pread(-5, 10)
    view = ms.pread_view(0, 100)
    ms.close()
    ms.close()
    assert bytes(view) == data[:100]
    with pytest.raises(ValueError, match="closed"):
        ms.pread(0, 4)
    fs.close()


@pytest.mark.parametrize("value,kind", [("0", FileSource),
                                        ("1", MmapSource),
                                        ("off", FileSource),
                                        ("false", FileSource),
                                        ("on", MmapSource)])
def test_mmap_knob(monkeypatch, tmp_path, value, kind):
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 64)
    monkeypatch.setenv("PARQUET_TPU_TORCH_MMAP", value)
    src = as_source(str(p))
    assert type(src) is kind
    src.close()


def test_filelike_source_concurrent_preads():
    data = bytes(range(256)) * 2048
    src = FileLikeSource(io.BytesIO(data))
    rng = np.random.default_rng(3)
    spans = [(int(o), int(s)) for o, s in zip(
        rng.integers(0, len(data) - 4096, 400), rng.integers(1, 4096, 400))]

    def worker(part):
        return [src.pread(o, s) == data[o:o + s] for o, s in part]

    futs = [pool_mod.submit(worker, spans[i::4]) for i in range(4)]
    assert all(all(f.result(30)) for f in futs)
    src.close()
    with pytest.raises(ValueError):
        src.pread(0, 4)


def test_filelike_close_during_preads_is_clean():
    src = FileLikeSource(io.BytesIO(b"z" * 262144))
    started = threading.Barrier(5)
    errs = []

    def reader():
        started.wait(30)
        while True:
            try:
                src.pread(1000, 64)
            except ValueError:
                return  # the closed-source error: clean
            except Exception as e:
                errs.append(e)
                return

    ts = [threading.Thread(target=reader) for _ in range(4)]
    for t in ts:
        t.start()
    started.wait(30)
    src.close()
    for t in ts:
        t.join(30)
    assert not errs


# ---------------------------------------------------------------------------
# the read under every prefetch mode, with the fault layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "auto", "advise", "ring"])
def test_read_is_equal_in_every_mode(monkeypatch, tmp_path, raw, mode):
    p = tmp_path / "f.parquet"
    p.write_bytes(raw)
    want = parquet_tpu.ParquetFile(raw).read()
    monkeypatch.setenv(MODE, mode)
    for source in (raw, str(p)):
        pf = pqt.ParquetFile(source)
        got = pf.read(device=CPU)
        assert list(got) == want.to_arrow().column_names
        np.testing.assert_array_equal(got["x"].values.numpy(),
                                      want.to_arrow()["x"].to_numpy())
        _same(got, pqt.ParquetFile(raw).read(device=CPU))
        assert pf.source is pf._base_source  # the prefetcher is gone
        pf.close()


def test_ring_read_retries_transient_errors(monkeypatch, raw):
    monkeypatch.setenv(MODE, "ring")
    clean = pqt.ParquetFile(raw).read(device=CPU)
    pol = pqt.FaultPolicy(max_retries=4, backoff_s=0.0)
    for seed in range(3):
        src = tfaults.FaultInjectingSource(BytesSource(raw), seed=seed,
                                           error_rate=0.25,
                                           max_consecutive_errors=2)
        pf = pqt.ParquetFile(src, policy=pol)
        at_open = src.stats.injected_errors
        rep = pqt.ReadReport()
        _same(pf.read(device=CPU, report=rep), clean)
        if src.stats.injected_errors > at_open:
            # the window reads' retries land in the consumer's report
            assert rep.retries > 0, seed


def test_ring_read_deadline_with_queued_windows(monkeypatch, raw):
    monkeypatch.setenv(MODE, "ring")
    src = tfaults.FaultInjectingSource(BytesSource(raw), latency_s=0.05)
    pf = pqt.ParquetFile(BytesSource(raw))
    pf.source = pf._base_source = src
    with pytest.raises(DeadlineError):
        pf.read(device=CPU, policy=pqt.FaultPolicy(deadline_s=0.005,
                                                   backoff_s=0.0))
    assert pf.source is src
    pf.source = pf._base_source = BytesSource(raw)
    _same(pf.read(device=CPU), pqt.ParquetFile(raw).read(device=CPU))


@pytest.mark.parametrize("mode", ["off", "ring"])
def test_skip_read_under_each_mode_matches_jax(monkeypatch, raw, mode):
    md = papq.ParquetFile(io.BytesIO(raw)).metadata
    off = md.row_group(2).column(0).data_page_offset
    flips = [off, off + 1, off + 2]
    monkeypatch.setenv(MODE, mode)
    skip = pqt.FaultPolicy(backoff_s=0.0, on_corrupt="skip_row_group")
    rep = pqt.ReadReport()
    got = pqt.ParquetFile(tfaults.FaultInjectingSource(
        BytesSource(raw), flip_offsets=flips), policy=skip).read(
        device=CPU, report=rep)
    jrep = parquet_tpu.ReadReport()
    from parquet_tpu.io.faults import FaultInjectingSource as JFault
    from parquet_tpu.io.source import BytesSource as JBytes

    want = parquet_tpu.ParquetFile(JFault(JBytes(raw), flip_offsets=flips),
                                   policy=parquet_tpu.FaultPolicy(
                                       backoff_s=0.0,
                                       on_corrupt="skip_row_group")
                                   ).read(report=jrep)
    np.testing.assert_array_equal(got["x"].values.numpy(),
                                  want.to_arrow()["x"].to_numpy())
    assert rep.row_groups_skipped == jrep.row_groups_skipped == [2]
    assert rep.rows_dropped == jrep.rows_dropped > 0
    assert rep.rows_read == jrep.rows_read


def test_device_pipeline_plans_on_the_chunk_prefetcher(monkeypatch,
                                                       tmp_path, raw):
    """``decode_chunks_pipelined`` over a mapped file plans every chunk on
    the advise prefetcher (its hits counted), and the file reads plainly
    afterwards."""
    p = tmp_path / "d.parquet"
    p.write_bytes(raw)
    made = []
    real = pre_mod.make_chunk_prefetcher

    def spy(source, *a, **k):
        got = real(source, *a, **k)
        made.append(got)
        return got

    monkeypatch.setattr(pre_mod, "make_chunk_prefetcher", spy)
    pf = pqt.ParquetFile(str(p))
    got = pf.read(device=CPU)
    assert made and made[0].backend == "advise"
    assert made[0].stats.prefetch_hits >= len(pf.row_groups) * 3
    _same(got, pqt.ParquetFile(raw).read(device=CPU))
    assert type(pf.source) is MmapSource


# ---------------------------------------------------------------------------
# the streamed drain under every prefetch mode, and drop-behind
# ---------------------------------------------------------------------------


def _drain(pf, batch_rows=1500, **kw) -> dict:
    """A drain's batches concatenated by column."""
    from parquet_tpu_torch.io.column import concat_columns

    batches = list(pf.iter_batches(batch_rows=batch_rows, device=CPU, **kw))
    return {p: concat_columns([b[p] for b in batches]) for p in batches[0]}


@pytest.mark.parametrize("mode", ["off", "auto", "advise", "ring"])
def test_stream_is_equal_in_every_mode(monkeypatch, tmp_path, raw, mode):
    p = tmp_path / "f.parquet"
    p.write_bytes(raw)
    want = pqt.ParquetFile(raw).read(device=CPU)
    jwant = parquet_tpu.ParquetFile(raw).read().to_arrow()
    monkeypatch.setenv(MODE, mode)
    for source in (raw, str(p)):
        pf = pqt.ParquetFile(source)
        got = _drain(pf)
        _same(got, want)
        np.testing.assert_array_equal(got["x"].values.numpy(),
                                      jwant["x"].to_numpy())
        assert pf.source is pf._base_source
        pf.close()


def test_stream_ring_retries_transient_errors(monkeypatch, raw):
    monkeypatch.setenv(MODE, "ring")
    clean = pqt.ParquetFile(raw).read(device=CPU)
    pol = pqt.FaultPolicy(max_retries=4, backoff_s=0.0)
    for seed in range(3):
        src = tfaults.FaultInjectingSource(BytesSource(raw), seed=seed,
                                           error_rate=0.25,
                                           max_consecutive_errors=2)
        pf = pqt.ParquetFile(src, policy=pol)
        at_open = src.stats.injected_errors
        rep = pqt.ReadReport()
        _same(_drain(pf, report=rep), clean)
        if src.stats.injected_errors > at_open:
            assert rep.retries > 0, seed


@pytest.mark.parametrize("mode", ["off", "ring"])
def test_stream_skip_under_each_mode_matches_jax(monkeypatch, raw, mode):
    from parquet_tpu.io.faults import FaultInjectingSource as JFault
    from parquet_tpu.io.source import BytesSource as JBytes

    md = papq.ParquetFile(io.BytesIO(raw)).metadata
    off = md.row_group(2).column(0).data_page_offset
    flips = [off, off + 1, off + 2]
    monkeypatch.setenv(MODE, mode)
    rep = pqt.ReadReport()
    got = _drain(pqt.ParquetFile(tfaults.FaultInjectingSource(
        BytesSource(raw), flip_offsets=flips), policy=pqt.FaultPolicy(
        backoff_s=0.0, on_corrupt="skip_row_group")), report=rep)
    jrep = parquet_tpu.ReadReport()
    want = [b.to_arrow() for b in parquet_tpu.iter_batches(
        parquet_tpu.ParquetFile(JFault(JBytes(raw), flip_offsets=flips),
                                policy=parquet_tpu.FaultPolicy(
                                    backoff_s=0.0,
                                    on_corrupt="skip_row_group")),
        batch_rows=1500, report=jrep)]
    np.testing.assert_array_equal(
        got["x"].values.numpy(),
        np.concatenate([t["x"].to_numpy() for t in want]))
    assert rep.row_groups_skipped == jrep.row_groups_skipped == [2]
    assert rep.rows_dropped == jrep.rows_dropped > 0
    assert rep.rows_read == jrep.rows_read


def test_read_stats_surfaced_on_batches(tmp_path, raw):
    p = tmp_path / "f.parquet"
    p.write_bytes(raw)
    last = None
    for b in pqt.ParquetFile(str(p)).iter_batches(batch_rows=4000,
                                                   device=CPU):
        last = b
    assert isinstance(last.read_stats, ReadStats)
    d = last.read_stats.as_dict()
    assert d["backend"] == "advise" and d["prefetch_hits"] > 0
    assert last.read_stats.bytes_prefetched > 0
    assert d["bytes_dropbehind"] == 0


def _mmap_file(tmp_path, nbytes=1 << 20):
    data = (np.arange(nbytes, dtype=np.uint32) * 2654435761).astype(
        np.uint32).tobytes()[:nbytes]
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    return str(p), data


def test_madvise_sequential_best_effort(tmp_path):
    path, data = _mmap_file(tmp_path)
    src = MmapSource(path)
    src.madvise_sequential()  # never raises
    assert src.pread(100, 16) == data[100:116]
    src.close()
    src.madvise_sequential()  # closed: nothing to do
    assert src.madvise_dontneed(0, 1 << 20) == 0


def test_dropbehind_knob_gates(tmp_path, monkeypatch):
    from parquet_tpu_torch.io.source import dropbehind_enabled

    monkeypatch.delenv("PARQUET_TPU_TORCH_MMAP_DROPBEHIND", raising=False)
    assert not dropbehind_enabled()
    path, data = _mmap_file(tmp_path)
    src = MmapSource(path)
    assert src._fd is None  # no descriptor kept while the mode is off
    pre = PrefetchSource(src, backend="advise")
    pre.plan(0, len(data))
    pre.pread(0, 4096)
    pre.close()
    assert pre.stats.bytes_dropbehind == 0
    src.close()
    monkeypatch.setenv("PARQUET_TPU_TORCH_MMAP_DROPBEHIND", "1")
    assert dropbehind_enabled()
    src = MmapSource(path)
    assert src._fd is not None  # kept for posix_fadvise
    src.close()
    assert src._fd is None


def test_dropbehind_drain_equal_and_metered(tmp_path, monkeypatch):
    """A drain with drop-behind on is equal to the one without and counts
    the page cache it released (sequential advice, then DONTNEED behind
    the frontier and over the rest at the end)."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_MMAP_DROPBEHIND", "1")
    n = 120_000
    t = pa.table({"a": pa.array(np.arange(n, dtype=np.int64)),
                  "b": pa.array(np.arange(n, dtype=np.float64))})
    p = tmp_path / "drain.parquet"
    papq.write_table(t, str(p), row_group_size=n // 4)
    pf = pqt.ParquetFile(str(p))
    last = None
    parts = []
    for b in pf.iter_batches(batch_rows=10_000, device=CPU):
        parts.append(b["a"].values.numpy())
        last = b
    np.testing.assert_array_equal(np.concatenate(parts), np.arange(n))
    rs = last.read_stats
    assert rs.backend == "advise"
    assert rs.bytes_dropbehind > 0
    assert rs.as_dict()["bytes_dropbehind"] == rs.bytes_dropbehind
    pf.close()


def test_dropbehind_trails_the_frontier(tmp_path, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_MMAP_DROPBEHIND", "1")
    path, data = _mmap_file(tmp_path, nbytes=1 << 20)
    src = MmapSource(path)
    pre = PrefetchSource(src, backend="advise", window_bytes=64 * 1024)
    pre.plan(0, len(data))
    assert pre.pread(0, 256 * 1024) == data[:256 * 1024]
    # the read's own span is not dropped: its view is not decoded yet
    assert pre.stats.bytes_dropbehind == 0
    assert pre.pread(256 * 1024, 256 * 1024) == data[256 * 1024:512 * 1024]
    assert pre.stats.bytes_dropbehind > 0  # the first span, mid-drain
    mid = pre.stats.bytes_dropbehind
    pre.close()
    assert pre.stats.bytes_dropbehind >= mid  # the rest at the end
    assert src.pread(4096, 64) == data[4096:4160]  # reads still correct
    src.close()


def test_make_prefetcher_sizes_the_ring_by_streams(monkeypatch):
    monkeypatch.setenv(MODE, "ring")
    assert make_prefetcher(BytesSource(b"x" * 100)).max_windows == 8
    assert make_prefetcher(BytesSource(b"x" * 100),
                           n_streams=7).max_windows == 14
