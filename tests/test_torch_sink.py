"""parquet_tpu_torch's sinks (``io/sink.py``) against the JAX package's:
the same sequence of writes gives the same bytes on disk and the same
byte and flush counters of ``WriteStats`` in both packages'
``BufferedSink`` over each inner sink; the atomic and in-place path
sinks commit, abort and fail as the JAX package's do; the vectored flush
resumes short writes and batches by ``IOV_MAX``; the write auto-tuner
follows the same rule; and ``FaultInjectingSink`` draws the same faults
from the same seed.  Timing fields are checked only for their
invariants."""

import errno
import io
import os

import numpy as np
import pytest

import parquet_tpu
from parquet_tpu.io import faults as jfaults
from parquet_tpu.io import sink as jsink

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io import sink as tsink
from torch_fixtures.threads import assert_no_thread_started, threads_now

COUNTERS = ("bytes_buffered", "bytes_flushed", "sink_flushes",
            "writev_flushes")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PARQUET_TPU_TORCH_WRITE_BUFFER",
              "PARQUET_TPU_TORCH_WRITE_AUTOTUNE", "PARQUET_TPU_WRITE_BUFFER",
              "PARQUET_TPU_WRITE_AUTOTUNE", "PARQUET_TPU_MMAP_SINK"):
        monkeypatch.delenv(k, raising=False)
    tsink.write_autotune().reset()
    jsink.write_autotune().reset()
    before = threads_now()
    yield
    tsink.write_autotune().reset()
    jsink.write_autotune().reset()
    assert_no_thread_started(before)


def _writes(seed: int) -> list:
    """A seeded sequence of ``write`` (bytes) and ``writelines`` (a list
    of bytes) calls of 0 to 3,000 bytes each."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        n = int(rng.integers(0, 3000))
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        if rng.random() < 0.3:
            cut = int(rng.integers(0, n + 1))
            ops.append([blob[:cut], blob[cut:]])
        else:
            ops.append(blob)
    return ops


def _inner(pkg, kind: str, path: str):
    if kind == "bytesio":
        return io.BytesIO()
    return {"file": pkg.FileSink, "atomic": pkg.AtomicFileSink}[kind](path)


def _run(pkg, kind, path, buffer_bytes, ops):
    stats = pkg.WriteStats()
    inner = _inner(pkg, kind, path)
    sink = pkg.BufferedSink(inner, buffer_bytes=buffer_bytes, stats=stats)
    for op in ops:
        if isinstance(op, list):
            sink.writelines(op)
        else:
            sink.write(op)
    sink.flush()
    if kind == "bytesio":
        out = inner.getvalue()
    else:
        sink.close()
        out = open(path, "rb").read()
    return out, stats


@pytest.mark.parametrize("buffer_bytes", [0, 1, 1024, 65_536, 1 << 22])
@pytest.mark.parametrize("kind", ["bytesio", "file", "atomic"])
def test_same_writes_same_bytes_and_counters(tmp_path, kind, buffer_bytes):
    ops = _writes(buffer_bytes + len(kind))
    got, st = _run(tsink, kind, str(tmp_path / "port.bin"), buffer_bytes,
                   ops)
    want, jst = _run(jsink, kind, str(tmp_path / "jax.bin"), buffer_bytes,
                     ops)
    assert got == want
    assert got == b"".join(b"".join(op) if isinstance(op, list) else op
                           for op in ops)
    assert {k: getattr(st, k) for k in COUNTERS} == {
        k: getattr(jst, k) for k in COUNTERS}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("stats", [
    dict(), dict(overlapped_groups=3, encode_s=2.0, pool_wait_s=0.5),
    dict(overlapped_groups=1, encode_s=1.0, pool_wait_s=3.0),
    dict(overlapped_groups=2, encode_s=0.0, pool_wait_s=0.0),
    dict(row_groups=4, emit_s=0.123456, bytes_flushed=9, sink_flushes=2)])
def test_write_stats_as_jax(stats):
    got, want = pqt.WriteStats(**stats), parquet_tpu.WriteStats(**stats)
    assert got.overlap_ratio() == want.overlap_ratio()
    assert got.as_dict() == want.as_dict()


class _CountingSink:
    def __init__(self):
        self.buf = io.BytesIO()
        self.write_calls = 0
        self.writelines_calls = 0
        self.closed = False
        self.aborted = False

    def write(self, d):
        self.write_calls += 1
        return self.buf.write(d)

    def writelines(self, parts):
        self.writelines_calls += 1
        for p in parts:
            self.buf.write(p)

    def flush(self):
        pass

    def close(self):
        self.closed = True

    def abort(self):
        self.aborted = True


def test_buffered_sink_coalesces_small_writes():
    inner = _CountingSink()
    st = pqt.WriteStats()
    b = pqt.BufferedSink(inner, buffer_bytes=1024, stats=st)
    for i in range(64):
        b.write(bytes([i]) * 100)
    assert inner.write_calls == 0 and inner.writelines_calls == 5
    b.flush()
    assert inner.buf.getvalue() == b"".join(bytes([i]) * 100
                                            for i in range(64))
    assert st.bytes_buffered == 6400 and st.bytes_flushed == 6400
    assert st.sink_flushes == 6 and st.writev_flushes == 0


def test_buffered_sink_close_drains_and_abort_drops():
    inner = _CountingSink()
    b = pqt.BufferedSink(inner, buffer_bytes=1 << 20)
    b.write(b"tail bytes")
    b.close()
    assert inner.closed and inner.buf.getvalue() == b"tail bytes"
    inner = _CountingSink()
    b = pqt.BufferedSink(inner, buffer_bytes=1 << 20)
    b.write(b"never flushed")
    b.abort()
    assert inner.aborted and inner.buf.getvalue() == b""
    plain = io.BytesIO()  # no abort: the inner sink is closed instead
    pqt.BufferedSink(plain, buffer_bytes=1 << 20).abort()
    assert plain.closed


def test_writev_all_resumes_short_writes_and_batches(monkeypatch, tmp_path):
    if not hasattr(os, "writev"):
        pytest.skip("no os.writev on this platform")
    monkeypatch.setattr(tsink, "_IOV_MAX", 4)
    parts = [bytes([i]) * 13 for i in range(11)]
    p = tmp_path / "iov.bin"
    fd = os.open(str(p), os.O_WRONLY | os.O_CREAT)
    try:
        tsink._writev_all(fd, parts)
    finally:
        os.close(fd)
    assert p.read_bytes() == b"".join(parts)
    calls = []
    real = os.writev

    def short(fd_, bufs):
        calls.append(len(bufs))
        assert len(bufs) <= 4
        return real(fd_, [memoryview(bufs[0])[:5]])

    monkeypatch.setattr(os, "writev", short)
    p2 = tmp_path / "short.bin"
    fd = os.open(str(p2), os.O_WRONLY | os.O_CREAT)
    try:
        tsink._writev_all(fd, parts)
    finally:
        os.close(fd)
    assert p2.read_bytes() == b"".join(parts)
    assert len(calls) > len(parts)
    monkeypatch.setattr(os, "writev", lambda fd_, bufs: 0)
    fd = os.open(str(tmp_path / "zero.bin"), os.O_WRONLY | os.O_CREAT)
    try:
        with pytest.raises(OSError, match="writev wrote 0"):
            tsink._writev_all(fd, parts)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# the path sinks
# ---------------------------------------------------------------------------
def _temps(d) -> list:
    return [f for f in os.listdir(d) if f.endswith(".tmp")]


@pytest.mark.parametrize("pkg", [tsink, jsink], ids=["port", "jax"])
def test_atomic_sink_commits_by_rename(tmp_path, pkg):
    dest = tmp_path / "a.bin"
    s = pkg.AtomicFileSink(str(dest))
    s.write(b"PAR1")
    s.writelines([b"x" * 10_000_000, memoryview(b"yz")])
    s.flush()
    assert not dest.exists() and len(_temps(tmp_path)) == 1
    assert s.temp_path.startswith(str(dest) + ".")
    s.close()
    s.close()  # a second close is a no-op
    assert dest.read_bytes() == b"PAR1" + b"x" * 10_000_000 + b"yz"
    assert s.committed and s.temp_path is None and not _temps(tmp_path)
    s.abort()  # after the commit: leaves the destination alone
    assert dest.exists()


@pytest.mark.parametrize("pkg", [tsink, jsink], ids=["port", "jax"])
def test_atomic_sink_abort_leaves_nothing(tmp_path, pkg):
    dest = tmp_path / "b.bin"
    s = pkg.AtomicFileSink(str(dest))
    s.write(b"partial")
    s.abort()
    s.abort()  # idempotent
    assert os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="commit after abort"):
        s.close()
    with pytest.raises(ValueError, match="closed sink"):
        s.write(b"more")


@pytest.mark.parametrize("pkg", [tsink, jsink], ids=["port", "jax"])
def test_commit_failure_raises_a_located_write_error(tmp_path, monkeypatch,
                                                     pkg):
    dest = tmp_path / "c.bin"
    s = pkg.AtomicFileSink(str(dest))
    s.write(b"PAR1")
    tp = s.temp_path

    def no_replace(src, dst):
        raise OSError(errno.EACCES, "rename denied")

    monkeypatch.setattr(os, "replace", no_replace)
    with pytest.raises(OSError) as ei:
        s.close()
    monkeypatch.undo()
    assert type(ei.value).__name__ == "WriteError"
    assert ei.value.path == str(dest) and ei.value.temp_path == tp
    assert isinstance(ei.value.__cause__, OSError)
    assert os.listdir(tmp_path) == []


def test_commit_failure_releases_the_descriptor(tmp_path, monkeypatch):
    def no_fsync(fd):
        raise OSError(errno.EIO, "fsync failed")

    fd_dir = "/proc/self/fd"
    before = len(os.listdir(fd_dir))
    for i in range(20):
        sink = pqt.AtomicFileSink(str(tmp_path / f"fd{i}.bin"))
        sink.write(b"PAR1")
        monkeypatch.setattr(os, "fsync", no_fsync)
        with pytest.raises(pqt.WriteError):
            sink.close()
        monkeypatch.undo()
    assert len(os.listdir(fd_dir)) <= before + 1
    assert not _temps(tmp_path)


def test_file_sink_writes_in_place_and_abort_unlinks(tmp_path):
    dest = tmp_path / "d.bin"
    s = pqt.FileSink(str(dest))
    s.write(b"abc")
    assert dest.exists() and s.raw_fd() is not None
    s.close()
    s.close()
    assert dest.read_bytes() == b"abc" and s.raw_fd() is None
    s2 = pqt.FileSink(str(tmp_path / "e.bin"), fsync=False)
    s2.writelines([b"a", b"b"])
    s2.abort()
    assert not (tmp_path / "e.bin").exists()


def test_commit_drops_the_cached_footer(tmp_path):
    """A committed destination's cached footer goes: a rewrite of the
    same size reads back as the new file."""
    dest = str(tmp_path / "f.parquet")
    pqt.write_table({"x": np.arange(100, dtype=np.int64)}, dest)
    assert (pqt.ParquetFile(dest).read(device="cpu")["x"].values.numpy()
            == np.arange(100)).all()
    pqt.write_table({"x": np.arange(100, 200, dtype=np.int64)}, dest)
    assert (pqt.ParquetFile(dest).read(device="cpu")["x"].values.numpy()
            == np.arange(100, 200)).all()


def test_fsync_dir_is_best_effort(tmp_path):
    tsink.fsync_dir(str(tmp_path / "any"))
    tsink.fsync_dir(str(tmp_path / "missing" / "deeper" / "file"))


# ---------------------------------------------------------------------------
# the auto-tuner, as the JAX package's
# ---------------------------------------------------------------------------
def test_write_autotune_grows_then_decays_as_jax():
    seq = [(6, 120), (6, 120), (6, 6), (6, 6), (6, 6), (6, 0), (1, 100),
           (2, 200), (0, 5)]
    for rgs, flushes in seq:
        for pkg in (tsink, jsink):
            pkg.write_autotune().observe(pkg.WriteStats(
                row_groups=rgs, sink_flushes=flushes,
                bytes_buffered=1 if flushes else 0))
        assert tsink.write_buffer_bytes() == jsink.write_buffer_bytes()
        assert tsink.write_autotune().suggest() == \
            jsink.write_autotune().suggest()
    t = tsink.write_autotune()
    t.reset()
    hot = pqt.WriteStats(row_groups=6, sink_flushes=120, bytes_buffered=1)
    t.observe(hot)
    assert tsink.write_buffer_bytes() == tsink.DEFAULT_WRITE_BUFFER * 2
    for _ in range(10):
        t.observe(hot)
    assert tsink.write_buffer_bytes() == tsink._WRITE_TUNE_MAX_BUFFER


def test_write_buffer_knob_pin_and_garbage(monkeypatch):
    t = tsink.write_autotune()
    t.observe(pqt.WriteStats(row_groups=1, sink_flushes=100,
                             bytes_buffered=1))
    assert tsink.write_buffer_bytes() == tsink.DEFAULT_WRITE_BUFFER * 2
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_BUFFER", "4mb")
    assert tsink.write_buffer_bytes() == tsink.DEFAULT_WRITE_BUFFER * 2
    assert pqt.BufferedSink(io.BytesIO())._tunable is True
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_BUFFER", "12345")
    assert tsink.write_buffer_bytes() == 12345
    assert pqt.BufferedSink(io.BytesIO())._tunable is False
    assert pqt.BufferedSink(io.BytesIO(), buffer_bytes=7).buffer_bytes == 7
    monkeypatch.delenv("PARQUET_TPU_TORCH_WRITE_BUFFER")
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_AUTOTUNE", "0")
    assert tsink.write_buffer_bytes() == tsink.DEFAULT_WRITE_BUFFER
    assert pqt.BufferedSink(io.BytesIO())._tunable is False


def test_writer_close_feeds_the_autotuner(tmp_path, monkeypatch):
    """A wide table against a tiny tuned buffer flushes once a chunk:
    ``close`` doubles the next writer's buffer.  A pinned buffer is not
    observed, and no size changes the bytes."""
    wide = {f"c{i:02d}": np.arange(2000, dtype=np.int64) for i in range(12)}
    opts = pqt.WriterOptions(row_group_size=500)
    t = tsink.write_autotune()
    t.buffer = 1024
    pqt.write_table(wide, str(tmp_path / "tuned.parquet"), opts)
    assert t.suggest() == 2048
    t.reset()
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_BUFFER", "1024")
    pqt.write_table(wide, str(tmp_path / "pinned.parquet"), opts)
    assert t.suggest() is None
    assert (tmp_path / "tuned.parquet").read_bytes() == \
        (tmp_path / "pinned.parquet").read_bytes()


# ---------------------------------------------------------------------------
# FaultInjectingSink: the same faults from the same seed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("faults", [
    dict(seed=11, error_rate=0.3), dict(seed=12, error_rate=0.3),
    dict(seed=3, short_write_rate=0.4), dict(enospc_at_byte=20_000),
    dict(crash_at_byte=33_333), dict(crash_at_byte=0),
    dict(seed=5, error_rate=0.1, short_write_rate=0.1,
         enospc_at_byte=50_000)])
def test_fault_injection_draws_as_jax(faults):
    ops = _writes(9)

    def run(pkg):
        inner = io.BytesIO()
        sink = pkg.FaultInjectingSink(inner, **faults)
        raised = []
        for op in ops:
            try:
                if isinstance(op, list):
                    sink.writelines(op)
                else:
                    sink.write(op)
                raised.append(None)
            except Exception as e:
                raised.append((type(e).__name__, getattr(e, "errno", None),
                               str(e)))
        return inner.getvalue(), vars(sink.stats), raised

    assert run(tfaults) == run(jfaults)


def test_a_crashed_sink_cannot_flush_or_commit():
    sink = pqt.FaultInjectingSink(io.BytesIO(), crash_at_byte=2)
    with pytest.raises(pqt.InjectedWriterCrash):
        sink.write(b"PAR1")
    assert sink.stats.crashed and sink.inner.getvalue() == b"PA"
    for call in (lambda: sink.write(b"x"), sink.flush, sink.close):
        with pytest.raises(pqt.InjectedWriterCrash):
            call()
    done = pqt.FaultInjectingSink(io.BytesIO(), crash_at_byte=4)
    done.write(b"PAR1")
    with pytest.raises(pqt.InjectedWriterCrash, match="pre-commit"):
        done.close()  # the crash fell right after the last byte
    assert isinstance(pqt.SinkFaultStats(), tfaults.SinkFaultStats)
