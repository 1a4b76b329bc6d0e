"""The fault layer of parquet_tpu_torch (``io/faults.py``, the located
``ReadError`` hierarchy, ``ParquetFile(policy=)``, the degraded read, and
``policy``/``report`` through the scans, the lookup and ``Dataset``)
against parquet_tpu's, on the CPU.

The files are pyarrow's (gzip, so a flipped byte in a page is a loud
decode error), small and made from a seed with numpy.  For the same file
and the same injected faults the two packages give the same rows and
values, the same ``row_groups_skipped``, ``rows_read``, ``rows_dropped``
and ``files_skipped``, and the same exception class; retry counts are
never compared (the port reads a chunk in one pread where the reference
may take several, so the injector's draws land on other reads).  Retry
tests use ``backoff_s=0``; deadline tests only assert that
``DeadlineError`` is raised.  Every test ends with the threads it
started with (the shared pools are filled once, first).
"""

import io
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.io.faults import FaultInjectingSource as JFaultInjecting
from parquet_tpu.io.source import BytesSource as JBytesSource
from parquet_tpu.parallel import host_scan as jhs

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import (CorruptedError, DeadlineError,
                                      ReadError, ReadIOError, ShortReadError,
                                      _Unsupported)
from parquet_tpu_torch.io import faults as tfaults
from parquet_tpu_torch.io.source import (BytesSource, FileLikeSource,
                                         FileSource, RetryingSource)
from parquet_tpu_torch.parallel import device_reader as tdr
from parquet_tpu_torch.utils import pool as tpool
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = "cpu"
N_ROWS = 10_000
ROW_GROUP = 2_500  # 4 row groups

FAST = pqt.FaultPolicy(max_retries=4, backoff_s=0.0)
SKIP = pqt.FaultPolicy(max_retries=4, backoff_s=0.0,
                       on_corrupt="skip_row_group")
JFAST = parquet_tpu.FaultPolicy(max_retries=4, backoff_s=0.0)
JSKIP = parquet_tpu.FaultPolicy(max_retries=4, backoff_s=0.0,
                                on_corrupt="skip_row_group")


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
    """Every worker of both shared pools started, so that the per-test
    thread count sees only what a test leaves behind."""
    from parquet_tpu.utils import pool as jpool

    for pool, width in ((tpool.shared_pool(), tpool.pool_width()),
                        (jpool.shared_pool(), jpool.pool_width())):
        barrier = threading.Barrier(width + 1)
        futs = [pool.submit(barrier.wait) for _ in range(width)]
        barrier.wait(timeout=30)
        for f in futs:
            f.result(timeout=30)


@pytest.fixture(autouse=True)
def _fresh():
    parquet_tpu.clear_caches()
    pqt.clear_caches()
    pqt.reset_mesh()
    pqt.reset_route_refusals()
    before = threads_now()
    yield
    assert pqt.MESH["staging_bytes"] == 0
    assert_no_thread_started(before)
    parquet_tpu.clear_caches()
    pqt.clear_caches()


def _make_raw(page_index: bool = False) -> bytes:
    t = pa.table({
        "x": pa.array(np.arange(N_ROWS, dtype=np.int64)),
        "s": pa.array([f"v{i % 17}" for i in range(N_ROWS)]),
    })
    buf = io.BytesIO()
    papq.write_table(t, buf, row_group_size=ROW_GROUP, compression="gzip",
                     write_page_index=page_index)
    return buf.getvalue()


@pytest.fixture(scope="module")
def raw() -> bytes:
    return _make_raw()


def _flips(raw, rgs=(1,)):
    """Offsets smashing the first page header of each row group's ``x``
    chunk."""
    meta = papq.ParquetFile(io.BytesIO(raw)).metadata
    out = []
    for i in rgs:
        off = meta.row_group(i).column(0).data_page_offset
        out += [off, off + 1, off + 2]
    return out


def _both_sources(raw, **kw):
    return (tfaults.FaultInjectingSource(BytesSource(raw), **kw),
            JFaultInjecting(JBytesSource(raw), **kw))


def _host(col):
    """A port column on the host: values (strings as a list of bytes)."""
    got = col.materialize_host()
    if isinstance(got, tuple):
        vals, offs = got
        return [vals[offs[i]:offs[i + 1]].tobytes()
                for i in range(len(offs) - 1)]
    return got


def _same_read(got, want) -> None:
    """A port read equals a JAX package read (its ``to_arrow``)."""
    arrow = want.to_arrow()
    assert list(got) == arrow.column_names
    for name, col in got.items():
        ref = arrow.column(name).combine_chunks()
        mine = _host(col)
        if isinstance(mine, list):
            assert mine == [v.encode() for v in ref.to_pylist()], name
        else:
            np.testing.assert_array_equal(mine, ref.to_numpy(), err_msg=name)


def _same_report(got, want) -> None:
    assert got.row_groups_skipped == want.row_groups_skipped
    assert got.rows_read == want.rows_read
    assert got.rows_dropped == want.rows_dropped
    assert got.files_skipped == want.files_skipped
    assert len(got.errors) == len(want.errors)


def _same_error(run_port, run_jax):
    with pytest.raises(Exception) as mine:
        run_port()
    with pytest.raises(Exception) as theirs:
        run_jax()
    assert type(mine.value).__name__ == type(theirs.value).__name__, (
        mine.value, theirs.value)
    return mine.value


# ---------------------------------------------------------------------------
# the policy, the report and the sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [({"on_corrupt": "ignore"},
                                       "on_corrupt"),
                                      ({"max_retries": -1}, "max_retries")])
def test_fault_policy_validates_as_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        pqt.FaultPolicy(**kw)
    with pytest.raises(ValueError, match=match):
        parquet_tpu.FaultPolicy(**kw)


def test_delays_and_report_as_jax():
    pol = pqt.FaultPolicy(max_retries=3, backoff_s=0.5, jitter=0.0)
    jpol = parquet_tpu.FaultPolicy(max_retries=3, backoff_s=0.5, jitter=0.0)
    assert list(pol.delays()) == list(jpol.delays()) == [0.5, 1.0, 2.0]
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    for r in (rep, jrep):
        r.bind("a").bind("b")
        r.record_skip(2, 10, "e1")
        r.record_file_skip("f", 5, "e2")
        r.merge(type(r)(rows_read=3, retries=1, row_groups_skipped=[4]))
    assert rep.as_dict() == jrep.as_dict() and not rep.ok


def test_mix_rng_draws_as_jax():
    from parquet_tpu.io.faults import _mix_rng as jmix

    for key in ((0, 0, 0, 0), (7, 4096, 123, 2), (2 ** 63, 1, 1, 1)):
        assert tfaults._mix_rng(*key).random() == jmix(*key).random()


def test_file_sources_after_close(tmp_path, raw):
    p = tmp_path / "f.parquet"
    p.write_bytes(raw)
    src = FileSource(str(p))
    assert src.pread(0, 4) == b"PAR1"
    src.close()
    src.close()  # idempotent
    with pytest.raises(ValueError, match="closed source"):
        src.pread(0, 4)
    f = io.BytesIO(raw)
    fl = FileLikeSource(f)
    assert fl.pread(0, 4) == b"PAR1" and fl.size() == len(raw)
    fl.close()
    fl.close()
    assert f.closed
    with pytest.raises(ValueError, match="closed source"):
        fl.pread(0, 4)


def test_file_object_reads_as_bytes(raw):
    got = pqt.ParquetFile(io.BytesIO(raw)).read(device=CPU)
    _same_read(got, parquet_tpu.ParquetFile(raw).read())


def test_retrying_source_retries_transients(tmp_path, raw):
    class Flaky(BytesSource):
        def __init__(self, data, fails):
            super().__init__(data)
            self.fails, self.calls = fails, 0

        def pread(self, offset, size):
            self.calls += 1
            if self.fails > 0:
                self.fails -= 1
                raise OSError("transient: connection reset")
            return super().pread(offset, size)

    src = Flaky(raw, fails=2)
    rs = RetryingSource(src, retries=3, backoff_s=0.0)
    assert bytes(rs.pread_view(0, 4)) == b"PAR1" and src.calls == 3
    p = tmp_path / "f.parquet"
    p.write_bytes(raw)
    view = RetryingSource(pqt.MmapSource(str(p)), backoff_s=0.0)
    assert isinstance(view.pread_view(4, 64), np.ndarray)  # zero-copy kept
    with pytest.raises(OSError, match="transient"):
        RetryingSource(Flaky(raw, fails=5), retries=2,
                       backoff_s=0.0).pread(0, 4)
    view.close()


def test_short_read_is_never_retried():
    calls = []

    def short(offset, size):
        calls.append(offset)
        raise ShortReadError(f"short read at {offset}")

    with pytest.raises(ShortReadError):
        tfaults.retry_call(short, 0, 4, FAST)
    assert calls == [0]
    assert isinstance(ShortReadError("x"), (CorruptedError, OSError))


def test_flip_mask_targets_exact_bytes(raw):
    src, jsrc = _both_sources(raw, flip_offsets=[100], flip_mask=0x01)
    want = bytearray(raw[96:112])
    want[4] ^= 0x01
    assert src.pread(96, 16) == jsrc.pread(96, 16) == bytes(want)
    assert src.stats.injected_flips == 1


def test_injector_draws_as_jax(raw):
    """One seed draws the same transient errors for the same reads."""
    src, jsrc = _both_sources(raw, seed=11, error_rate=0.5)
    for off in range(0, 4000, 97):
        outcome = []
        for s in (src, jsrc):
            try:
                s.pread(off, 33)
                outcome.append("ok")
            except OSError:
                outcome.append("err")
        assert outcome[0] == outcome[1], off
    assert src.stats.injected_errors == jsrc.stats.injected_errors > 0


# ---------------------------------------------------------------------------
# transient errors, the located errors, the degraded read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 7])
def test_read_recovers_transient_errors(raw, seed):
    src, jsrc = _both_sources(raw, seed=seed, error_rate=0.3,
                              max_consecutive_errors=2)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.ParquetFile(src, policy=FAST).read(device=CPU, report=rep)
    want = parquet_tpu.ParquetFile(jsrc, policy=JFAST).read(report=jrep)
    _same_read(got, want)
    _same_report(rep, jrep)
    assert got.report is rep and rep.ok and rep.rows_read == N_ROWS
    assert src.stats.injected_errors > 0 and rep.retries > 0


def test_retries_exhausted_raise_readioerror_as_jax(raw):
    def port():
        pqt.ParquetFile(tfaults.FaultInjectingSource(
            BytesSource(raw), seed=1, error_rate=1.0),
            policy=pqt.FaultPolicy(max_retries=2, backoff_s=0.0))

    def jax():
        parquet_tpu.ParquetFile(JFaultInjecting(
            JBytesSource(raw), seed=1, error_rate=1.0),
            policy=parquet_tpu.FaultPolicy(max_retries=2, backoff_s=0.0))

    e = _same_error(port, jax)
    assert isinstance(e, ReadIOError) and isinstance(e, OSError)
    assert "injected transient" in str(e)


def test_corrupt_row_group_raises_located_readerror(tmp_path, raw):
    p = tmp_path / "victim.parquet"
    p.write_bytes(raw)
    e = _same_error(
        lambda: pqt.ParquetFile(tfaults.FaultInjectingSource(
            FileSource(str(p)), flip_offsets=_flips(raw)),
            policy=FAST).read(device=CPU),
        lambda: parquet_tpu.ParquetFile(JFaultInjecting(
            JBytesSource(raw), flip_offsets=_flips(raw)),
            policy=JFAST).read())
    assert isinstance(e, ReadError)
    assert e.row_group == 1 and e.column == "x"
    msg = str(e)
    assert "victim.parquet" in msg and "row-group=1" in msg \
        and "column=x" in msg


def test_corrupt_row_group_is_located_without_policy(raw):
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw))
    e = _same_error(lambda: pqt.ParquetFile(src).read(device=CPU),
                    lambda: parquet_tpu.ParquetFile(jsrc).read())
    assert "row-group=1" in str(e)


@pytest.mark.parametrize("rgs", [(1,), (0, 3), (0, 1, 2, 3)])
def test_skip_row_group_read_matches_jax(raw, rgs):
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw, rgs))
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.ParquetFile(src, policy=SKIP).read(device=CPU, report=rep)
    want = parquet_tpu.ParquetFile(jsrc, policy=JSKIP).read(report=jrep)
    _same_read(got, want)
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == list(rgs)
    assert rep.rows_dropped == ROW_GROUP * len(rgs)
    assert all(f"row-group={i}" in m for i, m in zip(rgs, rep.errors))


def test_skip_mode_runs_on_the_device_where_jax_refuses(raw):
    """The reference refuses ``read(device=True)`` under skip_row_group;
    the port's reads are all its one pipeline, so its read (on the CPU
    here, the card by default) gives the reference's host degraded
    read."""
    with pytest.raises(ValueError, match="skip_row_group.*device"):
        parquet_tpu.ParquetFile(JBytesSource(raw),
                                policy=JSKIP).read(device=True)
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw, (2,)))
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.ParquetFile(src).read(device=CPU, policy=SKIP, report=rep,
                                    columns=["x"], row_groups=[3, 2, 0])
    want = parquet_tpu.ParquetFile(jsrc).read(policy=JSKIP, report=jrep,
                                              columns=["x"],
                                              row_groups=[3, 2, 0])
    _same_read(got, want)
    _same_report(rep, jrep)


def test_report_reused_across_files_accumulates(raw):
    rep = pqt.ReadReport()
    for _ in range(2):
        src = tfaults.FaultInjectingSource(BytesSource(raw),
                                           flip_offsets=_flips(raw))
        pqt.ParquetFile(src, policy=SKIP).read(device=CPU, report=rep)
    assert rep.row_groups_skipped == [1, 1]
    assert rep.rows_dropped == 2 * ROW_GROUP and len(rep.errors) == 2


def test_truncation_and_short_reads_detected_as_jax(tmp_path, raw):
    _same_error(
        lambda: pqt.ParquetFile(tfaults.FaultInjectingSource(
            BytesSource(raw), truncate_at=len(raw) - 64)),
        lambda: parquet_tpu.ParquetFile(JFaultInjecting(
            JBytesSource(raw), truncate_at=len(raw) - 64)))
    cut = papq.ParquetFile(io.BytesIO(raw)).metadata.row_group(1) \
        .column(0).data_page_offset + 10
    path = str(tmp_path / "t.parquet")
    open(path, "wb").write(raw)
    pf = pqt.ParquetFile(path)
    pf.source = pf._base_source = tfaults.FaultInjectingSource(
        FileSource(path), truncate_at=cut)
    with pytest.raises(ReadIOError) as e:
        pf.read(device=CPU)
    assert isinstance(e.value, ShortReadError) and e.value.row_group == 1
    with pytest.raises((CorruptedError, OSError)):
        pqt.ParquetFile(tfaults.FaultInjectingSource(
            BytesSource(raw), seed=2, short_read_rate=1.0)).read(device=CPU)


def test_injector_is_deterministic(raw):
    def run(seed):
        src = tfaults.FaultInjectingSource(BytesSource(raw), seed=seed,
                                           error_rate=0.2,
                                           max_consecutive_errors=2)
        rep = pqt.ReadReport()
        pqt.ParquetFile(src, policy=FAST).read(device=CPU, report=rep)
        return src.stats.injected_errors, rep.retries

    assert run(123) == run(123)
    assert len({run(s)[0] for s in (1, 2, 3, 4, 5)}) > 1


def test_per_call_policy_override(raw):
    src = tfaults.FaultInjectingSource(BytesSource(raw), seed=7,
                                       error_rate=0.2,
                                       max_consecutive_errors=2)
    pf = pqt.ParquetFile(BytesSource(raw))
    pf.source = pf._base_source = src  # opened clean, read through chaos
    rep = pqt.ReadReport()
    got = pf.read(device=CPU, policy=FAST, report=rep)
    _same_read(got, parquet_tpu.ParquetFile(raw).read())
    assert rep.retries > 0 and pf.source is src


def test_overlapping_policy_scopes_restore_the_source(raw):
    """Scopes closed out of order leave ``pf.source`` on a live wrapper,
    then on the open-time source."""
    pf = pqt.ParquetFile(BytesSource(raw))
    base = pf.source
    p1 = pqt.FaultPolicy(max_retries=1, backoff_s=0.0)
    p2 = pqt.FaultPolicy(max_retries=2, backoff_s=0.0)
    s1, s2 = pf._resilient_op(p1, None), pf._resilient_op(p2, None)
    s1.__enter__()
    s2.__enter__()
    pre = pqt.PrefetchSource(pf.source, backend="ring", window_bytes=4096)
    s3 = pf._source_override(pre)
    s3.__enter__()
    s1.__exit__(None, None, None)  # out of order
    assert pf.source is pre
    s3.__exit__(None, None, None)
    pre.close()
    assert pf.source.policy is p2
    assert pf.read(device=CPU)["x"].num_slots == N_ROWS
    s2.__exit__(None, None, None)
    assert pf.source is base


def test_overlapping_operations_keep_their_deadlines(raw):
    pf = pqt.ParquetFile(BytesSource(raw),
                         policy=pqt.FaultPolicy(deadline_s=30.0,
                                                backoff_s=0.0))
    op1 = pf._resilient_op(None, None)
    op1.__enter__()
    op2 = pf._resilient_op(None, None)
    op2.__enter__()
    op1.__exit__(None, None, None)
    assert pf.source._deadline is not None  # op2's clock survives
    op2.__exit__(None, None, None)
    assert pf.source._deadline is None
    assert pf.read(device=CPU)["x"].num_slots == N_ROWS


# ---------------------------------------------------------------------------
# errors that are never corruption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("error", [
    ModuleNotFoundError("No module named 'zstandard'"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    MemoryError()], ids=["import", "oom", "cuda", "memory"])
def test_device_and_environment_errors_are_never_skipped(raw, monkeypatch,
                                                          error):
    """A CUDA error, an out-of-memory card or a missing package raised by
    the decode propagates with its class under skip_row_group: no row
    group is recorded as skipped."""
    def fail(*a, **k):
        raise error

    monkeypatch.setattr(tdr, "decode_staged", fail)
    rep = pqt.ReadReport()
    with pytest.raises(type(error)):
        pqt.ParquetFile(BytesSource(raw), policy=SKIP).read(device=CPU,
                                                            report=rep)
    assert rep.row_groups_skipped == [] and rep.rows_dropped == 0
    assert isinstance(error, tfaults.NON_DATA_ERRORS)


def test_a_refused_chunk_still_takes_the_host_route_under_skip():
    """``_Unsupported`` is never wrapped: the host-route fixture's chunks
    decode on the host under a skip policy as without one."""
    path = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                        "host_route.parquet")
    data = open(path, "rb").read()
    pqt.reset_host_route()
    plain = pqt.ParquetFile(data).read(device=CPU)
    routed = sum(pqt.HOST_ROUTE.values())
    assert routed > 0
    rep = pqt.ReadReport()
    got = pqt.ParquetFile(data, policy=SKIP).read(device=CPU, report=rep)
    assert sum(pqt.HOST_ROUTE.values()) == 2 * routed and rep.ok
    for name in plain:
        assert torch.equal(got[name].values, plain[name].values), name
    with pytest.raises(_Unsupported):
        with tfaults.read_context(path="p", row_group=0):
            raise _Unsupported("k", "a refusal")


def test_failed_open_does_not_leak_fds(tmp_path, raw):
    p = tmp_path / "torn.parquet"
    p.write_bytes(raw[:len(raw) // 2])  # no trailing magic
    before = len(os.listdir("/proc/self/fd"))
    for _ in range(20):
        with pytest.raises(CorruptedError):
            pqt.ParquetFile(str(p))
        with pytest.raises(CorruptedError, match="torn.parquet"):
            pqt.ParquetFile(str(p), policy=FAST)
    assert len(os.listdir("/proc/self/fd")) <= before + 1


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_corrupt", ["raise", "skip_row_group"])
def test_deadline_fires_on_injected_latency(raw, on_corrupt):
    """Latency 0.05 s a pread against a 0.005 s budget: a
    ``DeadlineError`` (a ``TimeoutError``), in skip mode too; afterwards no
    thread is left and a clean read is equal."""
    pol = pqt.FaultPolicy(deadline_s=0.005, backoff_s=0.0,
                          on_corrupt=on_corrupt)
    src = tfaults.FaultInjectingSource(BytesSource(raw), latency_s=0.05)
    with pytest.raises(DeadlineError) as e:
        pqt.ParquetFile(src, policy=pol)  # the footer's preads
    assert isinstance(e.value, TimeoutError)
    pf = pqt.ParquetFile(BytesSource(raw))
    pf.source = pf._base_source = tfaults.FaultInjectingSource(
        BytesSource(raw), latency_s=0.05)
    with pytest.raises(DeadlineError):
        pf.read(device=CPU, policy=pol)
    pf.source = pf._base_source = BytesSource(raw)
    _same_read(pf.read(device=CPU), parquet_tpu.ParquetFile(raw).read())


def test_no_deadline_reads_fine(raw):
    src = tfaults.FaultInjectingSource(BytesSource(raw), latency_s=0.001)
    got = pqt.ParquetFile(src, policy=FAST).read(device=CPU)
    _same_read(got, parquet_tpu.ParquetFile(raw).read())


# ---------------------------------------------------------------------------
# scans, the planner, the lookup
# ---------------------------------------------------------------------------


def _same_scan(got, want) -> None:
    from tests.test_torch_host_scan import _same

    _same(got, want, "scan")


@pytest.mark.parametrize("policy", ["fast", "skip"])
def test_scan_filtered_matches_jax(raw, policy):
    kw = dict(flip_offsets=_flips(raw)) if policy == "skip" else dict(
        seed=5, error_rate=0.3, max_consecutive_errors=2)
    src, jsrc = _both_sources(raw, **kw)
    pol, jpol = (SKIP, JSKIP) if policy == "skip" else (FAST, JFAST)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.scan_filtered(pqt.ParquetFile(src, policy=pol), "x", lo=100,
                            hi=9000, device=CPU, report=rep)
    want = jhs.scan_filtered(parquet_tpu.ParquetFile(jsrc, policy=jpol),
                             "x", lo=100, hi=9000, report=jrep)
    _same_scan(got, want)
    _same_report(rep, jrep)


def test_scan_expr_phase_two_skip_matches_jax(raw):
    """A row group corrupt only in an output column drops in phase 2,
    filter and output rows together."""
    from parquet_tpu.algebra.expr import col as jcol

    from parquet_tpu_torch.algebra.expr import col

    meta = papq.ParquetFile(io.BytesIO(raw)).metadata
    off = meta.row_group(2).column(1).data_page_offset
    flips = [off, off + 1, off + 2]
    src, jsrc = _both_sources(raw, flip_offsets=flips)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.scan_expr(pqt.ParquetFile(src, policy=SKIP),
                        (col("x") >= 10) & (col("x") <= 9989),
                        columns=["s", "x"], device=CPU, report=rep)
    want = jhs.scan_expr(parquet_tpu.ParquetFile(jsrc, policy=JSKIP),
                         (jcol("x") >= 10) & (jcol("x") <= 9989),
                         columns=["s", "x"], report=jrep)
    _same_scan(got, want)
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == [2]


def test_corrupt_column_index_located_and_skippable():
    raw = _make_raw(page_index=True)
    off = pqt.ParquetFile(raw).metadata.row_groups[1].columns[0] \
        .column_index_offset
    bad = bytearray(raw)
    bad[off:off + 8] = b"\xff" * 8  # wire type 15: a thrift error
    bad = bytes(bad)
    e = _same_error(
        lambda: pqt.scan_filtered(pqt.ParquetFile(bad, policy=FAST), "x",
                                  lo=0, hi=N_ROWS, device=CPU),
        lambda: jhs.scan_filtered(parquet_tpu.ParquetFile(bad, policy=JFAST),
                                  "x", lo=0, hi=N_ROWS))
    assert "row-group=1" in str(e)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.scan_filtered(pqt.ParquetFile(bad, policy=SKIP), "x", lo=0,
                            hi=N_ROWS, device=CPU, report=rep)
    want = jhs.scan_filtered(parquet_tpu.ParquetFile(bad, policy=JSKIP), "x",
                             lo=0, hi=N_ROWS, report=jrep)
    _same_scan(got, want)
    _same_report(rep, jrep)
    plan = pqt.ScanPlanner(pqt.ParquetFile(bad), device=CPU, policy=SKIP,
                           report=pqt.ReadReport()).plan(
        pqt.col("x") >= 0)
    assert plan.counters["rg_skipped_corrupt"] == 1


def test_device_scan_skips_at_staging_as_jax(raw):
    from parquet_tpu.ops.device import pairs_to_host

    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw))
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.scan_filtered_device(pqt.ParquetFile(src, policy=SKIP), "x",
                                   lo=0, hi=N_ROWS, columns=["x"],
                                   device=CPU, report=rep)
    want = jhs.scan_filtered_device(parquet_tpu.ParquetFile(
        jsrc, policy=JSKIP), "x", lo=0, hi=N_ROWS, columns=["x"],
        report=jrep)
    np.testing.assert_array_equal(got["x"].numpy(),
                                  pairs_to_host(want["x"], np.int64))
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == [1]
    state = pqt.stage_scan(pqt.ParquetFile(tfaults.FaultInjectingSource(
        BytesSource(raw), flip_offsets=_flips(raw, (0, 2))), policy=SKIP),
        "x", lo=0, columns=["s"], device=CPU)
    assert [p.rg_index for p, _, _ in state["spans"]] == [1, 3]


def test_routed_scan_keeps_the_attempts_skips_once(raw, monkeypatch):
    """Pinned to the device scan, the routed scan's skips are the device
    attempt's, recorded once; when the device scan refuses, the host scan
    records them and only the attempt's retries carry over."""
    from parquet_tpu_torch.parallel import host_scan as ths

    monkeypatch.setenv("PARQUET_TPU_TORCH_ROUTE", "device")
    src = tfaults.FaultInjectingSource(BytesSource(raw),
                                       flip_offsets=_flips(raw))
    rep = pqt.ReadReport()
    got = pqt.scan(pqt.ParquetFile(src, policy=SKIP), "x", lo=0,
                   hi=N_ROWS, columns=["x"], device=CPU, report=rep)
    assert len(got["x"]) == N_ROWS - ROW_GROUP
    assert rep.row_groups_skipped == [1]

    def refuse(*a, report=None, **k):
        report.record_skip(7, 1, "scratch")
        report.retries += 2
        raise ValueError("a shape; use the host scan")

    monkeypatch.setattr(ths, "scan_filtered_device", refuse)
    rep = pqt.ReadReport()
    got = pqt.scan(pqt.ParquetFile(src, policy=SKIP), "x", lo=0, hi=N_ROWS,
                   columns=["x"], device=CPU, report=rep)
    assert rep.row_groups_skipped == [1] and rep.retries >= 2
    np.testing.assert_array_equal(
        got["x"], np.r_[0:ROW_GROUP, 2 * ROW_GROUP:N_ROWS])


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_find_rows_matches_jax(raw, policy):
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw))
    keys = [5, 2600, 4999, 7000, -1]
    if policy == "raise":
        e = _same_error(
            lambda: pqt.ParquetFile(src).find_rows(
                "x", keys, columns=["s"], device=CPU, policy=FAST),
            lambda: parquet_tpu.ParquetFile(jsrc).find_rows(
                "x", keys, columns=["s"], policy=JFAST))
        assert "row-group=1" in str(e)
        return
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.ParquetFile(src, policy=SKIP).find_rows(
        "x", keys, columns=["s"], device=CPU, report=rep)
    want = parquet_tpu.ParquetFile(jsrc, policy=JSKIP).find_rows(
        "x", keys, columns=["s"], report=jrep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rows, w.rows)
        assert g.values["s"] == w.values["s"]
    assert got.report is rep
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == [1] and rep.rows_dropped == ROW_GROUP
    assert got[1].num_rows == 0  # 2600 lay in the dropped row group


def test_a_corrupt_bloom_filter_drops_its_row_group(tmp_path):
    """The lookup's and the scan planner's bloom stage read a corrupt
    filter as a data error of its row group (the JAX package raises its
    bare thrift error there, ROADMAP queue C)."""
    path = str(tmp_path / "b.parquet")
    pqt.write_table({"k": np.arange(4000, dtype=np.int64) * 3,
                     "v": np.arange(4000, dtype=np.float64)}, path,
                    pqt.WriterOptions(row_group_size=1000,
                                      bloom_filters={"k": 10}))
    meta = pqt.ParquetFile(path).metadata
    off = meta.row_groups[2].columns[0].meta_data.bloom_filter_offset
    src = tfaults.FaultInjectingSource(FileSource(path),
                                       flip_offsets=[off, off + 1, off + 2])
    rep = pqt.ReadReport()
    got = pqt.ParquetFile(src, policy=SKIP).find_rows(
        "k", [3, 6003, 9000], columns=["v"], device=CPU, report=rep)
    assert rep.row_groups_skipped == [2]
    assert [h.num_rows for h in got] == [1, 0, 1]
    rep = pqt.ReadReport()
    pqt.scan_filtered(pqt.ParquetFile(src, policy=SKIP), "k",
                      values=[3, 6003], device=CPU, report=rep)
    assert rep.row_groups_skipped == [2]


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


def _parts(root, n=4, rows=1200):
    paths = []
    for i in range(n):
        t = pa.table({"x": pa.array(np.arange(i * rows, (i + 1) * rows,
                                              dtype=np.int64)),
                      "s": pa.array([f"p{i}-{j % 11}" for j in range(rows)])})
        p = os.path.join(root, f"part-{i}.parquet")
        papq.write_table(t, p, row_group_size=400, compression="gzip")
        paths.append(p)
    return paths


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])


@pytest.mark.parametrize("devices", ["cpu", "cpu4"])
def test_dataset_read_drops_an_unreadable_file_as_jax(tmp_path, devices):
    paths = _parts(str(tmp_path))
    _truncate(paths[2])
    mesh = [torch.device(CPU)] * (4 if devices == "cpu4" else 1)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.Dataset(paths).read(device=mesh, policy=SKIP, report=rep)
    want = parquet_tpu.Dataset(paths).read(policy=JSKIP, report=jrep)
    _same_read(got, want)
    _same_report(rep, jrep)
    assert rep.files_skipped == [paths[2]] and got.report is rep
    with pytest.raises(CorruptedError):
        pqt.Dataset(paths).read(device=mesh, policy=FAST)


def test_dataset_read_skips_a_corrupt_row_group_as_jax(tmp_path):
    paths = _parts(str(tmp_path))
    raw = bytearray(open(paths[1], "rb").read())
    for o in _flips(bytes(raw), (2,)):
        raw[o] ^= 0xFF
    open(paths[1], "wb").write(bytes(raw))
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.Dataset(paths, policy=SKIP).read(device=CPU, report=rep)
    want = parquet_tpu.Dataset(paths, policy=JSKIP).read(report=jrep)
    _same_read(got, want)
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == [2] and pqt.ROUTE_REFUSALS["error"] == 1


def test_dataset_scan_prune_find_rows_as_jax(tmp_path):
    paths = _parts(str(tmp_path))
    _truncate(paths[1])
    port, ref = pqt.Dataset(paths), parquet_tpu.Dataset(paths)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    assert port.prune("x", lo=500, policy=SKIP, report=rep) == \
        ref.prune("x", lo=500, policy=JSKIP, report=jrep)
    _same_report(rep, jrep)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    _same_scan(port.scan("x", lo=500, hi=4000, device=CPU, policy=SKIP,
                         report=rep),
               ref.scan("x", lo=500, hi=4000, policy=JSKIP, report=jrep))
    _same_report(rep, jrep)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    keys = [3, 1300, 2500, 4000]
    got = port.find_rows("x", keys, columns=["s"], device=CPU, policy=SKIP,
                         report=rep)
    want = ref.find_rows("x", keys, columns=["s"], policy=JSKIP,
                         report=jrep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rows, w.rows)
        assert g.values["s"] == w.values["s"]
    _same_report(rep, jrep)
    assert rep.files_skipped == [paths[1]]
    _same_error(lambda: port.scan("x", lo=0, device=CPU, policy=FAST),
                lambda: ref.scan("x", lo=0, policy=JFAST))


def test_scan_files_skip_files_as_jax(tmp_path):
    paths = _parts(str(tmp_path), n=3)
    pfs = [pqt.ParquetFile(p) for p in paths]
    jpfs = [parquet_tpu.ParquetFile(p) for p in paths]
    # file 1 opened whole, then torn before the scan reads it
    pfs[1].source = pfs[1]._base_source = tfaults.FaultInjectingSource(
        pfs[1].source, truncate_at=100)
    jpfs[1].source = jpfs[1]._base_source = JFaultInjecting(
        jpfs[1].source, truncate_at=100)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = pqt.scan_files(pfs, "x", lo=10, devices=[CPU], report=rep,
                         skip_files=True)
    want = jhs.scan_files(jpfs, "x", lo=10, report=jrep, skip_files=True)
    _same_scan(got, want)
    _same_report(rep, jrep)
    assert rep.rows_dropped == 1200


# ---------------------------------------------------------------------------
# cache identity
# ---------------------------------------------------------------------------


def test_injected_bytes_never_fill_or_hit_the_caches(tmp_path, raw):
    """A file opened through a FaultInjectingSource neither fills nor is
    served from the footer and page caches (its key is fixed at open from
    the innermost source, None for a wrapper); a path opened with a
    policy still uses them."""
    raw = _make_raw(page_index=True)  # the lookup reads single pages
    p = str(tmp_path / "c.parquet")
    open(p, "wb").write(raw)
    src = tfaults.FaultInjectingSource(FileSource(p))
    pf = pqt.ParquetFile(src, policy=FAST)
    assert pf._cache_key is None
    pf.find_rows("x", [5, 7000], columns=["s"], device=CPU)
    assert pqt.cache_stats().footer_entries == 0
    assert pqt.cache_stats().page_entries == 0
    pol = pqt.ParquetFile(p, policy=FAST)
    key = pol._cache_key
    assert key is not None and pqt.cache_stats().footer_entries == 1
    with pol._source_override(pqt.PrefetchSource(pol.source,
                                                 backend="ring")):
        assert pol._cache_key == key
    pol.find_rows("x", [5, 7000], columns=["s"], device=CPU)
    assert pqt.cache_stats().page_entries > 0
    again = pqt.ParquetFile(tfaults.FaultInjectingSource(
        FileSource(p), flip_offsets=_flips(raw)), policy=SKIP)
    rep = pqt.ReadReport()
    got = again.find_rows("x", [5, 2600], device=CPU, report=rep)
    assert rep.row_groups_skipped == [1] and got[1].num_rows == 0


@pytest.mark.parametrize("codec", ["uncompressed", "snappy", "zstd"])
def test_random_flips_are_located_or_skipped(codec):
    """Bytes flipped at random places of the pages (the C++ planner's
    headers, lengths, level and delta streams, compressed blocks): a read
    under ``raise`` either succeeds or raises a ``ReadError`` naming its
    row group, never another exception; under ``skip_row_group`` it
    never raises, and some flips do drop a row group."""
    from parquet_tpu_torch.format.enums import Encoding

    rng = np.random.default_rng(1)
    n = 8000
    table = {"id": np.arange(n, dtype=np.int64),
             "k": rng.integers(0, 200, n).astype(np.int64),
             "cat": np.ma.masked_array(rng.integers(0, 50, n).astype(
                 np.int32), mask=rng.random(n) < 0.1),
             "ts": np.cumsum(rng.integers(0, 1000, n)).astype(np.int64),
             "s": np.array([b"v%d" % (i % 37) for i in range(n)], object)}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=2000, data_page_size=4096, compression=codec,
        column_encoding={"id": Encoding.PLAIN,
                         "k": Encoding.RLE_DICTIONARY,
                         "cat": Encoding.RLE_DICTIONARY,
                         "ts": Encoding.DELTA_BINARY_PACKED}))
    raw = buf.getvalue()
    pages_end = min(c.meta_data.data_page_offset
                    for c in pqt.ParquetFile(raw).metadata.row_groups[-1]
                    .columns) + 1000
    skipped = 0
    for seed in range(24):
        r = np.random.default_rng(seed)
        kw = dict(flip_offsets=[int(o) for o in r.integers(4, pages_end, 3)],
                  flip_mask=int(r.integers(1, 256)))
        try:
            pqt.ParquetFile(tfaults.FaultInjectingSource(
                BytesSource(raw), **kw)).read(device=CPU)
        except ReadError as e:
            assert e.row_group is not None, e
        rep = pqt.ReadReport()
        pqt.ParquetFile(tfaults.FaultInjectingSource(BytesSource(raw), **kw),
                        policy=SKIP).read(device=CPU, report=rep)
        skipped += len(rep.row_groups_skipped)
    assert skipped > 0


# ---------------------------------------------------------------------------
# streamed drains (io/stream.py) under the policy, and page CRCs
# ---------------------------------------------------------------------------


def _drained(batches) -> dict:
    """A port drain's batches concatenated by column."""
    from parquet_tpu_torch.io.column import concat_columns

    batches = list(batches)
    return {p: concat_columns([b[p] for b in batches]) for p in batches[0]}


def _jax_drained(batches):
    return _JaxTable(pa.concat_tables(b.to_arrow() for b in batches))


class _JaxTable:
    """A concatenated JAX drain in the form ``_same_read`` takes."""

    def __init__(self, table):
        self._t = table

    def to_arrow(self):
        return self._t


def test_iter_batches_recovers_transient_errors_as_jax(raw):
    src, jsrc = _both_sources(raw, seed=3, error_rate=0.2,
                              max_consecutive_errors=2)
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = _drained(pqt.ParquetFile(src, policy=FAST).iter_batches(
        batch_rows=1000, device=CPU, report=rep))
    want = _jax_drained(parquet_tpu.iter_batches(
        parquet_tpu.ParquetFile(jsrc, policy=JFAST), batch_rows=1000,
        report=jrep))
    _same_read(got, want)
    _same_read(got, parquet_tpu.ParquetFile(raw).read())
    assert src.stats.injected_errors > 0
    assert rep.rows_read == jrep.rows_read == N_ROWS and rep.ok


@pytest.mark.parametrize("rgs", [(1,), (0, 3)])
def test_skip_row_group_stream_matches_jax(raw, rgs):
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw, rgs))
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got = _drained(pqt.ParquetFile(src, policy=SKIP).iter_batches(
        batch_rows=1000, device=CPU, report=rep))
    want = _jax_drained(parquet_tpu.iter_batches(
        parquet_tpu.ParquetFile(jsrc, policy=JSKIP), batch_rows=1000,
        report=jrep))
    _same_read(got, want)
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == list(rgs)
    assert rep.rows_dropped == ROW_GROUP * len(rgs)


def test_stream_corrupt_row_group_raises_located(raw):
    src, jsrc = _both_sources(raw, flip_offsets=_flips(raw))
    e = _same_error(
        lambda: list(pqt.ParquetFile(src, policy=FAST).iter_batches(
            batch_rows=1000, device=CPU)),
        lambda: list(parquet_tpu.iter_batches(
            parquet_tpu.ParquetFile(jsrc, policy=JFAST), batch_rows=1000)))
    assert "row-group=1" in str(e) and "column=x" in str(e)


class _TestClock:
    """The ``time`` module as ``io/faults.py`` sees it, with a monotonic
    clock that stands still until the test advances it: a deadline then
    runs out where the test says, whatever the host's load."""

    def __init__(self):
        import time

        self._time = time
        self.now = time.monotonic()

    def monotonic(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def __getattr__(self, name):
        return getattr(self._time, name)


def test_paused_stream_deadline_does_not_poison_other_ops(raw, monkeypatch):
    """A paused drain keeps its own deadline: a read meanwhile runs on its
    own clock, and the resumed drain hits its deadline.  Every
    ``Deadline`` reads the clock of ``io/faults.py``, which the test
    drives, so the read's fresh budget cannot run out under load."""
    clock = _TestClock()
    monkeypatch.setattr(tfaults, "time", clock)
    pf = pqt.ParquetFile(BytesSource(raw), policy=pqt.FaultPolicy(
        deadline_s=0.05, backoff_s=0.0))
    before = tfaults.active_deadline()
    it = pf.iter_batches(batch_rows=1000, device=CPU)
    next(it)
    # the drain's clock stays in the drain's own context
    assert tfaults.active_deadline() is before
    clock.advance(0.08)  # the drain's budget runs out while it is paused
    assert pf.read(device=CPU)["x"].num_slots == N_ROWS
    with pytest.raises(DeadlineError):
        for _ in it:
            pass


def test_interleaved_policy_overrides_restore_source(raw):
    pf = pqt.ParquetFile(BytesSource(raw))
    base = pf.source
    p1 = pqt.FaultPolicy(max_retries=1, backoff_s=0.0)
    p2 = pqt.FaultPolicy(max_retries=2, backoff_s=0.0)
    g1 = pf.iter_batches(batch_rows=1000, device=CPU, policy=p1)
    g2 = pf.iter_batches(batch_rows=1000, device=CPU, policy=p2)
    next(g1)
    next(g2)
    g1.close()  # out of order: g2's wrapper stays installed
    assert getattr(pf.source, "policy", None) is p2
    assert sum(b["x"].num_slots for b in g2) > 0
    assert pf.source is base


def test_interleaved_drains_keep_their_deadlines(raw):
    pf = pqt.ParquetFile(BytesSource(raw), policy=pqt.FaultPolicy(
        deadline_s=30.0, backoff_s=0.0))
    g1 = pf.iter_batches(batch_rows=1000, device=CPU)
    next(g1)
    g2 = pf.iter_batches(batch_rows=1000, device=CPU)
    next(g2)
    g1.close()
    assert pf.source._deadline is not None  # g2's budget survives
    g2.close()
    assert pf.source._deadline is None
    assert pf.read(device=CPU)["x"].num_slots == N_ROWS


def test_stream_deadline_fires_on_injected_latency(raw):
    src = tfaults.FaultInjectingSource(BytesSource(raw), latency_s=0.02)
    pf = pqt.ParquetFile(BytesSource(raw))
    pf.source = pf._base_source = src
    with pytest.raises(DeadlineError):
        for _ in pf.iter_batches(batch_rows=1000, device=CPU,
                                 policy=pqt.FaultPolicy(deadline_s=0.05,
                                                        backoff_s=0.0)):
            pass
    assert pf.source is src


CRC_RG = 2


@pytest.fixture(scope="module")
def crc_raw() -> bytes:
    """The port's writer (page CRCs on): PLAIN int64 and a dictionary
    string, UNCOMPRESSED, so a flipped payload byte decodes silently
    unless the CRC is checked."""
    rng = np.random.default_rng(4)
    buf = io.BytesIO()
    pqt.write_table({"x": np.arange(N_ROWS, dtype=np.int64),
                     "v": rng.random(N_ROWS)}, buf,
                    pqt.WriterOptions(row_group_size=ROW_GROUP,
                                      dictionary=False,
                                      compression="uncompressed"))
    return buf.getvalue()


def _payload_flip(raw) -> int:
    """A byte in the middle of row group 2's ``x`` data page."""
    chunk = pqt.ParquetFile(raw).row_group(CRC_RG).column(0)
    start, size = chunk.byte_range
    return start + size // 2


@pytest.mark.parametrize("policy", ["raise", "skip"])
@pytest.mark.parametrize("how", ["read", "drain"])
def test_verify_crc_catches_a_flip_as_jax(crc_raw, how, policy):
    from parquet_tpu.io.reader import ReadOptions as JReadOptions

    flips = [_payload_flip(crc_raw)]
    src, jsrc = _both_sources(crc_raw, flip_offsets=flips)
    # unchecked, the flip is a wrong value, not an error
    quiet = pqt.ParquetFile(src).read(device=CPU)["x"].values.numpy()
    assert (quiet != np.arange(N_ROWS)).sum() == 1
    opts = pqt.ReadOptions(verify_crc=True)
    jopts = JReadOptions(verify_crc=True)
    pf = pqt.ParquetFile(src, options=opts,
                         policy=SKIP if policy == "skip" else FAST)
    jpf = parquet_tpu.ParquetFile(jsrc, options=jopts,
                                  policy=JSKIP if policy == "skip"
                                  else JFAST)

    def port(report=None):
        if how == "read":
            return pf.read(device=CPU, report=report)
        return _drained(pf.iter_batches(batch_rows=1000, device=CPU,
                                        report=report))

    def jax(report=None):
        if how == "read":
            return jpf.read(device=False, report=report)
        return _jax_drained(parquet_tpu.iter_batches(
            jpf, batch_rows=1000, report=report))

    if policy == "raise":
        e = _same_error(port, jax)
        assert "page CRC mismatch at offset" in str(e)
        assert f"row-group={CRC_RG}" in str(e) and "page-offset=" in str(e)
        return
    rep, jrep = pqt.ReadReport(), parquet_tpu.ReadReport()
    got, want = port(rep), jax(jrep)
    _same_read(got, want)
    _same_report(rep, jrep)
    assert rep.row_groups_skipped == [CRC_RG]
    assert "page CRC mismatch" in rep.errors[0]


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_verify_crc_in_find_rows(crc_raw, policy):
    flips = [_payload_flip(crc_raw)]
    src = tfaults.FaultInjectingSource(BytesSource(crc_raw),
                                       flip_offsets=flips)
    keys = [5, CRC_RG * ROW_GROUP + 7, 9000]
    pf = pqt.ParquetFile(src, options=pqt.ReadOptions(verify_crc=True))
    if policy == "raise":
        with pytest.raises(CorruptedError, match="page CRC mismatch"):
            pf.find_rows("x", keys, columns=["v"], device=CPU)
        return
    rep = pqt.ReadReport()
    got = pf.find_rows("x", keys, columns=["v"], device=CPU, policy=SKIP,
                       report=rep)
    assert [h.num_rows for h in got] == [1, 0, 1]
    assert rep.row_groups_skipped == [CRC_RG]


def test_verify_crc_clean_file_reads_equal(crc_raw):
    on = pqt.ParquetFile(crc_raw, options=pqt.ReadOptions(verify_crc=True))
    got = on.read(device=CPU)
    np.testing.assert_array_equal(got["x"].values.numpy(),
                                  np.arange(N_ROWS))
    drained = _drained(on.iter_batches(batch_rows=777, device=CPU))
    np.testing.assert_array_equal(drained["v"].values.numpy(),
                                  got["v"].values.numpy())
    assert on.options.verify_crc and not pqt.ParquetFile(
        crc_raw).options.verify_crc
