"""parquet_tpu_torch's crash-safe writes against the JAX package's
``tests/test_writer_faults.py`` matrix: the atomic commit, abort on an
exception, the write-side fault injector and the crash matrix
(``crash_consistency_check``, buffered and not, with the overlap off,
auto and forced).  Whatever fault stops a write, the
destination is afterwards absent, or whole and clean in both packages'
``verify_file``; no temp file is left once the sink is aborted; no
thread is left."""

import dataclasses
import errno
import io
import os

import numpy as np
import pytest

import parquet_tpu

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import writer as twriter
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

N_ROWS = 6000
RG = 2000  # 3 row groups


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PARQUET_TPU_TORCH_WRITE_OVERLAP",
              "PARQUET_TPU_TORCH_WRITE_BUFFER"):
        monkeypatch.delenv(k, raising=False)
    before = threads_now()
    yield
    assert_no_thread_started(before)


@pytest.fixture(scope="module")
def table():
    return {"x": np.arange(N_ROWS, dtype=np.int64),
            "s": np.array([f"v{i % 23}" for i in range(N_ROWS)],
                          dtype=object)}


@pytest.fixture(scope="module")
def schema(table):
    return twriter.schema_of(table)


def _cols(table, r0=0, r1=N_ROWS):
    return {"x": pqt.ColumnData(values=table["x"][r0:r1]),
            "s": twriter._column_data(table["s"][r0:r1])}


def _no_temps(d) -> bool:
    return not [f for f in os.listdir(d) if f.endswith(".tmp")]


def _clean_in_both(path) -> None:
    rep = pqt.verify_file(str(path))
    assert rep.ok, rep.summary()
    assert parquet_tpu.verify_file(str(path)).ok


# ---------------------------------------------------------------------------
# the atomic commit
# ---------------------------------------------------------------------------
def test_atomic_write_round_trips_and_verifies(tmp_path, table):
    dest = tmp_path / "a.parquet"
    w = pqt.write_table(table, str(dest),
                        pqt.WriterOptions(row_group_size=RG))
    assert _no_temps(tmp_path)
    got = pqt.ParquetFile(str(dest)).read(device="cpu")
    assert (got["x"].values.numpy() == table["x"]).all()
    rep = pqt.verify_file(str(dest))
    assert rep.ok and rep.crcs_checked > 0, rep.summary()
    assert w.write_stats.bytes_flushed == os.path.getsize(dest)
    _clean_in_both(dest)


def test_the_destination_appears_only_at_close(tmp_path, table, schema):
    dest = tmp_path / "late.parquet"
    w = pqt.ParquetWriter(str(dest), schema)
    w.write_row_group(_cols(table), N_ROWS)
    w.flush()
    assert not dest.exists() and len(os.listdir(tmp_path)) == 1
    w.close()
    assert dest.exists() and _no_temps(tmp_path)


def test_pathlike_sink_and_caller_file_object(tmp_path, table):
    dest = tmp_path / "p.parquet"  # a PathLike, not a str
    pqt.write_table(table, dest)
    assert pqt.verify_file(dest).ok
    with open(dest, "rb") as f:
        assert pqt.verify_file(f).ok
        f.seek(0)
        assert f.read(4) == b"PAR1"  # the caller's handle stays open


@pytest.mark.parametrize("fsync", [True, False])
def test_atomic_commit_opt_out_still_cleans_on_abort(tmp_path, table, schema,
                                                     fsync):
    dest = tmp_path / "direct.parquet"
    opts = pqt.WriterOptions(atomic_commit=False, fsync=fsync,
                             row_group_size=RG)
    with pytest.raises(RuntimeError):
        with pqt.ParquetWriter(str(dest), schema, opts) as w:
            w.write_row_group(_cols(table), N_ROWS)
            w.flush()
            assert dest.exists()  # written in place
            raise RuntimeError("boom")
    assert not dest.exists()
    pqt.write_table(table, str(dest), opts)
    _clean_in_both(dest)


def test_exit_aborts_on_exception(tmp_path, table, schema):
    dest = tmp_path / "b.parquet"
    with pytest.raises(RuntimeError):
        with pqt.ParquetWriter(str(dest), schema) as w:
            w.write_row_group(_cols(table), N_ROWS)
            raise RuntimeError("mid-write failure")
    assert not dest.exists() and _no_temps(tmp_path)


def test_abort_is_idempotent_and_blocks_close(tmp_path, schema):
    w = pqt.ParquetWriter(str(tmp_path / "c.parquet"), schema)
    w.abort()
    w.abort()
    with pytest.raises(ValueError, match="aborted"):
        w.close()
    assert os.listdir(tmp_path) == []


def test_write_after_close_raises(tmp_path, table, schema):
    dest = tmp_path / "d.parquet"
    w = pqt.ParquetWriter(str(dest), schema)
    w.write_row_group(_cols(table), N_ROWS)
    w.close()
    for call in (lambda: w.write_row_group(_cols(table), N_ROWS),
                 lambda: w.write(_cols(table), N_ROWS), w.flush):
        with pytest.raises(ValueError, match="closed"):
            call()
    w.close()  # close after close stays a no-op
    _clean_in_both(dest)


def test_magic_write_failure_leaks_no_temp(tmp_path, schema, monkeypatch):
    def boom(self, data):
        raise OSError(errno.EIO, "disk gone at open")

    monkeypatch.setattr(pqt.AtomicFileSink, "write", boom)
    with pytest.raises(OSError):
        pqt.ParquetWriter(str(tmp_path / "e.parquet"), schema)
    assert os.listdir(tmp_path) == []


def test_commit_failure_aborts_and_raises_write_error(tmp_path, table,
                                                      schema, monkeypatch):
    dest = tmp_path / "f.parquet"
    w = pqt.ParquetWriter(str(dest), schema)
    w.write_row_group(_cols(table), N_ROWS)

    def no_replace(src, dst):
        raise OSError(errno.EACCES, "rename denied")

    monkeypatch.setattr(os, "replace", no_replace)
    with pytest.raises(pqt.WriteError) as ei:
        w.close()
    assert ei.value.path == str(dest)
    assert not w._closed
    monkeypatch.undo()
    assert not dest.exists() and _no_temps(tmp_path)
    with pytest.raises(ValueError, match="aborted"):
        w.close()


def test_a_torn_footer_commits_nothing(tmp_path, table, schema):
    probe = pqt.FaultInjectingSink(io.BytesIO())
    with pqt.ParquetWriter(probe, schema) as w:
        w.write_row_group(_cols(table), N_ROWS)
    total = probe.stats.bytes_written
    dest = tmp_path / "g.parquet"
    sink = pqt.FaultInjectingSink(pqt.AtomicFileSink(str(dest)),
                                  enospc_at_byte=total - 30)
    w = pqt.ParquetWriter(sink, schema)
    w.write_row_group(_cols(table), N_ROWS)
    with pytest.raises(OSError):
        w.close()
    assert not w._closed
    sink.abort()  # the caller owns a sink it handed over
    assert not dest.exists() and _no_temps(tmp_path)


@dataclasses.dataclass
class _Rec:
    x: int


def test_typed_writer_exit_and_close_failure_abort(tmp_path, monkeypatch):
    dest = tmp_path / "typed.parquet"
    with pytest.raises(RuntimeError):
        with pqt.TypedWriter(str(dest), _Rec) as tw:
            tw.write([_Rec(x=i) for i in range(100)])
            raise RuntimeError("boom")
    assert not dest.exists() and _no_temps(tmp_path)
    tw = pqt.TypedWriter(str(dest), _Rec)
    tw.write([_Rec(x=i) for i in range(10)])

    def boom(self, columns, num_rows):
        raise OSError(errno.ENOSPC, "disk full during close-time drain")

    monkeypatch.setattr(pqt.ParquetWriter, "write_row_group", boom)
    with pytest.raises(OSError):
        tw.close()
    assert not dest.exists() and _no_temps(tmp_path)


def test_intentional_abort_inside_the_block_exits_cleanly(tmp_path, table,
                                                          schema):
    dest = tmp_path / "k.parquet"
    with pqt.ParquetWriter(str(dest), schema) as w:
        w.write(_cols(table), N_ROWS)
        w.abort()
    assert not dest.exists() and _no_temps(tmp_path)
    with pqt.TypedWriter(str(tmp_path / "l.parquet"), _Rec) as tw:
        tw.write([_Rec(x=1)])
        tw.abort()
    assert os.listdir(tmp_path) == []


def test_abort_unlink_failure_does_not_mask_the_error(tmp_path, table,
                                                      schema, monkeypatch):
    def no_unlink(p):
        raise OSError(errno.EACCES, "stale NFS handle")

    with pytest.raises(RuntimeError, match="original"):
        with pqt.ParquetWriter(str(tmp_path / "n.parquet"), schema) as w:
            w.write(_cols(table), N_ROWS)
            monkeypatch.setattr(os, "unlink", no_unlink)
            raise RuntimeError("original failure")
    monkeypatch.undo()


def test_write_table_failure_aborts_the_path(tmp_path, table):
    from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.schema import schema as S

    dest = tmp_path / "j.parquet"
    bogus = S.message("m", [S.leaf("missing", Type.INT64, Rep.OPTIONAL)])
    with pytest.raises(KeyError):
        pqt.write_table(table, str(dest), schema=bogus)
    short = {"x": pqt.ColumnData(values=np.arange(5, dtype=np.int64),
                                 validity=np.ones(6, bool))}
    opt = S.message("m", [S.leaf("x", Type.INT64, Rep.OPTIONAL)])
    with pytest.raises(ValueError, match="values"):
        pqt.write_table(short, str(dest), schema=opt)
    assert os.listdir(tmp_path) == []


def test_sorting_spills_skip_the_atomic_commit(tmp_path, table, schema):
    dest = tmp_path / "sorted.parquet"
    sw = pqt.SortingWriter(str(dest), schema,
                           [pqt.SortingColumn("x", descending=True)],
                           buffer_rows=1500, device="cpu")
    sw.write(_cols(table), N_ROWS)
    assert sw.spills and all(
        not [f for f in os.listdir(os.path.dirname(p)) if f.endswith(".tmp")]
        for p in sw.spills)
    sw.close()
    _clean_in_both(dest)
    assert _no_temps(tmp_path)
    got = pqt.ParquetFile(str(dest)).read(device="cpu")["x"].values.numpy()
    assert (got == np.arange(N_ROWS, dtype=np.int64)[::-1]).all()


# ---------------------------------------------------------------------------
# the fault injector under the writer
# ---------------------------------------------------------------------------
def test_enospc_in_a_row_group(tmp_path, table, schema):
    dest = tmp_path / "enospc.parquet"
    sink = pqt.FaultInjectingSink(pqt.AtomicFileSink(str(dest)),
                                  enospc_at_byte=4096)
    with pytest.raises(OSError) as ei:
        with pqt.ParquetWriter(sink, schema,
                               pqt.WriterOptions(row_group_size=RG)) as w:
            w.write_row_group(_cols(table), N_ROWS)
    assert ei.value.errno == errno.ENOSPC
    assert sink.stats.bytes_written <= 4096
    sink.abort()
    assert not dest.exists() and _no_temps(tmp_path)


def test_short_write_surfaces(table, schema):
    sink = pqt.FaultInjectingSink(io.BytesIO(), seed=3, short_write_rate=1.0)
    with pytest.raises(OSError, match="short write"):
        with pqt.ParquetWriter(sink, schema) as w:
            w.write_row_group(_cols(table), N_ROWS)
    assert sink.stats.injected_short_writes == 1


def test_injection_is_deterministic(table, schema):
    def run(seed):
        sink = pqt.FaultInjectingSink(io.BytesIO(), seed=seed,
                                      error_rate=0.3)
        try:
            with pqt.ParquetWriter(sink, schema) as w:
                w.write_row_group(_cols(table), N_ROWS)
        except OSError:
            pass
        return vars(sink.stats), sink.inner.getvalue()

    assert run(11) == run(11)
    assert run(11) != run(12)


def test_a_crash_strands_the_temp_but_not_the_destination(tmp_path, table,
                                                          schema):
    dest = tmp_path / "crash.parquet"
    sink = pqt.FaultInjectingSink(pqt.AtomicFileSink(str(dest)),
                                  crash_at_byte=1000)
    with pytest.raises(pqt.InjectedWriterCrash):
        w = pqt.ParquetWriter(sink, schema)
        w.write_row_group(_cols(table), N_ROWS)
    assert not dest.exists()
    assert os.path.exists(sink.inner.temp_path)
    sink.abort()  # the restarted process's sweep
    assert _no_temps(tmp_path)


# ---------------------------------------------------------------------------
# the crash matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("overlap", ["0", "auto", "force"])
@pytest.mark.parametrize("buffered", [False, True],
                         ids=["unbuffered", "buffered"])
def test_crash_consistency_matrix(tmp_path, table, monkeypatch, buffered,
                                  overlap):
    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", overlap)
    dest = str(tmp_path / "matrix.parquet")
    opts = pqt.WriterOptions(row_group_size=RG, bloom_filters={"s": 10})
    results = pqt.crash_consistency_check(
        lambda sink: pqt.write_table(table, sink, opts), dest, samples=10,
        seed=42, buffered=buffered)
    assert len(results) == 11
    assert [r["outcome"] for r in results[:-1]] == ["absent"] * 10
    assert results[-1] == {"offset": None, "outcome": "clean"}
    assert _no_temps(tmp_path)
    rep = pqt.verify_file(dest, decode=True, device="cpu")
    assert rep.ok and rep.chunks_decoded == 6, rep.summary()
    assert parquet_tpu.verify_file(dest, decode=True).ok


def test_crash_matrix_at_given_offsets_and_refusals(tmp_path, table):
    dest = tmp_path / "given.parquet"
    results = pqt.crash_consistency_check(
        lambda sink: pqt.write_table(table, sink), str(dest),
        offsets=[1, 4, 5, 1000])
    assert [r["offset"] for r in results] == [1, 4, 5, 1000, None]
    with pytest.raises(FileExistsError):
        pqt.crash_consistency_check(lambda sink: None, str(dest))
    d2 = tmp_path / "buffered.parquet"
    results = pqt.crash_consistency_check(
        lambda sink: pqt.write_table(table, sink), str(d2),
        offsets=[1, 4, 5, 1000], buffered=True)
    assert {r["outcome"] for r in results[:-1]} == {"absent"}
    _clean_in_both(d2)


def test_a_commit_that_lies_is_caught(tmp_path, table):
    """The harness's oracle catches a sink that commits a torn file: a
    build that writes half a file and commits it fails the check."""
    dest = str(tmp_path / "torn.parquet")

    def torn(sink):
        buf = io.BytesIO()
        pqt.write_table(table, buf)
        sink.write(buf.getvalue()[:len(buf.getvalue()) // 2])

    with pytest.raises(AssertionError, match="verification"):
        pqt.crash_consistency_check(torn, dest, samples=3)
