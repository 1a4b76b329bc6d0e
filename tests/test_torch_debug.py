"""The port's ``utils/debug.py``, ``utils/printer.py`` and row-group
pruning (``io/search.py``) against the JAX package's, on the CPU.

``counters`` counts what the JAX package's counts where both packages
run the same event (a file opened, the pages the host decode decodes, the
dictionary pages of the stream and of a lookup), and in a read agrees
with ``device_reader.PIPELINE`` on the three names both keep.  The
``print_*`` dumps are the JAX package's text, character for character,
on files of pyarrow's and both packages' writers.  ``prune_row_group``
and ``prune_row_group_values`` give the JAX package's answers, the bloom
probe of a batch on the device route (the kernel's plain version here).
``profiler_trace`` writes a Chrome trace holding the read's three region
names, and it and ``trace`` do nothing without their knobs.  Files are
small and made from a seed; every test leaves no thread running."""

import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.io import bloom as jbloom
from parquet_tpu.io import reader as jreader
from parquet_tpu.io import search as jsearch
from parquet_tpu.utils import debug as jdebug
from parquet_tpu.utils import printer as jprinter

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import bloom as tbloom
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.io import reader as treader
from parquet_tpu_torch.io import search as tsearch
from parquet_tpu_torch.utils import debug as tdebug
from parquet_tpu_torch.utils import printer as tprinter
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_fixtures", "host_route.parquet")
ROWS = 3000


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


def _table(rows=ROWS, seed=0) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(np.arange(rows, dtype=np.int64) * 3),
        "cat": pa.array([f"c{v}" for v in rng.integers(0, 30, rows)]),
        "f": pa.array(rng.random(rows), mask=rng.random(rows) < 0.1),
        "xs": pa.array([list(range(v % 4)) for v in range(rows)],
                       pa.list_(pa.int32())),
        "st": pa.array([None if v % 7 == 0 else {"a": v, "b": f"b{v % 3}"}
                        for v in range(rows)],
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same rows written by pyarrow (v1 and v2 pages, a page index)
    and by both packages' writers (a bloom filter on ``k`` and ``cat``),
    1,000-row row groups."""
    root = tmp_path_factory.mktemp("debug")
    t = _table()
    out = {}
    for v in ("1.0", "2.0"):
        p = str(root / f"pyarrow_v{v[0]}.parquet")
        papq.write_table(t, p, row_group_size=1000, data_page_size=2048,
                         data_page_version=v, write_page_index=True,
                         use_dictionary=["cat"])
        out[f"pyarrow_v{v[0]}"] = p
    bloom = {"k": 10.0, "cat": 10.0}
    p = str(root / "port.parquet")
    pqt.write_table(t, p, pqt.WriterOptions(row_group_size=1000,
                                            data_page_size=2048,
                                            bloom_filters=bloom))
    out["port"] = p
    p = str(root / "jax.parquet")
    parquet_tpu.write_table(t, p, parquet_tpu.WriterOptions(
        row_group_size=1000, data_page_size=2048, bloom_filters=bloom))
    out["jax"] = p
    return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def _delta(run) -> dict:
    tdebug.counters.reset()
    jdebug.counters.reset()
    run()
    return tdebug.counters.snapshot(), jdebug.counters.snapshot()


@pytest.mark.parametrize("name", ["pyarrow_v1", "pyarrow_v2", "port",
                                  "jax"])
def test_host_decode_counts_as_jax(files, name):
    """Opening a file and decoding its chunks on the host count the same
    files, dictionary pages and data pages in both packages."""
    path = files[name]
    got, want = _delta(lambda: (pqt.ParquetFile(path),
                                parquet_tpu.ParquetFile(path)))
    assert got["files_opened"] == want["files_opened"] == 1
    pf, jpf = pqt.ParquetFile(path), parquet_tpu.ParquetFile(path)

    def decode():
        for rg, jrg in zip(pf.row_groups, jpf.row_groups):
            for i in range(len(pf.schema.leaves)):
                treader.decode_chunk_host(rg.column(i), CPU)
                jreader.decode_chunk_host(jrg.column(i))

    got, want = _delta(decode)
    for name in ("dict_pages_decoded", "data_pages_decoded"):
        assert got.get(name, 0) == want.get(name, 0) > 0


def test_stream_and_lookup_dictionaries_count_as_jax(files):
    raw = open(files["pyarrow_v1"], "rb").read()

    def stream():
        for _ in pqt.ParquetFile(raw).iter_batches(batch_rows=700,
                                                   device=CPU):
            pass

    def jstream():
        for _ in parquet_tpu.ParquetFile(raw).iter_batches(batch_rows=700):
            pass

    got, _ = _delta(stream)
    _, want = _delta(jstream)
    assert got["dict_pages_decoded"] == want["dict_pages_decoded"] == 3
    tcache.clear_caches()
    parquet_tpu.clear_caches()
    keys = [f"c{v}" for v in range(0, 40, 3)]
    got, _ = _delta(lambda: pqt.ParquetFile(raw).find_rows(
        "cat", keys, device=CPU))
    _, want = _delta(lambda: parquet_tpu.ParquetFile(raw).find_rows(
        "cat", keys))
    assert got.get("dict_pages_decoded", 0) == \
        want.get("dict_pages_decoded", 0)


@pytest.mark.parametrize("path", ["pyarrow_v1", FIXTURE])
def test_read_counts_as_pipeline(files, path):
    """A read's chunks, on the device route and the host route (the
    fixture's), counted by ``counters`` as by ``PIPELINE``; the CPU read
    copies nothing to a card, so ``bytes_h2d`` stays 0."""
    path = files.get(path, path)
    pqt.reset_pipeline()
    tdebug.counters.reset()
    pf = pqt.ParquetFile(path)
    pf.read(device=CPU)
    chunks = len(pf.row_groups) * len(pf.schema.leaves)
    snap = tdebug.counters.snapshot()
    for name in ("chunks_device_decoded", "chunks_host_fallback",
                 "stage_concurrency_peak"):
        assert snap.get(name, 0) == pqt.PIPELINE[name], name
    assert snap.get("chunks_device_decoded", 0) + snap.get(
        "chunks_host_fallback", 0) == chunks
    if path == FIXTURE:
        assert snap["chunks_host_fallback"] > 0
    assert snap.get("bytes_h2d", 0) == 0


def test_counters_surface():
    c = tdebug.Counters()
    c.inc("a")
    c.inc("a", 4)
    c.high_water("peak", 3)
    c.high_water("peak", 2)
    assert c.get("a") == 5 and c.get("peak") == 3 and c.get("none") == 0
    assert c.snapshot() == {"a": 5, "peak": 3}
    c.reset()
    assert c.snapshot() == {}
    assert pqt.counters is tdebug.counters


# ---------------------------------------------------------------------------
# printer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pyarrow_v1", "pyarrow_v2", "port",
                                  "jax"])
def test_printer_text_equals_jax(files, name, capsys):
    path = files[name]
    pf, jpf = pqt.ParquetFile(path), parquet_tpu.ParquetFile(path)
    assert pqt.print_schema(pf.schema) == jprinter.print_schema(jpf.schema)
    assert pqt.print_file(pf) == jprinter.print_file(jpf)
    for rg in range(len(pf.row_groups)):
        for col in range(len(pf.schema.leaves)):
            assert pqt.print_pages(pf, rg, col) == \
                jprinter.print_pages(jpf, rg, col)
    out = io.StringIO()
    text = tprinter.print_file(pf, file=out)
    assert out.getvalue() == text + "\n"


# ---------------------------------------------------------------------------
# row-group pruning
# ---------------------------------------------------------------------------

PROBES = [dict(lo=100, hi=200), dict(lo=3100), dict(hi=-1),
          dict(lo=5000, hi=9000), dict(equals=300), dict(equals=301),
          dict(equals=7000, use_bloom=True), dict(equals=7001,
                                                  use_bloom=True),
          dict(equals=-3, use_bloom=True), dict(equals="x", use_bloom=True)]


@pytest.mark.parametrize("name", ["port", "jax", "pyarrow_v1"])
def test_prune_row_group_as_jax(files, name):
    pf, jpf = pqt.ParquetFile(files[name]), parquet_tpu.ParquetFile(
        files[name])
    for kw in PROBES:
        for rg, jrg in zip(pf.row_groups, jpf.row_groups):
            for path in ("k", "cat"):
                if path == "cat" and isinstance(kw.get("equals"), int):
                    kw = dict(kw, equals=f"c{kw['equals'] % 40}")
                try:
                    want = jsearch.prune_row_group(jrg, path, **kw)
                except TypeError:
                    with pytest.raises(TypeError):
                        tsearch.prune_row_group(rg, path, device=CPU, **kw)
                    continue
                got = tsearch.prune_row_group(rg, path, device=CPU, **kw)
                assert got == want, (path, kw, rg.index)
    assert pqt.prune_row_group is tsearch.prune_row_group


@pytest.mark.parametrize("device_probe", [False, True])
def test_prune_row_group_values_as_jax(files, device_probe, monkeypatch):
    """The IN-list prune with and without hashes; with ``device_probe``
    every batch takes the device route (``check_hashes_multi``, the
    kernel's plain version on the CPU)."""
    if device_probe:
        monkeypatch.setattr(tbloom.SplitBlockFilter, "_DEVICE_PROBE_MIN", 1)
    calls = []
    real = tbloom.check_hashes_multi
    monkeypatch.setattr(tbloom, "check_hashes_multi",
                        lambda *a: calls.append(a[2]) or real(*a))
    rng = np.random.default_rng(3)
    for name in ("port", "jax"):
        pf = pqt.ParquetFile(files[name])
        jpf = parquet_tpu.ParquetFile(files[name])
        leaf = pf.schema.leaf("k")
        for vals in ([0, 3, 6], [1, 2, 4], [2999 * 3 + 1, 9000],
                     sorted(rng.integers(0, 9000, 50).tolist()), []):
            hashes = tbloom.probe_hashes(leaf, vals)
            jhashes = jbloom.probe_hashes(jpf.schema.leaf("k"), vals)
            np.testing.assert_array_equal(hashes, jhashes)
            for rg, jrg in zip(pf.row_groups, jpf.row_groups):
                for h in (None, hashes):
                    got = tsearch.prune_row_group_values(
                        rg, "k", vals, hashes=h, device=CPU)
                    want = jsearch.prune_row_group_values(
                        jrg, "k", vals, hashes=None if h is None
                        else jhashes)
                    assert got == want, (name, vals, rg.index, h is None)
    assert bool(calls) == device_probe
    assert all(torch.device(d) == CPU for d in calls)


# ---------------------------------------------------------------------------
# profiler regions and the knobs
# ---------------------------------------------------------------------------


def test_profiler_trace_names_the_read_regions(files, tmp_path):
    out = str(tmp_path / "trace")
    with tdebug.profiler_trace(out) as prof:
        assert prof is not None
        pqt.ParquetFile(files["pyarrow_v1"]).read(device=CPU)
        pqt.Dataset([files["port"], files["jax"]]).read(device=CPU)
    names = os.listdir(out)
    assert len(names) == 1 and names[0].endswith(".json")
    with open(os.path.join(out, names[0])) as f:
        events = json.load(f)["traceEvents"]
    seen = {e.get("name", "") for e in events}
    assert "pq.prepare_chunk" in seen
    assert "pq.prepare_chunks_batched" in seen
    kinds = {n.split(":", 1)[1] for n in seen
             if n.startswith("pq.decode_staged:")}
    assert {"dict", "plain_fixed"} <= kinds


def test_knobs_off_leave_no_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("PARQUET_TPU_TORCH_TRACE_DIR", raising=False)
    monkeypatch.delenv("PARQUET_TPU_TORCH_DEBUG", raising=False)
    ctx = tdebug.profiler_trace()
    with ctx as prof:
        assert prof is None

    def f(x):
        return x + 1

    assert tdebug.trace(f) is f
    monkeypatch.setenv("PARQUET_TPU_TORCH_TRACE_DIR", str(tmp_path / "env"))
    with tdebug.profiler_trace():
        torch.ones(3).sum()
    assert len(os.listdir(tmp_path / "env")) == 1
    monkeypatch.setenv("PARQUET_TPU_TORCH_DEBUG", "1")
    g = tdebug.trace(f)
    assert g is not f and g(1) == 2
    err = capsys.readouterr().err
    assert "[parquet-tpu-torch]" in err and "f " in err
    with tdebug.annotate("pq.test"):
        pass
