"""The fused page cursor of parquet_tpu_torch (``io/fused.py``), its gate
``io/planner.py::choose_fused`` under ``PARQUET_TPU_TORCH_FUSED``, and the
host scan's fused phase 1, against parquet_tpu on the CPU.

Every mode (on, off, auto) gives the JAX package's aggregates and scans on
the same seeded files; the masked-emit decoders of ``ops/ref.py`` equal
the JAX package's on the same streams.  The one designed difference:
under ``auto`` an aggregate on a CUDA device never fuses (the card decodes
a contended span whole in one plan), where the JAX package's rule keeps
fusing large spans.
"""

import io
import math
import threading

import numpy as np
import pytest
import torch

import parquet_tpu
from parquet_tpu.algebra import aggregate as JA
from parquet_tpu.algebra.expr import col as jcol
from parquet_tpu.io import planner as jplanner
from parquet_tpu.ops import ref as jref
from parquet_tpu.parallel import host_scan as jhs

import parquet_tpu_torch as pqt
from parquet_tpu_torch.algebra.expr import col as tcol
from parquet_tpu_torch.io import fused as tfused
from parquet_tpu_torch.io import planner as tplanner
from parquet_tpu_torch.ops import ref as tref
from parquet_tpu_torch.utils import pool as tpool

CPU = "cpu"
N = 10_000
MODES = ["on", "off", "auto"]


@pytest.fixture(scope="module", autouse=True)
def _full_pool():
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
    tfused.reset_fused()
    before = threading.active_count()
    yield
    assert threading.active_count() <= before


def _table(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.integers(-1_000, 1_000, N)
    f = rng.standard_normal(N)
    f[rng.random(N) < 0.03] = np.nan
    return {
        "k": np.sort(rng.integers(0, 3_000, N)).astype(np.int64),
        "x": np.ma.MaskedArray(x, mask=rng.random(N) < 0.1),
        "f": f,
        "q": rng.integers(1, 40, N).astype(np.int32),
        "s": np.array([b"red", b"green", b"blue"], dtype=object)[
            rng.integers(0, 3, N)],
    }


def _write(path, page_index=True, version=1, dictionary=True):
    pqt.write_table(_table(0), path, pqt.WriterOptions(
        row_group_size=2_500, data_page_size=1_024,
        write_page_index=page_index, data_page_version=version,
        dictionary=dictionary))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused")
    return {"v1": _write(str(d / "v1.parquet")),
            "v2": _write(str(d / "v2.parquet"), version=2),
            "plain": _write(str(d / "plain.parquet"), dictionary=False),
            "no_index": _write(str(d / "noidx.parquet"), page_index=False)}


SPECS = [("count",), ("count", "x"), ("sum", "x"), ("min", "f"),
         ("max", "f"), ("sum", "f"), ("count_distinct", "q"),
         ("max", "s"), ("avg", "q"), ("variance", "x")]
WHERES = {
    "range": (tcol("k").between(400, 2_100), jcol("k").between(400, 2_100)),
    "tree": ((tcol("q") <= 10) & (tcol("k") >= 300),
             (jcol("q") <= 10) & (jcol("k") >= 300)),
    "or": ((tcol("x") >= 500) | (tcol("s") == b"red"),
           (jcol("x") >= 500) | (jcol("s") == b"red")),
}


def _aggs(specs):
    fn = {"count": "count", "min": "min_", "max": "max_", "sum": "sum_",
          "count_distinct": "count_distinct", "avg": "avg",
          "variance": "variance"}
    t = [getattr(pqt, fn[s[0]])(*s[1:]) for s in specs]
    j = [getattr(JA, fn[s[0]])(*s[1:]) for s in specs]
    return t, j


def _same(got, want):
    assert list(got.keys()) == list(want.keys())
    for name in want.keys():
        g, w = got[name], want[name]
        if isinstance(w, float) and name.startswith(("sum(", "avg(",
                                                      "variance(")):
            assert g == pytest.approx(w, rel=1e-9, nan_ok=True), name
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), name
        else:
            assert g == w and type(g) is type(w), (name, g, w)
    assert got.counters == want.counters


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["v1", "v2", "plain"])
@pytest.mark.parametrize("where", list(WHERES))
def test_modes_give_the_jax_aggregates(files, monkeypatch, mode, name,
                                       where):
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", mode)
    monkeypatch.setenv("PARQUET_TPU_FUSED", mode)
    taggs, jaggs = _aggs(SPECS)
    tw, jw = WHERES[where]
    got = pqt.ParquetFile(files[name]).aggregate(taggs, where=tw,
                                                 device=CPU)
    want = parquet_tpu.ParquetFile(files[name]).aggregate(jaggs, where=jw)
    _same(got, want)
    fused = "(fused)" in got.explain()
    assert fused == (mode == "on")  # these spans are under 8 MiB
    assert fused == ("(fused)" in want.explain())
    if mode == "on":
        assert tfused.FUSED["rg_folds"] > 0
        assert pqt.AGG["host_folds_fused"] > 0
    else:
        assert tfused.FUSED["rg_folds"] == 0


def test_fused_tier_skips_pages_the_mask_never_selects(files, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", "on")
    taggs, _ = _aggs([("sum", "x"), ("count", "f")])
    pqt.ParquetFile(files["v1"]).aggregate(
        taggs, where=tcol("q") <= 2, device=CPU)
    assert tfused.FUSED["pages_masked_emit"] > 0


def test_fallback_without_an_offset_index(files, monkeypatch):
    """``on`` over a file without a page index: the cursor is refused,
    counted, and the materializing tier answers, as in the JAX
    package."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", "on")
    monkeypatch.setenv("PARQUET_TPU_FUSED", "on")
    taggs, jaggs = _aggs(SPECS)
    tw, jw = WHERES["tree"]
    got = pqt.ParquetFile(files["no_index"]).aggregate(taggs, where=tw,
                                                       device=CPU)
    want = parquet_tpu.ParquetFile(files["no_index"]).aggregate(jaggs,
                                                                where=jw)
    _same(got, want)
    assert tfused.FUSED["fallbacks"] > 0
    assert "(fused)" not in got.explain()


@pytest.mark.parametrize("mode,est,device,want", [
    ("on", 0, None, True), ("on", 0, "cuda", True),
    ("on", 1 << 30, "cuda:0", True),
    ("off", 1 << 30, None, False), ("off", 1 << 30, "cpu", False),
    ("auto", (8 << 20) - 1, None, False), ("auto", 8 << 20, None, True),
    ("auto", 8 << 20, "cpu", True), ("auto", 1 << 30, "cuda", False),
    ("auto", 1 << 30, torch.device("cuda", 0), False),
    ("", 8 << 20, None, True)])
def test_choose_fused_modes(monkeypatch, mode, est, device, want):
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", mode)
    monkeypatch.setenv("PARQUET_TPU_FUSED", mode)
    assert tplanner.FUSED_AUTO_MIN_BYTES == jplanner.FUSED_AUTO_MIN_BYTES
    assert tplanner.choose_fused(est, device) is want
    if device is None or str(device) == "cpu":  # the JAX package's rule
        assert jplanner.choose_fused(est) is want


def test_cuda_auto_is_a_designed_divergence(monkeypatch):
    """Where the JAX package fuses a large span, the port's aggregate on a
    card does not under ``auto`` (and does on the CPU)."""
    monkeypatch.delenv("PARQUET_TPU_TORCH_FUSED", raising=False)
    monkeypatch.delenv("PARQUET_TPU_FUSED", raising=False)
    big = 64 << 20
    assert jplanner.choose_fused(big)
    assert tplanner.choose_fused(big, "cpu")
    assert not tplanner.choose_fused(big, "cuda")


def _scan_same(got, want):
    assert list(got) == list(want)
    for c in want:
        g, w = got[c], want[c]
        if isinstance(w, list):
            assert g == w, c
        else:
            np.testing.assert_array_equal(np.ma.getdata(g), np.ma.getdata(w))
            np.testing.assert_array_equal(np.ma.getmaskarray(g),
                                          np.ma.getmaskarray(w))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("where", list(WHERES))
def test_host_scan_fused_phase_one(files, monkeypatch, mode, where):
    """The host scan's phase 1, fused or not, gives the JAX package's
    rows; fused, its filter columns that are also output columns read
    again in phase 2."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", mode)
    monkeypatch.setenv("PARQUET_TPU_FUSED", mode)
    tw, jw = WHERES[where]
    cols = ["k", "x", "s", "q"]
    got = pqt.scan_expr(pqt.ParquetFile(files["v1"]), tw, columns=cols,
                        device=CPU)
    want = jhs.scan_expr(parquet_tpu.ParquetFile(files["v1"]), jw,
                         columns=cols)
    _scan_same(got, want)
    assert (tfused.FUSED["scan_spans"] > 0) == (mode == "on")


def test_host_scan_fused_without_an_offset_index(files, monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", "on")
    monkeypatch.setenv("PARQUET_TPU_FUSED", "on")
    tw, jw = WHERES["tree"]
    got = pqt.scan_expr(pqt.ParquetFile(files["no_index"]), tw,
                        columns=["x", "f"], device=CPU)
    want = jhs.scan_expr(parquet_tpu.ParquetFile(files["no_index"]), jw,
                         columns=["x", "f"])
    _scan_same(got, want)
    assert tfused.FUSED["fallbacks"] > 0


def _rle_stream(rng, n, width):
    vals = rng.integers(0, 1 << width, n)
    vals[: n // 3] = 5 % (1 << width)  # an RLE run first
    return vals, tref.encode_rle(vals, width)


@pytest.mark.parametrize("width", [1, 3, 8, 13, 20])
def test_masked_decoders_match_jax(width):
    rng = np.random.default_rng(width)
    n = 3_001
    vals, body = _rle_stream(rng, n, width)
    buf = np.frombuffer(bytes([width]) + body, np.uint8)
    take = np.sort(rng.choice(n, 400, replace=False)).astype(np.int64)
    got = tref.decode_rle_dict_indices_masked(buf, n, take)
    want = jref.decode_rle_dict_indices_masked(buf, n, take)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals[take])
    for physical, dt in ((pqt.format.enums.Type.INT32, np.int32),
                         (pqt.format.enums.Type.DOUBLE, np.float64),
                         (pqt.format.enums.Type.INT64, np.int64)):
        plain = rng.integers(-99, 99, n).astype(dt)
        raw = np.frombuffer(plain.tobytes(), np.uint8)
        np.testing.assert_array_equal(
            tref.decode_plain_masked(raw, n, take, physical),
            jref.decode_plain_masked(raw, n, take, physical))
    bits = rng.random(n) < 0.5
    raw = np.packbits(bits, bitorder="little")
    np.testing.assert_array_equal(
        tref.decode_plain_masked(raw, n, take, pqt.format.enums.Type.BOOLEAN),
        bits[take])
    delta = np.cumsum(rng.integers(-50, 50, n)).astype(np.int64)
    stream = np.frombuffer(tref.encode_delta_binary_packed(delta), np.uint8)
    np.testing.assert_array_equal(
        tref.decode_delta_binary_packed_masked(stream, n, take),
        jref.decode_delta_binary_packed_masked(stream, n, take))


def test_page_cursor_aligned_equals_the_read(files):
    """The cursor's row-aligned blocks of every page join to the column."""
    pf = pqt.ParquetFile(files["v2"])
    whole = pf.read(["x"], device=CPU)["x"]
    rg = pf.row_groups[1]
    cur = tfused.PageCursor(rg, pf.schema.leaf("x"))
    vals, valid = cur.aligned(0, rg.num_rows)
    start = pf.row_groups[0].num_rows
    want_valid = whole.validity.numpy()[start:start + rg.num_rows]
    np.testing.assert_array_equal(valid, want_valid)
    dense = whole.values.numpy()
    v0 = int(whole.validity.numpy()[:start].sum())
    np.testing.assert_array_equal(vals[valid],
                                  dense[v0:v0 + int(valid.sum())])
    assert cur.touched and cur.pages_decoded == len(cur.spans)
    with pytest.raises(tfused.FusedUnsupported):
        tfused.PageCursor(pqt.ParquetFile(files["no_index"]).row_groups[0],
                          pf.schema.leaf("x"))
