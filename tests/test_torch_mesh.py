"""parquet_tpu_torch's row-group-sharded read (``read_table_sharded``),
sharded decode step (``decode_step_sharded``) and sharded device scan
(``scan_filtered_sharded``) against parquet_tpu's, on the CPU.

The port shards over ``["cpu"] * 8`` (or 4), the JAX package over its
8-device (or 4-device) CPU mesh; each of the port's shards is held to the
JAX package's global array cut into as many shards, padding included,
bit for bit (its 64-bit uint32 pairs viewed as int64 or float64).  Files
are small and made from a seed with numpy.  Every test ends with the
threads it started with.
"""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import jax.numpy as jnp
from parquet_tpu.ops import device as jdev
from parquet_tpu.ops import ref as jref
from parquet_tpu.parallel import mesh as jmesh

import parquet_tpu_torch as pqt
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    pqt.reset_mesh()
    pqt.reset_host_route()
    before = threads_now()
    yield
    assert_no_thread_started(before)


def _write(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    papq.write_table(table, buf, **kw)
    return buf.getvalue()


def _multi_rg_file(n=30000, rgs=6) -> bytes:
    """Uneven row groups (the last one short), a nullable column."""
    rng = np.random.default_rng(7)
    m = rng.random(n) < 0.05
    return _write(pa.table({
        "x": pa.array(rng.integers(0, 10 ** 12, n)),
        "f": pa.array(rng.random(n, dtype=np.float32)),
        "d": pa.array(rng.random(n)),
        "i": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "b": pa.array(rng.random(n) < 0.5),
        "o": pa.array(np.where(m, 0, rng.integers(0, 50, n)), mask=m)}),
        row_group_size=n // rgs + 13, use_dictionary=["i"],
        compression="snappy")


def _shards(arr, nd: int) -> list:
    """The JAX package's global array cut into ``nd`` shards, 64-bit
    pairs as int64/float64 (by ``pairs``)."""
    a = np.asarray(arr)
    return np.split(a, nd)


def _as_native(a: np.ndarray, leaf) -> np.ndarray:
    if a.ndim == 2 and a.dtype == np.uint32 and a.shape[1] == 2:
        return jdev.pairs_to_host(
            a, np.float64 if int(leaf.physical_type) == 5 else np.int64)
    return a


def _same_sharded(got, want, nd: int) -> None:
    """Shard for shard: arrays, validity, ragged pairs and dictionaries."""
    assert got.row_counts == tuple(want.row_counts)
    assert got.shard_rows == want.shard_rows
    assert set(got.arrays) == set(want.arrays)
    assert set(got.validity) == set(want.validity)
    assert set(got.ragged) == set(want.ragged)
    assert set(got.dictionaries) == set(want.dictionaries)
    for path, shards in got.arrays.items():
        assert len(shards) == nd
        for d, (g, w) in enumerate(zip(shards, _shards(want.arrays[path],
                                                       nd))):
            w = _as_native(w, got.leaves[path])
            g = g.numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (path, d)
            np.testing.assert_array_equal(g.view(np.uint8),
                                          w.view(np.uint8),
                                          err_msg=f"{path} shard {d}")
    for path, shards in got.validity.items():
        for d, (g, w) in enumerate(zip(shards, _shards(want.validity[path],
                                                       nd))):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{path} validity {d}")
    for path, (gb, go) in got.ragged.items():
        wb, wo = want.ragged[path]
        for d, (b, o, eb, eo) in enumerate(zip(gb, go, _shards(wb, nd),
                                               _shards(wo, nd))):
            np.testing.assert_array_equal(b.numpy(), eb,
                                          err_msg=f"{path} bytes {d}")
            np.testing.assert_array_equal(o.numpy(), eo,
                                          err_msg=f"{path} offsets {d}")
    for path, (v, o) in got.dictionaries.items():
        wv, wo = want.dictionaries[path]
        np.testing.assert_array_equal(v, np.asarray(wv))
        np.testing.assert_array_equal(o, np.asarray(wo))


def _both(raw: bytes, nd: int = 8, columns=None):
    got = pqt.read_table_sharded(raw, mesh=[CPU] * nd, columns=columns)
    want = jmesh.read_table_sharded(raw, mesh=jmesh.default_mesh(nd),
                                    columns=columns)
    return got, want


def test_uneven_row_groups_and_nulls():
    got, want = _both(_multi_rg_file())
    _same_sharded(got, want, 8)
    assert got.num_rows == 30000
    assert min(got.row_counts) < max(got.row_counts)  # uneven
    assert set(got.validity) == {"o"}
    assert got.arrays["x"][0].dtype == torch.int64
    mask = got.row_mask()
    for d, m in enumerate(mask):
        np.testing.assert_array_equal(
            m.numpy(), np.arange(got.shard_rows) < got.row_counts[d])
    np.testing.assert_array_equal(
        np.concatenate([m.numpy() for m in mask]),
        np.asarray(want.row_mask()))
    assert sum(pqt.HOST_ROUTE.values()) == 0
    assert pqt.MESH["chunks_host_fallback"] == 0


def test_plain_strings_shard_ragged():
    rng = np.random.default_rng(11)
    n = 9000
    words = np.array(["alpha", "bee", "", "delta-delta", "e"])
    s = words[rng.integers(0, 5, n)]
    raw = _write(pa.table({"s": pa.array(s),
                           "sn": pa.array(s, mask=rng.random(n) < 0.2),
                           "x": pa.array(np.arange(n, dtype=np.int64))}),
                 use_dictionary=False, row_group_size=n // 5)
    got, want = _both(raw)
    assert set(got.ragged) == {"s", "sn"} and "sn" in got.validity
    _same_sharded(got, want, 8)


def test_mixed_dictionary_and_plain_chunks_densify():
    n = 6000
    s = np.array([f"v{i % 7}" for i in range(n // 2)]
                 + [f"unique_{i:06d}" for i in range(n // 2)])
    raw = _write(pa.table({"s": pa.array(s)}), row_group_size=n // 2,
                 compression="snappy", use_dictionary=True,
                 dictionary_pagesize_limit=4096)
    got, want = _both(raw, nd=4)
    assert "s" in got.ragged and "s" not in got.dictionaries
    _same_sharded(got, want, 4)


def test_dictionaries_unify_across_row_groups():
    rng = np.random.default_rng(5)
    n, rgs = 24_000, 5
    cats = np.array([f"mode_{i:02d}" for i in range(37)])
    s = cats[rng.integers(0, 37, n)]
    raw = _write(pa.table({"s": pa.array(s),
                           "sn": pa.array(s, mask=rng.random(n) < 0.3),
                           "x": pa.array(np.arange(n, dtype=np.int64))}),
                 row_group_size=(n + rgs - 1) // rgs, compression="snappy")
    got, want = _both(raw)
    _same_sharded(got, want, 8)
    assert len(got.dictionaries["s"][1]) - 1 == 37  # not 5 x 37
    # ids name the source strings, shard for shard
    per = (n + rgs - 1) // rgs
    for d in range(8):
        rows = np.concatenate([np.arange(g * per, min((g + 1) * per, n))
                               for g in range(rgs) if g % 8 == d]
                              or [np.zeros(0, np.int64)])
        ids = got.arrays["s"][d][:len(rows)]
        assert [x.decode() for x in got.lookup_strings("s", ids)] == \
            list(s[rows])
        assert got.lookup_strings("s", ids.numpy()[:3]) == \
            want.lookup_strings("s", ids.numpy()[:3])


def test_empty_file():
    raw = _write(pa.table({"x": pa.array(np.zeros(0, np.int64))}))
    got, want = _both(raw)
    assert got.num_rows == want.num_rows == 0
    assert got.row_counts == tuple(want.row_counts) == (0,) * 8
    # one row group of no rows: eight empty shards (the JAX package's
    # empty global array is int32, not uint32 pairs; the port keeps int64)
    assert np.asarray(want.arrays["x"]).size == 0
    assert [(a.dtype, a.shape) for a in got.arrays["x"]] == \
        [(torch.int64, (0,))] * 8
    assert all(m.numel() == 0 for m in got.row_mask())


def test_host_fallback_on_mixed_encodings():
    """A chunk whose dictionary falls back to PLAIN pages mid-chunk takes
    the host route, counted; the table still shards."""
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.integers(0, 3, 2000),
                           rng.integers(0, 1 << 40, 48000)]).astype(np.int64)
    raw = _write(pa.table({"f": pa.array(vals),
                           "x": pa.array(np.arange(50000, dtype=np.int64))}),
                 use_dictionary=["f"], data_page_size=4096,
                 dictionary_pagesize_limit=4096)
    got, want = _both(raw, columns=["f", "x"])
    _same_sharded(got, want, 8)
    assert pqt.MESH["chunks_host_fallback"] >= 1
    assert pqt.HOST_ROUTE["mixed_page_kinds"] == \
        pqt.MESH["chunks_host_fallback"]
    mask = torch.cat(got.row_mask())
    np.testing.assert_array_equal(torch.cat(got.arrays["f"])[mask].numpy(),
                                  vals)


def test_nested_columns_raise():
    raw = _write(pa.table({"l": pa.array([[1], [2, 3], []])}))
    with pytest.raises(ValueError, match="nested"):
        pqt.read_table_sharded(raw, mesh=[CPU] * 8)
    with pytest.raises(ValueError, match="nested"):
        jmesh.read_table_sharded(raw, mesh=jmesh.default_mesh(8))


def test_lineitem_columns_at_four_shards():
    """Three row groups over four shards (one shard all padding), the
    dictionary, PLAIN-string and 64-bit columns of lineitem."""
    rng = np.random.default_rng(3)
    n = 3000
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"])
    raw = _write(pa.table({
        "l_orderkey": pa.array(np.sort(rng.integers(1, n, n))),
        "l_extendedprice": pa.array(rng.random(n) * 1e5),
        "l_shipdate": pa.array(rng.integers(8000, 12000, n).astype(
            np.int32)),
        "l_shipmode": pa.array(modes[rng.integers(0, 7, n)]),
        "l_comment": pa.array(["".join(chr(97 + c) for c in
                                       rng.integers(0, 26, 27))
                               for _ in range(n)])}),
        row_group_size=1000, compression="snappy",
        use_dictionary=["l_shipmode"])
    got, want = _both(raw, nd=4)
    _same_sharded(got, want, 4)
    assert got.row_counts == (1000, 1000, 1000, 0)
    assert set(got.dictionaries) == {"l_shipmode"}
    assert set(got.ragged) == {"l_comment"}


# ---------------------------------------------------------------------------
# the sharded decode step
# ---------------------------------------------------------------------------


def _step_inputs(n: int, shards: int, seed: int) -> list:
    """A PLAIN INT64 page and an RLE def-level stream with its run table a
    shard (the JAX package's dry-run inputs, seeded per shard)."""
    out = []
    for d in range(shards):
        rng = np.random.default_rng(seed + d)
        values = rng.integers(0, 2 ** 60, size=n).astype(np.int64)
        defs = (rng.random(n) < 0.9).astype(np.int64)
        lev = jref.encode_rle(defs, 1)
        kinds, cnts, payloads, offs, _ = jref.scan_rle_runs(
            np.frombuffer(lev, np.uint8), n, 1)
        out.append((
            jdev.pad_to_bucket(np.frombuffer(values.tobytes(), np.uint8)),
            jdev.pad_to_bucket(np.frombuffer(lev, np.uint8)),
            np.cumsum(cnts).astype(np.int64), kinds.astype(np.uint8),
            payloads.astype(np.int32), (offs * 8).astype(np.int64),
            np.ones(len(kinds), np.int32)))
    # every shard's buffers and run table padded to one shape (padding
    # runs end at n: no value falls in them)
    runs = -(-max(len(s[2]) for s in out) // 16) * 16
    nbuf = [max(len(s[i]) for s in out) for i in (0, 1)]
    fill = (n, 0, 0, 0, 1)
    return [np.stack([np.pad(s[i], (0, nbuf[i] - len(s[i]))) for s in out])
            for i in (0, 1)] + [
        np.stack([np.pad(s[i], (0, runs - len(s[i])),
                         constant_values=fill[i - 2]) for s in out])
        for i in range(2, 7)]


def test_decode_step_sharded_matches_jax():
    n, nd = 256, 8
    cols = _step_inputs(n, nd, seed=0)
    lo, hi, validity, nrows = jmesh.decode_step_sharded(
        jmesh.default_mesh(nd), n)(*[jnp.asarray(c) for c in cols])
    want = np.stack([np.asarray(lo), np.asarray(hi)], -1).astype(
        np.uint32)
    step = pqt.decode_step_sharded([CPU] * nd, n)
    values, valid, rows = step(*[torch.from_numpy(c) for c in cols])
    assert len(values) == len(valid) == nd
    for d in range(nd):
        np.testing.assert_array_equal(
            values[d].numpy(), jdev.pairs_to_host(want[d], np.int64))
        np.testing.assert_array_equal(valid[d].numpy(),
                                      np.asarray(validity)[d])
    assert rows.dtype == torch.int64 and int(rows) == int(nrows)
    # per-shard lists work as the stacked tensors do
    again = step(*[[torch.from_numpy(c[d]) for d in range(nd)]
                   for c in cols])
    assert int(again[2]) == int(rows)


def test_decode_step_sums_over_a_process_group(tmp_path):
    """Two processes (``torch.distributed``, gloo), each two shards: every
    process's row count is the sum over all four shards."""
    n, nd = 256, 4
    cols = _step_inputs(n, nd, seed=3)
    path = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(path, *cols)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = os.path.join(ROOT, "tests", "torch_fixtures",
                          "decode_step_worker.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    procs = [subprocess.Popen(
        [sys.executable, script, str(rank), "2", str(port), path, str(n)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT, env=env,
        text=True) for rank in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    single = int(pqt.decode_step_sharded([CPU] * nd, n)(
        *[torch.from_numpy(c) for c in cols])[2])
    assert [o["rows"] for o in outs] == [single, single]
    assert sum(o["local_rows"] for o in outs) == single


# ---------------------------------------------------------------------------
# the sharded device scan
# ---------------------------------------------------------------------------


def _scan_file() -> bytes:
    """Eight row groups of a sorted INT32 key, a row id, a nullable double
    and a dictionary string, with a page index."""
    rng = np.random.default_rng(23)
    n = 16_000
    m = rng.random(n) < 0.1
    return _write(pa.table({
        "k": pa.array(np.sort(rng.integers(0, 4000, n)).astype(np.int32)),
        "v": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(np.where(m, 0.0, rng.random(n)), mask=m),
        "s": pa.array([f"s{i % 11}" for i in range(n)])}),
        row_group_size=n // 8, use_dictionary=["s"], write_page_index=True,
        data_page_size=1 << 12)


def _rows_of(form, col: str) -> tuple:
    """A device-scan column form on the host: (values, validity)."""
    if isinstance(form, tuple) and isinstance(form[0], tuple):
        (dv, do), idx = form
        dv, do = dv.numpy(), do.numpy()
        return [dv[do[i]:do[i + 1]].tobytes() for i in idx.numpy()], None
    if isinstance(form, tuple):
        return form[0].numpy(), form[1].numpy()
    return form.numpy(), None


@pytest.mark.parametrize("nd", [1, 4])
def test_scan_filtered_sharded_matches(nd):
    """Each shard's rows are its spans' (span i on device i % nd): joined
    and put back in file order they equal ``scan_filtered_device``; each
    shard's numbers equal the JAX package's shard on its CPU mesh."""
    from parquet_tpu.io.reader import ParquetFile as JParquetFile
    from parquet_tpu.parallel import host_scan as jhs

    raw = _scan_file()
    pf = pqt.ParquetFile(raw)
    cols = ["v", "d", "s"]
    for kw in ({"lo": 300, "hi": 3500}, {"lo": 10 ** 6}):
        got = pqt.scan_filtered_sharded(pf, "k", columns=cols,
                                        mesh=[CPU] * nd, **kw)
        want = pqt.scan_filtered_device(pf, "k", columns=cols, device=CPU,
                                        **kw)
        assert got["#rows"] == len(want["v"])
        order = np.argsort(np.concatenate(
            [_rows_of(p, "v")[0] for p in got["v"]] or [np.zeros(0)]))
        for c in cols:
            wv, wvalid = _rows_of(want[c], c)
            parts = [_rows_of(p, c) for p in got[c]]
            gv = [x for vals, _ in parts for x in vals]
            assert [gv[i] for i in order] == list(wv), (c, kw)
            if wvalid is not None:
                gvalid = np.concatenate([
                    v if v is not None else np.ones(len(x), bool)
                    for x, v in parts])
                assert np.array_equal(gvalid[order], wvalid), (c, kw)
        ref = jhs.scan_filtered_sharded(JParquetFile(raw), "k",
                                        columns=["v", "d"],
                                        mesh=jmesh.default_mesh(nd), **kw)
        assert ref["#rows"] == got["#rows"]
        assert len(ref["v"]) == len(got["v"])
        for gp, jp in zip(got["v"], ref["v"]):
            np.testing.assert_array_equal(
                gp.numpy(), _as_native(np.asarray(jp), pf.schema.leaf("v")))
        for gp, jp in zip(got["d"], ref["d"]):
            gvals, gvalid = gp if isinstance(gp, tuple) else (gp, None)
            jvals, jvalid = jp if isinstance(jp, tuple) else (jp, None)
            np.testing.assert_array_equal(
                gvals.numpy(), _as_native(np.asarray(jvals),
                                          pf.schema.leaf("d")))
            assert (gvalid is None) == (jvalid is None)
            if gvalid is not None:
                np.testing.assert_array_equal(gvalid.numpy(),
                                              np.asarray(jvalid))


def test_scan_filtered_sharded_refuses_a_rows_column():
    raw = _write(pa.table({"k": pa.array(np.arange(10, dtype=np.int32)),
                           "#rows": pa.array(np.arange(10))}))
    with pytest.raises(ValueError, match="#rows"):
        pqt.scan_filtered_sharded(pqt.ParquetFile(raw), "k", lo=1,
                                  mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="#rows"):
        pqt.scan_filtered_sharded(pqt.ParquetFile(raw), "k", lo=1,
                                  mesh=[CPU], policy=pqt.FaultPolicy())
