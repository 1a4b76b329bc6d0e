"""parquet_tpu_torch's batched point lookup (``find_rows`` on the CPU)
against parquet_tpu's, on files written by both writers: hits (rows,
values bit for bit, validity) and stage counters, exact.

Both packages run on in-memory bytes, where their page caches and
negative-lookup memos never engage, and the reference with key sharding
off (``PARQUET_TPU_LOOKUP_KEY_SHARD=0``; the port does not shard), so
``page_cache_hits``, ``neg_hits`` and ``key_shards`` stay 0 on both
sides; the caches are held to the reference in
``test_torch_lookup_leftovers.py`` and ``test_torch_cache.py``.
"""

import io

import numpy as np
import pyarrow as pa
import pytest
import torch

import parquet_tpu
from parquet_tpu.format.enums import Encoding as JEncoding
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.io import bloom as tbloom
from parquet_tpu_torch.io import lookup as tlookup
from parquet_tpu_torch.ops import kernels

N = 24_000
RGS = 4
PER_RG = N // RGS
CACHE_AND_SHARD_KEYS = ("page_cache_hits", "neg_hits", "key_shards")

_ENC = {"plain": Encoding.PLAIN, "dict": Encoding.RLE_DICTIONARY,
        "delta": Encoding.DELTA_BINARY_PACKED}


@pytest.fixture(autouse=True)
def _no_key_shards(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")


def _table(seed: int, nulls: bool, sorted_keys: bool, key_dtype=np.int64,
           n: int = N, key_range: int = N // 4) -> dict:
    """``k`` (the key), ``v`` DOUBLE, ``c`` INT32 (200 values): masked
    arrays where ``nulls``.  Sorted keys put their nulls at the end of
    each row group, as a sort with nulls last does."""
    r = np.random.default_rng(seed)
    if sorted_keys:
        k = (np.arange(n) // 7 * 2).astype(key_dtype)  # odd keys absent
        km = (np.arange(n) % PER_RG) >= PER_RG - PER_RG // 20
    else:
        k = r.integers(0, key_range, n).astype(key_dtype)
        km = r.random(n) < 0.05
    v = r.random(n)
    c = r.integers(0, 200, n).astype(np.int32)
    if not nulls:
        return {"k": k, "v": v, "c": c}
    return {"k": np.ma.masked_array(k, mask=km),
            "v": np.ma.masked_array(v, mask=r.random(n) < 0.07),
            "c": np.ma.masked_array(c, mask=r.random(n) < 0.10)}


def _write(table: dict, writer: str, enc: str, page_index: bool = True,
           sorted_keys: bool = False, page: int = 4096) -> bytes:
    sorting = [("k", False, False)] if sorted_keys else []
    buf = io.BytesIO()
    if writer == "port":
        pqt.write_table(table, buf, pqt.WriterOptions(
            row_group_size=PER_RG, data_page_size=page,
            column_encoding={"k": _ENC[enc]}, bloom_filters={"k": 10},
            write_page_index=page_index, sorting_columns=sorting))
        return buf.getvalue()
    arrow = pa.table({
        name: (pa.array(np.asarray(a.data), mask=np.ma.getmaskarray(a))
               if isinstance(a, np.ma.MaskedArray) else pa.array(a))
        for name, a in table.items()})
    kw = dict(row_group_size=PER_RG, data_page_size=page,
              compression="gzip", bloom_filters={"k": 10},
              write_page_index=page_index, sorting_columns=sorting,
              dictionary=["k", "c"] if enc == "dict" else ["c"])
    if enc == "delta":
        kw["column_encoding"] = {"k": JEncoding.DELTA_BINARY_PACKED}
    jwrite_table(arrow, buf, JWriterOptions(**kw))
    return buf.getvalue()


def _keys(table: dict, seed: int) -> list:
    """Present keys (a duplicated one among them), absent keys inside the
    range (only the bloom filter or the pages can drop them), keys outside
    it, and keys no INT64 can equal."""
    r = np.random.default_rng(seed + 1)
    k = np.ma.getdata(table["k"])
    present = [int(x) for x in r.choice(k, 40)]
    inside = [int(x) for x in r.integers(int(k.min()), int(k.max()), 40)]
    return (present + [present[0]] + inside
            + [-5, int(k.max()) + 10**6, 10**12, None, 2.5, float(present[1]),
               2**70, np.int64(present[2])])


def _assert_same(got, want, columns) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.key is w.key or g.key == w.key
        np.testing.assert_array_equal(g.rows, w.rows, err_msg=repr(w.key))
        assert g.rows.dtype == np.int64
        for c in columns:
            gv, wv = np.asarray(g.values[c]), np.asarray(w.values[c])
            assert gv.dtype == wv.dtype, c
            np.testing.assert_array_equal(
                gv.view(f"i{gv.itemsize}"), wv.view(f"i{wv.itemsize}"),
                err_msg=f"{c} of key {w.key!r}")
            if w.validity[c] is None:
                assert g.validity[c] is None, (c, w.key)
            else:
                np.testing.assert_array_equal(g.validity[c], w.validity[c])


def _assert_counters(got: dict, want: dict) -> None:
    assert all(want[k] == got[k] == 0 for k in CACHE_AND_SHARD_KEYS), want
    assert got == want


def _both(data: bytes, keys, columns):
    want = parquet_tpu.ParquetFile(data).find_rows("k", keys, columns=columns)
    got = pqt.ParquetFile(data).find_rows("k", keys, columns=columns,
                                          device="cpu")
    return got, want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("sorted_keys", [False, True])
@pytest.mark.parametrize("page_index", [True, False])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("enc", ["plain", "dict", "delta"])
def test_find_rows_matches_jax(enc, nulls, page_index, sorted_keys, writer):
    seed = sum(map(ord, f"{enc}{nulls}{page_index}{sorted_keys}"))
    table = _table(seed, nulls, sorted_keys)
    data = _write(table, writer, enc, page_index, sorted_keys)
    keys = _keys(table, seed)
    got, want = _both(data, keys, ["v", "c"])
    _assert_same(got, want, ["v", "c"])
    _assert_counters(got.counters, want.counters)
    assert got.counters["rows_matched"] > 0
    if page_index:
        assert got.counters["keys_pruned_bloom"] > 0
        assert (got.counters["binary_search_hits"] > 0) == sorted_keys
    else:
        assert got.counters["chunk_fallbacks"] > 0


def test_find_rows_matches_numpy_oracle():
    table = _table(11, nulls=True, sorted_keys=False)
    data = _write(table, "port", "dict")
    keys = _keys(table, 11)
    res = pqt.ParquetFile(data).find_rows("k", keys, columns=["v", "c"],
                                          device="cpu")
    k = table["k"]
    kvalid = ~np.ma.getmaskarray(k)
    for h, key in zip(res, keys):
        if key is None or key in (2.5, 2**70):
            assert h.num_rows == 0 and h.validity["v"] is None
            continue
        rows = np.flatnonzero(kvalid & (np.ma.getdata(k) == int(key)))
        np.testing.assert_array_equal(h.rows, rows)
        for c in ("v", "c"):
            arr = table[c]
            valid = ~np.ma.getmaskarray(arr)[rows]
            if len(rows):
                assert h.validity[c] is not None
                np.testing.assert_array_equal(h.validity[c], valid)
                np.testing.assert_array_equal(
                    h.values[c][valid], np.ma.getdata(arr)[rows][valid])
    assert res[0].rows is res[40].rows  # a repeated key shares its hits
    assert res.counters["keys"] == len(keys)


def _spy_segments(monkeypatch) -> list:
    """Record the segment sizes of each ``bloom_check_segments_ref`` call
    (the segmented probe's plain version, which the CPU runs)."""
    calls = []
    real = kernels.bloom_check_segments_ref

    def spy(filters, hashes, starts):
        calls.append(np.diff(starts.numpy()).tolist())
        return real(filters, hashes, starts)

    monkeypatch.setattr(kernels, "bloom_check_segments_ref", spy)
    return calls


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_large_batch_takes_the_device_probe(writer, monkeypatch):
    """At 32,768 or more keys alive after the statistics stage, the bloom
    stage runs the segmented probe (its plain version, on the CPU): one
    call per lookup, one segment per row group; the hits and counters
    still equal the reference's."""
    calls = _spy_segments(monkeypatch)
    table = _table(3, nulls=True, sorted_keys=False, key_range=10**9)
    data = _write(table, writer, "plain")
    r = np.random.default_rng(4)
    k = np.ma.getdata(table["k"])
    keys = np.concatenate([r.choice(k, 500),
                           r.integers(0, 10**9, 34_000)]).astype(np.int64)
    got, want = _both(data, keys, ["v"])
    _assert_same(got, want, ["v"])
    _assert_counters(got.counters, want.counters)
    assert len(calls) == 1 and len(calls[0]) == RGS
    assert min(calls[0]) >= tbloom.SplitBlockFilter._DEVICE_PROBE_MIN
    assert got.counters["keys_pruned_bloom"] > 30_000


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_bloom_routes_match_jax(writer, monkeypatch):
    """With the device threshold set small, the row groups whose bloom
    batch reaches it are probed together by one segmented call and the
    others by the numpy probe, each row group by its size alone; hits and
    counters equal the reference's (which probes all on the host)."""
    monkeypatch.setattr(tbloom.SplitBlockFilter, "_DEVICE_PROBE_MIN", 200)
    calls = _spy_segments(monkeypatch)
    host = []
    real_host = tbloom.SplitBlockFilter.check_hashes
    monkeypatch.setattr(tbloom.SplitBlockFilter, "check_hashes",
                        lambda self, h: host.append(len(h))
                        or real_host(self, h))
    table = _table(12, nulls=True, sorted_keys=True)
    data = _write(table, writer, "plain", sorted_keys=True)
    k = np.ma.getdata(table["k"])
    r = np.random.default_rng(12)
    # sorted keys give each row group its own range: many keys inside row
    # groups 0 and 2, few inside 1 and 3
    keys = np.concatenate([
        r.integers(k[g * PER_RG] + 2, k[(g + 1) * PER_RG - 1] - 2, m)
        for g, m in enumerate([600, 40, 600, 40])]).astype(np.int64)
    got, want = _both(data, keys, ["v", "c"])
    _assert_same(got, want, ["v", "c"])
    _assert_counters(got.counters, want.counters)
    assert len(calls) == 1 and len(calls[0]) == 2
    assert min(calls[0]) >= 200
    assert len(host) == 2 and max(host) < 200
    assert got.counters["keys_pruned_bloom"] > 0
    assert got.counters["rows_matched"] > 0


@pytest.mark.parametrize("key_dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_other_key_types_match_jax(key_dtype, writer):
    """INT32, FLOAT and DOUBLE keys: NaN never matches, -0.0 equals 0.0,
    and python ints and floats probe each other's columns."""
    table = _table(5, nulls=True, sorted_keys=False, key_dtype=key_dtype)
    k = np.ma.getdata(table["k"])
    if key_dtype != np.int32:
        k[:: 97] = -0.0
        k[1:: 89] = np.nan
        k[2:: 83] = k[2:: 83] + 0.5
    data = _write(table, writer, "dict")
    keys = ([v.item() for v in k[::251]] + [0.0, -0.0, float("nan"), 7, 7.5,
                                            -3, 2**40, None])
    got, want = _both(data, keys, ["v", "c"])
    _assert_same(got, want, ["v", "c"])
    _assert_counters(got.counters, want.counters)
    assert got.counters["rows_matched"] > 0


def test_numpy_key_array_prepares_as_the_list_does():
    table = _table(9, nulls=False, sorted_keys=False)
    data = _write(table, "port", "plain")
    r = np.random.default_rng(9)
    arr = np.concatenate([r.choice(table["k"], 30),
                          r.integers(-10, N, 30)]).astype(np.int64)
    f = pqt.ParquetFile(data)
    a = f.find_rows("k", arr, columns=["c"], device="cpu")
    b = f.find_rows("k", arr.tolist(), columns=["c"], device="cpu")
    _assert_same(a, b, ["c"])
    assert a.counters == b.counters


def test_repeated_lookups_reuse_the_parsed_filter():
    """Chunk readers are memoized on the file: a second lookup reads no
    index or filter again, and the filter's device copy is reused."""
    table = _table(2, nulls=False, sorted_keys=False)
    f = pqt.ParquetFile(_write(table, "port", "plain"))
    keys = np.arange(0, 6000, 7)
    f.find_rows("k", keys, device="cpu")
    chunk = f.row_groups[0].column(0)
    assert f.row_groups[0].column(0) is chunk
    bf = chunk.bloom_filter()
    dev = bf.device_blocks("cpu")
    f.find_rows("k", keys, device="cpu")
    assert chunk.bloom_filter() is bf and bf.device_blocks("cpu") is dev


def test_find_rows_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = _write(_table(1, False, False), "port", "plain")
    with pytest.raises(RuntimeError):
        pqt.ParquetFile(data).find_rows("k", [1, 2])


def test_all_nan_page_has_unknown_bounds():
    """A DOUBLE page of NaNs only has empty bounds in the column index.
    The port reads them as unknown: the boundary order is UNORDERED, the
    zone-map walk keeps that page, and lookups equal a numpy oracle (NaN
    never matches)."""
    from parquet_tpu_torch.format.enums import BoundaryOrder

    v = np.arange(6000, dtype=np.float64)
    v[1024:2048] = np.nan
    data = io.BytesIO()
    pqt.write_table({"k": v}, data, pqt.WriterOptions(data_page_size=8192))
    f = pqt.ParquetFile(data.getvalue())
    ci = f.row_groups[0].column(0).column_index()
    assert ci.min_values[1] == ci.max_values[1] == b""
    assert ci.boundary_order == BoundaryOrder.UNORDERED
    keys = [5.0, 1500.0, float("nan"), 4000.0, -1.0]
    res = f.find_rows("k", keys, device="cpu")
    for h, key in zip(res, keys):
        np.testing.assert_array_equal(h.rows, np.flatnonzero(v == key))
    assert res.counters["rows_matched"] == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v2_pages_with_and_without_nulls_match_jax(writer):
    """Data pages v2, where ``v`` has nulls in its first half only: keys
    whose rows lie in null-free pages get no validity, as in the
    reference."""
    table = _table(21, nulls=True, sorted_keys=False)
    table["v"].mask[N // 2:] = False
    buf = io.BytesIO()
    if writer == "port":
        pqt.write_table(table, buf, pqt.WriterOptions(
            row_group_size=PER_RG, data_page_size=4096, data_page_version=2,
            compression="gzip", bloom_filters={"k": 10}))
    else:
        arrow = pa.table({
            name: pa.array(np.asarray(a.data), mask=np.ma.getmaskarray(a))
            for name, a in table.items()})
        jwrite_table(arrow, buf, JWriterOptions(
            row_group_size=PER_RG, data_page_size=4096, data_page_version=2,
            compression="gzip", bloom_filters={"k": 10}))
    keys = _keys(table, 21)
    got, want = _both(buf.getvalue(), keys, ["v", "c"])
    _assert_same(got, want, ["v", "c"])
    _assert_counters(got.counters, want.counters)
    assert any(h.num_rows and h.validity["v"] is None for h in want)
    assert any(h.num_rows and h.validity["v"] is not None for h in want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_descending_index_matches_jax(writer):
    """Keys sorted descending: a DESCENDING column index, searched by
    :func:`find` key by key, and a sort declaration the in-page binary
    search does not take."""
    table = _table(31, nulls=False, sorted_keys=True)
    table["k"] = table["k"][::-1].copy()
    data = _write(table, writer, "plain")
    f = pqt.ParquetFile(data)
    assert f.row_groups[0].column(0).column_index().boundary_order == 2
    keys = _keys(table, 31)
    got, want = _both(data, keys, ["v", "c"])
    _assert_same(got, want, ["v", "c"])
    _assert_counters(got.counters, want.counters)
    assert got.counters["rows_matched"] > 0
    assert got.counters["binary_search_hits"] == 0


@pytest.mark.parametrize("case", ["uint64", "uint64_array", "uint32",
                                  "decimal"])
def test_unsigned_and_decimal_keys_match_jax(case):
    """Keys of an unsigned column order unsigned, in the statistics, the
    page index and the match: ``uint64`` keys 5 and 2**63 + 7 (whose bit
    patterns are negative as int64), as a list and as a numpy key array,
    a ``uint32`` key above 2**31, and a ``Decimal`` key of a decimal
    stored as INT64, each equal to the JAX package's hits."""
    import decimal

    if case.startswith("uint64"):
        base = [1, 5, 2**63 + 7, 2**64 - 1, 9, 3]
        key = pa.array(base * 1000, pa.uint64())
        keys = [2**63 + 7, 5, 2**64 - 1, 0, 2**64, -1]
        if case == "uint64_array":  # the vectorized key preparation
            keys = np.array([9, 5, 0, -1], np.int64)
    elif case == "uint32":
        base = [1, 5, 2**31 + 7, 2**32 - 1, 9, 3]
        key = pa.array(base * 1000, pa.uint32())
        keys = [2**31 + 7, 5, 2**32 - 1, 2**32, -1]
    else:
        base = [decimal.Decimal(s) for s in
                ("1.25", "-7.50", "99999.99", "0.00", "3.10", "-0.01")]
        key = pa.array(base * 1000, pa.decimal128(12, 2))
        keys = [decimal.Decimal("-7.50"), decimal.Decimal("99999.99"),
                decimal.Decimal("0.005"), decimal.Decimal("12.34")]
    t = pa.table({"k": key, "v": pa.array(np.arange(len(key),
                                                    dtype=np.int64))})
    buf = io.BytesIO()
    import pyarrow.parquet as papq

    papq.write_table(t, buf, row_group_size=2000, data_page_size=1024,
                     write_page_index=True, store_decimal_as_integer=True)
    data = buf.getvalue()
    got, want = _both(data, keys, ["v"])
    _assert_same(got, want, ["v"])
    assert got[0].num_rows == 1000 and got[1].num_rows == 1000
    assert got[-1].num_rows == 0
