"""The lookup leftovers of parquet_tpu_torch against parquet_tpu, on the
CPU: ``find_rows`` over BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY, BOOLEAN and
byte-array DECIMAL key and value columns (files from the port's writer,
the JAX package's writer and pyarrow, with nulls), byte-array bloom
filters read across the two writers, leaves under optional structs as
keys and values (a repeated column raises as in the reference), a batch
the reference shards, ``Dataset.find_rows``
and the C++ ``pq_xxh64_batch``.  Hits (rows, values, validity) and
counters are held exact.  Every test starts from cleared caches in both
packages, and the lookups run on in-memory bytes unless a path is the
point (the cache tiers then stay out of the counters).
"""

import decimal
import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu.format.enums import Type as JType
from parquet_tpu.io.bloom import xxh64_bytes as jxxh64_bytes
from parquet_tpu.io.writer import ColumnData as JColumnData
from parquet_tpu.io.writer import ParquetWriter as JParquetWriter
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table
from parquet_tpu.schema import schema as jsch
from parquet_tpu.schema.types import LogicalKind as JLogicalKind

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.io import bloom as tbloom
from parquet_tpu_torch.io.lookup import COUNTER_KEYS
from parquet_tpu_torch.io.writer import schema_of as table_schema_of
from parquet_tpu_torch.ops import host

N = 3000
RG = 1000
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    parquet_tpu.clear_caches()
    pqt.clear_caches()
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "0")
    yield
    parquet_tpu.clear_caches()
    pqt.clear_caches()


def _columns(seed: int) -> dict:
    """``s`` strings of 400 values with 5 % nulls, ``p`` distinct binary
    keys with nulls, ``fx`` 6-byte rows with nulls, ``b`` booleans with
    nulls, ``fd`` a decimal(25, 2) with nulls (FLBA storage), ``v`` the row
    number."""
    rng = np.random.default_rng(seed)
    null = rng.random((4, N)) < 0.05
    s = [f"user-{i:04d}".encode() for i in rng.integers(0, 400, N)]
    p = [b"%08d" % i + bytes(rng.integers(0, 256, i % 40, dtype=np.uint8))
         for i in range(N)]
    fx = rng.integers(0, 3, (N, 6)).astype(np.uint8)
    b = rng.random(N) < 0.3
    fd = [decimal.Decimal(f"{(i * 37) % 500 - 250}.50") for i in range(N)]
    return {"s": (s, null[0]), "p": (p, null[1]), "fx": (fx, null[2]),
            "b": (b, null[3]), "fd": (fd, null[3]),
            "v": (np.arange(N, dtype=np.int64), None)}


def _arrow(cols: dict) -> pa.Table:
    out = {}
    for name, (vals, null) in cols.items():
        if name == "fx":
            arr = pa.array([bytes(r) for r in vals], pa.binary(6),
                           mask=null)
        elif name == "fd":
            arr = pa.array(vals, pa.decimal128(25, 2), mask=null)
        elif name == "b":
            arr = pa.array(vals, mask=null)
        elif name == "v":
            arr = pa.array(vals)
        else:
            arr = pa.array(vals, pa.binary(), mask=null)
        out[name] = arr
    return pa.table(out)


def _port_table(cols: dict):
    """The columns as the port's ``write_table`` takes them, and their
    schema (the nullable FLBA rows go in as ``ColumnData``)."""
    out = {}
    for name, (vals, null) in cols.items():
        if name == "fd":
            continue  # the port's write_table takes no decimal input
        if name in ("s", "p"):
            arr = np.empty(N, object)
            arr[:] = vals
        else:
            arr = vals
        if null is not None:
            mask = null if arr.ndim == 1 else np.repeat(null[:, None],
                                                        arr.shape[1], 1)
            arr = np.ma.masked_array(arr, mask=mask)
        out[name] = arr
    schema = table_schema_of(out)
    vals, null = cols["fx"]
    out["fx"] = pqt.ColumnData(values=vals[~null], validity=~null)
    return out, schema


BLOOM = {"s": 10, "p": 10, "fx": 10}


def _write(writer: str, seed: int) -> bytes:
    cols = _columns(seed)
    buf = io.BytesIO()
    if writer == "port":
        table, schema = _port_table(cols)
        pqt.write_table(table, buf, pqt.WriterOptions(
            row_group_size=RG, data_page_size=1024, bloom_filters=BLOOM,
            column_encoding={"p": Encoding.PLAIN}), schema=schema)
    elif writer == "jax":
        jwrite_table(_arrow(cols), buf, JWriterOptions(
            row_group_size=RG, data_page_size=1024, bloom_filters=BLOOM,
            dictionary=["s"]))
    else:
        papq.write_table(_arrow(cols), buf, row_group_size=RG,
                         data_page_size=1024, write_page_index=True,
                         use_dictionary=["s", "b"])
    return buf.getvalue()


def _keys(column: str, seed: int) -> list:
    cols = _columns(seed)
    vals, null = cols[column]
    present = [vals[i] for i in (0, 5, 17, 2999)]
    if column == "fx":
        present = [bytes(v) for v in present]
        return present + [b"\x09" * 6, b"\x00" * 5, present[0]]
    if column == "b":
        return [True, False, 1, None]
    if column == "fd":
        return present + [decimal.Decimal("0.50"), decimal.Decimal("7.25"),
                          decimal.Decimal("123456.00")]
    # absent keys inside each row group's range: only the bloom filter or
    # the pages can drop them
    inside = ([b"user-0%03d!" % i for i in range(0, 400, 40)]
              if column == "s" else [b"%08d~" % i for i in range(0, N, 300)])
    return present + inside + [
        present[1].decode() if column == "s" else b"nope", b"",
        b"user-9999", None, present[0]]


def _same_values(g, w, what) -> None:
    if isinstance(w, list):
        assert isinstance(g, list) and g == w, what
        return
    g, w = np.asarray(g), np.asarray(w)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_same(got, want, columns) -> None:
    assert len(got) == len(want)
    for g, h in zip(got, want):
        np.testing.assert_array_equal(g.rows, h.rows, err_msg=repr(h.key))
        assert g.rows.dtype == np.int64
        for c in columns:
            _same_values(g.values[c], h.values[c], f"{c} of {h.key!r}")
            if h.validity[c] is None:
                assert g.validity[c] is None, (c, h.key)
            else:
                np.testing.assert_array_equal(g.validity[c], h.validity[c])
    assert got.counters == want.counters


def _both(data, key, keys, columns):
    want = parquet_tpu.ParquetFile(data).find_rows(key, keys,
                                                   columns=columns)
    got = pqt.ParquetFile(data).find_rows(key, keys, columns=columns,
                                          device=CPU)
    return got, want


@pytest.mark.parametrize("writer", ["port", "jax", "pyarrow"])
@pytest.mark.parametrize("key", ["s", "p", "fx", "b"])
def test_byte_flba_bool_keys_and_values_match_jax(writer, key):
    data = _write(writer, 7)
    columns = ["v", "s", "p", "fx", "b"]
    if writer != "port":
        columns.append("fd")
    got, want = _both(data, key, _keys(key, 7), columns)
    _assert_same(got, want, columns)
    assert got.counters["rows_matched"] > 0
    if writer != "pyarrow" and key != "b":
        assert got.counters["keys_pruned_bloom"] > 0


@pytest.mark.parametrize("writer", ["jax", "pyarrow"])
def test_flba_decimal_key_matches_jax(writer):
    data = _write(writer, 8)
    keys = _keys("fd", 8)
    got, want = _both(data, "fd", keys, ["v", "fd", "s"])
    _assert_same(got, want, ["v", "fd", "s"])
    assert got.counters["rows_matched"] > 0


def _byte_array_decimal(sort: bool) -> bytes:
    """A decimal over BYTE_ARRAY (minimal big-endian two's complement,
    negatives among them) from the JAX package's writer, with a bloom
    filter; ``sort`` declares its rows sorted by it."""
    root = jsch.message("m", [
        jsch.optional(jsch.leaf("bd", JType.BYTE_ARRAY,
                                logical=JLogicalKind.DECIMAL, precision=20,
                                scale=2)),
        jsch.leaf("v", JType.INT64)])
    unscaled = [(i * 7919) % 2001 - 1000 for i in range(2000)]
    if sort:
        unscaled.sort()
    raws = [u.to_bytes(max(1, (u.bit_length() + 8) // 8), "big",
                       signed=True) for u in unscaled]
    valid = np.array([i % 29 != 3 for i in range(2000)])
    buf = io.BytesIO()
    w = JParquetWriter(buf, root, JWriterOptions(
        dictionary=False, row_group_size=500, data_page_size=1 << 9,
        bloom_filters={"bd": 10},
        sorting_columns=[("bd", False, False)] if sort else []))
    for a in range(0, 2000, 500):
        part = [r for r, ok in zip(raws[a:a + 500], valid[a:a + 500]) if ok]
        offs = np.zeros(len(part) + 1, np.int64)
        np.cumsum([len(r) for r in part], out=offs[1:])
        w.write_row_group({
            "bd": JColumnData(values=np.frombuffer(b"".join(part), np.uint8),
                              offsets=offs, validity=valid[a:a + 500]),
            "v": JColumnData(values=np.arange(a, a + 500, dtype=np.int64))},
            500)
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("sort", [False, True])
def test_byte_array_decimal_key_matches_jax(sort):
    data = _byte_array_decimal(sort)
    D = decimal.Decimal
    keys = [D("-10.00"), D("0.00"), D("9.99"), D("-0.01"), D("10.00"),
            D("3.005"), D("500.00"), 7, -1000]
    got, want = _both(data, "bd", keys, ["v", "bd"])
    _assert_same(got, want, ["v", "bd"])
    assert got.counters["rows_matched"] > 0


def test_sorted_byte_array_pages_binary_search_as_jax():
    """Rows declared sorted by a string key: each (key, page) probe is an
    in-page binary search over the byte rows, counted as the reference
    counts it."""
    rng = np.random.default_rng(3)
    words = np.sort(np.array([b"k%06d" % i for i in
                              rng.integers(0, 5000, N)], object))
    buf = io.BytesIO()
    pqt.write_table({"k": words, "v": np.arange(N, dtype=np.int64)}, buf,
                    pqt.WriterOptions(row_group_size=RG, data_page_size=512,
                                      bloom_filters={"k": 10},
                                      sorting_columns=[("k", False, False)]))
    keys = list(words[::97]) + [b"k999999", b"a", words[5]]
    got, want = _both(buf.getvalue(), "k", keys, ["v", "k"])
    _assert_same(got, want, ["v", "k"])
    assert got.counters["binary_search_hits"] > 0


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_byte_array_bloom_filters_cross_writers(direction):
    """A BYTE_ARRAY and an FLBA bloom filter written by one package prune
    the other's lookup: equal hits, equal counters, absent keys pruned."""
    data = _write("port" if direction == "port_to_jax" else "jax", 9)
    cols = _columns(9)
    absent = [b"user-%04d!" % i for i in range(0, 400, 10)]
    got, want = _both(data, "s", [cols["s"][0][3]] + absent, ["v"])
    _assert_same(got, want, ["v"])
    assert got.counters["keys_pruned_bloom"] >= 30
    # inside the chunks' byte range, but no stored row holds a 3
    absent_fx = [bytes(t) for a in range(3) for b in range(3)
                 for c in range(3)
                 for t in ((1, a, 3, b, c, 0), (0, a, b, 3, c, 1))]
    got, want = _both(data, "fx", absent_fx, ["v"])
    _assert_same(got, want, ["v"])
    assert got.counters["keys_pruned_bloom"] >= 30


def _struct_file(writer: str, seed: int) -> tuple:
    """(bytes, ids): an optional struct ``user {id INT64 optional, score
    DOUBLE}`` with 10 % null structs and 5 % null ids, and a flat ``k``,
    three row groups with a page index; the port's writer adds a bloom
    filter on ``user.id``."""
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.schema import schema as S

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, N).astype(np.int64)
    score = rng.random(N)
    null_struct = rng.random(N) < 0.1
    null_id = (rng.random(N) < 0.05) & ~null_struct
    buf = io.BytesIO()
    if writer == "pyarrow":
        user = pa.StructArray.from_arrays(
            [pa.array(ids, mask=null_id), pa.array(score)],
            names=["id", "score"], mask=pa.array(null_struct))
        papq.write_table(pa.table({"user": user, "k": pa.array(
            np.arange(N, dtype=np.int64))}), buf, row_group_size=RG,
            write_page_index=True, data_page_size=512)
        return buf.getvalue(), ids
    schema = S.message("m", [
        S.optional(S.group("user", [S.optional(S.leaf("id", Type.INT64)),
                                    S.leaf("score", Type.DOUBLE)])),
        S.leaf("k", Type.INT64)])
    id_def = np.where(null_struct, 0, np.where(null_id, 1, 2))
    score_def = np.where(null_struct, 0, 1)
    pqt.write_table(
        {"user.id": pqt.ColumnData(values=ids[id_def == 2],
                                   def_levels=id_def),
         "user.score": pqt.ColumnData(values=score[score_def == 1],
                                      def_levels=score_def),
         "k": np.arange(N, dtype=np.int64)}, buf,
        pqt.WriterOptions(row_group_size=RG, data_page_size=512,
                          bloom_filters={"user.id": 10}), schema=schema)
    return buf.getvalue(), ids


@pytest.mark.parametrize("writer", ["port", "pyarrow"])
def test_struct_leaf_key_matches_jax(writer):
    """A leaf under an optional struct is a key: a null id or a null
    struct never matches; hits, values and counters are the reference's
    (bloom pruning included where the port's writer wrote a filter)."""
    data, ids = _struct_file(writer, 12)
    keys = [int(v) for v in ids[:60:3]] + [10 ** 6, 501, -1]
    got, want = _both(data, "user.id", keys, ["user.score", "k"])
    _assert_same(got, want, ["user.score", "k"])
    assert got.counters["rows_matched"] > 0
    if writer == "port":
        assert got.counters["keys_pruned_bloom"] > 0


@pytest.mark.parametrize("writer", ["port", "pyarrow"])
def test_struct_leaf_values_match_jax(writer):
    """Struct leaves as value columns: a row whose struct or id is null
    has validity False, as in the reference."""
    data, _ = _struct_file(writer, 13)
    keys = list(range(0, N, 7)) + [N + 5]
    got, want = _both(data, "k", keys, ["user.id", "user.score"])
    _assert_same(got, want, ["user.id", "user.score"])
    valid = np.concatenate([h.validity["user.id"] for h in got
                            if h.num_rows])
    assert not valid.all() and valid.any()


@pytest.mark.parametrize("where", ["key", "value"])
def test_repeated_key_or_value_column_raises_as_jax(where):
    buf = io.BytesIO()
    papq.write_table(pa.table({"l": pa.array([[1, 2], None, [3]]),
                               "k": pa.array([1, 2, 3])}), buf)
    key, columns = (("l.list.element", None) if where == "key"
                    else ("k", ["l.list.element"]))
    with pytest.raises(ValueError, match="nested") as mine:
        pqt.ParquetFile(buf.getvalue()).find_rows(key, [1], columns=columns,
                                                  device=CPU)
    with pytest.raises(ValueError, match="nested") as theirs:
        parquet_tpu.ParquetFile(buf.getvalue()).find_rows(key, [1],
                                                          columns=columns)
    assert type(mine.value) is type(theirs.value)


# ---------------------------------------------------------------------------
# a batch the reference shards (the port does not)
# ---------------------------------------------------------------------------


def _numeric_file(tmp_path) -> str:
    path = str(tmp_path / "k.parquet")
    k = np.arange(N, dtype=np.int64) * 3
    pqt.write_table({"k": k, "v": np.arange(N, dtype=np.float64)}, path,
                    pqt.WriterOptions(row_group_size=RG, data_page_size=512,
                                      bloom_filters={"k": 10}))
    return path


def _big_batch(source: str, tmp_path):
    """(file, key column, keys, output columns): 500 distinct byte keys on
    in-memory bytes, or 4,500 integer keys on a file on disk."""
    if source == "bytes":
        cols = _columns(11)
        rng = np.random.default_rng(11)
        keys = ([cols["p"][0][i] for i in rng.integers(0, N, 300)]
                + [b"absent-%d" % i for i in range(200)])
        return _write("port", 11), "p", keys, ["v", "s"]
    return (_numeric_file(tmp_path), "k",
            np.arange(0, 3 * N, 2, dtype=np.int64), ["v"])


def _shard_both(monkeypatch, floor: str) -> None:
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", floor)
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", floor)


def _same(got, want, columns) -> None:
    for g, h in zip(got, want):
        np.testing.assert_array_equal(g.rows, h.rows)
        for c in columns:
            if isinstance(h.values[c], list):
                assert g.values[c] == h.values[c]
            else:
                np.testing.assert_array_equal(g.values[c], h.values[c])
            if h.validity[c] is None:
                assert g.validity[c] is None
            else:
                np.testing.assert_array_equal(g.validity[c], h.validity[c])


@pytest.mark.parametrize("source", ["bytes", "path"])
def test_a_batch_the_reference_shards_matches_jax(monkeypatch, tmp_path,
                                                  source):
    """With both packages' shard floors at 8, both fan the batch out on
    their pools (``key_shards`` >= 2) and give the same hits and the same
    key counters."""
    data, key, keys, columns = _big_batch(source, tmp_path)
    _shard_both(monkeypatch, "8")
    got, want = _both(data, key, keys, columns)
    assert want.counters["key_shards"] >= 2
    assert got.counters["key_shards"] >= 2
    _same(got, want, columns)
    for k in ("keys", "keys_pruned_stats", "keys_pruned_bloom",
              "keys_pruned_pages", "rows_matched", "chunk_fallbacks",
              "binary_search_hits"):
        assert got.counters[k] == want.counters[k], k


# the counters a sharded lookup may move otherwise than the serial one: the
# shards fetch the pages their keys need, so a run of adjacent pages the
# serial run reads in one pread can take several
SHARD_MAY_DIFFER = ("preads", "pages_coalesced", "key_shards")


@pytest.mark.parametrize("source", ["bytes", "path"])
def test_a_sharded_lookup_is_the_serial_one(monkeypatch, tmp_path, source):
    """At a floor of 8 against 0, from cleared caches: the same hits and
    every counter but ``preads`` and ``pages_coalesced``: each page is
    read once (``pages_read``) and asked of the page cache once
    (``page_cache_hits``), and the absent-key memo holds the same keys.
    Then a warm run of each, which on a path reads nothing."""
    from parquet_tpu_torch.io import cache as tcache

    data, key, keys, columns = _big_batch(source, tmp_path)
    runs = {}
    for floor in ("0", "8"):
        _shard_both(monkeypatch, floor)
        pqt.clear_caches()
        f = pqt.ParquetFile(data)
        cold = f.find_rows(key, keys, columns=columns, device=CPU)
        negs = {k: set(v[0]) for k, v in tcache.NEGS._entries.items()}
        warm = f.find_rows(key, keys, columns=columns, device=CPU)
        runs[floor] = (cold, warm, negs)
    (cold0, warm0, negs0), (cold8, warm8, negs8) = runs["0"], runs["8"]
    assert cold0.counters["key_shards"] == 0
    assert cold8.counters["key_shards"] >= 2
    for a, b in ((cold0, cold8), (warm0, warm8)):
        _same(b, a, columns)
        for k in COUNTER_KEYS:
            if k not in SHARD_MAY_DIFFER:
                assert a.counters[k] == b.counters[k], k
    assert cold8.counters["preads"] >= cold0.counters["preads"]
    assert negs8 == negs0
    if source == "path":
        assert cold0.counters["pages_read"] > 0
        assert warm0.counters["pages_read"] == 0
        assert warm8.counters["preads"] == warm0.counters["preads"] == 0
        assert warm0.counters["page_cache_hits"] > 0


def test_shards_run_on_pool_workers_in_the_callers_context(tmp_path,
                                                           monkeypatch):
    """At a floor of 8, ``_lookup_rg`` runs on the shared pool's workers,
    inside the caller's op scope and under the tenant's page pin: the
    pages the shards fetch land pinned."""
    from parquet_tpu_torch.io import cache as tcache
    from parquet_tpu_torch.io import lookup as tlookup
    from parquet_tpu_torch.obs import scope as tscope
    from parquet_tpu_torch.utils import pool as tpool

    data, key, keys, columns = _big_batch("path", tmp_path)
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "8")
    seen = []
    real = tlookup._lookup_rg

    def lookup_rg(pf, rg, *args):
        seen.append((tpool.in_shared_pool(), tscope.current_op(),
                     tcache.current_pin()))
        return real(pf, rg, *args)

    monkeypatch.setattr(tlookup, "_lookup_rg", lookup_rg)
    with tscope.op_scope("test.sharded") as op, \
            tcache.page_pin_scope("tenant-a", 1 << 30):
        got = pqt.ParquetFile(data).find_rows(key, keys, columns=columns,
                                              device=CPU)
    assert got.counters["key_shards"] >= 2
    assert seen and all(s == (True, op, ("tenant-a", 1 << 30))
                        for s in seen)
    assert op.counters().get("lookup.key_shards") == \
        got.counters["key_shards"]
    assert op.counters().get("lookup.rows_matched") == \
        got.counters["rows_matched"]
    assert tcache.PAGES.pinned_bytes("tenant-a") > 0
    assert len(tcache.PAGES._pinned) == got.counters["pages_read"]
    tcache.PAGES.unpin_tenant("tenant-a")


def test_a_large_batch_runs_on_the_calling_thread(tmp_path, monkeypatch):
    """4,500 distinct keys, more than two shards at the reference's floor
    of 1,024: at the port's floor of 0, its default, every row group's page
    search, reads and match run on the caller's thread, never on the
    shared pool."""
    from parquet_tpu_torch.io import lookup as tlookup
    from parquet_tpu_torch.utils import pool as tpool

    data, key, keys, columns = _big_batch("path", tmp_path)
    seen = []
    real = tlookup._lookup_rg

    def lookup_rg(pf, rg, *args):
        seen.append((rg.index, tpool.in_shared_pool()))
        return real(pf, rg, *args)

    monkeypatch.setattr(tlookup, "_lookup_rg", lookup_rg)
    got = pqt.ParquetFile(data).find_rows(key, keys, columns=columns,
                                          device=CPU)
    assert seen == [(i, False) for i in range(N // RG)]
    assert got.counters["key_shards"] == 0
    assert got.rows_total == len(keys) // 3 + (len(keys) % 3 > 0)


# ---------------------------------------------------------------------------
# Dataset.find_rows
# ---------------------------------------------------------------------------


def _parts(tmp_path, n_files: int = 3) -> list:
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"part-{i}.parquet")
        cols = _columns(20 + i)
        jwrite_table(_arrow(cols), p, JWriterOptions(
            row_group_size=RG, data_page_size=1024, bloom_filters=BLOOM,
            dictionary=["s"]))
        paths.append(p)
    return paths


def test_dataset_find_rows_matches_jax(tmp_path):
    """Global row ordinals, values and validity equal the reference's;
    the keys count once for the batch, every other counter is the sum of
    the files'."""
    paths = _parts(tmp_path)
    keys = [b"user-0003", b"user-0100", b"nope", "user-0007", None,
            b"user-0003"]
    want = parquet_tpu.Dataset(paths).find_rows("s", keys,
                                                columns=["v", "p", "fx"])
    ds = pqt.Dataset(paths)
    got = ds.find_rows("s", keys, columns=["v", "p", "fx"], device=CPU)
    _assert_same(got, want, ["v", "p", "fx"])
    assert got.counters["keys"] == len(keys)
    offs = ds.row_offsets()
    assert got[0].num_rows > 0 and got[0].rows.max() >= offs[1]
    pqt.clear_caches()
    per_file = [pqt.ParquetFile(p).find_rows("s", keys,
                                             columns=["v", "p", "fx"],
                                             device=CPU)
                for p in paths]
    for k in got.counters:
        if k != "keys":
            assert got.counters[k] == sum(r.counters[k] for r in per_file), k


def test_dataset_find_rows_warm_repeat_matches_jax(tmp_path):
    """The same batch twice over the same paths from cleared caches: the
    second run is served from the page cache and the memo in both
    packages, counter for counter."""
    paths = _parts(tmp_path, 2)
    keys = [b"user-%04d" % i for i in range(0, 800, 9)]
    for _ in range(2):
        want = parquet_tpu.Dataset(paths).find_rows("s", keys,
                                                    columns=["v"])
        got = pqt.Dataset(paths).find_rows("s", keys, columns=["v"],
                                           device=CPU)
        _assert_same(got, want, ["v"])
    assert got.counters["preads"] == 0
    assert got.counters["page_cache_hits"] > 0
    assert got.counters["neg_hits"] > 0


# ---------------------------------------------------------------------------
# the byte-array hash
# ---------------------------------------------------------------------------


def test_xxh64_batch_matches_jax_at_every_length():
    """``pq_xxh64_batch`` and the port's plain ``xxh64_bytes`` against the
    reference's ``xxh64_bytes`` at every length 0-70 (the < 4, 4-7, 8-31
    and >= 32 byte paths and their tails) and at 1,000 bytes."""
    rng = np.random.default_rng(5)
    vals = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in list(range(71)) + [1000]]
    offs = np.zeros(len(vals) + 1, np.int64)
    np.cumsum([len(v) for v in vals], out=offs[1:])
    got = host.xxh64_batch(np.frombuffer(b"".join(vals), np.uint8), offs)
    want = [int(jxxh64_bytes(v)) for v in vals]
    assert got.dtype == np.uint64 and got.tolist() == want
    assert [tbloom.xxh64_bytes(v) for v in vals] == want
    with pytest.raises(ValueError):
        host.xxh64_batch(np.zeros(4, np.uint8), np.array([0, 5]))
    assert len(host.xxh64_batch(np.zeros(0, np.uint8), np.zeros(1))) == 0


def test_writer_bloom_filter_holds_every_byte_array():
    """Every value of a BYTE_ARRAY and an FLBA chunk probes positive in the
    filter the port's writer wrote for it."""
    data = _write("port", 13)
    cols = _columns(13)
    pf = pqt.ParquetFile(data)
    for name in ("p", "fx"):
        leaf = pf.schema.leaf(name)
        vals, null = cols[name]
        for rg in pf.row_groups:
            bf = rg.column(leaf.column_index).bloom_filter()
            rows = range(rg.index * RG, (rg.index + 1) * RG)
            present = [bytes(vals[i]) for i in rows if not null[i]]
            h = tbloom.probe_hashes(leaf, present)
            assert bf.check_hashes(h).all()
