"""The decoded whole-chunk cache of parquet_tpu_torch (``io/cache.py::
CHUNKS``) against parquet_tpu's, on the CPU, through the lookups of files
without a page index (the lookup's whole-chunk fallback is the cache's
caller in both packages).

The same two lookups from cleared caches move the same ``cache.chunk_*``
counters in both packages and give the same hits and key counters, at the
key-shard knobs' defaults, at ``0`` and at a floor of 8.  Beside them:
the byte cap and its evictions, the knob at ``0``, an oversized chunk
refused, frozen entries, a rewrite dropping the file's entries, an
in-memory source never cached, the ``cache.chunk`` ledger account and its
reclaim under the soft watermark, and ``/debugz``'s ``chunk`` entry.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
import parquet_tpu.io.cache  # noqa: F401 (the reference's chunk cache)
from parquet_tpu.obs import export as jexport

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import cache as tcache
from parquet_tpu_torch.obs import export as texport
from parquet_tpu_torch.obs import ledger as tledger

CPU = "cpu"
N = 6000
RG = 1500
CHUNK_KEYS = ("chunk_hits", "chunk_misses", "chunk_evictions",
              "chunk_entries")
KEY_COUNTERS = ("keys", "keys_pruned_stats", "keys_pruned_bloom",
                "keys_pruned_pages", "rows_matched", "chunk_fallbacks")
SHARD_FLOORS = {"defaults": None, "off": "0", "floor8": "8"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in ("CHUNK_CACHE", "LOOKUP_KEY_SHARD", "MEM_SOFT", "MEM_HARD"):
        monkeypatch.delenv("PARQUET_TPU_TORCH_" + knob, raising=False)
        monkeypatch.delenv("PARQUET_TPU_" + knob, raising=False)
    parquet_tpu.clear_caches()
    pqt.clear_caches(reset_stats=True)
    yield
    parquet_tpu.clear_caches()
    pqt.clear_caches(reset_stats=True)


def _table(seed: int) -> dict:
    """``k`` 600 values in random order, ``v`` a double with 10 % nulls,
    ``s`` strings with 5 % nulls."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 600, N).astype(np.int64),
            "v": np.ma.masked_array(rng.random(N),
                                    mask=rng.random(N) < 0.1),
            "s": np.ma.masked_array(
                np.array([b"s%d" % i for i in rng.integers(0, 50, N)],
                         object), mask=rng.random(N) < 0.05)}


def _write(sink, writer: str = "port", seed: int = 1) -> None:
    """A file without a page index, by the port's writer or pyarrow."""
    t = _table(seed)
    if writer == "port":
        pqt.write_table(t, sink, pqt.WriterOptions(
            row_group_size=RG, write_page_index=False,
            bloom_filters={"k": 10}))
        return
    arrow = pa.table({"k": t["k"],
                      "v": pa.array(np.ma.getdata(t["v"]),
                                    mask=np.ma.getmaskarray(t["v"])),
                      "s": pa.array(list(np.ma.getdata(t["s"])),
                                    mask=np.ma.getmaskarray(t["s"]))})
    papq.write_table(arrow, sink, row_group_size=RG)


@pytest.fixture
def path(tmp_path):
    p = str(tmp_path / "bare.parquet")
    _write(p)
    return p


def _keys(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 600, n // 2).tolist()
            + rng.integers(1000, 2000, n - n // 2).tolist())


def _chunk_delta(stats, before) -> dict:
    return {k: getattr(stats(), k) - getattr(before, k) for k in CHUNK_KEYS}


def _same_hits(got, want, columns) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rows, w.rows)
        for c in columns:
            if isinstance(w.values[c], list):
                assert g.values[c] == w.values[c], c
            else:
                np.testing.assert_array_equal(g.values[c], w.values[c])
            if w.validity[c] is None:
                assert g.validity[c] is None, c
            else:
                np.testing.assert_array_equal(g.validity[c], w.validity[c])


def _two_lookups(find, stats, keys, columns):
    out = []
    for _ in range(2):
        before = stats()
        res = find(keys, columns)
        out.append((res, _chunk_delta(stats, before)))
    return out


def _port_find(p):
    def find(keys, columns):
        with pqt.ParquetFile(p) as pf:
            return pf.find_rows("k", keys, columns=columns, device=CPU)
    return find


def _ref_find(p):
    def find(keys, columns):
        with parquet_tpu.ParquetFile(p) as pf:
            return pf.find_rows("k", keys, columns=columns)
    return find


@pytest.mark.parametrize("floor", list(SHARD_FLOORS), ids=list(SHARD_FLOORS))
@pytest.mark.parametrize("writer", ["port", "pyarrow"])
def test_a_warm_lookup_hits_as_the_reference_does(tmp_path, monkeypatch,
                                                  writer, floor):
    """The cold lookup misses on every (row group, column) it decodes and
    the warm one hits on each, in both packages, with the same hits and
    key counters.  At a floor of 8 both packages shard the 60 keys; the
    port's shards decode each chunk once, so its deltas are its serial
    run's, which are the reference's serial ones (the reference's shards
    each ask the cache, so their hits and misses split by timing)."""
    p = str(tmp_path / f"{writer}.parquet")
    _write(p, writer)
    keys, columns = _keys(3), ["v", "s"]
    if SHARD_FLOORS[floor] is not None:
        monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD",
                           SHARD_FLOORS[floor])
        monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD",
                           SHARD_FLOORS[floor])
    port = _two_lookups(_port_find(p), pqt.cache_stats, keys, columns)
    ref = _two_lookups(_ref_find(p), parquet_tpu.cache_stats, keys, columns)
    for (got, got_d), (want, want_d) in zip(port, ref):
        _same_hits(got, want, columns)
        for k in KEY_COUNTERS[:-1]:
            assert got.counters[k] == want.counters[k], k
        assert (got.counters["key_shards"] >= 2) == (floor == "floor8")
        assert (want.counters["key_shards"] >= 2) == (floor == "floor8")
        if floor != "floor8":
            assert got.counters["chunk_fallbacks"] == \
                want.counters["chunk_fallbacks"]
            assert got_d == want_d
    cold, warm = port[0][1], port[1][1]
    assert cold["chunk_misses"] == cold["chunk_entries"] > 0
    assert cold["chunk_hits"] == 0
    assert warm["chunk_hits"] == cold["chunk_misses"]
    assert warm["chunk_misses"] == 0 and warm["chunk_entries"] == 0
    if floor == "floor8":
        # the serial runs of both packages, from cleared caches
        monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "0")
        monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")
        pqt.clear_caches()
        parquet_tpu.clear_caches()
        serial = _two_lookups(_port_find(p), pqt.cache_stats, keys, columns)
        ref = _two_lookups(_ref_find(p), parquet_tpu.cache_stats, keys,
                           columns)
        for (got, got_d), (s, s_d), (want, want_d) in zip(port, serial,
                                                          ref):
            assert got_d == s_d == want_d
            assert got.counters["chunk_fallbacks"] == \
                s.counters["chunk_fallbacks"] == \
                want.counters["chunk_fallbacks"]


def test_the_byte_cap_evicts_least_recently_used(path, monkeypatch):
    """A cap of three chunks of ``k`` and ``v``: the lookup's eight whole
    chunks (four row groups, two columns) evict down to the cap, and a
    repeat misses on the evicted ones."""
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", _keys(4), columns=["v"], device=CPU)
        entry = max(nb for _, nb in tcache.CHUNKS._entries.values())
    pqt.clear_caches(reset_stats=True)
    cap = 3 * entry
    monkeypatch.setenv("PARQUET_TPU_TORCH_CHUNK_CACHE", str(cap))
    find = _port_find(path)
    (_, cold), (_, warm) = _two_lookups(find, pqt.cache_stats, _keys(4),
                                        ["v"])
    st = pqt.cache_stats()
    assert st.chunk_capacity == cap
    assert 0 < st.chunk_bytes <= cap and st.chunk_entries <= 3
    assert cold["chunk_evictions"] == cold["chunk_misses"] - 3
    assert warm["chunk_misses"] > 0 and warm["chunk_evictions"] > 0


def test_the_knob_at_zero_turns_the_cache_off(path, monkeypatch):
    """Off in both packages: every fallback misses, nothing is kept."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_CHUNK_CACHE", "0")
    monkeypatch.setenv("PARQUET_TPU_CHUNK_CACHE", "0")
    keys = _keys(5)
    port = _two_lookups(_port_find(path), pqt.cache_stats, keys, ["v"])
    ref = _two_lookups(_ref_find(path), parquet_tpu.cache_stats, keys, ["v"])
    for (got, got_d), (want, want_d) in zip(port, ref):
        assert got_d == want_d
        assert got_d["chunk_hits"] == 0 and got_d["chunk_misses"] > 0
        _same_hits(got, want, ["v"])
    assert pqt.cache_stats().chunk_entries == 0
    assert len(tcache.CHUNKS._entries) == 0


def test_an_oversized_chunk_is_refused(path, monkeypatch):
    """A cap under twice a chunk's bytes keeps none of them: an item
    larger than half the cap is refused."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_CHUNK_CACHE", str(RG * 8))
    (_, cold), (_, warm) = _two_lookups(_port_find(path), pqt.cache_stats,
                                        _keys(6), ["v"])
    assert cold["chunk_misses"] > 0 and cold["chunk_entries"] == 0
    assert warm["chunk_misses"] == cold["chunk_misses"]
    assert tcache.CHUNKS._bytes == 0


def test_contains_moves_no_counter(path):
    """``contains`` answers membership without a hit, a miss or a move in
    the LRU's order."""
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", _keys(12), columns=["v"], device=CPU)
    keys = list(tcache.CHUNKS._entries)
    before = pqt.cache_stats()
    assert all(tcache.CHUNKS.contains(k) for k in keys)
    assert not tcache.CHUNKS.contains(("nowhere", 0, "k", False))
    assert list(tcache.CHUNKS._entries) == keys
    after = pqt.cache_stats()
    assert (after.chunk_hits, after.chunk_misses) == (before.chunk_hits,
                                                      before.chunk_misses)


def test_entries_are_frozen(path):
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", _keys(7), columns=["v", "s"], device=CPU)
    assert tcache.CHUNKS._entries
    for entry, nb in tcache.CHUNKS._entries.values():
        assert entry.nbytes() == nb
        values = entry.values
        arrays = ([values.data, values.offsets]
                  if isinstance(values, tcache.ByteRows) else [values])
        if entry.validity is not None:
            arrays.append(entry.validity)
        for a in arrays:
            assert not a.flags.writeable
            with pytest.raises(ValueError):
                a[:1] = 0


def test_a_rewrite_drops_the_files_entries(path):
    """The port's writer invalidates the path it wrote: the old chunks go,
    and a lookup after the rewrite sees the new rows."""
    keys = _keys(8)
    with pqt.ParquetFile(path) as pf:
        pf.find_rows("k", keys, columns=["v"], device=CPU)
    assert tcache.CHUNKS._entries
    _write(path, seed=2)
    assert not tcache.CHUNKS._entries
    assert pqt.cache_stats().chunk_bytes == 0
    before = pqt.cache_stats()
    got = _port_find(path)(keys, ["v"])
    assert _chunk_delta(pqt.cache_stats, before)["chunk_hits"] == 0
    want = _ref_find(path)(keys, ["v"])
    _same_hits(got, want, ["v"])


def test_an_in_memory_source_is_never_cached():
    buf = io.BytesIO()
    _write(buf)
    data = buf.getvalue()
    keys = _keys(9)
    port = _two_lookups(
        lambda k, c: pqt.ParquetFile(data).find_rows("k", k, columns=c,
                                                     device=CPU),
        pqt.cache_stats, keys, ["v"])
    ref = _two_lookups(
        lambda k, c: parquet_tpu.ParquetFile(data).find_rows("k", k,
                                                             columns=c),
        parquet_tpu.cache_stats, keys, ["v"])
    for (got, got_d), (want, want_d) in zip(port, ref):
        assert got_d == want_d == dict.fromkeys(CHUNK_KEYS, 0)
        assert got.counters["chunk_fallbacks"] == \
            want.counters["chunk_fallbacks"] > 0
        _same_hits(got, want, ["v"])
    assert not tcache.CHUNKS._entries


def _resident(name: str) -> int:
    return tledger.LEDGER.accounts()[name].resident


def test_the_ledger_account_and_its_reclaim(path, monkeypatch):
    """``cache.chunk`` holds the tier's bytes; under the soft watermark
    the reclaimer shrinks the tier, and a lookup after gives the same
    hits."""
    keys = _keys(10)
    first = _port_find(path)(keys, ["v", "s"])
    held = tcache.CHUNKS._bytes
    assert held > 0 and _resident("cache.chunk") == held
    assert tledger.LEDGER.accounts()["cache.chunk"].capacity() == \
        tcache.chunk_cache_bytes()
    monkeypatch.setenv("PARQUET_TPU_TORCH_MEM_SOFT",
                       str(tledger.LEDGER.total() // 2))
    tledger.LEDGER.check_pressure()
    assert _resident("cache.chunk") == tcache.CHUNKS._bytes < held
    assert pqt.cache_stats().chunk_evictions > 0
    monkeypatch.delenv("PARQUET_TPU_TORCH_MEM_SOFT")
    again = _port_find(path)(keys, ["v", "s"])
    _same_hits(again, first, ["v", "s"])
    pqt.clear_caches()
    assert _resident("cache.chunk") == 0


def test_debugz_lists_the_largest_chunks(path):
    keys = _keys(11)
    _port_find(path)(keys, ["v", "s"])
    _ref_find(path)(keys, ["v", "s"])
    port = texport.debugz_snapshot()["caches"]["chunk"]
    ref = jexport.debugz_snapshot()["caches"]["chunk"]
    assert set(port) == set(ref)
    assert port["entries"] == ref["entries"] == len(tcache.CHUNKS._entries)
    assert port["bytes"] == tcache.CHUNKS._bytes > 0
    assert port["capacity"] == ref["capacity"] == 256 << 20
    top = port["top"]
    assert [t["bytes"] for t in top] == sorted(
        (nb for _, nb in tcache.CHUNKS._entries.values()), reverse=True)[
            :len(top)]
    with pqt.ParquetFile(path) as pf:
        file_key = str(pf._cache_key)
    for t in top:
        assert t["key"][0] == file_key
        assert t["key"][2] in ("k", "v", "s")
    # the same chunks resident in both packages: (row group, column, CRC)
    assert {k[1:] for k in tcache.CHUNKS._entries} == {
        k[1:] for k in parquet_tpu.io.cache.CHUNKS._entries}
