"""The port's caches (``parquet_tpu_torch/io/cache.py``) on the CPU: the
footer cache and its invalidation, the page cache's cap, refusals and
frozen entries, the negative-lookup memo, in-memory sources left
uncached, and the warm-repeat counters of a lookup on a file on disk held
to parquet_tpu's for the same sequence of calls.  Every test starts from
cleared caches in both packages.
"""

import io
import os

import numpy as np
import pytest

import parquet_tpu
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch.io import cache, source

CPU = "cpu"
N = 4000


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    parquet_tpu.clear_caches()
    pqt.clear_caches(reset_stats=True)
    monkeypatch.setenv("PARQUET_TPU_LOOKUP_KEY_SHARD", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "0")
    yield
    parquet_tpu.clear_caches()
    pqt.clear_caches(reset_stats=True)


def _table(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": np.sort(rng.integers(0, N // 2, N)).astype(np.int64),
            "v": np.ma.masked_array(rng.random(N),
                                    mask=rng.random(N) < 0.1),
            "c": rng.integers(0, 50, N).astype(np.int32)}


def _write_port(sink, seed: int = 1) -> None:
    if not hasattr(sink, "write"):
        sink = str(sink)
    pqt.write_table(_table(seed), sink, pqt.WriterOptions(
        row_group_size=1000, data_page_size=1024, bloom_filters={"k": 10}))


def test_reopen_is_served_from_the_footer_cache(tmp_path, monkeypatch):
    """A second open of the same bytes reads no tail: the spy on every
    source's pread sees none, and the parsed footer is shared."""
    path = tmp_path / "f.parquet"
    _write_port(path)
    first = pqt.ParquetFile(str(path))
    calls = []
    for cls in (source.MmapSource, source.FileSource):
        real = cls.pread

        def spy(self, offset, size, real=real):
            calls.append((offset, size))
            return real(self, offset, size)

        monkeypatch.setattr(cls, "pread", spy)
    second = pqt.ParquetFile(str(path))
    assert calls == []
    assert second.metadata is first.metadata
    assert second.schema is first.schema
    st = pqt.cache_stats()
    assert (st.footer_misses, st.footer_hits, st.footer_entries) == (1, 1, 1)
    np.testing.assert_array_equal(second.read(device=CPU)["k"].values.numpy(),
                                  _table(1)["k"])


def test_in_place_rewrite_by_the_writer_invalidates(tmp_path, monkeypatch):
    """A rewrite in place of the same size by the port's writer, whose
    fstat identity the caches cannot tell from the old file's (pinned
    here as one tick of the clock would leave it), drops the cached
    footer: the reopen reads the new bytes."""
    path = tmp_path / "f.parquet"
    monkeypatch.setattr(source, "_stat_key",
                        lambda p, st: (os.path.abspath(p), 1, 1, 1))
    plain = pqt.WriterOptions(compression="uncompressed")  # same size
    pqt.write_table({"x": np.arange(100, dtype=np.int64)}, str(path), plain)
    size = path.stat().st_size
    assert pqt.ParquetFile(str(path)).read(device=CPU)["x"].values[0] == 0
    pqt.write_table({"x": np.arange(100, dtype=np.int64) + 7}, str(path),
                    plain)
    assert path.stat().st_size == size
    got = pqt.ParquetFile(str(path)).read(device=CPU)["x"].values.numpy()
    np.testing.assert_array_equal(got, np.arange(100) + 7)
    assert pqt.cache_stats().footer_hits == 0


def test_invalidate_path_drops_pages_and_memo(tmp_path):
    path = tmp_path / "f.parquet"
    _write_port(path)
    pf = pqt.ParquetFile(str(path))
    pf.find_rows("k", [3, 5, N], columns=["v"], device=CPU)
    assert cache.PAGES._entries and cache.NEGS._entries
    cache.invalidate_path(str(path))
    assert not cache.PAGES._entries and not cache.NEGS._entries
    assert not cache.FOOTERS._entries
    assert cache.NEGS.resident_bytes == 0


def test_page_cache_cap_eviction_refusal_and_frozen(monkeypatch):
    """Entries stay under the byte cap (LRU out first), an entry over half
    the cap is refused but still frozen, and no entry is writable."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_PAGE_CACHE", "10000")
    pages = cache.PageCache(cache.CacheStats())
    for i in range(30):
        e = pages.put(("f", 0, "k", i), np.full(125, i, np.int64), None,
                      0, 125)
        assert pages._bytes <= 10000
    assert pages.stats.page_evictions == 30 - 10
    assert pages.get(("f", 0, "k", 0)) is None
    assert pages.get(("f", 0, "k", 29)) is e
    with pytest.raises(ValueError):
        e.values[0] = 1
    big = pages.put(("f", 0, "k", "big"), np.zeros(700, np.int64),
                    np.ones(700, bool), 0, 700)
    assert pages.get(("f", 0, "k", "big")) is None
    assert not big.values.flags.writeable
    assert not big.validity.flags.writeable
    rows = cache.ByteRows(np.frombuffer(b"abcdef", np.uint8).copy(),
                          np.array([0, 2, 2, 6]))
    e = pages.put(("f", 0, "s", 0), rows, np.array([True, False, True]),
                  0, 3)
    assert e.values.row(2) == b"cdef"
    with pytest.raises(ValueError):
        e.values.data[0] = 1
    with pytest.raises(ValueError):
        e.validity[0] = False
    assert pages.shrink_to(0) >= 1 and pages._bytes == 0
    monkeypatch.setenv("PARQUET_TPU_TORCH_PAGE_CACHE", "0")
    pages.put(("f", 0, "k", 1), np.arange(4), None, 0, 4)
    assert pages.get(("f", 0, "k", 1)) is None


def test_page_entries_of_a_lookup_are_frozen(tmp_path):
    path = tmp_path / "f.parquet"
    _write_port(path)
    key = int(_table(1)["k"][10])
    pqt.ParquetFile(str(path)).find_rows("k", [key], columns=["v"],
                                         device=CPU)
    assert cache.PAGES._entries
    for entry, _ in cache.PAGES._entries.values():
        assert not entry.values.flags.writeable
        # a view of its own copy, never of a whole decoded run
        assert entry.values.base is None or \
            entry.values.base.nbytes == entry.values.nbytes


def test_negative_memo_cap_and_hits(monkeypatch):
    negs = cache.NegLookupCache()
    negs.add(("f", 0, "k"), [1, 2, 3])
    negs.add(("f", 0, "s"), [b"abc"])
    assert negs.absent_mask(("f", 0, "k"), [1, 4, 3]).tolist() == [
        True, False, True]
    assert negs.absent_mask(("f", 1, "k"), [1]) is None
    assert negs.resident_bytes == 3 * 64 + 64 + 3
    monkeypatch.setenv("PARQUET_TPU_TORCH_NEG_LOOKUP", "200")
    negs.add(("f", 2, "k"), [9, 10])  # over the cap: the oldest chunks go
    assert negs.resident_bytes <= 200
    assert negs.absent_mask(("f", 0, "k"), [1]) is None
    monkeypatch.setenv("PARQUET_TPU_TORCH_NEG_LOOKUP", "0")
    negs.add(("f", 3, "k"), [1])
    assert negs.absent_mask(("f", 3, "k"), [1]) is None


@pytest.mark.parametrize("extra", [0, 1, 5])
def test_a_memo_entry_over_the_cap_empties_the_memo_as_jax(monkeypatch,
                                                            extra):
    """A chunk whose absent keys alone pass the cap leaves the memo empty,
    as the JAX package's eviction does (the port skips the inserts); one
    that fits keeps the reference's entries."""
    from parquet_tpu.io.cache import NegLookupCache as JNegLookupCache

    monkeypatch.setenv("PARQUET_TPU_TORCH_NEG_LOOKUP", str(64 * 8))
    monkeypatch.setenv("PARQUET_TPU_NEG_LOOKUP", str(64 * 8))
    port, ref = cache.NegLookupCache(), JNegLookupCache()
    for memo in (port, ref):
        memo.add(("f", 0, "k"), [1, 2, 3])
        memo.add(("f", 1, "k"), list(range(100, 104 + extra)))
    assert port.resident_bytes == ref.resident_bytes
    for rg in (0, 1):
        keys = [1, 2, 100, 103, 104]
        got = port.absent_mask(("f", rg, "k"), keys)
        want = ref.absent(("f", rg, "k"), keys)
        assert (set() if got is None else
                {k for k, hit in zip(keys, got.tolist()) if hit}) == want


def test_in_memory_sources_are_never_cached():
    buf = io.BytesIO()
    _write_port(buf)
    data = buf.getvalue()
    for _ in range(2):
        res = pqt.ParquetFile(data).find_rows("k", [3, 5, N], columns=["v"],
                                              device=CPU)
        assert res.counters["page_cache_hits"] == 0
        assert res.counters["neg_hits"] == 0
        assert res.counters["preads"] > 0
    st = pqt.cache_stats()
    assert st.footer_hits == st.footer_misses == st.page_hits == 0
    assert not cache.PAGES._entries and not cache.NEGS._entries


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_warm_repeat_counters_match_jax(tmp_path, writer):
    """The same calls on a file on disk, from cleared caches, in both
    packages: a cold lookup, its exact repeat (on a new handle), a batch
    that overlaps it, and the repeat on the first handle.  Every call's
    counters equal the reference's; the exact repeat reads nothing and
    decodes nothing, its absent keys served by the memo."""
    path = str(tmp_path / "f.parquet")
    table = _table(2)
    if writer == "port":
        _write_port(path, 2)
    else:
        import pyarrow as pa

        arrow = pa.table({
            "k": pa.array(table["k"]),
            "v": pa.array(np.ma.getdata(table["v"]),
                          mask=np.ma.getmaskarray(table["v"])),
            "c": pa.array(table["c"])})
        jwrite_table(arrow, path, JWriterOptions(
            row_group_size=1000, data_page_size=1024,
            bloom_filters={"k": 10}, dictionary=["c"]))
    rng = np.random.default_rng(3)
    cold = rng.integers(-5, N // 2 + 5, 60).tolist()
    overlap = cold[::2] + rng.integers(0, N // 2, 30).tolist()
    calls = [("new", cold), ("new", cold), ("new", overlap), ("first", cold)]
    for pkg in ("port", "jax"):
        first = None
        seen = []
        for handle, keys in calls:
            pf = (pqt.ParquetFile(path) if pkg == "port"
                  else parquet_tpu.ParquetFile(path))
            if first is None:
                first = pf
            if handle == "first":
                pf = first
            kw = {"device": CPU} if pkg == "port" else {}
            res = pf.find_rows("k", keys, columns=["v", "c"], **kw)
            seen.append((res.counters, [h.rows.tolist() for h in res]))
        if pkg == "port":
            port = seen
        else:
            ref = seen
    for (gc, gr), (wc, wr) in zip(port, ref):
        assert gr == wr
        assert gc == wc
    warm = port[1][0]
    assert warm["preads"] == warm["pages_read"] == 0
    assert warm["page_cache_hits"] > 0 and warm["neg_hits"] > 0
    assert port[0][0]["page_cache_hits"] == port[0][0]["neg_hits"] == 0


def test_clear_caches_resets_stats(tmp_path):
    path = tmp_path / "f.parquet"
    _write_port(path)
    pqt.ParquetFile(str(path)).find_rows("k", [int(_table(1)["k"][10])],
                                         device=CPU)
    pqt.ParquetFile(str(path))
    st = pqt.cache_stats()
    assert st.footer_hits == 1 and st.page_misses > 0
    assert st.as_dict()["page_capacity"] == 64 << 20
    pqt.clear_caches()
    assert pqt.cache_stats().footer_hits == 1
    assert pqt.cache_stats().footer_entries == 0
    pqt.clear_caches(reset_stats=True)
    assert pqt.cache_stats().footer_hits == 0
