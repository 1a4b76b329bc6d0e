"""The lookup's host C++ (``csrc/host_lookup.cpp``: ``pq_lookup_match``,
``pq_lookup_gather``, ``pq_lookup_gather_ba``) against its numpy twins
(``ops/host.py::lookup_match_numpy``, ``lookup_gather_numpy``), on the
CPU under hypothesis: int64 keys, the unsigned order of uint64, float64
with NaN and -0.0, hashed byte keys with forced hash collisions,
zone-map page lists, empty pages and null rows.  The call releases the
interpreter lock: another Python thread runs while it sorts.
"""

import threading
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from parquet_tpu_torch.io.cache import ByteRows
from parquet_tpu_torch.ops import host

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


@st.composite
def row_groups(draw, kind: str):
    """A row group's fetched pages: ``(keys, row_page, row_local,
    page_first, page_rows, page_values, needles, run_lo, run_hi, lists,
    key_table, needle_ids)`` for :func:`host.lookup_match`."""
    n_pages = draw(st.integers(1, 6))
    rows_of = [draw(st.integers(0, 12)) for _ in range(n_pages)]
    present = [draw(st.lists(st.booleans(), min_size=r, max_size=r))
               for r in rows_of]  # False: a null row, not in the table
    page_first = np.concatenate([[0], np.cumsum(rows_of)[:-1]]).astype(
        np.int64)
    page_rows = np.array(rows_of, np.int64)
    domain = {"i64": st.integers(-4, 4),
              "u64": st.sampled_from([0, 1, 2, 2**63 - 1, 2**63, 2**64 - 1]),
              "f64": st.sampled_from([0.0, -0.0, 1.5, -2.0, float("nan"),
                                      float("inf")]),
              "hash": st.integers(0, 3)}[kind]
    pages, local, keys, values = [], [], [], []
    byte_rows = []  # hashed: each page's rows' bytes
    for p, mask in enumerate(present):
        rows_bytes = []
        for i, ok in enumerate(mask):
            b = draw(st.sampled_from([b"", b"a", b"ab", b"b", b"abc"]))
            rows_bytes.append(b)
            if ok:
                pages.append(p)
                local.append(i)
                keys.append(draw(domain))
        byte_rows.append(rows_bytes)
    for rows_bytes in byte_rows:
        data = b"".join(rows_bytes)
        offs = np.concatenate([[0], np.cumsum([len(b) for b in rows_bytes])
                               ]).astype(np.int64)
        values.append(ByteRows(np.frombuffer(data, np.uint8), offs))
    m = draw(st.integers(0, 8))
    needles = [draw(domain) for _ in range(m)]
    run_lo = np.array([draw(st.integers(0, n_pages - 1)) for _ in range(m)],
                      np.int64)
    run_hi = np.array([draw(st.integers(int(a) + 1, n_pages))
                       for a in run_lo], np.int64)
    lists = None
    if draw(st.booleans()):  # zone-map walks: a page list inside the run
        offs, listed = [0], []
        for a, b in zip(run_lo.tolist(), run_hi.tolist()):
            chosen = sorted(draw(st.sets(st.integers(a, b - 1), max_size=3)))
            listed += chosen
            offs.append(len(listed))
        lists = (np.array(offs, np.int64), np.array(listed, np.int64))
    key_table = needle_ids = None
    if kind == "hash":
        # the needles' bytes: one of the rows' byte strings, so a needle's
        # hash collides with rows of other bytes
        words = [b"", b"a", b"ab", b"b", b"abc"]
        needle_ids = np.array([draw(st.integers(0, len(words) - 1))
                               for _ in range(m)], np.int64)
        key_table = (np.frombuffer(b"".join(words), np.uint8),
                     np.concatenate([[0], np.cumsum([len(w) for w in words])
                                     ]).astype(np.int64))
    dt = {"i64": np.int64, "u64": np.uint64, "f64": np.float64,
          "hash": np.uint64}[kind]
    return (np.array(keys, dt), np.array(pages, np.int64),
            np.array(local, np.int64), page_first, page_rows, values,
            np.array(needles, dt), run_lo, run_hi, lists, key_table,
            needle_ids)


def _match_both(kind, case):
    (keys, pages, local, first, rows, values, needles, lo, hi, lists,
     key_table, ids) = case
    kw = {}
    if kind == "hash":
        kw = dict(page_values=values, key_table=key_table, needle_ids=ids)
    got = host.lookup_match(kind, keys, pages, local, first, rows, needles,
                            lo, hi, lists, **kw)
    want = host.lookup_match_numpy(kind, keys, pages, local, first, rows,
                                   needles, lo, hi, lists, **kw)
    return got, want


@pytest.mark.parametrize("kind", ["i64", "u64", "f64", "hash"])
def test_the_match_is_its_numpy_twin(kind):
    @SETTINGS
    @given(row_groups(kind))
    def check(case):
        (got_offs, got_rows), (want_offs, want_rows) = _match_both(kind,
                                                                   case)
        np.testing.assert_array_equal(got_offs, want_offs)
        np.testing.assert_array_equal(got_rows, want_rows)
        for k in range(len(got_offs) - 1):  # ascending a needle
            part = got_rows[got_offs[k]:got_offs[k + 1]]
            assert np.all(np.diff(part) > 0)

    check()


def test_unsigned_keys_compare_in_unsigned_order():
    keys = np.array([2**64 - 1, 1, 2**63, 2**63 - 1], np.uint64)
    offs, rows = host.lookup_match(
        "u64", keys, np.zeros(4), np.arange(4), [0], [4],
        np.array([2**63, 2**64 - 1, 7], np.uint64), np.zeros(3),
        np.ones(3))
    assert offs.tolist() == [0, 1, 2, 2]
    assert rows.tolist() == [2, 0]


def test_nan_matches_nothing_and_negative_zero_equals_zero():
    keys = np.array([0.0, -0.0, np.nan, 1.0], np.float64)
    offs, rows = host.lookup_match(
        "f64", keys, np.zeros(4), np.arange(4), [0], [4],
        np.array([-0.0, np.nan, 0.0]), np.zeros(3), np.ones(3))
    assert offs.tolist() == [0, 2, 2, 4]
    assert rows.tolist() == [0, 1, 0, 1]


def test_a_hash_collision_is_told_apart_by_the_bytes():
    """Four rows share one hash; only the rows whose bytes are the
    needle's match."""
    page = ByteRows(np.frombuffer(b"xyxy", np.uint8),
                    np.array([0, 1, 2, 3, 4], np.int64))
    table = (np.frombuffer(b"yx", np.uint8), np.array([0, 1, 2], np.int64))
    offs, rows = host.lookup_match(
        "hash", np.full(4, 99, np.uint64), np.zeros(4), np.arange(4), [0],
        [4], np.array([99, 99], np.uint64), np.zeros(2), np.ones(2),
        page_values=[page], key_table=table, needle_ids=np.array([1, 0]))
    assert offs.tolist() == [0, 2, 4]
    assert rows.tolist() == [0, 2, 1, 3]


def test_fixed_width_rows_compare_their_bytes():
    page = np.array([[1, 2], [3, 4], [1, 2]], np.uint8)
    table = (np.array([1, 2], np.uint8), np.array([0, 2], np.int64))
    offs, rows = host.lookup_match(
        "hash", np.full(3, 5, np.uint64), np.zeros(3), np.arange(3), [10],
        [3], np.array([5], np.uint64), np.zeros(1), np.ones(1),
        page_values=[page], key_table=table, needle_ids=np.array([0]))
    assert rows.tolist() == [10, 12]


def test_bad_indexes_raise():
    with pytest.raises(ValueError):  # a row's page outside the table
        host.lookup_match("i64", np.zeros(1, np.int64), [3], [0], [0], [1],
                          np.zeros(1, np.int64), [0], [1])
    with pytest.raises(ValueError):  # a row past its page's rows
        host.lookup_match("i64", np.zeros(1, np.int64), [0], [5], [0], [1],
                          np.zeros(1, np.int64), [0], [1])
    with pytest.raises(ValueError):
        host.lookup_gather([(0, 2, np.arange(2.0), None)], np.array([2]))


@st.composite
def gather_cases(draw, byte_rows: bool):
    n_pages = draw(st.integers(0, 5))
    pages, first = [], 0
    for _ in range(n_pages):
        r = draw(st.integers(0, 6))
        if byte_rows:
            parts = [draw(st.binary(max_size=4)) for _ in range(r)]
            offs = np.concatenate([[0], np.cumsum([len(p) for p in parts])
                                   ]).astype(np.int64)
            vals = ByteRows(np.frombuffer(b"".join(parts), np.uint8), offs)
        else:
            vals = np.array(draw(st.lists(st.integers(-9, 9), min_size=r,
                                          max_size=r)), np.int32)
        valid = (np.array(draw(st.lists(st.booleans(), min_size=r,
                                        max_size=r)), bool)
                 if draw(st.booleans()) else None)
        pages.append((first, r, vals, valid))
        first += r + draw(st.integers(0, 2))  # rows on no fetched page
    spans = [(f, r) for f, r, _, _ in pages if r]
    rows = []
    if spans:
        for _ in range(draw(st.integers(0, 12))):
            f, r = draw(st.sampled_from(spans))
            rows.append(f + draw(st.integers(0, r - 1)))
    return pages, np.array(rows, np.int64)


@pytest.mark.parametrize("byte_rows", [False, True], ids=["fixed", "bytes"])
def test_the_gather_is_its_numpy_twin(byte_rows):
    @SETTINGS
    @given(gather_cases(byte_rows))
    def check(case):
        pages, rows = case
        got = host.lookup_gather(pages, rows)
        want = host.lookup_gather_numpy(pages, rows)
        if byte_rows:
            for g, w in zip(got[0], want[0]):
                np.testing.assert_array_equal(g, w)
        elif len(rows):
            np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])

    check()


def test_fixed_length_rows_gather_whole():
    pages = [(0, 2, np.array([[1, 2, 3], [4, 5, 6]], np.uint8), None),
             (2, 1, np.array([[7, 8, 9]], np.uint8), np.array([False]))]
    vals, valid, row_valid = host.lookup_gather(pages, np.array([2, 0]))
    assert vals.tolist() == [[7, 8, 9], [1, 2, 3]]
    assert valid.tolist() == [False, True]
    assert row_valid.tolist() == [True, False]


def test_the_match_lets_another_thread_run():
    """``ctypes`` releases the interpreter lock for the call: a thread
    that stamps the clock in a loop keeps stamping while the call sorts
    three million rows."""
    rng = np.random.default_rng(0)
    n = 3_000_000
    keys = rng.integers(0, 1 << 40, n)
    args = ("i64", keys, np.zeros(n, np.int64), np.arange(n), [0], [n],
            keys[:4], np.zeros(4), np.ones(4))
    host.lookup_match(*args)  # built and warm
    stamps, stop = [], threading.Event()

    def spin():
        while not stop.is_set():
            stamps.append(time.perf_counter())

    t = threading.Thread(target=spin)
    t.start()
    try:
        while not stamps:
            time.sleep(0.001)
        t0 = time.perf_counter()
        host.lookup_match(*args)
        t1 = time.perf_counter()
    finally:
        stop.set()
        t.join()
    inside = np.array([s for s in stamps if t0 <= s <= t1])
    assert t1 - t0 > 0.05
    assert len(inside) > 1
    gaps = np.diff(np.concatenate([[t0], inside, [t1]]))
    assert gaps.max() < 0.5 * (t1 - t0)
