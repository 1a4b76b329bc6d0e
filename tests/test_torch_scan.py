"""parquet_tpu_torch's device pushdown scan (``scan_filtered_device``,
``stage_scan``, ``decoded_scan``) on the CPU against parquet_tpu's device
scan (JAX on the CPU, its 64-bit outputs through ``pairs_to_host``) and
its host scan ``scan_filtered``: every surviving row, value and validity
bit equal, in file order.  The matrix follows ``tests/test_device_scan.py``:
INT32/INT64/FLOAT/DOUBLE keys, unsigned keys at their domain's ends,
nullable outputs, dictionary string outputs and keys, IN-lists with and
without a bloom filter, PLAIN string outputs (the host-ragged form), the
mixed dictionary/PLAIN demotion, empty results and spans whose pages start
before their first row.  Then the refusals, the bloom-pruned chunk that is
never read, and the one place the port follows the host scan rather than
the reference's device route (a DOUBLE key's signed zeros and NaNs).
Files are small (at most 60,000 rows) and built once each."""

import decimal
import functools
import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from parquet_tpu.io.reader import ParquetFile as JParquetFile
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table
from parquet_tpu.ops.device import pairs_to_host
from parquet_tpu.parallel import host_scan as jhs

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.parallel import host_scan as ths
from torch_fixtures.threads import assert_no_thread_started, threads_now

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


def _pyarrow(table: dict, rg: int, page: int, **kw) -> bytes:
    buf = io.BytesIO()
    papq.write_table(pa.table(table), buf, row_group_size=rg,
                     data_page_size=page, write_page_index=True, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the files, each made once
# ---------------------------------------------------------------------------

N = 60_000


@functools.lru_cache(None)
def lineitem() -> bytes:
    """``tests/test_device_scan.py``'s lineitem, with a nullable price and
    an INT32 quantity whose pages hold twice the rows of the INT64 key's
    (so a span of ``l_orderkey`` starts inside a quantity page)."""
    rng = np.random.default_rng(17)
    ship = np.sort(rng.integers(8000, 12000, N).astype(np.int32))
    price = rng.random(N) * 1e5
    pm = rng.random(N) < 0.05
    return _pyarrow({
        "l_shipdate": pa.array(ship),
        "l_orderkey": pa.array(np.arange(N, dtype=np.int64) * 3),
        "l_quantity": pa.array(rng.integers(1, 50, N).astype(np.int32)),
        "l_extendedprice": pa.array(np.where(pm, 0.0, price), mask=pm),
        "l_tax": pa.array(rng.random(N).astype(np.float32)),
    }, N // 4, 1 << 14, compression="snappy", use_dictionary=False)


@functools.lru_cache(None)
def wide_keys() -> bytes:
    """INT64 keys beyond 2**53, FLOAT and DOUBLE keys with negatives, and
    unsigned INT32/INT64 keys that reach both ends of their domains."""
    rng = np.random.default_rng(3)
    n = 40_000
    u32 = np.sort(rng.integers(0, 2**32, n, dtype=np.uint64)).astype(
        np.uint32)
    u32[:3], u32[-3:] = 0, 2**32 - 1
    u64 = np.sort(rng.integers(0, 2**64 - 1, n, dtype=np.uint64))
    u64[:3], u64[-3:] = 0, 2**64 - 1
    p = rng.random(n) * 2e5 - 1e5
    pm = rng.random(n) < 0.02
    return _pyarrow({
        "k": pa.array(np.arange(n, dtype=np.int64) * (2**40) - 2**60),
        "f": pa.array(np.sort(rng.random(n).astype(np.float32) * 200 - 100)),
        "d": pa.array(np.sort(rng.random(n) * 2e5 - 1e5)),
        "u32": pa.array(u32),
        "u64": pa.array(u64),
        "p": pa.array(np.where(pm, 0.0, p), mask=pm),
        "v": pa.array(np.arange(n, dtype=np.int32)),
    }, n // 4, 1 << 14, use_dictionary=False)


@functools.lru_cache(None)
def strings() -> bytes:
    """A dictionary string key (40 regions), dictionary string outputs
    whose dictionaries differ by row group, and a PLAIN string output with
    nulls; ``k`` is a sorted INT32 key."""
    rng = np.random.default_rng(11)
    n = 40_000
    regions = np.array([f"region_{i:02d}" for i in range(40)])
    s = np.array([f"rg{i // (n // 4)}_{i % 7}" for i in range(n)])
    words = np.array([f"word_{i:04d}"[: 3 + i % 9] for i in range(200)])
    cm = rng.random(n) < 0.1
    return _pyarrow({
        "k": pa.array(np.sort(rng.integers(0, 4000, n).astype(np.int32))),
        "region": pa.array(regions[rng.integers(0, 40, n)]),
        "s": pa.array(s),
        "comment": pa.array(np.where(cm, None, words[rng.integers(0, 200,
                                                                  n)])),
        "v": pa.array(rng.integers(0, 1 << 40, n).astype(np.int64)),
    }, n // 4, 1 << 12, compression="snappy",
        use_dictionary=["region", "s"])


@functools.lru_cache(None)
def bloom_file() -> bytes:
    """The port's writer: PLAIN INT32 keys with a bloom filter, four row
    groups whose [min, max] all overlap but whose values are disjoint (so
    only the filter prunes), and a nullable dictionary INT32 output."""
    n = 32_000
    rng = np.random.default_rng(5)
    k = (np.arange(n, dtype=np.int32) % (n // 4)) * 4 + np.repeat(
        np.arange(4, dtype=np.int32), n // 4)
    cat = np.ma.masked_array(rng.integers(0, 200, n).astype(np.int32),
                             mask=rng.random(n) < 0.1)
    buf = io.BytesIO()
    pqt.write_table({"k": k, "cat": cat, "x": rng.random(n)}, buf,
                    pqt.WriterOptions(row_group_size=n // 4,
                                      data_page_size=4096,
                                      compression="snappy",
                                      column_encoding={
                                          "k": Encoding.PLAIN,
                                          "x": Encoding.PLAIN},
                                      bloom_filters={"k": 10}))
    return buf.getvalue()


@functools.lru_cache(None)
def mixed_dict_plain() -> bytes:
    """The JAX package's writer emits ``s`` dictionary-encoded in one row
    group and PLAIN in the other."""
    n = 40_000
    rng = np.random.default_rng(31)
    ship = np.sort(rng.integers(8000, 12000, n).astype(np.int32))
    s = np.array([f"v{i % 5}" for i in range(n // 2)]
                 + [f"u_{i:06d}" for i in range(n // 2)])
    buf = io.BytesIO()
    jwrite_table(pa.table({"l_shipdate": pa.array(ship), "s": pa.array(s)}),
                 buf, JWriterOptions(compression="snappy",
                                     row_group_size=n // 2,
                                     dictionary_page_limit=1 << 12))
    return buf.getvalue()


@functools.lru_cache(None)
def no_index() -> bytes:
    rng = np.random.default_rng(2)
    n = 20_000
    buf = io.BytesIO()
    papq.write_table(pa.table({
        "k": pa.array(np.sort(rng.integers(0, 1000, n).astype(np.int32))),
        "v": pa.array(rng.random(n))}), buf, row_group_size=n // 4,
        data_page_size=1 << 12, use_dictionary=False,
        write_page_index=False)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# forms -> comparable host values
# ---------------------------------------------------------------------------


def _strings_of(vals, offs, idx=None):
    vals, offs = np.asarray(vals), np.asarray(offs, np.int64)
    rows = range(len(offs) - 1) if idx is None else np.asarray(idx)
    return [vals[offs[i]:offs[i + 1]].tobytes() for i in rows]


def _port_form(form, leaf_type):
    """A port column form -> (values, validity or None)."""
    valid = None
    if isinstance(form, tuple) and len(form) == 2 and (
            getattr(form[1], "dtype", None) in (torch.bool, np.bool_)
            and not (isinstance(form[0], torch.Tensor)
                     and form[0].dtype == torch.uint8
                     and leaf_type == "ba")):
        form, valid = form
        valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor)
                           else valid)
    if isinstance(form, tuple) and isinstance(form[0], tuple):
        (dv, do), idx = form
        vals = _strings_of(dv.cpu(), do.cpu(), idx.cpu())
    elif isinstance(form, tuple):
        vals = _strings_of(*form)
    else:
        vals = form.cpu().numpy()
    return vals, valid


def _ref_form(form, dtype):
    """A JAX device-scan column form -> (values, validity or None)."""
    valid = None
    if isinstance(form, tuple) and len(form) == 2 and \
            getattr(form[1], "dtype", None) == np.bool_ and \
            not isinstance(form[0], np.ndarray):
        form, valid = form
        valid = np.asarray(valid)
    elif isinstance(form, tuple) and len(form) == 2 and \
            np.asarray(form[1]).dtype == np.bool_ and \
            isinstance(form[0], tuple):
        form, valid = form
        valid = np.asarray(valid)
    if isinstance(form, tuple) and isinstance(form[0], tuple):
        (dv, do), idx = form
        vals = _strings_of(dv, do, idx)
    elif isinstance(form, tuple):
        vals = _strings_of(*form)
    elif dtype in (np.int64, np.float64):
        vals = pairs_to_host(form, np.dtype(dtype))
    else:
        vals = np.asarray(form)
    return vals, valid


def _host_form(arr):
    """A host-scan column -> (present values in row order, validity)."""
    if isinstance(arr, np.ma.MaskedArray):
        return np.ma.getdata(arr), ~np.ma.getmaskarray(arr)
    if isinstance(arr, list):
        return ([None if v is None else (v if isinstance(v, bytes)
                                          else v.encode()) for v in arr],
                np.array([v is not None for v in arr], bool))
    return np.asarray(arr), None


def _same_values(a, b, valid=None) -> bool:
    if isinstance(a, list) or isinstance(b, list):
        a, b = list(a), list(b)
        if valid is not None:
            a = [x if v else None for x, v in zip(a, valid)]
            b = [x if v else None for x, v in zip(b, valid)]
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if valid is not None:
        a, b = a[valid], b[valid]
    return np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


_NP = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
       "DOUBLE": np.float64, "BOOLEAN": np.bool_, "BYTE_ARRAY": None}


def _check(data: bytes, path, columns, *, host=True, **kw):
    """The port's scan (on the CPU) equals the JAX package's device scan
    bit for bit (validity included) and, with ``host``, its host scan on
    the present values; returns the port's rows."""
    pf = pqt.ParquetFile(data)
    got = pqt.scan_filtered_device(pf, path, columns=columns, device=CPU,
                                   **kw)
    jpf = JParquetFile(data)
    want = jhs.scan_filtered_device(jpf, path, columns=columns, **kw)
    assert list(got) == list(want)
    rows = None
    for c in columns:
        t = pf.schema.leaf(c).physical_type.name
        gv, gval = _port_form(got[c], "ba" if t == "BYTE_ARRAY" else t)
        wv, wval = _ref_form(want[c], _NP[t])
        assert (gval is None) == (wval is None), c
        if gval is not None:
            np.testing.assert_array_equal(gval, wval, err_msg=c)
        assert _same_values(gv, wv), c
        rows = len(gv)
    if host:
        hs = jhs.scan_filtered(jpf, path, columns=columns, **kw)
        for c in columns:
            t = pf.schema.leaf(c).physical_type.name
            gv, gval = _port_form(got[c], "ba" if t == "BYTE_ARRAY" else t)
            hv, hval = _host_form(hs[c])
            valid = hval if hval is not None else gval
            if gval is not None and hval is not None:
                np.testing.assert_array_equal(gval, hval, err_msg=c)
            assert len(gv) == len(hv), c
            if valid is not None and not isinstance(gv, list):
                assert _same_values(gv[valid], np.asarray(hv)[valid]), c
            else:
                assert _same_values(gv, hv, valid), c
    return rows


# ---------------------------------------------------------------------------
# the scan against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(9000, 9200), (None, 8100), (11900, None),
                                   (9000.5, 9001.5), (10**6, 2 * 10**6),
                                   (-(2**40), 8000)])
def test_int32_key_ranges(lo, hi):
    rows = _check(lineitem(), "l_shipdate",
                  ["l_extendedprice", "l_orderkey", "l_quantity", "l_tax"],
                  lo=lo, hi=hi)
    assert (rows == 0) == (lo == 10**6)


@pytest.mark.parametrize("lo,hi", [(3 * 17_500, 3 * 18_000),
                                   (3 * 8192 + 3, 3 * 9000), (7, 7)])
def test_int64_key_trims_output_pages(lo, hi):
    """``l_orderkey``'s spans start on its own page boundaries, inside the
    pages of ``l_quantity`` (twice as many rows a page) and of the
    nullable price."""
    pf = pqt.ParquetFile(lineitem())
    state = pqt.stage_scan(pf, "l_orderkey", lo=lo, hi=hi,
                           columns=["l_quantity", "l_extendedprice"],
                           device=CPU)
    trims = [per_col[c][2] for _, per_col, _ in state["spans"]
             for c in ("l_quantity", "l_extendedprice")]
    assert any(t > 0 for t in trims) or lo == hi == 7
    _check(lineitem(), "l_orderkey", ["l_quantity", "l_extendedprice",
                                      "l_shipdate"], lo=lo, hi=hi)


@pytest.mark.parametrize("path,lo,hi", [
    ("k", 3 * 2**40 - 2**60, 9000 * 2**40 - 2**60),
    ("k", None, -(2**60) + 5), ("f", -50.5, 20.25), ("f", None, -99.0),
    ("d", -5000.0, 1000.0), ("d", 99_000.0, None)])
def test_wide_and_float_keys(path, lo, hi):
    _check(wide_keys(), path, ["p", "v"], lo=lo, hi=hi)


@pytest.mark.parametrize("path,lo,hi", [
    ("u32", 2**31 - 5, 2**31 + 2**30), ("u32", 0, 0),
    ("u32", 2**32 - 1, None), ("u32", None, 2**31),
    ("u64", 2**63, 2**63 + 2**62), ("u64", 0, 2**62),
    ("u64", 2**64 - 1, 2**64 - 1), ("u64", 2**63 - 1, None)])
def test_unsigned_keys_at_the_domain_ends(path, lo, hi):
    """Unsigned keys filter in unsigned order, at both ends of the
    domain; the rows they give are the numpy oracle's too."""
    rows = _check(wide_keys(), path, ["v"], lo=lo, hi=hi)
    u = papq.read_table(io.BytesIO(wide_keys()), columns=[path])[path]
    u = u.to_numpy()
    want = np.ones(len(u), bool)
    if lo is not None:
        want &= u >= lo
    if hi is not None:
        want &= u <= hi
    assert rows == int(want.sum()) > 0


def test_unsigned_in_list_drops_probes_outside_the_domain():
    u = papq.read_table(io.BytesIO(wide_keys()), columns=["u32"])["u32"]
    u = u.to_numpy()
    probes = [int(u[5]), int(u[-1]), 0, -1, 2**32, 2**31 + 0.5]
    rows = _check(wide_keys(), "u32", ["v"], values=probes)
    assert rows == int(np.isin(u, [int(u[5]), 2**32 - 1, 0]).sum())


def test_dictionary_string_outputs_rebase_across_row_groups():
    n = 40_000
    rows = _check(strings(), "k", ["s", "region", "v"], lo=900, hi=3100)
    assert rows > n // 4  # spans of several row groups


@pytest.mark.parametrize("kw", [dict(lo="region_10", hi="region_15"),
                                dict(lo=None, hi="region_03"),
                                dict(values=["region_07", "region_33",
                                             "nowhere"])])
def test_dictionary_string_key(kw):
    assert _check(strings(), "region", ["v", "k"], **kw) > 0


def test_plain_string_output_with_nulls():
    pf = pqt.ParquetFile(strings())
    state = pqt.stage_scan(pf, "k", lo=500, hi=2600, columns=["comment"],
                           device=CPU)
    assert all(per_col["comment"][0] == "host_ragged"
               for _, per_col, _ in state["spans"])
    first = pqt.decoded_scan(state)
    (vals, offs), valid = first["comment"]
    assert not valid.all()
    again = pqt.decoded_scan(state)  # the state serves any number of calls
    assert np.array_equal(again["comment"][0][1], offs)
    _check(strings(), "k", ["comment", "s"], lo=500, hi=2600)


@pytest.mark.parametrize("use_bloom", [True, False])
def test_single_word_in_list(use_bloom):
    """An IN-list on an INT32 key: statistics and pages cannot prune the
    row groups whose ranges overlap; with the bloom filter only the row
    group holding the probes survives."""
    probes = [4 * 17 + 1, 4 * 4001 + 1]  # both in row group 1 only
    rows = _check(bloom_file(), "k", ["cat", "x"], values=probes,
                  use_bloom=use_bloom)
    assert rows == 2
    plans = pqt.plan_scan(pqt.ParquetFile(bloom_file()), "k", values=probes,
                          use_bloom=use_bloom, device=CPU)
    assert [p.rg_index for p in plans] == ([1] if use_bloom
                                           else [0, 1, 2, 3])


def test_float_in_list():
    f = papq.read_table(io.BytesIO(wide_keys()), columns=["f"])["f"]
    f = f.to_numpy()
    probes = [float(f[10]), float(f[20_000]), 1e9]
    assert _check(wide_keys(), "f", ["v", "p"], values=probes) >= 2


@pytest.mark.parametrize("kw", [dict(lo=True, hi=True),
                                dict(lo=None, hi=False),
                                dict(values=[True])])
def test_boolean_key(kw):
    n = 5000
    rng = np.random.default_rng(1)
    data = _pyarrow({"b": pa.array(rng.random(n) < 0.3,
                                   mask=rng.random(n) < 0.1),
                     "v": pa.array(np.arange(n, dtype=np.int32))},
                    n, 512, use_dictionary=False)
    assert _check(data, "b", ["v"], **kw) > 0


def test_mixed_dictionary_and_plain_column_is_demoted():
    pf = pqt.ParquetFile(mixed_dict_plain())
    state = pqt.stage_scan(pf, "l_shipdate", lo=9800, hi=10200,
                           columns=["s"], device=CPU)
    assert len(state["spans"]) == 2
    assert {per_col["s"][0] == "host_ragged"
            for _, per_col, _ in state["spans"]} == {True}
    assert _check(mixed_dict_plain(), "l_shipdate", ["s"], lo=9800,
                  hi=10200) > 100


def test_host_ragged_columns_are_never_planned(monkeypatch):
    """A PLAIN string output and a demoted mixed column take the host form
    from their page headers: the device planner never sees their chunks,
    so no span plans a column and then decodes it again on the host."""
    from parquet_tpu_torch.parallel import device_reader

    planned = []
    real = device_reader.build_plan

    def spy(chunk, *args, **kwargs):
        planned.append(chunk.leaf.name)
        return real(chunk, *args, **kwargs)

    monkeypatch.setattr(device_reader, "build_plan", spy)
    state = pqt.stage_scan(pqt.ParquetFile(strings()), "k", lo=500,
                           hi=2600, columns=["comment", "s"], device=CPU)
    assert set(planned) == {"k", "s"}
    assert len(planned) == 2 * len(state["spans"])
    planned.clear()
    state = pqt.stage_scan(pqt.ParquetFile(mixed_dict_plain()), "l_shipdate",
                           lo=9800, hi=10200, columns=["s"], device=CPU)
    assert planned == ["l_shipdate"] * len(state["spans"]) == \
        ["l_shipdate"] * 2


def test_empty_result_is_typed():
    got = pqt.scan_filtered_device(
        pqt.ParquetFile(strings()), "k", lo=10**6, hi=2 * 10**6,
        columns=["v", "s", "comment"], device=CPU)
    assert got["v"].dtype == torch.int64 and got["v"].shape == (0,)
    (dv, do), idx = got["s"]
    assert dv.dtype == torch.uint8 and do.tolist() == [0]
    assert idx.dtype == torch.int32 and idx.shape == (0,)
    (cv, co), cidx = got["comment"]  # BYTE_ARRAY: the dictionary form
    assert co.tolist() == [0] and cidx.shape == (0,)


def test_no_page_index_scans_whole_row_groups():
    assert _check(no_index(), "k", ["v"], lo=100, hi=300) > 0


def test_counts_are_read_back_in_batches(monkeypatch):
    """Twelve spans: the survivor counts come back in two reads (eight
    spans, then four), never once a span."""
    reads = []
    real = ths._ScanCarrier.flush

    def spy(self, out_cols, upto):
        if upto > self.flushed:
            reads.append(upto - self.flushed)
        return real(self, out_cols, upto)

    monkeypatch.setattr(ths._ScanCarrier, "flush", spy)
    n = 24_000
    data = _pyarrow({"k": pa.array(np.arange(n, dtype=np.int32)),
                     "v": pa.array(np.arange(n, dtype=np.float64))},
                    n // 12, 1 << 12, use_dictionary=False)
    got = pqt.scan_filtered_device(pqt.ParquetFile(data), "k", lo=0,
                                   hi=n, columns=["v"], device=CPU)
    assert reads == [8, 4]
    np.testing.assert_array_equal(got["v"].numpy(), np.arange(n))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    pf = pqt.ParquetFile(lineitem())
    for call in (lambda: pqt.scan_filtered_device(pf, "l_shipdate", lo=1),
                 lambda: pqt.stage_scan(pf, "l_shipdate", lo=1),
                 lambda: pqt.plan_scan(pf, "l_shipdate", lo=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@functools.lru_cache(None)
def refusal_file() -> bytes:
    n = 1000
    return _pyarrow({
        "k": pa.array(np.arange(n, dtype=np.int32)),
        "k64": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(np.arange(n, dtype=np.float64)),
        "s": pa.array([f"str_{i:05d}" for i in range(n)]),
        "fl": pa.array([bytes([i % 256]) * 4 for i in range(n)],
                       pa.binary(4)),
        "dec": pa.array([decimal.Decimal(f"{i}.00") for i in range(n)],
                        pa.decimal128(25, 2)),
        "lst": pa.array([[i, i + 1] for i in range(n)]),
    }, n, 1 << 12, use_dictionary=False, store_decimal_as_integer=False)


@pytest.mark.parametrize("path,kw", [
    ("lst", dict(lo=1)), ("k", dict(lo=1, columns=["lst"])),
    ("nope", dict(lo=1)), ("fl", dict(lo=b"\x01" * 4)),
    ("dec", dict(lo=decimal.Decimal("1.00"))), ("s", dict(lo="str_00100")),
    ("k64", dict(values=[1, 2])), ("d", dict(values=[1.0]))])
def test_refusals_match_the_reference(path, kw):
    kw.setdefault("columns", ["k"] if path != "k" else ["d"])
    with pytest.raises(ValueError, match="use the host scan") as mine:
        pqt.stage_scan(pqt.ParquetFile(refusal_file()), path, device=CPU,
                       **kw)
    with pytest.raises(ValueError, match="use the host scan") as theirs:
        jhs.stage_scan(JParquetFile(refusal_file()), path, **kw)
    assert type(mine.value) is type(theirs.value)


def test_refuses_a_chunk_the_device_route_cannot_decode():
    """The fixture's ``k`` overflows its dictionary into PLAIN pages
    inside one chunk, which the device route cannot plan."""
    import os

    path = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                        "host_route.parquet")
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="use the host scan"):
        pqt.scan_filtered_device(pqt.ParquetFile(data), "k", lo=0,
                                 columns=["s"], device=CPU)
    with pytest.raises(ValueError, match="use the host scan"):
        jhs.scan_filtered_device(JParquetFile(data), "k", lo=0,
                                 columns=["s"])


@pytest.mark.parametrize("kw", [dict(policy="policy"),
                                dict(report="report")])
def test_policy_and_report_are_not_ported(kw):
    """A policy or a report is taken now (``io/faults.py``): on clean
    bytes the device scan under either gives the rows of the scan
    without, as the JAX package's does, and the report records no loss."""
    import parquet_tpu

    cols = ["l_quantity", "l_extendedprice"]
    if "policy" in kw:
        mine = {"policy": pqt.FaultPolicy(backoff_s=0)}
        theirs = {"policy": parquet_tpu.FaultPolicy(backoff_s=0)}
    else:
        mine = {"report": pqt.ReadReport()}
        theirs = {"report": parquet_tpu.ReadReport()}
    got = pqt.scan_filtered_device(pqt.ParquetFile(lineitem()), "l_shipdate",
                                   lo=9000, columns=cols, device=CPU, **mine)
    want = jhs.scan_filtered_device(JParquetFile(lineitem()), "l_shipdate",
                                    lo=9000, columns=cols, **theirs)
    for c, t in zip(cols, ("INT32", "DOUBLE")):
        gv, gval = _port_form(got[c], t)
        wv, wval = _ref_form(want[c], _NP[t])
        assert (gval is None) == (wval is None), c
        assert _same_values(gv, wv, gval), c
    if "report" in kw:
        assert mine["report"].ok and theirs["report"].ok
        assert mine["report"].rows_dropped == theirs["report"].rows_dropped


def test_bloom_pruned_chunk_is_never_read(tmp_path):
    """Probing 4 * 17 + 1 (row group 1 only), the other row groups' key
    and output chunks are never read: every pread of the file is counted
    by the byte range it falls in."""
    path = tmp_path / "bloom.parquet"
    path.write_bytes(bloom_file())
    pf = pqt.ParquetFile(str(path))
    rgs = pf.row_groups
    ranges = {(rg.index, leaf.name): rg.column(leaf.column_index).byte_range
              for rg in rgs for leaf in pf.schema.leaves}
    hits = []
    src = pf.source
    for name in ("pread", "pread_view"):
        real = getattr(src, name)

        def counted(offset, size, real=real):
            hits.extend(key for key, (s, n) in ranges.items()
                        if offset < s + n and s < offset + size)
            return real(offset, size)

        setattr(src, name, counted)
    got = pqt.scan_filtered_device(pf, "k", values=[4 * 17 + 1],
                                   columns=["x"], device=CPU)
    assert got["x"].shape == (1,)
    assert {rg for rg, _ in hits} == {1}
    assert {c for _, c in hits} == {"k", "x"}
    pf.close()


# ---------------------------------------------------------------------------
# the DOUBLE key's signed zeros and NaNs
# ---------------------------------------------------------------------------


def test_double_key_signed_zero_and_nan():
    """The port filters a DOUBLE key as the host scan does (NaN never
    matches, -0.0 == 0.0); the JAX package's device route compares the
    IEEE total order of the bits (``pair_range_mask``), where -0.0 < 0.0
    and the positive NaN sorts above +inf.  Its rows are pinned here as
    they are."""
    d = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0]
                 * 4)
    data = _pyarrow({"d": pa.array(d),
                     "row": pa.array(np.arange(len(d), dtype=np.int64))},
                    len(d), 1 << 12, use_dictionary=False)
    jpf = JParquetFile(data)
    pf = pqt.ParquetFile(data)
    for lo, hi, host_rows, ref_rows in (
            (0.0, None, [0, 1, 4, 6], [1, 2, 4, 6]),
            (0.0, 0.0, [0, 1], [1])):
        want = jhs.scan_filtered(jpf, "d", lo=lo, hi=hi, columns=["row"])
        ref = pairs_to_host(jhs.scan_filtered_device(
            jpf, "d", lo=lo, hi=hi, columns=["row"])["row"],
            np.dtype(np.int64))
        got = pqt.scan_filtered_device(pf, "d", lo=lo, hi=hi,
                                       columns=["row"], device=CPU)["row"]
        base = np.arange(4) * 8
        np.testing.assert_array_equal(
            want["row"], (base[:, None] + host_rows).reshape(-1))
        np.testing.assert_array_equal(got.numpy(), want["row"])
        np.testing.assert_array_equal(
            ref, (base[:, None] + ref_rows).reshape(-1))
