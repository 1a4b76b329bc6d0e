"""The port's table manifest (``parquet_tpu_torch/io/manifest.py``)
against the JAX package's (``parquet_tpu/io/manifest.py``), on the CPU:
the value codec, the serialized bytes, each package's manifest read by
the other, corruption, zone-map pruning and coverage over a set of
expression trees, ``collect_entry`` on files that both packages wrote,
and the orphan sweep with its in-flight exemptions."""

import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pytest

import parquet_tpu
from parquet_tpu.io import manifest as jm
from parquet_tpu.io.writer import columns_from_arrow
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch.errors import CorruptedError
from parquet_tpu_torch.io import manifest as tm
from parquet_tpu_torch.io.writer import ColumnData as TCD
from torch_fixtures.threads import (assert_no_thread_started,
                                    start_shared_pools, threads_now)


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _no_thread_left():
    before = threads_now()
    yield
    assert_no_thread_started(before)


# ---------------------------------------------------------------------------
# the value codec and the serialized form
# ---------------------------------------------------------------------------

CODEC_VALUES = [None, True, False, 0, -5, 1 << 80, (1 << 64) - 1,
                (1 << 53) + 1, 3.5, float("inf"), float("-inf"), -0.0, 0.0,
                float("nan"), b"", b"\x00\xffbytes", bytearray(b"ab"),
                np.int64(7), np.uint64((1 << 63) + 3), np.float64(2.5),
                np.float32(-0.0), np.bool_(True)]


@pytest.mark.parametrize("v", CODEC_VALUES, ids=repr)
def test_value_codec_matches_jax(v):
    enc = tm._enc_value(v)
    assert enc == jm._enc_value(v) or (enc is not None and enc["v"] == "nan"
                                       and jm._enc_value(v)["v"] == "nan")
    got = tm._dec_value(enc)
    want = jm._dec_value(jm._enc_value(v))
    if isinstance(want, float) and want != want:
        assert isinstance(got, float) and got != got
    else:
        assert got == want and type(got) is type(want)
        if isinstance(want, float):  # -0.0 keeps its sign
            assert repr(got) == repr(want)


def test_value_codec_unknown_is_inconclusive():
    for d in ({"t": "zz", "v": 1}, "garbage", {"t": "i", "v": "x1"},
              {"t": "x", "v": "zz"}, None, object()):
        assert tm._dec_value(d) is None and jm._dec_value(d) is None
    assert tm._enc_value(object()) is None
    assert tm._enc_value(datetime.date(2020, 1, 1)) is None


def _zone_maps():
    return {"k": (1, 9, 0, 10), "s": (b"a", b"z", None, None),
            "u": ((1 << 64) - 2, (1 << 64) - 1, 0, 10),
            "f": (-0.0, float("inf"), 2, 10), "n": (None, None, 10, 10),
            "b": (False, True, 0, 10), "big": (-(1 << 80), 1 << 80, 0, 3)}


def _manifests():
    kw = dict(version=3, created=1234, sorting=[("k", False, True)])
    files = [("part-a.parquet", 10, 999, _zone_maps()),
             ("part-b.parquet", 0, 4, {}),
             ("part-c.parquet", 7, 70, {"k": (None, 3, None, 7)})]
    return (tm.Manifest(files=[tm.ManifestEntry(*f) for f in files], **kw),
            jm.Manifest(files=[jm.ManifestEntry(*f) for f in files], **kw))


def test_serialize_is_byte_equal_to_jax():
    mine, theirs = _manifests()
    assert mine.serialize() == theirs.serialize()
    assert mine.num_rows == theirs.num_rows == 17
    assert mine.names() == theirs.names()
    back = tm.Manifest.deserialize(theirs.serialize())
    assert back.serialize() == theirs.serialize()
    assert back.files[0].zone_maps == theirs.files[0].zone_maps
    assert tm.MANIFEST_NAME == jm.MANIFEST_NAME
    assert tm.PART_PREFIX == jm.PART_PREFIX
    assert tm.CLAIM_NAME == jm.CLAIM_NAME
    assert tm.part_file_name("ab") == jm.part_file_name("ab")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_manifest(tmp_path, writer):
    mine, theirs = _manifests()
    if writer == "port":
        tm.write_manifest(tmp_path, mine)
        got = jm.read_manifest(tmp_path)
    else:
        jm.write_manifest(tmp_path, theirs)
        got = tm.read_manifest(tmp_path)
    assert got.serialize() == mine.serialize()
    assert got.files[0].zone_maps == mine.files[0].zone_maps
    assert os.listdir(tmp_path) == [tm.MANIFEST_NAME]  # no temp is left


@pytest.mark.parametrize("raw", [b"{ torn json", b"\x00\x01", b"[1, 2]",
                                 b'{"files": []}', b'{"version": "x"}',
                                 b'{"version": 1, "files": [{}]}'])
def test_corrupt_manifest_raises(tmp_path, raw):
    (tmp_path / tm.MANIFEST_NAME).write_bytes(raw)
    with pytest.raises(CorruptedError):
        tm.read_manifest(tmp_path)
    with pytest.raises(parquet_tpu.errors.CorruptedError):
        jm.read_manifest(tmp_path)
    assert tm.read_manifest(tmp_path / "absent") is None


def test_commit_stamps_versions_and_conflicts_abort(tmp_path):
    d = str(tmp_path)
    for want in (1, 2, 3):
        new = tm.commit_manifest(d, lambda live: tm.Manifest(
            files=list(live.files) + [tm.ManifestEntry(
                f"part-{len(live.files)}.parquet", 1, 1)]))
        assert new.version == want and new.created > 0
    assert tm.commit_manifest(d, lambda live: None) is None
    live = tm.read_manifest(d)
    assert live.version == 3 and live.names()[0] == "part-0.parquet"
    assert jm.read_manifest(d).serialize() == live.serialize()


def test_a_rival_claim_is_a_conflict(tmp_path, monkeypatch):
    """A fresh claim file held by another committer makes the compare-and-
    swap lose every attempt; one older than the TTL is broken."""
    d = str(tmp_path)
    claim = tmp_path / tm.CLAIM_NAME
    claim.write_bytes(b"")
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_CAS_RETRIES", "1")
    with pytest.raises(OSError, match="compare-and-swap 2 time"):
        tm.commit_manifest(d, lambda live: tm.Manifest())
    assert tm.read_manifest(d) is None
    assert tm.cas_commit_local(d, 0, tm.Manifest(version=1)) == (False, 0)
    old = os.path.getmtime(claim) - 60
    os.utime(claim, (old, old))
    assert tm.commit_manifest(d, lambda live: tm.Manifest()).version == 1
    assert not claim.exists()


def test_a_commit_arbiter_is_consulted(tmp_path):
    seen = []

    def arbiter(table_dir, expected, manifest, sink_wrap):
        seen.append(expected)
        return tm.cas_commit_local(table_dir, expected, manifest, sink_wrap)

    tm.set_commit_arbiter(lambda d: arbiter)
    try:
        tm.commit_manifest(tmp_path, lambda live: tm.Manifest())
        tm.commit_manifest(tmp_path, lambda live: live)
    finally:
        tm.set_commit_arbiter(None)
    assert seen == [0, 1] and tm.read_manifest(tmp_path).version == 2


# ---------------------------------------------------------------------------
# zone maps: collect_entry on files that both packages wrote
# ---------------------------------------------------------------------------

N = 3000
RG = 1000


def _arrow_table(seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    k = np.arange(N, dtype=np.int64) * 3 - 4000
    f = rng.normal(size=N)
    f[::97] = -0.0
    f[5::211] = np.nan
    valid = rng.random(N) > 0.3
    base = datetime.date(2020, 1, 1)
    return pa.table({
        "k": pa.array(k),
        "i": pa.array(rng.integers(-2**31, 2**31, N).astype(np.int32)),
        "u": pa.array(np.uint64(1 << 63)
                      + rng.integers(0, 2**40, N).astype(np.uint64)),
        "u32": pa.array(rng.integers(0, 2**32, N).astype(np.uint32)),
        "f": pa.array(f),
        "g": pa.array(f.astype(np.float32)),
        "b": pa.array(rng.random(N) > 0.5),
        "s": pa.array([f"w{int(x):04d}" for x in rng.integers(0, 999, N)]),
        "n": pa.array([int(x) if ok else None
                       for x, ok in zip(k.tolist(), valid)], pa.int64()),
        "allnull": pa.array([None] * N, pa.int32()),
        "dt": pa.array([base + datetime.timedelta(days=int(x))
                        for x in rng.integers(0, 5000, N)], pa.date32()),
        "dec": pa.array([decimal.Decimal(int(x)) / 100
                         for x in rng.integers(-99999, 99999, N)],
                        pa.decimal128(9, 2)),
        "dec20": pa.array([decimal.Decimal(int(x)) / 100
                           for x in rng.integers(-10**12, 10**12, N)],
                          pa.decimal128(20, 2)),
        "lst": pa.array([[int(x)] * (int(x) % 3)
                         for x in rng.integers(0, 50, N)],
                        pa.list_(pa.int32())),
    })


def _port_columns(table: pa.Table, jschema) -> dict:
    """The JAX package's ColumnData of ``table`` as the port's (one list
    offsets array a repeated level)."""
    out = {}
    for name, cd in columns_from_arrow(table, jschema).items():
        lo = None if cd.list_offsets is None else [cd.list_offsets]
        lv = None if cd.list_offsets is None else [cd.list_validity]
        out[name] = TCD(values=cd.values, validity=cd.validity,
                        offsets=cd.offsets, list_offsets=lo,
                        list_validity=lv)
    return out


@pytest.fixture(scope="module")
def both_files(tmp_path_factory):
    """``part-jax.parquet`` from the JAX writer, ``part-port.parquet``
    from the port's, the same rows in 3 row groups."""
    d = tmp_path_factory.mktemp("zm")
    table = _arrow_table()
    jpath = os.path.join(d, "part-jax.parquet")
    jwrite_table(table, jpath, parquet_tpu.WriterOptions(row_group_size=RG))
    jschema = parquet_tpu.ParquetFile(jpath).schema
    tpath = os.path.join(d, "part-port.parquet")
    w = pqt.ParquetWriter(tpath, pqt.ParquetFile(jpath).schema,
                          pqt.WriterOptions(row_group_size=RG))
    w.write(_port_columns(table, jschema), N)
    w.close()
    return str(d)


@pytest.mark.parametrize("name", ["part-jax.parquet", "part-port.parquet"])
def test_collect_entry_matches_jax(both_files, name):
    mine = tm.collect_entry(both_files, name)
    theirs = jm.collect_entry(both_files, name)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.zone_maps.keys() == theirs.zone_maps.keys()
    assert "lst.list.element" not in mine.zone_maps
    assert mine.num_rows == N and mine.file_size == os.path.getsize(
        os.path.join(both_files, name))
    # unsigned bounds in unsigned order, and the all-null column
    u = _arrow_table().column("u").to_numpy()
    assert mine.zone_maps["u"][:2] == (int(u.min()), int(u.max()))
    assert mine.zone_maps["allnull"] == (None, None, N, N)
    m = tm.Manifest(version=1, created=5, files=[mine])
    assert m.serialize() == jm.Manifest(version=1, created=5,
                                        files=[theirs]).serialize()


def test_entries_of_both_writers_prune_alike(both_files):
    """The zone maps of the port's file equal those of the JAX package's
    file where both writers keep statistics."""
    mine = tm.collect_entry(both_files, "part-port.parquet")
    theirs = jm.collect_entry(both_files, "part-jax.parquet")
    for c in ("k", "i", "u", "u32", "b", "s", "n", "allnull", "dt", "dec",
              "dec20"):
        assert mine.zone_maps[c] == theirs.zone_maps[c], c


# ---------------------------------------------------------------------------
# pruning and coverage from the manifest, over expression trees
# ---------------------------------------------------------------------------

EXPRS = {
    "range": lambda c: c("k").between(-100, 200),
    "range_dead": lambda c: c("k").between(10**7, 10**8),
    "eq": lambda c: c("k") == 5,
    "ne": lambda c: c("k") != 5,
    "ge_le": lambda c: (c("k") >= 0) & (c("k") <= 50),
    "in": lambda c: c("k").isin([-4000, 17, 10**9]),
    "not_in": lambda c: ~c("k").isin(list(range(-4000, -3000))),
    "or": lambda c: (c("k") >= 4000) | (c("i") <= -2**31 + 5),
    "not_range": lambda c: ~c("k").between(-5000, 10**6),
    "null": lambda c: c("n").is_null(),
    "notnull": lambda c: c("n").not_null(),
    "required_null": lambda c: c("k").is_null(),
    "allnull_range": lambda c: c("allnull").between(0, 5),
    "allnull_null": lambda c: c("allnull").is_null(),
    "uint64": lambda c: c("u").between((1 << 63) + 5, (1 << 63) + 2**39),
    "uint32": lambda c: c("u32") >= 2**31,
    "string": lambda c: c("s").between("w0100", "w0200"),
    "bool": lambda c: c("b") == True,  # noqa: E712
    "double_zero": lambda c: c("f").between(-0.0, 0.0),
    "float_nan": lambda c: c("g") >= float("nan"),
    "date": lambda c: c("dt") >= datetime.date(2030, 1, 1),
    "decimal": lambda c: c("dec") <= decimal.Decimal("-500.00"),
    "decimal_flba": lambda c: c("dec20").between(decimal.Decimal("-5.00"),
                                                 decimal.Decimal("7.50")),
    "and_or_not": lambda c: ((c("k") >= 0) & ~(c("n").is_null()))
    | (c("s") == "w0001"),
}


def _entries(both_files):
    """Entries of the JAX file, each row group a part, plus entries with
    unknown and missing bounds."""
    path = os.path.join(both_files, "part-jax.parquet")
    whole = jm.collect_entry(both_files, "part-jax.parquet").as_dict()
    pf = parquet_tpu.ParquetFile(path)
    out = [whole]
    for rg in pf.row_groups:
        zm = {}
        for leaf in pf.schema.leaves:
            if leaf.max_repetition_level:
                continue
            st = rg.column(leaf.column_index).statistics()
            nv = rg.column(leaf.column_index).meta.num_values
            zm[leaf.dotted_path] = (st.min_value, st.max_value,
                                    st.null_count, nv)
        out.append(jm.ManifestEntry(f"part-{rg.index}.parquet", rg.num_rows,
                                    1, zm).as_dict())
    pf.close()
    out.append(jm.ManifestEntry("part-empty.parquet", 10, 1, {}).as_dict())
    out.append(jm.ManifestEntry("part-unknown.parquet", 10, 1, {
        c: (None, None, None, None) for c in whole["zone_maps"]}).as_dict())
    return out


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_manifest_match_equals_jax(both_files, name):
    path = os.path.join(both_files, "part-jax.parquet")
    jschema = parquet_tpu.ParquetFile(path).schema
    tschema = pqt.ParquetFile(path).schema
    from parquet_tpu.algebra.expr import prepare as jprepare
    from parquet_tpu_torch.algebra.expr import prepare as tprepare

    texpr = tprepare(EXPRS[name](pqt.col), tschema)
    jexpr = jprepare(EXPRS[name](parquet_tpu.col), jschema)
    answers = []
    for d in _entries(both_files):
        mine, theirs = tm.ManifestEntry.from_dict(d), \
            jm.ManifestEntry.from_dict(d)
        got = (tm.manifest_may_match(mine, texpr),
               tm.manifest_all_match(mine, texpr))
        want = (jm.manifest_may_match(theirs, jexpr),
                jm.manifest_all_match(theirs, jexpr))
        assert got == want, (d["name"], got, want)
        answers.append(got)
    if name in ("range_dead", "required_null", "allnull_range"):
        assert not any(a[0] for a in answers[:4])  # proven dead
    assert all(a[0] for a in answers[-2:])  # unknown bounds: conservative


def test_prune_is_conservative_on_unknown_bounds():
    schema = pqt.message("t", [pqt.leaf("k", pqt.io.writer.Type.INT64)])
    from parquet_tpu_torch.algebra.expr import prepare

    expr = prepare(pqt.col("k") == 5, schema)
    for zm in ({}, {"k": (None, None, None, None)}, {"k": (None, 3, 0, 9)},
               {"k": ("a", "b", 0, 9)}):
        e = tm.ManifestEntry("p", 10, 100, zm)
        assert tm.manifest_may_match(e, expr) is True
        assert tm.manifest_all_match(e, expr) is False


# ---------------------------------------------------------------------------
# the orphan sweep
# ---------------------------------------------------------------------------


def test_sweep_removes_orphans_and_spares_the_exempt(tmp_path):
    d = str(tmp_path)
    live = tm.Manifest(version=1, files=[
        tm.ManifestEntry("part-live.parquet", 1, 1)])
    tm.write_manifest(d, live)
    for name in ("part-live.parquet", "part-orphan.parquet",
                 "part-live.parquet.abc.tmp", "part-flight.parquet",
                 "part-flight.parquet.123.tmp", "_manifest_claim.tmp",
                 "notes.txt"):
        (tmp_path / name).write_bytes(b"x")

    def exempt(table_dir_abs):
        return {"part-flight.parquet"} if table_dir_abs == d else set()

    tm.register_sweep_exempt(exempt)
    try:
        swept = tm.sweep_orphans(d)
    finally:
        tm._SWEEP_EXEMPT_PROVIDERS.remove(exempt)
    assert sorted(swept) == ["_manifest_claim.tmp",
                             "part-live.parquet.abc.tmp",
                             "part-orphan.parquet"]
    assert sorted(os.listdir(d)) == sorted([
        tm.MANIFEST_NAME, "notes.txt", "part-flight.parquet",
        "part-flight.parquet.123.tmp", "part-live.parquet"])
    # without the exemption the in-flight part is an orphan, as in the
    # JAX package's sweep of the same directory
    assert sorted(jm.sweep_orphans(d)) == ["part-flight.parquet",
                                           "part-flight.parquet.123.tmp"]
    assert tm.sweep_orphans(tmp_path / "absent") == []


def test_a_broken_exemption_provider_does_not_block_the_sweep(tmp_path):
    (tmp_path / "part-x.parquet").write_bytes(b"x")

    def broken(_):
        raise RuntimeError("boom")

    tm.register_sweep_exempt(broken)
    try:
        assert tm.sweep_orphans(tmp_path) == ["part-x.parquet"]
    finally:
        tm._SWEEP_EXEMPT_PROVIDERS.remove(broken)
