"""The port's row model against the JAX package's, on the CPU
(``parquet_tpu_torch/rows.py``): Dremel shredding and assembly, the row
writer and reader, ``copy_rows``, ``FileRows`` and its ``seek_to_row`` at
every row of a multi-page, multi-row-group nested file with and without a
page index, nested ``read_row_range``, and the level streams the device
decode keeps only when asked.  Nested shapes: the Dremel paper's
``Document`` (Melnik et al., VLDB 2010, Figure 2), ``list<struct{optional
...}>``, ``map<str, struct>`` and lists of lists, where a null struct and a
struct with a null leaf must come back different."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
from parquet_tpu import rows as JR
from parquet_tpu.format.enums import FieldRepetitionType as JRep
from parquet_tpu.format.enums import Type as JType
from parquet_tpu.io.search import read_row_range as jread_row_range
from parquet_tpu.schema import schema as JS

import parquet_tpu_torch as pqt
from parquet_tpu_torch import rows as R
from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
from parquet_tpu_torch.format.enums import Type
from parquet_tpu_torch.schema import schema as S
from parquet_tpu_torch.schema.types import LogicalKind as K

CPU = "cpu"


def _both(build):
    """A schema built by ``build(S, Rep, Type)`` in each package."""
    return (build(S, Rep, Type),
            build(JS, JRep, lambda t: JType(int(t))))


def _flat(S, Rep, T):
    return S.message("row", [
        S.leaf("a", T(Type.INT64)),
        S.optional(S.leaf("b", T(Type.DOUBLE))),
        S.optional(S.leaf("s", T(Type.BYTE_ARRAY), logical=K.STRING))])


def _deep(S, Rep, T):
    inner = S.list_of("inner", S.leaf("e", T(Type.INT32)),
                      repetition=Rep.OPTIONAL)
    return S.message("row", [
        S.leaf("id", T(Type.INT32)), S.list_of("lol", inner),
        S.map_of("attrs", S.leaf("k", T(Type.BYTE_ARRAY), logical=K.STRING),
                 S.optional(S.leaf("v", T(Type.INT64))))])


def _document(S, Rep, T):
    ba = T(Type.BYTE_ARRAY)
    return S.message("Document", [
        S.leaf("DocId", T(Type.INT64)),
        S.group("Links", [S.repeated(S.leaf("Backward", T(Type.INT64))),
                          S.repeated(S.leaf("Forward", T(Type.INT64)))],
                Rep.OPTIONAL),
        S.group("Name", [
            S.group("Language", [
                S.leaf("Code", ba, logical=K.STRING),
                S.optional(S.leaf("Country", ba, logical=K.STRING))],
                Rep.REPEATED),
            S.optional(S.leaf("Url", ba, logical=K.STRING))], Rep.REPEATED)])


def _structs(S, Rep, T):
    """list<struct{optional a, b}>, map<str, optional struct{optional v}>
    and list<list<int64>>."""
    return S.message("m", [
        S.leaf("id", T(Type.INT64)),
        S.list_of("xs", S.optional(S.group("element", [
            S.optional(S.leaf("a", T(Type.INT32))),
            S.leaf("b", T(Type.DOUBLE))]))),
        S.map_of("m", S.leaf("key", T(Type.BYTE_ARRAY), logical=K.STRING),
                 S.optional(S.group("value", [
                     S.optional(S.leaf("v", T(Type.INT64)))]))),
        S.list_of("ll", S.list_of("element", S.optional(S.leaf(
            "element", T(Type.INT64)))))])


def _document_records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        links = None
        if rng.random() < 0.8:
            links = {k: [int(x) for x in rng.integers(0, 100,
                                                      rng.integers(0, 3))]
                     for k in ("Backward", "Forward")}
        names = []
        for _ in range(int(rng.integers(0, 3))):
            langs = [{"Code": f"c{int(rng.integers(5))}",
                      "Country": (f"u{int(rng.integers(3))}"
                                  if rng.random() < .5 else None)}
                     for _ in range(int(rng.integers(0, 3)))]
            names.append({"Language": langs,
                          "Url": (f"http://{int(rng.integers(9))}"
                                  if rng.random() < .6 else None)})
        out.append({"DocId": i, "Links": links, "Name": names})
    return out


def _struct_records(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        xs = None if i % 9 == 4 else [
            None if j % 3 == 1 else
            {"a": None if j % 4 == 2 else int(rng.integers(-9, 9)),
             "b": float(j)} for j in range(i % 4)]
        m = {f"k{j}": (None if j == 1 else
                       {"v": None if j == 2 else int(rng.integers(99))})
             for j in range(i % 4)}
        ll = None if i % 7 == 3 else [
            None if j % 3 == 2 else [None if h == 1 else int(h + i)
                                     for h in range(j % 3)]
            for j in range(i % 3)]
        out.append({"id": i, "xs": xs, "m": m, "ll": ll})
    return out


DEEP = [{"id": 1, "lol": [[1, 2], [], [3]], "attrs": {"a": 1, "b": None}},
        {"id": 2, "lol": [], "attrs": {}},
        {"id": 3, "lol": None, "attrs": {"z": 9}},
        {"id": 4, "lol": [[], [7]], "attrs": {}}]

SHAPES = {
    "flat": (_flat, lambda: [{"a": i, "b": None if i % 3 else i / 2,
                              "s": None if i % 2 else f"s{i}"}
                             for i in range(40)]),
    "deep": (_deep, lambda: DEEP),
    "document": (_document, lambda: _document_records(60)),
    "structs": (_structs, lambda: _struct_records(60)),
}


def _slots(rows):
    return [[(v.column, v.value, v.definition_level, v.repetition_level)
             for v in r] for r in rows]


def _write(mod, schema, recs, **opts):
    buf = io.BytesIO()
    options = (pqt.WriterOptions if mod is R else
               parquet_tpu.WriterOptions)(**opts)
    mod.write_rows(buf, schema, recs, options)
    return buf.getvalue()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_deconstruct_reconstruct_match_jax(shape):
    build, make = SHAPES[shape]
    schema, jschema = _both(build)
    for rec in make():
        row, jrow = R.deconstruct(schema, rec), JR.deconstruct(jschema, rec)
        assert _slots([row]) == _slots([jrow])
        assert R.reconstruct(schema, row) == JR.reconstruct(jschema, jrow) \
            == rec


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_row_files_cross_read_between_packages(shape):
    build, make = SHAPES[shape]
    schema, jschema = _both(build)
    recs = make()
    opts = dict(row_group_size=17, data_page_size=256)
    for raw in (_write(R, schema, recs, **opts),
                _write(JR, jschema, recs, **opts)):
        assert list(JR.read_rows(raw)) == recs
        assert list(R.read_rows(raw, device=CPU)) == recs
        assert _slots(R.FileRows(pqt.ParquetFile(raw),
                                 device=CPU).read_rows(1000)) == \
            _slots(JR.FileRows(parquet_tpu.ParquetFile(raw)).read_rows(1000))


def test_null_struct_and_struct_of_nulls_differ():
    schema, _ = _both(_structs)
    recs = [{"id": 0, "xs": [None, {"a": None, "b": 1.0}],
             "m": {"p": None, "q": {"v": None}}, "ll": [None, [], [None]]}]
    raw = _write(R, schema, recs)
    assert list(R.read_rows(raw, device=CPU)) == list(JR.read_rows(raw)) \
        == recs


def test_row_builder_and_value_model_match_jax():
    schema, jschema = _both(_flat)
    got = R.RowBuilder(schema).set("a", 7).set("b", None).set("s", "q").row()
    want = JR.RowBuilder(jschema).set("a", 7).set("b", None).set(
        "s", "q").row()
    assert _slots([got]) == _slots([want])
    assert [(v.is_null, repr(v)) for v in got.for_column(1)] == [
        (v.is_null, repr(v)) for v in want.for_column(1)]
    schema, jschema = _both(_deep)
    strict = {"id": 1, "lol": [],
              "attrs": {"key_value": [{"key": "a", "value": 5}]}}
    sugar = {"id": 1, "lol": [], "attrs": {"a": 5}}
    assert _slots([R.deconstruct(schema, strict)]) == _slots(
        [R.deconstruct(schema, sugar)]) == _slots(
        [JR.deconstruct(jschema, sugar)])


def test_row_writer_refusals_match_jax():
    def build(S, Rep, T):
        return S.message("m", [S.leaf("f", T(Type.FIXED_LEN_BYTE_ARRAY),
                                      Rep.OPTIONAL, type_length=4)])

    schema, jschema = _both(build)
    for mod, sch in ((R, schema), (JR, jschema)):
        with pytest.raises(ValueError, match="'f'.*4"):
            _write(mod, sch, [{"f": b"12345678"}, {"f": b"abcd"}])
        with pytest.raises(TypeError, match="expects a dict"):
            mod.deconstruct(sch, 5)


def test_unsigned_and_pyarrow_files():
    def build(S, Rep, T):
        return S.message("row", [
            S.leaf("u32", T(Type.INT32), logical=K.INT, bit_width=32,
                   signed=False),
            S.leaf("u64", T(Type.INT64), logical=K.INT, bit_width=64,
                   signed=False)])

    schema, _ = _both(build)
    recs = [{"u32": 3_000_000_000, "u64": 2**63 + 17}, {"u32": 0, "u64": 0}]
    raw = _write(R, schema, recs, dictionary=False)
    assert list(R.read_rows(raw, device=CPU)) == list(JR.read_rows(raw)) \
        == recs
    assert papq.read_table(io.BytesIO(raw)).column("u32").to_pylist() == [
        3_000_000_000, 0]
    t = pa.table({"x": pa.array([1, 2, None, 4], pa.int64()),
                  "name": pa.array(["a", None, "c", "d"]),
                  "xs": pa.array([[1, 2], None, [], [5]],
                                 pa.list_(pa.int32()))})
    buf = io.BytesIO()
    papq.write_table(t, buf, compression="snappy")
    assert list(R.read_rows(buf.getvalue(), device=CPU)) == list(
        JR.read_rows(buf.getvalue()))


def test_copy_rows_and_batching_match_jax():
    schema, jschema = _both(_document)
    recs = _document_records(250, seed=3)
    raw = _write(R, schema, recs, row_group_size=100)
    out, jout = io.BytesIO(), io.BytesIO()
    w = pqt.ParquetWriter(out, schema, pqt.WriterOptions(row_group_size=64))
    n = R.copy_rows(R.WriterRows(w), R.FileRows(pqt.ParquetFile(raw),
                                                device=CPU), batch=33)
    w.close()
    jw = parquet_tpu.ParquetWriter(jout, jschema, parquet_tpu.WriterOptions(
        row_group_size=64))
    jn = JR.copy_rows(JR.WriterRows(jw),
                      JR.FileRows(parquet_tpu.ParquetFile(raw)), batch=33)
    jw.close()
    assert n == jn == 250
    for got in (out.getvalue(), jout.getvalue()):
        f = parquet_tpu.ParquetFile(got)
        assert [rg.num_rows for rg in f.row_groups] == [64, 64, 64, 58]
        assert list(JR.read_rows(got)) == list(R.read_rows(
            got, device=CPU)) == recs
    fr = R.FileRows(pqt.ParquetFile(raw), device=CPU)
    jfr = JR.FileRows(parquet_tpu.ParquetFile(raw))
    for k in (20, 130, 1000, 10):
        assert _slots(fr.read_rows(k)) == _slots(jfr.read_rows(k))
    rows = [R.deconstruct(schema, r) for r in recs]
    assert _slots(R.BufferRows(rows).read_rows(300)) == _slots(rows)


@pytest.fixture(scope="module")
def seek_files():
    """The Document rows in 4 row groups of 40 rows and pages of about
    256 bytes, with a page index and without."""
    schema, _ = _both(_document)
    recs = _document_records(160, seed=5)
    out = {}
    for index in (True, False):
        raw = _write(R, schema, recs, row_group_size=40, data_page_size=128,
                     write_page_index=index)
        out[index] = raw
    return recs, out


@pytest.mark.parametrize("page_index", [True, False])
def test_seek_to_row_at_every_row(seek_files, page_index):
    recs, files = seek_files
    raw = files[page_index]
    pf = pqt.ParquetFile(raw)
    chunk = pf.row_group(1).column(4)
    assert (chunk.offset_index() is not None) == page_index
    if page_index:
        assert len(chunk.offset_index().page_locations) > 1
    every = R.FileRows(pf, device=CPU).read_rows(1000)
    jf = parquet_tpu.ParquetFile(raw)
    assert _slots(every) == _slots(JR.FileRows(jf).read_rows(1000))
    cur = R.FileRows(pf, device=CPU)
    for r in range(len(recs) + 2):
        cur.seek_to_row(r)
        assert _slots(cur.read_rows(4)) == _slots(every[r:r + 4]), r
    for r in (0, 39, 40, 41, 80, 159, 160):
        cur.seek_to_row(r)
        jcur = JR.FileRows(jf)
        jcur.seek_to_row(r)
        assert _slots(cur.read_rows(90)) == _slots(jcur.read_rows(90))
    with pytest.raises(ValueError):
        cur.seek_to_row(-1)


@pytest.mark.parametrize("start,count", [(0, 1), (5, 37), (35, 10),
                                         (0, 160), (159, 5), (160, 2),
                                         (70, 60)])
def test_nested_read_row_range_matches_jax(seek_files, start, count):
    _, files = seek_files
    raw = files[True]
    pf, jpf = pqt.ParquetFile(raw), parquet_tpu.ParquetFile(raw)
    for leaf in pf.schema.leaves:
        if not leaf.max_repetition_level:
            continue
        got = pqt.read_row_range(pf, leaf.name, start, count)
        want = jread_row_range(jpf, leaf.name, start, count)
        assert got.to_pylist() == want.to_arrow().to_pylist(), leaf.name
        np.testing.assert_array_equal(got.def_levels,
                                      np.asarray(want.def_levels))
        np.testing.assert_array_equal(got.rep_levels,
                                      np.asarray(want.rep_levels))
    with pytest.raises(ValueError, match="flat"):
        pqt.read_row_range(pf, "Name.Url", 0, 1, aligned=True)


def test_level_streams_only_on_request():
    """The whole read and the stream keep no level stream of a repeated
    column unless asked; asked, the stream's equal the JAX package's host
    decode's."""
    schema, _ = _both(_structs)
    raw = _write(R, schema, _struct_records(120), row_group_size=50,
                 data_page_size=256)
    pf = pqt.ParquetFile(raw)
    repeated = [leaf.name for leaf in pf.schema.leaves
                if leaf.max_repetition_level]
    whole = pf.read(device=CPU)
    for name in repeated:
        assert whole[name].def_levels is None
        assert whole[name].rep_levels is None
    for batch in pf.iter_batches(batch_rows=32, device=CPU):
        for name in repeated:
            assert batch[name].def_levels is None
            assert batch[name].rep_levels is None
    jtab = parquet_tpu.ParquetFile(raw).read()
    got = {name: ([], []) for name in repeated}
    for batch in pqt.iter_batches(pf, batch_rows=32, device=CPU,
                                  keep_levels=True):
        for name in repeated:
            got[name][0].append(batch[name].def_levels)
            got[name][1].append(batch[name].rep_levels)
    for name in repeated:
        np.testing.assert_array_equal(np.concatenate(got[name][0]),
                                      np.asarray(jtab[name].def_levels))
        np.testing.assert_array_equal(np.concatenate(got[name][1]),
                                      np.asarray(jtab[name].rep_levels))


def test_cuda_by_default(monkeypatch):
    import torch

    schema, _ = _both(_flat)
    raw = _write(R, schema, SHAPES["flat"][1]())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: R.FileRows(pqt.ParquetFile(raw)),
                 lambda: list(R.read_rows(raw))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
