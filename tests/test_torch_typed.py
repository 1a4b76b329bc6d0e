"""The port's typed front end against the JAX package's, on the CPU:
``schema_of``, ``TypedWriter``/``write_objects``, ``TypedReader``/
``read_objects`` and ``read_pytree`` (``parquet_tpu_torch/typed.py``), and
``Column.to_pylist`` against ``to_arrow().to_pylist()`` for every scalar
type the typed front end maps, with nulls and one and two list levels.
Each file written by one package is read by the other; objects compare
with ``==`` and ``tzinfo`` by type and key."""

import dataclasses
import datetime
import io
import math
from typing import Dict, List, Optional

import numpy as np
import pytest
import torch

import parquet_tpu
from parquet_tpu import typed as jtyped
from parquet_tpu.format.enums import FieldRepetitionType as JRep
from parquet_tpu.format.enums import Type as JType
from parquet_tpu.schema import schema as jsch

import parquet_tpu_torch as pqt
from parquet_tpu_torch import typed as ttyped
from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
from parquet_tpu_torch.format.enums import Type
from parquet_tpu_torch.schema import schema as tsch

CPU = "cpu"


@dataclasses.dataclass
class Order:
    order_id: int
    price: float
    comment: str
    flagged: bool
    discount: Optional[float]
    quantities: List[int]
    tag: Optional[str]


@dataclasses.dataclass
class Address:
    city: str
    zip_code: int


@dataclasses.dataclass
class Customer:
    name: str
    address: Address
    score: Optional[int]


@dataclasses.dataclass
class Point:
    x: float
    y: float
    label: Optional[str]


@dataclasses.dataclass
class Track:
    tid: int
    points: List[Point]


@dataclasses.dataclass
class OptTrack:
    tid: int
    points: Optional[List[Point]]


@dataclasses.dataclass
class WithMap:
    name: str
    attrs: Dict[str, int]


@dataclasses.dataclass
class WithOptMap:
    k: int
    tags: Optional[Dict[str, Optional[float]]]


@dataclasses.dataclass
class Stat:
    lo: int
    hi: int


@dataclasses.dataclass
class WithStructMap:
    day: int
    stats: Dict[str, Stat]


@dataclasses.dataclass
class Geo:
    lat: float
    lon: float


@dataclasses.dataclass
class Event:
    id: int
    region: np.int16
    user: str
    ts: datetime.datetime
    day: datetime.date
    score: Optional[float]
    tags: List[str]
    attrs: Dict[str, int]
    geo: Optional[Geo]
    blob: Optional[bytes]
    small: np.uint8
    wide: Optional[np.uint64]
    f32: np.float32
    u32: List[Optional[np.uint32]]


@dataclasses.dataclass
class Odd:
    list: int  # noqa: A003 - a field named like the list wrapper
    key_value: str


def _orders(n=300):
    rng = np.random.default_rng(5)
    return [Order(order_id=i, price=float(rng.random() * 100),
                  comment=f"comment-{i % 37}", flagged=bool(i % 3 == 0),
                  discount=None if i % 4 == 0 else float(i % 10) / 10,
                  quantities=[int(x) for x in rng.integers(0, 50, i % 5)],
                  tag=None if i % 2 else f"tag{i % 7}") for i in range(n)]


def _events(n=400, seed=3):
    rng = np.random.default_rng(seed)
    t0 = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
    out = []
    for i in range(n):
        out.append(Event(
            id=i, region=np.int16(rng.integers(-200, 200)),
            user=f"u{int(rng.integers(0, 50))}",
            ts=t0 + datetime.timedelta(microseconds=int(rng.integers(
                0, 10**12))),
            day=datetime.date(2000, 1, 1) + datetime.timedelta(
                days=int(rng.integers(0, 9000))),
            score=None if rng.random() < 0.1 else float(rng.normal()),
            tags=[f"t{int(x)}" for x in rng.integers(0, 32,
                                                     rng.integers(0, 5))],
            attrs={f"a{j}": int(rng.integers(-9, 9))
                   for j in range(int(rng.integers(0, 4)))},
            geo=None if rng.random() < 0.15 else Geo(float(rng.random()),
                                                     float(rng.random())),
            blob=None if i % 7 == 0 else bytes(rng.integers(
                0, 256, i % 5, dtype=np.uint8)),
            small=np.uint8(rng.integers(0, 256)),
            wide=None if i % 5 == 0 else np.uint64(2**40 + i),
            f32=np.float32(rng.random()),
            u32=[None if rng.random() < 0.2 else np.uint32(2**30 + j)
                 for j in range(int(rng.integers(0, 3)))]))
    return out


def _jax_reading(objs):
    """The objects as the JAX package reads them back: a null optional
    struct comes back as a struct of Nones (a property of the JAX
    package's typed reader that the port keeps)."""
    out = []
    for o in objs:
        if isinstance(o, Event) and o.geo is None:
            o = dataclasses.replace(o, geo=Geo(None, None))
        out.append(o)
    return out


CASES = {
    "orders": (Order, lambda: _orders()),
    "customers": (Customer, lambda: [
        Customer(f"c{i}", Address(f"city{i % 5}", 10000 + i),
                 None if i % 3 == 0 else i) for i in range(60)]),
    "tracks": (Track, lambda: [
        Track(1, [Point(0.0, 1.0, "s"), Point(2.0, 3.0, None)]),
        Track(2, []), Track(3, [Point(-1.0, -2.0, "e")])]),
    "opt_tracks": (OptTrack, lambda: [
        OptTrack(1, [Point(0.5, 1.5, None)]), OptTrack(2, None),
        OptTrack(3, [])]),
    "maps": (WithMap, lambda: [WithMap("a", {"x": 1, "y": 2}),
                               WithMap("b", {}), WithMap("c", {"z": -5})]),
    "opt_maps": (WithOptMap, lambda: [
        WithOptMap(1, {"a": 1.5, "b": None}), WithOptMap(2, None),
        WithOptMap(3, {}), WithOptMap(4, {"c": 0.25})]),
    "struct_maps": (WithStructMap, lambda: [
        WithStructMap(1, {"a": Stat(0, 10), "b": Stat(-5, 5)}),
        WithStructMap(2, {})]),
    "events": (Event, lambda: _events()),
    "odd_names": (Odd, lambda: [Odd(1, "a"), Odd(2, "b")]),
}


def _written(write, objs, cls, **opts):
    buf = io.BytesIO()
    write(objs, buf, cls, **opts)
    return buf.getvalue()


def _same_objects(got, want):
    """Equal objects, with the types of their timestamps' ``tzinfo``
    and keys equal too (aware datetimes compare by instant alone)."""
    assert got == want
    for a, b in zip(got, want):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, datetime.datetime):
                assert type(x.tzinfo) is type(y.tzinfo)
                assert str(x.tzinfo) == str(y.tzinfo)


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_cross_read_between_packages(case):
    cls, make = CASES[case]
    objs = make()
    want = _jax_reading(objs)
    mine = _written(ttyped.write_objects, objs, cls)
    theirs = _written(jtyped.write_objects, objs, cls)
    jgot = jtyped.read_objects(mine, cls)
    assert jgot == want
    _same_objects(ttyped.read_objects(mine, cls, device=CPU), jgot)
    _same_objects(ttyped.read_objects(theirs, cls, device=CPU),
                  jtyped.read_objects(theirs, cls))
    # the same schema, as the JAX package reads it from either file
    assert repr(parquet_tpu.ParquetFile(mine).schema) == repr(
        parquet_tpu.ParquetFile(theirs).schema)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schema_of_matches(case):
    cls, _ = CASES[case]
    mine, theirs = ttyped.schema_of(cls), jtyped.schema_of(cls)
    assert pqt.schema_of is ttyped.schema_of
    assert [leaf.dotted_path for leaf in mine.leaves] == [
        leaf.dotted_path for leaf in theirs.leaves]
    for a, b in zip(mine.leaves, theirs.leaves):
        assert (int(a.physical_type), a.max_definition_level,
                a.max_repetition_level, a.logical_kind, a.logical_params) \
            == (int(b.physical_type), b.max_definition_level,
                b.max_repetition_level, b.logical_kind, b.logical_params)


def test_schema_of_refuses_as_jax():
    @dataclasses.dataclass
    class BadElemOpt:
        xs: List[Optional[Point]]

    @dataclasses.dataclass
    class BadValue:
        m: Dict[bytes, Dict[str, int]]

    for cls in (BadElemOpt, BadValue, int):
        with pytest.raises(TypeError):
            jtyped.schema_of(cls)
        with pytest.raises(TypeError):
            ttyped.schema_of(cls)


@pytest.mark.parametrize("batch_rows,reads", [(64, (30, 100, 1000)),
                                               (1000, (1, 299, 5))])
def test_typed_reader_drains_the_stream(batch_rows, reads):
    objs = _events(300, seed=9)
    raw = _written(ttyped.write_objects, objs, Event,
                   options=pqt.WriterOptions(row_group_size=70,
                                             data_page_size=512))
    r = ttyped.TypedReader(raw, Event, batch_rows=batch_rows, device=CPU)
    jr = jtyped.TypedReader(raw, Event, batch_rows=batch_rows)
    pqt.reset_stream()
    for n in reads:
        _same_objects(r.read(n), jr.read(n))
    assert pqt.STREAM["pulls"] > 0
    assert r.read(10) == [] and jr.read(10) == []
    _same_objects(ttyped.TypedReader(raw, Event, device=CPU).read_all(),
                  jtyped.TypedReader(raw, Event).read_all())


def test_typed_writer_buffers_row_groups_and_aborts(tmp_path):
    objs = _orders(250)
    opts = dict(row_group_size=100, data_page_size=1024)
    path = tmp_path / "o.parquet"
    w = ttyped.TypedWriter(str(path), Order, pqt.WriterOptions(**opts))
    for i in range(0, 250, 30):
        w.write(objs[i:i + 30])
    w.close()
    jbuf = io.BytesIO()
    jw = jtyped.TypedWriter(jbuf, Order, parquet_tpu.WriterOptions(**opts))
    for i in range(0, 250, 30):
        jw.write(objs[i:i + 30])
    jw.close()
    got = parquet_tpu.ParquetFile(str(path))
    want = parquet_tpu.ParquetFile(jbuf.getvalue())
    assert [rg.num_rows for rg in got.row_groups] == [
        rg.num_rows for rg in want.row_groups] == [100, 100, 50]
    assert jtyped.read_objects(str(path), Order) == objs
    # the write pipeline's meter, the underlying writer's
    assert w.write_stats is w.writer.write_stats
    assert w.write_stats.row_groups == 3
    assert w.write_stats.bytes_flushed == path.stat().st_size
    gone = tmp_path / "gone.parquet"
    with pytest.raises(RuntimeError):
        with ttyped.TypedWriter(str(gone), Order) as w:
            w.write(objs[:10])
            raise RuntimeError("boom")
    assert not gone.exists()
    w = ttyped.TypedWriter(str(gone), Order)
    w.write(objs)
    w.abort()
    w.abort()  # idempotent
    assert not gone.exists()


def _jax_pytree_host(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = {n: (tuple(np.asarray(x) for x in a)
                          if isinstance(a, tuple) else np.asarray(a))
                      for n, a in v.items()}
        else:
            out[k] = np.asarray(v)
    return out


def test_read_pytree_matches_jax_and_the_read():
    objs = _orders(200)
    raw = _written(jtyped.write_objects, objs, Order)
    mine = ttyped.read_pytree(raw, device=CPU)
    theirs = _jax_pytree_host(jtyped.read_pytree(raw, device=False))
    read = pqt.ParquetFile(raw).read(device=CPU)
    assert list(mine) == list(theirs) == list(read)
    for path, v in mine.items():
        col = read[path]
        if isinstance(v, dict) and "indices" in v:
            dv, do = v["dictionary"]
            jv, jo = theirs[path]["dictionary"]
            np.testing.assert_array_equal(dv.numpy(), jv)
            np.testing.assert_array_equal(do.numpy(), jo)
            np.testing.assert_array_equal(v["indices"].numpy(),
                                          theirs[path]["indices"])
            np.testing.assert_array_equal(v["indices"].numpy(),
                                          col.dict_indices.numpy())
        elif isinstance(v, dict):
            for n in ("values", "offsets"):
                np.testing.assert_array_equal(v[n].numpy(), theirs[path][n])
        else:
            assert isinstance(v, torch.Tensor)
            np.testing.assert_array_equal(v.numpy(), theirs[path])
            np.testing.assert_array_equal(v.numpy(), col.values.numpy())


# ---------------------------------------------------------------------------
# Column.to_pylist against the JAX package's to_arrow().to_pylist()
# ---------------------------------------------------------------------------

SCALARS = sorted(ttyped._SCALAR_MAP, key=lambda t: t.__name__)


def _scalar(t, rng, i):
    if t is bool:
        return bool(rng.integers(0, 2))
    if t is int:
        return int(rng.integers(-2**62, 2**62))
    if t is float:
        return [math.nan, -0.0, float(rng.normal())][i % 3]
    if t is str:
        return "é" * (i % 3) + f"s{i}"
    if t is bytes:
        return bytes(rng.integers(0, 256, i % 4, dtype=np.uint8))
    if t is datetime.date:
        return datetime.date(1960, 1, 1) + datetime.timedelta(days=i * 97)
    if t is datetime.datetime:
        return datetime.datetime(1969, 12, 31, tzinfo=datetime.timezone.utc) \
            + datetime.timedelta(microseconds=int(rng.integers(0, 10**13)))
    info = np.iinfo(t) if np.issubdtype(t, np.integer) else None
    if info is not None:
        return t(info.max - i if i % 2 else info.min + i)
    return t(rng.normal())


def _scalar_schemas(t):
    """``x`` optional, ``l`` an optional list of optional values and
    ``ll`` a list of lists, in both packages."""
    phys, kind, params = ttyped._SCALAR_MAP[t]
    jphys, jkind, jparams = jtyped._SCALAR_MAP[t]

    def build(S, R, T, ph, k, p):
        ph = T(int(ph))
        return S.message("m", [
            S.leaf("x", ph, R.OPTIONAL, k, **p),
            S.list_of("l", S.leaf("element", ph, R.OPTIONAL, k, **p)),
            S.list_of("ll", S.list_of("element", S.leaf(
                "element", ph, R.OPTIONAL, k, **p)))])

    return (build(tsch, Rep, Type, phys, kind, params),
            build(jsch, JRep, JType, jphys, jkind, jparams))


@pytest.mark.parametrize("t", SCALARS, ids=lambda t: t.__name__)
def test_to_pylist_matches_pyarrow_objects(t):
    rng = np.random.default_rng(11)
    vals = [None if i % 5 == 3 else _scalar(t, rng, i) for i in range(40)]
    schema, jschema = _scalar_schemas(t)
    stored = _stored_form(vals)
    lists = [None if i % 6 == 1 else stored[i:i + i % 4] for i in range(40)]
    nested = [None if i % 7 == 2 else [None if j % 3 == 2 else lists[j]
                                       for j in range(i % 4)]
              for i in range(40)]
    recs = [{"x": v, "l": a, "ll": b}
            for v, a, b in zip(stored, lists, nested)]
    buf = io.BytesIO()
    parquet_tpu.rows.write_rows(buf, jschema, recs)
    raw = buf.getvalue()
    mine = pqt.ParquetFile(raw).read(device=CPU)
    theirs = parquet_tpu.ParquetFile(raw).read()
    for path, col in mine.items():
        got = col.to_pylist()
        want = theirs[path].to_arrow().to_pylist()
        assert len(got) == len(want) == 40
        assert repr(got) == repr(want), path  # NaN, -0.0 and tzinfo too
        flat = [v for v in _flatten(got) if v is not None]
        wflat = [v for v in _flatten(want) if v is not None]
        assert [type(v) for v in flat] == [type(v) for v in wflat]


def _stored_form(vals):
    """Dates as days and datetimes as microseconds since the epoch, the
    integers the row writer stores."""
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    out = []
    for v in vals:
        if isinstance(v, datetime.datetime):
            v = (v - epoch) // datetime.timedelta(microseconds=1)
        elif isinstance(v, datetime.date):
            v = (v - epoch.date()).days
        out.append(v)
    return out


def _flatten(xs):
    for x in xs:
        if isinstance(x, list):
            yield from _flatten(x)
        else:
            yield x


def test_to_pylist_dictionary_column_gathers_once():
    objs = [WithMap(f"n{i % 3}", {}) for i in range(50)]
    raw = _written(jtyped.write_objects, objs, WithMap)
    col = pqt.ParquetFile(raw).read(device=CPU)["name"]
    assert col.is_dictionary_encoded()
    assert col.to_pylist() == [f"n{i % 3}" for i in range(50)]


def test_default_options_write_snappy_as_jax():
    objs = _orders(50)
    for raw in (_written(ttyped.write_objects, objs, Order),
                _written(jtyped.write_objects, objs, Order)):
        codecs = {c.meta_data.codec
                  for rg in parquet_tpu.ParquetFile(raw).metadata.row_groups
                  for c in rg.columns}
        assert codecs == {1}  # SNAPPY
