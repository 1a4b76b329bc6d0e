"""parquet_tpu_torch's read of nested columns against the JAX package's.

One table of every nested shape (a list of dictionary ints, a list of
delta-encoded timestamps, a list of dictionary strings, a list under a
struct, a struct chain with no list, a map, a list three levels deep),
with null and empty lists and null elements, 2,400 rows in three row
groups and small pages (the JAX package's writer: no null struct above a
list, which it refuses), is written by pyarrow, by the JAX package's writer
and by the port's, in v1 and v2 pages.  The port reads each on the CPU,
and every leaf's values, validity, list offsets and list validity of every
level equal, exactly, ``parquet_tpu``'s host read and its device read on
JAX's CPU backend with its device assembly off
(``PARQUET_TPU_DEVICE_ASM=0``) and on (``=1``).  The port's writer's output
also reads back in pyarrow and in the JAX package as the table that made
it.  The two assembly ops are held against the JAX package's ops and the
host assembler on levels made from a seed.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import parquet_tpu
from parquet_tpu.io.writer import WriterOptions as JWriterOptions
from parquet_tpu.io.writer import write_table as jwrite_table

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Type
from parquet_tpu_torch.io.writer import ColumnData
from parquet_tpu_torch.ops import device as tdev
from parquet_tpu_torch.ops import kernels
from parquet_tpu_torch.ops import levels as tlevels
from parquet_tpu_torch.schema import schema as S
from parquet_tpu_torch.schema.types import LogicalKind

ROWS = 2400
ROW_GROUP = 800
PAGE = 2048


def _maybe(rng, p, x):
    return None if rng.random() < p else x


def _table(seed: int = 0, null_structs: bool = True) -> pa.Table:
    """The row groups share their level structure (lengths and nulls come
    from a generator seeded by the row's place in its row group), so the
    JAX package's device assembly, which compiles for each set of sizes,
    compiles once a leaf; values differ in every row."""
    vrng = np.random.default_rng(seed)
    names = [f"tag-{i:03d}" for i in range(300)]

    xs, ts, tags, st, pt, m, d3 = [], [], [], [], [], [], []
    t = 1_700_000_000_000
    for i in range(ROWS):
        rng = np.random.default_rng([seed, i % ROW_GROUP])

        def ints(k, hi):
            return [_maybe(rng, 0.08, int(v))
                    for v in vrng.integers(0, hi, k)]

        k = int(rng.integers(0, 6))
        xs.append(_maybe(rng, 0.06, ints(k, 40)))
        deltas = vrng.integers(0, 1000, int(rng.integers(0, 8)))
        ts.append([int(t + x) for x in np.cumsum(deltas)])
        t += 1000
        tags.append(_maybe(rng, 0.05, [
            _maybe(rng, 0.05, names[int(j)])
            for j in vrng.integers(0, 300, int(rng.integers(0, 4)))]))
        b = _maybe(rng, 0.1, ints(int(rng.integers(0, 3)), 1 << 20))
        st.append(_maybe(rng, 0.1 if null_structs else 0.0,
                         {"a": int(i), "b": b}))
        pt.append(_maybe(rng, 0.1, {
            "x": float(vrng.random()),
            "y": _maybe(rng, 0.2, {"z": _maybe(rng, 0.3, int(i % 97))})}))
        m.append(_maybe(rng, 0.07, [
            (f"k{int(j)}", _maybe(rng, 0.1, int(j) * 3))
            for j in rng.choice(50, int(rng.integers(0, 4)),
                                replace=False)]))
        d3.append(_maybe(rng, 0.06, [
            [ints(int(rng.integers(0, 3)), 9)
             for _ in range(int(rng.integers(0, 2)))]
            for _ in range(int(rng.integers(0, 3)))]))
    return pa.table({
        "xs": pa.array(xs, pa.list_(pa.int64())),
        "ts": pa.array(ts, pa.list_(pa.int64())),
        "tags": pa.array(tags, pa.list_(pa.string())),
        "st": pa.array(st, pa.struct([("a", pa.int64()),
                                      ("b", pa.list_(pa.int32()))])),
        "pt": pa.array(pt, pa.struct([
            ("x", pa.float64()),
            ("y", pa.struct([("z", pa.int32())]))])),
        "m": pa.array(m, pa.map_(pa.string(), pa.int64())),
        "d3": pa.array(d3, pa.list_(pa.list_(pa.list_(pa.int64())))),
    })


DICT = ["xs.list.element", "tags.list.element", "m.key_value.key"]
DELTA = {"ts.list.element": "DELTA_BINARY_PACKED"}


def _write_pyarrow(t: pa.Table, version: int) -> bytes:
    buf = io.BytesIO()
    papq.write_table(t, buf, data_page_version=f"{version}.0",
                     row_group_size=ROW_GROUP, data_page_size=PAGE,
                     use_dictionary=DICT, column_encoding=DELTA,
                     compression="snappy", write_statistics=False)
    return buf.getvalue()


def _write_jax(t: pa.Table, version: int) -> bytes:
    from parquet_tpu.format.enums import Encoding as JEncoding

    buf = io.BytesIO()
    jwrite_table(t, buf, JWriterOptions(
        compression="snappy", data_page_version=version,
        row_group_size=ROW_GROUP, data_page_size=PAGE, dictionary=DICT,
        write_statistics=False, write_page_index=False,
        column_encoding={"ts.list.element": JEncoding.DELTA_BINARY_PACKED}))
    return buf.getvalue()


def _write_port(raw: bytes, version: int) -> bytes:
    """The port's writer, fed each leaf's values and raw levels from the
    JAX package's host read of ``raw``."""
    from parquet_tpu_torch.format.enums import Encoding

    ref = parquet_tpu.ParquetFile(raw)
    cols = ref.read(device=False)
    schema = S.Schema.from_elements(_port_elements(raw))
    table = {}
    for leaf in schema.leaves:
        c = cols[leaf.name]
        if c.is_dictionary_encoded():
            c.materialize_host()
        table[leaf.name] = ColumnData(
            values=np.asarray(c.values),
            offsets=None if c.offsets is None else np.asarray(
                c.offsets, np.int64),
            def_levels=c.def_levels, rep_levels=c.rep_levels)
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        compression="snappy", data_page_version=version,
        row_group_size=ROW_GROUP, data_page_size=PAGE,
        column_encoding={**{n: Encoding.RLE_DICTIONARY for n in DICT},
                         "ts.list.element": Encoding.DELTA_BINARY_PACKED},
        write_statistics=False, write_page_index=False), schema=schema)
    return buf.getvalue()


def _port_elements(raw: bytes):
    return pqt.ParquetFile(raw).metadata.schema


def _host(a):
    return None if a is None else np.asarray(a)


def _ref_values(col, physical):
    if col.is_dictionary_encoded():
        col.materialize_host()
    values = np.asarray(col.values)
    if col.offsets is not None:
        return values, np.asarray(col.offsets).astype(np.int64)
    if values.ndim == 2 and values.dtype == np.uint32:  # uint32 pairs
        values = values.view({Type.INT64: np.int64,
                              Type.DOUBLE: np.float64}[physical]).reshape(-1)
    return values


def _same_mask(got, want, what):
    """Two validity masks, None standing for all valid."""
    if got is None or want is None:
        present = got if got is not None else want
        assert present is None or bool(np.all(present)), what
        return
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_column(port_col, ref_col, what: str) -> None:
    got = port_col.materialize_host()
    nested = isinstance(got, dict)
    values = got["values"] if nested else got
    want = _ref_values(ref_col, port_col.leaf.physical_type)
    if isinstance(values, tuple):
        np.testing.assert_array_equal(values[0], want[0], err_msg=what)
        np.testing.assert_array_equal(values[1], want[1], err_msg=what)
    else:
        assert values.dtype == want.dtype, (what, values.dtype, want.dtype)
        np.testing.assert_array_equal(values, want, err_msg=what)
    _same_mask(_host(port_col.validity), _host(ref_col.validity), what)
    assert len(port_col.list_offsets) == len(ref_col.list_offsets), what
    for k, (o, ro) in enumerate(zip(port_col.list_offsets,
                                    ref_col.list_offsets)):
        assert o.dtype == torch.int64
        np.testing.assert_array_equal(o.numpy(),
                                      np.asarray(ro).astype(np.int64),
                                      err_msg=f"{what}: offsets {k}")
        _same_mask(port_col.list_validity[k].numpy(),
                   _host(ref_col.list_validity[k]),
                   f"{what}: list validity {k}")
    if port_col.def_levels is not None and ref_col.def_levels is not None:
        np.testing.assert_array_equal(port_col.def_levels,
                                      np.asarray(ref_col.def_levels),
                                      err_msg=f"{what}: def levels")


def _jax_reads(raw: bytes, monkeypatch) -> dict:
    f = parquet_tpu.ParquetFile(raw)
    reads = {"host": f.read(device=False)}
    for flag in ("0", "1"):
        with monkeypatch.context() as m:
            m.setenv("PARQUET_TPU_DEVICE_ASM", flag)
            reads[f"device/asm={flag}"] = f.read(device=True)
    return reads


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def pyarrow_files(table):
    return {v: _write_pyarrow(table, v) for v in (1, 2)}


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["pyarrow", "jax", "port"])
def test_nested_read_matches_jax(writer, version, table, pyarrow_files,
                                 monkeypatch):
    raw = pyarrow_files[version]
    if writer == "jax":
        # the JAX package's arrow ingestion refuses null structs above a
        # list, so its file has none
        table = _table(null_structs=False)
        raw = _write_jax(table, version)
    elif writer == "port":
        raw = _write_port(raw, version)
    pqt.reset_host_route()
    port = pqt.ParquetFile(raw).read(device="cpu")
    assert sum(pqt.HOST_ROUTE.values()) == 0, pqt.HOST_ROUTE
    names = [l.name for l in pqt.ParquetFile(raw).schema.leaves]
    assert list(port) == names
    for route, cols in _jax_reads(raw, monkeypatch).items():
        for name in names:
            _same_column(port[name], cols[name], f"{writer} v{version} "
                         f"{name}: {route}")
    if writer == "port":
        # the port's file reads back in pyarrow as the table that made it
        back = papq.read_table(io.BytesIO(raw))
        for name in table.column_names:
            assert back.column(name).to_pylist() == \
                table.column(name).to_pylist(), name


def test_nested_columns_take_the_kernels(pyarrow_files, monkeypatch):
    """The nested dictionary and delta columns go through the same dense
    unpack paths as flat ones: ``unpack_bits_dense`` for ``ts``'s delta
    miniblocks and the string dictionary indexes, ``dict_unpack_gather``
    for ``xs``'s 40-entry int64 dictionary."""
    calls = {}

    def spy(name):
        real = getattr(kernels, name)

        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)
        monkeypatch.setattr(kernels, name, wrapped)

    spy("unpack_bits_dense")
    spy("dict_unpack_gather")
    f = pqt.ParquetFile(pyarrow_files[1])
    for name in ("ts", "tags", "xs"):
        before = dict(calls)
        f.read(columns=[name], device="cpu")
        took = {k: calls.get(k, 0) - before.get(k, 0) for k in calls}
        want = "dict_unpack_gather" if name == "xs" else "unpack_bits_dense"
        assert took.get(want, 0) > 0, (name, took)


def test_columns_select_leaves_under_a_top_level_name(pyarrow_files):
    f = pqt.ParquetFile(pyarrow_files[1])
    assert list(f.read(columns=["st"], device="cpu")) == ["st.a",
                                                          "st.b.list.element"]
    assert list(f.read(columns=["m.key_value.value"], device="cpu")) == [
        "m.key_value.value"]
    assert f.schema.leaf(("pt", "y", "z")) is f.schema.leaf("pt.y.z")
    assert f.schema.leaf("ts").name == "ts.list.element"
    with pytest.raises(KeyError):
        f.read(columns=["nope"], device="cpu")


def _expected_lists(offs, lv, ev, vals):
    it, ei = iter(vals), iter(ev)
    return [[next(it) if next(ei) else None
             for _ in range(offs[i + 1] - offs[i])] if lv[i] else None
            for i in range(len(offs) - 1)]


@pytest.mark.parametrize("version", [1, 2])
def test_port_writer_list_form_reads_back(version):
    """``ColumnData`` in list form (offsets and validity per level) and a
    struct chain's raw def levels: pyarrow and the JAX package read the
    port's file as the data that made it, and the port reads it as
    well."""
    rng = np.random.default_rng(5)
    n = 1500
    lv = rng.random(n) > 0.1
    lens = np.where(lv, rng.integers(0, 5, n), 0)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    ev = rng.random(int(offs[-1])) > 0.1
    vals = rng.integers(0, 1000, int(ev.sum()))
    o1 = np.zeros(n + 1, np.int64)
    np.cumsum(rng.integers(0, 3, n), out=o1[1:])
    o2 = np.zeros(int(o1[-1]) + 1, np.int64)
    np.cumsum(rng.integers(0, 3, int(o1[-1])), out=o2[1:])
    grid = rng.integers(0, 9, int(o2[-1]))
    sv = rng.random(n) > 0.1
    labelled = sv & (rng.random(n) > 0.2)
    labels = [f"l{i}".encode() for i in range(int(labelled.sum()))]
    lo = np.zeros(len(labels) + 1, np.int64)
    np.cumsum([len(x) for x in labels], out=lo[1:])
    xcoord = rng.random(int(sv.sum()))
    schema = S.message("m", [
        S.list_of("xs", S.optional(S.leaf("e", Type.INT64))),
        S.group("pt", [S.leaf("x", Type.DOUBLE), S.optional(S.leaf(
            "label", Type.BYTE_ARRAY, logical=LogicalKind.STRING))],
            S.Rep.OPTIONAL),
        S.list_of("grid", S.list_of("e", S.leaf("e", Type.INT64),
                                    S.Rep.REQUIRED), S.Rep.REQUIRED)])
    table = {
        "xs.list.element": ColumnData(vals, ev, list_offsets=[offs],
                                      list_validity=[lv]),
        "pt.x": ColumnData(xcoord, def_levels=sv.astype(np.int32)),
        "pt.label": ColumnData(np.frombuffer(b"".join(labels), np.uint8),
                               offsets=lo, def_levels=sv.astype(np.int32)
                               + labelled),
        "grid.list.element.list.element": ColumnData(
            grid, list_offsets=[o1, o2], list_validity=[None, None])}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        data_page_version=version, row_group_size=600, data_page_size=512,
        compression="snappy"), schema=schema)
    raw = buf.getvalue()
    meta = papq.ParquetFile(io.BytesIO(raw)).metadata
    assert meta.num_rows == n and meta.row_group(0).num_rows == 600
    want_xs = _expected_lists(offs, lv, ev, vals)
    want_grid = [[list(grid[o2[j]:o2[j + 1]]) for j in range(o1[i],
                                                               o1[i + 1])]
                 for i in range(n)]
    it_x, it_l = iter(xcoord), iter(labels)
    want_pt = [{"x": next(it_x), "label": next(it_l).decode()
                if labelled[i] else None} if sv[i] else None
               for i in range(n)]
    for t in (papq.read_table(io.BytesIO(raw)),
              parquet_tpu.ParquetFile(raw).read().to_arrow()):
        assert t.column("xs").to_pylist() == want_xs
        assert t.column("grid").to_pylist() == want_grid
        assert t.column("pt").to_pylist() == want_pt
    got = pqt.ParquetFile(raw).read(device="cpu")
    xs = got["xs.list.element"]
    np.testing.assert_array_equal(xs.values.numpy(), vals)
    np.testing.assert_array_equal(xs.validity.numpy(), ev)
    np.testing.assert_array_equal(xs.list_offsets[0].numpy(), offs)
    np.testing.assert_array_equal(xs.list_validity[0].numpy(), lv)
    g = got["grid.list.element.list.element"]
    np.testing.assert_array_equal(g.list_offsets[0].numpy(), o1)
    np.testing.assert_array_equal(g.list_offsets[1].numpy(), o2)
    np.testing.assert_array_equal(g.values.numpy(), grid)
    np.testing.assert_array_equal(got["pt.label"].def_levels,
                                  sv.astype(np.int32) + labelled)


def _random_levels(rng, leaf, n_rows):
    """Levels of random offsets and validity at every level of ``leaf``,
    through the port's writer-side ``levels_for_nested``."""
    infos = tlevels.repeated_ancestors(leaf)
    offs, valid, count = [], [], n_rows
    for _ in infos:
        v = rng.random(count) > 0.1
        lens = np.where(v, rng.integers(0, 4, count), 0)
        o = np.zeros(count + 1, np.int64)
        np.cumsum(lens, out=o[1:])
        offs.append(o)
        valid.append(v)
        count = int(o[-1])
    ev = rng.random(count) > 0.2
    return tlevels.levels_for_nested(offs, valid, ev, leaf)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_assemble_ops_match_jax_and_host(depth):
    """``assemble_single_list`` (one level) and ``assemble_nested`` (any
    depth) against the JAX package's ops and both host assemblers, on
    levels made from a seed; and the writer's level builders against the
    JAX package's."""
    import jax.numpy as jnp

    from parquet_tpu.ops import device as jdev
    from parquet_tpu.ops import levels as jlevels
    from parquet_tpu.schema import schema as JS
    from parquet_tpu.format.enums import Type as JType

    node = S.optional(S.leaf("e", Type.INT64))
    jnode = JS.optional(JS.leaf("e", JType.INT64))
    for _ in range(depth):
        node = S.list_of("l", node)
        jnode = JS.list_of("l", jnode)
    leaf = S.message("m", [node]).leaves[0]
    jleaf = JS.message("m", [jnode]).leaves[0]
    rng = np.random.default_rng(depth)
    d, r = _random_levels(rng, leaf, 700)
    infos = tlevels.repeated_ancestors(leaf)
    host = tlevels.assemble(d, r, leaf)
    jhost = jlevels.assemble(d, r, jleaf)
    got = [tdev.assemble_nested(torch.from_numpy(d), torch.from_numpy(r),
                                infos, leaf.max_definition_level)]
    if depth == 1:
        got.append(tdev.assemble_single_list(
            torch.from_numpy(d), torch.from_numpy(r), infos[0].def_level,
            leaf.max_definition_level))
        jgot = jdev.assemble_single_list(jnp.asarray(d), jnp.asarray(r),
                                         infos[0].def_level,
                                         leaf.max_definition_level)
        jgot = ([jgot[0]], [jgot[1]], jgot[2])
    else:
        jgot = jdev.assemble_nested(
            jnp.asarray(d), jnp.asarray(r),
            jlevels.repeated_ancestors(jleaf), leaf.max_definition_level)
    for offs, valid, leaf_valid in got:
        assert len(offs) == len(valid) == depth
        for k in range(depth):
            assert offs[k].dtype == torch.int64
            for want in (host.list_offsets[k], jhost.list_offsets[k],
                         jgot[0][k]):
                np.testing.assert_array_equal(
                    offs[k].numpy(), np.asarray(want).astype(np.int64))
            for want in (host.list_validity[k], jhost.list_validity[k],
                         jgot[1][k]):
                np.testing.assert_array_equal(valid[k].numpy(),
                                              np.asarray(want))
        for want in (host.validity, jhost.validity, jgot[2]):
            np.testing.assert_array_equal(leaf_valid.numpy(),
                                          np.asarray(want))
    # the writer's inverse agrees with the JAX package's
    jd, jr = jlevels.levels_for_nested(host.list_offsets, host.list_validity,
                                       host.validity, jleaf)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(r, jr)
    if depth == 1:
        ld, lr = tlevels.levels_for_list(host.list_offsets[0],
                                         host.list_validity[0],
                                         host.validity, leaf)
        jd, jr = jlevels.levels_for_list(host.list_offsets[0],
                                         host.list_validity[0],
                                         host.validity, jleaf)
        np.testing.assert_array_equal(ld, jd)
        np.testing.assert_array_equal(lr, jr)


def test_assemble_empty_levels():
    empty = torch.zeros(0, dtype=torch.int32)
    offs, valid, leaf_valid = tdev.assemble_single_list(empty, empty, 2, 3)
    assert offs[0].tolist() == [0] and valid[0].numel() == 0 and \
        leaf_valid.numel() == 0
    leaf = S.message("m", [S.list_of("a", S.list_of(
        "b", S.leaf("e", Type.INT32)))]).leaves[0]
    offs, valid, _ = tdev.assemble_nested(
        empty, empty, tlevels.repeated_ancestors(leaf), 4)
    assert [o.tolist() for o in offs] == [[0], [0]]


def test_schema_round_trips_through_the_footer(pyarrow_files):
    """The footer's element list parses into the tree and back to the
    same elements; every leaf's levels equal the JAX package's."""
    raw = pyarrow_files[1]
    elements = pqt.ParquetFile(raw).metadata.schema
    schema = S.Schema.from_elements(elements)
    again = S.Schema.from_elements(schema.to_elements())
    jschema = parquet_tpu.ParquetFile(raw).schema
    for a, b, j in zip(schema.leaves, again.leaves, jschema.leaves):
        assert a.path == b.path == j.path
        assert (a.max_definition_level, a.max_repetition_level) == (
            b.max_definition_level, b.max_repetition_level) == (
            j.max_definition_level, j.max_repetition_level)
        assert a.physical_type == j.physical_type
    assert schema.leaf("tags.list.element").string
    kinds = {n.name: n.logical_kind for n in schema.root.children}
    assert kinds["xs"] == LogicalKind.LIST and kinds["m"] == LogicalKind.MAP
