"""parquet_tpu_torch's CUDA kernels, device read and point lookup on a card.

These tests need a CUDA card and skip without one.  The file imports
neither JAX nor parquet_tpu, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import io
from typing import Dict, List, Optional

import numpy as np
import pytest
import torch

import parquet_tpu_torch as pqt
from parquet_tpu_torch.format.enums import Encoding
from parquet_tpu_torch.ops import kernels


@pytest.fixture
def cuda_device():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_on_card(cuda_device):
    """Both CUDA kernels against their plain versions on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n = (1 << 20) + 7
    for w in range(1, 33):
        words = torch.randint(-2**31, 2**31 - 1, ((n + 31) // 32 * w,),
                              dtype=torch.int32, device=cuda_device,
                              generator=gen)
        got = kernels.unpack_bits_dense(words, n, w)
        assert torch.equal(got, kernels.unpack_bits_dense_ref(words, n, w))
        for m in CARD_NS[:-1]:  # the same stream's prefixes
            got = kernels.unpack_bits_dense(words, m, w)
            assert torch.equal(got, kernels.unpack_bits_dense_ref(words, m,
                                                                   w))
    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        dictionary = torch.arange(1024, device=cuda_device).to(dtype)
        words = torch.randint(-2**31, 2**31 - 1, ((n + 31) // 32 * 10,),
                              dtype=torch.int32, device=cuda_device,
                              generator=gen)
        got = kernels.dict_unpack_gather(words, dictionary, n, 10)
        assert torch.equal(
            got, kernels.dict_unpack_gather_ref(words, dictionary, n, 10))


# value counts around the kernels' 32-value groups and 512-value tiles, and
# one past a row group's 1,048,576
CARD_NS = (1, 31, 32, 33, 255, 257, 511, 512, 513, (1 << 20) + 7)
DICT_SIZES = (1, 2, 200, 1024)
DICT_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The integer bit patterns of ``t`` (NaN-safe equality)."""
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _words(count: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, (count,), dtype=torch.int32,
                         device=device, generator=gen)


def _dictionary(d: int, dtype: torch.dtype, gen: torch.Generator, device):
    if dtype.is_floating_point:
        return torch.randn(d, dtype=dtype, device=device, generator=gen)
    lim = 2**31 - 1 if dtype == torch.int32 else 2**62
    return torch.randint(-lim, lim, (d,), dtype=dtype, device=device,
                         generator=gen)


def _check_both(words: torch.Tensor, n: int, w: int, dictionaries) -> None:
    """Both kernels on ``words`` equal their plain versions bit for bit."""
    got = kernels.unpack_bits_dense(words, n, w)
    assert torch.equal(got, kernels.unpack_bits_dense_ref(words, n, w)), \
        (n, w)
    for dictionary in dictionaries:
        got = kernels.dict_unpack_gather(words, dictionary, n, w)
        want = kernels.dict_unpack_gather_ref(words, dictionary, n, w)
        assert torch.equal(_bits(got), _bits(want)), \
            (n, w, dictionary.shape[0], dictionary.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("w", range(1, 33))
def test_dict_unpack_gather_on_card_every_width(cuda_device, w):
    """``dict_unpack_gather`` at width ``w`` over dictionaries of 1, 2, 200
    and 1024 entries of the four types, at value counts around a group
    and a tile: random words give indexes past the dictionary's end
    wherever 2^w exceeds it, which must read 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(w)
    dictionaries = [_dictionary(d, dtype, gen, cuda_device)
                    for d in DICT_SIZES for dtype in DICT_DTYPES]
    for n in CARD_NS:
        words = _words((n + 31) // 32 * w, gen, cuda_device)
        _check_both(words, n, w, dictionaries)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("short", [0, 1, 5, "empty"])
def test_kernels_on_card_ragged_streams(cuda_device, offset, short):
    """A stream ``short`` words shorter than ceil(n/32)*w (or empty): the
    kernels read zeros past its end.  A view ``offset`` words into its
    storage (``words[1:]``, ``words[3:]``: 4- but not 16-byte aligned):
    the kernels read from its first word."""
    gen = torch.Generator(device=cuda_device).manual_seed(7 * offset + 1)
    dictionaries = [_dictionary(200, torch.int32, gen, cuda_device),
                    _dictionary(1024, torch.float64, gen, cuda_device)]
    for w in (1, 5, 8, 10, 15, 16, 17, 24, 31, 32):
        for n in CARD_NS:
            need = (n + 31) // 32 * w
            keep = 0 if short == "empty" else max(need - short, 0)
            storage = _words(keep + offset, gen, cuda_device)
            words = storage[offset:]
            # (an empty tensor's data_ptr() is 0)
            assert keep == 0 or words.data_ptr() % 16 == 4 * offset
            _check_both(words, n, w, dictionaries)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_read_on_card_matches_cpu(cuda_device, version):
    """A file with every encoding of the slice reads the same on the card
    as on the CPU, and the card's read launches both kernels."""
    rng = np.random.default_rng(7)
    n = 50_000
    table = {
        "id": np.arange(n, dtype=np.int64),
        "small": np.ma.masked_array(rng.integers(0, 200, n).astype(np.int32),
                                    mask=rng.random(n) < 0.1),
        "large": rng.integers(0, 3000, n).astype(np.int64),
        "ts": np.cumsum(rng.integers(0, 1000, n)),
        "f": np.ma.masked_array(rng.random(n), mask=rng.random(n) < 0.05),
    }
    opts = pqt.WriterOptions(
        row_group_size=20_000, data_page_size=8192, compression="gzip",
        data_page_version=version, column_encoding={
            "id": Encoding.PLAIN, "small": Encoding.RLE_DICTIONARY,
            "large": Encoding.RLE_DICTIONARY,
            "ts": Encoding.DELTA_BINARY_PACKED, "f": Encoding.PLAIN})
    buf = io.BytesIO()
    pqt.write_table(table, buf, opts)
    f = pqt.ParquetFile(buf.getvalue())
    want = f.read(device="cpu")
    pqt.reset_launches()
    got = f.read(device=cuda_device)
    torch.cuda.synchronize()
    read_kernels = ("unpack_bits_dense", "dict_unpack_gather")
    assert all(pqt.LAUNCHES[k] > 0 for k in read_kernels), pqt.LAUNCHES
    for name in table:
        assert got[name].values.device.type == "cuda"
        assert torch.equal(got[name].values.cpu(), want[name].values)
        if want[name].validity is None:
            assert got[name].validity is None
        else:
            assert torch.equal(got[name].validity.cpu(), want[name].validity)


@pytest.mark.cuda
@pytest.mark.parametrize("z", [1, 1024, 65_536, 1 << 22])
def test_bloom_check_on_card(cuda_device, z):
    """``bloom_check`` against its plain version and the numpy host probe,
    hashes with all high bits set (the last block) among them."""
    from parquet_tpu_torch.io.bloom import SplitBlockFilter

    rng = np.random.default_rng(z)
    n = (1 << 16) + 3
    h = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    h[::5] |= np.uint64(0xFFFFFFFF00000000)
    blocks = (rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
              & rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
              ).astype(np.uint32)
    f = SplitBlockFilter(blocks)
    f.insert_hashes(h[::2])
    filt = f.device_blocks(cuda_device)
    hashes = torch.from_numpy(h.view(np.int64)).to(cuda_device)
    before = kernels.LAUNCHES["bloom_check"]
    got = kernels.bloom_check(filt, hashes)
    assert kernels.LAUNCHES["bloom_check"] == before + 1
    assert torch.equal(got, kernels.bloom_check_ref(filt, hashes))
    np.testing.assert_array_equal(got.cpu().numpy(), f.check_hashes(h))


# (blocks, hashes) per segment: one segment; eight equal ones; uneven ones
# with empty ones among them; z = 1 beside z = 65,536; batch sizes that are
# not multiples of 4; more segments than the kernel keeps in shared memory
SEGMENT_LAYOUTS = {
    "one": [(1024, 40_000)],
    "eight_equal": [(65_536, 8_192)] * 8,
    "uneven_with_empty": [(64, 0), (1024, 5_003), (1, 0), (4096, 17),
                          (65_536, 30_001), (256, 0)],
    "z1_beside_z65536": [(1, 9_999), (65_536, 10_001), (1, 7), (65_536, 2)],
    "ragged": [(512, 4_097), (2048, 3), (512, 1)],
    "past_shared_table": [(1 + i % 300, (i * 7) % 13) for i in range(1100)],
}


def _segments(layout, seed: int):
    """Filters of sparse random bits, each holding half of its batch, and
    the batches (every 7th hash probes the filter's last block)."""
    from parquet_tpu_torch.io.bloom import SplitBlockFilter

    rng = np.random.default_rng(seed)
    filters, batches = [], []
    for z, n in layout:
        h = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
        h[::7] |= np.uint64(0xFFFFFFFF00000000)
        blocks = (rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
                  & rng.integers(0, 2**32, (z, 8), dtype=np.uint64)
                  ).astype(np.uint32)
        f = SplitBlockFilter(blocks)
        f.insert_hashes(h[::2])
        filters.append(f)
        batches.append(h)
    return filters, batches


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(SEGMENT_LAYOUTS))
def test_bloom_check_segments_on_card(cuda_device, layout):
    """One launch of the segmented kernel equals its plain version and the
    numpy host probe of each segment's filter, bit for bit."""
    filters, batches = _segments(SEGMENT_LAYOUTS[layout], len(layout))
    blocks = [f.device_blocks(cuda_device) for f in filters]
    starts = np.zeros(len(batches) + 1, np.int64)
    np.cumsum([len(h) for h in batches], out=starts[1:])
    hashes = torch.from_numpy(np.concatenate(batches).view(np.int64)).to(
        cuda_device)
    before = kernels.LAUNCHES["bloom_check"]
    got = kernels.bloom_check_segments(blocks, hashes,
                                       torch.from_numpy(starts))
    assert kernels.LAUNCHES["bloom_check"] == before + 1
    assert torch.equal(got, kernels.bloom_check_segments_ref(
        blocks, hashes, torch.from_numpy(starts)))
    got = got.cpu().numpy()
    for f, h, a, b in zip(filters, batches, starts[:-1], starts[1:]):
        np.testing.assert_array_equal(got[a:b], f.check_hashes(h))


@pytest.mark.cuda
def test_bloom_check_rejects_misaligned_hashes(cuda_device):
    """The kernel loads hashes as 16-byte vectors in place: a view that
    starts 8 bytes into its storage raises instead of launching."""
    filt = torch.zeros((64, 8), dtype=torch.int32, device=cuda_device)
    hashes = torch.zeros(17, dtype=torch.int64, device=cuda_device)
    before = kernels.LAUNCHES["bloom_check"]
    with pytest.raises(ValueError, match="aligned"):
        kernels.bloom_check_segments([filt], hashes[1:],
                                     torch.tensor([0, 16]))
    with pytest.raises(ValueError, match="aligned"):
        kernels.bloom_check(filt, hashes[1:])
    assert kernels.LAUNCHES["bloom_check"] == before


@pytest.mark.cuda
def test_find_rows_on_card_matches_cpu(cuda_device):
    """A lookup whose row groups keep more than 32,768 keys after the
    statistics stage probes with the kernel on the card, and equals the
    same lookup on the CPU in hits and counters."""
    rng = np.random.default_rng(3)
    n = 80_000
    table = {
        "k": np.arange(n, dtype=np.int64) // 2 * 2,
        "v": np.ma.masked_array(rng.random(n), mask=rng.random(n) < 0.05),
        "c": np.ma.masked_array(rng.integers(0, 200, n).astype(np.int32),
                                mask=rng.random(n) < 0.1),
    }
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=40_000, data_page_size=8192,
        column_encoding={"c": Encoding.RLE_DICTIONARY},
        bloom_filters={"k": 10}, sorting_columns=[("k", False, False)]))
    keys = rng.permutation(np.arange(0, n, dtype=np.int64))
    f = pqt.ParquetFile(buf.getvalue())
    pqt.clear_caches()
    want = f.find_rows("k", keys, columns=["v", "c"], device="cpu")
    pqt.clear_caches()
    pqt.reset_launches()
    got = f.find_rows("k", keys, columns=["v", "c"], device=cuda_device)
    assert pqt.LAUNCHES["bloom_check"] == 1  # both row groups, one launch
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    assert got.counters == want.counters
    assert got.counters["rows_matched"] == n
    for g, w in zip(got, want):
        assert np.array_equal(g.rows, w.rows)
        for c in ("v", "c"):
            assert np.array_equal(g.values[c], w.values[c])
            assert (g.validity[c] is None) == (w.validity[c] is None)
            if w.validity[c] is not None:
                assert np.array_equal(g.validity[c], w.validity[c])


@pytest.mark.cuda
def test_value_ops_on_card(cuda_device):
    """The torch ops of the value decodes on the card against their CPU
    results on the same operands: the byte-stream-split transpose, the
    front-coded expansion, the byte-array gather, the offsets' cumsum and
    the boolean expand."""
    from parquet_tpu_torch.ops import device as dev
    from parquet_tpu_torch.ops import ref

    rng = np.random.default_rng(3)
    n = 100_003
    raw = torch.from_numpy(rng.integers(0, 256, 8 * n, dtype=np.uint8))
    for width, dt in ((2, None), (4, torch.float32), (4, torch.int32),
                      (8, torch.float64), (16, None)):
        m = 8 * n // width
        want = dev.byte_stream_split(raw, m, width, dt)
        got = dev.byte_stream_split(raw.to(cuda_device), m, width, dt)
        assert torch.equal(got.cpu().view(torch.uint8),
                           want.view(torch.uint8))
    items = sorted(b"https://host.example/" + b"p/" * int(k) + str(i).encode()
                   for i, k in enumerate(rng.integers(0, 40, 20_000)))
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offs[1:])
    vals = np.frombuffer(b"".join(items), np.uint8)
    stream = np.frombuffer(ref.encode_delta_byte_array(vals, offs), np.uint8)
    plens, suffixes, soffs, _ = dev.delta_byte_array_prescan(stream)
    eoffs = np.zeros(len(items) + 1, np.int64)
    np.cumsum(plens + np.diff(soffs), out=eoffs[1:])
    ops = [torch.from_numpy(np.array(a)) for a in
           (suffixes, plens, soffs[:-1], eoffs)]
    iters = dev.delta_byte_array_iters(plens)
    want = dev.delta_byte_array_expand(*ops, int(eoffs[-1]), iters)
    got = dev.delta_byte_array_expand(*(t.to(cuda_device) for t in ops),
                                      int(eoffs[-1]), iters)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), vals)
    idx = torch.from_numpy(rng.integers(0, len(items), 50_000))
    dv, do = torch.from_numpy(vals.copy()), torch.from_numpy(offs)
    for a, b in zip(dev.gather_byte_arrays(dv, do, idx),
                    dev.gather_byte_arrays(dv.to(cuda_device),
                                           do.to(cuda_device),
                                           idx.to(cuda_device))):
        assert torch.equal(a, b.cpu())
    lengths = idx % 17
    assert torch.equal(dev.cumsum_offsets(lengths),
                       dev.cumsum_offsets(lengths.to(cuda_device)).cpu())
    bits = rng.random(n) < 0.3
    bits[1000:5000] = True
    stream = np.frombuffer(ref.encode_rle(bits.astype(np.int64), 1),
                           np.uint8)
    tables = _run_tables(stream, n, 1)
    want = dev.rle_expand(torch.from_numpy(dev.pad_to_bucket(stream)), n,
                          *tables) != 0
    got = dev.rle_expand(
        torch.from_numpy(dev.pad_to_bucket(stream)).to(cuda_device), n,
        *(t.to(cuda_device) for t in tables)) != 0
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), bits)


def _run_tables(stream: np.ndarray, n: int, w: int) -> list:
    """``rle_expand``'s run-table operands of a hybrid stream."""
    from parquet_tpu_torch.ops import ref

    kinds, cnts, payloads, offs, _ = ref.scan_rle_runs(stream, n, w)
    return [torch.from_numpy(np.asarray(a, np.int64)) for a in
            (np.cumsum(cnts), kinds, payloads, offs * 8,
             np.full(len(kinds), w))]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3])
def test_rle_expand_on_card(w, cuda_device):
    """``rle_expand`` at lineitem's dictionary-index shape: about 4,000,000
    indexes of 1-3 bits in mixed RLE and bit-packed runs, on the card
    against its CPU result."""
    from parquet_tpu_torch.ops import device as dev
    from parquet_tpu_torch.ops import ref

    rng = np.random.default_rng(w)
    n = 4_000_000
    v = rng.integers(0, 1 << w, n)
    runs = rng.integers(0, n - 100, 2000)
    for s, k in zip(runs, rng.integers(8, 100, len(runs))):
        v[s:s + k] = v[s]
    stream = np.frombuffer(ref.encode_rle(v, w), np.uint8)
    tables = _run_tables(stream, n, w)
    kinds = tables[1]
    assert (kinds == 0).any() and (kinds == 1).any()
    buf = torch.from_numpy(dev.pad_to_bucket(stream))
    want = dev.rle_expand(buf, n, *tables)
    got = dev.rle_expand(buf.to(cuda_device), n,
                         *(t.to(cuda_device) for t in tables))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["lineitem", "enc"])
def test_value_tables_round_trip_on_card(table, cuda_device, tmp_path,
                                        monkeypatch):
    """``chip_smoke.py``'s lineitem (100,000 rows, Snappy) and enc (v2
    pages) tables, written by the port and read on the card, equal the
    generated columns and the CPU read."""
    import chip_smoke

    rows = 100_000
    if table == "lineitem":
        schema, data = chip_smoke.make_lineitem(rows, 0)
        opts = pqt.WriterOptions(compression="snappy", row_group_size=40_000,
                                 column_encoding=chip_smoke.LINEITEM_ENCODINGS)
    else:
        schema, data = chip_smoke.make_enc(rows, 0)
        opts = pqt.WriterOptions(
            data_page_version=2, row_group_size=40_000,
            data_page_size=16 << 10, column_encoding={
                n: spec[2] for n, spec in chip_smoke.ENC_COLUMNS.items()})
    path = str(tmp_path / f"{table}.parquet")
    pqt.write_table(data, path, opts, schema=schema)
    got = pqt.ParquetFile(path).read(device=cuda_device)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")
    chip_smoke.check_columns(got, data)
    cpu = pqt.ParquetFile(path).read(device="cpu")
    for name in data:
        a, b = got[name].materialize_host(), cpu[name].materialize_host()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert np.array_equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_assemble_ops_on_card(depth, cuda_device):
    """``assemble_single_list`` and ``assemble_nested`` on the card equal
    the same ops on the CPU and the host assembler, on levels of random
    offsets and validity at every level (200,000 rows)."""
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.ops import device as dev
    from parquet_tpu_torch.ops import levels
    from parquet_tpu_torch.schema import schema as S

    node = S.optional(S.leaf("e", Type.INT64))
    for _ in range(depth):
        node = S.list_of("l", node)
    leaf = S.message("m", [node]).leaves[0]
    infos = levels.repeated_ancestors(leaf)
    rng = np.random.default_rng(depth)
    offs, valid, count = [], [], 200_000
    for _ in infos:
        v = rng.random(count) > 0.05
        lens = np.where(v, rng.integers(0, 5, count), 0)
        o = np.zeros(count + 1, np.int64)
        np.cumsum(lens, out=o[1:])
        offs.append(o)
        valid.append(v)
        count = int(o[-1])
    d, r = levels.levels_for_nested(offs, valid, rng.random(count) > 0.1,
                                    leaf)
    host = levels.assemble(d, r, leaf)
    max_def = leaf.max_definition_level
    dc = torch.from_numpy(d).to(cuda_device)
    rc = torch.from_numpy(r).to(cuda_device)
    results = [dev.assemble_nested(dc, rc, infos, max_def)]
    if depth == 1:
        results.append(dev.assemble_single_list(dc, rc, infos[0].def_level,
                                                max_def))
    for got_offs, got_valid, got_leaf in results:
        assert got_leaf.device.type == "cuda"
        for k in range(depth):
            assert np.array_equal(got_offs[k].cpu().numpy(),
                                  host.list_offsets[k])
            assert np.array_equal(got_valid[k].cpu().numpy(),
                                  host.list_validity[k])
        assert np.array_equal(got_leaf.cpu().numpy(), host.validity)


@pytest.mark.cuda
def test_nested_tables_on_card(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.py``'s cfg 4 (160,000 rows) and mixed nested table
    (50,000 rows, 4 row groups), written by the port and read on the card,
    equal the generated leaves and the CPU read, take both kernels and
    leave ``HOST_ROUTE`` empty; the host-route fixture reads on the card
    with its chunks counted."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")
    cases = [(chip_smoke.make_cfg4(640_000, 0), pqt.WriterOptions(
        column_encoding={"ts.list.element": Encoding.DELTA_BINARY_PACKED})),
        (chip_smoke.make_nest_mix(50_000, 0), pqt.WriterOptions(
            compression="snappy", row_group_size=12_500,
            data_page_size=16 << 10,
            column_encoding=chip_smoke.NEST_MIX_ENCODINGS))]
    pqt.reset_launches()
    pqt.reset_host_route()
    for i, ((schema, data, want), opts) in enumerate(cases):
        path = str(tmp_path / f"nested{i}.parquet")
        pqt.write_table(data, path, opts, schema=schema)
        got = pqt.ParquetFile(path).read(device=cuda_device)
        chip_smoke.check_nested(got, want)
        cpu = pqt.ParquetFile(path).read(device="cpu")
        for name, col in cpu.items():
            assert all(torch.equal(a.cpu(), b) for a, b in zip(
                got[name].list_offsets, col.list_offsets)), name
    assert not any(pqt.HOST_ROUTE.values()), pqt.HOST_ROUTE
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    chip_smoke.host_route_fixture()


def _staging_table(n: int, rng) -> dict:
    """A column of each staged kind: PLAIN with nulls, dictionary indexes
    (dense and fused), delta miniblocks, byte arrays."""
    return {
        "id": np.ma.masked_array(np.arange(n, dtype=np.int64),
                                 mask=rng.random(n) < 0.1),
        "small": rng.integers(0, 200, n).astype(np.int32),
        "large": rng.integers(0, 3000, n).astype(np.int64),
        "ts": np.cumsum(rng.integers(0, 1000, n)),
        "s": np.array([b"s%d" % (i % 333) for i in range(n)], dtype=object),
    }


_STAGING_ENCODINGS = {"small": Encoding.RLE_DICTIONARY,
                      "large": Encoding.RLE_DICTIONARY,
                      "ts": Encoding.DELTA_BINARY_PACKED}


def _flat(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _flat(v)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if k != "ready":
                yield from _flat(v)


def _same_column(got, want) -> None:
    g, w = got.materialize_host(), want.materialize_host()
    for a, b in zip(g if isinstance(g, tuple) else (g,),
                    w if isinstance(w, tuple) else (w,)):
        assert np.array_equal(a, b)
    if want.validity is None:
        assert got.validity is None
    else:
        assert torch.equal(got.validity.cpu(), want.validity.cpu())


@pytest.mark.cuda
def test_staging_batch_on_card(cuda_device):
    """Each chunk's operands are views of one device buffer, filled from a
    pinned host buffer by one copy on a side stream, and decode as on the
    CPU."""
    from parquet_tpu_torch.parallel import device_reader as tdr

    rng = np.random.default_rng(11)
    buf = io.BytesIO()
    pqt.write_table(_staging_table(60_000, rng), buf, pqt.WriterOptions(
        row_group_size=30_000, data_page_size=8192,
        column_encoding=_STAGING_ENCODINGS))
    f = pqt.ParquetFile(buf.getvalue())
    for leaf in f.schema.leaves:
        for rg in f.row_groups:
            reader = rg.column(leaf.column_index)
            plan = tdr.build_plan(reader)
            batch = tdr._StagingBatch()
            staged = tdr.stage_plan(plan, cuda_device, batch.put)
            staged, ready = batch.commit(staged, cuda_device,
                                         side_stream=True)
            assert batch.host.is_pinned()
            event, dbuf = ready
            staged[2]["ready"] = ready
            ptr = dbuf.untyped_storage().data_ptr()
            tensors = list(_flat(staged))
            assert tensors and all(
                t.device.type == "cuda"
                and t.untyped_storage().data_ptr() == ptr for t in tensors)
            got = tdr.decode_staged(plan, staged, cuda_device)
            cpu_plan = tdr.build_plan(reader)
            want = tdr.decode_staged(cpu_plan, tdr.stage_plan(
                cpu_plan, torch.device("cpu")), torch.device("cpu"))
            _same_column(got, want)


@pytest.mark.cuda
def test_pipelined_read_on_card_equals_serial(cuda_device, tmp_path):
    """The pipelined read of a mapped file equals its serial read
    (``workers=0``) and the CPU read, three times back to back, with
    chunks staged two at a time."""
    from parquet_tpu_torch.io.column import concat_columns
    from parquet_tpu_torch.parallel import device_reader as tdr

    rng = np.random.default_rng(12)
    table = _staging_table(200_000, rng)
    path = str(tmp_path / "staging.parquet")
    pqt.write_table(table, path, pqt.WriterOptions(
        row_group_size=25_000, data_page_size=16 << 10,
        compression="snappy", column_encoding=_STAGING_ENCODINGS))
    f = pqt.ParquetFile(path)
    chunks = [rg.column(leaf.column_index)
              for leaf in f.schema.leaves for rg in f.row_groups]
    serial = tdr.decode_chunks_pipelined(chunks, cuda_device, workers=0)
    serial = {leaf.name: concat_columns([next(serial)
                                         for _ in f.row_groups])
              for leaf in f.schema.leaves}
    cpu = f.read(device="cpu")
    pqt.reset_pipeline()
    for _ in range(3):
        got = f.read(device=cuda_device)
        torch.cuda.synchronize()
        for name in table:
            _same_column(got[name], serial[name])
            _same_column(got[name], cpu[name])
    assert pqt.PIPELINE["stage_concurrency_peak"] >= 2
    assert pqt.PIPELINE["chunks_host_fallback"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_native_plan_on_card_equals_python_plan(cuda_device, version):
    """Every chunk planned by the C++ planner, staged on the card and
    decoded, equals the Python walk's plan decoded on the CPU; no chunk
    takes the Python walk."""
    from parquet_tpu_torch.parallel import device_reader as tdr

    rng = np.random.default_rng(13)
    buf = io.BytesIO()
    pqt.write_table(_staging_table(60_000, rng), buf, pqt.WriterOptions(
        row_group_size=30_000, data_page_size=8192, compression="snappy",
        data_page_version=version, column_encoding=_STAGING_ENCODINGS))
    f = pqt.ParquetFile(buf.getvalue())
    pqt.reset_plan_route()
    for leaf in f.schema.leaves:
        for rg in f.row_groups:
            reader = rg.column(leaf.column_index)
            plan = tdr.build_plan(reader)
            got = tdr.decode_staged(plan, tdr.stage_plan(plan, cuda_device),
                                    cuda_device)
            oracle = tdr._build_plan_python(reader)
            want = tdr.decode_staged(oracle, tdr.stage_plan(
                oracle, torch.device("cpu")), torch.device("cpu"))
            _same_column(got, want)
    assert pqt.PLAN_ROUTE["native"] == 2 * len(f.schema.leaves)
    assert sum(pqt.PLAN_ROUTE.values()) == pqt.PLAN_ROUTE["native"]


@pytest.mark.cuda
def test_fill_batch_into_pinned_memory(cuda_device):
    """One threaded C++ fill of a pinned batch (a large array, byte
    streams and miniblock rows) copies to the card as written."""
    from parquet_tpu_torch.ops import host
    from parquet_tpu_torch.parallel import device_reader as tdr

    rng = np.random.default_rng(14)
    big = rng.integers(0, 256, 9 << 20, dtype=np.uint8)
    values = rng.integers(0, 256, 50_000, dtype=np.uint8)
    starts = np.sort(rng.integers(0, 50_000, 4000))
    batch = tdr._StagingBatch()
    slots = [batch.put(big, extra=12),
             batch.put(tdr._MiniblockGather(values, starts, 40), extra=4)]
    assert host.fill_threads(batch.nbytes) > 1 or host.available_cpus() == 1
    staged, ready = batch.commit(slots, cuda_device, side_stream=True)
    assert batch.host.is_pinned()
    torch.cuda.synchronize()
    assert torch.equal(staged[0][:len(big)].cpu(), torch.from_numpy(big))
    assert not staged[0][len(big):].any()
    pad = np.concatenate([values, np.full(40, values[-1], np.uint8)])
    want = np.stack([pad[s:s + 40] for s in starts]).reshape(-1)
    assert torch.equal(staged[1][:len(want)].cpu(), torch.from_numpy(want))


def _scan_file(rows: int = 200_000) -> bytes:
    """The port's writer: a sorted INT32 ``ship`` key with a bloom filter,
    a 7-mode dictionary string ``mode``, a PLAIN string ``note`` with
    nulls, a sorted INT64 ``k``, a nullable double ``v`` and a nullable
    200-entry dictionary INT32 ``cat``, in 65,536-row row groups."""
    rng = np.random.default_rng(21)
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"], object)
    notes = np.array([f"note {i:03d}"[: 4 + i % 6] for i in range(300)],
                     object)
    table = {
        "ship": np.sort(rng.integers(8000, 12000, rows)).astype(np.int32),
        "mode": modes[rng.integers(0, 7, rows)],
        "note": np.ma.masked_array(notes[rng.integers(0, 300, rows)],
                                   mask=rng.random(rows) < 0.1),
        "k": np.arange(rows, dtype=np.int64) * 2,
        "v": np.ma.masked_array(rng.random(rows), mask=rng.random(rows) < .05),
        "cat": np.ma.masked_array(rng.integers(0, 200, rows).astype(np.int32),
                                  mask=rng.random(rows) < 0.1)}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=1 << 16, data_page_size=8192, compression="snappy",
        column_encoding={"ship": Encoding.PLAIN, "k": Encoding.PLAIN,
                         "v": Encoding.PLAIN, "note": Encoding.PLAIN,
                         "cat": Encoding.RLE_DICTIONARY},
        bloom_filters={"ship": 10}))
    return buf.getvalue()


def _host_form(form):
    if isinstance(form, torch.Tensor):
        return form.cpu()
    if isinstance(form, np.ndarray):
        return form
    return tuple(_host_form(x) for x in form)


def _same_form(a, b) -> None:
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_form(x, y)
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("ship", dict(lo=9000, hi=9200), ["k", "v", "mode", "note"], None),
    ("ship", dict(values=list(range(9000, 9640, 10))), ["k", "cat"],
     "bloom_check"),
    ("mode", dict(values=["MAIL", "SHIP"]), ["k", "ship"],
     "unpack_bits_dense"),
    ("k", dict(lo=20_000, hi=24_000), ["v", "cat"], "dict_unpack_gather")],
    ids=["range", "in_bloom", "dict_key", "nullable"])
def test_scan_on_card_equals_cpu(case, cuda_device):
    """One device scan a case on the card, equal to the same scan on the
    CPU form for form, with its kernel launched."""
    path, kw, columns, kernel = case
    data = _scan_file()
    pqt.reset_launches()
    got = pqt.scan_filtered_device(pqt.ParquetFile(data), path,
                                   columns=columns, device=cuda_device, **kw)
    launches = dict(pqt.LAUNCHES)
    want = pqt.scan_filtered_device(pqt.ParquetFile(data), path,
                                    columns=columns, device="cpu", **kw)
    for c in columns:
        _same_form(_host_form(got[c]), _host_form(want[c]))
    if kernel is not None:
        assert launches[kernel] > 0, launches


@pytest.mark.cuda
def test_scan_ops_on_card(cuda_device):
    """The scan's filter ops on the card against the CPU: the range and IN
    masks (signed and sign-flipped unsigned keys) and the compaction."""
    from parquet_tpu_torch.ops import device as dev

    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.int32, torch.int64):
        info = torch.iinfo(dtype)
        x = torch.randint(info.min, info.max, (1 << 20,), dtype=dtype,
                          generator=gen)
        probes = torch.unique(x[:: 4097])
        for flip in (False, True):
            v = dev.sign_flip(x) if flip else x
            for fn in (lambda t: dev.range_mask(t, -5, 1 << 30),
                       lambda t: dev.in_mask(t, probes.to(t.device))):
                want = fn(v)
                got = fn(v.to(cuda_device)).cpu()
                assert torch.equal(got, want)
                tgt, cnt = dev.compact_targets(want.to(cuda_device))
                out = dev.compact_prefix(v.to(cuda_device), tgt)
                assert torch.equal(out[:int(cnt)].cpu(), v[want])


def _dataset_files(root, files: int = 4) -> list:
    """Part files written by the port: PLAIN, dictionary (numeric and
    string), DELTA and nullable columns, three row groups a file."""
    from parquet_tpu_torch.io.writer import ColumnData

    rng = np.random.default_rng(11)
    words = [w.encode() for w in ("AIR", "MAIL", "SHIP", "TRUCK")]
    paths = []
    for i in range(files):
        n = 30_000
        idx = rng.integers(0, len(words), n)
        values = np.concatenate([np.frombuffer(words[j], np.uint8)
                                 for j in idx])
        lens = np.array([len(words[j]) for j in idx], np.int64)
        table = {
            "id": np.arange(i * n, (i + 1) * n, dtype=np.int64),
            "cat": np.ma.masked_array(rng.integers(0, 200, n).astype(
                np.int32), mask=rng.random(n) < 0.1),
            "ts": np.cumsum(rng.integers(0, 1000, n)),
            "mode": ColumnData(values=values, offsets=np.concatenate(
                [[0], np.cumsum(lens)])),
        }
        opts = pqt.WriterOptions(
            row_group_size=10_000, compression="snappy", column_encoding={
                "id": Encoding.PLAIN, "cat": Encoding.RLE_DICTIONARY,
                "ts": Encoding.DELTA_BINARY_PACKED,
                "mode": Encoding.RLE_DICTIONARY})
        path = str(root / f"part-{i}.parquet")
        pqt.write_table(table, path, opts)
        paths.append(path)
    return paths


def _same_columns(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, col in want.items():
        a, b = got[name].materialize_host(), col.materialize_host()
        if isinstance(a, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        va = None if got[name].validity is None else got[name].validity.cpu()
        vb = col.validity
        assert (va is None) == (vb is None) and (
            va is None or torch.equal(va, vb)), name


@pytest.mark.cuda
@pytest.mark.parametrize("devices", ["list1", "list4", "cuda"])
def test_dataset_read_on_card_matches_cpu(cuda_device, tmp_path, devices):
    """Dataset.read on [cuda:0], [cuda:0] * 4 (four files in flight on
    one card) and "cuda", each equal to the CPU's read, on the device
    route alone and with the staged bytes drained."""
    paths = _dataset_files(tmp_path)
    want = pqt.Dataset(paths).read(device="cpu")
    mesh = {"list1": [cuda_device], "list4": [cuda_device] * 4,
            "cuda": "cuda"}[devices]
    pqt.reset_mesh()
    pqt.reset_route_refusals()
    pqt.reset_launches()
    got = pqt.Dataset(paths).read(device=mesh)
    torch.cuda.synchronize()
    assert got["id"].values.device.type == "cuda"
    _same_columns(got, want)
    assert pqt.MESH["files_sharded"] == len(paths)
    assert pqt.MESH["stage_overlapped"] == (3 if devices == "list4" else 0)
    assert pqt.MESH["staging_bytes"] == 0
    assert sum(pqt.ROUTE_REFUSALS.values()) == 0
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0, pqt.LAUNCHES


@pytest.mark.cuda
def test_read_table_sharded_on_card_matches_cpu(cuda_device, tmp_path):
    """Four shards on one card: the file's three row groups, one shard
    all padding, shard for shard equal to the CPU's."""
    path = _dataset_files(tmp_path, files=1)[0]
    want = pqt.read_table_sharded(path, mesh=["cpu"] * 4)
    got = pqt.read_table_sharded(path, mesh=[cuda_device] * 4)
    torch.cuda.synchronize()
    assert got.row_counts == want.row_counts == (10_000, 10_000, 10_000, 0)
    for table in ("arrays", "validity"):
        g, w = getattr(got, table), getattr(want, table)
        assert set(g) == set(w)
        for path_ in w:
            for a, b in zip(g[path_], w[path_]):
                assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    for path_, (v, o) in want.dictionaries.items():
        assert np.array_equal(got.dictionaries[path_][0], v)
        assert np.array_equal(got.dictionaries[path_][1], o)
    step_in = [torch.zeros(4, 64, dtype=torch.uint8),
               torch.zeros(4, 64, dtype=torch.uint8),
               torch.full((4, 1), 8, dtype=torch.int64),
               torch.zeros(4, 1, dtype=torch.uint8),
               torch.ones(4, 1, dtype=torch.int32),
               torch.zeros(4, 1, dtype=torch.int64),
               torch.ones(4, 1, dtype=torch.int32)]
    rows = pqt.decode_step_sharded([cuda_device] * 4, 8)(*step_in)[2]
    assert rows.device.type == "cuda" and int(rows) == 32


def _same_host_result(got: dict, want: dict) -> None:
    """Two host-scan results equal: byte lists, or arrays (masked or not)
    of one type and dtype, bit for bit."""
    assert list(got) == list(want)
    for c, w in want.items():
        g = got[c]
        if isinstance(w, list):
            assert g == w, c
            continue
        assert type(g) is type(w) and g.dtype == w.dtype, c
        assert np.array_equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w))
        assert np.array_equal(np.ma.getdata(g).view(np.uint8),
                              np.ma.getdata(w).view(np.uint8)), c


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("ship", dict(lo=9000, hi=9200), ["k", "v", "mode", "note"], 0),
    ("ship", dict(values=list(range(9000, 9640, 10))), ["k", "cat"], 1),
    ("mode", dict(values=["MAIL", "SHIP"]), ["k", "note"], 0)],
    ids=["range", "in_bloom", "dict_key"])
def test_host_scan_on_card_equals_cpu(case, cuda_device):
    """The host scan with its planner's bloom probe on the card equals it
    on the CPU, with one ``bloom_check`` launch a plan that probes."""
    path, kw, columns, probes = case
    data = _scan_file()
    pqt.reset_launches()
    got = pqt.scan_filtered(pqt.ParquetFile(data), path, columns=columns,
                            device=cuda_device, **kw)
    assert pqt.LAUNCHES["bloom_check"] == probes, pqt.LAUNCHES
    want = pqt.scan_filtered(pqt.ParquetFile(data), path, columns=columns,
                             device="cpu", **kw)
    _same_host_result(got, want)
    from parquet_tpu_torch.algebra.expr import col

    tree = (col("ship") <= 8100) | ~col("mode").isin(["AIR", "MAIL"])
    _same_host_result(
        pqt.scan_expr(pqt.ParquetFile(data), tree, device=cuda_device),
        pqt.scan_expr(pqt.ParquetFile(data), tree, device="cpu"))


@pytest.mark.cuda
def test_routed_scan_on_card(cuda_device, monkeypatch):
    """``scan`` on the card: pinned to the device route it equals the
    device scan; a PLAIN string key goes to the host scan with the
    footer's reason; pinned to the host it equals the CPU's host scan."""
    data = _scan_file()
    pf = pqt.ParquetFile(data)
    monkeypatch.setenv("PARQUET_TPU_TORCH_ROUTE", "device")
    got = pqt.scan(pf, "ship", lo=9000, hi=9200, columns=["k", "v"],
                   device=cuda_device)
    want = pqt.scan_filtered_device(pf, "ship", lo=9000, hi=9200,
                                    columns=["k", "v"], device=cuda_device)
    for c in ("k", "v"):
        _same_form(_host_form(got[c]), _host_form(want[c]))
    d = pqt.route_scan(pf, "note", values=["n1"], device=cuda_device)
    assert d.route == "host" and "non-dictionary" in d.reason
    monkeypatch.setenv("PARQUET_TPU_TORCH_ROUTE", "host")
    _same_host_result(
        pqt.scan(pf, "ship", lo=9000, hi=9200, columns=["k", "note"],
                 device=cuda_device),
        pqt.scan_filtered(pf, "ship", lo=9000, hi=9200,
                          columns=["k", "note"], device="cpu"))


@pytest.mark.cuda
def test_page_level_fallback_on_card(cuda_device, monkeypatch):
    """The host-route fixture's string key, whose dictionary falls back to
    PLAIN mid-chunk: the footer passes it, the device scan refuses it, the
    routed scan pinned to the card falls back to the host scan."""
    import os

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
    a = np.load(os.path.join(here, "host_route.npz"))
    pf = pqt.ParquetFile(os.path.join(here, "host_route.parquet"))
    o = a["s_offsets"]
    probe = [a["s_values"][o[i]:o[i + 1]].tobytes() for i in (3, 2500)]
    assert pqt.device_route_supported(pf, "s", ["k"], probe)[0]
    with pytest.raises(ValueError, match="use the host scan"):
        pqt.stage_scan(pf, "s", values=probe, columns=["k"],
                       device=cuda_device)
    monkeypatch.setenv("PARQUET_TPU_TORCH_ROUTE", "device")
    got = pqt.scan(pf, "s", values=probe, columns=["k"], device=cuda_device)
    want = pqt.scan_filtered(pf, "s", values=probe, columns=["k"],
                             device="cpu")
    _same_host_result(got, want)
    assert got["k"].tolist() == [int(a["k"][3]), int(a["k"][2500])]


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [1, 2])
def test_dataset_scan_and_sharded_scan_on_card(cuda_device, tmp_path,
                                               entries):
    """``Dataset.scan`` and ``scan_filtered_sharded`` at
    ``[cuda:0] * entries``, equal to the CPU's."""
    paths = _dataset_files(tmp_path)
    mesh = [cuda_device] * entries
    _same_host_result(
        pqt.Dataset(paths).scan("cat", lo=10, hi=40, device=mesh),
        pqt.Dataset(paths).scan("cat", lo=10, hi=40, device="cpu"))
    pf = pqt.ParquetFile(paths[0])
    got = pqt.scan_filtered_sharded(pf, "id", lo=5000, hi=25_000,
                                    columns=["cat", "ts"], mesh=mesh)
    want = pqt.scan_filtered_sharded(pf, "id", lo=5000, hi=25_000,
                                     columns=["cat", "ts"],
                                     mesh=["cpu"] * entries)
    assert got["#rows"] == want["#rows"] == 20_001
    for c in ("cat", "ts"):
        for a, b in zip(got[c], want[c]):
            _same_form(_host_form(a), _host_form(b))


@pytest.mark.cuda
def test_gather_byte_arrays_cpp_on_card_machine(cuda_device):
    """The C++ survivor gather against its numpy version at a chunk's
    size (the machine's own compiler)."""
    from parquet_tpu_torch.ops import host

    rng = np.random.default_rng(4)
    offs = np.arange(1_000_001, dtype=np.int64) * 27
    vals = rng.integers(0, 256, int(offs[-1])).astype(np.uint8)
    idx = np.flatnonzero(rng.random(1_000_000) < 0.1)
    for a, b in zip(host.gather_byte_arrays(vals, offs, idx),
                    host.gather_byte_arrays_numpy(vals, offs, idx)):
        assert np.array_equal(a, b)


def _same_hits(got, want, columns) -> None:
    assert got.counters == want.counters
    for g, w in zip(got, want):
        assert np.array_equal(g.rows, w.rows)
        for c in columns:
            if isinstance(w.values[c], list):
                assert g.values[c] == w.values[c]
            else:
                assert np.array_equal(g.values[c], w.values[c])
            assert (g.validity[c] is None) == (w.validity[c] is None)
            if w.validity[c] is not None:
                assert np.array_equal(g.validity[c], w.validity[c])


@pytest.mark.cuda
def test_byte_array_lookup_on_card_matches_cpu(cuda_device, tmp_path):
    """A BYTE_ARRAY key with a bloom filter, 42,500 keys inside the
    column's range (one row group's batch above the device probe's
    32,768): one
    ``bloom_check`` launch, and hits and counters equal the CPU's, each
    run from cleared caches, on a file on disk."""
    n = 60_000
    rng = np.random.default_rng(4)
    words = np.empty(n, object)
    words[:] = sorted(b"sku-%09d" % i for i in rng.choice(10**9, n,
                                                          replace=False))
    path = str(tmp_path / "s.parquet")
    pqt.write_table({"s": words, "v": np.arange(n, dtype=np.int64)}, path,
                    pqt.WriterOptions(row_group_size=n, data_page_size=8192,
                                      bloom_filters={"s": 10},
                                      column_encoding={"s": Encoding.PLAIN}))
    keys = list(words[::8]) + [b"sku-%09dx" % i for i in
                               rng.integers(0, 10**9, 35_000)]
    pqt.clear_caches()
    want = pqt.ParquetFile(path).find_rows("s", keys, columns=["v", "s"],
                                           device="cpu")
    pqt.clear_caches()
    pqt.reset_launches()
    got = pqt.ParquetFile(path).find_rows("s", keys, columns=["v", "s"],
                                          device=cuda_device)
    assert pqt.LAUNCHES["bloom_check"] == 1
    _same_hits(got, want, ["v", "s"])
    assert got.counters["rows_matched"] == len(words[::8])


@pytest.mark.cuda
def test_dataset_find_rows_on_card_matches_cpu(cuda_device, tmp_path):
    """Three part files, looked up as one dataset on the card and on the
    CPU from cleared caches: the same global rows, values and counters."""
    paths = []
    for i in range(3):
        p = str(tmp_path / f"part-{i}.parquet")
        k = np.arange(i * 10_000, (i + 1) * 10_000, dtype=np.int64)
        pqt.write_table({"k": k, "v": (k * 3).astype(np.float64)}, p,
                        pqt.WriterOptions(row_group_size=5000,
                                          data_page_size=4096,
                                          bloom_filters={"k": 10}))
        paths.append(p)
    keys = np.arange(0, 40_000, 7, dtype=np.int64)
    pqt.clear_caches()
    want = pqt.Dataset(paths).find_rows("k", keys, columns=["v"],
                                        device="cpu")
    pqt.clear_caches()
    got = pqt.Dataset(paths).find_rows("k", keys, columns=["v"],
                                       device=cuda_device)
    _same_hits(got, want, ["v"])
    assert got.counters["rows_matched"] == int((keys < 30_000).sum())


# ---------------------------------------------------------------------------
# reads through a faulty source
# ---------------------------------------------------------------------------


def _five_columns(path: str) -> None:
    """Four row groups of dictionary, delta and nullable columns (both
    unpack kernels run on the card)."""
    rng = np.random.default_rng(9)
    n = 40_000
    pqt.write_table(
        {"k": rng.integers(0, 500, n).astype(np.int64),
         "cat": np.ma.masked_array(rng.integers(0, 50, n).astype(np.int32),
                                   mask=rng.random(n) < 0.1),
         "ts": np.cumsum(rng.integers(0, 1000, n)).astype(np.int64)}, path,
        pqt.WriterOptions(row_group_size=10_000, column_encoding={
            "k": Encoding.RLE_DICTIONARY, "cat": Encoding.RLE_DICTIONARY,
            "ts": Encoding.DELTA_BINARY_PACKED}))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["policy", "ring", "skip"])
def test_fault_reads_on_card_match_the_clean_read(cuda_device, tmp_path,
                                                  monkeypatch, case):
    """A retried read (transient errors under a policy), the same through
    the ring prefetcher, and a read that skips a corrupt row group, each
    equal on the card to the clean read of the rows it keeps."""
    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    clean = pqt.ParquetFile(path).read(device=cuda_device)
    rep = pqt.ReadReport()
    if case == "skip":
        m = pqt.ParquetFile(path).metadata.row_groups[2].columns[0].meta_data
        off = m.dictionary_page_offset or m.data_page_offset
        src = pqt.FaultInjectingSource(pqt.MmapSource(path),
                                       flip_offsets=[off, off + 1, off + 2])
        pol = pqt.FaultPolicy(backoff_s=0, on_corrupt="skip_row_group")
        clean = pqt.ParquetFile(path).read(device=cuda_device,
                                           row_groups=[0, 1, 3])
    else:
        if case == "ring":
            monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH", "ring")
        src = pqt.FaultInjectingSource(pqt.MmapSource(path), seed=3,
                                       error_rate=0.3,
                                       max_consecutive_errors=2)
        pol = pqt.FaultPolicy(max_retries=3, backoff_s=0)
    clean = {n: c.to(torch.device("cpu")) for n, c in clean.items()}
    pqt.reset_launches()
    got = pqt.ParquetFile(src, policy=pol).read(device=cuda_device,
                                                report=rep)
    _same_columns(got, clean)
    assert got["k"].values.device == cuda_device
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    if case == "skip":
        assert rep.row_groups_skipped == [2] and rep.rows_dropped == 10_000
    else:
        assert rep.ok and rep.retries > 0


def _settled_allocated(device) -> int:
    """Allocated card bytes once the blocks freed while waiting on another
    stream's events are returned (a small allocation processes them)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.empty(1, device=device)
    return torch.cuda.memory_allocated()


@pytest.mark.cuda
def test_deadline_read_on_card_then_a_clean_read(cuda_device, tmp_path):
    """A read past its deadline raises ``DeadlineError`` and leaves no
    thread and no allocated card memory behind; the next read is equal."""
    import threading

    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    clean = pqt.ParquetFile(path).read(device=cuda_device)
    threads, allocated = (threading.active_count(),
                          _settled_allocated(cuda_device))
    pf = pqt.ParquetFile(pqt.FaultInjectingSource(pqt.MmapSource(path),
                                                  latency_s=0.05))
    with pytest.raises(pqt.DeadlineError):
        pf.read(device=cuda_device,
                policy=pqt.FaultPolicy(deadline_s=0.005, backoff_s=0))
    assert threading.active_count() == threads
    assert _settled_allocated(cuda_device) == allocated
    _same_columns(pqt.ParquetFile(path).read(device=cuda_device),
                  {n: c.to(torch.device("cpu")) for n, c in clean.items()})


# ---------------------------------------------------------------------------
# streamed drains on the card (io/stream.py)
# ---------------------------------------------------------------------------


def _host_drain(batches) -> list:
    """Each batch as ``{path: host form}`` (the batch dropped after)."""
    out = []
    for b in batches:
        out.append({p: (c.materialize_host(), None if c.validity is None
                        else c.validity.cpu().numpy(),
                        [o.cpu().numpy() for o in c.list_offsets],
                        [v.cpu().numpy() for v in c.list_validity])
                    for p, c in b.items()})
    return out


def _same_drain(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for p in g:
            _same_tree(g[p], w[p], p)


def _same_tree(a, b, what) -> None:
    if isinstance(a, dict):
        for k in a:
            if k in ("def_levels", "rep_levels") and (a[k] is None
                                                      or b[k] is None):
                continue
            _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same_tree(x, y, what)
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        assert np.array_equal(a, b), what


@pytest.mark.cuda
def test_stream_on_card_matches_the_cpu_drain(cuda_device, tmp_path):
    """A drain of the five-column file on the card equals the CPU's batch
    by batch, takes both unpack kernels and no host route."""
    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    want = _host_drain(pqt.ParquetFile(path).iter_batches(
        batch_rows=7_000, device="cpu"))
    pqt.reset_launches()
    pqt.reset_host_route()
    batches = pqt.ParquetFile(path).iter_batches(batch_rows=7_000,
                                                 device=cuda_device)
    got = []
    for b in batches:
        assert b["k"].values.device == cuda_device
        got += _host_drain([b])
    _same_drain(got, want)
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    assert not any(pqt.HOST_ROUTE.values()), pqt.HOST_ROUTE


@pytest.mark.cuda
def test_nested_and_dataset_streams_on_card(cuda_device, tmp_path):
    """``chip_smoke.py``'s mixed nested table and the dataset parts drained
    on the card equal their CPU drains."""
    import chip_smoke

    schema, data, _ = chip_smoke.make_nest_mix(20_000, 0)
    path = str(tmp_path / "mix.parquet")
    pqt.write_table(data, path, pqt.WriterOptions(
        compression="snappy", row_group_size=6_000, data_page_size=8 << 10,
        column_encoding=chip_smoke.NEST_MIX_ENCODINGS), schema=schema)
    for drain in (lambda d: pqt.ParquetFile(path).iter_batches(
            batch_rows=2_500, device=d),
            lambda d: pqt.Dataset(_dataset_files(tmp_path)).iter_batches(
                batch_rows=4_096, device=d)):
        _same_drain(_host_drain(drain(cuda_device)), _host_drain(
            drain("cpu")))


@pytest.mark.cuda
def test_closed_drain_leaves_nothing_on_card(cuda_device, tmp_path):
    """A drain closed after its first batch leaves no thread and no
    allocated card memory behind."""
    import threading

    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    threads, allocated = (threading.active_count(),
                          _settled_allocated(cuda_device))
    it = pqt.ParquetFile(path).iter_batches(batch_rows=5_000,
                                            device=cuda_device)
    first = next(it)
    assert first["ts"].values.device == cuda_device
    del first
    it.close()
    assert threading.active_count() == threads
    assert _settled_allocated(cuda_device) == allocated


@dataclasses.dataclass
class _Geo:
    lat: float
    lon: float


@dataclasses.dataclass
class _Event:
    id: int
    region: int
    user: str
    score: Optional[float]
    tags: List[str]
    attrs: Dict[str, int]
    geo: Optional[_Geo]


def _typed_events(n: int) -> list:
    rng = np.random.default_rng(4)
    return [_Event(i, int(rng.integers(0, 200)), f"u{int(rng.integers(500))}",
                   None if i % 20 == 0 else float(rng.random()),
                   [f"t{int(x)}" for x in rng.integers(0, 32, i % 5)],
                   {f"a{j}": j for j in range(i % 4)},
                   None if i % 10 == 3 else _Geo(float(i), -float(i)))
            for i in range(n)]


@pytest.mark.cuda
def test_typed_drain_on_card_matches_cpu(cuda_device, tmp_path):
    """``TypedReader.read(n)`` draining the stream on the card gives the
    CPU's objects and launches both unpack kernels; ``read_pytree``'s
    tensors live on the card and equal the CPU's."""
    path = str(tmp_path / "ev.parquet")
    pqt.write_objects(_typed_events(30_000), path,
                      options=pqt.WriterOptions(row_group_size=8_192))
    pqt.reset_launches()
    r = pqt.TypedReader(path, _Event, batch_rows=4_096, device=cuda_device)
    want = pqt.read_objects(path, _Event, device="cpu")
    got = []
    while True:
        chunk = r.read(5_000)
        if not chunk:
            break
        got += chunk
    assert got == want
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    tree = pqt.read_pytree(path, device=cuda_device)
    cpu = pqt.read_pytree(path, device="cpu")
    assert tree["id"].device == cuda_device
    assert torch.equal(tree["id"].cpu(), cpu["id"])


def _sorted_runs(tmp_path, count: int, rows: int) -> list:
    rng = np.random.default_rng(6)
    paths = []
    for i in range(count):
        k, v = rng.integers(0, 10**5, rows), rng.random(rows)
        order = np.lexsort((v, k))  # sorted by (k, v)
        k, v = k[order], v[order]
        path = str(tmp_path / f"run{i}.parquet")
        pqt.write_table({"k": k, "v": v,
                         "s": np.array([f"s{int(x) % 97}" for x in k],
                                       object)}, path,
                        pqt.WriterOptions(row_group_size=20_000))
        paths.append(path)
    return paths


@pytest.mark.cuda
def test_merge_and_sort_on_card_match_cpu(cuda_device, tmp_path):
    """``merge_files`` and ``SortingWriter`` reading their runs on the
    card write the same bytes as on the CPU."""
    runs = _sorted_runs(tmp_path, 4, 50_000)
    sorting = [pqt.SortingColumn("k"), pqt.SortingColumn("v")]
    outs = {}
    for dev in (cuda_device, "cpu"):
        out = io.BytesIO()
        pqt.merge_files(runs, sorting, out, batch_rows=8_192, device=dev)
        outs[str(dev)] = out.getvalue()
    assert outs[str(cuda_device)] == outs["cpu"]
    pf = pqt.ParquetFile(runs[0])
    cols = pqt.convert_table(pf, pf.schema, device=cuda_device)
    sorted_outs = {}
    for dev in (cuda_device, "cpu"):
        out = io.BytesIO()
        w = pqt.SortingWriter(out, pf.schema, [pqt.SortingColumn("v")],
                              buffer_rows=12_000, device=dev)
        for c, n in cols:
            w.write(c, n)
        w.close()
        sorted_outs[str(dev)] = out.getvalue()
    assert sorted_outs[str(cuda_device)] == sorted_outs["cpu"]


@pytest.mark.cuda
def test_file_rows_seek_on_card_matches_cpu(cuda_device, tmp_path):
    """``FileRows.seek_to_row`` and ``read_rows`` on the card give the
    CPU's rows (a nested file with a page index)."""
    from parquet_tpu_torch import rows as R
    from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
    from parquet_tpu_torch.format.enums import Type
    from parquet_tpu_torch.schema import schema as S

    schema = S.message("m", [
        S.leaf("id", Type.INT64),
        S.list_of("xs", S.optional(S.group("element", [
            S.optional(S.leaf("a", Type.INT32))]))),
        S.group("g", [S.repeated(S.leaf("b", Type.INT64))], Rep.OPTIONAL)])
    recs = [{"id": i, "xs": None if i % 7 == 1 else [
        None if j == 1 else {"a": None if j == 2 else i + j}
        for j in range(i % 4)], "g": None if i % 5 == 2 else {
        "b": list(range(i % 3))}} for i in range(6_000)]
    path = str(tmp_path / "rows.parquet")
    R.write_rows(path, schema, recs, pqt.WriterOptions(
        row_group_size=2_000, data_page_size=1_024))
    assert list(R.read_rows(path, device=cuda_device)) == recs
    card = R.FileRows(pqt.ParquetFile(path), device=cuda_device)
    cpu = R.FileRows(pqt.ParquetFile(path), device="cpu")
    for r in (0, 1, 1_999, 2_000, 3_333, 5_999, 6_000):
        card.seek_to_row(r)
        cpu.seek_to_row(r)
        a, b = card.read_rows(300), cpu.read_rows(300)
        assert [[(v.column, v.value, v.definition_level,
                  v.repetition_level) for v in row] for row in a] == \
            [[(v.column, v.value, v.definition_level, v.repetition_level)
              for v in row] for row in b]


# ---------------------------------------------------------------------------
# the aggregation cascade on the card
# ---------------------------------------------------------------------------


def _agg_file(tmp_path) -> str:
    """Dictionary-encoded numerics (50 and 11 random values: every index
    run bit-packed), a PLAIN double, a sorted key and a string."""
    rng = np.random.default_rng(11)
    n = 200_000
    path = str(tmp_path / "agg.parquet")
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.01] = np.nan
    pqt.write_table({
        "k": np.sort(rng.integers(0, 50_000, n)).astype(np.int64),
        "q": rng.integers(1, 51, n).astype(np.int64),
        "d": np.round(rng.random(n) * 0.1, 2),
        "f": np.ma.MaskedArray(f, mask=rng.random(n) < 0.05),
        "u": rng.integers(0, 2**31, n).astype(np.int32),
        "s": np.array([b"A", b"N", b"R"], dtype=object)[
            rng.integers(0, 3, n)]}, path,
        pqt.WriterOptions(row_group_size=50_000, data_page_size=64 << 10,
                          column_encoding={"f": Encoding.PLAIN,
                                           "k": Encoding.PLAIN}))
    return path


AGGS = [pqt.count(), pqt.count("f"), pqt.sum_("q"), pqt.sum_("f"),
        pqt.min_("f"), pqt.max_("f"), pqt.avg("d"), pqt.variance("q"),
        pqt.count_distinct("q"), pqt.top_k("f", 5), pqt.top_k("k", 3, False),
        pqt.sum_sq("u"), pqt.max_("s")]


def _same_agg(got, want) -> None:
    assert list(got.keys()) == list(want.keys())
    for name in want.keys():
        g, w = got[name], want[name]
        if isinstance(w, float) and name.startswith(("sum(", "avg(",
                                                      "variance(")):
            assert g == pytest.approx(w, rel=1e-9, nan_ok=True), name
        else:
            assert g == w and type(g) is type(w), (name, g, w)
    assert got.counters == want.counters


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["none", "range", "tree"])
def test_aggregate_on_card_matches_cpu(cuda_device, tmp_path, where):
    path = _agg_file(tmp_path)
    w = {"none": None, "range": pqt.col("k").between(10_000, 27_000),
         "tree": (pqt.col("q") <= 20) & (pqt.col("k") >= 5_000)}[where]
    pf = pqt.ParquetFile(path)
    pqt.reset_agg()
    got = pf.aggregate(AGGS, where=w, device=cuda_device)
    assert pqt.AGG["device_folds"] > 0 or where == "none"
    want = pf.aggregate(AGGS, where=w, device="cpu")
    _same_agg(got, want)
    got = pf.aggregate([pqt.sum_("q"), pqt.max_("f"), pqt.count()],
                       where=w, group_by="s", device=cuda_device)
    want = pf.aggregate([pqt.sum_("q"), pqt.max_("f"), pqt.count()],
                        where=w, group_by="s", device="cpu")
    assert got.groups == want.groups
    _same_agg(got, want)


@pytest.mark.cuda
def test_aggregate_tiers_launch_their_kernels_on_card(cuda_device, tmp_path):
    """The dictionary tier unpacks indexes with no gather; the exact tier
    gathers through ``dict_unpack_gather``; no chunk takes the host
    route."""
    path = _agg_file(tmp_path)
    pf = pqt.ParquetFile(path)
    pqt.reset_launches()
    pqt.reset_host_route()
    pf.aggregate([pqt.sum_("q"), pqt.count_distinct("d"),
                  pqt.variance("d")], device=cuda_device)
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    assert pqt.LAUNCHES["dict_unpack_gather"] == 0
    pqt.reset_launches()
    pf.aggregate([pqt.sum_("q"), pqt.max_("d")],
                 where=pqt.col("f") >= 0.5, device=cuda_device)
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    assert sum(pqt.HOST_ROUTE.values()) == 0


@pytest.mark.cuda
def test_aggregate_fused_on_card_equals_default(cuda_device, tmp_path,
                                                monkeypatch):
    path = _agg_file(tmp_path)
    pf = pqt.ParquetFile(path)
    w = (pqt.col("q") <= 20) & (pqt.col("k") >= 5_000)
    aggs = [pqt.count(), pqt.sum_("q"), pqt.max_("f"), pqt.avg("d")]
    want = pf.aggregate(aggs, where=w, device=cuda_device)
    assert "(fused)" not in want.explain()  # auto never fuses on a card
    monkeypatch.setenv("PARQUET_TPU_TORCH_FUSED", "on")
    got = pf.aggregate(aggs, where=w, device=cuda_device)
    assert "(fused)" in got.explain()
    _same_agg(got, want)
    before = torch.cuda.memory_allocated(cuda_device)
    del got, want
    assert torch.cuda.memory_allocated(cuda_device) <= before


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", ["off", "force"])
def test_write_from_cuda_tensors(cuda_device, tmp_path, monkeypatch,
                                 overlap):
    """Columns read on the card go straight back to ``write_table`` as
    CUDA tensors: the file is committed atomically, equals the write of
    the same columns from the host byte for byte, reads back equal, and
    leaves no temp file and no writer thread."""
    from torch_fixtures.threads import assert_no_thread_started, threads_now

    monkeypatch.setenv("PARQUET_TPU_TORCH_WRITE_OVERLAP", overlap)
    src = str(tmp_path / "src.parquet")
    _five_columns(src)
    f = pqt.ParquetFile(src)
    read = f.read(device=cuda_device)
    cols = {name: pqt.ColumnData(values=c.values, validity=c.validity)
            for name, c in read.items()}
    host = {name: pqt.ColumnData(
        values=c.values.cpu().numpy(),
        validity=None if c.validity is None else c.validity.cpu().numpy())
        for name, c in read.items()}
    opts = pqt.WriterOptions(row_group_size=10_000)
    threads = threads_now()
    dest = tmp_path / "card.parquet"
    w = pqt.write_table(cols, str(dest), opts, schema=f.schema)
    assert w.write_stats.row_groups == 4
    assert w.write_stats.bytes_flushed == dest.stat().st_size
    buf = io.BytesIO()
    pqt.write_table(host, buf, opts, schema=f.schema)
    assert dest.read_bytes() == buf.getvalue()
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
    assert_no_thread_started(threads)
    back = pqt.ParquetFile(str(dest)).read(device=cuda_device)
    for name, c in read.items():
        assert torch.equal(back[name].values, c.values)
        assert (c.validity is None) == (back[name].validity is None)
        if c.validity is not None:
            assert torch.equal(back[name].validity, c.validity)


@pytest.mark.cuda
def test_verify_file_decodes_on_card(cuda_device, tmp_path):
    """``verify_file(decode=True)`` decodes every chunk on the card through
    both unpack kernels and no host route; a flipped page byte is one CRC
    issue and one decode issue at its row group and column."""
    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    pqt.reset_launches()
    pqt.reset_host_route()
    rep = pqt.verify_file(path, decode=True)
    assert rep.ok and rep.chunks_decoded == 12, rep.summary()
    assert pqt.LAUNCHES["unpack_bits_dense"] > 0
    assert pqt.LAUNCHES["dict_unpack_gather"] > 0
    assert not any(pqt.HOST_ROUTE.values())
    chunk = pqt.ParquetFile(path).row_group(2).column(2)
    page = next(p for p in chunk.pages()
                if p.header.data_page_header is not None)
    raw = bytearray(open(path, "rb").read())
    at = page.offset + (chunk.byte_range[0] + chunk.byte_range[1]
                        - page.offset) // 2
    raw[at] ^= 0xFF
    bad = pqt.verify_file(bytes(raw), decode=True, device=cuda_device)
    assert [(i.kind, i.row_group, i.column) for i in bad.issues] == [
        ("crc", 2, "ts"), ("decode", 2, "ts")], bad.summary()
    assert bad.chunks_decoded == 11


# ---------------------------------------------------------------------------
# writable tables on the card (dataset_writer.py)
# ---------------------------------------------------------------------------

TABLE_PART_ROWS = 40_000  # two 20,000-row row groups a part
TABLE_STEP = 3  # keys step by 3: the gaps are absent keys


def _table_columns(part: int, seed: int) -> dict:
    """Part ``part``'s keys in a seeded order, a dictionary int column, a
    double and a dictionary string column."""
    rng = np.random.default_rng(seed)
    n = TABLE_PART_ROWS
    k = (np.arange(n, dtype=np.int64) + part * n) * TABLE_STEP
    rng.shuffle(k)
    words = [b"AIR", b"MAIL", b"SHIP", b"TRUCK"]
    s = [words[int(x) % 4] for x in k]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in s], out=offs[1:])
    return {"k": pqt.ColumnData(k),
            "q": pqt.ColumnData((k % 50).astype(np.int64)),
            "v": pqt.ColumnData(k * 0.5),
            "s": pqt.ColumnData(np.frombuffer(b"".join(s), np.uint8).copy(),
                                offsets=offs)}


def _table_schema():
    from parquet_tpu_torch.format.enums import Type

    return pqt.message("t", [pqt.leaf("k", Type.INT64),
                             pqt.leaf("q", Type.INT64),
                             pqt.leaf("v", Type.DOUBLE),
                             pqt.leaf("s", Type.BYTE_ARRAY, logical="string")])


def _table(root, sort: bool = True, commits: int = 4) -> str:
    d = str(root / "table")
    with pqt.DatasetWriter(d, _table_schema(),
                           sorting=[pqt.SortingColumn("k")] if sort else None,
                           options=pqt.WriterOptions(
                               row_group_size=TABLE_PART_ROWS // 2,
                               bloom_filters={"k": 10})) as w:
        for i in range(commits):
            w.write(_table_columns(i, i), TABLE_PART_ROWS)
            w.commit()
    return d


@pytest.mark.cuda
def test_table_ingest_reads_on_card_as_on_cpu(cuda_device, tmp_path):
    """A table's read, lookup and aggregate on the card equal the CPU's,
    through both unpack kernels and the bloom probe (one row group's
    36,000 keys take the device probe), no chunk on the host route."""
    d = _table(tmp_path)
    assert pqt.read_manifest(d).version == 4
    with pqt.open_table(d) as ds:
        pqt.reset_launches()
        pqt.reset_host_route()
        got = ds.read(device=cuda_device)
        assert pqt.LAUNCHES["unpack_bits_dense"] > 0
        assert pqt.LAUNCHES["dict_unpack_gather"] > 0
        _same_columns({n: c.to("cpu") for n, c in got.items()},
                      ds.read(device="cpu"))
        first = 2 * TABLE_PART_ROWS * TABLE_STEP  # part 2's first key
        keys = np.arange(first, first + 36_000)
        pqt.reset_launches()
        pqt.clear_caches()
        hits = ds.find_rows("k", keys, columns=["v"], device=cuda_device)
        assert pqt.LAUNCHES["bloom_check"] > 0
        pqt.clear_caches()
        want = ds.find_rows("k", keys, columns=["v"], device="cpu")
        assert [h.rows.tolist() for h in hits] == \
            [h.rows.tolist() for h in want]
        assert hits.rows_total == 12_000 and hits.counters == want.counters
        w = pqt.col("k").between(150_000, 260_000)
        aggs = [pqt.count(), pqt.sum_("q"), pqt.max_("k")]
        _same_agg(ds.aggregate(aggs, where=w, device=cuda_device),
                  ds.aggregate(aggs, where=w, device="cpu"))
        assert sum(pqt.HOST_ROUTE.values()) == 0


@pytest.mark.cuda
def test_table_pruned_scan_on_card_opens_one_part(cuda_device, tmp_path):
    """The manifest drops the parts a scan cannot match before they are
    opened; the survivors scan on the card as on the CPU."""
    d = _table(tmp_path)
    ds = pqt.open_table(d, pin=False)
    lo = 2 * TABLE_PART_ROWS * TABLE_STEP + 3_000
    w = pqt.col("k").between(lo, lo + 6_000)
    got = ds.scan(where=w, columns=["k", "v", "s"], device=cuda_device)
    assert sorted(ds._files) == [0, 2]  # part 0 types the predicate
    want = ds.scan(where=w, columns=["k", "v", "s"], device="cpu")
    ds.close()
    assert np.array_equal(np.asarray(got["k"]), np.asarray(want["k"]))
    assert np.array_equal(np.asarray(got["k"]),
                          np.arange(lo, lo + 6_001, TABLE_STEP))
    assert list(got["s"]) == list(want["s"])


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [True, False])
def test_table_compaction_on_card_as_on_cpu(cuda_device, tmp_path, sort):
    """``compact_table(device="cuda")`` writes the same part as on the CPU,
    a pinned reader keeps its snapshot, and the card's allocated bytes
    come back."""
    import os

    parts = {}
    for dev in ("cpu", cuda_device):
        root = tmp_path / str(dev).replace(":", "_")
        root.mkdir()
        d = _table(root, sort=sort)
        before = _settled_allocated(cuda_device)
        with pqt.open_table(d) as ds:
            old = {n: c.to("cpu") for n, c in ds.read(device=dev).items()}
            m = pqt.compact_table(d, device=dev)
            assert m.version == 5 and len(m.files) == 1
            _same_columns({n: c.to("cpu")
                           for n, c in ds.read(device=dev).items()}, old)
        with open(os.path.join(d, m.files[0].name), "rb") as f:
            parts[str(dev)] = f.read()
        del old
        assert _settled_allocated(cuda_device) <= before
        assert pqt.recover_table(d) == []
    assert parts["cpu"] == parts[str(cuda_device)]


@pytest.mark.cuda
def test_card_read_counters(cuda_device, tmp_path):
    """A card read counts every chunk decoded on the device, none on the
    host route, the staged bytes it copied, and agrees with ``PIPELINE``
    on the names both keep."""
    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    pf = pqt.ParquetFile(path)
    pqt.reset_pipeline()
    pqt.counters.reset()
    pf.read(device=cuda_device)
    snap = pqt.counters.snapshot()
    assert snap["chunks_device_decoded"] == len(pf.row_groups) * 3
    assert snap.get("chunks_host_fallback", 0) == 0
    assert snap["bytes_h2d"] > 0
    for name in ("chunks_device_decoded", "chunks_host_fallback",
                 "stage_concurrency_peak"):
        assert snap.get(name, 0) == pqt.PIPELINE[name]


@pytest.mark.cuda
def test_traced_card_read(cuda_device, tmp_path):
    """A card read under ``profiler_trace`` writes a Chrome trace with the
    read's regions and each unpack kernel as often as ``LAUNCHES``
    counted, and its columns equal an untraced read's."""
    import json
    import os

    from parquet_tpu_torch.utils.debug import profiler_trace

    path = str(tmp_path / "f.parquet")
    _five_columns(path)
    want = {n: c.to("cpu") for n, c in
            pqt.ParquetFile(path).read(device=cuda_device).items()}
    out = str(tmp_path / "trace")
    pqt.reset_launches()
    with profiler_trace(out):
        got = pqt.ParquetFile(path).read(device=cuda_device)
        torch.cuda.synchronize()
    _same_columns({n: c.to("cpu") for n, c in got.items()}, want)
    (name,) = os.listdir(out)
    with open(os.path.join(out, name)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert "pq.prepare_chunk" in names
    assert any(n.startswith("pq.decode_staged:") for n in names)
    for kernel in ("unpack_bits_dense", "dict_unpack_gather"):
        assert pqt.LAUNCHES[kernel] > 0
        assert sum(1 for e in events if e.get("cat") == "kernel"
                   and f"{kernel}_kernel" in e.get("name", "")) \
            == pqt.LAUNCHES[kernel]


@pytest.mark.cuda
def test_row_group_pruning_probe_on_card(cuda_device, tmp_path):
    """``prune_row_group_values`` with 40,000 hashes over every row
    group's key range probes each row group's filter on the card (one
    ``bloom_check`` launch a row group) and answers as on the CPU."""
    from parquet_tpu_torch.io.bloom import probe_hashes
    from parquet_tpu_torch.io.search import prune_row_group_values

    path = str(tmp_path / "b.parquet")
    pqt.write_table({"k": np.arange(80_000, dtype=np.int64) * 2}, path,
                    pqt.WriterOptions(row_group_size=20_000,
                                      bloom_filters={"k": 10}))
    pf = pqt.ParquetFile(path)
    for vals in (list(range(1, 160_000, 4)), list(range(0, 160_000, 4))):
        hashes = probe_hashes(pf.schema.leaf("k"), vals)
        pqt.reset_launches()
        got = [prune_row_group_values(rg, "k", vals, hashes=hashes,
                                      device=cuda_device)
               for rg in pf.row_groups]
        assert pqt.LAUNCHES["bloom_check"] == len(pf.row_groups)
        want = [prune_row_group_values(rg, "k", vals, hashes=hashes,
                                       device="cpu")
                for rg in pf.row_groups]
        assert got == want


@pytest.mark.cuda
def test_to_arrow_of_a_card_read(cuda_device, tmp_path):
    """Where pyarrow is installed, a card read's ``to_arrow`` (its nested
    fields' level streams decoded again on the card) equals the CPU
    read's, whole and batch by batch."""
    pa = pytest.importorskip("pyarrow")
    papq = pytest.importorskip("pyarrow.parquet")
    elem = pa.struct([("a", pa.int32()), ("b", pa.string())])
    n = 20_000
    t = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array([f"s{i % 13}" for i in range(n)]),
        "st": pa.array([None if i % 7 == 1 else {"a": i, "b": None}
                        for i in range(n)], elem),
        "ls": pa.array([None if i % 9 == 0 else
                        [None if (i + j) % 5 == 0 else {"a": j, "b": "x"}
                         for j in range(i % 4)] for i in range(n)],
                       pa.list_(elem)),
        "mp": pa.array([[(f"k{j}", i * j) for j in range(i % 3)]
                        for i in range(n)], pa.map_(pa.string(),
                                                    pa.int64()))})
    path = str(tmp_path / "nested.parquet")
    papq.write_table(t, path, row_group_size=5_000, data_page_size=4096)
    pf = pqt.ParquetFile(path)
    got = pf.read(device=cuda_device).to_arrow()
    assert got.equals(pf.read(device="cpu").to_arrow())
    for c in t.column_names:
        assert got[c].to_pylist() == t[c].to_pylist()
    for b, cb in zip(pf.iter_batches(batch_rows=3_000, device=cuda_device),
                     pf.iter_batches(batch_rows=3_000, device="cpu")):
        assert b.to_arrow().equals(cb.to_arrow())


def _remote_pools_drained(server) -> None:
    from parquet_tpu_torch.io import remote

    remote.drain_connection_pools()
    server.close()


@pytest.mark.cuda
def test_url_read_on_card_equals_the_local_read(cuda_device, tmp_path):
    """A file read on the card from a loopback ``LocalRangeServer`` equals
    the same file read from its path bit for bit, and launches both unpack
    kernels as often as the local read."""
    rng = np.random.default_rng(11)
    n = 60_000
    table = {
        "id": np.arange(n, dtype=np.int64),
        "small": np.ma.masked_array(rng.integers(0, 200, n).astype(np.int32),
                                    mask=rng.random(n) < 0.1),
        "large": rng.integers(0, 3000, n).astype(np.int64),
        "ts": np.cumsum(rng.integers(0, 1000, n))}
    path = str(tmp_path / "t.parquet")
    pqt.write_table(table, path, pqt.WriterOptions(
        row_group_size=20_000, compression="snappy", column_encoding={
            "id": Encoding.PLAIN, "small": Encoding.RLE_DICTIONARY,
            "large": Encoding.RLE_DICTIONARY,
            "ts": Encoding.DELTA_BINARY_PACKED}))
    with open(path, "rb") as f:
        server = pqt.LocalRangeServer({"t.parquet": f.read()})
    try:
        pqt.reset_launches()
        want = pqt.ParquetFile(path).read(device=cuda_device)
        local = dict(pqt.LAUNCHES)
        pqt.reset_launches()
        got = pqt.ParquetFile(server.url("t.parquet")).read(
            device=cuda_device)
        torch.cuda.synchronize()
        assert dict(pqt.LAUNCHES) == local
        assert local["unpack_bits_dense"] > 0
        assert local["dict_unpack_gather"] > 0
        for name in table:
            assert got[name].values.device.type == "cuda"
            assert torch.equal(_bits(got[name].values),
                               _bits(want[name].values))
            assert (got[name].validity is None) == \
                (want[name].validity is None)
            if want[name].validity is not None:
                assert torch.equal(got[name].validity, want[name].validity)
    finally:
        _remote_pools_drained(server)


@pytest.mark.cuda
def test_url_lookup_on_card_launches_bloom_check(cuda_device):
    """``find_rows`` over a URL probes its bloom filters with the kernel
    on the card and equals the same lookup of the bytes on the CPU."""
    n = 80_000
    table = {"k": np.arange(n, dtype=np.int64) // 2 * 2,
             "v": np.arange(n, dtype=np.float64) / 8}
    buf = io.BytesIO()
    pqt.write_table(table, buf, pqt.WriterOptions(
        row_group_size=40_000, data_page_size=8192,
        bloom_filters={"k": 10}, sorting_columns=[("k", False, False)]))
    keys = np.random.default_rng(5).permutation(np.arange(n,
                                                          dtype=np.int64))
    server = pqt.LocalRangeServer({"k.parquet": buf.getvalue()})
    try:
        pqt.clear_caches()
        want = pqt.ParquetFile(buf.getvalue()).find_rows(
            "k", keys, columns=["v"], device="cpu")
        pqt.clear_caches()
        pqt.reset_launches()
        got = pqt.ParquetFile(server.url("k.parquet")).find_rows(
            "k", keys, columns=["v"], device=cuda_device)
        assert pqt.LAUNCHES["bloom_check"] == 1
        assert got.counters == want.counters
        for g, w in zip(got, want):
            assert np.array_equal(g.rows, w.rows)
            assert np.array_equal(g.values["v"], w.values["v"])
    finally:
        _remote_pools_drained(server)


def _obs_file(path):
    """A 4-row-group file of the 5-column kinds (a dictionary the unpack
    kernels decode), at ``path``."""
    rng = np.random.default_rng(11)
    n = 80_000
    table = {"id": np.arange(n, dtype=np.int64),
             "k": rng.integers(0, 3000, n).astype(np.int64),
             "cat": rng.integers(0, 200, n).astype(np.int32),
             "ts": np.cumsum(rng.integers(0, 1000, n))}
    pqt.write_table(table, str(path), pqt.WriterOptions(
        row_group_size=20_000, column_encoding={
            "id": Encoding.PLAIN, "k": Encoding.RLE_DICTIONARY,
            "cat": Encoding.RLE_DICTIONARY,
            "ts": Encoding.DELTA_BINARY_PACKED}))
    return str(path)


def _syncs(fn) -> list:
    """The synchronizing CUDA calls ``fn()`` makes: for each, the file of
    the package's innermost frame that made it."""
    import os
    import traceback
    import warnings

    pkg = os.path.dirname(os.path.abspath(pqt.__file__))
    sites = []

    def show(message, *a, **k):
        if "synchroniz" not in str(message):
            return
        files = [f.filename for f in traceback.extract_stack()
                 if f.filename.startswith(pkg)]
        sites.append(os.path.relpath(files[-1], pkg) if files else "?")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


@pytest.mark.cuda
def test_a_traced_read_on_card_adds_no_sync(cuda_device, tmp_path):
    """Tracing a card read records its spans and adds no synchronization:
    no sync comes from ``obs/``, the traced read makes no more syncs than
    the untraced one before it (a first read's pinned allocations may
    sync; later reads reuse them), and it launches the kernels as
    often."""
    from parquet_tpu_torch import obs

    path = _obs_file(tmp_path / "o.parquet")

    def read():
        with pqt.ParquetFile(path) as f:
            return f.read(device=cuda_device)

    for _ in range(3):  # warm: the staging buffers and the caches
        read()

    pqt.reset_launches()
    untraced = _syncs(read)
    launches = dict(pqt.LAUNCHES)
    obs.reset_trace()
    obs.enable_tracing()
    try:
        pqt.reset_launches()
        traced = _syncs(read)
    finally:
        obs.disable_tracing()
    names = {e["name"] for e in obs.trace_events()}
    obs.reset_trace()
    assert len(traced) <= len(untraced), (traced, untraced)
    assert not [s for s in traced + untraced if s.startswith("obs")]
    assert dict(pqt.LAUNCHES) == launches, (dict(pqt.LAUNCHES), launches)
    assert launches["unpack_bits_dense"] > 0
    assert {"device.h2d", "op.file.read"} <= names


@pytest.mark.cuda
def test_a_card_reads_bytes_are_its_ops(cuda_device, tmp_path):
    """A card read inside an op: the op's ``read.bytes_read`` equals the
    global delta (the prepare workers run in the op's context), and its
    pool tasks are the op's."""
    from parquet_tpu_torch import obs

    path = _obs_file(tmp_path / "a.parquet")
    before = obs.metrics_snapshot()
    with obs.op_scope("t.card") as op:
        with pqt.ParquetFile(path) as f:
            f.read(device=cuda_device)
    torch.cuda.synchronize()
    delta = obs.metrics_delta(before, obs.metrics_snapshot())["counters"]
    mine = op.counters()
    assert delta["read.bytes_read"] > 0
    assert mine["read.bytes_read"] == delta["read.bytes_read"]
    assert mine["pool.tasks"] == delta["pool.tasks"] > 0


def _post(srv, path: str, doc: dict, tenant: str = "default") -> bytes:
    import json
    import urllib.request

    req = urllib.request.Request(srv.url + path, data=json.dumps(doc)
                                 .encode(), headers={"X-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return r.read()


@pytest.mark.cuda
def test_served_lookup_on_card_equals_find_rows(cuda_device, tmp_path):
    """``POST /v1/lookup`` of a daemon on its default device (the card)
    answers what ``Dataset.find_rows(device="cuda")`` does, its bloom
    probe launched on the card and its pages pinned for the tenant."""
    import json

    from parquet_tpu_torch.io import cache
    from parquet_tpu_torch.serve.codecs import lookup_to_jsonable

    n = 80_000
    rng = np.random.default_rng(3)
    path = str(tmp_path / "look.parquet")
    pqt.write_table(
        {"k": np.arange(n, dtype=np.int64) // 2 * 2,
         "v": rng.random(n),
         "cat": rng.integers(0, 200, n).astype(np.int32)},
        path, pqt.WriterOptions(
            row_group_size=n, data_page_size=8192, bloom_filters={"k": 10},
            sorting_columns=[("k", False, False)],
            column_encoding={"cat": Encoding.RLE_DICTIONARY}))
    keys = [int(k) for k in rng.permutation(n)[:40_000]]
    cfg = {"datasets": {"look": {"paths": [path]}},
           "tenants": {"i": {"class": "latency", "pin_bytes": "64MiB"}}}
    with pqt.Server(cfg, port=0) as srv:
        assert srv.device.type == "cuda"
        pqt.clear_caches()
        pqt.reset_launches()
        body = _post(srv, "/v1/lookup", {"dataset": "look", "column": "k",
                                         "keys": keys,
                                         "columns": ["v", "cat"]},
                     tenant="i")
        launches = dict(pqt.LAUNCHES)
        assert cache.PAGES.pinned_bytes("i") > 0
    assert cache.PAGES.pinned_bytes("i") == 0
    pqt.clear_caches()
    with pqt.Dataset([path]) as ds:
        want = ds.find_rows("k", keys, columns=["v", "cat"],
                            device=cuda_device)
    doc = json.loads(body)
    assert doc["hits"] == lookup_to_jsonable(want, keys)
    assert doc["rows_total"] == want.rows_total > 0
    assert launches["bloom_check"] >= 1
    assert launches["dict_unpack_gather"] >= 1


@pytest.mark.cuda
def test_served_arrow_scan_on_card_equals_the_direct_read(cuda_device,
                                                          tmp_path):
    """``POST /v1/scan`` (Arrow, no predicate) on the card equals the
    direct read's ``to_arrow`` and launches the same kernels."""
    pa = pytest.importorskip("pyarrow")
    path = _obs_file(tmp_path / "a.parquet")
    cols = ["k", "cat", "ts"]
    with pqt.Server({"datasets": {"d": {"paths": [path]}}}, port=0) as srv:
        pqt.reset_launches()
        body = _post(srv, "/v1/scan", {"dataset": "d", "format": "arrow",
                                       "columns": cols})
        served = dict(pqt.LAUNCHES)
    pqt.reset_launches()
    with pqt.ParquetFile(path) as f:
        want = f.read(columns=cols, device=cuda_device).to_arrow() \
            .combine_chunks()
    direct = dict(pqt.LAUNCHES)
    got = pa.ipc.open_stream(io.BytesIO(body)).read_all().combine_chunks()
    assert got.equals(want)
    assert served == direct and served["unpack_bits_dense"] > 0


@pytest.mark.cuda
def test_fleet_on_card_answers_as_a_single_node(cuda_device, tmp_path,
                                                monkeypatch):
    """Three fleet members on the card (one process, loopback) answer a
    scan and a lookup byte for byte as a single node over the same
    key-partitioned table; the members' legs launch the unpack kernels
    (the scan's dictionary columns) and the bloom probe (each member's
    share of the keys is one device batch a row group).  No leg is hedged
    or timed out: each is its member's own."""
    import json

    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_HEDGE_S", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S", "600")

    pa = pytest.importorskip("pyarrow")
    from parquet_tpu_torch.serve.cluster import HashRing

    names = ("n1", "n2", "n3")
    ring = HashRing(names)
    per, commits = 150_000, 3
    rng = np.random.default_rng(5)
    tab = pa.table({"k": np.arange(per * commits, dtype=np.int64),
                    "q": rng.integers(0, 3000, per * commits),
                    "cat": rng.integers(0, 200, per * commits)
                    .astype(np.int32)})
    opts = pqt.WriterOptions(row_group_size=per, bloom_filters={"k": 10},
                             column_encoding={
                                 "q": Encoding.RLE_DICTIONARY,
                                 "cat": Encoding.RLE_DICTIONARY})
    for attempt in range(50):  # until every member owns a part
        tbl = str(tmp_path / f"tbl{attempt}")
        w = pqt.DatasetWriter(tbl, pqt.schema_from_arrow(tab.schema),
                              options=opts, rows_per_file=per,
                              partition_on="k", num_partitions=4)
        for c in range(commits):
            w.write_arrow(tab.slice(c * per, per))
            w.commit()
        w.close()
        with pqt.open_table(tbl) as ds:
            paths = list(ds.paths)
        if set(ring.spread(paths)) == set(names):
            break
    keys = list(range(per))  # the first commit's keys
    shares = {}
    for k in keys:
        shares[ring.owner_of_key(k)] = shares.get(ring.owner_of_key(k), 0) + 1
    assert min(shares.values()) >= 32_768  # SplitBlockFilter's device batch
    scan = {"dataset": "t", "format": "arrow", "columns": ["k", "q", "cat"]}
    look = {"dataset": "t", "column": "k", "keys": keys,
            "columns": ["q", "cat"]}

    def cfg(name=None):
        doc = {"datasets": {"t": {"table": tbl}}}
        if name is not None:
            doc["cluster"] = {"self": name,
                              "peers": {n: None for n in names}}
        return doc

    want = {}
    with pqt.Server(cfg(), port=0) as solo:
        assert solo.device.type == "cuda"
        for what, path, doc in (("scan", "/v1/scan", scan),
                                ("lookup", "/v1/lookup", look)):
            pqt.clear_caches()
            want[what] = _post(solo, path, doc)
    servers = {}
    got, launches = {}, {}
    try:
        for nm in names:
            servers[nm] = pqt.Server(cfg(nm), port=0)
        urls = {nm: s.url for nm, s in servers.items()}
        for s in servers.values():
            s.set_peers(urls)
        for what, path, doc in (("scan", "/v1/scan", scan),
                                ("lookup", "/v1/lookup", look)):
            pqt.clear_caches()
            pqt.reset_launches()
            got[what] = _post(servers["n2"], path, doc)
            launches[what] = dict(pqt.LAUNCHES)
    finally:
        for s in reversed(list(servers.values())):
            s.close()
    stream = pa.ipc.open_stream
    assert stream(io.BytesIO(got["scan"])).read_all().equals(
        stream(io.BytesIO(want["scan"])).read_all())
    assert got["lookup"] == want["lookup"]  # no shard skipped either
    assert json.loads(got["lookup"])["rows_total"] == per
    assert launches["scan"]["unpack_bits_dense"] > 0
    assert launches["scan"]["dict_unpack_gather"] > 0
    # one probe a member over its row groups the statistics keep
    assert launches["lookup"]["bloom_check"] >= len(names)


@pytest.mark.cuda
def test_analyze_on_card_is_clean(cuda_device):
    """``python -m parquet_tpu_torch analyze --json --device cuda`` from the
    tree: no lint finding, the README knob table current, and the lock
    checker's hammer clean on the card (reads, scans, lookups, a table, a
    two-tenant daemon and a three-member fleet, every lock checked)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "parquet_tpu_torch", "analyze", "--json",
         "--device", "cuda"], capture_output=True, text=True, cwd=root,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["lint"] == [] and not rep["knobs_md"]["stale"]
    hammer = rep["lockcheck"]
    assert hammer["ok"] and hammer["cycles"] == [] and \
        hammer["findings"] == []
    assert hammer["acquisitions"] > 1000
    assert "device.stage_concurrency" in hammer["locks"] or \
        "prefetch.ring" in hammer["locks"]


@pytest.mark.cuda
def test_cli_head_and_aggregate_on_card_launch_the_kernels(cuda_device,
                                                           tmp_path):
    """``head`` and ``aggregate`` of the CLI decode on the card (the
    default device): an unpack kernel launches, and the answers equal the
    CPU's."""
    import contextlib
    import json

    from parquet_tpu_torch.__main__ import main

    rng = np.random.default_rng(3)
    n = 200_000
    path = str(tmp_path / "t.parquet")
    pqt.write_table({"k": rng.integers(0, 50, n).astype(np.int32),
                     "v": rng.integers(0, 1 << 20, n).astype(np.int64)},
                    path, options=pqt.WriterOptions(
                        row_group_size=n // 2, column_encoding={
                            "k": Encoding.RLE_DICTIONARY}))

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return out.getvalue()

    for argv in (["head", "-n", "20", path],
                 ["aggregate", path, "--agg", "count", "--agg", "sum:v",
                  "--group-by", "k", "--where", "v:1000:"]):
        pqt.clear_caches()
        pqt.reset_launches()
        card = run(argv)
        launched = dict(pqt.LAUNCHES)
        pqt.clear_caches()
        cpu = run(argv + ["--device", "cpu"])
        assert launched["unpack_bits_dense"] + \
            launched["dict_unpack_gather"] > 0, (argv, launched)
        if argv[0] == "head":
            assert card == cpu
        else:
            assert json.loads(card)["aggregates"] == \
                json.loads(cpu)["aggregates"]


def _no_index_file(path: str, n: int = 400_000) -> np.ndarray:
    """A file without a page index: ``k`` 5,000 values dictionary-encoded,
    ``v`` a double, ``c`` a 100-value int32 dictionary with nulls; returns
    ``k``."""
    rng = np.random.default_rng(11)
    k = rng.integers(0, 5_000, n).astype(np.int64) * 4
    pqt.write_table(
        {"k": k, "v": rng.random(n),
         "c": np.ma.masked_array(rng.integers(0, 100, n).astype(np.int32),
                                 mask=rng.random(n) < 0.1)},
        path, options=pqt.WriterOptions(
            row_group_size=n // 4, write_page_index=False,
            bloom_filters={"k": 10}, column_encoding={
                "k": Encoding.RLE_DICTIONARY, "c": Encoding.RLE_DICTIONARY}))
    return k


def _same_hits(got, want, columns) -> None:
    assert got.counters == want.counters
    for g, w in zip(got, want):
        assert np.array_equal(g.rows, w.rows)
        for c in columns:
            assert np.array_equal(g.values[c], w.values[c])
            assert (g.validity[c] is None) == (w.validity[c] is None)
            if w.validity[c] is not None:
                assert np.array_equal(g.validity[c], w.validity[c])


@pytest.mark.cuda
def test_chunk_cache_serves_a_warm_lookup_on_card(cuda_device, tmp_path):
    """On a file without a page index the cold lookup on the card decodes
    every whole chunk it needs there (the unpack kernels launch) and puts
    it in the whole-chunk cache; the warm one is served from it, with no
    launch, and both equal the CPU's lookup."""
    path = str(tmp_path / "bare.parquet")
    k = _no_index_file(path)
    keys = np.concatenate([k[:40], np.arange(1, 400, 2)]).astype(np.int64)
    cols = ["v", "c"]
    pqt.clear_caches(reset_stats=True)
    pqt.reset_launches()
    cold = pqt.ParquetFile(path).find_rows("k", keys, columns=cols,
                                           device=cuda_device)
    launched = dict(pqt.LAUNCHES)
    misses = pqt.cache_stats().chunk_misses
    pqt.reset_launches()
    warm = pqt.ParquetFile(path).find_rows("k", keys, columns=cols,
                                           device=cuda_device)
    st = pqt.cache_stats()
    assert launched["unpack_bits_dense"] > 0
    assert launched["dict_unpack_gather"] > 0
    assert misses == 12 and st.chunk_hits == misses
    assert st.chunk_misses == misses
    assert pqt.LAUNCHES["unpack_bits_dense"] == 0
    assert pqt.LAUNCHES["dict_unpack_gather"] == 0
    pqt.clear_caches()
    cpu = pqt.ParquetFile(path).find_rows("k", keys, columns=cols,
                                          device="cpu")
    _same_hits(cold, cpu, cols)
    assert warm.counters["chunk_fallbacks"] == cpu.counters["chunk_fallbacks"]
    for g, w in zip(warm, cpu):
        assert np.array_equal(g.rows, w.rows)


@pytest.mark.cuda
def test_key_shard_lookup_on_card_is_the_serial_one(cuda_device, tmp_path,
                                                    monkeypatch):
    """A batch of 200,000 keys (about 50,000 a row group after the
    statistics, a device probe) at the reference's shard floor of 1,024 on
    the card:
    ``key_shards`` >= 2, one ``bloom_check`` launch, and the hits and
    counters (but ``preads`` and ``pages_coalesced``) of the serial
    lookup at a floor of 0."""
    n = 1 << 20
    path = str(tmp_path / "sorted.parquet")
    rng = np.random.default_rng(5)
    pqt.write_table({"k": np.arange(n, dtype=np.int64) // 2 * 2,
                     "v": rng.random(n)}, path,
                    options=pqt.WriterOptions(
                        row_group_size=n // 4, data_page_size=8192,
                        bloom_filters={"k": 10}))
    keys = rng.choice(n, 200_000, replace=False).astype(np.int64)
    runs = {}
    for floor in ("0", "1024"):
        monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", floor)
        pqt.clear_caches()
        pqt.reset_launches()
        runs[floor] = (pqt.ParquetFile(path).find_rows(
            "k", keys, columns=["v"], device=cuda_device),
            pqt.LAUNCHES["bloom_check"])
    (serial, b0), (sharded, b1) = runs["0"], runs["1024"]
    assert serial.counters["key_shards"] == 0
    assert sharded.counters["key_shards"] >= 2
    assert b0 == b1 == 1
    for k in serial.counters:
        if k not in ("preads", "pages_coalesced", "key_shards"):
            assert sharded.counters[k] == serial.counters[k], k
    for g, w in zip(sharded, serial):
        assert np.array_equal(g.rows, w.rows)
        assert np.array_equal(g.values["v"], w.values["v"])
