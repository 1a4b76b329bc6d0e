"""Write the host-route fixture that ``chip_smoke.py`` reads on the card
(which has no pyarrow) and ``tests/test_torch_host_route.py`` checks here.

    python3 tests/torch_fixtures/make_host_route.py

``host_route.parquet``: 4,000 rows in two row groups, written by pyarrow
with a 4 KiB dictionary page limit, so every chunk's dictionary overflows
into PLAIN pages mid-chunk (the device route refuses such a chunk as
``mixed_page_kinds``): ``k`` int64, ``s`` byte strings and ``l`` a
``list<int64>`` with null lists and null elements.  ``host_route.npz``
holds the arrays that made it and the count of chunks that must take the
host decode.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = 4000
ROW_GROUP = 2000


def make(seed: int = 0) -> dict:
    """The fixture's arrays, from ``seed``."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 40, ROWS)
    lens = rng.integers(8, 24, ROWS)
    s_offsets = np.zeros(ROWS + 1, np.int64)
    np.cumsum(lens, out=s_offsets[1:])
    s_values = rng.integers(97, 123, int(s_offsets[-1])).astype(np.uint8)
    list_validity = rng.random(ROWS) > 0.08
    l_lens = np.where(list_validity, rng.integers(0, 5, ROWS), 0)
    l_offsets = np.zeros(ROWS + 1, np.int64)
    np.cumsum(l_lens, out=l_offsets[1:])
    l_validity = rng.random(int(l_offsets[-1])) > 0.1
    l_values = rng.integers(0, 1 << 30, int(l_validity.sum()))
    return {"k": k, "s_values": s_values, "s_offsets": s_offsets,
            "l_values": l_values, "l_validity": l_validity,
            "l_offsets": l_offsets, "l_list_validity": list_validity}


def write(path: str, a: dict) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    o = a["s_offsets"]
    s = [a["s_values"][o[i]:o[i + 1]].tobytes() for i in range(ROWS)]
    full = np.zeros(len(a["l_validity"]), np.int64)
    full[a["l_validity"]] = a["l_values"]
    items = pa.array(full, mask=~a["l_validity"])
    lst = pa.ListArray.from_arrays(pa.array(a["l_offsets"].astype(np.int32)),
                                   items,
                                   mask=pa.array(~a["l_list_validity"]))
    pq.write_table(pa.table({"k": a["k"], "s": pa.array(s, pa.binary()),
                             "l": lst}), path, row_group_size=ROW_GROUP,
                   dictionary_pagesize_limit=4096, data_page_size=4096,
                   compression="snappy")


def main() -> None:
    a = make()
    path = os.path.join(HERE, "host_route.parquet")
    write(path, a)
    np.savez_compressed(os.path.join(HERE, "host_route.npz"),
                        host_route_chunks=3 * (ROWS // ROW_GROUP), **a)


if __name__ == "__main__":
    main()
