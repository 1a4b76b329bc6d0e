"""One process of a two-process sharded decode step, for
``tests/test_torch_mesh.py``.

    python decode_step_worker.py RANK WORLD PORT INPUTS.npz N

Joins a gloo process group at ``tcp://localhost:PORT``, takes its half of
the stacked shards in ``INPUTS.npz`` (rank r: shards ``r*k .. r*k+k-1``),
runs ``decode_step_sharded`` over ``["cpu"] * k`` and prints one JSON
line: the row count summed over the group and its own shards' count.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import parquet_tpu_torch as pqt  # noqa: E402


def main(argv) -> int:
    rank, world, port, path, n = (int(argv[0]), int(argv[1]), int(argv[2]),
                                  argv[3], int(argv[4]))
    with np.load(path) as f:
        cols = [f[f"arr_{i}"] for i in range(7)]
    k = cols[0].shape[0] // world
    mine = [torch.from_numpy(c[rank * k:(rank + 1) * k]) for c in cols]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _, validity, rows = pqt.decode_step_sharded(
            [torch.device("cpu")] * k, n)(*mine)
        local = int(sum(int(v.sum()) for v in validity))
        print(json.dumps({"rows": int(rows), "local_rows": local}))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
