"""The port's read admission gate (``parquet_tpu_torch/utils/pool.py``) on
the CPU: FIFO order shown with ``threading.Event``s (at most 4 threads,
each joined with a timeout; no sleep, no wall-clock assertion), the
oversized request clamped to admit alone, a budget of 0 that never
blocks, nested acquires on a pool worker, the tier budgets against the
JAX package's controller, and the lookup, host scan and dataset read
admitting their spans.  No thread a test starts outlives it (the shared
pool's workers, named ``pqt-work``, live for the process by design).
"""

import threading

import numpy as np
import pytest

import parquet_tpu
from parquet_tpu.utils.pool import AdmissionController as JAdmission

import parquet_tpu_torch as pqt
from parquet_tpu_torch.utils import pool as tpool

CPU = "cpu"
JOIN_S = 30.0  # a liveness bound for joins and waits, never asserted on
BUDGET_KNOBS = ("READ_BUDGET", "LOOKUP_BUDGET", "SCAN_BUDGET")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in BUDGET_KNOBS:
        monkeypatch.delenv(f"PARQUET_TPU_TORCH_{name}", raising=False)
        monkeypatch.delenv(f"PARQUET_TPU_{name}", raising=False)
    parquet_tpu.clear_caches()
    pqt.clear_caches()
    before = set(threading.enumerate())
    tpool.read_admission()._reset()
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()
            and not t.name.startswith("pqt-work")]
    assert not left, left
    pqt.clear_caches()


def _wait_depth(gate, depth: int) -> None:
    """Until ``depth`` tickets wait at ``gate`` (polled on an Event)."""
    tick = threading.Event()
    for _ in range(int(JOIN_S * 1000)):
        if gate.queue_depth() >= depth:
            return
        tick.wait(0.001)
    raise AssertionError(f"the gate never held {depth} waiting tickets")


def _start(fn, *args) -> threading.Thread:
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def _join(*threads) -> None:
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()


def test_tickets_are_granted_in_arrival_order(monkeypatch):
    """The main thread holds 80 of 100 bytes.  A asks for 50 (does not
    fit) and waits; B, arriving after, asks for 10, which would fit, and
    still waits behind A.  After the release A is granted before B."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "100")
    gate = tpool.AdmissionController()
    order, lock = [], threading.Lock()
    done = {name: threading.Event() for name in "AB"}

    def take(name, n):
        g = gate.acquire(n)
        with lock:
            order.append((name, g, gate.in_flight_bytes()))
        done[name].set()

    held = gate.acquire(80)
    a = _start(take, "A", 50)
    _wait_depth(gate, 1)
    b = _start(take, "B", 10)
    _wait_depth(gate, 2)
    assert not done["A"].is_set() and not done["B"].is_set()
    gate.release(held)
    _join(a, b)
    assert [name for name, _, _ in order] == ["A", "B"]
    assert order[0][1] == 50 and order[1][1] == 10
    assert gate.high_water == 80 and gate.waits == 2
    gate.release(50)
    gate.release(10)
    assert gate.in_flight_bytes() == 0


def test_oversized_request_is_clamped_and_admits_alone(monkeypatch):
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "100")
    gate = tpool.AdmissionController()
    big = gate.acquire(10_000)
    assert big == 100 and gate.in_flight_bytes() == 100
    got = threading.Event()

    def small():
        gate.release(gate.acquire(1))
        got.set()

    t = _start(small)
    _wait_depth(gate, 1)
    assert not got.is_set()  # the clamped request holds the whole budget
    gate.release(big)
    _join(t)
    assert got.is_set() and gate.high_water == 100


@pytest.mark.parametrize("knob", ["PARQUET_TPU_TORCH_READ_BUDGET",
                                  "PARQUET_TPU_TORCH_LOOKUP_BUDGET"])
def test_a_budget_of_zero_never_blocks(monkeypatch, knob):
    monkeypatch.setenv(knob, "0")
    gate = tpool.AdmissionController()
    grants = [gate.acquire(1 << 40) for _ in range(5)]
    assert grants == [0] * 5
    assert gate.in_flight_bytes() == 0 and gate.waits == 0
    with gate.admit(1 << 40) as g:
        assert g == 0


def test_nested_acquire_on_a_pool_worker_gets_grant_zero(monkeypatch):
    """Inside ``admit`` a nested acquire is granted 0, on the caller's
    thread and on a shared-pool worker the caller submits to (the grant
    follows the work in its context)."""
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "100")
    gate = tpool.read_admission()
    with gate.admit(100) as outer:
        assert outer == 100
        assert gate.acquire(100) == 0
        assert tpool.submit(gate.acquire, 100).result(JOIN_S) == 0
        assert tpool.map_in_order(lambda n: gate.acquire(n),
                                  [10, 20]) == [0, 0]
    assert gate.in_flight_bytes() == 0
    # outside any grant, a pool worker's acquire is a real one
    assert tpool.submit(gate.acquire, 30).result(JOIN_S) == 30
    gate.release(30)


@pytest.mark.parametrize("env", [
    {}, {"READ_BUDGET": "1000"}, {"READ_BUDGET": "0"},
    {"LOOKUP_BUDGET": "77"}, {"SCAN_BUDGET": "5000"},
    {"READ_BUDGET": "1000", "SCAN_BUDGET": "300"},
    {"READ_BUDGET": "0", "LOOKUP_BUDGET": "77"},
    {"LOOKUP_BUDGET": "0", "READ_BUDGET": "900"}])
def test_tier_budgets_match_jax(monkeypatch, env):
    """The scan tier is off by default and the lookup tier 64 MiB; every
    combination of the three knobs resolves as in the JAX package."""
    for name, v in env.items():
        monkeypatch.setenv(f"PARQUET_TPU_TORCH_{name}", v)
        monkeypatch.setenv(f"PARQUET_TPU_{name}", v)
    got, want = tpool.AdmissionController(), JAdmission()
    for tier in ("lookup", "scan"):
        assert got.budget_bytes(tier) == want.budget_bytes(tier), tier
    assert got.global_budget_bytes() == want.global_budget_bytes()
    if not env:
        assert got.budget_bytes("scan") == 0
        assert got.budget_bytes("lookup") == 64 << 20
        assert got.acquire(1 << 30, tier="scan") == 0


def _lookup_file(tmp_path) -> str:
    path = str(tmp_path / "k.parquet")
    n = 20_000
    pqt.write_table({"k": np.arange(n, dtype=np.int64),
                     "v": np.arange(n, dtype=np.float64)}, path,
                    pqt.WriterOptions(row_group_size=5000,
                                      data_page_size=2048))
    return path


def test_lookup_admits_its_page_runs(tmp_path, monkeypatch):
    """Each coalesced run is admitted under the lookup tier: the high
    water stays within the budget, and a budget smaller than one run
    (clamped) leaves the hits as they were."""
    path = _lookup_file(tmp_path)
    keys = np.arange(0, 20_000, 37, dtype=np.int64)
    gate = tpool.read_admission()
    want = pqt.ParquetFile(path).find_rows("k", keys, columns=["v"],
                                           device=CPU)
    assert 0 < gate.high_water <= 64 << 20
    pqt.clear_caches()
    gate._reset()
    monkeypatch.setenv("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "1000")
    got = pqt.ParquetFile(path).find_rows("k", keys, columns=["v"],
                                          device=CPU)
    assert gate.high_water == 1000 and gate.in_flight_bytes() == 0
    assert got.counters == want.counters
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rows, w.rows)
        np.testing.assert_array_equal(g.values["v"], w.values["v"])


def test_host_scan_and_dataset_read_admit_under_the_scan_tier(tmp_path,
                                                             monkeypatch):
    """With a scan budget set, the host scan's spans and each file stage of
    a dataset read are admitted (the high water within the budget); the
    results equal the unbudgeted ones."""
    path = _lookup_file(tmp_path)
    gate = tpool.read_admission()
    want = pqt.scan_filtered(pqt.ParquetFile(path), "k", lo=100, hi=15_000,
                             columns=["v"], device=CPU)
    assert gate.high_water == 0  # the scan tier is off by default
    monkeypatch.setenv("PARQUET_TPU_TORCH_SCAN_BUDGET", str(1 << 20))
    got = pqt.scan_filtered(pqt.ParquetFile(path), "k", lo=100, hi=15_000,
                            columns=["v"], device=CPU)
    np.testing.assert_array_equal(got["v"], want["v"])
    assert 0 < gate.high_water <= 1 << 20
    gate._reset()
    monkeypatch.setenv("PARQUET_TPU_TORCH_SCAN_BUDGET", "4096")
    table = pqt.Dataset([path, path]).read(device=CPU)
    assert gate.high_water == 4096 and gate.in_flight_bytes() == 0
    np.testing.assert_array_equal(table["k"].values.numpy()[:20_000],
                                  np.arange(20_000))


def test_a_dataset_window_whose_later_file_takes_the_budget_first(
        tmp_path, monkeypatch):
    """A window of [cpu] * 4 over three files, a scan budget smaller than
    one file (each grant clamped to all of it): file 1 takes the grant
    before file 0 asks for it.  File 0 waits for file 1's decode to end,
    not for the consumer to take file 1, so the read ends, equal to the
    files' rows, with the budget handed back."""
    import shutil

    from parquet_tpu_torch.parallel import mesh as tmesh

    first = _lookup_file(tmp_path)
    paths = [first]
    for j in (1, 2):
        paths.append(str(tmp_path / f"k{j}.parquet"))
        shutil.copy(first, paths[-1])
    monkeypatch.setenv("PARQUET_TPU_TORCH_SCAN_BUDGET", "4096")
    gate = tpool.read_admission()
    real = tmesh._stage_dataset_file
    granted = threading.Event()

    def stage(dataset, i, *args):
        if i == 0:
            granted.wait(JOIN_S)
        st = real(dataset, i, *args)
        if i == 1:
            granted.set()  # file 1 holds the whole budget
        return st

    monkeypatch.setattr(tmesh, "_stage_dataset_file", stage)
    got = {}
    reader = _start(lambda: got.setdefault(
        "table", pqt.Dataset(paths).read(device=[CPU] * 4)))
    _join(reader)
    assert granted.is_set()
    np.testing.assert_array_equal(got["table"]["k"].values.numpy(),
                                  np.tile(np.arange(20_000), 3))
    assert gate.high_water == 4096 and gate.in_flight_bytes() == 0
