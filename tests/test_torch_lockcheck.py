"""The port's lock checker (``parquet_tpu_torch/utils/locks.py``) and its
report and hammer (``analysis/lockcheck.py``), held against the
reference's (``parquet_tpu/utils/locks.py``, ``parquet_tpu/analysis/
lockcheck.py``): each script (ABBA and three-lock cycles, same-name
edges, the self-deadlock, the try-lock, the RLock re-entry, blocking
under a tier lock and under a ``tier=False`` lock, the condition wait)
runs through both checkers, each turned on with ``enable_lockcheck()``,
and the two reports must be equal: cycles, edges with their counts and
stacks, findings, acquisitions.  ``find_cycles`` takes the same edge
lists in both; the locks of both packages carry the same names and
tiers.  Then the port alone: the factories' plain stdlib primitives when
the checker is off (counted, never timed), one compile for four build
threads, and the hammer on the CPU in a subprocess, clean."""

import importlib
import json
import os
import re
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

from parquet_tpu.analysis import lockcheck as ref_lockcheck
from parquet_tpu.utils import locks as RL
from parquet_tpu_torch.analysis.lockcheck import (find_cycles, format_stack,
                                                  lockcheck_report)
from parquet_tpu_torch.utils import locks as L

from torch_fixtures.threads import no_thread_started

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
THIS = os.path.basename(__file__)

SIDES = (
    types.SimpleNamespace(pkg="parquet_tpu", locks=RL,
                          report=ref_lockcheck.lockcheck_report),
    types.SimpleNamespace(pkg="parquet_tpu_torch", locks=L,
                          report=lockcheck_report),
)


def _stack(lines: list, where: str = THIS) -> list:
    """The frames of this file (or of the child's ``<string>``): the
    scripts below run the same code through both checkers, so these lines
    match; frames inside each package's own modules differ by path and
    are dropped."""
    return [ln for ln in lines if f"{where}:" in ln]


def _edge(e: dict, where: str = THIS) -> dict:
    return {k: (_stack(v, where) if k.endswith("_stack") else v)
            for k, v in e.items() if k != "thread"}


def _norm(rep: dict, where: str = THIS) -> dict:
    """A report with what differs by run taken out (thread names, frames
    outside ``where``); every other key is kept as it is."""
    findings = []
    for f in rep["findings"]:
        g = {}
        for k, v in f.items():
            if k == "thread":
                continue
            if k in ("stack", "first_stack"):
                v = _stack(v, where)
            elif k == "edges":
                v = [_edge(e, where) for e in v]
            g[k] = v
        findings.append(g)
    return dict(rep, edges=[_edge(e, where) for e in rep["edges"]],
                findings=findings)


def _observed(v):
    if isinstance(v, dict) and "findings" in v:
        return _norm(v)
    if isinstance(v, (list, tuple)):
        return [_observed(x) for x in v]
    return v


@pytest.fixture
def both():
    """``run(script)``: ``script(side)`` runs once with the reference's
    checker on and once with the port's (``side.locks``, ``side.report``,
    ``side.pkg``), each with its state cleared before and after; what it
    returns and the final reports must be equal.  Gives the port's
    ``(report, returned)``."""
    def run(script):
        got = []
        for side in SIDES:
            side.locks.enable_lockcheck()
            side.locks.reset_lockcheck()
            try:
                value = script(side)
                got.append((side.report(), value))
            finally:
                side.locks.disable_lockcheck()
                side.locks.reset_lockcheck()
        (ref_rep, ref_val), (port_rep, port_val) = got
        assert _norm(port_rep) == _norm(ref_rep)
        assert _observed(port_val) == _observed(ref_val)
        return port_rep, port_val

    return run


def _abba(side):
    a = side.locks.make_lock("fix.A")
    b = side.locks.make_lock("fix.B")

    with a:
        with b:
            pass

    def reversed_order():
        with b:
            with a:
                pass

    t = threading.Thread(target=reversed_order)
    t.start()
    t.join()


# ---------------------------------------------------------------------------
# cycles (potential deadlocks)
# ---------------------------------------------------------------------------
def test_abba_cycle_detected_with_both_stacks(both):
    rep, _ = both(_abba)
    assert not rep["ok"]
    assert ["fix.A", "fix.B"] in rep["cycles"]
    cyc = [f for f in rep["findings"] if f["kind"] == "lock_order_cycle"]
    assert len(cyc) == 1
    edges = cyc[0]["edges"]
    assert len(edges) == 2  # A->B and B->A, each with both stacks
    for e in edges:
        assert _stack(e["from_stack"]) and _stack(e["to_stack"]), e


def test_consistent_order_is_clean(both):
    def script(side):
        a = side.locks.make_lock("ord.A")
        b = side.locks.make_lock("ord.B")
        for _ in range(3):
            with a:
                with b:
                    pass

    rep, _ = both(script)
    assert rep["ok"] and rep["cycles"] == []
    assert [(e["from"], e["to"], e["count"]) for e in rep["edges"]] == \
        [("ord.A", "ord.B", 3)]
    assert rep["acquisitions"] == 6


def test_three_lock_cycle_detected(both):
    def script(side):
        a, b, c = (side.locks.make_lock(f"tri.{n}") for n in "ABC")
        for first, second in ((a, b), (b, c), (c, a)):
            with first:
                with second:
                    pass

    rep, _ = both(script)
    assert not rep["ok"]
    assert rep["cycles"] == [["tri.A", "tri.B", "tri.C"]]
    cyc = [f for f in rep["findings"] if f["kind"] == "lock_order_cycle"]
    assert len(cyc) == 1 and len(cyc[0]["edges"]) == 3


@pytest.mark.parametrize("edges", [
    [("x", "y"), ("y", "z"), ("z", "x"), ("x", "w")],
    [("x", "y"), ("y", "z")],
    [("a", "b"), ("b", "a"), ("b", "c"), ("c", "a")],
    [("a", "b"), ("b", "a"), ("a", "b")],
    [("c", "d"), ("d", "c"), ("a", "b"), ("b", "a")],
    [("d", "a"), ("a", "b"), ("b", "c"), ("c", "d"), ("b", "d")],
    [("a", "a"), ("a", "b")],
    [],
])
def test_find_cycles_unit(edges):
    """The same edge lists give the same cycles, in the same order and
    rotation, in both packages."""
    recs = [{"from": a, "to": b} for a, b in edges]
    assert find_cycles(recs) == ref_lockcheck.find_cycles(recs)


def test_find_cycles_on_random_graphs():
    rng = np.random.default_rng(7)
    names = [f"n{i}" for i in range(7)]
    for _ in range(200):
        n = int(rng.integers(0, 14))
        recs = [{"from": names[int(a)], "to": names[int(b)]}
                for a, b in rng.integers(0, len(names), size=(n, 2))]
        assert find_cycles(recs) == ref_lockcheck.find_cycles(recs), recs


def test_same_name_edges_skipped(both):
    def script(side):
        a1 = side.locks.make_lock("inst.same")
        a2 = side.locks.make_lock("inst.same")
        with a1:
            with a2:
                pass

    rep, _ = both(script)
    assert rep["ok"] and rep["edges"] == [] and rep["acquisitions"] == 2


# ---------------------------------------------------------------------------
# self-deadlock and reentry
# ---------------------------------------------------------------------------
def test_self_deadlock_raises_instead_of_hanging(both):
    def script(side):
        lk = side.locks.make_lock("self.dead")
        lk.acquire()
        try:
            with pytest.raises(RuntimeError, match="self-deadlock"):
                lk.acquire()
        finally:
            lk.release()

    rep, _ = both(script)
    dead = [f for f in rep["findings"] if f["kind"] == "self_deadlock"]
    assert len(dead) == 1 and dead[0]["lock"] == "self.dead"
    assert _stack(dead[0]["first_stack"])


def test_try_lock_on_held_lock_returns_false_like_stdlib(both):
    def script(side):
        lk = side.locks.make_lock("self.try")
        lk.acquire()
        try:
            return [lk.acquire(blocking=False), lk.acquire(True, 0.01)]
        finally:
            lk.release()

    rep, tried = both(script)
    assert tried == [False, False]
    # the timed case only
    assert [f["kind"] for f in rep["findings"]] == ["self_deadlock"]


def test_rlock_reentry_is_legal(both):
    def script(side):
        rl = side.locks.make_rlock("re.lock")
        inner = side.locks.make_lock("re.inner")
        with rl:
            with rl:
                with inner:
                    pass

    rep, _ = both(script)
    assert rep["ok"]
    assert [(e["from"], e["to"]) for e in rep["edges"]] == \
        [("re.lock", "re.inner")]


# ---------------------------------------------------------------------------
# blocking under a lock
# ---------------------------------------------------------------------------
def _blocking(rep: dict) -> list:
    return [(f["blocking"], f["held"])
            for f in rep["findings"] if f["kind"] == "blocking_under_lock"]


def test_blocking_under_tier_lock_flagged(both):
    def script(side):
        lk = side.locks.make_lock("tier.cache")
        with lk:
            for i in range(3):  # one finding per (kind, held set)
                side.locks.note_blocking("source.pread",
                                         detail=f"f{i}.parquet")

    rep, _ = both(script)
    blk = [f for f in rep["findings"] if f["kind"] == "blocking_under_lock"]
    assert len(blk) == 1
    assert (blk[0]["blocking"], blk[0]["held"], blk[0]["detail"]) == \
        ("source.pread", ["tier.cache"], "f0.parquet")
    assert _stack(blk[0]["stack"])


def test_blocking_with_nothing_held_is_clean(both):
    rep, _ = both(lambda side: side.locks.note_blocking("pool.submit"))
    assert rep["ok"]


def test_non_tier_lock_exempt_from_blocking_rule(both):
    def script(side):
        fd = side.locks.make_lock("src.fd", tier=False)
        tier = side.locks.make_lock("src.tier")
        with fd:
            side.locks.note_blocking("source.pread")
        with tier:
            with fd:
                side.locks.note_blocking("source.pread")

    rep, _ = both(script)
    # the fd lock stays in the order graph, and only the tier lock counts
    assert [(e["from"], e["to"]) for e in rep["edges"]] == \
        [("src.tier", "src.fd")]
    assert _blocking(rep) == [("source.pread", ["src.tier"])]


def test_condition_wait_exempts_its_own_lock_only(both):
    def script(side):
        cv = side.locks.make_condition("cv.own")
        with cv:
            cv.wait(timeout=0.01)  # holding only the condition's lock
        clean = side.report()
        outer = side.locks.make_lock("cv.outer")
        with outer:
            with cv:
                cv.wait(timeout=0.01)  # waiting under outer: a finding
        return [clean]

    rep, (clean,) = both(script)
    assert clean["ok"]
    assert _blocking(rep) == [("condition.wait", ["cv.outer"])]


def test_condition_notify_and_wait_keep_held_set_exact(both):
    def script(side):
        cv = side.locks.make_condition("cv.pair")
        woke, waiting = [], threading.Event()

        def waiter():
            with cv:
                waiting.set()
                while not woke:
                    cv.wait(timeout=5)
                woke.append("waiter")

        t = threading.Thread(target=waiter)
        t.start()
        waiting.wait(5)
        with cv:
            woke.append("notifier")
            cv.notify_all()
        t.join()
        lk = side.locks.make_lock("cv.after")
        with lk:
            pass
        return woke

    rep, woke = both(script)
    assert woke == ["notifier", "waiter"]
    assert rep["ok"] and rep["edges"] == []


def test_the_port_preads_and_submits_declare_blocking(both, tmp_path):
    """The preads of each local source and a pool submit are the same
    blocking sites in both packages: made under a tier lock, each is a
    finding of its kind or of none, as the reference's is."""
    import io

    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(64)))

    def script(side):
        src_mod = importlib.import_module(side.pkg + ".io.source")
        pool = importlib.import_module(side.pkg + ".utils.pool")
        held = side.locks.make_lock("fix.tier")
        # pread_view: the one source that has it in both packages
        sources = [(src_mod.FileSource(str(path)), ("pread",)),
                   (src_mod.MmapSource(str(path)), ("pread", "pread_view")),
                   (src_mod.FileLikeSource(io.BytesIO(bytes(range(64)))),
                    ("pread",))]
        seen = []
        try:
            for src, reads in sources:
                for read in reads:
                    side.locks.reset_lockcheck()
                    with held:
                        got = bytes(getattr(src, read)(3, 4))
                    seen.append([type(src).__name__, read, got.hex(),
                                 _blocking(side.report())])
        finally:
            for src, _ in sources:
                src.close()
        side.locks.reset_lockcheck()
        with held:
            fut = pool.submit(int, "5")
        seen.append(["pool.submit", fut.result(timeout=30),
                     _blocking(side.report())])
        return seen

    _, seen = both(script)
    pread = [("source.pread", ["fix.tier"])]
    assert [s for s in seen if s[1] == "pread"] == [
        [name, "pread", "03040506", pread]
        for name in ("FileSource", "MmapSource", "FileLikeSource")]
    assert seen[-1] == ["pool.submit", 5, [("pool.submit", ["fix.tier"])]]


def test_note_blocking_free_when_disabled():
    for side in SIDES:
        assert not side.locks.LOCKCHECK_ENABLED
        side.locks.reset_lockcheck()
        side.locks.note_blocking("source.pread")
        assert side.locks.lockcheck_state().snapshot()["findings"] == []


# ---------------------------------------------------------------------------
# off: the plain stdlib primitives (no wrapper), counted and never timed
# ---------------------------------------------------------------------------
def test_factories_return_plain_stdlib_primitives_when_off():
    for side in SIDES:
        lk = side.locks
        assert not lk.LOCKCHECK_ENABLED
        assert type(lk.make_lock("x")) is type(threading.Lock())
        assert type(lk.make_lock("x", tier=False)) is type(threading.Lock())
        assert type(lk.make_rlock("x")) is type(threading.RLock())
        cv = lk.make_condition("x")
        assert type(cv) is threading.Condition
        assert not isinstance(cv, lk.CheckedCondition)


def test_a_read_off_the_checker_goes_through_no_checked_lock(tmp_path):
    """With the checker off the port's locks are the stdlib's: a read,
    a lookup and a scan on the CPU count no checked acquisition."""
    import parquet_tpu_torch as pq
    from parquet_tpu_torch.io import cache
    from parquet_tpu_torch.obs import metrics
    from parquet_tpu_torch.utils import pool

    assert type(cache.PAGES._lock) is type(threading.Lock())
    assert type(metrics.REGISTRY._lock) is type(threading.Lock())
    assert type(pool.read_admission()._cv) is threading.Condition
    path = str(tmp_path / "t.parquet")
    pq.write_table({"k": np.arange(2_000, dtype=np.int64)}, path,
                   options=pq.WriterOptions(row_group_size=500))
    L.reset_lockcheck()
    with no_thread_started():
        pf = pq.ParquetFile(path)
        try:
            pf.read(device="cpu")
            pf.find_rows("k", [3, 1_500], device="cpu")
            pq.scan_expr(pf, pq.col("k") >= 1_990, device="cpu")
        finally:
            pf.close()
    assert L.lockcheck_state().snapshot() == {
        "edges": [], "findings": [], "acquisitions": 0}


# ---------------------------------------------------------------------------
# the locks of both packages: the same names and tiers
# ---------------------------------------------------------------------------
_LOCK_SITE = re.compile(
    r"\bmake_(lock|rlock|condition)\(\s*\"([^\"]+)\"\s*(?:,\s*tier=(\w+))?")

# the reference's locks with no counterpart, each with the reason
_REFERENCE_ONLY = {
    "native.build": "each kernel build holds a per-library file lock",
    "write.pended_cv": "the port's writer queues no encoded row groups",
}
_PORT_ONLY = {"codecs.registry", "device.copy_streams", "device.plan_route",
              "kernels.launches", "lookup.fetch", "mesh.counters",
              "serve.connections", "serve.fleet_legs"}


def _lock_sites(pkg: str) -> dict:
    out = {}
    root = os.path.join(REPO, pkg)
    for d, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py") or \
                    os.path.join(d, fn).endswith(os.path.join("utils",
                                                              "locks.py")):
                continue
            with open(os.path.join(d, fn), encoding="utf-8") as f:
                for kind, name, tier in _LOCK_SITE.findall(f.read()):
                    out.setdefault(name, set()).add((kind, tier or "True"))
    return out


def test_every_reference_lock_has_its_port_counterpart():
    """Each lock the reference builds is built by the port under the same
    name, factory and tier; the two sets differ by the pinned lists."""
    ref, port = _lock_sites("parquet_tpu"), _lock_sites("parquet_tpu_torch")
    assert set(ref) - set(port) == set(_REFERENCE_ONLY)
    assert set(port) - set(ref) == _PORT_ONLY
    for name in set(ref) & set(port):
        assert port[name] == ref[name], name


# one child for both packages' checkers, on from import: first the names
# and tiers of their locks, then the same ABBA through each
_CHECKED_CHILD = r"""
import importlib, io, json, sys, threading
path = sys.argv[1]
importlib.import_module("parquet_tpu_torch").write_table(
    {"k": list(range(10))}, path)


def lock(lk):
    lk = getattr(lk, "_checked", lk)  # a condition's checked lock
    return [type(lk).__name__, lk.name, lk.tier]


got = {}
for pkg in ("parquet_tpu", "parquet_tpu_torch"):
    m = lambda name: importlib.import_module(pkg + "." + name)
    cache, source, pool = m("io.cache"), m("io.source"), m("utils.pool")
    scope, trace = m("obs.scope"), m("obs.trace")
    mm = source.MmapSource(path)
    fl = source.FileLikeSource(io.BytesIO(b"x" * 8))
    adm = pool.read_admission()
    got[pkg] = {
        "cache.page": lock(cache.PAGES._lock),
        "cache.footer": lock(cache.FOOTERS._lock),
        "cache.neg": lock(cache.NEGS._lock),
        "source.mmap": lock(mm._fd_lock),
        "source.filelike": lock(fl._lock),
        "pool.build": lock(pool._LOCK),
        "pool.admission": [type(adm._cv).__name__] + lock(adm._cv),
        "pool.qps": lock(adm._qps_lock),
        "metrics.registry": lock(m("obs.metrics").REGISTRY._lock),
        "ledger.registry": lock(m("obs.ledger").LEDGER._lock),
        "trace.buffer": lock(trace._LOCK),
        "scope": [lock(scope._SLOW_LOG_LOCK), lock(scope._LIVE_LOCK),
                  lock(scope._SAMPLE_LOCK)],
    }
    mm.close()
    fl.close()
got["kernels"] = lock(importlib.import_module(
    "parquet_tpu_torch.ops.kernels")._launch_lock)

reports = {}
for pkg in ("parquet_tpu", "parquet_tpu_torch"):
    L = importlib.import_module(pkg + ".utils.locks")
    L.reset_lockcheck()  # what came before is not counted
    a = L.make_lock("seed.A"); b = L.make_lock("seed.B")
    with a:
        with b: pass
    def rev():
        with b:
            with a: pass
    t = threading.Thread(target=rev); t.start(); t.join()
    reports[pkg] = importlib.import_module(
        pkg + ".analysis.lockcheck").lockcheck_report()
json.dump({"names": got, "abba": reports}, sys.stdout)
sys.exit(0 if reports["parquet_tpu_torch"]["ok"] else 1)
"""


@pytest.fixture(scope="module")
def checked_child(tmp_path_factory):
    """The child of :data:`_CHECKED_CHILD` under ``PARQUET_TPU_LOCKCHECK=1``
    and ``PARQUET_TPU_TORCH_LOCKCHECK=1``, each package's exit report
    asked for: ``(process, tmp dir)``."""
    tmp = tmp_path_factory.mktemp("checked_child")
    env = dict(os.environ, PARQUET_TPU_TORCH_LOCKCHECK="1",
               PARQUET_TPU_TORCH_LOCKCHECK_REPORT=str(tmp / "port.json"),
               PARQUET_TPU_LOCKCHECK="1",
               PARQUET_TPU_LOCKCHECK_REPORT=str(tmp / "ref.json"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHECKED_CHILD, str(tmp / "t.parquet")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    return proc, tmp


def test_the_port_locks_carry_the_reference_names(checked_child):
    """Under ``PARQUET_TPU_LOCKCHECK=1`` and ``PARQUET_TPU_TORCH_LOCKCHECK=1``
    (each read at import) the locks of both packages, import-time ones
    too, are checked; each port lock has its reference counterpart's
    name and tier, read from both in one process."""
    proc, _ = checked_child
    assert proc.stdout, proc.stderr[-2000:]
    got = json.loads(proc.stdout)["names"]
    assert got["parquet_tpu_torch"] == got["parquet_tpu"]
    port = got["parquet_tpu_torch"]
    assert port["cache.page"] == ["CheckedLock", "cache.page", True]
    assert port["source.mmap"] == ["CheckedLock", "source.mmap_fd", False]
    assert port["pool.admission"] == ["CheckedCondition", "CheckedLock",
                                      "pool.admission", True]
    assert got["kernels"] == ["CheckedLock", "kernels.launches", True]


def test_build_threads_of_one_process_compile_once(tmp_path):
    """``ops/_build.py`` keeps no lock of its own: its file lock, opened
    anew by each thread, serializes the threads of one process too, so
    four threads loading one library into an empty directory compile it
    once and share one handle."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_build_threads", os.path.join(REPO, "parquet_tpu_torch", "ops",
                                       "_build.py"))
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    b.BUILD_DIR = str(tmp_path)
    compiled, real_start = [], b._start

    def counting_start(name):
        got = real_start(name)
        if got is not None:
            compiled.append(name)
        return got

    b._start = counting_start
    gate = threading.Barrier(4)
    libs, errors = [], []

    def loader():
        try:
            gate.wait(30)
            libs.append(b.load("host_codec"))
        except Exception as e:  # raised below
            errors.append(e)

    with no_thread_started():
        threads = [threading.Thread(target=loader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    assert not errors, errors
    assert compiled == ["host_codec"]
    assert len(libs) == 4 and len({id(lib) for lib in libs}) == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def test_format_stack_renders_file_line_func():
    frames = ((__file__, 10, "some_func"), ("/no/such/file.py", 3, "f"))
    out = format_stack(frames)
    assert out == ref_lockcheck.format_stack(frames)
    assert len(out) == 2 and ":10 in some_func" in out[0]
    assert out[1] == "/no/such/file.py:3 in f"


def test_report_json_serializable(both):
    rep, _ = both(_abba)
    rep = json.loads(json.dumps(rep))
    assert rep["enabled"] is True and rep["locks"] == ["fix.A", "fix.B"]


def test_seeded_abba_subprocess_exits_1_with_stacks(checked_child):
    """Both checkers on from import in one child, the same ABBA through
    each: equal reports, exit 1, and each package's exit report on disk."""
    proc, tmp_path = checked_child
    assert proc.returncode == 1, proc.stderr[-2000:]
    reps = json.loads(proc.stdout)["abba"]
    ref, port = reps["parquet_tpu"], reps["parquet_tpu_torch"]
    assert _norm(port, "<string>") == _norm(ref, "<string>")
    assert port["cycles"] == [["seed.A", "seed.B"]]
    for rep in (ref, port):
        edges = [f for f in rep["findings"]
                 if f["kind"] == "lock_order_cycle"][0]["edges"]
        assert sorted((e["from"], e["to"], e["count"]) for e in edges) == \
            [("seed.A", "seed.B", 1), ("seed.B", "seed.A", 1)]
        assert all(_stack(e["from_stack"], "<string>") and
                   _stack(e["to_stack"], "<string>") for e in edges)
    # the exit reports (PARQUET_TPU[_TORCH]_LOCKCHECK_REPORT) landed too
    for name in ("port", "ref"):
        disk = json.loads((tmp_path / f"{name}.json").read_text())
        assert disk["cycles"] == port["cycles"]


# ---------------------------------------------------------------------------
# the hammer on the CPU: the port's lock graph under the checker
# ---------------------------------------------------------------------------
def test_lockcheck_hammer_cli_clean_on_the_cpu(tmp_path):
    """``python -m parquet_tpu_torch.analysis.lockcheck --device cpu`` under
    the checker: reads, scans and lookups under a read budget, a table's
    ingest and compaction, the daemon and a fleet under concurrent
    clients give a graph with no cycle, no other finding, and locks of
    every layer in it."""
    env = dict(os.environ, PARQUET_TPU_TORCH_LOCKCHECK="1",
               PARQUET_TPU_TORCH_LOCKCHECK_REPORT=str(tmp_path / "rep.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "parquet_tpu_torch.analysis.lockcheck",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["enabled"]
    assert rep["cycles"] == [] and rep["findings"] == []
    assert rep["acquisitions"] > 1000
    # the report's lock set comes from its edges: a lock shows where it
    # was held across another's acquisition
    for expected in ("prefetch.ring", "pool.admission", "cache.page",
                     "cache.footer", "ledger.account", "metrics.counter",
                     "manifest.dir", "serve.fleet"):
        assert expected in rep["locks"], (expected, rep["locks"])
    assert json.loads((tmp_path / "rep.json").read_text())["ok"]


def test_hammer_device_flag_defaults_to_cuda(monkeypatch, capsys):
    from parquet_tpu_torch.analysis import lockcheck

    seen = []
    monkeypatch.setattr(lockcheck, "_hammer_workload",
                        lambda td, device: seen.append(device))
    L.reset_lockcheck()
    assert lockcheck.hammer_main([]) == 0
    assert lockcheck.hammer_main(["--device", "cpu"]) == 0
    assert seen == ["cuda", "cpu"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is True
