"""The port's command line (``python -m parquet_tpu_torch``) against the
reference's (``parquet_tpu.__main__``) on the same files, made from a seed
with numpy, with ``--device cpu`` where a command decodes: every command
and its error paths give the same exit code and the same output (the
``parquet_tpu:`` prefix swapped), as the reference's tests
(``test_reader.py``, ``test_dataset.py``, ``test_obs.py``,
``test_ledger.py``, ``test_aggregate.py``) run them; ``stats`` compares
its families and read counters from fresh processes; ``serve`` answers a
lookup in a subprocess and drains on SIGTERM."""

import contextlib
import io
import json
import math
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import parquet_tpu
import parquet_tpu_torch as pqt
from parquet_tpu.__main__ import main as jmain
from parquet_tpu_torch.__main__ import main as tmain

from torch_fixtures.threads import no_thread_started, start_shared_pools

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 3_000
SEED = 23
# commands that decode take the port's --device
DECODING = ("head", "aggregate", "stats", "verify")


@pytest.fixture(scope="module", autouse=True)
def _pools():
    start_shared_pools()


@pytest.fixture(autouse=True)
def _clean():
    pqt.clear_caches()
    parquet_tpu.clear_caches()
    with no_thread_started():
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A flat file (ints, doubles, nullable strings, a dictionary column,
    three row groups), a nested one (a list, a struct), a second flat part
    and a corrupt copy."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(SEED)
    words = np.array(["ant", "bee", "cat", "dog", "eel"])
    s = words[rng.integers(0, 5, N)].astype(object)
    s[rng.random(N) < 0.1] = None
    flat = pa.table({
        "id": np.arange(N, dtype=np.int64),
        "x": rng.random(N),
        "s": pa.array(s, pa.string()),
        "k": rng.integers(0, 7, N).astype(np.int32),
        "flag": pa.array(np.array(["A", "N", "R"])[rng.integers(0, 3, N)]),
    })
    out = {"dir": str(d)}
    out["flat"] = str(d / "part-0.parquet")
    papq.write_table(flat, out["flat"], row_group_size=1_000,
                     use_dictionary=["k", "flag"])
    out["part1"] = str(d / "part-1.parquet")
    papq.write_table(flat.slice(0, 700), out["part1"], row_group_size=300)
    lists = [list(range(i % 4)) if i % 9 else None for i in range(200)]
    nested = pa.table({
        "l": pa.array(lists, pa.list_(pa.int64())),
        "st": pa.array([{"a": i, "b": f"v{i % 3}"} for i in range(200)],
                       pa.struct([("a", pa.int32()), ("b", pa.string())])),
    })
    out["nested"] = str(d / "nested.parquet")
    papq.write_table(nested, out["nested"], row_group_size=64)
    with open(out["flat"], "rb") as f:
        data = f.read()
    out["corrupt"] = str(d / "bad" / "corrupt.parquet")
    os.makedirs(os.path.dirname(out["corrupt"]))
    with open(out["corrupt"], "wb") as f:
        f.write(data[: len(data) // 2] + data[-8:])
    return out


def _run(main, argv):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = main(argv)
    return rc, o.getvalue(), e.getvalue()


def _both(argv, device=True):
    """The same command through both CLIs: the reference's exactly, the
    port's with ``--device cpu`` where it decodes; stderr with the
    prefix named ``PFX``."""
    ref = _run(jmain, argv)
    targv = list(argv) + (["--device", "cpu"]
                          if device and argv[0] in DECODING else [])
    port = _run(tmain, targv)
    norm = (lambda r, p: (r[0], r[1], r[2].replace(p, "PFX:")))
    return norm(ref, "parquet_tpu:"), norm(port, "parquet_tpu_torch:")


# ---------------------------------------------------------------------------
# meta, schema, pages, head: byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["meta", "{flat}"], ["meta", "{nested}"],
    ["schema", "{flat}"], ["schema", "{nested}"],
    ["pages", "{flat}"], ["pages", "{flat}", "--row-group", "2",
                          "--column", "2"],
    ["pages", "{flat}", "--column", "3"], ["pages", "{nested}",
                                           "--column", "1"],
    ["head", "{flat}"], ["head", "-n", "1", "{flat}"],
    ["head", "-n", "2500", "{flat}"], ["head", "-n", "5", "{nested}"],
], ids=lambda a: "-".join(x.strip("{}-") for x in a))
def test_file_commands_match_the_reference(files, argv):
    argv = [a.format(**files) for a in argv]
    ref, port = _both(argv)
    assert ref[0] == port[0] == 0
    assert port == ref
    assert port[1]


@pytest.mark.parametrize("argv", [
    ["meta", "{dir}/missing.parquet"],
    ["head", "-n", "0", "{flat}"],
    ["pages", "{flat}", "--row-group", "9"],
    ["pages", "{flat}", "--column", "-1"],
    ["schema", "{flat}", "{part1}"],
    ["meta"],
    ["verify"],
    ["aggregate"],
    ["serve"],
    ["stats", "{dir}/nope*.parquet"],
    ["aggregate", "{flat}", "--agg", "bogus:x"],
    ["aggregate", "{flat}", "--agg", "sum"],
    ["aggregate", "{flat}", "--agg", "sum:nope"],
], ids=lambda a: "-".join(x.strip("{}-").replace("/", "")
                          for x in a)[:40])
def test_error_paths_match_the_reference(files, argv):
    argv = [a.format(**files) for a in argv]
    ref, port = _both(argv)
    assert ref[0] == port[0] == 1
    assert port == ref


@pytest.mark.parametrize("cmd", ["meta", "head"])
def test_a_corrupt_footer_raises_as_in_the_reference(files, cmd):
    """The file commands catch OS, value and key errors only: a corrupt
    footer's ``ReadError`` escapes both CLIs alike."""
    argv = [cmd, files["corrupt"]]
    with pytest.raises(parquet_tpu.ReadError, match="bad footer"):
        _run(jmain, argv)
    with pytest.raises(pqt.ReadError, match="bad footer"):
        _run(tmain, argv + (["--device", "cpu"] if cmd == "head" else []))


def test_a_card_command_without_a_card_fails_and_names_it(files):
    """No fallback: ``--device cuda`` (the default) on a machine without
    a card is an error of the command, before any decode."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["head", files["flat"]],
                 ["aggregate", files["flat"], "--agg", "count"],
                 ["stats", files["flat"]],
                 ["verify", "--decode", files["flat"]]):
        rc, out, err = _run(tmain, argv)
        assert (rc, out) == (1, ""), argv
        assert err.startswith("parquet_tpu_torch: CUDA is not available")
    # meta and a verify without --decode decode nothing: no card needed
    assert _run(tmain, ["meta", files["flat"]])[0] == 0
    assert _run(tmain, ["verify", files["flat"]])[0] == 0


def test_an_unknown_device_is_refused(files):
    rc, out, err = _run(tmain, ["head", files["flat"], "--device", "meta"])
    assert (rc, out) == (1, "")
    assert err.startswith("parquet_tpu_torch: unsupported device 'meta'")
    rc, out, err = _run(tmain, ["head", files["flat"], "--device", "tpu"])
    assert (rc, out) == (1, "") and err.startswith("parquet_tpu_torch: ")


# ---------------------------------------------------------------------------
# verify: several paths and globs, plain and --json
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv,rc", [
    (["verify", "{flat}"], 0),
    (["verify", "--json", "{flat}", "{part1}"], 0),
    (["verify", "--json", "{dir}/part-*.parquet"], 0),
    (["verify", "--decode", "--json", "{dir}/part-*.parquet", "{nested}"], 0),
    (["verify", "{dir}/part-*.parquet", "{corrupt}"], 1),
    (["verify", "--json", "{corrupt}"], 1),
    (["verify", "--json", "{flat}", "{dir}/nope*.parquet"], 1),
    (["verify", "{dir}/nope*.parquet"], 1),
    (["verify", "{dir}/missing.parquet"], 1),
], ids=lambda a: "-".join(x.strip("{}-").replace("/", "")
                          for x in a)[:48] if isinstance(a, list) else str(a))
def test_verify_matches_the_reference(files, argv, rc):
    argv = [a.format(**files) for a in argv]
    ref, port = _both(argv)
    assert ref[0] == port[0] == rc
    assert port == ref
    if "--json" in argv:
        for line in port[1].splitlines():
            json.loads(line)


# ---------------------------------------------------------------------------
# stats: fresh processes, the same families, the same read counters
# ---------------------------------------------------------------------------
_STATS = r"""
import contextlib, io, json, sys
pkg, path = sys.argv[1], sys.argv[2]
main = __import__(pkg + ".__main__", fromlist=["main"]).main
dev = ["--device", "cpu"] if pkg == "parquet_tpu_torch" else []
out = {}
for form in ("plain", "--json", "--prom", "--debugz", "file"):
    argv = ["stats"] + ([] if form in ("plain", "file") else [form])
    if form == "file":
        argv += ["--json", path] + dev
    o = io.StringIO()
    with contextlib.redirect_stdout(o):
        rc = main(argv)
    out[form] = [rc, o.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def stats_runs(files):
    """Each package's ``stats`` in every form, in a fresh process of its
    own (the registry is process-wide)."""
    out = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for pkg in ("parquet_tpu", "parquet_tpu_torch"):
        proc = subprocess.run([sys.executable, "-c", _STATS, pkg,
                               files["flat"]], capture_output=True,
                              text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out["parquet_tpu"], out["parquet_tpu_torch"]


def test_stats_plain_names_the_same_series(stats_runs):
    ref, port = stats_runs
    assert ref["plain"][0] == port["plain"][0] == 0

    def names(text):
        return [line.split()[0] for line in text.splitlines()]
    assert names(port["plain"][1]) == names(ref["plain"][1])
    assert "cache.footer_hits 0" in port["plain"][1].splitlines()


def test_stats_json_has_the_same_families(stats_runs):
    ref, port = stats_runs
    r, p = json.loads(ref["--json"][1]), json.loads(port["--json"][1])
    assert set(p) == set(r) == {"counters", "gauges", "histograms"}
    for kind in r:
        assert set(p[kind]) == set(r[kind]), kind


def test_stats_prom_has_the_same_families(stats_runs):
    ref, port = stats_runs

    def types(text):
        return [line for line in text.splitlines()
                if line.startswith("# TYPE")]
    assert types(port["--prom"][1]) == types(ref["--prom"][1])
    assert "# TYPE parquet_tpu_cache_footer_hits_total counter" \
        in port["--prom"][1]


def test_stats_debugz_has_the_same_sections(stats_runs):
    ref, port = stats_runs
    r, p = json.loads(ref["--debugz"][1]), json.loads(port["--debugz"][1])
    assert set(p) == set(r)
    assert set(p["ledger"]["accounts"]) == set(r["ledger"]["accounts"])


def test_stats_of_a_file_meters_the_same_read(stats_runs):
    """The read the command makes moves the ``read.*`` counters as the
    reference's does, and its ``read.file_s`` once."""
    ref, port = stats_runs
    assert ref["file"][0] == port["file"][0] == 0
    r, p = json.loads(ref["file"][1]), json.loads(port["file"][1])
    reads = {k: v for k, v in r["counters"].items() if k.startswith("read.")}
    assert reads["read.bytes_read"] > 0
    assert {k: p["counters"][k] for k in reads} == reads
    assert p["histograms"]["read.file_s"]["count"] == 1


def test_stats_of_a_file_moves_what_a_direct_read_moves(files):
    """In one process: the command's counters move by what one direct
    ``read(device="cpu")`` moves, from cleared caches each."""
    from parquet_tpu_torch.obs import metrics_delta, metrics_snapshot

    def moved(fn):
        pqt.clear_caches()
        before = metrics_snapshot()
        fn()
        d = metrics_delta(before, metrics_snapshot())["counters"]
        return {k: v for k, v in d.items() if k.startswith("read.")}

    def direct():
        with pqt.ParquetFile(files["flat"]) as pf:
            pf.read(device="cpu")

    got = moved(lambda: _run(tmain, ["stats", "--json", files["flat"],
                                     "--device", "cpu"]))
    assert got == moved(direct) and got["read.bytes_read"] > 0


def test_stats_serve_scrapes_and_stops_on_sigint():
    """``stats --serve 0`` prints its URL, answers a scrape, and stops
    with exit 0 on an interrupt."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "parquet_tpu_torch", "stats", "--serve", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving metrics on http://127.0.0.1:"), \
            line or proc.stderr.read()
        url = line.split(" on ", 1)[1].split(" ", 1)[0]
        with urllib.request.urlopen(url, timeout=60) as r:
            text = r.read().decode()
        assert "# TYPE parquet_tpu_cache_footer_hits_total counter" in text
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0


# ---------------------------------------------------------------------------
# aggregate: the same JSON, floats to 1e-9
# ---------------------------------------------------------------------------
def _close(a, b, path="") -> None:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a == b, path
        elif math.isnan(a):
            assert math.isnan(b), path
        else:
            assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), \
                (path, a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("args", [
    [],
    ["--agg", "count", "--agg", "sum:x", "--agg", "avg:x",
     "--agg", "min:id", "--agg", "max:s"],
    ["--agg", "count", "--agg", "sum:k", "--group-by", "flag"],
    ["--agg", "count", "--agg", "avg:x", "--group-by", "s",
     "--where", "id:100:2500"],
    ["--agg", "var:x", "--agg", "var:x:sample", "--agg", "sum_sq:x",
     "--where", "x::0.5"],
    ["--agg", "distinct:k", "--agg", "top:s:2", "--agg", "count:s"],
    ["--agg", "count", "--where", "s:bee:dog"],
    ["--agg", "max:x", "--where", "id:5000:"],
], ids=lambda a: "-".join(a).replace(":", "_")[:50] or "default")
def test_aggregate_matches_the_reference(files, args):
    argv = ["aggregate", files["flat"], files["part1"]] + args
    ref, port = _both(argv)
    assert ref[0] == port[0] == 0, (ref[2], port[2])
    assert port[2] == ref[2] == ""
    _close(json.loads(port[1]), json.loads(ref[1]))


def test_aggregate_explain_goes_to_stderr(files):
    argv = ["aggregate", files["flat"], "--agg", "count", "--agg", "sum:x",
            "--where", "id:0:999", "--explain"]
    ref, port = _both(argv)
    assert ref[0] == port[0] == 0
    _close(json.loads(port[1]), json.loads(ref[1]))
    assert port[2] == ref[2] and port[2].strip()


# ---------------------------------------------------------------------------
# serve: a subprocess on an ephemeral port, one lookup, SIGTERM
# ---------------------------------------------------------------------------
def test_serve_answers_a_lookup_and_drains_on_sigterm(files, tmp_path):
    cfg = tmp_path / "serve.json"
    cfg.write_text(json.dumps({
        "datasets": {"flat": {"paths": [files["flat"]]}},
        "tenants": {"online": {"class": "latency"}}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "parquet_tpu_torch", "serve", "--config",
         str(cfg), "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving 1 dataset(s) on http://"), \
            line + proc.stderr.read() if not line else line
        url = line.split(" on ", 1)[1].split(" ", 1)[0]
        base = url.rsplit("/", 1)[0] if url.endswith("/") else url
        keys = [5, 17, 2_999, 123_456]
        req = urllib.request.Request(
            base.rstrip("/") + "/v1/lookup",
            data=json.dumps({"dataset": "flat", "column": "id",
                             "keys": keys, "columns": ["x", "s"]}).encode(),
            headers={"X-Tenant": "online"})
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
        from parquet_tpu_torch.serve.codecs import lookup_to_jsonable

        with pqt.Dataset([files["flat"]]) as ds:
            want = ds.find_rows("id", keys, columns=["x", "s"], device="cpu")
        assert doc["hits"] == json.loads(json.dumps(
            lookup_to_jsonable(want, keys)))
        assert doc["rows_total"] == want.rows_total == 3
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert out.strip().splitlines()[-1] == "drained and stopped"


def test_serve_with_a_bad_config_fails(tmp_path):
    cfg = tmp_path / "serve.json"
    cfg.write_text(json.dumps({"datasets": {"x": {}}}))
    ref = _run(jmain, ["serve", "--config", str(cfg)])
    port = _run(tmain, ["serve", "--config", str(cfg), "--device", "cpu"])
    assert ref[0] == port[0] == 1
    assert port[2].replace("parquet_tpu_torch:", "PFX:") == \
        ref[2].replace("parquet_tpu:", "PFX:")


# ---------------------------------------------------------------------------
# python -m, and the analyze command's device flag
# ---------------------------------------------------------------------------
def test_python_dash_m_entry_point(files):
    got = subprocess.run(
        [sys.executable, "-m", "parquet_tpu_torch", "meta", files["flat"]],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout == _run(tmain, ["meta", files["flat"]])[1]
    bad = subprocess.run(
        [sys.executable, "-m", "parquet_tpu_torch", "nope"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr


def test_analyze_passes_its_device_to_the_hammer(monkeypatch, capsys):
    from parquet_tpu_torch import __main__ as cli

    seen = []
    monkeypatch.setattr(cli, "_run_hammer", lambda device: seen.append(
        device) or {"ok": True, "acquisitions": 7, "edges": [],
                    "cycles": [], "findings": []})
    assert cli.main(["analyze"]) == 0
    assert cli.main(["analyze", "--device", "cpu", "--json"]) == 0
    assert seen == ["cuda", "cpu"]
    out = capsys.readouterr().out
    assert "lockcheck: 7 acquisitions, 0 lock-order edges, 0 cycle(s)" in out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is True
