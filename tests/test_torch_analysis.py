"""The port's linter (``parquet_tpu_torch/analysis/lint.py``), its typed
knob registry (``analysis/knobs.py`` read through ``utils/env.py``) and
the README table of its knobs, against the reference's
(``parquet_tpu/analysis``, ``tests/test_analysis.py``).

Each lint case is one source written twice, once per package (the
package and the knob prefix swapped): both linters must give the same
``(rule, line)`` set, and it must be the expected one."""

import json
import os
import subprocess
import sys

import pytest

from parquet_tpu.analysis import lint as jlint
from parquet_tpu.utils import env as jenv
from parquet_tpu_torch.analysis import lint as tlint
from parquet_tpu_torch.analysis.lint import (Finding, declared_metric_families,
                                             lint_source, run_lint)
from parquet_tpu_torch.utils import env as tenv
from parquet_tpu_torch.utils.env import (env_bool, env_bytes, env_int,
                                         env_opt_bytes, env_opt_float,
                                         env_opt_int, env_str, knob, knobs,
                                         knobs_markdown)

from torch_fixtures.threads import no_thread_started

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _rules(findings):
    return {f.rule for f in findings}


def _both(template: str, rel: str = "io/fixture.py"):
    """``template`` linted by both packages' linters (``{pkg}`` is the
    package, ``{P}`` the knob prefix): each one's ``(rule, line)`` set."""
    ref = {"pkg": "parquet_tpu", "P": "PARQUET_TPU_"}
    port = {"pkg": "parquet_tpu_torch", "P": "PARQUET_TPU_TORCH_"}
    got_ref = jlint.lint_source(template.format(**ref),
                                f"parquet_tpu/{rel}")
    got_port = tlint.lint_source(template.format(**port),
                                 f"parquet_tpu_torch/{rel}")
    return ({(f.rule, f.line) for f in got_ref},
            {(f.rule, f.line) for f in got_port})


# ---------------------------------------------------------------------------
# the reference's fixtures (tests/lint_fixtures/), written here for both
# packages: each flags its rule on the same lines in both linters
# ---------------------------------------------------------------------------
FIXTURES = {
    "pt001_metric": ('"""PT001: a family obs/metrics.py never declared."""\n'
                     'from {pkg}.obs.metrics import counter\n'
                     '\n'
                     '_M_BOGUS = counter("bogus.family_nobody_declared")\n',
                     {("PT001", 4)}),
    "pt002_env": ('"""PT002: knobs read off os.environ."""\n'
                  'import os\n'
                  '\n'
                  'RAW = os.environ.get("{P}PAGE_CACHE", "")\n'
                  'ALSO = os.getenv("{P}PAGE_CACHE")\n',
                  {("PT002", 4), ("PT002", 5)}),
    "pt003_ledger": ('"""PT003: an account of io/cache.py resolved here."""\n'
                     'from {pkg}.obs.ledger import ledger_account\n'
                     '\n'
                     'ACC = ledger_account("cache.page")\n',
                     {("PT003", 4)}),
    "pt004_time": ('"""PT004: wall-clock deadline math."""\n'
                   'import time\n'
                   '\n'
                   '\n'
                   'def deadline_in(seconds):\n'
                   '    return time.time() + seconds\n',
                   {("PT004", 6)}),
    "pt005_except": ('"""PT005: a bare except, a swallowed BaseException."""\n'
                     '\n'
                     '\n'
                     'def swallow_everything(fn):\n'
                     '    try:\n'
                     '        return fn()\n'
                     '    except:  # noqa: E722\n'
                     '        return None\n'
                     '\n'
                     '\n'
                     'def swallow_base(fn):\n'
                     '    try:\n'
                     '        return fn()\n'
                     '    except BaseException:\n'
                     '        return None\n',
                     {("PT005", 7), ("PT005", 14)}),
    "pt006_lock": ('"""PT006: locks built around utils/locks.py."""\n'
                   'import threading\n'
                   'from threading import RLock\n'
                   '\n'
                   'LOCK = threading.Lock()\n'
                   'RL = RLock()\n',
                   {("PT006", 5), ("PT006", 6)}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_flags_the_same_lines(name):
    template, want = FIXTURES[name]
    ref, port = _both(template)
    assert ref == port == want


# ---------------------------------------------------------------------------
# each rule's semantics on small sources, in both linters
# ---------------------------------------------------------------------------
CASES = {
    "pt001_declared_family_passes": (
        'from {pkg}.obs.metrics import counter\n'
        'C = counter("cache.page_hits")\n', "io/x.py", set()),
    "pt001_non_literal_name_passes": (
        'from {pkg}.obs.metrics import histogram\n'
        'def h(name):\n    return histogram("span." + name)\n',
        "io/x.py", set()),
    "pt001_alias_prefix_flags": (
        'from {pkg}.obs.metrics import gauge as _mgauge\n'
        'G = _mgauge("nobody.declared_this")\n', "io/x.py", {("PT001", 2)}),
    "pt001_declaration_file_exempt": (
        'from .metrics import counter\n'
        'C = counter("anything.new")\n', "obs/metrics.py", set()),
    "pt002_undeclared_knob_flags": (
        'from {pkg}.utils.env import env_int\n'
        'V = env_int("{P}NOT_A_KNOB")\n', "io/x.py", {("PT002", 2)}),
    "pt002_accessor_type_mismatch_flags": (
        'from {pkg}.utils.env import env_int\n'
        'V = env_int("{P}PAGE_CACHE")\n', "io/x.py", {("PT002", 2)}),
    "pt002_declared_knob_with_its_accessor_passes": (
        'from {pkg}.utils.env import env_bytes\n'
        'V = env_bytes("{P}PAGE_CACHE")\n', "io/x.py", set()),
    "pt002_environ_write_and_pop_are_legal": (
        'import os\n'
        'os.environ["{P}PAGE_CACHE"] = "1"\n'
        'os.environ.pop("{P}PAGE_CACHE", None)\n'
        'del os.environ["{P}MMAP"]\n', "io/x.py", set()),
    "pt002_env_file_exempt": (
        'import os\nV = os.environ.get("X", "")\n', "utils/env.py", set()),
    "pt003_owner_module_passes": (
        'from {pkg}.obs.ledger import ledger_account\n'
        'A = ledger_account("cache.page")\n', "io/cache.py", set()),
    "pt003_foreign_module_flags": (
        'from {pkg}.obs.ledger import ledger_account\n'
        'A = ledger_account("cache.page")\n', "io/lookup.py", {("PT003", 2)}),
    "pt003_unknown_account_flags_everywhere": (
        'from {pkg}.obs.ledger import ledger_account\n'
        'A = ledger_account("mystery.tier")\n', "io/cache.py",
        {("PT003", 2)}),
    "pt004_monotonic_clocks_pass": (
        'import time\nA = time.monotonic()\nB = time.perf_counter()\n',
        "io/x.py", set()),
    "pt005_reraise_passes": (
        'def f(g):\n    try:\n        return g()\n'
        '    except BaseException:\n        cleanup = 1\n        raise\n',
        "io/x.py", set()),
    "pt005_tuple_with_baseexception_flags": (
        'def f(g):\n    try:\n        return g()\n'
        '    except (ValueError, BaseException):\n        return None\n',
        "io/x.py", {("PT005", 4)}),
    "pt006_factory_construction_passes": (
        'from {pkg}.utils.locks import make_lock\nL = make_lock("x.y")\n',
        "io/x.py", set()),
    "pt006_locks_file_exempt": (
        'import threading\nL = threading.Lock()\n', "utils/locks.py", set()),
    "pt006_semaphore_flags": (
        'import threading\nS = threading.Semaphore(2)\n', "io/x.py",
        {("PT006", 2)}),
    "suppression_with_reason_silences": (
        'import time\n'
        '# ptlint: disable=PT004 -- wall-clock record stamp\n'
        'TS = time.time()\n', "io/x.py", set()),
    "trailing_suppression_silences": (
        'import time\n'
        'TS = time.time()  # ptlint: disable=PT004 -- record stamp\n',
        "io/x.py", set()),
    "suppression_without_reason_is_pt000": (
        'import time\n# ptlint: disable=PT004\nTS = time.time()\n',
        "io/x.py", {("PT000", 2), ("PT004", 3)}),
    "suppression_for_another_rule_does_not_silence": (
        'import time\n# ptlint: disable=PT005 -- wrong rule\n'
        'TS = time.time()\n', "io/x.py", {("PT004", 3)}),
    "suppression_comment_block_skips_to_the_code_line": (
        'import time\n'
        '# ptlint: disable=PT004 -- record stamp, with a\n'
        '# continuation comment line between it and the code\n'
        'TS = time.time()\n', "io/x.py", set()),
    "suppression_of_several_rules": (
        'import os, time\n'
        '# ptlint: disable=PT002,PT004 -- both, for a reason\n'
        'V = (os.environ.get("X"), time.time())\n', "io/x.py", set()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_semantics_match_the_reference(name):
    template, rel, want = CASES[name]
    ref, port = _both(template, rel)
    assert ref == port == want


def test_the_ported_knob_prefix_is_what_the_port_declares():
    """A reference knob name is undeclared in the port: a finding there."""
    src = ('from parquet_tpu_torch.utils.env import env_bytes\n'
           'V = env_bytes("PARQUET_TPU_PAGE_CACHE")\n')
    assert _rules(lint_source(src, "parquet_tpu_torch/io/x.py")) \
        == {"PT002"}


def test_ledger_owners_are_the_reference_accounts():
    assert tlint.LEDGER_OWNERS == jlint.LEDGER_OWNERS
    assert tlint.RULES == jlint.RULES


# ---------------------------------------------------------------------------
# the port's tree: zero findings (analyze's lint half)
# ---------------------------------------------------------------------------
def test_the_port_tree_has_no_findings():
    findings = run_lint()
    assert findings == [], "\n".join(f.render() for f in findings)


def test_every_suppression_in_the_port_names_its_reason():
    """Every ``ptlint`` suppression of the port's tree carries its reason
    (the lint's PT000) and names a rule the linter has."""
    import re

    pkg = os.path.join(REPO, "parquet_tpu_torch")
    found = 0
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    m = re.search(r"#\s*ptlint:\s*disable=([A-Z]+\d+"
                                  r"(?:,[A-Z]+\d+)*)\s*--\s*(\S.*)", line)
                    if m:
                        found += 1
                        assert set(m.group(1).split(",")) <= set(tlint.RULES)
    assert found >= 9


def test_declared_families_are_the_references():
    declared = declared_metric_families()
    assert declared == jlint.declared_metric_families()
    for name in ("cache.page_hits", "pool.queue_wait_s",
                 "ledger.resident_bytes", "route.gbps",
                 "lookup.admission_wait_s"):
        assert name in declared, name


def test_finding_render_shape():
    f = Finding("PT004", "parquet_tpu_torch/x.py", 3, "msg")
    assert f.render() == "parquet_tpu_torch/x.py:3: PT004: msg"
    assert f.as_dict() == {"rule": "PT004", "path": "parquet_tpu_torch/x.py",
                           "line": 3, "message": "msg"}


# ---------------------------------------------------------------------------
# the knob registry and the accessors' semantics
# ---------------------------------------------------------------------------
def test_every_knob_is_declared_with_an_accessor_type():
    assert len(knobs()) == 47
    for k in knobs():
        assert k.name.startswith("PARQUET_TPU_TORCH_"), k.name
        assert any(k.type in types
                   for types in tenv.ACCESSOR_TYPES.values()), k.name
        assert k.doc, k.name
    assert tenv.ACCESSOR_TYPES == jenv.ACCESSOR_TYPES


@pytest.mark.parametrize("name", ["PARQUET_TPU_TORCH_DOES_NOT_EXIST",
                                  "PARQUET_TPU_MMAP"])
def test_undeclared_knob_raises(name):
    with pytest.raises(KeyError):
        env_str(name)


@pytest.mark.parametrize("accessor,name", [
    (env_int, "PARQUET_TPU_TORCH_PAGE_CACHE"),       # declared bytes
    (env_int, "PARQUET_TPU_TORCH_MMAP"),             # declared bool
    (env_str, "PARQUET_TPU_TORCH_REMOTE_TIMEOUT"),   # declared float
    (env_opt_bytes, "PARQUET_TPU_TORCH_PREFETCH_DEPTH"),  # opt_int
    (env_opt_int, "PARQUET_TPU_TORCH_PREFETCH_WINDOW"),   # opt_bytes
])
def test_wrong_accessor_for_the_declared_type_raises(accessor, name):
    with pytest.raises(TypeError):
        accessor(name)


def test_names_outside_the_prefix_stay_legal(monkeypatch):
    monkeypatch.setenv("SCRATCH_TEST_BUDGET", "123")
    assert env_opt_bytes("SCRATCH_TEST_BUDGET") == 123
    monkeypatch.delenv("SCRATCH_TEST_BUDGET")
    assert env_opt_bytes("SCRATCH_TEST_BUDGET") is None


# the port's knobs whose declaration differs from their reference twin's:
# the prefetcher's mode spells its default ``auto`` (the reference's
# ``1`` reads as auto in both), the window pin is a byte count that a
# negative value clamps to 0 (no pin) rather than failing the read, and
# the lookup's key sharding is off by default: at the reference's floor
# of 1,024 phase 5's 524,288-key lookup ran 8.506 s cold and 6.916 s
# warm against 6.009 s and 5.275 s serial on an H100 host (PERF.md),
# its stages 3-4 mostly Python a page under the GIL
DIVERGENT_KNOBS = {
    "PARQUET_TPU_TORCH_PREFETCH": (("str", "auto"), ("str", "1")),
    "PARQUET_TPU_TORCH_PREFETCH_WINDOW": (("opt_bytes", None),
                                          ("opt_int", None)),
    "PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD": (("int", 0), ("int", 1024)),
}


def test_every_knob_has_its_reference_twins_type_and_default():
    for k in knobs():
        ref = jenv.knob(k.name.replace("PARQUET_TPU_TORCH_", "PARQUET_TPU_"))
        assert ref is not None, k.name
        mine, theirs = (k.type, k.default), (ref.type, ref.default)
        assert (mine, theirs) == DIVERGENT_KNOBS.get(k.name, (theirs,
                                                              theirs)), \
            k.name


# (port knob, reference knob) of one type and default: the same raw
# values parse the same
TWINS = [("PARQUET_TPU_TORCH_AGG_DICT", "PARQUET_TPU_AGG_DICT"),
         ("PARQUET_TPU_TORCH_MMAP", "PARQUET_TPU_MMAP"),
         ("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE",
          "PARQUET_TPU_PREFETCH_AUTOTUNE"),
         ("PARQUET_TPU_TORCH_PAGE_CACHE", "PARQUET_TPU_PAGE_CACHE"),
         ("PARQUET_TPU_TORCH_CHUNK_CACHE", "PARQUET_TPU_CHUNK_CACHE"),
         ("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD",
          "PARQUET_TPU_LOOKUP_KEY_SHARD"),
         ("PARQUET_TPU_TORCH_REMOTE_BREAKER", "PARQUET_TPU_REMOTE_BREAKER"),
         ("PARQUET_TPU_TORCH_REMOTE_TIMEOUT", "PARQUET_TPU_REMOTE_TIMEOUT"),
         ("PARQUET_TPU_TORCH_REMOTE_HEDGE", "PARQUET_TPU_REMOTE_HEDGE"),
         ("PARQUET_TPU_TORCH_READ_BUDGET", "PARQUET_TPU_READ_BUDGET"),
         ("PARQUET_TPU_TORCH_SLOW_OP_S", "PARQUET_TPU_SLOW_OP_S"),
         ("PARQUET_TPU_TORCH_LOCKCHECK", "PARQUET_TPU_LOCKCHECK")]
RAW = [None, "", "  ", "0", "off", "NO", "false", "1", "yes", " 7 ", "-5",
       "2.5", "garbage", " 0.25 "]


@pytest.mark.parametrize("mine,theirs", TWINS, ids=[t[0] for t in TWINS])
def test_parse_semantics_match_the_reference(monkeypatch, mine, theirs):
    k, j = knob(mine), jenv.knob(theirs)
    assert ((k.type, k.default), (j.type, j.default)) == \
        DIVERGENT_KNOBS.get(mine, ((j.type, j.default),) * 2)
    read = {"str": "env_str", "bool": "env_bool", "int": "env_int",
            "float": "env_float", "bytes": "env_bytes",
            "opt_int": "env_opt_int", "opt_float": "env_opt_float",
            "opt_bytes": "env_opt_bytes"}[k.type]
    for raw in RAW:
        for name in (mine, theirs):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        got, want = getattr(tenv, read)(mine), getattr(jenv, read)(theirs)
        if (got, want) == (k.default, j.default):
            continue  # unset or unparsable: each its own default
        assert got == want, raw


def test_bool_int_bytes_and_opt_semantics(monkeypatch):
    assert env_bool("PARQUET_TPU_TORCH_AGG_DICT") is True
    assert env_bool("PARQUET_TPU_TORCH_LOCKCHECK") is False
    for off in ("0", "off", "false", "NO"):
        monkeypatch.setenv("PARQUET_TPU_TORCH_AGG_DICT", off)
        assert env_bool("PARQUET_TPU_TORCH_AGG_DICT") is False
    assert env_int("PARQUET_TPU_TORCH_FOOTER_CACHE") == 256
    monkeypatch.setenv("PARQUET_TPU_TORCH_FOOTER_CACHE", "off")
    assert env_int("PARQUET_TPU_TORCH_FOOTER_CACHE") == 256
    assert env_bytes("PARQUET_TPU_TORCH_PAGE_CACHE") == 64 << 20
    monkeypatch.setenv("PARQUET_TPU_TORCH_PAGE_CACHE", "-5")
    assert env_bytes("PARQUET_TPU_TORCH_PAGE_CACHE") == 0
    assert env_opt_int("PARQUET_TPU_TORCH_PREFETCH_DEPTH") is None
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_DEPTH", "-3")
    assert env_opt_int("PARQUET_TPU_TORCH_PREFETCH_DEPTH") == -3
    assert env_opt_float("PARQUET_TPU_TORCH_SLOW_OP_S") is None
    monkeypatch.setenv("PARQUET_TPU_TORCH_REMOTE_HEDGE", " 0.25 ")
    assert env_str("PARQUET_TPU_TORCH_REMOTE_HEDGE") == "0.25"


def test_a_negative_prefetch_depth_pin_reads_as_none_pinned(monkeypatch):
    """The depth pin reads through ``env_opt_int`` and clamps at 0 as its
    ``env_opt_bytes`` read did: a negative pin leaves the default."""
    from parquet_tpu_torch.io import prefetch
    from parquet_tpu_torch.io.source import BytesSource

    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE", "0")
    monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_DEPTH", "-3")
    with no_thread_started():
        src = prefetch.PrefetchSource(BytesSource(b"x" * 64))
        try:
            assert src.depth == 4
        finally:
            src.close()
        monkeypatch.setenv("PARQUET_TPU_TORCH_PREFETCH_DEPTH", "7")
        src = prefetch.PrefetchSource(BytesSource(b"x" * 64))
        try:
            assert src.depth == 7
        finally:
            src.close()


def test_knob_lookup():
    k = knob("PARQUET_TPU_TORCH_READ_BUDGET")
    assert k is not None and k.type == "opt_bytes" and k.doc
    assert knob("PARQUET_TPU_TORCH_NOPE") is None
    with pytest.raises(ValueError):
        tenv.declare("PARQUET_TPU_TORCH_READ_BUDGET", "opt_bytes", None,
                     "twice")


# ---------------------------------------------------------------------------
# the README table of the port's knobs, generated from the registry
# ---------------------------------------------------------------------------
def _readme_table() -> str:
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    begin, end = "<!-- torch-knobs:begin -->", "<!-- torch-knobs:end -->"
    assert begin in text and end in text
    return text.split(begin, 1)[1].split(end, 1)[0].strip()


def test_readme_knob_table_matches_the_registry():
    assert _readme_table() == knobs_markdown().strip(), \
        "README knob table is stale: regenerate with " \
        "`python -m parquet_tpu_torch analyze --knobs-md`"


def test_the_port_table_leaves_the_reference_table_alone():
    """The port's markers do not contain the reference's, so the
    reference's check reads its own table."""
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    ref = text.split("<!-- knobs:begin -->", 1)[1] \
        .split("<!-- knobs:end -->", 1)[0].strip()
    assert ref == jenv.knobs_markdown().strip()
    assert "PARQUET_TPU_TORCH_" not in ref


def test_knobs_markdown_sorted_and_complete():
    md = knobs_markdown()
    names = [line.split("`")[1] for line in md.splitlines()[2:]]
    assert names == sorted(names)
    assert len(names) == len(knobs())
    assert "| `PARQUET_TPU_TORCH_PAGE_CACHE` | bytes | 64 MiB |" in md
    assert "| `PARQUET_TPU_TORCH_LOCKCHECK` | bool | off |" in md
    assert "| `PARQUET_TPU_TORCH_READ_BUDGET` | opt_bytes | unset |" in md


# ---------------------------------------------------------------------------
# the analyze command without its hammer (the hammer: test_torch_lockcheck)
# ---------------------------------------------------------------------------
def test_analyze_no_hammer_json():
    proc = subprocess.run(
        [sys.executable, "-m", "parquet_tpu_torch", "analyze",
         "--no-hammer", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    assert rep == {"ok": True, "lint": [],
                   "knobs_md": {"stale": False,
                                "detail": "README knob table matches the "
                                          "registry"},
                   "lockcheck": {"skipped": True}}


def test_analyze_knobs_md_prints_the_table():
    from parquet_tpu_torch.__main__ import main
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["analyze", "--knobs-md"]) == 0
    assert out.getvalue() == knobs_markdown()


def test_analyze_reports_a_finding(tmp_path, monkeypatch, capsys):
    """A tree with a finding and a stale table fails the gate with both
    named."""
    from parquet_tpu_torch import __main__ as cli

    bad = tlint.Finding("PT004", "parquet_tpu_torch/io/x.py", 3, "msg")
    monkeypatch.setattr(tlint, "run_lint", lambda: [bad])
    monkeypatch.setattr(cli, "_repo_root", lambda: str(tmp_path))
    (tmp_path / "README.md").write_text("no markers\n")
    assert cli.main(["analyze", "--no-hammer"]) == 1
    out = capsys.readouterr().out
    assert "parquet_tpu_torch/io/x.py:3: PT004: msg" in out
    assert "lint: 1 finding(s)" in out
    assert "torch-knobs:begin" in out
    assert out.rstrip().endswith("analyze: FAILED")
