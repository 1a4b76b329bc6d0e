"""An AST linter of the port's invariants: the rules its correctness rests
on, checked by machine.  The port's copy of ``parquet_tpu/analysis/
lint.py``, over ``parquet_tpu_torch/``; stdlib only.

Rules
-----

- **PT001 metric families declared** -- every literal metric name given
  to a registry get-or-create (``counter("x")``, ``gauge``,
  ``histogram``, under any alias) outside ``obs/metrics.py`` and
  ``obs/ledger.py`` must be declared there.  ``stats --prom`` depends on
  it: a family must EXIST (at 0) once ``parquet_tpu_torch`` is imported,
  and one first made by a module loaded late is missing until then.
- **PT002 knobs through the registry** -- no ``os.environ`` or
  ``os.getenv`` read outside ``utils/env.py`` (a write, ``del`` or
  ``.pop`` is teardown, not configuration, and stays legal); and a
  literal ``PARQUET_TPU_*`` name given to an env accessor must be
  declared in ``analysis/knobs.py`` with the accessor's type (the port
  declares only ``PARQUET_TPU_TORCH_*`` knobs, so the name of one of the
  JAX package's is a finding).
- **PT003 ledger accounts resolved by their owner** --
  ``ledger_account("name")`` with a literal name resolves only in the
  module that owns the tier (it keeps the account exact inside its own
  critical sections; a second resolver is a second writer).
- **PT004 monotonic clocks only** -- no ``time.time()``: deadlines,
  backoff and latencies use ``time.monotonic`` or ``time.perf_counter``
  (the wall clock steps under NTP).  A true wall-clock record stamp is
  suppressed on its line with the reason.
- **PT005 no swallowed BaseException** -- never a bare ``except:``; an
  ``except BaseException`` handler re-raises (a bare ``raise``) or
  carries a suppression that says where the error surfaces again.
- **PT006 locks from utils/locks.py** -- no ``threading`` ``Lock``,
  ``RLock``, ``Condition`` or ``Semaphore`` built outside
  ``utils/locks.py``: every lock comes from ``make_lock`` and its
  siblings, so the lock checker can instrument it.

Suppression: ``# ptlint: disable=PT004 -- <reason>`` on the flagged
line, or alone on the line or lines just above it.  The reason is
REQUIRED: a suppression without one is a finding itself (**PT000**).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["Finding", "run_lint", "lint_file", "lint_source",
           "declared_metric_families", "RULES", "LEDGER_OWNERS"]

RULES = {
    "PT000": "suppression without justification",
    "PT001": "metric family not pre-declared in obs/metrics.py",
    "PT002": "env knob read bypassing utils/env.py or undeclared",
    "PT003": "ledger account resolved outside its owning tier module",
    "PT004": "time.time() in code (monotonic-only; suppress true "
             "wall-clock record stamps)",
    "PT005": "bare except / swallowed BaseException",
    "PT006": "direct threading lock construction outside utils/locks.py",
}

# account name -> path suffix of the one module allowed to resolve it
LEDGER_OWNERS = {
    "cache.chunk": "io/cache.py",
    "cache.page": "io/cache.py",
    "cache.page_pinned": "io/cache.py",
    "cache.footer": "io/cache.py",
    "cache.neg_lookup": "io/cache.py",
    "prefetch.ring": "io/prefetch.py",
    "prefetch.segments": "io/prefetch.py",
    "write.buffer": "io/sink.py",
    "write.pended": "io/writer.py",
    "admission.in_flight": "utils/pool.py",
    "trace.buffer": "obs/trace.py",
    "remote.hedge_in_flight": "io/remote.py",
    "table.pending": "dataset_writer.py",
    "device.staging": "parallel/mesh.py",
}

_METRIC_KINDS = ("counter", "gauge", "histogram")
_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
_DECLARATION_FILES = ("obs/metrics.py", "obs/ledger.py")
_ENV_FILE = "utils/env.py"
_KNOB_PREFIX = "PARQUET_TPU_"
_LOCKS_FILE = "utils/locks.py"

_SUPPRESS_RE = re.compile(
    r"#\s*ptlint:\s*disable=([A-Za-z0-9_,]+)\s*(?:--\s*(\S.*))?")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


def _pkg_root() -> str:
    """The ``parquet_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _call_name(func) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _metric_kind(func) -> Optional[str]:
    """counter/gauge/histogram if this call looks like a registry
    get-or-create (handles the ``_counter``/``_mcounter``/
    ``REGISTRY.counter``/``_metrics.gauge`` aliasing idioms)."""
    name = _call_name(func)
    if not name:
        return None
    n = name.lstrip("_")
    if n in _METRIC_KINDS:
        return n
    # one-letter module-alias prefixes: _mcounter (metrics), _ohistogram
    # (obs), _mgauge, ...
    if len(n) > 1 and n[1:] in _METRIC_KINDS:
        return n[1:]
    return None


def _str_arg(call: ast.Call, i: int = 0) -> Optional[str]:
    if len(call.args) > i and isinstance(call.args[i], ast.Constant) \
            and isinstance(call.args[i].value, str):
        return call.args[i].value
    return None


def declared_metric_families(root: Optional[str] = None) -> Set[str]:
    """Metric names declared at ``import parquet_tpu_torch`` time, read
    STATICALLY from obs/metrics.py + obs/ledger.py: every literal name
    in a get-or-create call there, plus the ``_CORE_COUNTERS`` table.
    Static, not a registry snapshot — a snapshot taken after other
    modules imported would launder their stray declarations."""
    root = root or _pkg_root()
    out: Set[str] = set()
    for rel in _DECLARATION_FILES:
        path = os.path.join(root, *rel.split("/"))
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _metric_kind(node.func):
                name = _str_arg(node)
                if name:
                    out.add(name)
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) \
                            and tgt.id == "_CORE_COUNTERS":
                        for elt in getattr(node.value, "elts", ()):
                            if (isinstance(elt, ast.Tuple) and elt.elts
                                    and isinstance(elt.elts[0], ast.Constant)
                                    and isinstance(elt.elts[0].value, str)):
                                out.add(elt.elts[0].value)
    return out


def _suppressions(source: str):
    """Map line -> list of (rule_set, justification).  A trailing
    comment applies to its own line; a standalone comment applies to
    the next code line (comment blocks skip forward).  Returns
    (mapping, malformed) where malformed is [(line, raw)] for
    suppressions missing their justification."""
    lines = source.splitlines()
    mapping: Dict[int, List[Tuple[Set[str], str]]] = {}
    malformed: List[Tuple[int, str]] = []
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip().upper() for r in m.group(1).split(",")
                 if r.strip()}
        just = (m.group(2) or "").strip()
        if not just:
            malformed.append((i, raw.strip()))
            continue
        stripped = raw.strip()
        if stripped.startswith("#"):
            # standalone: attach to the next code line
            j = i
            while j < len(lines):
                nxt = lines[j].strip()  # lines[j] is line j+1
                if nxt and not nxt.startswith("#"):
                    mapping.setdefault(j + 1, []).append((rules, just))
                    break
                j += 1
        else:
            mapping.setdefault(i, []).append((rules, just))
    return mapping, malformed


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str, declared: Set[str],
                 knob_lookup):
        self.rel = rel
        self.declared = declared
        self.knob_lookup = knob_lookup
        self.findings: List[Finding] = []
        self.is_declaration_file = rel.endswith(_DECLARATION_FILES)
        self.is_env_file = rel.endswith(_ENV_FILE)
        self.is_locks_file = rel.endswith(_LOCKS_FILE)
        # names bound by `from threading import Lock [as L]`
        self.threading_names: Dict[str, str] = {}
        # subscript STORE/DEL targets on os.environ are writes (teardown)
        self.env_write_nodes: Set[int] = set()
        tree = ast.parse(source, filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                for alias in node.names:
                    if alias.name in _LOCK_CTORS:
                        self.threading_names[alias.asname
                                             or alias.name] = alias.name
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and self._is_os_environ(node.value):
                self.env_write_nodes.add(id(node.value))
            if isinstance(node, ast.Attribute) and node.attr == "pop" \
                    and self._is_os_environ(node.value):
                # .pop() is teardown (test/harness cleanup), not a read
                self.env_write_nodes.add(id(node.value))
        self.visit(tree)

    def _flag(self, rule: str, node, msg: str) -> None:
        self.findings.append(Finding(rule, self.rel,
                                     getattr(node, "lineno", 0), msg))

    @staticmethod
    def _is_os_environ(node) -> bool:
        return (isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os")

    # ------------------------------------------------------------ visits
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._is_os_environ(node) and not self.is_env_file \
                and id(node) not in self.env_write_nodes:
            self._flag("PT002", node,
                       "os.environ read outside utils/env.py — declare "
                       "the knob in analysis/knobs.py and read it with "
                       "a utils.env accessor")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name = _call_name(func)

        # os.environ.<read>() is caught by visit_Attribute via the inner
        # attribute; os.getenv() needs its own check
        if isinstance(func, ast.Attribute) and func.attr == "getenv" \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "os" and not self.is_env_file:
            self._flag("PT002", node,
                       "os.getenv outside utils/env.py — use a "
                       "utils.env accessor")

        # PT002b: accessor calls with literal undeclared knob names
        if name in self._accessor_types():
            lit = _str_arg(node)
            if lit and lit.startswith(_KNOB_PREFIX):
                knob = self.knob_lookup(lit)
                if knob is None:
                    self._flag("PT002", node,
                               f"knob {lit} is not declared in "
                               f"analysis/knobs.py")
                elif knob.type not in self._accessor_types()[name]:
                    self._flag("PT002", node,
                               f"knob {lit} is declared {knob.type!r} "
                               f"but read with {name}()")

        # PT001: metric get-or-create with a literal name
        kind = _metric_kind(func)
        if kind and not self.is_declaration_file:
            lit = _str_arg(node)
            if lit and lit not in self.declared:
                self._flag("PT001", node,
                           f"{kind} family {lit!r} is not pre-declared "
                           f"in obs/metrics.py — `stats --prom` will "
                           f"not render it until this module happens "
                           f"to import")

        # PT003: ledger account ownership
        if name and name.lstrip("_") == "ledger_account" \
                and not self.rel.endswith("obs/ledger.py"):
            lit = _str_arg(node)
            if lit:
                owner = LEDGER_OWNERS.get(lit)
                if owner is None:
                    self._flag("PT003", node,
                               f"ledger account {lit!r} has no declared "
                               f"owner (add it to LEDGER_OWNERS and "
                               f"obs/ledger.py CORE_ACCOUNTS)")
                elif not self.rel.endswith(owner):
                    self._flag("PT003", node,
                               f"ledger account {lit!r} is owned by "
                               f"{owner}; resolving it here makes a "
                               f"second writer")

        # PT004: time.time()
        if isinstance(func, ast.Attribute) and func.attr == "time" \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "time":
            self._flag("PT004", node,
                       "time.time() — use time.monotonic()/"
                       "perf_counter() for deadline/backoff/latency "
                       "math; suppress with justification for true "
                       "wall-clock record stamps")

        # PT006: direct lock construction
        if not self.is_locks_file:
            if isinstance(func, ast.Attribute) \
                    and func.attr in _LOCK_CTORS \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id == "threading":
                self._flag("PT006", node,
                           f"threading.{func.attr}() — construct locks "
                           f"via utils.locks.make_lock/make_rlock/"
                           f"make_condition so the sanitizer can "
                           f"instrument them")
            elif isinstance(func, ast.Name) \
                    and func.id in self.threading_names:
                self._flag("PT006", node,
                           f"{self.threading_names[func.id]}() imported "
                           f"from threading — use utils.locks factories")

        self.generic_visit(node)

    @staticmethod
    def _accessor_types():
        from ..utils.env import ACCESSOR_TYPES

        return ACCESSOR_TYPES

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        names = []
        t = node.type
        for n in ([t] if not isinstance(t, ast.Tuple) else t.elts) \
                if t is not None else []:
            if isinstance(n, ast.Name):
                names.append(n.id)
            elif isinstance(n, ast.Attribute):
                names.append(n.attr)
        if t is None:
            self._flag("PT005", node,
                       "bare except: swallows KeyboardInterrupt/"
                       "SystemExit — name the exceptions")
        elif "BaseException" in names:
            reraises = any(isinstance(x, ast.Raise) and x.exc is None
                           for x in ast.walk(node))
            if not reraises:
                self._flag("PT005", node,
                           "except BaseException without a bare "
                           "`raise`: KeyboardInterrupt/SystemExit die "
                           "here — re-raise, or suppress with a "
                           "justification naming where the error "
                           "resurfaces")
        self.generic_visit(node)


def lint_source(source: str, rel: str,
                declared: Optional[Set[str]] = None,
                knob_lookup=None) -> List[Finding]:
    """Lint one module's source (``rel`` is the repo-relative path used
    in findings and for the ownership/exemption checks)."""
    if declared is None:
        declared = declared_metric_families()
    if knob_lookup is None:
        from ..utils.env import knob as knob_lookup  # noqa: F811
    sup_map, malformed = _suppressions(source)
    out = [Finding("PT000", rel, line,
                   f"suppression missing its justification "
                   f"(`# ptlint: disable=RULE -- why`): {raw}")
           for line, raw in malformed]
    linter = _ModuleLinter(rel, source, declared, knob_lookup)
    for f in linter.findings:
        sups = sup_map.get(f.line, ())
        if any(f.rule in rules for rules, _ in sups):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_file(path: str, rel: Optional[str] = None,
              declared: Optional[Set[str]] = None) -> List[Finding]:
    return lint_source(open(path).read(), _norm(rel or path),
                       declared=declared)


def run_lint(root: Optional[str] = None) -> List[Finding]:
    """Lint every module of the parquet_tpu_torch package (or ``root``).
    The lockcheck hammer harness (analysis/lockcheck.py) is scanned
    too; its env WRITES are legal by construction."""
    root = root or _pkg_root()
    declared = declared_metric_families(
        root if os.path.isdir(os.path.join(root, "obs")) else None)
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = _norm(os.path.relpath(path, os.path.dirname(root)))
            findings.extend(lint_file(path, rel=rel, declared=declared))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
