"""Lock construction, and a lockdep-style lock checker at run time.

The port's copy of ``parquet_tpu/utils/locks.py``.  Every lock of
parquet_tpu_torch is built here (:func:`make_lock`, :func:`make_rlock`,
:func:`make_condition`; lint rule PT006 flags a ``threading.Lock()``
built anywhere else).  With ``PARQUET_TPU_TORCH_LOCKCHECK`` off (read at
import) the factories return the plain stdlib primitives: no wrapper and
no cost.  With it on (``=1``) they return checked wrappers that, at each
acquisition:

- keep the thread's **held-lock stack** in acquisition order, each entry
  with its acquiring stack (a raw frame walk; source lines are looked up
  only for a report);
- record each **lock-order edge** ``A -> B`` (B taken while A is held)
  in one graph for the process, the first time with BOTH stacks;
- search the graph at each new edge and record any **cycle**, a
  potential deadlock, with every edge of it and both stacks of each (as
  lockdep does, the interleaving never has to deadlock to be caught);
- raise at once on a **self-deadlock** (a held non-reentrant lock taken
  again by its holder, which would block forever).

:func:`note_blocking` is the other half: a call that may block for any
time (a pool submit, an admission wait, a ``Condition.wait``, a source's
pread, a remote request) says so, and where the calling thread holds a
*tier* lock then, a blocking-under-lock finding is recorded with the held
names and the blocking stack.  A lock made with ``tier=False`` (a
source's own fd lock, held across its read by contract) stays in the
order graph and is exempt from that rule.

Locks are keyed by NAME (a lock class, in lockdep's terms), so the graph
stays small and per-instance locks (per-file sources, per-op conditions)
aggregate.  An edge between two locks of one name is skipped: the order
of per-instance locks of one class is almost always fixed by instance
(lockdep's nested-lock annotations have the same limit).

``analysis/lockcheck.py`` reports over the state;
``PARQUET_TPU_TORCH_LOCKCHECK_REPORT=/path.json`` writes the report at
exit.
"""

from __future__ import annotations

import atexit
import sys
import threading
from typing import Dict, List, Optional, Tuple

from .env import env_bool, env_str

__all__ = ["LOCKCHECK_ENABLED", "make_lock", "make_rlock",
           "make_condition", "note_blocking", "enable_lockcheck",
           "disable_lockcheck", "lockcheck_state", "reset_lockcheck",
           "CheckedLock", "CheckedRLock", "CheckedCondition"]

LOCKCHECK_ENABLED = env_bool("PARQUET_TPU_TORCH_LOCKCHECK")

_STACK_LIMIT = 16


def enable_lockcheck() -> None:
    """Turn instrumentation on for locks created FROM NOW ON (tests;
    production enables via the env var so import-time singletons are
    covered too)."""
    global LOCKCHECK_ENABLED
    LOCKCHECK_ENABLED = True


def disable_lockcheck() -> None:
    global LOCKCHECK_ENABLED
    LOCKCHECK_ENABLED = False


def _capture_stack(skip: int) -> Tuple[Tuple[str, int, str], ...]:
    """(filename, lineno, funcname) frames, innermost first — a raw
    frame walk, no linecache IO (formatting happens at report time).
    Leading frames inside this module (``__enter__``/``acquire``
    wrappers) are dropped so reports point at the acquiring code."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    out = []
    while f is not None and len(out) < _STACK_LIMIT:
        co = f.f_code
        out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


class _Held:
    """One entry in a thread's held-lock stack."""

    __slots__ = ("lock", "name", "tier", "stack", "count")

    def __init__(self, lock, name: str, tier: bool, stack):
        self.lock = lock
        self.name = name
        self.tier = tier
        self.stack = stack
        self.count = 1


class _State:
    """The process-wide sanitizer state.  Its own lock is a PLAIN
    ``threading.Lock`` — a strict leaf (nothing is acquired under it),
    so it can never join the graph it guards."""

    def __init__(self):
        self._lock = threading.Lock()
        # (from_name, to_name) -> edge record
        self.edges: "Dict[Tuple[str, str], dict]" = {}
        self.findings: "List[dict]" = []
        self._cycle_keys: set = set()
        self.acquisitions = 0

    def record_edge(self, held: "_Held", name: str, stack) -> None:
        key = (held.name, name)
        with self._lock:
            edge = self.edges.get(key)
            if edge is not None:
                edge["count"] += 1
                return
            self.edges[key] = {
                "from": held.name, "to": name, "count": 1,
                "from_stack": held.stack, "to_stack": stack,
                "thread": threading.current_thread().name,
            }
            cycle = self._find_cycle_locked(name, held.name)
        if cycle is not None:
            self._record_cycle(key, cycle)

    def _find_cycle_locked(self, src: str, dst: str) -> Optional[list]:
        """A path src→…→dst through the edge graph (the new edge dst→src
        then closes a cycle).  Called with the state lock held; graphs
        are lock-class-sized (tens of nodes), plain DFS."""
        adj: Dict[str, list] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _record_cycle(self, new_key: Tuple[str, str],
                      path: list) -> None:
        # path is to→…→from for the new edge (from→to): the cycle is
        # from→to→…→from.  The path already ENDS at `from`, so drop
        # that closing node — the chain below re-closes it for edge
        # lookup.  Dedup on the sorted node set.
        nodes = [new_key[0]] + path[:-1]
        sig = tuple(sorted(set(nodes)))
        with self._lock:
            if sig in self._cycle_keys:
                return
            self._cycle_keys.add(sig)
            edges = []
            chain = nodes + [nodes[0]]
            for a, b in zip(chain, chain[1:]):
                e = self.edges.get((a, b))
                if e is not None:
                    edges.append(e)
            self.findings.append({
                "kind": "lock_order_cycle",
                "cycle": nodes,
                "edges": edges,
                "thread": threading.current_thread().name,
            })

    def record_blocking(self, kind: str, held_names: list, stack,
                        detail: str) -> None:
        with self._lock:
            # dedup per (kind, held set): one hammer can hit a site
            # millions of times
            sig = (kind, tuple(held_names))
            if any(f.get("_sig") == sig for f in self.findings):
                return
            self.findings.append({
                "kind": "blocking_under_lock", "_sig": sig,
                "blocking": kind, "detail": detail,
                "held": held_names, "stack": stack,
                "thread": threading.current_thread().name,
            })

    def record_self_deadlock(self, name: str, stack, first_stack) -> None:
        with self._lock:
            self.findings.append({
                "kind": "self_deadlock", "lock": name,
                "stack": stack, "first_stack": first_stack,
                "thread": threading.current_thread().name,
            })

    def note_acquire(self) -> None:
        with self._lock:
            self.acquisitions += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"edges": [dict(e) for e in self.edges.values()],
                    "findings": [dict(f) for f in self.findings],
                    "acquisitions": self.acquisitions}

    def reset(self) -> None:
        with self._lock:
            self.edges.clear()
            self.findings.clear()
            self._cycle_keys.clear()
            self.acquisitions = 0


_STATE = _State()
_HELD = threading.local()


def _held_stack() -> "List[_Held]":
    st = getattr(_HELD, "stack", None)
    if st is None:
        st = _HELD.stack = []
    return st


def lockcheck_state() -> _State:
    """The process-wide sanitizer state (analysis/lockcheck.py reports
    over it)."""
    return _STATE


def reset_lockcheck() -> None:
    """Clear the graph and findings (test isolation; held stacks are
    per-thread and drain themselves)."""
    _STATE.reset()


class CheckedLock:
    """Instrumented non-reentrant mutex (duck-types ``threading.Lock``,
    including the ``_is_owned`` hook ``threading.Condition`` probes)."""

    __slots__ = ("name", "tier", "_lock", "_owner")

    def __init__(self, name: str, tier: bool = True):
        self.name = name
        self.tier = tier
        self._lock = threading.Lock()
        self._owner = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        held = _held_stack()
        for h in held:
            if h.lock is self:
                # re-acquire by the holder: an UNBOUNDED blocking
                # acquire would hang forever — report AND raise (hanging
                # is the worst diagnostic).  A try-lock or timed acquire
                # is contract-legal (threading.Lock returns False), so
                # those keep the stdlib behavior; the timed case is
                # still certain failure, so it records a finding.
                stack = _capture_stack(2)
                if not blocking:
                    return False
                _STATE.record_self_deadlock(self.name, stack, h.stack)
                if timeout is not None and timeout >= 0:
                    return self._lock.acquire(True, timeout)
                raise RuntimeError(
                    f"lockcheck: self-deadlock on {self.name!r} "
                    f"(non-reentrant lock re-acquired by its holder)")
        if not self._lock.acquire(blocking, timeout):
            return False
        self._owner = me
        self._note_acquired(3)
        return True

    def _note_acquired(self, skip: int) -> None:
        stack = _capture_stack(skip)
        held = _held_stack()
        _STATE.note_acquire()
        for h in held:
            if h.name != self.name:
                _STATE.record_edge(h, self.name, stack)
        held.append(_Held(self, self.name, self.tier, stack))

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                del held[i]
                break
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        # threading.Condition probes this before wait()/notify()
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"CheckedLock({self.name!r})"


class CheckedRLock:
    """Instrumented reentrant mutex: recursion bumps the held entry's
    count instead of re-recording (no self-edges, no self-deadlock —
    re-entry is an RLock's contract)."""

    __slots__ = ("name", "tier", "_lock")

    def __init__(self, name: str, tier: bool = True):
        self.name = name
        self.tier = tier
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._lock.acquire(blocking, timeout):
            return False
        held = _held_stack()
        for h in held:
            if h.lock is self:
                h.count += 1
                return True
        stack = _capture_stack(2)
        _STATE.note_acquire()
        for h in held:
            if h.name != self.name:
                _STATE.record_edge(h, self.name, stack)
        held.append(_Held(self, self.name, self.tier, stack))
        return True

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                break
        self._lock.release()

    def _is_owned(self) -> bool:
        return any(h.lock is self for h in _held_stack())

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"CheckedRLock({self.name!r})"


class CheckedCondition(threading.Condition):
    """``threading.Condition`` over a :class:`CheckedLock`: waits go
    through the checked lock's release/acquire (held stacks stay exact
    across the wait), and every ``wait`` is a declared blocking site —
    waiting while holding any OTHER tier lock is a finding (the
    condition's own lock is released by the wait and exempt)."""

    def __init__(self, name: str, tier: bool = True):
        self._checked = CheckedLock(name, tier=tier)
        super().__init__(self._checked)

    def wait(self, timeout: Optional[float] = None) -> bool:
        note_blocking("condition.wait", detail=self._checked.name,
                      exempt=self._checked)
        return super().wait(timeout)


def note_blocking(kind: str, detail: str = "", exempt=None) -> None:
    """Declare a potentially-unbounded blocking operation (pool submit,
    admission wait, condition wait, source pread, remote request).  If
    this thread holds any tier lock other than ``exempt``, record a
    blocking-under-lock finding.  Free when lockcheck is off (one module
    bool)."""
    if not LOCKCHECK_ENABLED:
        return
    held = [h for h in _held_stack()
            if h.tier and h.lock is not exempt]
    if not held:
        return
    _STATE.record_blocking(kind, [h.name for h in held],
                           _capture_stack(2), detail)


def make_lock(name: str, tier: bool = True):
    """A mutex for ``name`` (a dotted lock-class id, e.g.
    ``cache.chunk``): plain ``threading.Lock`` normally, a
    :class:`CheckedLock` under ``PARQUET_TPU_TORCH_LOCKCHECK=1``.
    ``tier=False`` exempts the lock from the blocking-under-lock rule
    (fd locks whose hold-across-IO is the documented contract) while
    keeping it in the order graph."""
    if LOCKCHECK_ENABLED:
        return CheckedLock(name, tier=tier)
    return threading.Lock()


def make_rlock(name: str, tier: bool = True):
    if LOCKCHECK_ENABLED:
        return CheckedRLock(name, tier=tier)
    return threading.RLock()


def make_condition(name: str, tier: bool = True):
    if LOCKCHECK_ENABLED:
        return CheckedCondition(name, tier=tier)
    return threading.Condition()


def _report_at_exit() -> None:
    path = env_str("PARQUET_TPU_TORCH_LOCKCHECK_REPORT")
    if not path:
        return
    # local import: lockcheck.py needs locks.py, not the reverse
    from ..analysis.lockcheck import lockcheck_report
    import json

    try:
        with open(path, "w") as f:
            json.dump(lockcheck_report(), f, sort_keys=True)
    except OSError:
        pass  # exit-time report is best-effort


atexit.register(_report_at_exit)
