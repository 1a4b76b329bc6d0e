"""The process-wide worker pool and the read admission gate.

The port's cut of ``parquet_tpu/utils/pool.py``: :func:`shared_pool`, one
``ThreadPoolExecutor`` a process, built at first use; :func:`submit`,
which marks its work so that :func:`in_shared_pool` is true inside it and
runs it in a copy of the submitter's context (so an admission grant held
by the caller follows its work onto the worker); and
:func:`map_in_order`, which fans a function out on the pool and returns
its results in input order; and :func:`cancel_futures`, which tears down
work whose consumer gave up.  Work nested inside a pool worker runs
serially on that worker: a worker that waits on futures no free worker
can run would wedge the pool.

:class:`AdmissionController` is the FIFO bytes budget over every
in-flight read span (:func:`read_admission`, :func:`lookup_admission`):
the ``lookup`` tier (64 MiB unless ``PARQUET_TPU_TORCH_LOOKUP_BUDGET``
says otherwise), the ``scan`` tier (off unless
``PARQUET_TPU_TORCH_SCAN_BUDGET`` sets it) and the ``hedge`` tier of the
remote sources' second attempts (the global budget), all inside
``PARQUET_TPU_TORCH_READ_BUDGET`` where that is set (``0`` turns every
tier off).  While the resource ledger's total is at or over
``PARQUET_TPU_TORCH_MEM_HARD`` (obs/ledger.py), every tier's new
admissions block until it drops.  Not in this port: tenants and their QoS
classes and ``try_request``'s request-rate gate (they come with the
serving daemon).

Every task :func:`submit` dispatches, and every task of the read's own
worker pools (:func:`instrument_task`), counts in ``pool.tasks``, its
queue-to-run wait lands in the ``pool.queue_wait_s`` histogram and in the
current op's report, and with tracing on it runs inside a ``pool.task``
span.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Optional

from ..obs import ledger as _ledger
from ..obs import scope as _scope
from ..obs import trace as _trace
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.metrics import histogram as _histogram
from ..ops.host import available_cpus
from .env import env_opt_bytes

_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_IN_POOL = threading.local()

# the queue-to-run wait of every task (obs.metrics.pool_wait_seconds sums
# it for the routed scan's cost model)
_QUEUE_WAIT = _histogram("pool.queue_wait_s")
_TASKS = _counter("pool.tasks")
_ACTIVE = _gauge("pool.active")
_M_ADM_WAITS = _counter("lookup.admission_waits")
_ADM_WAIT_S = _histogram("lookup.admission_wait_s")
_M_READ_WAITS = _counter("read.admission_waits")
_READ_WAIT_S = _histogram("read.admission_wait_s")
_M_ADMITTED = _gauge("lookup.admitted_bytes")
_ACC_ADMITTED = _ledger.ledger_account("admission.in_flight")


def pool_width() -> int:
    """Workers of the shared pool: the cores this process may use, at
    least 2 (I/O still overlaps decode) and at most 16."""
    return max(2, min(16, available_cpus()))


def shared_pool() -> ThreadPoolExecutor:
    """The process-wide pool, built at first use."""
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=pool_width(),
                                       thread_name_prefix="pqt-work")
        return _POOL


def in_shared_pool() -> bool:
    """True inside work dispatched through :func:`submit`."""
    return getattr(_IN_POOL, "flag", False)


def _run_pooled(fn, args, kwargs):
    prev = in_shared_pool()
    _IN_POOL.flag = True
    try:
        return fn(*args, **kwargs)
    finally:
        _IN_POOL.flag = prev


def instrument_task(fn, name: Optional[str] = None):
    """Wrap a task about to be dispatched to a pool: its queue-to-run wait
    (from now) lands in the ``pool.queue_wait_s`` histogram and in the
    current op's report, ``pool.tasks`` counts it, and with tracing on it
    runs inside a ``pool.task`` span.  The dispatcher's context is
    captured here and each run executes in a fresh copy of it, so the op
    scope (its per-op counters, its trace track and ring) and an
    admission grant follow the work onto the worker.  A copy per run: one
    wrapped function may run on several workers at once, and a context
    refuses concurrent entry.  The read's own worker pools wrap their
    tasks with it too."""
    t_submit = time.perf_counter()
    ctx = contextvars.copy_context()

    def run(*a, **k):
        return ctx.copy().run(_run_instrumented, fn, name, t_submit, a, k)

    return run


def _run_instrumented(fn, name, t_submit: float, a, k):
    wait = time.perf_counter() - t_submit
    _QUEUE_WAIT.observe(wait)
    # runs inside the copied context: the wait is the dispatching op's
    _scope.add_to_current("pool.queue_wait_s", wait)
    _scope.account(_TASKS)
    _ACTIVE.inc()
    try:
        if _trace.TRACE_ENABLED:
            with _trace.span("pool.task", fn=name):
                return fn(*a, **k)
        return fn(*a, **k)
    finally:
        _ACTIVE.dec()


def submit(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the shared pool, marked so that
    :func:`in_shared_pool` is true while it runs, in a copy of the
    caller's context (:func:`instrument_task`); returns its future."""
    run = instrument_task(_run_pooled, name=getattr(fn, "__name__", None))
    return shared_pool().submit(run, fn, args, kwargs)


def pool_debug() -> dict:
    """The shared pool now, for ``/debugz``: its width, whether it was
    built, the tasks running, and the tasks queued."""
    with _LOCK:
        pool = _POOL
    queued = 0
    if pool is not None:
        try:
            queued = pool._work_queue.qsize()
        except (AttributeError, NotImplementedError):
            queued = 0
    return {"width": pool_width(), "built": pool is not None,
            "active": _ACTIVE.value, "queued": queued}


def cancel_futures(futures) -> None:
    """Tear down abandoned background work: cancel what has not started,
    and retrieve the error of what has (a task that fails after its
    consumer gave up, a writer's abort, must not log an exception nobody
    retrieved).  Does not wait: the work is pure compute whose results
    nobody reads."""
    for f in futures:
        if not f.cancel():
            f.add_done_callback(
                lambda g: None if g.cancelled() else g.exception())


def map_in_order(fn, items) -> list:
    """``[fn(item) for item in items]``, fanned out on the shared pool
    unless that cannot help (one item, one core) or would deadlock (inside
    a pool worker already).  Every task runs to its end; then the first
    failing item's exception is raised.  An interrupt on the waiting
    thread cancels what has not started and propagates at once."""
    items = list(items)
    if len(items) < 2 or available_cpus() < 2 or in_shared_pool():
        return [fn(it) for it in items]
    futs = [submit(fn, it) for it in items]
    out, first_err = [], None
    try:
        for f in futs:
            try:
                out.append(f.result())
            except Exception as e:
                if first_err is None:
                    first_err = e
                out.append(None)
    except BaseException:
        for f in futs:
            f.cancel()
        raise
    if first_err is not None:
        raise first_err
    return out


# ---------------------------------------------------------------------------
# the read admission gate
# ---------------------------------------------------------------------------

# set while a span runs under a grant: a nested acquire (a decode that
# admits the bytes its caller already admitted) gets grant 0 instead of
# queueing behind later tickets while it holds budget.  A context
# variable, so it follows the span's work onto pool workers (submit).
_ADMISSION_HELD: "contextvars.ContextVar[bool]" = \
    contextvars.ContextVar("parquet_tpu_torch_admission_held", default=False)

_TIER_KNOBS = {"lookup": "PARQUET_TPU_TORCH_LOOKUP_BUDGET",
               "scan": "PARQUET_TPU_TORCH_SCAN_BUDGET"}


class _Ticket:
    __slots__ = ("seq", "tier", "grant")

    def __init__(self, seq: int, tier: str, grant: int):
        self.seq = seq
        self.tier = tier
        self.grant = grant


class AdmissionController:
    """A FIFO gate over a bytes budget, shared by every read tier.

    :meth:`acquire` blocks until the request fits its tier's budget and
    the global one; tickets are granted strictly in arrival order, across
    tiers, so a stream of small late requests cannot starve a large
    earlier one.  A request larger than its budget is clamped to it and
    so admits alone.  A budget of 0 turns the gate off (grant 0, no
    wait).  A nested acquire inside :meth:`admit` gets grant 0.
    ``high_water`` is the most bytes ever granted at once, ``waits`` the
    acquires that had to block."""

    def __init__(self, lookup_default: int = 64 << 20):
        self._lookup_default = lookup_default
        self._cv = threading.Condition()
        self._queue: list = []  # tickets, in arrival order
        self._seq = itertools.count()
        self._in_use = 0
        self._tier_use: dict = {}
        self.high_water = 0
        self.waits = 0

    def global_budget_bytes(self) -> Optional[int]:
        """``PARQUET_TPU_TORCH_READ_BUDGET``: None unset, 0 off."""
        return env_opt_bytes("PARQUET_TPU_TORCH_READ_BUDGET")

    def budget_bytes(self, tier: str = "lookup") -> int:
        """The tier's budget (0: off), read per acquire: its own knob, else
        the global budget, else 64 MiB for lookups and off for the other
        tiers (scans, remote hedges)."""
        g = self.global_budget_bytes()
        if g == 0:
            return 0
        knob = _TIER_KNOBS.get(tier)  # "hedge" has no knob of its own
        t = env_opt_bytes(knob) if knob is not None else None
        if t is not None:
            return t
        if g is not None:
            return g
        return self._lookup_default if tier == "lookup" else 0

    def _may_grant_locked(self, ticket: _Ticket, budgets: dict,
                          g: Optional[int], hard: bool = False) -> bool:
        # FIFO: only the oldest ticket may take a grant; the ones behind
        # it wait even where they would fit.  Nothing is granted while
        # the ledger is over its hard watermark.
        if hard:
            return False
        head = self._queue[0]
        if head is not ticket:
            return False
        tier_b = budgets[ticket.tier]
        fits_tier = tier_b <= 0 or (self._tier_use.get(ticket.tier, 0)
                                    + ticket.grant <= tier_b)
        fits_global = not g or self._in_use + ticket.grant <= g
        return fits_tier and fits_global

    def acquire(self, nbytes: int, tier: str = "lookup",
                give_up=None) -> int:
        """Block until ``nbytes`` fit; returns the grant to hand back to
        :meth:`release` (0 when the tier's gate is off or the caller holds
        a grant already).  ``give_up``, a predicate checked at each wait
        (every 50 ms at most), withdraws the ticket and grants 0: a hedged
        read whose primary won must not keep later tickets waiting
        behind a grant nobody wants."""
        if _ADMISSION_HELD.get():
            return 0
        budget = self.budget_bytes(tier)
        hard_gate = _ledger.hard_watermark_bytes() > 0
        if budget <= 0 and not hard_gate:
            return 0
        g = self.global_budget_bytes()
        grant = min(max(int(nbytes), 0), budget) if budget > 0 else 0
        if g:
            grant = min(grant, g)
        t0 = time.perf_counter()
        waited = False
        if hard_gate and _ledger.LEDGER.check_pressure() == "hard":
            # the reclaim runs here, outside the gate's lock
            waited = True
        with self._cv:
            ticket = _Ticket(next(self._seq), tier, grant)
            self._queue.append(ticket)
            budgets = {tier: budget}
            while not self._may_grant_locked(
                    ticket, budgets, g,
                    hard_gate and _ledger.LEDGER.state() == "hard"):
                if give_up is not None and give_up():
                    self._queue.remove(ticket)
                    self._cv.notify_all()
                    return 0
                waited = True
                # a bounded wait under the hard watermark: a release of
                # ledger bytes elsewhere has no notifier of its own
                self._cv.wait(timeout=None if give_up is None
                              and not hard_gate else 0.05)
            self._queue.pop(0)
            self._in_use += grant
            self._tier_use[tier] = self._tier_use.get(tier, 0) + grant
            self.high_water = max(self.high_water, self._in_use)
            if waited:
                self.waits += 1
            _M_ADMITTED.set(self._in_use)
            _ACC_ADMITTED.set(self._in_use)
            # the next ticket may fit too: grants are not exclusive
            self._cv.notify_all()
        if waited:
            wait_s = time.perf_counter() - t0
            if tier == "lookup":
                _ADM_WAIT_S.observe(wait_s)
                _scope.account(_M_ADM_WAITS)
                _scope.add_to_current("lookup.admission_wait_s", wait_s)
            else:
                _READ_WAIT_S.observe(wait_s)
                _scope.account(_M_READ_WAITS)
                _scope.add_to_current("read.admission_wait_s", wait_s)
        return grant

    def release(self, grant: int, tier: str = "lookup") -> None:
        if grant <= 0:
            return
        with self._cv:
            self._in_use -= grant
            self._tier_use[tier] = self._tier_use.get(tier, 0) - grant
            _M_ADMITTED.set(self._in_use)
            _ACC_ADMITTED.set(self._in_use)
            self._cv.notify_all()

    @contextmanager
    def admit(self, nbytes: int, tier: str = "lookup"):
        """``with gate.admit(span_bytes): read and decode the span``: the
        grant is held, and nested gates pass, inside the block."""
        grant = self.acquire(nbytes, tier=tier)
        token = _ADMISSION_HELD.set(True)
        try:
            yield grant
        finally:
            _ADMISSION_HELD.reset(token)
            self.release(grant, tier=tier)

    def queue_depth(self) -> int:
        """Tickets waiting now."""
        with self._cv:
            return len(self._queue)

    def in_flight_bytes(self) -> int:
        with self._cv:
            return self._in_use

    def _reset(self) -> None:
        """Forget the high water and the waits (tests, benchmarks)."""
        with self._cv:
            self.high_water = self._in_use
            self.waits = 0


_ADMISSION = AdmissionController()


def read_admission() -> AdmissionController:
    """The process-wide read gate: the host scan's spans, the dataset
    read's file stages and the lookups' page spans all admit through it."""
    return _ADMISSION


def lookup_admission() -> AdmissionController:
    """The gate the lookups admit through: :func:`read_admission`'s."""
    return _ADMISSION
