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
admissions block until it drops.

The serving daemon's tenants ride the same gate (:class:`TenantSpec`,
:func:`tenant_context`, :meth:`AdmissionController.configure_tenants`):
inside a tenant's context a ticket is scheduled by its priority class
(``latency`` before ``default`` before ``bulk``), then by the tenant's
weighted virtual time, then by arrival, and its bytes are clamped by the
tenant's own budget; :meth:`AdmissionController.try_request` is the
tenants' request-rate gate (a token bucket that reads :func:`_qps_clock`).
Untagged (library) traffic keeps the strict FIFO.

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
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..obs import ledger as _ledger
from ..obs import scope as _scope
from ..obs import trace as _trace
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.metrics import histogram as _histogram
from ..ops.host import available_cpus
from .env import env_opt_bytes
from . import locks as _locks
from .locks import make_condition, make_lock

_LOCK = make_lock("pool.build")
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
    if _locks.LOCKCHECK_ENABLED:
        _locks.note_blocking("pool.submit",
                             detail=getattr(fn, "__name__", "") or "")
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
# tenants: the serving daemon's QoS contracts on the one gate
# ---------------------------------------------------------------------------

# priority classes, best first: a latency ticket is considered before a
# bulk one whatever their arrival order; untagged (library) traffic rides
# the default rank and keeps its strict FIFO
_CLASS_RANKS = {"latency": 0, "default": 1, "bulk": 2}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract at the admission gate: ``budget_bytes``, its
    own clamp inside the shared budgets (0/None: none); ``weight``, its
    share under contention within its class (2.0 drains twice the bytes of
    1.0); ``klass`` (``latency`` | ``default`` | ``bulk``), its priority
    against other tenants; and a request-rate limit, ``qps`` tokens a
    second with up to ``burst`` banked (None/0 qps: none; ``burst``
    defaults to ``max(qps, 1)``), enforced by
    :meth:`AdmissionController.try_request`."""

    name: str
    budget_bytes: Optional[int] = None
    weight: float = 1.0
    klass: str = "default"
    qps: Optional[float] = None
    burst: Optional[float] = None


# the (tenant, class) of the current request: a context variable, so every
# admission the request makes, on pool workers too (instrument_task copies
# the context), is the tenant's
_TENANT: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("parquet_tpu_torch_tenant", default=None)


def current_tenant() -> "Optional[Tuple[str, str]]":
    """The active ``(tenant, class)``, or None outside a tenant context."""
    return _TENANT.get()


@contextmanager
def tenant_context(name: str, klass: str = "default"):
    """Run a block as tenant ``name`` in priority class ``klass`` (an
    unknown class runs as ``default``): every admission inside it is
    scheduled and charged as the tenant's (:class:`TenantSpec`).  The
    serving daemon wraps each request in one."""
    token = _TENANT.set((name, klass if klass in _CLASS_RANKS
                         else "default"))
    try:
        yield
    finally:
        _TENANT.reset(token)


def _qps_clock() -> float:
    """The clock of the request-rate gate (a test replaces it)."""
    return time.monotonic()


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
    """One waiter.  ``key`` orders the queue: (class rank, the tenant's
    virtual time at enqueue, arrival); untagged tickets share rank 1 and
    the fairness floor, which leaves them in arrival order."""

    __slots__ = ("key", "tenant", "tier", "grant")

    def __init__(self, key: tuple, tenant: Optional[str], tier: str,
                 grant: int):
        self.key = key
        self.tenant = tenant
        self.tier = tier
        self.grant = grant


class AdmissionController:
    """A gate over a bytes budget, shared by every read tier.

    :meth:`acquire` blocks until the request fits its tier's budget and
    the global one.  Untagged tickets are granted strictly in arrival
    order, across tiers, so a stream of small late requests cannot starve
    a large earlier one.  A request larger than its budget is clamped to
    it and so admits alone.  A budget of 0 turns the gate off (grant 0, no
    wait).  A nested acquire inside :meth:`admit` gets grant 0.

    Tickets taken inside :func:`tenant_context` are scheduled by key
    (class rank, then the tenant's weighted virtual time, then arrival):
    a ticket blocked only by its own tenant's budget holds back its whole
    lane (the tenant's later tickets wait behind it) while other lanes
    pass; a ticket that fits its lane but not the shared budget reserves
    it (no later key passes it).  Each grant advances the tenant's
    virtual time by its bytes over its weight, from a start floored at
    the gate's clock (a new or idle tenant joins at now, banking nothing).

    ``high_water`` is the most bytes ever granted at once, ``waits`` the
    acquires that had to block; ``tenant_high_water`` and
    ``tenant_waits`` the same per tenant."""

    def __init__(self, lookup_default: int = 64 << 20):
        self._lookup_default = lookup_default
        self._cv = make_condition("pool.admission")
        # the request-rate buckets have a lock of their own: try_request
        # runs before admission and must not wait on the scheduler
        self._qps_lock = make_lock("pool.qps")
        self._qps_state: "Dict[str, list]" = {}  # name -> [tokens, t_last]
        self._queue: list = []  # tickets, in arrival order
        self._seq = itertools.count()
        self._in_use = 0
        self._tier_use: dict = {}
        self._tenants: "Dict[str, TenantSpec]" = {}
        self._tenant_use: "Dict[str, int]" = {}
        self._vtime: "Dict[str, float]" = {}
        self._vfloor = 0.0  # the gate's virtual clock
        self.tenant_high_water: "Dict[str, int]" = {}
        self.tenant_waits: "Dict[str, int]" = {}
        self.high_water = 0
        self.waits = 0

    # ------------------------------------------------------------ tenants
    def configure_tenants(self, specs) -> None:
        """Install the tenant table (``{name: TenantSpec}`` or specs).  A
        tenant outside it admits with no budget of its own, at the class
        its context names."""
        if isinstance(specs, dict):
            specs = specs.values()
        table = {}
        for s in specs:
            if not isinstance(s, TenantSpec):
                raise TypeError(f"expected TenantSpec, got "
                                f"{type(s).__name__}")
            if s.weight <= 0:
                raise ValueError(f"tenant {s.name!r} weight must be > 0")
            if s.qps is not None and s.qps < 0:
                raise ValueError(f"tenant {s.name!r} qps must be >= 0")
            if s.burst is not None and s.burst < 1:
                raise ValueError(f"tenant {s.name!r} burst must be >= 1")
            table[s.name] = s
        with self._cv:
            self._tenants = table
            self._cv.notify_all()  # a lane's budget may have grown
        with self._qps_lock:
            # a new table starts every bucket afresh: no debt and no
            # banked burst carry over from the old contracts
            self._qps_state = {}

    def clear_tenants(self) -> None:
        """Forget the tenant table and its accounting (grants in flight
        release against the shared counters)."""
        with self._cv:
            self._tenants = {}
            self._tenant_use = {}
            self._vtime = {}
            self._vfloor = 0.0
            self.tenant_high_water = {}
            self.tenant_waits = {}
            self._cv.notify_all()
        with self._qps_lock:
            self._qps_state = {}

    def try_request(self, name: str) -> "Optional[float]":
        """The request-rate gate for one request of tenant ``name``: None
        where it admits (a token taken), else the seconds until a token
        exists (what a 429's ``Retry-After`` says).  A tenant without a
        ``qps`` contract, or unknown, always admits; the bucket banks up
        to ``burst`` tokens."""
        with self._cv:
            spec = self._tenants.get(name)
        if spec is None or not spec.qps:
            return None
        rate = float(spec.qps)
        cap = float(spec.burst) if spec.burst is not None \
            else max(rate, 1.0)
        now = _qps_clock()
        with self._qps_lock:
            state = self._qps_state.get(name)
            if state is None:
                state = self._qps_state[name] = [cap, now]
            tokens = min(cap, state[0] + (now - state[1]) * rate)
            state[1] = now
            if tokens >= 1.0:
                state[0] = tokens - 1.0
                return None
            state[0] = tokens
            return (1.0 - tokens) / rate

    def tenant_spec(self, name: str) -> "Optional[TenantSpec]":
        with self._cv:
            return self._tenants.get(name)

    def tenant_debug(self) -> dict:
        """Each tenant's contract and live state for ``/debugz``: class,
        weight, budget, bytes in flight, high water and blocked
        acquires."""
        with self._cv:
            names = set(self._tenants) | set(self._tenant_use) \
                | set(self.tenant_high_water)
            out = {}
            for n in sorted(names):
                spec = self._tenants.get(n)
                out[n] = {
                    "class": spec.klass if spec else "default",
                    "weight": spec.weight if spec else 1.0,
                    "budget_bytes": spec.budget_bytes if spec else None,
                    "in_flight_bytes": self._tenant_use.get(n, 0),
                    "high_water_bytes": self.tenant_high_water.get(n, 0),
                    "waits": self.tenant_waits.get(n, 0),
                }
            return out

    # ------------------------------------------------------------ budgets
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

    def _tenant_budget(self, name: Optional[str]) -> int:
        # under self._cv; 0: no clamp of the tenant's own
        if name is None:
            return 0
        spec = self._tenants.get(name)
        if spec is None or not spec.budget_bytes:
            return 0
        return int(spec.budget_bytes)

    def _may_grant_locked(self, ticket: _Ticket, budget: int,
                          g: Optional[int], hard: bool = False) -> bool:
        # walk the queue in key order: a ticket blocked by its own
        # tenant's budget (or behind a lane-mate that is) holds back its
        # lane and lets other lanes pass; any other earlier-keyed ticket
        # either takes its grant first or reserves the shared budget.
        # Nothing is granted while the ledger is over its hard watermark.
        if hard:
            return False
        # each tier's budget is read once an evaluation (an env parse)
        budgets = {ticket.tier: budget}
        blocked_lanes = set()
        for t in sorted(self._queue, key=lambda t: t.key):
            tier_b = budgets.get(t.tier)
            if tier_b is None:
                tier_b = budgets[t.tier] = self.budget_bytes(t.tier)
            tb = self._tenant_budget(t.tenant)
            lane_blocked = t.tenant is not None and t.tenant in blocked_lanes
            fits_tenant = tb <= 0 or (self._tenant_use.get(t.tenant, 0)
                                      + t.grant <= tb)
            fits_tier = tier_b <= 0 or (self._tier_use.get(t.tier, 0)
                                        + t.grant <= tier_b)
            fits_global = not g or self._in_use + t.grant <= g
            if t is ticket:
                return (fits_tenant and fits_tier and fits_global
                        and not lane_blocked)
            if not fits_tenant or lane_blocked:
                if t.tenant is not None:
                    blocked_lanes.add(t.tenant)
                continue
            return False
        raise AssertionError("ticket not in queue")  # pragma: no cover

    def acquire(self, nbytes: int, tier: str = "lookup",
                give_up=None) -> int:
        """Block until ``nbytes`` fit; returns the grant to hand back to
        :meth:`release` (0 when the gate is off for the tier and the
        tenant or the caller holds a grant already).  ``give_up``, a
        predicate checked at each wait (every 50 ms at most), withdraws
        the ticket and grants 0: a hedged read whose primary won must not
        keep later tickets waiting behind a grant nobody wants."""
        if _ADMISSION_HELD.get():
            return 0
        budget = self.budget_bytes(tier)
        hard_gate = _ledger.hard_watermark_bytes() > 0
        got = _TENANT.get()
        tenant = got[0] if got is not None else None
        klass = got[1] if got is not None else "default"
        with self._cv:
            tenant_budget = self._tenant_budget(tenant)
            spec = self._tenants.get(tenant) if tenant else None
        if budget <= 0 and tenant_budget <= 0 and not hard_gate:
            return 0
        g = self.global_budget_bytes()
        caps = [b for b in (budget, tenant_budget) if b > 0]
        grant = min(max(int(nbytes), 0), *caps) if caps else 0
        if g:
            grant = min(grant, g)
        t0 = time.perf_counter()
        waited = False
        if hard_gate and _ledger.LEDGER.check_pressure() == "hard":
            # the reclaim runs here, outside the gate's lock
            waited = True
        with self._cv:
            # the tenant's start is floored at the gate's clock, so a new
            # or idle tenant cannot replay its past as priority; untagged
            # tickets key at the floor too (monotone: still FIFO among
            # themselves), so sustained library traffic cannot outrank a
            # tenant's positive virtual time for ever
            vt = max(self._vtime.get(tenant, 0.0), self._vfloor) \
                if tenant else self._vfloor
            ticket = _Ticket((_CLASS_RANKS.get(klass, 1), vt,
                              next(self._seq)), tenant, tier, grant)
            self._queue.append(ticket)
            while not self._may_grant_locked(
                    ticket, budget, g,
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
            self._queue.remove(ticket)
            self._in_use += grant
            self._tier_use[tier] = self._tier_use.get(tier, 0) + grant
            self.high_water = max(self.high_water, self._in_use)
            if tenant is not None:
                use = self._tenant_use.get(tenant, 0) + grant
                self._tenant_use[tenant] = use
                if use > self.tenant_high_water.get(tenant, 0):
                    self.tenant_high_water[tenant] = use
                w = spec.weight if spec is not None else 1.0
                self._vfloor = max(self._vfloor, vt)
                self._vtime[tenant] = vt + grant / max(w, 1e-9)
                if waited:
                    self.tenant_waits[tenant] = \
                        self.tenant_waits.get(tenant, 0) + 1
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

    def release(self, grant: int, tier: str = "lookup",
                tenant: Optional[str] = None) -> None:
        """Hand a grant back; ``tenant`` (default: the current context's)
        is the tenant it was charged to."""
        if grant <= 0:
            return
        if tenant is None:
            got = _TENANT.get()
            tenant = got[0] if got is not None else None
        with self._cv:
            self._in_use -= grant
            self._tier_use[tier] = self._tier_use.get(tier, 0) - grant
            if tenant is not None and tenant in self._tenant_use:
                self._tenant_use[tenant] -= grant
            _M_ADMITTED.set(self._in_use)
            _ACC_ADMITTED.set(self._in_use)
            self._cv.notify_all()

    @contextmanager
    def admit(self, nbytes: int, tier: str = "lookup"):
        """``with gate.admit(span_bytes): read and decode the span``: the
        grant is held, and nested gates pass, inside the block."""
        got = _TENANT.get()
        grant = self.acquire(nbytes, tier=tier)
        token = _ADMISSION_HELD.set(True)
        try:
            yield grant
        finally:
            _ADMISSION_HELD.reset(token)
            self.release(grant, tier=tier,
                         tenant=got[0] if got is not None else None)

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
            self.tenant_high_water = {t: n for t, n
                                      in self._tenant_use.items() if n}
            self.tenant_waits = {}


_ADMISSION = AdmissionController()


def read_admission() -> AdmissionController:
    """The process-wide read gate: the host scan's spans, the dataset
    read's file stages and the lookups' page spans all admit through it."""
    return _ADMISSION


def lookup_admission() -> AdmissionController:
    """The gate the lookups admit through: :func:`read_admission`'s."""
    return _ADMISSION
