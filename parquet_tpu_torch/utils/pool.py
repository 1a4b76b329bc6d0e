"""The process-wide worker pool of the multi-file reads.

The port's cut of ``parquet_tpu/utils/pool.py``: :func:`shared_pool`, one
``ThreadPoolExecutor`` a process, built at first use; :func:`submit`,
which marks its work so that :func:`in_shared_pool` is true inside it;
and :func:`map_in_order`, which fans a function out on the pool and
returns its results in input order.  Work nested inside a pool worker
runs serially on that worker: a worker that waits on futures no free
worker can run would wedge the pool.  The tenant and admission machinery
(``AdmissionController``, ``read_admission``) and the pool's metrics and
trace spans belong to a later slice.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..ops.host import available_cpus

_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_IN_POOL = threading.local()


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


def submit(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the shared pool, marked so that
    :func:`in_shared_pool` is true while it runs; returns its future."""
    return shared_pool().submit(_run_pooled, fn, args, kwargs)


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
