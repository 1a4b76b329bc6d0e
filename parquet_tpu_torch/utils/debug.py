"""Counters, call tracing and profiler regions.

The port of ``parquet_tpu/utils/debug.py``.  :data:`counters` counts the
read's events under the JAX package's names: ``files_opened``,
``dict_pages_decoded`` and ``data_pages_decoded`` (pages decoded on the
host), ``bytes_h2d`` (the bytes of every staging batch copied to a card;
none on the CPU, where the host buffer is the device's),
``chunks_device_decoded``, ``chunks_host_fallback`` and the high water
``stage_concurrency_peak``; the last three as ``device_reader.PIPELINE``
counts them in a read.  The JAX package's other names count
routes the port does not have (a Pallas compile fallback, host routes for
dictionary runs and delta miniblocks on a CPU backend, whole-chunk host
fast paths), so they stay at 0 here.

:func:`trace` logs a function's calls and wall time to stderr where
``PARQUET_TPU_TORCH_DEBUG`` is set.  :func:`profiler_trace` records a
``torch.profiler`` trace (the card's kernels too where CUDA is available)
into a directory as a Chrome trace, and :func:`annotate` names a region
in it: the device read names ``pq.prepare_chunk``,
``pq.prepare_chunks_batched`` and ``pq.decode_staged:<value kind>``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .env import env_bool, env_str

__all__ = ["Counters", "counters", "trace", "profiler_trace", "annotate"]


class Counters:
    """Named counters, safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = defaultdict(int)

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] += by

    def high_water(self, name: str, value: int) -> None:
        """Record a peak (as the most chunks staged at once)."""
        with self._lock:
            if value > self._counts.get(name, 0):
                self._counts[name] = value

    def get(self, name: str) -> int:
        return self._counts.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


counters = Counters()


def trace(fn):
    """``fn`` with each call's wall time logged to stderr where
    ``PARQUET_TPU_TORCH_DEBUG`` is set when it is decorated; else ``fn``
    itself."""
    if not env_bool("PARQUET_TPU_TORCH_DEBUG"):
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            print(f"[parquet-tpu-torch] {fn.__qualname__} {dt:.3f}ms",
                  file=sys.stderr)

    return wrapper


@contextlib.contextmanager
def _chrome_trace(out_dir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the read prepares chunks on its pipeline's worker threads, which the
    # profiler records only where asked to record every thread
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def profiler_trace(out_dir: Optional[str] = None):
    """A context that records a ``torch.profiler`` trace of its block (host
    activity, and the card's where CUDA is available) and writes it into
    ``out_dir`` (default ``PARQUET_TPU_TORCH_TRACE_DIR``) as a Chrome trace
    ``trace.<pid>.<ns>.json``; the profiler is the context's value.  With
    neither set it records nothing (a ``nullcontext``), so a caller may
    wrap a region unconditionally::

        with profiler_trace("/tmp/pq_trace"):
            cols = pf.read(device="cuda")
    """
    out_dir = out_dir or env_str("PARQUET_TPU_TORCH_TRACE_DIR") or None
    if not out_dir:
        return contextlib.nullcontext()
    return _chrome_trace(out_dir)


def annotate(name: str):
    """A named region of a :func:`profiler_trace`
    (``torch.profiler.record_function``); costs little outside one."""
    return record_function(name)
