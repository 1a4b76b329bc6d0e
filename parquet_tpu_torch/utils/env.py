"""The port's environment knobs, read through one accessor.

The port's cut of ``parquet_tpu/utils/env.py``: every knob is declared in
:data:`KNOBS` with its default and what it does, named
``PARQUET_TPU_TORCH_*``, and read through :func:`env_str` (or the typed
:func:`env_int`, :func:`env_float`, :func:`env_opt_float`,
:func:`env_bytes` and :func:`env_opt_bytes`, which parse
it as the JAX package's accessors do: a value that does not parse reads as
the default; :func:`env_bool` reads ``0``/``off``/``false``/``no`` as
off), which refuse an undeclared name.  Knobs are read at each
call, so a test can set one with ``monkeypatch.setenv``.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["KNOBS", "env_str", "env_bool", "env_int", "env_float",
           "env_opt_float", "env_bytes", "env_opt_bytes"]

#: name -> (default, what it does); "" is unset
KNOBS = {
    "PARQUET_TPU_TORCH_ROUTE": (
        "", "pins the routed scan's route: host|cpu the host scan, "
        "device|cuda the device scan (a shape the device scan refuses "
        "still takes the host scan); anything else leaves the cost model "
        "to choose (io/planner.py::route_scan)"),
    "PARQUET_TPU_TORCH_MMAP": (
        "1", "0 opens a path with pread (io/source.py::FileSource) in "
        "place of the memory map (io/source.py::as_source)"),
    "PARQUET_TPU_TORCH_PREFETCH": (
        "auto", "the read's chunk prefetcher: auto (advise over a mapped "
        "file, else the ring), advise, ring, or off "
        "(io/prefetch.py::prefetch_mode)"),
    "PARQUET_TPU_TORCH_PREFETCH_WINDOW": (
        "", "pins the prefetcher's window in bytes; unset: 8 MiB, or "
        "the auto-tuner's (io/prefetch.py::PrefetchSource)"),
    "PARQUET_TPU_TORCH_PREFETCH_DEPTH": (
        "", "pins the windows kept in flight (ring) or advised (advise) "
        "ahead of each plan's frontier; unset: 4, or the auto-tuner's"),
    "PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE": (
        "1", "0 keeps the ring's window and depth fixed; else they adapt "
        "to the consumer's stalls (io/prefetch.py::prefetch_autotune)"),
    "PARQUET_TPU_TORCH_MMAP_DROPBEHIND": (
        "0", "1: a streamed drain over a mapped file advises sequential "
        "access and releases the page cache behind its frontier, and the "
        "rest of its span when it ends (known one-shot bulk drains only; "
        "io/source.py::dropbehind_enabled)"),
    "PARQUET_TPU_TORCH_FOOTER_CACHE": (
        "256", "parsed-footer cache capacity in entries; 0 disables "
        "(io/cache.py::FOOTERS)"),
    "PARQUET_TPU_TORCH_PAGE_CACHE": (
        str(64 << 20), "decoded-page LRU capacity in bytes, the lookup's "
        "serving tier; 0 disables (io/cache.py::PAGES)"),
    "PARQUET_TPU_TORCH_NEG_LOOKUP": (
        str(4 << 20), "negative-lookup memo capacity in bytes (keys a "
        "lookup proved absent from a chunk); 0 disables (io/cache.py::NEGS)"),
    "PARQUET_TPU_TORCH_READ_BUDGET": (
        "", "one FIFO byte budget over every in-flight read span (scans, "
        "dataset reads, lookups); 0 turns admission off for every tier "
        "(utils/pool.py::read_admission)"),
    "PARQUET_TPU_TORCH_LOOKUP_BUDGET": (
        "", "the lookup tier's budget inside the read budget; unset keeps "
        "the 64 MiB lookup default, 0 turns the tier's gate off"),
    "PARQUET_TPU_TORCH_FUSED": (
        "auto", "the fused page cursor (io/fused.py) in the aggregate's "
        "exact tier and the host scan's phase 1: on pins it, off the "
        "materializing tier; auto fuses from 8 MiB of estimated decode "
        "bytes on the CPU and in the host scan, and never for an "
        "aggregate on a CUDA device (io/planner.py::choose_fused)"),
    "PARQUET_TPU_TORCH_AGG_DICT": (
        "1", "0 turns the aggregate's dictionary tier off: a fully "
        "dictionary-encoded chunk then folds through the exact tier "
        "(io/aggregate.py::_RgReader.dict_column)"),
    "PARQUET_TPU_TORCH_SCAN_BUDGET": (
        "", "the scan tier's budget (host scan spans, dataset file "
        "stages) inside the read budget; unset leaves bulk reads "
        "unbudgeted"),
    "PARQUET_TPU_TORCH_WRITE_OVERLAP": (
        "1", "the writer's encode/emit pipelining: off (0), force, or "
        "auto (anything else: overlap where the process has more than "
        "one core and a row group brings 8 MiB of input; "
        "io/writer.py::_overlap_mode)"),
    "PARQUET_TPU_TORCH_WRITE_BUFFER": (
        "", "pins the writeback buffer of a path sink in bytes (0 passes "
        "every write through); unset: 4 MiB, or the auto-tuner's "
        "(io/sink.py::write_buffer_bytes)"),
    "PARQUET_TPU_TORCH_WRITE_AUTOTUNE": (
        "1", "0 keeps the writeback buffer fixed; else it grows or "
        "shrinks with the flushes a row group earlier writers needed"),
    "PARQUET_TPU_TORCH_REMOTE_POOL": (
        "4", "idle keep-alive connections kept per remote host, shared by "
        "every source of that host (io/remote.py::HttpTransport)"),
    "PARQUET_TPU_TORCH_REMOTE_TIMEOUT": (
        "30", "seconds every socket operation of a remote request may "
        "take: a stalled server surfaces as a retryable timeout"),
    "PARQUET_TPU_TORCH_REMOTE_BREAKER": (
        "5", "consecutive connection failures that open a remote host's "
        "circuit breaker; 0 never opens it (io/remote.py::CircuitBreaker)"),
    "PARQUET_TPU_TORCH_REMOTE_BREAKER_COOLDOWN": (
        "1.0", "seconds an open circuit waits before it lets one "
        "half-open probe through"),
    "PARQUET_TPU_TORCH_REMOTE_HEDGE": (
        "auto", "the hedged remote pread: 0/off none, seconds pins the "
        "delay before the second attempt, auto the p95 of remote.pread_s "
        "(io/remote.py::hedge_delay_s)"),
    "PARQUET_TPU_TORCH_REMOTE_AUTH_RETRY": (
        "1", "credential refreshes an auth hook is asked for per request "
        "on a 401 or 403 before the error surfaces"),
    "PARQUET_TPU_TORCH_REMOTE_PARALLEL": (
        "4", "ranges a remote aggregate fetches at once "
        "(io/remote.py::parallel_pread_slots); 0 or 1 fetches them one "
        "by one"),
    "PARQUET_TPU_TORCH_S3_ENDPOINT": (
        "", "the http(s) endpoint s3://bucket/key URLs resolve against, "
        "path-style (io/remote.py::resolve_s3_url); unset, an s3:// URL "
        "raises"),
    "PARQUET_TPU_TORCH_DEBUG": (
        "0", "1 makes utils/debug.py::trace log each call of the "
        "functions it decorates, with its wall time, to stderr"),
    "PARQUET_TPU_TORCH_TRACE": (
        "", "turns span tracing on for the process (read at import) and "
        "writes the Chrome trace-event JSON to this path at exit "
        "(obs/trace.py)"),
    "PARQUET_TPU_TORCH_TRACE_SAMPLE": (
        "1", "with tracing on, keeps one operation in each block of N on "
        "its own trace track; the others park their spans in a ring kept "
        "only when the op is slow (obs/scope.py; 1 traces every op)"),
    "PARQUET_TPU_TORCH_SLOW_OP_S": (
        "", "seconds past which an operation is slow: its spans are kept "
        "and, with PARQUET_TPU_TORCH_SLOW_LOG, its record written; 0 "
        "keeps every op; unset: no tail capture"),
    "PARQUET_TPU_TORCH_SLOW_LOG": (
        "", "appends one JSON line a slow operation (name, duration, "
        "stages, its counters) to this file"),
    "PARQUET_TPU_TORCH_MEM_SOFT": (
        "0", "soft memory watermark in bytes over the resource ledger's "
        "total: crossing it shrinks the caches (obs/ledger.py); 0 off"),
    "PARQUET_TPU_TORCH_MEM_HARD": (
        "0", "hard memory watermark in bytes: while the ledger's total is "
        "at or over it, new read admissions block (utils/pool.py); 0 off"),
    "PARQUET_TPU_TORCH_SERVE_DRAIN_S": (
        "10", "seconds the serving daemon's graceful close waits for the "
        "requests in flight (serve/config.py)"),
    "PARQUET_TPU_TORCH_SERVE_RETRY_AFTER_S": (
        "1.0", "the Retry-After seconds of the serving daemon's 429 when "
        "it sheds a bulk request under hard memory pressure"),
    "PARQUET_TPU_TORCH_SERVE_MAX_BODY": (
        str(64 << 20), "the serving daemon's cap on a request body in "
        "bytes; a longer body is refused 413 before it is read"),
    "PARQUET_TPU_TORCH_FLEET_VNODES": (
        "64", "virtual nodes a fleet member places on the consistent-hash "
        "ring (serve/cluster.py::HashRing); more spread keys and files "
        "more evenly and build the ring slower"),
    "PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S": (
        "10.0", "seconds a fleet scatter-gather gives each peer's "
        "sub-request when the request carries no deadline"),
    "PARQUET_TPU_TORCH_FLEET_MARGIN_S": (
        "0.25", "seconds a fleet gather keeps out of the request's "
        "deadline to merge the peers' answers (a peer's deadline is the "
        "time left less this margin)"),
    "PARQUET_TPU_TORCH_FLEET_HEDGE_S": (
        "", "seconds before a slow peer's sub-request is hedged by a "
        "local run of its shard; unset: the remote hedge's adaptive "
        "delay (io/remote.py::hedge_delay_s); 0 turns hedging off"),
    "PARQUET_TPU_TORCH_FLEET_CAS_TTL_S": (
        "30.0", "age in seconds after which a manifest commit's claim "
        "file left by a crashed committer may be broken "
        "(io/manifest.py::cas_commit_local)"),
    "PARQUET_TPU_TORCH_FLEET_CAS_RETRIES": (
        "8", "times a manifest commit reads and mutates again after the "
        "commit arbiter reports a rival's version "
        "(io/manifest.py::commit_manifest)"),
    "PARQUET_TPU_TORCH_TRACE_DIR": (
        "", "the directory utils/debug.py::profiler_trace writes its "
        "Chrome trace into when the caller names none; unset: no trace"),
}


def env_str(name: str) -> str:
    """The knob's value, or its default when unset or empty."""
    if name not in KNOBS:
        raise KeyError(f"{name} is not a declared knob of parquet_tpu_torch")
    return os.environ.get(name) or KNOBS[name][0]


_FALSEY = ("0", "off", "false", "no")


def env_bool(name: str) -> bool:
    """The knob as a switch: off where its value is one of
    ``0``/``off``/``false``/``no`` (any case), else on."""
    return env_str(name).lower() not in _FALSEY


def _parsed(name: str) -> Optional[int]:
    try:
        return int(env_str(name))
    except ValueError:
        pass
    try:
        return int(KNOBS[name][0])  # an unparsable value reads as unset
    except ValueError:
        return None


def env_int(name: str) -> int:
    """The knob as an int (0 where it and its default are unset)."""
    got = _parsed(name)
    return 0 if got is None else got


def env_float(name: str) -> float:
    """The knob as a float (its default where it does not parse)."""
    try:
        return float(env_str(name))
    except ValueError:
        return float(KNOBS[name][0] or 0.0)


def env_opt_float(name: str) -> Optional[float]:
    """The knob as a float, or None where it is unset or does not parse."""
    v = env_str(name)
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def env_bytes(name: str) -> int:
    """The knob as a byte count, at least 0."""
    return max(0, env_int(name))


def env_opt_bytes(name: str) -> Optional[int]:
    """The knob as a byte count at least 0, or None where it is unset."""
    got = _parsed(name)
    return None if got is None else max(0, got)
