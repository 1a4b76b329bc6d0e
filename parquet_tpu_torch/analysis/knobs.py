"""The knob registry: every ``PARQUET_TPU_TORCH_*`` environment variable
the port reads, declared once with its name, type, default and what it
does.

Pure data: this module imports nothing but ``utils.env.declare`` and runs
at the first accessor call.  The README's table of the port's knobs is
generated from it (``python -m parquet_tpu_torch analyze --knobs-md``),
and lint rule PT002 refuses an ``os.environ`` read around the accessors
and an accessor call that names an undeclared knob or reads one with
another type's accessor.

A default here is what the accessor returns for an unset or unparsable
value; a site may lay a policy over it (an unset
``PARQUET_TPU_TORCH_LOOKUP_BUDGET`` keeps the 64 MiB lookup default
inside ``utils/pool.py::AdmissionController``), and that policy stays
with the site.
"""

from ..utils.env import declare

# ------------------------------------------------------------- read / route
declare("PARQUET_TPU_TORCH_ROUTE", "str", "",
        "pins the routed scan's route: host|cpu the host scan, "
        "device|cuda the device scan (a shape the device scan refuses "
        "still takes the host scan); anything else leaves the cost model "
        "to choose (io/planner.py::route_scan)")
declare("PARQUET_TPU_TORCH_READ_BUDGET", "opt_bytes", None,
        "one FIFO byte budget over every in-flight read span (scans, "
        "dataset reads, lookups); 0 turns admission off for every tier "
        "(utils/pool.py::read_admission)")
declare("PARQUET_TPU_TORCH_LOOKUP_BUDGET", "opt_bytes", None,
        "the lookup tier's budget inside the read budget; unset keeps "
        "the 64 MiB lookup default, 0 turns the tier's gate off")
declare("PARQUET_TPU_TORCH_SCAN_BUDGET", "opt_bytes", None,
        "the scan tier's budget (host scan spans, dataset file stages) "
        "inside the read budget; unset leaves bulk reads unbudgeted")

# ------------------------------------------------------------------- caches
declare("PARQUET_TPU_TORCH_FOOTER_CACHE", "int", 256,
        "parsed-footer cache capacity in entries; 0 disables "
        "(io/cache.py::FOOTERS)")
declare("PARQUET_TPU_TORCH_CHUNK_CACHE", "bytes", 256 << 20,
        "decoded whole-chunk LRU capacity in bytes, the lookup's tier for "
        "chunks without a page index; 0 disables (io/cache.py::CHUNKS)")
declare("PARQUET_TPU_TORCH_PAGE_CACHE", "bytes", 64 << 20,
        "decoded-page LRU capacity in bytes, the lookup's serving tier; "
        "0 disables (io/cache.py::PAGES)")
declare("PARQUET_TPU_TORCH_NEG_LOOKUP", "bytes", 4 << 20,
        "negative-lookup memo capacity in bytes (keys a lookup proved "
        "absent from a chunk); 0 disables (io/cache.py::NEGS)")

# ------------------------------------------------------------------- lookup
declare("PARQUET_TPU_TORCH_LOOKUP_KEY_SHARD", "int", 0,
        "minimum unique keys per shard before a large lookup batch fans "
        "its row groups' page search, reads, match and gather across pool "
        "workers (the reference's 1024 shards); 0, the default, disables "
        "sharding: on an H100 host the shards ran slower than one thread "
        "(io/lookup.py::_dispatch_probes)")

# ---------------------------------------------------------- memory pressure
declare("PARQUET_TPU_TORCH_MEM_SOFT", "bytes", 0,
        "soft memory watermark in bytes over the resource ledger's "
        "total: crossing it shrinks the caches (obs/ledger.py); 0 off")
declare("PARQUET_TPU_TORCH_MEM_HARD", "bytes", 0,
        "hard memory watermark in bytes: while the ledger's total is at "
        "or over it, new read admissions block (utils/pool.py); 0 off")

# ------------------------------------------------------- sources / prefetch
declare("PARQUET_TPU_TORCH_MMAP", "bool", True,
        "off opens a path with pread (io/source.py::FileSource) in place "
        "of the memory map (io/source.py::as_source)")
declare("PARQUET_TPU_TORCH_MMAP_DROPBEHIND", "bool", False,
        "a streamed drain over a mapped file advises sequential access "
        "and releases the page cache behind its frontier, and the rest "
        "of its span when it ends (known one-shot bulk drains only; "
        "io/source.py::dropbehind_enabled)")
declare("PARQUET_TPU_TORCH_PREFETCH", "str", "auto",
        "the read's chunk prefetcher: auto (advise over a mapped file, "
        "else the ring), advise, ring, or off "
        "(io/prefetch.py::prefetch_mode)")
declare("PARQUET_TPU_TORCH_PREFETCH_WINDOW", "opt_bytes", None,
        "pins the prefetcher's window in bytes; unset: 8 MiB, or the "
        "auto-tuner's (io/prefetch.py::PrefetchSource)")
declare("PARQUET_TPU_TORCH_PREFETCH_DEPTH", "opt_int", None,
        "pins the windows kept in flight (ring) or advised (advise) "
        "ahead of each plan's frontier; unset: 4, or the auto-tuner's")
declare("PARQUET_TPU_TORCH_PREFETCH_AUTOTUNE", "bool", True,
        "off keeps the ring's window and depth fixed; on, they adapt to "
        "the consumer's stalls (io/prefetch.py::autotune_enabled)")

# -------------------------------------------------------------------- write
declare("PARQUET_TPU_TORCH_WRITE_OVERLAP", "str", "1",
        "the writer's encode/emit pipelining: off (0), force, or auto "
        "(anything else: overlap where the process has more than one "
        "core and a row group brings 8 MiB of input; "
        "io/writer.py::_overlap_mode)")
declare("PARQUET_TPU_TORCH_WRITE_BUFFER", "opt_bytes", None,
        "pins the writeback buffer of a path sink in bytes (0 passes "
        "every write through); unset: 4 MiB, or the auto-tuner's "
        "(io/sink.py::write_buffer_bytes)")
declare("PARQUET_TPU_TORCH_WRITE_AUTOTUNE", "bool", True,
        "0 keeps the writeback buffer fixed; else it grows or shrinks "
        "with the flushes a row group earlier writers needed")

# -------------------------------------------------------------- aggregation
declare("PARQUET_TPU_TORCH_FUSED", "str", "auto",
        "the fused page cursor (io/fused.py) in the aggregate's exact "
        "tier and the host scan's phase 1: on pins it, off the "
        "materializing tier; auto fuses from 8 MiB of estimated decode "
        "bytes on the CPU and in the host scan, and never for an "
        "aggregate on a CUDA device (io/planner.py::choose_fused)")
declare("PARQUET_TPU_TORCH_AGG_DICT", "bool", True,
        "0 turns the aggregate's dictionary tier off: a fully "
        "dictionary-encoded chunk then folds through the exact tier "
        "(io/aggregate.py::_RgReader.dict_column)")

# ------------------------------------------------------------------- remote
declare("PARQUET_TPU_TORCH_REMOTE_POOL", "int", 4,
        "idle keep-alive connections kept per remote host, shared by "
        "every source of that host (io/remote.py::HttpTransport)")
declare("PARQUET_TPU_TORCH_REMOTE_TIMEOUT", "float", 30.0,
        "seconds every socket operation of a remote request may take: a "
        "stalled server surfaces as a retryable timeout")
declare("PARQUET_TPU_TORCH_REMOTE_BREAKER", "int", 5,
        "consecutive connection failures that open a remote host's "
        "circuit breaker; 0 never opens it (io/remote.py::CircuitBreaker)")
declare("PARQUET_TPU_TORCH_REMOTE_BREAKER_COOLDOWN", "float", 1.0,
        "seconds an open circuit waits before it lets one half-open "
        "probe through")
declare("PARQUET_TPU_TORCH_REMOTE_HEDGE", "str", "auto",
        "the hedged remote pread: 0/off none, seconds pins the delay "
        "before the second attempt, auto the p95 of remote.pread_s "
        "(io/remote.py::hedge_delay_s)")
declare("PARQUET_TPU_TORCH_REMOTE_AUTH_RETRY", "int", 1,
        "credential refreshes an auth hook is asked for per request on a "
        "401 or 403 before the error surfaces")
declare("PARQUET_TPU_TORCH_REMOTE_PARALLEL", "int", 4,
        "ranges a remote aggregate fetches at once "
        "(io/remote.py::parallel_pread_slots); 0 or 1 fetches them one "
        "by one")
declare("PARQUET_TPU_TORCH_S3_ENDPOINT", "str", "",
        "the http(s) endpoint s3://bucket/key URLs resolve against, "
        "path-style (io/remote.py::resolve_s3_url); unset, an s3:// URL "
        "raises")

# ------------------------------------------------------------------ serving
declare("PARQUET_TPU_TORCH_SERVE_DRAIN_S", "float", 10.0,
        "seconds the serving daemon's graceful close waits for the "
        "requests in flight (serve/config.py)")
declare("PARQUET_TPU_TORCH_SERVE_RETRY_AFTER_S", "float", 1.0,
        "the Retry-After seconds of the serving daemon's 429 when it "
        "sheds a bulk request under hard memory pressure")
declare("PARQUET_TPU_TORCH_SERVE_MAX_BODY", "bytes", 64 << 20,
        "the serving daemon's cap on a request body in bytes; a longer "
        "body is refused 413 before it is read")

# -------------------------------------------------------------------- fleet
declare("PARQUET_TPU_TORCH_FLEET_VNODES", "int", 64,
        "virtual nodes a fleet member places on the consistent-hash ring "
        "(serve/cluster.py::HashRing); more spread keys and files more "
        "evenly and build the ring slower")
declare("PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S", "float", 10.0,
        "seconds a fleet scatter-gather gives each peer's sub-request "
        "when the request carries no deadline")
declare("PARQUET_TPU_TORCH_FLEET_MARGIN_S", "float", 0.25,
        "seconds a fleet gather keeps out of the request's deadline to "
        "merge the peers' answers (a peer's deadline is the time left "
        "less this margin)")
declare("PARQUET_TPU_TORCH_FLEET_HEDGE_S", "opt_float", None,
        "seconds before a slow peer's sub-request is hedged by a local "
        "run of its shard; unset: the remote hedge's adaptive delay "
        "(io/remote.py::hedge_delay_s); 0 turns hedging off")
declare("PARQUET_TPU_TORCH_FLEET_CAS_TTL_S", "float", 30.0,
        "age in seconds after which a manifest commit's claim file left "
        "by a crashed committer may be broken "
        "(io/manifest.py::cas_commit_local)")
declare("PARQUET_TPU_TORCH_FLEET_CAS_RETRIES", "int", 8,
        "times a manifest commit reads and mutates again after the "
        "commit arbiter reports a rival's version "
        "(io/manifest.py::commit_manifest)")

# ------------------------------------------------------------ observability
declare("PARQUET_TPU_TORCH_TRACE", "str", "",
        "turns span tracing on for the process (read at import) and "
        "writes the Chrome trace-event JSON to this path at exit "
        "(obs/trace.py)")
declare("PARQUET_TPU_TORCH_TRACE_SAMPLE", "int", 1,
        "with tracing on, keeps one operation in each block of N on its "
        "own trace track; the others park their spans in a ring kept "
        "only when the op is slow (obs/scope.py; 1 traces every op)")
declare("PARQUET_TPU_TORCH_SLOW_OP_S", "opt_float", None,
        "seconds past which an operation is slow: its spans are kept "
        "and, with PARQUET_TPU_TORCH_SLOW_LOG, its record written; 0 "
        "keeps every op; unset: no tail capture")
declare("PARQUET_TPU_TORCH_SLOW_LOG", "str", "",
        "appends one JSON line a slow operation (name, duration, stages, "
        "its counters) to this file")
declare("PARQUET_TPU_TORCH_TRACE_DIR", "str", "",
        "the directory utils/debug.py::profiler_trace writes its Chrome "
        "trace into when the caller names none; unset: no trace")
declare("PARQUET_TPU_TORCH_DEBUG", "bool", False,
        "makes utils/debug.py::trace log each call of the functions it "
        "decorates, with its wall time, to stderr")

# ------------------------------------------------------- the lock checker
declare("PARQUET_TPU_TORCH_LOCKCHECK", "bool", False,
        "read at import: every lock of utils/locks.py records each "
        "thread's held locks, the process's lock-order graph, its cycles "
        "(potential deadlocks) and blocking calls made under a lock; "
        "off, the factories return plain threading locks")
declare("PARQUET_TPU_TORCH_LOCKCHECK_REPORT", "str", "",
        "writes the lock checker's JSON report (graph and findings) to "
        "this path at exit")
