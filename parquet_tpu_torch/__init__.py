"""parquet_tpu_torch: the PyTorch/CUDA port of parquet_tpu.

It reads columns of every physical type (BOOLEAN, INT32, INT64, INT96,
FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY), flat or nested (lists,
maps and structs at any depth, assembled on the device), in PLAIN,
dictionary, RLE, DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY,
DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT pages (v1 and v2; UNCOMPRESSED,
GZIP, SNAPPY, ZSTD, LZ4_RAW, LZ4, BROTLI) into tensors on a CUDA device,
through the hand-written kernels of ``csrc/``; the chunks its device
route refuses decode on the host and are counted in ``HOST_ROUTE``, and
the chunks the Python walk plans in place of the C++ planner in
``PLAN_ROUTE``.  It looks rows up by a key of any flat column, in one
file or a dataset (``find_rows``, with a page cache, a negative-lookup
memo and a footer cache shared by the process: ``cache_stats``,
``clear_caches``), scans a file with
predicate pushdown on the card (``scan_filtered_device``: the planner's
statistics, page-index and bloom stages, then decode, filter and
compaction on the device) or on the host (``scan_expr``, predicate trees
over several columns, late-materialized), lets the planner's cost model
choose between the two (``scan``), and writes such files.  Every read,
scan and lookup takes a ``FaultPolicy`` (retries, a deadline, and
``on_corrupt="skip_row_group"``, which drops a corrupt row group and
accounts for it in a ``ReadReport``); its failures are located
``ReadError`` errors.  It streams a file or a dataset in bounded batches
(``iter_batches``: each batch holds only the pages that cover it, each
pull of pages one device decode of that span, on the card or, with
``device="cpu"``, on the CPU), and opens files with the JAX package's
``ReadOptions``, whose ``verify_crc`` holds every page read to the CRC32
its header carries (the writer writes one, ``WriterOptions.write_crc``).
Above the columns: dataclasses (``schema_of``, ``TypedWriter``,
``TypedReader``, whose ``read(n)`` drains the stream on the card), records
of any nesting (``write_rows``, ``read_rows``, ``FileRows`` with
``seek_to_row``, Dremel's ``deconstruct``/``reconstruct``), and sorted
files (``SortingWriter``, which spills sorted runs, and ``merge_files`` /
``iter_merged``, the k-way merge of sorted files, each run streamed from
the card).  It answers aggregates (``ParquetFile.aggregate``,
``Dataset.aggregate``: ``count``, ``min_``, ``max_``, ``sum_``,
``sum_sq``, ``avg``, ``variance``, ``count_distinct``, ``top_k``,
optionally grouped) from footer statistics and page-index zone maps
where they prove the answer, and otherwise decodes the dictionary pages
and the contended spans on the card and folds there (``AGG`` counts
where the folds ran); page encodings dispatch through a registry
(``register_encoding``).  It writes durably: a path is written to a temp
file beside it and renamed over it at close, after an fsync
(``WriterOptions.atomic_commit``), through a pipelined encode and emit
and a coalescing ``BufferedSink`` (``ParquetWriter.write_stats``); the
columns may be tensors on the card.  ``FaultInjectingSink`` and
``crash_consistency_check`` crash a write at chosen bytes, and
``verify_file`` walks a file's envelope, pages, CRCs, page index and
bloom filters, and with ``decode=True`` decodes every chunk on the card.
A table is a directory of parts under one manifest: ``DatasetWriter``
ingests and commits a snapshot atomically, ``open_table`` pins one (its
zone maps drop a part from a scan or an aggregate without opening it, and
its reads run on the card), ``compact_table`` and ``BackgroundCompactor``
merge parts on the card, and ``recover_table`` sweeps what a crash left
(``SharedCrashState``, ``table_crash_check``).  Every read, stream,
lookup, scan, aggregate and ``Dataset`` opens ``http(s)://`` and
``s3://`` URLs too (``HttpSource``, ``ObjectStoreSource``): hedged
preads, per-host circuit breakers, auth hooks, prefix listings, and a
remote aggregate that fetches its ranges at once; the loopback
``LocalRangeServer`` and ``FaultInjectingRemoteTransport`` test them.
Every read, scan, lookup, aggregate, write and table commit moves the
JAX package's meters (``metrics_snapshot``, ``render_prometheus``), runs
in an ``op_scope`` of its own unless the caller opened one (exact per-op
counters across worker threads), keeps its bytes in the resource ledger
(``ledger_snapshot``, the ``PARQUET_TPU_TORCH_MEM_SOFT``/``_HARD``
watermarks), and with ``enable_tracing`` writes Chrome trace spans;
``start_metrics_server`` serves ``/metrics``, ``/debugz`` and
``/healthz``.  ``Server`` is the serving daemon: HTTP lookups, scans,
aggregates and writes of hosted datasets, answered from the card, with
tenants (``TenantSpec``, ``tenant_context``: priority classes, budgets and
weights at the read gate, request rates, bearer tokens, pinned pages) and
a bulk tier shed under hard memory pressure (``ServeConfig``).  Where
pyarrow is installed, a read converts to a ``pyarrow.Table``
(``Table.to_arrow``; ``Table`` is the read's ``ColumnSet``) and
``write_table`` takes one (``schema_from_arrow``); the serving daemon's
Arrow streams and ingest need it too.  ``counters``
counts the read's events, ``utils/debug.py::profiler_trace`` records a
``torch.profiler`` trace of a read with its regions named, and
``print_schema``/``print_file``/``print_pages`` dump a file as text.

    import parquet_tpu_torch as pq
    pq.write_table({"x": np.arange(10)}, "x.parquet")
    table = pq.ParquetFile("x.parquet").read()            # on the card
    table = pq.ParquetFile("x.parquet").read(device="cpu")
    rows = pq.scan_filtered_device(pq.ParquetFile("x.parquet"), "x",
                                   lo=2, hi=5)                 # on the card
    rows = pq.scan_expr(pq.ParquetFile("x.parquet"),
                        (col("x") >= 2) & ~(col("x") == 4))    # on the host
    rows = pq.scan(pq.ParquetFile("x.parquet"), "x", lo=2, hi=5)  # routed
    table = pq.ParquetFile("http://host/x.parquet").read()  # remote
    table = pq.Dataset("s3://bucket/parts/").read()     # listed prefix
    table = pq.Dataset("parts/*.parquet").read()            # every card
    table = pq.Dataset("parts/*.parquet").read(["cpu"] * 8)  # 8 shards
    rows = pq.Dataset("parts/*.parquet").scan("x", values=[3, 7])
    hits = pq.ParquetFile("x.parquet").find_rows("x", [3, 7])  # on the card
    hits = pq.Dataset("parts/*.parquet").find_rows("x", [3, 7])
    report = pq.ReadReport()
    table = pq.ParquetFile("x.parquet").read(
        policy=pq.FaultPolicy(on_corrupt="skip_row_group"), report=report)
    for batch in pq.ParquetFile("x.parquet").iter_batches(batch_rows=4096):
        ...                                   # {path: Column} on the card
    for batch in pq.iter_batches(pq.ParquetFile("x.parquet"),
                                 batch_rows=4096, device="cpu"):
        ...
    for batch in pq.Dataset("parts/*.parquet").iter_batches():
        ...
    f = pq.ParquetFile("x.parquet", options=pq.ReadOptions(verify_crc=True))
    pq.write_objects(events, "ev.parquet")            # dataclass instances
    for batch in iter(lambda: pq.TypedReader("ev.parquet", Event).read(4096),
                      []):
        ...
    pq.merge_files(["a.parquet", "b.parquet"], [pq.SortingColumn("k")],
                   "ab.parquet")
    res = pq.ParquetFile("x.parquet").aggregate(
        [pq.count(), pq.sum_("x"), pq.avg("x")], where=col("x") >= 2)
    res = pq.Dataset("parts/*.parquet").aggregate(
        [pq.max_("x")], group_by="k", device="cpu")
    w = pq.write_table({"x": table["x"].values}, "y.parquet")  # CUDA input
    print(w.write_stats.as_dict())
    assert pq.verify_file("y.parquet", decode=True).ok      # on the card
    with pq.DatasetWriter("tbl", schema, [pq.SortingColumn("x")]) as w:
        w.write({"x": pq.ColumnData(np.arange(10))}, 10)    # one commit
    rows = pq.open_table("tbl").scan("x", lo=2, hi=5)       # zone maps
    pq.compact_table("tbl")                                  # on the card
"""

from .algebra.expr import And, Col, Expr, Not, Or, col
from .dataset import Dataset, expand_paths
from .dataset_writer import (BackgroundCompactor, DatasetWriter,
                             compact_table, open_table, recover_table)
from .io.manifest import Manifest, ManifestEntry, read_manifest
from .errors import (ColumnTooDeepError, CorruptedError, DeadlineError,
                     MissingRootColumnError, ReadError, ReadIOError,
                     RemoteCircuitOpenError, RemoteError,
                     RemoteTerminalError, RemoteThrottledError,
                     RemoteTransientError, ShortReadError,
                     TooManyRowGroupsError, WriteError)
from .algebra.aggregate import (AggExpr, avg, count, count_distinct, max_,
                                min_, sum_, sum_sq, top_k, variance)
from .io.aggregate import (AGG, AggregateResult, decode_agg_state,
                           encode_agg_state, reset_agg)
from .io.fused import FUSED, reset_fused
from .ops.encodings import (DictIndices, EncodingSpec, register_encoding,
                            registered_encodings)
from .io.faults import (FaultInjectingRemoteTransport, FaultInjectingSink,
                        FaultInjectingSource, FaultPolicy,
                        InjectedWriterCrash, LocalRangeServer, PolicySource,
                        ReadReport, SharedCrashState, SinkFaultStats,
                        crash_consistency_check, table_crash_check)
from .io.remote import (CircuitBreaker, HttpSource, HttpTransport,
                        ObjectStoreSource)
from . import obs
from .obs import (OpScope, current_op, debugz_snapshot, disable_tracing,
                  enable_tracing, flush_trace, ledger_snapshot,
                  metrics_delta, metrics_snapshot, op_scope,
                  pool_wait_seconds, render_prometheus, reset_metrics,
                  start_metrics_server, trace_span)
from .io.integrity import IntegrityIssue, IntegrityReport, verify_file
from .io.sink import (AtomicFileSink, BufferedSink, FileSink, Sink,
                      WriteStats)
from .io.cache import CacheStats, cache_stats, clear_caches
from .io.column import Column
from .io.lookup import KeyHits, LookupResult, find_rows
from .io.planner import (FUSED_AUTO_MIN_BYTES, ROUTE_REFUSALS, CostInputs,
                         RouteDecision, RouteHistory, ScanPlan, ScanPlanner,
                         choose_fused, choose_route,
                         device_route_supported, reset_route_refusals,
                         route_history, route_scan)
from .io.prefetch import PrefetchSource, ReadStats
from .io.reader import ColumnSet, ParquetFile, ReadOptions, RowGroupReader
from .io.search import (find, pages_overlapping, plan_scan, prune_row_group,
                        read_row_range)
from .io.source import (MmapSource, PreloadedSource, RetryingSource,
                        Source)
from .io.stream import STREAM, iter_batches, reset_stream
from .io.writer import (ColumnData, ParquetWriter, WriterOptions,
                        schema_from_arrow, write_table)
from .ops.kernels import LAUNCHES, reset_launches
from .parallel.device_reader import (HOST_ROUTE, PIPELINE, PLAN_ROUTE,
                                     reset_host_route, reset_pipeline,
                                     reset_plan_route)
from .parallel.host_scan import (decoded_scan, expr_mask, merge_scan_results,
                                 scan, scan_expr, scan_files, scan_filtered,
                                 scan_filtered_device, scan_filtered_sharded,
                                 stage_scan)
from .parallel.mesh import (MESH, ShardedTable, dataset_process_shard,
                            decode_step_sharded, default_mesh,
                            read_dataset_device, read_table_sharded,
                            reset_mesh)
from .schema.schema import (Schema, group, leaf, list_of, map_of, message,
                            optional, repeated)
from .algebra import (SortingColumn, SortingWriter, TableBuffer,
                      convert_table, iter_merged, merge_files,
                      merge_row_groups)
from .typed import (TypedReader, TypedWriter, read_objects, read_pytree,
                    schema_of, write_objects)
from .rows import (FileRows, Row, RowBuilder, Value, copy_rows, deconstruct,
                   read_rows, reconstruct, write_rows)
from .utils.debug import counters
from .utils.pool import TenantSpec, tenant_context
from .utils.printer import print_file, print_pages, print_schema
from .serve import ServeConfig, Server

#: the JAX package's name for a read's result (a ``ColumnSet``)
Table = ColumnSet

__all__ = ["Column", "ParquetFile", "WriterOptions", "write_table",
           "LAUNCHES", "reset_launches", "HOST_ROUTE", "reset_host_route",
           "PLAN_ROUTE", "reset_plan_route", "PIPELINE", "reset_pipeline",
           "plan_scan", "stage_scan", "decoded_scan", "scan_filtered_device",
           "Dataset", "expand_paths", "read_table", "ShardedTable",
           "default_mesh", "read_table_sharded", "decode_step_sharded",
           "read_dataset_device", "dataset_process_shard", "MESH",
           "reset_mesh", "ROUTE_REFUSALS", "reset_route_refusals", "scan",
           "scan_expr", "scan_filtered", "scan_files", "merge_scan_results",
           "scan_filtered_sharded", "expr_mask", "CostInputs",
           "RouteDecision", "RouteHistory", "choose_route", "route_history",
           "route_scan", "device_route_supported", "CacheStats",
           "cache_stats", "clear_caches", "KeyHits", "LookupResult",
           "find_rows", "Expr", "Col", "col", "And", "Or", "Not",
           "ScanPlanner", "ScanPlan", "ParquetWriter", "ColumnData",
           "schema_of", "Schema", "group", "leaf", "list_of", "map_of",
           "message", "optional", "repeated", "MmapSource", "Source",
           "RowGroupReader", "CorruptedError", "read_row_range",
           "pages_overlapping", "find", "FaultPolicy", "ReadReport",
           "FaultInjectingSource", "PolicySource", "RetryingSource",
           "PrefetchSource", "ReadStats", "ReadError", "ReadIOError",
           "DeadlineError", "ShortReadError", "iter_batches", "ReadOptions",
           "ColumnSet", "STREAM", "reset_stream", "SortingColumn",
           "SortingWriter", "TableBuffer", "convert_table", "iter_merged",
           "merge_files", "merge_row_groups", "TypedReader", "TypedWriter",
           "read_objects", "read_pytree", "write_objects", "FileRows", "Row",
           "RowBuilder", "Value", "copy_rows", "deconstruct", "read_rows",
           "reconstruct", "write_rows", "AggExpr", "avg", "count",
           "count_distinct", "max_", "min_", "sum_", "sum_sq", "top_k",
           "variance", "AggregateResult", "encode_agg_state",
           "decode_agg_state", "AGG", "reset_agg", "FUSED", "reset_fused",
           "choose_fused", "FUSED_AUTO_MIN_BYTES", "DictIndices",
           "EncodingSpec", "register_encoding", "registered_encodings",
           "WriteError", "ColumnTooDeepError", "MissingRootColumnError",
           "TooManyRowGroupsError", "Sink", "FileSink", "AtomicFileSink",
           "BufferedSink", "WriteStats", "FaultInjectingSink",
           "InjectedWriterCrash", "SinkFaultStats",
           "crash_consistency_check", "verify_file", "IntegrityReport",
           "IntegrityIssue", "DatasetWriter", "open_table", "recover_table",
           "compact_table", "BackgroundCompactor", "Manifest",
           "ManifestEntry", "read_manifest", "SharedCrashState",
           "table_crash_check", "Table", "schema_from_arrow", "counters",
           "print_schema", "print_file", "print_pages", "prune_row_group",
           "RemoteError", "RemoteTransientError", "RemoteThrottledError",
           "RemoteTerminalError", "RemoteCircuitOpenError",
           "FaultInjectingRemoteTransport", "LocalRangeServer",
           "CircuitBreaker", "HttpSource", "HttpTransport",
           "ObjectStoreSource", "PreloadedSource", "metrics_snapshot",
           "metrics_delta", "reset_metrics", "obs", "OpScope", "op_scope",
           "current_op", "debugz_snapshot", "enable_tracing",
           "disable_tracing", "flush_trace", "trace_span",
           "ledger_snapshot", "pool_wait_seconds", "render_prometheus",
           "start_metrics_server", "TenantSpec", "tenant_context",
           "ServeConfig", "Server"]


def read_table(source, columns=None, device="cuda") -> dict:
    """Open ``source`` and read its selected columns (all by default) on
    ``device``: ``ParquetFile(source).read(columns, device)``."""
    with ParquetFile(source) as pf:
        return pf.read(columns=columns, device=device)
