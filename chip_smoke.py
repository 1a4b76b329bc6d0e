"""Drive parquet_tpu_torch's device read, batched point lookups, device
scan, multi-file and sharded reads, streamed reads, typed reads, rows,
merge and sort, aggregation, durable writes from the card, writable
tables, the read's counters, traces and row-group pruning, and the
serving daemon on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0] [--rows 8388608] [--kernel-values 8388608]
                          [--lookup-rows 8388608] [--lineitem-rows 8388608]
                          [--enc-rows 2097152] [--nested-n 8000000]
                          [--nest-mix-rows 1048576] [--scan-rows 8388608]
                          [--out DIR]
    python3 chip_smoke.py --summarize LOG

Phases, each fatal on failure:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the CUDA kernels of ``parquet_tpu_torch/csrc`` compile with nvcc
   and its host C++ with c++ (one process per source, started together);
3. kernels against their plain PyTorch versions, on the card, bit for bit:
   ``unpack_bits_dense`` at every width 1..32, ``dict_unpack_gather`` at
   w in {1, 8, 10} over int32/int64/float32/float64 dictionaries of 2, 200
   and 1024 entries, ``bloom_check`` (one filter) at n in {32,768;
   1,048,576; 8,388,608} hashes x z in {1; 1,024; 65,536; 4,194,304}
   filter blocks, and ``bloom_check_segments`` (many filters, one launch)
   on the lookup's layout (8 filters of 65,536 blocks, 65,536 hashes each)
   and on 64 filters of 1 to 65,536 blocks with uneven batches, some
   empty (both bloom probes also against the numpy host probe of each
   filter), with median device times;
3b. the host link: 256 MiB copied from pinned and from pageable memory,
   best of 5 (``{"h2d_peak": ...}``, GB/s beside the card's name and
   power limit); the first pinned allocation must show as a new block of
   the host caching allocator;
4. read path: the port's writer makes a 5-column file from ``--seed``
   (1,048,576-row row groups, 1 MiB pages, UNCOMPRESSED), and
   ``ParquetFile(path).read(device="cuda")`` decodes it once cold and
   three times warm; every column must equal the generated arrays and each
   of the read's kernels must be launched during the reads, whose launches
   are also counted by the column being decoded (the counts must add up
   to the wrappers'); then the time of each column alone and of each
   phase of the serial read (host prescan, the staging batch's host fill
   and its copy, device decode).  Each read is the pipelined one
   ``read`` runs (two workers stage later chunks, each chunk in one
   pinned copy), each of the three warm reads is checked, and the last
   must equal the serial read (``workers=0``) bit for bit; so must every
   read of phases 4b-4d and the fixture's.  Lineitem is also read with
   each staging worker's page decompression on 1 thread and on the
   default (the cores over the workers), in turns;
4b. lineitem: TPC-H ``lineitem`` at ``bench.py:_lineitem_path``'s widths
   and cardinalities (four INT64, three DOUBLE and four INT32 columns
   PLAIN, four dictionary-encoded string columns of 3, 2, 4 and 7 values,
   a 27-byte PLAIN ``l_comment``), written by the port's writer from
   ``--seed`` with Snappy, 4,000,000-row row groups and 1 MiB pages;
   ``--lineitem-rows`` (8,388,608) cuts cfg 7's 40,000,000 rows so that
   the host-Python writer and reads fit the run.  One cold and three warm
   reads, each equal to the generated columns (strings compared on the
   host), rows/s and decoded GB/s, each column alone and each phase, and
   ``unpack_bits_dense``'s launches by column (0 where a column's index
   runs are not all bit-packed), which must add up to the wrapper's;
4c. enc: every (type, encoding) pair lineitem lacks (BOOLEAN PLAIN and
   RLE, INT96, FIXED_LEN_BYTE_ARRAY PLAIN and BYTE_STREAM_SPLIT, the
   numeric types in BYTE_STREAM_SPLIT, DELTA_LENGTH_BYTE_ARRAY, front-coded
   URLs, and 1,000-entry byte-array and 500-entry FLBA dictionaries whose
   index runs are all bit-packed), ``--enc-rows`` (2,097,152 since phase
   5j came: cut from 4,194,304 for the script's time) in 1,048,576-row row
   groups and 64 KiB pages, 5-10 % nulls on half of the columns; written
   with v1 pages under Snappy and with v2 pages, then under each of ZSTD,
   LZ4_RAW, LZ4 and BROTLI whose system library loaded (the
   ``{"codecs": ...}`` line names them); every read equals the generated
   columns and launches ``unpack_bits_dense`` on both dictionaries;
4d. nested: (a) ``bench.py:_build4``'s cfg 4 at its default ``n``
   (``--nested-n`` 8,000,000: 2,000,000 rows of ``list<int64>``, 0-7
   cumulative timestamps a row with uniform 0-999 deltas, 5 % empty
   lists), DELTA_BINARY_PACKED, UNCOMPRESSED, read once cold and three
   times warm; (b) a mixed nested file of ``--nest-mix-rows`` (1,048,576)
   in four row groups, Snappy, 64 KiB pages: ``tags`` ``list<string>`` of a
   1,000-entry dictionary (every index run bit-packed), ``scores``
   ``list<int32>`` of a 200-entry dictionary with 5 % null lists and 5 %
   null elements, ``attrs`` ``map<string, int64>``, ``pt`` an optional
   ``struct<x: double, y: double, label: optional string>`` with 10 % null
   structs, and ``grid`` ``list<list<int64>>``, read cold and warm.  Every
   leaf's values, validity, list offsets and list validity of every level
   (and ``pt.label``'s def levels) equal the generated arrays;
   ``unpack_bits_dense`` launches on ``ts``'s miniblocks and ``tags``'s
   indexes and ``dict_unpack_gather`` on ``scores``; (c) the host-route
   fixture (``tests/torch_fixtures/host_route.parquet``, written by
   pyarrow: dictionaries that overflow into PLAIN pages) reads equal to the
   arrays beside it with ``HOST_ROUTE`` counting exactly its chunks.  Every
   main-path file of phases 4-5 leaves ``HOST_ROUTE`` empty, and every
   one of its chunks is planned by the C++ planner (no ``python:*`` entry
   in ``PLAN_ROUTE``; ``native:python_codec`` counts the chunks whose
   codec, LZ4_RAW or BROTLI on enc, decompressed page by page first);
4e. prescan: one ``{"prescan": [...]}`` line, each C++ entry point of the
   host prescan (``csrc/host_prescan.cpp``) timed on the host at one real
   chunk (the first row group's) beside its Python version on the same
   bytes, whose outputs must be equal: the run scan and the present count
   on cfg 4's def and rep levels and ``cat``'s def levels, the delta
   miniblock table on ``ts``, the delta decode on enc's ``ba_dlba`` and
   ``ba_dba`` length streams, the page-header table and the batched
   decompression on lineitem's ``l_comment`` (Snappy) and enc's ZSTD
   ``ba_dlba``; the chunk planner (``pq_chunk_plan``, through
   ``build_plan``) against the Python walk (``_build_plan_python``) on
   the largest chunk of each main-path file and every chunk of the
   5-column file's first row group, every field of the two plans
   equal, with the planner's call in its parts (``parts_ms``: the
   page-header table, the per-page sources, the C++ call and the rest of
   ``build_plan``); and the staging fill (``pq_fill_batch``) against the
   numpy loop it replaced, into pinned memory, on the 5-column file's
   first row group (every column in one batch) and on cfg 4's largest
   chunk, the filled bytes equal; each with its calls in one read of its file;
5. lookup path: a 3-column file keyed by ``k`` (1,048,576-row row groups,
   8 KiB pages, bloom filters on ``k``, page index, rows sorted by ``k``)
   and a batch of ``--lookup-rows / 16`` distinct keys, one in eight
   present.  From cleared caches ``find_rows("k", keys, columns=["v",
   "cat"], device="cuda")`` runs once cold on a fresh handle and twice
   warm on the same one, first at the port's default cache sizes (64 MiB
   of pages, a 4 MiB memo), then with the page cache at 1 GiB and the
   memo at 512 MiB (:data:`LOOKUP_CACHE_KNOBS`, not the defaults: this
   batch's working set fits).  Every key's rows, values and validity must
   equal a numpy oracle; the bloom stage of every row group together must
   launch ``bloom_check`` once in a cold lookup and at most once in a warm
   one; with the larger caches the warm ones must read and decode nothing
   (``preads`` 0) and hit the page cache and the memo, and the cold and
   the first warm run's counters must equal the same runs' on the CPU
   from cleared caches (all three runs' before phase 5q).  Cold and warm keys/s of both cache sizes print beside the
   earlier calls W2 / W3's warm 102,557.7 / 102,960.0 (PR 10, no page
   cache); then one cold and one warm lookup at the defaults under
   per-stage timers (key preparation, statistics, bloom probe, page search, page
   fetch, matching, gather, assembly);
5b. device scan: ``stage_scan(..., device="cuda")`` once, ``decoded_scan``
   once cold and three times warm, ``scan_filtered_device`` end to end
   three times, in three cases: (A) ``bench.py:_cfg5`` at ``--scan-rows``
   (sorted ``l_shipdate`` 8000-12000, ``l_orderkey``, ``l_quantity``,
   ``l_extendedprice``; 8 row groups, 128 KiB pages, Snappy, PLAIN, page
   index, a bloom filter on ``l_shipdate``; the port's writer), its range
   [9000, 9200] and an IN-list of 64 ship dates, each also scanned on the
   CPU; (B) phase 4b's lineitem, TPC-H Q6's ``l_shipdate`` in [8766, 9130]
   (outputs ``l_extendedprice``, ``l_discount``, ``l_quantity``,
   ``l_returnflag``, ``l_comment``) and Q12's ``l_shipmode`` IN ('MAIL',
   'SHIP'); (C) phase 5's lookup file, a range of about 1 % of ``k``
   (outputs ``v`` and ``cat``).  Every result equals a numpy oracle over
   the generated arrays bit for bit, with validity (strings on the host);
   ``bloom_check`` launches in A's IN-list, ``unpack_bits_dense`` in B's
   Q12 (the one row group whose ``l_shipmode`` index runs are all
   bit-packed; ``l_returnflag``'s take ``rle_expand``),
   ``dict_unpack_gather`` in C; no chunk takes the host route or the
   Python walk.  One ``{"scan": [...]}`` line a case: rows, candidate rows,
   spans, rows selected, ``stage_s``, the cold and warm ``decoded_scan``
   seconds and rows/s (over the file and over the candidates), the end to
   end seconds, the kernels launched, the synchronizing calls of one warm
   ``decoded_scan`` (``torch.cuda.set_sync_debug_mode``) and the filter
   ops' calls in it;
5c. multi-file read: lineitem's generated rows as 8 part files of
   1,048,576 rows in 524,288-row row groups (the port's writer, Snappy),
   each read alone (``ParquetFile.read``, best of 3 warm), then read as
   one by ``Dataset(glob).read()`` at ``[cuda:0]`` (its default device),
   ``[cuda:0] * 2`` and ``[cuda:0] * 4``, each cold and three times
   warm: every read equal to the per-file reads bit for bit (the cold
   one also to the generated columns), no file refused, no chunk on the
   host route, the staged bytes back at 0, pinned blocks reused (the
   blocks the reads make never more than the staging buffers they ever
   had in use at once),
   ``unpack_bits_dense`` launched and the operands of its largest launch
   in the cold reads kept for phase 6; one ``{"dataset_read": ...}``
   line a mesh and a ``{"dataset_path": ...}`` line with the host
   seconds of one more read's stages;
5d. sharded read: ``read_table_sharded`` over phase 4b's lineitem with
   ``scripts/multichip_scale.py``'s 11 columns at 1 and 4 shards of
   ``cuda:0`` (three row groups: one shard of four is padding), three
   reads each, equal to the single-file read (the operands of the
   largest ``unpack_bits_dense`` launch of the first, cold, read kept for
   phase 6); ``decode_step_sharded`` at
   4 x 1,048,576 rows against its CPU run (``{"sharded": ...}``);
5f. the lookup leftovers: (a) a BYTE_ARRAY key, 1,048,576 distinct
   sorted URLs (phase 4c's ``_urls``) in one row group, PLAIN under Snappy,
   64 KiB pages, a bloom filter and a page index; 65,536 keys, one in
   eight present, looked up cold and warm on the card from cleared caches:
   hits equal to a dict oracle, one ``bloom_check`` launch, the cold
   counters equal to the CPU's, the warm run served from the caches, and
   the C++ ``pq_xxh64_batch`` of the keys equal to the plain Python
   ``io/bloom.py::xxh64_bytes`` (``{"url_lookup": ...}``); (b)
   ``Dataset.find_rows``: phase 5c's lineitem rows again as 8 part files
   (``l_orderkey``, ``l_quantity``, ``l_extendedprice``, ``l_shipmode``;
   524,288-row row groups, Snappy, 64 KiB pages, a bloom filter on
   ``l_orderkey``, page index), 65,536 keys in ``l_orderkey``'s range, one
   cold and two warm lookups on the card, each equal to a numpy oracle on
   the concatenated rows (global rows, values), the cold counters equal to
   the CPU's, ``read_admission()``'s high water within the lookup budget
   (``{"dataset_find_rows": ...}``); (c) a key under an optional struct
   (``user.id`` of ``user {id optional INT64, score DOUBLE}``, 10 % null
   structs, 5 % null ids, and a flat ``k``; ``--lookup-rows`` rows in
   1,048,576-row row groups, a bloom filter on ``user.id``, a page index):
   ``rows / 16`` keys, one in eight a stored id, cold and warm on the card,
   each equal to a numpy oracle (``user.score`` and its validity), one
   ``bloom_check`` launch cold, the cold counters equal to the CPU's, and
   a ``list<int64>`` key refused with ``ValueError``
   (``{"struct_lookup": ...}``);
5g. reads through a faulty source, on phase 4's 5-column file: transient
   errors (``FaultInjectingSource(error_rate=0.1,
   max_consecutive_errors=2)``) retried under ``FaultPolicy(max_retries=3,
   backoff_s=0)``, the same under ``PARQUET_TPU_TORCH_PREFETCH=ring``
   (its ``ReadStats`` printed), each equal bit for bit to the clean read
   with no chunk on the host route and both unpack kernels launched; a
   flipped page header in row group 3 under ``skip_row_group`` (the other
   row groups equal, ``row_groups_skipped == [3]``, its rows dropped); a
   read past its deadline (``DeadlineError``, no thread left, the card's
   allocated bytes back, the next read equal); the device scan of phase
   5b's case A and phase 5's lookup each with one corrupt row group
   skipped (the rest equal to their numpy oracles); ``Dataset.read`` over
   phase 5c's 8 parts with one truncated (``files_skipped`` names it, the
   rest equal to the per-file reads); and the walls, best of 3 warm, of
   the clean, policy, retry, ring and advise reads
   (``{"resilience": ...}``);
5h. streamed reads (``iter_batches(device="cuda")``): the 5-column file
   at 65,536, 1,048,576 and 100,000 (``strict_batch_rows``) rows a batch,
   lineitem at 65,536 and 1,048,576, cfg 4 and the mixed nested file at
   65,536, and ``Dataset.iter_batches`` over phase 5c's 8 parts at
   65,536.  Each batch is held as it arrives against the matching rows of
   the whole read, kept on the host (every leaf's values, validity, list
   offsets and list validity of every level, struct def levels), and no
   batch is held; the batches' row counts follow the JAX package's rule;
   no page span takes the host route or the Python walk;
   ``unpack_bits_dense`` and ``dict_unpack_gather`` launch in the
   5-column and mixed nested drains (``unpack_bits_dense`` in cfg 4's);
   the card's allocated bytes are back at the end of each drain; the
   5-column drain at 65,536 peaks under a quarter of the whole read's
   device bytes, and it and lineitem's read no chunk whole (a spy on the
   source: each pread within ``pages_streamed``'s window bound, or one
   page and its header).  Each drain's one warm wall (the best of 3
   before phase 5p came, of 2 before 5q, cut for the script's time)
   beside the
   whole read's (in turns), its pulls (page spans decoded), syncs and
   launches (``{"stream": [...]}``); lineitem's drain again under
   ``PARQUET_TPU_TORCH_MMAP_DROPBEHIND=1``, equal, with
   ``bytes_dropbehind > 0``; and the page CRCs the writer now writes:
   one byte flipped mid-page in row group 2 of the 5-column file makes
   the read and the drain under ``ReadOptions(verify_crc=True)`` raise
   ``CorruptedError`` naming the CRC, ``skip_row_group`` drops that row
   group alone (the rest equal), and the clean file's read with and
   without the check, best of 2 warm each (``{"crc": ...}``);
5i. what reads through the stream (the typed reader and writer, the row
   model, the ordered merge and sort), each check fatal; every size here
   was halved when phase 5j came, again when phase 5n came and again when
   phase 5p came, for the script's time: (a) 131,072 seeded ``Event``
   dataclasses (unique ``id``, ``region`` of 200,
   ``user`` of 20,000, a UTC ``ts``, a ``day``, ``score`` 5 % None, 0-4
   ``tags`` of 32, 0-3 ``attrs``, ``geo`` 10 % None) written by
   ``write_objects`` with the default options (Snappy, checked) in
   65,536-row row groups, drained by ``TypedReader(..., batch_rows=65,536,
   device="cuda").read(100,000)`` to the end and read by
   ``read_objects``, both equal to the generated objects (a null ``geo``
   read as ``Geo(None, None)``, as the JAX package reads it),
   ``read_pytree`` equal to ``ParquetFile.read``, both unpack kernels
   launched and the card's allocated bytes back (``{"typed": ...}``);
   (b) 32,768 Documents of the Dremel paper's schema written by
   ``write_rows`` (16,384-row row groups, 8 KiB pages, page index),
   ``read_rows(device="cuda")`` equal to the records, ``FileRows.seek_to_row``
   at 16 offsets (0, a page boundary, a row-group boundary, the last row,
   one past the end, 11 seeded) and ``read_rows(4,096)`` equal to the
   records there, ``copy_rows`` into a second file whose whole read
   equals the first's (``{"rows": ...}``); (c) phase 4b's lineitem at
   4 x 262,144 rows (8 runs cut to 4 for the phase's time)
   lexsorted by (``l_orderkey``, ``l_extendedprice``) and dealt round
   robin into 4 sorted runs (Snappy, 131,072-row row
   groups), merged by ``merge_files(..., batch_rows=65,536,
   device="cuda")`` equal to the sorted input (tie groups as sets) and
   by ``iter_merged`` in sorted chunks that concatenate to it
   (``{"merge": ...}``); (d) 262,144 lineitem rows in a seeded order
   through ``SortingWriter`` by (``l_shipdate`` descending,
   ``l_orderkey``, ``l_extendedprice``), ``buffer_rows=65,536`` (4
   spills), equal to the input sorted so on the host, no spill left
   after ``close`` nor after an ``abort`` (``{"sort": ...}``).  Each line
   gives the write, the cold run and the best of 2 warm runs beside as
   many whole reads of the same file, objects, records or rows a second,
   the seconds by step (the stream's pulls; assembly, window keys and
   permutes, host copies, the writer), pulls, syncs, launches and peak
   device bytes; ``unpack_bits_dense`` must launch in all four,
   ``dict_unpack_gather`` in the typed drain;
5j. aggregation on the card (``ParquetFile.aggregate(device="cuda")``),
   each check fatal: (a) TPC-H Q1's shape on phase 4b's lineitem rows
   (the generated columns written again with the small-cardinality ones
   dictionary-encoded): ``where l_shipdate <= 1998-09-02`` grouped by
   ``l_returnflag`` (sums, averages, counts), the same filter ungrouped,
   the statistics and dictionary tiers over every row
   (``count_distinct(l_shipmode)``, ``min_``/``max_(l_shipdate)``,
   ``variance(l_discount)``, ``sum_(l_quantity)``: ``unpack_bits_dense``
   and no gather) and ``top_k(l_extendedprice, 10)``; (b) about 30 % of
   phase 4b's keys (its file is sorted by ``l_orderkey``), the bounds on
   strict page boundaries, answered by the statistics and page tiers
   (their counters above 0), then decoded sums; (c)
   ``PARQUET_TPU_TORCH_FUSED=on`` on (a)'s filtered query.  Every answer
   equals a numpy oracle over the generated columns (float sums to
   ``1e-9``); both unpack kernels launch (``dict_unpack_gather`` in the
   exact tier), no chunk takes the host route, the card's allocated bytes
   come back.  One ``{"aggregate": ...}`` line: each query's cold and
   best of 3 warm walls beside the best whole read of its columns, tiers,
   launches, the host route, and ``AGG`` (folds on the card and the
   host, spans decoded, copies back);
5k. durable, pipelined writes from the card, each check fatal: (a) the
   first 2,097,152 rows of phase 4's 5-column file (its first two row
   groups; cut from 8,388,608 for the script's time) read on the card
   and handed as CUDA columns to ``write_table`` on a path with the
   default options (Snappy, atomic commit, fsync), under
   ``PARQUET_TPU_TORCH_WRITE_OVERLAP=off``, auto and ``force``, each
   twice: the three files byte-identical, each
   commit's destination absent until its rename and no ``*.tmp`` left;
   (b) ``verify_file(decode=True)`` on the card clean, with row groups x 5
   chunks decoded through ``unpack_bits_dense`` and ``dict_unpack_gather``
   and no host route, and the file read back equal to the original read
   bit for bit; (c) ``crash_consistency_check`` on 65,536 rows of the same
   columns, 12 samples, unbuffered and buffered, under ``force``:
   every outcome ``absent`` or ``clean``; (d) a full disk
   (``FaultInjectingSink(enospc_at_byte=half)``) raises and leaves no
   destination, no temp file, no writer thread and no device bytes; (e)
   one byte flipped in a page of row group 1 is exactly one CRC issue at
   that row group, column and page offset.  One ``{"write": ...}`` line:
   each write's walls, MB/s and ``WriteStats``, ``verify_file``'s walls
   with and without decode beside the whole read's, the crash matrix's
   outcomes and walls;
5l. writable tables, each check fatal: (a) phase 4b's lineitem rows
   (phase 5c's parts' rows) ingested by ``DatasetWriter`` into a table in
   one commit a 1,048,576-row slice (the default ``rows_per_file``,
   524,288-row row groups, Snappy, the default dictionary rule, a bloom
   filter on ``l_orderkey``): versions 1-8, a part each, no ``*.tmp``;
   (b) ``open_table`` pins the snapshot, whose read on the card equals
   the generated columns and phase 5c's glob read of the same rows bit
   for bit; a scan of 1 % of the sorted keys in part 0 opens part 0 only
   and one in a middle part opens it and part 0 (whose footer types the
   predicate), the manifest dropping the rest unopened, both equal to a
   numpy oracle; ``count`` with ``sum_(l_quantity)`` and ``count`` with
   ``min_``/``max_(l_orderkey)`` over the keys of parts 0-1 and 10 % of
   part 2, equal to the oracle, the parts past it dropped by the
   manifest, the covered parts answered by their zone maps where every
   aggregate is provable from them, the dictionary and exact tiers on
   the card; ``Dataset.find_rows`` of 65,536 keys in one part's two row
   groups (a quarter absent) equal to the oracle with ``bloom_check``
   launched; (c) ``compact_table(max_files=2)`` folds 2 parts through
   ``merge_files`` on the card while (b)'s dataset stays open: version 9
   with 7 parts, the inputs unlinked, the old dataset's read equal to its
   first bit for bit, a fresh open's parts equal to the generated rows in
   the new order, recovery removing nothing; (d) 1,048,576 lineitem rows
   in a seeded order into a table sorted by ``l_orderkey`` in 4 commits,
   each part's pages ascending, folded to one part by a
   ``BackgroundCompactor`` on the card, its read equal to the rows sorted
   on the host (ties as sets); (e) ``table_crash_check`` on 65,536 rows,
   10 samples, every outcome ``old`` or ``new``.  Both unpack kernels
   launch in (b)'s reads and ``bloom_check`` in its lookup, no chunk
   takes the host route, the card's allocated bytes come back after each
   step and no writer or compactor thread is left.  One ``{"table":
   ...}`` line: each commit's write and commit seconds and MB/s, the
   reads' cold and best warm walls beside the glob read's, the parts
   each query opened, the compaction's wall and rows/s beside 5i(c)'s
   merge, the crash matrix's outcomes and wall, the launches;
5m. observability, each check fatal: (a) phase 4's 5-column file read
   under ``utils/debug.py::profiler_trace`` (a Chrome trace of host and
   card activity, every thread; a first read opens the window, since the
   profiler can miss the device events of its first moments): the
   second read's columns equal an untraced read's bit for bit, and the
   trace holds the ``pq.prepare_chunk`` and ``pq.decode_staged:*``
   regions and each unpack kernel's symbol, launched inside that read,
   as often as ``LAUNCHES`` counted (a trace that dropped device events
   is taken again, up to 5 times); (b) ``counters`` over an untraced read:
   every chunk on the device, none on the host route, ``bytes_h2d`` the
   bytes of the staging batches sent, and the names ``PIPELINE`` keeps
   equal to its; (c) ``prune_row_group_values`` of phase 5's lookup file
   on ``k`` with 65,536 hashes a row group (phase 5's keys; then absent
   keys only), answers equal to the CPU's, one ``bloom_check`` launch a
   row group; (d) a line saying whether pyarrow imports on the machine:
   where it does, a card read's ``to_arrow`` holds the card's columns
   (timed); where it does not, no Arrow step runs.  One ``{"debug":
   ...}`` line:
   the walls untraced and traced (with and without the trace's export),
   the trace's bytes and events, the counters, the probes' answers and
   walls, the launches;
5o. observability in production (``obs/``), each check fatal: (a) phase
   4's 5-column file read on the card inside ``op_scope("smoke.read")``,
   3 times untraced, 3 times traced with every op sampled (the first from
   cleared footer and page caches) and 16 times at
   ``PARQUET_TPU_TORCH_TRACE_SAMPLE=8``: the columns equal the untraced
   read's bit for bit, the op's ``read.bytes_read`` equals the global
   delta and the bytes the file sources served, each unpack kernel
   launches and each read synchronizes as often as untraced, the trace
   JSON holds each read's ``op.smoke.read`` event, an ``open.footer``
   span and one ``device.h2d`` span a staged plan on the reads' tracks
   from more than one prepare worker, and the sampled run keeps 2 ops
   of 16 (``trace.ops_sampled`` 2, ``trace.ops_skipped`` 14) with spans
   of those 2 only; (b) a lookup of phase 5's 65,536 keys in its file's
   first row group (a batch the card's bloom probe takes) and a
   ``Dataset.scan`` of phase 5c's parts at once on two threads, each in
   its own op: their ``read.bytes_read`` sum to the global delta, and
   ``bloom_check`` launches; (c) ``start_metrics_server(0)`` scraped in
   the middle of a streamed drain: ``/metrics`` parses as Prometheus
   text with every family of the registry, ``/debugz`` shows the drain's
   live op and the ledger, and the server's thread is joined; (d) after
   a warm lookup the soft watermark at half the ledger's total shrinks
   the page cache under it with ``ledger.pressure_evictions`` and leaves
   the next lookup's answers unchanged, and the hard watermark holds a
   read admission on a thread until the ledger's bytes drop; (e) with
   ``PARQUET_TPU_TORCH_SLOW_OP_S=0`` the slow log holds one JSON line an
   op.  One ``{"obs": ...}`` line: the walls, the syncs, the trace's
   bytes and events, the op reports, the scraped families, the ledger
   before and after the pressure, the launches;
5p. the serving daemon on the card (``Server(config, port=0,
   device="cuda")`` on loopback), each check fatal, over phase 4's
   5-column file, phase 5's lookup file and phase 5j's Q1 file at their
   full sizes and a writable table sorted on ``k`` with phase 4's schema
   (4,096 seed rows committed first), for three tenants:
   ``interactive`` (latency, weight 4, 64 MiB of pinned pages, a bearer
   token), ``batch`` (bulk, a 256 MiB budget) and ``metered`` (5
   requests a second, a burst of 5): (a) ``/v1/lookup`` of phase 5's
   keys in its file's first row group (``v`` and ``cat``) cold and twice
   warm, equal to
   ``lookup_to_jsonable`` of the direct ``Dataset.find_rows`` on the
   card, ``bloom_check`` and ``dict_unpack_gather`` launched, the tenant's
   pinned bytes above 0 and within its cap, a wrong token 401; (b) the
   bulk tenant's Arrow ``/v1/scan`` of ``k``, ``cat`` and ``ts`` equal to
   the direct read's ``to_arrow`` with the same launches, a JSON scan of
   about 1 % of ``k``'s values equal byte for byte to the direct
   ``scan_expr``'s lines, and the same scan paged at 1,000,000 rows
   concatenating to it; (c) Q1 grouped and ungrouped and phase 5j's
   dictionary-tier query equal to ``Dataset.aggregate`` on the card
   (floats to ``1e-9``); (d) 4 ``/v1/write`` bodies of 65,536 rows of
   phase 4's columns from ``--seed``, versions 2-5, the table's scan a
   part a commit, each its rows sorted on ``k``, and a lookup of the last
   batch's ids equal to the direct lookup of a fresh ``open_table``; (e)
   4 threads of 10 lookups of 1,024 keys (50 before phase 5q, cut for
   the script's time) alone and beside 2 threads of whole-file Arrow
   scans, every answer equal to its direct call (p50 and
   p99 both ways), then 20 requests in a row of ``metered``, some 429
   with ``Retry-After``; (f) ``PARQUET_TPU_TORCH_MEM_HARD`` at half the
   pinned bytes: ``/healthz`` ``hard``, a bulk scan shed 429, a pinned
   lookup 200 and unchanged, then ``ok``; (g) ``/metrics``'s
   ``serve.requests`` of each class the sum of its tenants', ``/debugz``'s
   tenants section holding the requests and sheds the phase sent; then
   ``close()`` drains (True) and leaves no thread it started, no pin and
   no tenant.  Every kernel launches in the phase.  One ``{"serve":
   ...}`` line: each step's walls, keys/s and rows/s, the launches, the
   pinned bytes, the sheds and 429s;
5q. the serving fleet on the card: three fleet members (``Server(config,
   port=0, device="cuda")`` with a ``cluster`` block, in this process on
   loopback) over a table that ``DatasetWriter(partition_on=
   "l_orderkey")`` writes from 4,194,304 lineitem rows (commits of
   1,048,576 rows, 4 key partitions a commit, a part file each, a bloom
   filter on the key; more commits only if the ring left a member without
   a part), each check fatal, against a single node over the same table
   for the same requests: (a) a scatter lookup of 65,536 keys and (a') one
   of 131,072 keys inside the first commit's key range (every member's
   share one device bloom batch a row group), each byte for byte the
   single node's; (b) a JSON scan of about 1 % of ``l_shipdate`` byte for
   byte and its Arrow scan by ``Table.equals``; (c) TPC-H Q1 grouped
   (floats to ``1e-9``, integers exactly); every fleet answer one gather,
   a forward to each peer, no fallback and no hedge
   (``PARQUET_TPU_TORCH_FLEET_HEDGE_S=0``); (d) a member other than the
   coordinator chaos-killed mid-scan (``kill_after(victim, 1)`` then
   ``chaos_kill()``): the scan still byte for byte, ``fleet.local_
   fallbacks`` moved; with the victim's files hidden an ``exact`` scan is
   a 5xx; (e) the two live members take 4 ingest requests of 8,192 rows
   at once into one table: the version advances by 4, every row lands,
   ``fleet.cas_commits`` moves; (f) ``/debugz`` has the fleet section,
   and closing the members leaves no thread, pin, tenant or fleet
   section.  One ``{"fleet": ...}`` line: each request's wall on the
   fleet beside the single node's, the fleet counters it moved, and each
   kernel's launches on the members' legs;
6. one ``{"kernels": [...]}`` line: each kernel at the shapes its path
   gives it, with its launches on that path, bound, plain-version time and
   the device time of the library call.  ``unpack_bits_dense`` and
   ``dict_unpack_gather`` at the read's three shapes (``k``, ``ts`` and
   ``cat``: the first row group's launches, operands taken from the plan,
   with the launches of that column in phase 4's reads; and enc's
   ``ba_dict``, with its launches in phase 4c's first reads; and the
   nested columns ``ts``, ``tags`` and ``scores`` of phase 4d), bit for bit
   against their plain versions, each on a warm card with the profiler's
   mean (``ms``) beside the time per launch from the replay of a CUDA
   graph of 100 launches (``graph_ms``) and the SM clock, power draw and
   temperature sampled before and after; for
   ``bloom_check`` the lookup's segmented probe (``ms``, profiler), and
   beside it the one-filter launch at one row group's shape and the
   byte-array lookup's probe of phase 5f (``byte_array_shape``).  Every
   kernel also gets ``call_ms`` (CUDA events around back-to-back wrapper calls,
   the host's dispatch included); then one ``{"ops": [...]}`` line: the
   torch ops that stand for the JAX package's XLA ops, at the shapes of
   enc's and lineitem's first row groups, and the level assembly at cfg 4's
   first row group (``assemble_single_list``) and at ``grid``'s
   (``assemble_nested``), each with the profiler's device time per call
   (every kernel of the op), its calls per read and its byte bound; and
   the scan's filter ops (``range_mask``, ``in_mask``, ``compact_targets``,
   ``compact_prefix``) at case A's row group of 1,048,576 rows, with their
   calls in one ``decoded_scan``;
7. one warm ``decoded_scan`` of each scan case (``{"scan_breakdown":
   ...}``, first: short windows), one more warm read of the 5-column
   file, of lineitem and of cfg 4, and two more lookups (one cold from
   cleared caches at the defaults, one warm with the caches sized to the
   working set), each under the profiler, for the
   device's idle share; each read follows an unprofiled read of its file (phases 4b-6
   used the caching allocators in between) and must copy nothing over
   1 MiB from pageable memory and create no pinned block (the trace's
   copies and ``cudaHostAlloc`` and ``cudaMalloc`` calls are logged).
   They come last: after a window that long the profiler can drop every
   event of phase 6's short ones.  A ``{"stream_breakdown": ...}`` line
   follows: the 5-column drain at 65,536 rows twice, each step's seconds
   (a pull's plan and staging, its decode, its row starts, the slices, a
   batch's concatenation), and one drain under the profiler for the
   device's idle share.  Then a ``{"pipeline_breakdown": ...}``
   line: one serial and one pipelined read of each path with each step's
   seconds summed over the threads.  A ``{"path_phases": ...}`` line adds
   up, for the 5-column file, lineitem, enc v1-Snappy and cfg 4, the
   serial read's host prescan (``plan_s``), staging (``pack_s`` +
   ``h2d_s``) and decode seconds over its chunks beside the best warm
   pipelined read's wall and rows/s (``--summarize LOG`` prints the same
   from a saved run of this or an earlier version of the script), and a
   ``{"phase_s": ...}`` line gives each phase's wall time.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits non-zero before printing any result.  ``--out DIR`` also writes
the sweeps and the kernel and ops lines to ``DIR/chip_smoke_sweep.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import errno
import gc
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import parquet_tpu_torch as pq
from parquet_tpu_torch import codecs
from parquet_tpu_torch.algebra import buffer as algebra_buffer
from parquet_tpu_torch.algebra import merge as algebra_merge
from parquet_tpu_torch.format.enums import (BoundaryOrder, CompressionCodec,
                                            Encoding, PageType, Type)
from parquet_tpu_torch.format.enums import FieldRepetitionType as Rep
from parquet_tpu_torch.io import bloom, lookup
from parquet_tpu_torch.io.column import concat_columns
from parquet_tpu_torch.io.reader import (data_page_bodies, page_infos,
                                         thrift_page_walk)
from parquet_tpu_torch.io.writer import ColumnData
from parquet_tpu_torch.ops import _build, host, kernels, ref
from parquet_tpu_torch.ops import device as dev
from parquet_tpu_torch.ops.host import gather_byte_arrays, segment_ranges
from parquet_tpu_torch.parallel import device_reader
from parquet_tpu_torch.schema import schema as S
from parquet_tpu_torch.schema.schema import Leaf, Schema
from parquet_tpu_torch.schema.types import LogicalKind, physical_of_dtype
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)
M32 = 0xFFFFFFFF
DEVICE = "cuda"
ROW_GROUP = 1 << 20
READ_KERNELS = ("unpack_bits_dense", "dict_unpack_gather")
LOOKUP_KERNELS = ("bloom_check", "dict_unpack_gather")


LOGGED: list = []  # every object this run printed, for the path summary


def log(obj) -> None:
    LOGGED.append(obj)
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def no_host_route(what: str) -> None:
    """A main-path file decodes every chunk on the device route, each
    chunk planned by the C++ planner (no Python walk in ``PLAN_ROUTE``)."""
    if any(pq.HOST_ROUTE.values()):
        raise AssertionError(f"{what}: chunks took the host decode: "
                             f"{pq.HOST_ROUTE}")
    walked = {k: v for k, v in pq.PLAN_ROUTE.items()
              if k.startswith("python:") and v}
    native = pq.PLAN_ROUTE["native"] + pq.PLAN_ROUTE["native:python_codec"]
    if walked or not native:
        raise AssertionError(f"{what}: chunks planned by the Python walk: "
                             f"{pq.PLAN_ROUTE}")


def reset_routes() -> None:
    pq.reset_host_route()
    pq.reset_plan_route()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_sample() -> str:
    """The card's SM clock, its maximum, power draw and temperature now, as
    ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, launches: int = 100, replays: int = 20,
             warm_s: float = 0.5) -> float:
    """Device milliseconds per launch of ``fn``, a call that launches one
    kernel on the current stream: CUDA events around the replay of a CUDA
    graph of ``launches`` calls back to back, the median over ``replays``
    replays, after ``warm_s`` seconds of replays that warm the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def time_ms(fn, reps: int = 20, warmup: int = 3, batches: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` calls in a row, the median over ``batches`` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def pack_dense(values: torch.Tensor, w: int) -> torch.Tensor:
    """The dense LSB-first w-bit stream of ``values`` (int64, < 2^w) as
    int32 words: group g of 32 values fills words [g*w, (g+1)*w)."""
    n = values.shape[0]
    groups = (n + 31) // 32
    v = torch.zeros(groups * 32, dtype=torch.int64, device=values.device)
    v[:n] = values
    i = torch.arange(groups * 32, device=values.device)
    bit = (i & 31) * w
    word = (i >> 5) * w + (bit >> 5)
    sh = bit & 31
    words = torch.zeros(groups * w + 1, dtype=torch.int64,
                        device=values.device)
    words.index_add_(0, word, (v << sh) & M32)
    hi = sh + w > 32
    words.index_add_(0, word[hi] + 1, v[hi] >> (32 - sh[hi]))
    words = words[:groups * w]
    return (words - ((words & 0x80000000) << 1)).to(torch.int32)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    it = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(it), b.view(it))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unpack_bound(n: int, w: int) -> tuple:
    # read n*w/8 packed bytes, write 4n; ~6 integer operations per value
    return bound(n * w / 8 + 4 * n, 6 * n)


def dict_bound(n: int, w: int, d: int, elem: int) -> tuple:
    return bound(n * w / 8 + d * elem + n * elem, 7 * n)


def bloom_blocks(filt: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """The filter block each hash probes, ``((h >> 32) * z) >> 32``."""
    return (((hashes >> 32) & M32) * filt.shape[0]) >> 32


def bloom_bound(filt: torch.Tensor, hashes: torch.Tensor) -> tuple:
    return bloom_segments_bound([filt], hashes, [0, hashes.shape[0]])


def bloom_segments_bound(filters, hashes: torch.Tensor, starts) -> tuple:
    # read each hash (8 B), each distinct (filter, block) pair this data
    # touches (32 B) and the segment table (20 B a segment, the single
    # filter's included) once, write one byte per hash; ~30 integer
    # operations per probe
    n = hashes.shape[0]
    touched = sum(int(torch.unique(bloom_blocks(f, hashes[a:b])).numel())
                  for f, a, b in zip(filters, starts, starts[1:]))
    return bound(9 * n + 32 * touched + 20 * len(filters) + 8, 30 * n)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_unpack(n: int, gen: torch.Generator) -> list:
    rows = []
    for w in range(1, 33):
        words = torch.randint(-2**31, 2**31 - 1, ((n + 31) // 32 * w,),
                              dtype=torch.int32, device=DEVICE,
                              generator=gen)
        got = kernels.unpack_bits_dense(words, n, w)
        want = kernels.unpack_bits_dense_ref(words, n, w)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            bad = int((got != want).nonzero()[0])
            raise AssertionError(
                f"unpack_bits_dense w={w}: first mismatch at {bad} "
                f"({int(got[bad])} != {int(want[bad])})")
        call = lambda: kernels.unpack_bits_dense(words, n, w)  # noqa: E731
        plain = time_ms(lambda: kernels.unpack_bits_dense_ref(words, n, w),
                        reps=3, warmup=1, batches=1)
        b, by = unpack_bound(n, w)
        rows.append({"kernel": "unpack_bits_dense", "n": n, "w": w,
                     "ms": device_ms(call, "unpack_bits_dense_kernel"),
                     "call_ms": time_ms(call), "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "exact": True})
    return rows


def random_dictionary(d: int, dtype: torch.dtype,
                      gen: torch.Generator) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(d, dtype=dtype, device=DEVICE, generator=gen)
    lim = 2**31 - 1 if dtype == torch.int32 else 2**62
    return torch.randint(-lim, lim, (d,), dtype=dtype, device=DEVICE,
                         generator=gen)


def sweep_dict(n: int, gen: torch.Generator) -> list:
    rows = []
    for w in (1, 8, 10):
        for d in (2, 200, 1024):
            idx = torch.randint(0, min(d, 1 << w), (n,), device=DEVICE,
                                generator=gen)
            words = pack_dense(idx, w)
            if not torch.equal(kernels.unpack_bits_dense(words, n, w).long(),
                               idx):
                raise AssertionError(f"packing check failed at w={w}")
            for dtype in (torch.int32, torch.int64, torch.float32,
                          torch.float64):
                dictionary = random_dictionary(d, dtype, gen)
                got = kernels.dict_unpack_gather(words, dictionary, n, w)
                want = kernels.dict_unpack_gather_ref(words, dictionary, n,
                                                      w)
                torch.cuda.synchronize()
                if not bits_equal(got, want) or not bits_equal(
                        got, dictionary[idx]):
                    raise AssertionError(
                        f"dict_unpack_gather w={w} d={d} {dtype}: mismatch")
                call = lambda: kernels.dict_unpack_gather(  # noqa: E731
                    words, dictionary, n, w)
                plain = time_ms(lambda: kernels.dict_unpack_gather_ref(
                    words, dictionary, n, w), reps=3, warmup=1, batches=1)
                b, by = dict_bound(n, w, d, dictionary.element_size())
                rows.append({
                    "kernel": "dict_unpack_gather", "n": n, "w": w, "d": d,
                    "dtype": str(dtype),
                    "ms": device_ms(call, "dict_unpack_gather_kernel"),
                    "call_ms": time_ms(call), "plain_ms": plain,
                    "library_ms": device_ms(lambda: dictionary[idx]),
                    "bound_ms": b, "bound_by": by, "exact": True})
    return rows


BLOOM_N = (32_768, 1_048_576, 8_388_608)
BLOOM_Z = (1, 1_024, 65_536, 4_194_304)


def random_filter(z: int, rng: np.random.Generator,
                  inserted: np.ndarray) -> bloom.SplitBlockFilter:
    """A z-block filter of sparse random bits holding ``inserted``."""
    blocks = (rng.integers(0, 2**32, (z, 8), dtype=np.uint32)
              & rng.integers(0, 2**32, (z, 8), dtype=np.uint32))
    f = bloom.SplitBlockFilter(blocks)
    f.insert_hashes(inserted)
    return f


def random_hashes(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random 64-bit hashes, every 7th with all high bits set (it probes
    the filter's last block)."""
    h = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    h[::7] |= np.uint64(0xFFFFFFFF00000000)
    return h


def host_probe(f: bloom.SplitBlockFilter, h: np.ndarray) -> np.ndarray:
    return np.concatenate([f.check_hashes(h[i:i + (1 << 20)])
                           for i in range(0, max(len(h), 1), 1 << 20)])


def sweep_bloom(ns, zs, seed: int) -> list:
    """``bloom_check`` against ``bloom_check_ref`` and the numpy host probe,
    bit for bit, for each filter size and each prefix of one hash array.
    Half of the first 1,048,576 hashes are in each filter."""
    rng = np.random.default_rng(seed + 3)
    h_host = random_hashes(max(ns), rng)
    hashes = torch.from_numpy(h_host.view(np.int64)).to(DEVICE)
    rows = []
    for z in zs:
        f = random_filter(z, rng, h_host[:1 << 20:2])
        filt = f.device_blocks(DEVICE)
        for n in ns:
            h = hashes[:n]
            got = kernels.bloom_check(filt, h)
            want = kernels.bloom_check_ref(filt, h)
            host = host_probe(f, h_host[:n])
            if not torch.equal(got, want) or not np.array_equal(
                    got.cpu().numpy(), host):
                raise AssertionError(f"bloom_check n={n} z={z}: mismatch")
            blk = bloom_blocks(filt, h)
            b, by = bloom_bound(filt, h)
            call = lambda: kernels.bloom_check(filt, h)  # noqa: E731
            rows.append({
                "kernel": "bloom_check", "n": n, "z": z,
                "hit_share": float(got.float().mean()),
                "ms": device_ms(call, "bloom_check_kernel"),
                "call_ms": time_ms(call),
                "plain_ms": time_ms(lambda: kernels.bloom_check_ref(filt, h),
                                    reps=3, warmup=1, batches=1),
                "library_ms": device_ms(lambda: filt.index_select(0, blk)),
                "bound_ms": b, "bound_by": by, "exact": True})
    return rows


def segmented_probe(filters, batches) -> tuple:
    """The operands of one ``bloom_check_segments`` call: each filter's
    device copy, every batch's hashes in one tensor on the card, and the
    batches' starts (int64 on the CPU)."""
    starts = np.zeros(len(batches) + 1, np.int64)
    np.cumsum([len(h) for h in batches], out=starts[1:])
    hashes = torch.from_numpy(np.concatenate(batches).view(np.int64)).to(
        DEVICE)
    return ([f.device_blocks(DEVICE) for f in filters], hashes,
            torch.from_numpy(starts))


def check_segmented(filters, batches, blocks, hashes, starts,
                    what: str) -> torch.Tensor:
    """``bloom_check_segments`` bit for bit against its plain version and
    the numpy host probe of each segment's filter; returns the kernel's
    result."""
    got = kernels.bloom_check_segments(blocks, hashes, starts)
    want = kernels.bloom_check_segments_ref(blocks, hashes, starts)
    host = np.concatenate([host_probe(f, h) for f, h in zip(filters,
                                                             batches)])
    if not torch.equal(got, want) or not np.array_equal(got.cpu().numpy(),
                                                        host):
        raise AssertionError(f"bloom_check_segments {what}: mismatch")
    return got


def segmented_times(blocks, hashes, starts) -> dict:
    """Device and call times of one ``bloom_check_segments``, its bound,
    its plain version, and the library gather of the same blocks from the
    concatenated filters (``index_select``, the gather alone)."""
    st = starts.tolist()
    cat = torch.cat(blocks)
    base = np.cumsum([0] + [b.shape[0] for b in blocks[:-1]])
    idx = torch.cat([int(o) + bloom_blocks(b, hashes[a:e])
                     for o, b, a, e in zip(base, blocks, st, st[1:])])
    b, by = bloom_segments_bound(blocks, hashes, st)
    call = lambda: kernels.bloom_check_segments(  # noqa: E731
        blocks, hashes, starts)
    return {"ms": device_ms(call, "bloom_check_kernel"),
            "call_ms": time_ms(call),
            "plain_ms": time_ms(lambda: kernels.bloom_check_segments_ref(
                blocks, hashes, starts), reps=3, warmup=1, batches=1),
            "library_ms": device_ms(lambda: cat.index_select(0, idx)),
            "bound_ms": b, "bound_by": by}


def sweep_bloom_segments(seed: int) -> list:
    """``bloom_check_segments`` on the lookup's layout (8 filters of 65,536
    blocks, 65,536 hashes each) and on 64 filters of 1 to 65,536 blocks
    with uneven batches (every 9th empty, most not a multiple of 4).  Half
    of each batch is in its filter."""
    rng = np.random.default_rng(seed + 4)
    cases = {"lookup_layout": ([65_536] * 8, [65_536] * 8)}
    sizes = rng.integers(1, 40_000, 64)
    sizes[::9] = 0
    cases["many_segments"] = ([1 << (i % 17) for i in range(64)],
                              sizes.tolist())
    rows = []
    for name, (zs, ns) in cases.items():
        batches = [random_hashes(n, rng) for n in ns]
        filters = [random_filter(z, rng, h[::2]) for z, h in zip(zs, batches)]
        blocks, hashes, starts = segmented_probe(filters, batches)
        got = check_segmented(filters, batches, blocks, hashes, starts, name)
        rows.append({"kernel": "bloom_check_segments", "case": name,
                     "segments": len(zs), "n": hashes.shape[0],
                     "hit_share": float(got.float().mean()),
                     **segmented_times(blocks, hashes, starts),
                     "exact": True})
    return rows


# ---------------------------------------------------------------------------
# phase 4: the read path
# ---------------------------------------------------------------------------


def make_table(rows: int, seed: int) -> dict:
    """The five columns of the main path, from ``seed``."""
    rng = np.random.default_rng(seed)
    return {
        # bench.py config 1: a PLAIN int64 column of distinct values
        "id": (np.arange(rows, dtype=np.int64) * 2654435761
               + seed * 40503) % (1 << 62),
        # config 2: 20,000 distinct int64 keys, dictionary-encoded
        "k": rng.integers(0, 20_000, rows).astype(np.int64),
        # a 200-value int32 category with 10 % nulls
        "cat": np.ma.masked_array(
            rng.integers(0, 200, rows).astype(np.int32),
            mask=rng.random(rows) < 0.10),
        # config 4's timestamps, flat: deltas drawn from 0..999
        "ts": 1_700_000_000_000_000 + np.cumsum(
            rng.integers(0, 1000, rows), dtype=np.int64),
        # a double with 5 % nulls
        "price": np.ma.masked_array(rng.random(rows) * 1000.0,
                                    mask=rng.random(rows) < 0.05),
    }


ENCODINGS = {"id": Encoding.PLAIN, "k": Encoding.RLE_DICTIONARY,
             "cat": Encoding.RLE_DICTIONARY,
             "ts": Encoding.DELTA_BINARY_PACKED, "price": Encoding.PLAIN}


def check_table(out: dict, table: dict) -> None:
    for name, arr in table.items():
        col = out[name]
        if col.values.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"{name}: values on {col.values.device}")
        if isinstance(arr, np.ma.MaskedArray):
            valid = ~np.ma.getmaskarray(arr)
            if col.validity is None or not np.array_equal(
                    col.validity.cpu().numpy(), valid):
                raise AssertionError(f"{name}: validity differs")
            want = np.asarray(arr.data)[valid]
        else:
            if col.validity is not None:
                raise AssertionError(f"{name}: unexpected validity")
            want = arr
        got = col.values.cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(
                got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}")):
            raise AssertionError(f"{name}: values differ")


def decoded_bytes(out: dict) -> int:
    """Bytes of the decoded columns: values, byte-array offsets, the int32
    indexes of a column kept dictionary-encoded (its dictionary left out),
    one validity byte per slot of an optional column (per element of a
    repeated one) and each repeated level's int64 offsets and validity
    bytes."""
    total = 0
    for col in out.values():
        for t in (col.values, col.offsets, col.validity,
                  col.dict_indices if col.values is None else None,
                  *col.list_offsets, *col.list_validity):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def timed_read(path: str, columns=None) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pq.ParquetFile(path).read(columns=columns, device=DEVICE)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serial_read(path: str) -> dict:
    """``read`` with the pipeline's ``workers=0``: plan, stage and decode
    one chunk after another on this thread."""
    f = pq.ParquetFile(path)
    rgs = f.row_groups
    chunks = [rg.column(leaf.column_index)
              for leaf in f.schema.leaves for rg in rgs]
    gen = device_reader.decode_chunks_pipelined(chunks, torch.device(DEVICE),
                                                workers=0)
    return {leaf.name: concat_columns([next(gen) for _ in rgs])
            for leaf in f.schema.leaves}


def column_parts(col) -> list:
    """Every tensor and host level stream of a decoded column, in a fixed
    order (None where it has none)."""
    dictionary = (list(col.dictionary) if isinstance(col.dictionary, tuple)
                  else [col.dictionary])
    return [col.values, col.offsets, col.validity, col.dict_indices,
            *dictionary, *col.list_offsets, *col.list_validity,
            col.def_levels, col.rep_levels]


def same_bits(got: dict, want: dict, what: str) -> None:
    """Two reads of one file equal bit for bit, column by column."""
    for name, col in want.items():
        a, b = column_parts(got[name]), column_parts(col)
        ok = len(a) == len(b)
        for x, y in zip(a, b):
            if x is None or y is None:
                ok &= x is None and y is None
            elif isinstance(x, np.ndarray):
                ok &= isinstance(y, np.ndarray) and np.array_equal(x, y)
            else:
                ok &= (x.dtype == y.dtype and x.shape == y.shape
                       and torch.equal(x.contiguous().view(torch.uint8),
                                       y.contiguous().view(torch.uint8)))
        if not ok:
            raise AssertionError(f"{what}: {name} differs between the "
                                 "pipelined and the serial read")


def main_path(rows: int, seed: int, tmp: str) -> dict:
    table = make_table(rows, seed)
    path = os.path.join(tmp, "main.parquet")
    t0 = time.perf_counter()
    pq.write_table(table, path, pq.WriterOptions(
        column_encoding=ENCODINGS, compression="uncompressed"))
    write_s = time.perf_counter() - t0

    with ColumnLaunches() as by_column:
        pq.reset_launches()
        reset_routes()
        pq.reset_pipeline()
        out, cold_s = timed_read(path)
        check_table(out, table)
        del out
        warm = []
        for _ in range(3):  # each checked: pinned buffers are reused
            out, s = timed_read(path)
            warm.append(s)
            check_table(out, table)
        launches = dict(pq.LAUNCHES)
        pipeline = dict(pq.PIPELINE)
        plan_route = dict(pq.PLAN_ROUTE)
    column_launches = by_column.counts
    no_host_route("the 5-column read")
    same_bits(out, serial_read(path), "the 5-column read")
    nbytes = decoded_bytes(out)
    del out
    for name in READ_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main-path read")
        counted = sum(c.get(name, 0) for c in column_launches.values())
        if counted != launches[name]:
            raise AssertionError(
                f"{name}: {counted} launches counted by column, "
                f"{launches[name]} by the wrapper over the same reads")
    per_column = {}
    for name in table:
        _, per_column[name] = timed_read(path, [name])
    best = min(warm)
    log({"main_path": {
        "rows": rows, "row_groups": -(-rows // ROW_GROUP),
        "file_bytes": os.path.getsize(path), "write_s": write_s,
        "cold_read_s": cold_s, "warm_read_s": warm, "rows_per_s": rows / best,
        "decoded_bytes": nbytes, "decoded_gb_per_s": nbytes / best / 1e9,
        "column_read_s": per_column, "launches": launches,
        "pipeline": pipeline, "plan_route": plan_route,
        "column_launches": column_launches}})
    return {"path": path, "launches": launches,
            "shapes": path_operands(path),
            "path_launches": {c: column_launches.get(c, {}).get(k, 0)
                              for c, k in PATH_SHAPES},
            "columns": phase_times(path)}


# (column, kernel) of each read-path shape that phase 6 measures, on the
# 5-column file and on enc
PATH_SHAPES = (("k", "unpack_bits_dense"), ("ts", "unpack_bits_dense"),
               ("cat", "dict_unpack_gather"))
ENC_SHAPES = (("ba_dict", "unpack_bits_dense"),)
# on cfg 4, and on the mixed nested file
CFG4_SHAPES = (("ts.list.element", "unpack_bits_dense"),)
NEST_MIX_SHAPES = (("tags.list.element", "unpack_bits_dense"),
                   ("scores.list.element", "dict_unpack_gather"))
# on the device scan: the case whose cold decoded_scan gives the shape
SCAN_SHAPES = (("B_q12", "unpack_bits_dense"),
               ("C_lookup", "dict_unpack_gather"))


class ColumnLaunches:
    """Kernel launches by column over the reads inside the block: the
    change in ``LAUNCHES`` over each ``decode_staged`` call, credited to
    the column that call decodes (``counts[column][kernel]``)."""

    def __init__(self):
        self.counts = {}
        self._real = None

    def __enter__(self):
        real = self._real = device_reader.decode_staged

        def counted(plan, *args, **kwargs):
            before = dict(pq.LAUNCHES)
            try:
                return real(plan, *args, **kwargs)
            finally:
                col = self.counts.setdefault(plan.leaf.name, {})
                for k, v in pq.LAUNCHES.items():
                    if v != before[k]:
                        col[k] = col.get(k, 0) + v - before[k]

        device_reader.decode_staged = counted
        return self

    def __exit__(self, *exc):
        device_reader.decode_staged = self._real


def first_chunk_calls(path: str, column: str, owner, attr: str) -> list:
    """The arguments of every call of ``owner.attr`` that decoding the
    first row group of ``column`` makes, exactly as the read passes them
    (operands taken from the chunk's plan)."""
    f = pq.ParquetFile(path)
    reader = f.row_groups[0].column(f.schema.leaf(column).column_index)
    device = torch.device(DEVICE)
    calls = []
    real = getattr(owner, attr)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(owner, attr, spy)
    try:
        plan = device_reader.build_plan(reader)
        device_reader.decode_staged(
            plan, device_reader.stage_plan(plan, device), device)
    finally:
        setattr(owner, attr, real)
    return calls


def path_operands(path: str, shapes=PATH_SHAPES) -> dict:
    """For each read-path shape, the arguments of the largest launch of its
    kernel that decoding the column's first row group makes."""
    out = {}
    for column, kernel in shapes:
        calls = first_chunk_calls(path, column, kernels, kernel)
        if not calls:
            raise AssertionError(f"decoding {column} launched no {kernel}")
        out[column] = max(calls, key=lambda args: args[-2])  # n
    return out


def phase_times(path: str) -> dict:
    """Where a warm read's time goes, one chunk after another.  Per column,
    summed over row groups: host prescan (``build_plan``), the staging
    batch's host layout and fill (``pack_s``: ``stage_plan`` recording
    into a batch, then ``pack``), its one H2D copy (``h2d_s``), their sum
    ``stage_s``, and device decode (``decode_staged``), each closed by a
    synchronize."""
    dev = torch.device(DEVICE)
    f = pq.ParquetFile(path)
    columns = {}
    for leaf in f.schema.leaves:
        t = dict.fromkeys(("plan_s", "pack_s", "h2d_s", "stage_s",
                           "decode_s"), 0.0)
        for rg in f.row_groups:
            reader = rg.column(leaf.column_index)
            t0 = time.perf_counter()
            plan = device_reader.build_plan(reader)
            t1 = time.perf_counter()
            batch = device_reader._StagingBatch()
            staged = device_reader.stage_plan(plan, dev, batch.put)
            if batch._slots:
                batch.pack(pin=True)
            t2 = time.perf_counter()
            if batch._slots:
                staged = batch.resolve(staged, batch.send(dev))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            device_reader.decode_staged(plan, staged, dev)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            t["plan_s"] += t1 - t0
            t["pack_s"] += t2 - t1
            t["h2d_s"] += t3 - t2
            t["stage_s"] += t3 - t1
            t["decode_s"] += t4 - t3
        columns[leaf.name] = t
    return columns


def host_allocs() -> int:
    """Pinned blocks the host caching allocator has created so far."""
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


def transfer_audit(prof) -> dict:
    """From a profiler window's trace: its host-to-device copies from
    pageable memory (how many, how many over 1 MiB, the largest) and
    from pinned memory, and the ``cudaHostAlloc`` and ``cudaMalloc``
    calls it recorded."""
    fd, trace = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(trace)
    pageable = [int(e.get("args", {}).get("bytes", 0)) for e in events
                if "HtoD (Pageable -> Device)" in e.get("name", "")]
    copies = {}
    for e in events:
        if e.get("name", "").startswith("Memcpy"):
            copies[e["name"]] = copies.get(e["name"], 0) + 1
    return {"copies": copies, "pageable_htod": len(pageable),
            "pageable_htod_over_1mib": sum(b > 1 << 20 for b in pageable),
            "pageable_htod_max_bytes": max(pageable, default=0),
            "pinned_htod": sum("HtoD (Pinned -> Device)" in e.get("name", "")
                               for e in events),
            "cuda_host_alloc": sum(e.get("name") == "cudaHostAlloc"
                                   for e in events),
            "cuda_malloc": sum(e.get("name") == "cudaMalloc"
                               for e in events)}


def device_profile(run, what: str, audit: bool = False) -> dict:
    """``run()`` (a timed read or lookup returning its result and wall
    seconds) once under ``torch.profiler``: its wall time, the ten event
    names with the most device time, and the device's idle share of the
    wall time (None where the profiler saw no device time: not
    measured).  With ``audit``, the window's transfers
    (:func:`transfer_audit`) and the pinned blocks created in it: a read
    after warm-up must copy nothing over 1 MiB from pageable memory and
    allocate no pinned memory."""
    allocs = host_allocs()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = run()
    allocs = host_allocs() - allocs
    by_name = device_times_us(prof)
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {f"profiled_{what}_s": wall_s, "device_busy_s": busy_s or None,
           "device_idle_share": 1 - busy_s / wall_s if busy_s else None,
           "top_device_us": dict(top)}
    if audit:
        t = out["transfers"] = {**transfer_audit(prof),
                                "pinned_blocks_created": allocs}
        if t["pageable_htod_over_1mib"] or t["cuda_host_alloc"] or allocs:
            raise AssertionError(f"profiled {what}: pageable copies over "
                                 f"1 MiB or pinned allocations left: {t}")
    return out


def audited_read(path: str) -> dict:
    """One warm read of ``path``, then one under the profiler, audited
    (:func:`device_profile`): the first holds in the caching allocators
    the blocks a read of the file takes, so the second needs no new one
    unless the read makes fresh allocations."""
    timed_read(path)
    return device_profile(lambda: timed_read(path), "read", audit=True)


def device_times_us(prof) -> dict:
    """Device microseconds by event name: the kernels and copies the card
    ran.  The host-side operator events that launched them are left out,
    since the profiler also credits them with their kernels' time."""
    out = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def device_ms(fn, kernel: str = "", reps: int = 20, tries: int = 5):
    """Device milliseconds per call of ``fn``, a call that launches one
    device kernel whose name holds ``kernel`` (any name by default): the
    mean duration of those kernels over ``reps`` calls, from the profiler,
    the host's dispatch left out.  The profiler drops some of a window's
    device events now and then (more often after a long profiled session),
    so the mean is over the events it recorded, and a window that recorded
    fewer than half of them is profiled again, up to ``tries`` times.
    Where no window did, CUDA events around back-to-back calls time it
    (:func:`time_ms`), and ``PROFILER_FALLBACKS`` names the call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, events = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0 and kernel in e.key):
                us += e.self_device_time_total
                events += e.count
        if events >= reps / 2:
            return us / events / 1e3
    PROFILER_FALLBACKS.append(kernel or getattr(fn, "__name__", "call"))
    return time_ms(fn)


#: the timings the profiler recorded nothing for, taken with CUDA events
PROFILER_FALLBACKS: list = []


H2D_PROBE_BYTES = 256 << 20
PCIE5_X16_BYTES_PER_S = 63e9  # nominal, one direction (PCIe Gen5 x16)


def h2d_peak(card: str) -> dict:
    """The host link's copy rate: 256 MiB from the host to the card, best
    of 5 after one warm-up, CUDA events, from pinned and from pageable
    memory; and whether the first pinned allocation shows as a new
    block of the host caching allocator (it must, or the read's audit
    could not see one) and as a ``cudaHostAlloc`` in the profiler's
    trace."""
    allocs = host_allocs()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pinned = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8,
                             pin_memory=True)
    seen = transfer_audit(prof)["cuda_host_alloc"]
    allocs = host_allocs() - allocs
    if not allocs:
        raise AssertionError("the first pinned allocation created no "
                             "pinned block: the audit cannot see one")
    pageable = torch.ones(H2D_PROBE_BYTES, dtype=torch.uint8)
    pinned.fill_(1)
    target = torch.empty(H2D_PROBE_BYTES, dtype=torch.uint8, device=DEVICE)

    def best_ms(src) -> float:
        times = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            target.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times[1:])

    pin_ms, page_ms = best_ms(pinned), best_ms(pageable)
    return {"card": card, "bytes": H2D_PROBE_BYTES, "pinned_ms": pin_ms,
            "pinned_gb_per_s": H2D_PROBE_BYTES / pin_ms / 1e6,
            "pageable_ms": page_ms,
            "pageable_gb_per_s": H2D_PROBE_BYTES / page_ms / 1e6,
            "nominal_gb_per_s": PCIE5_X16_BYTES_PER_S / 1e9,
            "cuda_host_alloc_seen": seen}


def pipeline_breakdown(path: str) -> dict:
    """One warm read of ``path`` serial (``workers=0``) and one pipelined
    (the default), each with the wall seconds every thread spent in each
    step, summed over threads: the whole prescan (``plan_s``,
    ``build_plan``), in it the C++ planner's call (``walk_s``,
    ``host.chunk_plan``: the pages' decompression and walk), the page
    decompression outside it (``decompress_s``: codecs without a batched
    C++ decoder) and the Python walk's (``python_walk_s``),
    ``stage_plan``'s recording (``record_s``), the batch's fill
    (``pack_s``) and copy (``send_s``), the decode (``decode_s``), and
    the decoding thread's waits for a worker (``wait_s``).  Where a step
    takes longer pipelined than serial, the threads slowed each other."""
    from concurrent.futures import Future

    out = {}
    main_thread = threading.main_thread()
    for mode, workers in (("serial", 0), ("pipelined", 2)):
        acc = {}
        lock = threading.Lock()

        def add(key, dt):
            with lock:
                acc[key] = acc.get(key, 0.0) + dt

        saved = []

        def timed(owner, attr, key, when=None):
            real = getattr(owner, attr)
            saved.append((owner, attr, real))

            def run(*a, **k):
                if when is not None and not when(a, k):
                    return real(*a, **k)
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    add(key, time.perf_counter() - t0)

            setattr(owner, attr, run)

        timed(device_reader, "build_plan", "plan_s")
        timed(host, "chunk_plan", "walk_s")
        timed(device_reader, "_build_plan_python", "python_walk_s")
        timed(device_reader, "data_page_bodies", "decompress_s")
        # the recording only: ``stage_plan`` without a batch records into
        # its own (a call with one), then packs and sends it
        timed(device_reader, "stage_plan", "record_s",
              lambda a, k: len(a) > 2 or "put" in k)
        timed(device_reader._StagingBatch, "pack", "pack_s")
        timed(device_reader._StagingBatch, "send", "send_s")
        timed(device_reader, "decode_staged", "decode_s")
        timed(Future, "result", "wait_s",
              lambda a, k: threading.current_thread() is main_thread)
        try:
            f = pq.ParquetFile(path)
            rgs = f.row_groups
            chunks = [rg.column(leaf.column_index)
                      for leaf in f.schema.leaves for rg in rgs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = device_reader.decode_chunks_pipelined(
                chunks, torch.device(DEVICE), workers)
            for _ in chunks:
                next(gen)
            gen.close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for owner, attr, real in reversed(saved):
                setattr(owner, attr, real)
        out[mode] = {"wall_s": wall, **acc}
    return out


def native_thread_choice(path: str) -> dict:
    """Warm pipelined reads of ``path`` with each staging worker's native
    decompression threads at 1 (the JAX package's choice) and at the
    default (the cores this process may use over the two workers), in
    turns: default, 1, 1, default."""
    real = device_reader._native_threads
    default = real(2)
    times = {"1": [], str(default): []}
    for n in (default, 1, 1, default):
        device_reader._native_threads = lambda workers, n=n: n
        try:
            _, s = timed_read(path)
        finally:
            device_reader._native_threads = real
        times[str(n)].append(s)
    return {"cpus": host.available_cpus(), "workers": 2,
            "default_threads": default, "read_s": times}


# ---------------------------------------------------------------------------
# phase 4b: lineitem; phase 4c: every other value encoding
# ---------------------------------------------------------------------------

LINEITEM_ROW_GROUP = 4_000_000  # bench.py:_lineitem_path
LINEITEM_STRINGS = {  # bench.py:_lineitem_path's categoricals
    "l_returnflag": ["A", "N", "R"],
    "l_linestatus": ["F", "O"],
    "l_shipinstruct": ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                       "TAKE BACK RETURN"],
    "l_shipmode": ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"],
}
LINEITEM_ORDER = (
    "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
    "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
    "l_shipinstruct", "l_shipmode", "l_comment")
LINEITEM_ENCODINGS = {name: (Encoding.RLE_DICTIONARY
                             if name in LINEITEM_STRINGS else Encoding.PLAIN)
                      for name in LINEITEM_ORDER}


def make_lineitem(rows: int, seed: int) -> tuple:
    """TPC-H ``lineitem`` at ``bench.py:_lineitem_path``'s widths and
    cardinalities, from ``seed``: ``(schema, {name: ColumnData})``.  The
    four categoricals are byte arrays of 3, 2, 4 and 7 values, ``l_comment``
    27 random letters or spaces."""
    rng = np.random.default_rng(seed + 5)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    ship = rng.integers(8000, 12000, rows).astype(np.int32)
    numeric = {
        "l_orderkey": np.sort(rng.integers(1, rows, rows)).astype(np.int64),
        "l_partkey": rng.integers(1, 200_000, rows).astype(np.int64),
        "l_suppkey": rng.integers(1, 10_000, rows).astype(np.int64),
        "l_linenumber": rng.integers(1, 8, rows).astype(np.int32),
        "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
        "l_extendedprice": rng.random(rows) * 1e5,
        "l_discount": np.round(rng.random(rows) * 0.1, 2),
        "l_tax": np.round(rng.random(rows) * 0.08, 2),
        "l_shipdate": ship,
        "l_commitdate": ship + rng.integers(-30, 30, rows).astype(np.int32),
        "l_receiptdate": ship + rng.integers(1, 30, rows).astype(np.int32),
    }
    leaves, data = [], {}
    for name in LINEITEM_ORDER:
        if name in LINEITEM_STRINGS:
            words = [w.encode() for w in LINEITEM_STRINGS[name]]
            dv, do = _pool(words)
            values, offsets = gather_byte_arrays(
                dv, do, rng.integers(0, len(words), rows))
            data[name] = ColumnData(values=values, offsets=offsets)
            leaves.append(Leaf(-1, name, Type.BYTE_ARRAY, string=True))
        elif name == "l_comment":
            data[name] = ColumnData(
                values=letters[rng.integers(0, 27, rows * 27,
                                            dtype=np.int8)],
                offsets=np.arange(rows + 1, dtype=np.int64) * 27)
            leaves.append(Leaf(-1, name, Type.BYTE_ARRAY, string=True))
        else:
            data[name] = ColumnData(values=numeric[name])
            leaves.append(Leaf(-1, name,
                               physical_of_dtype(numeric[name].dtype)))
    return Schema(leaves), data


def _pool(items) -> tuple:
    """A list of bytes as (values, offsets)."""
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offsets[1:])
    return np.frombuffer(b"".join(items), np.uint8), offsets


ENC_ROW_GROUP = 1 << 20
ENC_PAGE = 64 << 10
# name -> (physical, type_length, encoding, null share)
ENC_COLUMNS = {
    "bool_plain": (Type.BOOLEAN, None, Encoding.PLAIN, 0.07),
    "bool_rle": (Type.BOOLEAN, None, Encoding.RLE, 0.0),
    "i96": (Type.INT96, None, Encoding.PLAIN, 0.05),
    "flba16": (Type.FIXED_LEN_BYTE_ARRAY, 16, Encoding.PLAIN, 0.05),
    "flba2_bss": (Type.FIXED_LEN_BYTE_ARRAY, 2, Encoding.BYTE_STREAM_SPLIT,
                  0.1),
    "flba4_bss": (Type.FIXED_LEN_BYTE_ARRAY, 4, Encoding.BYTE_STREAM_SPLIT,
                  0.0),
    "f32_bss": (Type.FLOAT, None, Encoding.BYTE_STREAM_SPLIT, 0.06),
    "f64_bss": (Type.DOUBLE, None, Encoding.BYTE_STREAM_SPLIT, 0.0),
    "i32_bss": (Type.INT32, None, Encoding.BYTE_STREAM_SPLIT, 0.08),
    "i64_bss": (Type.INT64, None, Encoding.BYTE_STREAM_SPLIT, 0.0),
    "ba_dlba": (Type.BYTE_ARRAY, None, Encoding.DELTA_LENGTH_BYTE_ARRAY,
                0.05),
    "ba_dba": (Type.BYTE_ARRAY, None, Encoding.DELTA_BYTE_ARRAY, 0.0),
    "ba_dict": (Type.BYTE_ARRAY, None, Encoding.RLE_DICTIONARY, 0.0),
    "flba_dict": (Type.FIXED_LEN_BYTE_ARRAY, 16, Encoding.RLE_DICTIONARY,
                  0.0),
}
ENC_DENSE = ("ba_dict", "flba_dict")  # every index run bit-packed


def _urls(rng, n: int) -> tuple:
    """``n`` sorted URL-like byte strings with long shared prefixes: one of
    eight long paths, then a 12-digit item number."""
    paths = sorted(f"https://www.example-store-{h}.com/catalog/department-"
                   f"{h * 7 % 5}/category/{'sub/' * h}item-".encode()
                   for h in range(8))
    host = rng.integers(0, 8, n)
    num = rng.integers(0, 10**12, n)
    order = np.lexsort((num, host))
    host, num = host[order], num[order]
    head, head_offs = gather_byte_arrays(*_pool(paths), host)
    hl = np.diff(head_offs)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(hl + 12, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)
    out[np.repeat(offs[:-1], hl) + segment_ranges(hl)] = head
    out[(offs[:-1] + hl)[:, None] + np.arange(12)] = (
        num[:, None] // 10 ** np.arange(11, -1, -1) % 10 + 48)
    return out, offs


def make_enc(rows: int, seed: int) -> tuple:
    """The ``enc`` table, from ``seed``: every (type, encoding) pair of the
    read path that lineitem lacks, 5-10 % nulls on half of the columns.
    ``(schema, {name: ColumnData})``."""
    rng = np.random.default_rng(seed + 6)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    leaves, data = [], {}
    for name, (physical, tl, _, nulls) in ENC_COLUMNS.items():
        validity = rng.random(rows) >= nulls if nulls else None
        n = rows if validity is None else int(validity.sum())
        offsets = None
        if physical == Type.BOOLEAN:
            values = rng.random(n) < 0.3
        elif physical == Type.INT96:
            values = rng.integers(-2**31, 2**31, (n, 3)).astype(np.int32)
        elif name == "flba_dict":  # 500 entries: w = 9
            pool = rng.integers(0, 256, (500, 16), dtype=np.uint8)
            values = pool[rng.integers(0, 500, n)]
        elif physical == Type.FIXED_LEN_BYTE_ARRAY:
            values = rng.integers(0, 256, (n, tl), dtype=np.uint8)
        elif physical in (Type.FLOAT, Type.DOUBLE):
            values = (rng.standard_normal(n) * 1000).astype(
                np.float32 if physical == Type.FLOAT else np.float64)
        elif physical in (Type.INT32, Type.INT64):
            values = rng.integers(-10**6, 10**6, n).astype(
                np.int32 if physical == Type.INT32 else np.int64)
        elif name == "ba_dlba":
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(rng.integers(0, 40, n), out=offsets[1:])
            values = letters[rng.integers(0, 26, int(offsets[-1]),
                                          dtype=np.int8)]
        elif name == "ba_dba":
            values, offsets = _urls(rng, n)
        else:  # ba_dict: 1,000 city-like names (w = 10)
            names = [f"City-{i:04d}-{'ville' * (i % 4)}".encode()
                     for i in range(1000)]
            values, offsets = gather_byte_arrays(*_pool(names),
                                                 rng.integers(0, 1000, n))
        data[name] = ColumnData(values=values, validity=validity,
                                offsets=offsets)
        leaves.append(Leaf(-1, name, physical, 1 if nulls else 0, tl))
    return Schema(leaves), data


def check_columns(out: dict, data: dict) -> None:
    """Each decoded column, materialized on the host, against its generated
    values, offsets and validity."""
    for name, cd in data.items():
        col = out[name]
        on = (col.values if col.values is not None
              else col.dict_indices).device
        if on.type != torch.device(DEVICE).type:
            raise AssertionError(f"{name}: decoded on {on}")
        if cd.validity is None:
            if col.validity is not None and not bool(col.validity.all()):
                raise AssertionError(f"{name}: unexpected nulls")
        elif col.validity is None or not np.array_equal(
                col.validity.cpu().numpy(), cd.validity):
            raise AssertionError(f"{name}: validity differs")
        got = col.materialize_host()
        if cd.offsets is not None:
            if not (np.array_equal(got[1], cd.offsets)
                    and np.array_equal(got[0], cd.values)):
                raise AssertionError(f"{name}: byte arrays differ")
            continue
        want = np.asarray(cd.values)
        if got.dtype != want.dtype or got.shape != want.shape or \
                not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"{name}: values differ")


def read_and_check(path: str, data: dict, reads: int,
                   check=check_columns) -> dict:
    """One cold read and ``reads - 1`` warm ones, each equal to ``data``
    (by ``check``) and each on the device route alone, with each kernel's
    launches by column over them, which must add up to the wrappers'."""
    with ColumnLaunches() as by_column:
        pq.reset_launches()
        reset_routes()
        pq.reset_pipeline()
        out, cold_s = timed_read(path)
        check(out, data)
        nbytes = decoded_bytes(out)
        warm = []
        for _ in range(reads - 1):
            del out
            out, s = timed_read(path)
            warm.append(s)
            check(out, data)
        launches = dict(pq.LAUNCHES)
        pipeline = dict(pq.PIPELINE)
        plan_route = dict(pq.PLAN_ROUTE)
    no_host_route(path)
    same_bits(out, serial_read(path), path)
    del out
    for name, count in launches.items():
        counted = sum(c.get(name, 0) for c in by_column.counts.values())
        if counted != count:
            raise AssertionError(f"{name}: {counted} launches counted by "
                                 f"column, {count} by the wrapper")
    return {"cold_read_s": cold_s, "warm_read_s": warm,
            "decoded_bytes": nbytes, "launches": launches,
            "pipeline": pipeline, "plan_route": plan_route,
            "column_launches": by_column.counts}


def lineitem_path(rows: int, seed: int, tmp: str) -> dict:
    """Phase 4b: the port's writer makes lineitem (Snappy, 4,000,000-row
    row groups, 1 MiB pages, page index), read cold and three times warm
    on the card, each read equal to the generated columns; then each
    column alone and the read's phases."""
    t0 = time.perf_counter()
    schema, data = make_lineitem(rows, seed)
    gen_s = time.perf_counter() - t0
    path = os.path.join(tmp, "lineitem.parquet")
    t0 = time.perf_counter()
    pq.write_table(data, path, pq.WriterOptions(
        compression="snappy", row_group_size=LINEITEM_ROW_GROUP,
        data_page_size=1 << 20, column_encoding=LINEITEM_ENCODINGS),
        schema=schema)
    write_s = time.perf_counter() - t0
    got = read_and_check(path, data, 4)
    del data
    best = min(got["warm_read_s"])
    native = native_thread_choice(path)
    per_column = {}
    for name in LINEITEM_ORDER:
        _, per_column[name] = timed_read(path, [name])
    log({"lineitem_path": {
        "rows": rows, "cut": "rows only: 8,388,608 by default of bench.py "
        "cfg 7's 40,000,000, so the host-Python writer and the reads fit "
        "the run; every column, width and cardinality kept",
        "row_groups": -(-rows // LINEITEM_ROW_GROUP),
        "file_bytes": os.path.getsize(path), "generate_s": gen_s,
        "write_s": write_s, **got, "rows_per_s": rows / best,
        "decoded_bytes_formula": "values + int64 byte-array offsets + the "
        "int32 indexes of columns kept dictionary-encoded (dictionaries "
        "left out) = 123 B a row",
        "decoded_gb_per_s": got["decoded_bytes"] / best / 1e9,
        "column_read_s": per_column, "native_threads": native,
        "unpack_bits_dense_by_column": {
            c: got["column_launches"].get(c, {}).get("unpack_bits_dense", 0)
            for c in LINEITEM_ORDER}}})
    return {"path": path, "columns": phase_times(path),
            "launches": got["launches"], "best_s": best}


def enc_path(rows: int, seed: int, tmp: str) -> dict:
    """Phase 4c: ``enc`` written with v1 pages under Snappy and with v2
    pages (each read cold and warm), then under every other codec whose
    library loaded (read once), each read equal to the generated columns,
    and the v1 Snappy file's read by column and phase;
    ``unpack_bits_dense`` must launch on both dense dictionary columns in
    every read."""
    schema, data = make_enc(rows, seed)
    libs = {c.name: codecs.system_library(*names)
            for c, names in codecs.LIBRARIES.items()}
    log({"codecs": {**libs, "SNAPPY": "the port's own "
                    "(parquet_tpu_torch/csrc/host_codec.cpp)",
                    "GZIP": "zlib", "not_run": sorted(
                        n for n, lib in libs.items() if lib is None)}})
    files = [("v1-SNAPPY", 1, "snappy"), ("v2-SNAPPY", 2, "snappy")]
    files += [(f"v1-{name}", 1, name.lower())
              for name, lib in libs.items() if lib is not None]
    results = {}
    for label, version, codec in files:
        path = os.path.join(tmp, f"enc-{label}.parquet")
        t0 = time.perf_counter()
        pq.write_table(data, path, pq.WriterOptions(
            compression=codec, data_page_version=version,
            row_group_size=ENC_ROW_GROUP, data_page_size=ENC_PAGE,
            column_encoding={n: spec[2] for n, spec in ENC_COLUMNS.items()}),
            schema=schema)
        write_s = time.perf_counter() - t0
        got = read_and_check(path, data, 2 if codec == "snappy" else 1)
        for name in ENC_DENSE:
            if not got["column_launches"].get(name, {}).get(
                    "unpack_bits_dense"):
                raise AssertionError(f"enc {label}: {name} launched no "
                                     "unpack_bits_dense")
        results[label] = {"file_bytes": os.path.getsize(path),
                          "write_s": write_s, **got}
        if label not in ("v1-SNAPPY", "v1-ZSTD"):
            os.remove(path)
    first = os.path.join(tmp, "enc-v1-SNAPPY.parquet")
    log({"enc_path": {"rows": rows, "row_groups": -(-rows // ENC_ROW_GROUP),
                      "page_bytes": ENC_PAGE, "files": results,
                      "v1_snappy_columns": phase_times(first)}})
    return {"path": first, "launches": results["v1-SNAPPY"]["launches"],
            "column_launches": results["v1-SNAPPY"]["column_launches"],
            "zstd_path": os.path.join(tmp, "enc-v1-ZSTD.parquet")
            if "v1-ZSTD" in results else None}


# ---------------------------------------------------------------------------
# phase 4d: nested columns, and the host route's fixture
# ---------------------------------------------------------------------------

NEST_MIX_ROW_GROUP = 1 << 18
NEST_MIX_PAGE = 64 << 10
NEST_MIX_ENCODINGS = {
    "tags.list.element": Encoding.RLE_DICTIONARY,
    "scores.list.element": Encoding.RLE_DICTIONARY,
    "attrs.key_value.key": Encoding.RLE_DICTIONARY,
    "attrs.key_value.value": Encoding.PLAIN,
    "pt.x": Encoding.PLAIN, "pt.y": Encoding.PLAIN,
    "pt.label": Encoding.RLE_DICTIONARY,
    "grid.list.element.list.element": Encoding.PLAIN,
}
NEST_KERNELS = {"ts.list.element": "unpack_bits_dense",
                "tags.list.element": "unpack_bits_dense",
                "scores.list.element": "dict_unpack_gather"}


def make_cfg4(n: int, seed: int) -> tuple:
    """``bench.py:_build4(n, seed)``'s table: ``n // 4`` rows of a
    ``list<int64>``, each 0-7 cumulative timestamps with uniform 0-999
    deltas, 5 % of rows empty lists (generator seeded 13, as the bench's).
    ``(schema, {leaf: ColumnData}, {leaf: expected})``."""
    rng = np.random.default_rng(13)
    lens = rng.integers(0, 8, max(n // 4, 1))
    lens[rng.random(len(lens)) < 0.05] = 0
    total = int(lens.sum())
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    base = 1_700_000_000_000_000 + seed * 977_777 + np.cumsum(
        rng.integers(0, 1000, max(total, 1)).astype(np.int64))
    values = base[:total]
    schema = S.message("schema", [S.list_of("ts", S.optional(S.leaf(
        "element", Type.INT64)))])
    name = "ts.list.element"
    return schema, {name: ColumnData(values, list_offsets=[offs])}, {
        name: {"values": values, "validity": None, "list_offsets": [offs],
               "list_validity": [None]}}


def _lists(rng, rows: int, most: int, null_share: float) -> tuple:
    """Offsets of ``rows`` lists of 0..``most`` entries and their validity
    (None without nulls); a null list holds no entries."""
    valid = rng.random(rows) >= null_share if null_share else None
    lens = rng.integers(0, most + 1, rows)
    if valid is not None:
        lens[~valid] = 0
    offs = np.zeros(rows + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, valid


def make_nest_mix(rows: int, seed: int) -> tuple:
    """The mixed nested table, from ``seed``: ``(schema, {leaf:
    ColumnData}, {leaf: expected})``.  ``tags``: 0-4 names a row of a
    1,000-entry pool drawn uniformly (w = 10, every index run bit-packed);
    ``scores``: 0-6 int32 a row of 200 values, 5 % null lists, 5 % null
    elements; ``attrs``: 0-3 distinct keys a row of 40, 4 % null maps, 5 %
    null values; ``pt``: 10 % null structs, 20 % of the others without a
    label; ``grid``: 0-3 lists of 0-3 int64, 3 % null at both levels, 2 %
    null elements."""
    rng = np.random.default_rng(seed + 7)
    data, want = {}, {}

    def put(name, cd, validity, offsets, list_validity, def_levels=None):
        data[name] = cd
        values = (cd.values if cd.offsets is None
                  else (cd.values, cd.offsets))
        want[name] = {"values": values, "validity": validity,
                      "list_offsets": offsets,
                      "list_validity": list_validity}
        if def_levels is not None:
            want[name]["def_levels"] = def_levels

    offs, _ = _lists(rng, rows, 4, 0.0)
    names = [f"tag-{i:04d}-{'x' * (i % 5)}".encode() for i in range(1000)]
    v, o = gather_byte_arrays(*_pool(names),
                              rng.integers(0, 1000, int(offs[-1])))
    put("tags.list.element", ColumnData(v, offsets=o, list_offsets=[offs]),
        None, [offs], [None])

    offs, lv = _lists(rng, rows, 6, 0.05)
    ev = rng.random(int(offs[-1])) >= 0.05
    v = (rng.integers(0, 200, int(ev.sum())) * 7 - 300).astype(np.int32)
    put("scores.list.element", ColumnData(v, ev, list_offsets=[offs],
                                          list_validity=[lv]),
        ev, [offs], [lv])

    offs, lv = _lists(rng, rows, 3, 0.04)
    n = int(offs[-1])
    j = np.arange(n) - np.repeat(offs[:-1], np.diff(offs))
    key = (np.repeat(rng.integers(0, 40, rows), np.diff(offs)) + 3 * j) % 40
    kv, ko = gather_byte_arrays(*_pool([f"attr-{i}".encode()
                                        for i in range(40)]), key)
    put("attrs.key_value.key", ColumnData(kv, offsets=ko,
                                          list_offsets=[offs],
                                          list_validity=[lv]),
        None, [offs], [lv])
    vv = rng.random(n) >= 0.05
    put("attrs.key_value.value", ColumnData(
        rng.integers(-10**12, 10**12, int(vv.sum())), vv,
        list_offsets=[offs], list_validity=[lv]), vv, [offs], [lv])

    sv = rng.random(rows) >= 0.10
    labelled = sv & (rng.random(rows) >= 0.2)
    for c in ("x", "y"):
        put(f"pt.{c}", ColumnData(rng.random(int(sv.sum())) * 360 - 180, sv),
            sv, [], [])
    d = sv.astype(np.int32) + labelled
    lv_, lo = gather_byte_arrays(*_pool([f"label-{i}".encode()
                                        for i in range(500)]),
                                 rng.integers(0, 500, int(labelled.sum())))
    put("pt.label", ColumnData(lv_, offsets=lo, def_levels=d), labelled,
        [], [], d)

    o1, v1 = _lists(rng, rows, 3, 0.03)
    o2, v2 = _lists(rng, int(o1[-1]), 3, 0.03)
    ev = rng.random(int(o2[-1])) >= 0.02
    put("grid.list.element.list.element", ColumnData(
        rng.integers(-10**6, 10**6, int(ev.sum())), ev,
        list_offsets=[o1, o2], list_validity=[v1, v2]),
        ev, [o1, o2], [v1, v2])

    el = S.optional(S.leaf("element", Type.INT64))
    schema = S.message("schema", [
        S.list_of("tags", S.leaf("element", Type.BYTE_ARRAY,
                                 logical=LogicalKind.STRING)),
        S.list_of("scores", S.optional(S.leaf("element", Type.INT32))),
        S.map_of("attrs", S.leaf("key", Type.BYTE_ARRAY,
                                 logical=LogicalKind.STRING),
                 S.optional(S.leaf("value", Type.INT64))),
        S.group("pt", [S.leaf("x", Type.DOUBLE), S.leaf("y", Type.DOUBLE),
                       S.optional(S.leaf("label", Type.BYTE_ARRAY,
                                         logical=LogicalKind.STRING))],
                S.Rep.OPTIONAL),
        S.list_of("grid", S.list_of("element", el))])
    return schema, data, want


def _equal(got, want) -> bool:
    if isinstance(want, tuple):
        return all(np.array_equal(g, w) for g, w in zip(got, want))
    want = np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _mask_equal(got, want) -> bool:
    """A decoded mask (a tensor or None) against the expected one (None:
    all valid)."""
    if want is None:
        return got is None or bool(got.all())
    return got is not None and np.array_equal(got.cpu().numpy(), want)


def check_nested(out: dict, want: dict) -> None:
    """Each leaf's values, validity, list offsets and list validity of every
    level (and def levels where given) against the generated arrays."""
    for name, w in want.items():
        col = out[name]
        on = (col.values if col.values is not None
              else col.dict_indices).device
        if on.type != torch.device(DEVICE).type or any(
                o.device.type != on.type for o in col.list_offsets):
            raise AssertionError(f"{name}: decoded on {on}")
        got = col.materialize_host()
        values = got["values"] if isinstance(got, dict) else got
        if not _equal(values, w["values"]):
            raise AssertionError(f"{name}: values differ")
        if not _mask_equal(col.validity, w["validity"]):
            raise AssertionError(f"{name}: validity differs")
        if len(col.list_offsets) != len(w["list_offsets"]):
            raise AssertionError(f"{name}: {len(col.list_offsets)} levels")
        for k, (o, wo) in enumerate(zip(col.list_offsets,
                                        w["list_offsets"])):
            if o.dtype != torch.int64 or not np.array_equal(
                    o.cpu().numpy(), wo):
                raise AssertionError(f"{name}: offsets of level {k} differ")
            if not _mask_equal(col.list_validity[k], w["list_validity"][k]):
                raise AssertionError(f"{name}: list validity of level {k} "
                                     "differs")
        if "def_levels" in w and not np.array_equal(col.def_levels,
                                                    w["def_levels"]):
            raise AssertionError(f"{name}: def levels differ")


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_fixtures")


def host_route_fixture() -> dict:
    """``tests/torch_fixtures/host_route.parquet`` (pyarrow: dictionaries
    that overflow into PLAIN pages mid-chunk) read on the card, equal to
    ``host_route.npz``'s arrays, ``HOST_ROUTE`` counting each chunk once
    and nothing else."""
    want = np.load(os.path.join(FIXTURES, "host_route.npz"))
    expected = {"k": {"values": want["k"], "validity": None,
                      "list_offsets": [], "list_validity": []},
                "s": {"values": (want["s_values"], want["s_offsets"]),
                      "validity": None, "list_offsets": [],
                      "list_validity": []},
                "l.list.element": {
                    "values": want["l_values"], "validity": want["l_validity"],
                    "list_offsets": [want["l_offsets"]],
                    "list_validity": [want["l_list_validity"]]}}
    reset_routes()
    pq.reset_launches()
    out, read_s = timed_read(os.path.join(FIXTURES, "host_route.parquet"))
    counted = dict(pq.HOST_ROUTE)
    plan_route = dict(pq.PLAN_ROUTE)
    check_nested(out, expected)
    chunks = int(want["host_route_chunks"])
    if counted["mixed_page_kinds"] != chunks or \
            sum(counted.values()) != chunks:
        raise AssertionError(f"host route counted {counted}, expected "
                             f"{chunks} mixed_page_kinds chunks")
    same_bits(out, serial_read(os.path.join(FIXTURES, "host_route.parquet")),
              "the host-route fixture")
    return {"read_s": read_s, "host_route": counted,
            "plan_route": plan_route, "launches": dict(pq.LAUNCHES)}


def nested_path(n: int, mix_rows: int, seed: int, tmp: str) -> dict:
    """Phase 4d: cfg 4 and the mixed nested file written by the port's
    writer and read on the card, each read equal to the generated leaves
    with no chunk on the host route; the kernels' launches by leaf; the
    host-route fixture."""
    t0 = time.perf_counter()
    schema, data, want = make_cfg4(n, seed)
    gen_s = time.perf_counter() - t0
    path = os.path.join(tmp, "cfg4.parquet")
    t0 = time.perf_counter()
    pq.write_table(data, path, pq.WriterOptions(column_encoding={
        "ts.list.element": Encoding.DELTA_BINARY_PACKED},
        compression="uncompressed"), schema=schema)
    write_s = time.perf_counter() - t0
    got = read_and_check(path, want, 4, check_nested)
    rows = n // 4
    best = min(got["warm_read_s"])
    cfg4 = {"n": n, "rows": rows, "elements": len(data[
        "ts.list.element"].values), "row_groups": -(-rows // ROW_GROUP),
        "file_bytes": os.path.getsize(path), "generate_s": gen_s,
        "write_s": write_s, **got, "rows_per_s": rows / best,
        "decoded_bytes_formula": "int64 values + int64 list offsets + one "
        "validity byte per element and per list",
        "decoded_gb_per_s": got["decoded_bytes"] / best / 1e9}
    if not got["column_launches"].get("ts.list.element", {}).get(
            "unpack_bits_dense"):
        raise AssertionError("cfg 4: ts launched no unpack_bits_dense")
    del data, want

    t0 = time.perf_counter()
    schema, data, want = make_nest_mix(mix_rows, seed)
    gen_s = time.perf_counter() - t0
    mix_path = os.path.join(tmp, "nest_mix.parquet")
    t0 = time.perf_counter()
    pq.write_table(data, mix_path, pq.WriterOptions(
        compression="snappy", row_group_size=NEST_MIX_ROW_GROUP,
        data_page_size=NEST_MIX_PAGE, column_encoding=NEST_MIX_ENCODINGS),
        schema=schema)
    write_s = time.perf_counter() - t0
    got = read_and_check(mix_path, want, 2, check_nested)
    for leaf, kernel in NEST_KERNELS.items():
        if leaf in want and not got["column_launches"].get(leaf, {}).get(
                kernel):
            raise AssertionError(f"nest_mix: {leaf} launched no {kernel}")
    mix = {"rows": mix_rows, "row_groups": -(-mix_rows
                                            // NEST_MIX_ROW_GROUP),
           "page_bytes": NEST_MIX_PAGE, "file_bytes":
           os.path.getsize(mix_path), "generate_s": gen_s,
           "write_s": write_s, **got,
           "rows_per_s": mix_rows / min(got["warm_read_s"])}
    del data, want
    fixture = host_route_fixture()
    log({"nested_path": {"cfg4": cfg4, "nest_mix": mix,
                         "host_route_fixture": fixture}})
    return {"path": path, "mix_path": mix_path,
            "launches": cfg4["launches"], "mix_launches": mix["launches"],
            "column_launches": {**cfg4["column_launches"],
                                **mix["column_launches"]},
            "columns": phase_times(path)}


# ---------------------------------------------------------------------------
# phase 4e: the host prescan's C++ entry points against their Python versions
# ---------------------------------------------------------------------------

# entry point -> (owner, attribute) of its wrapper on the read path
PRESCAN_ENTRIES = {
    "pq_scan_rle_runs": (host, "scan_rle_runs"),
    "pq_count_target_in_runs": (host, "count_present"),
    "pq_delta_prescan": (host, "delta_prescan"),
    "pq_delta_decode": (host, "decode_delta_binary_packed"),
    "pq_scan_page_headers": (host, "scan_page_headers"),
    "pq_decompress_pages": (host, "decompress_pages"),
    "pq_chunk_plan": (host, "chunk_plan"),
}


def host_calls(path: str) -> dict:
    """Calls of each prescan entry point that one read of ``path`` makes:
    ``build_plan`` of every chunk, the wrappers counted."""
    counts = dict.fromkeys(PRESCAN_ENTRIES, 0)
    saved = {}
    for entry, (owner, attr) in PRESCAN_ENTRIES.items():
        fn = saved[entry] = getattr(owner, attr)

        def counted(*a, _fn=fn, _entry=entry, **k):
            counts[_entry] += 1
            return _fn(*a, **k)

        setattr(owner, attr, counted)
    try:
        f = pq.ParquetFile(path)
        for leaf in f.schema.leaves:
            for rg in f.row_groups:
                device_reader.build_plan(rg.column(leaf.column_index))
    finally:
        for entry, (owner, attr) in PRESCAN_ENTRIES.items():
            setattr(owner, attr, saved[entry])
    return counts


def host_ms(fn, reps: int) -> float:
    """Median wall milliseconds of ``reps`` calls of the host function
    ``fn``, after one call to warm it."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def chunk_pages(path: str, column: str):
    """One row group's chunk of ``column``: its reader, its pages, their
    decompressed bodies and, per data page, its value count, its level
    streams (RLE, the writer's) and where its values start."""
    f = pq.ParquetFile(path)
    leaf = f.schema.leaf(column)
    reader = f.row_groups[0].column(leaf.column_index)
    pages = list(reader.pages())
    bodies = data_page_bodies(reader, pages)
    streams = []
    for page, raw in zip(pages, bodies):
        if raw is None:
            continue
        h = page.header
        levels = {}
        if page.page_type == PageType.DATA_PAGE:
            n, pos = h.data_page_header.num_values, 0
            for kind, top in (("rep", leaf.max_repetition_level),
                              ("def", leaf.max_definition_level)):
                if top:
                    length = int(raw[pos:pos + 4].view("<u4")[0])
                    levels[kind] = raw[pos + 4:pos + 4 + length]
                    pos += 4 + length
        else:
            dph2 = h.data_page_header_v2
            n, pos = dph2.num_values, 0
            rl = dph2.repetition_levels_byte_length or 0
            dl = dph2.definition_levels_byte_length or 0
            payload = host.as_u8(page.payload)
            levels = {"rep": payload[:rl], "def": payload[rl:rl + dl]}
        streams.append({"n": n, "raw": raw, "pos": pos, **levels})
    return reader, leaf, pages, streams


def _same(a, b) -> bool:
    """Equal outputs: tuples and lists item by item, arrays by value and
    dtype."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        b = np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def prescan_row(entry: str, chunk: str, cpp, python, reps: int,
                calls: int, views=(None, None), python_reps: int = 3,
                **sizes) -> dict:
    """Time ``cpp`` and ``python`` (each a function of no argument that
    returns a list of outputs) on one chunk; fail unless the outputs (seen
    through ``views``, untimed) are equal."""
    got, want = cpp(), python()
    if views[0] is not None:
        got, want = views[0](got), views[1](want)
    if not _same(got, want):
        raise AssertionError(f"{entry} on {chunk}: the C++ output differs "
                             "from its Python version's")
    return {"entry": entry, "chunk": chunk, **sizes,
            "ms": host_ms(cpp, reps), "python_ms": host_ms(python,
                                                           python_reps),
            "calls_per_read": calls, "equal": True}


def _plain_header(h):
    """A thrift-walked header as the table gives it: no statistics, the
    CRC unsigned."""
    for sub in (h.data_page_header, h.data_page_header_v2):
        if sub is not None:
            sub.statistics = None
    if h.dictionary_page_header is not None:
        h.dictionary_page_header.is_sorted = None
    if h.crc is not None:
        h.crc &= 0xFFFFFFFF
    return h


def plan_parts_ms(reader, reps: int) -> dict:
    """``build_plan``'s call on one chunk in its parts (median ms each):
    the page-header table, the per-page sources, the C++ call
    (``host.chunk_plan``: the walk and the export, into the bodies buffer
    of one ``_page_sources`` call, warm after the first) and the rest of
    ``_native_plan`` (the ``_Plan`` made from its arrays, dictionary
    pages decoded, and the first touch of the fresh bodies buffer that
    each of its calls allocates)."""
    table = reader.page_table()
    srcs, bodies, _ = device_reader._page_sources(reader, table)
    leaf = reader.leaf
    args = (table.rows, srcs, leaf.max_definition_level,
            leaf.max_repetition_level, int(reader.meta.type),
            -1 if leaf.type_length is None else leaf.type_length, bodies,
            host.plan_threads(device_reader._plan_work(table.rows, srcs)))
    parts = {
        "page_table": host_ms(reader.page_table, reps),
        "page_sources": host_ms(
            lambda: device_reader._page_sources(reader, table), reps),
        "chunk_plan_call": host_ms(lambda: host.chunk_plan(*args), reps),
        "native_plan": host_ms(
            lambda: device_reader._native_plan(reader, table, None), reps),
    }
    parts["plan_rest"] = (parts["native_plan"] - parts["page_sources"]
                          - parts["chunk_plan_call"])
    return parts


def largest_chunk(path: str):
    """The reader of ``path``'s chunk with the most page bytes."""
    f = pq.ParquetFile(path)
    return max((rg.column(leaf.column_index) for rg in f.row_groups
                for leaf in f.schema.leaves), key=lambda r: r.byte_range[1])


# a plan's fields compared as they are (arrays by value and dtype)
PLAN_SCALARS = ("value_kind", "dense_w", "dense_ok", "d_vpm", "total_slots",
                "total_values", "defs_expanded")
PLAN_TABLES = ("dense_pages", "d_firsts", "d_counts", "d_vpms",
               "d_mb_counts", "d_mb_offs", "d_mb_widths", "d_mb_mins",
               "bss_pages", "dba_plens", "dba_soffs", "dba_slens", "hb_lens")


def plan_fields(plan) -> list:
    """Every field of a staging plan as a comparable value: the byte
    streams by content, the host byte-array pages by their columns and
    their compacted bytes."""
    out = [getattr(plan, k) for k in PLAN_SCALARS]
    out += [a.array() for a in (plan.levels, plan.values, plan.dense)]
    for runs in (plan.def_runs, plan.rep_runs, plan.vruns):
        out += [runs.total, *runs.run_arrays()]
    out += [getattr(plan, k) for k in PLAN_TABLES]
    out += [plan.host_def if plan.host_def is not None else "none",
            plan.hb_parts[:, [0, 2, 3]],
            *device_reader._host_byte_arrays(plan)]
    return out


def _segment(ptr: int, n: int) -> np.ndarray:
    """``n`` bytes at address ``ptr`` as a numpy view."""
    import ctypes

    return np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(ptr))


def loop_pack(batch) -> torch.Tensor:
    """The fill ``_StagingBatch.pack`` ran before it was C++: a numpy loop
    over the slots and over each byte stream's parts, into a pinned
    buffer."""
    host_t = torch.empty(batch.nbytes, dtype=torch.uint8, pin_memory=True)
    h = host_t.numpy()
    for src, s in zip(batch._keep, batch._slots):
        if isinstance(src, np.ndarray):
            h[s.off:s.off + s.nbytes] = src.reshape(-1).view(np.uint8)
        elif isinstance(src, device_reader._MiniblockGather):
            if src.nb:
                vals = src.values
                short = int(src.starts.max()) + src.nb - len(vals)
                if short > 0:
                    vals = np.concatenate([vals, np.full(short, vals[-1],
                                                         np.uint8)])
                rows = np.lib.stride_tricks.sliding_window_view(vals, src.nb)
                h[s.off:s.off + s.nbytes].reshape(-1, src.nb)[...] = rows[
                    src.starts]
        else:
            off = s.off
            for ptr, n in src.segments().tolist():
                h[off:off + n] = _segment(ptr, n) if ptr else 0
                off += n
        h[s.off + s.nbytes:s.off + s.span] = 0
    return host_t


def fill_row(chunk: str, readers, path: str, reps: int = 5) -> dict:
    """``pq_fill_batch`` (``_StagingBatch.pack``) against the loop it
    replaced (:func:`loop_pack`) on the staging batch of ``readers``'
    plans, both into pinned memory: median milliseconds of ``reps``
    fills, each of a freshly recorded batch; the filled bytes of every
    slot must be equal.  ``calls_per_read`` counts the fills of one read
    of ``path``."""
    device = torch.device(DEVICE)
    plans = [device_reader.build_plan(r) for r in readers]

    def record():
        batch = device_reader._StagingBatch()
        for plan in plans:
            device_reader.stage_plan(plan, device, batch.put)
        return batch

    def timed(fill):
        times = []
        for _ in range(reps + 1):
            batch = record()
            slots = list(batch._slots)
            t0 = time.perf_counter()
            out = fill(batch)
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:]) * 1e3, out.numpy(), slots

    ms, got, slots = timed(lambda b: b.pack(pin=True))
    loop_ms, want, _ = timed(loop_pack)
    for s in slots:
        if not np.array_equal(got[s.off:s.off + s.span],
                              want[s.off:s.off + s.span]):
            raise AssertionError(f"pq_fill_batch on {chunk}: the slot at "
                                 f"{s.off} differs from the loop's")
    calls = [0]
    real = host.fill_batch

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    host.fill_batch = counted
    try:
        timed_read(path)
    finally:
        host.fill_batch = real
    return {"entry": "pq_fill_batch", "chunk": chunk, "slots": len(slots),
            "bytes": int(got.nbytes), "threads": host.fill_threads(
                got.nbytes), "ms": ms, "python_ms": loop_ms,
            "python": "the numpy loop over slots and parts it replaced",
            "speedup": loop_ms / ms, "calls_per_read": calls[0],
            "equal": True}


def prescan_path(read: dict, item: dict, enc: dict, nested: dict) -> list:
    """Phase 4e: each C++ entry point of the prescan at one real chunk of a
    path (the first row group's), beside its Python version on the same
    chunk; the outputs must be equal.  ``calls_per_read`` counts the entry
    point's calls in one read of the chunk's file."""
    if enc["zstd_path"] is None:
        raise AssertionError("enc's ZSTD file was not written: no libzstd")
    files = {"5col": read["path"], "lineitem": item["path"],
             "enc_snappy": enc["path"], "enc_zstd": enc["zstd_path"],
             "cfg4": nested["path"], "nest_mix": nested["mix_path"]}
    calls = {name: host_calls(path) for name, path in files.items()}
    rows = []
    for file, column, level in (("cfg4", "ts.list.element", "def"),
                                ("cfg4", "ts.list.element", "rep"),
                                ("5col", "cat", "def")):
        _, leaf, _, streams = chunk_pages(files[file], column)
        top = (leaf.max_definition_level if level == "def"
               else leaf.max_repetition_level)
        w = top.bit_length()
        todo = [(s[level], s["n"]) for s in streams]
        chunk = f"{file} {column} row group 0, {level} levels"
        tables = [host.scan_rle_runs(b, n, w) for b, n in todo]
        sizes = {"pages": len(todo), "values": sum(n for _, n in todo),
                 "stream_bytes": sum(len(b) for b, _ in todo),
                 "runs": sum(len(t[0]) for t in tables), "bit_width": w}
        rows.append(prescan_row(
            "pq_scan_rle_runs", chunk,
            lambda: [host.scan_rle_runs(b, n, w) for b, n in todo],
            lambda: [ref.scan_rle_runs(b, n, w) for b, n in todo], 5,
            calls[file]["pq_scan_rle_runs"], **sizes))
        if level == "def":
            rows.append(prescan_row(
                "pq_count_target_in_runs", chunk,
                lambda: [host.count_present(b, *t[:4], w, top)
                         for (b, _), t in zip(todo, tables)],
                lambda: [ref.count_in_runs(b, *t[:4], w, top)
                         for (b, _), t in zip(todo, tables)], 5,
                calls[file]["pq_count_target_in_runs"], **sizes))

    _, _, _, streams = chunk_pages(files["5col"], "ts")
    todo = [(s["raw"], s["pos"]) for s in streams]
    rows.append(prescan_row(
        "pq_delta_prescan", "5col ts row group 0",
        lambda: [host.delta_prescan(r, p) for r, p in todo],
        lambda: [dev.delta_prescan(r, p) for r, p in todo], 5,
        calls["5col"]["pq_delta_prescan"], pages=len(todo),
        values=sum(s["n"] for s in streams),
        miniblocks=sum(len(host.delta_prescan(r, p)[3]) for r, p in todo)))

    for column in ("ba_dlba", "ba_dba"):
        _, _, _, streams = chunk_pages(files["enc_snappy"], column)
        todo = []
        for s in streams:
            todo.append((s["raw"], s["pos"]))
            if column == "ba_dba":  # prefix lengths, then suffix lengths
                todo.append((s["raw"], host.decode_delta_binary_packed(
                    s["raw"], s["pos"])[1]))
        rows.append(prescan_row(
            "pq_delta_decode", f"enc v1-SNAPPY {column} row group 0, "
            "length streams",
            lambda: [host.decode_delta_binary_packed(r, p) for r, p in todo],
            lambda: [ref.decode_delta_binary_packed(r, p) for r, p in todo],
            5, calls["enc_snappy"]["pq_delta_decode"], pages=len(streams),
            streams=len(todo), values=sum(
                len(host.decode_delta_binary_packed(r, p)[0])
                for r, p in todo)))

    for file, column in (("lineitem", "l_comment"), ("enc_zstd", "ba_dlba")):
        reader, _, pages, _ = chunk_pages(files[file], column)
        start, size = reader.byte_range
        raw = reader.file.source.pread(start, size)
        total = reader.meta.num_values
        chunk = f"{file} {column} row group 0"
        rows.append(prescan_row(
            "pq_scan_page_headers", chunk,
            lambda: page_infos(raw, start, host.scan_page_headers(
                raw, total, base=start)),
            lambda: list(thrift_page_walk(raw, start, total)), 5,
            calls[file]["pq_scan_page_headers"],
            views=(lambda ps: [(p.offset, p.header, bytes(p.payload))
                               for p in ps],
                   lambda ps: [(p.offset, _plain_header(p.header),
                                bytes(p.payload)) for p in ps]),
            pages=len(pages), chunk_bytes=size))
        data = [p for p in pages if p.page_type in (PageType.DATA_PAGE,
                                                    PageType.DATA_PAGE_V2)]
        srcs = [p.payload for p in data]
        sizes = [p.header.uncompressed_page_size for p in data]
        codec = reader.codec
        threads = host.decompress_threads(sum(sizes))

        def batched():
            buf, offs = host.decompress_pages(srcs, sizes,
                                              int(codec.codec_id), threads)
            return [buf[offs[i]:offs[i + 1]] for i in range(len(srcs))]

        rows.append(prescan_row(
            "pq_decompress_pages", chunk, batched,
            lambda: [host.as_u8(codec.decode(b, n))
                     for b, n in zip(srcs, sizes)], 5,
            calls[file]["pq_decompress_pages"], codec=codec.codec_id.name,
            pages=len(data), compressed_bytes=sum(len(b) for b in srcs),
            bytes_out=sum(sizes), threads=threads))

    five = pq.ParquetFile(files["5col"])
    planned = [("5col", five.row_groups[0].column(leaf.column_index),
                "every column's") for leaf in five.schema.leaves]
    planned += [(file, largest_chunk(files[file]), "the file's largest "
                 "chunk") for file in ("lineitem", "enc_snappy", "cfg4",
                                       "nest_mix")]
    for file, reader, which in planned:
        table = reader.page_table()
        srcs, _, _ = device_reader._page_sources(reader, table)
        row = prescan_row(
            "pq_chunk_plan", f"{file} {reader.leaf.name} row group "
            f"{reader.rg_index}, {which}",
            lambda: [device_reader.build_plan(reader)],
            lambda: [device_reader._build_plan_python(reader)], 21,
            calls[file]["pq_chunk_plan"], python_reps=21,
            views=(lambda ps: plan_fields(ps[0]),
                   lambda ps: plan_fields(ps[0])),
            pages=len(table), chunk_bytes=reader.byte_range[1],
            value_kind=device_reader.build_plan(reader).value_kind,
            threads=host.plan_threads(device_reader._plan_work(table.rows,
                                                               srcs)))
        row["python"] = "device_reader._build_plan_python"
        row["speedup"] = row["python_ms"] / row["ms"]
        row["parts_ms"] = plan_parts_ms(reader, 21)
        rows.append(row)
    f = pq.ParquetFile(files["5col"])
    rows.append(fill_row("5col row group 0, every column in one batch",
                         [f.row_groups[0].column(leaf.column_index)
                          for leaf in f.schema.leaves], files["5col"]))
    rows.append(fill_row("cfg4 ts.list.element, the largest chunk",
                         [largest_chunk(files["cfg4"])], files["cfg4"]))
    log({"prescan": rows})
    log({"prescan_calls_per_read": calls})
    return rows


# ---------------------------------------------------------------------------
# the torch ops that stand for XLA ops, at enc's and lineitem's shapes
# ---------------------------------------------------------------------------

# op -> (owner, attribute) of the function the read calls
TORCH_OPS = {
    "byte_stream_split": (device_reader, "_bss_decode"),
    "delta_byte_array_expand": (dev, "delta_byte_array_expand"),
    "rle_expand": (dev, "rle_expand"),
    "assemble_single_list": (dev, "assemble_single_list"),
    "assemble_nested": (dev, "assemble_nested"),
}


class OpCalls:
    """Calls of each torch op of ``TORCH_OPS`` by column over the reads
    inside the block (``counts[column][op]``)."""

    def __init__(self):
        self.counts = {}
        self._saved = []
        self._column = None

    def __enter__(self):
        real_decode = device_reader.decode_staged

        def decode(plan, *args, **kwargs):
            self._column = plan.leaf.name
            return real_decode(plan, *args, **kwargs)

        self._saved.append((device_reader, "decode_staged", real_decode))
        device_reader.decode_staged = decode
        for op, (owner, attr) in TORCH_OPS.items():
            real = getattr(owner, attr)

            def counted(*args, real=real, op=op, **kwargs):
                col = self.counts.setdefault(self._column, {})
                col[op] = col.get(op, 0) + 1
                return real(*args, **kwargs)

            self._saved.append((owner, attr, real))
            setattr(owner, attr, counted)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        self._saved = []


def op_ms(fn, reps: int = 10, tries: int = 3):
    """Device milliseconds per call of ``fn``, a torch op of several
    kernels (or a copy): every device event the profiler recorded over
    ``reps`` calls, summed, over ``reps``; where ``tries`` windows
    recorded none, CUDA events around back-to-back calls, the call named
    in ``PROFILER_FALLBACKS``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0)
        if us > 0:
            return us / reps / 1e3
    PROFILER_FALLBACKS.append(getattr(fn, "__name__", "op"))
    return time_ms(fn)


def rle_bytes(args) -> int:
    """Bytes an ``rle_expand`` call must move: its bit-packed runs' bits,
    its run table (5 int64 a run) and 4 bytes out a value."""
    _, n, ends, kinds = args[:4]
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    packed = counts[kinds != 0]
    w = int(args[6].max()) if args[6].numel() else 0
    return int(packed.sum()) * w // 8 + 40 * ends.numel() + 4 * n


def op_row(op: str, shape: str, fn, nbytes: int, calls: dict,
           extra=None, rate: float = HBM_BYTES_PER_S, timer=None) -> dict:
    """One op's row: ``ms`` a call by ``timer`` (the profiler's
    :func:`op_ms` by default); its bound is ``nbytes`` at ``rate``
    bytes/s (the card's memory, or for a copy the host link)."""
    fallbacks = len(PROFILER_FALLBACKS)
    ms = (timer or op_ms)(fn)
    if len(PROFILER_FALLBACKS) > fallbacks:
        PROFILER_FALLBACKS[-1] = f"{op} {shape}"
    b = nbytes / rate * 1e3
    per_read = sum(calls.values())
    return {"op": op, "shape": shape, **(extra or {}), "ms": ms,
            "calls_per_read": per_read, "calls_by_column": calls,
            "bytes": nbytes, "bound_ms": b,
            "ms_per_read": None if ms is None else ms * per_read,
            "excess_ms_per_read": None if ms is None
            else (ms - b) * per_read}


def assemble_bytes(args, out) -> int:
    """Bytes an assembly call must move: read each slot's def and rep
    level, write each level's int64 offsets and list validity bytes and a
    validity byte per leaf element."""
    d, r = args[0], args[1]
    offs, valid, leaf_valid = out
    return (d.numel() * d.element_size() + r.numel() * r.element_size()
            + sum(8 * o.numel() + v.numel() for o, v in zip(offs, valid))
            + leaf_valid.numel())


def torch_ops(enc: str, lineitem: str, nested: dict, h2d: dict) -> list:
    """The profiler's ``ms`` per call, the calls per read and the byte bound
    (bytes moved / 3.35 TB/s) of the torch ops at the shapes of the first
    row group of enc's and lineitem's columns: ``byte_stream_split``
    (``f64_bss``), ``delta_byte_array_expand`` (``ba_dba``), the boolean
    expand (``bool_rle``: ``rle_expand`` at w = 1, then ``!= 0``),
    ``rle_expand`` at lineitem's four dictionary string columns (where
    their index runs are not all bit-packed) and the H2D copy of
    ``l_comment``'s bytes from pageable memory (the staging before the
    pinned batch) and from pinned memory (the read's), bound by the
    pinned peak of ``h2d`` (:func:`h2d_peak`), the nominal rate beside
    it; and the level assembly at the first row group
    of cfg 4 (``assemble_single_list``) and of ``grid``
    (``assemble_nested``)."""
    counts = {}
    for path in (enc, lineitem, nested["path"], nested["mix_path"]):
        with OpCalls() as calls:
            timed_read(path)
        counts[path] = calls.counts
    rows = []

    def by_column(path, op, columns):
        return {c: counts[path].get(c, {}).get(op, 0) for c in columns}

    args = first_chunk_calls(enc, "f64_bss", *TORCH_OPS["byte_stream_split"])
    buf, pages, width, physical = args[0]
    n = int(pages[:, 1].sum())
    rows.append(op_row(
        "byte_stream_split", f"enc.f64_bss: n={n}, width={width}, "
        f"{len(pages)} pages", lambda: device_reader._bss_decode(*args[0]),
        2 * n * width, by_column(enc, "byte_stream_split", [
            c for c, spec in ENC_COLUMNS.items()
            if spec[2] == Encoding.BYTE_STREAM_SPLIT])))
    args = first_chunk_calls(enc, "ba_dba",
                             *TORCH_OPS["delta_byte_array_expand"])[0]
    total, iters = args[4], args[5]
    entries = args[1].numel()
    rows.append(op_row(
        "delta_byte_array_expand", f"enc.ba_dba: {entries} values, "
        f"{total} bytes out", lambda: dev.delta_byte_array_expand(*args),
        total - int(args[1].sum()) + 24 * entries + total,
        by_column(enc, "delta_byte_array_expand", ["ba_dba"]),
        {"iters": iters}))
    args = first_chunk_calls(enc, "bool_rle", *TORCH_OPS["rle_expand"])[0]
    n = args[1]
    rows.append(op_row(
        "bool_expand", f"enc.bool_rle: n={n}, {args[2].numel()} runs",
        lambda: dev.rle_expand(*args) != 0,
        rle_bytes(args) - 3 * n,
        by_column(enc, "rle_expand", ["bool_rle"])))
    for column in LINEITEM_STRINGS:
        calls = first_chunk_calls(lineitem, column, *TORCH_OPS["rle_expand"])
        per_read = by_column(lineitem, "rle_expand", [column])
        if not calls:  # every run bit-packed: unpack_bits_dense instead
            rows.append({"op": "rle_expand", "shape": f"lineitem.{column}",
                         "ms": None, "calls_per_read": 0,
                         "calls_by_column": per_read, "bound_ms": None,
                         "note": "all index runs bit-packed: the chunk "
                         "took unpack_bits_dense"})
            continue
        a = calls[0]
        kinds = a[3]
        rows.append(op_row(
            "rle_expand", f"lineitem.{column}: n={a[1]}, "
            f"w={int(a[6].max())}, {a[2].numel()} runs "
            f"({int((kinds == 0).sum())} RLE)",
            lambda a=a: dev.rle_expand(*a), rle_bytes(a), per_read))
    f = pq.ParquetFile(lineitem)
    reader = f.row_groups[0].column(f.schema.leaf("l_comment").column_index)
    plan = device_reader.build_plan(reader)
    host_bytes, _ = device_reader._host_byte_arrays(plan)
    pageable = torch.from_numpy(host_bytes)
    pinned = torch.empty(pageable.shape, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(pageable)
    target = torch.empty(pageable.shape, dtype=torch.uint8, device=DEVICE)
    nbytes = host_bytes.nbytes
    for kind, src, calls in (("pageable", pageable, 0),
                             ("pinned", pinned, len(f.row_groups))):
        rows.append(op_row(
            "h2d", f"lineitem.l_comment: {nbytes} bytes, {kind}",
            lambda src=src: target.copy_(src, non_blocking=True), nbytes,
            {"l_comment": calls},
            {"bound_nominal_ms": nbytes / PCIE5_X16_BYTES_PER_S * 1e3,
             "note": "bound_ms: the bytes at the measured pinned peak of "
             "this run's 256 MiB probe; bound_nominal_ms at PCIe Gen5 "
             "x16's nominal 63 GB/s; ms from CUDA events around 20 "
             "copies (a profiler window can drop a lone copy's event)"
             + ("; the read stages pinned" if kind == "pageable" else "")},
            rate=h2d["pinned_gb_per_s"] * 1e9, timer=time_ms))
    del pinned
    for op, path, column in (
            ("assemble_single_list", nested["path"], "ts.list.element"),
            ("assemble_nested", nested["mix_path"],
             "grid.list.element.list.element")):
        args = first_chunk_calls(path, column, *TORCH_OPS[op])[0]
        fn = getattr(dev, op)
        out = fn(*args)
        rows.append(op_row(
            op, f"{column}: {args[0].numel()} slots, lists per level "
            f"{[o.numel() - 1 for o in out[0]]}, {out[2].numel()} elements",
            lambda fn=fn, args=args: fn(*args), assemble_bytes(args, out),
            by_column(path, op, [column])))
    missing = [r["op"] for r in rows
               if r["ms"] is None and r["calls_per_read"]]
    if missing:
        raise AssertionError(f"the profiler recorded no time for {missing}")
    return rows


# ---------------------------------------------------------------------------
# phase 5: the lookup path
# ---------------------------------------------------------------------------

LOOKUP_ENCODINGS = {"k": Encoding.PLAIN, "v": Encoding.PLAIN,
                    "cat": Encoding.RLE_DICTIONARY}
LOOKUP_COLUMNS = ["v", "cat"]


def make_lookup_table(rows: int, seed: int) -> dict:
    """``k``: ``bench.py`` config 10's four rows per key, doubled so that
    the odd keys inside every row group's range are absent; ``v`` a double
    with 5 % nulls; ``cat`` a 200-value int32 category with 10 % nulls."""
    rng = np.random.default_rng(seed + 1)
    i = np.arange(rows, dtype=np.int64)
    return {
        "k": 2 * (i // 4),
        "v": np.ma.masked_array(rng.random(rows),
                                mask=rng.random(rows) < 0.05),
        "cat": np.ma.masked_array(rng.integers(0, 200, rows).astype(np.int32),
                                  mask=rng.random(rows) < 0.10),
    }


def make_keys(rows: int, seed: int) -> np.ndarray:
    """``rows / 16`` distinct keys in [0, rows / 2), shuffled: one in eight
    is a present even key, the rest absent odd keys."""
    rng = np.random.default_rng(seed + 2)
    n = rows // 16
    present = n // 8
    even = rng.choice(rows // 4, present, replace=False) * 2
    odd = rng.choice(rows // 4, n - present, replace=False) * 2 + 1
    return rng.permutation(np.concatenate([even, odd]).astype(np.int64))


def check_lookup(res, keys: np.ndarray, table: dict) -> None:
    """Every key's rows, ``v``, ``cat`` and validity against the numpy
    oracle: key ``2j`` sits in rows ``[4j, 4j + 4)``, an odd key nowhere;
    a null slot holds 0."""
    if len(res) != len(keys):
        raise AssertionError(f"{len(res)} hits for {len(keys)} keys")
    lens = np.array([h.num_rows for h in res])
    even = keys % 2 == 0
    if not np.array_equal(lens, np.where(even, 4, 0)):
        raise AssertionError("lookup: wrong number of rows for some keys")
    hits = [h for h, e in zip(res, even) if e]
    rows = np.concatenate([h.rows for h in hits])
    want_rows = (2 * keys[even])[:, None] + np.arange(4)
    if not np.array_equal(rows, want_rows.reshape(-1)):
        raise AssertionError("lookup: rows differ from the oracle")
    for c in LOOKUP_COLUMNS:
        arr = table[c]
        valid = ~np.ma.getmaskarray(arr)[rows]
        want = np.where(valid, np.ma.getdata(arr)[rows], 0)
        got = np.concatenate([h.values[c] for h in hits])
        got_valid = np.concatenate([
            np.ones(4, bool) if h.validity[c] is None else h.validity[c]
            for h in hits])
        if got.dtype != want.dtype or not np.array_equal(got, want) \
                or not np.array_equal(got_valid, valid):
            raise AssertionError(f"lookup: column {c} differs from the "
                                 "oracle")


class PhaseTimer:
    """Exclusive wall time of the lookup's stages: each wrapped function's
    time less that of the wrapped functions it calls."""

    STAGES = (
        (lookup, "_prepare_keys", "prepare"),
        (lookup, "_stats_alive", "stats"),
        (bloom, "check_hashes_multi", "bloom"),
        (lookup, "_page_ords_of_keys", "page_search"),
        (lookup._PageFetcher, "fetch", "fetch"),
        (lookup, "_match", "match"),
        (lookup, "_gather_columns", "gather"),
        (lookup, "_assemble_hits", "assemble"),
    )

    def __init__(self):
        self.seconds = {name: 0.0 for _, _, name in self.STAGES}
        self.calls = {name: 0 for _, _, name in self.STAGES}
        self._stack = []
        self._saved = []

    def _wrap(self, fn, name):
        def timed(*args, **kwargs):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.seconds[name] += dt - inner
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed

    def __enter__(self):
        for owner, attr, name in self.STAGES:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


def timed_lookup(f, keys: np.ndarray, device, key: str = "k",
                 columns=LOOKUP_COLUMNS) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = f.find_rows(key, keys, columns=columns, device=device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


# keys/s of the warm lookup in two earlier calls (W2, W3: PR 10's chip runs
# of the same lookup, without a page cache, on NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's
EARLIER_WARM_KEYS_PER_S = {"W2": 102_557.7, "W3": 102_960.0}
# the caches sized to the working set of phase 5's lookup (every page of
# ``k``, ``v`` and ``cat`` the batch touches, and 4,128,768 (key, row
# group) pairs proven absent), not the port's defaults (64 MiB of pages, a
# 4 MiB memo): the warm checks of phases 5 and 5f run under them, and
# phase 5 runs its lookups at the defaults too
LOOKUP_CACHE_KNOBS = {"PARQUET_TPU_TORCH_PAGE_CACHE": str(1 << 30),
                      "PARQUET_TPU_TORCH_NEG_LOOKUP": str(512 << 20)}


@contextlib.contextmanager
def knobs(**values):
    """The port's knobs set to ``values`` inside the block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def bloom_probes():
    """The operands ``(filters, hash batches)`` of every segmented bloom
    probe made inside the block."""
    seen = []
    real = bloom.check_hashes_multi

    def spy(filters, batches, device="cuda"):
        seen.append((list(filters), [np.asarray(b) for b in batches]))
        return real(filters, batches, device)

    bloom.check_hashes_multi = spy
    try:
        yield seen
    finally:
        bloom.check_hashes_multi = real


def lookup_sequence(path: str, keys: np.ndarray, device,
                    probes: list = None, runs: int = 3) -> list:
    """From cleared caches: one cold lookup on a fresh handle, then
    ``runs - 1`` warm ones on the same handle; ``[(result, seconds,
    bloom_check launches)]``.  The cold lookup's bloom probes go to
    ``probes``."""
    pq.clear_caches()
    f = pq.ParquetFile(path)
    out = []
    for i in range(runs):
        before = pq.LAUNCHES["bloom_check"]
        with bloom_probes() as seen:
            res, s = timed_lookup(f, keys, device)
        if i == 0 and probes is not None:
            probes.extend(seen)
        out.append((res, s, pq.LAUNCHES["bloom_check"] - before))
    return out


def same_hits(a, b, what: str) -> None:
    """Two lookups' hits equal: rows, values and validity of each key."""
    for x, y in zip(a, b):
        if not np.array_equal(x.rows, y.rows):
            raise AssertionError(f"{what}: rows of key {y.key!r} differ")
        for c in x.values:
            xv, yv = x.values[c], y.values[c]
            same = (xv == yv if isinstance(yv, list)
                    else np.array_equal(xv, yv))
            xs, ys = x.validity[c], y.validity[c]
            if not same or (xs is None) != (ys is None) or (
                    ys is not None and not np.array_equal(xs, ys)):
                raise AssertionError(f"{what}: {c} of key {y.key!r} "
                                     "differs")


def check_bloom_runs(bloom_runs: list, row_groups: int, what: str) -> None:
    """One ``bloom_check`` launch in a cold lookup, at most one in a warm
    one."""
    if bloom_runs[0] != 1 or max(bloom_runs[1:]) > 1:
        raise AssertionError(
            f"{what}: bloom_check launched {bloom_runs} times in a cold and "
            f"two warm lookups of {row_groups} row groups: one launch a "
            "cold lookup, at most one a warm one expected")


def lookup_path(rows: int, seed: int, tmp: str) -> dict:
    """The lookup path at full size.  From cleared caches one cold lookup
    and two warm ones on the card at the port's default cache sizes, then
    the same sequence with the caches sized to the batch's working set
    (:data:`LOOKUP_CACHE_KNOBS`), where the warm runs must read nothing and
    the cold and first warm run's counters must equal the same runs' on
    the CPU; then a
    cold and a warm lookup at the defaults under the stage timers.
    Returns the kernels' launches over the two sequences, one lookup's
    segmented bloom probe (filters, surviving hashes of each), the stage
    times, and ``cold`` / ``warm`` (a cold lookup at the defaults; a warm
    one with the caches sized to the working set) for the profiler."""
    table = make_lookup_table(rows, seed)
    keys = make_keys(rows, seed)
    path = os.path.join(tmp, "lookup.parquet")
    t0 = time.perf_counter()
    pq.write_table(table, path, pq.WriterOptions(
        row_group_size=ROW_GROUP, data_page_size=8192,
        compression="uncompressed", column_encoding=LOOKUP_ENCODINGS,
        bloom_filters={"k": 10}, sorting_columns=[("k", False, False)]))
    write_s = time.perf_counter() - t0
    row_groups = -(-rows // ROW_GROUP)

    pq.reset_launches()
    reset_routes()
    # the shipped defaults (64 MiB of pages, a 4 MiB memo)
    default_runs = lookup_sequence(path, keys, DEVICE)
    for res, _, _ in default_runs:
        check_lookup(res, keys, table)
    check_bloom_runs([n for _, _, n in default_runs], row_groups,
                     "the lookups at the default cache sizes")
    default_s = [s for _, s, _ in default_runs]
    default_counters = [dict(res.counters) for res, _, _ in default_runs]
    del default_runs
    # the caches sized to the working set
    probes = []
    with knobs(**LOOKUP_CACHE_KNOBS):
        card_runs = lookup_sequence(path, keys, DEVICE, probes)
    run_s = [s for _, s, _ in card_runs]
    launches = dict(pq.LAUNCHES)
    for res, _, _ in card_runs:
        check_lookup(res, keys, table)
    no_host_route("the lookups")
    bloom_runs = [n for _, _, n in card_runs]
    check_bloom_runs(bloom_runs, row_groups, "the lookups with the caches "
                     "sized to the working set")
    for name in LOOKUP_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "lookups")
    counters = [dict(res.counters) for res, _, _ in card_runs]
    if counters[0]["rows_matched"] != 4 * (len(keys) // 8):
        raise AssertionError(f"rows_matched {counters[0]['rows_matched']}")
    for c in counters[1:]:  # every page is cached, every miss memoized
        if c["preads"] or c["pages_read"] or not c["page_cache_hits"] \
                or not c["neg_hits"]:
            raise AssertionError(f"a warm lookup read pages or missed the "
                                 f"memo: {c}")
    t0 = time.perf_counter()
    # the cold and the first warm run on the CPU (the second warm run's
    # there until phase 5q, cut for the script's time)
    with knobs(**LOOKUP_CACHE_KNOBS):
        cpu_runs = lookup_sequence(path, keys, "cpu", runs=2)
    cpu_s = time.perf_counter() - t0
    for i, ((res, _, _), (cpu, _, _)) in enumerate(zip(card_runs,
                                                       cpu_runs)):
        if cpu.counters != res.counters:
            raise AssertionError(f"lookup {i}: counters on {DEVICE} "
                                 f"{res.counters} differ from the CPU's "
                                 f"{cpu.counters}")
        same_hits(res, cpu, f"lookup {i} on the CPU")
    del cpu_runs
    del card_runs

    # a cold and a warm lookup under the stage timers, at the defaults
    stages = {}
    pq.clear_caches()
    f = pq.ParquetFile(path)
    for name in ("cold", "warm"):
        with PhaseTimer() as timer:
            _, timed_s = timed_lookup(f, keys, DEVICE)
        st = dict(timer.seconds)
        st["other"] = timed_s - sum(st.values())
        stages[name] = {"timed_lookup_s": timed_s, "stage_s": st,
                        "stage_calls": dict(timer.calls)}
    log({"lookup_path": {
        "rows": rows, "row_groups": row_groups, "keys": len(keys),
        "file_bytes": os.path.getsize(path), "write_s": write_s,
        "default_caches": {"cold_s": default_s[0], "warm_s": default_s[1:],
                           "keys_per_s_cold": len(keys) / default_s[0],
                           "keys_per_s_warm": len(keys) / min(default_s[1:]),
                           "counters_cold": default_counters[0],
                           "counters_warm": default_counters[1:]},
        "working_set_caches": {
            "knobs": LOOKUP_CACHE_KNOBS, "cold_s": run_s[0],
            "warm_s": run_s[1:], "keys_per_s_cold": len(keys) / run_s[0],
            "keys_per_s_warm": len(keys) / min(run_s[1:]),
            "counters_cold": counters[0], "counters_warm": counters[1:],
            "cpu_sequence_s": cpu_s},
        "earlier_warm_keys_per_s_no_page_cache": EARLIER_WARM_KEYS_PER_S,
        "bloom_launches": bloom_runs, "launches": launches,
        "cache_stats": pq.cache_stats().as_dict()}})

    def cold():
        pq.clear_caches()
        return timed_lookup(pq.ParquetFile(path), keys, DEVICE)

    def warm():
        with knobs(**LOOKUP_CACHE_KNOBS):
            return timed_lookup(f, keys, DEVICE)

    return {"launches": launches, "probe": probes[0], "path": path,
            "cold": cold, "warm": warm,
            "stages": {"stages": stages, "caches": "defaults"}}


# ---------------------------------------------------------------------------
# phase 5f: the lookup leftovers (byte-array keys, Dataset.find_rows)
# ---------------------------------------------------------------------------

URL_ROWS = 1 << 20  # one row group of phase 4c's URLs
URL_PAGE = 1 << 16
URL_KEYS = 65_536  # one in eight present
ORDERKEY_KEYS = 65_536
ORDERKEY_PAGE = 1 << 16
DATASET_LOOKUP_COLUMNS = ("l_quantity", "l_extendedprice", "l_shipmode")


def url_lookup(card: str, seed: int, tmp: str) -> dict:
    """A BYTE_ARRAY key: 1,048,576 distinct sorted URLs (phase 4c's
    ``_urls``) in one row group, PLAIN under Snappy, 64 KiB pages, a bloom
    filter and a page index; 65,536 keys, one in eight present (the others
    a stored URL with an ``x`` appended, inside the column's range).  From
    cleared caches a cold and a warm lookup on the card, each equal to the
    numpy oracle (one ``bloom_check`` launch in the cold one), the cold
    one's counters equal to the CPU's; the C++ ``pq_xxh64_batch`` of the
    keys equal to the plain Python ``xxh64_bytes``."""
    rng = np.random.default_rng(seed + 23)
    values, offsets = _urls(rng, URL_ROWS)
    urls = [values[offsets[i]:offsets[i + 1]].tobytes()
            for i in range(URL_ROWS)]
    where = {}
    for i, u in enumerate(urls):
        where.setdefault(u, []).append(i)
    path = os.path.join(tmp, "urls.parquet")
    t0 = time.perf_counter()
    pq.write_table(
        {"url": ColumnData(values=values, offsets=offsets),
         "v": ColumnData(values=np.arange(URL_ROWS, dtype=np.int64))},
        path, pq.WriterOptions(
            row_group_size=URL_ROWS, data_page_size=URL_PAGE,
            compression="snappy", bloom_filters={"url": 10},
            column_encoding={"url": Encoding.PLAIN, "v": Encoding.PLAIN}),
        schema=Schema([Leaf(-1, "url", Type.BYTE_ARRAY, string=True),
                       Leaf(-1, "v", Type.INT64)]))
    write_s = time.perf_counter() - t0
    present = URL_KEYS // 8
    keys = ([urls[i] for i in rng.choice(URL_ROWS, present, replace=False)]
            + [urls[i] + b"x" for i in rng.choice(URL_ROWS, URL_KEYS - present,
                                                 replace=False)])
    keys = [keys[i] for i in rng.permutation(URL_KEYS)]

    def check(res, what):
        for h, key in zip(res, keys):
            rows = where.get(key, [])
            if h.rows.tolist() != rows or h.values["v"].tolist() != rows \
                    or h.values["url"] != [key] * len(rows):
                raise AssertionError(f"url lookup ({what}): key {key!r}")

    def run(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = f.find_rows("url", keys, columns=["v", "url"], device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    pq.clear_caches()
    before = dict(pq.LAUNCHES)
    f = pq.ParquetFile(path)
    with bloom_probes() as probes:
        cold, cold_s = run(DEVICE)
    cold_launches = {k: pq.LAUNCHES[k] - before[k] for k in before}
    check(cold, "cold")
    warm, warm_s = run(DEVICE)
    check(warm, "warm")
    if cold_launches["bloom_check"] != 1 or len(probes) != 1:
        raise AssertionError(f"url lookup: {cold_launches['bloom_check']} "
                             "bloom_check launches, not 1")
    if warm.counters["preads"] or not warm.counters["page_cache_hits"] \
            or not warm.counters["neg_hits"]:
        raise AssertionError(f"url lookup: the warm run read pages or "
                             f"missed the memo: {warm.counters}")
    pq.clear_caches()
    t0 = time.perf_counter()
    cpu = pq.ParquetFile(path).find_rows("url", keys, columns=["v", "url"],
                                         device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu.counters != cold.counters:
        raise AssertionError(f"url lookup: counters on {DEVICE} "
                             f"{cold.counters} differ from the CPU's "
                             f"{cpu.counters}")
    koffs = np.zeros(URL_KEYS + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=koffs[1:])
    kvals = np.frombuffer(b"".join(keys), np.uint8)
    t0 = time.perf_counter()
    cpp = host.xxh64_batch(kvals, koffs)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [bloom.xxh64_bytes(k) for k in keys]
    plain_s = time.perf_counter() - t0
    if cpp.tolist() != plain:
        raise AssertionError("pq_xxh64_batch differs from xxh64_bytes on "
                             "the url keys")
    counters = dict(cold.counters)
    del cold, warm, cpu, urls, where
    log({"url_lookup": {
        "card": card, "rows": URL_ROWS, "keys": URL_KEYS,
        "present": present, "file_bytes": os.path.getsize(path),
        "write_s": write_s, "cold_s": cold_s, "warm_s": warm_s,
        "cpu_cold_s": cpu_s, "keys_per_s_cold": URL_KEYS / cold_s,
        "keys_per_s_warm": URL_KEYS / warm_s, "counters": counters,
        "launches": cold_launches,
        "xxh64": {"keys": URL_KEYS, "key_bytes": int(koffs[-1]),
                  "cpp_ms": cpp_s * 1e3, "plain_python_ms": plain_s * 1e3,
                  "equal": True}}})
    return {"probe": probes[0], "launches": cold_launches}


def dataset_lookup(card: str, rows: int, seed: int, tmp: str) -> dict:
    """``Dataset.find_rows`` on the card: phase 5c's lineitem rows again as
    8 part files of 524,288-row row groups (the port's writer, Snappy),
    this time with a bloom filter on ``l_orderkey``, 64 KiB pages and a
    page index, holding the key and :data:`DATASET_LOOKUP_COLUMNS`; 65,536
    keys in ``l_orderkey``'s range.  From cleared caches one cold and two
    warm lookups, each equal to a numpy oracle on the concatenated rows
    (global row ordinals, values), the cold one's counters equal to the
    CPU's; ``read_admission()``'s high water within the lookup budget."""
    from parquet_tpu_torch.utils.pool import read_admission

    _, data = make_lineitem(rows, seed)
    names = ("l_orderkey",) + DATASET_LOOKUP_COLUMNS
    schema = Schema([Leaf(-1, "l_orderkey", Type.INT64),
                     Leaf(-1, "l_quantity", Type.INT64),
                     Leaf(-1, "l_extendedprice", Type.DOUBLE),
                     Leaf(-1, "l_shipmode", Type.BYTE_ARRAY, string=True)])
    root = os.path.join(tmp, "dataset_lookup")
    os.makedirs(root)
    per = -(-rows // DATASET_FILES)
    paths = []
    t0 = time.perf_counter()
    for i in range(DATASET_FILES):
        a, b = i * per, min(rows, (i + 1) * per)
        p = os.path.join(root, f"part-{i:02d}.parquet")
        pq.write_table({k: column_slice(data[k], a, b) for k in names}, p,
                       pq.WriterOptions(
                           compression="snappy",
                           row_group_size=DATASET_ROW_GROUP,
                           data_page_size=ORDERKEY_PAGE,
                           bloom_filters={"l_orderkey": 10},
                           column_encoding={k: LINEITEM_ENCODINGS[k]
                                            for k in names}),
                       schema=schema)
        paths.append(p)
    write_s = time.perf_counter() - t0
    ok = data["l_orderkey"].values
    qty = data["l_quantity"].values
    price = data["l_extendedprice"].values
    sv, so = data["l_shipmode"].values, data["l_shipmode"].offsets
    rng = np.random.default_rng(seed + 29)
    keys = rng.integers(int(ok[0]), int(ok[-1]) + 1, ORDERKEY_KEYS,
                        dtype=np.int64)
    lo = np.searchsorted(ok, keys, "left")
    hi = np.searchsorted(ok, keys, "right")

    def check(res, what):
        for h, a, b in zip(res, lo.tolist(), hi.tolist()):
            rows_ = np.arange(a, b)
            if not np.array_equal(h.rows, rows_) \
                    or not np.array_equal(h.values["l_quantity"], qty[a:b]) \
                    or not np.array_equal(h.values["l_extendedprice"],
                                          price[a:b]) \
                    or h.values["l_shipmode"] != [
                        sv[so[r]:so[r + 1]].tobytes() for r in rows_]:
                raise AssertionError(f"dataset lookup ({what}): key "
                                     f"{h.key} differs from the oracle")

    gate = read_admission()
    pq.clear_caches()
    gate._reset()
    before = dict(pq.LAUNCHES)
    times, results = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pq.Dataset(paths).find_rows("l_orderkey", keys,
                                          columns=DATASET_LOOKUP_COLUMNS,
                                          device=DEVICE)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(res, f"run {len(times)}")
        results.append(dict(res.counters))
        del res
    launches = {k: pq.LAUNCHES[k] - before[k] for k in before}
    budget = gate.budget_bytes("lookup")
    if not 0 < gate.high_water <= budget:
        raise AssertionError(f"dataset lookup: admission high water "
                             f"{gate.high_water} outside (0, {budget}]")
    admission = {"high_water": gate.high_water, "waits": gate.waits,
                 "budget": budget}
    pq.clear_caches()
    t0 = time.perf_counter()
    cpu = pq.Dataset(paths).find_rows("l_orderkey", keys,
                                      columns=DATASET_LOOKUP_COLUMNS,
                                      device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu.counters != results[0]:
        raise AssertionError(f"dataset lookup: counters on {DEVICE} "
                             f"{results[0]} differ from the CPU's "
                             f"{cpu.counters}")
    if results[0]["keys"] != ORDERKEY_KEYS or any(
            c["preads"] for c in results[1:]):
        raise AssertionError(f"dataset lookup counters: {results}")
    del cpu, data
    log({"dataset_find_rows": {
        "card": card, "files": DATASET_FILES, "rows": rows,
        "row_group": DATASET_ROW_GROUP, "keys": ORDERKEY_KEYS,
        "present": int((hi > lo).sum()), "write_s": write_s,
        "cold_s": times[0], "warm_s": times[1:], "cpu_cold_s": cpu_s,
        "keys_per_s_cold": ORDERKEY_KEYS / times[0],
        "keys_per_s_warm": ORDERKEY_KEYS / min(times[1:]),
        "counters_cold": results[0], "counters_warm": results[1:],
        "admission": admission, "launches": launches}})
    return {"launches": launches}


def lookup_leftovers_path(card: str, rows: int, seed: int, tmp: str) -> dict:
    """Phase 5f: :func:`url_lookup` and :func:`dataset_lookup`, with the
    caches sized to their working sets (:data:`LOOKUP_CACHE_KNOBS`), which
    their warm checks need."""
    with knobs(**LOOKUP_CACHE_KNOBS):
        url = url_lookup(card, seed, tmp)
        ds = dataset_lookup(card, rows, seed, tmp)
    return {"probe": url["probe"],
            "launches": {k: url["launches"][k] + ds["launches"][k]
                         for k in url["launches"]}}


# ---------------------------------------------------------------------------
# phase 5f(c): struct-leaf lookup keys; phase 5g: reads through faults
# ---------------------------------------------------------------------------

STRUCT_ROWS_NULL = (0.10, 0.05)  # null structs, null ids among the rest


def make_struct_table(rows: int, seed: int) -> dict:
    """An optional struct ``user {id INT64 optional, score DOUBLE}`` with
    10 % null structs and 5 % null ids, and a flat ``k``: ``id`` is ``2 *
    row`` (sorted, so the page index narrows each key), as def levels."""
    rng = np.random.default_rng(seed + 31)
    null_struct = rng.random(rows) < STRUCT_ROWS_NULL[0]
    null_id = (rng.random(rows) < STRUCT_ROWS_NULL[1]) & ~null_struct
    return {"id": 2 * np.arange(rows, dtype=np.int64),
            "score": rng.random(rows),
            "id_def": np.where(null_struct, 0, np.where(null_id, 1, 2)),
            "score_def": np.where(null_struct, 0, 1),
            "k": np.arange(rows, dtype=np.int64)}


def struct_schema() -> Schema:
    return S.message("m", [
        S.optional(S.group("user", [S.optional(S.leaf("id", Type.INT64)),
                                    S.leaf("score", Type.DOUBLE)])),
        S.leaf("k", Type.INT64)])


def check_struct_hits(res, keys: np.ndarray, t: dict) -> None:
    """Key ``2r`` hits row ``r`` where its struct and id are present, with
    ``user.score`` valid; an odd key, or one on a null, hits nothing."""
    rows = np.where(keys % 2 == 0, keys // 2, -1)
    ok = rows >= 0
    ok[ok] = t["id_def"][rows[ok]] == 2
    for h, r, hit in zip(res, rows.tolist(), ok.tolist()):
        want = [r] if hit else []
        if h.rows.tolist() != want:
            raise AssertionError(f"struct lookup: key {h.key} hits "
                                 f"{h.rows.tolist()}, not {want}")
        if hit and (h.values["user.score"].tolist() != [t["score"][r]]
                    or h.validity["user.score"].tolist() != [True]
                    or h.values["k"].tolist() != [r]):
            raise AssertionError(f"struct lookup: key {h.key}'s values")


def struct_lookup_path(card: str, rows: int, seed: int, tmp: str) -> dict:
    """Phase 5f(c): ``find_rows`` on a leaf under an optional struct.  The
    file (:func:`make_struct_table`, the port's writer, 8 row groups, a
    page index and a bloom filter on ``user.id``) is looked up with
    ``rows / 16`` keys, one in eight present, cold and warm on the card:
    each equal to the numpy oracle, one ``bloom_check`` launch in the cold
    lookup, its counters equal to the CPU's; a ``list<int64>`` key raises
    ``ValueError``."""
    t = make_struct_table(rows, seed)
    path = os.path.join(tmp, "struct.parquet")
    t0 = time.perf_counter()
    pq.write_table(
        {"user.id": ColumnData(values=t["id"][t["id_def"] == 2],
                               def_levels=t["id_def"]),
         "user.score": ColumnData(values=t["score"][t["score_def"] == 1],
                                  def_levels=t["score_def"]),
         "k": t["k"]}, path,
        pq.WriterOptions(row_group_size=ROW_GROUP, data_page_size=8192,
                         compression="uncompressed",
                         bloom_filters={"user.id": 10}),
        schema=struct_schema())
    write_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 37)
    n = rows // 16  # one in eight a stored id, the others odd
    even = rng.choice(rows, n // 8, replace=False) * 2
    odd = rng.choice(rows, n - n // 8, replace=False) * 2 + 1
    keys = rng.permutation(np.concatenate([even, odd]).astype(np.int64))
    columns = ["user.score", "k"]
    pq.reset_launches()
    pq.clear_caches()
    f = pq.ParquetFile(path)
    runs = []
    for _ in range(2):
        before = pq.LAUNCHES["bloom_check"]
        res, s = timed_lookup(f, keys, DEVICE, "user.id", columns)
        check_struct_hits(res, keys, t)
        runs.append((dict(res.counters), s,
                     pq.LAUNCHES["bloom_check"] - before))
        del res
    launches = dict(pq.LAUNCHES)
    if runs[0][2] != 1 or runs[1][2] > 1:
        raise AssertionError(f"struct lookup: bloom_check launched "
                             f"{[r[2] for r in runs]} times, cold and warm")
    pq.clear_caches()
    t0 = time.perf_counter()
    cpu = pq.ParquetFile(path).find_rows("user.id", keys, columns=columns,
                                         device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu.counters != runs[0][0]:
        raise AssertionError(f"struct lookup: counters on {DEVICE} "
                             f"{runs[0][0]} differ from the CPU's "
                             f"{cpu.counters}")
    del cpu
    lpath = os.path.join(tmp, "list_key.parquet")
    pq.write_table({"l.list.element": ColumnData(
        values=np.arange(6, dtype=np.int64),
        list_offsets=[np.array([0, 2, 2, 6], np.int64)])}, lpath,
        pq.WriterOptions(compression="uncompressed"),
        schema=S.message("m", [S.list_of("l", S.leaf("element",
                                                     Type.INT64))]))
    try:
        pq.ParquetFile(lpath).find_rows("l.list.element", [1], device=DEVICE)
    except ValueError:
        pass
    else:
        raise AssertionError("find_rows on a list<int64> key did not raise "
                             "ValueError")
    log({"struct_lookup": {
        "card": card, "rows": rows, "row_groups": -(-rows // ROW_GROUP),
        "keys": len(keys), "present": int(runs[0][0]["rows_matched"]),
        "file_bytes": os.path.getsize(path), "write_s": write_s,
        "cold_s": runs[0][1], "warm_s": runs[1][1], "cpu_cold_s": cpu_s,
        "keys_per_s_cold": len(keys) / runs[0][1],
        "keys_per_s_warm": len(keys) / runs[1][1],
        "counters_cold": runs[0][0], "counters_warm": runs[1][0],
        "bloom_launches": [r[2] for r in runs], "launches": launches,
        "list_key_raises": "ValueError"}})
    return {"launches": launches}


RETRY_FAULTS = {"seed": 7, "error_rate": 0.1, "max_consecutive_errors": 2}
RETRY_POLICY = pq.FaultPolicy(max_retries=3, backoff_s=0)
SKIP_POLICY = pq.FaultPolicy(max_retries=3, backoff_s=0,
                             on_corrupt="skip_row_group")
SKIP_ROW_GROUP = 3  # the row group phase 5g corrupts
DEADLINE = {"latency_s": 0.01, "deadline_s": 0.05}
RESILIENCE_WARM = 3


def header_flips(path: str, rg: int, column: int) -> list:
    """Three bytes of the first page header of a chunk (a flipped header
    does not parse: the chunk is corrupt)."""
    meta = pq.ParquetFile(path).metadata.row_groups[rg].columns[column]
    m = meta.meta_data
    off = m.dictionary_page_offset or m.data_page_offset
    return [off, off + 1, off + 2]


def injected(path: str, **faults):
    """``path`` opened through a ``FaultInjectingSource`` over its map."""
    return pq.FaultInjectingSource(pq.MmapSource(path), **faults)


@contextlib.contextmanager
def prefetchers():
    """Every chunk prefetcher the reads inside the block make."""
    from parquet_tpu_torch.io import prefetch

    made, real = [], prefetch.make_chunk_prefetcher

    def spy(source, *a, **k):
        got = real(source, *a, **k)
        made.append(got)
        return got

    prefetch.make_chunk_prefetcher = spy
    try:
        yield made
    finally:
        prefetch.make_chunk_prefetcher = real


def settled_allocated() -> int:
    """The card's allocated bytes once the allocator has returned the
    freed blocks that waited on another stream's events (a staged buffer
    used on the decoding stream): a small allocation processes them."""
    gc.collect()
    torch.cuda.synchronize()
    torch.empty(1, device=DEVICE)
    return torch.cuda.memory_allocated()


def walls(run) -> dict:
    """``run()`` once cold and :data:`RESILIENCE_WARM` times warm, each
    synchronized: its seconds, the best warm one first."""
    times = []
    for _ in range(1 + RESILIENCE_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return {"best_warm_s": min(times[1:]), "cold_s": times[0],
            "warm_s": times[1:]}


def resilience_path(card: str, read: dict, scan: dict, look_path: str,
                    lookup_rows: int, dataset_paths: list, seed: int,
                    tmp: str) -> dict:
    """Phase 5g: the reads of phase 4's 5-column file through injected
    faults, each held to the clean read bit for bit (no chunk on the host
    route, both unpack kernels launched): transient errors retried under
    ``FaultPolicy(max_retries=3)``, the same under the ring prefetcher,
    a corrupt page header skipped under ``skip_row_group`` (the other row
    groups equal, the loss recorded), and a deadline that fires (no
    thread left, the card's allocated bytes back, the next read equal);
    then the device scan of phase 5b's case A and the lookup of phase 5
    each with one corrupt row group skipped (the rest equal to their numpy
    oracles), ``Dataset.read`` over phase 5c's 8 parts with one truncated
    (dropped whole), and the walls of the clean, policy, retry, ring and
    advise reads."""
    path = read["path"]
    clean = pq.ParquetFile(path).read(device=DEVICE)
    n_rg = len(pq.ParquetFile(path).row_groups)
    k = min(SKIP_ROW_GROUP, n_rg - 1)
    pq.reset_launches()
    reset_routes()
    pq.reset_plan_route()
    out = {}

    # retries
    rep = pq.ReadReport()
    src = injected(path, **RETRY_FAULTS)
    got = pq.ParquetFile(src, policy=RETRY_POLICY).read(device=DEVICE,
                                                        report=rep)
    same_bits(got, clean, "the retry read")
    del got
    if rep.retries <= 0 or not rep.ok or rep.rows_read != pq.ParquetFile(
            path).num_rows:
        raise AssertionError(f"retry read: report {rep.as_dict()}")
    no_host_route("the retry read")
    out["retry"] = {"retries": rep.retries,
                    "injected_errors": src.stats.injected_errors,
                    "preads": src.stats.preads}
    for name in READ_KERNELS:
        if pq.LAUNCHES[name] == 0:
            raise AssertionError(f"the retry read launched no {name}")

    # the same through the ring prefetcher
    rep = pq.ReadReport()
    with knobs(PARQUET_TPU_TORCH_PREFETCH="ring"), prefetchers() as made:
        got = pq.ParquetFile(injected(path, **RETRY_FAULTS),
                             policy=RETRY_POLICY).read(device=DEVICE,
                                                       report=rep)
    same_bits(got, clean, "the ring read")
    del got
    if not made or any(p is None or p.backend != "ring" for p in made):
        raise AssertionError("the ring read did not prefetch on the ring")
    out["ring"] = {"retries": rep.retries,
                   "read_stats": [p.stats.as_dict() for p in made]}

    # a corrupt page header under skip_row_group
    rep = pq.ReadReport()
    got = pq.ParquetFile(injected(path, flip_offsets=header_flips(
        path, k, 0)), policy=SKIP_POLICY).read(device=DEVICE, report=rep)
    keep = [i for i in range(n_rg) if i != k]
    same_bits(got, pq.ParquetFile(path).read(device=DEVICE, row_groups=keep),
              "the skip read")
    del got
    rg_rows = pq.ParquetFile(path).row_group(k).num_rows
    if rep.row_groups_skipped != [k] or rep.rows_dropped != rg_rows:
        raise AssertionError(f"skip read: report {rep.as_dict()}")
    out["skip"] = {"row_groups_skipped": rep.row_groups_skipped,
                   "rows_dropped": rep.rows_dropped,
                   "rows_read": rep.rows_read, "error": rep.errors[0]}

    # a deadline
    threads, allocated = threading.active_count(), settled_allocated()
    f = pq.ParquetFile(injected(path, latency_s=DEADLINE["latency_s"]))
    t0 = time.perf_counter()
    try:
        f.read(device=DEVICE, policy=pq.FaultPolicy(
            deadline_s=DEADLINE["deadline_s"], backoff_s=0))
    except pq.DeadlineError:
        raised_s = time.perf_counter() - t0
    else:
        raise AssertionError("the deadline read did not raise")
    if threading.active_count() != threads:
        raise AssertionError(f"the deadline read left "
                             f"{threading.active_count() - threads} "
                             "threads behind")
    left = settled_allocated() - allocated
    if left:
        raise AssertionError(f"the deadline read left {left} bytes "
                             "allocated on the card")
    got = pq.ParquetFile(path).read(device=DEVICE)
    same_bits(got, clean, "the read after the deadline")
    del got
    out["deadline"] = {**DEADLINE, "raised_after_s": raised_s}
    read_launches = dict(pq.LAUNCHES)

    # the device scan of case A with its row group corrupt
    table, spath = scan["cfg5"], scan["cfg5_path"]
    ship = table["l_shipdate"]
    lo, hi = SCAN_RANGE
    rg_rows = -(-len(ship) // SCAN_ROW_GROUPS)
    rg = int(np.flatnonzero((ship >= lo) & (ship <= hi))[0]) // rg_rows
    rep = pq.ReadReport()
    outs = ["l_orderkey", "l_quantity", "l_extendedprice"]
    got = pq.scan_filtered_device(
        pq.ParquetFile(injected(spath, flip_offsets=header_flips(spath, rg,
                                                                 0)),
                       policy=SKIP_POLICY), "l_shipdate", lo=lo, hi=hi,
        columns=outs, device=DEVICE, report=rep)
    in_rg = np.arange(len(ship)) // rg_rows == rg
    check_scan(got, oracle({c: table[c] for c in outs},
                           (ship >= lo) & (ship <= hi) & ~in_rg),
               "the skip scan")
    if rep.row_groups_skipped != [rg]:
        raise AssertionError(f"skip scan: report {rep.as_dict()}")
    out["scan"] = {"row_groups_skipped": rep.row_groups_skipped,
                   "rows_dropped": rep.rows_dropped}
    del got

    # the lookup with one corrupt row group
    look = make_lookup_table(lookup_rows, seed)
    keys = make_keys(lookup_rows, seed)
    k = min(SKIP_ROW_GROUP, len(pq.ParquetFile(look_path).row_groups) - 1)
    rep = pq.ReadReport()
    res = pq.ParquetFile(injected(look_path, flip_offsets=header_flips(
        look_path, k, 0)), policy=SKIP_POLICY).find_rows(
        "k", keys, columns=LOOKUP_COLUMNS, device=DEVICE, report=rep)
    in_k = (2 * keys) // ROW_GROUP == k  # key 2j sits in rows 4j..4j+3
    if any(h.num_rows for h, gone in zip(res, in_k) if gone):
        raise AssertionError("skip lookup: a key of the dropped row group "
                             "has rows")
    if not in_k.all():
        check_lookup([h for h, gone in zip(res, in_k) if not gone],
                     keys[~in_k], look)
    if rep.row_groups_skipped != [k] or rep.rows_dropped != min(
            ROW_GROUP, lookup_rows - k * ROW_GROUP):
        raise AssertionError(f"skip lookup: report {rep.as_dict()}")
    out["lookup"] = {"keys": len(keys),
                     "row_groups_skipped": rep.row_groups_skipped,
                     "rows_dropped": rep.rows_dropped,
                     "counters": dict(res.counters)}
    del res, look

    # Dataset.read over 8 parts with one truncated
    bad = os.path.join(tmp, "truncated.parquet")
    with open(dataset_paths[2], "rb") as fsrc, open(bad, "wb") as fdst:
        fdst.write(fsrc.read(os.path.getsize(dataset_paths[2]) // 2))
    paths = list(dataset_paths)
    paths[2] = bad
    rep = pq.ReadReport()
    got = pq.Dataset(paths).read(device=DEVICE, policy=SKIP_POLICY,
                                 report=rep)
    parts = [pq.ParquetFile(p).read(device=DEVICE)
             for i, p in enumerate(dataset_paths) if i != 2]
    same_bits(got, {c: concat_columns([p[c] for p in parts])
                    for c in parts[0]}, "the dataset skip read")
    if rep.files_skipped != [bad] or rep.row_groups_skipped:
        raise AssertionError(f"dataset skip read: report {rep.as_dict()}")
    out["dataset"] = {"files": len(paths), "files_skipped": 1,
                      "rows_read": rep.rows_read}
    del got, parts
    launches = dict(pq.LAUNCHES)

    # walls
    def clean_read():
        return pq.ParquetFile(path).read(device=DEVICE)

    def policy_read():
        return pq.ParquetFile(path, policy=RETRY_POLICY).read(device=DEVICE)

    def retry_read():
        return pq.ParquetFile(injected(path, **RETRY_FAULTS),
                              policy=RETRY_POLICY).read(device=DEVICE)

    timed = {"clean": walls(clean_read), "policy_no_faults":
             walls(policy_read), "retry": walls(retry_read)}
    with knobs(PARQUET_TPU_TORCH_PREFETCH="ring"):
        timed["ring_retry"] = walls(retry_read)
    with knobs(PARQUET_TPU_TORCH_PREFETCH="advise"):
        timed["advise"] = walls(clean_read)
    del clean
    log({"resilience": {"card": card, "rows": pq.ParquetFile(path).num_rows,
                        "row_groups": n_rg, **out, "walls": timed,
                        "launches_reads": read_launches,
                        "launches": launches}})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 5h: streamed reads on the card
# ---------------------------------------------------------------------------

STREAM_WARM = 1  # 3 before phase 5p, 2 before 5q (the script's time)
STREAM_MEMORY_SHARE = 0.25  # a drain's peak bytes under this share of a read
STREAM_CRC_ROW_GROUP = 2  # the row group phase 5h's CRC check corrupts
# the kernels each drain must launch (lineitem's indexes are bit-packed in
# some row groups only, the dataset's in some parts)
STREAM_KERNELS = {"5col": READ_KERNELS, "nest_mix": READ_KERNELS,
                  "cfg4": ("unpack_bits_dense",)}


class SpySource(pq.Source):
    """A source that records every read it passes on, ``(offset, size)``;
    ``inner`` is the file's source (a prefetcher still finds the map)."""

    def __init__(self, inner):
        self.inner = inner
        self.reads = []

    @property
    def path(self):
        return getattr(self.inner, "path", None)

    def pread(self, offset: int, size: int):
        self.reads.append((offset, size))
        return self.inner.pread(offset, size)

    def pread_view(self, offset: int, size: int):
        self.reads.append((offset, size))
        return self.inner.pread_view(offset, size)

    def size(self) -> int:
        return self.inner.size()

    def close(self) -> None:
        self.inner.close()


def expected_batches(rg_rows: list, batch_rows: int, strict: bool) -> list:
    """The row counts of a drain's batches by the JAX package's rule: a
    batch ends at ``batch_rows`` rows, or at a row-group boundary once at
    least half full (not under ``strict``)."""
    out, pending = [], 0
    for rows in rg_rows:
        while rows:
            take = min(batch_rows - pending, rows)
            pending += take
            rows -= take
            if pending >= batch_rows or (not strict and rows == 0
                                         and pending * 2 >= batch_rows):
                out.append(pending)
                pending = 0
    return out + ([pending] if pending else [])


class HostRows:
    """A whole read's columns on the host, cut by rows with numpy alone:
    each repeated level's offsets, then validity and value starts by a
    prefix count (the oracle of a streamed batch)."""

    def __init__(self, cols: dict):
        self.cols = {}
        for name, col in cols.items():
            got = col.materialize_host()
            values = got["values"] if isinstance(got, dict) else got
            validity = (None if col.validity is None
                        else col.validity.cpu().numpy())
            starts = None if validity is None else np.concatenate(
                [[0], np.cumsum(validity)])
            self.cols[name] = (
                values, validity, starts,
                [o.cpu().numpy() for o in col.list_offsets],
                [v.cpu().numpy() for v in col.list_validity],
                col.def_levels)

    def rows(self, name: str, r0: int, r1: int) -> tuple:
        values, validity, starts, offs, lval, defs = self.cols[name]
        lo, hi = r0, r1
        got_offs, got_lval = [], []
        for o, lv in zip(offs, lval):
            got_offs.append(o[lo:hi + 1] - o[lo])
            got_lval.append(lv[lo:hi])
            lo, hi = int(o[lo]), int(o[hi])
        v0, v1 = (lo, hi) if starts is None else (int(starts[lo]),
                                                  int(starts[hi]))
        if isinstance(values, tuple):
            data, o = values
            values = (data[o[v0]:o[v1]], o[v0:v1 + 1] - o[v0])
        else:
            values = values[v0:v1]
        return (values, None if validity is None else validity[lo:hi],
                got_offs, got_lval,
                None if defs is None or offs else defs[r0:r1])


def batch_rows_of(batch: dict) -> int:
    col = next(iter(batch.values()))
    return (col.list_offsets[0].shape[0] - 1 if col.list_offsets
            else col.num_slots)


def check_batch(batch: dict, want: HostRows, r0: int, what: str) -> int:
    """A streamed batch against rows ``[r0, r0 + its rows)`` of the whole
    read, column by column; returns its rows."""
    n = batch_rows_of(batch)
    if list(batch) != list(want.cols):
        raise AssertionError(f"{what}: columns {list(batch)}")
    for name, col in batch.items():
        on = (col.values if col.values is not None
              else col.dict_indices).device
        if on.type != torch.device(DEVICE).type:
            raise AssertionError(f"{what}: {name} decoded on {on}")
        values, validity, offs, lval, defs = want.rows(name, r0, r0 + n)
        got = col.materialize_host()
        gv = got["values"] if isinstance(got, dict) else got
        ok = _equal(gv, values) and _mask_equal(col.validity, validity) \
            and len(col.list_offsets) == len(offs)
        for k, o in enumerate(offs):
            ok = ok and np.array_equal(col.list_offsets[k].cpu().numpy(), o)
            ok = ok and _mask_equal(col.list_validity[k], lval[k])
        if defs is not None and col.def_levels is not None:
            ok = ok and np.array_equal(col.def_levels, defs)
        if not ok:
            raise AssertionError(f"{what}: {name} differs from the whole "
                                 f"read at rows [{r0}, {r0 + n})")
    return n


def row_group_rows(path: str) -> list:
    return [rg.num_rows for rg in pq.ParquetFile(path).row_groups]


def window_bound(chunk) -> int:
    """The largest pread ``pages_streamed`` may make of ``chunk``: its
    window, or one page and its header where a page is larger."""
    _, size = chunk.byte_range
    rows = chunk.page_table().rows
    page = int((rows[:, host.PG_DATA_POS] + rows[:, host.PG_COMP]
                - rows[:, host.PG_HEADER_POS]).max())
    return max(max(min(1 << 20, size // 16), 1 << 16), page)


def check_preads(path: str, reads: list, what: str) -> dict:
    """No pread of a drain covers a whole chunk; each is within the
    window bound of the chunk it reads."""
    f = pq.ParquetFile(path)
    chunks = [rg.column(i) for rg in f.row_groups
              for i in range(len(f.schema.leaves))]
    spans = sorted((c.byte_range[0], c.byte_range[1], window_bound(c))
                   for c in chunks)
    starts = [s for s, _, _ in spans]
    import bisect

    worst = 0.0
    for off, size in reads:
        i = bisect.bisect_right(starts, off) - 1
        start, csize, limit = spans[i]
        if off + size > start + csize:
            raise AssertionError(f"{what}: a pread of [{off}, {off + size})"
                                 " runs past its chunk")
        if size >= csize and csize > limit:
            raise AssertionError(f"{what}: a pread covers a whole chunk")
        if size > limit:
            raise AssertionError(f"{what}: a pread of {size} bytes over "
                                 f"the bound {limit}")
        worst = max(worst, size / limit)
    return {"preads": len(reads), "largest": max(s for _, s in reads),
            "largest_over_bound": worst}


def drain(f, batch_rows: int, strict: bool = False, **kw):
    """The batches of one drain of ``f`` (a file or a dataset), on the
    card."""
    return f.iter_batches(batch_rows=batch_rows, strict_batch_rows=strict,
                          device=DEVICE, **kw)


def consume(batches, sync: bool = True) -> int:
    """Pull every batch and drop it: the drain's own work (then a
    synchronize, unless ``sync`` is false)."""
    n = 0
    for b in batches:
        n += batch_rows_of(b)
    if sync:
        torch.cuda.synchronize()
    return n


class WholeRead:
    """A file's (or a dataset's) whole read on the card, the reference of
    its drains: its columns kept on the host (:class:`HostRows`), its
    rows, its row groups' rows and its peak device bytes above those
    allocated before it."""

    def __init__(self, path):
        self.path = path
        self.dataset = isinstance(path, list)
        settled = settled_allocated()
        torch.cuda.reset_peak_memory_stats()
        whole = self.read()
        torch.cuda.synchronize()
        self.peak = torch.cuda.max_memory_allocated() - settled
        self.rows = batch_rows_of(whole)
        self.host = HostRows(whole)
        del whole
        self.rg_rows = ([row_group_rows(p) for p in path] if self.dataset
                        else [row_group_rows(path)])

    def read(self):
        if self.dataset:
            return pq.Dataset(self.path).read(device=DEVICE)
        return pq.ParquetFile(self.path).read(device=DEVICE)

    def open(self):
        return (pq.Dataset(self.path) if self.dataset
                else pq.ParquetFile(self.path))


def checked_drain(f, ref: WholeRead, batch_rows: int, strict: bool,
                  what: str) -> list:
    """Drain ``f`` on the card, each batch held as it arrives against the
    whole read's rows (the checks outside the count of synchronizing
    calls: the sync debug mode is off while they run), none kept; the
    batches' row counts."""
    sizes, at = [], 0
    for batch in drain(f, batch_rows, strict):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            n = check_batch(batch, ref.host, at, what)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        sizes.append(n)
        at += n
        del batch
    return sizes


def stream_entry(card: str, name: str, ref: WholeRead, batch_rows: int,
                 strict: bool = False, spy: bool = False,
                 memory: bool = False) -> dict:
    """One drain of phase 5h: run once checked (:func:`checked_drain`;
    its row counts by the rule, no host route, the kernels launched, the
    card's allocated bytes back at the end, its synchronizing calls
    counted), its preads spied on where ``spy``, its peak device bytes
    above its start held under :data:`STREAM_MEMORY_SHARE` of the whole
    read's where ``memory``; then the best of :data:`STREAM_WARM` warm
    drains beside as many warm whole reads, in turns."""
    expect = [n for rgs in ref.rg_rows
              for n in expected_batches(rgs, batch_rows, strict)]
    f = ref.open()
    if spy:
        f.source = f._base_source = SpySource(f.source)
    pq.reset_launches()
    reset_routes()
    pq.reset_stream()
    start = settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    sizes = []
    what = f"{name} at {batch_rows}"
    syncs = count_syncs(lambda: sizes.extend(checked_drain(
        f, ref, batch_rows, strict, what)))
    peak = torch.cuda.max_memory_allocated() - start
    left = settled_allocated() - start
    launches = dict(pq.LAUNCHES)
    stream = dict(pq.STREAM)
    if sizes != expect or sum(sizes) != ref.rows:
        raise AssertionError(f"{what}: batches {sizes[:8]}... "
                             f"({len(sizes)}, {sum(sizes)} rows), the rule "
                             f"gives {expect[:8]}... ({len(expect)})")
    no_host_route(f"the {what} drain")
    if stream["host_pulls"]:
        raise AssertionError(f"{what}: {stream['host_pulls']} page spans "
                             "took the host route")
    for kernel in STREAM_KERNELS.get(name, ()):
        if launches[kernel] == 0:
            raise AssertionError(f"the {what} drain launched no {kernel}")
    if left:
        raise AssertionError(f"the {what} drain left {left} bytes "
                             "allocated on the card")
    if memory and peak >= STREAM_MEMORY_SHARE * ref.peak:
        raise AssertionError(f"the {what} drain peaked at {peak} bytes, "
                             f"the whole read at {ref.peak}")
    pre = check_preads(ref.path, f.source.reads, what) if spy else None

    walls, read_walls = [], []
    for _ in range(STREAM_WARM):  # in turns, on one card
        t0 = time.perf_counter()
        consume(drain(ref.open(), batch_rows, strict))
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ref.read()
        torch.cuda.synchronize()
        read_walls.append(time.perf_counter() - t0)
        del out
    best, best_read = min(walls), min(read_walls)
    return {"file": name, "batch_rows": batch_rows, "strict": strict,
            "rows": ref.rows, "batches": len(sizes),
            "pulls": stream["pulls"], "best_warm_s": best, "warm_s": walls,
            "rows_per_s": ref.rows / best, "read_best_warm_s": best_read,
            "read_rows_per_s": ref.rows / best_read,
            "drain_over_read": best / best_read,
            "syncs": syncs["count"], "syncs_by_line": syncs["by_line"],
            "launches": {k: launches[k] for k in READ_KERNELS},
            "peak_bytes": peak, "read_peak_bytes": ref.peak,
            "peak_share": peak / ref.peak if ref.peak else None,
            "preads": pre, "card": card}


class Steps:
    """Seconds and calls, inside the block, of the functions named in
    ``targets`` (``{step: (owner, attribute)}``), each call timed on its
    own, from any thread (a step's calls nested in another step count in
    both)."""

    def __init__(self, targets: dict):
        self._targets = targets
        self.seconds = dict.fromkeys(targets, 0.0)
        self.calls = dict.fromkeys(targets, 0)
        self._lock = threading.Lock()
        self._saved = []

    def __enter__(self):
        for name, (owner, attr) in self._targets.items():
            real = getattr(owner, attr)

            def timed(*a, real=real, name=name, **k):
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    with self._lock:
                        self.seconds[name] += time.perf_counter() - t0
                        self.calls[name] += 1

            self._saved.append((owner, attr, real))
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        self._saved = []


#: a streamed read's steps: a pull's plan and staging, its device decode
#: and its row starts, the slices and a batch's concatenation
PULL_STEPS = ("prepare", "decode", "piece", "slice", "concat")


def pull_steps() -> dict:
    from parquet_tpu_torch.io import stream

    return dict(zip(PULL_STEPS, (
        (device_reader, "_prepare"), (device_reader, "decode_staged"),
        (stream, "piece_from_column"), (stream, "_slice_rows"),
        (stream, "_concat_pending"))))


def pulls_s(steps: Steps) -> float:
    return sum(steps.seconds[k] for k in PULL_STEPS if k in steps.seconds)


def stream_breakdown(card: str, path: str, batch_rows: int = 65_536) -> dict:
    """The 5-column drain at ``batch_rows`` twice, each with the seconds of
    its steps (:class:`Steps` of :func:`pull_steps`); then one drain under
    the profiler, for the device's idle share."""
    runs = []
    for _ in range(2):
        with Steps(pull_steps()) as st:
            t0 = time.perf_counter()
            consume(drain(pq.ParquetFile(path), batch_rows))
            wall = time.perf_counter() - t0
        runs.append({"wall_s": wall, "step_s": st.seconds,
                     "calls": st.calls})

    def timed():
        t0 = time.perf_counter()
        consume(drain(pq.ParquetFile(path), batch_rows))
        return None, time.perf_counter() - t0

    return {"card": card, "batch_rows": batch_rows, "runs": runs,
            "best_s": min(r["wall_s"] for r in runs),
            **device_profile(timed, "drain")}


class _LastStats:
    """A file whose drains record each batch's ``read_stats`` in
    ``stats``."""

    def __init__(self, f, stats: list):
        self._f, self._stats = f, stats

    def iter_batches(self, **kw):
        for batch in self._f.iter_batches(**kw):
            self._stats.append(batch.read_stats)
            yield batch


def payload_flip(path: str, rg: int) -> int:
    """A byte in the middle of the first data page of row group ``rg``'s
    first chunk."""
    chunk = pq.ParquetFile(path).row_group(rg).column(0)
    rows = chunk.page_table().rows
    data = int(np.flatnonzero(rows[:, host.PG_TYPE] != int(
        PageType.DICTIONARY_PAGE))[0])
    return (chunk.byte_range[0] + int(rows[data, host.PG_DATA_POS])
            + int(rows[data, host.PG_COMP]) // 2)


def crc_checks(card: str, path: str) -> dict:
    """Phase 5h(e): one byte flipped mid-page in row group 2 of the
    5-column file.  With ``ReadOptions(verify_crc=True)`` the read and the
    drain raise ``CorruptedError`` naming the CRC; under
    ``skip_row_group`` the drain drops that row group alone and the rest
    equals the clean rows; and the clean file's read with the check and
    without, best of :data:`STREAM_WARM` warm each, in turns."""
    k = STREAM_CRC_ROW_GROUP
    flip = payload_flip(path, k)
    opts = pq.ReadOptions(verify_crc=True)

    def faulty(**kw):
        return pq.ParquetFile(injected(path, flip_offsets=[flip]),
                              options=opts, **kw)

    raised = {}
    for what, run in (("read", lambda: faulty().read(device=DEVICE)),
                      ("drain", lambda: consume(drain(faulty(), 65_536)))):
        try:
            run()
        except pq.CorruptedError as e:
            if "page CRC mismatch" not in str(e) or \
                    f"row-group={k}" not in str(e):
                raise AssertionError(f"the CRC {what} raised {e}")
            raised[what] = str(e)
        else:
            raise AssertionError(f"the {what} with a flipped page byte "
                                 "and verify_crc raised nothing")
    n_rg = len(pq.ParquetFile(path).row_groups)
    keep = [i for i in range(n_rg) if i != k]
    want = HostRows(pq.ParquetFile(path).read(device=DEVICE, row_groups=keep))
    rep = pq.ReadReport()
    at = 0
    for batch in drain(faulty(policy=SKIP_POLICY), 65_536, report=rep):
        at += check_batch(batch, want, at, "the CRC skip drain")
    if rep.row_groups_skipped != [k] or at != sum(
            row_group_rows(path)[i] for i in keep):
        raise AssertionError(f"CRC skip drain: report {rep.as_dict()}")
    walls = {"clean": [], "verify_crc": []}
    for _ in range(STREAM_WARM):
        for name, o in (("clean", None), ("verify_crc", opts)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pq.ParquetFile(path, options=o).read(device=DEVICE)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            del out
    return {"card": card, "flip_offset": flip, "raised": raised,
            "skip": {"row_groups_skipped": rep.row_groups_skipped,
                     "rows_dropped": rep.rows_dropped, "rows_read": at},
            "read_best_warm_s": {n: min(w) for n, w in walls.items()},
            "read_warm_s": walls,
            "verify_over_clean": min(walls["verify_crc"]) / min(
                walls["clean"])}


def stream_path(card: str, read: dict, item: dict, nested: dict,
                dataset_paths: list) -> dict:
    """Phase 5h: ``iter_batches`` on the card.  (a) the 5-column file at
    65,536 (its preads spied on, its peak device bytes against the whole
    read's), 1,048,576 and 100,000 strict; (b) lineitem at 65,536 and
    1,048,576; (c) cfg 4 and the mixed nested file at 65,536; (d)
    ``Dataset.iter_batches`` over phase 5c's 8 parts at 65,536; each
    drain checked against its whole read (:func:`stream_entry`); (e) the
    page CRCs (:func:`crc_checks`); (f) lineitem's 65,536 drain again
    under ``PARQUET_TPU_TORCH_MMAP_DROPBEHIND=1``, equal, with
    ``bytes_dropbehind > 0``.  Prints one ``{"stream": [...]}`` line and
    one ``{"crc": ...}`` line; returns the phase's kernel launches."""
    total = dict.fromkeys(pq.LAUNCHES, 0)
    entries = []

    def entry(*a, **kw):
        got = stream_entry(card, *a, **kw)
        for k, v in got["launches"].items():
            total[k] += v
        entries.append(got)

    ref = WholeRead(read["path"])
    entry("5col", ref, 65_536, spy=True, memory=True)
    entry("5col", ref, 1 << 20)
    entry("5col", ref, 100_000, strict=True)
    ref = WholeRead(item["path"])
    entry("lineitem", ref, 65_536, spy=True)
    entry("lineitem", ref, 1 << 20)

    # (f) drop-behind on lineitem's drain
    with knobs(PARQUET_TPU_TORCH_MMAP_DROPBEHIND="1"):
        stats = []
        checked_drain(_LastStats(ref.open(), stats), ref, 65_536, False,
                      "the drop-behind drain")
    last = stats[-1] if stats else None
    if last is None or last.bytes_dropbehind <= 0 or last.backend != \
            "advise":
        raise AssertionError(f"drop-behind drain: {last}")
    dropbehind = {"rows": ref.rows, **last.as_dict()}
    entry("cfg4", WholeRead(nested["path"]), 65_536)
    entry("nest_mix", WholeRead(nested["mix_path"]), 65_536)
    entry("dataset", WholeRead(list(dataset_paths)), 65_536)
    del ref
    log({"stream": entries, "dropbehind": dropbehind, "card": card})
    log({"crc": crc_checks(card, read["path"])})
    return {"launches": total}


# ---------------------------------------------------------------------------
# phase 5i: typed reads, rows, merge and sort
# ---------------------------------------------------------------------------

# phase 5i's depth, halved again when phase 5n came and again when 5p came
# (the script's time: the whole script took 1,107 s on an NVIDIA H100
# 80GB HBM3 at 700 W before this cut): each size and row group below is
# half of what it was, so every file keeps its count of row groups
# 1 << 20 before phase 5j, 1 << 19 before 5n, 1 << 18 before 5p
TYPED_ROWS = 1 << 17
TYPED_ROW_GROUP = 1 << 16
TYPED_BATCH = 65_536
TYPED_READ = 100_000
# 1 << 18 before phase 5j, 1 << 17 before 5n, 1 << 16 before 5p
DOC_ROWS = 1 << 15
DOC_ROW_GROUP = 1 << 14
DOC_PAGE = 8 << 10
DOC_SEEKS = 16
DOC_SEEK_ROWS = 4_096
MERGE_RUNS = 4  # 8 runs cut to 4: phase 5i's merges took 270 s at 8
MERGE_RUN_ROWS = 1 << 18  # 1 << 20 before phase 5n, 1 << 19 before 5p
MERGE_ROW_GROUP = 1 << 17
MERGE_BATCH = 65_536
MERGE_KEYS = ("l_orderkey", "l_extendedprice")
SORT_ROWS = 1 << 18  # 1 << 20 before phase 5n, 1 << 19 before 5p
SORT_BUFFER = 65_536
SORT_KEYS = (("l_shipdate", True), ("l_orderkey", False),
             ("l_extendedprice", False))
WARM_5I = 2  # warm runs a path, the best of them reported
SNAPPY = int(CompressionCodec.SNAPPY)


@dataclasses.dataclass
class Geo:
    lat: float
    lon: float


@dataclasses.dataclass
class Event:
    id: int
    region: int
    user: str
    ts: datetime.datetime
    day: datetime.date
    score: Optional[float]
    tags: List[str]
    attrs: Dict[str, int]
    geo: Optional[Geo]


def make_events(n: int, seed: int) -> tuple:
    """``n`` seeded ``Event``s: unique ids, 200 regions, 20,000 users, 5 %
    null scores, 0-4 tags of 32, 0-3 attributes, 10 % null geos."""
    rng = np.random.default_rng(seed + 19)
    ids = rng.permutation(n).tolist()
    region = rng.integers(0, 200, n).tolist()
    users = [f"user{i:05d}" for i in range(20_000)]
    uidx = rng.integers(0, 20_000, n).tolist()
    ts = (np.datetime64("2020-01-01T00:00:00", "us") + rng.integers(
        0, 10**14, n).astype("timedelta64[us]")).astype(object).tolist()
    day = (np.datetime64("1990-01-01") + rng.integers(0, 15_000, n).astype(
        "timedelta64[D]")).astype(object).tolist()
    score = rng.random(n).tolist()
    null_score = (rng.random(n) < 0.05).tolist()
    pool = [f"tag{i:02d}" for i in range(32)]
    ntags = rng.integers(0, 5, n)
    tag_idx = rng.integers(0, 32, int(ntags.sum())).tolist()
    nattr = rng.integers(0, 4, n).tolist()
    attr_vals = rng.integers(-1000, 1000, (n, 3)).tolist()
    null_geo = (rng.random(n) < 0.10).tolist()
    lat, lon = rng.random(n).tolist(), rng.random(n).tolist()
    utc = datetime.timezone.utc
    objs, t = [], 0
    for i in range(n):
        k = int(ntags[i])
        tags = [pool[j] for j in tag_idx[t:t + k]]
        t += k
        objs.append(Event(
            id=ids[i], region=region[i], user=users[uidx[i]],
            ts=ts[i].replace(tzinfo=utc), day=day[i],
            score=None if null_score[i] else score[i], tags=tags,
            attrs={f"a{j}": attr_vals[i][j] for j in range(nattr[i])},
            geo=None if null_geo[i] else Geo(lat[i], lon[i])))
    return objs


def as_read(objs: list) -> list:
    """The objects as the typed read gives them back (in place): a null
    ``geo`` as ``Geo(None, None)``, the JAX package's reading, which the
    port keeps."""
    none_geo = Geo(None, None)
    for o in objs:
        if o.geo is None:
            o.geo = none_geo
    return objs


def measured(run, sync_count: bool = False) -> dict:
    """``run()`` once on a settled card: its wall, peak device bytes
    above the start, the bytes left allocated, its launches and pulls
    (and, with ``sync_count``, its synchronizing calls); ``out`` is its
    result."""
    pq.reset_launches()
    pq.reset_stream()
    reset_routes()
    start = settled_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = {}

    def once():
        t0 = time.perf_counter()
        got["out"] = run()
        torch.cuda.synchronize()
        got["wall_s"] = time.perf_counter() - t0

    syncs = count_syncs(once) if sync_count else None
    if not sync_count:
        once()
    got["peak_bytes"] = torch.cuda.max_memory_allocated() - start
    got["launches"] = dict(pq.LAUNCHES)
    got["pulls"] = pq.STREAM["pulls"]
    got["host_pulls"] = pq.STREAM["host_pulls"]
    if syncs is not None:
        got["syncs"], got["syncs_by_line"] = syncs["count"], syncs["by_line"]
    out = got.pop("out")
    got["left_bytes"] = settled_allocated() - start
    return out, got


def warm_walls(run, whole_read, steps: dict) -> dict:
    """:data:`WARM_5I` warm runs of ``run`` (each under :class:`Steps`
    of ``steps``) in turns with as many whole reads of the same file:
    the best of each and the best run's seconds by step."""
    runs, reads = [], []
    for _ in range(WARM_5I):
        torch.cuda.synchronize()
        with Steps(steps) as st:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del out
        runs.append((wall, st))
        t0 = time.perf_counter()
        out = whole_read()
        torch.cuda.synchronize()
        reads.append(time.perf_counter() - t0)
        del out
    best, st = min(runs, key=lambda r: r[0])
    return {"best_warm_s": best, "warm_s": [w for w, _ in runs],
            "read_best_warm_s": min(reads), "read_warm_s": reads,
            "step_s": st.seconds, "step_calls": st.calls,
            "pulls_s": pulls_s(st), "host_s": best - pulls_s(st)}


def check_launched(what: str, launches: dict, kernels) -> None:
    for kernel in kernels:
        if launches[kernel] == 0:
            raise AssertionError(f"{what} launched no {kernel}")


def codecs_of(path: str) -> set:
    return {rg.rg.columns[i].meta_data.codec
            for rg in pq.ParquetFile(path).row_groups
            for i in range(len(rg.rg.columns))}


def typed_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5i(a): 131,072 ``Event``s written by ``write_objects`` with
    the default options (Snappy, 65,536-row row groups), drained by
    ``TypedReader(..., batch_rows=65,536, device="cuda").read(100,000)``
    to the end, equal to the generated objects, as ``read_objects``;
    ``read_pytree`` equal to ``ParquetFile.read``; both unpack kernels
    launched, the card's allocated bytes back at the end."""
    from parquet_tpu_torch import typed

    t0 = time.perf_counter()
    objs = make_events(TYPED_ROWS, seed)
    gen_s = time.perf_counter() - t0
    path = os.path.join(tmp, "events.parquet")
    t0 = time.perf_counter()
    pq.write_objects(objs, path, Event, pq.WriterOptions(
        row_group_size=TYPED_ROW_GROUP))
    write_s = time.perf_counter() - t0
    want = as_read(objs)
    if codecs_of(path) != {SNAPPY}:
        raise AssertionError(f"typed file codecs {codecs_of(path)}")

    def drain():
        r = pq.TypedReader(path, Event, batch_rows=TYPED_BATCH,
                           device=DEVICE)
        out = []
        while True:
            got = r.read(TYPED_READ)
            if not got:
                return out
            out += got

    got, cold = measured(drain, sync_count=True)
    if got != want:
        raise AssertionError("typed drain: objects differ from the "
                             "generated ones")
    del got
    check_launched("the typed drain", cold["launches"], READ_KERNELS)
    no_host_route("the typed drain")
    if cold["left_bytes"]:
        raise AssertionError(f"the typed drain left {cold['left_bytes']} "
                             "bytes allocated on the card")
    t0 = time.perf_counter()
    if pq.read_objects(path, Event, device=DEVICE) != want:
        raise AssertionError("read_objects differs from the generated "
                             "objects")
    read_objects_s = time.perf_counter() - t0
    tree = pq.read_pytree(path, device=DEVICE)
    whole = pq.ParquetFile(path).read(device=DEVICE)
    for name, col in whole.items():
        t = tree[name]
        pairs = ((t["dictionary"][0], col.dictionary[0]),
                 (t["dictionary"][1], col.dictionary[1]),
                 (t["indices"], col.dict_indices)) \
            if isinstance(t, dict) and "indices" in t else \
            ((t["values"], col.values), (t["offsets"], col.offsets)) \
            if isinstance(t, dict) else ((t, col.values),)
        for a, b in pairs:
            if a.device.type != torch.device(DEVICE).type or \
                    not torch.equal(a, b):
                raise AssertionError(f"read_pytree {name} differs")
    del tree, whole, want, objs
    steps = {**pull_steps(), "assembly": (typed, "_assemble"),
             "to_pylist": (pq.Column, "to_pylist")}
    warm = warm_walls(drain, lambda: pq.ParquetFile(path).read(
        device=DEVICE), steps)
    out = {"rows": TYPED_ROWS, "row_group_rows": TYPED_ROW_GROUP,
           "batch_rows": TYPED_BATCH, "read_n": TYPED_READ,
           "file_bytes": os.path.getsize(path), "generate_s": gen_s,
           "write_s": write_s, "write_objects_per_s": TYPED_ROWS / write_s,
           "cold_s": cold["wall_s"], **warm,
           "objects_per_s": TYPED_ROWS / warm["best_warm_s"],
           "read_rows_per_s": TYPED_ROWS / warm["read_best_warm_s"],
           "read_objects_s": read_objects_s,
           "pulls": cold["pulls"], "syncs": cold["syncs"],
           "syncs_by_line": cold["syncs_by_line"],
           "launches": cold["launches"], "peak_bytes": cold["peak_bytes"],
           "card": card}
    log({"typed": out})
    return cold["launches"]


def doc_schema() -> Schema:
    """The Dremel paper's ``Document`` (Melnik et al., VLDB 2010, Fig. 2)."""
    ba = Type.BYTE_ARRAY
    return S.message("Document", [
        S.leaf("DocId", Type.INT64),
        S.group("Links", [S.repeated(S.leaf("Backward", Type.INT64)),
                          S.repeated(S.leaf("Forward", Type.INT64))],
                Rep.OPTIONAL),
        S.group("Name", [
            S.group("Language", [
                S.leaf("Code", ba, logical=LogicalKind.STRING),
                S.optional(S.leaf("Country", ba,
                                  logical=LogicalKind.STRING))],
                Rep.REPEATED),
            S.optional(S.leaf("Url", ba, logical=LogicalKind.STRING))],
            Rep.REPEATED)])


def make_documents(n: int, seed: int) -> list:
    """``n`` seeded Documents: 20 % without ``Links``, 0-2 backward and
    forward links, 0-2 names of 0-2 languages (half without a country),
    60 % of names with a URL."""
    rng = np.random.default_rng(seed + 23)
    codes = [f"en-{c}" for c in "abcde"]
    countries = ["us", "gb", "nz"]
    out = []
    for i in range(n):
        r = rng.random(8)
        links = None
        if r[0] < 0.8:
            links = {"Backward": list(range(i % 3)),
                     "Forward": [int(x) for x in rng.integers(
                         0, n, int(r[1] * 3))]}
        names = []
        for _ in range(int(r[2] * 3)):
            names.append({
                "Language": [{"Code": codes[int(rng.integers(5))],
                              "Country": (countries[int(rng.integers(3))]
                                          if rng.random() < 0.5 else None)}
                             for _ in range(int(rng.integers(0, 3)))],
                "Url": (f"http://{int(rng.integers(1000))}"
                        if rng.random() < 0.6 else None)})
        out.append({"DocId": i, "Links": links, "Name": names})
    return out


def host_columns(cols: dict) -> dict:
    """A read's columns on the host: values (byte arrays: values and
    offsets), validity, each level's list offsets and validity."""
    out = {}
    for name, col in cols.items():
        got = col.materialize_host()
        out[name] = (got["values"] if isinstance(got, dict) else got,
                     None if col.validity is None
                     else col.validity.cpu().numpy(),
                     [o.cpu().numpy() for o in col.list_offsets],
                     [v.cpu().numpy() for v in col.list_validity])
    return out


def same_host_columns(a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        raise AssertionError(f"{what}: columns differ")
    for name in a:
        (va, ma, oa, la), (vb, mb, ob, lb) = a[name], b[name]
        same = _equal(va, vb) and len(oa) == len(ob) and all(
            np.array_equal(x, y) for x, y in zip(oa + la, ob + lb))
        same = same and ((ma is None and mb is None) or (
            ma is not None and mb is not None and np.array_equal(ma, mb))
            or (ma is None and bool(mb.all())) or (mb is None
                                                   and bool(ma.all())))
        if not same:
            raise AssertionError(f"{what}: {name} differs")


def rows_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5i(b): 32,768 Documents written by ``write_rows`` (16,384-row
    row groups, 8 KiB pages, page index); ``read_rows(device="cuda")``
    equal to the records; ``FileRows.seek_to_row`` at 16 offsets (0, a
    page boundary, a row-group boundary, the last row, one past the end,
    and seeded ones) then ``read_rows(4,096)`` equal to the records
    there; ``copy_rows`` into a ``WriterRows`` of a second file whose
    whole read equals the first's."""
    from parquet_tpu_torch import rows

    schema = doc_schema()
    t0 = time.perf_counter()
    recs = make_documents(DOC_ROWS, seed)
    gen_s = time.perf_counter() - t0
    path = os.path.join(tmp, "documents.parquet")
    opts = pq.WriterOptions(row_group_size=DOC_ROW_GROUP,
                            data_page_size=DOC_PAGE)
    t0 = time.perf_counter()
    pq.write_rows(path, schema, recs, opts)
    write_s = time.perf_counter() - t0
    pf = pq.ParquetFile(path)
    locs = pf.row_group(0).column(0).offset_index().page_locations
    if len(locs) < 2:
        raise AssertionError("the Document file's DocId has one page")
    got, cold = measured(lambda: list(pq.read_rows(path, device=DEVICE)),
                         sync_count=True)
    if got != recs:
        raise AssertionError("read_rows differs from the records")
    del got
    check_launched("the row read", cold["launches"], ("unpack_bits_dense",))
    no_host_route("the row read")
    rng = np.random.default_rng(seed + 29)
    offsets = [0, locs[1].first_row_index, DOC_ROW_GROUP, DOC_ROWS - 1,
               DOC_ROWS] + sorted(rng.integers(
                   1, DOC_ROWS, DOC_SEEKS - 5).tolist())
    seek_s = []
    for r in offsets:
        t0 = time.perf_counter()
        cur = pq.FileRows(pq.ParquetFile(path), device=DEVICE)
        cur.seek_to_row(r)
        got = [pq.reconstruct(schema, row)
               for row in cur.read_rows(DOC_SEEK_ROWS)]
        seek_s.append(time.perf_counter() - t0)
        if got != recs[r:r + DOC_SEEK_ROWS]:
            raise AssertionError(f"seek_to_row({r}) differs")
    copy = os.path.join(tmp, "documents_copy.parquet")
    t0 = time.perf_counter()
    w = pq.ParquetWriter(copy, schema, opts)
    n = pq.copy_rows(rows.WriterRows(w), pq.FileRows(
        pq.ParquetFile(path), device=DEVICE))
    w.close()
    copy_s = time.perf_counter() - t0
    if n != DOC_ROWS:
        raise AssertionError(f"copy_rows moved {n} rows")
    same_host_columns(host_columns(pq.ParquetFile(copy).read(device=DEVICE)),
                      host_columns(pq.ParquetFile(path).read(device=DEVICE)),
                      "the copied file")
    del recs
    steps = {"decode_span": (device_reader, "decode_chunk_span"),
             "slots": (rows, "_column_slots"),
             "assembly": (rows._Assembler, "assemble")}
    warm = warm_walls(lambda: list(pq.read_rows(path, device=DEVICE)),
                      lambda: pq.ParquetFile(path).read(device=DEVICE),
                      steps)
    warm["pulls_s"] = warm["step_s"]["decode_span"]
    warm["host_s"] = warm["best_warm_s"] - warm["pulls_s"]
    out = {"rows": DOC_ROWS, "row_group_rows": DOC_ROW_GROUP,
           "page_bytes": DOC_PAGE, "file_bytes": os.path.getsize(path),
           "generate_s": gen_s, "write_s": write_s,
           "write_records_per_s": DOC_ROWS / write_s,
           "cold_s": cold["wall_s"], **warm,
           "records_per_s": DOC_ROWS / warm["best_warm_s"],
           "read_rows_per_s": DOC_ROWS / warm["read_best_warm_s"],
           "seek_offsets": offsets, "seek_read_s": seek_s,
           "copy_rows_s": copy_s, "syncs": cold["syncs"],
           "syncs_by_line": cold["syncs_by_line"],
           "launches": cold["launches"], "peak_bytes": cold["peak_bytes"],
           "card": card}
    log({"rows": out})
    return cold["launches"]


def host_table(cols: dict, order: Optional[np.ndarray] = None) -> dict:
    """``{name: ColumnData}`` on the host (rows in ``order``): byte arrays
    as (values, offsets), the rest as arrays."""
    out = {}
    for name, cd in cols.items():
        if cd.offsets is not None:
            v, o = np.asarray(cd.values), np.asarray(cd.offsets, np.int64)
            out[name] = (v, o) if order is None else gather_byte_arrays(
                v, o, order)
        else:
            v = np.asarray(cd.values)
            out[name] = v if order is None else v[order]
    return out


def rows_of(table: dict, r0: int, r1: int) -> dict:
    out = {}
    for name, v in table.items():
        if isinstance(v, tuple):
            data, o = v
            out[name] = (data[o[r0]:o[r1]], o[r0:r1 + 1] - o[r0])
        else:
            out[name] = v[r0:r1]
    return out


def row_tuples(table: dict, idx) -> list:
    """Rows ``idx`` of a host table as tuples (a tie group's set)."""
    out = []
    for i in idx:
        row = []
        for v in table.values():
            if isinstance(v, tuple):
                data, o = v
                row.append(data[o[i]:o[i + 1]].tobytes())
            else:
                row.append(v[i].tobytes())
        out.append(tuple(row))
    return sorted(out)


def check_sorted_output(got: dict, want: dict, keys, what: str) -> int:
    """``got`` (host columns of a merge or sort) against ``want`` (the
    input sorted by ``keys`` on the host): equal row for row, but inside
    a group of rows that tie on every key, which is compared as a set.
    Returns the tied rows."""
    first = next(iter(want.values()))
    n = len(first[1]) - 1 if isinstance(first, tuple) else len(first)
    ties = np.ones(max(n - 1, 0), bool)
    for k in keys:
        ties &= want[k][1:] == want[k][:-1]
    tied = np.zeros(n, bool)
    tied[:-1] |= ties
    tied[1:] |= ties
    bad = np.zeros(n, bool)
    for name, b in want.items():
        a = got[name]
        if isinstance(b, tuple):
            (av, ao), (bv, bo) = a, b
            if len(ao) != len(bo):
                raise AssertionError(f"{what}: {name} has {len(ao) - 1} "
                                     f"rows for {n}")
            bad |= (ao[1:] != bo[1:]) | (ao[:-1] != bo[:-1])
            if len(av) != len(bv):
                raise AssertionError(f"{what}: {name}'s bytes differ")
            pos = np.flatnonzero(av != bv)
            bad[np.searchsorted(bo, pos, "right") - 1] = True
        else:
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{what}: {name} is {a.dtype} "
                                     f"{a.shape}, not {b.dtype} {b.shape}")
            bad |= (a.view(np.uint8).reshape(n, -1)
                    != b.view(np.uint8).reshape(n, -1)).any(1)
    if (bad & ~tied).any():
        raise AssertionError(f"{what}: row {int(np.flatnonzero(bad & ~tied)[0])}"
                             " differs")
    edges = np.diff(np.concatenate([[0], tied.astype(np.int8), [0]]))
    for s0, e0 in zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)):
        if bad[s0:e0].any() and row_tuples(got, range(s0, e0)) != \
                row_tuples(want, range(s0, e0)):
            raise AssertionError(f"{what}: the tie group at row {s0} "
                                 "differs")
    return int(tied.sum())


def read_host(path: str) -> dict:
    """A file's flat columns read on the card, on the host."""
    out = {}
    for name, col in pq.ParquetFile(path).read(device=DEVICE).items():
        got = col.materialize_host()
        out[name] = got
    return out


def merge_steps() -> dict:
    return {**pull_steps(),
            "host_copies": (algebra_merge, "column_to_data"),
            "window_extend": (algebra_merge, "_extend_cd"),
            "window_keys": (algebra_merge, "_merge_keys"),
            "window_check": (algebra_merge, "_check_runs_sorted"),
            "window_permute": (algebra_merge, "permute_column"),
            "writer": (pq.ParquetWriter, "write_row_group")}


def merge_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5i(c): phase 4b's lineitem generator at MERGE_RUNS x
    262,144 rows, lexsorted by (``l_orderkey``, ``l_extendedprice``) and
    dealt round robin into MERGE_RUNS sorted runs (Snappy, 131,072-row row
    groups, ``l_orderkey`` DELTA_BINARY_PACKED as a sorted key is
    written), whose key ranges overlap completely; ``merge_files(...,
    batch_rows=65,536, device="cuda")`` equal to the sorted input (tie
    groups as sets); ``iter_merged``'s chunks each sorted, together the
    same rows."""
    rows = MERGE_RUNS * MERGE_RUN_ROWS
    t0 = time.perf_counter()
    schema, data = make_lineitem(rows, seed)
    order = np.lexsort((data["l_extendedprice"].values,
                        data["l_orderkey"].values))
    want = host_table(data, order)
    del data
    gen_s = time.perf_counter() - t0
    runs = []
    t0 = time.perf_counter()
    for i in range(MERGE_RUNS):
        path = os.path.join(tmp, f"merge_run{i}.parquet")
        part = host_table({k: ColumnData(values=v[0], offsets=v[1])
                           if isinstance(v, tuple) else ColumnData(values=v)
                           for k, v in want.items()},
                          np.arange(i, rows, MERGE_RUNS))
        pq.write_table({k: ColumnData(values=v[0], offsets=v[1])
                        if isinstance(v, tuple) else ColumnData(values=v)
                        for k, v in part.items()}, path, pq.WriterOptions(
            compression="snappy", row_group_size=MERGE_ROW_GROUP,
            column_encoding={**LINEITEM_ENCODINGS,
                             "l_orderkey": Encoding.DELTA_BINARY_PACKED}),
            schema=schema)
        runs.append(path)
    write_s = time.perf_counter() - t0
    sorting = [pq.SortingColumn(k) for k in MERGE_KEYS]
    out_path = os.path.join(tmp, "merged.parquet")

    def merge():
        return pq.merge_files(runs, sorting, out_path,
                              batch_rows=MERGE_BATCH, device=DEVICE)

    with Steps({"windows": (algebra_merge, "_merge_keys")}) as win:
        _, cold = measured(merge, sync_count=True)
    windows = win.calls["windows"]
    check_launched("the merge", cold["launches"], ("unpack_bits_dense",))
    no_host_route("the merge")
    tied = check_sorted_output(read_host(out_path), want, MERGE_KEYS,
                               "merge_files")
    if codecs_of(out_path) != {SNAPPY}:
        raise AssertionError("merged file codecs")
    # iter_merged: every chunk sorted, together the same rows
    chunks, at = 0, 0
    t0 = time.perf_counter()
    for cols, n in pq.iter_merged(runs, sorting, batch_rows=MERGE_BATCH,
                                  device=DEVICE):
        k = np.asarray(cols["l_orderkey"].values)
        p = np.asarray(cols["l_extendedprice"].values)
        if ((k[1:] < k[:-1]) | ((k[1:] == k[:-1]) & (p[1:] < p[:-1]))).any():
            raise AssertionError(f"iter_merged chunk {chunks} not sorted")
        check_sorted_output(host_table(cols), rows_of(want, at, at + n),
                            MERGE_KEYS, f"iter_merged chunk {chunks}")
        at += n
        chunks += 1
    iter_s = time.perf_counter() - t0
    if at != rows:
        raise AssertionError(f"iter_merged gave {at} of {rows} rows")
    del want
    warm = warm_walls(merge, lambda: pq.ParquetFile(out_path).read(
        device=DEVICE), merge_steps())
    out = {"runs": MERGE_RUNS, "rows": rows, "run_rows": MERGE_RUN_ROWS,
           "row_group_rows": MERGE_ROW_GROUP, "batch_rows": MERGE_BATCH,
           "generate_s": gen_s, "write_runs_s": write_s,
           "cold_s": cold["wall_s"], **warm,
           "rows_per_s": rows / warm["best_warm_s"],
           "read_rows_per_s": rows / warm["read_best_warm_s"],
           "iter_merged_s": iter_s, "iter_merged_chunks": chunks,
           "tied_rows": tied, "windows": windows,
           "pulls": cold["pulls"], "syncs": cold["syncs"],
           "syncs_per_window": cold["syncs"] / max(windows, 1),
           "syncs_by_line": cold["syncs_by_line"],
           "launches": cold["launches"], "peak_bytes": cold["peak_bytes"],
           "file_bytes": os.path.getsize(out_path), "card": card}
    log({"merge": out})
    return cold["launches"]


def sort_dirs() -> set:
    return {d for d in os.listdir(tempfile.gettempdir())
            if d.startswith("parquet_tpu_torch_sort_")}


def sort_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5i(d): 262,144 lineitem rows in a seeded random order
    through ``SortingWriter`` by (``l_shipdate`` descending,
    ``l_orderkey``, ``l_extendedprice``) with ``buffer_rows=65,536``:
    4 spills, merged on the card; the output equal to the input sorted
    that way on the host (tie groups as sets); no spill left after
    ``close``, nor after an ``abort``."""
    schema, data = make_lineitem(SORT_ROWS, seed + 1)
    rng = np.random.default_rng(seed + 31)
    shuffled = host_table(data, rng.permutation(SORT_ROWS))
    del data
    order = np.lexsort((shuffled["l_extendedprice"],
                        shuffled["l_orderkey"], -shuffled["l_shipdate"]))
    want = host_table({k: ColumnData(values=v[0], offsets=v[1])
                       if isinstance(v, tuple) else ColumnData(values=v)
                       for k, v in shuffled.items()}, order)
    batches = [{k: ColumnData(values=v[0], offsets=v[1])
                if isinstance(v, tuple) else ColumnData(values=v)
                for k, v in rows_of(shuffled, r, r + SORT_BUFFER).items()}
               for r in range(0, SORT_ROWS, SORT_BUFFER)]
    sorting = [pq.SortingColumn(k, descending=d) for k, d in SORT_KEYS]
    out_path = os.path.join(tmp, "sorted.parquet")
    before = sort_dirs()
    spills = []

    def sort(n_batches=len(batches), abort=False):
        w = pq.SortingWriter(out_path, schema, sorting,
                             buffer_rows=SORT_BUFFER, device=DEVICE)
        for b in batches[:n_batches]:
            w.write(dict(b), SORT_BUFFER)  # the buffer rebinds its dict
        spills.append(len(w.spills))
        if abort:
            w.abort()
        else:
            w.close()

    _, cold = measured(sort, sync_count=True)
    if spills[-1] != SORT_ROWS // SORT_BUFFER or sort_dirs() != before:
        raise AssertionError(f"sort: {spills[-1]} spills, temporary "
                             f"directories left {sort_dirs() - before}")
    check_launched("the sort", cold["launches"], ("unpack_bits_dense",))
    no_host_route("the sort")
    tied = check_sorted_output(read_host(out_path), want,
                               [k for k, _ in SORT_KEYS], "SortingWriter")
    os.unlink(out_path)
    sort(2, abort=True)
    if sort_dirs() != before or os.path.exists(out_path):
        raise AssertionError("an aborted sort left a spill or its output")
    del want
    steps = {**merge_steps(), "buffer_sort": (algebra_buffer.TableBuffer,
                                              "sort"),
             "spill": (pq.SortingWriter, "_spill"),
             "merge": (pq.SortingWriter, "_merge_spills")}
    warm = warm_walls(sort, lambda: pq.ParquetFile(out_path).read(
        device=DEVICE), steps)
    out = {"rows": SORT_ROWS, "buffer_rows": SORT_BUFFER,
           "spills": spills[0], "keys": SORT_KEYS,
           "cold_s": cold["wall_s"], **warm,
           "rows_per_s": SORT_ROWS / warm["best_warm_s"],
           "read_rows_per_s": SORT_ROWS / warm["read_best_warm_s"],
           "tied_rows": tied, "pulls": cold["pulls"],
           "syncs": cold["syncs"], "syncs_by_line": cold["syncs_by_line"],
           "launches": cold["launches"], "peak_bytes": cold["peak_bytes"],
           "card": card}
    log({"sort": out})
    return cold["launches"]


def typed_rows_merge_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5i: the typed reads, the row model, the merge and the sort on
    the card (:func:`typed_path`, :func:`rows_path`, :func:`merge_path`,
    :func:`sort_path`), each printing its line; returns their kernel
    launches together."""
    total = dict.fromkeys(pq.LAUNCHES, 0)
    seconds = {}
    for name, fn in (("typed", typed_path), ("rows", rows_path),
                     ("merge", merge_path), ("sort", sort_path)):
        t0 = time.perf_counter()
        for k, v in fn(card, seed, tmp).items():
            total[k] += v
        seconds[name] = time.perf_counter() - t0
    log({"phase_5i_s": seconds})
    return {"launches": total}


# ---------------------------------------------------------------------------
# phase 5j: the aggregation cascade on the card
# ---------------------------------------------------------------------------

Q1_DATE = 10_471  # TPC-H Q1's 1998-12-01 less 90 days, in days since 1970
Q1_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
              "l_tax", "l_returnflag", "l_linestatus", "l_shipdate",
              "l_shipmode")
# the Q1 file's dictionary columns: every one of small cardinality
Q1_DICT = ("l_quantity", "l_discount", "l_tax", "l_returnflag",
           "l_linestatus", "l_shipmode")
AGG_WARM = 3
AGG_RANGE_SHARE = (0.35, 0.65)  # phase 5j(b): about 30 % of the keys
AGG_RTOL = 1e-9  # float sums add in another order than numpy's


def _close(got, want, what: str) -> None:
    """Exact for ints, bytes and bounds; ``AGG_RTOL`` for float sums."""
    if isinstance(want, float) and isinstance(got, float):
        if abs(got - want) > AGG_RTOL * max(abs(want), 1e-300):
            raise AssertionError(f"{what}: {got!r} != {want!r}")
        return
    if got != want or type(got) is not type(want):
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def _check_agg(res, want: dict, what: str) -> None:
    for name, w in want.items():
        g = res[name]
        if isinstance(w, list):
            if len(g) != len(w):
                raise AssertionError(f"{what} {name}: {g!r} != {w!r}")
            for a, b in zip(g, w):
                _close(a, b, f"{what} {name}")
        else:
            _close(g, w, f"{what} {name}")


def _strict_page_bounds(path: str, lo_row: int, hi_row: int) -> tuple:
    """Page bounds of the sorted ``l_orderkey`` near file rows ``lo_row``
    and ``hi_row``: the min of a page whose previous page's max is below
    it, and the max of a page whose next page's min is above it, so that
    the range's boundary pages are covered, not contended."""
    from parquet_tpu_torch.io.search import decoded_bounds

    f = pq.ParquetFile(path)
    pages, base = [], 0
    for rg in f.row_groups:
        chunk = rg.column(f.schema.leaf("l_orderkey").column_index)
        ci, oi = chunk.column_index(), chunk.offset_index()
        mins, maxs = decoded_bounds(ci, f.schema.leaf("l_orderkey"))
        for pl, mn, mx in zip(oi.page_locations, mins, maxs):
            pages.append((base + pl.first_row_index, mn, mx))
        base += rg.num_rows
    lo = hi = None
    for i in range(1, len(pages)):
        if pages[i][0] >= lo_row and pages[i][1] > pages[i - 1][2]:
            lo = pages[i][1]
            break
    for i in range(len(pages) - 1):
        if pages[i][0] >= hi_row and pages[i][2] < pages[i + 1][1]:
            hi = pages[i][2]
            break
    if lo is None or hi is None:
        raise AssertionError("phase 5j: no strict page boundary found")
    return int(lo), int(hi)


def _agg_walls(run, whole_read) -> dict:
    """``run()`` cold (its kernel launches, host routes and ``AGG``
    counters kept), then :data:`AGG_WARM` warm in turns with as many whole
    reads of the same columns: the best warm wall of each."""
    from parquet_tpu_torch.io import aggregate as agg_mod

    reset_routes()
    pq.reset_launches()
    agg_mod.reset_agg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counted = {"launches": dict(pq.LAUNCHES),
               "host_route": {k: v for k, v in pq.HOST_ROUTE.items() if v},
               "agg": {k: v for k, v in agg_mod.AGG.items() if v}}
    runs, reads = [], []
    for _ in range(AGG_WARM):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = whole_read()
        torch.cuda.synchronize()
        reads.append(time.perf_counter() - t0)
        del got
    return {"out": out, "cold_s": cold, "warm_s": min(runs),
            "whole_read_s": min(reads), **counted}


def aggregate_path(card: str, rows: int, seed: int, tmp: str,
                   lineitem: str) -> dict:
    """Phase 5j: ``ParquetFile.aggregate(device="cuda")``, each check
    fatal.  (a) TPC-H Q1's shape on phase 4b's lineitem rows (the same
    generated columns, written again with the small-cardinality columns
    dictionary-encoded, so that the dictionary tier has indexes to count
    and the exact tier a dictionary to gather): ``where l_shipdate <=
    1998-09-02`` grouped by ``l_returnflag`` (sums, averages, counts);
    the same filter ungrouped (the folds on the card under a mask sent
    there); ungrouped over every row, ``count_distinct(l_shipmode)``,
    ``min_``/``max_(l_shipdate)``, ``variance(l_discount)`` and
    ``sum_(l_quantity)`` (statistics and dictionary tiers: the indexes
    unpacked by ``unpack_bits_dense``, nothing gathered) and
    ``top_k(l_extendedprice, 10)``; (b) about 30 % of the keys of phase
    4b's file, sorted by ``l_orderkey``, its bounds on strict page
    boundaries: counts and the key's bounds answered by the statistics and
    page tiers, then sums decoded; (c) ``PARQUET_TPU_TORCH_FUSED=on`` on
    (a)'s filtered query, equal.  Every answer against a numpy oracle over
    the generated columns; both unpack kernels launched, no chunk on the
    host route, the card's allocated bytes back."""
    from parquet_tpu_torch.io import aggregate as agg_mod
    from parquet_tpu_torch.io import fused as fused_mod

    t0 = time.perf_counter()
    schema, data = make_lineitem(rows, seed)
    gen_s = time.perf_counter() - t0
    cols = {n: data[n] for n in Q1_COLUMNS}
    q1_schema = Schema([Leaf(-1, leaf.name, leaf.physical_type,
                             string=leaf.string)
                        for leaf in schema.leaves if leaf.name in cols])
    path = os.path.join(tmp, "lineitem_q1.parquet")
    t0 = time.perf_counter()
    pq.write_table(cols, path, pq.WriterOptions(
        compression="snappy", row_group_size=LINEITEM_ROW_GROUP,
        data_page_size=1 << 20,
        column_encoding={n: (Encoding.RLE_DICTIONARY if n in Q1_DICT
                             else Encoding.PLAIN) for n in Q1_COLUMNS}),
        schema=q1_schema)
    write_s = time.perf_counter() - t0
    # the numpy oracle
    num = {n: cols[n].values for n in Q1_COLUMNS
           if n not in LINEITEM_STRINGS}
    strs = {n: _codes_of(cols[n], LINEITEM_STRINGS[n])
            for n in ("l_returnflag", "l_shipmode")}
    q, price, disc = num["l_quantity"], num["l_extendedprice"], \
        num["l_discount"]
    ship, okey = num["l_shipdate"], num["l_orderkey"]
    del data, cols
    m = ship <= Q1_DATE
    flags = [w.encode() for w in LINEITEM_STRINGS["l_returnflag"]]
    fcode = strs["l_returnflag"]
    groups = [g for g in range(len(flags)) if np.any(m & (fcode == g))]
    q1_want = {
        "sum(l_quantity)": [int(q[m & (fcode == g)].sum()) for g in groups],
        "sum(l_extendedprice)": [float(price[m & (fcode == g)].sum())
                                 for g in groups],
        "avg(l_quantity)": [float(q[m & (fcode == g)].sum())
                            / int((m & (fcode == g)).sum()) for g in groups],
        "avg(l_discount)": [float(disc[m & (fcode == g)].sum())
                            / int((m & (fcode == g)).sum()) for g in groups],
        "count(*)": [int((m & (fcode == g)).sum()) for g in groups]}
    filt_want = {"count(*)": int(m.sum()), "sum(l_quantity)":
                 int(q[m].sum()), "sum(l_extendedprice)":
                 float(price[m].sum()), "min(l_discount)":
                 float(disc[m].min()), "max(l_discount)":
                 float(disc[m].max()), "avg(l_extendedprice)":
                 float(price[m].sum()) / int(m.sum())}
    n_all = len(disc)
    dict_want = {
        "count_distinct(l_shipmode)": len(np.unique(strs["l_shipmode"])),
        "min(l_shipdate)": int(ship.min()), "max(l_shipdate)":
        int(ship.max()), "sum(l_quantity)": int(q.sum()),
        "variance(l_discount)": float(
            (np.dot(disc, disc) - disc.sum() ** 2 / n_all) / n_all)}
    topk_want = {"top_k(l_extendedprice,10)":
                 np.sort(price)[::-1][:10].tolist()}
    lo_row, hi_row = (int(rows * s) for s in AGG_RANGE_SHARE)
    lo, hi = _strict_page_bounds(lineitem, lo_row, hi_row)
    r = (okey >= lo) & (okey <= hi)
    range_want = {"count(*)": int(r.sum()), "count(l_orderkey)":
                  int(r.sum()), "min(l_orderkey)": int(okey[r].min()),
                  "max(l_orderkey)": int(okey[r].max())}
    range_dec_want = {"sum(l_quantity)": int(q[r].sum()),
                      "max(l_extendedprice)": float(price[r].max())}
    q1_where = pq.col("l_shipdate") <= Q1_DATE
    f = pq.ParquetFile(path)
    item = pq.ParquetFile(lineitem)
    queries = {
        "q1_grouped": (f, dict(aggs=[
            pq.sum_("l_quantity"), pq.sum_("l_extendedprice"),
            pq.avg("l_quantity"), pq.avg("l_discount"), pq.count()],
            where=q1_where, group_by="l_returnflag"), q1_want,
            ["l_shipdate", "l_returnflag", "l_quantity", "l_extendedprice",
             "l_discount"]),
        "q1_filtered": (f, dict(aggs=[
            pq.count(), pq.sum_("l_quantity"), pq.sum_("l_extendedprice"),
            pq.min_("l_discount"), pq.max_("l_discount"),
            pq.avg("l_extendedprice")], where=q1_where), filt_want,
            ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount"]),
        "dictionary": (f, dict(aggs=[
            pq.count_distinct("l_shipmode"), pq.min_("l_shipdate"),
            pq.max_("l_shipdate"), pq.variance("l_discount"),
            pq.sum_("l_quantity")]), dict_want,
            ["l_shipmode", "l_shipdate", "l_discount", "l_quantity"]),
        "top_k": (f, dict(aggs=[pq.top_k("l_extendedprice", 10)]),
                  topk_want, ["l_extendedprice"]),
        "range_metadata": (item, dict(aggs=[
            pq.count(), pq.count("l_orderkey"), pq.min_("l_orderkey"),
            pq.max_("l_orderkey")],
            where=pq.col("l_orderkey").between(lo, hi)), range_want,
            ["l_orderkey"]),
        "range_decoded": (item, dict(aggs=[
            pq.sum_("l_quantity"), pq.max_("l_extendedprice")],
            where=pq.col("l_orderkey").between(lo, hi)), range_dec_want,
            ["l_orderkey", "l_quantity", "l_extendedprice"]),
    }
    start = settled_allocated()
    total = dict.fromkeys(pq.LAUNCHES, 0)
    out = {}
    for name, (pf, kw, want, read_cols) in queries.items():
        got = _agg_walls(lambda pf=pf, kw=kw: pf.aggregate(device=DEVICE,
                                                           **kw),
                         lambda pf=pf, c=read_cols: pf.read(columns=c,
                                                            device=DEVICE))
        res = got.pop("out")
        _check_agg(res, want, f"phase 5j {name}")
        if name == "q1_grouped" and res.groups != [flags[g]
                                                   for g in groups]:
            raise AssertionError(f"phase 5j q1 groups {res.groups}")
        if got["host_route"]:
            raise AssertionError(f"phase 5j {name}: host route "
                                 f"{got['host_route']}")
        for k, v in got["launches"].items():
            total[k] += v
        out[name] = {**got, "tiers": {k: v for k, v in res.counters.items()
                                      if v}}
    d = out["dictionary"]
    if not d["launches"]["unpack_bits_dense"] or \
            d["launches"]["dict_unpack_gather"]:
        raise AssertionError("phase 5j: the dictionary tier must unpack "
                             f"and never gather: {d['launches']}")
    if not d["tiers"].get("rg_answered_dict"):
        raise AssertionError(f"phase 5j: no dictionary tier {d['tiers']}")
    if not out["q1_filtered"]["launches"]["dict_unpack_gather"]:
        raise AssertionError("phase 5j: the exact tier launched no "
                             f"dict_unpack_gather: {out['q1_filtered']}")
    rt = out["range_metadata"]["tiers"]
    if not rt.get("rg_answered_stats") or not rt.get("rg_answered_pages"):
        raise AssertionError(f"phase 5j(b): statistics and page tiers "
                             f"must answer rows: {rt}")
    check_launched("phase 5j", total, READ_KERNELS)
    # (c) the fused page cursor pinned on, against the default
    fused_mod.reset_fused()
    with knobs(PARQUET_TPU_TORCH_FUSED="on"):
        pf, kw, want, read_cols = queries["q1_filtered"]
        t0 = time.perf_counter()
        res = pf.aggregate(device=DEVICE, **kw)
        fused_s = time.perf_counter() - t0
    _check_agg(res, want, "phase 5j fused")
    if "(fused)" not in res.explain() or not fused_mod.FUSED["rg_folds"]:
        raise AssertionError("phase 5j(c): the fused tier did not run")
    out["fused_on"] = {"wall_s": fused_s, "fused": dict(fused_mod.FUSED)}
    del res, got
    left = settled_allocated() - start
    if left > 0:
        raise AssertionError(f"phase 5j: {left} device bytes left "
                             "allocated")
    log({"aggregate": {"card": card, "rows": rows, "generate_s": gen_s,
                       "q1_write_s": write_s, "range": [lo, hi],
                       "queries": out}})
    return {"launches": total, "path": path,
            "dictionary": (queries["dictionary"][1], dict_want)}


WRITE_ROWS = 1 << 21  # phase 4's first two row groups, cut from 8,388,608
WRITE_MODES = ("off", "auto", "force")
WRITE_CRASH_ROWS = 65_536
WRITE_CRASH_SAMPLES = 12
WRITE_FLIP_ROW_GROUP = 1


def cut_rows(col, n: int) -> ColumnData:
    """The first ``n`` rows of a flat decoded column, its tensors left on
    the card: values are the present ones, so an optional column keeps as
    many values as its first ``n`` slots hold."""
    if col.validity is None:
        return ColumnData(values=col.values[:n])
    valid = col.validity[:n]
    return ColumnData(values=col.values[:int(valid.sum())], validity=valid)


@contextlib.contextmanager
def commit_spy():
    """Record, at every ``AtomicFileSink`` commit inside the block,
    whether the destination existed and the temp file did just before the
    rename, and whether either does just after."""
    from parquet_tpu_torch.io import sink as sink_mod

    seen = []
    real = sink_mod.AtomicFileSink.close

    def spied(self):
        dest, temp = self.dest, self.temp_path
        before = (os.path.exists(dest), temp is not None
                  and os.path.exists(temp))
        real(self)
        seen.append({"dest_before": before[0], "temp_before": before[1],
                     "dest_after": os.path.exists(dest),
                     "temp_after": temp is not None
                     and os.path.exists(temp)})

    sink_mod.AtomicFileSink.close = spied
    try:
        yield seen
    finally:
        sink_mod.AtomicFileSink.close = real


def temp_files(d: str) -> list:
    return sorted(f for f in os.listdir(d) if f.endswith(".tmp"))


def threads_started(before) -> list:
    """The names of the live threads not in ``before``, but for the
    shared pool's workers (they live for the process)."""
    return [t.name for t in threading.enumerate()
            if t not in before and not t.name.startswith("pqt-work")]


def same_values(got: dict, want: dict, what: str) -> None:
    """Two reads of flat columns equal bit for bit: each column's values
    (as bytes) and validity."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: columns {list(got)} != {list(want)}")
    for name, col in want.items():
        a, b = got[name], col
        if (a.values.dtype != b.values.dtype
                or a.values.shape != b.values.shape
                or not torch.equal(a.values.contiguous().view(torch.uint8),
                                   b.values.contiguous().view(torch.uint8))):
            raise AssertionError(f"{what}: {name} values differ")
        if (a.validity is None) != (b.validity is None) or (
                a.validity is not None
                and not torch.equal(a.validity, b.validity)):
            raise AssertionError(f"{what}: {name} validity differs")


def mid_page(path: str, rg: int) -> tuple:
    """(a byte in the middle of a page's stored bytes, that page's header
    offset) for the middle data page of row group ``rg``'s first chunk."""
    chunk = pq.ParquetFile(path).row_group(rg).column(0)
    rows = chunk.page_table().rows
    data = np.flatnonzero(rows[:, host.PG_TYPE] != int(
        PageType.DICTIONARY_PAGE))
    page = int(data[len(data) // 2])
    start = chunk.byte_range[0]
    return (start + int(rows[page, host.PG_DATA_POS])
            + int(rows[page, host.PG_COMP]) // 2,
            start + int(rows[page, host.PG_HEADER_POS]))


def write_path(card: str, read: dict, tmp: str) -> dict:
    """Phase 5k: durable, pipelined writes from the card, each check
    fatal.  (a) The first 2,097,152 rows of phase 4's 5-column file (its
    first two row groups; cut from 8,388,608 for the script's time) read
    on the card, and the CUDA columns handed to ``write_table`` on a path
    with the default options (Snappy, atomic commit, fsync) three times:
    ``PARQUET_TPU_TORCH_WRITE_OVERLAP=off``, auto and ``force``, each
    twice (its best wall kept); the three files
    are byte-identical, and at each commit the destination did not exist
    until the rename and no ``*.tmp`` is left.  (b) ``verify_file(path,
    decode=True)`` is clean with row groups x 5 chunks decoded, its decode
    launching ``unpack_bits_dense`` and ``dict_unpack_gather`` with no
    chunk on the host route, and the file read back on the card equals
    the original read bit for bit.  (c) ``crash_consistency_check`` on the
    first 65,536 rows of the same columns, 12 samples, unbuffered and
    buffered, under ``force``: every outcome ``absent`` or ``clean``.
    (d) ``FaultInjectingSink(enospc_at_byte=half)`` under ``force``
    makes the write raise; the destination is then
    absent, no temp file is left, no writer thread is alive and the
    card's allocated bytes are back.  (e) One byte flipped in the middle
    of a page of row group 1: ``verify_file`` reports exactly one CRC
    issue, at that row group, column and page offset.  One ``{"write":
    ...}`` line."""
    src = pq.ParquetFile(read["path"])
    schema = src.schema
    groups = list(range(-(-WRITE_ROWS // ROW_GROUP)))
    start = settled_allocated()
    threads = set(threading.enumerate())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orig = src.read(device=DEVICE, row_groups=groups)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    cols = {name: cut_rows(col, WRITE_ROWS) for name, col in orig.items()}
    if any(c.values.device.type != torch.device(DEVICE).type
           for c in cols.values()):
        raise AssertionError("phase 5k: the columns are not on the card")
    in_bytes = decoded_bytes(orig)
    # the default options' row groups (phase 4's, on the card)
    out_groups = -(-WRITE_ROWS // pq.WriterOptions().row_group_size)

    # (a) three pipelines, the same bytes
    writes, digests, commits = {}, {}, []
    for name in WRITE_MODES:
        path = os.path.join(tmp, f"write_{name}.parquet")
        walls_s, stats = [], None
        for _ in range(2):
            if os.path.exists(path):  # each write makes its destination
                os.unlink(path)
            with knobs(PARQUET_TPU_TORCH_WRITE_OVERLAP=name), \
                    commit_spy() as seen:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                w = pq.write_table(cols, path, schema=schema)
                walls_s.append(time.perf_counter() - t0)
            if len(seen) != 1 or seen[0] != {
                    "dest_before": False, "temp_before": True,
                    "dest_after": True, "temp_after": False}:
                raise AssertionError(f"phase 5k {name}: commit {seen}")
            commits.extend(seen)
            if temp_files(tmp):
                raise AssertionError(f"phase 5k {name}: temp files left "
                                     f"{temp_files(tmp)}")
            if stats is None or walls_s[-1] <= min(walls_s[:-1]):
                stats = w.write_stats.as_dict()
        size = os.path.getsize(path)
        if stats["bytes_flushed"] != size or \
                stats["row_groups"] != out_groups:
            raise AssertionError(f"phase 5k {name}: stats {stats}, file "
                                 f"{size} bytes")
        if name == "force" and stats["overlapped_groups"] != out_groups:
            raise AssertionError(f"phase 5k {name}: no overlap {stats}")
        with open(path, "rb") as fh:
            digests[name] = hashlib.sha256(fh.read()).hexdigest()
        best = min(walls_s)
        writes[name] = {"walls_s": walls_s, "best_s": best,
                        "file_bytes": size, "file_mb_per_s": size / best / 1e6,
                        "input_mb_per_s": in_bytes / best / 1e6,
                        "write_stats": stats}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"phase 5k: the pipelines' bytes differ "
                             f"{digests}")
    path = os.path.join(tmp, "write_off.parquet")

    # (b) verification and the read back
    t0 = time.perf_counter()
    structural = pq.verify_file(path)
    verify_s = time.perf_counter() - t0
    if not structural.ok or structural.crcs_checked == 0:
        raise AssertionError(f"phase 5k: {structural.summary()}")
    pq.reset_launches()
    reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = pq.verify_file(path, decode=True, device=DEVICE)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    verify_launches = dict(pq.LAUNCHES)
    if not rep.ok or rep.chunks_decoded != out_groups * len(cols):
        raise AssertionError(f"phase 5k: {rep.summary()}")
    check_launched("phase 5k verify_file(decode=True)", verify_launches,
                   READ_KERNELS)
    no_host_route("phase 5k verify_file(decode=True)")
    pq.reset_launches()
    reset_routes()
    back, back_s = timed_read(path)
    back_launches = dict(pq.LAUNCHES)
    check_launched("phase 5k read back", back_launches, READ_KERNELS)
    no_host_route("phase 5k read back")
    same_values(back, orig, "phase 5k read back")
    del back
    read_walls = []
    for _ in range(2):
        out, s = timed_read(path)
        read_walls.append(s)
        del out

    # (c) the crash matrix
    cut = {name: cut_rows(col, WRITE_CRASH_ROWS)
           for name, col in orig.items()}
    crash = {}
    with knobs(PARQUET_TPU_TORCH_WRITE_OVERLAP="force"):
        for buffered in (False, True):
            dest = os.path.join(tmp, f"crash_{int(buffered)}.parquet")
            t0 = time.perf_counter()
            res = pq.crash_consistency_check(
                lambda s: pq.write_table(cut, s, schema=schema), dest,
                samples=WRITE_CRASH_SAMPLES, seed=0, buffered=buffered)
            wall = time.perf_counter() - t0
            outcomes = [r["outcome"] for r in res]
            if len(res) != WRITE_CRASH_SAMPLES + 1 or not set(
                    outcomes) <= {"absent", "clean"} or temp_files(tmp):
                raise AssertionError(f"phase 5k crash matrix: {res}")
            crash["buffered" if buffered else "unbuffered"] = {
                "offsets": [r["offset"] for r in res],
                "outcomes": outcomes, "wall_s": wall}
            os.unlink(dest)

    # (d) a full disk
    dest = os.path.join(tmp, "enospc.parquet")
    half = os.path.getsize(path) // 2
    sink = pq.FaultInjectingSink(pq.AtomicFileSink(dest),
                                 enospc_at_byte=half)
    with knobs(PARQUET_TPU_TORCH_WRITE_OVERLAP="force"):
        try:
            pq.write_table(cols, sink, schema=schema)
        except OSError as e:
            if e.errno != errno.ENOSPC:
                raise
        else:
            raise AssertionError("phase 5k: the full disk did not raise")
    sink.abort()
    del cols, cut, orig
    left = settled_allocated() - start
    if os.path.exists(dest) or temp_files(tmp) or threads_started(threads) \
            or left > 0:
        raise AssertionError(
            f"phase 5k full disk: dest {os.path.exists(dest)}, temp "
            f"{temp_files(tmp)}, threads {threads_started(threads)}, "
            f"{left} device bytes")
    enospc = {"at_byte": half, "bytes_written": sink.stats.bytes_written}

    # (e) a flipped byte
    flipped = os.path.join(tmp, "write_flipped.parquet")
    at, page = mid_page(path, WRITE_FLIP_ROW_GROUP)
    with open(path, "rb") as fh:
        raw = bytearray(fh.read())
    raw[at] ^= 0x01
    with open(flipped, "wb") as fh:
        fh.write(raw)
    bad = pq.verify_file(flipped)
    os.unlink(flipped)
    column = schema.leaves[0].name
    if [(i.kind, i.row_group, i.column, i.offset) for i in bad.issues] != [
            ("crc", WRITE_FLIP_ROW_GROUP, column, page)]:
        raise AssertionError(f"phase 5k flip: {bad.summary()}")

    launches = {k: verify_launches[k] + back_launches[k]
                for k in verify_launches}
    log({"write": {
        "card": card, "rows": WRITE_ROWS, "row_groups": out_groups,
        "columns": len(schema.leaves), "input_bytes": in_bytes,
        "source_read_s": read_s, "writes": writes,
        "sha256": digests["off"], "commits": len(commits),
        "verify": {"structural_s": verify_s, "decode_s": decode_s,
                   "read_back_s": back_s, "read_s": read_walls,
                   "pages_checked": rep.pages_checked,
                   "crcs_checked": rep.crcs_checked,
                   "chunks_decoded": rep.chunks_decoded,
                   "launches": verify_launches},
        "read_back_launches": back_launches, "crash": crash,
        "enospc": enospc,
        "flip": {"at": at, "page_offset": page,
                 "issue": bad.issues[0].as_dict()}}})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 5l: writable tables on the card
# ---------------------------------------------------------------------------

TABLE_COMMIT_ROWS = 1 << 20  # DatasetWriter's default rows_per_file
TABLE_ROW_GROUP = 1 << 19
TABLE_SORTED_ROWS = 1 << 20
TABLE_SORTED_COMMITS = 4
TABLE_LOOKUP_KEYS = 65_536  # a quarter of them absent
TABLE_CRASH_ROWS = 65_536
TABLE_CRASH_SAMPLES = 10
TABLE_SCAN_COLUMNS = ["l_orderkey", "l_quantity", "l_extendedprice",
                      "l_shipmode"]




def host_columns_data(table: dict) -> dict:
    """``host_table``'s forms as ColumnData."""
    return {k: ColumnData(values=v[0], offsets=v[1]) if isinstance(v, tuple)
            else ColumnData(values=v) for k, v in table.items()}


def input_bytes(cols: dict) -> int:
    return sum(np.asarray(cd.values).nbytes + (
        0 if cd.offsets is None else np.asarray(cd.offsets).nbytes)
        for cd in cols.values())


def timed_walls(run, reads: int = 3) -> tuple:
    """``run()`` once cold and ``reads - 1`` (at least 1) times warm,
    synchronized: the first result and the seconds."""
    first, times = None, []
    for _ in range(reads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if first is None:
            first = out
        del out
    return first, {"cold_s": times[0], "warm_s": times[1:],
                   "best_warm_s": min(times[1:])}


def timed_read_of(ds) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ds.read(device=DEVICE)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def boundary_orders(path: str, column: str) -> list:
    f = pq.ParquetFile(path)
    leaf = f.schema.leaf(column)
    return [BoundaryOrder(rg.column(leaf.column_index).column_index()
                          .boundary_order) for rg in f.row_groups]


def last_logged(key: str) -> dict:
    return next((o[key] for o in reversed(LOGGED)
                 if isinstance(o, dict) and key in o), {})


def table_ingest(t1: str, schema, data: dict, rows: int) -> list:
    """Phase 5l(a): one commit a ``TABLE_COMMIT_ROWS`` slice."""
    commits = -(-rows // TABLE_COMMIT_ROWS)
    w = pq.DatasetWriter(t1, schema, options=pq.WriterOptions(
        compression="snappy", row_group_size=TABLE_ROW_GROUP,
        bloom_filters={"l_orderkey": 10}))
    out = []
    for i in range(commits):
        a, b = i * TABLE_COMMIT_ROWS, min(rows, (i + 1) * TABLE_COMMIT_ROWS)
        part = {k: column_slice(cd, a, b) for k, cd in data.items()}
        nbytes = input_bytes(part)
        t0 = time.perf_counter()
        w.write(part, b - a)  # the part is written as its buffer fills
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = w.commit()
        commit_s = time.perf_counter() - t0
        if m.version != i + 1 or len(m.files) != i + 1 or \
                m.files[-1].num_rows != b - a:
            raise AssertionError(f"phase 5l ingest: commit {i + 1} gave "
                                 f"version {m.version}, {len(m.files)} parts")
        out.append({"rows": b - a, "write_s": write_s, "commit_s": commit_s,
                    "input_mb_per_s": nbytes / (write_s + commit_s) / 1e6,
                    "part_bytes": m.files[-1].file_size})
    w.close()
    m = pq.read_manifest(t1)
    if m.version != commits or m.num_rows != rows or len(m.files) != commits \
            or temp_files(t1):
        raise AssertionError(f"phase 5l ingest: manifest v{m.version}, "
                             f"{m.num_rows} rows, temps {temp_files(t1)}")
    return out


def table_scans(t1: str, data: dict, rows: int) -> list:
    """Phase 5l(b)'s scans: 1 % of the sorted ``l_orderkey`` inside part 0
    and inside a middle part, each on a table opened unpinned: the parts
    opened are the survivor and part 0, whose footer types the predicate
    (the JAX package's rule); the others the manifest drops unopened."""
    ok = data["l_orderkey"].values
    span = rows // 100
    parts = -(-rows // TABLE_COMMIT_ROWS)
    table = {k: data[k] if data[k].offsets is not None else data[k].values
             for k in TABLE_SCAN_COLUMNS}
    out = []
    for part in sorted({0, parts // 2}):
        r0 = part * TABLE_COMMIT_ROWS + TABLE_COMMIT_ROWS // 4
        lo, hi = int(ok[r0]), int(ok[min(r0 + span, rows) - 1])
        ds = pq.open_table(t1, pin=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ds.scan(where=pq.col("l_orderkey").between(lo, hi),
                      columns=TABLE_SCAN_COLUMNS, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        opened = sorted(ds._files)
        ds.close()
        if opened != sorted({0, part}):
            raise AssertionError(f"phase 5l scan in part {part}: opened "
                                 f"parts {opened}")
        check_result(got, oracle(table, (ok >= lo) & (ok <= hi)),
                     f"phase 5l scan in part {part}")
        out.append({"part": part, "lo": lo, "hi": hi,
                    "rows": int(((ok >= lo) & (ok <= hi)).sum()),
                    "wall_s": wall, "parts_opened": opened,
                    "parts_not_opened": parts - len(opened)})
    return out


def table_aggregates(t1: str, data: dict, rows: int) -> dict:
    """Phase 5l(b)'s aggregates over ``l_orderkey`` from the first key to
    10 % into part 2: parts 0 and 1 covered, part 2 in part, the rest
    dropped by the manifest (which counts them in
    ``files_answered_manifest``, as the JAX package does).  ``count`` and
    ``sum_(l_quantity)`` resolve the covered parts through their row
    groups (statistics and dictionary tiers) and part 2 through the exact
    tier, on the card; ``count``, ``min_`` and ``max_(l_orderkey)`` are
    answered for the covered parts by their zone maps alone."""
    ok = data["l_orderkey"].values
    qty = data["l_quantity"].values
    parts = -(-rows // TABLE_COMMIT_ROWS)
    hi_row = 2 * TABLE_COMMIT_ROWS + TABLE_COMMIT_ROWS // 10
    lo, hi = int(ok[0]), int(ok[hi_row])
    if int(ok[3 * TABLE_COMMIT_ROWS]) <= hi:
        raise AssertionError("phase 5l aggregate: part 3 overlaps the range")
    mask = (ok >= lo) & (ok <= hi)
    where = pq.col("l_orderkey").between(lo, hi)
    out = {}
    for name, aggs, want in (
            ("count_sum", [pq.count(), pq.sum_("l_quantity")],
             {"count(*)": int(mask.sum()),
              "sum(l_quantity)": int(qty[mask].sum())}),
            ("count_min_max", [pq.count(), pq.min_("l_orderkey"),
                               pq.max_("l_orderkey")],
             {"count(*)": int(mask.sum()), "min(l_orderkey)": lo,
              "max(l_orderkey)": int(ok[mask].max())})):
        pq.reset_launches()
        ds = pq.open_table(t1, pin=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ds.aggregate(aggs, where=where, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        opened = sorted(ds._files)
        ds.close()
        launches = dict(pq.LAUNCHES)
        got = {k: res[k] for k in want}
        answered = sum("answered from manifest" in ln
                       for ln in res.explain().splitlines())
        c = res.counters
        if got != want:
            raise AssertionError(f"phase 5l aggregate {name}: {got} != "
                                 f"{want}")
        if name == "count_sum":
            ok_tiers = (c["files_answered_manifest"] == parts - 3
                        and answered == 0 and opened == [0, 1, 2]
                        and c["rg_answered_dict"] > 0
                        and c["rg_answered_decoded"] > 0)
            check_launched("phase 5l aggregate", launches, READ_KERNELS)
        else:
            ok_tiers = (c["files_answered_manifest"] == parts - 1
                        and answered == 2 and opened == [0, 2])
        if not ok_tiers:
            raise AssertionError(f"phase 5l aggregate {name}: counters {c},"
                                 f" {answered} answered by the manifest, "
                                 f"parts opened {opened}")
        out[name] = {"wall_s": wall, "answers": got, "counters": c,
                     "parts_answered_by_manifest": answered,
                     "parts_opened": opened, "launches": launches}
    return out


def table_lookup(t1: str, data: dict, seed: int) -> dict:
    """Phase 5l(b)'s lookup on its own open of the snapshot (closed after,
    with the filters' copies on the card): :data:`TABLE_LOOKUP_KEYS` keys
    inside part 3's two row groups (part 0's where the table is smaller),
    a quarter absent, so that each row group's bloom batch takes the
    device probe; every hit equal to a numpy oracle over the generated
    rows."""
    ok = data["l_orderkey"].values
    qty = data["l_quantity"].values
    part = 3 if len(ok) >= 4 * TABLE_COMMIT_ROWS else 0
    rng = np.random.default_rng(seed + 41)
    keys = []
    per = TABLE_LOOKUP_KEYS // 2
    for g in range(2):
        r0 = part * TABLE_COMMIT_ROWS + g * TABLE_ROW_GROUP
        seg = ok[r0:r0 + TABLE_ROW_GROUP]
        present = np.unique(seg)
        absent = np.setdiff1d(np.arange(seg[0], seg[-1] + 1), present)
        keys.append(rng.choice(present, per - per // 4, replace=False))
        keys.append(rng.choice(absent, per // 4, replace=False))
    keys = rng.permutation(np.concatenate(keys)).astype(np.int64)
    lo = np.searchsorted(ok, keys, "left")
    hi = np.searchsorted(ok, keys, "right")
    if int((hi == lo).sum()) != TABLE_LOOKUP_KEYS // 4:
        raise AssertionError("phase 5l lookup: absent keys miscounted")
    pq.clear_caches()
    pq.reset_launches()
    reset_routes()
    with pq.open_table(t1) as ds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ds.find_rows("l_orderkey", keys, columns=["l_quantity"],
                           device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(pq.LAUNCHES)
    for h, a, b in zip(res, lo.tolist(), hi.tolist()):
        if not np.array_equal(h.rows, np.arange(a, b)) or \
                not np.array_equal(h.values["l_quantity"], qty[a:b]):
            raise AssertionError(f"phase 5l lookup: key {h.key} differs "
                                 "from the oracle")
    check_launched("phase 5l lookup", launches, ("bloom_check",))
    no_host_route_chunks("phase 5l lookup")
    return {"keys": TABLE_LOOKUP_KEYS, "absent": TABLE_LOOKUP_KEYS // 4,
            "part": part, "wall_s": wall, "hits": res.rows_total,
            "counters": dict(res.counters), "launches": launches}


def no_host_route_chunks(what: str) -> None:
    """No chunk took the host decode (a lookup plans no whole chunk, so
    the planner's counts are not asked for)."""
    if any(pq.HOST_ROUTE.values()):
        raise AssertionError(f"{what}: chunks took the host decode: "
                             f"{pq.HOST_ROUTE}")


def table_compaction(t1: str, ds, t1_read: dict, data: dict) -> dict:
    """Phase 5l(c): ``compact_table(max_files=2)`` on the card while the
    dataset of (b) stays open on the old snapshot."""
    live = pq.read_manifest(t1)
    victims = sorted(live.files, key=lambda e: e.file_size)[:2]
    order = {e.name: i for i, e in enumerate(live.files)}
    victims.sort(key=lambda e: order[e.name])
    pq.reset_launches()
    reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = pq.compact_table(t1, max_files=2, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pq.LAUNCHES)
    rows = sum(e.num_rows for e in victims)
    if m is None or m.version != live.version + 1 or \
            len(m.files) != len(live.files) - 1 or \
            m.files[0].num_rows != rows or any(
                os.path.exists(os.path.join(t1, e.name)) for e in victims):
        raise AssertionError(f"phase 5l compaction: {m}")
    if not any(launches.values()):
        raise AssertionError("phase 5l compaction launched no kernel")
    no_host_route_chunks("phase 5l compaction")
    # the old snapshot still reads, from the unlinked parts' maps
    again, again_s = timed_read_of(ds)
    same_bits(again, t1_read, "phase 5l read of the old snapshot")
    del again
    # a fresh snapshot: the merged part (the victims in snapshot order),
    # then the others
    fresh = pq.open_table(t1)
    ranges = {e.name: (order[e.name] * TABLE_COMMIT_ROWS,
                       order[e.name] * TABLE_COMMIT_ROWS + e.num_rows)
              for e in live.files}
    merged = np.concatenate([np.arange(*ranges[e.name]) for e in victims])
    check_columns(fresh.file(0).read(device=DEVICE),
                  host_columns_data(host_table(data, merged)))
    for i, e in enumerate(m.files[1:], 1):
        a, b = ranges[e.name]
        check_columns(fresh.file(i).read(device=DEVICE),
                      {k: column_slice(cd, a, b) for k, cd in data.items()})
    out, fresh_s = timed_walls(lambda: fresh.read(device=DEVICE), 3)
    n = out["l_orderkey"].num_slots
    del out
    fresh.close()
    if n != sum(e.num_rows for e in live.files):
        raise AssertionError(f"phase 5l fresh read: {n} rows")
    swept = pq.recover_table(t1)
    if swept:
        raise AssertionError(f"phase 5l recovery removed {swept}")
    merge = last_logged("merge")
    return {"version": m.version, "parts": len(m.files), "rows": rows,
            "wall_s": wall, "rows_per_s": rows / wall,
            "merge_5i_rows_per_s": merge.get("rows_per_s"),
            "merged_bytes": m.files[0].file_size, "launches": launches,
            "old_snapshot_read_s": again_s,
            "fresh_read": fresh_s}


def table_sorted(t2: str, seed: int) -> dict:
    """Phase 5l(d): 1,048,576 lineitem rows in a seeded order into a table
    sorted by ``l_orderkey``, 4 commits of 262,144 rows, compacted to one
    part by a ``BackgroundCompactor`` on the card; its read equals the rows
    sorted on the host (ties as sets), and every part's ``l_orderkey``
    pages are in ascending order."""
    n = TABLE_SORTED_ROWS
    schema, d = make_lineitem(n, seed + 1)
    perm = np.random.default_rng(seed + 43).permutation(n)
    shuffled = host_table(d, perm)
    want = host_table(d, perm[np.argsort(d["l_orderkey"].values[perm],
                                         kind="stable")])
    del d
    cols = host_columns_data(shuffled)
    per = n // TABLE_SORTED_COMMITS
    w = pq.DatasetWriter(t2, schema, sorting=[pq.SortingColumn("l_orderkey")],
                         options=pq.WriterOptions(
                             compression="snappy",
                             row_group_size=TABLE_ROW_GROUP))
    t0 = time.perf_counter()
    for i in range(TABLE_SORTED_COMMITS):
        w.write({k: column_slice(cd, i * per, (i + 1) * per)
                 for k, cd in cols.items()}, per)
        w.commit()
    w.close()
    ingest_s = time.perf_counter() - t0
    live = pq.read_manifest(t2)
    orders = {e.name: boundary_orders(os.path.join(t2, e.name), "l_orderkey")
              for e in live.files}
    if len(live.files) != TABLE_SORTED_COMMITS or live.sorting != [
            ("l_orderkey", False, False)] or any(
                o != BoundaryOrder.ASCENDING for v in orders.values()
                for o in v):
        raise AssertionError(f"phase 5l sorted ingest: {live.sorting}, "
                             f"{orders}")
    pq.reset_launches()
    reset_routes()
    t0 = time.perf_counter()
    with pq.BackgroundCompactor(t2, interval_s=0.05, min_files=2,
                                device=DEVICE) as bc:
        deadline = time.monotonic() + 300
        while len(pq.read_manifest(t2).files) > 1 and bc.last_error is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    wall = time.perf_counter() - t0
    launches = dict(pq.LAUNCHES)
    m = pq.read_manifest(t2)
    if bc.last_error is not None or bc._thread.is_alive() or \
            len(m.files) != 1 or bc.passes != 1:
        raise AssertionError(f"phase 5l background compaction: "
                             f"{bc.last_error!r}, {len(m.files)} parts")
    no_host_route_chunks("phase 5l background compaction")
    if not any(launches.values()):
        raise AssertionError("phase 5l background compaction launched no "
                             "kernel")
    part = os.path.join(t2, m.files[0].name)
    if boundary_orders(part, "l_orderkey") != [BoundaryOrder.ASCENDING]:
        raise AssertionError("phase 5l: the compacted part is not "
                             "ascending")
    with pq.open_table(t2) as ds:
        got = {k: c.materialize_host()
               for k, c in ds.read(device=DEVICE).items()}
    tied = check_sorted_output(got, want, ("l_orderkey",),
                               "phase 5l sorted compaction")
    return {"rows": n, "commits": TABLE_SORTED_COMMITS,
            "ingest_s": ingest_s, "compaction_wall_s": wall,
            "rows_per_s": n / wall, "tied_rows": tied,
            "launches": launches}


def table_crash(tmp: str, seed: int) -> dict:
    """Phase 5l(e): ``table_crash_check`` on 65,536 lineitem rows: a base
    commit of the first half, then an ingest of the second half in two
    parts, crashed at sampled bytes; each snapshot read on the card."""
    schema, d = make_lineitem(TABLE_CRASH_ROWS, seed + 2)
    half = TABLE_CRASH_ROWS // 2

    def options():
        return pq.WriterOptions(compression="snappy", row_group_size=16_384)

    def setup(table_dir):
        with pq.DatasetWriter(table_dir, schema, options=options()) as w:
            w.write({k: column_slice(cd, 0, half) for k, cd in d.items()},
                    half)

    def ingest(table_dir, wrap):
        w = pq.DatasetWriter(table_dir, schema, options=options(),
                             rows_per_file=half // 2, _sink_wrap=wrap)
        w.write({k: column_slice(cd, half, TABLE_CRASH_ROWS)
                 for k, cd in d.items()}, TABLE_CRASH_ROWS - half)
        w.commit()

    root = os.path.join(tmp, "table_crash")
    t0 = time.perf_counter()
    res = pq.table_crash_check(setup, ingest, root,
                               samples=TABLE_CRASH_SAMPLES, seed=seed,
                               device=DEVICE)
    wall = time.perf_counter() - t0
    outcomes = [r["outcome"] for r in res]
    if set(outcomes) != {"old", "new"}:
        raise AssertionError(f"phase 5l crash matrix: {res}")
    return {"rows": TABLE_CRASH_ROWS, "offsets": [r["offset"] for r in res],
            "outcomes": outcomes, "wall_s": wall}


def table_path(card: str, rows: int, seed: int, tmp: str,
               dataset_paths: list) -> dict:
    """Phase 5l: writable tables on the card, each check fatal.  (a) Phase
    4b's lineitem rows (phase 5c's 8 parts' rows) ingested into table T1
    by ``DatasetWriter`` (the default ``rows_per_file``, 524,288-row row
    groups, Snappy, the default dictionary rule, a bloom filter on
    ``l_orderkey``) in one commit a 1,048,576-row slice: versions 1-8, a
    part each, no ``*.tmp``.  (b) ``open_table`` pins the snapshot: its
    read on the card (cold, best of 2 warm) equals the generated columns
    and phase 5c's glob read of the same rows bit for bit; scans of 1 % of
    the keys open only the survivor and part 0, which types the predicate
    (:func:`table_scans`); the aggregates of :func:`table_aggregates`; a
    lookup of :data:`TABLE_LOOKUP_KEYS` keys (:func:`table_lookup`).  (c)
    ``compact_table(max_files=2)`` on the card under the pinned dataset of
    (b), whose read still equals its first; a fresh open reads the new
    snapshot; recovery removes nothing (:func:`table_compaction`).  (d)
    :func:`table_sorted`.  (e) :func:`table_crash`.  Both unpack kernels
    launch in (b)'s reads and ``bloom_check`` in its lookup, no chunk
    takes the host route, the card's allocated bytes come back after each
    step and no writer or compactor thread is left.  One ``{"table":
    ...}`` line."""
    start = settled_allocated()
    threads = set(threading.enumerate())
    launches = dict.fromkeys(pq.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    steps_s = {}
    step_t0 = [time.perf_counter()]

    def settled(what, mark):
        """The step's end: its seconds, and its device bytes back."""
        steps_s[what] = time.perf_counter() - step_t0[0]
        left = settled_allocated() - mark
        if left > 0:
            raise AssertionError(f"phase 5l {what}: {left} device bytes "
                                 f"left (steps so far {steps_s})")
        step_t0[0] = time.perf_counter()

    # (a) ingest
    schema, data = make_lineitem(rows, seed)
    t1 = os.path.join(tmp, "table_t1")
    t0 = time.perf_counter()
    ingest = table_ingest(t1, schema, data, rows)
    ingest_s = time.perf_counter() - t0
    settled("ingest", start)
    log({"table_ingest": ingest})

    # (b) reads of the pinned snapshot
    ds = pq.open_table(t1)
    parts = len(ds.paths)
    if ds.snapshot_version != parts or sorted(ds._files) != list(
            range(parts)):
        raise AssertionError("phase 5l: open_table did not pin every part")
    pq.reset_launches()
    reset_routes()
    t1_read, read_walls = timed_walls(lambda: ds.read(device=DEVICE), 3)
    read_launches = dict(pq.LAUNCHES)
    check_launched("phase 5l table read", read_launches, READ_KERNELS)
    no_host_route("phase 5l table read")
    add(read_launches)
    check_columns(t1_read, data)
    # phase 5c's parts hold the same rows: its glob read equals the
    # generated columns too, so the two reads are equal
    glob_read, glob_walls = timed_walls(
        lambda: pq.Dataset(dataset_paths).read(device=DEVICE), 3)
    check_columns(glob_read, data)
    del glob_read
    mark = settled_allocated()
    reset_routes()
    scans = table_scans(t1, data, rows)
    aggs = table_aggregates(t1, data, rows)
    no_host_route_chunks("phase 5l scans and aggregates")
    for a in aggs.values():
        add(a["launches"])
    lookup_out = table_lookup(t1, data, seed)
    add(lookup_out["launches"])
    settled("reads", mark)

    # (c) compaction under the pinned reader
    compaction = table_compaction(t1, ds, t1_read, data)
    add(compaction["launches"])
    ds.close()
    del t1_read, data
    settled("compaction", start)

    # (d) a sorted, keyed table
    sorted_out = table_sorted(os.path.join(tmp, "table_t2"), seed)
    add(sorted_out["launches"])
    settled("sorted table", start)

    # (e) the crash matrix
    crash = table_crash(tmp, seed)
    settled("crash matrix", start)
    if threads_started(threads):
        raise AssertionError(f"phase 5l: threads left "
                             f"{threads_started(threads)}")
    glob5c = last_logged("dataset_path")
    log({"table": {
        "card": card, "rows": rows, "commit_rows": TABLE_COMMIT_ROWS,
        "row_group": TABLE_ROW_GROUP, "ingest_s": ingest_s,
        "steps_s": steps_s, "commits": ingest,
        "read": {**read_walls, "rows_per_s": rows / read_walls["best_warm_s"],
                 "launches": read_launches},
        "glob_read_5c_parts": glob_walls,
        "glob_5c_per_file_sum_best_s": glob5c.get("per_file_sum_best_s"),
        "scans": scans, "aggregates": aggs, "lookup": lookup_out,
        "compaction": compaction, "sorted": sorted_out, "crash": crash,
        "launches": launches, "host_route": dict(pq.HOST_ROUTE)}})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 5n: remote sources on the card
# ---------------------------------------------------------------------------

#: the faults of phase 5n's faulted read, drawn per (range, attempt) from
#: the run's seed; two in a row at most, so four retries always recover
REMOTE_FAULTS = dict(refuse_rate=0.1, reset_rate=0.1, status_rate=0.1,
                     status_code=503, throttle_rate=0.1, retry_after=0.0,
                     max_consecutive=2)
#: the hedge delay pinned for phase 5n's hedged read, in seconds
REMOTE_HEDGE_S = "0.005"
REMOTE_WARM = 3  # warm reads of each file, the best reported


def gets_of(server, name: str, since: int) -> tuple:
    """``(GETs, bytes asked for)`` of ``name`` in the server's log from
    entry ``since`` on."""
    n = nbytes = 0
    for method, obj, rng in server.requests[since:]:
        if method == "GET" and obj == name:
            n += 1
            if rng:
                lo, hi = rng.split("=", 1)[1].split("-")
                nbytes += int(hi) - int(lo) + 1
    return n, nbytes


def launched(run):
    """``(run(), launches by kernel during it)``."""
    before = dict(pq.LAUNCHES)
    out = run()
    return out, {k: v - before[k] for k, v in pq.LAUNCHES.items()}


def join_remote_threads() -> None:
    """Wait for the hedge race's attempts that are still out."""
    for t in threading.enumerate():
        if t.name in ("pqt-remote-pread", "pqt-remote-hedge"):
            t.join(timeout=120)


def remote_path(card: str, read: dict, look_path: str, lookup_rows: int,
                seed: int, parts: list, agg: dict) -> dict:
    """Phase 5n: the port's remote sources on the card, each check fatal.
    One ``LocalRangeServer`` on 127.0.0.1 serves from memory phase 4's
    5-column file, phase 5's lookup file, phase 5j's Q1 file and phase
    5c's 8 lineitem parts (under ``bucket/parts/``, with the s3 dialect);
    a server that cannot bind fails the phase.  (a) ``ParquetFile(url)
    .read(device="cuda")`` once cold and ``REMOTE_WARM`` times warm, each
    equal to the local read bit for bit and launching each unpack kernel
    as often as it; its GETs and the bytes they asked for against the
    file's size, its best warm wall against the local read's; a warm
    re-open sends one HEAD and no GET.  (b) the read through
    ``FaultInjectingRemoteTransport`` (:data:`REMOTE_FAULTS`, the run's
    seed) under ``FaultPolicy(max_retries=4)``: equal, with
    ``ReadReport.retries > 0``.  (c) the read with the first attempt of
    every range stalled (until released after the read) and
    ``PARQUET_TPU_TORCH_REMOTE_HEDGE`` pinned: equal, with
    ``remote.hedges_won > 0``.  (d) ``Dataset`` over the parts' http
    prefix and their ``s3://bucket/parts/`` prefix, each equal to the
    local ``Dataset`` read of the parts.  (e) phase 5's lookup over its
    URL: hits equal to the local lookup's, ``bloom_check`` launched.  (f)
    phase 5j's dictionary-tier aggregate over its URL: answers equal to
    the local ones and the numpy oracle, its ranges fetched at once
    (``remote.parallel_preads``), ``unpack_bits_dense`` launched.  Its
    launches are those of the URL runs."""
    from parquet_tpu_torch.io import remote

    t0 = time.perf_counter()
    files = {}
    for name, path in (("main.parquet", read["path"]),
                       ("lookup.parquet", look_path),
                       ("q1.parquet", agg["path"])):
        with open(path, "rb") as f:
            files[name] = f.read()
    for i, path in enumerate(parts):
        with open(path, "rb") as f:
            files[f"bucket/parts/part-{i:02d}.parquet"] = f.read()
    server = pq.LocalRangeServer(files, s3_dialect=True)
    load_s = time.perf_counter() - t0
    size = len(files["main.parquet"])
    out = {"card": card, "served_bytes": sum(map(len, files.values())),
           "load_s": load_s}
    del files
    total = dict.fromkeys(pq.LAUNCHES, 0)
    try:
        url = server.url("main.parquet")
        reset_routes()
        # (a) the plain read, against the local one
        local_s = []
        for _ in range(REMOTE_WARM):
            (local, s), local_launches = launched(
                lambda: timed_read(read["path"]))
            local_s.append(s)
        walls, gets = [], []
        for i in range(REMOTE_WARM + 1):
            mark = len(server.requests)
            (got, s), n = launched(lambda: timed_read(url))
            same_bits(got, local, f"phase 5n: read {i} of the URL")
            del got
            if any(n[k] != local_launches[k] for k in READ_KERNELS):
                raise AssertionError(f"phase 5n: the URL read launched {n}, "
                                     f"the local read {local_launches}")
            for k, v in n.items():
                total[k] += v
            walls.append(s)
            gets.append(gets_of(server, "main.parquet", mark))
        heads = server.request_count("main.parquet", "HEAD")
        mark = len(server.requests)
        pq.ParquetFile(url).close()
        if (server.request_count("main.parquet", "HEAD") != heads + 1
                or gets_of(server, "main.parquet", mark)[0]):
            raise AssertionError("phase 5n: a warm re-open sent more than "
                                 "one HEAD")
        out["read"] = {
            "file_bytes": size, "local_warm_s": local_s,
            "cold_s": walls[0], "warm_s": walls[1:],
            "best_warm_s": min(walls[1:]),
            "best_local_s": min(local_s),
            "vs_local": min(walls[1:]) / min(local_s),
            "gets": [g[0] for g in gets],
            "bytes_asked": [g[1] for g in gets],
            "bytes_over_file": [g[1] / size for g in gets],
            "launches": local_launches}
        # (b) through the fault injector, under retries
        tr = pq.FaultInjectingRemoteTransport(pq.HttpTransport(url),
                                              seed=seed, **REMOTE_FAULTS)
        rep = pq.ReadReport()
        t0 = time.perf_counter()
        got, n = launched(lambda: pq.ParquetFile(
            pq.HttpSource(url, transport=tr),
            policy=pq.FaultPolicy(max_retries=4, backoff_s=0.0)).read(
                device=DEVICE, report=rep))
        torch.cuda.synchronize()
        faulted_s = time.perf_counter() - t0
        same_bits(got, local, "phase 5n: the faulted read")
        del got
        if rep.retries <= 0:
            raise AssertionError(f"phase 5n: the faulted read retried "
                                 f"nothing ({dataclasses.asdict(tr.stats)})")
        for k, v in n.items():
            total[k] += v
        out["faulted"] = {"wall_s": faulted_s, "retries": rep.retries,
                          "injected": dataclasses.asdict(tr.stats)}
        # (c) every range's first attempt stalled: the hedge wins
        release = threading.Event()
        tr = pq.FaultInjectingRemoteTransport(
            pq.HttpTransport(url), stall_s=600.0, stall_attempts=1,
            stall_release=release)
        before = pq.metrics_snapshot()
        try:
            with knobs(PARQUET_TPU_TORCH_REMOTE_HEDGE=REMOTE_HEDGE_S):
                (got, s), n = launched(lambda: timed_read(
                    pq.HttpSource(url, transport=tr)))
        finally:
            release.set()
            join_remote_threads()
        delta = pq.metrics_delta(before, pq.metrics_snapshot())["counters"]
        same_bits(got, local, "phase 5n: the hedged read")
        del got, local
        if not delta.get("remote.hedges_won"):
            raise AssertionError(f"phase 5n: no hedge won: {delta}")
        for k, v in n.items():
            total[k] += v
        out["hedged"] = {"wall_s": s, "hedge_s": float(REMOTE_HEDGE_S),
                         "stalls": tr.stats.stalls,
                         "hedges_issued": delta.get("remote.hedges_issued"),
                         "hedges_won": delta["remote.hedges_won"],
                         "hedge_in_flight_bytes":
                             remote.hedge_in_flight_bytes()}
        # (d) the parts through a listed http prefix and an s3 prefix
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pq.Dataset(parts).read(device=DEVICE)
        torch.cuda.synchronize()
        out["dataset"] = {"local_s": time.perf_counter() - t0}
        endpoint = f"http://{server.host}:{server.port}"
        with knobs(PARQUET_TPU_TORCH_S3_ENDPOINT=endpoint):
            for how, arg in (("http", server.url("bucket/parts/")),
                             ("s3", "s3://bucket/parts/")):
                t0 = time.perf_counter()
                ds = pq.Dataset(arg)
                if len(ds.paths) != len(parts):
                    raise AssertionError(f"phase 5n: {how} listing gave "
                                         f"{ds.paths}")
                got, n = launched(lambda: ds.read(device=DEVICE))
                torch.cuda.synchronize()
                out["dataset"][f"{how}_s"] = time.perf_counter() - t0
                same_bits(got, want, f"phase 5n: the {how} Dataset")
                del got
                for k, v in n.items():
                    total[k] += v
        del want
        # (e) the lookup over the URL
        keys = make_keys(lookup_rows, seed)
        pq.clear_caches()
        want, local_s = timed_lookup(pq.ParquetFile(look_path), keys,
                                     DEVICE)
        pq.clear_caches()
        (got, s), n = launched(lambda: timed_lookup(
            pq.ParquetFile(server.url("lookup.parquet")), keys, DEVICE))
        same_hits(got, want, "phase 5n: the URL lookup")
        if got.counters != want.counters:
            raise AssertionError(f"phase 5n: lookup counters {got.counters}"
                                 f" != {want.counters}")
        if not n["bloom_check"]:
            raise AssertionError("phase 5n: the URL lookup launched no "
                                 "bloom_check")
        for k, v in n.items():
            total[k] += v
        out["lookup"] = {"keys": len(keys), "local_s": local_s, "url_s": s,
                         "launches": n}
        del got, want
        # (f) the dictionary-tier aggregate over the URL
        kw, dict_want = agg["dictionary"]
        want = pq.ParquetFile(agg["path"]).aggregate(device=DEVICE, **kw)
        before = pq.metrics_snapshot()
        t0 = time.perf_counter()
        got, n = launched(lambda: pq.ParquetFile(
            server.url("q1.parquet")).aggregate(device=DEVICE, **kw))
        agg_s = time.perf_counter() - t0
        delta = pq.metrics_delta(before, pq.metrics_snapshot())["counters"]
        _check_agg(got, dict_want, "phase 5n aggregate")
        if dict(got.items()) != dict(want.items()) \
                or got.counters != want.counters:
            raise AssertionError(f"phase 5n: aggregate {dict(got.items())} "
                                 f"!= {dict(want.items())}")
        if not delta.get("remote.parallel_preads") \
                or not n["unpack_bits_dense"]:
            raise AssertionError(f"phase 5n: the URL aggregate fetched "
                                 f"{delta} and launched {n}")
        for k, v in n.items():
            total[k] += v
        out["aggregate"] = {"wall_s": agg_s, "tiers": {
            k: v for k, v in got.counters.items() if v},
            "parallel_preads": delta["remote.parallel_preads"],
            "launches": n}
        no_host_route("phase 5n")
    finally:
        remote.drain_connection_pools()
        server.close()
    out["requests"] = len(server.requests)
    check_launched("phase 5n", total, READ_KERNELS + ("bloom_check",))
    out["launches"] = total
    log({"remote": out})
    return {"launches": total}


# ---------------------------------------------------------------------------
# Phase 5m: counters, a traced read, row-group pruning, no pyarrow
# ---------------------------------------------------------------------------

#: the probe values of phase 5m(c): as many as its hashes
DEBUG_PROBES = 65_536
#: traced reads phase 5m(a) may take before its kernel events must match:
#: the profiler drops a window's device events now and then
DEBUG_TRACE_TRIES = 5


def trace_events(out_dir: str) -> tuple:
    """The one Chrome trace in ``out_dir``: ``(events, bytes)``."""
    names = os.listdir(out_dir)
    if len(names) != 1:
        raise AssertionError(f"phase 5m: {len(names)} trace files, not 1")
    path = os.path.join(out_dir, names[0])
    with open(path) as f:
        return json.load(f)["traceEvents"], os.path.getsize(path)


#: the region around the read whose kernels phase 5m(a) counts
CHECKED_READ = "chip_smoke.checked_read"


def traced_read(path: str, out_dir: str, want: dict) -> dict:
    """Two reads of ``path`` on the card under ``profiler_trace(out_dir)``
    (the profiler can miss the device events of a window's first moments,
    so the first read only opens the window): the second's columns equal
    ``want`` bit for bit, the trace holds the read's ``pq.prepare_chunk``
    and ``pq.decode_staged:*`` regions, and each unpack kernel's CUDA
    symbol, launched (by its correlation id) inside the second read's
    region, as often as ``LAUNCHES`` counted in that read."""
    from parquet_tpu_torch.utils.debug import annotate, profiler_trace

    os.makedirs(out_dir)
    pq.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiler_trace(out_dir):
        first = pq.ParquetFile(path).read(device=DEVICE)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        del first
        first_launches = dict(pq.LAUNCHES)
        pq.reset_launches()
        t1 = time.perf_counter()
        with annotate(CHECKED_READ):
            got = pq.ParquetFile(path).read(device=DEVICE)
            torch.cuda.synchronize()
        read_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0
    launches = dict(pq.LAUNCHES)
    same_bits(got, want, "phase 5m traced read")
    del got
    events, nbytes = trace_events(out_dir)
    names = [e.get("name", "") for e in events]
    regions = {n for n in names if n == "pq.prepare_chunk"
               or n.startswith("pq.decode_staged:")}
    if "pq.prepare_chunk" not in regions or len(regions) < 2:
        raise AssertionError(f"phase 5m: the trace lacks the read's "
                             f"regions (found {sorted(regions)})")
    region = next(e for e in events if e.get("name") == CHECKED_READ
                  and e.get("ph") == "X")
    lo, hi = region["ts"], region["ts"] + region["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})
                and lo <= e["ts"] <= hi}
    in_trace = {k: sum(1 for e in events if e.get("cat") == "kernel"
                       and f"{k}_kernel" in e.get("name", "")
                       and e.get("args", {}).get("correlation") in launched)
                for k in READ_KERNELS}
    return {"first_traced_read_s": first_s, "traced_read_s": read_s,
            "traced_with_export_s": total_s, "trace_bytes": nbytes,
            "trace_events": len(events), "regions": sorted(regions),
            "first_launches": first_launches, "launches": launches,
            "kernel_events": in_trace}


def debug_path(card: str, read: dict, look_path: str, rows: int,
               seed: int, tmp: str) -> dict:
    """Phase 5m: the read's observability on the card, each check fatal.
    (a) Phase 4's 5-column file read under ``profiler_trace`` (a Chrome
    trace into a temporary directory; :func:`traced_read`): its columns
    equal an untraced read's bit for bit, the trace holds the
    ``pq.prepare_chunk`` and ``pq.decode_staged:*`` regions and as many
    ``unpack_bits_dense`` and ``dict_unpack_gather`` kernel events as
    ``LAUNCHES`` counted (a trace that dropped some is taken again, up to
    :data:`DEBUG_TRACE_TRIES`); the untraced and traced walls.  (b) ``counters`` over an untraced
    read: ``chunks_device_decoded`` is the file's chunks,
    ``chunks_host_fallback`` 0, ``bytes_h2d`` the bytes of the staging
    batches the read sent (summed by a spy on the send), and the three
    names ``PIPELINE`` keeps equal to its.  (c)
    ``prune_row_group_values`` of each of phase 5's row groups on the
    lookup file's ``k`` with :data:`DEBUG_PROBES` hashes (phase 5's keys,
    one in eight present; then odd keys only, all absent) on the card,
    its answers the CPU's, ``bloom_check`` launched once a row group.
    (d) Whether pyarrow imports here: where it does, a card read of the
    5-column file converts by ``to_arrow`` (timed), each column's nulls
    and values equal to the card's; where it does not, no Arrow step
    runs, and every earlier phase having run shows the port needs none.
    One ``{"debug": ...}`` line."""
    import importlib.util

    from parquet_tpu_torch.io.search import prune_row_group_values
    from parquet_tpu_torch.utils.debug import counters

    path = read["path"]
    launches = dict.fromkeys(pq.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the traced read against an untraced one
    timed_read(path)  # warm
    pq.reset_launches()
    want, untraced_s = timed_read(path)
    add(pq.LAUNCHES)
    tries = []
    for i in range(DEBUG_TRACE_TRIES):
        got = traced_read(path, os.path.join(tmp, f"trace_5m_{i}"), want)
        add(got["first_launches"])
        add(got["launches"])
        tries.append(got)
        if all(got["kernel_events"][k] == got["launches"][k]
               for k in READ_KERNELS):
            break
    else:
        raise AssertionError(f"phase 5m: no trace held every kernel "
                             f"launch: {tries}")
    check_launched("phase 5m traced read", got["launches"], READ_KERNELS)
    del want

    # (b) the counters of an untraced read
    sent = [0]
    send = device_reader._StagingBatch.send

    def spy(self, device):
        sent[0] += self.nbytes
        return send(self, device)

    pf = pq.ParquetFile(path)
    chunks = len(pf.row_groups) * len(pf.schema.leaves)
    pq.reset_pipeline()
    counters.reset()
    pq.reset_launches()
    device_reader._StagingBatch.send = spy
    try:
        pf.read(device=DEVICE)
        torch.cuda.synchronize()
    finally:
        device_reader._StagingBatch.send = send
    add(pq.LAUNCHES)
    snap, pipeline = counters.snapshot(), dict(pq.PIPELINE)
    if snap.get("chunks_device_decoded") != chunks or snap.get(
            "chunks_host_fallback", 0) != 0:
        raise AssertionError(f"phase 5m: counters {snap} for {chunks} "
                             "chunks on the device")
    if snap.get("bytes_h2d") != sent[0] or not sent[0]:
        raise AssertionError(f"phase 5m: bytes_h2d {snap.get('bytes_h2d')}"
                             f" against {sent[0]} bytes sent")
    for name in ("chunks_device_decoded", "chunks_host_fallback",
                 "stage_concurrency_peak"):
        if snap.get(name, 0) != pipeline[name]:
            raise AssertionError(f"phase 5m: counters {name} "
                                 f"{snap.get(name, 0)} != PIPELINE "
                                 f"{pipeline[name]}")

    # (c) row-group pruning with the bloom probe on the card
    lpf = pq.ParquetFile(look_path)
    leaf = lpf.schema.leaf("k")
    keys = make_keys(rows, seed)
    probes = {"mixed": np.sort(keys[:DEBUG_PROBES]),
              "absent": np.sort(keys[keys % 2 == 1][:DEBUG_PROBES])}
    prune = {}
    for name, vals in probes.items():
        vals = vals.tolist()
        hashes = bloom.probe_hashes(leaf, vals)
        pq.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [prune_row_group_values(rg, "k", vals, hashes=hashes,
                                      device=DEVICE)
               for rg in lpf.row_groups]
        card_s = time.perf_counter() - t0
        probe_launches = pq.LAUNCHES["bloom_check"]
        add(pq.LAUNCHES)
        t0 = time.perf_counter()
        cpu = [prune_row_group_values(rg, "k", vals, hashes=hashes,
                                      device="cpu")
               for rg in lpf.row_groups]
        cpu_s = time.perf_counter() - t0
        if got != cpu:
            raise AssertionError(f"phase 5m {name}: card {got} != cpu {cpu}")
        if probe_launches != len(lpf.row_groups):
            raise AssertionError(f"phase 5m {name}: {probe_launches} "
                                 "bloom_check launches for "
                                 f"{len(lpf.row_groups)} row groups")
        prune[name] = {"hashes": len(hashes), "kept": got,
                       "bloom_check_launches": probe_launches,
                       "card_s": card_s, "cpu_s": cpu_s}

    # (d) no pyarrow: the port ran every phase without it
    has_pyarrow = importlib.util.find_spec("pyarrow") is not None
    print(f"phase 5m: pyarrow {'imports' if has_pyarrow else 'does not import'}"
          " here; "
          + ("Table.to_arrow of a card read checked against its columns"
             if has_pyarrow else "no Arrow step runs"), flush=True)
    arrow = None
    if has_pyarrow:
        import pyarrow

        cols = pq.ParquetFile(path).read(device=DEVICE)
        torch.cuda.synchronize()
        arrow_s = []
        for _ in range(2):  # the process's first conversion, then a warm one
            t0 = time.perf_counter()
            tbl = cols.to_arrow()
            arrow_s.append(time.perf_counter() - t0)
        if tbl.num_rows != pf.num_rows or tbl.column_names != list(cols):
            raise AssertionError("phase 5m: to_arrow lost rows or columns")
        for name, col in cols.items():
            arr = tbl[name].combine_chunks()
            values, _ = col.host_dense()
            nulls = 0 if col.validity is None else int(
                (~col.validity).sum())
            if arr.null_count != nulls or not np.array_equal(
                    arr.drop_null().to_numpy(), values):
                raise AssertionError(f"phase 5m: to_arrow of {name} "
                                     "differs from the card's column")
        arrow = {"pyarrow": pyarrow.__version__, "rows": tbl.num_rows,
                 "columns": tbl.num_columns, "to_arrow_s": arrow_s}
        del cols, tbl
    log({"debug": {
        "card": card, "rows": pf.num_rows, "chunks": chunks,
        "file_bytes": os.path.getsize(path),
        "untraced_read_s": untraced_s, "traced": tries,
        "trace_tries": len(tries),
        "counters": snap, "pipeline": pipeline,
        "bytes_sent": sent[0], "prune": prune, "pyarrow": has_pyarrow,
        "arrow": arrow, "launches": launches}})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 5o: observability in production (obs/: scopes, spans, the ledger)
# ---------------------------------------------------------------------------

OBS_WARM = 3  # untraced and traced reads of the 5-column file, each
OBS_SAMPLED_READS = 16  # reads under PARQUET_TPU_TORCH_TRACE_SAMPLE=8
OBS_SAMPLE = 8
OBS_LOOKUP_KEYS = 65_536  # phase 5's keys in its first row group
OBS_SCAN = ("l_quantity", 10, 20)  # the dataset scan of phase 5o(b)
OBS_WAIT_S = 30.0  # the most a blocked admission is polled for


class SourceBytes:
    """Bytes the mapped and plain file sources served inside the block:
    the preads that ``read.bytes_read`` counts, summed by a spy."""

    def __init__(self):
        from parquet_tpu_torch.io import source as src

        self._src = src
        self.bytes = 0
        self._lock = threading.Lock()
        self._saved = []

    def __enter__(self):
        for cls in (self._src.MmapSource, self._src.FileSource):
            for meth in ("pread", "pread_view"):
                real = cls.__dict__.get(meth)
                if real is None:
                    continue

                def spied(this, offset, size, real=real):
                    out = real(this, offset, size)
                    with self._lock:
                        self.bytes += size
                    return out

                self._saved.append((cls, meth, real))
                setattr(cls, meth, spied)
        return self

    def __exit__(self, *exc):
        for cls, meth, real in self._saved:
            setattr(cls, meth, real)
        self._saved = []


def scoped_read(path: str, name: str = "smoke.read") -> dict:
    """One read of ``path`` on the card inside ``op_scope(name)``, its
    syncs counted: the columns, the wall (the read and a final
    synchronize), the op, the global counter delta, the bytes the sources
    served, the read's launches and its ``ReadStats``."""
    from parquet_tpu_torch import obs

    box = {}
    torch.cuda.synchronize()
    pq.reset_launches()
    before = obs.metrics_snapshot()
    with SourceBytes() as spy:
        t0 = time.perf_counter()
        with obs.op_scope(name) as op:
            def run():
                with pq.ParquetFile(path) as pf:
                    box["out"] = pf.read(device=DEVICE)
            syncs = count_syncs(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    delta = obs.metrics_delta(before, obs.metrics_snapshot())["counters"]
    mine = op.counters()
    if not (mine.get("read.bytes_read") == delta.get("read.bytes_read")
            == spy.bytes > 0):
        raise AssertionError(
            f"phase 5o: the op's read.bytes_read {mine.get('read.bytes_read')}"
            f", the global delta {delta.get('read.bytes_read')} and the "
            f"sources' {spy.bytes} differ")
    return {"out": box["out"], "wall_s": wall, "syncs": syncs, "op": op,
            "delta": delta, "bytes": spy.bytes,
            "launches": dict(pq.LAUNCHES)}


def _obs_report(op) -> dict:
    rep = op.report()
    return {k: rep[k] for k in ("name", "op", "sampled", "duration_s",
                                "bytes_read", "pool_wait_s", "cache_hits",
                                "cache_misses", "retries", "rows_pruned",
                                "rows_decoded", "routes")}


def instrumented_reads(path: str, tmp: str) -> dict:
    """Phase 5o(a): the 5-column file read untraced, traced with every op
    sampled, and sampled 1 in :data:`OBS_SAMPLE` over
    :data:`OBS_SAMPLED_READS` reads, each read inside
    ``op_scope("smoke.read")``."""
    from parquet_tpu_torch import obs
    from parquet_tpu_torch.obs import scope as oscope
    from parquet_tpu_torch.utils.debug import counters

    scoped_read(path)  # warm
    untraced = [scoped_read(path) for _ in range(OBS_WARM)]
    want = untraced[-1]["out"]
    base = untraced[-1]

    # traced, every op sampled; the first read from cleared caches
    trace_path = os.path.join(tmp, "trace_5o.json")
    plans = [0]
    build = device_reader.build_plan

    def counted(*a, **k):
        plans[0] += 1
        return build(*a, **k)

    traced = []
    h2d_sent = []
    with knobs(PARQUET_TPU_TORCH_TRACE_SAMPLE="1"):
        obs.reset_trace()
        pq.clear_caches()
        obs.enable_tracing(trace_path)
        device_reader.build_plan = counted
        try:
            for i in range(OBS_WARM):
                counters.reset()
                got = scoped_read(path)
                h2d_sent.append(counters.snapshot().get("bytes_h2d", 0))
                traced.append(got)
        finally:
            device_reader.build_plan = build
            obs.disable_tracing()
        written = obs.flush_trace()
    for got in traced:
        same_bits(got["out"], want, "phase 5o traced read")
        if got["syncs"]["count"] != base["syncs"]["count"]:
            raise AssertionError(f"phase 5o: a traced read synchronized "
                                 f"{got['syncs']} against the untraced "
                                 f"{base['syncs']}")
        for k in READ_KERNELS:
            if got["launches"][k] != base["launches"][k]:
                raise AssertionError(f"phase 5o: the traced read launched "
                                     f"{k} {got['launches'][k]} times, the "
                                     f"untraced {base['launches'][k]}")
        del got["out"]
    with open(written) as f:
        events = json.load(f)["traceEvents"]
    trace_bytes = os.path.getsize(written)
    tracks = {oscope._OP_PID_BASE + got["op"].op_id for got in traced}
    op_events = [e for e in events if e.get("name") == "op.smoke.read"]
    if {e["pid"] for e in op_events} != tracks:
        raise AssertionError("phase 5o: the trace lacks a read's own event")
    h2d = [e for e in events if e.get("name") == "device.h2d"]
    if len(h2d) != plans[0] or {e["pid"] for e in h2d} != tracks:
        raise AssertionError(f"phase 5o: {len(h2d)} device.h2d spans on "
                             f"the reads' tracks for {plans[0]} staged "
                             "plans")
    h2d_threads = {e["tid"] for e in h2d}
    names = {e["args"]["name"] for e in events
             if e.get("name") == "thread_name" and e.get("tid") in
             h2d_threads}
    if len(h2d_threads) < 2 or not all(n.startswith("pqt-prepare")
                                       for n in names):
        raise AssertionError(f"phase 5o: the staging spans came from "
                             f"threads {sorted(names)}, not the prepare "
                             "workers")
    if "open.footer" not in {e.get("name") for e in events}:
        raise AssertionError("phase 5o: the first traced read from cleared "
                             "caches has no open.footer span")
    h2d_bytes = sum(e["args"]["bytes"] for e in h2d)

    # sampled one op in OBS_SAMPLE
    sampled = []
    obs.reset_trace()
    before = obs.metrics_snapshot()
    with knobs(PARQUET_TPU_TORCH_TRACE_SAMPLE=str(OBS_SAMPLE)):
        obs.enable_tracing()
        try:
            for _ in range(OBS_SAMPLED_READS):
                got = scoped_read(path)
                same_bits(got.pop("out"), want, "phase 5o sampled read")
                sampled.append(got)
        finally:
            obs.disable_tracing()
    d = obs.metrics_delta(before, obs.metrics_snapshot())["counters"]
    kept = [g["op"] for g in sampled if g["op"].sampled]
    n_kept = OBS_SAMPLED_READS // OBS_SAMPLE
    if (d.get("trace.ops_sampled") != n_kept
            or d.get("trace.ops_skipped") != OBS_SAMPLED_READS - n_kept
            or len(kept) != n_kept):
        raise AssertionError(f"phase 5o: sampled {d.get('trace.ops_sampled')}"
                             f", skipped {d.get('trace.ops_skipped')} of "
                             f"{OBS_SAMPLED_READS} reads at 1 in "
                             f"{OBS_SAMPLE}")
    sevents = obs.trace_events()
    kept_tracks = {oscope._OP_PID_BASE + op.op_id for op in kept}
    spans_on = {e["pid"] for e in sevents if e.get("ph") == "X"}
    if spans_on != kept_tracks:
        raise AssertionError("phase 5o: spans of unsampled reads reached "
                             "the trace")
    obs.reset_trace()
    del want
    for got in untraced:
        got.pop("out", None)
    return {
        "untraced_s": [g["wall_s"] for g in untraced],
        "traced_s": [g["wall_s"] for g in traced],
        "sampled_s": [g["wall_s"] for g in sampled],
        "best_untraced_s": min(g["wall_s"] for g in untraced),
        "best_traced_s": min(g["wall_s"] for g in traced[1:]),
        "best_sampled_s": min(g["wall_s"] for g in sampled),
        "syncs": {"untraced": base["syncs"], "traced": traced[-1]["syncs"]},
        "bytes_read": base["bytes"],
        "trace_bytes": trace_bytes, "trace_events": len(events),
        "h2d_spans": len(h2d), "staged_plans": plans[0],
        "h2d_threads": sorted(names),
        "h2d_span_bytes": h2d_bytes, "counters_bytes_h2d": sum(h2d_sent),
        "sampled_events": len(sevents),
        "sampled": {"kept": n_kept, "ops_sampled": d["trace.ops_sampled"],
                    "ops_skipped": d["trace.ops_skipped"]},
        "reports": {"untraced": _obs_report(base["op"]),
                    "traced": _obs_report(traced[-1]["op"])},
        "launches": base["launches"]}


def concurrent_ops(look_path: str, keys: np.ndarray, parts: list) -> dict:
    """Phase 5o(b): a lookup of phase 5's keys in its file's first row
    group (a batch the card's bloom probe takes) and a ``Dataset.scan``
    of phase 5c's parts at once on two threads, each in its own op: their
    ``read.bytes_read`` sum to the global delta."""
    from parquet_tpu_torch import obs

    pq.clear_caches()
    ops, errors = {}, []
    launches = dict.fromkeys(pq.LAUNCHES, 0)

    def lookup():
        try:
            with obs.op_scope("smoke.lookup") as op:
                with pq.ParquetFile(look_path) as f:
                    f.find_rows("k", keys, columns=LOOKUP_COLUMNS,
                                device=DEVICE)
            ops["lookup"] = op
        except Exception as e:  # raised below, on the phase's thread
            errors.append(e)

    def scan():
        try:
            key, lo, hi = OBS_SCAN
            with obs.op_scope("smoke.scan") as op:
                with pq.Dataset(parts) as ds:
                    ops["rows"] = len(ds.scan(key, lo=lo, hi=hi,
                                              columns=["l_extendedprice"],
                                              device=DEVICE)
                                      ["l_extendedprice"])
            ops["scan"] = op
        except Exception as e:
            errors.append(e)

    pq.reset_launches()
    before = obs.metrics_snapshot()
    threads = [threading.Thread(target=lookup, name="smoke-lookup"),
               threading.Thread(target=scan, name="smoke-scan")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for k, v in pq.LAUNCHES.items():
        launches[k] += v
    delta = obs.metrics_delta(before, obs.metrics_snapshot())["counters"]
    got = {k: ops[k].counters().get("read.bytes_read", 0)
           for k in ("lookup", "scan")}
    if not (got["lookup"] > 0 and got["scan"] > 0
            and got["lookup"] + got["scan"] == delta["read.bytes_read"]):
        raise AssertionError(f"phase 5o: the ops' bytes {got} do not sum "
                             f"to the global {delta['read.bytes_read']}")
    if launches["bloom_check"] == 0:
        raise AssertionError("phase 5o: the lookup launched no bloom_check")
    return {"wall_s": wall, "bytes_read": got,
            "global_bytes_read": delta["read.bytes_read"],
            "scan_rows": ops["rows"],
            "reports": {k: _obs_report(ops[k]) for k in ("lookup", "scan")},
            "launches": launches}


_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$')


def scraped_drain(path: str) -> dict:
    """Phase 5o(c): ``start_metrics_server(0)`` on 127.0.0.1 scraped in
    the middle of a streamed drain of the 5-column file on the card:
    ``/metrics`` parses as Prometheus text with every family of the
    registry, ``/debugz`` shows the drain's live op and the ledger; the
    server's thread is joined at the end."""
    import urllib.request

    from parquet_tpu_torch import obs
    from parquet_tpu_torch.obs import export, metrics

    def get(url):
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read().decode()

    pq.reset_launches()
    srv = pq.start_metrics_server(0, host="127.0.0.1")
    try:
        with pq.ParquetFile(path) as f:
            it = f.iter_batches(batch_rows=1 << 20, device=DEVICE)
            next(it)
            text = get(srv.url)
            dz = json.loads(get(f"http://{srv.host}:{srv.port}/debugz"))
            batches = 1 + sum(1 for _ in it)
        torch.cuda.synchronize()
    finally:
        srv.close()
    if srv._thread.is_alive():
        raise AssertionError("phase 5o: the metrics server's thread lives "
                             "on after close")
    families = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif not line.startswith("# ") and not _PROM_SAMPLE.match(line):
            raise AssertionError(f"phase 5o: /metrics line {line!r} is "
                                 "not Prometheus text")
    want = set()
    for m in metrics.REGISTRY.collect():
        fam = export._prom_name(m.name)
        want.add(fam + "_total" if isinstance(m, metrics.Counter) else fam)
    missing = sorted(want - families)
    core = {"parquet_tpu_read_bytes_read_total", "parquet_tpu_pool_tasks_total",
            "parquet_tpu_ledger_resident_bytes",
            "parquet_tpu_pool_queue_wait_s"}
    if missing or not core <= families:
        raise AssertionError(f"phase 5o: /metrics lacks {missing[:10]}")
    live = [o["name"] for o in dz["ops"]]
    if "file.iter_batches" not in live or "accounts" not in dz["ledger"]:
        raise AssertionError(f"phase 5o: /debugz shows ops {live} and "
                             f"ledger {sorted(dz['ledger'])}")
    return {"families": len(families), "metrics_bytes": len(text),
            "debugz_sections": sorted(dz), "live_ops": live,
            "batches": batches, "launches": dict(pq.LAUNCHES)}


def memory_pressure(look_path: str, keys: np.ndarray) -> dict:
    """Phase 5o(d): after a warm lookup the soft watermark at half the
    ledger's total shrinks the page cache under it, and a second lookup's
    answers are unchanged; the hard watermark holds a read admission on a
    thread until the ledger's bytes drop."""
    from parquet_tpu_torch import obs
    from parquet_tpu_torch.obs import ledger, metrics
    from parquet_tpu_torch.utils import pool

    pq.clear_caches()
    pq.reset_launches()
    with pq.ParquetFile(look_path) as f:
        timed_lookup(f, keys, DEVICE)
        first, warm_s = timed_lookup(f, keys, DEVICE)
        before = obs.ledger_snapshot()
        total = before["total_bytes"]
        page = before["accounts"]["cache.page"]["resident_bytes"]
        ev0 = metrics.counter("ledger.pressure_evictions").value
        with knobs(PARQUET_TPU_TORCH_MEM_SOFT=str(total // 2)):
            state = ledger.LEDGER.check_pressure()
            after = obs.ledger_snapshot()
            second, second_s = timed_lookup(f, keys, DEVICE)
        evictions = metrics.counter("ledger.pressure_evictions").value - ev0
    if not (after["total_bytes"] < total // 2 and evictions > 0
            and after["accounts"]["cache.page"]["resident_bytes"] < page):
        raise AssertionError(f"phase 5o: the soft watermark at {total // 2} "
                             f"left {after['total_bytes']} bytes after "
                             f"{evictions} evictions")
    same_hits(second.hits, first.hits, "phase 5o: the lookup under the "
              "soft watermark")

    # the hard watermark holds an admission until the bytes drop
    ballast = ledger.LEDGER.account("smoke.ballast")
    hard = max(total, 1 << 20)
    gate = pool.read_admission()
    done = threading.Event()
    errors = []

    def admit():
        try:
            with gate.admit(4096, tier="scan"):
                done.set()
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=admit, name="smoke-admission")
    with knobs(PARQUET_TPU_TORCH_MEM_HARD=str(hard)):
        ballast.add(2 * hard)
        try:
            if ledger.LEDGER.state() != "hard":
                raise AssertionError("phase 5o: the ledger is not over its "
                                     "hard watermark")
            t.start()
            t0 = time.perf_counter()
            while gate.queue_depth() == 0 and t.is_alive() and \
                    time.perf_counter() - t0 < OBS_WAIT_S:
                time.sleep(0.001)
            held = gate.queue_depth() == 1 and not done.is_set()
        finally:
            ballast.sub(2 * hard)
            t.join(timeout=OBS_WAIT_S)
    if t.is_alive() or errors or not done.is_set() or not held:
        raise AssertionError(f"phase 5o: the hard watermark's admission: "
                             f"held {held}, admitted {done.is_set()}, "
                             f"errors {errors}")
    return {"total_before": total, "soft_watermark": total // 2,
            "state": state, "total_after": after["total_bytes"],
            "page_before": page,
            "page_after": after["accounts"]["cache.page"]["resident_bytes"],
            "pressure_evictions": evictions, "warm_lookup_s": warm_s,
            "lookup_under_pressure_s": second_s,
            "hard_watermark": hard, "admission_held": held,
            "ledger_before": before["accounts"],
            "ledger_after": after["accounts"],
            "launches": dict(pq.LAUNCHES)}


def slow_log(path: str, look_path: str, keys: np.ndarray, tmp: str) -> dict:
    """Phase 5o(e): with ``PARQUET_TPU_TORCH_SLOW_OP_S=0`` the slow log
    holds one JSON line an op (a read and a lookup), each with its
    report."""
    log_path = os.path.join(tmp, "slow_5o.jsonl")
    pq.reset_launches()
    with knobs(PARQUET_TPU_TORCH_SLOW_OP_S="0",
               PARQUET_TPU_TORCH_SLOW_LOG=log_path):
        with pq.ParquetFile(path) as f:
            f.read(device=DEVICE)
        with pq.ParquetFile(look_path) as f:
            f.find_rows("k", keys, columns=LOOKUP_COLUMNS, device=DEVICE)
        torch.cuda.synchronize()
    with open(log_path) as f:
        recs = [json.loads(line) for line in f]
    names = [r["name"] for r in recs]
    if names != ["file.read", "lookup.find_rows"] or not all(
            r["report"].get("read.bytes_read", 0) > 0 for r in recs):
        raise AssertionError(f"phase 5o: slow log {names}")
    return {"records": len(recs), "names": names,
            "duration_s": [r["duration_s"] for r in recs],
            "launches": dict(pq.LAUNCHES)}


def obs_path(card: str, read: dict, look_path: str, lookup_rows: int,
             seed: int, parts: list, tmp: str) -> dict:
    """Phase 5o: the port's observability in production, each check
    fatal (:func:`instrumented_reads`, :func:`concurrent_ops`,
    :func:`scraped_drain`, :func:`memory_pressure`, :func:`slow_log`).
    One ``{"obs": ...}`` line (a failing check's line holds the parts
    done before it)."""
    # phase 5's keys that fall in its lookup file's first row group: a
    # row group's batch of 32,768 hashes or more goes to the card's probe
    keys = make_keys(lookup_rows, seed)
    keys = keys[keys < 2 * (ROW_GROUP // 4)][:OBS_LOOKUP_KEYS]
    launches = dict.fromkeys(pq.LAUNCHES, 0)
    out = {"card": card, "lookup_keys": len(keys)}
    for name, run in (
            ("a_reads", lambda: instrumented_reads(read["path"], tmp)),
            ("b_concurrent", lambda: concurrent_ops(look_path, keys, parts)),
            ("c_endpoints", lambda: scraped_drain(read["path"])),
            ("d_pressure", lambda: memory_pressure(look_path, keys)),
            ("e_slow_log", lambda: slow_log(read["path"], look_path, keys,
                                            tmp))):
        t0 = time.perf_counter()
        try:
            got = run()
        except BaseException:
            log({"obs": out, "failed_in": name})
            raise
        got["phase_s"] = time.perf_counter() - t0
        for k, v in got["launches"].items():
            launches[k] += v
        out[name] = got
    check_launched("phase 5o", launches,
                   READ_KERNELS + ("bloom_check",))
    out["launches"] = launches
    log({"obs": out})
    return {"launches": launches}


SERVE_PIN = 64 << 20  # the latency tenant's pinned pages
SERVE_BATCH_BUDGET = 256 << 20
SERVE_TOKEN = "smoke-bearer-token"
SERVE_AUTH = {"Authorization": f"Bearer {SERVE_TOKEN}"}
SERVE_SCAN_COLUMNS = ["k", "cat", "ts"]
SERVE_SCAN_SHARE = 0.01  # the JSON scan's range: about 1 % of k's values
SERVE_PAGE_LIMIT = 1_000_000
SERVE_SEED_ROWS = 4_096  # the table's first commit, before the daemon boots
SERVE_WRITE_ROWS = 65_536  # a micro-batched ingest service's request
SERVE_WRITES = 4
SERVE_TABLE_KEYS = 1_024  # ids of the last batch looked up after the writes
SERVE_LOAD_THREADS = 4
SERVE_LOAD_REQUESTS = 10  # 50 before phase 5q (the script's time)
SERVE_LOAD_KEYS = 1_024
SERVE_LOAD_BATCHES = 8
SERVE_BULK_THREADS = 2
SERVE_QPS = 5
SERVE_QPS_BURST = 20
SERVE_TIMEOUT_S = 600.0  # a liveness bound of one request


def serve_call(srv, path: str, doc=None, tenant: str = "default",
               headers=None) -> tuple:
    """``(status, body, headers, seconds)`` of one request to the daemon;
    an error status is returned, not raised."""
    import urllib.error
    import urllib.request

    hdrs = {"X-Tenant": tenant}
    hdrs.update(headers or {})
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(srv.url + path, data=data, headers=hdrs)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            out = (r.status, r.read(), dict(r.headers))
    except urllib.error.HTTPError as e:
        with e:
            out = (e.code, e.read(), dict(e.headers))
    return out + (time.perf_counter() - t0,)


def served(srv, path: str, doc, tenant: str, sent: dict, what: str,
           headers=None, phase: str = "5p") -> tuple:
    """A request that must answer 200 (a 500 fails the phase with the
    daemon's error); ``sent`` counts it as its tenant's."""
    status, body, hdrs, secs = serve_call(srv, path, doc, tenant, headers)
    sent[tenant] = sent.get(tenant, 0) + 1
    if status != 200:
        raise AssertionError(f"phase {phase} {what}: {status} "
                             f"{body[:300]!r}")
    return body, hdrs, secs


def _json_scan_lines(files: list, columns) -> bytes:
    """The JSON scan's bytes as the daemon's wire format lays them out: a
    line a file (``{"columns", "num_rows"}``, keys sorted) and the done
    line."""
    out, total = [], 0
    for doc in files:
        n = len(next(iter(doc.values()))) if doc else 0
        out.append((json.dumps({"columns": doc, "num_rows": n},
                               sort_keys=True) + "\n").encode())
        total += n
    out.append((json.dumps({"done": True, "num_rows": total})
                + "\n").encode())
    return b"".join(out)


def _agg_doc(res) -> dict:
    from parquet_tpu_torch.serve.codecs import jsonable

    doc = {"aggregates": {k: jsonable(v) for k, v in res.items()},
           "tiers": {k: v for k, v in res.counters.items() if v}}
    if res.groups is not None:
        doc["groups"] = [jsonable(k) for k in res.groups]
    return doc


def _same_agg(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want) or got["tiers"] != want["tiers"] \
            or got.get("groups") != want.get("groups") \
            or set(got["aggregates"]) != set(want["aggregates"]):
        raise AssertionError(f"phase 5p {what}: {got} != {want}")
    for name, w in want["aggregates"].items():
        g = got["aggregates"][name]
        for a, b in (zip(g, w) if isinstance(w, list) else [(g, w)]):
            _close(a, b, f"phase 5p {what} {name}")


def _write_body(rows: int, seed: int) -> dict:
    """``rows`` rows of phase 4's 5 columns from ``seed`` as the JSON of a
    ``/v1/write`` body (nulls as ``null``)."""
    out = {}
    for name, col in make_table(rows, seed).items():
        vals = np.asarray(col).astype(object)
        vals[np.ma.getmaskarray(col)] = None
        out[name] = vals.tolist()
    return out


def _sorted_rows(cols: dict) -> list:
    """Row tuples of a JSON column dict ordered by (k, id)."""
    names = sorted(cols)
    rows = list(zip(*(cols[n] for n in names)))
    ki, ii = names.index("k"), names.index("id")
    return sorted(rows, key=lambda r: (r[ki], r[ii]))


def _plus(total: dict, launches: dict) -> dict:
    """``total`` with ``launches`` added, kernel by kernel."""
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def _percentile(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def serve_lookups(srv, look_path: str, keys: np.ndarray, sent: dict,
                  card: str) -> dict:
    """Phase 5p(a): the latency tenant's lookup of phase 5's keys in its
    file's first row group, cold then twice warm, each equal to the
    direct ``Dataset.find_rows`` on the card; the bloom probe and the
    dictionary gather launched, the tenant's pages pinned under its cap,
    and a wrong token refused 401."""
    from parquet_tpu_torch.io import cache
    from parquet_tpu_torch.serve.codecs import lookup_to_jsonable

    body = {"dataset": "look", "column": "k",
            "keys": [int(k) for k in keys], "columns": LOOKUP_COLUMNS}
    auth = SERVE_AUTH
    pq.clear_caches()
    pq.reset_launches()
    runs = []
    for i in range(3):
        got, _, secs = served(srv, "/v1/lookup", body, "interactive", sent,
                              "(a) lookup", auth)
        runs.append(secs)
        if i == 0:
            cold = dict(pq.LAUNCHES)
    served_launches = dict(pq.LAUNCHES)
    pinned = cache.PAGES.pinned_bytes("interactive")
    t0 = time.perf_counter()
    with pq.Dataset([look_path]) as ds:
        want = ds.find_rows("k", keys, columns=LOOKUP_COLUMNS,
                            device=DEVICE)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doc = json.loads(got)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_hits = lookup_to_jsonable(want, body["keys"])
    codec_s = time.perf_counter() - t0
    if doc["hits"] != want_hits or doc["rows_total"] != want.rows_total:
        raise AssertionError("phase 5p(a): the served lookup differs from "
                             "the direct find_rows")
    check_launched("phase 5p(a) cold lookup", cold, LOOKUP_KERNELS)
    if not 0 < pinned <= SERVE_PIN:
        raise AssertionError(f"phase 5p(a): {pinned} bytes pinned for a "
                             f"{SERVE_PIN}-byte cap")
    status = serve_call(srv, "/v1/lookup", body, "interactive",
                        {"Authorization": "Bearer wrong"})
    if status[0] != 401 or "Bearer" not in status[2].get(
            "WWW-Authenticate", ""):
        raise AssertionError(f"phase 5p(a): a wrong token got {status[0]}")
    return {"keys": len(keys), "rows_total": want.rows_total,
            "cold_s": runs[0], "warm_s": runs[1:],
            "keys_per_s": len(keys) / min(runs[1:]),
            "cold_keys_per_s": len(keys) / runs[0],
            "direct_warm_s": direct_s, "client_json_decode_s": decode_s,
            "direct_codec_s": codec_s, "response_bytes": len(got),
            "pinned_bytes": pinned, "cold_launches": cold,
            "launches": served_launches}


def serve_scans(srv, events: str, sent: dict) -> dict:
    """Phase 5p(b): the bulk tenant's Arrow scan of three columns of phase
    4's file equal to the direct read's ``to_arrow`` and launching what
    it launches; a JSON scan of about 1 % of ``k`` equal byte for byte to
    the direct ``scan_expr``'s lines; the same scan in pages of
    ``SERVE_PAGE_LIMIT`` rows concatenating to it."""
    import pyarrow as pa

    from parquet_tpu_torch.serve.codecs import columns_to_jsonable

    pq.reset_launches()
    got, _, arrow_s = served(srv, "/v1/scan", {
        "dataset": "events", "format": "arrow",
        "columns": SERVE_SCAN_COLUMNS}, "batch", sent, "(b) arrow scan")
    served_launches = dict(pq.LAUNCHES)
    table = pa.ipc.open_stream(io.BytesIO(got)).read_all().combine_chunks()
    pq.reset_launches()
    t0 = time.perf_counter()
    with pq.ParquetFile(events) as f:
        want = f.read(columns=SERVE_SCAN_COLUMNS, device=DEVICE).to_arrow() \
            .combine_chunks()
    direct_s = time.perf_counter() - t0
    direct_launches = dict(pq.LAUNCHES)
    if not table.equals(want):
        raise AssertionError("phase 5p(b): the served Arrow scan differs "
                             "from the direct read")
    if served_launches != direct_launches:
        raise AssertionError(f"phase 5p(b): the served scan launched "
                             f"{served_launches}, the direct read "
                             f"{direct_launches}")
    check_launched("phase 5p(b) arrow scan", served_launches, READ_KERNELS)
    hi = int(20_000 * SERVE_SCAN_SHARE) - 1
    where = {"col": "k", "ge": 0, "le": hi}
    (body, _, json_s), json_launches = launched(lambda: served(
        srv, "/v1/scan", {"dataset": "events", "where": where}, "batch",
        sent, "(b) json scan"))
    t0 = time.perf_counter()
    with pq.ParquetFile(events) as f:
        rows = pq.scan_expr(f, pq.col("k").between(0, hi), device=DEVICE)
    want_lines = _json_scan_lines([columns_to_jsonable(rows)], None)
    direct_json_s = time.perf_counter() - t0
    if body != want_lines:
        raise AssertionError("phase 5p(b): the served JSON scan differs "
                             "from the direct scan_expr's lines")
    pages, token = [], None
    while True:
        doc = {"dataset": "events", "where": where,
               "limit": SERVE_PAGE_LIMIT}
        if token:
            doc["page_token"] = token
        (page, hdrs, _), got = launched(lambda: served(
            srv, "/v1/scan", doc, "batch", sent, "(b) paged scan"))
        json_launches = _plus(json_launches, got)
        pages.append(page)
        token = hdrs.get("X-Next-Page-Token")
        if not token:
            break
    if b"".join(pages) != body:
        raise AssertionError("phase 5p(b): the pages do not concatenate "
                             "to the unbounded scan")
    n = table.num_rows
    matched = json.loads(body.splitlines()[-1])["num_rows"]
    return {"arrow_rows": n, "arrow_s": arrow_s,
            "arrow_rows_per_s": n / arrow_s, "arrow_bytes": len(got),
            "direct_read_to_arrow_s": direct_s,
            "launches_served": served_launches,
            "launches_direct": direct_launches,
            "json_rows": matched, "json_s": json_s,
            "json_bytes": len(body), "direct_scan_s": direct_json_s,
            "pages": len(pages),
            "launches": _plus(served_launches, json_launches)}


def serve_aggregates(srv, q1: str, sent: dict) -> dict:
    """Phase 5p(c): TPC-H Q1 grouped and ungrouped and phase 5j's
    dictionary-tier query through ``/v1/aggregate``, each equal to
    ``Dataset.aggregate`` on the card."""
    from parquet_tpu_torch.serve.codecs import expr_from_wire, parse_aggs

    where = {"col": "l_shipdate", "le": Q1_DATE}
    queries = {
        "q1_grouped": {"aggs": ["sum:l_quantity", "sum:l_extendedprice",
                                "avg:l_quantity", "avg:l_discount",
                                "count"], "group_by": "l_returnflag",
                       "where": where},
        "q1_filtered": {"aggs": ["count", "sum:l_quantity",
                                 "sum:l_extendedprice", "min:l_discount",
                                 "max:l_discount", "avg:l_extendedprice"],
                        "where": where},
        "dictionary": {"aggs": ["distinct:l_shipmode", "min:l_shipdate",
                                "max:l_shipdate", "var:l_discount",
                                "sum:l_quantity"]},
    }
    out, total = {}, {}
    for name, q in queries.items():
        (body, _, secs), got = launched(lambda q=q, name=name: served(
            srv, "/v1/aggregate", {"dataset": "q1", **q}, "interactive",
            sent, f"(c) {name}", SERVE_AUTH))
        total = _plus(total, got)
        with pq.Dataset([q1]) as ds:
            t0 = time.perf_counter()
            res = ds.aggregate(parse_aggs(q["aggs"]),
                               where=expr_from_wire(q.get("where")),
                               group_by=q.get("group_by"), device=DEVICE)
            direct_s = time.perf_counter() - t0
        _same_agg(json.loads(body), _agg_doc(res), name)
        out[name] = {"served_s": secs, "direct_s": direct_s,
                     "tiers": _agg_doc(res)["tiers"]}
    out["launches"] = total
    check_launched("phase 5p(c)", total, READ_KERNELS)
    return out


def serve_writes(srv, tbl: str, seed_rows: dict, seed: int,
                 sent: dict) -> dict:
    """Phase 5p(d): 4 ingest requests of 65,536 rows of phase 4's columns
    (a micro-batched ingest service), each one committed version; then
    the table's JSON scan holds the seed's part and each request's rows
    in its own part sorted on ``k``, and a lookup of the last batch's ids
    finds them (the snapshot refreshed on commit), equal to the direct
    lookup of a fresh ``open_table``."""
    from parquet_tpu_torch.serve.codecs import lookup_to_jsonable

    bodies, versions, walls = [seed_rows], [], []
    for j in range(SERVE_WRITES):
        rows = _write_body(SERVE_WRITE_ROWS, seed + 100 + j)
        got, _, secs = served(srv, "/v1/write", {"dataset": "tbl",
                                                 "rows": rows},
                              "batch", sent, f"(d) write {j}")
        doc = json.loads(got)
        if doc["rows"] != SERVE_WRITE_ROWS:
            raise AssertionError(f"phase 5p(d): write {j} answered {doc}")
        versions.append(doc["version"])
        walls.append(secs)
        bodies.append(rows)
    if versions != list(range(2, 2 + SERVE_WRITES)):
        raise AssertionError(f"phase 5p(d): committed versions {versions}")
    got, _, scan_s = served(srv, "/v1/scan", {"dataset": "tbl"}, "batch",
                            sent, "(d) table scan")
    lines = [json.loads(x) for x in got.splitlines()]
    parts = [x["columns"] for x in lines[:-1]]
    if len(parts) != len(bodies):
        raise AssertionError(f"phase 5p(d): {len(parts)} parts for "
                             f"{len(bodies)} commits")
    for i, (part, rows) in enumerate(zip(parts, bodies)):
        ks = part["k"]
        if any(a > b for a, b in zip(ks, ks[1:])) or \
                _sorted_rows(part) != _sorted_rows(rows):
            raise AssertionError(f"phase 5p(d): part {i} is not its "
                                 "commit's rows sorted on k")
    ids = [int(x) for x in bodies[-1]["id"][:SERVE_TABLE_KEYS]]
    body = {"dataset": "tbl", "column": "id", "keys": ids,
            "columns": ["k", "cat", "price"]}
    got, _, look_s = served(srv, "/v1/lookup", body, "interactive", sent,
                            "(d) table lookup", SERVE_AUTH)
    served_launches = dict(pq.LAUNCHES)
    with pq.open_table(tbl) as ds:
        want = ds.find_rows("id", ids, columns=["k", "cat", "price"],
                            device=DEVICE)
    doc = json.loads(got)
    if doc["hits"] != lookup_to_jsonable(want, ids) or \
            doc["rows_total"] != len(ids):
        raise AssertionError("phase 5p(d): the last batch's ids are not "
                             "found as the direct lookup finds them")
    n = SERVE_WRITE_ROWS
    return {"versions": versions, "write_s": walls,
            "rows_per_s": n / min(walls), "body_bytes": len(json.dumps(
                {"dataset": "tbl", "rows": bodies[-1]})),
            "table_rows": sum(x["num_rows"] for x in lines[:-1]),
            "scan_s": scan_s, "lookup_s": look_s,
            "launches": served_launches}


def serve_load(srv, events: str, look_path: str, keys: np.ndarray,
               sent: dict) -> dict:
    """Phase 5p(e): 4 threads of the latency tenant's lookups (1,024 keys,
    10 requests a thread) alone, then while 2 threads of the bulk
    tenant's whole-file Arrow scans run: every lookup 200 and equal to its
    direct call, the lookups' p50/p99 both ways; then the metered tenant
    at 20 requests in a row gets 429s with ``Retry-After``."""
    from parquet_tpu_torch.serve.codecs import lookup_to_jsonable

    batches = [[int(k) for k in keys[i * SERVE_LOAD_KEYS:
                                     (i + 1) * SERVE_LOAD_KEYS]]
               for i in range(SERVE_LOAD_BATCHES)]
    with pq.Dataset([look_path]) as ds:
        want = [lookup_to_jsonable(
            ds.find_rows("k", b, columns=LOOKUP_COLUMNS, device=DEVICE), b)
            for b in batches]
    pq.reset_launches()  # from here every launch is a served request's
    auth = SERVE_AUTH
    lock = threading.Lock()

    def lookups(lat: list, errors: list, tid: int):
        try:
            for i in range(SERVE_LOAD_REQUESTS):
                j = (tid * SERVE_LOAD_REQUESTS + i) % len(batches)
                st, body, _, secs = serve_call(
                    srv, "/v1/lookup", {"dataset": "look", "column": "k",
                                        "keys": batches[j],
                                        "columns": LOOKUP_COLUMNS},
                    "interactive", auth)
                with lock:
                    sent["interactive"] = sent.get("interactive", 0) + 1
                if st != 200 or json.loads(body)["hits"] != want[j]:
                    raise AssertionError(f"phase 5p(e): lookup {j} "
                                         f"answered {st}")
                lat.append(secs)
        except BaseException as e:
            errors.append(e)

    def run_lookups() -> tuple:
        lat, errors = [], []
        ts = [threading.Thread(target=lookups, args=(lat, errors, t),
                               name=f"smoke-serve-lookup-{t}")
              for t in range(SERVE_LOAD_THREADS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return lat, wall

    alone, alone_wall = run_lookups()
    stop = threading.Event()
    bulk_errors, bulk_rows, bulk_s = [], [], []

    def bulk():
        try:
            while not stop.is_set():
                st, body, _, secs = serve_call(
                    srv, "/v1/scan", {"dataset": "events", "format": "arrow",
                                      "columns": SERVE_SCAN_COLUMNS},
                    "batch")
                with lock:
                    sent["batch"] = sent.get("batch", 0) + 1
                if st != 200:
                    raise AssertionError(f"phase 5p(e): bulk scan {st}")
                bulk_rows.append(len(body))
                bulk_s.append(secs)
        except BaseException as e:
            bulk_errors.append(e)

    bts = [threading.Thread(target=bulk, name=f"smoke-serve-bulk-{i}")
           for i in range(SERVE_BULK_THREADS)]
    for t in bts:
        t.start()
    try:
        mixed, mixed_wall = run_lookups()
    finally:
        stop.set()
        for t in bts:
            t.join()
    if bulk_errors:
        raise bulk_errors[0]
    if not bulk_s:
        raise AssertionError("phase 5p(e): no bulk scan finished")
    # the metered tenant over its QPS contract
    codes, retry = [], []
    for _ in range(SERVE_QPS_BURST):
        st, _, hdrs, _ = serve_call(srv, "/v1/lookup", {
            "dataset": "look", "column": "k", "keys": [0]}, "metered")
        codes.append(st)
        if st == 429:
            retry.append(hdrs.get("Retry-After"))
        elif st == 200:
            sent["metered"] = sent.get("metered", 0) + 1
    if 429 not in codes or None in retry or set(codes) - {200, 429}:
        raise AssertionError(f"phase 5p(e): the metered tenant got {codes}")
    n = SERVE_LOAD_THREADS * SERVE_LOAD_REQUESTS
    return {"lookups": n, "keys_per_lookup": SERVE_LOAD_KEYS,
            "alone": {"p50_s": _percentile(alone, 50),
                      "p99_s": _percentile(alone, 99), "wall_s": alone_wall,
                      "keys_per_s": n * SERVE_LOAD_KEYS / alone_wall},
            "with_bulk": {"p50_s": _percentile(mixed, 50),
                          "p99_s": _percentile(mixed, 99),
                          "wall_s": mixed_wall,
                          "keys_per_s": n * SERVE_LOAD_KEYS / mixed_wall},
            "bulk_scans": len(bulk_s), "bulk_scan_s": bulk_s,
            "bulk_bytes": sum(bulk_rows),
            "metered_codes": codes, "metered_429": codes.count(429),
            "retry_after": sorted(set(retry)),
            "launches": dict(pq.LAUNCHES)}


def serve_pressure(srv, keys: np.ndarray, sent: dict) -> dict:
    """Phase 5p(f): the hard watermark set under the ledger's total (under
    the pinned bytes, which no reclaim frees): ``/healthz`` reads
    ``hard``, a bulk scan is shed 429 with ``Retry-After`` and a latency
    lookup of pinned pages answers 200, equal to its answer before; the
    knob restored, ``/healthz`` reads ``ok``."""
    from parquet_tpu_torch import obs
    from parquet_tpu_torch.io import cache

    auth = SERVE_AUTH
    body = {"dataset": "look", "column": "k",
            "keys": [int(k) for k in keys[:SERVE_LOAD_KEYS]],
            "columns": LOOKUP_COLUMNS}
    before, _, _ = served(srv, "/v1/lookup", body, "interactive", sent,
                          "(f) lookup before", auth)
    total = obs.ledger_snapshot()["total_bytes"]
    pinned = cache.PAGES.pinned_bytes()
    hard = min(total, pinned) // 2
    if hard <= 0:
        raise AssertionError(f"phase 5p(f): nothing pinned ({pinned})")
    with knobs(PARQUET_TPU_TORCH_MEM_HARD=str(hard)):
        health = serve_call(srv, "/healthz")[1]
        st, _, hdrs, shed_s = serve_call(srv, "/v1/scan", {
            "dataset": "events", "format": "arrow",
            "columns": SERVE_SCAN_COLUMNS}, "batch")
        got, _, look_s = served(srv, "/v1/lookup", body, "interactive",
                                sent, "(f) lookup under pressure", auth)
    after = serve_call(srv, "/healthz")[1]
    if health != b"hard\n" or after != b"ok\n":
        raise AssertionError(f"phase 5p(f): /healthz {health!r} then "
                             f"{after!r}")
    if st != 429 or not hdrs.get("Retry-After"):
        raise AssertionError(f"phase 5p(f): the bulk scan got {st}")
    if got != before:
        raise AssertionError("phase 5p(f): the lookup under pressure "
                             "differs")
    return {"ledger_total": total, "pinned": pinned, "hard": hard,
            "shed_status": st, "retry_after": hdrs.get("Retry-After"),
            "shed_s": shed_s, "lookup_under_pressure_s": look_s,
            "launches": dict(pq.LAUNCHES)}


def serve_scrape(srv, sent: dict, shed: dict) -> dict:
    """Phase 5p(g): ``/metrics``: each class's ``serve.requests`` is the
    sum of its tenants'; ``/debugz``'s tenants section counts the
    requests and sheds this phase sent."""
    text = serve_call(srv, "/metrics")[1].decode()
    dz = json.loads(serve_call(srv, "/debugz")[1])
    by_class, by_tenant = {}, {}
    pat = re.compile(r'^parquet_tpu_serve_requests_total\{(.*)\} (\S+)$')
    for line in text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        labels = dict(kv.split("=", 1) for kv in m.group(1).split(","))
        labels = {k: v.strip('"') for k, v in labels.items()}
        v = float(m.group(2))
        if "tenant" in labels:
            by_tenant.setdefault(labels["class"], {})[labels["tenant"]] = v
        else:
            by_class[labels["class"]] = v
    for klass, v in by_class.items():
        if sum(by_tenant.get(klass, {}).values()) != v:
            raise AssertionError(f"phase 5p(g): serve.requests of {klass} "
                                 f"{v} != its tenants' {by_tenant}")
    tenants = dz.get("tenants", {})
    got = {t: tenants.get(t, {}).get("requests", 0) for t in sent}
    got_shed = {t: tenants.get(t, {}).get("shed", 0) for t in shed}
    if got != sent or got_shed != shed:
        raise AssertionError(f"phase 5p(g): /debugz counts {got} and sheds "
                             f"{got_shed}, the phase sent {sent} and saw "
                             f"{shed} shed")
    return {"requests_by_class": by_class, "by_tenant": by_tenant,
            "debugz_tenants": tenants, "launches": dict(pq.LAUNCHES)}


def serve_path(card: str, read: dict, look_path: str, lookup_rows: int,
               q1: str, seed: int, tmp: str) -> dict:
    """Phase 5p: the serving daemon on the card, each check fatal
    (:func:`serve_lookups`, :func:`serve_scans`, :func:`serve_aggregates`,
    :func:`serve_writes`, :func:`serve_load`, :func:`serve_pressure`,
    :func:`serve_scrape`), then ``close()`` drains and leaves no thread,
    pin or tenant.  One ``{"serve": ...}`` line."""
    import pyarrow as pa

    from parquet_tpu_torch.io import cache
    from parquet_tpu_torch.utils import pool

    keys = make_keys(lookup_rows, seed)
    keys = keys[keys < 2 * (ROW_GROUP // 4)][:OBS_LOOKUP_KEYS]
    tbl = os.path.join(tmp, "served_table")
    schema = pq.ParquetFile(read["path"]).schema
    seed_rows = _write_body(SERVE_SEED_ROWS, seed + 99)
    w = pq.DatasetWriter(tbl, schema, sorting=[pq.SortingColumn("k")])
    w.write_arrow(pa.table(seed_rows))
    w.commit()
    w.close()
    config = {
        "datasets": {"events": {"paths": [read["path"]]},
                     "look": {"paths": [look_path]},
                     "q1": {"paths": [q1]},
                     "tbl": {"table": tbl, "writable": True,
                             "sorting": "k"}},
        "tenants": {
            "interactive": {"class": "latency", "weight": 4,
                            "pin_bytes": SERVE_PIN, "token": SERVE_TOKEN},
            "batch": {"class": "bulk", "budget_bytes": SERVE_BATCH_BUDGET},
            "metered": {"qps": SERVE_QPS, "burst": SERVE_QPS}}}
    before = set(threading.enumerate())
    launches = dict.fromkeys(pq.LAUNCHES, 0)
    sent: dict = {}
    out = {"card": card}
    t0 = time.perf_counter()
    srv = pq.Server(config, port=0, device=DEVICE)
    out["boot_s"] = time.perf_counter() - t0
    try:
        for name, run in (
                ("a_lookup", lambda: serve_lookups(srv, look_path, keys,
                                                   sent, card)),
                ("b_scan", lambda: serve_scans(srv, read["path"], sent)),
                ("c_aggregate", lambda: serve_aggregates(srv, q1, sent)),
                ("d_write", lambda: serve_writes(srv, tbl, seed_rows, seed,
                                                 sent)),
                ("e_load", lambda: serve_load(srv, read["path"], look_path,
                                              keys, sent)),
                ("f_pressure", lambda: serve_pressure(srv, keys, sent)),
                ("g_scrape", lambda: serve_scrape(
                    srv, sent, {"batch": 1, "metered": out["e_load"][
                        "metered_429"]}))):
            t1 = time.perf_counter()
            try:
                pq.reset_launches()
                got = run()
            except BaseException:
                log({"serve": out, "failed_in": name})
                raise
            got["phase_s"] = time.perf_counter() - t1
            for k, v in got["launches"].items():
                launches[k] += v
            out[name] = got
    finally:
        t1 = time.perf_counter()
        drained = srv.close()
        out["close_s"] = time.perf_counter() - t1
    left = threads_started(before)
    if not drained or left or cache.PAGES.pinned_bytes() \
            or pool.read_admission().tenant_debug():
        raise AssertionError(f"phase 5p: close drained {drained}, threads "
                             f"{left}, pinned {cache.PAGES.pinned_bytes()}, "
                             f"tenants "
                             f"{pool.read_admission().tenant_debug()}")
    check_launched("phase 5p", launches, READ_KERNELS + ("bloom_check",))
    out["launches"] = launches
    out["requests"] = sent
    log({"serve": out})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 5q: the serving fleet on the card
# ---------------------------------------------------------------------------

FLEET_NAMES = ("n1", "n2", "n3")
FLEET_ROWS = 1 << 22  # half of phase 4b's lineitem rows
FLEET_COMMIT_ROWS = 1 << 20  # a commit: one slice of the sorted keys
FLEET_PARTITIONS = 4  # key partitions a commit, one part file each
FLEET_ROW_GROUP = 1 << 19
FLEET_LOOKUP_KEYS = 65_536
# (a'): keys inside the first commit's key range, so that every member's
# share (at least 29 % of them on this ring) is one bloom batch of at
# least SplitBlockFilter._DEVICE_PROBE_MIN hashes a row group
FLEET_PROBE_KEYS = 131_072
FLEET_LOOKUP_COLUMNS = ["l_quantity", "l_extendedprice", "l_shipmode"]
FLEET_SCAN_WHERE = {"col": "l_shipdate", "ge": 9000, "le": 9039}  # ~1 %
FLEET_SCAN_COLUMNS = ["l_orderkey", "l_quantity", "l_extendedprice",
                      "l_shipmode"]
FLEET_WRITE_ROWS = 8_192  # an ingest request of (e)
FLEET_WRITES = 4  # (e): two a writing member, all at once
FLEET_RTOL = AGG_RTOL  # float sums of shard states add in another order
# no hedge and no leg timed out: each leg's wall is the peer's own, and a
# fallback is the chaos check's alone
FLEET_KNOBS = {"PARQUET_TPU_TORCH_FLEET_HEDGE_S": "0",
               "PARQUET_TPU_TORCH_FLEET_PEER_TIMEOUT_S":
               str(SERVE_TIMEOUT_S)}


def fleet_counters() -> dict:
    snap = pq.metrics_snapshot()["counters"]
    return {k: snap.get(k, 0) for k in (
        "fleet.forwards", "fleet.gathers", "fleet.peer_errors",
        "fleet.local_fallbacks", "fleet.hedges_issued", "fleet.hedges_won",
        "fleet.peer_skips", "fleet.cas_commits", "fleet.cas_conflicts",
        "read.files_skipped")}


def fleet_table(tbl: str, seed: int) -> dict:
    """Phase 5q's table: lineitem rows in commits of
    :data:`FLEET_COMMIT_ROWS` through ``DatasetWriter(partition_on=
    "l_orderkey")``, each commit's slice spread over
    :data:`FLEET_PARTITIONS` part files by the splitmix64 hash of its key
    (the ring's key hash), with a bloom filter on the key; commits go on
    past :data:`FLEET_ROWS` until ``ring.spread`` gives every member a
    part (the part names are random)."""
    from parquet_tpu_torch.serve.cluster import HashRing

    schema, data = make_lineitem(FLEET_ROWS, seed + 61)
    ring = HashRing(FLEET_NAMES)
    w = pq.DatasetWriter(tbl, schema, options=pq.WriterOptions(
        compression="snappy", row_group_size=FLEET_ROW_GROUP,
        bloom_filters={"l_orderkey": 10}),
        rows_per_file=FLEET_COMMIT_ROWS, partition_on="l_orderkey",
        num_partitions=FLEET_PARTITIONS)
    commits, t0 = [], time.perf_counter()
    i = 0
    while True:
        a = (i * FLEET_COMMIT_ROWS) % FLEET_ROWS
        part = {k: column_slice(cd, a, a + FLEET_COMMIT_ROWS)
                for k, cd in data.items()}
        t1 = time.perf_counter()
        w.write(part, FLEET_COMMIT_ROWS)
        m = w.commit()
        commits.append(time.perf_counter() - t1)
        i += 1
        owners = ring.spread([os.path.abspath(os.path.join(tbl, f.name))
                              for f in m.files])
        if i * FLEET_COMMIT_ROWS >= FLEET_ROWS and \
                set(owners) == set(FLEET_NAMES):
            break
    w.close()
    m = pq.read_manifest(tbl)
    if m.num_rows != i * FLEET_COMMIT_ROWS or temp_files(tbl):
        raise AssertionError(f"phase 5q table: {m.num_rows} rows")
    return {"rows": m.num_rows, "commits": i, "parts": len(m.files),
            "parts_by_member": {k: len(v) for k, v in owners.items()},
            "commit_s": commits, "write_s": time.perf_counter() - t0,
            "keys": data["l_orderkey"].values}


def fleet_requests(table: dict, seed: int) -> dict:
    """The requests phase 5q sends to the single node and to the fleet."""
    keys = table["keys"]
    rng = np.random.default_rng(seed + 67)
    look = rng.choice(np.unique(keys), FLEET_LOOKUP_KEYS, replace=False)
    first = np.unique(keys[:FLEET_COMMIT_ROWS])
    probe = rng.choice(first, FLEET_PROBE_KEYS, replace=False)
    where = {"col": "l_shipdate", "le": Q1_DATE}
    return {
        "a_lookup": ("/v1/lookup", {
            "dataset": "li", "column": "l_orderkey",
            "keys": [int(k) for k in look], "columns": FLEET_LOOKUP_COLUMNS},
            "interactive"),
        "a_probe_lookup": ("/v1/lookup", {
            "dataset": "li", "column": "l_orderkey",
            "keys": [int(k) for k in probe],
            "columns": FLEET_LOOKUP_COLUMNS}, "interactive"),
        "b_json_scan": ("/v1/scan", {
            "dataset": "li", "where": FLEET_SCAN_WHERE,
            "columns": FLEET_SCAN_COLUMNS}, "batch"),
        "b_arrow_scan": ("/v1/scan", {
            "dataset": "li", "where": FLEET_SCAN_WHERE,
            "columns": FLEET_SCAN_COLUMNS, "format": "arrow"}, "batch"),
        "c_q1": ("/v1/aggregate", {
            "dataset": "li", "aggs": ["sum:l_quantity",
                                      "sum:l_extendedprice",
                                      "avg:l_quantity", "avg:l_discount",
                                      "count"],
            "group_by": "l_returnflag", "where": where}, "interactive"),
    }


def fleet_same(name: str, got: bytes, want: bytes) -> None:
    """A fleet answer against the single node's: JSON scans and lookups
    byte for byte, Arrow scans as tables, aggregates under
    :data:`FLEET_RTOL` (the groups and integer sums exactly)."""
    import pyarrow as pa

    if name.startswith("c_"):
        g, w = json.loads(got), json.loads(want)
        if g.get("groups") != w.get("groups") or \
                set(g["aggregates"]) != set(w["aggregates"]):
            raise AssertionError(f"phase 5q {name}: {g} != {w}")
        for agg, wv in w["aggregates"].items():
            for a, b in zip(g["aggregates"][agg], wv):
                if isinstance(b, int) and not isinstance(b, bool):
                    if a != b:
                        raise AssertionError(f"phase 5q {name} {agg}: "
                                             f"{a} != {b}")
                else:
                    _close(a, b, f"phase 5q {name} {agg}")
    elif name == "b_arrow_scan":
        g = pa.ipc.open_stream(io.BytesIO(got)).read_all()
        w = pa.ipc.open_stream(io.BytesIO(want)).read_all()
        if not g.equals(w) or g.num_rows == 0:
            raise AssertionError(f"phase 5q {name}: the fleet's Arrow scan "
                                 f"({g.num_rows} rows) differs")
    elif got != want:
        raise AssertionError(f"phase 5q {name}: the fleet's answer "
                             f"({len(got)} bytes) differs from the single "
                             f"node's ({len(want)} bytes)")


def fleet_config(tbl: str, wtbl: str, name: Optional[str]) -> dict:
    cfg = {"datasets": {"li": {"table": tbl},
                        "wtbl": {"table": wtbl, "writable": True}},
           "tenants": {"interactive": {"class": "latency",
                                       "pin_bytes": SERVE_PIN},
                       "batch": {"class": "bulk",
                                 "budget_bytes": SERVE_BATCH_BUDGET}}}
    if name is not None:
        cfg["cluster"] = {"self": name,
                          "peers": {n: None for n in FLEET_NAMES}}
    return cfg


def fleet_chaos(servers: dict, want: bytes, req: tuple) -> dict:
    """Phase 5q(d): a member other than the coordinator with a shard is
    chaos-killed mid-scan (one more sub-request allowed, then partitioned,
    and its daemon closed with no drain): the JSON scan stays byte for
    byte the single node's and ``fleet.local_fallbacks`` moves; then with
    the victim's files hidden an ``exact`` scan is a 5xx."""
    from parquet_tpu_torch.io import faults

    coord = servers["n1"]
    paths = coord.dataset("li").paths
    owners = coord.fleet.ring.spread(list(paths))
    victim = next(nm for nm in FLEET_NAMES if nm != "n1" and owners.get(nm))
    path, doc, tenant = req
    chaos = faults.PeerChaos()
    faults.set_peer_chaos(chaos)
    out = {"victim": victim, "victim_files": len(owners[victim])}
    try:
        chaos.kill_after(victim, 1)
        servers[victim].chaos_kill()
        before = fleet_counters()
        (got, _, secs), launches = launched(lambda: served(
            coord, path, doc, tenant, {}, "(d) scan after the kill",
            phase="5q"))
        moved = {k: v - before[k] for k, v in fleet_counters().items()}
        if got != want:
            raise AssertionError("phase 5q(d): the scan after the kill "
                                 "differs from the single node's")
        if moved["fleet.local_fallbacks"] < 1 or moved["fleet.peer_skips"]:
            raise AssertionError(f"phase 5q(d): counters moved {moved}")
        out.update(scan_s=secs, counters=moved, launches=launches,
                   trips=len(chaos.trips))
        hidden = []
        try:
            for p in owners[victim]:
                os.rename(p, p + ".hidden")
                hidden.append(p)
            pq.clear_caches()
            st, body, _, exact_s = serve_call(coord, path,
                                              dict(doc, exact=True), tenant)
        finally:
            for p in hidden:
                os.rename(p + ".hidden", p)
        if st < 500:
            raise AssertionError(f"phase 5q(d): exact with an unservable "
                                 f"shard answered {st}")
        out.update(exact_status=st, exact_s=exact_s)
    finally:
        faults.set_peer_chaos(None)
    return out


def fleet_writes(servers: dict, wtbl: str, seed: int) -> dict:
    """Phase 5q(e): the two live members each take two ingest requests
    of :data:`FLEET_WRITE_ROWS` rows, all four at once: the table's
    version advances by exactly four (one arbitrated commit a request),
    every row lands, and ``fleet.cas_commits`` moves."""
    live = [nm for nm, s in servers.items() if not s._closed]
    v0 = pq.read_manifest(wtbl).version
    rng = np.random.default_rng(seed + 71)
    bodies = [{"dataset": "wtbl", "rows": {
        "k": [int(x) for x in rng.integers(0, 1 << 40, FLEET_WRITE_ROWS)],
        "v": [float(x) for x in rng.random(FLEET_WRITE_ROWS)]}}
        for _ in range(FLEET_WRITES)]
    before = fleet_counters()
    results, errors = [None] * FLEET_WRITES, []

    def write(i: int):
        try:
            results[i] = served(servers[live[i % len(live)]], "/v1/write",
                                bodies[i], "batch", {}, f"(e) write {i}",
                                phase="5q")
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=write, args=(i,), name=f"smoke-fleet-w{i}")
          for i in range(FLEET_WRITES)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    launches = dict(pq.LAUNCHES)  # the members' own, before the check's read
    if errors:
        raise errors[0]
    moved = {k: v - before[k] for k, v in fleet_counters().items()}
    versions = sorted(json.loads(r[0])["version"] for r in results)
    with pq.open_table(wtbl) as ds:
        got = ds.read(columns=["k"], device=DEVICE).to_arrow()["k"] \
            .to_pylist()
    want = [k for b in bodies for k in b["rows"]["k"]]
    if versions != list(range(v0 + 1, v0 + 1 + FLEET_WRITES)) or \
            pq.read_manifest(wtbl).version != v0 + FLEET_WRITES:
        raise AssertionError(f"phase 5q(e): versions {versions} from v{v0}")
    if sorted(got) != sorted([0] + want) or \
            moved["fleet.cas_commits"] < FLEET_WRITES:
        raise AssertionError(f"phase 5q(e): {len(got)} rows, counters "
                             f"{moved}")
    return {"members": live, "writes": FLEET_WRITES,
            "rows_a_write": FLEET_WRITE_ROWS, "versions": versions,
            "wall_s": wall, "write_s": [r[2] for r in results],
            "counters": moved, "launches": launches}


def fleet_path(card: str, seed: int, tmp: str) -> dict:
    """Phase 5q: three fleet members (``Server(config, port=0)`` on the
    card, in this process, on loopback) over a key-partitioned lineitem
    table (:func:`fleet_table`), against a single node over the same
    table: (a) scatter lookups equal byte for byte to the single node's;
    (b) a filtered JSON scan byte for byte and its Arrow scan by
    ``Table.equals``; (c) TPC-H Q1 grouped under :data:`FLEET_RTOL`; (d)
    a member chaos-killed mid-scan (:func:`fleet_chaos`); (e) two members
    ingesting one table (:func:`fleet_writes`); (f) ``/debugz``'s fleet
    section, and no thread, pin or tenant left after the members close.
    Each fleet answer's wall beside the single node's for the same
    request, and each kernel's launches on the members' legs.  One
    ``{"fleet": ...}`` line."""
    import pyarrow as pa

    from parquet_tpu_torch.io import cache
    from parquet_tpu_torch.utils import pool

    tbl = os.path.join(tmp, "fleet_table")
    wtbl = os.path.join(tmp, "fleet_ingest")
    table = fleet_table(tbl, seed)
    keys = table.pop("keys")
    w = pq.DatasetWriter(wtbl, pq.schema_from_arrow(pa.schema(
        [("k", pa.int64()), ("v", pa.float64())])))
    w.write_arrow(pa.table({"k": [0], "v": [0.0]}))
    w.commit()
    w.close()
    reqs = fleet_requests({"keys": keys}, seed)
    del keys
    out = {"card": card, "table": table, "checks": {}}
    before = set(threading.enumerate())
    launches = dict.fromkeys(pq.LAUNCHES, 0)
    want = {}
    with knobs(**FLEET_KNOBS):
        t0 = time.perf_counter()
        with pq.Server(fleet_config(tbl, wtbl, None), port=0,
                       device=DEVICE) as solo:
            for name, (path, doc, tenant) in reqs.items():
                pq.clear_caches()
                (body, _, secs), got = launched(lambda: served(
                    solo, path, doc, tenant, {}, f"single node {name}",
                    phase="5q"))
                want[name] = body
                out["checks"][name] = {"single_s": secs,
                                       "single_launches": got,
                                       "bytes": len(body)}
        out["single_node_s"] = time.perf_counter() - t0
        servers = {}
        try:
            t0 = time.perf_counter()
            for nm in FLEET_NAMES:
                servers[nm] = pq.Server(fleet_config(tbl, wtbl, nm), port=0,
                                        device=DEVICE)
            urls = {nm: s.url for nm, s in servers.items()}
            for s in servers.values():
                s.set_peers(urls)
            out["boot_s"] = time.perf_counter() - t0
            coord = servers["n1"]
            dz = json.loads(serve_call(coord, "/debugz")[1])
            if set(dz.get("fleet", {}).get("peers", {})) != \
                    set(FLEET_NAMES) or "tenants" not in dz:
                raise AssertionError(f"phase 5q(f): /debugz {dz.get('fleet')}")
            out["debugz_fleet"] = dz["fleet"]
            for name, (path, doc, tenant) in reqs.items():
                pq.clear_caches()
                before_c = fleet_counters()
                pq.reset_launches()
                body, _, secs = served(coord, path, doc, tenant, {},
                                       f"fleet {name}", phase="5q")
                got = dict(pq.LAUNCHES)
                moved = {k: v - before_c[k]
                         for k, v in fleet_counters().items()}
                fleet_same(name, body, want[name])
                if moved["fleet.gathers"] != 1 or \
                        moved["fleet.forwards"] < 2 or \
                        moved["fleet.local_fallbacks"] or \
                        moved["fleet.hedges_issued"]:
                    raise AssertionError(f"phase 5q {name}: counters "
                                         f"{moved}")
                out["checks"][name].update(fleet_s=secs, counters=moved,
                                           launches=got)
                launches = _plus(launches, got)
            check_launched("phase 5q(a') probe lookup",
                           out["checks"]["a_probe_lookup"]["launches"],
                           ("bloom_check",))
            pq.reset_launches()
            t0 = time.perf_counter()
            out["d_chaos"] = fleet_chaos(servers, want["b_json_scan"],
                                         reqs["b_json_scan"])
            out["d_chaos"]["phase_s"] = time.perf_counter() - t0
            launches = _plus(launches, dict(pq.LAUNCHES))
            pq.reset_launches()
            out["e_writes"] = fleet_writes(servers, wtbl, seed)
            launches = _plus(launches, out["e_writes"]["launches"])
        finally:
            t0 = time.perf_counter()
            drained = [s.close() for s in reversed(list(servers.values()))]
            out["close_s"] = time.perf_counter() - t0
    left = threads_started(before)
    if not all(drained) or left or cache.PAGES.pinned_bytes() \
            or pool.read_admission().tenant_debug() \
            or "fleet" in pq.debugz_snapshot():
        raise AssertionError(f"phase 5q(f): close drained {drained}, "
                             f"threads {left}, pinned "
                             f"{cache.PAGES.pinned_bytes()}, tenants "
                             f"{pool.read_admission().tenant_debug()}")
    check_launched("phase 5q", launches, READ_KERNELS + ("bloom_check",))
    out["launches"] = launches
    log({"fleet": out})
    return {"launches": launches}


def _codes_of(cd, words) -> np.ndarray:
    """Each row's index in ``words`` of a byte-array column built from
    them (by the first byte, which tells these words apart, else by the
    whole value)."""
    firsts = [w.encode()[:1] for w in words]
    starts = cd.values[cd.offsets[:-1]]
    if len(set(firsts)) == len(words):
        table = np.full(256, -1, np.int64)
        for i, b in enumerate(firsts):
            table[b[0]] = i
        return table[starts]
    lens = np.diff(cd.offsets)
    key = starts.astype(np.int64) * 1000 + lens
    out = np.full(len(starts), -1, np.int64)
    for i, w in enumerate(words):
        b = w.encode()
        out[key == b[0] * 1000 + len(b)] = i
    return out


# ---------------------------------------------------------------------------
# phase 5b: the device scan
# ---------------------------------------------------------------------------

SCAN_ROW_GROUPS = 8  # bench.py:_cfg5: n // 8 rows a row group
SCAN_PAGE = 1 << 17  # bench.py:_cfg5's 128 KiB pages
SCAN_RANGE = (9000, 9200)  # bench.py:_cfg5's ~5 %
SCAN_IN_DATES = 64
# days of case A without a shipment: the IN-list's probes that fall inside
# a row group's statistics range but not in its data, so that only the
# bloom filter can prune that row group
SCAN_HOLES = 16
SCAN_HOLE_FROM = 10_000  # the holes lie in 10000-11998, the other probes below
Q6_DATES = (8766, 9130)  # TPC-H Q6: l_shipdate in 1994
Q6_COLUMNS = ["l_extendedprice", "l_discount", "l_quantity", "l_returnflag",
              "l_comment"]
Q12_MODES = ["MAIL", "SHIP"]  # TPC-H Q12's l_shipmode IN-list
Q12_COLUMNS = ["l_orderkey", "l_shipdate", "l_commitdate", "l_receiptdate"]
LOOKUP_SCAN_SHARE = 0.01  # case C: a range of about 1 % of the rows
SCAN_OPS = ("range_mask", "in_mask", "compact_targets", "compact_prefix")


def scan_holes(seed: int) -> np.ndarray:
    """The ship dates case A's data lacks: :data:`SCAN_HOLES` even days
    from :data:`SCAN_HOLE_FROM` on."""
    rng = np.random.default_rng(seed + 19)
    return np.sort(rng.choice(np.arange(SCAN_HOLE_FROM, 12000, 2),
                              SCAN_HOLES, replace=False)).astype(np.int32)


def make_cfg5(rows: int, seed: int) -> dict:
    """``bench.py:_cfg5``'s mini lineitem from ``seed``: sorted ship dates
    (8000-12000; the days of :func:`scan_holes` moved to the day after,
    which keeps them sorted), order keys, quantities and prices."""
    rng = np.random.default_rng(seed + 17)
    ship = np.sort(rng.integers(8000, 12000, rows)).astype(np.int32)
    ship[np.isin(ship, scan_holes(seed))] += 1
    return {
        "l_shipdate": ship,
        "l_orderkey": np.arange(rows, dtype=np.int64),
        "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
        "l_extendedprice": rng.random(rows) * 1e5}


def scan_in_dates(seed: int) -> list:
    """Case A's IN-list: days below :data:`SCAN_HOLE_FROM` (each in the
    data) and every hole, so the row groups past that day hold only absent
    probes."""
    rng = np.random.default_rng(seed + 18)
    present = rng.choice(np.arange(8000, SCAN_HOLE_FROM),
                         SCAN_IN_DATES - SCAN_HOLES, replace=False)
    return sorted(int(d) for d in np.concatenate([present,
                                                  scan_holes(seed)]))


def check_scan_plan(path: str, key: str, values: list) -> dict:
    """The planner's bloom stage on the card, at case A's IN-list: the
    card's plan equal to the CPU planner's (decisions, counters, candidate
    rows), at least one row group pruned by the bloom filter alone, and
    the stage's one ``bloom_check_segments`` call held bit for bit against
    its plain version and the host probe at the operands the planner gave
    it.  Returns those operands and the plan's numbers."""
    from parquet_tpu_torch.algebra.expr import single_pred
    from parquet_tpu_torch.io.planner import ScanPlanner

    seen = []
    real = bloom.check_hashes_multi

    def spy(filters, batches, device="cuda"):
        seen.append((list(filters), [np.asarray(b) for b in batches]))
        return real(filters, batches, device)

    expr = single_pred(key, values=values)
    bloom.check_hashes_multi = spy
    try:
        card = ScanPlanner(pq.ParquetFile(path), device=DEVICE).plan(expr)
    finally:
        bloom.check_hashes_multi = real
    cpu = ScanPlanner(pq.ParquetFile(path), device="cpu").plan(expr)

    def decided(p):
        return [(d.rg_index, d.pruned_by, d.killer, d.ranges, d.page_sel)
                for d in p.decisions]

    if (decided(card) != decided(cpu) or card.counters != cpu.counters
            or card.candidate_rows != cpu.candidate_rows):
        raise AssertionError("scan plan: the card's plan differs from the "
                             f"CPU's: {card.explain()}\n{cpu.explain()}")
    if not card.counters["rg_pruned_bloom"]:
        raise AssertionError("scan plan: the bloom stage pruned no row "
                             f"group: {card.explain()}")
    if len(seen) != 1:
        raise AssertionError(f"scan plan: {len(seen)} bloom probes, not 1")
    filters, batches = seen[0]
    blocks, h, starts = segmented_probe(filters, batches)
    check_segmented(filters, batches, blocks, h, starts,
                    "at the scan planner's shape")
    return {"probe": (filters, batches), "counters": card.counters,
            "candidate_rows": card.candidate_rows,
            "rows": sum(d.num_rows for d in card.decisions)}


def rows_equal(cd: ColumnData, word: bytes) -> np.ndarray:
    """Rows of a byte-array column equal to ``word``."""
    offs = np.asarray(cd.offsets, np.int64)
    starts, lens = offs[:-1], np.diff(offs)
    hit = lens == len(word)
    vals = np.asarray(cd.values)
    for j, b in enumerate(word):
        at = np.minimum(starts + j, len(vals) - 1)
        hit &= vals[at] == b
    return hit


def oracle(table: dict, mask: np.ndarray) -> dict:
    """The rows of ``mask`` of each generated column, in file order, as
    the scan gives them: numbers with 0 at a null and the validity (None
    without nulls), byte arrays as a ``(values, offsets)`` pair."""
    rows = np.flatnonzero(mask)
    out = {}
    for name, col in table.items():
        if isinstance(col, ColumnData):
            out[name] = (gather_byte_arrays(col.values, col.offsets, rows),
                         None)
        elif isinstance(col, np.ma.MaskedArray):
            valid = ~np.ma.getmaskarray(col)[rows]
            out[name] = (np.where(valid, np.ma.getdata(col)[rows], 0).astype(
                col.dtype), valid)
        else:
            out[name] = (np.asarray(col)[rows], None)
    return out


def scan_form_host(form) -> tuple:
    """A scan column's form -> ``(values or (values, offsets), validity
    or None)`` on the host."""
    valid = None
    if isinstance(form, tuple) and len(form) == 2 and isinstance(
            form[1], (torch.Tensor, np.ndarray)) and form[1].dtype in (
                torch.bool, np.bool_):
        form, valid = form
        valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) \
            else valid
    if isinstance(form, tuple) and isinstance(form[0], tuple):
        (dv, do), idx = form
        vals = gather_byte_arrays(dv.cpu().numpy(), do.cpu().numpy(),
                                  idx.cpu().numpy())
    elif isinstance(form, tuple):
        vals = (np.asarray(form[0]), np.asarray(form[1], np.int64))
    else:
        vals = form.cpu().numpy()
    return vals, valid


def check_scan(out: dict, want: dict, what: str) -> None:
    """Every column of a scan equal to the oracle, bit for bit, with its
    validity (strings compared on the host)."""
    for name, (wv, wvalid) in want.items():
        gv, gvalid = scan_form_host(out[name])
        if (gvalid is None) != (wvalid is None) or (
                gvalid is not None and not np.array_equal(gvalid, wvalid)):
            raise AssertionError(f"{what}: {name}'s validity differs")
        if isinstance(wv, tuple):
            same = (np.array_equal(gv[0], wv[0])
                    and np.array_equal(gv[1], wv[1]))
        else:
            same = (gv.dtype == wv.dtype and gv.shape == wv.shape
                    and np.array_equal(gv.view(np.uint8), wv.view(np.uint8)))
        if not same:
            raise AssertionError(f"{what}: {name} differs from the oracle")


def timed_scan(state) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pq.decoded_scan(state)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def count_syncs(fn) -> dict:
    """The synchronizing CUDA calls ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: their count
    and, by the line of this repository that made each, how many."""
    import traceback
    import warnings

    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    where = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = "?"
        for frame in reversed(traceback.extract_stack()[:-1]):
            if frame.filename.startswith(here) and \
                    not frame.filename.endswith("chip_smoke.py"):
                site = (f"{os.path.relpath(frame.filename, here)}:"
                        f"{frame.lineno}")
                break
        where[site] = where.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"count": sum(where.values()), "by_line": where}


class ScanOpCalls:
    """Calls of the scan's filter ops (:data:`SCAN_OPS`) inside the
    block."""

    def __init__(self):
        self.counts = dict.fromkeys(SCAN_OPS, 0)
        self._saved = []

    def __enter__(self):
        for op in SCAN_OPS:
            real = getattr(dev, op)

            def counted(*args, real=real, op=op, **kwargs):
                self.counts[op] += 1
                return real(*args, **kwargs)

            self._saved.append((op, real))
            setattr(dev, op, counted)
        return self

    def __exit__(self, *exc):
        for op, real in self._saved:
            setattr(dev, op, real)
        self._saved = []


def scan_case(card: str, name: str, path: str, key: str, kw: dict,
              want: dict, kernel=None, cpu_check: bool = False) -> dict:
    """One scan case on the card: ``stage_scan`` once, ``decoded_scan``
    once cold and three times warm, ``scan_filtered_device`` end to end
    three times, every result equal to ``want``; the kernels launched
    over those runs (``kernel`` must be among them, and the operands of
    its largest launch in the cold ``decoded_scan`` are kept, the scan's
    own shape for phase 6), the synchronizing calls of one warm
    ``decoded_scan``, and with ``cpu_check`` the same scan on the CPU,
    equal form for form."""
    columns = list(want)
    f = pq.ParquetFile(path)
    pq.reset_launches()
    reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = pq.stage_scan(f, key, columns=columns, device=DEVICE, **kw)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    operands = []
    spied = kernel if kernel in ("unpack_bits_dense",
                                 "dict_unpack_gather") else None
    real = getattr(kernels, spied) if spied else None
    if spied:
        setattr(kernels, spied,
                lambda *a, **k: operands.append(a) or real(*a, **k))
    try:
        out, cold_s = timed_scan(state)
    finally:
        if spied:
            setattr(kernels, spied, real)
    check_scan(out, want, name)
    warm = []
    for _ in range(3):
        out, s = timed_scan(state)
        warm.append(s)
    check_scan(out, want, name)
    e2e = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pq.scan_filtered_device(f, key, columns=columns, device=DEVICE,
                                      **kw)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        check_scan(out, want, name)
    launches = dict(pq.LAUNCHES)
    no_host_route(f"scan {name}")
    if kernel is not None and not launches[kernel]:
        raise AssertionError(f"scan {name}: {kernel} was not launched: "
                             f"{launches}")
    with ScanOpCalls() as ops:
        syncs = count_syncs(lambda: pq.decoded_scan(state))
    if cpu_check:
        cpu = pq.scan_filtered_device(pq.ParquetFile(path), key,
                                      columns=columns, device="cpu", **kw)
        check_scan(cpu, want, f"{name} on the CPU")
    rows = f.num_rows
    candidates = sum(p.row_count for p, _, _ in state["spans"])
    best = min(warm)
    first = want[columns[0]][0]
    selected = len(first[1]) - 1 if isinstance(first, tuple) else len(first)
    log({"scan": [{
        "case": name, "card": card, "key": key,
        "predicate": {k: (v if k != "values" or len(v) <= 8
                          else f"{len(v)} values") for k, v in kw.items()},
        "columns": columns, "rows": rows, "row_groups": len(f.row_groups),
        "candidate_rows": candidates, "spans": len(state["spans"]),
        "rows_selected": selected, "stage_s": stage_s,
        "decoded_scan_cold_s": cold_s, "decoded_scan_warm_s": warm,
        "rows_per_s_file": rows / best,
        "rows_per_s_candidates": candidates / best,
        "scan_filtered_device_s": e2e, "launches": launches,
        "host_syncs_warm_decoded_scan": syncs,
        "filter_op_calls": ops.counts,
        "cpu_equal": cpu_check or None}]})
    return {"state": state, "launches": launches, "op_calls": ops.counts,
            "spans": len(state["spans"]),
            "operands": max(operands, key=lambda a: a[-2], default=None)}


def scan_path(card: str, rows: int, seed: int, tmp: str, lineitem: str,
              lineitem_rows: int, lookup: str, lookup_rows: int) -> dict:
    """Phase 5b: the device scan's three cases, each checked against a
    numpy oracle over the generated arrays; returns each case's staged
    state (for the profiled scans of phase 7), its launches and filter op
    calls, and case A's table."""
    cases = {}
    # A: bench.py:_cfg5 at --scan-rows, written by the port's writer
    table = make_cfg5(rows, seed)
    path = os.path.join(tmp, "cfg5.parquet")
    t0 = time.perf_counter()
    pq.write_table(table, path, pq.WriterOptions(
        row_group_size=-(-rows // SCAN_ROW_GROUPS), data_page_size=SCAN_PAGE,
        compression="snappy", column_encoding=dict.fromkeys(
            table, Encoding.PLAIN), bloom_filters={"l_shipdate": 10}))
    log({"scan_cfg5": {"rows": rows, "write_s": time.perf_counter() - t0,
                       "file_bytes": os.path.getsize(path)}})
    ship = table["l_shipdate"]
    outs = ["l_orderkey", "l_quantity", "l_extendedprice"]
    lo, hi = SCAN_RANGE
    want = oracle({c: table[c] for c in outs}, (ship >= lo) & (ship <= hi))
    cases["A_range"] = scan_case(card, "A_range", path, "l_shipdate",
                                 {"lo": lo, "hi": hi}, want, cpu_check=True)
    dates = scan_in_dates(seed)
    want = oracle({c: table[c] for c in outs}, np.isin(ship, dates))
    cases["A_in"] = scan_case(card, "A_in", path, "l_shipdate",
                              {"values": dates}, want, "bloom_check",
                              cpu_check=True)
    plan = check_scan_plan(path, "l_shipdate", dates)
    filters, batches = plan["probe"]
    log({"scan_plan": {
        "case": "A_in", "card": card, "equal_cpu_plan": True,
        "holes": scan_holes(seed).tolist(), "counters": plan["counters"],
        "candidate_rows": plan["candidate_rows"], "rows": plan["rows"],
        "bloom_probe": {"segments": len(filters),
                        "n": int(sum(len(b) for b in batches)),
                        "z": sorted({int(f.blocks.shape[0]) for f in filters}),
                        "equal_plain": True}}})
    # B: phase 4b's lineitem, TPC-H Q6's dates and Q12's ship modes
    _, data = make_lineitem(lineitem_rows, seed)
    ship = data["l_shipdate"].values
    lo, hi = Q6_DATES
    want = oracle({c: data[c] if data[c].offsets is not None
                   else data[c].values for c in Q6_COLUMNS},
                  (ship >= lo) & (ship <= hi))
    cases["B_q6"] = scan_case(card, "B_q6", lineitem, "l_shipdate",
                              {"lo": lo, "hi": hi}, want)
    mask = np.zeros(lineitem_rows, bool)
    for mode in Q12_MODES:
        mask |= rows_equal(data["l_shipmode"], mode.encode())
    want = oracle({c: data[c].values for c in Q12_COLUMNS}, mask)
    cases["B_q12"] = scan_case(card, "B_q12", lineitem, "l_shipmode",
                               {"values": Q12_MODES}, want,
                               "unpack_bits_dense")
    del data, want
    # C: phase 5's lookup file, a range of about 1 % of its rows on k
    look = make_lookup_table(lookup_rows, seed)
    k = look["k"]
    lo = int(k[-1]) * 2 // 5
    hi = lo + int(int(k[-1]) * LOOKUP_SCAN_SHARE)
    want = oracle({c: look[c] for c in LOOKUP_COLUMNS},
                  (k >= lo) & (k <= hi))
    cases["C_lookup"] = scan_case(card, "C_lookup", lookup, "k",
                                  {"lo": lo, "hi": hi}, want,
                                  "dict_unpack_gather")
    launches = {name: sum(c["launches"][name] for c in cases.values())
                for name in pq.LAUNCHES}
    return {"cases": cases, "launches": launches, "cfg5": table,
            "cfg5_path": path, "in_dates": dates,
            "bloom_probe": plan["probe"], "plan_counters": plan["counters"]}


# ---------------------------------------------------------------------------
# phase 5c: the multi-file read; phase 5d: the sharded read and decode step
# ---------------------------------------------------------------------------

DATASET_FILES = 8
DATASET_ROW_GROUP = 1 << 19
# (name, entries of cuda:0 in the mesh); the first reads through
# Dataset.read()'s default device, "cuda"
DATASET_MESHES = (("x1", 1), ("x2", 2), ("x4", 4))
# scripts/multichip_scale.py:47's READ_COLS: 64-bit, dictionary-string and
# PLAIN-string (ragged) columns
SHARDED_COLS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                "l_returnflag", "l_shipmode", "l_comment"]
SHARDED_MESHES = (("x1", 1), ("x4", 4))
STEP_ROWS = 1 << 20  # values a shard of the decode step
STEP_SHARDS = 4
# the rows phase 6 adds for these paths: (path, kernel), the operands of
# the kernel's largest launch in the path's cold reads
MULTI_SHAPES = (("dataset", "unpack_bits_dense"),
                ("sharded", "unpack_bits_dense"),
                ("host_scan", "unpack_bits_dense"))


class LargestLaunch:
    """The operands of ``kernel``'s largest launch (most values) over the
    reads inside the block, on whatever thread it launches, and the
    column whose ``decode_staged`` launched it."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.operands = None
        self.column = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._real = {}

    def __enter__(self):
        real_k = self._real["k"] = getattr(kernels, self.kernel)
        real_d = self._real["d"] = device_reader.decode_staged

        def launch(*a, **k):
            with self._lock:
                if self.operands is None or a[-2] > self.operands[-2]:
                    self.operands = a
                    self.column = getattr(self._local, "column", None)
            return real_k(*a, **k)

        def decode(plan, *a, **k):
            self._local.column = plan.leaf.name
            return real_d(plan, *a, **k)

        setattr(kernels, self.kernel, launch)
        device_reader.decode_staged = decode
        return self

    def __exit__(self, *exc):
        setattr(kernels, self.kernel, self._real["k"])
        device_reader.decode_staged = self._real["d"]


class PinnedLog:
    """The staging buffers of the reads inside the block
    (``_StagingBatch.commit``, on the pool's workers): the most in use at
    once, each from the start of its fill until its copy's event is seen
    to have ended (as the host allocator holds a pinned block: it
    checks a freed block's events when it next allocates), and their
    sizes.  A buffer's use is counted from before the allocator's own
    check, so the count is never below the blocks the allocator needs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._filling = 0
        self._copies = []  # the copies' events not yet seen to end
        self.peak = 0
        self.sizes = set()
        self._real = None

    def __enter__(self):
        real = self._real = device_reader._StagingBatch.commit

        def commit(batch, staged, device, side_stream=False):
            with self._lock:
                self._copies = [e for e in self._copies if not e.query()]
                self._filling += 1
                self.peak = max(self.peak, self._filling + len(self._copies))
                self.sizes.add(batch.nbytes)
            out = None
            try:
                out = real(batch, staged, device, side_stream)
                return out
            finally:
                with self._lock:
                    self._filling -= 1
                    if out is not None and out[1] is not None:
                        self._copies.append(out[1][0])

        device_reader._StagingBatch.commit = commit
        return self

    def __exit__(self, *exc):
        device_reader._StagingBatch.commit = self._real

    def take(self) -> dict:
        """The most buffers in use at once since the last call, and the
        buffers' sizes (MiB) and the power-of-two blocks they take."""
        with self._lock:
            self._copies = [e for e in self._copies if not e.query()]
            peak, sizes = self.peak, sorted(self.sizes)
            self.peak, self.sizes = self._filling + len(self._copies), set()
        return {"buffers_peak": peak,
                "buffer_mib": [n / 2 ** 20 for n in sizes],
                "block_mib": sorted({(1 << max(n - 1, 0).bit_length())
                                     / 2 ** 20 for n in sizes})}


def column_slice(cd: ColumnData, a: int, b: int) -> ColumnData:
    """Rows ``[a, b)`` of a flat column without nulls."""
    if cd.offsets is None:
        return ColumnData(values=cd.values[a:b])
    o = cd.offsets[a:b + 1]
    return ColumnData(values=cd.values[o[0]:o[-1]], offsets=o - o[0])


def timed_dataset_read(pattern: str, mesh) -> tuple:
    """``Dataset(pattern).read()`` on ``mesh`` (its default, every card,
    where None), ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = pq.Dataset(pattern)
    out = ds.read() if mesh is None else ds.read(device=mesh)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    ds.close()
    return out, s


def dataset_reads(pattern: str, name: str, entries: int, data: dict,
                  per_file: dict, largest: LargestLaunch,
                  pinned_state: dict) -> dict:
    """One mesh's cold read (``largest`` watching its launches) and three
    warm ones: the cold read equal to the generated columns, every read
    equal to the per-file reads bit for bit, every file on the device
    route, the staged bytes drained, and pinned blocks reused: after each
    read, the pinned blocks the phase's reads have made (``made``) are no
    more than the most staging buffers any of them had in use at once
    (``high``; :class:`PinnedLog`), the blocks a host allocator that
    reuses every free block can need.  Logged as ``{"dataset_read":
    ...}`` before its checks."""
    mesh = None if entries == 1 else [torch.device(DEVICE)] * entries
    pq.reset_mesh()
    pq.reset_route_refusals()
    reset_routes()
    reads = {}
    with PinnedLog() as pinned:
        for r in ("cold", "warm1", "warm2", "warm3"):
            before = host_allocs()
            with largest if r == "cold" else contextlib.nullcontext():
                out, wall = timed_dataset_read(pattern, mesh)
            reads[r] = {"wall_s": wall, **pinned.take(),
                        "new_pinned_blocks": host_allocs() - before}
            if r == "cold":
                check_columns(out, data)
            same_bits(out, per_file, f"dataset {name}")
            if r != "warm3":
                del out
    counts = dict(pq.MESH)
    nbytes = decoded_bytes(out)
    del out
    warm = [reads[r]["wall_s"] for r in ("warm1", "warm2", "warm3")]
    best = min(warm)
    rows = next(iter(per_file.values())).num_slots
    got = {"mesh": [DEVICE + ":0"] * entries, "window": min(entries, 4),
           "cold_s": reads["cold"]["wall_s"], "warm_s": warm,
           "best_s": best, "rows_per_s": rows / best,
           "decoded_bytes": nbytes, "decoded_gb_per_s": nbytes / best / 1e9,
           "mesh_counts": counts, "staging": reads,
           "host_route": dict(pq.HOST_ROUTE),
           "route_refusals": dict(pq.ROUTE_REFUSALS)}
    log({"dataset_read": {name: got}})
    no_host_route(f"dataset {name}")
    if any(pq.ROUTE_REFUSALS.values()):
        raise AssertionError(f"dataset {name}: files refused: "
                             f"{pq.ROUTE_REFUSALS}")
    if counts["staging_bytes"] or counts["files_sharded"] != \
            4 * DATASET_FILES:
        raise AssertionError(f"dataset {name}: {counts}")
    for r, got_r in reads.items():
        pinned_state["made"] += got_r["new_pinned_blocks"]
        pinned_state["high"] = max(pinned_state["high"],
                                   got_r["buffers_peak"])
        if pinned_state["made"] > pinned_state["high"]:
            raise AssertionError(
                f"dataset {name} {r}: the reads made {pinned_state} pinned "
                "blocks, more than the staging buffers ever in use at once")
    return got


class StageDecodeTimes:
    """Host seconds in the dataset reads inside the block: each file's
    stage (``mesh._stage_dataset_file``: footer check, plan, fill and
    copy) and decode (``mesh._decode_dataset_file``), summed over the
    pool's workers, and ``Dataset.read``'s concatenation of the files'
    columns (``concat_s``)."""

    def __init__(self):
        self.times = {"stage_s": 0.0, "decode_s": 0.0, "concat_s": 0.0}
        self._lock = threading.Lock()
        self._real = {}

    def _timed(self, owner, attr: str, key: str) -> None:
        real = self._real[(owner, attr)] = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                with self._lock:
                    self.times[key] += time.perf_counter() - t0

        setattr(owner, attr, timed)

    def __enter__(self):
        from parquet_tpu_torch import dataset
        from parquet_tpu_torch.parallel import mesh

        self._timed(mesh, "_stage_dataset_file", "stage_s")
        self._timed(mesh, "_decode_dataset_file", "decode_s")
        self._timed(dataset, "concat_columns", "concat_s")
        return self

    def __exit__(self, *exc):
        for (owner, attr), real in self._real.items():
            setattr(owner, attr, real)


def dataset_breakdown(pattern: str) -> dict:
    """One more warm read at one and at four entries of cuda:0, with the
    host seconds of its stages (:class:`StageDecodeTimes`)."""
    out = {}
    for name, entries in (("x1", 1), ("x4", 4)):
        with StageDecodeTimes() as t:
            _, wall = timed_dataset_read(
                pattern, [torch.device(DEVICE)] * entries)
        out[name] = {"wall_s": wall, **t.times}
    return out


def dataset_path(card: str, rows: int, seed: int, tmp: str,
                 lineitem: dict) -> dict:
    """Phase 5c: phase 4b's lineitem data as 8 part files of 524,288-row
    row groups (the port's writer, Snappy), read per file and as one
    ``Dataset`` at each of :data:`DATASET_MESHES`."""
    schema, data = make_lineitem(rows, seed)
    root = os.path.join(tmp, "dataset")
    os.makedirs(root)
    per = -(-rows // DATASET_FILES)
    paths = []
    t0 = time.perf_counter()
    for i in range(DATASET_FILES):
        a, b = i * per, min(rows, (i + 1) * per)
        path = os.path.join(root, f"part-{i:02d}.parquet")
        pq.write_table({k: column_slice(cd, a, b) for k, cd in data.items()},
                       path, pq.WriterOptions(
                           compression="snappy",
                           row_group_size=DATASET_ROW_GROUP,
                           data_page_size=1 << 20,
                           column_encoding=LINEITEM_ENCODINGS),
                       schema=schema)
        paths.append(path)
    write_s = time.perf_counter() - t0
    pq.reset_launches()
    best, reads = [], []
    for path in paths:
        out, _ = timed_read(path)
        warm = []
        for _ in range(3):
            del out
            out, s = timed_read(path)
            warm.append(s)
        best.append(min(warm))
        reads.append(out)
    per_file = {name: concat_columns([r[name] for r in reads])
                for name in LINEITEM_ORDER}
    del reads
    per_file_launches = dict(pq.LAUNCHES)
    pattern = os.path.join(root, "part-*.parquet")
    largest = LargestLaunch("unpack_bits_dense")
    pq.reset_launches()  # the dataset reads: the path this phase drives
    # the pinned blocks the reads made, the most buffers in use at once
    pinned_state = {"made": 0, "high": 0}
    got = {name: dataset_reads(pattern, name, entries, data, per_file,
                               largest, pinned_state)
           for name, entries in DATASET_MESHES}
    launches = dict(pq.LAUNCHES)
    del per_file, data
    breakdown = dataset_breakdown(pattern)
    if launches["unpack_bits_dense"] == 0 or largest.operands is None:
        raise AssertionError("the dataset reads launched no "
                             "unpack_bits_dense")
    log({"dataset_path": {
        "card": card, "files": DATASET_FILES, "rows": rows,
        "rows_per_file": per, "row_group": DATASET_ROW_GROUP,
        "file_bytes": sum(os.path.getsize(p) for p in paths),
        "write_s": write_s, "per_file_best_s": best,
        "per_file_sum_best_s": sum(best),
        "per_file_rows_per_s": rows / sum(best),
        "one_file_best_s": lineitem["best_s"],
        "one_file_rows_per_s": rows / lineitem["best_s"],
        "reads": got, "pinned": pinned_state, "breakdown": breakdown,
        "launches": launches,
        "per_file_launches": per_file_launches,
        "largest_unpack": {"column": largest.column,
                           "n": largest.operands[-2],
                           "w": largest.operands[-1]},
        "equal_generated": True, "equal_per_file_reads": True,
        "host_route": dict(pq.HOST_ROUTE),
        "route_refusals": dict(pq.ROUTE_REFUSALS)}})
    return {"launches": launches, "operands": largest.operands,
            "column": largest.column, "paths": paths}


def check_sharded(st, single: dict, rg_rows: list) -> None:
    """Every column of ``st`` equal to the single-file read, bit for bit:
    numeric shards as values, dictionary ids through the unified
    dictionary, ragged shards as values and offsets."""
    k = len(st.mesh)
    if st.validity:
        raise AssertionError(f"sharded: validity on {list(st.validity)}")
    order = sorted(((g, d) for d in range(k)
                    for g in range(d, len(rg_rows), k)))
    for path in SHARDED_COLS:
        col = single[path]
        if path in st.ragged:
            b, o = st.ragged[path]
            values, offsets, base = [], [o[0][:1]], 0
            for g, d in order:
                # row groups before g on shard d
                skip = sum(rg_rows[h] for h in range(d, g, k))
                oo = o[d][skip:skip + rg_rows[g] + 1]
                values.append(b[d][int(oo[0]):int(oo[-1])])
                offsets.append(oo[1:] - oo[0] + base)
                base += int(oo[-1] - oo[0])
            got = torch.cat(values), torch.cat(offsets)
            want = dev.gather_byte_arrays(*col.dictionary, col.dict_indices) \
                if col.is_dictionary_encoded() else (col.values, col.offsets)
        else:
            ids = torch.cat([st.arrays[path][d][
                sum(rg_rows[h] for h in range(d, g, k)):][:rg_rows[g]]
                for g, d in order])
            if path in st.dictionaries:
                uv, uo = (torch.from_numpy(a).to(ids.device)
                          for a in st.dictionaries[path])
                got = dev.gather_byte_arrays(uv, uo, ids)
                want = dev.gather_byte_arrays(*col.dictionary,
                                              col.dict_indices)
            else:
                got, want = (ids,), (col.values,)
        for x, y in zip(got, want):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"sharded {path}: differs from the "
                                     "single-file read")


def step_inputs(n: int, shards: int, seed: int) -> list:
    """The sharded decode step's inputs: a shard's PLAIN INT64 page and
    its def levels (90 % present) as an RLE/bit-packed stream with its run
    table, stacked on a first axis (buffers and run tables padded to one
    shape; padding runs end at ``n``)."""
    out = []
    for d in range(shards):
        rng = np.random.default_rng(seed + 100 + d)
        values = rng.integers(0, 2 ** 60, n).astype(np.int64)
        defs = (rng.random(n) < 0.9).astype(np.int64)
        lev = np.frombuffer(host.encode_rle(defs, 1, 8), np.uint8)
        kinds, cnts, payloads, offs, _ = host.scan_rle_runs(lev, n, 1)
        out.append((dev.pad_to_bucket(values.view(np.uint8)),
                    dev.pad_to_bucket(lev), np.cumsum(cnts),
                    kinds.astype(np.uint8), payloads.astype(np.int32),
                    offs * 8, np.ones(len(kinds), np.int32)))
    runs = max(len(s[2]) for s in out)
    fill = (n, 0, 0, 0, 1)
    return [torch.from_numpy(np.stack([
        np.pad(s[i], (0, max(len(t[i]) for t in out) - len(s[i])))
        for s in out])) for i in (0, 1)] + [
        torch.from_numpy(np.stack([
            np.pad(s[i], (0, runs - len(s[i])), constant_values=fill[i - 2])
            for s in out])) for i in range(2, 7)]


def sharded_path(card: str, lineitem: str, rows: int, seed: int) -> dict:
    """Phase 5d: ``read_table_sharded`` over phase 4b's lineitem with
    ``scripts/multichip_scale.py``'s columns at 1 and 4 shards of cuda:0
    (three row groups: one shard of four is all padding), each equal to
    the single-file read; then ``decode_step_sharded`` at 4 x 1,048,576
    rows against its CPU run."""
    single = pq.ParquetFile(lineitem).read(columns=SHARDED_COLS,
                                           device=DEVICE)
    rg_rows = [rg.num_rows for rg in pq.ParquetFile(lineitem).row_groups]
    pq.reset_launches()
    reset_routes()
    pq.reset_mesh()
    got = {}
    largest = LargestLaunch("unpack_bits_dense")
    for name, k in SHARDED_MESHES:
        mesh = [torch.device(DEVICE)] * k
        walls = []
        for r in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with largest if (r, name) == (0, SHARDED_MESHES[0][0]) \
                    else contextlib.nullcontext():
                st = pq.read_table_sharded(lineitem, mesh=mesh,
                                           columns=SHARDED_COLS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check_sharded(st, single, rg_rows)
        got[name] = {
            "shards": k, "walls_s": walls, "best_s": min(walls),
            "rows_per_s": rows / min(walls), "row_counts": st.row_counts,
            "shard_rows": st.shard_rows,
            "dictionary_sizes": {p: len(o) - 1
                                 for p, (_, o) in st.dictionaries.items()},
            "ragged": sorted(st.ragged), "equal_single_read": True}
        del st
    launches = dict(pq.LAUNCHES)
    no_host_route("the sharded reads")
    if pq.MESH["chunks_host_fallback"] or launches["unpack_bits_dense"] == 0 \
            or largest.operands is None:
        raise AssertionError(f"sharded reads: {pq.MESH}, {launches}")
    del single
    step_in = step_inputs(STEP_ROWS, STEP_SHARDS, seed)
    want = pq.decode_step_sharded([torch.device("cpu")] * STEP_SHARDS,
                                  STEP_ROWS)(*step_in)
    on_card = [t.to(DEVICE) for t in step_in]
    step = pq.decode_step_sharded([torch.device(DEVICE)] * STEP_SHARDS,
                                  STEP_ROWS)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(*on_card)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    equal = (int(res[2]) == int(want[2]) and all(
        torch.equal(a.cpu(), b) for xs, ys in zip(res[:2], want[:2])
        for a, b in zip(xs, ys)))
    if not equal:
        raise AssertionError("decode_step_sharded differs from its CPU run")
    log({"sharded": {
        "card": card, "file": "phase 4b's lineitem", "rows": rows,
        "row_groups": rg_rows, "columns": SHARDED_COLS, "reads": got,
        "launches": launches, "mesh_counts": dict(pq.MESH),
        "largest_unpack": {"column": largest.column,
                           "n": largest.operands[-2],
                           "w": largest.operands[-1]},
        "decode_step": {"shards": STEP_SHARDS, "rows_per_shard": STEP_ROWS,
                        "present_rows": int(res[2]), "cold_s": walls[0],
                        "warm_s": walls[1:], "equal_cpu": True}}})
    return {"launches": launches, "operands": largest.operands,
            "column": largest.column}


# ---------------------------------------------------------------------------
# phase 5e: the host scan and the routed scan
# ---------------------------------------------------------------------------

HOST_SCAN_WARM = 3
Q6_DISCOUNT = (0.05, 0.07)  # TPC-H Q6: l_discount between 0.06 -+ 0.01
Q6_QUANTITY = 23  # TPC-H Q6: l_quantity < 24
Q6_OUT = ["l_extendedprice", "l_discount"]
TREE_COLS = ["l_orderkey", "l_extendedprice"]
SHARDED_SCAN_RANGE = (8500, 11500)  # cfg 5: six of its eight row groups
SHARDED_SCAN_MESHES = (("x1", 1), ("x4", 4))
DATASET_SCAN_MESHES = (("x1", 1), ("x4", 4))
ROUTE_PIN = "PARQUET_TPU_TORCH_ROUTE"


def q6_tree():
    """TPC-H Q6's predicate over three lineitem columns."""
    from parquet_tpu_torch.algebra.expr import col

    return (col("l_shipdate").between(*Q6_DATES)
            & col("l_discount").between(*Q6_DISCOUNT)
            & (col("l_quantity") <= Q6_QUANTITY))


def host_form(col) -> tuple:
    """A host-scan column as :func:`oracle` gives it: ``(values or
    (values, offsets), validity or None)``."""
    if isinstance(col, list):
        items = [b"" if v is None else v for v in col]
        offs = np.zeros(len(items) + 1, np.int64)
        np.cumsum([len(v) for v in items], out=offs[1:])
        valid = np.array([v is not None for v in col], bool)
        return ((np.frombuffer(b"".join(items), np.uint8), offs),
                None if valid.all() else valid)
    if isinstance(col, np.ma.MaskedArray):
        m = np.ma.getmaskarray(col)
        return np.ma.getdata(col), ~(m[:, 0] if m.ndim == 2 else m)
    return np.asarray(col), None


def is_device_result(out: dict) -> bool:
    return any(isinstance(v, (torch.Tensor, tuple)) for v in out.values())


def check_result(out: dict, want: dict, what: str) -> None:
    """A scan's result equal to the oracle, bit for bit, whichever route
    gave it (the device scan's forms through :func:`check_scan`)."""
    if is_device_result(out):
        check_scan(out, want, what)
        return
    for name, (wv, wvalid) in want.items():
        gv, gvalid = host_form(out[name])
        if (gvalid is None) != (wvalid is None) or (
                gvalid is not None and not np.array_equal(gvalid, wvalid)):
            raise AssertionError(f"{what}: {name}'s validity differs")
        if isinstance(wv, tuple):
            same = (np.array_equal(gv[0], wv[0])
                    and np.array_equal(gv[1], wv[1]))
        else:
            same = (gv.dtype == wv.dtype and gv.shape == wv.shape
                    and np.array_equal(gv.view(np.uint8), wv.view(np.uint8)))
        if not same:
            raise AssertionError(f"{what}: {name} differs from the oracle")


def host_scan_case(card: str, name: str, path: str, where, columns: list,
                   want: dict, device_kw=None) -> dict:
    """One host-scan case: ``scan_expr`` once cold (the bloom probes it
    launches counted, the planner's probe operands kept) and three times
    warm, each phase timed, every result equal to ``want``; with
    ``device_kw`` the same predicate through ``scan_filtered_device``
    too, equal to the same oracle."""
    from parquet_tpu_torch.parallel.host_scan import _scan_expr_impl

    probes = []
    real = bloom.check_hashes_multi

    def spy(filters, batches, device="cuda"):
        probes.append((list(filters), [np.asarray(b) for b in batches]))
        return real(filters, batches, device)

    f = pq.ParquetFile(path)
    before = dict(pq.LAUNCHES)
    bloom.check_hashes_multi = spy
    try:
        t0 = time.perf_counter()
        out = pq.scan_expr(f, where, columns=columns, device=DEVICE)
        cold = time.perf_counter() - t0
    finally:
        bloom.check_hashes_multi = real
    cold_bloom = pq.LAUNCHES["bloom_check"] - before["bloom_check"]
    check_result(out, want, f"host scan {name}")
    warm, best = [], None
    for _ in range(HOST_SCAN_WARM):
        t = {}
        t0 = time.perf_counter()
        out = _scan_expr_impl(f, where, columns, None, True,
                              torch.device(DEVICE), timings=t)
        t["wall_s"] = time.perf_counter() - t0
        warm.append(t["wall_s"])
        if best is None or t["wall_s"] < best["wall_s"]:
            best = t
    check_result(out, want, f"host scan {name} warm")
    if device_kw is not None:
        check_scan(pq.scan_filtered_device(f, device=DEVICE, **device_kw),
                   want, f"host scan {name}: scan_filtered_device")
    row = {"case": name, "card": card, "file_rows": f.num_rows,
           "columns": columns, "cold_wall_s": cold, "warm_wall_s": warm,
           "best_warm_s": best["wall_s"], "plan_s": best["plan_s"],
           "phase1_s": best["phase1_s"], "phase2_s": best["phase2_s"],
           "candidate_rows": best["candidate_rows"],
           "survivors": best["survivors"], "spans": best["spans"],
           "threads_phase1_phase2": best["threads"],
           "bloom_check_launches_cold": cold_bloom,
           "rg_pruned": {k: v for k, v in best["plan_counters"].items()
                         if k.startswith("rg_")},
           "equal_oracle": True,
           "equal_device_scan": device_kw is not None or None}
    log({"host_scan": [row]})
    return {"out": out, "row": row, "probes": probes}


def timed_routed(f, key: str, kw: dict, columns: list) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pq.scan(f, key, columns=columns, device=DEVICE, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def routed_case(card: str, name: str, path: str, key: str, kw: dict,
                columns: list, want: dict, largest) -> dict:
    """The routed ``scan()`` three ways: unpinned (the cost model on its
    priors, the history cleared), pinned to the host and pinned to the
    device, each cold and three times warm (a pin the device scan refuses
    from the footer runs once), every result equal to ``want``; which
    route each run took (a page-level refusal falls back to the host
    scan)."""
    f = pq.ParquetFile(path)
    os.environ.pop(ROUTE_PIN, None)
    pq.route_history().reset()
    unpinned = pq.route_scan(f, key, columns=columns, device=DEVICE, **kw)
    out, wall = timed_routed(f, key, kw, columns)
    check_result(out, want, f"routed {name} unpinned")
    runs = {"unpinned": {"route": unpinned.route, "reason": unpinned.reason,
                         "ran": "device" if is_device_result(out)
                         else "host", "wall_s": wall}}
    for pin in ("host", "device"):
        os.environ[ROUTE_PIN] = pin
        try:
            d = pq.route_scan(f, key, columns=columns, device=DEVICE, **kw)
            walls, ran = [], set()
            reps = 1 + (HOST_SCAN_WARM if d.route == pin else 0)
            for r in range(reps):
                with (largest if pin == "device" and r == 0
                      else contextlib.nullcontext()):
                    out, s = timed_routed(f, key, kw, columns)
                walls.append(s)
                ran.add("device" if is_device_result(out) else "host")
                check_result(out, want, f"routed {name} pinned {pin}")
        finally:
            os.environ.pop(ROUTE_PIN, None)
        runs[pin] = {"route": d.route, "reason": d.reason, "ran": sorted(ran),
                     "cold_s": walls[0], "warm_s": walls[1:],
                     "best_warm_s": min(walls[1:]) if walls[1:] else None}
    row = {"case": name, "card": card, "routed": True, "key": key,
           "predicate": {k: (v if k != "values" else f"{len(v)} values")
                         for k, v in kw.items()},
           "columns": columns, "est_bytes": unpinned.est_bytes,
           "route": unpinned.route, "reason": unpinned.reason, "runs": runs,
           "equal_oracle": True}
    log({"host_scan": [row]})
    return row


def route_rates(rows: list, card: str) -> dict:
    """Each route's GB/s over the cases both routes ran (``est_bytes`` over
    the best warm wall, the median over the cases), the device route's
    fixed cost (cold minus best warm, the median), and the smallest
    ``est_bytes`` at which the device route was no slower than the host
    route."""
    both = [r for r in rows if r["runs"]["device"]["ran"] == ["device"]
            and r["runs"]["host"]["ran"] == ["host"]]
    host = [r["est_bytes"] / r["runs"]["host"]["best_warm_s"] / 1e9
            for r in both]
    card_rates = [r["est_bytes"] / r["runs"]["device"]["best_warm_s"] / 1e9
                  for r in both]
    fixed = [r["runs"]["device"]["cold_s"] - r["runs"]["device"][
        "best_warm_s"] for r in both]
    wins = sorted(r["est_bytes"] for r in both
                  if r["runs"]["device"]["best_warm_s"]
                  <= r["runs"]["host"]["best_warm_s"])
    return {"card": card, "cases": [r["case"] for r in both],
            "est_bytes": [r["est_bytes"] for r in both],
            "host_gbps": statistics.median(host) if host else None,
            "device_gbps": statistics.median(card_rates)
            if card_rates else None,
            "host_gbps_by_case": host, "device_gbps_by_case": card_rates,
            "device_fixed_s": statistics.median(fixed) if fixed else None,
            "device_no_slower_from_bytes": wins[0] if wins else None}


def dataset_scans(card: str, paths: list, want: dict) -> dict:
    """``Dataset.scan`` of TPC-H Q6 over the lineitem part files at each
    of :data:`DATASET_SCAN_MESHES`, cold and twice warm, each equal to the
    one-file scan of the same rows."""
    got = {}
    for name, k in DATASET_SCAN_MESHES:
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            with pq.Dataset(paths) as ds:
                out = ds.scan(where=q6_tree(), columns=Q6_OUT,
                              device=[torch.device(DEVICE)] * k)
            walls.append(time.perf_counter() - t0)
            for c in Q6_OUT:
                if not np.array_equal(np.asarray(out[c]),
                                      np.asarray(want[c])):
                    raise AssertionError(f"Dataset.scan at {name}: {c} "
                                         "differs from the one-file scan")
        got[name] = {"entries": k, "cold_s": walls[0], "warm_s": walls[1:],
                     "best_warm_s": min(walls[1:]),
                     "rows": len(out[Q6_OUT[0]]),
                     "equal_one_file_scan": True}
    return {"card": card, "files": len(paths), "predicate": "TPC-H Q6",
            "meshes": got}


def sharded_scans(card: str, path: str) -> dict:
    """``scan_filtered_sharded`` over cfg 5 at each of
    :data:`SHARDED_SCAN_MESHES`, cold and twice warm, equal to
    ``scan_filtered_device`` (the shards' rows put back in file order by
    ``l_orderkey``, the row ordinal)."""
    lo, hi = SHARDED_SCAN_RANGE
    cols = ["l_orderkey", "l_quantity", "l_extendedprice"]
    f = pq.ParquetFile(path)
    single = pq.scan_filtered_device(f, "l_shipdate", lo=lo, hi=hi,
                                     columns=cols, device=DEVICE)
    want = {c: scan_form_host(single[c])[0] for c in cols}
    got = {}
    for name, k in SHARDED_SCAN_MESHES:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pq.scan_filtered_sharded(f, "l_shipdate", lo=lo, hi=hi,
                                           columns=cols,
                                           mesh=[torch.device(DEVICE)] * k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        per = {c: np.concatenate([scan_form_host(p)[0] for p in out[c]])
               for c in cols}
        order = np.argsort(per["l_orderkey"], kind="stable")
        for c in cols:
            if not np.array_equal(per[c][order], want[c]):
                raise AssertionError(f"scan_filtered_sharded at {name}: {c} "
                                     "differs from scan_filtered_device")
        got[name] = {"entries": k, "shards": len(out[cols[0]]),
                     "rows": out["#rows"], "cold_s": walls[0],
                     "warm_s": walls[1:], "best_warm_s": min(walls[1:]),
                     "equal_scan_filtered_device": True}
    return {"card": card, "range": SHARDED_SCAN_RANGE, "meshes": got}


def gather_rows(card: str, cd: ColumnData, survivors: np.ndarray) -> list:
    """``gather_byte_arrays``' C++ at Q6's survivors of ``l_comment`` and
    at one whole ``l_comment`` chunk, each equal to its numpy version and
    both timed (the median of three calls)."""
    out = []
    for name, idx in (("q6_survivors", survivors),
                      ("chunk", np.arange(min(LINEITEM_ROW_GROUP,
                                              len(cd.offsets) - 1)))):
        got = host.gather_byte_arrays(cd.values, cd.offsets, idx)
        want = host.gather_byte_arrays_numpy(cd.values, cd.offsets, idx)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"gather_byte_arrays at {name} differs "
                                 "from its numpy version")
        out.append({"case": name, "card": card, "rows": len(idx),
                    "bytes": int(got[1][-1]),
                    "cpp_ms": host_ms(lambda: host.gather_byte_arrays(
                        cd.values, cd.offsets, idx), 3),
                    "numpy_ms": host_ms(lambda: host.gather_byte_arrays_numpy(
                        cd.values, cd.offsets, idx), 3),
                    "equal_numpy": True})
    return out


def host_scan_path(card: str, scan: dict, lineitem: str, rows: int,
                   seed: int, parts: list) -> dict:
    """Phase 5e: the host scan (``scan_expr``) and the routed ``scan()``
    on the files phases 4b, 5b and 5c wrote, each case against a numpy
    oracle over the generated arrays; then ``Dataset.scan`` over the part
    files, ``scan_filtered_sharded`` on cfg 5 and the C++ survivor
    gather.  Returns the host scan planner's bloom probe (case A_in), the
    phase's launches and the operands of the routed device scans' largest
    ``unpack_bits_dense`` launch (None where they launched none: cfg 5 is
    PLAIN, and lineitem's dictionary chunks mix RLE runs into their
    indexes, which ``rle_expand`` decodes)."""
    from parquet_tpu_torch.algebra.expr import col, single_pred

    pq.reset_launches()
    table, cfg5 = scan["cfg5"], scan["cfg5_path"]
    ship = table["l_shipdate"]
    outs = ["l_orderkey", "l_quantity", "l_extendedprice"]
    lo, hi = SCAN_RANGE
    dates = scan["in_dates"]
    cases = {}
    want_range = oracle({c: table[c] for c in outs},
                        (ship >= lo) & (ship <= hi))
    cases["A_range"] = host_scan_case(
        card, "A_range", cfg5, single_pred("l_shipdate", lo=lo, hi=hi), outs,
        want_range, {"path": "l_shipdate", "lo": lo, "hi": hi,
                     "columns": outs})
    want_in = oracle({c: table[c] for c in outs}, np.isin(ship, dates))
    cases["A_in"] = host_scan_case(
        card, "A_in", cfg5, single_pred("l_shipdate", values=dates), outs,
        want_in, {"path": "l_shipdate", "values": dates, "columns": outs})
    a_in = cases["A_in"]["row"]
    if a_in["bloom_check_launches_cold"] != 1 or len(
            cases["A_in"]["probes"]) != 1:
        n = a_in["bloom_check_launches_cold"]
        raise AssertionError(f"host scan A_in: {n} bloom_check launches, "
                             "not 1")
    if a_in["rg_pruned"] != {k: v for k, v in scan["plan_counters"].items()
                             if k.startswith("rg_")}:
        raise AssertionError("host scan A_in: its plan pruned other row "
                             f"groups than the device scan's: {a_in}")
    qty = table["l_quantity"]
    tree = col("l_shipdate").between(9000, 9100) | ~(col("l_quantity") <= 45)
    cases["or_not"] = host_scan_case(
        card, "or_not", cfg5, tree, TREE_COLS,
        oracle({c: table[c] for c in TREE_COLS},
               ((ship >= 9000) & (ship <= 9100)) | ~(qty <= 45)))
    del want_in
    # TPC-H Q6 whole, on lineitem
    _, data = make_lineitem(rows, seed)
    v = {c: data[c].values for c in ("l_shipdate", "l_discount",
                                     "l_quantity", "l_extendedprice")}
    q6 = ((v["l_shipdate"] >= Q6_DATES[0]) & (v["l_shipdate"] <= Q6_DATES[1])
          & (v["l_discount"] >= Q6_DISCOUNT[0])
          & (v["l_discount"] <= Q6_DISCOUNT[1])
          & (v["l_quantity"] <= Q6_QUANTITY))
    cases["q6"] = host_scan_case(card, "q6", lineitem, q6_tree(), Q6_OUT,
                                 oracle({c: v[c] for c in Q6_OUT}, q6))
    got = cases["q6"]["out"]
    revenue = float(np.sum(got["l_extendedprice"] * got["l_discount"]))
    want_rev = float(np.sum(v["l_extendedprice"][q6] * v["l_discount"][q6]))
    if abs(revenue - want_rev) > 1e-9 * abs(want_rev):
        raise AssertionError(f"Q6 revenue {revenue} != {want_rev}")
    log({"q6": {"card": card, "revenue": revenue, "oracle": want_rev,
                "rows": int(q6.sum()), "equal_to_rounding": True}})
    # the routed scan, three ways a case
    largest = LargestLaunch("unpack_bits_dense")
    routed = []
    routed.append(routed_case(card, "A_range", cfg5, "l_shipdate",
                              {"lo": lo, "hi": hi}, outs, want_range,
                              largest))
    routed.append(routed_case(card, "A_in", cfg5, "l_shipdate",
                              {"values": dates}, outs,
                              oracle({c: table[c] for c in outs},
                                     np.isin(ship, dates)), largest))
    b_mask = (v["l_shipdate"] >= Q6_DATES[0]) & (v["l_shipdate"] <=
                                                  Q6_DATES[1])
    routed.append(routed_case(
        card, "B_q6_dates", lineitem, "l_shipdate",
        {"lo": Q6_DATES[0], "hi": Q6_DATES[1]}, Q6_COLUMNS,
        oracle({c: data[c] if data[c].offsets is not None
                else data[c].values for c in Q6_COLUMNS}, b_mask), largest))
    # an IN-list on a PLAIN string key (part 0's l_comment), which the
    # device scan refuses from the footer
    per = -(-rows // DATASET_FILES)
    comment = column_slice(data["l_comment"], 0, per)
    o = comment.offsets
    words = [comment.values[o[i]:o[i + 1]].tobytes()
             for i in (3, per // 2, per - 1)] + [b"absent" * 4]
    mask = np.zeros(per, bool)
    for w in words:
        mask |= rows_equal(comment, w)
    routed.append(routed_case(
        card, "plain_in", parts[0], "l_comment", {"values": words},
        ["l_orderkey", "l_quantity"],
        oracle({c: data[c].values[:per] for c in ("l_orderkey",
                                                  "l_quantity")}, mask),
        largest))
    if routed[-1]["route"] != "host" or "non-dictionary" not in \
            routed[-1]["reason"]:
        raise AssertionError(f"plain_in routed: {routed[-1]}")
    # a dictionary key chunk that falls back to PLAIN mid-chunk: the
    # footer passes it, the device scan refuses it, the scan falls back
    fx = np.load(os.path.join(FIXTURES, "host_route.npz"))
    fo = fx["s_offsets"]
    probe = [fx["s_values"][fo[i]:fo[i + 1]].tobytes() for i in (3, 2500)]
    s_col = ColumnData(values=fx["s_values"], offsets=fo)
    fmask = rows_equal(s_col, probe[0]) | rows_equal(s_col, probe[1])
    routed.append(routed_case(
        card, "page_fallback", os.path.join(FIXTURES, "host_route.parquet"),
        "s", {"values": probe}, ["k"], oracle({"k": fx["k"]}, fmask),
        largest))
    if routed[-1]["runs"]["device"]["route"] != "device" or \
            routed[-1]["runs"]["device"]["ran"] != ["host"]:
        raise AssertionError(f"page_fallback routed: {routed[-1]}")
    for r in routed[:3]:
        if r["runs"]["device"]["ran"] != ["device"]:
            raise AssertionError(f"routed {r['case']}: pinned to the device "
                                 f"it ran {r['runs']['device']}")
    rates = route_rates(routed, card)
    log({"route_rates": rates})
    # Dataset.scan and the sharded scan
    log({"dataset_scan": dataset_scans(card, parts, cases["q6"]["out"])})
    log({"sharded_scan": sharded_scans(card, cfg5)})
    log({"gather_byte_arrays": gather_rows(card, data["l_comment"],
                                           np.flatnonzero(q6))})
    launches = dict(pq.LAUNCHES)
    if launches["bloom_check"] == 0:
        raise AssertionError(f"host scan path: {launches}")
    return {"probe": cases["A_in"]["probes"][0], "launches": launches,
            "operands": largest.operands, "column": largest.column,
            "rates": rates}


def scan_ops(scan: dict) -> list:
    """The scan's filter ops at case A's span shape (the row group of
    1,048,576 rows its range meets first): the range and IN masks on the
    ship dates, the
    survivors' targets and the compaction of the prices, each with the
    profiler's device time a call, its calls in one ``decoded_scan`` of
    each A case and its byte bound."""
    table = scan["cfg5"]
    n = -(-len(table["l_shipdate"]) // SCAN_ROW_GROUPS)
    rg = scan["cases"]["A_range"]["state"]["spans"][0][0].rg_index
    cut = slice(rg * n, (rg + 1) * n)  # the row group the range meets
    ship = torch.from_numpy(table["l_shipdate"][cut]).to(DEVICE)
    price = torch.from_numpy(table["l_extendedprice"][cut]).to(DEVICE)
    probes = torch.tensor(scan["in_dates"], dtype=torch.int32, device=DEVICE)
    lo, hi = SCAN_RANGE
    mask = dev.range_mask(ship, lo, hi)
    tgt, cnt = dev.compact_targets(mask)
    kept = int(cnt)
    calls = {case: scan["cases"][case]["op_calls"]
             for case in ("A_range", "A_in")}

    def by_case(op):
        return {case: c[op] for case, c in calls.items()}

    shape = f"cfg5 row group {rg}: n={ship.numel()}"
    return [
        op_row("range_mask", f"{shape}, int32 in [{lo}, {hi}]",
               lambda: dev.range_mask(ship, lo, hi), 5 * n,
               by_case("range_mask"), {"per": "decoded_scan"}),
        op_row("in_mask", f"{shape}, {probes.numel()} int32 probes",
               lambda: dev.in_mask(ship, probes), 5 * n + 4 * probes.numel(),
               by_case("in_mask"), {"per": "decoded_scan"}),
        op_row("compact_targets", f"{shape}, {kept} kept",
               lambda: dev.compact_targets(mask), 9 * n,
               by_case("compact_targets"), {"per": "decoded_scan"}),
        op_row("compact_prefix", f"{shape}, float64, {kept} kept",
               lambda: dev.compact_prefix(price, tgt), 24 * n,
               by_case("compact_prefix"), {"per": "decoded_scan"}),
    ]


def shape_times(column: str, kernel: str, args: tuple,
                launches: int) -> dict:
    """One read-path shape of a kernel, on a warm card: the kernel bit for
    bit against its plain version; its time per launch from the profiler
    (``ms``, as in every other row) and from a CUDA graph (``graph_ms``);
    its launches at this shape over the main path's reads; its bound, plain
    version and library call; the SM clock, power draw and temperature
    before and after the window.  Fails where a time is missing or the
    path did not launch the kernel at this shape."""
    fn = getattr(kernels, kernel)
    ref = getattr(kernels, kernel + "_ref")
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        raise AssertionError(f"{kernel} differs from its plain version at "
                             f"the {column} shape")
    n, w = args[-2], args[-1]
    call = lambda: fn(*args)  # noqa: E731
    row = {"column": column, "n": n, "w": w, "words": args[0].shape[0],
           "launches": launches, "max_abs_err": max_abs_err(got, want),
           "gpu_before": gpu_sample(), "graph_ms": graph_ms(call),
           "ms": device_ms(call, kernel + "_kernel")}
    row["gpu_after"] = gpu_sample()
    row["call_ms"] = time_ms(call)
    row["plain_ms"] = time_ms(lambda: ref(*args), reps=3, warmup=1,
                              batches=1)
    if kernel == "dict_unpack_gather":
        dictionary = args[1]
        d = dictionary.shape[0]
        idx = (kernels.unpack_bits_dense_ref(args[0], n, w).long()
               & M32).clamp(max=d - 1)
        row.update(d=d, dtype=str(dictionary.dtype),
                   library_ms=device_ms(lambda: dictionary[idx]))
        b, by = dict_bound(n, w, d, dictionary.element_size())
    else:
        row["library_ms"] = None
        b, by = unpack_bound(n, w)
    row.update(bound_ms=b, bound_by=by)
    if launches == 0 or row["graph_ms"] is None or row["ms"] is None:
        raise AssertionError(f"{kernel} at the {column} shape: launches "
                             f"{launches}, graph_ms {row['graph_ms']}, "
                             f"ms {row['ms']}")
    return row


def main_shape_kernels(launches: dict, lookup_launches: dict, shapes: dict,
                       path_launches: dict, probe: tuple, enc: dict,
                       lineitem_launches: dict, nested: dict,
                       scan: dict, more: dict) -> list:
    """Each kernel at the shapes its path gives it.  On the read path, the
    first row group's launches as ``path_operands`` took them: ``k``
    (indexes of a 20,000-entry dictionary, unfused), ``ts`` (the delta
    miniblocks) and ``cat`` (indexes fused with its 200-entry int32
    dictionary), on ``enc`` ``ba_dict`` (the indexes of a 1,000-entry
    byte-array dictionary), and the nested leaves of phase 4d (cfg 4's
    ``ts`` miniblocks, ``tags``'s indexes, ``scores``'s fused gather), and on
    the device scan the largest launch of each unpack kernel in a cold
    ``decoded_scan`` (:data:`SCAN_SHAPES`); a kernel's top-level numbers
    are its first shape's.  On the lookup path one lookup's segmented
    bloom probe (``probe``: every row group's filter and the hashes of the
    keys that survive its statistics stage), and on the scan the
    planner's bloom stage (case A's IN-list: every row group its
    statistics keep), and the host scan planner's (phase 5e's case A_in,
    ``host_scan_shape``).  ``more`` holds each later path's launches by
    kernel and the operands of its largest launch in its cold reads (the
    dataset and sharded reads and the routed device scans,
    :data:`MULTI_SHAPES`), and the host scan's planner probe."""
    scan_launches = scan["launches"]
    rows = {c: shape_times(c, k, shapes[c], path_launches[c])
            for c, k in PATH_SHAPES}
    for c, k in ENC_SHAPES:
        rows[f"enc.{c}"] = shape_times(
            f"enc.{c}", k, enc["shapes"][c],
            enc["column_launches"].get(c, {}).get(k, 0))
    for c, k in CFG4_SHAPES + NEST_MIX_SHAPES:
        rows[f"nested.{c}"] = shape_times(
            f"nested.{c}", k, nested["shapes"][c],
            nested["column_launches"].get(c, {}).get(k, 0))
    for case, k in SCAN_SHAPES:
        got = scan["cases"][case]
        if got["operands"] is None:
            raise AssertionError(f"scan {case}: no {k} launch to time")
        rows[f"scan.{case}"] = shape_times(f"scan.{case}", k, got["operands"],
                                           got["launches"][k])
    # the routed device scans may launch no unpack kernel (phase 5e)
    multi = tuple((path, k) for path, k in MULTI_SHAPES
                  if path != "host_scan"
                  or more[path]["operands"] is not None)
    for path, k in multi:
        got = more[path]
        rows[path] = shape_times(f"{path}.{got['column']}", k,
                                 got["operands"], got["launches"][k])
    all_shapes = PATH_SHAPES + tuple(
        (f"enc.{c}", k) for c, k in ENC_SHAPES) + tuple(
        (f"nested.{c}", k) for c, k in CFG4_SHAPES + NEST_MIX_SHAPES) + tuple(
        (f"scan.{case}", k) for case, k in SCAN_SHAPES) + multi
    out = []
    for name, source, line in (
            ("unpack_bits_dense", "unpack_bits.cu", 81),
            ("dict_unpack_gather", "dict_unpack_gather.cu", 166)):
        mine = [rows[c] for c, k in all_shapes if k == name]
        top = mine[0]
        out.append({
            "name": name, "route": "cuda",
            "source": f"parquet_tpu_torch/csrc/{source}",
            "replaces": f"parquet_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "graph_ms": top["graph_ms"],
            "call_ms": top["call_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "path_shapes": mine})

    filters, batches = scan["bloom_probe"]
    blocks, h, starts = segmented_probe(filters, batches)
    got = check_segmented(filters, batches, blocks, h, starts,
                          "at the scan planner's shape")
    scan_shape = {
        "n": h.shape[0], "segments": len(blocks),
        "z": sorted({b.shape[0] for b in blocks}),
        "launches": scan_launches["bloom_check"],
        "max_abs_err": max_abs_err(
            got, kernels.bloom_check_segments_ref(blocks, h, starts)),
        **segmented_times(blocks, h, starts)}
    filters, batches = more["host_scan"]["probe"]
    blocks, h, starts = segmented_probe(filters, batches)
    got = check_segmented(filters, batches, blocks, h, starts,
                          "at the host scan planner's shape")
    host_scan_shape = {
        "case": "host_scan.A_in", "n": h.shape[0], "segments": len(blocks),
        "z": sorted({b.shape[0] for b in blocks}),
        "launches": more["host_scan"]["launches"]["bloom_check"],
        "max_abs_err": max_abs_err(
            got, kernels.bloom_check_segments_ref(blocks, h, starts)),
        **segmented_times(blocks, h, starts)}
    filters, batches = more["lookups"]["probe"]
    blocks, h, starts = segmented_probe(filters, batches)
    got = check_segmented(filters, batches, blocks, h, starts,
                          "at the byte-array lookup's shape")
    byte_array_shape = {
        "case": "url_lookup", "n": h.shape[0], "segments": len(blocks),
        "z": sorted({b.shape[0] for b in blocks}),
        "launches": more["lookups"]["launches"]["bloom_check"],
        "max_abs_err": max_abs_err(
            got, kernels.bloom_check_segments_ref(blocks, h, starts)),
        **segmented_times(blocks, h, starts)}
    filters, batches = probe
    blocks, h, starts = segmented_probe(filters, batches)
    got = check_segmented(filters, batches, blocks, h, starts,
                          "at the lookup's shape")
    want = kernels.bloom_check_segments_ref(blocks, h, starts)
    # the one-filter launch at one row group's shape (the lookup's launch
    # before the probe was segmented)
    n0 = int(starts[1])
    one = kernels.bloom_check(blocks[0], h[:n0])
    b1, by1 = bloom_bound(blocks[0], h[:n0])
    before = gpu_sample()
    times = segmented_times(blocks, h, starts)
    out.append({
        "name": "bloom_check", "route": "cuda",
        "source": "parquet_tpu_torch/csrc/bloom_check.cu",
        "replaces": "parquet_tpu/ops/pallas_kernels.py:216",
        "launches": lookup_launches["bloom_check"],
        "max_abs_err": max(max_abs_err(got, want),
                           max_abs_err(one, got[:n0]),
                           scan_shape["max_abs_err"],
                           host_scan_shape["max_abs_err"],
                           byte_array_shape["max_abs_err"]),
        **times, "gpu_before": before, "gpu_after": gpu_sample(),
        "shape": {"n": h.shape[0], "segments": len(blocks),
                  "z": sorted({b.shape[0] for b in blocks})},
        "one_filter": {
            "n": n0, "z": blocks[0].shape[0],
            "ms": device_ms(lambda: kernels.bloom_check(blocks[0], h[:n0]),
                            "bloom_check_kernel"),
            "call_ms": time_ms(lambda: kernels.bloom_check(blocks[0],
                                                           h[:n0])),
            "bound_ms": b1, "bound_by": by1},
        "scan_shape": scan_shape, "host_scan_shape": host_scan_shape,
        "byte_array_shape": byte_array_shape})
    for k in out:
        k["launches_by_path"] = {"read": launches[k["name"]],
                                 "lookup": lookup_launches[k["name"]],
                                 "lineitem": lineitem_launches[k["name"]],
                                 "enc": enc["launches"][k["name"]],
                                 "nested": nested["launches"][k["name"]],
                                 "nest_mix": nested["mix_launches"][
                                     k["name"]],
                                 "scan": scan_launches[k["name"]],
                                 **{path: got["launches"][k["name"]]
                                    for path, got in more.items()}}
    for k in out:
        if k["max_abs_err"] != 0:
            raise AssertionError(f"{k['name']}: kernel differs from its "
                                 "plain version at the main-path shape")
        if k["ms"] is None:
            raise AssertionError(f"{k['name']}: the profiler recorded no "
                                 "time at the main-path shape")
    return out


# the paths whose phases the summary adds up: (name, the log line with
# the path's rows and warm reads, the breakdown with its columns' phases)
SUMMARY_PATHS = (
    ("5col", ("main_path",), ("breakdown", "columns")),
    ("lineitem", ("lineitem_path",), ("lineitem_breakdown", "columns")),
    ("enc_v1_snappy", ("enc_path", "files", "v1-SNAPPY"),
     ("enc_path", "v1_snappy_columns")),
    ("cfg4", ("nested_path", "cfg4"), ("nested_breakdown", "columns")),
)


def path_summary(objs) -> dict:
    """Per path of a ``chip_smoke.py`` run's printed objects (this
    version's or an earlier one's): the host prescan (``plan_s``), staging
    and decode seconds of one read summed over its chunks, and the best
    warm read's seconds and rows/s."""
    found = {}
    for obj in objs:
        if isinstance(obj, dict):
            found.update(obj)
    out = {}
    for name, read_key, cols_key in SUMMARY_PATHS:
        if read_key[0] not in found or cols_key[0] not in found:
            continue
        read, cols = found, found
        for k in read_key:
            read = read[k]
        for k in cols_key:
            cols = cols[k]
        rows = read.get("rows") or found[read_key[0]].get("rows")
        best = min(read["warm_read_s"])
        out[name] = {ph: (sum(c[ph] for c in cols.values())
                          if all(ph in c for c in cols.values()) else None)
                     for ph in ("plan_s", "pack_s", "h2d_s", "stage_s",
                                "decode_s")}
        out[name].update(
            serial_sum_s=sum(out[name][ph] for ph in ("plan_s", "stage_s",
                                                      "decode_s")),
            best_warm_read_s=best, rows_per_s=rows / best,
            stage_concurrency_peak=read.get("pipeline", {}).get(
                "stage_concurrency_peak"))
    return out


def summarize(path: str) -> int:
    """``--summarize LOG``: the path summary of a saved run's output."""
    objs = []
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    objs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    print(json.dumps({"path_phases": path_summary(objs)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=8_388_608)
    ap.add_argument("--kernel-values", type=int, default=8_388_608)
    ap.add_argument("--lookup-rows", type=int, default=8_388_608)
    ap.add_argument("--lineitem-rows", type=int, default=8_388_608,
                    help="lineitem's rows: a cut of bench.py cfg 7's "
                    "40,000,000")
    ap.add_argument("--enc-rows", type=int, default=2_097_152,
                    help="enc's rows: 2,097,152 by default (4,194,304 "
                    "before phase 5j, cut for the script's time)")
    ap.add_argument("--nested-n", type=int, default=8_000_000,
                    help="bench.py's n for cfg 4, which writes n // 4 "
                    "list rows")
    ap.add_argument("--nest-mix-rows", type=int, default=1 << 20)
    ap.add_argument("--scan-rows", type=int, default=8_388_608,
                    help="rows of the scan's bench.py cfg 5 file")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke_sweep.json (none by "
                    "default)")
    ap.add_argument("--summarize", metavar="LOG", default=None,
                    help="print the per-path phase summary of a saved "
                    "run's output (of this or an earlier chip_smoke.py) "
                    "and exit; needs no card")
    args = ap.parse_args(argv)
    if args.summarize:
        return summarize(args.summarize)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log({"card": card, "torch_device": kind, "torch": torch.__version__,
         "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    log({"build_s": time.perf_counter() - t0})

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)
    sweep = sweep_unpack(args.kernel_values, gen)
    sweep += sweep_dict(args.kernel_values, gen)
    sweep += sweep_bloom([n for n in BLOOM_N if n <= args.kernel_values]
                         or [args.kernel_values], BLOOM_Z, args.seed)
    sweep += sweep_bloom_segments(args.seed)
    for row in sweep:
        log(row)

    phase_s = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.perf_counter() - t0

    h2d = phase("3b_h2d", h2d_peak, card)
    log({"h2d_peak": h2d})

    with tempfile.TemporaryDirectory() as tmp:
        read = phase("4_read", main_path, args.rows, args.seed, tmp)
        item = phase("4b_lineitem", lineitem_path, args.lineitem_rows,
                     args.seed, tmp)
        enc = phase("4c_enc", enc_path, args.enc_rows, args.seed, tmp)
        enc["shapes"] = path_operands(enc["path"], ENC_SHAPES)
        nested = phase("4d_nested", nested_path, args.nested_n,
                       args.nest_mix_rows, args.seed, tmp)
        nested["shapes"] = {**path_operands(nested["path"], CFG4_SHAPES),
                            **path_operands(nested["mix_path"],
                                            NEST_MIX_SHAPES)}
        phase("4e_prescan", prescan_path, read, item, enc, nested)
        look = phase("5_lookup", lookup_path, args.lookup_rows, args.seed,
                     tmp)
        scan = phase("5b_scan", scan_path, card, args.scan_rows, args.seed,
                     tmp, item["path"], args.lineitem_rows, look["path"],
                     args.lookup_rows)
        multi = phase("5c_dataset", dataset_path, card, args.lineitem_rows,
                      args.seed, tmp, item)
        sharded = phase("5d_sharded", sharded_path, card, item["path"],
                        args.lineitem_rows, args.seed)
        hscan = phase("5e_host_scan", host_scan_path, card, scan,
                      item["path"], args.lineitem_rows, args.seed,
                      multi["paths"])
        leftovers = phase("5f_lookups", lookup_leftovers_path, card,
                          args.lineitem_rows, args.seed, tmp)
        struct = phase("5f_struct_keys", struct_lookup_path, card,
                       args.lookup_rows, args.seed, tmp)
        resilience = phase("5g_resilience", resilience_path, card, read,
                           scan, look["path"], args.lookup_rows,
                           multi["paths"], args.seed, tmp)
        stream = phase("5h_stream", stream_path, card, read, item, nested,
                       multi["paths"])
        typed_rows = phase("5i_typed_rows_merge", typed_rows_merge_path,
                           card, args.seed, tmp)
        aggregate = phase("5j_aggregate", aggregate_path, card,
                          args.lineitem_rows, args.seed, tmp, item["path"])
        write = phase("5k_write", write_path, card, read, tmp)
        table = phase("5l_table", table_path, card, args.lineitem_rows,
                      args.seed, tmp, multi["paths"])
        debug = phase("5m_debug", debug_path, card, read, look["path"],
                      args.lookup_rows, args.seed, tmp)
        remote = phase("5n_remote", remote_path, card, read, look["path"],
                       args.lookup_rows, args.seed, multi["paths"],
                       aggregate)
        obs = phase("5o_obs", obs_path, card, read, look["path"],
                    args.lookup_rows, args.seed, multi["paths"], tmp)
        serve = phase("5p_serve", serve_path, card, read, look["path"],
                      args.lookup_rows, aggregate["path"], args.seed, tmp)
        fleet = phase("5q_fleet", fleet_path, card, args.seed, tmp)
        # the short profiler windows of the kernels and ops come before
        # the profiled reads and lookup: after such a long window the
        # profiler can drop every event of a short one
        kern = phase("6_kernels", main_shape_kernels, read["launches"],
                     look["launches"], read["shapes"],
                     read["path_launches"], look["probe"], enc,
                     item["launches"], nested, scan,
                     {"dataset": multi, "sharded": sharded,
                      "host_scan": hscan, "lookups": leftovers,
                      "struct_keys": struct, "resilience": resilience,
                      "stream": stream, "typed_rows_merge": typed_rows,
                      "aggregate": aggregate, "write": write,
                      "table": table, "debug": debug,
                      "remote": remote, "obs": obs, "serve": serve,
                      "fleet": fleet})
        ops = phase("6_ops", torch_ops, enc["path"], item["path"], nested,
                    h2d)
        ops += phase("6_scan_ops", scan_ops, scan)
        t0 = time.perf_counter()
        # the scans' short windows before the reads' and the lookup's
        # long ones, after which the profiler can drop a short window's
        # events
        log({"scan_breakdown": {
            name: {"card": card, **device_profile(
                lambda c=c: timed_scan(c["state"]), "decoded_scan")}
            for name, c in scan["cases"].items()}})
        log({"breakdown": {"columns": read["columns"],
                           **audited_read(read["path"])}})
        log({"lineitem_breakdown": {"columns": item["columns"],
                                    **audited_read(item["path"])}})
        log({"nested_breakdown": {"columns": nested["columns"],
                                  **audited_read(nested["path"])}})
        look["warm"]()  # fills the caches sized to the working set
        log({"lookup_breakdown": {
            **look["stages"], "card": card,
            "cold_defaults": device_profile(look["cold"], "lookup"),
            "warm_working_set_caches": device_profile(look["warm"],
                                                      "lookup")}})
        phase_s["7_profiled"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log({"stream_breakdown": stream_breakdown(card, read["path"])})
        phase_s["7c_stream_breakdown"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log({"pipeline_breakdown": {name: pipeline_breakdown(path) for name,
                                    path in (("5col", read["path"]),
                                             ("lineitem", item["path"]),
                                             ("enc_v1_snappy", enc["path"]),
                                             ("cfg4", nested["path"]),
                                             ("nest_mix",
                                              nested["mix_path"]))}})
        phase_s["7b_pipeline"] = time.perf_counter() - t0
    log({"path_phases": path_summary(LOGGED)})
    log({"phase_s": phase_s, "profiler_fallbacks": PROFILER_FALLBACKS})

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_sweep.json"), "w") as f:
            json.dump({"card": card, "sweep": sweep, "kernels": kern,
                       "ops": ops}, f, indent=1)
    log({"ops": ops})
    log(card)
    log({"kernels": kern})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
