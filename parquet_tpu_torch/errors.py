"""Exceptions and hard format limits of the port.

The port's copy of the parts of ``parquet_tpu/errors.py`` its slices
raise: the read hierarchy (:class:`ReadError` and its subclasses) that
``io/faults.py::read_context`` wraps a read's failures in, the schema's
and the writer's limits (:class:`MissingRootColumnError`,
:class:`ColumnTooDeepError`, :class:`TooManyRowGroupsError`),
:class:`WriteError`, and the remote sources' hierarchy under
:class:`RemoteError` (``io/remote.py`` raises it).
"""


class CorruptedError(Exception):
    """The file's bytes do not form a valid Parquet file."""


class ReadError(CorruptedError):
    """A read failure with its place: file path, row-group ordinal, column
    dotted path and page offset, named in the message; the low-level
    failure rides as ``__cause__``.  Its subclasses keep the failure
    catchable under its usual base: :class:`ReadIOError` is an
    ``OSError``, :class:`DeadlineError` a ``TimeoutError``."""

    def __init__(self, message: str, path=None, row_group=None, column=None,
                 page_offset=None):
        loc = []
        if path is not None:
            loc.append(f"file={path}")
        if row_group is not None:
            loc.append(f"row-group={row_group}")
        if column is not None:
            loc.append(f"column={column}")
        if page_offset is not None:
            loc.append(f"page-offset={page_offset}")
        super().__init__(f"[{' '.join(loc)}] {message}" if loc else message)
        self.path = path
        self.row_group = row_group
        self.column = column
        self.page_offset = page_offset


class ReadIOError(ReadError, OSError):
    """An ``OSError`` of the byte source, with its place in the file."""


class DeadlineError(ReadError, TimeoutError):
    """A read ran past its ``FaultPolicy.deadline_s`` (checked between
    preads and before each retry's sleep)."""


class ShortReadError(ReadIOError):
    """A source gave fewer bytes than asked (a torn file, a buggy mount):
    corruption, never retried.  ``read_context`` adds the place where the
    source raised without one."""


class RemoteError(ReadIOError):
    """A remote source's failure with its network context: host, HTTP
    status, attempt and byte range, named in the message.  ``retryable``
    is what the retry loop (``io/faults.py::is_corrupt_oserror``) reads:
    a transient failure (refused or reset connection, 5xx, 429, a stalled
    or torn body) is tried again under the policy's backoff, a terminal
    one (another 4xx, an unsatisfiable range) raises at once and is
    dropped like corruption by ``on_corrupt='skip_row_group'``."""

    retryable = False

    def __init__(self, message: str, host=None, status=None, attempt=None,
                 offset=None, size=None, path=None):
        loc = []
        if host is not None:
            loc.append(f"host={host}")
        if status is not None:
            loc.append(f"status={status}")
        if attempt is not None:
            loc.append(f"attempt={attempt}")
        if offset is not None and size is not None:
            loc.append(f"range={offset}+{size}")
        ReadError.__init__(
            self, f"{message} [{' '.join(loc)}]" if loc else message,
            path=path)
        self.host = host
        self.status = status
        self.attempt = attempt
        self.offset = offset
        self.size = size


class RemoteTransientError(RemoteError):
    """A retryable remote failure: a refused or reset connection, 5xx, a
    stalled or torn body, a wrong range."""

    retryable = True


class RemoteThrottledError(RemoteTransientError):
    """HTTP 429: retryable, and the retry loop waits at least the server's
    ``Retry-After`` seconds (``retry_after``) before the next attempt."""

    def __init__(self, message: str, retry_after=None, **kw):
        super().__init__(message, **kw)
        self.retry_after = retry_after


class RemoteTerminalError(RemoteError):
    """A remote answer a retry cannot change: 4xx, an unsatisfiable
    range.  Classified as corruption."""


class RemoteCircuitOpenError(RemoteTransientError):
    """The refusal of a host's open circuit breaker
    (``io/remote.py::CircuitBreaker``): the request never reached the
    network.  Retryable: the policy's backoff is the pause the breaker
    wants, and a later attempt may be its half-open probe."""


class WriteError(OSError):
    """A write failure with its destination: the target path and, for an
    atomic sink, the temporary file the bytes live in.  An ``OSError``, so
    ``except OSError`` still catches it; the low-level failure rides as
    ``__cause__``."""

    def __init__(self, message: str, path=None, temp_path=None):
        loc = []
        if path is not None:
            loc.append(f"dest={path}")
        if temp_path is not None:
            loc.append(f"temp={temp_path}")
        super().__init__(f"[{' '.join(loc)}] {message}" if loc else message)
        self.path = path
        self.temp_path = temp_path


class MissingRootColumnError(CorruptedError):
    """The schema has no root element."""


class TooManyRowGroupsError(ValueError):
    """A file would hold more than :data:`MAX_ROW_GROUPS` row groups."""


class ColumnTooDeepError(ValueError):
    """A column lies deeper than :data:`MAX_COLUMN_DEPTH` nodes."""


# page sizes are i32 in the thrift structs
MAX_PAGE_SIZE = (1 << 31) - 1
# a column index or offset index longer than this is corruption
MAX_COLUMN_INDEX_SIZE = 16 * 1024 * 1024
# a page header longer than this is corruption (the streamed walk's cap)
MAX_PAGE_HEADER_SIZE = 1 << 20
# nodes on a column's path, below the root (the JAX package's limit)
MAX_COLUMN_DEPTH = 16
# a row group's ordinal is an i16
MAX_ROW_GROUPS = 1 << 15


def unsupported(what: str, slice_name: str) -> NotImplementedError:
    """The error for a file feature the port does not read at all (neither
    its device route nor its host decode): it names the later slice that
    brings it."""
    return NotImplementedError(
        f"{what} is not supported yet by parquet_tpu_torch "
        f"(planned slice: {slice_name})")


class _Unsupported(Exception):
    """The device route cannot decode this chunk; its host decode can.

    ``reason`` is the chunk kind's key in
    ``parallel/device_reader.HOST_ROUTE``.  Only the read's chunk loop
    catches it, and sends the chunk to ``io/reader.decode_chunk_host``."""

    def __init__(self, reason: str, what: str):
        super().__init__(f"{what} ({reason}): the chunk takes the host "
                         "decode")
        self.reason = reason
