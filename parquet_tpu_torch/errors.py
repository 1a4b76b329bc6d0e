"""Exceptions and hard format limits of the port.

The port's copy of the parts of ``parquet_tpu/errors.py`` its slices
raise: the read hierarchy (:class:`ReadError` and its subclasses) that
``io/faults.py::read_context`` wraps a read's failures in, the schema's
and the writer's limits (:class:`MissingRootColumnError`,
:class:`ColumnTooDeepError`, :class:`TooManyRowGroupsError`) and
:class:`WriteError`.  The remote errors come with ``io/remote.py``.
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
