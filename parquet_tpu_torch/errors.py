"""Exceptions and hard format limits of the port.

The port's copy of the parts of ``parquet_tpu/errors.py`` this slice raises.
"""


class CorruptedError(Exception):
    """The file's bytes do not form a valid Parquet file."""


# page sizes are i32 in the thrift structs
MAX_PAGE_SIZE = (1 << 31) - 1
# nodes on a column's path, below the root (the JAX package's limit)
MAX_COLUMN_DEPTH = 16


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
