"""parquet.thrift struct definitions, cut to what flat-column reads,
writes and point lookups touch.

The port's copy of ``parquet_tpu/format/metadata.py``.  Field ids, names and
types mirror the Apache Parquet thrift IDL, so a file written by either
package reads back in the other.  Every member of the ``LogicalType``
union that the JAX package knows is read, and so are the footer's column
orders, a chunk's page encoding stats and size statistics and the
encryption structs (declared so a reader keeps them, as the JAX package
declares them).
"""

from __future__ import annotations

from .thrift import TType as T
from .thrift import thrift_struct

_L = lambda elem: (T.LIST, elem)  # noqa: E731
_S = lambda cls: (T.STRUCT, cls)  # noqa: E731


def _empty(name):
    @thrift_struct
    class _E:
        _FIELDS = []

    _E.__name__ = _E.__qualname__ = name
    return _E


@thrift_struct
class Statistics:
    _FIELDS = [
        (1, "max", T.BINARY),  # deprecated (physical order)
        (2, "min", T.BINARY),  # deprecated
        (3, "null_count", T.I64),
        (4, "distinct_count", T.I64),
        (5, "max_value", T.BINARY),  # logical order
        (6, "min_value", T.BINARY),
        (7, "is_max_value_exact", T.BOOL),
        (8, "is_min_value_exact", T.BOOL),
    ]


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
StringType = _empty("StringType")
MapType = _empty("MapType")
ListType = _empty("ListType")
EnumType = _empty("EnumType")
DateType = _empty("DateType")
NullType = _empty("NullType")
JsonType = _empty("JsonType")
BsonType = _empty("BsonType")
UUIDType = _empty("UUIDType")
Float16Type = _empty("Float16Type")
MilliSeconds = _empty("MilliSeconds")
MicroSeconds = _empty("MicroSeconds")
NanoSeconds = _empty("NanoSeconds")


@thrift_struct
class DecimalType:
    _FIELDS = [(1, "scale", T.I32), (2, "precision", T.I32)]


@thrift_struct
class TimeUnit:  # union
    _FIELDS = [(1, "MILLIS", _S(MilliSeconds)),
               (2, "MICROS", _S(MicroSeconds)),
               (3, "NANOS", _S(NanoSeconds))]


@thrift_struct
class TimestampType:
    _FIELDS = [(1, "isAdjustedToUTC", T.BOOL), (2, "unit", _S(TimeUnit))]


@thrift_struct
class TimeType:
    _FIELDS = [(1, "isAdjustedToUTC", T.BOOL), (2, "unit", _S(TimeUnit))]


@thrift_struct
class IntType:
    _FIELDS = [(1, "bitWidth", T.I8), (2, "isSigned", T.BOOL)]


@thrift_struct
class LogicalType:  # union
    _FIELDS = [(1, "STRING", _S(StringType)), (2, "MAP", _S(MapType)),
               (3, "LIST", _S(ListType)), (4, "ENUM", _S(EnumType)),
               (5, "DECIMAL", _S(DecimalType)), (6, "DATE", _S(DateType)),
               (7, "TIME", _S(TimeType)),
               (8, "TIMESTAMP", _S(TimestampType)),
               (10, "INTEGER", _S(IntType)), (11, "UNKNOWN", _S(NullType)),
               (12, "JSON", _S(JsonType)), (13, "BSON", _S(BsonType)),
               (14, "UUID", _S(UUIDType)), (15, "FLOAT16", _S(Float16Type))]


@thrift_struct
class SchemaElement:
    _FIELDS = [
        (1, "type", T.I32),  # enums.Type
        (2, "type_length", T.I32),
        (3, "repetition_type", T.I32),  # enums.FieldRepetitionType
        (4, "name", T.STRING),
        (5, "num_children", T.I32),
        (6, "converted_type", T.I32),  # enums.ConvertedType
        (7, "scale", T.I32),
        (8, "precision", T.I32),
        (9, "field_id", T.I32),
        (10, "logicalType", _S(LogicalType)),
    ]


# ---------------------------------------------------------------------------
# Page headers
# ---------------------------------------------------------------------------
@thrift_struct
class DataPageHeader:
    _FIELDS = [
        (1, "num_values", T.I32),
        (2, "encoding", T.I32),
        (3, "definition_level_encoding", T.I32),
        (4, "repetition_level_encoding", T.I32),
        (5, "statistics", _S(Statistics)),
    ]


@thrift_struct
class DictionaryPageHeader:
    _FIELDS = [
        (1, "num_values", T.I32),
        (2, "encoding", T.I32),
        (3, "is_sorted", T.BOOL),
    ]


@thrift_struct
class DataPageHeaderV2:
    _FIELDS = [
        (1, "num_values", T.I32),
        (2, "num_nulls", T.I32),
        (3, "num_rows", T.I32),
        (4, "encoding", T.I32),
        (5, "definition_levels_byte_length", T.I32),
        (6, "repetition_levels_byte_length", T.I32),
        (7, "is_compressed", T.BOOL),  # default true
        (8, "statistics", _S(Statistics)),
    ]


@thrift_struct
class PageHeader:
    _FIELDS = [
        (1, "type", T.I32),  # enums.PageType
        (2, "uncompressed_page_size", T.I32),
        (3, "compressed_page_size", T.I32),
        (4, "crc", T.I32),
        (5, "data_page_header", _S(DataPageHeader)),
        (7, "dictionary_page_header", _S(DictionaryPageHeader)),
        (8, "data_page_header_v2", _S(DataPageHeaderV2)),
    ]


# ---------------------------------------------------------------------------
# Bloom filter
# ---------------------------------------------------------------------------
SplitBlockAlgorithm = _empty("SplitBlockAlgorithm")
XxHash = _empty("XxHash")
BloomUncompressed = _empty("BloomUncompressed")


@thrift_struct
class BloomFilterAlgorithm:  # union
    _FIELDS = [(1, "BLOCK", _S(SplitBlockAlgorithm))]


@thrift_struct
class BloomFilterHash:  # union
    _FIELDS = [(1, "XXHASH", _S(XxHash))]


@thrift_struct
class BloomFilterCompression:  # union
    _FIELDS = [(1, "UNCOMPRESSED", _S(BloomUncompressed))]


@thrift_struct
class BloomFilterHeader:
    _FIELDS = [
        (1, "numBytes", T.I32),
        (2, "algorithm", _S(BloomFilterAlgorithm)),
        (3, "hash", _S(BloomFilterHash)),
        (4, "compression", _S(BloomFilterCompression)),
    ]


# ---------------------------------------------------------------------------
# Column / row-group / file metadata
# ---------------------------------------------------------------------------
@thrift_struct
class KeyValue:
    _FIELDS = [(1, "key", T.STRING), (2, "value", T.STRING)]


@thrift_struct
class SortingColumn:
    _FIELDS = [
        (1, "column_idx", T.I32),
        (2, "descending", T.BOOL),
        (3, "nulls_first", T.BOOL),
    ]


@thrift_struct
class PageEncodingStats:
    _FIELDS = [
        (1, "page_type", T.I32),
        (2, "encoding", T.I32),
        (3, "count", T.I32),
    ]


@thrift_struct
class SizeStatistics:
    _FIELDS = [
        (1, "unencoded_byte_array_data_bytes", T.I64),
        (2, "repetition_level_histogram", _L(T.I64)),
        (3, "definition_level_histogram", _L(T.I64)),
    ]


@thrift_struct
class ColumnMetaData:
    _FIELDS = [
        (1, "type", T.I32),  # enums.Type
        (2, "encodings", _L(T.I32)),
        (3, "path_in_schema", _L(T.STRING)),
        (4, "codec", T.I32),  # enums.CompressionCodec
        (5, "num_values", T.I64),
        (6, "total_uncompressed_size", T.I64),
        (7, "total_compressed_size", T.I64),
        (8, "key_value_metadata", _L(_S(KeyValue))),
        (9, "data_page_offset", T.I64),
        (10, "index_page_offset", T.I64),
        (11, "dictionary_page_offset", T.I64),
        (12, "statistics", _S(Statistics)),
        (13, "encoding_stats", _L(_S(PageEncodingStats))),
        (14, "bloom_filter_offset", T.I64),
        (15, "bloom_filter_length", T.I32),
        (16, "size_statistics", _S(SizeStatistics)),
    ]


# the encryption structs, declared so a reader keeps them
EncryptionWithFooterKey = _empty("EncryptionWithFooterKey")


@thrift_struct
class EncryptionWithColumnKey:
    _FIELDS = [(1, "path_in_schema", _L(T.STRING)),
               (2, "key_metadata", T.BINARY)]


@thrift_struct
class ColumnCryptoMetaData:  # union
    _FIELDS = [
        (1, "ENCRYPTION_WITH_FOOTER_KEY", _S(EncryptionWithFooterKey)),
        (2, "ENCRYPTION_WITH_COLUMN_KEY", _S(EncryptionWithColumnKey)),
    ]


@thrift_struct
class ColumnChunk:
    _FIELDS = [
        (1, "file_path", T.STRING),
        (2, "file_offset", T.I64),
        (3, "meta_data", _S(ColumnMetaData)),
        (4, "offset_index_offset", T.I64),
        (5, "offset_index_length", T.I32),
        (6, "column_index_offset", T.I64),
        (7, "column_index_length", T.I32),
        (8, "crypto_metadata", _S(ColumnCryptoMetaData)),
        (9, "encrypted_column_metadata", T.BINARY),
    ]


@thrift_struct
class RowGroup:
    _FIELDS = [
        (1, "columns", _L(_S(ColumnChunk))),
        (2, "total_byte_size", T.I64),
        (3, "num_rows", T.I64),
        (4, "sorting_columns", _L(_S(SortingColumn))),
        (5, "file_offset", T.I64),
        (6, "total_compressed_size", T.I64),
        (7, "ordinal", T.I16),
    ]


TypeDefinedOrder = _empty("TypeDefinedOrder")


@thrift_struct
class ColumnOrder:  # union
    _FIELDS = [(1, "TYPE_ORDER", _S(TypeDefinedOrder))]


# ---------------------------------------------------------------------------
# Page index
# ---------------------------------------------------------------------------
@thrift_struct
class PageLocation:
    _FIELDS = [
        (1, "offset", T.I64),
        (2, "compressed_page_size", T.I32),
        (3, "first_row_index", T.I64),
    ]


@thrift_struct
class OffsetIndex:
    _FIELDS = [
        (1, "page_locations", _L(_S(PageLocation))),
        (2, "unencoded_byte_array_data_bytes", _L(T.I64)),
    ]


@thrift_struct
class ColumnIndex:
    _FIELDS = [
        (1, "null_pages", _L(T.BOOL)),
        (2, "min_values", _L(T.BINARY)),
        (3, "max_values", _L(T.BINARY)),
        (4, "boundary_order", T.I32),  # enums.BoundaryOrder
        (5, "null_counts", _L(T.I64)),
        (6, "repetition_level_histograms", _L(T.I64)),
        (7, "definition_level_histograms", _L(T.I64)),
    ]


@thrift_struct
class AesGcmV1:
    _FIELDS = [
        (1, "aad_prefix", T.BINARY),
        (2, "aad_file_unique", T.BINARY),
        (3, "supply_aad_prefix", T.BOOL),
    ]


@thrift_struct
class AesGcmCtrV1:
    _FIELDS = [
        (1, "aad_prefix", T.BINARY),
        (2, "aad_file_unique", T.BINARY),
        (3, "supply_aad_prefix", T.BOOL),
    ]


@thrift_struct
class EncryptionAlgorithm:  # union
    _FIELDS = [(1, "AES_GCM_V1", _S(AesGcmV1)),
               (2, "AES_GCM_CTR_V1", _S(AesGcmCtrV1))]


@thrift_struct
class FileMetaData:
    _FIELDS = [
        (1, "version", T.I32),
        (2, "schema", _L(_S(SchemaElement))),
        (3, "num_rows", T.I64),
        (4, "row_groups", _L(_S(RowGroup))),
        (5, "key_value_metadata", _L(_S(KeyValue))),
        (6, "created_by", T.STRING),
        (7, "column_orders", _L(_S(ColumnOrder))),
        (8, "encryption_algorithm", _S(EncryptionAlgorithm)),
        (9, "footer_signing_key_metadata", T.BINARY),
    ]


MAGIC = b"PAR1"
