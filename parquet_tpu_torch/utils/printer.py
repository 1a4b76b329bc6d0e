"""Text dumps of a schema, a file's footer and a chunk's pages.

The port of ``parquet_tpu/utils/printer.py`` (parquet-tools style); for
the same file each function returns the JAX package's text, character
for character.
"""

from __future__ import annotations

from ..format.enums import CompressionCodec, Encoding, PageType, Type

__all__ = ["print_schema", "print_file", "print_pages"]


def print_schema(schema, file=None) -> str:
    """The schema tree as text (also printed to ``file`` where given)."""
    out = repr(schema)
    if file is not None:
        print(out, file=file)
    return out


def print_file(pf, file=None) -> str:
    """A :class:`~parquet_tpu_torch.io.reader.ParquetFile` summarized: its
    schema, rows, writer and key/value metadata, then each row group's
    chunks with their type, codec, encodings, sizes, statistics and which
    of a column index, an offset index and a bloom filter they have."""
    from ..io.statistics import decode_statistics

    lines = [repr(pf.schema), ""]
    lines.append(f"num_rows: {pf.num_rows}")
    lines.append(f"created_by: {pf.created_by}")
    kv = pf.key_value_metadata()
    if kv:
        lines.append("key_value_metadata:")
        for k, v in kv.items():
            lines.append(f"  {k} = {v!r}")
    for rg in pf.row_groups:
        lines.append(f"row group {rg.index}: {rg.num_rows} rows")
        for i, chunk in enumerate(rg.rg.columns):
            m = chunk.meta_data
            encs = "/".join(Encoding(e).name for e in (m.encodings or []))
            st = ""
            if m.statistics is not None:
                try:
                    ts = decode_statistics(m.statistics, pf.schema.leaves[i])
                except Exception:  # a statistic the text cannot show
                    ts = None
                if ts is not None:
                    if ts.min_value is not None or ts.max_value is not None:
                        st = f" min={ts.min_value!r} max={ts.max_value!r}"
                    if ts.null_count is not None:
                        st += f" nulls={ts.null_count}"
            flags = []
            if chunk.column_index_offset:
                flags.append("colidx")
            if chunk.offset_index_offset:
                flags.append("offidx")
            if m.bloom_filter_offset:
                flags.append("bloom")
            fl = f" ({','.join(flags)})" if flags else ""
            lines.append(
                f"  {'.'.join(m.path_in_schema or [])}: {Type(m.type).name} "
                f"{CompressionCodec(m.codec).name} [{encs}] "
                f"values={m.num_values} "
                f"compressed={m.total_compressed_size} "
                f"uncompressed={m.total_uncompressed_size}{st}{fl}")
    out = "\n".join(lines)
    if file is not None:
        print(out, file=file)
    return out


def print_pages(pf, rg_index: int = 0, column: int = 0, file=None) -> str:
    """Each page of one chunk: its type, values (rows and nulls of a v2
    page), encoding or dictionary entries, and sizes."""
    path = pf.schema.leaves[column].dotted_path
    reader = pf.row_group(rg_index).column(column)
    lines = [f"row group {rg_index}, column {path!r}:"]
    for i, page in enumerate(reader.pages()):
        h = page.header
        pt = PageType(h.type).name
        if h.data_page_header is not None:
            dph = h.data_page_header
            detail = (f"values={dph.num_values} "
                      f"enc={Encoding(dph.encoding).name}")
        elif h.data_page_header_v2 is not None:
            d2 = h.data_page_header_v2
            detail = (f"values={d2.num_values} rows={d2.num_rows} "
                      f"nulls={d2.num_nulls} enc={Encoding(d2.encoding).name}")
        elif h.dictionary_page_header is not None:
            detail = f"entries={h.dictionary_page_header.num_values}"
        else:
            detail = ""
        lines.append(f"  page {i}: {pt} {detail} "
                     f"compressed={h.compressed_page_size} "
                     f"uncompressed={h.uncompressed_page_size}")
    out = "\n".join(lines)
    if file is not None:
        print(out, file=file)
    return out
