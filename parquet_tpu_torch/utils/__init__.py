"""utils layer of parquet_tpu_torch."""
