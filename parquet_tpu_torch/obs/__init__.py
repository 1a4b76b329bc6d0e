"""obs layer of parquet_tpu_torch: the process-wide metrics registry."""
