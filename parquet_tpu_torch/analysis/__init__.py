"""Static analysis and the runtime lock checker of parquet_tpu_torch.

The port's copy of ``parquet_tpu/analysis``, with one command in front
(``python -m parquet_tpu_torch analyze [--json]``):

- ``analysis/lint.py``: an AST linter (rules PT000-PT006) over the
  port's tree: metric families declared in ``obs/metrics.py``, knobs read
  through ``utils/env.py``, each ledger account resolved by its own
  module, no ``time.time()`` in deadline math, no swallowed
  ``BaseException``, every lock built by ``utils/locks.py``.
- ``analysis/lockcheck.py``: the report over the lock checker of
  ``utils/locks.py`` (the lock-order graph, its cycles with both
  acquisition stacks, blocking calls under a lock) and the hammer that
  ``analyze`` runs under it.
- ``analysis/knobs.py``: the declaration of every
  ``PARQUET_TPU_TORCH_*`` knob, read through ``utils/env.py``.

Nothing of the port imports this package at run time but ``knobs.py``
(the env accessors load it at their first call).
"""
