"""Per-layer readers, one module per metric (``metrics/<name>.py``), each
with ``read(ctx) -> float | None``.  ``ctx`` holds what a traced run
measured (see ``portbench/run.py``: ``window``, ``chunk_flops``,
``events``, ``chunk_trace``, ``env_trace``, ``cfg``, ``wl``,
``updates_per_chunk``).  A reader that finds nothing to read returns
None and the metric is left out of the line."""
