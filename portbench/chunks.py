"""The window's chunks as the program records them: the per-layer metrics
``span_env_step_ms``, ``span_update_ms``, ``chunk_gap_ms`` and
``first_launch_ms`` read the chunk records of
``border_tpu_torch.utils.profiling`` (one a ``Trainer._chunk``, device
times from the program's own events, see that module).

In a ``--trace 1`` run the records that carry neither flag are the
window's chunks: set-up's two chunks built the graphs (``built``) and the
chunks traced after the window ran under the profiler (``profiled``).
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional

MIN_CHUNKS = 3


def window_median(value: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The median of ``value(record)`` over the window's chunk records
    where it is not None; None with fewer than :data:`MIN_CHUNKS`, or from
    a program that keeps no chunk records."""
    from border_tpu_torch.utils import profiling

    records = getattr(profiling, "chunk_records", None)
    if records is None:
        return None
    values = [v for r in records() if not r["built"] and not r["profiled"]
              for v in (value(r),) if v is not None]
    return statistics.median(values) if len(values) >= MIN_CHUNKS else None


def per(total: Optional[float], n: int) -> Optional[float]:
    """``total`` over ``n``, None where either is missing."""
    return None if total is None or not n else total / n
