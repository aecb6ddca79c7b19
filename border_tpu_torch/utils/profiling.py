"""Profiler hooks (≙ border_tpu/utils/profiling.py).

The trainers already emit the reference's coarse wall-clock averages
(``average_opt_time`` / ``average_sample_time``) as records;
:func:`profile_trace` adds a device trace through ``torch.profiler``, and
:class:`Stopwatch` accumulates wall-clock time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is present) and write a Chrome trace,
    ``<log_dir>/trace_<pid>_<n>.json`` (viewable in Perfetto or
    ``chrome://tracing``).

    No-op when ``log_dir`` is falsy, so call sites can leave it wired.
    """
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class Stopwatch:
    """Accumulating wall-clock timer (≙ the SystemTime delta accumulation
    in trainer.rs:163-174)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total / max(self.count, 1)
