"""Device timing and profiler reading, the benchmark's own.

``profiled(run)``: ``run()`` under ``torch.profiler`` (CPU and CUDA
activities), ending in a device sync, reduced to what the per-layer
metrics read: the traced wall on the host clock, the device's busy time
(the union of its kernel, copy and set intervals), launches, kernel rows
by name (``self_device_time_total``, annotation rows left out: the
optimizer's step annotation spans its kernels and the gaps between
them), and the longest idle gaps of the device with the host operation
that was running when each began.

``device_ms(run, n)``: CUDA events around ``run()`` while the card
sleeps behind ``torch.cuda._sleep`` until the host has queued all of it,
so the events hold device time only; milliseconds per step.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List

import torch

SLEEP_CYCLES = 400_000_000  # ~0.2 s at 1.98 GHz: covers the host's queuing


def device_ms(run: Callable[[], None], n: int) -> float:
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record()
    run()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / n


def _union(intervals: List[tuple]) -> List[list]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profiled(run: Callable[[], None], top: int = 10) -> Dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda and e.name not in annotations]
    host = [e for e in events if e.device_type != cuda]
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and e.key not in annotations]
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the device's idle gaps inside the traced stretch, each named by the
    # innermost host event running when it began
    gaps = sorted(([b0[1], b1[0]] for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]

    def doing(t: float) -> str:
        i = bisect.bisect_right(starts, t)
        for e in reversed(host[max(0, i - 2000):i]):
            if e.time_range.end >= t:
                return e.name[:80]
        return "no host event"

    return {
        "wall_s": wall,
        "busy_s": busy_us / 1e6,
        "launches": sum(e.count for e in rows),
        "rows": {e.key: (e.count, e.self_device_time_total / 1e6) for e in rows},
        "device_ops": [[e.key[:80], e.self_device_time_total / 1e6]
                       for e in rows[:top]],
        "idle_gaps": [[doing(a), (b - a) / 1e6] for a, b in gaps],
    }
