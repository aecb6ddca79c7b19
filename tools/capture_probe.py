#!/usr/bin/env python3
"""Which calls made outside a CUDA-graph capture's own operations
invalidate it (ROADMAP C.6): each case in a process of its own, in both
capture modes (``global``, the default, and ``thread_local``).

A capture of three elementwise operations on a side stream, while in the
middle of it

- ``thread_*``: another thread queries an event, synchronizes the device,
  allocates a new segment, copies to the device or pins host memory;
- ``gc_*``: a collection frees a dead object held in a reference cycle: a
  graph captured and replayed before, a CUDA event, a pinned tensor, or an
  object whose finalizer synchronizes the device;
- ``none`` and ``profiler_before`` (after a ``torch.profiler`` trace with
  CUDA activity): 200 captures with nothing in the middle.

Usage, from the root of a checkout, on a GPU::

    python tools/capture_probe.py

Prints one JSON line a case and mode: captures, failures, the first
failure, the other thread's error and the process's thread names.
"""

import gc
import json
import os
import subprocess
import sys
import threading

CASES = ("none", "thread_event_query", "thread_synchronize", "thread_malloc",
         "thread_h2d", "thread_pinned", "gc_dead_graph", "gc_dead_event",
         "gc_dead_pinned", "gc_del_synchronize", "profiler_before")


def _threads() -> list:
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                names.append(f.read().strip())
        except OSError:
            pass
    return sorted(names)


class _Cycle:
    def __init__(self, held=None):
        self.me, self.held = self, held


def case(name: str, mode: str) -> dict:
    import torch

    dev = torch.device("cuda")
    x = torch.randn(1024, device=dev)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # the body's operations, made before
        for _ in range(3):
            torch.sin(torch.cos(x)) * 2
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    go, done, err = threading.Event(), threading.Event(), []

    def other():
        go.wait()
        try:
            if name == "thread_event_query":
                e = torch.cuda.Event()
                e.record(torch.cuda.default_stream())
                e.query()
            elif name == "thread_synchronize":
                torch.cuda.synchronize()
            elif name == "thread_malloc":
                torch.empty(123_456_789, dtype=torch.uint8, device=dev)
            elif name == "thread_h2d":
                torch.ones(1000).to(dev)
            elif name == "thread_pinned":
                torch.ones(1000).pin_memory()
        except RuntimeError as e:
            err.append(f"{type(e).__name__}: {str(e).splitlines()[0]}")
        done.set()

    class SyncOnDel(_Cycle):
        def __del__(self):
            torch.cuda.synchronize()

    if name.startswith("thread_"):
        threading.Thread(target=other, daemon=True).start()
    elif name == "gc_dead_graph":
        g0 = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g0, stream=s):
            z = x * 3
        g0.replay()
        torch.cuda.synchronize()
        _Cycle((g0, z))
        del g0, z
    elif name == "gc_dead_event":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        torch.cuda.synchronize()
        _Cycle(e)
        del e
    elif name == "gc_dead_pinned":
        p = torch.ones(4096).pin_memory()
        p.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        _Cycle(p)
        del p
    elif name == "gc_del_synchronize":
        SyncOnDel()
    elif name == "profiler_before":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                torch.sin(x)
            torch.cuda.synchronize()
        prof.key_averages()
    n = 200 if name in ("none", "profiler_before") else 1
    failures, first = 0, None
    for _ in range(n):
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=s,
                                  capture_error_mode=mode):
                y = torch.cos(x)
                if name.startswith("thread_"):
                    go.set()
                    done.wait(10)
                elif name.startswith("gc_"):
                    gc.collect()
                y = torch.sin(y) * 2
        except RuntimeError as e:
            failures += 1
            first = first or f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        torch.cuda.synchronize()
    return {"case": name, "mode": mode, "captures": n, "failures": failures,
            "first_failure": first, "other_thread_error": err,
            "threads": _threads()}


def main() -> int:
    if len(sys.argv) == 3:
        print(json.dumps(case(sys.argv[1], sys.argv[2])), flush=True)
        return 0
    for name in CASES:
        for mode in ("global", "thread_local"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), name, mode],
                               capture_output=True, text=True, timeout=300)
            print(p.stdout.strip().splitlines()[-1] if p.returncode == 0 else json.dumps(
                {"case": name, "mode": mode, "rc": p.returncode,
                 "stderr": p.stderr[-1500:]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
