#!/usr/bin/env python3
"""A benchmark cell's window as the program's spans record it: a study,
not a run of the benchmark.

    python tools/chunk_study.py --workload <cell> --seed <n> --seconds <s> --out <dir>

Set-up and the window as ``portbench/run.py`` makes them (the same driver,
seed and closed loop of chunks), then one chunk under ``torch.profiler``.
Writes ``<dir>/<cell>.<seed>.chunks.jsonl``, every chunk record of
``border_tpu_torch.utils.profiling`` (the window's carry neither flag),
and prints one JSON line: the window's env steps a second, the four
per-layer metrics as the benchmark's readers compute them, the medians of
the window's host spans and of the ``detail`` split (where the level is
``detail``), the window's records averaged in bins of ``--bin`` seconds
from its start, the set-up spans' host seconds, the graphs' counters,
and the profiled chunk's longest idle gaps of the device, each with the
innermost program span and the innermost host operation running when it
began.  The tracing level is the program's (``BORDER_TPU_TRACE``).
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402
from portbench.chunks import window_median  # noqa: E402

METRICS = ("span_env_step_ms", "span_update_ms", "chunk_gap_ms", "first_launch_ms")


def _bins(window, t0_ns, width):
    """Per ``width`` seconds of the window: chunks, and the mean of each
    chunk number."""
    keys = {"env_ms": lambda r: r["device_ms"].get("chunk.env"),
            "update_ms": lambda r: r["device_ms"].get("chunk.update"),
            "gap_ms": lambda r: r["gap_ms"],
            "first_launch_ms": lambda r: r["first_launch_ms"],
            "host_chunk_ms": lambda r: r["host_ms"].get("chunk"),
            "host_metrics_ms": lambda r: r["host_ms"].get("metrics_to_host")}
    out = {}
    for r in window:
        out.setdefault(int((r["t_ns"] - t0_ns) / 1e9 // width), []).append(r)
    return [{"from_s": b * width, "chunks": len(rs),
             **{k: _mean([f(r) for r in rs]) for k, f in keys.items()}}
            for b, rs in sorted(out.items())]


def _mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def named_gaps(prof, top: int = 10):
    """The device's ``top`` longest idle gaps in a profile, each with the
    innermost program span (a user annotation on the host) and the
    innermost host operation running when it began."""
    import torch

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    notes = [e for e in events if getattr(e, "is_user_annotation", False)
             and e.device_type != cuda]
    names = {e.name for e in notes}
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and e.name not in names)
    busy = []
    for a, b in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    host = sorted((e for e in events if e.device_type != cuda and e.name not in names),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]

    def innermost(pool, t):
        inside = [e for e in pool if e.time_range.start <= t <= e.time_range.end]
        return min(inside, key=lambda e: e.time_range.end - e.time_range.start,
                   default=None)

    out = []
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        op = innermost(host[max(0, i - 2000):i], a)
        span = innermost(notes, a)
        out.append({"ms": (b - a) / 1e3, "span": span.name if span else None,
                    "op": op.name[:80] if op else None})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/chunk_study.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bin", type=float, default=5.0)
    args = p.parse_args(argv)
    files = run.cell_files(args.workload)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from border_tpu_torch.train import graphs
    from border_tpu_torch.utils import profiling

    device = torch.device("cuda", 0)
    torch.cuda.init()
    drv = run.build(files, args.seed, device)
    setup_spans: dict = {}
    for sp in profiling.spans():
        if not sp["name"].startswith(("chunk", "metrics_to_host", "update.")):
            ns = setup_spans.get(sp["name"], 0) + sp["t1_ns"] - sp["t0_ns"]
            setup_spans[sp["name"]] = ns
    setup_spans = {k: round(v / 1e9, 4) for k, v in setup_spans.items()}
    built = dict(graphs.counts)

    t0 = time.perf_counter()
    chunks = 0
    while True:
        drv.chunk()
        chunks += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drv.chunk()
        torch.cuda.synchronize()
    gaps = named_gaps(prof)

    recs = profiling.chunk_records()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.workload}.{args.seed}.chunks.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    window = [r for r in recs if not r["built"] and not r["profiled"]]
    line = {
        "workload": args.workload, "seed": args.seed, "level": profiling.level_name(),
        "device": torch.cuda.get_device_name(device), "power_limit": run.power_limit(),
        "chunks": chunks, "seconds": seconds,
        "env_steps_per_s": chunks * drv.env_steps_per_chunk / seconds,
        "records": len(window),
        **{m: importlib.import_module(f"portbench.metrics.{m}").read({})
           for m in METRICS},
        "host_ms": {k: window_median(lambda r, k=k: r["host_ms"].get(k))
                    for k in ("chunk", "chunk.env", "chunk.update",
                              "chunk.sync_counters", "metrics_to_host")},
        "update_split_ms": {k: window_median(
            lambda r, k=k: r.get("update_split_ms", {}).get(k))
            for k in sorted({k for r in window for k in r.get("update_split_ms", {})})},
        "bins": _bins(window, window[0]["t_ns"], args.bin) if window else [],
        "setup_spans_s": setup_spans, "graph_counts_setup": {
            f"{k[0]}/{k[1]}": v for k, v in built.items()},
        "graph_counts_after": {f"{k[0]}/{k[1]}": v for k, v in graphs.counts.items()},
        "profiled_gaps": gaps,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
