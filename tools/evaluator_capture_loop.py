#!/usr/bin/env python3
"""Repeat the chip smoke's capture-heavy phases, or the whole script, and
count the runs whose CUDA-graph capture fails (ROADMAP C.6: the graphed
Evaluator's capture in phase 14 failed once, invalidated by a call outside
the captured operations).

Two loops:

- ``--rounds N``: ``chip_smoke.py``'s phases 6-14 (the fused training
  paths, their breakdowns and traces, the cartpole gate run and SAC on
  Pendulum) N times in this one process, after building the kernel and the
  host envs;
- ``--whole N``: the whole ``chip_smoke.py`` N times, each in its own
  process, from the checkout this file is in (unpack a ``git archive`` and
  run the copy's tool to test the committed files).

Every capture is watched: the threads alive when it starts (Python's and
the process's own), the live ``LoopGraph`` objects, and every collection
of the cyclic garbage collector while it is open, with whether the stream
was capturing then and how many ``LoopGraph`` objects (each holding a
captured graph) the collection freed.  A failed capture prints that record,
so a failure names its cause: a collection inside the capture that freed a
graph, another thread, or neither (a first-time operation).

``--unguarded`` runs the capture as it was before ``LoopGraph._capture``
kept the collector out of it (``graphs.no_collection`` replaced by a null
context), to reproduce the fault.

Usage, from the root of a checkout, on a GPU::

    python tools/evaluator_capture_loop.py --rounds 20
    python tools/evaluator_capture_loop.py --whole 3

Prints a line a round or run and a JSON summary as its last line.  Exits 1
if a run failed.
"""

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONITOR_TAG = "capture monitor: "


def _os_threads() -> list:
    """The names of the process's threads (native ones too)."""
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                names.append(f.read().strip())
        except OSError:
            pass
    return sorted(names)


class CaptureMonitor:
    """Watches every ``LoopGraph`` capture of this process (see the module
    docstring); ``summary()`` counts what it saw."""

    def __init__(self, torch):
        from border_tpu_torch.train.graphs import LoopGraph

        self.torch, self.loops = torch, weakref.WeakSet()
        self.current, self.records, self._start = None, [], None
        init, capture, monitor = LoopGraph.__init__, LoopGraph._capture, self

        def watched_init(graph, *a, **kw):
            init(graph, *a, **kw)
            monitor.loops.add(graph)

        def watched_capture(graph):
            rec = {"name": graph.name, "loopgraphs": len(monitor.loops),
                   "threads": sorted(t.name for t in threading.enumerate()),
                   "os_threads": _os_threads(), "collections": []}
            monitor.current = rec
            try:
                capture(graph)
            except Exception as e:
                rec["error"] = f"{type(e).__name__}: {e}"
                print("capture failed: " + json.dumps(rec), flush=True)
                raise
            finally:
                monitor.current = None
                monitor.records.append(rec)

        LoopGraph.__init__, LoopGraph._capture = watched_init, watched_capture
        gc.callbacks.append(self._on_collection)

    def _on_collection(self, phase, info):
        if self.current is None:
            return
        if phase == "start":
            self._start = (len(self.loops),
                           self.torch.cuda.is_current_stream_capturing())
            return
        loops, capturing = self._start
        self.current["collections"].append({
            "generation": info["generation"], "collected": info["collected"],
            "during_capture": capturing,
            "loopgraphs_freed": loops - len(self.loops)})

    def summary(self) -> dict:
        cols = [c for r in self.records for c in r["collections"]]
        inside = [c for c in cols if c["during_capture"]]
        before = [c for c in cols if not c["during_capture"]]
        return {
            "captures": len(self.records),
            "failed_captures": [r for r in self.records if "error" in r],
            "collections_inside_captures": len(inside),
            "of_them_freeing_graphs": sum(c["loopgraphs_freed"] > 0 for c in inside),
            "collections_before_captures": len(before),
            "of_them_freeing_graphs_before": sum(c["loopgraphs_freed"] > 0
                                                 for c in before),
            "graphs_freed_before_captures": sum(c["loopgraphs_freed"] for c in before),
            "python_threads_seen": sorted({t for r in self.records
                                           for t in r["threads"]}),
            "os_threads_most": max((len(r["os_threads"]) for r in self.records),
                                   default=0),
        }


def _unguard():
    from border_tpu_torch.train import graphs

    graphs.no_collection = contextlib.nullcontext


def _untimed(_label, fn, *args, skipped=None, **kw):
    return fn(*args, **kw)


def rounds(n: int) -> dict:
    """Phases 6-14 ``n`` times in this process."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from border_tpu_torch.ops import _build

    for name in ("frame_gather", "envpool"):
        _build.load(name)
    monitor = CaptureMonitor(torch)
    dev = torch.device("cuda")
    out = {"rounds": 0, "failures": 0, "first_failure": None, "round_s": []}
    for i in range(n):
        seen = len(monitor.records)
        t0 = time.perf_counter()
        try:
            chip_smoke.training_phases(torch, dev, _untimed)
            err = None
        except (Exception, SystemExit) as e:  # noqa: BLE001 — counted
            err = f"{type(e).__name__}: {e}"
        torch.cuda.synchronize()
        chip_smoke._free(torch)
        out["rounds"] += 1
        out["round_s"].append(round(time.perf_counter() - t0, 2))
        if err is not None:
            out["failures"] += 1
            out["first_failure"] = out["first_failure"] or err
        print(f"round {i}: {'FAILED ' + err if err else 'ok'} in "
              f"{out['round_s'][-1]} s, {len(monitor.records) - seen} captures",
              flush=True)
    out["monitor"] = monitor.summary()
    return out


def smoke() -> int:
    """The whole chip_smoke.py in this process, its captures watched."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    monitor = CaptureMonitor(torch)
    code = 0
    try:
        chip_smoke.main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    print(MONITOR_TAG + json.dumps(monitor.summary()), flush=True)
    return code


def whole(n: int, unguarded: bool) -> dict:
    """The whole script ``n`` times, a process each."""
    out = {"runs": 0, "failures": 0, "first_failure": None, "run_s": [],
           "monitors": []}
    for i in range(n):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--smoke"]
                           + (["--unguarded"] if unguarded else []),
                           cwd=ROOT, capture_output=True, text=True, timeout=1500)
        lines = p.stdout.splitlines()
        ok = p.returncode == 0 and any(l.startswith('{"ok": true') for l in lines)
        out["runs"] += 1
        out["run_s"].append(round(time.perf_counter() - t0, 2))
        mon = [json.loads(l[len(MONITOR_TAG):]) for l in lines
               if l.startswith(MONITOR_TAG)]
        out["monitors"].append(mon[0] if mon else None)
        if not ok:
            out["failures"] += 1
            out["first_failure"] = out["first_failure"] or (
                f"rc {p.returncode}: " + "\n".join(lines[-5:]) + p.stderr[-3000:])
        print(f"whole run {i}: {'ok' if ok else 'FAILED rc ' + str(p.returncode)} "
              f"in {out['run_s'][-1]} s; "
              + (json.dumps({k: v for k, v in mon[0].items() if k != 'failed_captures'})
                 if mon else "no monitor line"), flush=True)
        for l in lines:
            if l.startswith(("phase seconds:", "all phases passed")):
                print("  " + l, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=0,
                   help="phases 6-14 this many times in this process")
    p.add_argument("--whole", type=int, default=0,
                   help="the whole chip_smoke.py this many times")
    p.add_argument("--unguarded", action="store_true",
                   help="capture without the collector guard (as before it)")
    p.add_argument("--smoke", action="store_true",
                   help="one whole chip_smoke.py in this process (--whole's runs)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no GPU: the loops capture CUDA graphs", file=sys.stderr)
        return 2
    if args.unguarded:
        _unguard()
    if args.smoke:
        return smoke()
    summary = {"unguarded": args.unguarded}
    if args.rounds:
        summary["rounds"] = rounds(args.rounds)
    if args.whole:
        summary["whole"] = whole(args.whole, args.unguarded)
    print(json.dumps(summary), flush=True)
    return 1 if any(v.get("failures") for v in summary.values()
                    if isinstance(v, dict)) else 0


if __name__ == "__main__":
    raise SystemExit(main())
