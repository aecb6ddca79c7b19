"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names a configuration (``configs/<config>.json``,
whose FLOP count is ``flops/<config>.py``) and a traffic mix
(``workloads/<traffic>.json``); ``limits/<cell>.json`` holds the limits
of the compared numbers, and each per-layer metric is read by
``metrics/<name>.py``.  The configuration's ``driver`` is
``drivers/<driver>.py``, judged by ``reference/checks/<driver>.py``; its
``agent.kind`` is built by ``agents/<kind>.py``, with its reference
(parameter shapes, greedy action, loss) in ``reference/kinds/<kind>.py``;
a pixel configuration's ``env`` is ``reference/games/<env>.py``.

A run: set-up (the program imported, its trainer built from the seed with
the benchmark's weights, the two chunks that capture its graphs), then a
closed loop of the trainer's chunk for ``--seconds``, then (``--trace
1``) the per-layer measurements, then the window's chunks on until the
target network's next hard copy (watched), then the check against the
plain reference (``reference/``) once the program is freed.  The last line of
standard output is the result; the compared numbers and their limits are
also the last lines of standard error.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's build caches, at fixed places inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "border_tpu")
TRACE_SECONDS = 1.0  # whole chunks traced: at least one, about this long


def since_process_start() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str) -> dict:
    """The cell's entries and files, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    return {
        "cell": cell, "cfg": cfg,
        "wl": json.loads((HERE / "workloads" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
        "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"],
        "flops": load_file(HERE / "flops" / f"{cell['config']}.py",
                           "portbench_flops_" + cell["config"].replace("-", "_")),
    }


def verdict(readings: dict, limits: dict) -> tuple:
    """``(checks, failed)``: each limited number beside its limit, and the
    names of those over it (a limited number that was not read fails)."""
    checks = {k: {"value": readings.get(k), "limit": lim} for k, lim in limits.items()}
    failed = sorted(k for k, c in checks.items()
                    if c["value"] is None or not c["value"] <= c["limit"])
    return checks, failed


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def build(files: dict, seed: int, device):
    """The program's trainer for the cell, set up from ``seed``."""
    from portbench import seeds, weights
    from portbench.reference import kinds

    cfg = files["cfg"]
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    w0 = weights.make(kinds.find(cfg).shapes(cfg), seeds.weights(seed), device)
    drv = driver.Driver(cfg, files["wl"], seed, device)
    drv.setup(w0)
    return drv


def measure_layers(drv, files: dict, window: dict) -> tuple:
    """The per-layer metrics (``--trace 1``), after the window."""
    from portbench.trace import device_ms, profiled

    cfg = files["cfg"]
    events = {"env_step_ms": device_ms(drv.env_phase, cfg["replay"]["steps_per_chunk"]),
              "update_ms": device_ms(drv.update_phase, drv.updates_per_chunk)}
    drv.sync()
    n = max(1, math.ceil(TRACE_SECONDS * window["chunks"] / window["seconds"]))

    def chunks():
        for _ in range(n):
            drv.chunk()

    chunk_trace = profiled(chunks)
    env_trace = profiled(drv.env_phase)
    drv.sync()
    ctx = {"window": window, "events": events, "chunk_trace": chunk_trace,
           "env_trace": env_trace, "traced_chunks": n, "cfg": cfg, "wl": files["wl"],
           "updates_per_chunk": drv.updates_per_chunk,
           "chunk_flops": files["flops"].chunk_flops(cfg, drv.updates_per_chunk)}
    values = {}
    for m in files["per_layer"]:
        reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                           f"portbench_metric_{m['name'].replace('.', '_')}")
        v = reader.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {"device_ops": chunk_trace["device_ops"],
                 "idle_gaps": chunk_trace["idle_gaps"]}
    return values, breakdown, chunk_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = cell_files(args.workload)

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    t_torch = since_process_start()
    torch.cuda.init()
    device = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(device)

    t_cuda = since_process_start()
    drv = build(files, args.seed, device)
    t = time.perf_counter()
    obs = drv.observations()
    setup_s = since_process_start() - (time.perf_counter() - t)

    # -- the window: the training loop's body, back to back --------------------
    t0, t0_wall = time.perf_counter(), time.time()
    ends = []
    while True:
        drv.chunk()
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= args.seconds:
            break
    chunks, t_end = len(ends), ends[-1]
    window = {"chunks": chunks, "seconds": t_end - t0,
              "env_steps": chunks * drv.env_steps_per_chunk}
    peak = torch.cuda.max_memory_allocated(device)

    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    line: dict = {}
    if args.trace:
        metrics, breakdown, tr = measure_layers(drv, files, window)
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        line["breakdown"] = breakdown
    else:
        values = {"env_steps_per_s": window["env_steps"] / window["seconds"],
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in files["end_to_end"]}

    # -- the check: the target's copy in the program's run, then the rest
    # against the reference once the program is freed -------------------------
    target_mismatch = drv.target_check()
    drv_parts = drv.setup_parts
    drv.free()
    del drv
    gc.collect()
    torch.cuda.empty_cache()
    from portbench.reference.checks import find as find_check

    readings = find_check(files["cfg"]).numbers(obs, files["cfg"], files["wl"],
                                                args.seed, device)
    readings["target_mismatch"] = target_mismatch
    checks, failed = verdict(readings, files["limits"])

    found = forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX package or JAX are loaded: {found}",
              file=sys.stderr)
        return 4
    line = {"correct": not failed,
            "attempted": chunks, "failed": len(failed), "metrics": metrics,
            "device": dev_info, **line,
            "power_limit": power_limit(),
            "not_compared": {k: v for k, v in readings.items() if k not in checks},
            "checks": checks}
    print(json.dumps(line), flush=True)
    parts = {"python and torch": t_torch, "cuda": t_cuda - t_torch, **drv_parts}
    print("setup parts (s): " + json.dumps(parts), file=sys.stderr)
    print(f"window from {t0_wall:.3f} (epoch s), chunk seconds: " + json.dumps(
        [b - a for a, b in zip([t0] + ends, ends)]), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}"
              f"{'' if k not in failed else ' FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
