"""Readings that the limits of a cell are set from, all seeds in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...]

For each seed: the program's set-up at the cell's own size (the same
object and chunks as a run's, without the window), then the comparison
with the reference by the check of the configuration's driver
(``reference/checks/<driver>.py``), and on the same inputs the control
(the reference one precision step below the configuration's) and the
planted faults that the check reads, each against the reference.  One
JSON line a seed, then one line of the largest program reading and the
smallest control and fault readings of each number.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    files = run.cell_files(args.workload)

    import torch

    from portbench.reference import checks

    check = checks.find(files["cfg"])
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        drv = run.build(files, seed, device)
        obs = drv.observations()
        drv.free()
        del drv
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = check.numbers(obs, files["cfg"], files["wl"], seed, device,
                             controls=True)
        nums.update(seed=seed, setup_s=t_ref - t, check_s=time.perf_counter() - t_ref)
        rows.append(nums)
        print(json.dumps(nums), flush=True)
    names = [k for k in rows[0] if "." not in k and k not in ("seed", "setup_s", "check_s")]
    sides = dict.fromkeys(k.split(".")[0] for k in rows[0] if "." in k)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in names:
        summary[k] = {"program_max": max(r[k] for r in rows)}
        for side in sides:
            key = f"{side}.{k}"
            if key in rows[0]:
                summary[k][f"{side}_min"] = min(r[key] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
