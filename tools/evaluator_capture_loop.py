#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s phase 14 (SAC on Pendulum through
``Trainer.train()``, whose graphed ``Evaluator`` captures its evaluation
step, then the phase's traced breakdown) in one process, in turns with two
evaluation resets, and count the runs whose capture fails:

- ``index_seeded_on_cpu``: the package's ``VecEnv.reset_with_index`` (the
  reset drawn on the CPU from ``index_seed`` and copied to the card);
- ``drawn_on_device``: the reset drawn on the env's device from a
  generator seeded with ``index_seed``, as before the reset moved to the CPU.

Usage, from the root of a checkout, on a GPU::

    python tools/evaluator_capture_loop.py --rounds 12

Prints one line a run and a JSON summary as its last line: for each reset,
the runs, the failures and the first failure's message.  Exits 1 if a run
failed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from border_tpu_torch.core.env import VecEnv, index_seed
    from border_tpu_torch.utils.device import as_generator

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no GPU: the loop captures CUDA graphs", file=sys.stderr)
        return 2

    def drawn_on_device(self, base_seed, index, gen=None):
        return self.reset(as_generator(index_seed(base_seed, index), self.device,
                                       into=gen))

    resets = {"index_seeded_on_cpu": VecEnv.reset_with_index,
              "drawn_on_device": drawn_on_device}
    summary = {k: {"runs": 0, "failures": 0, "first_failure": None}
               for k in resets}
    dev = torch.device("cuda")
    for i in range(args.rounds):
        order = list(resets) if i % 2 == 0 else list(reversed(resets))
        for name in order:
            VecEnv.reset_with_index = resets[name]
            t0 = time.perf_counter()
            try:
                chip_smoke.pendulum_sac_path(torch, dev)
                err = None
            except (Exception, SystemExit) as e:  # noqa: BLE001 — counted
                err = f"{type(e).__name__}: {e}"
            torch.cuda.synchronize()
            s = summary[name]
            s["runs"] += 1
            if err is not None:
                s["failures"] += 1
                s["first_failure"] = s["first_failure"] or err
            print(f"round {i} {name}: {'FAILED ' + err if err else 'ok'} "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
    VecEnv.reset_with_index = resets["index_seeded_on_cpu"]
    print(json.dumps(summary), flush=True)
    return 1 if any(s["failures"] for s in summary.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
