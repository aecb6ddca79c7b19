#!/usr/bin/env python3
"""Score every in-training evaluation of an offline gate run on the
certification's fresh indices: a checkpoint x fresh-index matrix, which
shows whether the gate's pick (the best in-training score, at index 0, 1,
...) is a checkpoint that also scores well on the indices the gate
certifies it on (``10_000 + 7 i``).

Usage, from the root of a checkout::

    python tools/fresh_by_checkpoint.py awac_offline --seed 0
    python tools/fresh_by_checkpoint.py bc_offline --seed 0 --device cpu

It trains the config through ``border_tpu_torch.learning.run``, as the gate
does, with the run's evaluator wrapped: after each in-training evaluation
the same parameters are scored on the fresh indices too.  The evaluator
re-seeds its own generators every evaluation and the training draws from
others, so the run trains and certifies as without the extra evaluations.
Writes the run's artifact with ``fresh_by_checkpoint`` added, one row per
in-training evaluation, to ``artifacts/torch/c4/`` (not to the gate's
artifacts, which the gate reads).
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FreshByCheckpoint:
    """A run's evaluator; each in-training evaluation (an index under
    10,000) is followed by the same parameters' fresh evaluations."""

    def __init__(self, inner, config: str, fresh, score):
        self.inner, self.config, self.fresh, self.score = inner, config, fresh, score
        self.rows = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def evaluate(self, agent, agent_state, eval_index=0):
        out = self.inner.evaluate(agent, agent_state, eval_index=eval_index)
        if eval_index < self.fresh[0]:
            scores = [round(float(self.score(self.inner.evaluate(
                agent, agent_state, eval_index=i)[0])), 2) for i in self.fresh]
            self.rows.append({"eval_index": eval_index, "fresh": scores,
                              "median": round(float(np.median(scores)), 2)})
        return out


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from border_tpu_torch import learning
    from border_tpu_torch.data import normalized_score

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", choices=sorted(learning.OFFLINE_CONFIGS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    out = args.out or os.path.join(
        ROOT, "artifacts", "torch", "c4",
        f"{args.config}_seed{args.seed}_fresh_by_checkpoint.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fresh = [10_000 + 7 * i
             for i in range(learning.N_FINAL_EVALS.get(args.config, 5))]
    wrapped = []
    build = learning.build_offline

    def build_wrapped(config, seed, device, max_opts=None):
        md, agent, cfg, ev, eval_env, meta = build(config, seed, device, max_opts)
        wrapped.append(FreshByCheckpoint(
            ev, config, fresh,
            lambda s: normalized_score(s, md.ref_min, md.ref_max)))
        return md, agent, cfg, wrapped[-1], eval_env, meta

    learning.build_offline = build_wrapped
    r = learning.run(args.config, args.seed, out, device=args.device)
    # the curve's last point is the certification's
    curve = r.artifact["curve"][:-1]
    rows = [{"opt_steps": point["opt_steps"], **row}
            for point, row in zip(curve, wrapped[0].rows, strict=True)]
    art = {}
    for k, v in r.artifact.items():
        if k == "final_evals":
            art["fresh_by_checkpoint"] = rows
        art[k] = v
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art["fresh_by_checkpoint"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
