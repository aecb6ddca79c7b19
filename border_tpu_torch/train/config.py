"""Trainer configuration (≙ border_tpu/train/config.py).

The same fields as the JAX ``TrainerConfig``, so a YAML file written by one
loads in the other.  The update:sample ratio knobs carry over exactly:

- ``opt_interval``: env steps between optimization rounds,
- ``n_updates_per_opt``: gradient steps per optimization round.

``num_envs`` is the vectorised env axis and ``steps_per_chunk`` the env
steps run between two rounds of updates.

``update_scan_unroll`` has no effect in the port (there is no scan to
unroll) and is kept so configs round-trip.  ``prefetch_sample`` and
``updates_per_sample_batch`` order the uniform update loop's samples as in
the JAX trainer (``Trainer._update_scan``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainerConfig:
    # -- loop extent -------------------------------------------------------
    max_opts: int = 10_000
    warmup_period: int = 1_000  # env steps before first update
    opt_interval: int = 1  # env steps per optimization round
    n_updates_per_opt: int = 1
    batch_size: int = 64
    # -- cadences ----------------------------------------------------------
    eval_interval: int = 1_000  # in opt steps
    eval_episodes: int = 5
    save_interval: int = 0  # 0 = disabled
    flush_record_interval: int = 100
    record_compute_cost_interval: int = 1_000
    record_agent_info_interval: int = 0  # 0 = disabled (param_stats cadence)
    # -- vectorisation / chunking ------------------------------------------
    num_envs: int = 128  # vectorized env axis (≙ N actors)
    steps_per_chunk: int = 64  # env steps per chunk
    # uniform update loop: sample i+1 started before update i / one sample
    # of batch_size·u cut into u sub-batches
    prefetch_sample: bool = False
    update_scan_unroll: int = 1  # JAX-only, kept for the YAML round-trip
    updates_per_sample_batch: int = 1
    # -- misc --------------------------------------------------------------
    seed: int = 0
    sync_interval: int = 100

    def save(self, path: str) -> None:
        import yaml  # only the YAML round-trip needs PyYAML

        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "TrainerConfig":
        import yaml

        with open(path) as f:
            return cls(**yaml.safe_load(f))

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)
