"""DQN on the Nature torso: a forward is the torso and the Q layer.  An
update: the online forward and backward on ``obs``, the online forward on
``next_obs`` (double DQN's argmax) and the target forward on ``next_obs``."""

from __future__ import annotations

from portbench.flops import torso


def forward_macs(cfg: dict) -> int:
    return torso.macs(cfg) + cfg["torso"]["fc"] * cfg["n_actions"]


def update_macs(cfg: dict) -> int:
    f = forward_macs(cfg)
    backward = 2 * f - torso.first_layer_macs(cfg)
    return cfg["agent"]["batch_size"] * (f + backward + f + f)


def chunk_flops(cfg: dict, updates_per_chunk: int) -> int:
    r = cfg["replay"]
    act = r["num_envs"] * r["steps_per_chunk"] * forward_macs(cfg)
    return 2 * (act + updates_per_chunk * update_macs(cfg))
