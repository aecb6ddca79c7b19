"""IQN on the Nature torso.  A forward at K fractions: the torso and ψ's
projection once, and per fraction φ (n_cos → feature) and f.  An update:
the online forward and backward at N fractions on ``obs``; the target's
ψ(next_obs) once, at K' + N' fractions (the acting fractions for a* and
the target fractions)."""

from __future__ import annotations

from portbench.flops import torso


def _k(strategy: str) -> int:
    return int(strategy.lstrip("abcdefghijklmnopqrstuvwxyz") or 1)


def psi_macs(cfg: dict) -> int:
    return torso.macs(cfg) + cfg["torso"]["fc"] * cfg["agent"]["feature_dim"]


def phi_macs(cfg: dict) -> int:
    a = cfg["agent"]
    return a["n_cos"] * a["feature_dim"]


def head_macs(cfg: dict) -> int:
    """φ and f, one fraction."""
    a = cfg["agent"]
    widths = [a["feature_dim"], *a["hidden"], cfg["n_actions"]]
    return phi_macs(cfg) + sum(x * y for x, y in zip(widths[:-1], widths[1:]))


def forward_macs(cfg: dict, k: int) -> int:
    return psi_macs(cfg) + k * head_macs(cfg)


def update_macs(cfg: dict) -> int:
    a = cfg["agent"]
    n, n_tgt, k_act = (_k(a[s]) for s in ("sample_percents_pred",
                                          "sample_percents_tgt",
                                          "sample_percents_act"))
    online = forward_macs(cfg, n)
    backward = 2 * online - torso.first_layer_macs(cfg) - n * phi_macs(cfg)
    target = forward_macs(cfg, n_tgt + k_act)
    return a["batch_size"] * (online + backward + target)


def chunk_flops(cfg: dict, updates_per_chunk: int) -> int:
    r, a = cfg["replay"], cfg["agent"]
    act = r["num_envs"] * r["steps_per_chunk"] * forward_macs(
        cfg, _k(a["sample_percents_act"]))
    return 2 * (act + updates_per_chunk * update_macs(cfg))
