"""SAC on ReLU MLPs: a forward of the actor (two hidden layers and the
mean and log σ heads) or of one critic (two hidden layers and the value)
on one sample.  An update, per sample: the target branch (the actor on
``next_obs`` and every target critic), every critic's forward and
backward on ``(obs, act)`` (no input gradient), the actor's sample with
every critic's forward and an input-gradient-only backward through the
critics, the actor's backward (no input gradient) and the TD error's
forward of every critic after the steps.  Acting: the actor's forward of
every env step."""

from __future__ import annotations

from portbench.reference import games


def _mlp(widths: list) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def actor_macs(cfg: dict) -> int:
    env, a = games.find(cfg["env"]), cfg["agent"]
    hidden = [env.obs_dim, *a["actor_hidden"]]
    return _mlp(hidden) + 2 * hidden[-1] * env.act_dim


def critic_macs(cfg: dict) -> int:
    env, a = games.find(cfg["env"]), cfg["agent"]
    return _mlp([env.obs_dim + env.act_dim, *a["critic_hidden"], 1])


def update_macs(cfg: dict) -> int:
    """Multiply-adds of one update on one sample."""
    env, a = games.find(cfg["env"]), cfg["agent"]
    n = a["n_critics"]
    f_a, f_c = actor_macs(cfg), critic_macs(cfg)
    c_in = (env.obs_dim + env.act_dim) * a["critic_hidden"][0]
    a_in = env.obs_dim * a["actor_hidden"][0]
    target = f_a + n * f_c
    critics = n * (f_c + 2 * f_c - c_in)
    actor = f_a + n * f_c + n * f_c + 2 * f_a - a_in
    td = n * f_c
    return target + critics + actor + td


def chunk_flops(cfg: dict, updates_per_chunk: int) -> int:
    r, a = cfg["replay"], cfg["agent"]
    act = r["num_envs"] * r["steps_per_chunk"] * actor_macs(cfg)
    return 2 * (act + updates_per_chunk * a["batch_size"] * update_macs(cfg))
