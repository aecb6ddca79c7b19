"""DQN on the Nature torso (``agent.kind`` ``dqn``): Mnih et al. 2015, with
van Hasselt et al. 2016's double-DQN target:
``y = r + γ(1 − terminated) Q_target(s', argmax_a Q_online(s', a))``, the
Huber loss (δ = 1) of ``Q_online(s, a) − y``, weighted by the importance
weights where replay is prioritized, averaged over the batch.  The head is
rounded as the torso is (``rnd``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.update import batch_mean, huber


def shapes(cfg: dict):
    fc = cfg["torso"]["fc"]
    return nets.torso_shapes(cfg) + [("fc1.weight", (cfg["n_actions"], fc)),
                                     ("fc1.bias", (cfg["n_actions"],))]


def q(p: nets.Params, x, cfg: dict, rnd) -> torch.Tensor:
    """Q values ``[B, A]``."""
    return F.linear(rnd(nets.torso(p, x, cfg, rnd)), rnd(p["fc1.weight"]),
                    p["fc1.bias"])


def greedy(p: nets.Params, x, cfg: dict, rnd, rnd_head) -> torch.Tensor:
    return q(p, x, cfg, rnd).argmax(dim=1)


def loss_draws(u: dict, b: dict, cfg: dict, device) -> dict:
    """The loss draws nothing."""
    return {}


def loss(p, tgt, b: dict, cfg: dict, rnd, rnd_head, half: bool = False):
    """``(loss, td_error)`` of a batch ``b`` (obs/next_obs
    ``[B, 4, 84, 84]`` uint8, act, reward, terminated, weight)."""
    gamma = cfg["agent"]["gamma"]
    with torch.no_grad():
        q_next = q(tgt, b["next_obs"], cfg, rnd)
        if cfg["agent"]["double_dqn"]:
            a_star = q(p, b["next_obs"], cfg, rnd).argmax(dim=1)
        else:
            a_star = q_next.argmax(dim=1)
        y = b["reward"] + gamma * (1.0 - b["terminated"].float()) * \
            q_next.gather(1, a_star[:, None])[:, 0]
    pred = q(p, b["obs"], cfg, rnd).gather(1, b["act"][:, None])[:, 0]
    return batch_mean(huber(pred - y), b.get("weight"), half), (pred - y).detach()
