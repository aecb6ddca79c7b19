"""Plain updates of the two agents, float32, one batch at a time.

DQN (Mnih et al. 2015, with van Hasselt et al. 2016's double-DQN target):
``y = r + γ(1 − terminated) Q_target(s', argmax_a Q_online(s', a))``, the
Huber loss (δ = 1) of ``Q_online(s, a) − y``, weighted by the importance
weights where replay is prioritized, averaged over the batch.

IQN (Dabney et al. 2018, eq. 3): the greedy next action maximises the
target net's Q averaged over the 32 midpoint fractions; target quantiles
``r + γ(1 − terminated) Z_target(s', a*; τ')``; the quantile Huber loss
``|τ − 1{u < 0}| · huber(u)`` of every pair, averaged over the target
fractions, summed over the predicted ones, averaged over the batch.

Adam (Kingma & Ba 2015): β 0.9 / 0.999, ε 1e-8 outside the root,
bias-corrected.  ``half`` is a planted fault: the loss's mean over the
first half of the batch only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import nets


def huber(d: torch.Tensor, kappa: float = 1.0) -> torch.Tensor:
    a = d.abs()
    return torch.where(a <= kappa, 0.5 * d * d, kappa * (a - 0.5 * kappa))


def _mean(per: torch.Tensor, weight: Optional[torch.Tensor], half: bool):
    if weight is not None:
        per = weight * per
    return per[: per.shape[0] // 2].mean() if half else per.mean()


def dqn_loss(p, tgt, b: dict, cfg: dict, rnd, half: bool = False):
    """``(loss, td_error)`` of a batch ``b`` (obs/next_obs
    ``[B, 4, 84, 84]`` uint8, act, reward, terminated, weight)."""
    gamma = cfg["agent"]["gamma"]
    with torch.no_grad():
        q_next = nets.dqn_q(tgt, b["next_obs"], cfg, rnd)
        if cfg["agent"]["double_dqn"]:
            a_star = nets.dqn_q(p, b["next_obs"], cfg, rnd).argmax(dim=1)
        else:
            a_star = q_next.argmax(dim=1)
        y = b["reward"] + gamma * (1.0 - b["terminated"].float()) * \
            q_next.gather(1, a_star[:, None])[:, 0]
    pred = nets.dqn_q(p, b["obs"], cfg, rnd).gather(1, b["act"][:, None])[:, 0]
    return _mean(huber(pred - y), b.get("weight"), half), (pred - y).detach()


def midpoints(k: int, device) -> torch.Tensor:
    return ((torch.arange(k, dtype=torch.float32) + 0.5) / k).to(device)


def iqn_loss(p, tgt, b: dict, cfg: dict, rnd, rnd_head, half: bool = False):
    """As :func:`dqn_loss`; ``b`` also carries ``taus_pred``/``taus_tgt``
    ``[B, K]`` (the draws of this update)."""
    a = cfg["agent"]
    B = b["reward"].shape[0]
    k_act = int(a["sample_percents_act"][len("const"):])
    with torch.no_grad():
        t_act = midpoints(k_act, b["reward"].device).expand(B, k_act)
        a_star = nets.iqn_z(tgt, b["next_obs"], t_act, cfg, rnd, rnd_head
                            ).mean(dim=1).argmax(dim=1)
        z = nets.iqn_z(tgt, b["next_obs"], b["taus_tgt"], cfg, rnd, rnd_head)
        z_a = z.gather(2, a_star[:, None, None].expand(-1, z.shape[1], 1))[..., 0]
        y = b["reward"][:, None] + a["gamma"] * (
            1.0 - b["terminated"].float())[:, None] * z_a
    zp = nets.iqn_z(p, b["obs"], b["taus_pred"], cfg, rnd, rnd_head)
    pred = zp.gather(2, b["act"][:, None, None].expand(-1, zp.shape[1], 1))[..., 0]
    u = y[:, None, :] - pred[:, :, None]
    taus = b["taus_pred"][:, :, None]
    per = ((taus - (u < 0).float()).abs() * huber(u, a["kappa"]) / a["kappa"]
           ).mean(dim=2).sum(dim=1)
    td = (pred.mean(dim=1) - y.mean(dim=1)).detach()
    return _mean(per, b.get("weight"), half), td


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]):
        self.t += 1
        for k, grad in g.items():
            m = self.m.get(k, torch.zeros_like(grad))
            v = self.v.get(k, torch.zeros_like(grad))
            m = self.b1 * m + (1 - self.b1) * grad
            v = self.b2 * v + (1 - self.b2) * grad * grad
            self.m[k], self.v[k] = m, v
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            p[k] -= self.lr * m_hat / (v_hat.sqrt() + self.eps)
