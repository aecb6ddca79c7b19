"""IQN on the Nature torso (``agent.kind`` ``iqn``): Dabney et al. 2018.

The net (eq. 4): ψ(x) ⊙ φ(τ), φ_j(τ) = ReLU(Σ_i cos(π i τ) w_ij + b_j),
then f.  The loss (eq. 3): the greedy next action maximises the target
net's Q averaged over the acting fractions at their midpoints; target
quantiles ``r + γ(1 − terminated) Z_target(s', a*; τ')``; the quantile
Huber loss ``|τ − 1{u < 0}| · huber(u)`` of every pair, averaged over the
target fractions, summed over the predicted ones, averaged over the batch
(weighted by the importance weights where replay is prioritized).  The
fractions τ and τ' of an update are drawn from the program's generator
state at that update."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.update import batch_mean, huber


def shapes(cfg: dict):
    h = cfg["agent"]
    fc, feat, n_cos = cfg["torso"]["fc"], h["feature_dim"], h["n_cos"]
    widths = [feat, *h["hidden"], cfg["n_actions"]]
    out = nets.torso_shapes(cfg, "psi.") + [
        ("psi_proj.weight", (feat, fc)), ("psi_proj.bias", (feat,)),
        ("phi.weight", (feat, n_cos)), ("phi.bias", (feat,))]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(f"f.{i}.weight", (b, a)), (f"f.{i}.bias", (b,))]
    return out


def quantiles(p: nets.Params, x, taus: torch.Tensor, cfg: dict, rnd, rnd_head
              ) -> torch.Tensor:
    """Quantile values ``[B, K, A]`` at fractions ``taus`` ``[B, K]``."""
    n_cos = cfg["agent"]["n_cos"]
    psi = F.relu(F.linear(rnd_head(nets.torso(p, x, cfg, rnd, "psi.")),
                          rnd_head(p["psi_proj.weight"]), p["psi_proj.bias"]))
    i = torch.arange(1, n_cos + 1, dtype=torch.float32, device=taus.device)
    cos = torch.cos(taus[..., None] * math.pi * i)
    phi = F.relu(F.linear(rnd_head(cos), rnd_head(p["phi.weight"]),
                          p["phi.bias"]))
    z = psi[:, None, :] * phi
    n_f = sum(1 for k in p if k.startswith("f.") and k.endswith(".weight"))
    for j in range(n_f):
        z = F.linear(rnd_head(z), rnd_head(p[f"f.{j}.weight"]), p[f"f.{j}.bias"])
        if j < n_f - 1:
            z = F.relu(z)
    return z


def midpoints(k: int, device) -> torch.Tensor:
    return ((torch.arange(k, dtype=torch.float32) + 0.5) / k).to(device)


def greedy(p: nets.Params, x, cfg: dict, rnd, rnd_head) -> torch.Tensor:
    """The action of the best mean over the acting fractions' midpoints."""
    k = int(cfg["agent"]["sample_percents_act"][len("const"):])
    taus = midpoints(k, x.device).expand(x.shape[0], k)
    return quantiles(p, x, taus, cfg, rnd, rnd_head).mean(dim=1).argmax(dim=1)


def loss_draws(u: dict, b: dict, cfg: dict, device) -> dict:
    """``taus_pred`` and ``taus_tgt`` ``[B, K]``: the update's fractions,
    drawn again from the program's generator state at the update."""
    a = cfg["agent"]
    g = torch.Generator(device=device)
    g.set_state(u["gen_state"])
    if u.get("gen_offset") is not None:
        g.set_offset(u["gen_offset"])
    B = b["reward"].shape[0]
    kp = int(a["sample_percents_pred"][len("uniform"):])
    kt = int(a["sample_percents_tgt"][len("uniform"):])
    taus_pred = torch.rand((B, kp), generator=g, device=device)
    return {"taus_pred": taus_pred,
            "taus_tgt": torch.rand((B, kt), generator=g, device=device)}


def loss(p, tgt, b: dict, cfg: dict, rnd, rnd_head, half: bool = False):
    """``(loss, td_error)`` of a batch ``b`` (obs/next_obs
    ``[B, 4, 84, 84]`` uint8, act, reward, terminated, weight, and the
    update's fractions ``taus_pred``/``taus_tgt`` ``[B, K]``)."""
    a = cfg["agent"]
    B = b["reward"].shape[0]
    k_act = int(a["sample_percents_act"][len("const"):])
    with torch.no_grad():
        t_act = midpoints(k_act, b["reward"].device).expand(B, k_act)
        a_star = quantiles(tgt, b["next_obs"], t_act, cfg, rnd, rnd_head
                           ).mean(dim=1).argmax(dim=1)
        zt = quantiles(tgt, b["next_obs"], b["taus_tgt"], cfg, rnd, rnd_head)
        z_a = zt.gather(2, a_star[:, None, None].expand(-1, zt.shape[1], 1))[..., 0]
        y = b["reward"][:, None] + a["gamma"] * (
            1.0 - b["terminated"].float())[:, None] * z_a
    zp = quantiles(p, b["obs"], b["taus_pred"], cfg, rnd, rnd_head)
    pred = zp.gather(2, b["act"][:, None, None].expand(-1, zp.shape[1], 1))[..., 0]
    u = y[:, None, :] - pred[:, :, None]
    taus = b["taus_pred"][:, :, None]
    per = ((taus - (u < 0).float()).abs() * huber(u, a["kappa"]) / a["kappa"]
           ).mean(dim=2).sum(dim=1)
    td = (pred.mean(dim=1) - y.mean(dim=1)).detach()
    return batch_mean(per, b.get("weight"), half), td
