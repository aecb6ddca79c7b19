"""Soft Actor-Critic (``agent.kind`` ``sac``): Haarnoja et al. 2018, "Soft
Actor-Critic Algorithms and Applications" (arXiv:1812.05905), §4–5 and
appendix C, in float32.

An actor ``f_φ(s) = (μ, log σ)`` (ReLU MLP, two linear heads) and two
critics ``Q_i(s, a)`` (ReLU MLPs on s ‖ a) with target copies ``Q'_i``.
One update on a batch, with the two normal draws ``z'`` (next action)
and ``z`` (the actor's), in the program's order:

1. the critics: ``a' = tanh(μ(s') + σ(s')·z')·scale + bias`` with
   ``log π(a'|s') = log N(u'; μ, σ) − Σ log(1 − tanh²(u'))`` (eq. 26),
   the target ``y = r + γ(1 − terminated)(min_i Q'_i(s', a') − α·log π')``
   (eqs. 3, 5, with the minimum of the two targets), and one Adam step on
   the critics' loss;
2. the actor: ``J_π = mean(α·log π(a|s) − min_i Q_i(s, a))`` (eq. 7) at
   ``a = tanh(μ(s) + σ(s)·z)·scale + bias``, through the critics just
   stepped, and one Adam step on the actor;
3. the temperature: ``J(α) = −mean(log α·(log π + H̄))`` (eq. 18, with
   H̄ = ``target_entropy``), one Adam step on ``log α``;
4. the targets: ``Q'_i ← Q'_i·(1 − τ) + Q_i·τ`` (two products and a sum).

α is ``exp(log α)`` as the update starts.  Where this departs from the
paper, it follows the program's choices, which the comparison judges:

- the critics' loss is one mean over both critics and the batch of
  ``(Q_i − y)²``: a critic's gradient is that of the paper's
  ``J_Q(θ_i) = E[½(Q_i − y)²]`` (the ½ and the sum over two critics
  cancel), its value twice the mean of the two;
- the temperature is learned as ``log α`` (as in the authors' code), so
  its loss is eq. 18 with ``log α`` in place of α;
- ``log σ`` is clamped to ``agent.log_std_bounds`` (the authors' code's
  [−20, 2]);
- ``log(1 − tanh²(u))`` is computed as ``2·(log 2 − u − softplus(−2u))``,
  the same quantity without the cancellation of ``1 − tanh²`` near ±1.

The networks' input and output widths are the env's (its reference
class's ``obs_dim``, ``act_dim``, ``act_low``, ``act_high``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import games
from portbench.reference.update import Adam

Params = Dict[str, torch.Tensor]
LOG_2 = math.log(2.0)
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def env_spaces(cfg: dict):
    """``(obs_dim, act_dim, low, high)`` of the configuration's env."""
    g = games.find(cfg["env"])
    return g.obs_dim, g.act_dim, g.act_low, g.act_high


def _mlp_shapes(prefix: str, widths: list, heads: list) -> list:
    out = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(f"{prefix}.{i}.weight", (b, a)), (f"{prefix}.{i}.bias", (b,))]
    for name, b in heads:
        out += [(f"{prefix}.{name}.weight", (b, widths[-1])),
                (f"{prefix}.{name}.bias", (b,))]
    return out


def shapes(cfg: dict):
    """The actor (``actor.<i>``, heads ``actor.mean``, ``actor.log_std``),
    then each critic (``critic<j>.<i>``, its last layer 1 wide)."""
    a = cfg["agent"]
    obs, act, _, _ = env_spaces(cfg)
    out = _mlp_shapes("actor", [obs, *a["actor_hidden"]], [("mean", act), ("log_std", act)])
    for j in range(a["n_critics"]):
        out += _mlp_shapes(f"critic{j}", [obs + act, *a["critic_hidden"], 1], [])
    return out


def _trunk(p: Params, prefix: str, x, rnd, n: int):
    for i in range(n):
        x = F.relu(F.linear(rnd(x), rnd(p[f"{prefix}.{i}.weight"]), p[f"{prefix}.{i}.bias"]))
    return x


def policy(p: Params, x, cfg: dict, rnd):
    """``(μ, log σ)`` of observations ``x`` ``[B, obs_dim]``."""
    h = _trunk(p, "actor", x, rnd, len(cfg["agent"]["actor_hidden"]))
    mean = F.linear(rnd(h), rnd(p["actor.mean.weight"]), p["actor.mean.bias"])
    log_std = F.linear(rnd(h), rnd(p["actor.log_std.weight"]), p["actor.log_std.bias"])
    lo, hi = cfg["agent"]["log_std_bounds"]
    return mean, log_std.clamp(lo, hi)


def _squash(u, cfg: dict):
    _, _, low, high = env_spaces(cfg)
    return torch.tanh(u) * ((high - low) / 2.0) + (high + low) / 2.0


def sample(p: Params, x, z, cfg: dict, rnd):
    """``(action, log π)`` at the standard-normal draws ``z``."""
    mean, log_std = policy(p, x, cfg, rnd)
    u = mean + torch.exp(log_std) * z
    log_n = (-0.5 * z * z - log_std - HALF_LOG_2PI).sum(-1)
    log_det = (2.0 * (LOG_2 - u - F.softplus(-2.0 * u))).sum(-1)
    return _squash(u, cfg), log_n - log_det


def q(p: Params, j: int, x, a, cfg: dict, rnd) -> torch.Tensor:
    """Critic ``j``'s value ``[B]`` of ``(x, a)``."""
    prefix, n = f"critic{j}", len(cfg["agent"]["critic_hidden"])
    h = _trunk(p, prefix, torch.cat([x, a], dim=1), rnd, n)
    return F.linear(rnd(h), rnd(p[f"{prefix}.{n}.weight"]), p[f"{prefix}.{n}.bias"])[:, 0]


def min_q(p: Params, x, a, cfg: dict, rnd) -> torch.Tensor:
    qs = [q(p, j, x, a, cfg, rnd) for j in range(cfg["agent"]["n_critics"])]
    return torch.stack(qs).min(dim=0).values


def greedy(p: Params, x, cfg: dict, rnd, rnd_head) -> torch.Tensor:
    """The deterministic action ``tanh(μ)·scale + bias``."""
    return _squash(policy(p, x, cfg, rnd)[0], cfg)


def loss_draws(u: dict, b: dict, cfg: dict, device) -> dict:
    """``z_next`` and ``z_actor`` ``[B, act_dim]``: the update's two normal
    draws, in that order, from the program's generator state at it."""
    g = torch.Generator(device=device)
    g.set_state(u["gen_state"])
    if u.get("gen_offset") is not None:
        g.set_offset(u["gen_offset"])
    shape = (b["reward"].shape[0], env_spaces(cfg)[1])
    z_next = torch.randn(shape, generator=g, device=device)
    return {"z_next": z_next, "z_actor": torch.randn(shape, generator=g, device=device)}


def _alpha(p: Params) -> torch.Tensor:
    return p["log_alpha"].detach().exp()


def loss(p, tgt, b: dict, cfg: dict, rnd, rnd_head, half: bool = False):
    """``(critic loss, td_error)``: the first of an update's three losses
    (:func:`update` makes the whole update), at the online parameters
    ``p`` (``log_alpha`` among them) and the target critics' ``tgt``;
    ``td_error`` is the critics' mean minus the target, before the step.
    ``half``: the mean over the first half of the batch (a planted fault)."""
    a = cfg["agent"]
    n_critics = a["n_critics"]
    with torch.no_grad():
        a_next, logp_next = sample(p, b["next_obs"], b["z_next"], cfg, rnd)
        y = b["reward"] * a["reward_scale"] + a["gamma"] * (
            1.0 - b["terminated"].float()) * (
            min_q(tgt, b["next_obs"], a_next, cfg, rnd) - _alpha(p) * logp_next)
    qs = torch.stack([q(p, j, b["obs"], b["act"], cfg, rnd) for j in range(n_critics)])
    per = (qs - y[None, :]) ** 2
    if half:
        per = per[:, : per.shape[1] // 2]
    return per.mean(), (qs.mean(0) - y).detach()


def learner(w0: Params, cfg: dict) -> dict:
    """The reference's learner from the seed's weights: ``params`` (the
    actor's, the critics' and ``log_alpha``), ``target`` (the critics'
    copies) and the three Adams."""
    a = cfg["agent"]
    params = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    log_alpha = torch.tensor(a["ent_coef_init"], dtype=torch.float32).log()
    params["log_alpha"] = log_alpha.to(next(iter(w0.values())).device).requires_grad_(True)
    return {"params": params,
            "target": {k: v.clone() for k, v in w0.items() if k.startswith("critic")},
            "opts": {"critic": Adam(a["critic_lr"]), "actor": Adam(a["actor_lr"]),
                     "alpha": Adam(a["ent_lr"])}}


def _step(lrn: dict, name: str, loss_value, keys: list, still: bool) -> Params:
    p = lrn["params"]
    grads = dict(zip(keys, torch.autograd.grad(loss_value, [p[k] for k in keys])))
    if not still:
        lrn["opts"][name].step(p, grads)
    return grads


def update(lrn: dict, b: dict, cfg: dict, rnd, half: bool = False,
           still: bool = False):
    """One update of the learner ``lrn`` (:func:`learner`) on the batch
    ``b`` (with :func:`loss_draws`' entries).  Returns ``(losses, grads)``:
    the critics', the actor's and the temperature's losses, and every
    parameter's gradient as its optimizer got it.  ``still``: Adam steps
    that leave the parameters and the moments as they were (a planted
    fault; the targets still follow the critics)."""
    a = cfg["agent"]
    p, tgt = lrn["params"], lrn["target"]
    alpha = _alpha(p)
    critics = [k for k in p if k.startswith("critic")]
    actor = [k for k in p if k.startswith("actor.")]
    c_loss, _ = loss(p, tgt, b, cfg, rnd, rnd, half)
    grads = _step(lrn, "critic", c_loss, critics, still)
    act, logp = sample(p, b["obs"], b["z_actor"], cfg, rnd)
    a_loss = (alpha * logp - min_q(p, b["obs"], act, cfg, rnd)).mean()
    grads.update(_step(lrn, "actor", a_loss, actor, still))
    logp = logp.detach()
    al_loss = -(p["log_alpha"] * (logp + a["target_entropy"])).mean()
    grads.update(_step(lrn, "alpha", al_loss, ["log_alpha"], still))
    tau = a["tau"]
    with torch.no_grad():
        for k in critics:
            tgt[k] = tgt[k] * (1.0 - tau) + p[k] * tau
    return [float(x.detach()) for x in (c_loss, a_loss, al_loss)], grads
