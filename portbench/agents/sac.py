"""SAC on ReLU MLPs (``agent.kind`` ``sac``): the program's agent built from
the configuration, and its parameters under the reference's names (actor
``actor.<i>``, ``actor.mean``, ``actor.log_std``; critic ``j``'s layer
``i`` as ``critic<j>.<i>``, ``[out, in]``; ``log_alpha``)."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def build(cfg: dict):
    from border_tpu_torch.agents import SAC, SACConfig

    a = cfg["agent"]
    return SAC(SACConfig(
        gamma=a["gamma"], tau=a["tau"], n_critics=a["n_critics"],
        reward_scale=a["reward_scale"], critic_loss=a["critic_loss"],
        ent_coef_mode=a["ent_coef_mode"], ent_coef_init=a["ent_coef_init"],
        target_entropy=a["target_entropy"], ent_lr=a["ent_lr"],
        actor_lr=a["actor_lr"], critic_lr=a["critic_lr"],
        actor_hidden=tuple(a["actor_hidden"]), critic_hidden=tuple(a["critic_hidden"])))


def critics(ens, of: Callable = lambda p: p) -> Dict[str, torch.Tensor]:
    """Member ``j``'s ``[out, in]`` weight and bias of each layer, as views
    of ``of`` of the stacked ``[n, in, out]`` and ``[n, out]`` parameters."""
    out = {}
    for i, (w, b) in enumerate(zip(ens.weights, ens.biases)):
        w, b = of(w), of(b)
        for j in range(ens.n):
            out[f"critic{j}.{i}.weight"] = w[j].T
            out[f"critic{j}.{i}.bias"] = b[j]
    return out


def _named(state, of: Callable = lambda opt, p: p) -> Dict[str, torch.Tensor]:
    """``of(its optimizer, parameter)`` of every learned parameter, by the
    reference's name."""
    out = {"actor." + k.replace("layers.", ""): of(state.actor_opt, p)
           for k, p in state.actor_params.named_parameters()}
    out.update(critics(state.critic_params, lambda p: of(state.critic_opt, p)))
    out["log_alpha"] = of(state.alpha_opt, state.log_alpha)
    return out


def load(cfg: dict, state, w0: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the actor, the critics and the critics'
    targets."""
    lo, hi = cfg["agent"]["log_std_bounds"]
    actor = state.actor_params
    if (actor.log_std_min, actor.log_std_max) != (lo, hi):
        raise RuntimeError(f"the program clamps log σ to [{actor.log_std_min}, "
                           f"{actor.log_std_max}], the configuration to [{lo}, {hi}]")
    named = _named(state)
    del named["log_alpha"]  # from ent_coef_init, not drawn
    if set(named) != set(w0):
        raise RuntimeError(f"the program's parameters {sorted(named)} are not the "
                           f"reference's {sorted(w0)}")
    with torch.no_grad():
        for k, p in named.items():
            if p.shape != w0[k].shape:
                raise RuntimeError(f"{k}: {tuple(p.shape)} in the program, "
                                   f"{tuple(w0[k].shape)} here")
            p.copy_(w0[k])
        for k, p in critics(state.critic_target_params).items():
            p.copy_(w0[k])


def params(state) -> Dict[str, torch.Tensor]:
    """Every learned parameter under the reference's names (views)."""
    return _named(state)


def first_grads(state) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient of the first update as its Adam got it:
    the first moment after one step is (1 − β1)·g (a step that left no
    moment reads as a zero gradient)."""
    def grad(opt, p):
        b1 = opt.param_groups[0]["betas"][0]
        return opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - b1)

    return _named(state, grad)


def losses(metrics: dict) -> List[torch.Tensor]:
    """The update's three losses: the critics', the actor's, the
    temperature's."""
    return [metrics["loss_critic"], metrics["loss_actor"], metrics["loss_alpha"]]


def soft_targets(cfg: dict, state):
    """``(online, target, τ)``: the critics' parameters and their targets,
    which each update moves to ``target·(1 − τ) + online·τ``."""
    return (list(state.critic_params.parameters()),
            list(state.critic_target_params.parameters()), cfg["agent"]["tau"])
