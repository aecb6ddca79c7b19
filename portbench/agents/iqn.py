"""IQN on the Nature torso (``agent.kind`` ``iqn``)."""

from __future__ import annotations

import functools


def build(cfg: dict):
    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.models import AtariCNN

    a = cfg["agent"]
    return IQN(IQNConfig(
        psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
        feature_dim=a["feature_dim"], n_cos=a["n_cos"], hidden=tuple(a["hidden"]),
        sample_percents_pred=a["sample_percents_pred"],
        sample_percents_tgt=a["sample_percents_tgt"],
        sample_percents_act=a["sample_percents_act"], kappa=a["kappa"],
        gamma=a["gamma"], lr=a["lr"], soft_update_interval=a["target_interval"],
        tau=a["tau"], eps_start=a["eps_start"], eps_final=a["eps_final"],
        eps_final_step=a["eps_final_step"]))
