"""DQN on the Nature torso (``agent.kind`` ``dqn``)."""

from __future__ import annotations


def build(cfg: dict):
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN

    a = cfg["agent"]
    return DQN(DQNConfig(
        model=lambda n: AtariCNN(out_dim=n), gamma=a["gamma"], lr=a["lr"],
        loss=a["loss"], double_dqn=a["double_dqn"],
        soft_update_interval=a["target_interval"], tau=a["tau"],
        eps_start=a["eps_start"], eps_final=a["eps_final"],
        eps_final_step=a["eps_final_step"]))
