"""RL agents (≙ border_tpu/agents).  Ported so far: DQN."""

from border_tpu_torch.agents.dqn import DQN, DQNConfig, DQNState  # noqa: F401
