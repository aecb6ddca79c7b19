"""RL agents (≙ border_tpu/agents).  Ported so far: DQN and IQN."""

from border_tpu_torch.agents.dqn import DQN, DQNConfig, DQNState  # noqa: F401
from border_tpu_torch.agents.iqn import IQN, IQNConfig, IQNState  # noqa: F401
