"""RL agents (≙ border_tpu/agents): DQN and IQN; SAC; the offline family
BC, AWAC and IQL."""

from border_tpu_torch.agents.awac import AWAC, AWACConfig, AWACState  # noqa: F401
from border_tpu_torch.agents.bc import BC, BCConfig, BCState  # noqa: F401
from border_tpu_torch.agents.dqn import DQN, DQNConfig, DQNState  # noqa: F401
from border_tpu_torch.agents.iql import IQL, IQLConfig, IQLState  # noqa: F401
from border_tpu_torch.agents.iqn import IQN, IQNConfig, IQNState  # noqa: F401
from border_tpu_torch.agents.sac import SAC, SACConfig, SACState  # noqa: F401
