"""Core contracts: spaces, batched environments, agent interface
(≙ border_tpu/core)."""

from border_tpu_torch.core import spaces  # noqa: F401
from border_tpu_torch.core.env import (  # noqa: F401
    Environment,
    EnvParams,
    EnvState,
    Timestep,
    VecEnv,
    VecEnvState,
)
from border_tpu_torch.core.agent import Agent, AgentState  # noqa: F401
