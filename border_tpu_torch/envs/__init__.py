"""Batched on-device environments (≙ border_tpu/envs).  Ported so far:
Pong under the DQN pixel wrapper."""

from border_tpu_torch.envs.pixel import PixelEnv, PixelGame  # noqa: F401
from border_tpu_torch.envs.pong import Pong, make_pong  # noqa: F401
from border_tpu_torch.envs.registry import make, register, registry  # noqa: F401
