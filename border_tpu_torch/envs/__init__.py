"""Batched on-device environments (≙ border_tpu/envs): the classic-control
family, the five pixel games under the DQN pixel wrapper, and the
dict-observation Reacher; and the host-env path's envs, stepped on the host
(``native.py``: the C++ env pool, ``py_env.py``: Gymnasium-API envs,
``ale.py``: the real-ALE seam)."""

from border_tpu_torch.envs.classic_control import (  # noqa: F401
    Acrobot,
    CartPole,
    MountainCar,
    MountainCarContinuous,
    Pendulum,
)
from border_tpu_torch.envs.pixel import PixelEnv, PixelGame  # noqa: F401
from border_tpu_torch.envs.pong import Pong, make_pong  # noqa: F401
from border_tpu_torch.envs.breakout import Breakout, make_breakout  # noqa: F401
from border_tpu_torch.envs.seaquest import Seaquest, make_seaquest  # noqa: F401
from border_tpu_torch.envs.freeway import Freeway, make_freeway  # noqa: F401
from border_tpu_torch.envs.space_invaders import (  # noqa: F401
    SpaceInvaders,
    make_space_invaders,
)
from border_tpu_torch.envs.reacher import FlattenDictWrapper, Reacher  # noqa: F401
from border_tpu_torch.envs.registry import make, register, registry  # noqa: F401
from border_tpu_torch.envs.py_env import PyVecEnv  # noqa: F401
from border_tpu_torch.envs.ale import AleVecEnv, ale_available  # noqa: F401
