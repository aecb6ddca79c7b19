"""Environment registry — string id → Environment factory
(≙ border_tpu/envs/registry.py).

Every id of the JAX registry is registered.
"""

from __future__ import annotations

from typing import Callable, Dict

from border_tpu_torch.core.env import Environment
from border_tpu_torch.envs import classic_control as cc
from border_tpu_torch.envs.breakout import make_breakout
from border_tpu_torch.envs.freeway import make_freeway
from border_tpu_torch.envs.pong import make_pong
from border_tpu_torch.envs.reacher import FlattenDictWrapper, Reacher
from border_tpu_torch.envs.seaquest import make_seaquest
from border_tpu_torch.envs.space_invaders import make_space_invaders

registry: Dict[str, Callable[[], Environment]] = {}


def register(name: str, factory: Callable[[], Environment]) -> None:
    registry[name] = factory


def make(name: str, **kwargs) -> Environment:
    if name not in registry:
        raise KeyError(
            f"Unknown env '{name}'. Registered: {sorted(registry)}"
        )
    return registry[name](**kwargs)


register("CartPole-v1", cc.CartPole)
register("Pendulum-v1", cc.Pendulum)
register("MountainCar-v0", cc.MountainCar)
register("MountainCarContinuous-v0", cc.MountainCarContinuous)
register("Acrobot-v1", cc.Acrobot)
register("Pong-v0", make_pong)
register("Breakout-v0", make_breakout)
register("Seaquest-v0", make_seaquest)
register("Freeway-v0", make_freeway)
register("SpaceInvaders-v0", make_space_invaders)
register("Reacher-v0", Reacher)
register("ReacherFlat-v0", lambda: FlattenDictWrapper(Reacher()))
# the goal-conditioned flat view (observation ‖ desired_goal, the key order
# of GoalDictConverter's default): the recovered env of dict-obs corpora
register(
    "ReacherGoal-v0",
    lambda: FlattenDictWrapper(Reacher(), keys=("observation", "desired_goal")),
)
