"""Environment registry — string id → Environment factory
(≙ border_tpu/envs/registry.py).

Only the ported envs are registered; an unported id raises the same
``KeyError`` as the JAX registry.
"""

from __future__ import annotations

from typing import Callable, Dict

from border_tpu_torch.core.env import Environment
from border_tpu_torch.envs.pong import make_pong

registry: Dict[str, Callable[[], Environment]] = {}


def register(name: str, factory: Callable[[], Environment]) -> None:
    registry[name] = factory


def make(name: str, **kwargs) -> Environment:
    if name not in registry:
        raise KeyError(
            f"Unknown env '{name}'. Registered: {sorted(registry)}"
        )
    return registry[name](**kwargs)


register("Pong-v0", make_pong)
