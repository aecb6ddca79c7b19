"""Pendulum (``Pendulum-v1``): Gymnasium's classic-control pendulum, one
torque in [−2, 2], a 3-wide observation (cos θ, sin θ, θ̇) and a
200-step time limit, batched over ``[N]`` float32 tensors.

``step`` follows Gymnasium's ``PendulumEnv.step`` operation by operation:
the torque clipped, the cost of the state before the step
``angle_normalize(θ)² + 0.1·θ̇² + 0.001·u²``, then
``θ̇' = clip(θ̇ + (3g/(2l)·sin θ + 3/(m·l²)·u)·dt, ±8)`` and
``θ' = θ + θ̇'·dt``; the reward is −cost, an episode never terminates and
is truncated at its 200th step.  ``reset`` draws θ ~ U(−π, π) and
θ̇ ~ U(−1, 1) with one ``[N, 2]`` uniform draw from the generator handed
in (θ's first), each mapped onto its range with both bounds in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference.games import uniform_jax


@dataclasses.dataclass
class State:
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # steps taken in the episode


class Pendulum:
    obs_dim, act_dim = 3, 1
    act_low, act_high = -2.0, 2.0
    MAX_SPEED, MAX_TORQUE, DT, G, M, L = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
    MAX_STEPS = 200

    def reset(self, gen, n: int, device) -> State:
        u = torch.rand((n, 2), generator=gen, device=device)
        return State(theta=uniform_jax(u[:, 0], -math.pi, math.pi),
                     theta_dot=uniform_jax(u[:, 1], -1.0, 1.0),
                     t=torch.zeros((n,), dtype=torch.int32, device=device))

    def obs(self, s: State) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=1)

    @staticmethod
    def angle_normalize(x: torch.Tensor) -> torch.Tensor:
        return ((x + math.pi) % (2 * math.pi)) - math.pi

    def step(self, s: State, action: torch.Tensor):
        """``(state, reward, terminated, truncated)`` after the torque
        ``action`` ``[N, 1]``."""
        g, m, l, dt = self.G, self.M, self.L, self.DT
        u = torch.clamp(action[:, 0], -self.MAX_TORQUE, self.MAX_TORQUE)
        costs = self.angle_normalize(s.theta) ** 2 + 0.1 * s.theta_dot ** 2 + 0.001 * (u ** 2)
        newthdot = s.theta_dot + (3 * g / (2 * l) * torch.sin(s.theta)
                                  + 3.0 / (m * l ** 2) * u) * dt
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = s.theta + newthdot * dt
        t = s.t + 1
        truncated = t >= self.MAX_STEPS
        return (State(theta=newth, theta_dot=newthdot, t=t), -costs,
                torch.zeros_like(truncated), truncated)


GAME = Pendulum
