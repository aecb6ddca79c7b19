"""Classic-control dynamics, batched (≙ border_tpu/envs/classic_control.py).

Physics constants and reward shapes follow the public Gymnasium definitions.
Every state field is ``[N]`` float32 (``t`` int32); time-limit truncation
lives inside the dynamics (a step counter in the state), keeping the
terminated/truncated split.  A reset draws all its values with one
``torch.rand`` call.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from border_tpu_torch.core import spaces
from border_tpu_torch.core.env import Environment, scale_uniform


def _steps(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int32, device=device)


@dataclasses.dataclass
class CartPoleState:
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half pole length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4
    max_steps: int = 500


class CartPole(Environment):
    """CartPole-v1: discrete(2), reward 1/step, 500-step limit."""

    name = "CartPole-v1"

    @property
    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    def observation_space(self, params) -> spaces.Box:
        high = np.array([4.8, np.inf, 0.418, np.inf], np.float32)
        return spaces.Box(-high, high, (4,), torch.float32)

    def action_space(self, params) -> spaces.Discrete:
        return spaces.Discrete(2)

    def reset_env(self, gen, n, params, device):
        init = scale_uniform(
            torch.rand((n, 4), generator=gen, device=device), -0.05, 0.05)
        state = CartPoleState(*init.unbind(1), _steps(n, device))
        return self._obs(state), state

    def _obs(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=1)

    def step_env(self, gen, state, action, params):
        force = torch.where(action == 1, params.force_mag, -params.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        total_mass = params.masscart + params.masspole
        polemass_length = params.masspole * params.length

        temp = (
            force + polemass_length * state.theta_dot**2 * sintheta
        ) / total_mass
        thetaacc = (params.gravity * sintheta - costheta * temp) / (
            params.length
            * (4.0 / 3.0 - params.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = state.x + params.tau * state.x_dot
        x_dot = state.x_dot + params.tau * xacc
        theta = state.theta + params.tau * state.theta_dot
        theta_dot = state.theta_dot + params.tau * thetaacc
        t = state.t + 1
        new = CartPoleState(x, x_dot, theta, theta_dot, t)

        terminated = (
            (x < -params.x_threshold)
            | (x > params.x_threshold)
            | (theta < -params.theta_threshold)
            | (theta > params.theta_threshold)
        )
        truncated = (t >= params.max_steps) & ~terminated
        reward = torch.ones_like(x)
        return self._obs(new), new, reward, terminated, truncated, {}


@dataclasses.dataclass
class PendulumState:
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PendulumParams:
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0  # noqa: E741
    max_steps: int = 200


class Pendulum(Environment):
    """Pendulum-v1: Box(1) torque in [-2,2], shaped cost, 200-step truncation."""

    name = "Pendulum-v1"

    @property
    def default_params(self) -> PendulumParams:
        return PendulumParams()

    def observation_space(self, params) -> spaces.Box:
        high = np.array([1.0, 1.0, params.max_speed], np.float32)
        return spaces.Box(-high, high, (3,), torch.float32)

    def action_space(self, params) -> spaces.Box:
        return spaces.Box(-params.max_torque, params.max_torque, (1,),
                          torch.float32)

    def reset_env(self, gen, n, params, device):
        u = torch.rand((n, 2), generator=gen, device=device)
        state = PendulumState(
            scale_uniform(u[:, 0], -math.pi, math.pi),
            scale_uniform(u[:, 1], -1.0, 1.0),
            _steps(n, device),
        )
        return self._obs(state), state

    def _obs(self, s: PendulumState) -> torch.Tensor:
        return torch.stack(
            [torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=1)

    def step_env(self, gen, state, action, params):
        u = torch.clamp(action.reshape(-1), -params.max_torque, params.max_torque)
        theta_norm = ((state.theta + math.pi) % (2 * math.pi)) - math.pi
        cost = theta_norm**2 + 0.1 * state.theta_dot**2 + 0.001 * u**2

        new_theta_dot = (
            state.theta_dot
            + (
                3.0 * params.g / (2.0 * params.l) * torch.sin(state.theta)
                + 3.0 / (params.m * params.l**2) * u
            )
            * params.dt
        )
        new_theta_dot = torch.clamp(new_theta_dot, -params.max_speed,
                                    params.max_speed)
        new_theta = state.theta + new_theta_dot * params.dt
        t = state.t + 1
        new = PendulumState(new_theta, new_theta_dot, t)
        truncated = t >= params.max_steps
        return (self._obs(new), new, -cost, torch.zeros_like(truncated),
                truncated, {})


@dataclasses.dataclass
class MountainCarState:
    position: torch.Tensor
    velocity: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MountainCarParams:
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    goal_velocity: float = 0.0
    force: float = 0.001
    gravity: float = 0.0025
    max_steps: int = 200


class MountainCar(Environment):
    """MountainCar-v0: discrete(3), -1/step, 200-step limit."""

    name = "MountainCar-v0"

    @property
    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    def observation_space(self, params) -> spaces.Box:
        low = np.array([params.min_position, -params.max_speed], np.float32)
        high = np.array([params.max_position, params.max_speed], np.float32)
        return spaces.Box(low, high, (2,), torch.float32)

    def action_space(self, params) -> spaces.Discrete:
        return spaces.Discrete(3)

    def reset_env(self, gen, n, params, device):
        pos = scale_uniform(
            torch.rand((n,), generator=gen, device=device), -0.6, -0.4)
        state = MountainCarState(pos, torch.zeros_like(pos), _steps(n, device))
        return self._obs(state), state

    def _obs(self, s) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=1)

    def _push(self, state, push, params):
        """One step under the engine force ``push`` [N] float32: the new
        state and the terminated and truncated flags."""
        velocity = state.velocity + push + torch.cos(
            3 * state.position
        ) * (-params.gravity)
        velocity = torch.clamp(velocity, -params.max_speed, params.max_speed)
        position = torch.clamp(
            state.position + velocity, params.min_position, params.max_position
        )
        velocity = torch.where(
            (position <= params.min_position) & (velocity < 0), 0.0, velocity
        )
        t = state.t + 1
        new = MountainCarState(position, velocity, t)
        terminated = (position >= params.goal_position) & (
            velocity >= params.goal_velocity
        )
        truncated = (t >= params.max_steps) & ~terminated
        return new, terminated, truncated

    def step_env(self, gen, state, action, params):
        new, terminated, truncated = self._push(
            state, (action - 1) * params.force, params)
        reward = torch.full_like(new.position, -1.0)
        return self._obs(new), new, reward, terminated, truncated, {}


class MountainCarContinuous(MountainCar):
    """MountainCarContinuous-v0: Box(1) action, shaped reward."""

    name = "MountainCarContinuous-v0"

    @property
    def default_params(self) -> MountainCarParams:
        return MountainCarParams(max_speed=0.07, force=0.0015, gravity=0.0025,
                                 goal_position=0.45, max_steps=999)

    def action_space(self, params) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (1,), torch.float32)

    def step_env(self, gen, state, action, params):
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        new, terminated, truncated = self._push(
            state, force * params.force, params)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        return self._obs(new), new, reward, terminated, truncated, {}


@dataclasses.dataclass
class AcrobotState:
    theta1: torch.Tensor
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AcrobotParams:
    dt: float = 0.2
    link_length_1: float = 1.0
    link_length_2: float = 1.0
    link_mass_1: float = 1.0
    link_mass_2: float = 1.0
    link_com_pos_1: float = 0.5
    link_com_pos_2: float = 0.5
    link_moi: float = 1.0
    max_vel_1: float = 4 * math.pi
    max_vel_2: float = 9 * math.pi
    max_steps: int = 500


class Acrobot(Environment):
    """Acrobot-v1: discrete(3) torque {-1,0,1}, -1/step until swing-up."""

    name = "Acrobot-v1"

    @property
    def default_params(self) -> AcrobotParams:
        return AcrobotParams()

    def observation_space(self, params) -> spaces.Box:
        high = np.array(
            [1.0, 1.0, 1.0, 1.0, params.max_vel_1, params.max_vel_2], np.float32
        )
        return spaces.Box(-high, high, (6,), torch.float32)

    def action_space(self, params) -> spaces.Discrete:
        return spaces.Discrete(3)

    def reset_env(self, gen, n, params, device):
        init = scale_uniform(
            torch.rand((n, 4), generator=gen, device=device), -0.1, 0.1)
        state = AcrobotState(*init.unbind(1), _steps(n, device))
        return self._obs(state), state

    def _obs(self, s) -> torch.Tensor:
        return torch.stack(
            [
                torch.cos(s.theta1),
                torch.sin(s.theta1),
                torch.cos(s.theta2),
                torch.sin(s.theta2),
                s.dtheta1,
                s.dtheta2,
            ],
            dim=1,
        )

    def _dsdt(self, s_aug, params):
        """``s_aug``: [5, N] (θ1, θ2, θ̇1, θ̇2, torque)."""
        m1, m2 = params.link_mass_1, params.link_mass_2
        l1 = params.link_length_1
        lc1, lc2 = params.link_com_pos_1, params.link_com_pos_2
        i1 = i2 = params.link_moi
        g = 9.8
        theta1, theta2, dtheta1, dtheta2, a = s_aug.unbind(0)
        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(theta2))
            + i1
            + i2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(theta2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (
            a
            + d2 / d1 * phi1
            - m2 * l1 * lc2 * dtheta1**2 * torch.sin(theta2)
            - phi2
        ) / (m2 * lc2**2 + i2 - d2**2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack(
            [dtheta1, dtheta2, ddtheta1, ddtheta2, torch.zeros_like(a)])

    def step_env(self, gen, state, action, params):
        torque = (action - 1).float()
        s_aug = torch.stack(
            [state.theta1, state.theta2, state.dtheta1, state.dtheta2, torque]
        )
        # RK4 over one dt, matching Gymnasium's integrator
        dt = params.dt
        k1 = self._dsdt(s_aug, params)
        k2 = self._dsdt(s_aug + dt / 2 * k1, params)
        k3 = self._dsdt(s_aug + dt / 2 * k2, params)
        k4 = self._dsdt(s_aug + dt * k3, params)
        ns = s_aug + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

        wrap = lambda x: ((x + math.pi) % (2 * math.pi)) - math.pi  # noqa: E731
        theta1 = wrap(ns[0])
        theta2 = wrap(ns[1])
        dtheta1 = torch.clamp(ns[2], -params.max_vel_1, params.max_vel_1)
        dtheta2 = torch.clamp(ns[3], -params.max_vel_2, params.max_vel_2)
        t = state.t + 1
        new = AcrobotState(theta1, theta2, dtheta1, dtheta2, t)
        terminated = -torch.cos(theta1) - torch.cos(theta2 + theta1) > 1.0
        truncated = (t >= params.max_steps) & ~terminated
        reward = torch.where(terminated, 0.0, -1.0)
        return self._obs(new), new, reward, terminated, truncated, {}
