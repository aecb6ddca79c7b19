"""Carry weights and state over from the JAX package.

Every function takes what the JAX side holds, as numpy arrays or anything
``numpy.asarray`` reads (flax param dicts, ``flax.struct`` states), and
returns the port's counterpart on ``device``.  The module imports neither
``jax`` nor ``border_tpu``: it reads attributes and arrays only.

- AtariCNN params: conv kernels ``HWIO → OIHW``, Dense kernels
  ``[in, out] → [out, in]``, and ``Dense_0``'s 3136 input rows permuted from
  the JAX NHWC flatten order (``h·448 + w·64 + c``) to the port's NCHW
  order (``c·49 + h·7 + w``).
- ``PongState`` / ``PixelEnvState`` / ``VecEnvState`` → the port's env state.
- ``FrameReplayState`` → the port's buffer state: the ``(R, 128)`` tile
  padding of each stored frame is stripped back to ``H × W``; the slice
  mode's mirror slots stay on the frames only; a PER state's ``tree``
  becomes a ``SumTreeState``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.agents.dqn import DQN, DQNState
from border_tpu_torch.core.env import VecEnvState
from border_tpu_torch.envs.pixel import PixelEnvState
from border_tpu_torch.envs.pong import PongState
from border_tpu_torch.models.cnn import AtariCNN
from border_tpu_torch.replay.frame_buffer import FrameReplayState
from border_tpu_torch.replay.sum_tree import SumTreeState
from border_tpu_torch.utils.device import DeviceLike, as_generator, resolve_device

_CNN_LAYERS = (("Conv_0", "conv0"), ("Conv_1", "conv1"), ("Conv_2", "conv2"),
               ("Dense_0", "fc0"), ("Dense_1", "fc1"))


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def _dense0_rows(c: int = 64, h: int = 7, w: int = 7) -> np.ndarray:
    """``rows[k_nchw] = k_nhwc``: for NCHW flat index ``c·49 + h·7 + w``
    the NHWC flat index ``h·448 + w·64 + c`` of the same feature."""
    ci, hi, wi = np.meshgrid(np.arange(c), np.arange(h), np.arange(w),
                             indexing="ij")
    return (hi * (w * c) + wi * c + ci).reshape(-1)


def atari_cnn_state_dict(flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``AtariCNN`` params (``{"params": {...}}`` or the inner dict)
    → a state dict for :class:`border_tpu_torch.models.AtariCNN`."""
    p = flax_params.get("params", flax_params)
    out = {}
    for jname, tname in _CNN_LAYERS:
        if jname not in p:
            continue
        k = np.asarray(p[jname]["kernel"], np.float32)
        if k.ndim == 4:
            k = k.transpose(3, 2, 0, 1)  # HWIO → OIHW
        else:
            k = k.T  # [in, out] → [out, in]
            if jname == "Dense_0":
                k = k[:, _dense0_rows()]
        out[f"{tname}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        out[f"{tname}.bias"] = torch.from_numpy(
            np.asarray(p[jname]["bias"], np.float32).copy())
    return out


def atari_cnn_to_flax(net: AtariCNN) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`atari_cnn_state_dict`: the port's parameters
    in the flax layout, as numpy (for comparing with the JAX side)."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    inv = np.argsort(_dense0_rows())
    out = {}
    for jname, tname in _CNN_LAYERS:
        if f"{tname}.weight" not in sd:
            continue
        k = sd[f"{tname}.weight"]
        if k.ndim == 4:
            k = k.transpose(2, 3, 1, 0)  # OIHW → HWIO
        else:
            if jname == "Dense_0":
                k = k[:, inv]
            k = k.T
        out[jname] = {"kernel": np.ascontiguousarray(k),
                      "bias": sd[f"{tname}.bias"]}
    return {"params": out}


def load_atari_cnn(net: AtariCNN, flax_params: Dict[str, Any]) -> AtariCNN:
    """Copy flax params into ``net`` in place; returns ``net``."""
    net.load_state_dict(atari_cnn_state_dict(flax_params))
    return net


def dqn_state(agent: DQN, jax_state, obs_space, act_space,
              device: DeviceLike = None) -> DQNState:
    """A ``DQNState`` with the JAX state's online and target params and
    counters, and a fresh optimizer (the JAX optimizer state must be fresh
    too: its moments are not carried over)."""
    device = resolve_device(device)
    count = _adam_count(jax_state.opt_state)
    if count:
        raise ValueError(
            f"optimizer state has taken {count} steps; only a fresh one "
            f"carries over"
        )
    st = agent.init(0, obs_space, act_space, device=device)
    load_atari_cnn(st.params, jax_state.params)
    load_atari_cnn(st.target_params, jax_state.target_params)
    st.n_opts = int(np.asarray(jax_state.n_opts))
    st.n_samples = int(np.asarray(jax_state.n_samples))
    return st


def _adam_count(opt_state) -> int:
    """The largest ``count`` field anywhere in an optax state tuple."""
    if "count" in getattr(opt_state, "_fields", ()):
        return int(np.asarray(opt_state.count))
    if isinstance(opt_state, (tuple, list)):
        return max([_adam_count(s) for s in opt_state] + [0])
    return 0


def pong_state(js, device: DeviceLike = "cpu") -> PongState:
    """Batched JAX ``PongState`` (every field ``[N]``) → the port's."""
    return PongState(**{
        f.name: _t(getattr(js, f.name), device)
        for f in dataclasses.fields(PongState)
    })


def pixel_env_state(js, device: DeviceLike = "cpu") -> PixelEnvState:
    """Batched JAX ``PixelEnvState`` of Pong → the port's."""
    return PixelEnvState(
        game=pong_state(js.game, device),
        frames=_t(js.frames, device),
        frame_count=_t(js.frame_count, device, torch.int32),
        t=_t(js.t, device, torch.int32),
        lives=_t(js.lives, device, torch.int32),
        game_over=_t(js.game_over, device, torch.bool),
    )


def vec_env_state(js, seed_or_gen, device: DeviceLike = "cpu") -> VecEnvState:
    """JAX ``VecEnvState`` → the port's.  The JAX key has no counterpart:
    the port's env draws from ``seed_or_gen``."""
    device = torch.device(device)
    return VecEnvState(
        env_state=pixel_env_state(js.env_state, device),
        obs=_t(js.obs, device),
        episode_return=_t(js.episode_return, device, torch.float32),
        episode_length=_t(js.episode_length, device, torch.int32),
        last_return=_t(js.last_return, device, torch.float32),
        last_length=_t(js.last_length, device, torch.int32),
        gen=as_generator(seed_or_gen, device),
    )


def sum_tree_state(js, device: DeviceLike = "cpu") -> SumTreeState:
    """JAX ``SumTreeState`` → the port's (same heap layout)."""
    return SumTreeState(
        sum_tree=_t(js.sum_tree, device, torch.float32),
        min_tree=_t(js.min_tree, device, torch.float32),
        max_priority=_t(js.max_priority, device, torch.float32),
    )


def frame_replay_state(js, frame_hw: Tuple[int, int] = (84, 84),
                       device: DeviceLike = "cpu",
                       capacity: Optional[int] = None) -> FrameReplayState:
    """JAX ``FrameReplayState`` (frames ``[N, slots, R, 128]``) → the port's
    unpadded ``[N, slots, H, W]`` ring.  In slice mode ``slots`` is the
    capacity plus the mirror slots, and the JAX state pads every other
    array to ``slots`` too; the port keeps those at ``capacity``, which the
    caller then passes."""
    h, w = frame_hw
    f = np.asarray(js.frames)
    n, slots = f.shape[:2]
    frames = f.reshape(n, slots, -1)[:, :, : h * w].reshape(n, slots, h, w)
    tree = getattr(js, "tree", None)
    cap = slots if capacity is None else capacity
    return FrameReplayState(
        frames=_t(frames, device),
        act=_t(js.act, device, torch.int32)[:, :cap],
        reward=_t(js.reward, device, torch.float32)[:, :cap],
        terminated=_t(js.terminated, device, torch.bool)[:, :cap],
        truncated=_t(js.truncated, device, torch.bool)[:, :cap],
        age=_t(js.age, device, torch.int32)[:, :cap],
        total=int(np.asarray(js.total)),
        tree=None if tree is None else sum_tree_state(tree, device),
    )
